"""Training slice of the PyTorch port (``lightgbm_tpu_torch``) against the
JAX package, on the CPU: the tree builder with the kernels' plain twins,
then ``train`` / ``Booster`` end to end.

The bars:
- one tree from the same (grad, hess, inbag) channels: split leaf,
  feature, bin, kind, default_left, routing table and every row's leaf
  EQUAL; gains, sums and leaf values within rtol 1e-5 (f32 gain arithmetic
  in another op order; the channels are 1/64-grid values, so histogram
  sums are exact in both packages);
- five boosting iterations from the JAX package's own bins
  (``dataset_from_reference``): the same trees, leaf values and
  predictions within TRAIN_RTOL / TRAIN_ATOL (torch_port_cases.py);
- early stopping, continued training from a JAX model and rollback;
- every setting the port cannot honour raises, naming its ROADMAP item
  (quantized, sampled and rows-layout training are held to the JAX
  package in test_torch_quantized_train.py, the one-kernel split in
  test_torch_one_kernel.py); an ineligible ``tpu_split_kernel=on`` warns
  and trains the three-launch path, as the JAX package does.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_cases import (CPU, TRAIN_ATOL, TRAIN_RTOL, assert_same_trees,
                              jax_dataset, one_torch_thread, torch_threads,
                              train_params)

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import construct_dataset as jax_construct
from lightgbm_tpu.learner import SerialTreeLearner as JLearner

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.dataset import construct_dataset
from lightgbm_tpu_torch.learner import SerialTreeLearner
from lightgbm_tpu_torch.utils.log import LightGBMError


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """Every test here runs the port on the host: one torch thread
    (torch_port_cases.one_torch_thread)."""


@pytest.fixture(autouse=True, scope="module")
def _one_thread_module():
    """The module-scoped training fixtures run before any function-scoped
    fixture: one torch thread for them too."""
    with torch_threads(1):
        yield


def _higgs_grid(rng, n, f):
    return np.round(rng.randn(n, f) * 16) / 64.0


# ------------------------------------------------------------- one tree

@pytest.mark.parametrize("n,f,leaves", [(2999, 28, 31), (1501, 28, 255)])
def test_one_tree_equals_jax(n, f, leaves):
    rng = np.random.RandomState(0)
    X = _higgs_grid(rng, n, f)
    y = (X @ rng.randn(f) > 0).astype(np.float64)
    g = np.round(rng.randn(n) * 16) / 64
    h = (np.round(np.abs(rng.randn(n)) * 16) + 6) / 64
    ghc = np.stack([g, h, np.ones(n)], axis=1).astype(np.float32)
    p = {"objective": "binary", "num_leaves": leaves, "max_bin": 63,
         "min_data_in_leaf": 2, "verbosity": -1}
    jcfg = JConfig.from_params(dict(p, tree_builder="partition",
                                    tpu_work_layout="planes"))
    jds = jax_construct(X, jcfg, label=y)
    a = jax.device_get(JLearner(jcfg, jds).train(
        jnp.asarray(ghc), jnp.ones(jds.num_features, bool),
        jax.random.PRNGKey(0)))
    pcfg = Config.from_params(dict(p, device_type="cpu"))
    lrn = SerialTreeLearner(pcfg, construct_dataset(X, pcfg, label=y))
    b = lrn.train(torch.as_tensor(ghc))
    ns = int(a.num_splits)
    assert ns == int(b.num_splits[0]) == leaves - 1
    for fld in ("split_leaf", "feature", "bin", "kind", "default_left",
                "go_left"):
        np.testing.assert_array_equal(np.asarray(getattr(a, fld))[:ns],
                                      getattr(b, fld).numpy()[:ns],
                                      err_msg=fld)
    np.testing.assert_array_equal(np.asarray(a.row_leaf), b.row_leaf.numpy())
    for fld in ("gain", "left_sum", "right_sum", "leaf_value", "leaf_sum"):
        np.testing.assert_allclose(getattr(b, fld).numpy(),
                                   np.asarray(getattr(a, fld)),
                                   rtol=1e-5, atol=1e-6, err_msg=fld)
    # the integer invariants chip_smoke.py checks on the card
    cnt = lrn.last_stats["leaf_cnt"][:ns + 1]
    assert int(cnt.sum()) == n
    assert torch.equal(cnt, torch.bincount(b.row_leaf, minlength=ns + 1)
                       .to(torch.int32))
    assert torch.equal(lrn.last_stats["hist_cnt"][:ns + 1],
                       cnt.to(torch.float32))


# ------------------------------------------------------- five iterations

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("train")
    out = {}
    for name in ("binary", "regression", "multiclass", "nan_missing",
                 "categorical", "efb"):
        ds, path, X, y, _ = jax_dataset(name, d, n=1200)
        params = train_params(name)
        jb = lgb.Booster(params, ds)
        for _ in range(5):
            jb.update()
        pb = lgt.train(dict(params, **CPU),
                       lgt.dataset_from_reference(path, CPU), 5)
        out[name] = (jb, pb, X)
    return out


@pytest.mark.parametrize("name", ["binary", "regression", "multiclass",
                                  "nan_missing", "categorical", "efb"])
def test_five_iterations_equal_jax(trained, name):
    jb, pb, X = trained[name]
    if name == "efb":
        assert pb.inner.train_set.has_bundles
    if name == "categorical":
        assert any(t.num_cat for t in pb.inner.models)
    assert pb.current_iteration == 5
    np.testing.assert_array_equal(jb.inner.init_scores, pb.inner.init_scores)
    assert_same_trees(jb.inner.models, pb.inner.models)
    np.testing.assert_allclose(pb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True),
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    np.testing.assert_allclose(pb.inner.train_score.np(),
                               np.asarray(jb.inner.train_score.score),
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    for (_, ja, va, _), (_, pa, vb, _) in zip(jb.eval_train(),
                                              pb.eval_train()):
        assert ja == pa
        assert vb == pytest.approx(va, rel=1e-5)


def test_early_stopping_matches_jax(tmp_path):
    ds, path, _, _, (Xv, yv) = jax_dataset("binary", tmp_path, n=800,
                                           seed=4, valid_rows=300)
    params = dict(train_params("binary", leaves=15), learning_rate=0.5,
                  early_stopping_round=2)
    jb = lgb.train(dict(params), ds, 60,
                   valid_sets=[lgb.Dataset(Xv, label=yv, reference=ds)])
    ptr = lgt.dataset_from_reference(path, CPU)
    pb = lgt.train(dict(params, **CPU), ptr, 60,
                   valid_sets=[lgt.Dataset(Xv, label=yv, reference=ptr)])
    assert jb.best_iteration < 60
    assert pb.best_iteration == jb.best_iteration
    assert pb.current_iteration == jb.inner.iter_
    assert pb.best_score["valid_0"]["binary_logloss"] == pytest.approx(
        jb.best_score["valid_0"]["binary_logloss"], rel=1e-5)


def test_init_model_continues_jax_model(tmp_path):
    ds, path, X, _, _ = jax_dataset("binary", tmp_path, seed=5)
    params = train_params("binary")
    first = lgb.train(dict(params), ds, 3)
    text = first.model_to_string()
    jb = lgb.train(dict(params), ds, 2, init_model=first)
    pb = lgt.train(dict(params, **CPU), lgt.dataset_from_reference(path, CPU),
                   2, init_model=text)
    assert pb.current_iteration == 5
    assert_same_trees(jb.inner.models, pb.inner.models)
    np.testing.assert_allclose(pb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True),
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)


def test_rollback_one_iter(tmp_path):
    _, path, X, _, _ = jax_dataset("regression", tmp_path, n=800, seed=6)
    params = dict(train_params("regression"), **CPU)
    two = lgt.Booster(params, lgt.dataset_from_reference(path, CPU))
    three = lgt.Booster(params, lgt.dataset_from_reference(path, CPU))
    for _ in range(2):
        two.update()
    for _ in range(3):
        three.update()
    three.rollback_one_iter()
    assert three.current_iteration == 2 and three.num_trees() == 2
    np.testing.assert_allclose(three.inner.train_score.np(),
                               two.inner.train_score.np(), atol=1e-6)
    three.update()       # training goes on from the rebuilt scores
    two.update()
    np.testing.assert_allclose(three.predict(X), two.predict(X), atol=1e-6)


def test_auto_knobs_resolve_and_record(tmp_path):
    from lightgbm_tpu_torch.obs import telemetry

    _, path, _, _, _ = jax_dataset("binary", tmp_path, n=300, seed=2)
    telemetry.reset()
    bst = lgt.Booster(dict(train_params("binary"), **CPU),
                      lgt.dataset_from_reference(path, CPU))
    kw = bst.inner.learner.build_kwargs()
    assert kw["work_layout"] == "planes"
    assert kw["part_kernel"] == kw["hist_kernel"] == "xla"   # host twins
    got = {r["knob"]: r["value"] for r in telemetry.records("auto_resolution")}
    assert got["tpu_work_layout"] == "planes"
    assert got["tpu_resident_state"] == "off"
    assert got["tpu_partition_kernel"] == "xla"
    assert got["tpu_split_kernel"] == "off"
    # on a CUDA device auto names the kernels and xla is refused
    lrn = bst.inner.learner
    lrn.device = torch.device("cuda")
    kw = lrn.build_kwargs()
    assert kw["part_kernel"] == "pallas"
    assert kw["split_kernel"] == "on"      # eligible: one launch per split
    lrn.config.tpu_hist_kernel = "xla"
    with pytest.raises(LightGBMError, match="ROADMAP"):
        lrn.build_kwargs()


def test_ineligible_split_kernel_downgrades(tmp_path):
    """tpu_split_kernel=on where the one-kernel split cannot run (the rows
    layout, int8 histograms) warns and trains the three-launch path, the
    JAX package's own downgrade (tests/test_one_kernel.py)."""
    from lightgbm_tpu_torch.utils.log import set_thread_log_sink

    _, path, _, _, _ = jax_dataset("binary", tmp_path, n=300, seed=2)
    lines = []
    set_thread_log_sink(lines.append)
    try:
        for extra in ({"tpu_work_layout": "rows"},
                      {"use_quantized_grad": True}):
            params = dict(train_params("binary"), tpu_split_kernel="on",
                          **CPU, **extra)
            bst = lgt.train(params, lgt.dataset_from_reference(path, CPU), 2)
            kw = bst.inner.learner._kw
            assert kw["split_kernel"] == "off"
            assert kw["work_layout"] == "rows"
            assert bst.current_iteration == 2
    finally:
        set_thread_log_sink(None)
    warned = [ln for ln in lines if "not eligible" in ln]
    assert len(warned) == 2
    assert "planes work layout" in warned[0] and "int8" in warned[1]


@pytest.mark.parametrize("extra", [
    {"tpu_goss_compact": "on"},
    {"tpu_work_layout": "planes", "use_quantized_grad": True},
    {"feature_fraction_bynode": 0.5}, {"extra_trees": True},
    {"interaction_constraints": "[0,1]"}, {"cegb_penalty_split": 0.1},
    {"forcedsplits_filename": "forced.json"},
    {"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1},
    {"boosting": "dart"}, {"linear_tree": True}, {"tree_learner": "data"},
    {"tree_builder": "dense"},
])
def test_unsupported_settings_raise(tmp_path, extra):
    """Settings the port does not train raise naming their ROADMAP item
    (int8 on the planes layout, item B, as in the JAX package). The
    per-node split options, forced splits (a file that is not there warns
    and forces nothing, as in the JAX package), GOSS compaction (where GOSS
    does not sample it warns and keeps the dense path), DART and RF,
    linear trees (a binary-cache dataset keeps no raw features, so its
    leaves stay constant, as the JAX package's fit skips them), the dense
    builder and ``tree_learner=data`` (without a process group it trains
    the serial learner, as the JAX package does on one device) train since
    they were ported, and raise no longer."""
    _, path, _, _, _ = jax_dataset("binary", tmp_path, n=200, seed=3)
    params = dict(train_params("binary"), **CPU)
    params.update(extra)
    ported = ("tpu_goss_compact", "feature_fraction_bynode", "extra_trees",
              "interaction_constraints", "cegb_penalty_split",
              "forcedsplits_filename", "boosting", "linear_tree",
              "tree_builder", "tree_learner")
    if any(k in extra for k in ported):
        bst = lgt.train(params, lgt.dataset_from_reference(path, CPU), 2)
        assert bst.current_iteration == 2
        assert bst.inner.models[0].num_leaves > 1
        if "boosting" in extra:
            assert bst.inner.name == extra["boosting"]
        if "linear_tree" in extra:
            assert all(t.is_linear for t in bst.inner.models)
        if "tree_builder" in extra:
            assert bst.inner.learner.dense
            assert bst.inner.learner._kw["work_layout"] == "dense"
        if "tree_learner" in extra:
            assert type(bst.inner.learner) is SerialTreeLearner
        return
    item = {"tpu_work_layout": "B"}[next(iter(extra))]
    with pytest.raises(LightGBMError, match="ROADMAP %s" % item):
        lgt.train(params, lgt.dataset_from_reference(path, CPU), 1)


@pytest.mark.parametrize("method", ["intermediate", "advanced"])
def test_monotone_intermediate_raises(method):
    """The intermediate and advanced monotone methods no longer raise:
    both train, and their predictions keep the constraint."""
    rng = np.random.RandomState(0)
    X = _higgs_grid(rng, 300, 3)
    params = {"objective": "regression", "verbosity": -1, "device_type": "cpu",
              "monotone_constraints": [1, 0, 0],
              "monotone_constraints_method": method}
    bst = lgt.train(params, lgt.Dataset(X, label=X[:, 0]), 2)
    hp = bst.inner.learner.hp
    assert hp.mono_intermediate and hp.mono_advanced == (method == "advanced")
    assert bst.inner.models[0].num_leaves > 1
    grid = np.tile(X[:1], (50, 1))
    grid[:, 0] = np.linspace(X[:, 0].min(), X[:, 0].max(), 50)
    assert float(np.diff(bst.predict(grid)).min()) >= -1e-7


def test_fobj_equals_builtin_l2(tmp_path):
    """A custom objective (``fobj``) with L2 gradients grows the trees of
    ``objective=regression`` without boost_from_average."""
    _, path, X, y, _ = jax_dataset("regression", tmp_path, n=600, seed=8)
    params = dict(train_params("regression"), boost_from_average=False,
                  **CPU)
    builtin = lgt.train(params, lgt.dataset_from_reference(path, CPU), 3)

    def fobj(score, ds):
        return score - y, np.ones_like(score)

    custom = lgt.train(dict(params, objective="none"),
                       lgt.dataset_from_reference(path, CPU), 3, fobj=fobj)
    for a, b in zip(builtin.inner.models, custom.inner.models):
        assert a.to_text() == b.to_text()
