"""The port's API surface against the JAX package on the CPU: the Dataset
setters and getters; ``dump_model``, ``to_if_else_cpp``,
``feature_importance`` and ``pred_contrib`` on one model text loaded into
both packages (equal exactly); ``pred_contrib`` row sums on a model each
package trains; the converted C++ compiled with g++; the
``reset_parameter`` callback's schedule and ``Booster.reset_parameter``
(the trees of the JAX package); and ``refit`` on binary, L2, weighted,
multiclass and ranking data (leaf values within 1e-5 relative)."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from torch_port_cases import (CPU, REFIT_ATOL, REFIT_RTOL,
                              assert_same_trees, jax_dataset, make_data,
                              make_train_data, torch_threads, train_params)

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.utils.log import LightGBMError


@pytest.fixture(autouse=True, scope="module")
def _one_thread_module():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def models():
    """{case: (JAX booster, port booster, query rows)}: one model text
    (trained by the port) loaded into both packages."""
    out = {}
    for name, spec in (("nan_missing", dict(nan=True)),
                       ("categorical", dict(cat=True)),
                       ("multiclass", dict(classes=3)),
                       ("linear", dict(nan=True))):
        params = {"objective": "binary", "num_leaves": 15,
                  "verbosity": -1}
        if name == "multiclass":
            params.update(objective="multiclass", num_class=3)
        if name == "linear":
            params.update(objective="regression", linear_tree=True)
        rng = np.random.RandomState(7)
        X, y = make_data(rng, 500, 8, **spec)
        Xq, _ = make_data(rng, 120, 8, **{k: v for k, v in spec.items()
                                          if k != "classes"})
        ds = lgt.Dataset(X, label=y, params=dict(params, **CPU),
                         categorical_feature=[0] if spec.get("cat") else [])
        text = lgt.train(dict(params, **CPU), ds, 5).model_to_string()
        out[name] = (lgb.Booster(model_str=text),
                     lgt.Booster(CPU, model_str=text), Xq)
    return out


def test_dataset_setters_and_getters():
    rng = np.random.RandomState(3)
    X, y, _ = make_train_data(rng, 200)
    w, init = rng.rand(200), rng.randn(200)
    for pkg in (lgb, lgt):
        ds = pkg.Dataset(X, label=y)
        assert (ds.num_data(), ds.num_feature()) == (200, 8)
        ds.construct()
        ds.set_label(1 - y).set_weight(w).set_init_score(init)
        np.testing.assert_array_equal(ds.get_label(), 1 - y)
        np.testing.assert_array_equal(ds.get_weight(), w)
        np.testing.assert_array_equal(ds.get_init_score(), init)
        md = ds.construct().metadata
        np.testing.assert_array_equal(md.label, (1 - y).astype(np.float32))
        np.testing.assert_array_equal(md.weight, w.astype(np.float32))
        np.testing.assert_array_equal(md.init_score, init)
        assert (ds.num_data(), ds.num_feature()) == (200, 8)
        ds.set_weight(None)
        assert ds.get_weight() is None and ds.construct().metadata.weight \
            is None


@pytest.mark.parametrize("case", ["nan_missing", "categorical",
                                  "multiclass", "linear"])
def test_host_readers_equal_jax(models, case):
    """One model text in both packages: the JSON dump, the C++ source,
    both importances and the SHAP contributions are equal exactly."""
    jb, pb, Xq = models[case]
    assert pb.dump_model() == jb.dump_model()
    assert pb.dump_model(num_iteration=2) == jb.dump_model(num_iteration=2)
    assert pb.inner.to_if_else_cpp() == jb.inner.to_if_else_cpp()
    assert pb.inner.to_if_else_cpp(3) == jb.inner.to_if_else_cpp(3)
    for kind in ("split", "gain"):
        np.testing.assert_array_equal(pb.feature_importance(kind),
                                      jb.feature_importance(kind))
        np.testing.assert_array_equal(pb.feature_importance(kind, 2),
                                      jb.feature_importance(kind, 2))
    np.testing.assert_array_equal(pb.predict(Xq, pred_contrib=True),
                                  jb.predict(Xq, pred_contrib=True))
    assert pb.feature_name() == jb.feature_name()
    assert pb.num_model_per_iteration() == jb.num_model_per_iteration()


@pytest.mark.parametrize("pkg,case", [("jax", "binary"),
                                      ("port", "binary"),
                                      ("port", "multiclass")])
def test_pred_contrib_rows_sum_to_raw_scores(pkg, case):
    """On a model each package trains itself, the contributions of a row
    add up to its raw score (per class)."""
    params = train_params(case)
    rng = np.random.RandomState(5)
    X, y, _ = make_train_data(rng, 400, objective=params["objective"])
    mod, extra = (lgb, {}) if pkg == "jax" else (lgt, CPU)
    bst = mod.train(dict(params, **extra), mod.Dataset(X, label=y), 3)
    contrib = bst.predict(X[:100], pred_contrib=True)
    raw = np.asarray(bst.predict(X[:100], raw_score=True))
    K = 1 if raw.ndim == 1 else raw.shape[1]
    sums = contrib.reshape(100, K, -1).sum(axis=2)
    np.testing.assert_allclose(sums, raw.reshape(100, K), rtol=0, atol=1e-5)


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not available")
def test_if_else_cpp_compiles_to_the_raw_scores(models, tmp_path):
    """The converted model compiled with g++: f64 raw scores equal the
    host tree walk's at 1e-10, as in tests/test_codegen.py."""
    _, pb, Xq = models["nan_missing"]
    src = tmp_path / "model.cpp"
    src.write_text(pb.inner.to_if_else_cpp())
    so = str(tmp_path / "model.so")
    r = subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-std=c++14",
                        "-o", so, str(src)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lib = ctypes.CDLL(so)
    dptr = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    lib.PredictRaw.argtypes = [dptr, dptr]
    lib.PredictRaw.restype = None
    out = np.zeros(1)
    got = []
    for row in np.ascontiguousarray(Xq, np.float64):
        lib.PredictRaw(row, out)
        got.append(out[0])
    np.testing.assert_allclose(got, pb.predict(Xq, raw_score=True), rtol=0,
                               atol=1e-10)


def test_reset_parameter_schedule_gives_the_jax_trees(tmp_path):
    """A learning-rate schedule by list and a lambda_l2 schedule by
    function: the trees (and each tree's shrinkage) equal the JAX
    package's."""
    params = train_params("binary")
    ds, path, _, _, _ = jax_dataset("binary", tmp_path, n=1000)
    lr = [0.2, 0.1, 0.025]
    l2 = [0.0, 4.0, 0.5]
    jb = lgb.train(dict(params), ds, 3, callbacks=[lgb.reset_parameter(
        learning_rate=lr, lambda_l2=lambda i: l2[i])])
    pb = lgt.train(dict(params, **CPU),
                   lgt.dataset_from_reference(path, dict(params, **CPU)), 3,
                   callbacks=[lgt.reset_parameter(
                       learning_rate=lr, lambda_l2=lambda i: l2[i])])
    assert_same_trees(jb.inner.models, pb.inner.models)
    assert [t.shrinkage for t in pb.inner.models] == lr
    assert pb.inner.learner.hp.lambda_l2 == 0.5


def test_booster_reset_parameter_between_updates(tmp_path):
    """``Booster.reset_parameter`` between two ``update`` calls: the port
    grows the JAX package's trees, with a new learner of the one class."""
    params = train_params("regression")
    ds, path, _, _, _ = jax_dataset("regression", tmp_path, n=1000)
    jb = lgb.Booster(dict(params), ds)
    pb = lgt.Booster(dict(params, **CPU),
                     lgt.dataset_from_reference(path, dict(params, **CPU)))
    for b in (jb, pb):
        b.update()
        b.reset_parameter({"num_leaves": 5, "lambda_l2": 2.0})
        b.update()
    assert type(pb.inner.learner).__name__ == "SerialTreeLearner"
    assert pb.inner.learner.hp.lambda_l2 == 2.0
    assert_same_trees(jb.inner.models, pb.inner.models)


def test_reset_parameter_refuses_the_host_on_a_cuda_booster(monkeypatch):
    """``reset_parameter`` (the method and the callback) holds the checks
    that a CUDA booster's setup makes: ``linear_device=off`` and a new
    ``device_type`` raise before anything changes, so no later tree fits
    its leaves on the host. On a host booster ``off`` is taken."""
    import torch

    from lightgbm_tpu_torch import boosting
    from lightgbm_tpu_torch.callback import CallbackEnv

    p = dict(train_params("regression"), linear_tree=True, **CPU)
    X, y = _refit_data("regression", 300, 8)
    bst = lgt.Booster(dict(p), lgt.Dataset(X, label=y, params=dict(p)))
    bst.update()
    learner, lr0 = bst.inner.learner, bst.config.learning_rate
    monkeypatch.setattr(boosting, "resolve_device",
                        lambda _: torch.device("cuda"))
    monkeypatch.setattr(bst.inner, "device", torch.device("cuda"))
    cb = lgt.reset_parameter(linear_device=["off"])
    env = CallbackEnv(bst, p, 0, 0, 1, None)
    for reset in (lambda: bst.reset_parameter({"linear_device": "off"}),
                  lambda: cb(env)):
        with pytest.raises(LightGBMError, match="linear_device=off"):
            reset()
    monkeypatch.setattr(boosting, "resolve_device",
                        lambda d: torch.device("cpu" if d == "cpu"
                                               else "cuda"))
    with pytest.raises(LightGBMError, match="device_type=cpu moves"):
        bst.reset_parameter({"device_type": "cpu", "learning_rate": 0.5})
    assert bst.config.linear_device == "auto"
    assert bst.config.learning_rate == lr0
    assert bst.inner.learner is learner
    monkeypatch.undo()
    bst.reset_parameter({"linear_device": "off"})
    assert bst.config.linear_device == "off"
    assert not bst.inner._linear_fit_on_device()


def _refit_data(objective, n, seed):
    rng = np.random.RandomState(seed)
    return make_train_data(rng, n, objective=objective)[:2]


@pytest.mark.parametrize("case,weighted", [("binary", False),
                                           ("regression", False),
                                           ("binary", True),
                                           ("multiclass", False)])
def test_refit_equals_jax(case, weighted):
    params = train_params(case)
    X, y = _refit_data(params["objective"], 600, 1)
    Xn, yn = _refit_data(params["objective"], 400, 2)
    w = np.random.RandomState(4).rand(400) + 0.5 if weighted else None
    text = lgt.train(dict(params, **CPU), lgt.Dataset(X, label=y),
                     4).model_to_string()
    jr = lgb.Booster(model_str=text).refit(Xn, yn, decay_rate=0.5,
                                           weight=w)
    pr = lgt.Booster(CPU, model_str=text).refit(Xn, yn, decay_rate=0.5,
                                                weight=w)
    assert pr.inner.device.type == "cpu"
    for a, b in zip(jr.inner.models, pr.inner.models):
        np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                   a.leaf_value[:a.num_leaves],
                                   rtol=REFIT_RTOL, atol=REFIT_ATOL)
    before = lgt.Booster(CPU, model_str=text)
    assert any(not np.array_equal(a.leaf_value, b.leaf_value)
               for a, b in zip(before.inner.models, pr.inner.models))
    np.testing.assert_allclose(pr.predict(Xn), jr.predict(Xn), rtol=1e-5,
                               atol=1e-6)


def test_refit_ranking_needs_group():
    rng = np.random.RandomState(6)
    X = np.round(rng.randn(300, 5) * 16) / 64
    y = rng.randint(0, 3, 300).astype(np.float64)
    group = [100, 120, 80]
    params = {"objective": "lambdarank", "num_leaves": 7, "verbosity": -1,
              "min_data_in_leaf": 5, "min_gain_to_split": 1e-3}
    text = lgt.train(dict(params, **CPU),
                     lgt.Dataset(X, label=y, group=group),
                     3).model_to_string()
    with pytest.raises(LightGBMError, match="group"):
        lgt.Booster(CPU, model_str=text).refit(X, y)
    jr = lgb.Booster(model_str=text).refit(X, y, group=group)
    pr = lgt.Booster(CPU, model_str=text).refit(X, y, group=group)
    for a, b in zip(jr.inner.models, pr.inner.models):
        np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                   a.leaf_value[:a.num_leaves],
                                   rtol=REFIT_RTOL, atol=REFIT_ATOL)


def test_refit_keeps_linear_leaves_in_step(models):
    """A linear model's refit moves ``leaf_const`` with the leaf values,
    as the JAX package's does."""
    jb, pb, Xq = models["linear"]
    yq = np.round(Xq[:, 1] * 64) / 64
    jr = jb.refit(np.nan_to_num(Xq), yq)
    pr = pb.refit(np.nan_to_num(Xq), yq)
    for a, b in zip(jr.inner.models, pr.inner.models):
        np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                   a.leaf_value[:a.num_leaves],
                                   rtol=REFIT_RTOL, atol=REFIT_ATOL)
        if a.is_linear:
            np.testing.assert_allclose(b.leaf_const, a.leaf_const,
                                       rtol=REFIT_RTOL, atol=REFIT_ATOL)


def test_cuda_refit_without_card_raises():
    """A booster on the card builds its refit booster there too: without
    a card that raises (no host fallback)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    X, y = _refit_data("binary", 300, 7)
    text = lgt.train(dict(train_params("binary"), **CPU),
                     lgt.Dataset(X, label=y), 2).model_to_string()
    bst = lgt.Booster(CPU, model_str=text)
    bst.config.device_type = "cuda"
    with pytest.raises(LightGBMError, match="CUDA card"):
        bst.refit(X, y)
