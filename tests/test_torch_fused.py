"""The fused K-iteration block of the PyTorch port (``lightgbm_tpu_torch``)
on the CPU: ``FusedTrainer`` against the port's per-iteration path and the
JAX package's fused path, and the device tree loop against the per-split
host loop.

The bars:
- (a) with no valid set and no callback, ``train`` runs fused blocks, and
  the model string is byte-equal to the per-iteration path's (which a user
  callback forces) in every configuration: the device tree loop (the
  one-kernel split on planes and resident) and the host-loop builder
  inside the block (three launches, rows, int8, categorical, EFB), with
  every sampler and block lengths 1, 3 and the default;
- (b) the port's fused path against ``lightgbm_tpu.train`` with the same
  params and no callbacks (the JAX package's fused path): the same trees,
  leaf values and predictions within TRAIN_RTOL / TRAIN_ATOL;
- (c) the device tree loop's ``TreeLog`` equals the host loop's field by
  field (max_depth, basic monotone, min_gain_to_split, two leaves, a tree
  that stops early, the resident layout);
- (d) the device tree loop reads nothing back to the host: with the
  tensor-to-host conversions patched to raise it still grows a tree;
- (e) an all-constant first tree stops training with the tree count of the
  per-iteration path and of the JAX package's fused path;
- (f) readers in the middle of a fused run finalize the block in flight;
  rollback and continued training;
- (g) the ``fused/*`` counters, and ``tree/*`` / ``learner/*`` counts
  equal to the per-iteration path's.
"""
import numpy as np
import pytest
import torch

from torch_port_cases import (CPU, TRAIN_ATOL, TRAIN_RTOL, assert_same_trees,
                              jax_dataset, make_train_data, train_params)

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.obs import telemetry

ROUNDS = 7

#: (training case of torch_port_cases, extra params)
FUSED_CASES = {
    "binary": ("binary", {}),
    "regression": ("regression", {}),
    "multiclass": ("multiclass", {}),
    "bagging": ("binary", {"bagging_fraction": 0.8, "bagging_freq": 1}),
    "balanced_bagging": ("binary", {"pos_bagging_fraction": 0.7,
                                    "neg_bagging_fraction": 0.9,
                                    "bagging_freq": 1}),
    "goss": ("binary", {"data_sample_strategy": "goss",
                        "learning_rate": 0.5}),
    "feature_fraction": ("binary", {"feature_fraction": 0.8}),
    "categorical": ("categorical", {}),
    "efb": ("efb", {}),
    "int8": ("binary", {"use_quantized_grad": True}),
    "split_kernel_planes": ("binary", {"tpu_split_kernel": "on"}),
    "split_kernel_resident": ("nan_missing", {"tpu_split_kernel": "on",
                                              "tpu_resident_state": "on",
                                              "bagging_fraction": 0.8,
                                              "bagging_freq": 1}),
    "block1": ("binary", {"tpu_iter_block": 1}),
    "block3": ("binary", {"tpu_iter_block": 3}),
}


def _data(case, n=1200, seed=3):
    from torch_port_cases import TRAIN_CASES
    spec = TRAIN_CASES[case]
    rng = np.random.RandomState(seed)
    return make_train_data(rng, n, objective=spec["objective"],
                           cat=spec.get("cat", False),
                           nan=spec.get("nan", False),
                           efb=spec.get("efb", False))


def _params(case, extra):
    return dict(train_params(case), **CPU, **extra)


def _train(params, X, y, cats, rounds=ROUNDS, callbacks=None, **kw):
    ds = lgt.Dataset(X, label=y, categorical_feature=cats, params=params)
    return lgt.train(dict(params), ds, rounds, callbacks=callbacks, **kw)


def _eager(params, X, y, cats, rounds=ROUNDS, **kw):
    """The per-iteration path: a user callback disables fusing."""
    return _train(params, X, y, cats, rounds,
                  callbacks=[lambda env: None], **kw)


# ------------------------------------------------------------------- (a)

def _model(bst):
    """The model text less best_iteration, which ``train`` sets and a
    Booster driven by hand leaves at -1."""
    return "\n".join(ln for ln in bst.model_to_string().splitlines()
                     if not ln.startswith("best_iteration="))


@pytest.mark.parametrize("name", sorted(FUSED_CASES))
def test_fused_equals_per_iteration(name):
    case, extra = FUSED_CASES[name]
    X, y, cats = _data(case)
    params = _params(case, extra)
    telemetry.reset()
    fused = _train(params, X, y, cats)
    block = int(extra.get("tpu_iter_block", 10))
    assert telemetry.counter("fused/blocks_dispatched") == \
        -(-ROUNDS // block)
    # the device tree loop takes every configuration on the card
    device_loop = fused.inner.learner.device_loop_eligible()
    assert device_loop
    eager = _eager(params, X, y, cats)
    assert fused.current_iteration == eager.current_iteration == ROUNDS
    assert fused.model_to_string() == eager.model_to_string()
    np.testing.assert_array_equal(fused.inner.train_score.np(),
                                  eager.inner.train_score.np())
    if device_loop:
        # the card's builder, the device tree loop, inside the same blocks
        # on the host (where the trainer takes the host loop by default)
        from lightgbm_tpu_torch.fused import FusedTrainer
        bst = lgt.Booster(dict(params), lgt.Dataset(
            X, label=y, categorical_feature=cats, params=params))
        bst.inner._fused = FusedTrainer(bst.inner)
        bst.inner._fused.device_loop = True
        assert bst.inner.train_block(ROUNDS) is False
        bst.inner.finish_fused("test")
        assert bst.inner.learner._loop is not None
        assert _model(bst) == _model(eager)
        np.testing.assert_array_equal(bst.inner.train_score.np(),
                                      eager.inner.train_score.np())


# ------------------------------------------------------------------- (b)

@pytest.mark.parametrize("name", ["binary", "regression", "multiclass"])
def test_fused_equals_jax_fused(tmp_path, name):
    ds, path, X, _, _ = jax_dataset(name, tmp_path, n=1000, seed=2)
    params = train_params(name)
    jb = lgb.train(dict(params), ds, 5)          # the JAX fused path
    assert jb.inner._fused is not None
    pb = lgt.train(dict(params, **CPU), lgt.dataset_from_reference(path, CPU),
                   5)
    assert pb.inner._fused is not None
    assert pb.current_iteration == jb.current_iteration == 5
    assert_same_trees(jb.inner.models, pb.inner.models)
    np.testing.assert_allclose(pb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True),
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    np.testing.assert_allclose(pb.inner.train_score.np(),
                               np.asarray(jb.inner.train_score.score),
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)


# ------------------------------------------------------------------- (c)

def _learner(extra, n=1500, seed=0):
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, 6) * 64) / 64
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.randn(n) * 0.5 > 0).astype(float)
    X[rng.rand(n) < 0.05, 2] = np.nan
    p = dict({"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "min_data_in_leaf": 5, "tpu_split_kernel": "on"}, **CPU,
             **extra)
    bst = lgt.Booster(p, lgt.Dataset(X, label=y, params=p))
    g = bst.inner
    grad, hess = g.objective.get_gradients(g.train_score.score)
    inbag = (torch.as_tensor(rng.rand(n)) < 0.8).to(torch.float32)
    ghc = torch.stack([grad * inbag, hess * inbag, inbag], dim=1)
    return g.learner, ghc


LOOP_CASES = {
    "plain": {},
    "max_depth": {"max_depth": 3},
    "monotone": {"monotone_constraints": [1, -1, 0, 0, 1, 0],
                 "monotone_penalty": 1.5},
    "min_gain": {"min_gain_to_split": 2.0},
    "two_leaves": {"num_leaves": 2},
    "stops_early": {"min_data_in_leaf": 400},
    "resident": {"tpu_resident_state": "on", "max_depth": 4},
}


@pytest.mark.parametrize("name", sorted(LOOP_CASES))
def test_device_loop_log_equals_host_loop(name):
    lrn, ghc = _learner(LOOP_CASES[name])
    fmask = torch.ones(lrn.dataset.num_features, dtype=torch.bool)
    fmask[3] = False
    want = lrn.train(ghc, fmask)
    want_stats = dict(lrn.last_stats)
    got = lrn.train_device(ghc, fmask)
    ns = int(want.num_splits[0])
    if name == "stops_early":
        assert 0 < ns < lrn.num_leaves - 1
    elif name == "two_leaves":
        assert ns == 1
    for fld in got._fields:
        assert torch.equal(getattr(got, fld), getattr(want, fld)), fld
    assert torch.equal(lrn.last_stats["leaf_cnt"], want_stats["leaf_cnt"])
    assert torch.equal(lrn.last_stats["hist_cnt"], want_stats["hist_cnt"])
    # a second tree through the same loop (its buffers reused)
    again = lrn.train_device(ghc * 0.5, fmask)
    want2 = lrn.train(ghc * 0.5, fmask)
    for fld in got._fields:
        assert torch.equal(getattr(again, fld), getattr(want2, fld)), fld


# ------------------------------------------------------------------- (d)

def test_device_loop_makes_no_host_read(monkeypatch):
    lrn, ghc = _learner({"monotone_constraints": [1, 0, 0, 0, -1, 0],
                         "max_depth": 5})
    want = lrn.train(ghc)

    def refuse(*_args, **_kwargs):
        raise AssertionError("a host read inside the device tree loop")

    for attr in ("item", "tolist", "__bool__", "__int__", "__float__",
                 "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, attr, refuse)
    with pytest.raises(AssertionError, match="host read"):
        bool(ghc[0, 0] > 0)
    got = lrn.train_device(ghc)
    monkeypatch.undo()
    assert int(got.num_splits[0]) == int(want.num_splits[0]) > 1
    for fld in got._fields:
        assert torch.equal(getattr(got, fld), getattr(want, fld)), fld


# ------------------------------------------------------------------- (e)

@pytest.mark.parametrize("block", [1, 3])
def test_all_constant_first_tree_stops(tmp_path, block):
    ds, path, X, y, _ = jax_dataset("binary", tmp_path, n=600, seed=6)
    params = dict(train_params("binary"), min_gain_to_split=1e9,
                  tpu_iter_block=block)
    jb = lgb.train(dict(params), ds, ROUNDS)
    pb = lgt.train(dict(params, **CPU), lgt.dataset_from_reference(path, CPU),
                   ROUNDS)
    assert pb.num_trees() == jb.num_trees() == block
    assert all(t.num_leaves == 1 for t in pb.inner.models)
    if block == 1:
        eager = lgt.train(dict(params, **CPU),
                          lgt.dataset_from_reference(path, CPU), ROUNDS,
                          callbacks=[lambda env: None])
        assert eager.num_trees() == pb.num_trees()
        assert eager.model_to_string() == pb.model_to_string()


# ------------------------------------------------------------------- (f)

@pytest.mark.parametrize("split_kernel", ["off", "on"])
def test_readers_mid_run_and_rollback(split_kernel):
    X, y, cats = _data("binary", n=900)
    params = _params("binary", {"tpu_split_kernel": split_kernel})
    ref = {r: _eager(params, X, y, cats, r) for r in (2, 3, 5)}
    bst = lgt.Booster(dict(params), lgt.Dataset(X, label=y, params=params))
    telemetry.reset()
    assert bst.inner.train_block(3) is False     # block in flight
    assert len(bst.inner.models) == 0
    assert bst.num_trees() == 3                  # the reader finalizes it
    assert telemetry.counter("fused/flush/num_trees") == 1
    assert _model(bst) == _model(ref[3])
    bst.inner.train_block(2)
    np.testing.assert_array_equal(bst.predict(X), ref[5].predict(X))
    assert telemetry.counter("fused/flush/predict") == 1
    assert bst.current_iteration == 5
    assert _model(bst) == _model(ref[5])
    bst.rollback_one_iter()
    bst.rollback_one_iter()
    bst.rollback_one_iter()
    assert bst.current_iteration == 2
    assert _model(bst) == _model(ref[2])
    np.testing.assert_allclose(bst.inner.train_score.np(),
                               ref[2].inner.train_score.np(), rtol=1e-6,
                               atol=1e-7)


def test_continued_training_fused():
    X, y, cats = _data("binary", n=900)
    params = _params("binary", {})
    first = _train(params, X, y, cats, 3)
    fused = _train(params, X, y, cats, 2, init_model=first)
    eager = _eager(params, X, y, cats, 2, init_model=first)
    assert fused.inner._fused is not None
    assert fused.current_iteration == 5
    assert fused.model_to_string() == eager.model_to_string()


# ------------------------------------------------------------------- (g)

def _counters():
    return {k: v for k, v in telemetry.snapshot()["counters"].items()
            if k.startswith(("tree/", "learner/"))}


@pytest.mark.parametrize("split_kernel", ["off", "on"])
def test_fused_counters(split_kernel):
    X, y, cats = _data("binary", n=900)
    params = _params("binary", {"tpu_split_kernel": split_kernel,
                                "tpu_iter_block": 3})
    telemetry.reset()
    _eager(params, X, y, cats)
    want = _counters()
    telemetry.reset()
    _train(params, X, y, cats)
    assert telemetry.counter("fused/blocks_dispatched") == 3
    assert telemetry.counter("fused/iters_dispatched") == ROUNDS
    assert telemetry.counter("fused/flush/train_end") == 1
    assert _counters() == want
    assert want["tree/trees"] == ROUNDS
