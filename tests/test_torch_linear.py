"""Linear-tree training of the PyTorch port (``lightgbm_tpu_torch``)
against the JAX package, on the CPU.

The bars:
- ``linear/fit.leaf_feature_table`` equal to the JAX package's on the same
  trees;
- ``fit_leaves_plain`` (the Gram kernel's twin and the batched solve)
  against JAX ``fit_leaves_impl`` jitted on the CPU, on 1/64-grid inputs
  whose Gram sums are exact in f32 in both packages: ``fit_ok`` equal and
  the coefficients within FIT_RTOL (two f32 LU solves of the same system);
  NaN rows, an under-determined leaf, a singular one, a ridge and a leaf
  without features among the cases;
- training with ``linear_device=off`` (the host f64 oracle in both
  packages) and ``on`` (the batched f32 fit in both): the same trees,
  every leaf's features equal, coefficients and constants within
  COEF_TOL of each fit, raw predictions on the training and valid
  rows within TRAIN_RTOL / TRAIN_ATOL, ``pred_leaf`` equal and the valid
  metrics within METRIC_RTOL;
- ``linear_device`` validation, ``auto`` as the host oracle on the host,
  the model text round trip, and the refusal of two-round loading.
"""
import numpy as np
import pytest
import torch

import jax

from torch_port_cases import (CPU, TRAIN_ATOL, TRAIN_RTOL, assert_same_trees,
                              one_torch_thread, torch_threads)

import lightgbm_tpu as lgb
from lightgbm_tpu.linear.fit import fit_leaves_impl as jax_fit_leaves
from lightgbm_tpu.linear.fit import leaf_feature_table as jax_table

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.linear import fit as LF
from lightgbm_tpu_torch.utils.log import LightGBMError

#: f32 solves of one system by two LAPACK calls (jax and torch): the
#: coefficients of a well-conditioned leaf within this relative tolerance
FIT_RTOL = 1e-4
#: fitted coefficients and constants, port vs JAX, after training: the
#: gradients differ by an ulp (exp in XLA vs torch) and the leaf values by
#: the histograms' summation order; the f64 oracles solve exactly what
#: they are given, while the batched f32 fits sum the Gram terms in
#: another order and solve in f32, which a leaf's condition number
#: (~10-100 here) amplifies
COEF_TOL = {"off": (TRAIN_RTOL, 1e-6), "on": (1e-3, 1e-5)}
METRIC_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """Every test here trains on the host: one torch thread
    (torch_port_cases.one_torch_thread)."""


@pytest.fixture(autouse=True, scope="module")
def _one_thread_module():
    """Module-scoped fixtures run before function-scoped ones: one torch
    thread for them too."""
    with torch_threads(1):
        yield


# ---------------------------------------------------------------- the fit

def _fit_case(name, rng, n=600, F=6, L=8, km=4):
    """numpy inputs of one fit case on 1/64 grids: raw features X, the
    rows' leaves, g and h, per-leaf feature tables and the ridge."""
    X = np.round(rng.randn(n, F) * 32) / 64
    row_leaf = rng.randint(0, L - 1, n).astype(np.int32)
    g = np.round(rng.randn(n) * 64) / 64
    h = np.round((np.abs(rng.randn(n)) + 0.25) * 64) / 64
    feat_idx = np.zeros((L, km), np.int32)
    feat_mask = np.zeros((L, km), bool)
    for l in range(1, L):
        k = 1 + l % km
        feat_idx[l, :k] = np.sort(rng.choice(F, k, replace=False))
        feat_mask[l, :k] = True
    lam = 0.0
    if name == "nan":
        X[rng.rand(n, F) < 0.1] = np.nan
    elif name == "under_determined":
        # leaf 3 has 3 features and 3 rows: fewer than k + 1
        rows = np.flatnonzero(row_leaf == 3)
        row_leaf[rows[3:]] = 1
    elif name == "singular":
        # leaf 2's one feature is constant on its rows: its column is the
        # intercept's times 0.5, and without a ridge A is singular
        X[row_leaf == 2, feat_idx[2, 0]] = 0.5
    elif name == "ridge":
        lam = 0.75
    elif name == "out_of_bag":
        oob = rng.rand(n) < 0.3
        g[oob], h[oob] = 0.0, 0.0
    return X.astype(np.float32), row_leaf, g, h, feat_idx, feat_mask, lam


@pytest.mark.parametrize("case", ["basic", "nan", "under_determined",
                                  "singular", "ridge", "out_of_bag"])
def test_fit_leaves_plain_matches_jax(case):
    rng = np.random.RandomState(["basic", "nan", "under_determined",
                                 "singular", "ridge",
                                 "out_of_bag"].index(case))
    X, rl, g, h, fi, fm, lam = _fit_case(case, rng)
    jb, jok = jax.jit(jax_fit_leaves)(X, rl, g.astype(np.float32),
                                      h.astype(np.float32), fi, fm,
                                      np.float32(lam))
    jb, jok = np.asarray(jb), np.asarray(jok)
    pb, pok = LF.fit_leaves_plain(
        torch.as_tensor(X), torch.as_tensor(rl),
        torch.as_tensor(g.astype(np.float32)),
        torch.as_tensor(h.astype(np.float32)), torch.as_tensor(fi),
        torch.as_tensor(fm), lam)
    np.testing.assert_array_equal(pok.numpy(), jok)
    assert not pok[0]                           # no features
    if case == "under_determined":
        assert not pok[3]
    if case == "singular":
        assert not pok[2]
    assert pok.any()
    ok = pok.numpy()
    np.testing.assert_allclose(pb.numpy()[ok], jb[ok], rtol=FIT_RTOL,
                               atol=1e-6)


def test_gram_sums_plain_are_the_oracle_sums():
    """The twin's Gram sums equal the f64 sums of the host oracle's design
    matrices on exact inputs (NaN rows dropped, the intercept last), and
    the counts are the leaf's rows and NaN-free rows."""
    rng = np.random.RandomState(11)
    X, rl, g, h, fi, fm, _ = _fit_case("nan", rng)
    s = LF.gram_sums_plain(torch.as_tensor(X), torch.as_tensor(rl),
                           torch.as_tensor(g.astype(np.float32)),
                           torch.as_tensor(h.astype(np.float32)),
                           torch.as_tensor(fi), torch.as_tensor(fm))
    for l in range(1, fi.shape[0] - 1):
        feats = fi[l][fm[l]]
        rows = np.flatnonzero(rl == l)
        Z = X[np.ix_(rows, feats)].astype(np.float64)
        ok = ~np.isnan(Z).any(axis=1)
        Zk = np.concatenate([Z[ok], np.ones((int(ok.sum()), 1))], axis=1)
        k = len(feats)
        A = Zk.T @ (Zk * h[rows][ok][:, None])
        B = Zk.T @ g[rows][ok]
        idx = list(range(k)) + [fi.shape[1]]
        got_a = s.A[l].numpy()[np.ix_(idx, idx)]
        np.testing.assert_array_equal(got_a, A.astype(np.float32))
        np.testing.assert_array_equal(s.B[l].numpy()[idx],
                                      B.astype(np.float32))
        assert s.cnt[l] == len(rows) and s.vcnt[l] == int(ok.sum())


def test_gram_plan_sizes():
    """The Gram kernel's plan: up to 8 leaves a block while their
    accumulators fit, row slices that cover every row in 256-row tiles,
    and a refusal past a block's shared memory."""
    p = LF.gram_plan(2_000_000, 255, 32)
    assert p.leaves == 8 and p.rows % LF.GRAM_TILE == 0
    assert p.slices * p.rows >= 2_000_000 > (p.slices - 1) * p.rows
    assert -(-255 // p.leaves) * p.slices >= LF.GRAM_TARGET_BLOCKS // 2
    assert LF.gram_plan(100, 31, 128).leaves == 1
    assert LF.gram_plan(0, 1, 1).slices == 1
    with pytest.raises(ValueError, match="shared memory"):
        LF.gram_plan(1000, 31, 256)


# ------------------------------------------------------------- training

def _linear_data(rng, n, f=5, nan=False, cat=False, classes=0):
    """(X, y) on 1/64 grids: a piecewise-linear target."""
    X = np.round(rng.randn(n, f) * 32) / 64
    z = 0.6 * X[:, 0] - 0.4 * X[:, 1] * (X[:, 2] > 0) + 0.2 * X[:, 3] \
        + 0.1 * np.round(rng.randn(n) * 16) / 64
    if cat:
        X[:, 4] = rng.randint(0, 6, n)
        z = z + 0.3 * np.isin(X[:, 4], (1, 3))
    if classes:
        y = np.digitize(z, [-0.2, 0.2][:classes - 1]).astype(np.float64)
    else:
        y = np.round(z * 64) / 64
    if nan:
        X[rng.rand(n, f) < 0.08] = np.nan
        if cat:
            X[np.isnan(X[:, 4]), 4] = 0
    return X, y


CASES = {
    "regression": dict(objective="regression"),
    "nan": dict(objective="regression", nan=True),
    "binary": dict(objective="binary", classes=2),
    "multiclass": dict(objective="multiclass", num_class=3, classes=3),
    # one-vs-rest categorical splits (a many-vs-many split and its
    # complement tie up to rounding: ROADMAP C)
    "categorical": dict(objective="regression", cat=True,
                        max_cat_to_onehot=8),
}


def _params(case, device, **kw):
    spec = dict(CASES[case])
    for k in ("nan", "cat", "classes"):
        spec.pop(k, None)
    p = dict(spec, num_leaves=8, verbosity=-1, linear_tree=True,
             linear_lambda=0.01, learning_rate=0.2, min_data_in_leaf=20,
             min_gain_to_split=1e-3, linear_device=device, seed=7)
    p.update(kw)
    return p


def _train_both(case, device, rounds=3, n=1200, valid=300, seed=0, **kw):
    """(JAX booster, port booster, X, Xv, yv, JAX evals, port evals) of one
    case: the same data and params, a valid set, recorded metrics."""
    spec = CASES[case]
    rng = np.random.RandomState(seed)
    X, y = _linear_data(rng, n + valid, nan=spec.get("nan", False),
                        cat=spec.get("cat", False),
                        classes=spec.get("classes", 0))
    Xv, yv, X, y = X[n:], y[n:], X[:n], y[:n]
    cats = [4] if spec.get("cat") else []
    p = _params(case, device, **kw)
    dj = lgb.Dataset(X, label=y, params=dict(p), categorical_feature=cats)
    vj = lgb.Dataset(Xv, label=yv, reference=dj)
    ej, et = {}, {}
    jb = lgb.train(p, dj, num_boost_round=rounds, valid_sets=[vj],
                   valid_names=["v"], callbacks=[lgb.record_evaluation(ej)])
    pc = dict(p, **CPU)
    dt = lgt.Dataset(X, label=y, params=dict(pc), categorical_feature=cats)
    vt = lgt.Dataset(Xv, label=yv, reference=dt)
    pb = lgt.train(pc, dt, num_boost_round=rounds, valid_sets=[vt],
                   valid_names=["v"], callbacks=[lgt.record_evaluation(et)])
    return jb, pb, X, Xv, yv, ej, et


def _assert_linear_models(jb, pb, device):
    """The same trees; each leaf's linear features equal, coefficients and
    constants within COEF_TOL of the fit. Returns the number of leaves
    with coefficients."""
    rtol, atol = COEF_TOL[device]
    jm, pm = jb.inner.models, pb.inner.models
    assert_same_trees(jm, pm)
    fitted = 0
    for i, (a, b) in enumerate(zip(jm, pm)):
        assert a.is_linear and b.is_linear, i
        assert sorted(a.leaf_coeff) == sorted(b.leaf_coeff), i
        np.testing.assert_allclose(b.leaf_const[:b.num_leaves],
                                   a.leaf_const[:a.num_leaves],
                                   rtol=rtol, atol=atol)
        for leaf in a.leaf_coeff:
            np.testing.assert_array_equal(b.leaf_features[leaf],
                                          a.leaf_features[leaf])
            np.testing.assert_allclose(
                np.asarray(b.leaf_coeff[leaf], np.float64),
                np.asarray(a.leaf_coeff[leaf], np.float64),
                rtol=rtol, atol=atol, err_msg="tree %d leaf %d" % (i, leaf))
            fitted += len(a.leaf_coeff[leaf]) > 0
    return fitted


@pytest.mark.parametrize("device", ["off", "on"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_training_matches_jax(case, device):
    """Both fits (``off``: the f64 oracles; ``on``: the batched f32 fits)
    through training with a valid set: trees and linear leaves, raw
    predictions on both sets, pred_leaf and the valid metrics."""
    rounds = 2 if case == "multiclass" else 3
    jb, pb, X, Xv, _, ej, et = _train_both(case, device, rounds=rounds)
    assert _assert_linear_models(jb, pb, device) > 0
    for rows in (X, Xv):
        np.testing.assert_allclose(pb.predict(rows, raw_score=True),
                                   jb.predict(rows, raw_score=True),
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
        np.testing.assert_array_equal(pb.predict(rows, pred_leaf=True),
                                      jb.predict(rows, pred_leaf=True))
    assert set(et["v"]) == set(ej["v"])
    for m in ej["v"]:
        np.testing.assert_allclose(et["v"][m], ej["v"][m], rtol=METRIC_RTOL)


def test_host_oracle_equals_jax_oracle_text(tmp_path):
    """With the f64 host oracles both packages write the same model text
    up to the printed digits of the fitted values, and the port's model
    read back from its text predicts what the trained one does."""
    jb, pb, X, Xv, _, _, _ = _train_both("nan", "off", rounds=3)
    jt, pt = jb.model_to_string(), pb.model_to_string()
    jl, pl = jt.splitlines(), pt.splitlines()
    assert len(jl) == len(pl)
    same = [a == b for a, b in zip(jl, pl)]
    keys = {a.split("=")[0] for a, s in zip(jl, same) if not s}
    assert keys <= {"leaf_value", "leaf_const", "leaf_coeff",
                    "internal_value", "split_gain", "leaf_weight",
                    "internal_weight"}, keys
    path = tmp_path / "m.txt"
    pb.save_model(str(path))
    loaded = lgt.Booster(CPU, model_file=str(path))
    for rows in (X, Xv):
        np.testing.assert_allclose(loaded.predict(rows), pb.predict(rows),
                                   rtol=0, atol=1e-12)


def test_auto_is_the_host_oracle_on_the_host():
    """``linear_device=auto`` fits with the host oracle on the host (the
    JAX package's rule: the batched fit only on an accelerator), so its
    model equals ``off``'s byte for byte; ``on`` takes the batched fit."""
    rng = np.random.RandomState(3)
    X, y = _linear_data(rng, 1000)
    models = {}
    for dev in ("auto", "off", "on"):
        p = dict(_params("regression", dev), **CPU)
        bst = lgt.train(p, lgt.Dataset(X, label=y, params=dict(p)), 3)
        models[dev] = bst
    assert not models["auto"].inner._linear_fit_on_device()
    assert models["on"].inner._linear_fit_on_device()
    assert models["auto"].model_to_string() == \
        models["off"].model_to_string()


def test_linear_device_validated():
    with pytest.raises(LightGBMError, match="linear_device"):
        lgt.train(dict(_params("regression", "gpu"), **CPU),
                  lgt.Dataset(np.zeros((50, 2)), label=np.zeros(50)), 1)


def test_linear_device_off_refused_on_a_cuda_learner(monkeypatch):
    """``linear_device=off`` is the host learner's oracle: a learner on a
    CUDA device refuses it before it touches the device (the card fits
    the leaves with the Gram kernel, and the host is no fallback)."""
    from lightgbm_tpu_torch import boosting
    from lightgbm_tpu_torch.config import Config

    p = dict(_params("regression", "off"), **CPU)
    binned = lgt.Dataset(np.zeros((50, 2)), label=np.zeros(50),
                         params=dict(p)).construct()
    monkeypatch.setattr(boosting, "resolve_device",
                        lambda _: torch.device("cuda"))
    with pytest.raises(LightGBMError, match="linear_device=off"):
        boosting.GBDT(Config.from_params(p), binned)
    for mode in ("auto", "on"):
        cfg = Config.from_params(dict(p, linear_device=mode))
        assert boosting.GBDT(cfg).device.type == "cuda"


def test_first_tree_and_renewing_objectives_keep_constants():
    """The first iteration copies constants only (the reference skips the
    fit), as in the JAX package; an objective that renews its leaves (L1)
    trains plain trees."""
    rng = np.random.RandomState(4)
    X, y = _linear_data(rng, 800)
    p = dict(_params("regression", "on"), **CPU)
    bst = lgt.train(p, lgt.Dataset(X, label=y, params=dict(p)), 2)
    t0 = bst.inner.models[0]
    assert t0.is_linear and not any(len(c) for c in t0.leaf_coeff.values())
    assert any(len(c) for c in bst.inner.models[1].leaf_coeff.values())
    pl1 = dict(p, objective="regression_l1")
    jp = dict(pl1)
    jp.pop("device_type")
    jb = lgb.train(jp, lgb.Dataset(X, label=y, params=dict(jp)), 2)
    pb = lgt.train(pl1, lgt.Dataset(X, label=y, params=dict(pl1)), 2)
    assert_same_trees(jb.inner.models, pb.inner.models)
    assert not any(t.is_linear for t in pb.inner.models)


def test_leaf_feature_table_matches_jax():
    """Each tree's padded feature tables equal the JAX package's:
    branch-path numerical features only (the categorical feature never
    enters), padded to a power of two and to num_leaves leaves."""
    jb, pb, _, _, _, _, _ = _train_both("categorical", "on", rounds=3)
    jds = jb.train_dataset.construct()
    pds = pb.train_dataset.construct()
    seen = 0
    for jt, pt in zip(jb.inner.models, pb.inner.models):
        a = jax_table(jt, jds, 8)
        b = LF.leaf_feature_table(pt, pds, 8)
        assert (a is None) == (b is None)
        if a is None:
            continue
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
        assert not np.isin(4, b[0][b[1]])
        seen += 1
    assert seen > 0


def test_two_round_loading_refuses_linear_trees(tmp_path):
    """Two-round loading keeps no raw values: with linear trees it is
    fatal, as in the JAX package."""
    from lightgbm_tpu_torch import io as port_io
    from lightgbm_tpu_torch.config import Config

    path = tmp_path / "d.csv"
    rng = np.random.RandomState(5)
    X, y = _linear_data(rng, 100)
    np.savetxt(path, np.column_stack([y, X]), delimiter=",")
    with pytest.raises(LightGBMError, match="two_round"):
        port_io.load_dataset_two_round(str(path), Config.from_params(
            dict(CPU, linear_tree=True)))
