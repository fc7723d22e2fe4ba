"""The intermediate and advanced monotone constraint methods of the
PyTorch port (``lightgbm_tpu_torch``) on the CPU, against the JAX package.

The bars:
- (a) the five state helpers (``ops/monotone.adv_*``) equal the JAX
  package's ``_adv_*`` exactly, on random states (L = 15, F = 5, B = 16,
  mixed signs, bounds on a coarse grid so that ties occur), numerical and
  categorical winners, valid and invalid rounds; the two kernels' plain
  twins (``mono_bounds``, ``mono_commit``) equal the helpers;
- (b) one tree by each package's learner from the same (grad, hess,
  inbag) channels under each method, alone, with forced splits and with
  max_depth: the same splits, leaf values within TRAIN_RTOL / TRAIN_ATOL;
- (c) the device tree loop (the card's tree loop, on its plain twins
  here) grows the host loop's tree field by field, and reads nothing back
  to the host;
- (d) fused blocks give the per-iteration model byte for byte, the device
  loop inside them too; the port's fused training against the JAX fused
  path, 5 rounds (one int8 rows case);
- (e) mirrors of tests/test_monotone.py: monotone predictions under both
  methods, advanced not downgraded, and advanced fitting better than
  intermediate on the restricted-neighbour case; with three or more
  features both packages grow the same trees under the two methods, on
  that case and on chip_smoke.py's phase-3i data (and different ones on
  its two pair columns).

The parity cases set ``min_gain_to_split=1e-3`` (torch_port_cases).
"""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_port_cases import (CPU, TRAIN_ATOL, TRAIN_RTOL, assert_same_trees,
                              make_train_data, one_torch_thread, train_params)

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu import learner as JL

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import monotone as M
from lightgbm_tpu_torch.prng import PRNGKey


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """Training-heavy: one torch thread (torch_port_cases)."""


METHODS = ("intermediate", "advanced")
#: constraints of make_train_data's 8 features (its label weights are +,
#: -, +, -, +, -, +, +): feature 2 against its weight, so the bounds bite
MONOTONE = [1, -1, -1, 0, 1, 0, 1, 0]

# ------------------------------------------------------------------- (a)

L, F, B = 15, 5, 16


def _state(rng):
    """A random advanced state: boxes inside each feature's bins, bounds
    on a 1/8 grid (ties), a third of them unbounded."""
    nb = rng.randint(6, B + 1, F).astype(np.int32)
    lo = rng.randint(0, nb - 1, size=(L, F))
    hi = lo + 1 + (rng.rand(L, F) * (nb - 1 - lo)).astype(np.int64)
    cons_lo = rng.randint(-12, 4, size=(L, F, B)) / 8.0
    cons_hi = rng.randint(-4, 12, size=(L, F, B)) / 8.0
    cons_lo[rng.rand(L, F, B) < 0.3] = -np.inf
    cons_hi[rng.rand(L, F, B) < 0.3] = np.inf
    mono = rng.randint(-1, 2, F).astype(np.int8)
    return (nb, cons_lo.astype(np.float32), cons_hi.astype(np.float32),
            lo.astype(np.int32), hi.astype(np.int32), mono)


def _both(*arrays):
    return (tuple(jnp.asarray(a) for a in arrays),
            tuple(torch.as_tensor(a) for a in arrays))


def _equal(jax_arrays, torch_arrays):
    for a, b in zip(jax_arrays, torch_arrays):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b), np.argwhere(a != b)[:4]


def _infos(rng, kind, nb):
    f = int(rng.randint(F))
    t = int(rng.randint(max(1, nb[f] - 1)))
    wl, wr = (rng.randint(-16, 16, 2) / 8.0).astype(np.float32)
    j = SimpleNamespace(kind=jnp.int32(kind), feature=jnp.int32(f),
                        bin=jnp.int32(t), left_output=jnp.float32(wl),
                        right_output=jnp.float32(wr))
    p = SimpleNamespace(kind=torch.tensor(kind), feature=torch.tensor(f),
                        bin=torch.tensor(t), left_output=torch.tensor(wl),
                        right_output=torch.tensor(wr))
    return j, p


@pytest.mark.parametrize("seed", range(4))
def test_state_init_and_bounds_match_jax(seed):
    rng = np.random.RandomState(seed)
    nb, cons_lo, cons_hi, lo, hi, _ = _state(rng)
    meta = SimpleNamespace(num_bins=jnp.asarray(nb))
    _equal(JL._adv_boxes_init(L, F, meta),
           M.adv_boxes_init(L, F, torch.as_tensor(nb)))
    _equal(JL._adv_init(L, F, B, meta),
           M.adv_init(L, F, B, torch.as_tensor(nb)))
    jadv, padv = _both(cons_lo, cons_hi, lo, hi)
    if seed == 3:      # one feature: the exclude-one extremum is +/-inf
        jadv, padv = _both(cons_lo[:, :1], cons_hi[:, :1], lo[:, :1],
                           hi[:, :1])
    for leaf in range(L):
        _equal(JL._adv_bounds_of(jadv, jnp.int32(leaf)),
               M.adv_bounds_of(padv, leaf))
    # a leaf as a device word, as the tree loops pass it
    _equal(JL._adv_bounds_of(jadv, jnp.int32(4)),
           M.adv_bounds_of(padv, torch.tensor([4], dtype=torch.int32)))


@pytest.mark.parametrize("kind,valid", [(0, True), (2, True), (0, False)])
def test_commit_helpers_match_jax(kind, valid):
    rng = np.random.RandomState(11 + kind + 3 * valid)
    nb, cons_lo, cons_hi, lo, hi, mono = _state(rng)
    jadv, padv = _both(cons_lo, cons_hi, lo, hi)
    for leaf, new in ((0, 1), (3, 7), (6, 14)):
        jinfo, pinfo = _infos(rng, kind, nb)

        def jsel(a, b):
            return jnp.where(valid, a, b)

        def psel(a, b):
            return torch.where(torch.tensor(valid), a, b)

        jb = JL._adv_child_boxes(jadv[2], jadv[3], jsel, leaf, new, jinfo)
        pb = M.adv_child_boxes(padv[2], padv[3], psel, leaf, new, pinfo)
        _equal(jb[:2], pb[:2])
        _equal(jb[2] + jb[3], pb[2] + pb[3])
        for c_box in (jb[2], jb[3]):
            _equal([JL._adv_overlap_except(jb[0], jb[1], *c_box)],
                   [M.adv_overlap_except(pb[0], pb[1],
                                         *(torch.as_tensor(np.array(x))
                                           for x in c_box))])
        meta = SimpleNamespace(monotone=jnp.asarray(mono))
        jadv = JL._adv_commit(jadv, meta, jsel, leaf, new, jinfo, B)
        padv = M.adv_commit(padv, torch.as_tensor(mono), psel, leaf, new,
                            pinfo, B)
        _equal(jadv, padv)
    if not valid:
        _equal(_both(cons_lo, cons_hi, lo, hi)[1], padv)


@pytest.mark.parametrize("seed", range(3))
def test_kernel_twins_equal_the_helpers(seed):
    """mono_bounds' and mono_commit's plain twins (the wrappers on host
    tensors) against adv_bounds_of and adv_commit, with the live word 0
    writing nothing."""
    rng = np.random.RandomState(40 + seed)
    nb, cons_lo, cons_hi, lo, hi, mono = _state(rng)
    _, adv = _both(cons_lo, cons_hi, lo, hi)
    out = torch.full((2, 4, F, B), 9.0)
    leaf, new = 2, 5
    M.mono_bounds(*adv, torch.tensor([leaf], dtype=torch.int32), new, 2, out)
    for node, lf in enumerate((leaf, new)):
        want = torch.stack(M.adv_bounds_of(adv, lf))
        assert torch.equal(out[node], want)
    before = out.clone()
    M.mono_bounds(*adv, torch.tensor([7], dtype=torch.int32), 0, 1, out,
                  live=torch.zeros(1, dtype=torch.int32))
    assert torch.equal(out, before)
    M.mono_bounds(*adv, torch.tensor([7], dtype=torch.int32), 0, 1, out)
    assert torch.equal(out[0], torch.stack(M.adv_bounds_of(adv, 7)))
    assert torch.equal(out[1], before[1])
    # mono_commit: the boxes already cut (the split commit's), then writes
    _, pinfo = _infos(rng, 0, nb)
    sel = (lambda a, b: a)
    rl, rh, _, _ = M.adv_child_boxes(adv[2], adv[3], sel, leaf, new, pinfo)
    want = M.adv_commit(adv, torch.as_tensor(mono), sel, leaf, new, pinfo,
                        B)
    state = [adv[0].clone(), adv[1].clone(), rl, rh]
    outs = torch.stack([pinfo.left_output, pinfo.right_output])
    for live in (0, 1):
        M.mono_commit(*state, torch.as_tensor(mono),
                      torch.tensor([live, leaf], dtype=torch.int32), outs,
                      new)
        if not live:
            assert torch.equal(state[0], adv[0])
            assert torch.equal(state[1], adv[1])
    for a, b in zip(state, want):
        assert torch.equal(a, b)


# ------------------------------------------------------------------- (b)

def _forced_file(tmp_path):
    t = {"feature": 0, "threshold": 0.05,
         "left": {"feature": 1, "threshold": -0.1,
                  "left": {"feature": 2, "threshold": 0.0}},
         "right": {"feature": 2, "threshold": 0.2}}
    path = os.path.join(str(tmp_path), "forced.json")
    with open(path, "w") as f:
        json.dump(t, f)
    return path


def _extra(variant, tmp_path):
    return {"alone": {},
            "forced": {"forcedsplits_filename": _forced_file(tmp_path)},
            "max_depth": {"max_depth": 4, "num_leaves": 31}}[variant]


def _datasets(tmp_path, params, n=1500, seed=2):
    """(JAX Dataset, port Dataset, X, y) binned by the JAX package with
    ``params`` (the monotone constraints included) and carried into the
    port through its npz."""
    rng = np.random.RandomState(seed)
    X, y, _ = make_train_data(rng, n)
    ds = lgb.Dataset(X, label=y, params=dict(params))
    ds.construct()
    path = os.path.join(str(tmp_path), "train_%d.npz" % seed)
    ds.save_binary(path)
    return ds, lgt.dataset_from_reference(path, CPU), X, y


def _channels(n, seed=5):
    rng = np.random.RandomState(seed)
    g = (rng.randn(n) * 0.5).astype(np.float32)
    h = (rng.rand(n) * 0.25 + 0.05).astype(np.float32)
    inbag = (rng.rand(n) < 0.9).astype(np.float32)
    return np.stack([g * inbag, h * inbag, inbag], axis=1)


def _params(method, extra=None):
    return dict(train_params("binary"), monotone_constraints=MONOTONE,
                monotone_constraints_method=method, **(extra or {}))


@pytest.mark.parametrize("variant", ["alone", "forced", "max_depth"])
@pytest.mark.parametrize("method", METHODS)
def test_one_tree_matches_jax(tmp_path, method, variant):
    params = _params(method, _extra(variant, tmp_path))
    jds, pds, X, _ = _datasets(tmp_path, params)
    jlrn = lgb.Booster(dict(params), train_set=jds).inner.learner
    plrn = lgt.Booster(dict(params, **CPU), pds).inner.learner
    assert plrn.hp.has_monotone and plrn.hp.mono_intermediate
    assert plrn.hp.mono_advanced == (method == "advanced")
    ghc = _channels(X.shape[0])
    fmask = np.ones(X.shape[1], dtype=bool)
    jlog = jlrn.train(jnp.asarray(ghc), jnp.asarray(fmask),
                      jax.random.PRNGKey(9), jnp.zeros(8, bool))
    plog = plrn.train(torch.as_tensor(ghc), torch.as_tensor(fmask),
                      PRNGKey(9), torch.zeros(8, dtype=torch.bool))
    assert int(plog.num_splits[0]) == int(jlog.num_splits) > 4
    assert_same_trees([jlrn.log_to_tree(jlog)], [plrn.log_to_tree(plog)])
    if variant == "forced":       # the forced root split
        assert int(plog.feature[0]) == 0 \
            and int(plog.bin[0]) == int(jlog.bin[0])


# ------------------------------------------------------------------- (c)

LOOP_VARIANTS = {
    "alone": {},
    "forced_depth": {"max_depth": 4},
    "bynode_cegb": {"feature_fraction_bynode": 0.7,
                    "cegb_penalty_split": 0.002},
    "resident": {"tpu_resident_state": "on"},
    "rows_int8": {"use_quantized_grad": True},
    "categorical": {},
}


def _learner(method, variant, tmp_path, n=1500, seed=0):
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, 6) * 64) / 64
    z = X[:, 0] - 0.7 * X[:, 1] + 0.5 * X[:, 2] + 0.3 * X[:, 4]
    cat = variant == "categorical"
    if cat:
        X[:, 3] = rng.randint(0, 6, n)
        z = z + 0.4 * np.isin(X[:, 3], (1, 4))
    y = (z + rng.randn(n) * 0.5 > 0).astype(float)
    X[rng.rand(n) < 0.05, 2] = np.nan
    extra = dict(LOOP_VARIANTS[variant])
    if variant == "forced_depth":
        extra["forcedsplits_filename"] = _forced_file(tmp_path)
    p = dict({"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "min_data_in_leaf": 5, "monotone_constraints":
              [1, -1, -1, 0, 1, 0], "monotone_constraints_method": method},
             **CPU, **extra)
    ds = lgt.Dataset(X, label=y, params=p,
                     categorical_feature=[3] if cat else "auto")
    bst = lgt.Booster(p, ds)
    g = bst.inner
    grad, hess = g.objective.get_gradients(g.train_score.score)
    inbag = (torch.as_tensor(rng.rand(n)) < 0.8).to(torch.float32)
    ghc = torch.stack([grad * inbag, hess * inbag, inbag], dim=1)
    return g.learner, ghc


@pytest.mark.parametrize("variant", sorted(LOOP_VARIANTS))
@pytest.mark.parametrize("method", METHODS)
def test_device_loop_equals_host_loop(tmp_path, method, variant):
    lrn, ghc = _learner(method, variant, tmp_path)
    assert lrn._kw["split_kernel"] == "off"
    half = ghc * torch.tensor([0.5, 0.5, 1.0])   # the count stays whole
    for key, g in ((PRNGKey(5), ghc), (PRNGKey(6), half)):
        want = lrn.train(g, key=key)
        got = lrn.train_device(g, key=key)
        for fld in got._fields:
            assert torch.equal(getattr(got, fld), getattr(want, fld)), fld
    assert int(want.num_splits[0]) > lrn.num_leaves // 2
    if variant == "forced_depth":     # the forced root split
        assert want.feature[0] == 0


def test_device_loop_makes_no_host_read(monkeypatch, tmp_path):
    lrn, ghc = _learner("advanced", "forced_depth", tmp_path)
    want = lrn.train(ghc, key=PRNGKey(3))

    def refuse(*_args, **_kwargs):
        raise AssertionError("a host read inside the device tree loop")

    for attr in ("item", "tolist", "__bool__", "__int__", "__float__",
                 "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, attr, refuse)
    got = lrn.train_device(ghc, key=PRNGKey(3))
    monkeypatch.undo()
    assert int(got.num_splits[0]) == int(want.num_splits[0]) > 1
    for fld in got._fields:
        assert torch.equal(getattr(got, fld), getattr(want, fld)), fld


def test_launch_counts_per_split():
    from lightgbm_tpu_torch.learner import launches_per_split

    assert launches_per_split("planes", False, advanced=True) == 6
    assert launches_per_split("planes", False, device_loop=False,
                              advanced=True) == 6
    assert launches_per_split("resident", False, node_inputs=True,
                              advanced=True) == 8
    assert launches_per_split("planes", False) == 4


# ------------------------------------------------------------------- (d)

def _model(bst):
    return "\n".join(ln for ln in bst.model_to_string().splitlines()
                     if not ln.startswith("best_iteration="))


@pytest.mark.parametrize("method", METHODS)
def test_fused_equals_per_iteration(method):
    from lightgbm_tpu_torch.fused import FusedTrainer

    rng = np.random.RandomState(3)
    X, y, _ = make_train_data(rng, 1200)
    params = dict(_params(method), **CPU, tpu_iter_block=3)

    def ds():
        return lgt.Dataset(X, label=y, params=params)

    fused = lgt.train(dict(params), ds(), 7)
    assert fused.inner._fused is not None
    eager = lgt.train(dict(params), ds(), 7, callbacks=[lambda env: None])
    assert fused.model_to_string() == eager.model_to_string()
    # the card's tree loop inside the same blocks
    bst = lgt.Booster(dict(params), ds())
    bst.inner._fused = FusedTrainer(bst.inner)
    bst.inner._fused.device_loop = True
    assert bst.inner.train_block(7) is False
    bst.inner.finish_fused("test")
    assert _model(bst) == _model(eager)


@pytest.mark.parametrize("method,extra", [
    ("intermediate", {}), ("advanced", {}),
    ("advanced", {"use_quantized_grad": True})])
def test_fused_matches_jax_fused(tmp_path, method, extra):
    params = _params(method, extra)
    jds, pds, X, _ = _datasets(tmp_path, params, n=1200, seed=4)
    jb = lgb.train(dict(params), jds, 5)
    assert jb.inner._fused is not None
    pb = lgt.train(dict(params, **CPU), pds, 5)
    assert pb.inner._fused is not None
    if extra:
        assert pb.inner.learner._kw["work_layout"] == "rows"
    assert_same_trees(jb.inner.models, pb.inner.models)
    np.testing.assert_allclose(pb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True),
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)


# ------------------------------------------------------------------- (e)

def _mono_data(seed=7, n=2000):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 4)
    y = 1.6 * X[:, 0] - 1.1 * X[:, 1] + np.sin(X[:, 2] * 6) * X[:, 3] \
        + 0.12 * rng.randn(n)
    return X, y


def _worst_slope(bst, feature, sign, reps=25, seed=3):
    rng = np.random.RandomState(seed)
    grid = np.linspace(0.01, 0.99, 50)
    worst = 0.0
    for _ in range(reps):
        pts = np.tile(rng.rand(4), (50, 1))
        pts[:, feature] = grid
        p = bst.predict(pts) * sign
        worst = min(worst, float(np.diff(p).min()))
    return worst


@pytest.mark.parametrize("method", METHODS)
def test_monotone_soundness(method):
    X, y = _mono_data()
    bst = lgt.train({"objective": "regression", "num_leaves": 31,
                     "verbosity": -1, "monotone_constraints": [1, -1, 0, 0],
                     "monotone_constraints_method": method,
                     "tpu_iter_block": 5, **CPU},
                    lgt.Dataset(X, label=y), num_boost_round=8)
    assert bst.inner._fused is not None
    assert _worst_slope(bst, 0, +1) >= -1e-7
    assert _worst_slope(bst, 1, -1) >= -1e-7


def test_advanced_enabled_no_downgrade():
    X, y = _mono_data(n=1200)
    b = lgt.Booster(params={"objective": "regression", "num_leaves": 15,
                            "verbosity": -1,
                            "monotone_constraints": [1, 0, 0, 0],
                            "monotone_constraints_method": "advanced",
                            **CPU},
                    train_set=lgt.Dataset(X, label=y))
    hp = b.inner.learner.hp
    assert hp.mono_advanced and hp.has_monotone


def test_advanced_beats_intermediate_on_restricted_neighbor():
    """tests/test_monotone.py's construction: a neighbour's bound that
    applies to part of a leaf's range along a free feature; advanced keeps
    it per threshold and fits better than intermediate's scalar clamp."""
    rng = np.random.RandomState(5)
    n = 2000
    x0 = rng.rand(n)
    x2 = np.where(rng.rand(n) > 0.1, 0.6 + rng.rand(n) * 0.35,
                  rng.rand(n) * 0.35)
    y = np.where(x0 >= 0.6, np.where(x2 < 0.5, 9.0, 4.5),
                 np.where(x2 < 0.5, 5.0, 2.0)) + 0.01 * rng.randn(n)
    X = np.stack([x0, x2], axis=1)
    mse = {}
    for m in METHODS:
        bst = lgt.train({"objective": "regression", "num_leaves": 4,
                         "max_bin": 63, "learning_rate": 1.0,
                         "verbosity": -1, "monotone_constraints": [1, 0],
                         "monotone_constraints_method": m,
                         "min_data_in_leaf": 5, **CPU},
                        lgt.Dataset(X, label=y), num_boost_round=1)
        mse[m] = float(np.mean((bst.predict(X) - y) ** 2))
        grid = np.linspace(0.01, 0.99, 50)
        for x2v in (0.2, 0.8):
            pts = np.stack([grid, np.full(50, x2v)], axis=1)
            assert float(np.diff(bst.predict(pts)).min()) >= -1e-7, m
    assert mse["advanced"] < mse["intermediate"] * 0.95, mse


@pytest.mark.parametrize("noise", [0, 1, 2])
def test_advanced_is_intermediate_past_two_features(noise):
    """The restricted-neighbour construction with ``noise`` random columns
    added, in both packages: the port's trees are the JAX package's under
    each method, and the methods grow different trees on the two
    features only. With three or more, every leaf that a neighbour bounds
    overlaps it in two or more features, the neighbour's output lands in
    each of those rows, and the exclude-one extremum hands every
    candidate the intermediate method's scalar bound."""
    rng = np.random.RandomState(5)
    n = 2000
    x0 = rng.rand(n)
    x2 = np.where(rng.rand(n) > 0.1, 0.6 + rng.rand(n) * 0.35,
                  rng.rand(n) * 0.35)
    y = np.where(x0 >= 0.6, np.where(x2 < 0.5, 9.0, 4.5),
                 np.where(x2 < 0.5, 5.0, 2.0)) + 0.01 * rng.randn(n)
    X = np.column_stack([x0, x2] + [rng.rand(n) for _ in range(noise)])
    strings = {}
    for m in METHODS:
        params = {"objective": "regression", "num_leaves": 4,
                  "max_bin": 63, "learning_rate": 1.0, "verbosity": -1,
                  "monotone_constraints": [1] + [0] * (1 + noise),
                  "monotone_constraints_method": m, "min_data_in_leaf": 5}
        jb = lgb.train(dict(params, tree_builder="partition"),
                       lgb.Dataset(X, label=y), num_boost_round=1)
        pb = lgt.train(dict(params, **CPU), lgt.Dataset(X, label=y),
                       num_boost_round=1)
        assert_same_trees(jb.inner.models, pb.inner.models)
        strings[m] = (jb.model_to_string(), pb.model_to_string())
    for k in range(2):
        same = strings["intermediate"][k] == strings["advanced"][k]
        assert same == (noise > 0), (k, noise)


@pytest.mark.parametrize("pair", [False, True])
def test_smoke_data_methods_match_jax(tmp_path, pair):
    """Both methods on chip_smoke.py's phase-3i data and constraints
    (20,000 rows, 63 leaves, 3 trees): (a) and (b) on its 28 columns,
    (e) and (f) on its two pair columns. The port's trees are the JAX
    package's. On 28 columns the advanced method grows the intermediate
    method's trees in both packages: the port's model strings are
    byte-equal (as phase 3i's are on the card), the JAX package's trees
    equal up to the last printed digit of a split gain. On the pair the
    two methods differ in both packages."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    data = chip_smoke.training_data(0, 20000, 0)
    configs = chip_smoke.monotone_configs()
    if pair:
        data, configs = chip_smoke.monotone_pair(data)
    X, y = data[0], data[1]
    boosters = {}
    for method in METHODS:
        params = dict(chip_smoke.TRAIN_PARAMS, num_leaves=63,
                      **configs[method + ("_pair" if pair else "")])
        ds = lgb.Dataset(X, label=y, params=dict(params))
        ds.construct()
        path = os.path.join(str(tmp_path), "%s.npz" % method)
        ds.save_binary(path)
        jb = lgb.train(dict(params), ds, 3)
        pb = lgt.train(dict(params, **CPU),
                       lgt.dataset_from_reference(path, CPU), 3)
        assert_same_trees(jb.inner.models, pb.inner.models)
        boosters[method] = (jb, pb)
    (ji, pi), (ja, pa) = boosters["intermediate"], boosters["advanced"]
    if pair:
        assert pi.model_to_string() != pa.model_to_string()
        assert ji.model_to_string() != ja.model_to_string()
    else:
        assert pi.model_to_string() == pa.model_to_string()
        assert_same_trees(ji.inner.models, ja.inner.models, rtol=0, atol=0)
