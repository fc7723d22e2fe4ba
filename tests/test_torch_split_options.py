"""The per-node split options of the PyTorch port (``lightgbm_tpu_torch``)
on the CPU: by-node feature sampling, extra-trees, interaction
constraints, CEGB penalties and forced splits, against the JAX package.

The bars:
- (a) the node draws (``ops/node.node_inputs``' plain twin) are
  ``jax.random``'s bit for bit: the by-node masks and the extra-trees
  bins over a grid of (round, leaf, F, fraction, extra_seed), and the CEGB
  penalties are the JAX formula's;
- (b) one tree from the same (grad, hess, inbag) channels, key and used
  features through each package's learner: the same splits, leaf values
  within TRAIN_RTOL / TRAIN_ATOL, for each option alone and all together;
- (c) the device tree loop (the card's tree loop, on its plain twins here)
  grows the host loop's tree field by field, one-kernel split included
  for forced splits, and reads nothing back to the host;
- (d) fused blocks give the per-iteration model byte for byte;
- (e) the port's fused training against the JAX package's, 5 rounds;
- (f) the forced-split loader and the constraint parser equal JAX's,
  including a missing file and a feature the dataset does not have;
- (g) the knob resolutions: ``tpu_split_kernel`` leaves the one-kernel
  split for the chain under by-node sampling, extra-trees, constraint sets
  and CEGB (JAX's gate) and keeps it with forced splits;
  ``cegb_penalty_feature_lazy`` warns; the CEGB mirrors of
  tests/test_linear_cegb.py.

The parity cases set ``min_gain_to_split=1e-3`` (torch_port_cases).
"""
import json
import os

import numpy as np
import pytest
import torch

from torch_port_cases import (CPU, TRAIN_ATOL, TRAIN_RTOL, assert_same_trees,
                              jax_dataset, make_train_data, one_torch_thread,
                              train_params)

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops.node import (NodeOptions, node_buf, node_inputs,
                                         node_keys)
from lightgbm_tpu_torch.ops.split import SplitHyper
from lightgbm_tpu_torch.prng import PRNGKey


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """Training-heavy: one torch thread (torch_port_cases)."""


def _forced_file(tmp_path, name="forced.json", bad=False):
    """A forced-split tree of three levels (7 splits) on features 0-3;
    ``bad`` puts the second level's left split at a threshold no row
    passes (its leaf cannot split there, so forcing stops)."""
    t = {"feature": 0, "threshold": 0.05,
         "left": {"feature": 1, "threshold": -10.0 if bad else -0.1,
                  "left": {"feature": 2, "threshold": 0.0},
                  "right": {"feature": 3, "threshold": 0.1}},
         "right": {"feature": 2, "threshold": 0.2,
                   "left": {"feature": 1, "threshold": 0.0},
                   "right": {"feature": 3, "threshold": -0.05}}}
    path = os.path.join(str(tmp_path), name)
    with open(path, "w") as f:
        json.dump(t, f)
    return path


def _many_sets(n=300, seed=5):
    """``n`` interaction constraint sets of 2 to 4 of the 8 features, more
    than one word of set bits a feature holds."""
    rng = np.random.RandomState(seed)
    sets = [sorted(rng.choice(8, rng.randint(2, 5), replace=False))
            for _ in range(n)]
    return ",".join("[%s]" % ",".join(str(f) for f in s) for s in sets)


MANY_SETS = _many_sets()


def option_params(name, tmp_path):
    """The params of one option case (8 features)."""
    forced = _forced_file(tmp_path)
    cases = {
        "bynode": {"feature_fraction_bynode": 0.5},
        "extra_trees": {"extra_trees": True, "extra_seed": 11},
        "interaction": {"interaction_constraints": "[0,1,2],[3,4,5,6,7]"},
        "cegb": {"cegb_penalty_split": 0.002,
                 "cegb_penalty_feature_coupled": [0.5] * 8},
        "forced": {"forcedsplits_filename": forced},
        "forced_bad": {"forcedsplits_filename": _forced_file(
            tmp_path, "bad.json", bad=True), "min_data_in_leaf": 30},
        "many_sets": {"interaction_constraints": MANY_SETS},
        "all": {"feature_fraction_bynode": 0.7, "extra_trees": True,
                "interaction_constraints": "[0,1,2,3],[3,4,5,6,7]",
                "cegb_penalty_split": 0.002,
                "cegb_penalty_feature_coupled": [0.5] * 8,
                "forcedsplits_filename": forced},
    }
    return cases[name]


OPTION_CASES = ("bynode", "extra_trees", "interaction", "cegb", "forced",
                "forced_bad", "many_sets", "all")


# ------------------------------------------------------------------- (a)

def _jax_node_inputs(key, r, leaf, num_feat, frac, extra_seed, num_bins):
    """node_inputs of the JAX package's _make_best_for (learner.py)."""
    k = jax.random.fold_in(key, r * 2 + 1000 + leaf)
    u = jax.random.uniform(k, (num_feat,))
    kth = max(1, int(np.ceil(frac * num_feat)))
    rank = jnp.argsort(jnp.argsort(u))
    mask = np.asarray(rank < kth)
    k = jax.random.fold_in(jax.random.fold_in(key, 2000 + extra_seed),
                           r * 2 + 1 + leaf)
    u = jax.random.uniform(k, (num_feat,))
    thr = np.asarray((u * jnp.maximum(num_bins - 1, 1).astype(jnp.float32))
                     .astype(jnp.int32))
    return mask, thr


@pytest.mark.parametrize("seed,num_feat,frac,extra_seed", [
    (0, 8, 0.5, 6), (7, 28, 0.3, 6), (3, 137, 0.8, 11), (2 ** 31 - 1, 5,
                                                         0.01, 0)])
def test_node_draws_match_jax(seed, num_feat, frac, extra_seed):
    rng = np.random.RandomState(seed % 1000)
    nb = rng.randint(1, 256, size=num_feat).astype(np.int32)
    opts = NodeOptions(kth=max(1, int(np.ceil(frac * num_feat))),
                       extra_trees=True, extra_seed=extra_seed)
    out = node_buf(opts, num_feat, "cpu")
    keys = node_keys(PRNGKey(seed), extra_seed,
                     torch.zeros(4, dtype=torch.int64))
    jkey = jax.random.PRNGKey(seed)
    fmask = torch.ones(num_feat, dtype=torch.bool)
    for r, leaf, leaf1 in ((0, 0, 0), (0, 0, 1), (3, 2, 4), (200, 117, 201)):
        node_inputs(out, keys, r, leaf, leaf1, 2, opts=opts, fmask=fmask,
                    num_bins=torch.as_tensor(nb),
                    coupled=torch.zeros(num_feat), hp=SplitHyper())
        for c, lf in enumerate((leaf, leaf1)):
            mask, thr = _jax_node_inputs(jkey, r, lf, num_feat, frac,
                                         extra_seed, jnp.asarray(nb))
            np.testing.assert_array_equal(out.mask[c].numpy(), mask)
            np.testing.assert_array_equal(out.thr[c].numpy(), thr)
        # the leaf of node 0 may also come from a device header word
        node_inputs(out, keys, r, torch.tensor([leaf], dtype=torch.int32),
                    leaf1, 1, opts=opts, fmask=fmask,
                    num_bins=torch.as_tensor(nb),
                    coupled=torch.zeros(num_feat), hp=SplitHyper())
        np.testing.assert_array_equal(out.mask[0].numpy(),
                                      _jax_node_inputs(
                                          jkey, r, leaf, num_feat, frac,
                                          extra_seed, jnp.asarray(nb))[0])


def test_node_inputs_constraints_cegb_and_live():
    """The allowed mask of the JAX package, its CEGB penalty formula, and
    a dead live word that leaves the buffer as it was."""
    rng = np.random.RandomState(4)
    F, L = 9, 6
    sets = torch.as_tensor(rng.rand(3, F) < 0.5)
    used = torch.as_tensor(rng.rand(L, F) < 0.2)
    tree_used = torch.as_tensor(rng.rand(F) < 0.5)
    coupled = torch.as_tensor(rng.rand(F).astype(np.float32))
    hp = SplitHyper(cegb_tradeoff=0.7, cegb_penalty_split=0.013,
                    use_cegb=True)
    opts = NodeOptions(sets=sets, cegb=True)
    out = node_buf(opts, F, "cpu")
    fmask = torch.as_tensor(rng.rand(F) < 0.8)
    sums = torch.as_tensor(rng.rand(2, 3).astype(np.float32) * 100)
    node_inputs(out, torch.zeros(4, dtype=torch.int64), 5, 3, 6, 2,
                opts=opts, fmask=fmask, num_bins=torch.full((F,), 9),
                coupled=coupled, hp=hp, sums=sums, used=used,
                tree_used=tree_used)
    u = np.asarray(used[3])
    s = np.asarray(sets)
    compat = np.all(~u[None, :] | s, axis=1)
    allowed = np.any(s & compat[:, None], axis=0)
    for c in range(2):
        np.testing.assert_array_equal(out.mask[c].numpy(),
                                      np.asarray(fmask) & allowed)
        want = np.float32(0.7) * (np.float32(0.013) * sums[c, 2].numpy()
                                  + coupled.numpy()
                                  * (~np.asarray(tree_used))
                                  .astype(np.float32))
        np.testing.assert_array_equal(out.delta[c].numpy(), want)
    before = [t.clone() for t in out if t is not None]
    node_inputs(out, torch.zeros(4, dtype=torch.int64), 1, 0, 1, 2,
                opts=opts, fmask=~fmask, num_bins=torch.full((F,), 9),
                coupled=coupled * 2, hp=hp, sums=sums, used=used,
                tree_used=tree_used, live=torch.zeros(1, dtype=torch.int32))
    for a, b in zip(before, [t for t in out if t is not None]):
        assert torch.equal(a, b)


# ------------------------------------------------------------------- (b)

def _channels(X, seed=5):
    rng = np.random.RandomState(seed)
    n = X.shape[0]
    g = (rng.randn(n) * 0.5).astype(np.float32)
    h = (rng.rand(n) * 0.25 + 0.05).astype(np.float32)
    inbag = (rng.rand(n) < 0.9).astype(np.float32)
    return np.stack([g * inbag, h * inbag, inbag], axis=1)


@pytest.mark.parametrize("name", OPTION_CASES)
def test_one_tree_matches_jax(tmp_path, name):
    ds, path, X, _, _ = jax_dataset("binary", tmp_path, n=1500, seed=2)
    params = dict(train_params("binary"), **option_params(name, tmp_path))
    jlrn = lgb.Booster(dict(params), train_set=ds).inner.learner
    plrn = lgt.Booster(dict(params, **CPU), lgt.dataset_from_reference(
        path, CPU)).inner.learner
    ghc = _channels(X)
    fmask = np.ones(X.shape[1], dtype=bool)
    fmask[6] = False
    used = np.zeros(X.shape[1], dtype=bool)
    used[[1, 4]] = True
    jlog = jlrn.train(jnp.asarray(ghc), jnp.asarray(fmask),
                      jax.random.PRNGKey(9), jnp.asarray(used))
    plog = plrn.train(torch.as_tensor(ghc), torch.as_tensor(fmask),
                      PRNGKey(9), torch.as_tensor(used))
    assert int(plog.num_splits[0]) == int(jlog.num_splits) > 4
    assert_same_trees([jlrn.log_to_tree(jlog)], [plrn.log_to_tree(plog)])
    if name == "forced":       # the forced tree's top levels, BFS
        assert plog.feature[:7].tolist() == [0, 1, 2, 2, 3, 1, 3]


# ------------------------------------------------------------------- (c)

def _learner(extra, n=1500, seed=0):
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, 6) * 64) / 64
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.randn(n) * 0.5 > 0).astype(float)
    X[rng.rand(n) < 0.05, 2] = np.nan
    p = dict({"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "min_data_in_leaf": 5}, **CPU, **extra)
    bst = lgt.Booster(p, lgt.Dataset(X, label=y, params=p))
    g = bst.inner
    grad, hess = g.objective.get_gradients(g.train_score.score)
    inbag = (torch.as_tensor(rng.rand(n)) < 0.8).to(torch.float32)
    ghc = torch.stack([grad * inbag, hess * inbag, inbag], dim=1)
    return g.learner, ghc


def loop_params(name, tmp_path):
    forced = _forced_file(tmp_path)
    return {
        "bynode": {"feature_fraction_bynode": 0.5},
        "extra_trees": {"extra_trees": True},
        "interaction": {"interaction_constraints": "[0,1,2],[3,4,5]"},
        "cegb": {"cegb_penalty_split": 0.01,
                 "cegb_penalty_feature_coupled": [0.5] * 6},
        "forced_depth": {"forcedsplits_filename": forced, "max_depth": 4},
        "forced_bad": {"forcedsplits_filename": _forced_file(
            tmp_path, "bad.json", bad=True), "min_data_in_leaf": 30},
        "forced_none_valid": {"forcedsplits_filename": forced,
                              "min_gain_to_split": 1e9},
        "forced_one_kernel": {"forcedsplits_filename": forced,
                              "tpu_split_kernel": "on"},
        "forced_resident": {"forcedsplits_filename": forced,
                            "tpu_split_kernel": "on",
                            "tpu_resident_state": "on"},
        "all_monotone": {"feature_fraction_bynode": 0.7, "extra_trees": True,
                         "interaction_constraints": "[0,1,2,3],[3,4,5]",
                         "cegb_penalty_split": 0.002,
                         "cegb_penalty_feature_coupled": [0.5] * 6,
                         "forcedsplits_filename": forced,
                         "monotone_constraints": [1, 0, 0, 0, -1, 0]},
        "all_rows_int8": {"feature_fraction_bynode": 0.7,
                          "extra_trees": True, "use_quantized_grad": True,
                          "cegb_penalty_split": 0.002,
                          "forcedsplits_filename": forced},
    }[name]


LOOP_CASES = ("bynode", "extra_trees", "interaction", "cegb", "forced_depth",
              "forced_bad", "forced_none_valid", "forced_one_kernel",
              "forced_resident", "all_monotone", "all_rows_int8")


@pytest.mark.parametrize("name", LOOP_CASES)
def test_device_loop_equals_host_loop(tmp_path, name):
    lrn, ghc = _learner(loop_params(name, tmp_path))
    if name in ("forced_one_kernel", "forced_resident"):
        assert lrn._kw["split_kernel"] == "on"
    fmask = torch.ones(6, dtype=torch.bool)
    fmask[5] = False
    used = torch.zeros(6, dtype=torch.bool)
    used[1] = True
    half = ghc * torch.tensor([0.5, 0.5, 1.0])   # the count stays whole
    for key, g in ((PRNGKey(5), ghc), (PRNGKey(6), half)):
        want = lrn.train(g, fmask, key, used)
        got = lrn.train_device(g, fmask, key, used)
        for fld in got._fields:
            assert torch.equal(getattr(got, fld), getattr(want, fld)), fld
    ns = int(want.num_splits[0])
    if name == "forced_none_valid":
        assert ns == 0
    else:
        assert ns == lrn.num_leaves - 1
    if name in ("forced_depth", "forced_one_kernel", "forced_resident"):
        assert want.feature[:7].tolist() == [0, 1, 2, 2, 3, 1, 3]
        assert want.split_leaf[:7].tolist() == [0, 0, 1, 0, 2, 1, 3]


@pytest.mark.parametrize("goss", [False, True])
def test_device_loop_equals_host_loop_efb(tmp_path, goss):
    """EFB bundles under forced splits and every node option (the forced
    leaf's scan on the per-feature view of a bundled histogram), and
    under GOSS compaction."""
    rng = np.random.RandomState(3)
    X, y, _ = make_train_data(rng, 1500, efb=True)
    F = X.shape[1]
    path = os.path.join(str(tmp_path), "efb.json")
    with open(path, "w") as f:
        json.dump({"feature": 25, "threshold": 0.0,
                   "left": {"feature": 3, "threshold": 0.5},
                   "right": {"feature": 26, "threshold": 0.1}}, f)
    extra = {"data_sample_strategy": "goss", "learning_rate": 0.5,
             "tpu_goss_compact": "on"} if goss else {
        "forcedsplits_filename": path, "feature_fraction_bynode": 0.6,
        "extra_trees": True, "cegb_penalty_split": 0.001,
        "cegb_penalty_feature_coupled": [0.3] * F,
        "interaction_constraints": "[0,1,2,3,4,5,6,7,8,24,25,26,27],"
                                   "[%s]" % ",".join(map(str, range(9, 32)))}
    p = dict(train_params("binary"), **CPU, **extra)
    bst = lgt.Booster(p, lgt.Dataset(X, label=y, params=p))
    g = bst.inner
    lrn = g.learner
    assert lrn.bundle is not None
    grad, hess = g.objective.get_gradients(g.train_score.score)
    inbag = (torch.as_tensor(rng.rand(len(y))) < 0.7).to(torch.float32)
    ghc = torch.stack([grad * inbag, hess * inbag, inbag], dim=1)
    want = lrn.train(ghc, key=PRNGKey(2))
    got = lrn.train_device(ghc, key=PRNGKey(2))
    for fld in got._fields:
        assert torch.equal(getattr(got, fld), getattr(want, fld)), fld
    assert int(want.num_splits[0]) == lrn.num_leaves - 1
    if not goss:
        assert want.feature[:3].tolist() == [25, 3, 26]


def test_device_loop_with_options_makes_no_host_read(monkeypatch, tmp_path):
    lrn, ghc = _learner(loop_params("all_monotone", tmp_path))
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


# ------------------------------------------------------------------- (d)

def _model(bst):
    return "\n".join(ln for ln in bst.model_to_string().splitlines()
                     if not ln.startswith("best_iteration="))


@pytest.mark.parametrize("name", ["bynode", "cegb", "forced", "all"])
def test_fused_equals_per_iteration(tmp_path, name):
    from lightgbm_tpu_torch.fused import FusedTrainer

    rng = np.random.RandomState(3)
    X, y, _ = make_train_data(rng, 1200)
    params = dict(train_params("binary"), **CPU,
                  **option_params(name, tmp_path), tpu_iter_block=3)

    def ds():
        return lgt.Dataset(X, label=y, params=params)

    fused = lgt.train(dict(params), ds(), 7)
    eager = lgt.train(dict(params), ds(), 7, callbacks=[lambda env: None])
    assert fused.model_to_string() == eager.model_to_string()
    assert torch.equal(fused.inner._cegb_used, eager.inner._cegb_used)
    # the card's tree loop inside the same blocks
    bst = lgt.Booster(dict(params), ds())
    bst.inner._fused = FusedTrainer(bst.inner)
    bst.inner._fused.device_loop = True
    assert bst.inner.train_block(7) is False
    bst.inner.finish_fused("test")
    assert _model(bst) == _model(eager)


def test_fused_rollback_restores_used_features():
    """A dropped block restores the model's used features with its scores,
    as the JAX package's fused rollback does."""
    rng = np.random.RandomState(3)
    X, y, _ = make_train_data(rng, 600)
    params = dict(train_params("binary"), **CPU, tpu_iter_block=2,
                  cegb_penalty_feature_coupled=[0.1] * 8)
    bst = lgt.Booster(dict(params), lgt.Dataset(X, label=y, params=params))
    g = bst.inner
    assert g.train_block(2) is False
    assert g._cegb_used.any()
    pre = torch.zeros_like(g._cegb_used)
    g._fused._rollback(g.train_score.score, pre)
    assert not g._cegb_used.any()


# ------------------------------------------------------------------- (e)

@pytest.mark.parametrize("group", ["bynode_extra", "cegb_constraints_forced"])
def test_fused_matches_jax_fused(tmp_path, group):
    ds, path, X, _, _ = jax_dataset("binary", tmp_path, n=1200, seed=4)
    extra = {"feature_fraction_bynode": 0.6, "extra_trees": True} \
        if group == "bynode_extra" else {
            "cegb_penalty_split": 0.002,
            "cegb_penalty_feature_coupled": [0.5] * 8,
            "interaction_constraints": "[0,1,2,3],[2,3,4,5,6,7]",
            "forcedsplits_filename": _forced_file(tmp_path)}
    params = dict(train_params("binary"), **extra)
    jb = lgb.train(dict(params), ds, 5)
    assert jb.inner._fused is not None
    pb = lgt.train(dict(params, **CPU), lgt.dataset_from_reference(path, CPU),
                   5)
    assert pb.inner._fused is not None
    assert_same_trees(jb.inner.models, pb.inner.models)
    np.testing.assert_allclose(pb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True),
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)


# ------------------------------------------------------------------- (f)

@pytest.mark.parametrize("spec", [
    "[0,1],[2,3]", "[0, 1, 2],[5],[ ]", "[1,99],[0,3]", "", "no sets"])
def test_constraint_parser_matches_jax(tmp_path, spec):
    ds, path, _, _, _ = jax_dataset("binary", tmp_path, n=300, seed=5)
    params = dict(train_params("binary"), interaction_constraints=spec)
    jl = lgb.Booster(dict(params), train_set=ds).inner.learner
    pl = lgt.Booster(dict(params, **CPU), lgt.dataset_from_reference(
        path, CPU)).inner.learner
    want, got = jl._constraint_sets(), pl._constraint_sets()
    if want is None:
        assert got is None and pl.opts.sets is None
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["three_levels", "bad", "missing",
                                  "unknown_feature", "too_many"])
def test_forced_loader_matches_jax(tmp_path, case):
    ds, path, _, _, _ = jax_dataset("binary", tmp_path, n=300, seed=5)
    fname = {"three_levels": _forced_file(tmp_path),
             "bad": _forced_file(tmp_path, "b.json", bad=True),
             "missing": os.path.join(str(tmp_path), "absent.json")}.get(case)
    if case in ("unknown_feature", "too_many"):
        node = {"feature": 0, "threshold": 0.0,
                "left": {"feature": 42, "threshold": 1.0},
                "right": {"feature": 1, "threshold": 1e9,
                          "left": {"feature": 2, "threshold": -1e9}}}
        fname = os.path.join(str(tmp_path), case + ".json")
        with open(fname, "w") as f:
            json.dump(node, f)
    leaves = 3 if case == "too_many" else 15
    params = dict(train_params("binary", leaves=leaves),
                  forcedsplits_filename=fname)
    jl = lgb.Booster(dict(params), train_set=ds).inner.learner
    pl = lgt.Booster(dict(params, **CPU), lgt.dataset_from_reference(
        path, CPU)).inner.learner
    want, got = jl._forced_splits(), pl._forced_splits()
    if want is None:
        assert got is None and case == "missing"
        return
    assert [list(map(int, np.asarray(w))) for w in want] == \
        [list(g) for g in got]


# ------------------------------------------------------------------- (g)

def test_split_kernel_gate_and_lazy_warning(tmp_path):
    from lightgbm_tpu_torch.utils.log import (Log, set_thread_log_level,
                                               set_thread_log_sink)

    _, path, _, _, _ = jax_dataset("binary", tmp_path, n=300, seed=2)
    lines = []
    set_thread_log_sink(lines.append)
    # another test of the worker may have left the level above warnings
    set_thread_log_level(Log.WARNING)
    try:
        for extra, on in (({"feature_fraction_bynode": 0.5}, False),
                          ({"extra_trees": True}, False),
                          ({"interaction_constraints": "[0,1]"}, False),
                          ({"cegb_penalty_split": 0.1}, False),
                          ({"forcedsplits_filename":
                            _forced_file(tmp_path)}, True)):
            params = dict(train_params("binary"), tpu_split_kernel="on",
                          **CPU, **extra)
            bst = lgt.train(params, lgt.dataset_from_reference(path, CPU), 2)
            assert (bst.inner.learner._kw["split_kernel"] == "on") == on
            lrn = bst.inner.learner
            lrn.device = torch.device("cuda")      # auto on the card
            lrn.config.tpu_split_kernel = "auto"
            assert (lrn.build_kwargs()["split_kernel"] == "on") == on
        params = dict(train_params("binary"), **CPU,
                      cegb_penalty_feature_lazy=[1.0, 2.0])
        lgt.train(params, lgt.dataset_from_reference(path, CPU), 1)
    finally:
        set_thread_log_sink(None, clear=True)
        set_thread_log_level(None)
    assert sum("not eligible" in ln for ln in lines) == 4
    assert any("by-node sampling / extra-trees" in ln for ln in lines)
    assert any("interaction constraint sets" in ln for ln in lines)
    assert any("cegb_penalty_feature_lazy is not supported" in ln
               for ln in lines)


def test_cegb_coupled_penalty_shrinks_feature_set():
    """tests/test_linear_cegb.py:53 on the port: coupled penalties use
    fewer features."""
    rng = np.random.RandomState(0)
    n, f = 2500, 12
    X = np.round(rng.randn(n, f) * 16) / 64
    w = np.concatenate([[3.0, 2.0, 1.5], np.full(f - 3, 0.3)])
    y = (X @ w > 0).astype(np.float64)
    base = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
            "min_gain_to_split": 1e-3}
    plain = lgt.train(dict(base, **CPU), lgt.Dataset(X, label=y), 8)
    cegb_p = dict(base, cegb_penalty_feature_coupled=[5.0] * f)
    cegb = lgt.train(dict(cegb_p, **CPU), lgt.Dataset(X, label=y), 8)
    used_plain = int((plain.inner.feature_importance() > 0).sum())
    used_cegb = int((cegb.inner.feature_importance() > 0).sum())
    assert used_cegb <= used_plain
    assert used_cegb < f
    # the model's used set is the features its trees split on
    assert int(cegb.inner._cegb_used.sum()) == used_cegb


def test_cegb_split_penalty_shrinks_trees():
    """tests/test_linear_cegb.py:69 on the port."""
    rng = np.random.RandomState(1)
    n = 2500
    X = np.round(rng.randn(n, 6) * 16) / 64
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    base = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
            "min_gain_to_split": 1e-3, **CPU}
    plain = lgt.train(dict(base), lgt.Dataset(X, label=y), 5)
    cegb = lgt.train(dict(base, cegb_penalty_split=0.002),
                     lgt.Dataset(X, label=y), 5)
    leaves_plain = sum(t.num_leaves for t in plain.inner.models)
    leaves_cegb = sum(t.num_leaves for t in cegb.inner.models)
    assert leaves_cegb < leaves_plain
