"""The split scan with the chain's sibling folded in (``ops/scan.SplitScan.
fold``) and the split commit that no longer copies the children
(``ops/commit.split_commit_plain(pooled=True)``), on the CPU, where both
run their plain twins.

The bars:
- (a) the fold twin equals today's torch sequence bit for bit: the
  sibling by ``index_select`` / ``sub`` / ``where``, ``find_best_split``,
  then the commit's copy of both children into the pool; and the state a
  pooled commit leaves equals the copying commit's, field by field,
  either child the smaller, a live and a dead header, numerical and
  categorical features;
- (b) the fold twin's outputs match the JAX package's ``find_best_split``
  on each child, from the same numpy-seeded histograms;
- (c) device-loop trees through the fold (the chain without bundles, the
  dense builder, forced splits read from the pool, a tree that stops
  early and runs dead headers) equal the JAX package's trees.

Tolerances: (a) exact (bytes equal); (b) integer fields equal, float
fields rtol 1e-5 / atol 1e-6 (the two packages sum a prefix in different
orders: JAX in XLA's cumsum, the port in torch's); (c) as
``torch_port_cases.assert_same_trees``.
"""
import json
import os

import numpy as np
import pytest
import torch

from torch_port_cases import (CPU, assert_same_trees, jax_dataset,
                              train_params)

import jax
import jax.numpy as jnp
import lightgbm_tpu as lgb
from lightgbm_tpu.ops import split as JS

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import commit as C
from lightgbm_tpu_torch.ops import partition as P
from lightgbm_tpu_torch.ops import split as PS
from lightgbm_tpu_torch.ops.scan import (SplitScan, fold_children,
                                         split_scan_fold_plain,
                                         split_scan_plain)
from lightgbm_tpu_torch.prng import PRNGKey

F, B, L = 6, 32, 8
#: the split's slot: its parent leaf is PARENT, its new leaf SLOT + 1
SLOT, PARENT = 3, 2


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _meta(cat):
    """numpy FeatureMeta columns: two features short of B bins, a movable
    NaN bin on feature 0, and with ``cat`` a categorical feature 2 of 12
    categories."""
    nb = np.array([B, 20, B, 9, B, 27], np.int32)
    meta = dict(num_bins=nb, movable_missing=np.zeros(F, bool),
                missing_bin=np.zeros(F, np.int32),
                is_categorical=np.zeros(F, bool),
                monotone=np.zeros(F, np.int8), penalty=np.ones(F, np.float32),
                cegb_coupled=np.zeros(F, np.float32))
    meta["movable_missing"][0] = True
    meta["missing_bin"][0] = B - 1
    if cat:
        meta["is_categorical"][2] = True
        nb[2] = 12
    return meta


def _hist(rng, nb, n, signal):
    """An (F, B, 3) histogram of n seeded rows on a 1/64 grid."""
    bins = np.stack([rng.randint(0, nb[f], n) for f in range(F)], axis=1)
    g = np.round((rng.randn(n) * 0.25 + signal * (bins[:, 1] > nb[1] // 2)
                  + 0.5 * np.isin(bins[:, 2], (1, 4, 7))) * 64) / 64
    h = (np.round(np.abs(rng.randn(n)) * 16) + 6) / 64
    out = np.zeros((F, B, 3), np.float32)
    for f in range(F):
        np.add.at(out[f], bins[:, f], np.stack([g, h, np.ones(n)], axis=1))
    return out


def _inputs(seed, cat, ls, live):
    """numpy pool (L, F, B, 3) whose row PARENT is a parent's histogram,
    the smaller child (F, B, 3) below it, the (8,) header and (12,) pair
    row of split SLOT, and the meta and hyperparameters."""
    rng = np.random.RandomState(seed)
    meta = _meta(cat)
    pool = np.stack([_hist(rng, meta["num_bins"], 500, 0.2)
                     for _ in range(L)])
    small = _hist(rng, meta["num_bins"], 900, 0.4)
    pool[PARENT] = small + _hist(rng, meta["num_bins"], 1300, -0.3)
    sums_small = small[0].sum(axis=0)
    sums_large = pool[PARENT][0].sum(axis=0) - sums_small
    sums = np.stack([sums_small, sums_large] if ls
                    else [sums_large, sums_small]).astype(np.float32)
    pair = np.concatenate([sums.reshape(-1), [0.01, -0.02],
                           [-np.inf, -np.inf], [np.inf, np.inf]]
                          ).astype(np.float32)
    hdr = np.array([0, 128, 2200, 1, ls, 2, live, PARENT], np.int32)
    hp = dict(min_data_in_leaf=20.0, has_categorical=cat,
              max_cat_to_onehot=4, min_data_per_group=10.0)
    return pool, small, hdr, pair, meta, hp


def _torch(meta, hp):
    return (PS.FeatureMeta(**{k: torch.as_tensor(v) for k, v in meta.items()}),
            PS.SplitHyper(**hp))


CASES = [(ls, live, cat) for cat in (False, True) for ls in (1, 0)
         for live in (1, 0)]


@pytest.mark.parametrize("ls,live,cat", CASES)
def test_fold_twin_equals_torch_sequence(ls, live, cat):
    pool, small, hdr, pair, meta, hp = _inputs(5, cat, ls, live)
    tmeta, thp = _torch(meta, hp)
    fmask = torch.ones(F, dtype=torch.bool)
    small_t, hdr_t, pair_t = (torch.as_tensor(small), torch.as_tensor(hdr),
                              torch.as_tensor(pair))
    # the fold
    pool_a = torch.as_tensor(pool).clone()
    out_a = P.split_out(F, B, "cpu")
    split_scan_fold_plain(small_t, pool_a, hdr_t, SLOT + 1, pair_t, out_a,
                          tmeta, fmask, thp)
    # today's torch sequence, then the commit's copy
    pool_b = torch.as_tensor(pool).clone()
    out_b = P.split_out(F, B, "cpu")
    large = pool_b.index_select(0, hdr_t[7:8]).squeeze(0) - small_t
    is_ls = hdr_t[4:5] != 0
    torch.where(is_ls, small_t, large, out=out_b.hists[0])
    torch.where(is_ls, large, small_t, out=out_b.hists[1])
    split_scan_plain(out_b.hists, pair_t, hdr_t, out_b, tmeta, fmask, thp)
    if live:
        pool_b[PARENT] = out_b.hists[0]
        pool_b[SLOT + 1] = out_b.hists[1]
    assert torch.equal(pool_a.view(torch.uint8), pool_b.view(torch.uint8))
    for fld in ("fout", "iout", "bout"):
        assert torch.equal(getattr(out_a, fld), getattr(out_b, fld)), fld
    if live:
        assert float(out_a.fout[0]) > 0 and float(out_a.fout[1]) > 0
    if cat and live:
        assert {2, 3} & set(out_a.iout[4:6].tolist()) or 1 in \
            out_a.iout[4:6].tolist()
    # a dead header leaves the pool as it was
    if not live:
        assert torch.equal(pool_a, torch.as_tensor(pool))


@pytest.mark.parametrize("ls,live,cat", CASES)
def test_pooled_commit_equals_copying_commit(ls, live, cat):
    """Commit SLOT + 1 applies split SLOT: the state after the fold and a
    pooled commit equals the state after the torch sequence into the
    split outputs and a commit that copies them, field by field."""
    pool, small, hdr, pair, meta, hp = _inputs(7, cat, ls, live)
    tmeta, thp = _torch(meta, hp)
    fmask = torch.ones(F, dtype=torch.bool)
    gains = np.random.RandomState(11).uniform(-1, 1, L).astype(np.float32)
    states = []
    for pooled in (True, False):
        st = C.tree_state(L, F, B, "cpu")
        st.hist_pool.copy_(torch.as_tensor(pool))
        st.best_gain.copy_(torch.as_tensor(gains))
        st.seg_tab[:, 0] = 128
        st.seg_tab[:, 1] = 100
        st.hdr[SLOT].copy_(torch.as_tensor(hdr))
        st.pair[SLOT].copy_(torch.as_tensor(pair))
        st.depth[PARENT] = 2
        out = P.split_out(F, B, "cpu")
        out.lt.fill_(900)
        small_t = torch.as_tensor(small)
        if pooled:
            split_scan_fold_plain(small_t, st.hist_pool, st.hdr[SLOT],
                                  SLOT + 1, st.pair[SLOT], out, tmeta, fmask,
                                  thp)
        else:
            out.hists.copy_(fold_children(small_t, st.hist_pool,
                                          st.hdr[SLOT]))
            split_scan_plain(out.hists, st.pair[SLOT], st.hdr[SLOT], out,
                             tmeta, fmask, thp)
        C.split_commit_plain(st, out, SLOT + 1, max_depth=-1,
                             monotone=tmeta.monotone, has_monotone=False,
                             pooled=pooled)
        states.append(st)
    for fld, a, b in zip(C.TreeState._fields, *states):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), fld
    assert int(states[0].hdr[SLOT + 1, 6]) == live


@pytest.mark.parametrize("cat", [False, True])
@pytest.mark.parametrize("ls", [1, 0])
def test_fold_scan_matches_jax_find_best_split(cat, ls):
    pool, small, hdr, pair, meta, hp = _inputs(13, cat, ls, 1)
    tmeta, thp = _torch(meta, hp)
    fmask = np.ones(F, bool)
    out = P.split_out(F, B, "cpu")
    pool_t = torch.as_tensor(pool).clone()
    split_scan_fold_plain(torch.as_tensor(small), pool_t,
                          torch.as_tensor(hdr), SLOT + 1,
                          torch.as_tensor(pair), out, tmeta,
                          torch.as_tensor(fmask), thp)
    got = out.infos()
    jmeta = JS.FeatureMeta(**{k: jnp.asarray(v) for k, v in meta.items()})
    jhp = JS.SplitHyper(**hp)
    kinds = set()
    for c, slot in ((0, PARENT), (1, SLOT + 1)):
        hist = pool_t[slot].numpy()
        want = JS.find_best_split(
            jnp.asarray(hist), jnp.asarray(pair[3 * c:3 * c + 3]), jmeta,
            jnp.asarray(fmask), jhp, parent_output=jnp.float32(pair[6 + c]))
        for fld in ("feature", "bin", "kind", "default_left", "go_left"):
            np.testing.assert_array_equal(
                np.asarray(getattr(want, fld)),
                getattr(got, fld)[c].numpy(), err_msg=fld)
        for fld in ("gain", "left_sum", "right_sum", "left_output",
                    "right_output"):
            np.testing.assert_allclose(
                getattr(got, fld)[c].numpy(), np.asarray(getattr(want, fld)),
                rtol=1e-5, atol=1e-6, err_msg=fld)
        kinds.add(int(got.kind[c]))
        assert float(got.gain[c]) > 0
    # the children's histograms are the parent's split by the smaller one
    np.testing.assert_array_equal(
        pool_t[PARENT if ls else SLOT + 1].numpy(), small)


def _forced_file(tmp_path):
    """A forced-split tree of three levels (7 splits) on features 0-3."""
    t = {"feature": 0, "threshold": 0.05,
         "left": {"feature": 1, "threshold": -0.1,
                  "left": {"feature": 2, "threshold": 0.0},
                  "right": {"feature": 3, "threshold": 0.1}},
         "right": {"feature": 2, "threshold": 0.2,
                   "left": {"feature": 1, "threshold": 0.0},
                   "right": {"feature": 3, "threshold": -0.05}}}
    path = os.path.join(str(tmp_path), "forced.json")
    with open(path, "w") as f:
        json.dump(t, f)
    return path


def _channels(X, seed=5):
    """One tree's (grad, hess, in-bag) channels, a tenth of the rows out
    of bag (the channels of test_torch_split_options.py)."""
    rng = np.random.RandomState(seed)
    n = X.shape[0]
    g = (rng.randn(n) * 0.5).astype(np.float32)
    h = (rng.rand(n) * 0.25 + 0.05).astype(np.float32)
    inbag = (rng.rand(n) < 0.9).astype(np.float32)
    return np.stack([g * inbag, h * inbag, inbag], axis=1)


#: (params, rows): the chain without bundles; forced splits (the forced
#: leaf's scan reads the pool); a tree that stops early (dead headers);
#: the dense builder
LOOP_CASES = {
    "chain": ({}, 1500),
    "forced": ({"forcedsplits_filename": "FORCED"}, 1500),
    "stops_early": ({"num_leaves": 63, "min_data_in_leaf": 40}, 600),
    "dense": ({"tree_builder": "dense"}, 1500),
}


@pytest.mark.parametrize("name", sorted(LOOP_CASES))
def test_fold_loop_trees_equal_jax(tmp_path, name):
    extra, n = LOOP_CASES[name]
    extra = {k: (_forced_file(tmp_path) if v == "FORCED" else v)
             for k, v in extra.items()}
    params = dict(train_params("binary"), **extra)
    ds, path, X, _, _ = jax_dataset("binary", tmp_path, n=n, seed=2)
    jlrn = lgb.Booster(dict(params), train_set=ds).inner.learner
    plrn = lgt.Booster(dict(params, **CPU), lgt.dataset_from_reference(
        path, CPU)).inner.learner
    ghc = _channels(X)
    fmask = np.ones(X.shape[1], dtype=bool)
    jlog = jlrn.train(jnp.asarray(ghc), jnp.asarray(fmask),
                      jax.random.PRNGKey(9))
    plog = plrn.train_device(torch.as_tensor(ghc), torch.as_tensor(fmask),
                             PRNGKey(9))
    loop = plrn._loop
    assert loop.pooled and loop.commit.pooled
    ns = int(plog.num_splits[0])
    assert ns == int(jlog.num_splits) > 3
    if name == "stops_early":
        assert ns < params["num_leaves"] - 1
        assert int(loop.state.hdr[ns, 6]) == 0       # a dead header ran
    if name == "forced":       # the forced tree's top levels, BFS
        assert plog.feature[:7].tolist() == [0, 1, 2, 2, 3, 1, 3]
    assert_same_trees([jlrn.log_to_tree(jlog)], [plrn.log_to_tree(plog)])
    # the fold leaves each leaf's histogram in the pool: its count channel
    # sums to the leaf's in-bag rows
    cnt = loop.state.hist_pool[:ns + 1, 0, :, 2].sum(dim=1)
    inbag = torch.bincount(plog.row_leaf.long(),
                           weights=torch.as_tensor(ghc[:, 2]).double(),
                           minlength=ns + 1)
    assert torch.equal(cnt.double(), inbag[:ns + 1])


def test_fold_arguments_checked():
    """The fold's shapes and slot are checked on the host."""
    meta, hp = _torch(_meta(False), {})
    op = SplitScan(meta, torch.ones(F, dtype=torch.bool), hp, num_feat=F,
                   num_bins=B, device="cpu")
    pool = torch.zeros((L, F, B, 3))
    hdr = torch.zeros(8, dtype=torch.int32)
    pair = torch.zeros(12)
    out = P.split_out(F, B, "cpu")
    with pytest.raises(ValueError, match="small"):
        op.fold(torch.zeros((F, B + 1, 3)), pool, hdr, 1, pair, out)
    with pytest.raises(ValueError, match="pool"):
        op.fold(torch.zeros((F, B, 3)), pool[:, :, :4], hdr, 1, pair, out)
    with pytest.raises(ValueError, match="new_slot"):
        op.fold(torch.zeros((F, B, 3)), pool, hdr, L, pair, out)
    assert C.commit_blocks(28 * 255 * 3, True) == 1
    assert C.commit_blocks(28 * 255 * 3, False) == 1 + 21
