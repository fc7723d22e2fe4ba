"""The forest kernel's walk (``csrc/forest_predict.cu``) emulated in numpy,
its walk tables (``ops/forest.forest_walk``) and its launch plan
(``ops/forest.forest_plan``), on the CPU.

The kernel walks each (row, tree) pair along per-round child links: the
first later round that splits the same slot (left) and the first later
round that splits slot r + 1 (right), linked only below min(num_splits,
R), from the first round that splits slot 0. Block (chunk, span) walks
its chunk of rows through a span of groups of 8 trees (one group for one
class, K for K classes), a group at a time, a pass of 32 rows at a time,
one lane a tree; the lanes' values are summed by three xor shuffles (4,
2, 1) for one class (else in tree order a class), a span's groups are
chained in group order, and the (span, row, class) partials are summed
in span order by the chunk's last block. The emulation does the same in that order and is
held equal, as integers, to ``forest_slots_plain`` (every round in order)
and to the JAX package's Pallas ``forest_predict_impl`` under the
interpreter (its slots read through a pack whose leaf values are the slot
numbers, one class a tree); its one-class scores bit-equal to
``accumulate_scores``. Packs: ``chip_smoke.forest_edge_pack`` (a 254-round
chain, trees that always split slot 0, padded rounds, num_splits 0 and
past R, padded trees, movable-missing bins, categorical rounds, 3
classes, linear leaves with NaN raw values, 1000 features whose bins the
kernel reads from device memory) and packs of seeded trees through
``forest_pack``.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import forest as jax_forest

from lightgbm_tpu_torch.ops import forest as Fo
from lightgbm_tpu_torch.ops.predict import accumulate_scores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

CPU = torch.device("cpu")
SMS = 132
END = Fo.FOREST_END
TB = Fo.FOREST_TREE_BATCH


def links_by_definition(fp):
    """(T, R) next_left, next_right and (T,) first as defined: the first
    later round below ns that splits the same slot, or slot r + 1; the
    first round that splits slot 0; END where there is none (and for the
    rounds at or past ns)."""
    slot = fp.slot.numpy().T
    T, R = slot.shape
    ns = np.clip(fp.num_splits.numpy(), 0, R)
    nl = np.full((T, R), END, np.int64)
    nr = np.full((T, R), END, np.int64)
    first = np.full(T, END, np.int64)
    for t in range(T):
        s = slot[t, :ns[t]]
        zero = np.nonzero(s == 0)[0]
        if len(zero):
            first[t] = zero[0]
        for r in range(ns[t]):
            same = np.nonzero(s[r + 1:] == s[r])[0]
            child = np.nonzero(s[r + 1:] == r + 1)[0]
            if len(same):
                nl[t, r] = r + 1 + same[0]
            if len(child):
                nr[t, r] = r + 1 + child[0]
    return nl, nr, first


def entries_np(fp):
    """(T, R, 4) i64 node entries {feature | categorical << 31, tbin,
    miss (INT_MIN where the movable-missing bin does not flip the
    threshold's direction), links} built from the definition."""
    nl, nr, first = links_by_definition(fp)
    tr = lambda a: a.numpy().T.astype(np.int64)  # noqa: E731
    tbin, miss = tr(fp.tbin), tr(fp.miss_bin)
    flips = (tr(fp.movable) == 1) & ((tr(fp.default_left) == 1)
                                     != (miss <= tbin))
    miss = np.where(flips, miss, Fo.FOREST_NO_MISS)
    word = tr(fp.feature) | (tr(fp.kind) > 0).astype(np.int64) << 31
    return np.stack([word, tbin, miss, nl | nr << 16], axis=2), first


def walk_np(bins, fp, t, rows, nodes, first, has_cat):
    """Leaf slots of ``rows`` through tree ``t`` by the kernel's walk."""
    cat = fp.cat_bins.numpy()
    r = np.full(len(rows), first[t], np.int64)
    state = np.zeros(len(rows), np.int64)
    while True:
        live = np.nonzero(r < fp.slot.shape[0])[0]    # END ends a walk
        if not len(live):
            return state
        e = nodes[t, r[live]]
        c = bins[rows[live], e[:, 0] & ((1 << 31) - 1)].astype(np.int64)
        go = (c <= e[:, 1]) != (c == e[:, 2])
        if has_cat:
            in_set = (cat[r[live], t, :] == c[:, None]).any(axis=1)
            go = np.where((e[:, 0] >> 31) & 1 == 1, in_set, go)
        state[live] = np.where(go, state[live], r[live] + 1)
        links = e[:, 3]
        r[live] = np.where(go, links & 0xFFFF, links >> 16)


def leaf_value_np(fp, X, t, rows, slots, has_linear):
    """The lane's leaf value: the slot's value, or its linear model unless
    a used raw value is NaN (the kernel's order: contributions summed over
    k in order from 0, then added to the constant)."""
    v = fp.value_of_slot.numpy()[t, slots]
    if not has_linear:
        return v
    cf = fp.coeff.numpy()[t, slots]            # (rows, Km)
    fi = fp.coeff_feat.numpy()[t, slots]
    used = fp.coeff_mask.numpy()[t, slots] > 0.5
    z = X[rows[:, None], fi]
    nanrow = (used & np.isnan(z)).any(axis=1)
    contrib = np.zeros(len(rows), np.float32)
    for k in range(cf.shape[1]):
        ok = used[:, k] & ~np.isnan(z[:, k])
        contrib = np.where(ok, contrib + z[:, k] * cf[:, k], contrib)
    lin = fp.const_of_slot.numpy()[t, slots] + contrib
    return np.where(nanrow, v, lin).astype(np.float32)


def lane_sums(v):
    """(rows, 8) lane values -> lane 0 after xor shuffles 4, 2, 1."""
    for m in (4, 2, 1):
        v = v + v[:, np.arange(TB) ^ m]
    return v[:, 0]


def emulate(bins, X, fp, num_class=1, has_cat=False, has_linear=False,
            sms=SMS):
    """The kernel's order of work over the plan's blocks. Returns ((T, n)
    slots, (n,) or (n, K) f32 scores, (groups, n) visits of each
    (group, row))."""
    bins = np.asarray(bins)
    n, F = bins.shape
    R, T = fp.slot.shape
    K = max(1, num_class)
    plan = Fo.forest_plan(n, T, R, sms, F, K)
    nodes, first = entries_np(fp)
    cls = fp.tree_class.numpy()
    slots = np.full((T, n), -1, np.int64)
    part = np.zeros((plan.spans, n, K), np.float32)
    visits = np.zeros((plan.groups, n), np.int64)
    for c, sp in np.ndindex(plan.chunks, plan.spans):
        lo = c * plan.rows_per_block
        hi = min(n, lo + plan.rows_per_block)
        assert lo < hi
        g_lo = sp * plan.span
        for g in range(g_lo, min(plan.groups, g_lo + plan.span)):
            for p0 in range(lo, hi, Fo.FOREST_PASS_ROWS):
                rows = np.arange(p0, min(p0 + Fo.FOREST_PASS_ROWS, hi))
                visits[g, rows] += 1
                v = np.zeros((len(rows), TB), np.float32)
                for j in range(TB):
                    t = g * TB + j
                    s = walk_np(bins, fp, t, rows, nodes, first, has_cat)
                    slots[t, rows] = s
                    v[:, j] = leaf_value_np(fp, X, t, rows, s, has_linear)
                if K == 1:
                    assert plan.span == 1
                    part[sp, rows, 0] = lane_sums(v)
                else:
                    for k in range(K):
                        acc = np.zeros(len(rows), np.float32)
                        for j in range(TB):
                            acc = acc + np.where(cls[g * TB + j] == k,
                                                 v[:, j], np.float32(0))
                        part[sp, rows, k] = acc if g == g_lo \
                            else part[sp, rows, k] + acc
    out = np.zeros((n, K), np.float32)
    for sp in range(plan.spans):
        out = out + part[sp]
    return slots, (out[:, 0] if K == 1 else out), visits


def jax_slots(bins, fp, has_cat):
    """(T, n) slots from the JAX package's Pallas kernel under the
    interpreter: each tree's leaf values are its slot numbers and each
    tree is a class of its own, so every score is one tree's slot."""
    R, T = fp.slot.shape
    arrs = {f: getattr(fp, f).numpy() for f in fp._fields}
    arrs["value_of_slot"] = np.tile(np.arange(R + 1, dtype=np.float32),
                                    (T, 1))
    arrs["tree_class"] = np.arange(T, dtype=np.int32)
    jfp = jax_forest.ForestPack(**{f: jnp.asarray(a)
                                   for f, a in arrs.items()})
    out = jax_forest.forest_predict_impl(jnp.asarray(np.asarray(bins)),
                                         None, jfp, num_class=T,
                                         has_cat=has_cat, interpret=True)
    return np.asarray(out).T.astype(np.int64)


def check_pack(fp, bins, X, kw):
    slots, got, visits = emulate(bins.numpy(), None if X is None
                                 else X.numpy(), fp, **kw)
    assert (visits == 1).all()
    plain = Fo.forest_slots_plain(bins, fp, kw["has_cat"]).numpy()
    assert np.array_equal(slots, plain)
    assert np.array_equal(slots, jax_slots(bins, fp, kw["has_cat"]))
    want = Fo.forest_predict_plain(bins, X, fp, **kw).numpy()
    if kw["num_class"] == 1 and not kw["has_linear"]:
        ref = accumulate_scores(torch.gather(
            fp.value_of_slot, 1, torch.from_numpy(plain).long()),
            fp.tree_class, 1).numpy()
        assert got.tobytes() == ref.tobytes()
        assert got.tobytes() == want.tobytes()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", chip_smoke.FOREST_EDGE_CASES)
def test_walk_matches_plain_and_jax(case):
    rng = np.random.RandomState(len(case))
    fp, bins, X, kw = chip_smoke.forest_edge_pack(case, rng, 300, CPU)
    check_pack(fp, bins, X, kw)


@pytest.mark.parametrize("case", ["numerical", "categorical", "linear"])
def test_walk_on_packed_trees(case):
    """Seeded trees of a real Dataset through forest_pack (the serving
    path's packer): 11 trees of 31 leaves, padded to 16."""
    rng = np.random.RandomState(5)
    n = 400
    X = np.round(rng.randn(n, 10) * 16) / 64.0
    X[rng.rand(n, 10) < 0.1] = np.nan
    params = {"verbosity": -1}
    if case == "categorical":
        X[:, 0] = rng.randint(0, 12, n)
        params["categorical_feature"] = "0"
    ds = chip_smoke.construct(X, params)
    trees = chip_smoke.random_trees(ds, rng, 11, 31,
                                    categorical=case == "categorical",
                                    linear=case == "linear")
    fp, has_cat, has_lin = Fo.forest_pack(trees, ds)
    assert fp.slot.shape[1] == 16
    b, xr = chip_smoke.bin_rows(ds, X)
    check_pack(fp, torch.from_numpy(b), torch.from_numpy(xr),
               dict(num_class=1, has_cat=has_cat, has_linear=has_lin))


@pytest.mark.parametrize("case", chip_smoke.FOREST_EDGE_CASES)
def test_walk_tables_equal_their_definition(case):
    """forest_walk's entries and links (torch sort and search) equal the
    first-later-round definition, on every round a row can reach."""
    rng = np.random.RandomState(len(case) + 1)
    fp, _, _, _ = chip_smoke.forest_edge_pack(case, rng, 8, CPU)
    walk = Fo.forest_walk(fp)
    want, first = entries_np(fp)
    got = walk.nodes.numpy().transpose(1, 0, 2).astype(np.int64) \
        & 0xFFFFFFFF
    assert np.array_equal(walk.first.numpy(), first)
    R = fp.slot.shape[0]
    ns = np.clip(fp.num_splits.numpy(), 0, R)
    live = np.arange(R)[None, :] < ns[:, None]
    assert np.array_equal(got[live], (want & 0xFFFFFFFF)[live])
    # a padded round is never linked to, and its links end the walk
    links = got[..., 3]
    for t in range(fp.slot.shape[1]):
        for half in (links[t] & 0xFFFF, links[t] >> 16):
            assert ((half < ns[t]) | (half == END)).all()
    assert (links[~live] == END | END << 16).all()


def test_walk_depth_is_the_path():
    """On the 254-round chain a row that keeps going right visits every
    round; a tree without splits starts at END (slot 0)."""
    rng = np.random.RandomState(3)
    fp, _, _, _ = chip_smoke.forest_edge_pack("chain254", rng, 8, CPU)
    nl, nr, first = links_by_definition(fp)
    assert (first == 0).all()
    assert (nr[:, :-1] == np.arange(1, 254)).all() and (nr[:, -1] == END).all()
    assert (nl == END).all()
    fp, _, _, _ = chip_smoke.forest_edge_pack("no_splits", rng, 8, CPU)
    assert (Fo.forest_walk(fp).first.numpy()[::2] == END).all()


@pytest.mark.parametrize("n", [1, 256, 4096, 65536])
@pytest.mark.parametrize("T", [8, 40, 200])
@pytest.mark.parametrize("K", [1, 3, 10])
def test_forest_plan(n, T, K):
    """Every (row, group) pair is covered by exactly one block, every
    chunk holds rows, one class walks one group a block, the scratch of
    (span, row, class) partials exceeds one class's by at most n x K, the
    grid is about one wave, and the block's shared memory is what its
    tables and staged passes take, within a block's limit."""
    R, F = 254, 28
    plan = Fo.forest_plan(n, T, R, SMS, F, K)
    assert plan.groups == T // TB
    assert plan.span == (1 if K == 1 else min(plan.groups, K))
    assert plan.rows_per_block % Fo.FOREST_PASS_ROWS == 0
    cover = np.zeros((plan.groups, n), np.int64)
    for c, sp in np.ndindex(plan.chunks, plan.spans):
        lo = c * plan.rows_per_block
        hi = min(n, lo + plan.rows_per_block)
        g_lo = sp * plan.span
        assert lo < hi and g_lo < plan.groups
        cover[g_lo:g_lo + plan.span, lo:hi] += 1
    assert (cover == 1).all()
    assert plan.spans * n * K <= plan.groups * n + n * K
    assert plan.smem == Fo.forest_smem_bytes(R, F, plan.staged)
    assert plan.smem <= Fo.FOREST_SMEM_BYTES
    assert plan.staged == (Fo.forest_smem_bytes(R, F, True)
                           <= Fo.FOREST_SMEM_BYTES)
    per_sm = min(Fo.FOREST_BLOCKS_PER_SM,
                 Fo.FOREST_SM_SMEM_BYTES // (plan.smem + 1024))
    wave = SMS * per_sm
    blocks = plan.chunks * plan.spans
    assert blocks <= max(wave, plan.spans)
    if n >= Fo.FOREST_PASS_ROWS * wave:
        assert blocks > wave // 2      # the card is filled


def test_forest_plan_shapes_of_the_serving_rungs():
    """40 trees x 254 rounds over 28 features: a 256-row rung runs 8 x 5
    blocks (one pass each), 4096 rows 64 x 5, the top rung 103 x 5 (four
    blocks an SM fit beside their ~47 KB of shared memory); 1000 features
    do not fit a pass's bins beside the tables."""
    assert Fo.forest_smem_bytes(254, 28, True) == \
        8 * (16 * 254 + 4 * 255) + 2 * 32 * 28 * 4
    assert Fo.forest_plan(256, 40, 254, SMS, 28, 1) == Fo.ForestPlan(
        True, 32, 8, 5, 1, 5, 47840)
    assert Fo.forest_plan(4096, 40, 254, SMS, 28, 1).chunks == 64
    assert Fo.forest_plan(65536, 40, 254, SMS, 28, 1) == Fo.ForestPlan(
        True, 640, 103, 5, 1, 5, 47840)
    assert not Fo.forest_plan(4096, 40, 254, SMS, 1000, 1).staged
    assert not Fo.forest_plan(1, 16, 254, 1, chip_smoke.FOREST_WIDE_F,
                              1).staged


def test_forest_plan_bounds_the_multiclass_scratch():
    """A 10-class model of 600 trees (75 groups) at the top rung keeps 8
    spans of 10 groups: 8 x 65,536 x 10 f32 partials (21 MB), not one a
    group (75 x 65,536 x 10, 197 MB)."""
    plan = Fo.forest_plan(65536, 600, 254, SMS, 28, 10)
    assert (plan.groups, plan.span, plan.spans) == (75, 10, 8)
    assert plan.spans * 65536 * 10 * 4 == 20971520
    assert plan.chunks * plan.spans <= SMS * Fo.FOREST_BLOCKS_PER_SM


def test_forest_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="rounds"):
        Fo.forest_plan(256, 8, Fo.FOREST_MAX_ROUNDS + 1, SMS, 28, 1)
    with pytest.raises(ValueError, match="groups"):
        Fo.forest_plan(256, 12, 30, SMS, 28, 1)
    assert Fo.forest_smem_bytes(Fo.FOREST_MAX_ROUNDS, 0, False) \
        <= Fo.FOREST_SMEM_BYTES
    assert Fo.forest_smem_bytes(Fo.FOREST_MAX_ROUNDS + 1, 0, False) \
        > Fo.FOREST_SMEM_BYTES
    assert Fo.FOREST_MAX_ROUNDS < END       # links are 16-bit


def test_pack_refuses_too_many_rounds():
    """forest_pack raises for trees deeper than the kernel's shared
    memory holds."""
    rng = np.random.RandomState(2)
    ds = chip_smoke.construct(rng.randn(2000, 3), {"verbosity": -1})
    trees = chip_smoke.chain_trees(ds, rng, 1, Fo.FOREST_MAX_ROUNDS + 1)
    with pytest.raises(ValueError, match="rounds"):
        Fo.forest_pack(trees, ds)
    trees = chip_smoke.chain_trees(ds, rng, 1, Fo.FOREST_MAX_ROUNDS)
    assert Fo.forest_pack(trees, ds)[0].slot.shape[0] == \
        Fo.FOREST_MAX_ROUNDS
