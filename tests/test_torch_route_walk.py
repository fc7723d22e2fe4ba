"""The row router's walk (``csrc/route_rows.cu``) emulated in numpy, and its
launch plan (``ops/route.route_plan``), on the CPU.

The kernel derives two child links per round from the (R * TBL_W) table
(the first later round that splits the same leaf, and the first later
round that splits leaf r + 1), links only rounds below min(num_splits,
R), and walks each row from the first round that splits leaf 0. The
emulation does the same and is held equal, as integers, to
``route_rows_plain`` (every round in order) and to the JAX package's
Pallas ``route_rows`` under the interpreter, on tables that stress the
walk: a 254-round chain (each split takes the newest right child), a tree
that always splits leaf 0, padded rounds (``split_leaf = 0`` past
num_splits, as the learner pads them), num_splits of 0 and past R, EFB
bundle columns with out-of-range slots on both sides, and movable-missing
bins.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu.ops.partition
from lightgbm_tpu.ops.route import route_rows as jax_route_rows

from lightgbm_tpu_torch.ops import route as R

SMS = 132
END = 0xFFFF


def route_links(table, num_splits):
    """(first round splitting leaf 0, next_left, next_right, ns) as the
    kernel's prologue derives them: keys leaf << 16 | r of the rounds
    below ns (a leaf id outside [0, R] gets no key: no row reaches it),
    padded to a power of two and sorted; next_left is the next key if it
    has the same leaf, next_right and the first round the first key at or
    above (r + 1) << 16 | (r + 1) and 0 with the wanted leaf. END ends the
    walk."""
    tbl = np.asarray(table).reshape(-1, R.TBL_W)
    rounds = tbl.shape[0]
    ns = max(0, min(int(num_splits), rounds))
    nkeys = 1
    while nkeys < rounds:
        nkeys *= 2
    no_key = 0xFFFFFFFF
    keys = np.full(nkeys, no_key, np.uint64)
    for r in range(ns):
        leaf = int(tbl[r, 1])
        if 0 <= leaf <= rounds:
            keys[r] = leaf << 16 | r
    keys = np.sort(keys)
    nl = np.full(ns, END, np.int64)
    nr = np.full(ns, END, np.int64)
    for p, key in enumerate(keys):
        key = int(key)
        if key == no_key:
            continue
        r = key & 0xFFFF
        nxt = int(keys[p + 1]) if p + 1 < nkeys else no_key
        if nxt != no_key and nxt >> 16 == key >> 16:
            nl[r] = nxt & 0xFFFF
        want = (r + 1) << 16 | (r + 1)
        q = int(np.searchsorted(keys, want, side="left"))
        kq = int(keys[q]) if q < nkeys else no_key
        if kq != no_key and kq >> 16 == r + 1:
            nr[r] = kq & 0xFFFF
    k0 = int(keys[0])
    first = k0 & 0xFFFF if ns > 0 and k0 != no_key and k0 >> 16 == 0 \
        else END
    return first, nl, nr, ns


def links_by_definition(table, num_splits):
    """The links as defined: the first later round below ns that splits
    the same leaf, or leaf r + 1; the first round that splits leaf 0."""
    tbl = np.asarray(table).reshape(-1, R.TBL_W)
    ns = max(0, min(int(num_splits), tbl.shape[0]))
    leaf = tbl[:ns, 1]
    nl = np.full(ns, END, np.int64)
    nr = np.full(ns, END, np.int64)
    for r in range(ns):
        same = np.nonzero(leaf[r + 1:] == leaf[r])[0]
        child = np.nonzero(leaf[r + 1:] == r + 1)[0]
        if len(same):
            nl[r] = r + 1 + same[0]
        if len(child):
            nr[r] = r + 1 + child[0]
    zero = np.nonzero(leaf == 0)[0]
    return (int(zero[0]) if len(zero) else END), nl, nr, ns


def route_walk_np(bins_t, table, num_splits):
    """The kernel's walk over (F, npad) u8 bins: each row follows ~depth
    links. Returns (npad,) i32 leaf ids."""
    flat = np.asarray(bins_t).reshape(np.asarray(bins_t).shape[0], -1)
    tbl = np.asarray(table).reshape(-1, R.TBL_W).astype(np.int64)
    first, nl, nr, ns = route_links(table, num_splits)
    npad = flat.shape[1]
    rows = np.arange(npad)
    r = np.full(npad, first, np.int64)
    state = np.zeros(npad, np.int64)
    while True:
        live = r < ns
        if not live.any():
            break
        i, rr = rows[live], r[live]
        col, tbin, miss, dl, plain, off, dpos, nbm1, rest = \
            (tbl[rr, k] for k in (0, 2, 3, 4, 5, 6, 7, 8, 9))
        c = flat[col, i].astype(np.int64)
        rank = c - off
        eff = np.where(plain == 1, c, rank + (rank >= dpos))
        go = eff <= tbin
        go = np.where((miss >= 0) & (eff == miss), dl != 0, go)
        in_range = (c >= off) & (c < off + nbm1)
        go = np.where((plain == 1) | in_range, go, rest != 0)
        state[i] = np.where(go, state[i], rr + 1)
        r[i] = np.where(go, nl[rr], nr[rr])
    return state.astype(np.int32)


def _table(rows):
    """(R * TBL_W,) i32 from per-round dicts (defaults: plain numerical)."""
    out = []
    for d in rows:
        e = dict(col=0, leaf=0, bin=0, miss=-1, dl=0, plain=1, off=0,
                 dpos=0, nbm1=0, rest=0)
        e.update(d)
        out.append([e[k] for k in ("col", "leaf", "bin", "miss", "dl",
                                   "plain", "off", "dpos", "nbm1", "rest")])
    return np.asarray(out, np.int32).reshape(-1)


def chain(rng, rounds, F):
    """Round r splits leaf r (the newest right child): depth = rounds."""
    return _table([dict(col=r % F, leaf=r, bin=int(rng.randint(0, 12)))
                   for r in range(rounds)])


def leaf_zero(rng, rounds, F):
    """Every round splits leaf 0: each row walks the left links."""
    return _table([dict(col=int(rng.randint(F)), leaf=0,
                        bin=int(rng.randint(150, 256)))
                   for _ in range(rounds)])


def random_tree(rng, rounds, F, bundle=False, missing=False):
    """A best-first-shaped tree: round r splits one of the leaves 0..r;
    with ``bundle`` half the rounds read a bundle column with a sub-feature
    slot range (out-of-range slots go the way ``rest`` says); with
    ``missing`` some rounds carry a movable-missing bin."""
    rows = []
    for r in range(rounds):
        e = dict(col=int(rng.randint(F)), leaf=int(rng.randint(0, r + 1)),
                 bin=int(rng.randint(0, 40)))
        if bundle and rng.rand() < 0.5:
            off = int(rng.randint(1, 20))
            e.update(plain=0, off=off, dpos=int(rng.randint(0, 8)),
                     nbm1=int(rng.randint(4, 24)),
                     rest=int(rng.rand() < 0.5), bin=int(rng.randint(0, 20)))
        if missing and rng.rand() < 0.4:
            e.update(miss=int(rng.randint(0, 40)), dl=int(rng.rand() < 0.5))
        rows.append(e)
    return _table(rows)


def padded(table, ns, rounds):
    """``table``'s first ns rounds, then rounds of split_leaf = 0 up to
    ``rounds`` (the learner's padding; their other columns are junk)."""
    t = np.asarray(table).reshape(-1, R.TBL_W)[:ns]
    pad = np.zeros((rounds - ns, R.TBL_W), np.int32)
    pad[:, 0] = 1
    pad[:, 2] = 255
    pad[:, 5] = 1
    return np.concatenate([t, pad]).reshape(-1)


def _bins(rng, F, npad=2048, nb=48):
    return rng.randint(0, nb, (F, npad)).astype(np.uint8)


CASES = {
    "chain254": lambda rng, F: (chain(rng, 254, F), 254),
    "leaf_zero": lambda rng, F: (leaf_zero(rng, 60, F), 60),
    "numerical": lambda rng, F: (random_tree(rng, 254, F), 254),
    "missing": lambda rng, F: (random_tree(rng, 120, F, missing=True), 120),
    "bundles": lambda rng, F: (random_tree(rng, 120, F, bundle=True,
                                           missing=True), 120),
    "padded": lambda rng, F: (padded(random_tree(rng, 254, F), 37, 254),
                              37),
    "padded_chain": lambda rng, F: (padded(chain(rng, 254, F), 100, 254),
                                    100),
    "no_splits": lambda rng, F: (random_tree(rng, 30, F), 0),
    "past_rounds": lambda rng, F: (random_tree(rng, 30, F), 1000),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_matches_plain_and_jax(case, monkeypatch):
    rng = np.random.RandomState(len(case))
    F = 7
    table, ns = CASES[case](rng, F)
    bins = _bins(rng, F)
    if case == "bundles":           # slots past every sub-feature's range
        bins[:, ::5] = 60
    got = route_walk_np(bins, table, ns)
    bt = torch.as_tensor(bins).reshape(F, -1, 128)
    nst = torch.tensor([ns], dtype=torch.int32)
    want = R.route_rows_plain(bt, torch.as_tensor(table), nst).numpy()
    assert np.array_equal(got, want)
    monkeypatch.setattr(lightgbm_tpu.ops.partition, "_INTERPRET", True)
    ref = np.asarray(jax_route_rows(jnp.asarray(bins).reshape(F, -1, 128),
                                    jnp.asarray(table),
                                    jnp.int32(ns), bins.shape[1],
                                    rows_per_block=1024))
    assert np.array_equal(got, ref)
    # the wrapper's CPU path is the plain twin
    assert np.array_equal(R.route_rows(bt, torch.as_tensor(table),
                                       nst).numpy(), want)


def test_walk_depth_is_the_path():
    """A row's walk visits only the rounds that split its leaf: on the
    chain every row that keeps going right visits every round, on a
    balanced tree ~log2(leaves) rounds."""
    rng = np.random.RandomState(3)
    first, nl, nr, ns = route_links(chain(rng, 254, 5), 254)
    assert first == 0
    assert list(nr[:-1]) == list(range(1, 254)) and nr[-1] == END
    assert (nl == END).all()
    # a balanced tree of 255 leaves: round r splits leaf r // 2 ... as
    # breadth-first order gives it
    rows = [dict(leaf=0)]
    queue = [0, 1]
    for r in range(1, 254):
        leaf = queue.pop(0)
        rows.append(dict(leaf=leaf))
        queue += [leaf, r + 1]
    first, nl, nr, ns = route_links(_table(rows), 254)
    depth = np.zeros(255, int)
    todo = [(first, 0)]
    while todo:
        r, d = todo.pop()
        if r >= ns:
            continue
        depth[r] = d
        todo += [(nl[r], d + 1), (nr[r], d + 1)]
    assert depth.max() <= 8


@pytest.mark.parametrize("seed", range(6))
def test_sorted_links_equal_their_definition(seed):
    """The kernel's sort-and-search links equal the first-later-round
    definition on trees, chains, leaf-0 trees, padded tables and tables
    with leaf ids out of range (rounds no row reaches)."""
    rng = np.random.RandomState(seed)
    F = 5
    tables = [(random_tree(rng, 254, F), 254), (chain(rng, 254, F), 200),
              (leaf_zero(rng, 60, F), 60),
              (padded(random_tree(rng, 254, F), 37, 254), 37),
              (random_tree(rng, 300, F), 1000), (random_tree(rng, 7, F), 0)]
    wild = random_tree(rng, 100, F).reshape(-1, R.TBL_W).copy()
    wild[::7, 1] = rng.choice([-3, 101, 5000], len(wild[::7]))
    tables.append((wild.reshape(-1), 100))
    for table, ns in tables:
        a = route_links(table, ns)
        b = links_by_definition(table, ns)
        assert a[0] == b[0] and a[3] == b[3]
        leaf = np.asarray(table).reshape(-1, R.TBL_W)[:a[3], 1]
        # a round of a leaf id outside [0, R] is never reached: its own
        # links are never followed (and no link leads to it)
        ok = (leaf >= 0) & (leaf <= len(np.asarray(table)) // R.TBL_W)
        assert np.array_equal(a[1][ok], b[1][ok])
        assert np.array_equal(a[2][ok], b[2][ok])


def test_padding_rounds_are_never_linked():
    """The learner pads unused rounds with split_leaf = 0: a row at leaf 0
    past num_splits must not follow them."""
    rng = np.random.RandomState(4)
    table = padded(random_tree(rng, 254, 5), 10, 254)
    first, nl, nr, ns = route_links(table, 10)
    assert ns == 10 and ((nl < 10) | (nl == END)).all()
    assert ((nr < 10) | (nr == END)).all()


@pytest.mark.parametrize("npad,F,rounds", [
    (2_000_128, 28, 254), (100_096, 28, 254), (65_536, 28, 254),
    (128, 28, 254), (2_000_128, 136, 254), (1_000_064, 400, 254),
    (1_000_064, 5000, 254), (4096, 28, R.ROUTE_MAX_ROUNDS), (4096, 28, 0)])
def test_route_plan(npad, F, rounds):
    plan = R.route_plan(npad, F, rounds, SMS)
    ent = R.route_table_bytes(rounds)
    tiles = -(-npad // R.ROUTE_TILE_ROWS)
    assert plan.grid == max(1, min(tiles, SMS * R.ROUTE_BLOCKS_PER_SM))
    assert plan.smem <= R.ROUTE_SMEM_BYTES
    stage = 2 * F * (R.ROUTE_TILE_ROWS + R.ROUTE_STRIPE_PAD)
    assert plan.staged == (ent + stage <= R.ROUTE_SMEM_BYTES)
    assert plan.smem == ent + (stage if plan.staged else 0)


def test_route_plan_shapes_of_the_main_path():
    """2M training rows: staged 256-row tiles, eight blocks per SM, whose
    shared memory fits an SM together; the valid set and a serving rung
    spread over the SMs; thousands of columns read device memory."""
    plan = R.route_plan(2_000_128, 28, 254, SMS)
    assert plan == R.RoutePlan(True, SMS * 8,
                               32 * 254 + 4 * 256 + 2 * 28 * 272)
    assert 8 * (plan.smem + 1024) <= 228 * 1024
    assert R.route_plan(100_096, 28, 254, SMS).grid == 391
    assert R.route_plan(65_536, 28, 254, SMS).grid == 256
    assert not R.route_plan(2_000_128, 5000, 254, SMS).staged


def test_route_plan_refuses_too_many_rounds():
    with pytest.raises(ValueError, match="rounds"):
        R.route_plan(4096, 28, R.ROUTE_MAX_ROUNDS + 1, SMS)
    assert R.route_table_bytes(R.ROUTE_MAX_ROUNDS) <= R.ROUTE_SMEM_BYTES
    assert R.route_table_bytes(R.ROUTE_MAX_ROUNDS + 1) > R.ROUTE_SMEM_BYTES
    assert R.ROUTE_MAX_ROUNDS < 0xFFFF      # links are 16-bit, 0xffff ends
    assert R.route_table_bytes(254) == 32 * 254 + 4 * 256
