"""Launch sizing of the planes partition (K3 planes,
``csrc/partition_segment.cu``) and a numpy emulation of its order of work,
on the CPU.

The kernel runs only on the card; what decides its shape is Python
(``ops/partition.partition_planes_plan``) and a little index arithmetic.
Here:
- the plan: tile rows, stripes and slots, plane groups, the grid, the
  resident-versus-two-read switch, for W in {4, 17, 40, 73, 212} and
  wider;
- the kernel emulated in numpy: block tile ranges, the block prefixes,
  staged stripes of 16-byte chunks, per-tile ballot ranks, each run's
  indices shifted by its first lane mod 4, (plane, word) items with the
  divisions as multiply-highs, aligned 4-byte stores inside a run and
  byte stores at its ends. It is held byte for byte and in ``lt`` to
  ``partition_segment_plain`` and to the JAX package's
  ``partition_segment_planes_fused`` under the Pallas interpreter, and
  every destination byte it stores must lie in the segment and be stored
  exactly once (a word store over a run's end would race with the
  neighbouring run's writer on the card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu.ops.partition as JP

from lightgbm_tpu_torch.ops import partition as P

SMS = 132
WIDTHS = [4, 17, 40, 73, 212]
#: planes of one copy item (the kernel's kCopyPlanes)
COPY_PLANES = 8


def _magic(d):
    """The kernel's unsigned 32-bit 0xffffffff / d + 1 (0 for d = 1)."""
    return (0xFFFFFFFF // d + 1) & 0xFFFFFFFF


def _div(k, d):
    """k // d as the kernel computes it: a multiply-high by the magic, or
    k itself where the magic wrapped to 0."""
    m = _magic(d)
    if m == 0:
        return k
    return int((np.uint64(k) * np.uint64(m)) >> np.uint64(32))


@pytest.mark.parametrize("d", [1, 2, 3, 7, 51, 202, 258])
def test_magic_division_is_exact(d):
    """Every (plane, chunk) and (plane, word) item of the widest group."""
    for k in list(range(0, 4000)) + [d * 1152 - 1]:
        assert _div(k, d) == k // d


@pytest.mark.parametrize("width", WIDTHS + [1000, 3000, 9000])
def test_planes_plan_tiles(width):
    for cnt in (1, 5000, 65536, 700_000, 2_000_000):
        plan = P.partition_planes_plan(cnt, width, SMS)
        assert 1 <= plan.steps <= 32 and plan.tile_rows == 32 * plan.steps
        assert plan.tile_rows * width <= max(P.PART_PLANES_TILE_BYTES,
                                             32 * width)
        assert plan.stripe == plan.tile_rows + P.PART_PLANES_STRIPE_PAD
        assert plan.stripe % 16 == 0
        # a stripe holds a tile's bytes from any lane mod 16, in chunks
        assert 16 * (-(-(15 + plan.tile_rows) // 16)) <= plan.stripe
        assert 1 <= plan.group <= width
        assert plan.slot_bytes == plan.group * plan.stripe
        assert plan.slots * plan.slot_bytes <= P.PART_PLANES_SMEM_BYTES
        if plan.resident:
            assert plan.group == width
        else:
            assert plan.slots in (2, 3)
            assert P.PART_PLANES_BLOCKS_PER_SM * plan.slots \
                * plan.slot_bytes <= P.PART_PLANES_SMEM_BYTES
        # the kernel's multiply-high divisions are exact on every item:
        # (plane, chunk) when staging, (plane, word) when writing
        nch = -(-(15 + plan.tile_rows) // 16)
        nwt = plan.tile_rows // 4 + 2
        for d, items in ((nch, plan.group * nch),
                         (nwt, -(-plan.group // COPY_PLANES) * nwt)):
            assert (items - 1) * d < 2 ** 32


def test_planes_plan_spreads_small_segments():
    """A deep leaf's rows spread over the SMs: a tile per SM and no fewer
    tiles than there are SMs while a 32-row tile allows it."""
    for cnt in (8189, 20798, 65536):
        plan = P.partition_planes_plan(cnt, 40, SMS)
        assert plan.resident and SMS // 2 < plan.grid <= SMS
    assert P.partition_planes_plan(100, 40, SMS).grid == 4
    root = P.partition_planes_plan(2_000_000, 40, SMS)
    assert not root.resident and root.tile_rows == 800
    assert root.slots == 3 and root.grid == SMS         # ~96 KB an SM
    slim = P.partition_planes_plan(2_000_000, 17, SMS)
    assert not slim.resident and slim.tile_rows == 1024
    assert slim.slots == 3 and slim.grid == 2 * SMS     # ~104 KB an SM


@pytest.mark.parametrize("width", WIDTHS)
def test_planes_plan_resident_switch(width):
    """Resident exactly while every tile, all W planes, fits the grid's
    shared memory (PART_PLANES_SMEM_BYTES an SM); then two reads through
    three slots on PART_PLANES_BLOCKS_PER_SM blocks per SM."""
    big = P.partition_planes_plan(10 ** 8, width, SMS)
    cap = P.PART_PLANES_SMEM_BYTES // (big.stripe * width)
    limit = SMS * cap * big.tile_rows
    for cnt in (1, 31, 4097, 65536, limit - 1, limit):
        plan = P.partition_planes_plan(cnt, width, SMS)
        tiles = -(-cnt // plan.tile_rows)
        assert plan.resident, cnt
        assert plan.grid * plan.slots >= tiles
        assert (plan.grid - 1) * plan.slots < tiles       # no idle block
        # the blocks of one SM fit its shared memory together
        assert -(-plan.grid // SMS) * plan.slots * plan.slot_bytes \
            <= P.PART_PLANES_SMEM_BYTES
    for cnt in (limit + 1, 2_000_000, 10_000_000):
        if cnt <= limit:
            continue
        plan = P.partition_planes_plan(cnt, width, SMS)
        assert not plan.resident and plan.slots == 3
        blocks = max(1, min(P.PART_PLANES_BLOCKS_PER_SM,
                            P.PART_PLANES_STREAM_BYTES
                            // (plan.slots * plan.slot_bytes)))
        assert plan.grid == min(-(-cnt // plan.tile_rows), SMS * blocks)


def test_planes_plan_resident_limits():
    """The 2M-row root exceeds the grid's shared memory at W = 40 and at
    the slim rows' W = 17; ~630k and ~1.6M rows fit."""
    for width, most in ((40, 600_000), (17, 1_600_000)):
        assert P.partition_planes_plan(most, width, SMS).resident
        assert not P.partition_planes_plan(2_000_000, width, SMS).resident


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("cnt_bound", [1, 1025, 200_000, 2_000_000])
def test_planes_plan_holds_any_smaller_count(width, cnt_bound):
    """The kernel decides residency from the true count on the card: with
    kb = ceil(tiles / grid) tiles per block, a resident plan stays resident
    (kb <= slots) for every count up to its bound."""
    plan = P.partition_planes_plan(cnt_bound, width, SMS)
    for cnt in np.unique(np.linspace(0, cnt_bound, 50).astype(int)):
        tiles = -(-int(cnt) // plan.tile_rows)
        kb = -(-tiles // plan.grid)
        assert kb * plan.grid >= tiles
        if plan.resident:
            assert kb <= plan.slots


def emulate_planes_kernel(work, seg, table, cnt_bound, sms=SMS, grid=None,
                          group=None):
    """numpy emulation of partition_planes_kernel on a (2, W, npad) u8
    pair, in place. Returns (lt, per-lane store counts of the destination
    buffer). ``grid`` cuts the grid (as the card's occupancy may);
    ``group`` forces smaller plane groups (the two-read path of very wide
    rows)."""
    src, start, cnt, feat = (int(v) for v in seg)
    W, npad = work.shape[1], work.shape[2]
    plan = P.partition_planes_plan(cnt_bound, W, sms)
    G = grid or plan.grid
    T, S = plan.tile_rows, plan.stripe
    grp = group or plan.group
    tbl = np.zeros(256, np.uint8)
    tbl[:len(table)] = table
    sbuf = work[src]
    dst = work[1 - src]
    stores = np.zeros((W, npad), np.int64)
    nt = -(-cnt // T)
    kb = -(-nt // G)
    resident = kb <= plan.slots and grp == W
    ranges = [(min(b * kb, nt), min(b * kb + kb, nt)) for b in range(G)]

    def tile_n(t):
        return min(T, cnt - t * T)

    def stage(t, w0, gw):
        a = start + t * T
        pad = a & 15
        nch = (pad + tile_n(t) + 15) >> 4
        assert 16 * nch <= S
        st = np.zeros((gw, S), np.uint8)
        for k in range(gw * nch):
            q = _div(k, nch)
            c = k - q * nch
            lo = a - pad + 16 * c
            assert lo % 16 == 0 and lo + 16 <= npad
            st[q, 16 * c:16 * c + 16] = sbuf[w0 + q, lo:lo + 16]
        return st, pad

    # 1. count: from the staged split column or from device memory
    left = []
    for t0, t1 in ranges:
        k = 0
        for t in range(t0, t1):
            if resident:
                st, pad = stage(t, 0, W)
                col = st[feat, pad:pad + tile_n(t)]
            else:
                a = start + t * T
                col = sbuf[feat, a:a + tile_n(t)]
            k += int(tbl[col].sum())
        left.append(k)
    total = sum(left)

    def rank(col, n, shl, shr):
        go = tbl[col[:n]].astype(bool)
        steps = -(-n // 32)
        masks = [go[s * 32:s * 32 + 32] for s in range(steps)]
        lpre = np.concatenate([[0], np.cumsum([m.sum() for m in masks])])
        idx = np.full((2, T + 8), 0xFFFF, np.int64)   # stale: never read
        for i in range(n):
            s, lane = divmod(i, 32)
            lb = int(lpre[s] + masks[s][:lane].sum())
            if go[i]:
                idx[0, shl + lb] = i
            else:
                idx[1, shr + (i - lb)] = i
        return int(lpre[-1]), idx

    def copy(st, pad, w0, gw, n, nl, left_at, right_at, idx):
        shl, shr = left_at & 3, right_at & 3
        nr = n - nl
        nwl = (shl + nl + 3) >> 2 if nl else 0
        nwt = nwl + ((shr + nr + 3) >> 2 if nr else 0)
        blocks = -(-gw // COPY_PLANES)
        for k in range(nwt * blocks):
            pb = _div(k, nwt)
            u = k - pb * nwt
            right = u >= nwl
            j = u - nwl if right else u
            s, ln = (shr, nr) if right else (shl, nl)
            ix = idx[1 if right else 0, 4 * j:4 * j + 4]
            lane0 = (right_at if right else left_at) - s + 4 * j
            assert lane0 % 4 == 0
            p0 = 4 * j - s
            q0 = pb * COPY_PLANES
            for q in range(q0, min(q0 + COPY_PLANES, gw)):
                plane = st[q, pad:]
                if p0 >= 0 and p0 + 4 <= ln:
                    dst[w0 + q, lane0:lane0 + 4] = plane[ix]
                    stores[w0 + q, lane0:lane0 + 4] += 1
                else:
                    for b in range(4):
                        if 0 <= p0 + b < ln:
                            dst[w0 + q, lane0 + b] = plane[ix[b]]
                            stores[w0 + q, lane0 + b] += 1

    # 3. scatter, block by block (blocks write disjoint lanes)
    ngroups = -(-W // grp)
    for b, (t0, t1) in enumerate(ranges):
        before = sum(left[:b])
        left_at, right_at = start + before, start + total + t0 * T - before
        for t in range(t0, t1):
            n = tile_n(t)
            a = start + t * T
            if resident:
                st, pad = stage(t, 0, W)
                nl, idx = rank(st[feat, pad:], n, left_at & 3, right_at & 3)
                copy(st, pad, 0, W, n, nl, left_at, right_at, idx)
            else:
                for g in range(ngroups):
                    w0 = g * grp
                    gw = min(grp, W - w0)
                    st, pad = stage(t, w0, gw)
                    if g == 0:      # the staged column when a slot has it
                        col = st[feat, pad:] if ngroups == 1 \
                            else sbuf[feat, a:]
                        nl, idx = rank(col, n, left_at & 3, right_at & 3)
                    copy(st, pad, w0, gw, n, nl, left_at, right_at, idx)
            left_at += nl
            right_at += n - nl
    return total, stores


def _pair(rng, W, npad, nb=64):
    work = rng.randint(0, 256, (2, W, npad)).astype(np.uint8)
    work[:, :min(W, 8)] %= nb
    return work


def _tables(rng, nb=64):
    return {"table": rng.rand(nb) < 0.45, "all": np.ones(nb, bool),
            "none": np.zeros(nb, bool),
            "alternating": np.arange(nb) % 2 == 0}


def _check(work, seg, table, cnt_bound, **kw):
    want = torch.as_tensor(work.copy())
    lt = P.partition_segment_plain(
        want, torch.tensor(seg, dtype=torch.int32), torch.as_tensor(table))
    got = work.copy()
    total, stores = emulate_planes_kernel(got, seg, table, cnt_bound, **kw)
    assert total == int(lt)
    assert np.array_equal(got, want.numpy())
    src, start, cnt, _ = seg
    inside = np.zeros(work.shape[2], bool)
    inside[start:start + cnt] = True
    assert (stores[:, inside] == 1).all()          # each byte once
    assert (stores[:, ~inside] == 0).all()         # nothing outside
    return total


#: (start, cnt) of the emulation cases: unaligned starts, 0, 1, 31, 4095,
#: 4097 rows, and one row past a tile of the W = 40 plan
EDGE_SEGMENTS = [(141, 0), (133, 1), (130, 31), (129, 4095), (131, 4097),
                 (137, 801), (128, 3000)]


@pytest.mark.parametrize("width", [17, 40])
@pytest.mark.parametrize("start,cnt", EDGE_SEGMENTS)
def test_planes_emulation_matches_twin(width, start, cnt):
    rng = np.random.RandomState(width * 1000 + cnt)
    npad = P.planes_npad(start + cnt + 8)
    work = _pair(rng, width, npad)
    tables = _tables(rng)
    for name, table in tables.items():
        lt = _check(work, [0, start, cnt, 3], table, max(cnt, 1))
        if name == "all":
            assert lt == cnt
        if name == "none":
            assert lt == 0


@pytest.mark.parametrize("width,grid,group,cnt_bound", [
    (4, None, None, 2000), (73, 3, None, 2500), (212, None, None, 1500),
    (40, 2, None, 2600), (40, 1, 7, 2600), (17, 3, 5, 3000),
    (40, None, None, 10 ** 7)])
def test_planes_emulation_grids_and_groups(width, grid, group, cnt_bound):
    """Cut grids (several tiles per block: the two-read path), plane groups
    smaller than W (very wide rows) and a bound far above the count."""
    rng = np.random.RandomState(width + (grid or 0))
    start, cnt = 135, 2411
    work = _pair(rng, width, P.planes_npad(start + cnt + 8))
    _check(work, [1, start, cnt, 2], rng.rand(64) < 0.5, cnt_bound,
           grid=grid, group=group)


def test_planes_emulation_shared_end_words():
    """Runs whose first or last word is shared: a left run ending mid-word
    where the right run starts, tiles whose runs meet mid-word, and
    segment ends mid-word beside lanes that must stay untouched."""
    rng = np.random.RandomState(5)
    W = 17
    for start, cnt in ((129, 5), (130, 803), (131, 1602), (128, 7)):
        work = _pair(rng, W, P.planes_npad(start + cnt + 8))
        for k in (1, 2, 3, 5):
            table = np.arange(64) % k == 0
            _check(work, [0, start, cnt, 1], table, cnt, grid=3)


@pytest.mark.parametrize("start,cnt,ch", [(137, 700, 256), (333, 1400, 512),
                                          (513, 100, 256)])
def test_planes_emulation_matches_jax(start, cnt, ch, monkeypatch):
    """The emulation against the JAX kernel under the interpreter: lt
    equal, left rows byte-equal in order, right rows equal as a set (the
    JAX kernel leaves their order unspecified), lanes outside the segment
    untouched."""
    rng = np.random.RandomState(start)
    guard = ch + 2 * JP.PLANE_ALIGN
    n, F = 1500, 20
    npad = ((n + 2 * guard + 127) // 128) * 128
    bins = np.zeros((npad, F), np.uint8)
    bins[guard:guard + n] = rng.randint(0, 32, (n, F))
    ghc = np.zeros((npad, 3), np.float32)
    ghc[guard:guard + n] = rng.randn(n, 3)
    w0 = np.asarray(JP.pack_planes(jnp.asarray(bins), jnp.asarray(ghc)))
    work = np.stack([w0, rng.randint(0, 256, w0.shape).astype(np.uint8)])
    table = rng.rand(32) < 0.45
    s0, s1 = guard + start, guard + start + cnt
    monkeypatch.setattr(JP, "_INTERPRET", True)
    ref, lt_ref = JP.partition_segment_planes_fused(
        jnp.asarray(work), jnp.int32(0), jnp.int32(s0), jnp.int32(cnt),
        jnp.int32(3), jnp.asarray(table), ch=ch)
    ref = np.asarray(ref)
    mine = work[:, :F + 12].copy()        # the port's W has no padding
    lt, _ = emulate_planes_kernel(mine, [0, s0, cnt, 3], table, cnt)
    assert lt == int(lt_ref)
    assert np.array_equal(mine[1, :, s0:s0 + lt], ref[1, :F + 12, s0:s0 + lt])
    assert sorted(map(bytes, mine[1, :, s0 + lt:s1].T)) == \
        sorted(map(bytes, ref[1, :F + 12, s0 + lt:s1].T))
    assert np.array_equal(mine[1, :, :s0], work[1, :F + 12, :s0])
    assert np.array_equal(mine[1, :, s1:], work[1, :F + 12, s1:])


def test_block_scratch_is_kept_and_grown():
    cpu = torch.device("cpu")
    P._BLOCK_SCRATCH.clear()
    a = P.block_scratch(cpu, 12345, 10)
    assert a.dtype == torch.int32 and a.numel() >= 10
    assert P.block_scratch(cpu, 12345, 264) is a
    assert P.block_scratch(cpu, 999, 10) is not a
    b = P.block_scratch(cpu, 12345, 5000)
    assert b.numel() >= 5000 and b is not a
    P._BLOCK_SCRATCH.clear()
