"""Launch sizing of the rows partition (K3 rows, ``csrc/partition_rows.cu``)
and the int8 histogram (K5, ``csrc/segment_histogram_q.cu``), on the CPU.

The kernels run only on the card; what decides their shape is Python
(``ops/partition.partition_rows_plan``, ``ops/histogram.hist_q_plan``) and
a little index arithmetic. Here:
- the plans: tile rows, slot and shared-memory sizes, the grid, the
  resident-versus-two-read switch, clusters and feature groups;
- the kernel's index arithmetic, emulated in numpy: the division of a run
  offset by W as a multiply-high by a per-W magic number, and the whole
  rows partition (block tile ranges, block prefixes, per-tile ballot
  ranks, runs written as aligned words with bytes at the ends) against
  the plain twin, byte for byte;
- the int8 histogram's kept accumulator.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import histogram as H
from lightgbm_tpu_torch.ops import partition as P

SMS = 132


def _magic(width):
    return 0xFFFFFFFF // width + 1


@pytest.mark.parametrize("width", [4, 8, 15, 21, 31, 40, 64, 255, 1000,
                                   P.PART_ROWS_MAX_WIDTH])
def test_rows_plan_tiles(width):
    plan = P.partition_rows_plan(1, width, SMS)
    assert 1 <= plan.steps <= 32 and plan.tile_rows == 32 * plan.steps
    if width * 32 * 32 <= P.PART_ROWS_TILE_BYTES:
        assert plan.steps == 32
    else:
        assert plan.tile_rows * width <= max(P.PART_ROWS_TILE_BYTES,
                                             32 * width)
    # a slot holds the tile's bytes from any start mod 16, in whole chunks
    chunks = -(-(15 + plan.tile_rows * width) // 16)
    assert plan.slot_bytes % 16 == 0 and plan.slot_bytes >= 16 * chunks
    assert plan.slot_bytes <= P.PART_ROWS_SMEM_BYTES
    # the multiply-high division is exact on every run offset of a tile
    k = np.arange(plan.tile_rows * width, dtype=np.uint64)
    got = (k * np.uint64(_magic(width))) >> np.uint64(32)
    assert np.array_equal(got, k // np.uint64(width))


@pytest.mark.parametrize("width", [3, P.PART_ROWS_MAX_WIDTH + 1])
def test_rows_plan_refuses_widths(width):
    with pytest.raises(ValueError, match="bytes"):
        P.partition_rows_plan(100, width, SMS)


@pytest.mark.parametrize("width", [31, 40, 21])
def test_rows_plan_resident_switch(width):
    """Resident exactly while every tile fits the grid's shared memory (one
    block per SM, PART_ROWS_SMEM_BYTES of slots); then two reads through
    two slots on PART_ROWS_BLOCKS_PER_SM blocks per SM."""
    one = P.partition_rows_plan(1, width, SMS)
    cap = P.PART_ROWS_SMEM_BYTES // one.slot_bytes
    limit = SMS * cap * one.tile_rows
    for cnt in (1, one.tile_rows - 1, one.tile_rows + 1, 65536, limit - 1,
                limit):
        plan = P.partition_rows_plan(cnt, width, SMS)
        tiles = -(-cnt // plan.tile_rows)
        per_sm = P.PART_ROWS_BLOCKS_PER_SM
        assert plan.resident and plan.grid <= SMS * per_sm
        # the blocks of one SM fit its shared memory together
        assert -(-plan.grid // SMS) * plan.slots * plan.slot_bytes \
            <= P.PART_ROWS_SMEM_BYTES
        assert plan.grid * plan.slots >= tiles
        assert (plan.grid - 1) * plan.slots < tiles       # no idle block
        if tiles <= SMS * per_sm:                # one tile a block
            assert plan.slots == 1 and plan.grid == tiles
    for cnt in (limit + 1, 2_000_000, 10_000_000):
        plan = P.partition_rows_plan(cnt, width, SMS)
        tiles = -(-cnt // plan.tile_rows)
        assert not plan.resident and plan.slots == 2
        assert plan.grid == min(tiles, SMS * P.PART_ROWS_BLOCKS_PER_SM)


@pytest.mark.parametrize("cnt_bound", [1, 1025, 200_000, 2_000_000])
def test_rows_plan_holds_any_smaller_count(cnt_bound):
    """The kernel decides residency from the true count on the card: with
    kb = ceil(tiles / grid) tiles per block, a resident plan stays resident
    (kb <= slots) for every count up to its bound."""
    plan = P.partition_rows_plan(cnt_bound, 31, SMS)
    for cnt in np.unique(np.linspace(0, cnt_bound, 50).astype(int)):
        tiles = -(-int(cnt) // plan.tile_rows)
        kb = -(-tiles // plan.grid)
        assert kb * plan.grid >= tiles
        if plan.resident:
            assert kb <= plan.slots


def emulate_rows_kernel(work, seg, table, cnt_bound, sms=SMS, grid=None):
    """numpy emulation of partition_rows_kernel on a (2, npad, W) u8 pair:
    block tile ranges, the block prefix, each tile's ballot ranks and its
    two runs written as aligned 4-byte words (bytes at the ends), byte k
    of a run from row src[k // W] with k // W as a multiply-high."""
    src, start, cnt, feat = (int(v) for v in seg)
    width = work.shape[2]
    plan = P.partition_rows_plan(cnt_bound, width, sms)
    G = grid or plan.grid
    T = plan.tile_rows
    magic = np.uint64(_magic(width))
    tbl = np.zeros(256, np.uint8)
    tbl[:len(table)] = table
    flat_src = work[src].reshape(-1)
    dst = work[1 - src].reshape(-1)
    nt = -(-cnt // T)
    kb = -(-nt // G)
    ranges = [(min(b * kb, nt), min(b * kb + kb, nt)) for b in range(G)]

    def rows_of(t):
        n = min(T, cnt - t * T)
        base = (start + t * T) * width
        return flat_src[base:base + n * width].reshape(n, width)

    left = [sum(int(tbl[rows_of(t)[:, feat]].sum()) for t in range(*r))
            for r in ranges]
    total = sum(left)
    for b, (t0, t1) in enumerate(ranges):
        before = sum(left[:b])
        left_at, right_at = start + before, start + total + t0 * T - before
        for t in range(t0, t1):
            rows = rows_of(t)
            n = rows.shape[0]
            go = tbl[rows[:, feat]].astype(bool)
            steps = -(-n // 32)
            masks = [go[s * 32:s * 32 + 32] for s in range(steps)]
            lpre = np.concatenate([[0], np.cumsum([m.sum() for m in masks])])
            nl = int(lpre[-1])
            order = np.empty(n, np.int64)
            for i in range(n):
                s, lane = divmod(i, 32)
                lb = int(lpre[s] + masks[s][:lane].sum())
                order[lb if go[i] else nl + (i - lb)] = i
            flat_rows = rows.reshape(-1)
            for at, idx in ((left_at, order[:nl]), (right_at, order[nl:])):
                length = len(idx) * width
                d = at * width
                head = min(length, (4 - d % 4) % 4)
                k = np.arange(length, dtype=np.uint64)
                r = ((k * magic) >> np.uint64(32)).astype(np.int64)
                w = k.astype(np.int64) - r * width
                run = flat_rows[idx[r] * width + w]
                words = (length - head) // 4
                dst[d:d + head] = run[:head]
                body = run[head:head + 4 * words].reshape(-1, 4) \
                    .astype(np.uint32)
                dst[d + head:d + head + 4 * words] = (
                    body[:, 0] | body[:, 1] << 8 | body[:, 2] << 16
                    | body[:, 3] << 24).view(np.uint8)
                dst[d + head + 4 * words:d + length] = \
                    run[head + 4 * words:]
            left_at += nl
            right_at += n - nl
    return total


@pytest.mark.parametrize("F,quantized,start,cnt,grid", [
    (28, True, 141, 3000, None), (28, False, 128, 1025, None),
    (9, False, 133, 2500, 2), (12, True, 130, 31, None),
    (61, True, 128, 1100, 3), (28, True, 139, 0, None),
    (28, True, 129, 1023, 1), (200, False, 131, 700, None)])
def test_rows_kernel_emulation_matches_twin(F, quantized, start, cnt, grid):
    rng = np.random.RandomState(F + cnt)
    width = F + (P.GH_BYTES_Q if quantized else P.GH_BYTES)
    npad = P.planes_npad(start + cnt + 8)
    work = rng.randint(0, 256, (2, npad, width)).astype(np.uint8)
    table = rng.rand(256) < 0.4
    seg = [0, start, cnt, F // 2]
    want = torch.as_tensor(work.copy())
    lt = P.partition_segment_rows_plain(
        want, torch.tensor(seg, dtype=torch.int32), torch.as_tensor(table))
    got = work.copy()
    total = emulate_rows_kernel(got, seg, table, max(cnt, 1), grid=grid)
    assert total == int(lt)
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("F,B", [(28, 256), (5, 64), (61, 64), (100, 256),
                                 (200, 256), (1000, 64)])
def test_hist_q_plan_shapes(F, B):
    for cnt in (0, 1, 511, 513, 4097, 16_385, 28_458, 2_000_000):
        plan = H.hist_q_plan(cnt, F, B)
        assert plan.groups == -(-F // plan.feats_per_block)
        assert plan.smem_bytes <= H.HIST_Q_SMEM_BYTES
        width = F + 3
        ring = H.HIST_Q_WARPS * H.HIST_Q_RING * ((32 * width + 31) // 16 * 16)
        assert plan.staged == (ring <= H.HIST_Q_SMEM_BYTES // 2)
        assert plan.smem_bytes == (
            (plan.feats_per_block * B * 12 + 15) // 16 * 16
            + (ring if plan.staged else 0))
        assert 1 <= plan.cluster <= H.HIST_Q_CLUSTER
        assert plan.cluster & (plan.cluster - 1) == 0
        assert plan.row_blocks % plan.cluster == 0
        assert plan.acc_ints == F * B * 3
        want = max(1, -(-cnt // H.HIST_Q_ROWS_PER_BLOCK))
        if want <= H.HIST_Q_CLUSTER:
            assert plan.row_blocks == plan.cluster >= want
        else:
            assert plan.cluster == H.HIST_Q_CLUSTER
            assert plan.row_blocks * plan.groups <= max(
                H.HIST_Q_MAX_ROW_BLOCKS, H.HIST_Q_CLUSTER * plan.groups)


def test_hist_q_plan_spreads_mid_segments():
    """A ~16k-row parent (a deep leaf's) spreads over 32 row blocks in
    clusters of 8, a ~64k-row one over the whole wave of 128 (one block per
    SM), as the 2M-row root; tiny segments take one short cluster."""
    assert H.hist_q_plan(16384, 28, 256)[2:4] == (32, 8)
    assert H.hist_q_plan(65536, 28, 256)[2:4] == (128, 8)
    assert H.hist_q_plan(2_000_000, 28, 256)[2:4] == (128, 8)
    assert H.hist_q_plan(1500, 28, 256)[2:4] == (4, 4)
    assert H.hist_q_plan(100, 28, 256)[2:4] == (1, 1)
    assert H.hist_q_plan(2_000_000, 28, 256).feats_per_block == 28


def test_hist_q_scratch_is_kept_and_grown():
    dev = torch.device("cpu")
    acc, ticket = H._hist_q_scratch(dev, 12345, 100)
    assert acc.dtype == torch.int32 and acc.numel() == 100
    assert not acc.any() and not ticket.any()
    again, t2 = H._hist_q_scratch(dev, 12345, 50)
    assert again is acc and t2 is ticket
    other = H._hist_q_scratch(dev, 999, 50)[0]
    assert other is not acc
    bigger = H._hist_q_scratch(dev, 12345, 200)[0]
    assert bigger.numel() == 200 and not bigger.any()
    H._HIST_Q_SCRATCH.clear()
