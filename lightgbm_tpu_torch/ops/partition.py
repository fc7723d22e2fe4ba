"""Leaf-contiguous row partition on the planes and rows work layouts
(PyTorch port of ``lightgbm_tpu/ops/partition.py``).

Rows are kept physically grouped by leaf in a ping-pong pair of buffers,
in one of two layouts of the same packed bytes:

- **planes**, ``work`` of shape ``(2, W, Npad)`` u8:
  ``work[p][w, guard + i]`` = byte w of row i;
- **rows**, ``work`` of shape ``(2, Npad, W)`` u8:
  ``work[p][guard + i, w]`` = byte w of row i.

A row is F bin bytes (bundle columns), then g, h, cnt as little-endian f32
(12 bytes, ``W = F + 12``), or, when quantized, int8 g, int8 h and u8 cnt
(3 bytes, ``W = F + 3``). A leaf's rows are one contiguous range
``[start, start + cnt)`` of one buffer, and a split writes the parent's
segment into the other buffer, left child first. The layouts are the JAX
package's, byte for byte, except that W is not padded: the TPU kernels pad
W to 32 sublanes (planes) or 128 lanes (rows), a DMA tiling that buys
nothing on a GPU.

:func:`partition_segment` (planes) and :func:`partition_segment_rows` are
the split. On a CUDA tensor they launch the hand-written kernel
``csrc/partition_segment.cu`` (entry point ``partition_segment``,
replacing the TPU kernel ``partition_segment_planes_fused``) and
``csrc/partition_rows.cu`` (entry point ``partition_segment_rows``, one
cooperative launch, replacing ``partition_segment_fused``); on a CPU
tensor they run their plain twins. The order is fixed and stable on
both sides (the TPU kernels leave it unspecified): left rows ascending
from ``start``, right rows ascending from ``start + lt``, so a kernel and
its twin agree byte for byte, and both layouts hold the same rows in the
same order.

Segment arguments ride in a small device i32 tensor, so the learner never
waits for the card to issue a launch; ``cnt_bound`` (a host int at least
the segment's row count) only sizes the grid (:func:`partition_rows_plan`
on the rows layout). The device tree loop's three-launch chain
(``ops/chain.py``) launches the same kernels on a split's device header
instead, with plans taken once for the root (:class:`SegmentPartition`,
:class:`RouteGather`; the segment modes ``SEG_*``); their twins work on
whole planes under masks and read nothing back to the host.

:func:`one_kernel_split_planes` runs a whole split in one launch: the
partition, the smaller child's histogram and both children's split scan
(``csrc/one_kernel_split.cu``, replacing the TPU kernel
``one_kernel_split_planes`` in its planes and resident modes). The kernel
reads the split's scalars from a device header (ONE_KERNEL_HDR) and
writes into the caller's buffers (:class:`SplitOut`), so a tree's splits
can be queued with no read back to the host
(:meth:`OneKernelSplit.split`); its plain twin
:func:`one_kernel_split_header_plain` computes, from the same header, what
the three-launch chain :func:`one_kernel_split_planes_plain` computes.

The **resident** layout (the JAX package's ``tpu_resident_state=on``)
keeps the bins once, in original row order, in the ``(F, Npad)`` resident
planes (:func:`resident_bin_planes`; the learner's are the row router's
block form of the binned matrix, so they cost no second copy). The work
pair is slim, ``(2, RST_WIDTH, Npad)``: per row a route byte, the row's
index into the resident planes (``ridx``, 4 little-endian byte planes)
and the 12 g/h/cnt bytes. Before each partition :func:`write_route_plane`
gathers the split column's bin of every segment row into the route plane
(``csrc/resident_route.cu``), and the unchanged planes partition routes
on plane 0. The port's ``ridx`` is the original row index ``i`` (the JAX
package stores ``guard + i``); the resident planes have no guard lanes.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch

from .kernels import CudaKernel, register, stream_of

GH_BYTES = 12      # g, h, cnt as f32 bytes
GH_BYTES_Q = 3     # quantized: int8 g, int8 h, u8 cnt
#: the slim work rows of the resident layout: plane 0 the route byte,
#: planes 1..4 the row index (little-endian bytes), planes 5..16 g/h/cnt
RST_ROUTE = 1
RST_RIDX = 4
RST_GH_OFF = RST_ROUTE + RST_RIDX
RST_WIDTH = RST_GH_OFF + GH_BYTES
#: rows of padding below and above the rows (row i sits at GUARD + i)
GUARD = 128
#: rows per tile of the one-kernel split's partition phase (its count and
#: scatter tile, csrc/segment_partition.cuh)
PART_TILE = 4096
#: the planes partition (csrc/partition_segment.cu): the bytes a tile of
#: all W planes aims at (its rows are 32 * steps, steps <= 32), the bytes
#: past its rows of each plane's stripe in shared memory, the dynamic
#: shared memory an SM's blocks may hold in tile slots (two blocks of 512
#: threads and their static shared memory fit beside it), and the most
#: blocks an SM runs
PART_PLANES_TILE_BYTES = 32 * 1024
PART_PLANES_STRIPE_PAD = 16
PART_PLANES_SMEM_BYTES = 216 * 1024
PART_PLANES_BLOCKS_PER_SM = 2
#: the ring bytes an SM's blocks aim at when streaming (two reads): on
#: the card ~100 KB of slots an SM streamed fastest at W = 40 (one block
#: of three 32 KB slots) and at W = 17 (two blocks of three 17 KB slots)
PART_PLANES_STREAM_BYTES = 112 * 1024
#: the rows partition (csrc/partition_rows.cu): bytes of rows a tile aims
#: at (its rows are 32 * steps, steps <= 32), the dynamic shared memory a
#: block may hold in tile slots, the blocks per SM its streaming (two-read)
#: grid asks for, and the widest row it takes (one 32-row tile per slot,
#: and the magic-number division exact: 32 W^2 < 2^32)
PART_ROWS_TILE_BYTES = 32 * 1024
PART_ROWS_SMEM_BYTES = 224 * 1024
PART_ROWS_BLOCKS_PER_SM = 2
PART_ROWS_MAX_WIDTH = (PART_ROWS_SMEM_BYTES - 32) // 32

_P = ctypes.c_void_p
_I = ctypes.c_int
PARTITION_KERNEL = register(CudaKernel(
    "partition_segment", "partition_segment.cu",
    [_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P]))
PARTITION_ROWS_KERNEL = register(CudaKernel(
    "partition_segment_rows", "partition_rows.cu",
    [_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P]))
#: phase C follows torch's arithmetic op by op: no contracted multiply-adds
ONE_KERNEL = register(CudaKernel(
    "one_kernel_split", "one_kernel_split.cu", [_P, _P],
    flags=("-fmad=false",)))
ONE_KERNEL_RESIDENT = register(CudaKernel(
    "one_kernel_split_resident", "one_kernel_split.cu", [_P, _P],
    flags=("-fmad=false",)))
ROUTE_KERNEL = register(CudaKernel(
    "write_route_plane", "resident_route.cu", [_P, _I, _I, _P, _I, _P, _I,
                                               _I, _P]))
#: 4-row words of a route-gather block per pass: 64 threads, one word each
ROUTE_WORDS_PER_BLOCK = 64
#: the route gather's blocks per SM on a static plan (the device tree
#: loop's, sized for the root; the blocks stride over the segment's words)
ROUTE_STATIC_BLOCKS_PER_SM = 16

#: what a partition, histogram or route-gather launch reads as its segment
#: (csrc/segment_arg.cuh): the small segment array of the per-split host
#: loop, or a split's device header (ONE_KERNEL_HDR) -- its parent segment,
#: the same routed on the route plane (resident), or with the left count
#: the smaller child's segment. A header whose live word is 0 is a no-op.
SEG_PLAIN, SEG_PARENT, SEG_ROUTE, SEG_SMALLER = 0, 1, 2, 3


def work_spec(num_groups: int, quantized: bool = False,
              layout: str = "planes") -> Tuple[int, int]:
    """(guard rows, packed row width W) of the work buffer; W is the
    plane count of the planes and resident layouts (the resident one
    carries the slim payload, RST_WIDTH planes) and the row width of the
    rows layout."""
    if layout == "resident":
        return GUARD, RST_WIDTH
    return GUARD, num_groups + (GH_BYTES_Q if quantized else GH_BYTES)


def dither_offset(num_groups: int, part_chunk: int = 0,
                  hist_chunk: int = 0) -> int:
    """Row offset of the JAX package's quantization dither.

    The JAX rows builder draws ``uniform(key, (N + 2 * guard, 2))`` over
    its guard-padded buffer, so row i's two draws sit at flat index
    ``(guard + i) * 2 + c``, with ``guard = max(part_chunk, hist_chunk)``
    as its knob resolution gives them off the TPU (the XLA partition: part
    chunk 2048, hist chunk 4096 for at most 64 columns, else 1024; an
    explicit ``tpu_part_chunk`` / ``tpu_hist_chunk`` wins). The port
    allocates no such padding; it draws each row's bits at that offset.
    """
    pc = part_chunk if part_chunk > 0 else 2048
    hc = hist_chunk if hist_chunk > 0 else (4096 if num_groups <= 64
                                            else 1024)
    return max(pc, hc)


def goss_compact_rows(n: int, top_rate: float, other_rate: float) -> int:
    """The compact row count M of GOSS compaction (the JAX package's
    ``goss_compact_rows``): the ``top_k`` rows GOSS always keeps plus the
    expected sample of the rest, with a 4-sigma margin and 32 rows of
    slack, at most ``n``. The JAX package grows a compacted tree over a
    static M-row prefix; here it is the rows a compacted tree is expected
    to scan at most (``traffic_spec``), and ``M = n`` leaves nothing to
    compact."""
    top_k = max(1, int(n * top_rate))
    rest = max(0, n - top_k)
    p = min(1.0, other_rate / max(1e-12, 1.0 - top_rate))
    slack = 4.0 * math.sqrt(rest * p * (1.0 - p)) + 32.0
    return min(n, top_k + int(math.ceil(rest * p + slack)))


def inbag_order(ghc: torch.Tensor):
    """The rows in GOSS compaction's order: the in-bag rows (``ghc[:, 2] >
    0``) first in their order, then the out-of-bag rows in theirs (the
    order of the JAX package's ``compact_rows_by_inbag``) -> ``(order,
    c)``: the (N,) i64 row of each position and the (1,) i64 in-bag count
    ``c``, both on the device. A stable split by prefix sums; nothing is
    read back to the host, so a CUDA graph holds it."""
    n = ghc.shape[0]
    dev = ghc.device
    inbag = ghc[:, 2] > 0
    cin = torch.cumsum(inbag.to(torch.int64), dim=0)
    c = cin[n - 1:]
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    pos = torch.where(inbag, cin - 1, c + (iota - cin))
    return torch.empty_like(iota).scatter_(0, pos, iota), c


def planes_npad(n: int, guard: int = GUARD) -> int:
    """Lane count of the work buffer: rows plus both guards, in whole
    128-lane tiles."""
    return 128 * ((n + 2 * guard + 127) // 128)


def work_buffer(n: int, num_groups: int, layout: str, quantized: bool,
                device) -> torch.Tensor:
    """A zeroed ping-pong work pair for ``n`` rows: (2, W, Npad) on the
    planes layout, (2, RST_WIDTH, Npad) on the resident layout,
    (2, Npad, W) on the rows layout."""
    guard, width = work_spec(num_groups, quantized, layout)
    npad = planes_npad(n, guard)
    shape = (2, npad, width) if layout == "rows" else (2, width, npad)
    return torch.zeros(shape, dtype=torch.uint8, device=device)


def pack_planes(bins: torch.Tensor, ghc: torch.Tensor) -> torch.Tensor:
    """(N, F) u8 + (N, 3) f32 -> (F + 12, N) u8 plane-major columns."""
    gb = ghc.to(torch.float32).contiguous().view(torch.uint8) \
        .reshape(ghc.shape[0], GH_BYTES)
    return torch.cat([bins, gb], dim=1).t()


def unpack_ghc_planes(planes: torch.Tensor, num_feat: int) -> torch.Tensor:
    """(F + 12, C) u8 planes -> (3, C) f32 channels."""
    gb = planes[num_feat:num_feat + GH_BYTES]
    if gb.shape[1] == 0:     # an empty tensor's strides refuse the view
        return torch.zeros((3, 0), dtype=torch.float32, device=gb.device)
    return gb.t().contiguous().view(torch.float32).t()


def pack_rows(bins: torch.Tensor, ghc: torch.Tensor) -> torch.Tensor:
    """(N, F) u8 + (N, 3) f32 -> (N, F + 12) u8 packed rows."""
    gb = ghc.to(torch.float32).contiguous().view(torch.uint8) \
        .reshape(ghc.shape[0], GH_BYTES)
    return torch.cat([bins, gb], dim=1)


def unpack_ghc(rows: torch.Tensor, num_feat: int) -> torch.Tensor:
    """(N, F + 12) u8 packed rows -> (N, 3) f32 channels."""
    gb = rows[:, num_feat:num_feat + GH_BYTES]
    if gb.shape[0] == 0:
        return torch.zeros((0, 3), dtype=torch.float32, device=gb.device)
    # a copy: a slice of one row is contiguous at any byte offset, and the
    # f32 view needs a 4-byte aligned one
    return gb.clone(memory_format=torch.contiguous_format).view(torch.float32)


def quantize_scales(ghc: torch.Tensor) -> torch.Tensor:
    """(2,) f32 ``[gscale, hscale]``: ``127 / (max |x| + 1e-12)`` per
    channel, the JAX builder's per-tree local scales (f32 throughout)."""
    mx = torch.amax(torch.abs(ghc[:, :2].to(torch.float32)), dim=0) + 1e-12
    # a true division: ``127.0 / mx`` is a reciprocal times 127 in torch,
    # which rounds twice
    return torch.div(torch.full_like(mx, 127.0), mx)


def pack_rows_quantized(bins: torch.Tensor, ghc: torch.Tensor, key,
                        scales: torch.Tensor, *,
                        offset: int = 0) -> torch.Tensor:
    """(N, F) u8 + (N, 3) f32 -> (N, F + 3) u8 with int8 gradients:
    ``clip(floor(x * scale + u), -127, 127)`` with u ~ U[0, 1) from
    ``uniform(key, (offset + N, 2))[offset:]`` (stochastic rounding, the
    JAX package's ``pack_rows_quantized`` over its guard-padded buffer,
    ``offset`` = :func:`dither_offset`), then the u8 count."""
    from ..prng import uniform

    n = ghc.shape[0]
    u = uniform(key, (n, 2), device=ghc.device, start=2 * offset)
    q = torch.floor(ghc[:, :2].to(torch.float32) * scales + u) \
        .clamp(-127.0, 127.0).to(torch.int8).view(torch.uint8)
    cnt = ghc[:, 2:3].to(torch.uint8)
    return torch.cat([bins, q, cnt], dim=1)


def unpack_ghq(rows: torch.Tensor, num_feat: int):
    """(N, F + 3) u8 packed rows -> int8 g, int8 h, u8 cnt columns."""
    return (rows[:, num_feat].view(torch.int8),
            rows[:, num_feat + 1].view(torch.int8), rows[:, num_feat + 2])


def root_segment(guard: int, n: int, device) -> torch.Tensor:
    """The (3,) i32 device segment ``[0, guard, n]`` of a tree's root (all
    rows in plane 0). A caller that replays the root from a CUDA graph
    makes it once, before capture: building it copies host ints to the
    card."""
    return torch.tensor([0, guard, n], dtype=torch.int32, device=device)


def pack_planes_fold_root(work: torch.Tensor, bins: torch.Tensor,
                          ghc: torch.Tensor, guard: int, *, num_bins: int,
                          exact: bool, seg=None) -> torch.Tensor:
    """Write rows into plane 0 of ``work`` (in place) and return the root
    histogram: one segment-histogram launch over all rows (``seg``, the
    :func:`root_segment`, made here when None). The TPU folds the
    histogram into the pack pass to save a DMA read; here the pack is a
    torch copy and the histogram its own kernel. On host tensors the
    twin sums the rows the host already knows (no read of ``seg``)."""
    from .histogram import _histogram_plain, segment_histogram

    n, g = bins.shape
    work[0, :, guard:guard + n] = pack_planes(bins, ghc)
    if work.device.type == "cpu":
        cols = work[0, :, guard:guard + n]
        return _histogram_plain(cols[:g], unpack_ghc_planes(cols, g),
                                num_bins=num_bins, exact=exact)
    if seg is None:
        seg = root_segment(guard, n, work.device)
    return segment_histogram(work, seg, num_bins=num_bins, num_feat=g,
                             exact=exact, cnt_bound=n)


def pack_rows_fold_root(work: torch.Tensor, bins: torch.Tensor,
                        ghc: torch.Tensor, guard: int, *, num_bins: int,
                        exact: bool = True, seg=None, key=None, scales=None,
                        scale=None, offset: int = 0) -> torch.Tensor:
    """Write rows into buffer 0 of the rows pair ``work`` (in place) and
    return the root histogram, as :func:`pack_planes_fold_root` does for
    planes: f32 rows (:func:`pack_rows`) and the rows histogram, or, given
    the dither ``key`` (a ``prng`` key or its (2,) int64 device words), the
    per-tree ``scales`` and the (3,) dequantization ``scale``, int8 rows
    (:func:`pack_rows_quantized` at row ``offset``) and the int8
    histogram. On host tensors the twin sums the rows the host already
    knows (no read of ``seg``)."""
    from .histogram import (_histogram_plain, histogram_q_rows_plain,
                            segment_histogram_q, segment_histogram_rows)

    n, g = bins.shape
    quantized = key is not None
    if quantized:
        work[0, guard:guard + n] = pack_rows_quantized(bins, ghc, key, scales,
                                                       offset=offset)
    else:
        work[0, guard:guard + n] = pack_rows(bins, ghc)
    if work.device.type == "cpu":
        rows = work[0, guard:guard + n]
        if quantized:
            return histogram_q_rows_plain(rows, scale, num_bins=num_bins,
                                          num_feat=g)
        return _histogram_plain(rows[:, :g].t(), unpack_ghc(rows, g).t(),
                                num_bins=num_bins, exact=exact)
    if seg is None:
        seg = root_segment(guard, n, work.device)
    if quantized:
        return segment_histogram_q(work, seg, scale, num_bins=num_bins,
                                   num_feat=g, cnt_bound=n)
    return segment_histogram_rows(work, seg, num_bins=num_bins, num_feat=g,
                                  exact=exact, cnt_bound=n)


def partition_segment_plain(work: torch.Tensor, seg: torch.Tensor,
                            table: torch.Tensor) -> torch.Tensor:
    """Plain torch twin: the segment's columns of plane ``src`` written to
    plane ``1 - src`` as ``cat(seg[:, go], seg[:, ~go])``. Returns ``lt``,
    the left count, as a (1,) i32 tensor on ``work``'s device."""
    src, start, cnt, feat = (int(v) for v in seg.tolist())
    cols = work[src, :, start:start + cnt]
    go = table[cols[feat].long()]
    work[1 - src, :, start:start + cnt] = torch.cat(
        [cols[:, go], cols[:, ~go]], dim=1)
    return go.sum().to(torch.int32).reshape(1)


def partition_segment(work: torch.Tensor, seg: torch.Tensor,
                      table: torch.Tensor, cnt_bound: int) -> torch.Tensor:
    """Stably partition lanes ``[start, start + cnt)`` of plane ``src`` of
    ``work`` (2, W, Npad) u8 into plane ``1 - src`` by the routing table.

    ``seg`` is a (4,) i32 tensor ``[src, start, cnt, feat]`` on ``work``'s
    device, ``table`` the (B,) bool routing table over the split column's
    bin codes, ``cnt_bound`` a host int >= cnt. The
    destination plane is written in place; lanes outside the segment stay
    untouched. Returns ``lt``, the left count, as a (1,) i32 device tensor.
    On the card: one cooperative launch sized by
    :func:`partition_planes_plan`.
    """
    _check_partition_args("partition_segment", work, seg, table)
    if work.device.type == "cpu":
        return partition_segment_plain(work, seg, table)
    check_on_card("partition_segment", work, seg, table)
    plan = partition_planes_plan(int(cnt_bound), work.shape[1],
                                 sm_count(work.device.index))
    lt = torch.empty(1, dtype=torch.int32, device=work.device)
    PARTITION_KERNEL.launch(
        work.data_ptr(), work.shape[1], work.shape[2], seg.data_ptr(),
        table.data_ptr(), table.numel(), plan.steps, plan.group, plan.slots,
        plan.grid, SEG_PLAIN,
        block_scratch(work.device, stream_of(work), plan.grid).data_ptr(),
        lt.data_ptr(), stream_of(work))
    return lt


class PartPlanesPlan(NamedTuple):
    """The launch of one planes partition (csrc/partition_segment.cu)."""
    steps: int        # 32-row steps per tile
    tile_rows: int    # 32 * steps
    stripe: int       # shared memory of one plane of a tile
    group: int        # planes a slot holds (W unless the tile is too wide)
    slot_bytes: int   # group * stripe
    slots: int        # slots per block
    grid: int         # blocks asked for (the card may run fewer at once)
    resident: bool    # every tile stays staged across the grid barrier


@functools.lru_cache(maxsize=4096)
def partition_planes_plan(cnt_bound: int, width: int,
                          sms: int) -> PartPlanesPlan:
    """Size a planes partition of up to ``cnt_bound`` rows of ``width``
    planes on a card of ``sms`` SMs. A tile is at most
    PART_PLANES_TILE_BYTES of rows over all planes, and no more rows than
    spread the segment over every SM (a deep leaf's few thousand rows take
    as many blocks as a 2M-row root's). When the grid's shared memory
    (PART_PLANES_SMEM_BYTES an SM) holds every tile with all its planes,
    the plan is resident: each block keeps its ``slots`` tiles staged
    across the grid barrier and the segment is read once;
    PART_PLANES_BLOCKS_PER_SM blocks share an SM while their slots fit,
    else one block takes it. Otherwise the kernel reads the split column
    for the count and then the tiles, a group of planes at a time (every
    plane unless a tile is too wide), through a ring of two or three
    slots, on as many blocks per SM (at most PART_PLANES_BLOCKS_PER_SM)
    as keep an SM's rings near PART_PLANES_STREAM_BYTES."""
    if width < 1:
        raise ValueError("partition_segment: %d planes" % width)
    cnt_bound = max(1, int(cnt_bound))
    most = max(1, min(32, PART_PLANES_TILE_BYTES // (32 * width)))
    steps = max(1, min(most, -(-cnt_bound // (32 * sms))))
    rows = 32 * steps
    stripe = rows + PART_PLANES_STRIPE_PAD
    per_sm = PART_PLANES_BLOCKS_PER_SM
    group = min(width, PART_PLANES_SMEM_BYTES // (2 * per_sm) // stripe)
    tiles = -(-cnt_bound // rows)
    if group == width and tiles <= sms * (PART_PLANES_SMEM_BYTES
                                          // (stripe * width)):
        slot = stripe * width
        slots = -(-tiles // (sms * per_sm))
        if slots * slot > PART_PLANES_SMEM_BYTES // per_sm:
            slots = -(-tiles // sms)
        return PartPlanesPlan(steps, rows, stripe, width, slot, slots,
                              -(-tiles // slots), True)
    slot = stripe * group
    slots = min(3, PART_PLANES_SMEM_BYTES // per_sm // slot)
    blocks = max(1, min(per_sm, PART_PLANES_STREAM_BYTES // (slots * slot)))
    return PartPlanesPlan(steps, rows, stripe, group, slot, slots,
                          min(tiles, sms * blocks), False)


#: per (device, stream): the cooperative partitions' per-block left counts
#: (written and read inside one launch, so launches on one stream share it)
_BLOCK_SCRATCH: dict = {}


def block_scratch(device: torch.device, stream: int,
                  n: int) -> torch.Tensor:
    """At least ``n`` i32 of scratch on ``device``, kept per (device,
    stream) and grown as needed."""
    buf = _BLOCK_SCRATCH.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.empty(max(n, 1024), dtype=torch.int32, device=device)
        _BLOCK_SCRATCH[(device, stream)] = buf
    return buf


def _check_partition_args(name: str, work: torch.Tensor, seg: torch.Tensor,
                          table: torch.Tensor) -> None:
    if work.dim() != 3 or work.shape[0] != 2 or work.dtype != torch.uint8:
        raise ValueError("%s: work must be a (2, ., .) u8 pair, got %s %s"
                         % (name, tuple(work.shape), work.dtype))
    if seg.dtype != torch.int32 or seg.numel() != 4:
        raise ValueError("%s: seg must be 4 int32" % name)
    if table.dtype != torch.bool or table.dim() != 1 \
            or not 0 < table.numel() <= 256:
        raise ValueError("%s: table must be (B,) bool with B <= 256" % name)


def check_on_card(name: str, work: torch.Tensor, *tensors) -> None:
    """Raise unless ``work`` is a CUDA tensor and ``tensors`` lie on its
    device; all of them must be contiguous (the kernels take raw
    pointers)."""
    if work.device.type != "cuda":
        raise RuntimeError("%s: no kernel for device %s" % (name, work.device))
    for t in tensors:
        if t.device != work.device:
            raise ValueError("%s: an input is on %s, work on %s"
                             % (name, t.device, work.device))
    if not all(t.is_contiguous() for t in (work,) + tensors):
        raise ValueError("%s: inputs must be contiguous" % name)


def partition_segment_rows_plain(work: torch.Tensor, seg: torch.Tensor,
                                 table: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of the rows layout: the segment's rows of buffer
    ``src`` written to buffer ``1 - src`` as ``cat(rows[go], rows[~go])``.
    Returns ``lt`` as a (1,) i32 tensor on ``work``'s device."""
    src, start, cnt, feat = (int(v) for v in seg.tolist())
    rows = work[src, start:start + cnt]
    go = table[rows[:, feat].long()]
    work[1 - src, start:start + cnt] = torch.cat([rows[go], rows[~go]])
    return go.sum().to(torch.int32).reshape(1)


class PartRowsPlan(NamedTuple):
    """The launch of one rows partition (csrc/partition_rows.cu)."""
    steps: int        # 32-row steps per tile
    tile_rows: int    # 32 * steps
    slot_bytes: int   # shared memory of one tile slot
    slots: int        # tile slots per block
    grid: int         # blocks asked for (the card may run fewer at once)
    resident: bool    # every tile stays staged across the grid barrier


def partition_rows_plan(cnt_bound: int, width: int,
                        sms: int) -> PartRowsPlan:
    """Size a rows partition of up to ``cnt_bound`` rows of ``width``
    bytes on a card of ``sms`` SMs. A tile is about PART_ROWS_TILE_BYTES
    of rows. When the grid's shared memory holds every tile (at most
    PART_ROWS_SMEM_BYTES an SM), the plan is resident: each block gets
    ``slots`` tiles and keeps them staged across the grid barrier, so the
    segment is read once; PART_ROWS_BLOCKS_PER_SM blocks share an SM while
    their slots fit, else one block takes it. Otherwise the kernel reads
    the segment twice (the split column for the count, then the rows),
    through two slots, on PART_ROWS_BLOCKS_PER_SM blocks per SM."""
    if not 4 <= width <= PART_ROWS_MAX_WIDTH:
        raise ValueError("partition_segment_rows: rows of %d bytes (the "
                         "kernel takes 4 to %d)"
                         % (width, PART_ROWS_MAX_WIDTH))
    steps = max(1, min(32, PART_ROWS_TILE_BYTES // (32 * width)))
    rows = 32 * steps
    slot = (rows * width + 31) // 16 * 16
    tiles = max(1, -(-int(cnt_bound) // rows))
    cap = PART_ROWS_SMEM_BYTES // slot
    if tiles <= sms * cap:
        # PART_ROWS_BLOCKS_PER_SM blocks per SM while their slots fit,
        # else one block per SM with up to all of its shared memory
        per_sm = PART_ROWS_BLOCKS_PER_SM
        slots = -(-tiles // (sms * per_sm))
        if slots * slot > PART_ROWS_SMEM_BYTES // per_sm:
            slots = -(-tiles // sms)
        return PartRowsPlan(steps, rows, slot, slots, -(-tiles // slots),
                            True)
    return PartRowsPlan(steps, rows, slot, min(2, cap),
                        min(tiles, sms * PART_ROWS_BLOCKS_PER_SM), False)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def partition_segment_rows(work: torch.Tensor, seg: torch.Tensor,
                           table: torch.Tensor,
                           cnt_bound: int) -> torch.Tensor:
    """Stably partition rows ``[start, start + cnt)`` of buffer ``src`` of
    ``work`` (2, Npad, W) u8 into buffer ``1 - src`` by the routing table;
    the arguments and the result are :func:`partition_segment`'s. On the
    card: one cooperative launch sized by :func:`partition_rows_plan`."""
    _check_partition_args("partition_segment_rows", work, seg, table)
    if work.device.type == "cpu":
        return partition_segment_rows_plain(work, seg, table)
    check_on_card("partition_segment_rows", work, seg, table)
    plan = partition_rows_plan(cnt_bound, work.shape[2],
                               sm_count(work.device.index))
    lt = torch.empty(1, dtype=torch.int32, device=work.device)
    PARTITION_ROWS_KERNEL.launch(
        work.data_ptr(), work.shape[2], work.shape[1], seg.data_ptr(),
        table.data_ptr(), table.numel(), plan.steps, plan.slots, plan.grid,
        SEG_PLAIN,
        block_scratch(work.device, stream_of(work), plan.grid).data_ptr(),
        lt.data_ptr(), stream_of(work))
    return lt


# ------------------------------------------------------------ resident layout

def resident_bin_planes(bins: torch.Tensor) -> torch.Tensor:
    """(N, F) u8 bins -> (F, Npad) u8 resident planes: row i at lane i,
    zero-padded to whole 128-lane tiles (the JAX package's with no guard
    lanes). Written once per dataset and never partitioned; the learner's
    are the row router's block form (``learner.route_layout``)."""
    n, f = bins.shape
    res = torch.zeros((f, 128 * ((n + 127) // 128)), dtype=bins.dtype,
                      device=bins.device)
    res[:, :n] = bins.t()
    return res


def decode_ridx(planes: torch.Tensor, npad: int) -> torch.Tensor:
    """(4, C) u8 little-endian byte planes -> (C,) i64 row indices,
    clamped to ``[0, npad)``. Lanes outside a live segment hold stale bytes
    that can decode to anything (a top byte >= 128 decodes negative, as an
    i32 does); the clamp keeps a gather in bounds, as the JAX package's
    ``_decode_ridx`` does."""
    b = planes.to(torch.int64)
    r = b[0] + b[1] * 256 + b[2] * 65536 + b[3] * 16777216
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r)
    return r.clamp(0, npad - 1)


def encode_ridx(pos: torch.Tensor) -> torch.Tensor:
    """(C,) integer row indices -> (4, C) u8 little-endian byte planes."""
    sh = torch.arange(RST_RIDX, dtype=torch.int64, device=pos.device) * 8
    return ((pos.to(torch.int64)[None, :] >> sh[:, None]) & 255) \
        .to(torch.uint8)


def pack_resident(rows: torch.Tensor, ghc: torch.Tensor) -> torch.Tensor:
    """(C,) row indices into the resident planes + (C, 3) f32 ->
    (RST_WIDTH, C) u8 slim planes: a zero route byte, the ridx bytes, the
    g/h/cnt bytes."""
    gb = ghc.to(torch.float32).contiguous().view(torch.uint8) \
        .reshape(ghc.shape[0], GH_BYTES)
    route = torch.zeros((RST_ROUTE, rows.shape[0]), dtype=torch.uint8,
                        device=ghc.device)
    return torch.cat([route, encode_ridx(rows), gb.t()], dim=0)


def pack_resident_fold_root(work: torch.Tensor, resident: torch.Tensor,
                            ghc: torch.Tensor, guard: int, *, num_bins: int,
                            num_feat: int, exact: bool,
                            seg=None) -> torch.Tensor:
    """Write the slim rows into plane 0 of ``work`` (in place: ridx = the
    original row index, so row i at lane ``guard + i``) and return the
    root histogram: one resident-histogram launch over all rows (``seg``
    as in :func:`pack_planes_fold_root`), which gathers the bins in their
    original order and so equals the planes pack's root histogram bit for
    bit. On host tensors the twin sums the rows the host knows."""
    from .histogram import _histogram_plain, segment_histogram_resident

    n = ghc.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=work.device)
    work[0, :, guard:guard + n] = pack_resident(rows, ghc)
    if work.device.type == "cpu":
        cols = work[0, :, guard:guard + n]
        return _histogram_plain(resident[:num_feat, :n],
                                unpack_ghc_planes(cols, RST_GH_OFF),
                                num_bins=num_bins, exact=exact)
    if seg is None:
        seg = root_segment(guard, n, work.device)
    return segment_histogram_resident(work, resident, seg, num_bins=num_bins,
                                      num_feat=num_feat, exact=exact,
                                      cnt_bound=n)


def on_route_plane(seg: torch.Tensor) -> torch.Tensor:
    """The (4,) device segment ``[src, start, cnt, col]`` with column 0:
    the planes partition of the slim pair routes on the route plane."""
    return torch.cat([seg[:3], seg[3:] * 0])


def write_route_plane_plain(work: torch.Tensor, resident: torch.Tensor,
                            seg: torch.Tensor) -> None:
    """Plain torch twin of the route gather: plane 0 of the segment's
    lanes of buffer ``src`` gets ``resident[col, ridx]``."""
    src, start, cnt, col = (int(v) for v in seg.tolist())
    cols = work[src, :, start:start + cnt]
    ridx = decode_ridx(cols[RST_ROUTE:RST_GH_OFF], resident.shape[1])
    work[src, 0, start:start + cnt] = resident[col].index_select(0, ridx)


def write_route_plane(work: torch.Tensor, resident: torch.Tensor,
                      seg: torch.Tensor, cnt_bound: int) -> None:
    """Write the split column's bin of each row of a segment of the slim
    pair ``work`` (2, RST_WIDTH, Npad) u8 into its route plane (plane 0 of
    buffer ``src``), gathered from the (F, Npad_res) u8 ``resident``
    planes through the rows' ridx; nothing else is written. ``seg`` is the
    (4,) device i32 ``[src, start, cnt, col]``, ``cnt_bound`` a host int
    >= cnt that sizes the grid. On a CUDA tensor it launches
    ``csrc/resident_route.cu``; on a CPU tensor it runs the plain twin.
    The planes partition then routes the slim rows on plane 0
    (:func:`on_route_plane`)."""
    check_resident_args("write_route_plane", work, resident)
    if seg.dtype != torch.int32 or seg.numel() != 4:
        raise ValueError("write_route_plane: seg must be 4 int32")
    if work.device.type == "cpu":
        return write_route_plane_plain(work, resident, seg)
    check_on_card("write_route_plane", work, seg, resident)
    # cnt_bound rows start anywhere in a word: at most cnt_bound / 4 + 2
    nblocks = max(1, -(-(int(cnt_bound) // 4 + 2) // ROUTE_WORDS_PER_BLOCK))
    ROUTE_KERNEL.launch(work.data_ptr(), work.shape[1], work.shape[2],
                        seg.data_ptr(), SEG_PLAIN, resident.data_ptr(),
                        resident.shape[1], nblocks, stream_of(work))


def check_resident_args(name: str, work: torch.Tensor,
                        resident: torch.Tensor) -> None:
    """Raise unless ``work`` is a slim pair and ``resident`` u8 planes."""
    if work.dim() != 3 or work.shape[0] != 2 or work.dtype != torch.uint8 \
            or work.shape[1] != RST_WIDTH:
        raise ValueError("%s: work must be the (2, %d, .) u8 slim pair, got "
                         "%s %s" % (name, RST_WIDTH, tuple(work.shape),
                                    work.dtype))
    if resident.dim() != 2 or resident.dtype != torch.uint8 \
            or resident.shape[1] < 1:
        raise ValueError("%s: resident must be (F, Npad) u8, got %s %s"
                         % (name, tuple(resident.shape), resident.dtype))


# ------------------------------------------------------------ one-kernel split

class OneKernelArgs(ctypes.Structure):
    """The C struct ``OneKernelArgs`` of ``csrc/one_kernel_split.cu``
    (same fields, same order)."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "work", "hdr", "table", "parent", "num_bins", "movable",
        "missing_bin", "is_cat", "monotone", "penalty", "fmask", "sums2",
        "outs2", "lows2", "ups2", "counts", "partial", "done", "cand_gain",
        "cand_bin", "num_dl", "rank", "lt", "hist_left", "hist_right",
        "gain", "feature", "bin", "kind", "default_left", "go_left",
        "left_sum", "right_sum", "left_output", "right_output", "res",
        "stamps", "rand_thr", "cegb")] \
        + [(name, ctypes.c_int32) for name in (
            "W", "npad", "table_bins", "F", "B", "nch", "groups",
            "max_cat_to_onehot", "has_categorical", "has_monotone",
            "use_mono_penalty", "npad_res", "mask_stride")] \
        + [(name, ctypes.c_float) for name in (
            "lambda_l1", "lambda_l2", "two_l1", "l2_cat", "min_data_in_leaf",
            "min_sum_hessian", "min_gain_to_split", "max_delta_step",
            "cat_smooth", "cat_l2", "min_data_per_group", "path_smooth",
            "monotone_penalty", "max_cat_threshold")]


#: the one-kernel split's device header, (8,) i32: the segment, which child
#: is the smaller one, the children's node depth, whether the split runs at
#: all (0: every block returns at once, nothing is written) and the
#: parent's row of the histogram pool. The kernel reads it on the card.
ONE_KERNEL_HDR = ("src", "start", "cnt", "col", "left_smaller", "depth",
                  "live", "parent_slot")
HDR_WORDS = len(ONE_KERNEL_HDR)
#: the split's pair block, (12,) f32: the children's sums (2, 3), outputs
#: (2,), lower and upper bounds (2,) each
PAIR_WORDS = 12


class SplitOut(NamedTuple):
    """The caller's output buffers of a split (one-kernel, or the chain of
    ``ops/chain.ChainSplit``; written only when the header's ``live`` word
    is 1)."""
    lt: torch.Tensor      # (1,) i32 left count
    hists: torch.Tensor   # (2, F, B, 3) f32 left, right histograms (the
    #                       work rows' columns: (2, HF, HB, 3) with EFB)
    fout: torch.Tensor    # (18,) f32 gain 2, left_sum 2x3, right_sum 2x3,
    #                       left_output 2, right_output 2
    iout: torch.Tensor    # (6,) i64 feature 2, bin 2, kind 2
    bout: torch.Tensor    # (2 + 2B,) bool default_left 2, go_left 2xB

    def infos(self):
        """The batch-2 ``ops.split.SplitInfo`` (left child, then right):
        views of the buffers."""
        from .split import SplitInfo
        fo, io, bo = self.fout, self.iout, self.bout
        return SplitInfo(
            gain=fo[0:2], feature=io[0:2], bin=io[2:4], kind=io[4:6],
            default_left=bo[0:2], go_left=bo[2:].view(2, -1),
            left_sum=fo[2:8].view(2, 3), right_sum=fo[8:14].view(2, 3),
            left_output=fo[14:16], right_output=fo[16:18])


def split_out(num_feat: int, num_bins: int, device, hist=None) -> SplitOut:
    """Zeroed :class:`SplitOut` buffers, allocated once per tree (or once
    per learner) and reused split after split. ``hist`` (HF, HB) is the
    histograms' shape when it differs from (F, B) (EFB bundles)."""
    hf, hb = hist if hist is not None else (num_feat, num_bins)
    return SplitOut(
        lt=torch.zeros(1, dtype=torch.int32, device=device),
        hists=torch.zeros((2, hf, hb, 3), dtype=torch.float32,
                          device=device),
        fout=torch.zeros(18, dtype=torch.float32, device=device),
        iout=torch.zeros(6, dtype=torch.int64, device=device),
        bout=torch.zeros(2 + 2 * num_bins, dtype=torch.bool, device=device))


def split_pair(sums2, outs2, lows2, ups2) -> torch.Tensor:
    """The (12,) f32 pair block from the children's (2, 3) sums and (2,)
    outputs and bounds (device tensors; no host read)."""
    return torch.cat([sums2.reshape(-1), outs2.reshape(-1),
                      lows2.reshape(-1), ups2.reshape(-1)]).to(torch.float32)


def split_header(seg, left_smaller, depth, parent_slot=0,
                 live=1) -> torch.Tensor:
    """A (8,) i32 header on ``seg``'s device from the (4,) device segment
    ``[src, start, cnt, col]`` and host values: a convenience for callers
    that know them on the host (it copies them to the card). The learner
    builds its headers on the card."""
    tail = torch.tensor([int(bool(left_smaller)), int(depth), int(live),
                         int(parent_slot)], dtype=torch.int32)
    return torch.cat([seg.reshape(-1).to(torch.int32), tail.to(seg.device)])


#: features of one histogram work item of the one-kernel split
ONE_KERNEL_FEATS_PER_ITEM = 2
#: the measurement path: each block's thread 0 writes %globaltimer (ns)
#: into its row of a (grid, ONE_KERNEL_STAMP_SLOTS) i64 buffer at these
#: points; (phase, first slot, last slot) in launch order. "C finish" runs
#: in the one block that took phase C's last ticket, which alone writes
#: slot 8.
ONE_KERNEL_STAMP_SLOTS = 9
ONE_KERNEL_PHASES = (
    ("A count", 0, 1), ("barrier 1", 1, 2), ("A scatter", 2, 3),
    ("barrier 2", 3, 4), ("B chunks", 4, 5), ("barrier 3", 5, 6),
    ("C reduce + scan", 6, 7), ("C finish", 7, 8))
#: rows of a stamp buffer: more blocks than any cooperative grid has
ONE_KERNEL_MAX_GRID = 4096


def stamp_buffer(device) -> torch.Tensor:
    """A zeroed (ONE_KERNEL_MAX_GRID, ONE_KERNEL_STAMP_SLOTS) i64 buffer
    for :class:`OneKernelSplit`'s ``stamps``: rows of blocks the grid does
    not have stay zero."""
    return torch.zeros((ONE_KERNEL_MAX_GRID, ONE_KERNEL_STAMP_SLOTS),
                       dtype=torch.int64, device=device)


def _hyper_fields(hp) -> dict:
    """The scan's scalar hyperparameters as the float32 values torch uses:
    a Python float meets a float32 tensor as float32, and the sums that
    find_best_split forms in Python (``2 * lambda_l1``, ``lambda_l2 +
    cat_l2``) are rounded once."""
    return dict(
        lambda_l1=hp.lambda_l1, lambda_l2=hp.lambda_l2,
        two_l1=2.0 * hp.lambda_l1, l2_cat=hp.lambda_l2 + hp.cat_l2,
        min_data_in_leaf=hp.min_data_in_leaf,
        min_sum_hessian=hp.min_sum_hessian_in_leaf,
        min_gain_to_split=hp.min_gain_to_split,
        max_delta_step=hp.max_delta_step, cat_smooth=hp.cat_smooth,
        cat_l2=hp.cat_l2, min_data_per_group=hp.min_data_per_group,
        path_smooth=hp.path_smooth, monotone_penalty=hp.monotone_penalty,
        max_cat_threshold=float(hp.max_cat_threshold),
        max_cat_to_onehot=int(hp.max_cat_to_onehot),
        has_categorical=int(hp.has_categorical),
        has_monotone=int(hp.has_monotone),
        use_mono_penalty=int(hp.has_monotone and hp.monotone_penalty > 0))


def one_kernel_split_planes_plain(work, seg, go_left, left_smaller, depth,
                                  parent_hist, meta, fmask, sums2, outs2,
                                  lows2, ups2, hp, *, num_bins, num_feat,
                                  exact=True, resident=None):
    """Plain torch twin of the one-kernel split: the three-launch chain,
    ``partition_segment_plain`` -> ``segment_histogram_plain`` on the
    smaller child -> parent minus child -> ``find_best_split`` over the
    stacked pair with ``node_depth=depth``. Given the ``resident`` planes
    (``work`` is then the slim pair) it is the resident chain:
    ``write_route_plane_plain`` -> ``partition_segment_plain`` on the
    route plane -> ``segment_histogram_resident_plain`` -> the same."""
    from .histogram import (segment_histogram_plain,
                            segment_histogram_resident_plain)
    from .split import find_best_split

    if resident is not None:
        write_route_plane_plain(work, resident, seg)
        lt = partition_segment_plain(work, on_route_plane(seg), go_left)
    else:
        lt = partition_segment_plain(work, seg, go_left)
    src, start, cnt, _ = (int(v) for v in seg.tolist())
    n_left = int(lt)
    hseg = torch.tensor([1 - src, start, n_left] if left_smaller
                        else [1 - src, start + n_left, cnt - n_left],
                        dtype=torch.int32, device=work.device)
    if resident is not None:
        small = segment_histogram_resident_plain(
            work, resident, hseg, num_bins=num_bins, num_feat=num_feat,
            exact=exact)
    else:
        small = segment_histogram_plain(work, hseg, num_bins=num_bins,
                                        num_feat=num_feat, exact=exact)
    large = parent_hist - small
    hl, hr = (small, large) if left_smaller else (large, small)
    infos = find_best_split(torch.stack([hl, hr]), sums2, meta, fmask, hp,
                            parent_output=outs2, leaf_lower=lows2,
                            leaf_upper=ups2, node_depth=depth)
    return lt, hl, hr, infos


def one_kernel_split_planes(work, seg, go_left, left_smaller, depth,
                            parent_hist, meta, fmask, sums2, outs2, lows2,
                            ups2, hp, *, num_bins, num_feat, exact=True,
                            cnt_bound, resident=None):
    """One split in one launch (planes or resident layout): route the
    parent's rows, histogram the smaller child, scan both children.

    ``work`` (2, W, Npad) u8 with ``W = num_feat + 12`` is updated in
    place; ``seg`` is the device (4,) i32 ``[src, start, cnt, col]``;
    ``go_left`` the (B,) bool routing table; ``left_smaller`` (the left
    child is the smaller one), ``depth`` (the children's node depth) and
    ``cnt_bound`` (>= cnt; it sizes the scratch, while the kernel sizes
    its histogram by the smaller child's count, read on the card) are host
    values, copied into a device header (:func:`split_header`) that the
    kernel reads. ``parent_hist`` is the
    parent's (F, B, 3) f32 histogram, ``meta`` a ``FeatureMeta`` of (F,)
    tensors, ``fmask`` the (F,) bool search mask, ``sums2`` the (2, 3)
    child sums, ``outs2``/``lows2``/``ups2`` the (2,) child outputs and
    bounds, ``hp`` a ``SplitHyper``.

    Returns ``(lt, hist_left, hist_right, infos)``: the (1,) i32 left
    count, the children's (F, B, 3) histograms and a batch-2
    ``ops.split.SplitInfo`` (left child, then right) in the port's dtypes
    (the kernel writes i64 and bool directly). On a CUDA tensor it
    launches ``csrc/one_kernel_split.cu`` once; on a CPU tensor it runs
    the plain twin (:func:`one_kernel_split_header_plain`). Raises on a
    shape or type the kernel does not take. A caller that runs many splits
    over one work buffer (the learner) builds one :class:`OneKernelSplit`
    instead and calls :meth:`OneKernelSplit.split` per split with a header
    built on the card.

    Resident mode (the TPU kernel's ``resident_planes``): ``resident`` is
    the (num_feat, Npad_res) u8 resident bin planes, ``work`` the slim
    pair (2, RST_WIDTH, Npad) and ``col`` a column of ``resident``. The
    launch gathers the route bytes, routes the slim rows on them and
    gathers the smaller child's bins through ridx
    (``one_kernel_split_resident``); the twin is the resident chain.
    """
    return OneKernelSplit(work, meta, fmask, hp, num_bins=num_bins,
                          num_feat=num_feat, exact=exact,
                          cnt_max=cnt_bound, resident=resident)(
        seg, go_left, left_smaller, depth, parent_hist, sums2, outs2, lows2,
        ups2, cnt_bound=cnt_bound)


def one_kernel_scratch_rows(cnt_max: int) -> Tuple[int, int]:
    """(chunk partials, partition tiles) a one-kernel split's scratch holds
    for parents of up to ``cnt_max`` rows. The smaller child is the one
    with the smaller count channel, which under bagging may hold any share
    of the parent's rows, so the partials cover all ``cnt_max`` of them;
    the kernel reads the child's true count on the card and uses as many
    chunks as it has."""
    from .histogram import hist_chunks
    return max(1, hist_chunks(cnt_max)), max(1, -(-int(cnt_max) // PART_TILE))


class OneKernelSplit:
    """:func:`one_kernel_split_planes` over one work buffer, split after
    split. What stays fixed while a tree grows (the buffer, ``meta``,
    ``fmask``, ``hp`` and the shapes) is validated once, and on the card
    packed once into the C argument struct beside the scratch buffers
    (sized for segments of up to ``cnt_max`` rows); :meth:`split` fills in
    one split's pointers and launches. Every scalar of a split rides in
    its device header, so a launch never waits for the card and a CUDA
    graph can hold a tree's launches. ``resident`` (the resident bin
    planes) selects the resident mode. A call may pass ``stamps`` (a
    :func:`stamp_buffer` on the card): the kernel then writes each block's
    phase times into it (ONE_KERNEL_PHASES); the learner never does."""

    def __init__(self, work, meta, fmask, hp, *, num_bins, num_feat,
                 exact=True, cnt_max, resident=None):
        name = "one_kernel_split_planes"
        _check_one_kernel_fixed(name, work, meta, fmask, hp, num_bins,
                                num_feat, resident)
        self.work, self.meta, self.fmask, self.hp = work, meta, fmask, hp
        self.num_bins, self.num_feat, self.exact = num_bins, num_feat, exact
        self.cnt_max = int(cnt_max)
        self.resident = resident
        self._kernel = ONE_KERNEL if resident is None else ONE_KERNEL_RESIDENT
        self._args = None
        self._checked_out = None
        if work.device.type == "cpu":
            return
        extra = () if resident is None else (resident,)
        check_on_card(self._kernel.symbol, work, fmask, *meta[:6], *extra)
        dev = work.device
        F, B = num_feat, num_bins
        nch = 5 if exact else 3
        chunks, tiles = one_kernel_scratch_rows(self.cnt_max)
        i32 = torch.int32
        self._scratch = (
            torch.empty(tiles, dtype=i32, device=dev),          # counts
            torch.empty((chunks, F, B, nch),
                        dtype=torch.float32, device=dev),       # partials
            torch.zeros(1, dtype=i32, device=dev),              # ticket
            torch.empty((2, 2, 4, F), dtype=i32, device=dev),   # gain | bin
            torch.empty((3, 2, F, B), dtype=torch.uint8,
                        device=dev))                            # dl | ranks
        counts, partial, done, cand, flags = self._scratch
        fl = flags.data_ptr()
        self._args = OneKernelArgs(
            work=work.data_ptr(), num_bins=meta.num_bins.data_ptr(),
            movable=meta.movable_missing.data_ptr(),
            missing_bin=meta.missing_bin.data_ptr(),
            is_cat=meta.is_categorical.data_ptr(),
            monotone=meta.monotone.data_ptr(),
            penalty=meta.penalty.data_ptr(), fmask=fmask.data_ptr(),
            counts=counts.data_ptr(), partial=partial.data_ptr(),
            done=done.data_ptr(),
            cand_gain=cand.data_ptr(), cand_bin=cand.data_ptr() + 4 * 8 * F,
            num_dl=fl, rank=fl + 2 * F * B, W=work.shape[1],
            npad=work.shape[2], table_bins=B, F=F, B=B, nch=nch,
            groups=-(-F // ONE_KERNEL_FEATS_PER_ITEM),
            res=0 if resident is None else resident.data_ptr(),
            npad_res=0 if resident is None else resident.shape[1],
            **_hyper_fields(hp))

    def split(self, hdr, go_left, pool, pair, out, *, lanes=None,
              stamps=None) -> None:
        """One split from the (8,) i32 device header ``hdr``
        (ONE_KERNEL_HDR), the (B,) bool routing table ``go_left``, the
        (P, F, B, 3) f32 histogram ``pool`` whose row ``parent_slot`` is
        the parent's, and the (12,) f32 ``pair`` block (PAIR_WORDS); the
        results go into ``out`` (:class:`SplitOut`). On a CUDA tensor one
        cooperative launch of ``csrc/one_kernel_split.cu``; on a CPU tensor
        the plain twin :func:`one_kernel_split_header_plain`. Neither reads
        anything back to the host. The scratch holds segments of up to
        ``cnt_max`` rows: a header whose count exceeds it is the caller's
        error, which the host does not see. ``lanes``, a host ``(lo, hi)``
        that holds the parent's segment, lets the twin work on those lanes
        only (a caller that knows the segment on the host, as the per-split
        host loop does); the kernel needs no such bound."""
        _check_one_kernel_split(self, hdr, go_left, pool, pair, out)
        if self._args is None:
            one_kernel_split_header_plain(
                self.work, hdr, go_left, pool, pair, out, self.meta,
                self.fmask, self.hp, num_bins=self.num_bins,
                num_feat=self.num_feat, exact=self.exact,
                resident=self.resident, lanes=lanes)
            return
        check_on_card(self._kernel.symbol, self.work, hdr, go_left, pool,
                      pair, out.lt)
        F, B = self.num_feat, self.num_bins
        fo, io, bo = (out.fout.data_ptr(), out.iout.data_ptr(),
                      out.bout.data_ptr())
        pp = pair.data_ptr()
        a = self._args
        a.hdr, a.table, a.parent = (hdr.data_ptr(), go_left.data_ptr(),
                                    pool.data_ptr())
        a.sums2, a.outs2, a.lows2, a.ups2 = pp, pp + 24, pp + 32, pp + 40
        a.lt = out.lt.data_ptr()
        a.hist_left = out.hists.data_ptr()
        a.hist_right = a.hist_left + 4 * F * B * 3
        a.gain, a.left_sum, a.right_sum = fo, fo + 8, fo + 32
        a.left_output, a.right_output = fo + 56, fo + 64
        a.feature, a.bin, a.kind = io, io + 16, io + 32
        a.default_left, a.go_left = bo, bo + 2
        if stamps is not None:
            check_on_card(self._kernel.symbol, self.work, stamps)
            if stamps.dtype != torch.int64 or stamps.shape != (
                    ONE_KERNEL_MAX_GRID, ONE_KERNEL_STAMP_SLOTS):
                raise ValueError("one_kernel_split_planes: stamps must be "
                                 "a stamp_buffer()")
        a.stamps = 0 if stamps is None else stamps.data_ptr()
        self._kernel.launch(ctypes.addressof(a), stream_of(self.work))

    def __call__(self, seg, go_left, left_smaller, depth, parent_hist,
                 sums2, outs2, lows2, ups2, *, cnt_bound, stamps=None):
        """:meth:`split` with the split's scalars given on the host (copied
        into a header, :func:`split_header`) and fresh output buffers.
        Returns ``(lt, hist_left, hist_right, infos)``."""
        if int(cnt_bound) > self.cnt_max:
            raise ValueError("one_kernel_split_planes: cnt_bound %d above "
                             "the %d rows the scratch was sized for"
                             % (cnt_bound, self.cnt_max))
        if seg.dtype != torch.int32 or seg.numel() != 4:
            raise ValueError("one_kernel_split_planes: seg must be 4 int32")
        for field, t, shape in (("parent_hist", parent_hist,
                                 (self.num_feat, self.num_bins, 3)),
                                ("sums2", sums2, (2, 3)),
                                ("outs2", outs2, (2,)), ("lows2", lows2, (2,)),
                                ("ups2", ups2, (2,))):
            if t.shape != shape or t.dtype != torch.float32:
                raise ValueError("one_kernel_split_planes: %s must be %s f32,"
                                 " got %s %s" % (field, shape,
                                                 tuple(t.shape), t.dtype))
        out = split_out(self.num_feat, self.num_bins, self.work.device)
        self.split(split_header(seg, left_smaller, depth), go_left,
                   parent_hist[None], split_pair(sums2, outs2, lows2, ups2),
                   out, stamps=stamps)
        return out.lt, out.hists[0], out.hists[1], out.infos()


def _check_one_kernel_fixed(name, work, meta, fmask, hp, num_bins,
                            num_feat, resident=None) -> None:
    """What a one-kernel split takes for a whole tree."""
    if work.dim() != 3 or work.shape[0] != 2 or work.dtype != torch.uint8:
        raise ValueError("%s: work must be a (2, ., .) u8 pair, got %s %s"
                         % (name, tuple(work.shape), work.dtype))
    if work.shape[2] % 128:
        raise ValueError("%s: needs whole 128-lane tiles in the lane dim, "
                         "got Npad=%d" % (name, work.shape[2]))
    if resident is not None:
        check_resident_args(name, work, resident)
        if resident.shape[0] != num_feat:
            raise ValueError("%s: resident has %d planes, not num_feat = %d"
                             % (name, resident.shape[0], num_feat))
    elif work.shape[1] != num_feat + GH_BYTES:
        raise ValueError("%s: work has %d planes, not num_feat + %d = %d"
                         % (name, work.shape[1], GH_BYTES,
                            num_feat + GH_BYTES))
    check_scan_inputs(name, meta, fmask, hp, num_bins, num_feat)


def check_scan_inputs(name, meta, fmask, hp, num_bins, num_feat,
                      cegb_ok=False, mono_ok=False) -> None:
    """What a split scan kernel takes for a whole tree: the FeatureMeta
    columns, the search mask and hyperparameters it has fields for
    (``cegb_ok``: the kernel takes CEGB penalties; ``mono_ok``: the
    intermediate and advanced monotone methods' bounds)."""
    if not 0 < num_bins <= 256:
        raise ValueError("%s: needs 0 < num_bins <= 256, got %d"
                         % (name, num_bins))
    want = (("num_bins", torch.int32), ("movable_missing", torch.bool),
            ("missing_bin", torch.int32), ("is_categorical", torch.bool),
            ("monotone", torch.int8), ("penalty", torch.float32))
    for field, dtype in want:
        t = getattr(meta, field)
        if t.dtype != dtype or t.shape != (num_feat,):
            raise ValueError("%s: meta.%s must be (%d,) %s, got %s %s"
                             % (name, field, num_feat, dtype,
                                tuple(t.shape), t.dtype))
    if fmask.dtype != torch.bool or fmask.shape != (num_feat,):
        raise ValueError("%s: fmask must be (%d,) bool" % (name, num_feat))
    if (hp.use_cegb and not cegb_ok) or (
            hp.has_monotone and (hp.mono_intermediate or hp.mono_advanced)
            and not mono_ok):
        raise ValueError("%s: CEGB and intermediate/advanced monotone "
                         "constraints are not inputs of the kernel" % name)


def _check_one_kernel_split(op, hdr, go_left, pool, pair, out) -> None:
    """What a one-kernel split takes for one split."""
    name = "one_kernel_split_planes"
    F, B = op.num_feat, op.num_bins
    if hdr.dtype != torch.int32 or hdr.shape != (HDR_WORDS,):
        raise ValueError("%s: hdr must be (%d,) int32" % (name, HDR_WORDS))
    if go_left.dtype != torch.bool or go_left.shape != (B,):
        raise ValueError("%s: needs a (%d,) bool table, got %s %s"
                         % (name, B, tuple(go_left.shape), go_left.dtype))
    if pool.dim() != 4 or pool.shape[1:] != (F, B, 3) \
            or pool.dtype != torch.float32:
        raise ValueError("%s: the histogram pool must be (P, %d, %d, 3) f32, "
                         "got %s %s" % (name, F, B, tuple(pool.shape),
                                        pool.dtype))
    if pair.dtype != torch.float32 or pair.shape != (PAIR_WORDS,):
        raise ValueError("%s: pair must be (%d,) f32" % (name, PAIR_WORDS))
    if out is not op._checked_out:
        want = SplitOut(lt=((1,), torch.int32),
                        hists=((2, F, B, 3), torch.float32),
                        fout=((18,), torch.float32),
                        iout=((6,), torch.int64),
                        bout=((2 + 2 * B,), torch.bool))
        for field, t, (shape, dtype) in zip(SplitOut._fields, out, want):
            if t.shape != shape or t.dtype != dtype \
                    or not t.is_contiguous() or t.device != op.work.device:
                raise ValueError("%s: out.%s must be contiguous %s %s on %s, "
                                 "got %s %s on %s"
                                 % (name, field, shape, dtype,
                                    op.work.device, tuple(t.shape), t.dtype,
                                    t.device))
        op._checked_out = out    # buffers reused split after split


def _hdr_words(hdr: torch.Tensor):
    """The (8,) header's words as 0-d int64 tensors (no host read)."""
    return hdr.to(torch.int64).unbind()


def planes_view(work: torch.Tensor, rows: bool = False) -> torch.Tensor:
    """``work`` as (2, W, Npad) byte planes: the rows layout's (2, Npad, W)
    pair transposed (a view; the planes and resident layouts as they
    are)."""
    return work.transpose(1, 2) if rows else work


def write_route_plane_header_plain(work: torch.Tensor, resident: torch.Tensor,
                                   hdr: torch.Tensor, lanes=None) -> None:
    """Plain twin of the route gather on a split's header (SEG_PARENT):
    plane 0 of the parent segment's lanes of buffer ``src`` gets
    ``resident[col, ridx]``, over whole planes under a mask (no host
    read); a dead header writes nothing new. ``lanes`` (host ``(lo, hi)``
    holding the segment) limits the work to those lanes."""
    src, start, cnt, col, _, _, live, _ = _hdr_words(hdr)
    lo, hi = lanes if lanes is not None else (0, work.shape[2])
    view = work[:, :, lo:hi]
    lane = torch.arange(lo, hi, dtype=torch.int64, device=work.device)
    in_seg = (lane >= start) & (lane < start + cnt) & (live != 0)
    srcp = view.index_select(0, src.reshape(1))[0]
    ridx = decode_ridx(srcp[RST_ROUTE:RST_GH_OFF], resident.shape[1])
    routed = resident.index_select(0, col.reshape(1))[0].index_select(0, ridx)
    srcp[0] = torch.where(in_seg, routed, srcp[0])
    view.index_copy_(0, src.reshape(1), srcp[None])


def partition_header_plain(work: torch.Tensor, hdr: torch.Tensor,
                           table: torch.Tensor, *, route_plane=False,
                           lanes=None) -> torch.Tensor:
    """Plain twin of a partition on a split's header (SEG_PARENT, or
    SEG_ROUTE with ``route_plane``) over the (2, W, Npad) planes ``work``
    (:func:`planes_view` of a rows pair): the stable partition as a
    permutation of the destination plane's lanes under a mask (lanes
    outside the segment map to themselves), so nothing is read back to the
    host and a dead header moves nothing. Returns ``lt`` as a (1,) i32
    tensor (0 when dead). ``lanes`` as in
    :func:`write_route_plane_header_plain`."""
    dev = work.device
    src, start, cnt, col, _, _, live, _ = _hdr_words(hdr)
    lo, hi = lanes if lanes is not None else (0, work.shape[2])
    view = work[:, :, lo:hi]
    lane = torch.arange(lo, hi, dtype=torch.int64, device=dev)
    in_seg = (lane >= start) & (lane < start + cnt) & (live != 0)
    srcp = view.index_select(0, src.reshape(1))[0]
    dstp = view.index_select(0, (1 - src).reshape(1))[0]
    key = srcp[0] if route_plane else \
        srcp.index_select(0, col.reshape(1))[0]
    # lanes outside the segment may hold any byte: look up bin 0 for them
    key = torch.where(in_seg, key.long(), torch.zeros((), dtype=torch.int64,
                                                      device=dev))
    go = table[key] & in_seg
    right = in_seg & ~go
    lt = go.sum()
    dest = torch.where(go, start + torch.cumsum(go, 0) - 1,
                       torch.where(right,
                                   start + lt + torch.cumsum(right, 0) - 1,
                                   lane)) - lo
    moved = torch.where(in_seg[None], srcp, dstp)
    dstp = torch.empty_like(dstp).index_copy_(1, dest, moved)
    view.index_copy_(0, (1 - src).reshape(1), dstp[None])
    return lt.to(torch.int32).reshape(1)


def put_split_infos(out: "SplitOut", infos, live: torch.Tensor) -> None:
    """The batch-2 ``SplitInfo`` into ``out``'s fout / iout / bout where
    ``live`` (a 0-d bool), else unchanged."""
    fout = torch.cat([infos.gain, infos.left_sum.reshape(-1),
                      infos.right_sum.reshape(-1), infos.left_output,
                      infos.right_output])
    iout = torch.cat([infos.feature, infos.bin, infos.kind])
    bout = torch.cat([infos.default_left, infos.go_left.reshape(-1)])
    for buf, val in ((out.fout, fout), (out.iout, iout), (out.bout, bout)):
        buf.copy_(torch.where(live, val.to(buf.dtype), buf))


def put_split_info0(out: "SplitOut", info, live: torch.Tensor) -> None:
    """An unbatched ``SplitInfo`` into child 0 of ``out`` where ``live``
    (a 0-d bool), the other child's slots unchanged."""
    fo, io, bo = out.fout, out.iout, out.bout
    B = info.go_left.shape[-1]
    for buf, idx, val in (
            (fo, [0], info.gain), (fo, [2, 3, 4], info.left_sum),
            (fo, [8, 9, 10], info.right_sum), (fo, [14], info.left_output),
            (fo, [16], info.right_output), (io, [0], info.feature),
            (io, [2], info.bin), (io, [4], info.kind),
            (bo, [0], info.default_left),
            (bo, list(range(2, 2 + B)), info.go_left)):
        ix = torch.tensor(idx, dtype=torch.int64, device=buf.device)
        cur = buf.index_select(0, ix)
        buf.index_copy_(0, ix, torch.where(
            live, val.reshape(-1).to(buf.dtype), cur))


def one_kernel_split_header_plain(work, hdr, go_left, pool, pair, out, meta,
                                  fmask, hp, *, num_bins, num_feat,
                                  exact=True, resident=None,
                                  lanes=None) -> None:
    """Plain torch twin of :meth:`OneKernelSplit.split`: the split read
    from the device header, with no host read, so that the device tree
    loop (``learner.DeviceTreeLoop``) runs on host tensors as it runs on
    the card. It computes what the three-launch chain
    (:func:`one_kernel_split_planes_plain`) computes, bit for bit, over
    whole planes under masks instead of slices: the route gather
    (resident) and the partition (:func:`partition_header_plain`), the
    smaller child's float64 histogram with the other lanes' contributions
    zeroed (adding zeros leaves every sum's bits as they are;
    ``ops/histogram.segment_histogram_header_plain``), parent minus child,
    then ``find_best_split``. With ``live`` 0 nothing is written. ``lanes``
    (host ``(lo, hi)`` holding the segment) limits the work to those
    lanes; by default every lane."""
    from .histogram import segment_histogram_header_plain
    from .split import find_best_split

    _, _, _, _, ls, depth, live, slot = _hdr_words(hdr)
    live = live != 0
    ls = ls != 0
    if resident is not None:
        write_route_plane_header_plain(work, resident, hdr, lanes)
    lt = partition_header_plain(work, hdr, go_left,
                                route_plane=resident is not None,
                                lanes=lanes)
    small = segment_histogram_header_plain(
        work, hdr, lt, num_bins=num_bins, num_feat=num_feat, exact=exact,
        resident=resident, lanes=lanes)
    large = pool.index_select(0, slot.reshape(1))[0] - small
    hl = torch.where(ls, small, large)
    hr = torch.where(ls, large, small)
    infos = find_best_split(torch.stack([hl, hr]), pair[0:6].view(2, 3),
                            meta, fmask, hp, parent_output=pair[6:8],
                            leaf_lower=pair[8:10], leaf_upper=pair[10:12],
                            node_depth=depth)
    for buf, val in ((out.lt, lt), (out.hists, torch.stack([hl, hr]))):
        buf.copy_(torch.where(live, val.to(buf.dtype), buf))
    put_split_infos(out, infos, live)


# ------------------------------------------------ the device tree loop's K3

class SegmentPartition:
    """The partition of the device tree loop's three-launch chain
    (``ops/chain.ChainSplit``): K3 on the planes, resident (the route
    plane) or rows layout, planned once for segments of up to ``cnt_max``
    rows (the root) and launched per split on the split's device header,
    with no host value: the kernel reads the segment and the live word on
    the card (SEG_PARENT, SEG_ROUTE), and a dead header moves nothing. The
    plan is :func:`partition_planes_plan` / :func:`partition_rows_plan` at
    ``cnt_max``: each kernel decides its mode from the true count and any
    grid gives the same bytes. Its per-block scratch is kept here. On host
    tensors, :func:`partition_header_plain` (on the planes view)."""

    def __init__(self, work: torch.Tensor, *, layout: str, cnt_max: int):
        if layout not in ("planes", "resident", "rows"):
            raise ValueError("SegmentPartition: layout %r" % layout)
        self.work, self.layout = work, layout
        self.rows = layout == "rows"
        self.mode = SEG_ROUTE if layout == "resident" else SEG_PARENT
        self.cnt_max = max(1, int(cnt_max))
        self.plan = None
        if work.device.type == "cpu":
            return
        check_on_card("partition_segment", work)
        sms = sm_count(work.device.index)
        if self.rows:
            self.plan = partition_rows_plan(self.cnt_max, work.shape[2], sms)
        else:
            self.plan = partition_planes_plan(self.cnt_max, work.shape[1],
                                              sms)
        self.scratch = torch.empty(max(self.plan.grid, 1), dtype=torch.int32,
                                   device=work.device)

    def __call__(self, hdr: torch.Tensor, table: torch.Tensor,
                 lt: torch.Tensor) -> None:
        """Partition the parent segment of the (8,) i32 header ``hdr`` by
        the (Bm,) bool ``table`` (over the split column's codes) into the
        other buffer; the left count goes into the (1,) i32 ``lt``."""
        if hdr.dtype != torch.int32 or hdr.shape != (HDR_WORDS,):
            raise ValueError("partition: hdr must be (%d,) int32"
                             % HDR_WORDS)
        if table.dtype != torch.bool or table.dim() != 1 \
                or not 0 < table.numel() <= 256:
            raise ValueError("partition: table must be (B,) bool, B <= 256")
        work = self.work
        if self.plan is None:
            # a dead header leaves lt as it is, as the kernel does
            lt.copy_(torch.where(hdr[6:7] != 0, partition_header_plain(
                planes_view(work, self.rows), hdr, table,
                route_plane=self.mode == SEG_ROUTE), lt))
            return
        check_on_card("partition_segment", work, hdr, table, lt)
        p = self.plan
        if self.rows:
            PARTITION_ROWS_KERNEL.launch(
                work.data_ptr(), work.shape[2], work.shape[1],
                hdr.data_ptr(), table.data_ptr(), table.numel(), p.steps,
                p.slots, p.grid, self.mode, self.scratch.data_ptr(),
                lt.data_ptr(), stream_of(work))
        else:
            PARTITION_KERNEL.launch(
                work.data_ptr(), work.shape[1], work.shape[2],
                hdr.data_ptr(), table.data_ptr(), table.numel(), p.steps,
                p.group, p.slots, p.grid, self.mode, self.scratch.data_ptr(),
                lt.data_ptr(), stream_of(work))


class RouteGather:
    """The resident layout's route gather in the device tree loop: the
    split column's bins into the route plane of the parent segment of the
    split's header (SEG_PARENT), sized once for ``cnt_max`` rows
    (ROUTE_STATIC_BLOCKS_PER_SM blocks an SM at most, striding over the
    segment's words). On host tensors
    :func:`write_route_plane_header_plain`."""

    def __init__(self, work: torch.Tensor, resident: torch.Tensor, *,
                 cnt_max: int):
        check_resident_args("write_route_plane", work, resident)
        self.work, self.resident = work, resident
        self.nblocks = 0
        if work.device.type == "cpu":
            return
        check_on_card("write_route_plane", work, resident)
        words = -(-(max(1, int(cnt_max)) // 4 + 2) // ROUTE_WORDS_PER_BLOCK)
        self.nblocks = max(1, min(words, ROUTE_STATIC_BLOCKS_PER_SM
                                  * sm_count(work.device.index)))

    def __call__(self, hdr: torch.Tensor) -> None:
        if hdr.dtype != torch.int32 or hdr.shape != (HDR_WORDS,):
            raise ValueError("write_route_plane: hdr must be (%d,) int32"
                             % HDR_WORDS)
        if not self.nblocks:
            write_route_plane_header_plain(self.work, self.resident, hdr)
            return
        check_on_card("write_route_plane", self.work, hdr)
        ROUTE_KERNEL.launch(self.work.data_ptr(), self.work.shape[1],
                            self.work.shape[2], hdr.data_ptr(), SEG_PARENT,
                            self.resident.data_ptr(), self.resident.shape[1],
                            self.nblocks, stream_of(self.work))
