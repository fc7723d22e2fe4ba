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
``csrc/partition_segment.cu`` (entry points ``partition_segment`` and
``partition_segment_rows``, replacing the TPU kernels
``partition_segment_planes_fused`` and ``partition_segment_fused``); on a
CPU tensor they run their plain twins. The order is fixed and stable on
both sides (the TPU kernels leave it unspecified): left rows ascending
from ``start``, right rows ascending from ``start + lt``, so a kernel and
its twin agree byte for byte, and both layouts hold the same rows in the
same order.

Segment arguments ride in a small device i32 tensor, so the learner never
waits for the card to issue a launch; ``cnt_bound`` (a host int at least
the segment's row count) only sizes the grid.

:func:`one_kernel_split_planes` runs a whole split in one launch: the
partition, the smaller child's histogram and both children's split scan
(``csrc/one_kernel_split.cu``, replacing the TPU kernel
``one_kernel_split_planes`` in its planes and resident modes); its plain
twin :func:`one_kernel_split_planes_plain` is the three-launch chain.

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
from typing import Tuple

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
#: rows per block of the partition kernel (its count and scatter tile)
PART_TILE = 4096

_P = ctypes.c_void_p
_I = ctypes.c_int
_PART_ARGS = [_P, _I, _I, _P, _P, _I, _P, _P, _I, _P]
PARTITION_KERNEL = register(CudaKernel(
    "partition_segment", "partition_segment.cu", _PART_ARGS))
PARTITION_ROWS_KERNEL = register(CudaKernel(
    "partition_segment_rows", "partition_segment.cu", _PART_ARGS))
#: phase C follows torch's arithmetic op by op: no contracted multiply-adds
ONE_KERNEL = register(CudaKernel(
    "one_kernel_split", "one_kernel_split.cu", [_P, _P],
    flags=("-fmad=false",)))
ONE_KERNEL_RESIDENT = register(CudaKernel(
    "one_kernel_split_resident", "one_kernel_split.cu", [_P, _P],
    flags=("-fmad=false",)))
ROUTE_KERNEL = register(CudaKernel(
    "write_route_plane", "resident_route.cu", [_P, _I, _I, _P, _P, _I, _I,
                                               _P]))
#: 4-row words of a route-gather block per pass: 64 threads, one word each
ROUTE_WORDS_PER_BLOCK = 64


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


def pack_planes_fold_root(work: torch.Tensor, bins: torch.Tensor,
                          ghc: torch.Tensor, guard: int, *, num_bins: int,
                          exact: bool) -> torch.Tensor:
    """Write rows into plane 0 of ``work`` (in place) and return the root
    histogram: one segment-histogram launch over all rows. The TPU folds
    the histogram into the pack pass to save a DMA read; here the pack is
    a torch copy and the histogram its own kernel."""
    from .histogram import segment_histogram

    n, g = bins.shape
    work[0, :, guard:guard + n] = pack_planes(bins, ghc)
    seg = torch.tensor([0, guard, n], dtype=torch.int32, device=work.device)
    return segment_histogram(work, seg, num_bins=num_bins, num_feat=g,
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
    """
    _check_partition_args("partition_segment", work, seg, table)
    if work.device.type == "cpu":
        return partition_segment_plain(work, seg, table)
    return _launch_partition(PARTITION_KERNEL, work, seg, table, cnt_bound,
                             rows=work.shape[2], width=work.shape[1])


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


def _launch_partition(kernel: CudaKernel, work: torch.Tensor,
                      seg: torch.Tensor, table: torch.Tensor, cnt_bound: int,
                      *, rows: int, width: int) -> torch.Tensor:
    """Launch a partition entry point on a CUDA ``work`` (``rows`` = its
    Npad, ``width`` = W); raises on any other device."""
    check_on_card(kernel.symbol, work, seg, table)
    nblocks = max(1, -(-int(cnt_bound) // PART_TILE))
    scratch = torch.empty(nblocks, dtype=torch.int32, device=work.device)
    lt = torch.empty(1, dtype=torch.int32, device=work.device)
    kernel.launch(work.data_ptr(), width, rows, seg.data_ptr(),
                  table.data_ptr(), table.numel(), scratch.data_ptr(),
                  lt.data_ptr(), nblocks, stream_of(work))
    return lt


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


def partition_segment_rows(work: torch.Tensor, seg: torch.Tensor,
                           table: torch.Tensor,
                           cnt_bound: int) -> torch.Tensor:
    """Stably partition rows ``[start, start + cnt)`` of buffer ``src`` of
    ``work`` (2, Npad, W) u8 into buffer ``1 - src`` by the routing table;
    the arguments and the result are :func:`partition_segment`'s."""
    _check_partition_args("partition_segment_rows", work, seg, table)
    if work.device.type == "cpu":
        return partition_segment_rows_plain(work, seg, table)
    return _launch_partition(PARTITION_ROWS_KERNEL, work, seg, table,
                             cnt_bound, rows=work.shape[1],
                             width=work.shape[2])


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
                            num_feat: int, exact: bool) -> torch.Tensor:
    """Write the slim rows into plane 0 of ``work`` (in place: ridx = the
    original row index, so row i at lane ``guard + i``) and return the
    root histogram: one resident-histogram launch over all rows, which
    gathers the bins in their original order and so equals the planes
    pack's root histogram bit for bit."""
    from .histogram import segment_histogram_resident

    n = ghc.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=work.device)
    work[0, :, guard:guard + n] = pack_resident(rows, ghc)
    seg = torch.tensor([0, guard, n], dtype=torch.int32, device=work.device)
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
                        seg.data_ptr(), resident.data_ptr(),
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
        "work", "seg", "table", "parent", "num_bins", "movable",
        "missing_bin", "is_cat", "monotone", "penalty", "fmask", "sums2",
        "outs2", "lows2", "ups2", "counts", "partial", "done", "cand_gain",
        "cand_bin", "num_dl", "rank", "lt", "hist_left", "hist_right",
        "gain", "feature", "bin", "kind", "default_left", "go_left",
        "left_sum", "right_sum", "left_output", "right_output", "res",
        "stamps")] \
        + [(name, ctypes.c_int32) for name in (
            "W", "npad", "table_bins", "left_smaller", "depth", "F", "B",
            "nch", "groups", "max_cat_to_onehot", "has_categorical",
            "has_monotone", "use_mono_penalty", "npad_res")] \
        + [(name, ctypes.c_float) for name in (
            "lambda_l1", "lambda_l2", "two_l1", "l2_cat", "min_data_in_leaf",
            "min_sum_hessian", "min_gain_to_split", "max_delta_step",
            "cat_smooth", "cat_l2", "min_data_per_group", "path_smooth",
            "monotone_penalty", "max_cat_threshold")]


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
    ints. ``parent_hist`` is the
    parent's (F, B, 3) f32 histogram, ``meta`` a ``FeatureMeta`` of (F,)
    tensors, ``fmask`` the (F,) bool search mask, ``sums2`` the (2, 3)
    child sums, ``outs2``/``lows2``/``ups2`` the (2,) child outputs and
    bounds, ``hp`` a ``SplitHyper``.

    Returns ``(lt, hist_left, hist_right, infos)``: the (1,) i32 left
    count, the children's (F, B, 3) histograms and a batch-2
    ``ops.split.SplitInfo`` (left child, then right) in the port's dtypes
    (the kernel writes i64 and bool directly). On a CUDA tensor it
    launches ``csrc/one_kernel_split.cu`` once; on a CPU tensor it runs
    the plain twin. Raises on a shape or type the kernel does not take.
    A caller that runs many splits over one work buffer (the learner)
    builds one :class:`OneKernelSplit` instead and calls it per split.

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
    (sized for segments of up to ``cnt_max`` rows); each call checks and
    fills in one split's own fields and launches. ``resident`` (the
    resident bin planes) selects the resident mode. A call may pass
    ``stamps`` (a :func:`stamp_buffer` on the card): the kernel then
    writes each block's phase times into it (ONE_KERNEL_PHASES); the
    learner never does."""

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

    def __call__(self, seg, go_left, left_smaller, depth, parent_hist,
                 sums2, outs2, lows2, ups2, *, cnt_bound, stamps=None):
        from .split import SplitInfo

        _check_one_kernel_split(self, seg, go_left, parent_hist, sums2,
                                outs2, lows2, ups2, cnt_bound)
        work, B = self.work, self.num_bins
        if self._args is None:
            return one_kernel_split_planes_plain(
                work, seg, go_left, left_smaller, depth, parent_hist,
                self.meta, self.fmask, sums2, outs2, lows2, ups2, self.hp,
                num_bins=B, num_feat=self.num_feat, exact=self.exact,
                resident=self.resident)
        check_on_card(self._kernel.symbol, work, seg, go_left, parent_hist,
                      sums2, outs2, lows2, ups2)
        dev, F = work.device, self.num_feat
        hists = torch.empty((2, F, B, 3), dtype=torch.float32, device=dev)
        lt = torch.empty(1, dtype=torch.int32, device=dev)
        fout = torch.empty(18, dtype=torch.float32, device=dev)
        iout = torch.empty(6, dtype=torch.int64, device=dev)
        bout = torch.empty(2 + 2 * B, dtype=torch.bool, device=dev)
        fo, io, bo = fout.data_ptr(), iout.data_ptr(), bout.data_ptr()
        a = self._args
        a.seg, a.table = seg.data_ptr(), go_left.data_ptr()
        a.parent, a.sums2 = parent_hist.data_ptr(), sums2.data_ptr()
        a.outs2, a.lows2, a.ups2 = (outs2.data_ptr(), lows2.data_ptr(),
                                    ups2.data_ptr())
        a.lt = lt.data_ptr()
        a.hist_left = hists.data_ptr()
        a.hist_right = a.hist_left + 4 * F * B * 3
        a.gain, a.left_sum, a.right_sum = fo, fo + 8, fo + 32
        a.left_output, a.right_output = fo + 56, fo + 64
        a.feature, a.bin, a.kind = io, io + 16, io + 32
        a.default_left, a.go_left = bo, bo + 2
        a.left_smaller, a.depth = int(bool(left_smaller)), int(depth)
        if stamps is not None:
            check_on_card(self._kernel.symbol, work, stamps)
            if stamps.dtype != torch.int64 or stamps.shape != (
                    ONE_KERNEL_MAX_GRID, ONE_KERNEL_STAMP_SLOTS):
                raise ValueError("one_kernel_split_planes: stamps must be "
                                 "a stamp_buffer()")
        a.stamps = 0 if stamps is None else stamps.data_ptr()
        self._kernel.launch(ctypes.addressof(a), stream_of(work))
        infos = SplitInfo(
            gain=fout[0:2], feature=iout[0:2], bin=iout[2:4], kind=iout[4:6],
            default_left=bout[0:2], go_left=bout[2:].view(2, B),
            left_sum=fout[2:8].view(2, 3), right_sum=fout[8:14].view(2, 3),
            left_output=fout[14:16], right_output=fout[16:18])
        return lt, hists[0], hists[1], infos


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
    if hp.use_cegb or hp.mono_intermediate or hp.mono_advanced:
        raise ValueError("%s: CEGB and intermediate/advanced monotone "
                         "constraints are not inputs of the kernel" % name)


def _check_one_kernel_split(op, seg, go_left, parent_hist, sums2, outs2,
                            lows2, ups2, cnt_bound) -> None:
    """What a one-kernel split takes for one split."""
    name = "one_kernel_split_planes"
    F, B = op.num_feat, op.num_bins
    _check_partition_args(name, op.work, seg, go_left)
    if go_left.numel() != B:
        raise ValueError("%s: needs a (%d,) table, got %d"
                         % (name, B, go_left.numel()))
    if parent_hist.shape != (F, B, 3) or parent_hist.dtype != torch.float32:
        raise ValueError("%s: parent_hist must be (%d, %d, 3) f32, got %s %s"
                         % (name, F, B, tuple(parent_hist.shape),
                            parent_hist.dtype))
    if sums2.shape != (2, 3) or sums2.dtype != torch.float32:
        raise ValueError("%s: sums2 must be (2, 3) f32" % name)
    for field, t in (("outs2", outs2), ("lows2", lows2), ("ups2", ups2)):
        if t.shape != (2,) or t.dtype != torch.float32:
            raise ValueError("%s: %s must be (2,) f32" % (name, field))
    if int(cnt_bound) > op.cnt_max:
        raise ValueError("%s: cnt_bound %d above the %d rows the scratch "
                         "was sized for" % (name, cnt_bound, op.cnt_max))
