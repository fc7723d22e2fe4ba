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
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .kernels import CudaKernel, register, stream_of

GH_BYTES = 12      # g, h, cnt as f32 bytes
GH_BYTES_Q = 3     # quantized: int8 g, int8 h, u8 cnt
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


def work_spec(num_groups: int, quantized: bool = False) -> Tuple[int, int]:
    """(guard rows, packed row width W) of the work buffer; W is the
    plane count of the planes layout and the row width of the rows
    layout."""
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
    planes layout, (2, Npad, W) on the rows layout."""
    guard, width = work_spec(num_groups, quantized)
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
