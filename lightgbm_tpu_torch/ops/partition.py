"""Leaf-contiguous row partition on the planes work layout (PyTorch port of
the planes part of ``lightgbm_tpu/ops/partition.py``).

Rows are kept physically grouped by leaf in a ping-pong pair of byte
planes, ``work`` of shape ``(2, W, Npad)`` u8:

    work[p][w, guard + i] = byte w of row i:  F bin bytes (bundle columns),
                            then g, h, cnt as little-endian f32 (12 bytes)

so a leaf's rows are one contiguous lane range ``[start, start + cnt)`` of
one plane, and a split writes the parent's segment into the other plane,
left child first. The layout is the JAX package's, byte for byte, except
that W is ``F + 12``: the TPU kernel pads W to a multiple of 32 sublanes,
which moves 64 planes instead of 40 at F = 28 and buys nothing on a GPU.

:func:`partition_segment` is the split. On a CUDA tensor it launches the
hand-written kernel ``csrc/partition_segment.cu`` (replacing the TPU kernel
``partition_segment_planes_fused``); on a CPU tensor it runs
:func:`partition_segment_plain`. The order is fixed and stable on both
sides (the TPU kernel leaves it unspecified): left rows ascending from
``start``, right rows ascending from ``start + lt``, so the kernel and the
twin agree byte for byte.

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
#: lanes of padding below and above the rows (row i sits at lane GUARD + i)
GUARD = 128
#: lanes per block of the partition kernel (its count and scatter tile)
PART_TILE = 4096

_P = ctypes.c_void_p
_I = ctypes.c_int
PARTITION_KERNEL = register(CudaKernel(
    "partition_segment", "partition_segment.cu",
    [_P, _I, _I, _P, _P, _I, _P, _P, _I, _P]))


def work_spec(num_groups: int) -> Tuple[int, int]:
    """(guard lanes, plane count W) of the planes work buffer."""
    return GUARD, num_groups + GH_BYTES


def planes_npad(n: int, guard: int = GUARD) -> int:
    """Lane count of the work buffer: rows plus both guards, in whole
    128-lane tiles."""
    return 128 * ((n + 2 * guard + 127) // 128)


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
    if work.dim() != 3 or work.shape[0] != 2 or work.dtype != torch.uint8:
        raise ValueError("partition_segment: work must be (2, W, Npad) u8, "
                         "got %s %s" % (tuple(work.shape), work.dtype))
    if seg.dtype != torch.int32 or seg.numel() != 4:
        raise ValueError("partition_segment: seg must be 4 int32")
    if table.dtype != torch.bool or table.dim() != 1 \
            or not 0 < table.numel() <= 256:
        raise ValueError("partition_segment: table must be (B,) bool with "
                         "B <= 256")
    if work.device.type == "cpu":
        return partition_segment_plain(work, seg, table)
    if work.device.type != "cuda":
        raise RuntimeError("partition_segment: no kernel for device %s"
                           % work.device)
    for name, t in (("seg", seg), ("table", table)):
        if t.device != work.device:
            raise ValueError("partition_segment: %s is on %s, work on %s"
                             % (name, t.device, work.device))
    if not (work.is_contiguous() and seg.is_contiguous()
            and table.is_contiguous()):
        raise ValueError("partition_segment: inputs must be contiguous")
    nblocks = max(1, -(-int(cnt_bound) // PART_TILE))
    scratch = torch.empty(nblocks, dtype=torch.int32, device=work.device)
    lt = torch.empty(1, dtype=torch.int32, device=work.device)
    PARTITION_KERNEL.launch(work.data_ptr(), work.shape[1], work.shape[2],
                            seg.data_ptr(), table.data_ptr(), table.numel(),
                            scratch.data_ptr(), lt.data_ptr(), nblocks,
                            stream_of(work))
    return lt
