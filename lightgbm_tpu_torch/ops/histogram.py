"""Segment histograms on the planes work layout (PyTorch port of the planes
part of ``lightgbm_tpu/ops/histogram.py``).

A histogram is ``(F, B, 3)`` float32 of (sum_grad, sum_hess, count) per
feature bin, over the rows of one leaf's contiguous segment of the work
buffer (ops/partition.py). :func:`segment_histogram` launches the
hand-written kernel ``csrc/segment_histogram.cu`` on a CUDA tensor
(replacing the TPU kernel ``hist_pallas_segment_planes``) and runs
:func:`segment_histogram_plain` on a CPU tensor.

Per-row numerics are the TPU kernel's. In ``exact`` mode (the default,
``tpu_hist_precision=hilo``) g and h each contribute
``bf16(x)`` and ``bf16(x - bf16(x))`` (round to nearest even), summed in
two separate f32 channels that are added at the end (:func:`combine`); the
count contributes ``bf16(cnt)``. In ``bf16`` mode each channel contributes
``bf16(x)``. The port therefore differs from the JAX package only in the
order of the f32 sums; the count channel is exact. The plain twin sums in
float64, so it is the correctly rounded sum of the same per-row values,
and the kernel's f32 sums are held to it within :func:`sum_error_bound`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .kernels import CudaKernel, register, stream_of
from .partition import unpack_ghc_planes

_P = ctypes.c_void_p
_I = ctypes.c_int
HIST_KERNEL = register(CudaKernel(
    "segment_histogram", "segment_histogram.cu",
    [_P, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P]))

#: rows a histogram block takes per tile, and the most row blocks a launch
#: uses (each writes one partial histogram that the second pass sums)
HIST_TILE = 1024
HIST_MAX_ROW_BLOCKS = 128
#: features one histogram block keeps in shared memory (one warp each)
HIST_MAX_FEATS_PER_BLOCK = 16


def build_histogram_np(bins: np.ndarray, ghc: np.ndarray,
                       num_bins: int) -> np.ndarray:
    """Host f64 oracle: (N, F) bins + (N, C) channels -> (F, B, C) f32."""
    n, num_feat = bins.shape
    c = ghc.shape[1]
    out = np.zeros((num_feat, num_bins, c), dtype=np.float64)
    for f in range(num_feat):
        for ch in range(c):
            out[f, :, ch] = np.bincount(bins[:, f], weights=ghc[:, ch],
                                        minlength=num_bins)
    return out.astype(np.float32)


def channels(ghc_t: torch.Tensor, exact: bool) -> torch.Tensor:
    """(3, C) f32 g/h/cnt -> the per-row contributions: (5, C) hi/lo pairs
    for g and h plus cnt in exact mode, (3, C) in bf16 mode (each value
    rounded through bfloat16, round to nearest even)."""
    def bf(x):
        return x.to(torch.bfloat16).to(torch.float32)

    if not exact:
        return bf(ghc_t)
    g, h, c = ghc_t[0], ghc_t[1], ghc_t[2]
    g_hi, h_hi = bf(g), bf(h)
    return torch.stack([g_hi, bf(g - g_hi), h_hi, bf(h - h_hi), bf(c)])


def combine(acc: torch.Tensor, exact: bool) -> torch.Tensor:
    """(F, B, NCH) channel sums -> (F, B, 3): hi + lo per g and h."""
    if exact:
        return torch.stack([acc[..., 0] + acc[..., 1],
                            acc[..., 2] + acc[..., 3], acc[..., 4]], dim=-1)
    return acc


def segment_histogram_plain(work: torch.Tensor, seg: torch.Tensor, *,
                            num_bins: int, num_feat: int,
                            exact: bool = True) -> torch.Tensor:
    """Plain torch twin: per-feature ``index_add_`` of the segment's
    per-row channel contributions (rounded exactly as the kernel rounds
    them) into (B, NCH) float64 sums, returned as f32: the correctly
    rounded sum that the kernel's f32 sums are held to."""
    plane, start, cnt = (int(v) for v in seg.tolist())
    cols = work[plane, :, start:start + cnt]
    ch = channels(unpack_ghc_planes(cols, num_feat), exact).t() \
        .to(torch.float64)                                          # (C, NCH)
    acc = torch.zeros((num_feat, num_bins, ch.shape[1]), dtype=torch.float64,
                      device=work.device)
    for f in range(num_feat):
        acc[f].index_add_(0, cols[f].long(), ch)
    return combine(acc, exact).to(torch.float32)


def sum_error_bound(cnt: int) -> float:
    """Relative bound, against a bin's sum of |x|, on the error of the
    kernel's f32 sums over a ``cnt``-row segment: each row block adds its
    rows one by one (at most ``m`` of them), then the row blocks' partials
    are added in order, so |err| <= (m + row_blocks + 2) * 2^-24 * sum|x|
    (hi and lo channels each, combined once)."""
    row_blocks = max(1, min(HIST_MAX_ROW_BLOCKS, -(-int(cnt) // HIST_TILE)))
    tiles = -(-int(cnt) // HIST_TILE)
    m = -(-tiles // row_blocks) * HIST_TILE
    return (m + row_blocks + 2) * 2.0 ** -24


def segment_histogram(work: torch.Tensor, seg: torch.Tensor, *,
                      num_bins: int, num_feat: int, exact: bool = True,
                      cnt_bound: int) -> torch.Tensor:
    """(F, num_bins, 3) f32 histogram of lanes ``[start, start + cnt)`` of
    plane ``plane`` of ``work`` (2, W, Npad) u8.

    ``seg`` is a (3,) i32 tensor ``[plane, start, cnt]`` on ``work``'s
    device and ``cnt_bound`` a host int >= cnt that sizes the grid. The
    kernel's result is bit-identical run to run (fixed summation order,
    no float atomics)."""
    if work.dim() != 3 or work.shape[0] != 2 or work.dtype != torch.uint8:
        raise ValueError("segment_histogram: work must be (2, W, Npad) u8, "
                         "got %s %s" % (tuple(work.shape), work.dtype))
    if seg.dtype != torch.int32 or seg.numel() != 3:
        raise ValueError("segment_histogram: seg must be 3 int32")
    if not 0 < num_feat <= work.shape[1] - 12 or not 0 < num_bins <= 256:
        raise ValueError("segment_histogram: num_feat %d / num_bins %d do "
                         "not fit a %d-plane u8 work buffer"
                         % (num_feat, num_bins, work.shape[1]))
    if work.device.type == "cpu":
        return segment_histogram_plain(work, seg, num_bins=num_bins,
                                       num_feat=num_feat, exact=exact)
    if work.device.type != "cuda":
        raise RuntimeError("segment_histogram: no kernel for device %s"
                           % work.device)
    if seg.device != work.device:
        raise ValueError("segment_histogram: seg is on %s, work on %s"
                         % (seg.device, work.device))
    if not (work.is_contiguous() and seg.is_contiguous()):
        raise ValueError("segment_histogram: inputs must be contiguous")
    nch = 5 if exact else 3
    row_blocks = max(1, min(HIST_MAX_ROW_BLOCKS,
                            -(-int(cnt_bound) // HIST_TILE)))
    partial = torch.empty((row_blocks, num_feat, num_bins, nch),
                          dtype=torch.float32, device=work.device)
    out = torch.empty((num_feat, num_bins, 3), dtype=torch.float32,
                      device=work.device)
    HIST_KERNEL.launch(work.data_ptr(), work.shape[1], work.shape[2],
                       seg.data_ptr(), num_feat, num_bins, int(exact),
                       row_blocks, partial.data_ptr(), out.data_ptr(),
                       stream_of(work))
    return out
