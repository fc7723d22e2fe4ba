"""Segment histograms on the planes and rows work layouts (PyTorch port of
the segment histograms of ``lightgbm_tpu/ops/histogram.py``).

A histogram is ``(F, B, 3)`` float32 of (sum_grad, sum_hess, count) per
feature bin, over the rows of one leaf's contiguous segment of the work
buffer (ops/partition.py). Each wrapper launches a hand-written kernel on a
CUDA tensor and runs its plain twin on a CPU tensor:

- :func:`segment_histogram` (planes) and :func:`segment_histogram_rows`:
  ``csrc/segment_histogram.cu``, replacing the TPU kernels
  ``hist_pallas_segment_planes`` and ``hist_pallas_segment`` (and the f32
  mode of ``hist_mxu_segment``, which computes the same function);
- :func:`segment_histogram_resident`, the resident layout's gather
  histogram: ``csrc/segment_histogram.cu`` (entry point
  ``segment_histogram_resident``), replacing the JAX package's XLA
  ``hist16_segment_resident``. It gathers the bins from the resident
  planes through the slim rows' ridx and runs the planes kernel's body,
  so on the same rows in the same order it equals :func:`segment_histogram`
  bit for bit;
- :func:`segment_histogram_q`, int8 quantized rows:
  ``csrc/segment_histogram_q.cu`` (one cluster launch, sized by
  :func:`hist_q_plan`), replacing the quantized mode of
  ``hist_mxu_segment``. Its sums are integers, so the kernel, its twin and
  the JAX package's ``hist16_segment_q`` agree byte for byte.

The device tree loop's three-launch chain histograms the smaller child of
a split from its device header and left count with plans taken once for
the root (:class:`SegmentHistogram`; twin
:func:`segment_histogram_header_plain`, masked, with no host read).

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
from typing import NamedTuple

import numpy as np
import torch

from .kernels import CudaKernel, register, stream_of
from .partition import (GH_BYTES, GH_BYTES_Q, HDR_WORDS, RST_GH_OFF,
                        RST_ROUTE, SEG_PLAIN, SEG_SMALLER, check_on_card,
                        check_resident_args, decode_ridx, planes_view,
                        sm_count, unpack_ghc, unpack_ghc_planes, unpack_ghq)

_P = ctypes.c_void_p
_I = ctypes.c_int
_HIST_ARGS = [_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P]
HIST_KERNEL = register(CudaKernel(
    "segment_histogram", "segment_histogram.cu", _HIST_ARGS))
HIST_ROWS_KERNEL = register(CudaKernel(
    "segment_histogram_rows", "segment_histogram.cu", _HIST_ARGS))
HIST_RESIDENT_KERNEL = register(CudaKernel(
    "segment_histogram_resident", "segment_histogram.cu",
    [_P, _I, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P]))
HIST_Q_KERNEL = register(CudaKernel(
    "segment_histogram_q", "segment_histogram_q.cu",
    [_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]))

#: the f32 histograms' summation order (csrc/segment_hist.cuh): chunks of
#: HIST_CHUNK segment rows, each cut into HIST_SLICES slices of 32-row
#: steps (step q in slice q % HIST_SLICES); a slice adds its rows one by
#: one, a chunk adds its slices in order, the segment its chunks in order
HIST_CHUNK = 2048
HIST_SLICES = 4
#: int8 histogram (csrc/segment_histogram_q.cu): segment rows per row
#: block that size its grid, the blocks of one cluster (they merge their
#: histograms through distributed shared memory), the most row blocks
#: asked for across the feature groups (about a wave of one block per SM;
#: the entry point cuts the grid to the clusters the card runs at once),
#: the dynamic shared memory a block may take, and the warps of a block
#: and the 32-row steps each stages ahead (the kernel's kWarps, kRing)
HIST_Q_ROWS_PER_BLOCK = 512
HIST_Q_CLUSTER = 8
HIST_Q_MAX_ROW_BLOCKS = 128
HIST_Q_SMEM_BYTES = 224 * 1024
HIST_Q_WARPS = 16
HIST_Q_RING = 4
#: the largest segment whose int32 sums cannot overflow: 127 * N < 2^31
HIST_Q_MAX_ROWS = (2 ** 31 - 1) // 127
#: the f32 histogram's blocks an SM holds at once (512 threads, ~108 KB of
#: shared memory each) and the waves of them a static plan's grid spans
#: (the device tree loop's: its chunk rows stride over the segment's
#: chunks, so a deep leaf does not pay for a grid sized by the root)
HIST_BLOCKS_PER_SM = 2
HIST_STATIC_WAVES = 2


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


def _histogram_plain(bin_cols: torch.Tensor, ghc_t: torch.Tensor, *,
                     num_bins: int, exact: bool,
                     mask=None) -> torch.Tensor:
    """(F, C) bin codes + (3, C) f32 channels -> (F, B, 3) f32: each
    feature's ``index_add_`` of the per-row channel contributions (rounded
    exactly as the kernel rounds them) into float64 sums. With a (C,) bool
    ``mask`` the other columns contribute zeros to bin 0, which leaves
    every sum's bits as the masked columns alone give them."""
    ch = channels(ghc_t, exact).t().to(torch.float64)             # (C, NCH)
    bins = bin_cols.long()
    if mask is not None:
        zero = torch.zeros((), dtype=ch.dtype, device=ch.device)
        ch = torch.where(mask[:, None], ch, zero)
        bins = torch.where(mask[None, :], bins, zero.long())
    acc = torch.zeros((bin_cols.shape[0], num_bins, ch.shape[1]),
                      dtype=torch.float64, device=bin_cols.device)
    for f in range(bin_cols.shape[0]):
        acc[f].index_add_(0, bins[f], ch)
    return combine(acc, exact).to(torch.float32)


def segment_histogram_plain(work: torch.Tensor, seg: torch.Tensor, *,
                            num_bins: int, num_feat: int,
                            exact: bool = True) -> torch.Tensor:
    """Plain torch twin of the planes kernel: the correctly rounded sum
    of the segment's per-row contributions that the kernel's f32 sums are
    held to."""
    plane, start, cnt = (int(v) for v in seg.tolist())
    cols = work[plane, :, start:start + cnt]
    return _histogram_plain(cols[:num_feat], unpack_ghc_planes(cols, num_feat),
                            num_bins=num_bins, exact=exact)


def segment_histogram_rows_plain(work: torch.Tensor, seg: torch.Tensor, *,
                                 num_bins: int, num_feat: int,
                                 exact: bool = True) -> torch.Tensor:
    """Plain torch twin of the rows kernel (the planes twin's sums over the
    same rows)."""
    plane, start, cnt = (int(v) for v in seg.tolist())
    rows = work[plane, start:start + cnt]
    return _histogram_plain(rows[:, :num_feat].t(),
                            unpack_ghc(rows, num_feat).t(),
                            num_bins=num_bins, exact=exact)


def segment_histogram_resident_plain(work: torch.Tensor,
                                     resident: torch.Tensor,
                                     seg: torch.Tensor, *, num_bins: int,
                                     num_feat: int,
                                     exact: bool = True) -> torch.Tensor:
    """Plain torch twin of the resident kernel: the segment's ridx decoded
    (clamped to the resident planes), the bins gathered through it, then
    the planes twin's sums."""
    plane, start, cnt = (int(v) for v in seg.tolist())
    cols = work[plane, :, start:start + cnt]
    ridx = decode_ridx(cols[RST_ROUTE:RST_GH_OFF], resident.shape[1])
    return _histogram_plain(resident[:num_feat].index_select(1, ridx),
                            unpack_ghc_planes(cols, RST_GH_OFF),
                            num_bins=num_bins, exact=exact)


def hist_chunks(cnt: int) -> int:
    """Chunks of a ``cnt``-row segment in the kernels' summation order (a
    function of the count alone)."""
    return -(-int(cnt) // HIST_CHUNK)


def sum_error_bound(cnt: int) -> float:
    """Relative bound, against a bin's sum of |x|, on the error of the
    kernels' f32 sums over a ``cnt``-row segment. A row's value goes
    through at most ``m - 1`` adds in its slice (``m`` = the slice's rows,
    at most HIST_CHUNK / HIST_SLICES), ``HIST_SLICES - 1`` in its chunk's
    partial, one per chunk in the segment's sum and one in hi + lo, so
    |err| <= (m + HIST_SLICES + chunks + 2) * 2^-24 * sum|x|."""
    m = min(int(cnt), HIST_CHUNK // HIST_SLICES)
    return (m + HIST_SLICES + hist_chunks(cnt) + 2) * 2.0 ** -24


def segment_histogram(work: torch.Tensor, seg: torch.Tensor, *,
                      num_bins: int, num_feat: int, exact: bool = True,
                      cnt_bound: int) -> torch.Tensor:
    """(F, num_bins, 3) f32 histogram of lanes ``[start, start + cnt)`` of
    plane ``plane`` of ``work`` (2, W, Npad) u8.

    ``seg`` is a (3,) i32 tensor ``[plane, start, cnt]`` on ``work``'s
    device and ``cnt_bound`` a host int >= cnt that sizes the grid. The
    kernel's result is bit-identical run to run and for any ``cnt_bound``:
    its summation order depends on the segment's rows alone (no float
    atomics)."""
    _check_hist_args("segment_histogram", work, seg, num_bins, num_feat,
                     work.shape[1] - GH_BYTES)
    if work.device.type == "cpu":
        return segment_histogram_plain(work, seg, num_bins=num_bins,
                                       num_feat=num_feat, exact=exact)
    return _launch_histogram(HIST_KERNEL, work, seg, num_bins, num_feat,
                             exact, cnt_bound, rows=work.shape[2],
                             width=work.shape[1])


def segment_histogram_rows(work: torch.Tensor, seg: torch.Tensor, *,
                           num_bins: int, num_feat: int, exact: bool = True,
                           cnt_bound: int) -> torch.Tensor:
    """:func:`segment_histogram` on the rows layout, ``work`` (2, Npad, W)
    u8 with ``W = num_feat + 12``. The kernel runs the planes kernel's body
    (per-row rounding, summation order), so on the same rows in the same
    order its result equals the planes kernel's, bit for bit."""
    _check_hist_args("segment_histogram_rows", work, seg, num_bins, num_feat,
                     work.shape[2] - GH_BYTES)
    if work.device.type == "cpu":
        return segment_histogram_rows_plain(work, seg, num_bins=num_bins,
                                            num_feat=num_feat, exact=exact)
    return _launch_histogram(HIST_ROWS_KERNEL, work, seg, num_bins, num_feat,
                             exact, cnt_bound, rows=work.shape[1],
                             width=work.shape[2])


def segment_histogram_resident(work: torch.Tensor, resident: torch.Tensor,
                               seg: torch.Tensor, *, num_bins: int,
                               num_feat: int, exact: bool = True,
                               cnt_bound: int) -> torch.Tensor:
    """:func:`segment_histogram` on the resident layout: ``work`` is the
    slim pair (2, RST_WIDTH, Npad) u8 (ops/partition.py), ``resident`` the
    (>= num_feat, Npad_res) u8 resident bin planes; bin f of a segment row
    is ``resident[f, ridx]``. ``seg`` and ``cnt_bound`` as in
    :func:`segment_histogram`. The kernel runs the planes kernel's body
    (per-row rounding, summation order), so on the same rows in the same
    order it equals the planes kernel bit for bit."""
    check_resident_args("segment_histogram_resident", work, resident)
    _check_hist_args("segment_histogram_resident", work, seg, num_bins,
                     num_feat, resident.shape[0])
    if work.device.type == "cpu":
        return segment_histogram_resident_plain(
            work, resident, seg, num_bins=num_bins, num_feat=num_feat,
            exact=exact)
    check_on_card("segment_histogram_resident", work, seg, resident)
    chunks, partial, out = _hist_scratch(work, num_bins, num_feat, exact,
                                         cnt_bound)
    HIST_RESIDENT_KERNEL.launch(
        work.data_ptr(), work.shape[1], work.shape[2], seg.data_ptr(), None,
        SEG_PLAIN, resident.data_ptr(), resident.shape[1], num_feat,
        num_bins, int(exact), chunks, partial.data_ptr(), out.data_ptr(),
        stream_of(work))
    return out


def _check_hist_args(name: str, work: torch.Tensor, seg: torch.Tensor,
                     num_bins: int, num_feat: int, max_feat: int) -> None:
    if work.dim() != 3 or work.shape[0] != 2 or work.dtype != torch.uint8:
        raise ValueError("%s: work must be a (2, ., .) u8 pair, got %s %s"
                         % (name, tuple(work.shape), work.dtype))
    if seg.dtype != torch.int32 or seg.numel() != 3:
        raise ValueError("%s: seg must be 3 int32" % name)
    if not 0 < num_feat <= max_feat or not 0 < num_bins <= 256:
        raise ValueError("%s: num_feat %d / num_bins %d do not fit a u8 work "
                         "buffer of shape %s" % (name, num_feat, num_bins,
                                                 tuple(work.shape)))


def _launch_histogram(kernel: CudaKernel, work: torch.Tensor,
                      seg: torch.Tensor, num_bins: int, num_feat: int,
                      exact: bool, cnt_bound: int, *, rows: int,
                      width: int) -> torch.Tensor:
    check_on_card(kernel.symbol, work, seg)
    chunks, partial, out = _hist_scratch(work, num_bins, num_feat, exact,
                                         cnt_bound)
    kernel.launch(work.data_ptr(), width, rows, seg.data_ptr(), None,
                  SEG_PLAIN, num_feat, num_bins, int(exact), chunks,
                  partial.data_ptr(), out.data_ptr(), stream_of(work))
    return out


def _hist_scratch(work, num_bins, num_feat, exact, cnt_bound):
    """The grid's chunk count (from the host bound; the kernel reads the
    true count on the card and skips the rest), the (chunks, F, B, NCH)
    partials and the (F, B, 3) output of one f32 histogram launch."""
    chunks = max(1, hist_chunks(cnt_bound))
    partial = torch.empty((chunks, num_feat, num_bins, 5 if exact else 3),
                          dtype=torch.float32, device=work.device)
    out = torch.empty((num_feat, num_bins, 3), dtype=torch.float32,
                      device=work.device)
    return chunks, partial, out


# ---------------------------------------------------------------- int8 rows

def dequant_scale(scales: torch.Tensor) -> torch.Tensor:
    """(2,) f32 ``[gscale, hscale]`` -> the (3,) f32 dequantization
    ``[1 / gscale, 1 / hscale, 1]`` (hist16_segment_q's, in f32)."""
    s = scales.to(torch.float32)
    return torch.cat([torch.div(torch.ones_like(s), s),
                      torch.ones(1, dtype=torch.float32, device=s.device)])


def segment_histogram_q_plain(work: torch.Tensor, seg: torch.Tensor,
                              scale: torch.Tensor, *, num_bins: int,
                              num_feat: int) -> torch.Tensor:
    """Plain torch twin of the int8 kernel: per-feature int64
    ``index_add_`` of the int8 g, int8 h and u8 cnt, cast to int32, then
    ``float(sum) * scale``."""
    plane, start, cnt = (int(v) for v in seg.tolist())
    return histogram_q_rows_plain(work[plane, start:start + cnt], scale,
                                  num_bins=num_bins, num_feat=num_feat)


def histogram_q_rows_plain(rows: torch.Tensor, scale: torch.Tensor, *,
                           num_bins: int, num_feat: int) -> torch.Tensor:
    """(C, F + 3) quantized rows -> their dequantized (F, B, 3) f32
    histogram: per-feature int64 ``index_add_`` of the int8 g, int8 h and
    u8 cnt, cast to int32, then ``float(sum) * scale``."""
    gq, hq, cq = unpack_ghq(rows, num_feat)
    ch = torch.stack([gq.long(), hq.long(), cq.long()], dim=1)    # (C, 3)
    acc = torch.zeros((num_feat, num_bins, 3), dtype=torch.int64,
                      device=rows.device)
    for f in range(num_feat):
        acc[f].index_add_(0, rows[:, f].long(), ch)
    return acc.to(torch.int32).to(torch.float32) * scale


def segment_histogram_q(work: torch.Tensor, seg: torch.Tensor,
                        scale: torch.Tensor, *, num_bins: int, num_feat: int,
                        cnt_bound: int) -> torch.Tensor:
    """(F, num_bins, 3) f32 dequantized histogram of rows ``[start, start +
    cnt)`` of buffer ``plane`` of the quantized rows pair ``work``
    (2, Npad, F + 3) u8 (ops/partition.pack_rows_quantized). ``scale`` is
    the (3,) f32 :func:`dequant_scale`; ``seg`` and ``cnt_bound`` as in
    :func:`segment_histogram`. Segments over :data:`HIST_Q_MAX_ROWS` rows
    are refused: their int32 sums could overflow."""
    _check_hist_args("segment_histogram_q", work, seg, num_bins, num_feat,
                     work.shape[2] - GH_BYTES_Q)
    if scale.dtype != torch.float32 or scale.numel() != 3:
        raise ValueError("segment_histogram_q: scale must be 3 float32")
    if int(cnt_bound) > HIST_Q_MAX_ROWS:
        raise ValueError("segment_histogram_q: %d rows could overflow the "
                         "int32 sums (at most %d)"
                         % (int(cnt_bound), HIST_Q_MAX_ROWS))
    if work.device.type == "cpu":
        return segment_histogram_q_plain(work, seg, scale, num_bins=num_bins,
                                         num_feat=num_feat)
    check_on_card("segment_histogram_q", work, seg, scale)
    plan = hist_q_plan(cnt_bound, num_feat, num_bins)
    stream = stream_of(work)
    acc, ticket = _hist_q_scratch(work.device, stream, plan.acc_ints)
    out = torch.empty((num_feat, num_bins, 3), dtype=torch.float32,
                      device=work.device)
    HIST_Q_KERNEL.launch(work.data_ptr(), work.shape[2], work.shape[1],
                         seg.data_ptr(), None, SEG_PLAIN, num_feat, num_bins,
                         plan.feats_per_block, plan.row_blocks, plan.cluster,
                         int(plan.staged), scale.data_ptr(), acc.data_ptr(),
                         ticket.data_ptr(), out.data_ptr(), stream)
    return out


class HistQPlan(NamedTuple):
    """The launch of one int8 histogram (csrc/segment_histogram_q.cu)."""
    feats_per_block: int  # features of one block's shared histogram
    groups: int           # feature groups (grid.y)
    row_blocks: int       # row blocks (grid.x), a multiple of cluster
    cluster: int          # blocks per cluster
    staged: bool          # rows staged through shared memory
    smem_bytes: int       # dynamic shared memory of a block
    acc_ints: int         # the int32 accumulator the launch needs


def hist_q_plan(cnt_bound: int, num_feat: int, num_bins: int) -> HistQPlan:
    """Size an int8 histogram of up to ``cnt_bound`` rows of ``num_feat``
    bin bytes. A block holds the int32 (nfb, B, 3) histogram of as many
    features as fit HIST_Q_SMEM_BYTES beside its warps' staging ring (the
    ring only when it takes at most half of the budget; wider rows are
    read in place); a row block per HIST_Q_ROWS_PER_BLOCK rows, at most
    HIST_Q_MAX_ROW_BLOCKS across the feature groups and at least one
    cluster, rounded up to whole clusters (below HIST_Q_CLUSTER blocks, a
    power of two)."""
    width = num_feat + GH_BYTES_Q
    ring = HIST_Q_WARPS * HIST_Q_RING * ((32 * width + 31) // 16 * 16)
    staged = ring <= HIST_Q_SMEM_BYTES // 2
    if not staged:
        ring = 0
    nfb = max(1, min(num_feat,
                     (HIST_Q_SMEM_BYTES - ring - 16) // (num_bins * 12)))
    smem = (nfb * num_bins * 12 + 15) // 16 * 16 + ring
    groups = -(-num_feat // nfb)
    want = max(1, -(-int(cnt_bound) // HIST_Q_ROWS_PER_BLOCK))
    most = max(HIST_Q_CLUSTER,
               HIST_Q_MAX_ROW_BLOCKS // groups // HIST_Q_CLUSTER
               * HIST_Q_CLUSTER)
    want = min(want, most)
    if want < HIST_Q_CLUSTER:
        cluster = 1 << (want - 1).bit_length()
        blocks = cluster
    else:
        cluster = HIST_Q_CLUSTER
        blocks = -(-want // cluster) * cluster
    return HistQPlan(nfb, groups, blocks, cluster, staged, smem,
                     num_feat * num_bins * 3)


#: (device, stream) -> (int32 accumulator, u32 ticket), both zero between
#: launches: the kernel's last block zeroes them
_HIST_Q_SCRATCH = {}


def _hist_q_scratch(device, stream: int, ints: int):
    """The int8 histogram's kept accumulator and ticket for launches on
    ``stream`` of ``device``, grown (zeroed) when a launch needs more.
    Launches on one stream run in order, so they share them safely."""
    key = (device.index, stream)
    kept = _HIST_Q_SCRATCH.get(key)
    if kept is None or kept[0].numel() < ints:
        kept = (torch.zeros(ints, dtype=torch.int32, device=device),
                torch.zeros(1, dtype=torch.int32, device=device))
        _HIST_Q_SCRATCH[key] = kept
    return kept


# ------------------------------------------- the device tree loop's K4 / K5

def segment_histogram_header_plain(work: torch.Tensor, hdr: torch.Tensor,
                                   lt: torch.Tensor, *, num_bins: int,
                                   num_feat: int, exact: bool = True,
                                   layout: str = "planes", resident=None,
                                   scale=None, lanes=None) -> torch.Tensor:
    """Plain twin of a histogram of the smaller child of a split
    (SEG_SMALLER) from its (8,) header and (1,) left count ``lt``, over
    whole planes under a mask: lanes outside the child contribute zeros to
    bin 0, which leaves every float64 (and integer) sum as the child's rows
    alone give it, so the result equals the slicing twins' bit for bit
    with no host read. A dead header gives zeros. ``layout`` is
    ``planes`` (``resident`` given: the resident gather), ``rows`` or
    ``int8`` (the quantized rows pair; ``scale`` the (3,) dequantization).
    ``lanes`` (host ``(lo, hi)`` holding the segment) limits the work to
    those lanes."""
    dev = work.device
    src, start, cnt, _, ls, _, live, _ = hdr.to(torch.int64).unbind()
    n = lt.to(torch.int64).reshape(-1)[0]
    ls = ls != 0
    view = planes_view(work, layout in ("rows", "int8"))
    lo, hi = lanes if lanes is not None else (0, view.shape[2])
    view = view[:, :, lo:hi]
    lane = torch.arange(lo, hi, dtype=torch.int64, device=dev)
    s_start = torch.where(ls, start, start + n)
    s_cnt = torch.where(ls, n, cnt - n)
    mask = (lane >= s_start) & (lane < s_start + s_cnt) & (live != 0)
    cols = view.index_select(0, (1 - src).reshape(1))[0]
    if layout == "int8":
        g = cols[num_feat].view(torch.int8).long()
        h = cols[num_feat + 1].view(torch.int8).long()
        c = cols[num_feat + 2].long()
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        ch = torch.where(mask[:, None], torch.stack([g, h, c], dim=1), zero)
        bins = torch.where(mask[None, :], cols[:num_feat].long(), zero)
        acc = torch.zeros((num_feat, num_bins, 3), dtype=torch.int64,
                          device=dev)
        for f in range(num_feat):
            acc[f].index_add_(0, bins[f], ch)
        return acc.to(torch.int32).to(torch.float32) * scale
    if resident is not None:
        ridx = decode_ridx(cols[RST_ROUTE:RST_GH_OFF], resident.shape[1])
        bin_cols = resident[:num_feat].index_select(1, ridx)
        ghc_t = unpack_ghc_planes(cols, RST_GH_OFF)
    else:
        bin_cols = cols[:num_feat]
        ghc_t = unpack_ghc_planes(cols, num_feat)
    return _histogram_plain(bin_cols, ghc_t, num_bins=num_bins, exact=exact,
                            mask=mask)


class SegmentHistogram:
    """The smaller child's histogram in the device tree loop's three-launch
    chain (``ops/chain.ChainSplit``): K4 on the planes, rows or resident
    layout, or K5 on the int8 rows, launched per split on the split's
    device header and the partition's left count (SEG_SMALLER: the kernel
    derives the child's segment and reads the live word on the card; a dead
    header writes zeros). Planned once for children of up to ``cnt_max``
    rows (the root): K4's partials hold ``hist_chunks(cnt_max)`` chunks and
    its chunk rows stride over the child's true chunks on a grid of
    HIST_STATIC_WAVES waves; K5 takes :func:`hist_q_plan` at ``cnt_max`` and
    keeps its own accumulator and ticket. The output buffer is reused: each
    call returns the same (F, B, 3) tensor. The sums do not depend on the
    plan (K4's order is fixed by the rows, K5's are integers). On host
    tensors :func:`segment_histogram_header_plain`."""

    def __init__(self, work: torch.Tensor, *, layout: str, num_bins: int,
                 num_feat: int, exact: bool = True, cnt_max: int,
                 resident=None, scale=None):
        if layout not in ("planes", "resident", "rows", "int8"):
            raise ValueError("SegmentHistogram: layout %r" % layout)
        self.work, self.layout = work, layout
        self.num_bins, self.num_feat, self.exact = num_bins, num_feat, exact
        self.resident, self.scale = resident, scale
        self.cnt_max = max(1, int(cnt_max))
        if layout == "int8":
            if scale is None or scale.dtype != torch.float32 \
                    or scale.numel() != 3:
                raise ValueError("SegmentHistogram: int8 needs a (3,) f32 "
                                 "scale")
            if self.cnt_max > HIST_Q_MAX_ROWS:
                raise ValueError("SegmentHistogram: %d rows could overflow "
                                 "the int32 sums" % self.cnt_max)
        if layout == "resident":
            check_resident_args("segment_histogram_resident", work, resident)
        self.out = torch.zeros((num_feat, num_bins, 3), dtype=torch.float32,
                               device=work.device)
        if work.device.type == "cpu":
            return
        dev = work.device
        extra = tuple(t for t in (resident, scale) if t is not None)
        check_on_card("segment_histogram", work, *extra)
        if layout == "int8":
            self.plan = hist_q_plan(self.cnt_max, num_feat, num_bins)
            self.acc = torch.zeros(self.plan.acc_ints, dtype=torch.int32,
                                   device=dev)
            self.ticket = torch.zeros(1, dtype=torch.int32, device=dev)
            return
        chunks = max(1, hist_chunks(self.cnt_max))
        self.partial = torch.empty((chunks, num_feat, num_bins,
                                    5 if exact else 3),
                                   dtype=torch.float32, device=dev)
        groups = -(-num_feat // 4)     # segment_histogram.cu kHistFeats
        waves = HIST_STATIC_WAVES * HIST_BLOCKS_PER_SM * sm_count(dev.index)
        self.grid_chunks = max(1, min(chunks, waves // groups))

    def __call__(self, hdr: torch.Tensor, lt: torch.Tensor) -> torch.Tensor:
        """The (F, B, 3) f32 histogram of the smaller child of the split
        whose (8,) i32 header is ``hdr`` and (1,) i32 left count ``lt``."""
        if hdr.dtype != torch.int32 or hdr.shape != (HDR_WORDS,):
            raise ValueError("segment histogram: hdr must be (%d,) int32"
                             % HDR_WORDS)
        if lt.dtype != torch.int32 or lt.numel() != 1:
            raise ValueError("segment histogram: lt must be one int32")
        work, F, B = self.work, self.num_feat, self.num_bins
        if work.device.type == "cpu":
            self.out.copy_(segment_histogram_header_plain(
                work, hdr, lt, num_bins=B, num_feat=F, exact=self.exact,
                layout="planes" if self.layout == "resident" else self.layout,
                resident=self.resident, scale=self.scale))
            return self.out
        check_on_card("segment_histogram", work, hdr, lt)
        stream = stream_of(work)
        if self.layout == "int8":
            p = self.plan
            HIST_Q_KERNEL.launch(
                work.data_ptr(), work.shape[2], work.shape[1], hdr.data_ptr(),
                lt.data_ptr(), SEG_SMALLER, F, B, p.feats_per_block,
                p.row_blocks, p.cluster, int(p.staged), self.scale.data_ptr(),
                self.acc.data_ptr(), self.ticket.data_ptr(),
                self.out.data_ptr(), stream)
        elif self.layout == "resident":
            HIST_RESIDENT_KERNEL.launch(
                work.data_ptr(), work.shape[1], work.shape[2], hdr.data_ptr(),
                lt.data_ptr(), SEG_SMALLER, self.resident.data_ptr(),
                self.resident.shape[1], F, B, int(self.exact),
                self.grid_chunks, self.partial.data_ptr(),
                self.out.data_ptr(), stream)
        else:
            rows = self.layout == "rows"
            kernel = HIST_ROWS_KERNEL if rows else HIST_KERNEL
            width, n = (work.shape[2], work.shape[1]) if rows \
                else (work.shape[1], work.shape[2])
            kernel.launch(work.data_ptr(), width, n, hdr.data_ptr(),
                          lt.data_ptr(), SEG_SMALLER, F, B, int(self.exact),
                          self.grid_chunks, self.partial.data_ptr(),
                          self.out.data_ptr(), stream)
        return self.out
