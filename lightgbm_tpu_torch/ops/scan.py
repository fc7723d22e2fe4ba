"""The split scan of a split's two children in one launch: the third
launch of the device tree loop's three-launch chain (``ops/chain.py``).

:class:`SplitScan` computes what :func:`ops.split.find_best_split` computes
over a (2, F, B, 3) batch of child histograms, with the children's sums,
outputs and bounds from the split's pair row and the node depth from its
device header (``ops/partition.ONE_KERNEL_HDR``; a header whose live word
is 0 writes nothing), into the ``ops/partition.SplitOut`` buffers that the
split commit reads. On a CUDA tensor it launches ``csrc/split_scan.cu``,
the one-kernel split's phase C in torch's summation order on the card, so
its outputs equal ``find_best_split``'s there bit for bit; on a CPU tensor
its plain twin :func:`split_scan_plain` is ``find_best_split`` itself. The
JAX package runs this scan as XLA inside its ``lax.while_loop``; it has no
Pallas kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .kernels import CudaKernel, register, stream_of
from .partition import (HDR_WORDS, PAIR_WORDS, SplitOut, _hyper_fields,
                        check_on_card, check_scan_inputs, put_split_infos)

_P = ctypes.c_void_p
#: torch's op-by-op rounding: no contracted multiply-adds
SCAN_KERNEL = register(CudaKernel(
    "split_scan", "split_scan.cu", [_P, _P], flags=("-fmad=false",)))


class SplitScanArgs(ctypes.Structure):
    """The C struct ``SplitScanArgs`` of ``csrc/split_scan.cu`` (same
    fields, same order)."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "hists", "hdr", "num_bins", "movable", "missing_bin", "is_cat",
        "monotone", "penalty", "fmask", "sums2", "outs2", "lows2", "ups2",
        "done", "cand_gain", "cand_bin", "num_dl", "rank", "hist_left",
        "hist_right", "gain", "feature", "bin", "kind", "default_left",
        "go_left", "left_sum", "right_sum", "left_output",
        "right_output")] \
        + [(name, ctypes.c_int32) for name in (
            "F", "B", "max_cat_to_onehot", "has_categorical", "has_monotone",
            "use_mono_penalty")] \
        + [(name, ctypes.c_float) for name in (
            "lambda_l1", "lambda_l2", "two_l1", "l2_cat", "min_data_in_leaf",
            "min_sum_hessian", "min_gain_to_split", "max_delta_step",
            "cat_smooth", "cat_l2", "min_data_per_group", "path_smooth",
            "monotone_penalty", "max_cat_threshold")]


def split_scan_plain(hists, pair, hdr, out, meta, fmask, hp) -> None:
    """Plain twin of :class:`SplitScan`: ``find_best_split`` over the
    (2, F, B, 3) ``hists`` with the pair row's sums, outputs and bounds and
    the header's depth, written into ``out`` where the header is live (no
    host read)."""
    from .split import find_best_split

    w = hdr.to(torch.int64).unbind()
    infos = find_best_split(hists, pair[0:6].view(2, 3), meta, fmask, hp,
                            parent_output=pair[6:8], leaf_lower=pair[8:10],
                            leaf_upper=pair[10:12], node_depth=w[5])
    put_split_infos(out, infos, w[6] != 0)


class SplitScan:
    """The split scan over one learner's features: what stays fixed for a
    tree (``meta``, ``fmask``, ``hp``, the shapes) is checked once and, on
    the card, packed once into the C argument struct beside the scratch;
    each call fills in one split's pointers and launches 2F blocks."""

    def __init__(self, meta, fmask, hp, *, num_feat: int, num_bins: int,
                 device) -> None:
        check_scan_inputs("split_scan", meta, fmask, hp, num_bins, num_feat)
        self.meta, self.fmask, self.hp = meta, fmask, hp
        self.num_feat, self.num_bins = num_feat, num_bins
        self._args = None
        if torch.device(device).type == "cpu":
            return
        check_on_card("split_scan", fmask, *meta[:6])
        F, B = num_feat, num_bins
        i32 = torch.int32
        self._scratch = (
            torch.zeros(1, dtype=i32, device=device),              # ticket
            torch.empty((2, 2, 4, F), dtype=i32, device=device),   # gain|bin
            torch.empty((3, 2, F, B), dtype=torch.uint8,
                        device=device))                            # dl|rank
        done, cand, flags = self._scratch
        fl = flags.data_ptr()
        self._args = SplitScanArgs(
            num_bins=meta.num_bins.data_ptr(),
            movable=meta.movable_missing.data_ptr(),
            missing_bin=meta.missing_bin.data_ptr(),
            is_cat=meta.is_categorical.data_ptr(),
            monotone=meta.monotone.data_ptr(),
            penalty=meta.penalty.data_ptr(), fmask=fmask.data_ptr(),
            done=done.data_ptr(), cand_gain=cand.data_ptr(),
            cand_bin=cand.data_ptr() + 4 * 8 * F, num_dl=fl,
            rank=fl + 2 * F * B, F=F, B=B, **_hyper_fields(hp))

    def __call__(self, hists: torch.Tensor, pair: torch.Tensor,
                 hdr: torch.Tensor, out: SplitOut) -> None:
        """Scan the (2, F, B, 3) f32 ``hists`` (left child, right child)
        with the (12,) f32 ``pair`` row and the (8,) i32 header ``hdr``;
        the results go into ``out``'s fout / iout / bout."""
        F, B = self.num_feat, self.num_bins
        if hists.dtype != torch.float32 or hists.shape != (2, F, B, 3) \
                or not hists.is_contiguous():
            raise ValueError("split_scan: hists must be contiguous (2, %d, "
                             "%d, 3) f32" % (F, B))
        if pair.dtype != torch.float32 or pair.shape != (PAIR_WORDS,):
            raise ValueError("split_scan: pair must be (%d,) f32"
                             % PAIR_WORDS)
        if hdr.dtype != torch.int32 or hdr.shape != (HDR_WORDS,):
            raise ValueError("split_scan: hdr must be (%d,) int32"
                             % HDR_WORDS)
        if out.bout.shape != (2 + 2 * B,):
            raise ValueError("split_scan: out.bout must be (%d,) bool"
                             % (2 + 2 * B))
        if self._args is None:
            split_scan_plain(hists, pair, hdr, out, self.meta, self.fmask,
                             self.hp)
            return
        check_on_card("split_scan", hists, pair, hdr, out.fout, out.iout,
                      out.bout)
        a = self._args
        hp_ = hists.data_ptr()
        pp = pair.data_ptr()
        fo, io, bo = (out.fout.data_ptr(), out.iout.data_ptr(),
                      out.bout.data_ptr())
        a.hists, a.hist_left, a.hist_right = hp_, hp_, hp_ + 4 * F * B * 3
        a.hdr = hdr.data_ptr()
        a.sums2, a.outs2, a.lows2, a.ups2 = pp, pp + 24, pp + 32, pp + 40
        a.gain, a.left_sum, a.right_sum = fo, fo + 8, fo + 32
        a.left_output, a.right_output = fo + 56, fo + 64
        a.feature, a.bin, a.kind = io, io + 16, io + 32
        a.default_left, a.go_left = bo, bo + 2
        SCAN_KERNEL.launch(ctypes.addressof(a), stream_of(hists))

