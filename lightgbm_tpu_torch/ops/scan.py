"""The split scan of a split's two children in one launch: the third
launch of the device tree loop's three-launch chain (``ops/chain.py``),
and the scan of a forced split's leaf (:meth:`SplitScan.scan_leaf`).

:class:`SplitScan` computes what :func:`ops.split.find_best_split` computes
over a (2, F, B, 3) batch of child histograms, with the children's sums,
outputs and bounds from the split's pair row and the node depth from its
device header (``ops/partition.ONE_KERNEL_HDR``; a header whose live word
is 0 writes nothing), into the ``ops/partition.SplitOut`` buffers that the
split commit reads. Each child may carry its own inputs from
``ops/node.py`` (an ``ops/node.NodeBuf``: its search mask, extra-trees
threshold bins and CEGB penalties). On a CUDA tensor it launches ``csrc/split_scan.cu``,
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
                        check_on_card, check_scan_inputs, put_split_infos,
                        put_split_info0)

_P = ctypes.c_void_p
#: torch's op-by-op rounding: no contracted multiply-adds
SCAN_KERNEL = register(CudaKernel(
    "split_scan", "split_scan.cu", [_P, _P], flags=("-fmad=false",)))


class SplitScanArgs(ctypes.Structure):
    """The C struct ``SplitScanArgs`` of ``csrc/split_scan.cu`` (same
    fields, same order)."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "hists", "live", "depth", "num_bins", "movable", "missing_bin",
        "is_cat", "monotone", "penalty", "fmask", "rand_thr", "cegb",
        "sums2", "outs2", "lows2", "ups2", "adv",
        "done", "cand_gain", "cand_bin", "num_dl", "rank", "hist_left",
        "hist_right", "gain", "feature", "bin", "kind", "default_left",
        "go_left", "left_sum", "right_sum", "left_output",
        "right_output")] \
        + [(name, ctypes.c_int32) for name in (
            "F", "B", "max_cat_to_onehot", "has_categorical", "has_monotone",
            "use_mono_penalty", "mask_stride", "nodes")] \
        + [(name, ctypes.c_float) for name in (
            "lambda_l1", "lambda_l2", "two_l1", "l2_cat", "min_data_in_leaf",
            "min_sum_hessian", "min_gain_to_split", "max_delta_step",
            "cat_smooth", "cat_l2", "min_data_per_group", "path_smooth",
            "monotone_penalty", "max_cat_threshold")]


def split_scan_plain(hists, pair, hdr, out, meta, fmask, hp,
                     node=None, bounds=None) -> None:
    """Plain twin of :class:`SplitScan`: ``find_best_split`` over the
    (2, F, B, 3) ``hists`` with the pair row's sums, outputs and bounds,
    the header's depth, the children's ``node`` inputs (an
    ``ops/node.NodeBuf``, or None: ``fmask`` for both) and, for the
    advanced monotone method, the children's (2, 4, F, B) per-candidate
    ``bounds`` (``ops/monotone.mono_bounds``), written into ``out`` where
    the header is live (no host read)."""
    from .split import find_best_split

    w = hdr.to(torch.int64).unbind()
    mask, thr, delta = (fmask, None, None) if node is None \
        else node.rows(2)
    adv = None if bounds is None else tuple(bounds[:2].unbind(1))
    infos = find_best_split(hists, pair[0:6].view(2, 3), meta, mask, hp,
                            parent_output=pair[6:8], leaf_lower=pair[8:10],
                            leaf_upper=pair[10:12], node_depth=w[5],
                            rand_threshold=thr, cegb_delta=delta,
                            adv_bounds=adv)
    put_split_infos(out, infos, w[6] != 0)


def scan_leaf_info(hist, sums, outs, lows, ups, depth, mask, thr, meta,
                   hp, adv=None):
    """``find_best_split`` of one leaf (a forced split's: JAX
    ``pick_forced``) under the (F,) ``mask`` and threshold bins ``thr``,
    without CEGB, as an unbatched ``SplitInfo``; ``adv`` the leaf's four
    (F, B) per-candidate bounds (advanced monotone method) or None. It
    runs as a batch of two copies of the leaf: torch then sums the
    winner's bins in the order the split scan kernel follows on the card
    (a (2, B, 3) reduction), so the kernel's one-leaf scan is bit-equal to
    it there too."""
    from .split import SplitInfo, find_best_split

    if adv is not None:
        adv = tuple(torch.stack([a, a]) for a in adv)
    info = find_best_split(
        torch.stack([hist, hist]), torch.stack([sums.reshape(3)] * 2),
        meta, torch.stack([mask, mask]), hp,
        parent_output=outs.reshape(1).expand(2),
        leaf_lower=lows.reshape(1).expand(2),
        leaf_upper=ups.reshape(1).expand(2),
        node_depth=depth.reshape(-1)[0] if isinstance(depth, torch.Tensor)
        else depth, rand_threshold=torch.stack([thr, thr]),
        adv_bounds=adv)
    return SplitInfo(*(x[0] for x in info))


def scan_leaf_plain(hist, sums, outs, lows, ups, depth, live, mask, thr,
                    out, meta, hp, bounds=None) -> None:
    """Plain twin of :meth:`SplitScan.scan_leaf`: :func:`scan_leaf_info`
    into child 0 of ``out`` where ``live`` (``bounds`` node 0 of the
    per-candidate bounds, advanced monotone method)."""
    info = scan_leaf_info(hist, sums, outs, lows, ups, depth, mask, thr,
                          meta, hp, None if bounds is None
                          else tuple(bounds[0].unbind(0)))
    put_split_info0(out, info, live.reshape(-1)[0] != 0)


class SplitScan:
    """The split scan over one learner's features: what stays fixed for a
    tree (``meta``, ``fmask``, ``hp``, the shapes) is checked once and, on
    the card, packed once into the C argument struct beside the scratch;
    each call fills in one split's pointers and launches 2F blocks (F for
    :meth:`scan_leaf`). ``node``, an ``ops/node.NodeBuf`` (or None), holds
    the children's own masks, threshold bins and CEGB penalties, which
    every call reads. Under the advanced monotone method ``bounds``, a
    (2, 4, F, B) f32 buffer (``ops/monotone.mono_bounds``, node 0 the left
    child or the forced leaf), holds each candidate's child bounds, which
    every call reads; the intermediate method's bounds are the pair row's
    scalars, as the basic method's."""

    def __init__(self, meta, fmask, hp, *, num_feat: int, num_bins: int,
                 device, node=None, bounds=None) -> None:
        from .monotone import method_code

        check_scan_inputs("split_scan", meta, fmask, hp, num_bins, num_feat,
                          cegb_ok=True, mono_ok=True)
        if hp.use_cegb and (node is None or node.delta is None):
            raise ValueError("split_scan: CEGB needs the nodes' penalties "
                             "(an ops/node.NodeBuf with delta)")
        if (method_code(hp) == 2) != (bounds is not None):
            raise ValueError("split_scan: the advanced monotone method, and "
                             "only it, reads per-candidate bounds")
        if bounds is not None and (
                bounds.dtype != torch.float32 or not bounds.is_contiguous()
                or bounds.shape != (2, 4, num_feat, num_bins)):
            raise ValueError("split_scan: bounds must be contiguous (2, 4, "
                             "%d, %d) f32" % (num_feat, num_bins))
        self.meta, self.fmask, self.hp = meta, fmask, hp
        self.num_feat, self.num_bins = num_feat, num_bins
        self.node, self.bounds = node, bounds
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
            penalty=meta.penalty.data_ptr(),
            done=done.data_ptr(), cand_gain=cand.data_ptr(),
            cand_bin=cand.data_ptr() + 4 * 8 * F, num_dl=fl,
            rank=fl + 2 * F * B,
            adv=0 if bounds is None else bounds.data_ptr(), F=F, B=B,
            **_hyper_fields(hp))

    def _check_out(self, out: SplitOut) -> None:
        B = self.num_bins
        if out.bout.shape != (2 + 2 * B,):
            raise ValueError("split_scan: out.bout must be (%d,) bool"
                             % (2 + 2 * B))

    def _launch(self, hists, live, depth, sums, outs, lows, ups, masks,
                stride, thr, delta, out, nodes) -> None:
        F, B = self.num_feat, self.num_bins
        a = self._args
        hp_ = hists.data_ptr()
        fo, io, bo = (out.fout.data_ptr(), out.iout.data_ptr(),
                      out.bout.data_ptr())
        a.hists, a.hist_left, a.hist_right = hp_, hp_, hp_ + 4 * F * B * 3
        a.live, a.depth = live.data_ptr(), depth.data_ptr()
        a.sums2, a.outs2, a.lows2, a.ups2 = sums, outs, lows, ups
        a.fmask, a.mask_stride = masks.data_ptr(), stride
        a.rand_thr = 0 if thr is None else thr.data_ptr()
        a.cegb = 0 if delta is None else delta.data_ptr()
        a.nodes = nodes
        a.gain, a.left_sum, a.right_sum = fo, fo + 8, fo + 32
        a.left_output, a.right_output = fo + 56, fo + 64
        a.feature, a.bin, a.kind = io, io + 16, io + 32
        a.default_left, a.go_left = bo, bo + 2
        SCAN_KERNEL.launch(ctypes.addressof(a), stream_of(hists))

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
        self._check_out(out)
        if self._args is None:
            split_scan_plain(hists, pair, hdr, out, self.meta, self.fmask,
                             self.hp, self.node, self.bounds)
            return
        check_on_card("split_scan", hists, pair, hdr, out.fout, out.iout,
                      out.bout)
        node = self.node
        masks, stride, thr, delta = (self.fmask, 0, None, None) \
            if node is None else (node.mask, F, node.thr, node.delta)
        pp = pair.data_ptr()
        self._launch(hists, hdr[6:7], hdr[5:6], pp, pp + 24, pp + 32,
                     pp + 40, masks, stride, thr, delta, out, 2)

    def scan_leaf(self, hist: torch.Tensor, sums: torch.Tensor,
                  outs: torch.Tensor, lows: torch.Tensor, ups: torch.Tensor,
                  depth: torch.Tensor, live: torch.Tensor,
                  mask: torch.Tensor, thr: torch.Tensor,
                  out: SplitOut) -> None:
        """The scan of one leaf, a forced split's (JAX ``pick_forced``):
        the (1, F, B, 3) f32 ``hist``, its (3,) ``sums``, (1,) output and
        bounds, (1,) i32 ``depth`` and ``live`` words (device tensors, such
        as rows of the tree state), the (F,) bool ``mask`` (the forced
        feature alone) and (F,) i32 threshold bins ``thr`` (the forced
        bin): ``find_best_split`` under them, without CEGB, into child 0
        of ``out``, where ``live``."""
        F, B = self.num_feat, self.num_bins
        if hist.dtype != torch.float32 or hist.shape != (1, F, B, 3) \
                or not hist.is_contiguous():
            raise ValueError("split_scan: hist must be contiguous (1, %d, "
                             "%d, 3) f32" % (F, B))
        if mask.shape != (F,) or thr.shape != (F,) \
                or thr.dtype != torch.int32 or mask.dtype != torch.bool:
            raise ValueError("split_scan: mask (%d,) bool and thr (%d,) "
                             "int32" % (F, F))
        self._check_out(out)
        if self._args is None:
            scan_leaf_plain(hist[0], sums, outs, lows, ups, depth, live,
                            mask, thr, out, self.meta, self.hp, self.bounds)
            return
        check_on_card("split_scan", hist, sums, outs, lows, ups, depth,
                      live, mask, thr, out.fout)
        self._launch(hist, live, depth, sums.data_ptr(), outs.data_ptr(),
                     lows.data_ptr(), ups.data_ptr(), mask, 0, thr, None,
                     out, 1)
