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
threshold bins and CEGB penalties). :meth:`SplitScan.fold` takes the
smaller child and the histogram pool instead: the sibling is the parent's
pool row minus the smaller child, and both children go straight into the
pool (the left one over the parent's row, the right one into the new
leaf's), where the split commit used to copy them. On a CUDA tensor it
launches ``csrc/split_scan.cu``, whose outputs equal ``find_best_split``'s
run on the card bit for bit; on a CPU tensor its plain twins
:func:`split_scan_plain` and :func:`split_scan_fold_plain` are
``find_best_split`` itself (after the torch sequence of the sibling's
subtraction). The JAX package runs this scan as XLA inside its
``lax.while_loop``; it has no Pallas kernel.
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
#: the launch shape of F features at B bins, [teams a CTA, CTAs of the
#: cluster, item rounds, dynamic shared bytes]: an entry point of the
#: same library that launches nothing (not registered, never counted)
SCAN_SHAPE = CudaKernel("split_scan_shape", "split_scan.cu",
                        [ctypes.c_int, ctypes.c_int, _P],
                        flags=("-fmad=false",))
#: the most bins the kernel scans
SCAN_MAX_BINS = 3072
#: the measurement path: thread 0 of each CTA writes %globaltimer (ns) into
#: its row of a (SCAN_MAX_GRID, SCAN_STAMP_SLOTS) i64 buffer at these
#: points; (phase, first slot, last slot) in launch order. "gather + pick"
#: and "finish" run in the leader CTA alone.
SCAN_STAMP_SLOTS = 9
SCAN_PHASES = (("staging", 0, 1), ("fold + pool", 1, 2),
               ("prefix chains", 2, 3), ("gains", 3, 4),
               ("maxima", 4, 5), ("cluster barrier", 5, 6),
               ("gather + pick", 6, 7), ("finish", 7, 8))
#: rows of a stamp buffer: at least the CTAs of a cluster (up to 16)
SCAN_MAX_GRID = 16


def scan_stamp_buffer(device) -> torch.Tensor:
    """A zeroed stamp buffer for :class:`SplitScan`'s ``stamps``."""
    return torch.zeros((SCAN_MAX_GRID, SCAN_STAMP_SLOTS), dtype=torch.int64,
                       device=device)


def scan_shape(num_feat: int, num_bins: int) -> dict:
    """The launch shape the kernel takes on the current card for F
    features of B bins: teams (of 256 threads, a feature each) a CTA, CTAs
    of the cluster, item rounds and dynamic shared bytes (card only)."""
    out = torch.zeros(4, dtype=torch.int32)
    fn = SCAN_SHAPE.load()
    rc = fn(num_feat, num_bins, ctypes.c_void_p(out.data_ptr()))
    if rc != 0:
        raise RuntimeError("split_scan_shape: CUDA error %d" % rc)
    teams, cta, rounds, smem = out.tolist()
    return dict(teams_per_cta=teams, ctas=cta, rounds=rounds,
                smem_bytes=smem)


class SplitScanArgs(ctypes.Structure):
    """The C struct ``SplitScanArgs`` of ``csrc/split_scan.cu`` (same
    fields, same order)."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "hists", "pool", "hdr", "live", "depth", "num_bins", "movable",
        "missing_bin", "is_cat", "monotone", "penalty", "fmask", "rand_thr",
        "cegb", "sums2", "outs2", "lows2", "ups2", "adv", "rank", "gain",
        "feature", "bin", "kind", "default_left", "go_left", "left_sum",
        "right_sum", "left_output", "right_output", "stamps")] \
        + [(name, ctypes.c_int32) for name in (
            "F", "B", "max_cat_to_onehot", "has_categorical", "has_monotone",
            "use_mono_penalty", "mask_stride", "nodes", "new_slot", "ws",
            "rounds")] \
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


def fold_children(small, pool, hdr):
    """The chain's sibling by torch: the parent's pool row (the header's
    word 7) minus the (F, B, 3) smaller child, and the (2, F, B, 3)
    children in left/right order by the header's left_smaller word 4."""
    large = pool.index_select(0, hdr[7:8].to(torch.int64)).squeeze(0) \
        - small
    ls = hdr[4:5] != 0
    return torch.stack([torch.where(ls, small, large),
                        torch.where(ls, large, small)])


def split_scan_fold_plain(small, pool, hdr, new_slot, pair, out, meta,
                          fmask, hp, node=None, bounds=None) -> None:
    """Plain twin of :meth:`SplitScan.fold`: :func:`fold_children`, both
    children into the pool rows of the parent (left) and ``new_slot``
    (right) where the header is live, then :func:`split_scan_plain` on
    them (no host read)."""
    hists = fold_children(small, pool, hdr)
    slots = torch.cat([hdr[7:8].to(torch.int64), torch.full(
        (1,), int(new_slot), dtype=torch.int64, device=pool.device)])
    cur = pool.index_select(0, slots)
    pool.index_copy_(0, slots, torch.where(hdr[6:7] != 0, hists, cur))
    split_scan_plain(hists, pair, hdr, out, meta, fmask, hp, node, bounds)


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
    each call fills in one split's pointers and launches one cluster of
    CTAs (``csrc/split_scan.cu``). ``node``, an ``ops/node.NodeBuf`` (or
    None), holds the children's own masks, threshold bins and CEGB
    penalties, which every call reads. Under the advanced monotone method ``bounds``, a
    (2, 4, F, B) f32 buffer (``ops/monotone.mono_bounds``, node 0 the left
    child or the forced leaf), holds each candidate's child bounds, which
    every call reads; the intermediate method's bounds are the pair row's
    scalars, as the basic method's."""

    def __init__(self, meta, fmask, hp, *, num_feat: int, num_bins: int,
                 device, node=None, bounds=None) -> None:
        from .monotone import method_code

        check_scan_inputs("split_scan", meta, fmask, hp, num_bins, num_feat,
                          cegb_ok=True, mono_ok=True,
                          max_bins=SCAN_MAX_BINS)
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
        #: many-vs-many ranks of the categorical features (the kernel's)
        self._rank = torch.empty((2, 2, F, B), dtype=torch.int16,
                                 device=device)
        self._args = SplitScanArgs(
            num_bins=meta.num_bins.data_ptr(),
            movable=meta.movable_missing.data_ptr(),
            missing_bin=meta.missing_bin.data_ptr(),
            is_cat=meta.is_categorical.data_ptr(),
            monotone=meta.monotone.data_ptr(),
            penalty=meta.penalty.data_ptr(), rank=self._rank.data_ptr(),
            adv=0 if bounds is None else bounds.data_ptr(), F=F, B=B,
            **_hyper_fields(hp))

    def _check_out(self, out: SplitOut) -> None:
        B = self.num_bins
        if out.bout.shape != (2 + 2 * B,):
            raise ValueError("split_scan: out.bout must be (%d,) bool"
                             % (2 + 2 * B))

    def _launch(self, hists, live, depth, sums, outs, lows, ups, masks,
                stride, thr, delta, out, nodes, stamps=None, pool=None,
                hdr=None, new_slot=0) -> None:
        a = self._args
        fo, io, bo = (out.fout.data_ptr(), out.iout.data_ptr(),
                      out.bout.data_ptr())
        a.hists = hists.data_ptr()
        a.pool = 0 if pool is None else pool.data_ptr()
        a.hdr = 0 if hdr is None else hdr.data_ptr()
        a.new_slot = int(new_slot)
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
        if stamps is not None:
            check_on_card("split_scan", stamps)
            if stamps.dtype != torch.int64 or stamps.shape != (
                    SCAN_MAX_GRID, SCAN_STAMP_SLOTS):
                raise ValueError("split_scan: stamps must be a "
                                 "scan_stamp_buffer()")
        a.stamps = 0 if stamps is None else stamps.data_ptr()
        SCAN_KERNEL.launch(ctypes.addressof(a), stream_of(hists))

    def _node_inputs(self):
        node = self.node
        return (self.fmask, 0, None, None) if node is None \
            else (node.mask, self.num_feat, node.thr, node.delta)

    def _check_pair_hdr(self, pair, hdr) -> None:
        if pair.dtype != torch.float32 or pair.shape != (PAIR_WORDS,):
            raise ValueError("split_scan: pair must be (%d,) f32"
                             % PAIR_WORDS)
        if hdr.dtype != torch.int32 or hdr.shape != (HDR_WORDS,):
            raise ValueError("split_scan: hdr must be (%d,) int32"
                             % HDR_WORDS)

    def __call__(self, hists: torch.Tensor, pair: torch.Tensor,
                 hdr: torch.Tensor, out: SplitOut, stamps=None) -> None:
        """Scan the (2, F, B, 3) f32 ``hists`` (left child, right child)
        with the (12,) f32 ``pair`` row and the (8,) i32 header ``hdr``;
        the results go into ``out``'s fout / iout / bout. ``stamps`` (a
        :func:`scan_stamp_buffer`, the card only) takes the kernel's phase
        times."""
        F, B = self.num_feat, self.num_bins
        if hists.dtype != torch.float32 or hists.shape != (2, F, B, 3) \
                or not hists.is_contiguous():
            raise ValueError("split_scan: hists must be contiguous (2, %d, "
                             "%d, 3) f32" % (F, B))
        self._check_pair_hdr(pair, hdr)
        self._check_out(out)
        if self._args is None:
            split_scan_plain(hists, pair, hdr, out, self.meta, self.fmask,
                             self.hp, self.node, self.bounds)
            return
        check_on_card("split_scan", hists, pair, hdr, out.fout, out.iout,
                      out.bout)
        masks, stride, thr, delta = self._node_inputs()
        pp = pair.data_ptr()
        self._launch(hists, hdr[6:7], hdr[5:6], pp, pp + 24, pp + 32,
                     pp + 40, masks, stride, thr, delta, out, 2, stamps)

    def fold(self, small: torch.Tensor, pool: torch.Tensor,
             hdr: torch.Tensor, new_slot: int, pair: torch.Tensor,
             out: SplitOut, stamps=None) -> None:
        """The chain's sibling and scan in one launch: the (F, B, 3) f32
        smaller child ``small``, the (P, F, B, 3) f32 ``pool`` whose row
        ``hdr[7]`` is the parent's, the (8,) i32 header and the (12,)
        pair row. The children (the sibling the parent's row minus
        ``small``, ordered by ``hdr[4]``) go into the pool, the left one
        over the parent's row, the right one into row ``new_slot``; the
        scan's results into ``out`` (``out.hists`` is not written). A dead
        header writes nothing."""
        F, B = self.num_feat, self.num_bins
        if small.dtype != torch.float32 or small.shape != (F, B, 3) \
                or not small.is_contiguous():
            raise ValueError("split_scan: small must be contiguous (%d, %d, "
                             "3) f32" % (F, B))
        if pool.dtype != torch.float32 or pool.dim() != 4 \
                or pool.shape[1:] != (F, B, 3) or not pool.is_contiguous():
            raise ValueError("split_scan: pool must be contiguous (P, %d, "
                             "%d, 3) f32" % (F, B))
        if not 0 < int(new_slot) < pool.shape[0]:
            raise ValueError("split_scan: new_slot %d outside the pool"
                             % int(new_slot))
        self._check_pair_hdr(pair, hdr)
        self._check_out(out)
        if self._args is None:
            split_scan_fold_plain(small, pool, hdr, new_slot, pair, out,
                                  self.meta, self.fmask, self.hp, self.node,
                                  self.bounds)
            return
        check_on_card("split_scan", small, pool, pair, hdr, out.fout,
                      out.iout, out.bout)
        masks, stride, thr, delta = self._node_inputs()
        pp = pair.data_ptr()
        self._launch(small, hdr[6:7], hdr[5:6], pp, pp + 24, pp + 32,
                     pp + 40, masks, stride, thr, delta, out, 2, stamps,
                     pool=pool, hdr=hdr, new_slot=new_slot)

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
