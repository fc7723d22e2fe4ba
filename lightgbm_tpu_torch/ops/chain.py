"""The three-launch chain as a split object of the device tree loop.

:class:`ChainSplit` grows one split of ``learner.DeviceTreeLoop`` from the
split's device header (``ops/partition.ONE_KERNEL_HDR``, written by the
split commit) with no read back to the host, as the JAX builder's
``lax.while_loop`` body does with its three-launch chain
(``lightgbm_tpu/learner.py``, ``build_tree_partitioned``): on every work
layout, f32 or int8 histograms, with or without EFB bundles. It has the
signature of ``ops/partition.OneKernelSplit.split``, so the loop runs
either. Per split, in order:

- the route gather (resident layout only, ``ops/partition.RouteGather``);
- the partition, K3 on the planes (the resident route plane) or rows
  layout (``ops/partition.SegmentPartition``), by the routing table over
  the split column's codes; the left count goes into ``out.lt``;
- the smaller child's histogram, K4 (planes, rows, resident) or K5 (int8)
  (``ops/histogram.SegmentHistogram``), its segment derived on the card
  from the header and the left count;
- without bundles, the split scan's fold mode (``ops/scan.SplitScan.
  fold``, ``csrc/split_scan.cu``): the sibling as the parent's pool row
  minus the smaller child and both children into the pool (the left one
  over the parent's row, the right one into the new leaf's), in the scan's
  launch, so the commit copies nothing (:attr:`pooled`);
- with bundles, the sibling and both children into ``out.hists`` by torch
  ops, their per-feature view (``learner.feature_view``) into a buffer of
  its own, since the pool and the commit work in bundle space and the
  scan in feature space, and the scan of that view;
- the scan writes into ``out``, under the children's own node inputs when
  the learner has per-node options (``node``, an ``ops/node.NodeBuf``
  that the tree loop fills before the split) and, under the advanced
  monotone method, the children's per-candidate bounds (``bounds``, which
  the tree loop fills with ``ops/monotone.mono_bounds`` before the
  split).

The kernels are planned once for the root's row count, so a CUDA graph
holds every split of a tree. A header whose live word is 0 moves no row
and writes nothing that the commit reads. On host tensors every step runs
its plain twin over whole planes under masks, which reads nothing back
either.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .histogram import SegmentHistogram
from .partition import RouteGather, SegmentPartition, SplitOut
from .scan import SplitScan


class ChainSplit:
    """The three-launch chain of one learner's work buffer.

    ``work`` is the layout's ping-pong pair (``ops/partition.work_buffer``),
    ``layout`` ``planes``, ``resident`` (``resident`` the bin planes) or
    ``rows``; ``hist_mode`` ``hilo``, ``bf16`` or ``int8`` (rows only;
    ``scale`` the (3,) dequantization, refreshed per tree by the caller).
    ``num_feat`` / ``num_bins`` are the work rows' columns and bins (the
    bundles with EFB), ``scan_feat`` / ``scan_bins`` the features and bins
    the scan reads; ``feat_view`` (with EFB) maps the (2, HF, HB, 3) child
    histograms and the (2, 3) children's sums to that (2, F, B, 3) feature
    view. ``cnt_max`` (the rows of the root) sizes every launch."""

    def __init__(self, work: torch.Tensor, meta, fmask: torch.Tensor, hp, *,
                 layout: str, hist_mode: str, num_feat: int, num_bins: int,
                 scan_feat: int, scan_bins: int, cnt_max: int,
                 resident: Optional[torch.Tensor] = None,
                 scale: Optional[torch.Tensor] = None,
                 feat_view: Optional[Callable] = None, node=None,
                 bounds: Optional[torch.Tensor] = None) -> None:
        quantized = hist_mode == "int8"
        if quantized and layout != "rows":
            raise ValueError("ChainSplit: int8 histograms need the rows "
                             "layout")
        self.work = work
        self.route = RouteGather(work, resident, cnt_max=cnt_max) \
            if layout == "resident" else None
        self.partition = SegmentPartition(work, layout=layout,
                                          cnt_max=cnt_max)
        self.histogram = SegmentHistogram(
            work, layout="int8" if quantized else layout, num_bins=num_bins,
            num_feat=num_feat, exact=hist_mode != "bf16", cnt_max=cnt_max,
            resident=resident, scale=scale)
        self.scan = SplitScan(meta, fmask, hp, num_feat=scan_feat,
                              num_bins=scan_bins, device=work.device,
                              node=node, bounds=bounds)
        self.feat_view = feat_view
        self.fhist = None if feat_view is None else torch.zeros(
            (2, scan_feat, scan_bins, 3), dtype=torch.float32,
            device=work.device)
        #: the scan writes both children into the pool (no bundles)
        self.pooled = feat_view is None

    def small_child(self, hdr: torch.Tensor, go_left: torch.Tensor,
                    out: SplitOut) -> torch.Tensor:
        """The split's first launches: the route gather (resident), the
        partition (its left count into ``out.lt``) and the smaller child's
        (F, B, 3) histogram, which it returns."""
        if self.route is not None:
            self.route(hdr)
        self.partition(hdr, go_left, out.lt)
        return self.histogram(hdr, out.lt)

    def split(self, hdr: torch.Tensor, go_left: torch.Tensor,
              pool: torch.Tensor, pair: torch.Tensor, out: SplitOut,
              new_leaf: int) -> None:
        """One split from the (8,) i32 device header ``hdr``, the (Bm,)
        bool routing table ``go_left`` over the split column's codes, the
        (P, HF, HB, 3) f32 histogram ``pool`` whose row ``parent_slot`` is
        the parent's, the (12,) f32 ``pair`` row and the split's new leaf
        id (slot ``s`` creates leaf ``s + 1``); the results go into
        ``out`` (and the children into the pool when :attr:`pooled`).
        Nothing is read back to the host."""
        small = self.small_child(hdr, go_left, out)
        if self.pooled:
            self.scan.fold(small, pool, hdr, new_leaf, pair, out)
            return
        large = pool.index_select(0, hdr[7:8]).squeeze(0) - small
        ls = hdr[4:5] != 0
        torch.where(ls, small, large, out=out.hists[0])
        torch.where(ls, large, small, out=out.hists[1])
        self.fhist.copy_(self.feat_view(out.hists, pair[0:6].view(2, 3)))
        self.scan(self.fhist, pair, hdr, out)


class DenseSplit:
    """The dense builder's split in the device tree loop (the JAX
    package's ``build_tree`` loop body, ``lightgbm_tpu/learner.py``): every
    row stays in place with its leaf id in ``row_leaf`` (N,) i32. Per
    split, from the split's device header, with no read back to the host:

    - the row update (``ops/histogram.dense_row_update``): the parent's
      rows whose bin in the split column goes right move to the new leaf;
    - the smaller child's histogram (``ops/histogram.DenseHistogram``,
      ``csrc/dense_histogram.cu``): its rows selected by leaf id from all
      rows, planned once for all N rows;
    - the split scan's fold mode (``ops/scan.SplitScan.fold``): the
      sibling as the parent's pool row minus the smaller child, both
      children into the pool, the scan into ``out``, under the children's
      node inputs (``node``); the commit copies nothing (:attr:`pooled`).

    :meth:`split` takes the chain's arguments and the split's new leaf id
    (slot ``s`` creates leaf ``s + 1``). A dead header moves no row and
    writes nothing the commit reads."""

    def __init__(self, bins: torch.Tensor, ghc: torch.Tensor,
                 row_leaf: torch.Tensor, meta, fmask: torch.Tensor, hp, *,
                 num_bins: int, node=None) -> None:
        from .histogram import DenseHistogram

        self.bins, self.row_leaf = bins, row_leaf
        self.hist = DenseHistogram(bins, ghc, row_leaf, num_bins)
        self.scan = SplitScan(meta, fmask, hp, num_feat=bins.shape[1],
                              num_bins=num_bins, device=bins.device,
                              node=node)
        self.pooled = True

    def split(self, hdr: torch.Tensor, go_left: torch.Tensor,
              pool: torch.Tensor, pair: torch.Tensor, out: SplitOut,
              new_leaf: int) -> None:
        """One split from the (8,) i32 header ``hdr``, the (B,) bool
        routing table ``go_left``, the (P, F, B, 3) pool, the (12,) pair
        row and the new leaf id; the results go into ``out``."""
        small = self.small_child(hdr, go_left, out, new_leaf)
        self.scan.fold(small, pool, hdr, new_leaf, pair, out)

    def small_child(self, hdr: torch.Tensor, go_left: torch.Tensor,
                    out: SplitOut, new_leaf: int) -> torch.Tensor:
        """The split's first launches: the row update and the smaller
        child's (F, B, 3) histogram, which it returns."""
        from .histogram import dense_row_update

        dense_row_update(self.bins, self.row_leaf, go_left, hdr, new_leaf)
        return self.hist(hdr=hdr, new_leaf=new_leaf)
