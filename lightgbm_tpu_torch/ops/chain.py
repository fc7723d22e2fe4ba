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
- the sibling as the parent's pool row minus the smaller child, both into
  ``out.hists`` (torch ops on device tensors);
- with bundles, the per-feature view of both (``learner.feature_view``)
  into a buffer of its own, since the pool and the commit work in bundle
  space and the scan in feature space;
- the split scan (``ops/scan.SplitScan``, ``csrc/split_scan.cu``) into
  ``out``, under the children's own node inputs when the learner has
  per-node options (``node``, an ``ops/node.NodeBuf`` that the tree loop
  fills before the split) and, under the advanced monotone method, the
  children's per-candidate bounds (``bounds``, which the tree loop fills
  with ``ops/monotone.mono_bounds`` before the split).

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

    def split(self, hdr: torch.Tensor, go_left: torch.Tensor,
              pool: torch.Tensor, pair: torch.Tensor, out: SplitOut) -> None:
        """One split from the (8,) i32 device header ``hdr``, the (Bm,)
        bool routing table ``go_left`` over the split column's codes, the
        (P, HF, HB, 3) f32 histogram ``pool`` whose row ``parent_slot`` is
        the parent's, and the (12,) f32 ``pair`` row; the results go into
        ``out``. Nothing is read back to the host."""
        if self.route is not None:
            self.route(hdr)
        self.partition(hdr, go_left, out.lt)
        small = self.histogram(hdr, out.lt)
        large = pool.index_select(0, hdr[7:8]).squeeze(0) - small
        ls = hdr[4:5] != 0
        torch.where(ls, small, large, out=out.hists[0])
        torch.where(ls, large, small, out=out.hists[1])
        hists = out.hists
        if self.feat_view is not None:
            self.fhist.copy_(self.feat_view(out.hists, pair[0:6].view(2, 3)))
            hists = self.fhist
        self.scan(hists, pair, hdr, out)
