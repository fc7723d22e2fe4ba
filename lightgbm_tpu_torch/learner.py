"""Leaf-wise tree growth and binned-row routing (PyTorch port of
``lightgbm_tpu/learner.py``).

:func:`build_tree_partitioned` grows one tree on the planes or the rows
work layout (the JAX package's ``tpu_work_layout``): per split, a stable
partition of the parent's rows (``ops/partition.partition_segment`` /
``partition_segment_rows``, CUDA kernels on the card), a histogram of the
smaller child's contiguous segment (``ops/histogram.segment_histogram`` /
``segment_histogram_rows``, or ``segment_histogram_q`` for int8 quantized
gradients, which train on the rows layout only) with the sibling as parent
minus child, and the split scan over both children
(``ops/split.find_best_split``). After the tree, :func:`assign_leaves`
routes every row to its leaf (the ``route_rows`` kernel).

The JAX ``while_loop`` becomes a Python loop whose state stays on the
device. What the host needs to issue a split (the chosen leaf, whether its
gain is positive, the parent segment, the split column, which child is
smaller) comes back in ONE device->host transfer per split; the kernels
read their segment arguments from device tensors and the host sizes their
grids from the parent's row count.

Only the serial learner is ported (:class:`Comm` is its identity seam);
the data/feature/voting learners are later work (ROADMAP A11).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .utils.log import LightGBMError


class TreeLog(NamedTuple):
    """Device-side record of one tree in leaf-slot split order."""
    num_splits: torch.Tensor     # (1,) i32, stays on the device
    split_leaf: torch.Tensor     # (L-1,) i32
    feature: torch.Tensor        # (L-1,) i32
    bin: torch.Tensor            # (L-1,) i32
    kind: torch.Tensor           # (L-1,) i32
    default_left: torch.Tensor   # (L-1,) bool
    gain: torch.Tensor           # (L-1,) f32
    left_sum: torch.Tensor       # (L-1, 3) f32
    right_sum: torch.Tensor      # (L-1, 3) f32
    go_left: torch.Tensor        # (L-1, B) bool
    miss_bin: torch.Tensor       # (L-1,) i32 movable-missing bin
    movable: torch.Tensor        # (L-1,) bool feature has missing-directed bin
    leaf_value: torch.Tensor     # (L,) f32 raw outputs
    leaf_sum: torch.Tensor       # (L, 3) f32
    row_leaf: torch.Tensor       # (N,) i32 final leaf of every training row


def route_layout(bins: torch.Tensor) -> torch.Tensor:
    """(N, G) u8 binned matrix -> the router's (G, Npad/128, 128) u8
    transposed block form, rows zero-padded to a multiple of 128."""
    from .ops.route import ROUTE_ROW_ALIGN

    n, g = bins.shape
    npad = -(-n // ROUTE_ROW_ALIGN) * ROUTE_ROW_ALIGN
    bt = torch.zeros((g, npad), dtype=bins.dtype, device=bins.device)
    bt[:, :n] = bins.t()
    return bt.reshape(g, npad // ROUTE_ROW_ALIGN, ROUTE_ROW_ALIGN)


def assign_leaves(bins: torch.Tensor, log: TreeLog,
                  has_categorical: bool = True,
                  bundle: Optional[dict] = None,
                  bins_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Route binned rows through a tree's split log -> (N,) i32 leaf slots
    (device analog of Tree::PredictLeafIndex over pre-binned data).

    Numerical(-or-bundled) trees over a u8 matrix go through the row
    router ``ops.route.route_rows`` — its CUDA kernel on the card, its
    plain twin on the host — the same condition under which the JAX
    package takes its Pallas router. ``bins_t`` is the router's block form
    (:func:`route_layout`) when the caller caches it. Categorical trees
    and u16 matrices take the round-by-round plain router below, whose
    categorical rounds look the bin up in the (B,) routing table.
    """
    n = bins.shape[0]
    if not has_categorical and bins.dtype == torch.uint8:
        from .ops.route import build_route_table, route_rows

        btr = bins_t if bins_t is not None else route_layout(bins)
        table = build_route_table(log, bundle)
        return route_rows(btr, table, log.num_splits)[:n]
    max_splits = log.split_leaf.shape[0]
    ns = min(int(log.num_splits.reshape(-1)[0]), max_splits)
    row_leaf = torch.zeros(n, dtype=torch.int32, device=bins.device)
    bt = bins.t()
    for r in range(ns):
        fid = int(log.feature[r])
        col_idx = int(bundle["group"][fid]) if bundle is not None else fid
        col = bt[col_idx].to(torch.int32)
        if has_categorical and int(log.kind[r]) > 0:
            go = log.go_left[r][col.long()]
        elif bundle is not None:
            off = int(bundle["offset"][fid])
            d = int(bundle["dpos"][fid])
            rest_dir = bool(log.go_left[r][d])
            has_rest = bool(bundle["has_rest"][fid])
            rank = col - off
            fb = rank + (rank >= d).to(torch.int32)
            in_range = has_rest & (col >= off) \
                & (col < off + int(bundle["nbm1"][fid]))
            eff = fb if has_rest else col
            go = eff <= log.bin[r]
            go = torch.where(log.movable[r] & (eff == log.miss_bin[r]),
                             log.default_left[r], go)
            if has_rest:
                go = torch.where(in_range, go, rest_dir)
        else:
            go = col <= log.bin[r]
            go = torch.where(log.movable[r] & (col == log.miss_bin[r]),
                             log.default_left[r], go)
        row_leaf = torch.where((row_leaf == log.split_leaf[r]) & ~go,
                               r + 1, row_leaf)
    return row_leaf


def leaf_values_by_row(leaf_value: torch.Tensor,
                       row_leaf: torch.Tensor) -> torch.Tensor:
    """(L,) leaf outputs + (N,) leaf ids -> (N,) per-row f32 values."""
    return leaf_value.to(torch.float32)[row_leaf.long()]


# ---------------------------------------------------------------------------
# Tree builder
# ---------------------------------------------------------------------------

class Comm:
    """Collective seam of the tree builder, serial identity only
    (reference analog: the Network hooks of the parallel tree learners).
    The distributed strategies are ROADMAP A11."""

    axis = None
    mode = "serial"

    def hist(self, h):
        """Leaf-histogram reduction."""
        return h

    def root(self, x):
        """Root gradient-sum reduction."""
        return x


def _empty_best(num_leaves: int, num_bin: int, device) -> "SplitInfo":
    from .ops.split import SplitInfo

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return SplitInfo(
        gain=torch.full((num_leaves,), float("-inf"), device=device),
        feature=z(num_leaves, dtype=torch.int64),
        bin=z(num_leaves, dtype=torch.int64),
        kind=z(num_leaves, dtype=torch.int64),
        default_left=z(num_leaves, dtype=torch.bool),
        go_left=z(num_leaves, num_bin, dtype=torch.bool),
        left_sum=z(num_leaves, 3), right_sum=z(num_leaves, 3),
        left_output=z(num_leaves), right_output=z(num_leaves))


def _set_best(best, idx, info) -> None:
    """best[idx] = info, field by field, in place."""
    for b, v in zip(best, info):
        b[idx] = v


def _make_best_for(meta, hp, feature_mask):
    """Per-node split evaluation. By-node sampling, extra-trees and
    interaction constraints need the port's RNG and constraint sets
    (ROADMAP A3, A10); the learner refuses them, so this is the plain
    (F, B) scan."""
    from .ops.split import find_best_split

    def best_for(hist, parent_sum, parent_out, lower, upper, depth):
        return find_best_split(hist, parent_sum, meta, feature_mask, hp,
                               parent_output=parent_out, leaf_lower=lower,
                               leaf_upper=upper, node_depth=depth)

    return best_for


def build_tree_partitioned(
    bins: torch.Tensor,          # (N, G) uint8 bundle columns
    ghc: torch.Tensor,           # (N, 3) f32 (grad, hess, inbag)
    meta,                        # ops.split.FeatureMeta
    feature_mask: torch.Tensor,  # (F,) bool
    hp,                          # ops.split.SplitHyper
    *,
    num_leaves: int,
    num_bin: int,
    max_depth: int = -1,
    num_bin_hist: Optional[int] = None,
    bundle: Optional[Dict[str, torch.Tensor]] = None,
    hist_mode: str = "hilo",
    work_layout: str = "planes",
    key=None,
    dither_offset: int = 0,
    comm: Comm = Comm(),
    bins_t: Optional[torch.Tensor] = None,
    work: Optional[torch.Tensor] = None,
    stats: Optional[dict] = None,
) -> TreeLog:
    """Grow one leaf-wise tree with a physical row partition (reference
    contract: serial_tree_learner.cpp:324 FindBestSplits over the smaller
    leaf + histogram subtraction, data_partition.hpp:101 Split).

    ``work_layout`` is ``planes`` or ``rows``; ``hist_mode`` ``hilo``,
    ``bf16`` or ``int8`` (rows only: gradients packed as int8 with
    per-tree scales and a stochastic-rounding dither drawn from
    ``fold_in(key, 987123)`` at row offset ``dither_offset``, as the JAX
    builder draws it). ``work`` is a carried ping-pong buffer of the
    layout's shape (``ops/partition.work_buffer``; allocated when None);
    ``stats``, when given, receives the final per-leaf segment counts
    (``leaf_cnt``) and the count channel of each leaf's histogram
    (``hist_cnt``, the in-bag rows), both (num_leaves,) device tensors, the
    split count and the routed ``row_leaf``.

    Kept exactly as the JAX builder has them: the leaf to split is the
    first argmax of the best gains; the smaller child is the one with the
    smaller in-bag count (``left_sum[2] <= right_sum[2]``); the larger
    child's histogram is parent minus smaller; the root sum comes from the
    unquantized channels.
    """
    from .ops.histogram import (dequant_scale, segment_histogram,
                                segment_histogram_q, segment_histogram_rows)
    from .ops.partition import (pack_planes_fold_root, pack_rows,
                                pack_rows_quantized, partition_segment,
                                partition_segment_rows, quantize_scales,
                                work_buffer, work_spec)
    from .ops.split import calc_leaf_output
    from .prng import fold_in

    dev = bins.device
    f32, i32 = torch.float32, torch.int32
    n, num_grp = bins.shape
    num_feat = int(meta.num_bins.shape[0])
    max_splits = num_leaves - 1
    bm = num_bin_hist if num_bin_hist is not None else num_bin
    exact = hist_mode != "bf16"
    quantized = hist_mode == "int8"
    rows_layout = work_layout == "rows"
    if quantized and not rows_layout:
        raise ValueError("int8 quantized histograms need the rows work "
                         "layout (the planes layout has no quantized pack)")
    if quantized and key is None:
        raise ValueError("int8 quantized histograms need a key for the "
                         "stochastic-rounding dither")
    guard, _ = work_spec(num_grp, quantized)
    if work is None:
        work = work_buffer(n, num_grp, work_layout, quantized, dev)

    # ---- pack plane 0, root histogram (one launch) ----
    if rows_layout:
        part_fn = partition_segment_rows
        if quantized:
            # per-tree local scales, dequantized inside the histogram
            scales = quantize_scales(ghc)
            scale = dequant_scale(scales)
            work[0, guard:guard + n] = pack_rows_quantized(
                bins, ghc, fold_in(key, 987123), scales,
                offset=dither_offset)

            def hist_fn(seg, cnt_bound):
                return segment_histogram_q(work, seg, scale, num_bins=bm,
                                           num_feat=num_grp,
                                           cnt_bound=cnt_bound)
        else:
            work[0, guard:guard + n] = pack_rows(bins, ghc)

            def hist_fn(seg, cnt_bound):
                return segment_histogram_rows(work, seg, num_bins=bm,
                                              num_feat=num_grp, exact=exact,
                                              cnt_bound=cnt_bound)
        root_hist = hist_fn(torch.tensor([0, guard, n], dtype=i32,
                                         device=dev), n)
    else:
        part_fn = partition_segment

        def hist_fn(seg, cnt_bound):
            return segment_histogram(work, seg, num_bins=bm,
                                     num_feat=num_grp, exact=exact,
                                     cnt_bound=cnt_bound)
        root_hist = pack_planes_fold_root(work, bins, ghc, guard,
                                          num_bins=bm, exact=exact)

    def feat_view(hg, total_sum):
        """(P, G, Bm, 3) bundled histograms -> (P, F, B, 3) per-feature
        views; a bundled feature's shared default bin is recovered as
        total - sum(own slots) (dataset.h:503 FixHistogram)."""
        if bundle is None:
            return hg
        p = hg.shape[0]
        flat = hg.reshape(p, num_grp * bm, 3)
        fh = flat[:, bundle["proj"].reshape(-1).long()] \
            .reshape(p, num_feat, num_bin, 3)
        fh = fh * bundle["valid"][None, :, :, None]
        rest = total_sum[:, None, :] - torch.sum(fh, dim=2)     # (P, F, 3)
        put = bundle["dpos_oh"] & bundle["has_rest"][:, None]
        return torch.where(put[None, :, :, None], rest[:, :, None, :], fh)

    def route_table(go_left, feature):
        """Feature-space (B,) table -> bundle-column (Bm,) table (alien
        sub-features' slots follow the feature's default-bin direction)."""
        if bundle is None:
            return go_left
        return go_left[bundle["map_fb"][feature].long()]

    best_for = _make_best_for(meta, hp, feature_mask)

    # ---- root ----
    root_hist = comm.hist(root_hist)
    root_sum = comm.root(torch.sum(ghc, dim=0))
    hist_pool = torch.zeros((num_leaves, num_grp, bm, 3), dtype=f32,
                            device=dev)
    hist_pool[0] = root_hist
    leaf_sum = torch.zeros((num_leaves, 3), dtype=f32, device=dev)
    leaf_sum[0] = root_sum
    leaf_out = torch.zeros(num_leaves, dtype=f32, device=dev)
    leaf_out[0] = calc_leaf_output(root_sum[0], root_sum[1], hp)
    leaf_lower = torch.full((num_leaves,), float("-inf"), device=dev)
    leaf_upper = torch.full((num_leaves,), float("inf"), device=dev)
    # segment table: (start, cnt, parity) per leaf, on the device
    seg_tab = torch.zeros((num_leaves, 3), dtype=i32, device=dev)
    seg_tab[0, 0] = guard
    seg_tab[0, 1] = n
    depth = [0] * num_leaves
    best = _empty_best(num_leaves, num_bin, dev)
    root_info = best_for(feat_view(root_hist[None], root_sum[None]),
                         root_sum[None], leaf_out[:1], leaf_lower[:1],
                         leaf_upper[:1], 0)
    _set_best(best, slice(0, 1), root_info)

    log_leaf = []
    log_feat = torch.zeros(max_splits, dtype=torch.int64, device=dev)
    log_bin = torch.zeros_like(log_feat)
    log_kind = torch.zeros_like(log_feat)
    log_dl = torch.zeros(max_splits, dtype=torch.bool, device=dev)
    log_gain = torch.zeros(max_splits, dtype=f32, device=dev)
    log_ls = torch.zeros((max_splits, 3), dtype=f32, device=dev)
    log_rs = torch.zeros_like(log_ls)
    log_go = torch.zeros((max_splits, num_bin), dtype=torch.bool, device=dev)
    group = bundle["group"].long() if bundle is not None else None
    seg_cols = torch.tensor([2, 0, 1, 3], device=dev)   # parity,start,cnt,col

    for s in range(max_splits):
        # ---- the split's one device->host transfer ----
        leaf_d = torch.argmax(best.gain)
        feat_d = best.feature[leaf_d]
        col_d = group[feat_d] if group is not None else feat_d
        hdr = torch.cat([
            seg_tab[leaf_d], col_d.to(i32).reshape(1),
            leaf_d.to(i32).reshape(1),
            (best.gain[leaf_d] > 0).to(i32).reshape(1),
            (best.left_sum[leaf_d, 2] <= best.right_sum[leaf_d, 2])
            .to(i32).reshape(1)])
        start, cnt, parity, _, leaf, positive, left_smaller = hdr.tolist()
        if not positive:
            break
        new = s + 1
        info = [x[leaf] for x in best]     # views; read before best[leaf]
        (i_gain, i_feat, i_bin, i_kind, i_dl, i_go, i_ls, i_rs, i_lo,
         i_ro) = info

        # ---- record ----
        log_leaf.append(leaf)
        log_feat[s] = i_feat
        log_bin[s] = i_bin
        log_kind[s] = i_kind
        log_dl[s] = i_dl
        log_gain[s] = i_gain
        log_ls[s] = i_ls
        log_rs[s] = i_rs
        log_go[s] = i_go

        # ---- physical partition of the parent's segment ----
        seg = hdr.index_select(0, seg_cols)     # [src, start, cnt, col]
        lt = part_fn(work, seg, route_table(i_go, i_feat), cnt)
        new_parity = 1 - parity
        seg_tab[new, 0:1] = lt + start
        seg_tab[new, 1:2] = cnt - lt
        seg_tab[leaf, 1:2] = lt
        seg_tab[leaf, 2] = new_parity
        seg_tab[new, 2] = new_parity

        # ---- stats bookkeeping ----
        leaf_sum[leaf] = i_ls
        leaf_sum[new] = i_rs
        leaf_out[leaf] = i_lo
        leaf_out[new] = i_ro
        d = depth[leaf] + 1
        depth[leaf] = depth[new] = d
        if hp.has_monotone:
            # basic method: both children bounded by the split midpoint
            # (monotone_constraints.hpp:327 BasicLeafConstraints)
            mono = meta.monotone[i_feat]
            mid = (i_lo + i_ro) * 0.5
            lo_p, up_p = leaf_lower[leaf].clone(), leaf_upper[leaf].clone()
            leaf_lower[leaf] = torch.where(mono < 0, torch.maximum(lo_p, mid),
                                           lo_p)
            leaf_upper[leaf] = torch.where(mono > 0, torch.minimum(up_p, mid),
                                           up_p)
            leaf_lower[new] = torch.where(mono > 0, torch.maximum(lo_p, mid),
                                          lo_p)
            leaf_upper[new] = torch.where(mono < 0, torch.minimum(up_p, mid),
                                          up_p)

        # ---- histograms: smaller child's segment, sibling by subtraction
        hseg = torch.empty(3, dtype=i32, device=dev)
        hseg[0] = new_parity
        if left_smaller:
            hseg[1] = start
            hseg[2:3] = lt
        else:
            hseg[1:2] = lt + start
            hseg[2:3] = cnt - lt
        hist_small = comm.hist(hist_fn(hseg, cnt))
        hist_large = hist_pool[leaf] - hist_small
        hist_left, hist_right = (hist_small, hist_large) if left_smaller \
            else (hist_large, hist_small)
        hist_pool[leaf] = hist_left
        hist_pool[new] = hist_right

        # ---- refresh best splits for both children in one batched scan
        pair_sum = torch.stack([i_ls, i_rs])
        pair = slice(leaf, leaf + 1), slice(new, new + 1)
        pair_out = torch.cat([leaf_out[pair[0]], leaf_out[pair[1]]])
        pair_lo = torch.cat([leaf_lower[pair[0]], leaf_lower[pair[1]]])
        pair_up = torch.cat([leaf_upper[pair[0]], leaf_upper[pair[1]]])
        infos = best_for(feat_view(torch.stack([hist_left, hist_right]),
                                   pair_sum),
                         pair_sum, pair_out, pair_lo, pair_up, d)
        if max_depth > 0 and d >= max_depth:
            infos = infos._replace(gain=torch.full_like(infos.gain,
                                                        float("-inf")))
        _set_best(best, leaf, [x[0] for x in infos])
        _set_best(best, new, [x[1] for x in infos])

    ns = len(log_leaf)
    split_leaf = torch.tensor(log_leaf + [0] * (max_splits - ns),
                              dtype=i32).to(dev)
    log = TreeLog(
        num_splits=torch.full((1,), ns, dtype=i32, device=dev),
        split_leaf=split_leaf, feature=log_feat.to(i32),
        bin=log_bin.to(i32), kind=log_kind.to(i32), default_left=log_dl,
        gain=log_gain, left_sum=log_ls, right_sum=log_rs, go_left=log_go,
        miss_bin=meta.missing_bin[log_feat].to(i32),
        movable=meta.movable_missing[log_feat],
        leaf_value=leaf_out, leaf_sum=leaf_sum,
        row_leaf=torch.zeros(0, dtype=i32, device=dev))
    row_leaf = assign_leaves(bins, log, has_categorical=hp.has_categorical,
                             bundle=bundle, bins_t=bins_t)
    if stats is not None:
        stats["leaf_cnt"] = seg_tab[:, 1]
        stats["hist_cnt"] = hist_pool[:, 0, :, 2].sum(dim=1)
        stats["num_splits"] = ns
        stats["row_leaf"] = row_leaf
    return log._replace(row_leaf=row_leaf)


# ---------------------------------------------------------------------------
# Host wrapper
# ---------------------------------------------------------------------------

def _refuse(what: str, item: str) -> None:
    raise LightGBMError("%s is not ported to the PyTorch/CUDA package yet "
                        "(ROADMAP %s)" % (what, item))


class SerialTreeLearner:
    """Host orchestration around :func:`build_tree_partitioned` (reference
    analog: SerialTreeLearner + the factory at tree_learner.cpp:15).

    Settings the port cannot honour raise :class:`LightGBMError` naming
    their ROADMAP item; nothing warns and switches path."""

    def __init__(self, config, dataset, device: Optional[torch.device] = None,
                 bins: Optional[torch.Tensor] = None,
                 bins_t: Optional[torch.Tensor] = None) -> None:
        from .device import resolve_device
        from .ops.binning import BIN_CATEGORICAL, MISSING_NAN, MISSING_ZERO
        from .ops.split import FeatureMeta, SplitHyper

        self.config = config
        self.dataset = dataset
        self.device = device if device is not None \
            else resolve_device(config.device_type)
        dev = self.device
        self.num_leaves = max(2, int(config.num_leaves))
        nb = dataset.feature_num_bins()
        self.num_bin = int(max(2, nb.max() if len(nb) else 2))
        self.bins = bins if bins is not None \
            else torch.as_tensor(dataset.binned).to(dev)
        self.num_bin_hist = int(max(2, dataset.group_num_bins().max()
                                    if dataset.num_groups else 2))
        self._check_supported()
        self.bins_t = bins_t if bins_t is not None else route_layout(self.bins)
        mono = np.zeros(dataset.num_features, dtype=np.int8)
        if dataset.monotone_constraints is not None:
            mono = dataset.monotone_constraints.astype(np.int8)
        pen = np.ones(dataset.num_features, dtype=np.float32)
        if dataset.feature_penalty is not None:
            pen = dataset.feature_penalty.astype(np.float32)
        mappers = dataset.bin_mappers

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a)).to(dtype).to(dev)

        self.meta = FeatureMeta(
            num_bins=t(nb, torch.int32),
            movable_missing=t([m.missing_type in (MISSING_NAN, MISSING_ZERO)
                               and m.bin_type != BIN_CATEGORICAL
                               for m in mappers], torch.bool),
            missing_bin=t([m.missing_bin for m in mappers], torch.int32),
            is_categorical=t([m.bin_type == BIN_CATEGORICAL for m in mappers],
                             torch.bool),
            monotone=t(mono, torch.int8),
            penalty=t(pen, torch.float32),
            cegb_coupled=torch.zeros(dataset.num_features, device=dev))
        self.hp = SplitHyper(
            lambda_l1=float(config.lambda_l1),
            lambda_l2=float(config.lambda_l2),
            min_data_in_leaf=float(config.min_data_in_leaf),
            min_sum_hessian_in_leaf=float(config.min_sum_hessian_in_leaf),
            min_gain_to_split=float(config.min_gain_to_split),
            max_delta_step=float(config.max_delta_step),
            cat_smooth=float(config.cat_smooth),
            cat_l2=float(config.cat_l2),
            max_cat_threshold=int(config.max_cat_threshold),
            max_cat_to_onehot=int(config.max_cat_to_onehot),
            min_data_per_group=float(config.min_data_per_group),
            path_smooth=float(config.path_smooth),
            has_categorical=any(m.bin_type == BIN_CATEGORICAL
                                for m in mappers),
            has_monotone=dataset.monotone_constraints is not None,
            monotone_penalty=float(config.monotone_penalty))
        self.bundle = None
        if dataset.has_bundles:
            self.bundle = {k: torch.as_tensor(v).to(dev)
                           for k, v in dataset.bundle_maps().items()}
            self.bundle["dpos_oh"] = (
                torch.arange(self.num_bin, device=dev)[None, :]
                == self.bundle["dpos"].long()[:, None])
        self.comm = Comm()
        self._kw = self.build_kwargs()
        self._work = None
        #: the last tree's per-leaf segment and histogram counts
        self.last_stats: dict = {}

    def _check_supported(self) -> None:
        cfg = self.config
        ds = self.dataset
        if not self.use_partition():
            _refuse("the dense tree builder (tree_builder=dense, or more "
                    "than 256 bins per column)", "A10")
        if cfg.tree_learner != "serial":
            _refuse("tree_learner=%s" % cfg.tree_learner, "A11")
        if float(cfg.feature_fraction_bynode) < 1.0 or bool(cfg.extra_trees):
            _refuse("by-node feature sampling and extra_trees (they draw "
                    "threefry bits)", "A3")
        if cfg.interaction_constraints:
            _refuse("interaction_constraints", "A10")
        if cfg.forcedsplits_filename:
            _refuse("forced splits (forcedsplits_filename)", "A10")
        if cfg.cegb_penalty_split > 0 or cfg.cegb_penalty_feature_coupled \
                or cfg.cegb_penalty_feature_lazy:
            _refuse("CEGB penalties", "A10")
        if ds.monotone_constraints is not None \
                and cfg.monotone_constraints_method != "basic":
            _refuse("monotone_constraints_method=%s"
                    % cfg.monotone_constraints_method, "A10")

    def use_partition(self) -> bool:
        """The partitioned builder needs u8 bins (max_bin <= 256); the
        dense builder is not ported."""
        return self.config.tree_builder != "dense" and self.num_bin <= 256 \
            and self.num_bin_hist <= 256 and self.bins.dtype == torch.uint8

    def build_kwargs(self) -> dict:
        """Resolve the ``tpu_*`` knobs for the card; each ``auto``
        resolution is recorded with its reason. The work layout: int8
        quantized gradients (``use_quantized_grad`` or
        ``tpu_hist_precision=int8``) and ``tpu_hist_mxu=on`` train on the
        rows layout, everything else on planes; an explicit layout is
        honoured. The kernels: the hand-written ones (knob value
        ``pallas``) on a CUDA device, their plain twins (``xla``) on the
        host. Settings the port cannot honour raise."""
        from .obs import telemetry
        from .ops.partition import dither_offset

        cfg = self.config
        cuda = self.device.type == "cuda"

        def rec(knob, value, reason):
            telemetry.record("auto_resolution",
                             dedupe_key=(knob, value, reason), knob=knob,
                             configured="auto", value=value, reason=reason)

        mode = "int8" if cfg.use_quantized_grad else cfg.tpu_hist_precision
        quantized = mode == "int8"
        mxu = cfg.tpu_hist_mxu
        layout = cfg.tpu_work_layout
        if cfg.tpu_resident_state == "on":
            _refuse("the resident layout (tpu_resident_state=on)",
                    "B: resident gather histogram")
        if layout == "planes" and quantized:
            raise LightGBMError(
                "tpu_work_layout=planes cannot train int8 quantized "
                "histograms: the planes layout has no quantized pack, in "
                "the JAX package as here (use rows or auto; ROADMAP B)")
        if layout == "planes" and mxu == "on":
            raise LightGBMError(
                "tpu_hist_mxu=on needs the rows work layout, not "
                "tpu_work_layout=planes (ROADMAP B)")
        if layout == "auto":
            if quantized:
                layout = "rows"
                why = "int8 mode has no quantized planes pack"
            elif mxu == "on":
                layout = "rows"
                why = "tpu_hist_mxu=on histograms the rows layout"
            else:
                layout = "planes"
                why = ("f32 histograms: the planes layout, rows on request "
                       "(tpu_work_layout=rows or tpu_hist_mxu=on)")
            rec("tpu_work_layout", layout, why)
        if cfg.tpu_resident_state == "auto":
            rec("tpu_resident_state", "off", "the resident gather "
                "histogram is not ported (ROADMAP B)")
        if mxu == "auto":
            rec("tpu_hist_mxu", "off", "the layout decides the histogram "
                "kernel; on only asks for the rows layout")
        rows = layout == "rows"
        hist_src = ("csrc/segment_histogram_q.cu" if quantized else
                    "csrc/segment_histogram.cu (%s)"
                    % ("segment_histogram_rows" if rows
                       else "segment_histogram"))
        kernels = {}
        for knob, src in (("tpu_partition_kernel",
                           "csrc/partition_segment.cu (%s)"
                           % ("partition_segment_rows" if rows
                              else "partition_segment")),
                          ("tpu_hist_kernel", hist_src)):
            v = getattr(cfg, knob)
            if v == "xla" and cuda:
                _refuse("%s=xla on a CUDA device (the plain twins run only "
                        "on host tensors)" % knob, "B")
            if v == "auto":
                v = "pallas" if cuda else "xla"
                rec(knob, v, "hand-written CUDA kernel %s" % src if cuda
                    else "host tensors: the kernel's plain torch twin")
            kernels[knob] = v
        for knob, item in (("tpu_split_kernel", "B7"),
                           ("tpu_goss_compact", "A3")):
            v = getattr(cfg, knob)
            if v == "on":
                _refuse("%s=on" % knob, item)
            if v == "auto":
                rec(knob, "off", "not ported (ROADMAP %s)" % item)
        return dict(hp=self.hp, num_leaves=self.num_leaves,
                    num_bin=self.num_bin, max_depth=int(cfg.max_depth),
                    num_bin_hist=self.num_bin_hist, bundle=self.bundle,
                    hist_mode=mode, comm=self.comm,
                    part_kernel=kernels["tpu_partition_kernel"],
                    hist_kernel=kernels["tpu_hist_kernel"],
                    work_layout=layout,
                    dither_offset=dither_offset(
                        int(self.bins.shape[1]), int(cfg.tpu_part_chunk),
                        int(cfg.tpu_hist_chunk)))

    def train(self, ghc: torch.Tensor,
              feature_mask: Optional[torch.Tensor] = None,
              key=None) -> TreeLog:
        """One tree from (grad, hess, inbag) channels; the log stays on
        the device. ``key`` (a ``prng`` key, ``PRNGKey(0)`` when None)
        seeds the int8 quantization dither."""
        from .ops.partition import work_buffer
        from .prng import PRNGKey

        if feature_mask is None:
            feature_mask = torch.ones(self.dataset.num_features,
                                      dtype=torch.bool, device=self.device)
        kw = {k: v for k, v in self._kw.items()
              if k not in ("part_kernel", "hist_kernel")}
        if self._work is None:
            self._work = work_buffer(self.bins.shape[0], self.bins.shape[1],
                                     kw["work_layout"],
                                     kw["hist_mode"] == "int8", self.device)
        stats: dict = {}
        log = build_tree_partitioned(self.bins, ghc, self.meta, feature_mask,
                                     key=key if key is not None
                                     else PRNGKey(0),
                                     bins_t=self.bins_t, work=self._work,
                                     stats=stats, **kw)
        self.last_stats = stats
        return log

    def log_to_tree(self, log: TreeLog):
        """Pull the split log to the host and rebuild the Tree model
        (O(leaves) data; ``row_leaf`` stays on the device)."""
        from .tree import Tree

        h = {k: getattr(log, k).cpu().numpy() for k in (
            "num_splits", "split_leaf", "feature", "bin", "default_left",
            "gain", "left_sum", "right_sum", "leaf_value", "kind",
            "go_left")}
        return Tree.from_split_log(
            int(h["num_splits"].reshape(-1)[0]), h["split_leaf"],
            h["feature"], h["bin"], h["default_left"], h["gain"],
            h["left_sum"], h["right_sum"], h["leaf_value"],
            bin_mappers=self.dataset.bin_mappers,
            real_feature_index=self.dataset.used_feature_indices,
            go_left_table=h["go_left"], is_categorical=h["kind"] > 0)
