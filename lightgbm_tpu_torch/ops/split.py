"""Vectorized best-split search over histograms (PyTorch port of
``lightgbm_tpu/ops/split.py``).

The whole ``(features, bins)`` plane is scanned at once with prefix sums;
the missing-value direction is handled by evaluating both default-left and
default-right assignments; categorical splits use a one-vs-rest scan (<=
``max_cat_to_onehot`` categories) or a sorted-by-(grad/hess) many-vs-many
prefix scan. Its TPU form is XLA, not Pallas, so the port keeps it as plain
torch ops (a scan kernel is later work).

Unlike the JAX function, :func:`find_best_split` also takes a leading batch
axis: ``hist`` may be ``(P, F, B, 3)`` with per-node ``parent_sum`` (P, 3)
and per-node scalars (P,), which is how the learner scores both children
of a split in one pass (the JAX learner vmaps it). An unbatched
``(F, B, 3)`` call returns unbatched fields, like the JAX function.

Where the two frameworks could differ, this module does what JAX does:
``argsort`` is stable, ``argmax`` takes the first maximum, NaN gains fail
the ``> -inf`` live test and never win. Prefix sums run in torch's order,
so gains agree with the JAX package at a float tolerance, not bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG_INF = float("-inf")
K_EPSILON = 1e-15
KIND_NUMERICAL = 0
KIND_CAT_ONEHOT = 1
KIND_CAT_MVM_ASC = 2
KIND_CAT_MVM_DESC = 3


class FeatureMeta(NamedTuple):
    """Per-feature metadata as (F,) tensors on the learner's device."""
    num_bins: torch.Tensor         # int32 total bins incl. missing bin
    movable_missing: torch.Tensor  # bool: feature has a missing-directed bin
    missing_bin: torch.Tensor      # int32 index of that bin
    is_categorical: torch.Tensor   # bool
    monotone: torch.Tensor         # int8 in {-1, 0, +1}
    penalty: torch.Tensor          # float32 split-gain multiplier
    cegb_coupled: torch.Tensor     # float32 per-feature coupled CEGB penalty


class SplitHyper(NamedTuple):
    """Hyperparameters read by the scan (reference: the Config fields read
    by FeatureHistogram)."""
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: float = 20.0
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_delta_step: float = 0.0
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    min_data_per_group: float = 100.0
    path_smooth: float = 0.0
    has_categorical: bool = False
    has_monotone: bool = False
    mono_intermediate: bool = False
    mono_advanced: bool = False
    monotone_penalty: float = 0.0
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    use_cegb: bool = False


class SplitInfo(NamedTuple):
    """Best split for one leaf (or a (P,)-batch of leaves)."""
    gain: torch.Tensor          # f32; -inf when no valid split
    feature: torch.Tensor       # i64 inner feature index
    bin: torch.Tensor           # i64 threshold bin / category / prefix len
    kind: torch.Tensor          # i64 KIND_*
    default_left: torch.Tensor  # bool
    go_left: torch.Tensor       # (.., B) bool bin routing table
    left_sum: torch.Tensor      # (.., 3) g, h, cnt
    right_sum: torch.Tensor     # (.., 3)
    left_output: torch.Tensor   # f32
    right_output: torch.Tensor  # f32


def _threshold_l1(g, l1: float):
    return torch.sign(g) * torch.clamp(torch.abs(g) - l1, min=0.0)


def calc_leaf_output(g, h, hp: SplitHyper, extra_l2=0.0):
    """CalculateSplittedLeafOutput: -TL1(g)/(h+l2), clipped by
    max_delta_step when set."""
    g = torch.as_tensor(g, dtype=torch.float32)
    h = torch.as_tensor(h, dtype=torch.float32, device=g.device)
    denom = h + hp.lambda_l2 + extra_l2
    w = torch.where(denom > 0,
                    -_threshold_l1(g, hp.lambda_l1)
                    / torch.clamp(denom, min=1e-38),
                    torch.zeros((), dtype=torch.float32, device=g.device))
    if hp.max_delta_step > 0:
        w = torch.clamp(w, -hp.max_delta_step, hp.max_delta_step)
    return w


def _smoothed(w, cnt, parent_output, hp: SplitHyper):
    """Path smoothing: w' = w * n/(n+s) + parent * s/(n+s)."""
    if hp.path_smooth <= 0:
        return w
    n = torch.clamp(cnt, min=1.0)
    alpha = n / (n + hp.path_smooth)
    return w * alpha + parent_output * (1.0 - alpha)


def _gain_given_output(g, h, w, hp: SplitHyper, extra_l2=0.0):
    """GetLeafGainGivenOutput."""
    l2 = hp.lambda_l2 + extra_l2
    return -(2.0 * g * w + (h + l2) * w * w) \
        - 2.0 * hp.lambda_l1 * torch.abs(w)


def leaf_objective_value(g, h, hp: SplitHyper):
    """Gain of keeping a leaf unsplit (GetLeafGain)."""
    w = calc_leaf_output(g, h, hp)
    return _gain_given_output(g, h, w, hp)


def _split_gain_pair(gl, hl, cl, gr, hr, cr, hp: SplitHyper, *,
                     extra_l2=0.0, parent_output=0.0, lower=None, upper=None,
                     monotone=None, child_bounds=None):
    """Gain of a candidate split + the (possibly constrained) child
    outputs; broadcasts over any leading shape. Returns (gain, w_left,
    w_right, constraint_ok)."""
    wl = calc_leaf_output(gl, hl, hp, extra_l2)
    wr = calc_leaf_output(gr, hr, hp, extra_l2)
    wl = _smoothed(wl, cl, parent_output, hp)
    wr = _smoothed(wr, cr, parent_output, hp)
    ok = torch.ones(torch.broadcast_shapes(wl.shape, wr.shape), dtype=torch.bool,
                    device=wl.device)
    if hp.has_monotone and monotone is not None:
        viol = ((monotone > 0) & (wl > wr)) | ((monotone < 0) & (wl < wr))
        ok = ok & ~viol
        if child_bounds is not None:
            lo_l, up_l, lo_r, up_r = child_bounds
            wl = torch.minimum(torch.maximum(wl, lo_l), up_l)
            wr = torch.minimum(torch.maximum(wr, lo_r), up_r)
            viol2 = ((monotone > 0) & (wl > wr)) | ((monotone < 0) & (wl < wr))
            ok = ok & ~viol2
        elif lower is not None:
            wl = torch.minimum(torch.maximum(wl, lower), upper)
            wr = torch.minimum(torch.maximum(wr, lower), upper)
    gain = _gain_given_output(gl, hl, wl, hp, extra_l2) + \
        _gain_given_output(gr, hr, wr, hp, extra_l2)
    return gain, wl, wr, ok


def _per_node(x, p: int, device) -> torch.Tensor:
    """A scalar or (P,) per-node value -> (P,) f32. A Python number is
    filled on the device: a host->device copy would wait for the card."""
    if not isinstance(x, torch.Tensor):
        return torch.full((p,), float(x), dtype=torch.float32, device=device)
    t = x.to(torch.float32).reshape(-1)
    return t.expand(p) if t.numel() == 1 else t


def find_best_split(
    hist: torch.Tensor,          # (F, B, 3) or (P, F, B, 3) f32
    parent_sum: torch.Tensor,    # (3,) or (P, 3)
    meta: FeatureMeta,
    feature_mask: torch.Tensor,  # (F,) or per node (P, F) bool
    hp: SplitHyper,
    *,
    parent_output=0.0,
    leaf_lower=NEG_INF,
    leaf_upper=float("inf"),
    rand_threshold: Optional[torch.Tensor] = None,
    want_feature_gains: bool = False,
    want_candidates: bool = False,
    cegb_delta: Optional[torch.Tensor] = None,
    node_depth=None,
    adv_bounds=None,
) -> SplitInfo:
    """Best split over all features for one leaf's histogram (or a batch
    of leaves). With ``want_feature_gains`` returns only the per-feature
    max gains; with ``want_candidates`` the whole ``(P, 4, F, B)`` table of
    candidate gains (kind, feature, bin) whose flat first maximum is the
    winner, ``-inf`` where a candidate is not live. ``feature_mask``,
    ``rand_threshold`` (extra-trees: the one numerical threshold bin each
    feature may take) and ``cegb_delta`` may be (F,) for every node or
    (P, F), one row a node (the by-node draws of the learner)."""
    single = hist.dim() == 3
    if single:
        hist = hist[None]
        parent_sum = parent_sum.reshape(1, 3)
        if adv_bounds is not None:
            adv_bounds = tuple(a[None] for a in adv_bounds)
    dev = hist.device
    P, F, B, _ = hist.shape
    f32 = torch.float32
    neg = torch.full((), NEG_INF, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    po = _per_node(parent_output, P, dev)[:, None, None]      # (P, 1, 1)
    lower = _per_node(leaf_lower, P, dev)[:, None, None]
    upper = _per_node(leaf_upper, P, dev)[:, None, None]
    b_iota = torch.arange(B, dtype=torch.int64, device=dev)
    nb = meta.num_bins.long()
    bin_valid = b_iota[None, :] < nb[:, None]                  # (F, B)
    hist = torch.where(bin_valid[None, :, :, None], hist, zero)
    parent_gain = leaf_objective_value(parent_sum[:, 0], parent_sum[:, 1],
                                       hp)[:, None, None]      # (P, 1, 1)

    # ---------- numerical thresholds ----------
    is_missing_bin = meta.movable_missing[:, None] \
        & (b_iota[None, :] == meta.missing_bin.long()[:, None])
    miss = torch.sum(torch.where(is_missing_bin[None, :, :, None], hist,
                                 zero), dim=2)                 # (P, F, 3)
    hist_nm = torch.where(is_missing_bin[None, :, :, None], zero, hist)
    cum = torch.cumsum(hist_nm, dim=2)                         # (P, F, B, 3)
    total = parent_sum[:, None, None, :]                       # (P, 1, 1, 3)
    mono = meta.monotone[:, None] if hp.has_monotone else None

    def eval_dir(left):
        right = total - left
        gl, hl, cl = left[..., 0], left[..., 1], left[..., 2]
        gr, hr, cr = right[..., 0], right[..., 1], right[..., 2]
        gain, _, _, ok = _split_gain_pair(
            gl, hl, cl, gr, hr, cr, hp, parent_output=po, lower=lower,
            upper=upper, monotone=mono, child_bounds=adv_bounds)
        ok = ok & (cl >= hp.min_data_in_leaf) & (cr >= hp.min_data_in_leaf) \
            & (hl >= hp.min_sum_hessian_in_leaf) \
            & (hr >= hp.min_sum_hessian_in_leaf)
        return torch.where(ok, gain - parent_gain, neg)

    t_valid = (b_iota[None, :] < nb[:, None] - 1) \
        & ~meta.is_categorical[:, None]
    t_valid = t_valid[None]                                    # (1, F, B)
    if rand_threshold is not None:
        rt = rand_threshold.long()
        rt = rt[None] if rt.dim() == 1 else rt                 # (P|1, F)
        t_valid = t_valid & (b_iota[None, None, :] == rt[:, :, None])
    gains2 = eval_dir(torch.stack([cum, cum + miss[:, :, None, :]], dim=0))
    gains2 = torch.where(
        torch.stack([t_valid, t_valid & meta.movable_missing[None, :, None]],
                    dim=0), gains2, neg)                       # (2, P, F, B)
    gain_dr, gain_dl = gains2[0], gains2[1]
    num_gain = torch.maximum(gain_dr, gain_dl)                 # (P, F, B)
    num_dl = gain_dl > gain_dr

    # ---------- categorical ----------
    order_asc = order_desc = None
    if hp.has_categorical:
        extra_l2 = hp.cat_l2
        cat_bin_ok = meta.is_categorical[:, None] \
            & (b_iota[None, :] < nb[:, None] - 1)
        g_b, h_b, c_b = hist[..., 0], hist[..., 1], hist[..., 2]
        use_onehot = meta.is_categorical & (nb - 1 <= hp.max_cat_to_onehot)
        left = hist
        right = total - left
        oh_gain, _, _, _ = _split_gain_pair(
            left[..., 0], left[..., 1], left[..., 2],
            right[..., 0], right[..., 1], right[..., 2], hp,
            extra_l2=extra_l2, parent_output=po)
        oh_ok = (left[..., 2] >= hp.min_data_in_leaf) \
            & (right[..., 2] >= hp.min_data_in_leaf) \
            & (left[..., 1] >= hp.min_sum_hessian_in_leaf) \
            & (right[..., 1] >= hp.min_sum_hessian_in_leaf) \
            & cat_bin_ok & use_onehot[:, None] & (c_b > 0)
        oh_gain = torch.where(oh_ok, oh_gain - parent_gain, neg)

        group_ok = cat_bin_ok & (c_b >= hp.min_data_per_group) \
            & ~use_onehot[:, None]                             # (P, F, B)
        ratio = g_b / (h_b + hp.cat_smooth)
        key = torch.where(group_ok, ratio, -neg)
        order_asc = torch.argsort(key, dim=-1, stable=True)
        key_desc = torch.where(group_ok, ratio, neg)
        order_desc = torch.argsort(-key_desc, dim=-1, stable=True)
        n_groups = torch.sum(group_ok, dim=-1)                 # (P, F)

        order2 = torch.stack([order_asc, order_desc], dim=0)  # (2, P, F, B)
        h_sorted = torch.gather(
            hist[None].expand(2, P, F, B, 3), 3,
            order2[..., None].expand(2, P, F, B, 3))
        csum = torch.cumsum(h_sorted, dim=3)
        k1 = (b_iota + 1).to(f32)
        left = csum
        right = total - left
        gain, _, _, _ = _split_gain_pair(
            left[..., 0], left[..., 1], left[..., 2],
            right[..., 0], right[..., 1], right[..., 2], hp,
            extra_l2=extra_l2, parent_output=po)
        ok = (k1 <= hp.max_cat_threshold) & (k1 < n_groups[..., None]) \
            & (left[..., 2] >= hp.min_data_in_leaf) \
            & (right[..., 2] >= hp.min_data_in_leaf) \
            & (left[..., 1] >= hp.min_sum_hessian_in_leaf) \
            & (right[..., 1] >= hp.min_sum_hessian_in_leaf)
        mvm = torch.where(ok, gain - parent_gain, neg)
        mvm_asc, mvm_desc = mvm[0], mvm[1]
    else:
        oh_gain = mvm_asc = mvm_desc = torch.full_like(num_gain, NEG_INF)
    num_gain = torch.where(meta.is_categorical[:, None], neg, num_gain)

    # ---------- combine ----------
    stacked = torch.stack([num_gain, oh_gain, mvm_asc, mvm_desc],
                          dim=1)                               # (P, 4, F, B)
    fm = feature_mask if feature_mask.dim() == 2 else feature_mask[None]
    live = (stacked > NEG_INF) & fm[:, None, :, None]
    adj = stacked * meta.penalty[None, None, :, None]
    if hp.has_monotone and hp.monotone_penalty > 0 and node_depth is not None:
        p = torch.full((), hp.monotone_penalty, dtype=f32, device=dev)
        d = _per_node(node_depth, P, dev)[:, None, None, None]
        eps = torch.full((), K_EPSILON, dtype=f32, device=dev)
        pen = torch.where(p >= d + 1.0, eps,
                          torch.where(p <= 1.0, 1.0 - p / (2.0 ** d) + eps,
                                      1.0 - 2.0 ** (p - 1.0 - d) + eps))
        mono_f = meta.monotone != 0
        adj = torch.where(mono_f[None, None, :, None], adj * pen, adj)
    if hp.use_cegb and cegb_delta is not None:
        cd = cegb_delta if cegb_delta.dim() == 2 else cegb_delta[None]
        adj = adj - cd[:, None, :, None]
    stacked = torch.where(live, adj, neg)
    if want_feature_gains:
        fg = torch.amax(stacked, dim=(1, 3))                  # (P, F)
        return fg[0] if single else fg
    if want_candidates:
        return stacked[0] if single else stacked
    flat = stacked.reshape(P, -1)
    best_idx = torch.argmax(flat, dim=1)                       # first max
    best_gain = torch.gather(flat, 1, best_idx[:, None])[:, 0]
    kind = best_idx // (F * B)
    rem = best_idx % (F * B)
    feat = rem // B
    tbin = rem % B
    pi = torch.arange(P, device=dev)

    # ---------- routing table for the winner ----------
    b_row = b_iota[None, :]                                    # (1, B)
    dl = num_dl[pi, feat, tbin]                                # (P,)
    go_num = b_row <= tbin[:, None]
    go_num = torch.where(meta.movable_missing[feat][:, None]
                         & (b_row == meta.missing_bin.long()[feat][:, None]),
                         dl[:, None], go_num)
    if hp.has_categorical:
        go_oh = b_row == tbin[:, None]
        prefix = b_row <= tbin[:, None]

        def tbl_mvm(order):
            row = order[pi, feat]                              # (P, B)
            return torch.zeros((P, B), dtype=torch.bool,
                               device=dev).scatter(1, row, prefix)

        go_left = torch.where(
            (kind == 0)[:, None], go_num,
            torch.where((kind == 1)[:, None], go_oh,
                        torch.where((kind == 2)[:, None], tbl_mvm(order_asc),
                                    tbl_mvm(order_desc))))
        default_left = torch.where(kind == 0, dl, torch.zeros_like(dl))
    else:
        go_left, default_left = go_num, dl

    hwin = hist[pi, feat]                                      # (P, B, 3)
    win_left = torch.where(go_left[:, :, None], hwin, zero)
    if B <= 256:
        left_sum = torch.sum(win_left, dim=1)
    else:
        # past 256 bins the winner's bins add one after another (the last
        # of their prefix sums), an order the split scan kernel can follow
        # (csrc/split_scan.cuh finish_child)
        left_sum = torch.cumsum(win_left, dim=1)[:, -1]
    right_sum = parent_sum - left_sum
    extra = torch.where(kind > 0, torch.full((), hp.cat_l2, dtype=f32,
                                             device=dev), zero)
    po1 = po[:, 0, 0]
    wl = _smoothed(calc_leaf_output(left_sum[:, 0], left_sum[:, 1], hp, extra),
                   left_sum[:, 2], po1, hp)
    wr = _smoothed(calc_leaf_output(right_sum[:, 0], right_sum[:, 1], hp,
                                    extra), right_sum[:, 2], po1, hp)
    if hp.has_monotone:
        if adv_bounds is not None:
            lo_l, up_l, lo_r, up_r = (a[pi, feat, tbin] for a in adv_bounds)
            wl = torch.minimum(torch.maximum(wl, lo_l), up_l)
            wr = torch.minimum(torch.maximum(wr, lo_r), up_r)
        else:
            lo, up = lower[:, 0, 0], upper[:, 0, 0]
            wl = torch.minimum(torch.maximum(wl, lo), up)
            wr = torch.minimum(torch.maximum(wr, lo), up)

    valid = best_gain > hp.min_gain_to_split
    best_gain = torch.where(valid, best_gain, neg)
    info = SplitInfo(gain=best_gain, feature=feat, bin=tbin, kind=kind,
                     default_left=default_left, go_left=go_left,
                     left_sum=left_sum, right_sum=right_sum,
                     left_output=wl.to(f32), right_output=wr.to(f32))
    if single:
        return SplitInfo(*(x[0] for x in info))
    return info
