"""Batched prediction over packed tree arrays (PyTorch port of
``lightgbm_tpu/ops/predict.py``).

Every tree flattens into leaf-slot split order (``Tree.to_split_arrays``)
and rows are routed arithmetically: split r tests raw values against its
threshold and moves non-left rows from ``slot[r]`` to slot ``r+1``.
:func:`predict_raw_impl` is plain torch: it is the raw-value oracle the
forest kernels are held to. It routes all trees at once per round and sums
leaf values in the JAX oracle's grouping (groups of ``TREE_BATCH`` trees,
each group summed in XLA's halving association, or per class in tree
order, groups chained in tree order). :func:`predict_raw` serves the
models that have no BIN-space pack (a model loaded from text alone, one
trained on other bins): on a CUDA tensor it launches the raw-threshold
walk (``csrc/forest_predict.cu``'s ``forest_raw``,
``ops/forest.forest_raw_impl``), which computes the twin's function bit
for bit without linear leaves; on a CPU tensor it runs the twin.

:func:`split_bin_table` and :func:`tree_to_bin_log` convert a tree's raw
thresholds into BIN space once on the host; the forest repack and the
binned router (``learner.assign_leaves``) both build on them.
:func:`leaf_indices` routes rows to their leaves over f64 thresholds, as
the host tree walk does (``Booster.refit``).
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

K_ZERO = 1e-35
#: trees summed as one group (the JAX oracle's tree_batch)
TREE_BATCH = 8


class PackedSplits(NamedTuple):
    """(T trees, R max splits, L max leaves, Kc max categories, Km max
    linear leaf features), all on one torch device."""
    slot: torch.Tensor          # (T, R) i32
    feature: torch.Tensor       # (T, R) i64 column index into X
    threshold: torch.Tensor     # (T, R) f32
    kind: torch.Tensor          # (T, R) i32  0 numerical / 1 categorical
    default_left: torch.Tensor  # (T, R) bool
    missing_type: torch.Tensor  # (T, R) i32
    num_splits: torch.Tensor    # (T,) i32
    value_of_slot: torch.Tensor  # (T, L) f32 leaf outputs by slot
    tree_class: torch.Tensor    # (T,) i32
    cat_values: torch.Tensor    # (T, R, Kc) i32, padded with -2
    const_of_slot: torch.Tensor  # (T, L) f32 linear constant terms by slot
    coeff: torch.Tensor         # (T, L, Km) f32 leaf coefficients
    coeff_feat: torch.Tensor    # (T, L, Km) i64 column index into X
    coeff_mask: torch.Tensor    # (T, L, Km) bool valid coefficient slots


def pack_splits(trees: List, num_class: int = 1,
                device: torch.device = torch.device("cpu")):
    """Pack host Tree models into device tensors (raw-value routing).
    Returns ``(pack, has_cat, has_linear)``."""
    T = max(len(trees), 1)
    arrs = [t.to_split_arrays() for t in trees] or \
        [dict(slot=np.zeros(0, np.int32), feature=np.zeros(0, np.int32),
              threshold=np.zeros(0), kind=np.zeros(0, np.int32),
              default_left=np.zeros(0, bool),
              missing_type=np.zeros(0, np.int32),
              cat_values={}, leaf_of_slot=np.zeros(1, np.int32))]
    R = max(max((len(a["slot"]) for a in arrs), default=0), 1)
    L = R + 1
    Kc = max((len(v) for a in arrs for v in a["cat_values"].values()),
             default=0)
    has_cat = Kc > 0
    Kc = max(Kc, 1)

    slot = np.zeros((T, R), np.int32)
    feature = np.zeros((T, R), np.int64)
    threshold = np.zeros((T, R), np.float32)
    kind = np.zeros((T, R), np.int32)
    default_left = np.zeros((T, R), bool)
    missing_type = np.zeros((T, R), np.int32)
    num_splits = np.zeros(T, np.int32)
    value_of_slot = np.zeros((T, L), np.float32)
    tree_class = np.zeros(T, np.int32)
    cat_values = np.full((T, R, Kc), -2, np.int64)
    for ti, (t, a) in enumerate(zip(trees, arrs)):
        r = len(a["slot"])
        num_splits[ti] = r
        tree_class[ti] = ti % num_class
        slot[ti, :r] = a["slot"]
        feature[ti, :r] = a["feature"]
        threshold[ti, :r] = a["threshold"]
        kind[ti, :r] = a["kind"]
        default_left[ti, :r] = a["default_left"]
        missing_type[ti, :r] = a["missing_type"]
        lv = t.leaf_value[a["leaf_of_slot"][:r + 1]] if t.num_leaves > 1 \
            else t.leaf_value[:1]
        value_of_slot[ti, :len(lv)] = lv
        for rr, cats in a["cat_values"].items():
            cat_values[ti, rr, :len(cats)] = cats
    from ..linear.pack import linear_pack_arrays
    const_of_slot, coeff, coeff_feat, coeff_mask, has_linear = \
        linear_pack_arrays(trees, arrs, value_of_slot)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                            dtype=dtype)

    pk = PackedSplits(
        slot=dev(slot, torch.int32),
        feature=dev(feature, torch.int64),
        threshold=dev(threshold, torch.float32),
        kind=dev(kind, torch.int32),
        default_left=dev(default_left, torch.bool),
        missing_type=dev(missing_type, torch.int32),
        num_splits=dev(num_splits, torch.int32),
        value_of_slot=dev(value_of_slot, torch.float32),
        tree_class=dev(tree_class, torch.int32),
        cat_values=dev(cat_values, torch.int32),
        const_of_slot=dev(const_of_slot, torch.float32),
        coeff=dev(coeff, torch.float32),
        coeff_feat=dev(coeff_feat, torch.int64),
        coeff_mask=dev(coeff_mask, torch.bool))
    return pk, has_cat, has_linear


def _route_trees(X: torch.Tensor, pk: PackedSplits,
                 has_cat: bool) -> torch.Tensor:
    """Route all rows through every packed tree -> (T, N) leaf slots
    (tree.h NumericalDecision: NaN follows the default direction for
    MissingType::NaN, otherwise becomes 0; zeros follow it for
    MissingType::Zero)."""
    T, R = pk.slot.shape
    n = X.shape[0]
    slots = torch.zeros((T, n), dtype=torch.int32, device=X.device)
    rounds = int(pk.num_splits.max()) if T else 0
    Xt = X.t()
    for r in range(min(rounds, R)):
        col = Xt[pk.feature[:, r]]                        # (T, N)
        mt = pk.missing_type[:, r, None]
        dl = pk.default_left[:, r, None]
        nan = torch.isnan(col)
        v = torch.where(nan & (mt != 2), 0.0, col)
        go = v <= pk.threshold[:, r, None]
        go = torch.where((mt == 2) & nan, dl, go)
        go = torch.where((mt == 1) & (v.abs() <= K_ZERO), dl, go)
        if has_cat:
            iv = torch.where(torch.isfinite(col), col, -1.0).to(torch.int32)
            in_set = (iv[:, :, None]
                      == pk.cat_values[:, r, None, :]).any(dim=2)
            go = torch.where(pk.kind[:, r, None] > 0, in_set, go)
        move = (slots == pk.slot[:, r, None]) & ~go \
            & (r < pk.num_splits)[:, None]
        slots = torch.where(move, r + 1, slots)
    return slots


def halving_sum(rows: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 in XLA's reduce association: recursive halving over
    the next power of two with zero pads, ``((v0+v4)+(v2+v6)) +
    ((v1+v5)+(v3+v7))`` for 8 terms (the JAX oracle's group sum)."""
    n = 1
    while n < rows.shape[0]:
        n *= 2
    if n != rows.shape[0]:
        pad = rows.new_zeros((n - rows.shape[0],) + tuple(rows.shape[1:]))
        rows = torch.cat([rows, pad])
    while rows.shape[0] > 1:
        half = rows.shape[0] // 2
        rows = rows[:half] + rows[half:]
    return rows[0]


def group_class_sums(v: torch.Tensor, cls: torch.Tensor,
                     num_class: int) -> torch.Tensor:
    """(G, N) leaf values of one group of trees and their (G,) classes ->
    (N, K): each class's values added in tree order from 0, the other
    classes' trees adding 0 (the kernels' per-lane order)."""
    onehot = (cls[:, None] == torch.arange(num_class, device=cls.device)
              ).to(v.dtype)
    part = v.new_zeros((v.shape[1], num_class))
    for i in range(v.shape[0]):
        part = part + v[i][:, None] * onehot[i][None, :]
    return part


def accumulate_scores(vals: torch.Tensor, tree_class: torch.Tensor,
                      num_class: int) -> torch.Tensor:
    """(T, N) per-tree leaf values -> (N,) or (N, K) raw scores, summed in
    the oracle's order: groups of ``TREE_BATCH`` trees, chained in tree
    order from 0; a binary group in halving association, a multiclass
    group per class in tree order (:func:`group_class_sums`)."""
    T, n = vals.shape
    pad = (-T) % TREE_BATCH
    if pad:
        vals = torch.cat([vals, vals.new_zeros((pad, n))])
        tree_class = torch.cat([tree_class, tree_class.new_zeros(pad)])
    shape = (n, num_class) if num_class > 1 else (n,)
    score = torch.zeros(shape, dtype=torch.float32, device=vals.device)
    for g in range(0, vals.shape[0], TREE_BATCH):
        v = vals[g:g + TREE_BATCH]
        if num_class > 1:
            score = score + group_class_sums(
                v, tree_class[g:g + TREE_BATCH], num_class)
        else:
            score = score + halving_sum(v)
    return score


def predict_raw_impl(X: torch.Tensor, pack: PackedSplits, *,
                     num_class: int = 1, has_cat: bool = False,
                     has_linear: bool = False) -> torch.Tensor:
    """(N, F) raw rows -> (N,) or (N, K) f32 raw ensemble scores."""
    from ..linear.pack import linear_values_by_row

    X = X.to(torch.float32)
    slots = _route_trees(X, pack, has_cat)                 # (T, N)
    if has_linear:
        vals = linear_values_by_row(
            X, slots, pack.value_of_slot, pack.const_of_slot, pack.coeff,
            pack.coeff_feat, pack.coeff_mask)
    else:
        vals = torch.gather(pack.value_of_slot, 1, slots.long())
    return accumulate_scores(vals, pack.tree_class, num_class)


def predict_raw(X: torch.Tensor, pack: PackedSplits, *, walk=None,
                num_class: int = 1, has_cat: bool = False,
                has_linear: bool = False) -> torch.Tensor:
    """(N, F) raw rows -> (N,) or (N, K) f32 raw ensemble scores.

    A CPU ``X`` runs the plain twin :func:`predict_raw_impl`. A CUDA ``X``
    launches the raw-threshold walk once, over ``walk`` (the pack's
    ``ops/forest.raw_walk``, which a caller that serves the pack keeps
    beside it; derived here when None), or raises: there is no
    fallback."""
    if X.device.type == "cpu":
        return predict_raw_impl(X, pack, num_class=num_class,
                                has_cat=has_cat, has_linear=has_linear)
    from .forest import forest_raw_impl, raw_walk

    if walk is None:
        walk = raw_walk(pack)
    return forest_raw_impl(X, walk, num_class=num_class, has_cat=has_cat,
                           has_linear=has_linear)


def leaf_indices(trees: List, X: torch.Tensor) -> torch.Tensor:
    """(T, N) int64 leaf index of each of ``X``'s rows in each tree, routed
    on ``X``'s device over f64 values and f64 thresholds: the decisions of
    the host walk ``Tree.predict_leaf_index`` (refit's leaf indices)."""
    pk, has_cat, _ = pack_splits(trees, device=X.device)
    T, R = pk.slot.shape
    thr = np.zeros((T, R), np.float64)
    leaf_of_slot = np.zeros((T, R + 1), np.int64)
    for ti, t in enumerate(trees):
        a = t.to_split_arrays()
        r = len(a["slot"])
        thr[ti, :r] = a["threshold"]
        leaf_of_slot[ti, :r + 1] = a["leaf_of_slot"][:r + 1]
    pk = pk._replace(threshold=torch.as_tensor(thr).to(X.device))
    slots = _route_trees(X.to(torch.float64), pk, has_cat)
    return torch.gather(torch.as_tensor(leaf_of_slot).to(X.device), 1,
                        slots.long())


def split_bin_table(a, dataset):
    """Per-split BIN-space routing quantities for one tree's
    ``to_split_arrays`` dict: the single conversion shared by
    ``tree_to_bin_log`` (go_left tables for ``assign_leaves``) and the
    forest repack (``ops/forest.py`` split-major node tables).

    Returns a dict of per-split arrays — ``feature`` (inner index),
    ``tbin`` (threshold bin: go left iff ``bin <= tbin``), ``miss_bin``/
    ``movable`` (missing-bin override), ``valid`` (False where the split
    feature has no inner index in the dataset), ``exact`` (False where a
    numerical threshold is not the upper bound of its bin ``tbin``: BIN
    routing then sends that bin's rows above the threshold left, so it
    differs from the raw thresholds; a model trained on other bins, such
    as an online continue-mode candidate) — plus ``cat_bins`` mapping
    categorical split index -> bins routed LEFT."""
    from .binning import BIN_CATEGORICAL, MISSING_NAN, MISSING_ZERO

    r = len(a["slot"])
    feature = np.zeros(r, np.int32)
    tbin = np.zeros(r, np.int32)
    miss_bin = np.zeros(r, np.int32)
    movable = np.zeros(r, bool)
    valid = np.ones(r, bool)
    exact = np.ones(r, bool)
    cat_bins = {}
    for i in range(r):
        inner = dataset.inner_feature_index(int(a["feature"][i]))
        if inner < 0:
            valid[i] = False
            continue
        m = dataset.bin_mappers[inner]
        feature[i] = inner
        if a["kind"][i]:
            cats = a["cat_values"].get(i, np.array([], np.int64))
            cat_bins[i] = np.flatnonzero(
                np.isin(m.categories, cats)).astype(np.int64)
        else:
            tb = int(np.searchsorted(m.upper_bounds, float(a["threshold"][i]),
                                     side="left"))
            tb = min(tb, m.num_bins - 1)
            tbin[i] = tb
            exact[i] = m.upper_bounds[tb] == float(a["threshold"][i])
            if m.missing_type in (MISSING_ZERO, MISSING_NAN) \
                    and m.bin_type != BIN_CATEGORICAL:
                miss_bin[i] = m.missing_bin
                movable[i] = True
    return dict(feature=feature, tbin=tbin, miss_bin=miss_bin,
                movable=movable, valid=valid, exact=exact,
                cat_bins=cat_bins)


def tree_to_bin_log(tree, dataset, device: torch.device = torch.device("cpu")):
    """Convert a host Tree into a TreeLog routing in BIN space over the
    dataset's (bundled) matrix, on ``device`` — the input of
    ``assign_leaves`` for binned serving and score replay."""
    from ..learner import TreeLog

    a = tree.to_split_arrays()
    r = len(a["slot"])
    num_bin = int(dataset.feature_num_bins().max()) if dataset.num_features \
        else 1
    # pad the split count to a power-of-two bucket, as the JAX package does
    rp = 16
    while rp < r:
        rp *= 2
    tbl_r = split_bin_table(a, dataset)
    feature = np.zeros(rp, np.int32)
    tbin = np.zeros(rp, np.int32)
    kind = np.zeros(rp, np.int32)
    miss_bin = np.zeros(rp, np.int32)
    movable = np.zeros(rp, bool)
    go_left = np.zeros((rp, num_bin), bool)
    b_iota = np.arange(num_bin)
    feature[:r] = tbl_r["feature"]
    tbin[:r] = tbl_r["tbin"]
    miss_bin[:r] = tbl_r["miss_bin"]
    movable[:r] = tbl_r["movable"]
    for i in range(r):
        if not tbl_r["valid"][i]:
            continue
        if a["kind"][i]:
            kind[i] = 1
            go_left[i, tbl_r["cat_bins"][i]] = True
        else:
            tbl = b_iota <= tbin[i]
            if movable[i]:
                tbl = tbl.copy()
                tbl[miss_bin[i]] = bool(a["default_left"][i])
            go_left[i] = tbl
    slot = np.zeros(rp, np.int32)
    slot[:r] = a["slot"]
    default_left = np.zeros(rp, bool)
    default_left[:r] = a["default_left"]
    leaf_value = np.zeros(rp + 1, np.float32)
    leaf_value[:r + 1] = tree.leaf_value[a["leaf_of_slot"][:r + 1]] \
        if r else tree.leaf_value[:1]

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device)

    return TreeLog(
        num_splits=dev(np.array([r], np.int32)),
        split_leaf=dev(slot),
        feature=dev(feature),
        bin=dev(tbin),
        kind=dev(kind),
        default_left=dev(default_left),
        gain=torch.zeros(rp, dtype=torch.float32, device=device),
        left_sum=torch.zeros((rp, 3), dtype=torch.float32, device=device),
        right_sum=torch.zeros((rp, 3), dtype=torch.float32, device=device),
        go_left=dev(go_left),
        miss_bin=dev(miss_bin),
        movable=dev(movable),
        leaf_value=dev(leaf_value),
        leaf_sum=torch.zeros((rp + 1, 3), dtype=torch.float32, device=device),
        row_leaf=torch.zeros(1, dtype=torch.int32, device=device),
    )
