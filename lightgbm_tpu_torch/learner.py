"""Tree logs and binned-row routing (PyTorch port of the serving part of
``lightgbm_tpu/learner.py``).

Only what serving needs is here: the :class:`TreeLog` record, the binned
router :func:`assign_leaves` and :func:`leaf_values_by_row`. The tree
builders come with the training slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


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
