"""Row router: the whole tree's split log in one pass (PyTorch port of
``lightgbm_tpu/ops/route.py``).

:func:`route_rows` applies every round of one tree to every row of the
transposed bin matrix and returns each row's leaf id. On a CUDA tensor it
launches the hand-written kernel ``csrc/route_rows.cu`` (one thread per
row, the round table in shared memory); on a CPU tensor it runs
:func:`route_rows_plain`, the same arithmetic as plain torch ops, which is
also the reference the card's kernel is held to.

Scope, as in the JAX package: numerical splits, with or without EFB
bundles. Categorical trees need a per-row (B,)-table lookup and stay on
the plain router in ``learner.assign_leaves``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .kernels import CudaKernel, register, stream_of

# table layout: per round r the columns are
#   0 col      matrix column to read (bundle group or feature)
#   1 leaf     leaf id split this round
#   2 bin      threshold bin (feature-space)
#   3 miss     movable-missing bin (-1: none)
#   4 dl       default-left flag
#   5 plain    1 = no bundle arithmetic for this column
#   6 off      bundle: sub-feature's slot offset
#   7 dpos     bundle: shared default-bin slot position
#   8 nbm1     bundle: sub-feature slots (num_bins - 1)
#   9 rest     bundle: direction of out-of-range slots
TBL_W = 10
#: rows are padded to a multiple of this (the kernel's layout unit; the
#: TPU kernel's 16384-row grid block has no counterpart here)
ROUTE_ROW_ALIGN = 128
#: rounds whose table fits the shared memory one block may use
ROUTE_MAX_ROUNDS = 232448 // (TBL_W * 4)

_P = ctypes.c_void_p
_I = ctypes.c_int
ROUTE_KERNEL = register(CudaKernel(
    "route_rows", "route_rows.cu",
    [_P, _I, _P, _I, _P, _P, _P]))


def route_rows_plain(bins_t: torch.Tensor, table: torch.Tensor,
                     num_splits: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of the kernel: same inputs, same (Npad,) i32
    leaf ids, one vectorised pass over all rows per round."""
    F = bins_t.shape[0]
    flat = bins_t.reshape(F, -1)
    tbl = table.reshape(-1, TBL_W).tolist()
    ns = min(int(num_splits.reshape(-1)[0]), len(tbl))
    state = torch.zeros(flat.shape[1], dtype=torch.int32,
                        device=bins_t.device)
    for r in range(ns):
        col_idx, leaf, tbin, miss, dl, plain, off, dpos, nbm1, rest = tbl[r]
        col = flat[col_idx].to(torch.int32)
        if plain == 1:
            eff = col
        else:
            rank = col - off
            eff = rank + (rank >= dpos).to(torch.int32)
        go = eff <= tbin
        if miss >= 0:
            go = torch.where(eff == miss, bool(dl), go)
        if plain != 1:
            in_range = (col >= off) & (col < off + nbm1)
            go = torch.where(in_range, go, bool(rest))
        state = torch.where((state == leaf) & ~go, r + 1, state)
    return state


def route_rows(bins_t: torch.Tensor, table: torch.Tensor,
               num_splits: torch.Tensor) -> torch.Tensor:
    """(F, Npad/128, 128) u8 bins + (R*TBL_W,) i32 table + device scalar
    num_splits -> (Npad,) i32 leaf ids. Padding rows route harmlessly
    (callers slice [:n])."""
    if bins_t.dim() != 3 or bins_t.shape[2] != ROUTE_ROW_ALIGN:
        raise ValueError("route_rows: bins_t must be (F, Npad/128, 128), "
                         "got %s" % (tuple(bins_t.shape),))
    if bins_t.dtype != torch.uint8:
        raise TypeError("route_rows: bins_t must be uint8, got %s"
                        % bins_t.dtype)
    if table.dtype != torch.int32 or table.dim() != 1 \
            or table.numel() % TBL_W:
        raise ValueError("route_rows: table must be a flat int32 tensor "
                         "of R*%d entries" % TBL_W)
    if num_splits.dtype != torch.int32 or num_splits.numel() != 1:
        raise ValueError("route_rows: num_splits must be one int32")
    if bins_t.device.type == "cpu":
        return route_rows_plain(bins_t, table, num_splits)
    if bins_t.device.type != "cuda":
        raise RuntimeError("route_rows: no kernel for device %s"
                           % bins_t.device)
    for name, t in (("table", table), ("num_splits", num_splits)):
        if t.device != bins_t.device:
            raise ValueError("route_rows: %s is on %s, bins_t on %s"
                             % (name, t.device, bins_t.device))
    if not (bins_t.is_contiguous() and table.is_contiguous()):
        raise ValueError("route_rows: inputs must be contiguous")
    rounds = table.numel() // TBL_W
    if rounds > ROUTE_MAX_ROUNDS:
        raise ValueError("route_rows: %d rounds exceed the %d a block's "
                         "shared memory holds" % (rounds, ROUTE_MAX_ROUNDS))
    npad = bins_t.shape[1] * ROUTE_ROW_ALIGN
    out = torch.empty(npad, dtype=torch.int32, device=bins_t.device)
    if npad:
        ROUTE_KERNEL.launch(bins_t.data_ptr(), npad, table.data_ptr(),
                            rounds, num_splits.data_ptr(), out.data_ptr(),
                            stream_of(bins_t))
    return out


def build_route_table(log, bundle: Optional[dict]) -> torch.Tensor:
    """Assemble the per-round (R*TBL_W,) i32 table from a TreeLog, on the
    log's device (all gathers are over (R,)-sized tensors)."""
    feat = log.feature.long()
    if bundle is not None:
        colv = bundle["group"][feat]
        plain = ~bundle["has_rest"][feat]
        off = bundle["offset"][feat]
        dpos = bundle["dpos"][feat]
        nbm1 = bundle["nbm1"][feat]
        rest = torch.gather(log.go_left, 1, dpos.long()[:, None])[:, 0]
    else:
        colv = feat
        plain = torch.ones_like(feat, dtype=torch.bool)
        off = torch.zeros_like(feat)
        dpos = torch.zeros_like(feat)
        nbm1 = torch.zeros_like(feat)
        rest = torch.zeros_like(feat, dtype=torch.bool)
    miss = torch.where(log.movable, log.miss_bin, -1)
    cols = [colv, log.split_leaf, log.bin, miss, log.default_left, plain,
            off, dpos, nbm1, rest]
    return torch.stack([c.to(torch.int32) for c in cols], dim=1).reshape(-1)
