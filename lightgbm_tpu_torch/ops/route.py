"""Row router: the whole tree's split log in one pass (PyTorch port of
``lightgbm_tpu/ops/route.py``).

:func:`route_rows` applies every round of one tree to every row of the
transposed bin matrix and returns each row's leaf id. On a CUDA tensor it
launches the hand-written kernel ``csrc/route_rows.cu`` (a walk per row:
the table and each round's child links in shared memory, the rows' bins
staged a tile at a time, sized by :func:`route_plan`); on a CPU tensor it
runs :func:`route_rows_plain`, the same arithmetic as plain torch ops,
round by round, which is also the reference the card's kernel is held
to.

Scope, as in the JAX package: numerical splits, with or without EFB
bundles. Categorical trees need a per-row (B,)-table lookup and stay on
the plain router in ``learner.assign_leaves``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .kernels import CudaKernel, register, stream_of
from .partition import sm_count

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
#: shared memory a block of the kernel may take (the card's opt-in limit
#: less a little static room)
ROUTE_SMEM_BYTES = 232448 - 64


def route_table_bytes(rounds: int) -> int:
    """Shared memory of a ``rounds``-round table in the kernel: a 32-byte
    entry per round (bins, flags, links) and a 4-byte sort key per round,
    padded to a power of two, 16-byte aligned."""
    keys = 1
    while keys < rounds:
        keys *= 2
    return (32 * rounds + 4 * keys + 15) // 16 * 16


#: rounds whose table fits a block's shared memory (the kernel then reads
#: the bins from device memory)
ROUTE_MAX_ROUNDS = max(r for r in range(1, 8193)
                       if route_table_bytes(r) <= ROUTE_SMEM_BYTES)
#: rows of a tile (one a thread of a 256-thread block), the bytes past a
#: tile's rows in each column's stripe, and the blocks per SM the grid asks
#: for (their warps hide each other's chains of dependent loads)
ROUTE_TILE_ROWS = 256
ROUTE_STRIPE_PAD = 16
ROUTE_BLOCKS_PER_SM = 8

_P = ctypes.c_void_p
_I = ctypes.c_int
ROUTE_KERNEL = register(CudaKernel(
    "route_rows", "route_rows.cu",
    [_P, _I, _I, _P, _I, _P, _I, _I, _I, _P, _P]))


class RoutePlan(NamedTuple):
    """The launch of one router call (csrc/route_rows.cu)."""
    staged: bool      # the tiles' bins are staged in shared memory
    grid: int         # blocks; each strides over the tiles
    smem: int         # dynamic shared memory of a block


@functools.lru_cache(maxsize=1024)
def route_plan(npad: int, num_cols: int, rounds: int,
               sms: int) -> RoutePlan:
    """Size a router call over ``npad`` rows (a multiple of
    ROUTE_ROW_ALIGN) of ``num_cols`` columns with a ``rounds``-round table
    on a card of ``sms`` SMs. A block holds the table
    (:func:`route_table_bytes`) and stages ROUTE_TILE_ROWS-row tiles of
    every column in two buffers (ROUTE_STRIPE_PAD bytes past each column's
    rows) when they fit ROUTE_SMEM_BYTES beside it; else it reads the bins
    from device memory. The grid strides over the tiles, at most
    ROUTE_BLOCKS_PER_SM blocks per SM, so the table's prologue runs once
    per block."""
    if rounds > ROUTE_MAX_ROUNDS:
        raise ValueError("route_rows: %d rounds exceed the %d a block's "
                         "shared memory holds" % (rounds, ROUTE_MAX_ROUNDS))
    ent = route_table_bytes(rounds)
    staged = ent + 2 * num_cols * (ROUTE_TILE_ROWS + ROUTE_STRIPE_PAD)
    grid = max(1, min(-(-npad // ROUTE_TILE_ROWS), sms * ROUTE_BLOCKS_PER_SM))
    if staged <= ROUTE_SMEM_BYTES:
        return RoutePlan(True, grid, staged)
    return RoutePlan(False, grid, ent)


def route_rows_plain(bins_t: torch.Tensor, table: torch.Tensor,
                     num_splits: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of the kernel: same inputs, same (Npad,) i32
    leaf ids. Each round's direction is a function of the column's byte
    alone, so it is tabulated first for all rounds and all 256 byte values
    (the table's arithmetic on an (R, 256) grid); then one pass over all
    rows per round looks it up. Every round of the table runs, rounds at
    or past ``num_splits`` leaving the leaf ids as they are, so nothing is
    read back to the host (the device tree loop routes through it on host
    tensors)."""
    F = bins_t.shape[0]
    flat = bins_t.reshape(F, -1)
    tbl = table.reshape(-1, TBL_W).to(torch.int64)
    (col_idx, leaf, tbin, miss, dl, plain, off, dpos, nbm1,
     rest) = (c[:, None] for c in tbl.unbind(1))
    v = torch.arange(256, dtype=torch.int64, device=bins_t.device)[None, :]
    rank = v - off
    bundled = plain != 1
    eff = torch.where(bundled, rank + (rank >= dpos).to(torch.int64), v)
    go = eff <= tbin
    go = torch.where((miss >= 0) & (eff == miss), dl != 0, go)
    in_range = (v >= off) & (v < off + nbm1)
    go = torch.where(bundled & ~in_range, rest != 0, go)          # (R, 256)
    cols = col_idx[:, 0].clamp(0, F - 1)
    ns = num_splits.reshape(-1)[0]
    state = torch.zeros(flat.shape[1], dtype=torch.int32,
                        device=bins_t.device)
    for r in range(tbl.shape[0]):
        col = flat.index_select(0, cols[r:r + 1])[0].long()
        right = ~go[r].index_select(0, col)
        state = torch.where((state == leaf[r]) & right & (ns > r),
                            torch.full_like(state, r + 1), state)
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
    npad = bins_t.shape[1] * ROUTE_ROW_ALIGN
    plan = route_plan(npad, bins_t.shape[0], rounds,
                      sm_count(bins_t.device.index))
    out = torch.empty(npad, dtype=torch.int32, device=bins_t.device)
    if npad:
        ROUTE_KERNEL.launch(bins_t.data_ptr(), bins_t.shape[0], npad,
                            table.data_ptr(), rounds, num_splits.data_ptr(),
                            int(plan.staged), plan.grid, plan.smem,
                            out.data_ptr(), stream_of(bins_t))
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
