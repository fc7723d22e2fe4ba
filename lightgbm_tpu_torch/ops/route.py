"""Row router: the whole tree's split log in one pass (PyTorch port of
``lightgbm_tpu/ops/route.py``).

:func:`route_rows` applies every round of one tree to every row of the
transposed bin matrix and returns each row's leaf id. On a CUDA tensor it
launches the hand-written kernel ``csrc/route_rows.cu`` (entry point
``route_rows``; ``route_rows_cat`` with a categorical table;
``route_rows_u16`` for the u16 bins of the dense builder's matrices past
256 bins, with or without one): a walk per
row, the table and each round's child links in shared memory, the rows'
bins staged a tile at a time, sized by :func:`route_plan`; on a CPU tensor it
runs :func:`route_rows_plain`, the same arithmetic as plain torch ops,
round by round, which is also the reference the card's kernel is held
to.

Numerical splits, with or without EFB bundles, as in the JAX package's
router; and, beyond it, categorical splits: given the per-round
categorical table (:func:`build_cat_table`: a kind flag and the split's
go-left set, 32 W bits), a categorical round sends a row left when its
column's bin is in the set, as the JAX package's round-by-round
``fori_loop`` (``lightgbm_tpu/learner.py`` ``assign_leaves``) does with its
(B,) table.
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
#: the categorical table, per round: 0 kind (> 0: a categorical round),
#: then the go-left set, bit b of word b // 32 for bin b: CAT_WORDS words
#: for u8 bins, more for u16 bins past 256 (:func:`build_cat_table`)
CAT_W = 9
CAT_WORDS = 8
#: rows are padded to a multiple of this (the kernel's layout unit; the
#: TPU kernel's 16384-row grid block has no counterpart here)
ROUTE_ROW_ALIGN = 128
#: shared memory a block of the kernel may take (the card's opt-in limit
#: less a little static room)
ROUTE_SMEM_BYTES = 232448 - 64


def route_table_bytes(rounds: int, categorical: bool = False,
                      cat_words: int = CAT_WORDS) -> int:
    """Shared memory of a ``rounds``-round table in the kernel: a 32-byte
    entry per round (bins, flags, links), with a categorical table also
    each round's go-left set (``cat_words`` words), and a 4-byte sort key
    per round, padded to a power of two, 16-byte aligned."""
    keys = 1
    while keys < rounds:
        keys *= 2
    ent = 32 + 4 * cat_words if categorical else 32
    return (ent * rounds + 4 * keys + 15) // 16 * 16


#: rounds whose table fits a block's shared memory (the kernel then reads
#: the bins from device memory), without and with a categorical table
ROUTE_MAX_ROUNDS = max(r for r in range(1, 8193)
                       if route_table_bytes(r) <= ROUTE_SMEM_BYTES)
ROUTE_MAX_ROUNDS_CAT = max(r for r in range(1, 8193)
                           if route_table_bytes(r, True) <= ROUTE_SMEM_BYTES)
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
#: the router with a categorical table (its own entry point, so its
#: launches count apart)
ROUTE_CAT_KERNEL = register(CudaKernel(
    "route_rows_cat", "route_rows.cu",
    [_P, _I, _I, _P, _I, _P, _P, _I, _I, _I, _P, _P]))
#: the router over u16 bins (the dense builder past 256 bins), with or
#: without a categorical table of any width
ROUTE_U16_KERNEL = register(CudaKernel(
    "route_rows_u16", "route_rows.cu",
    [_P, _I, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P]))


class RoutePlan(NamedTuple):
    """The launch of one router call (csrc/route_rows.cu)."""
    staged: bool      # the tiles' bins are staged in shared memory
    grid: int         # blocks; each strides over the tiles
    smem: int         # dynamic shared memory of a block


@functools.lru_cache(maxsize=1024)
def route_plan(npad: int, num_cols: int, rounds: int, sms: int,
               categorical: bool = False, elem: int = 1,
               cat_words: int = CAT_WORDS) -> RoutePlan:
    """Size a router call over ``npad`` rows (a multiple of
    ROUTE_ROW_ALIGN) of ``num_cols`` columns with a ``rounds``-round table
    on a card of ``sms`` SMs. A block holds the table
    (:func:`route_table_bytes`) and stages ROUTE_TILE_ROWS-row tiles of
    every column in two buffers (ROUTE_STRIPE_PAD bytes past each column's
    rows) when they fit ROUTE_SMEM_BYTES beside it; else it reads the bins
    from device memory. The grid strides over the tiles, at most
    ROUTE_BLOCKS_PER_SM blocks per SM, so the table's prologue runs once
    per block. ``categorical``: the table carries each round's go-left
    set too (``cat_words`` words a round). ``elem`` is the bins' bytes (1
    for u8, 2 for u16)."""
    ent = route_table_bytes(rounds, categorical, cat_words)
    if ent > ROUTE_SMEM_BYTES:
        raise ValueError("route_rows: %d rounds exceed what a block's "
                         "shared memory holds" % rounds)
    staged = ent + 2 * num_cols * (ROUTE_TILE_ROWS * elem + ROUTE_STRIPE_PAD)
    grid = max(1, min(-(-npad // ROUTE_TILE_ROWS), sms * ROUTE_BLOCKS_PER_SM))
    if staged <= ROUTE_SMEM_BYTES:
        return RoutePlan(True, grid, staged)
    return RoutePlan(False, grid, ent)


def cat_go_table(cat: torch.Tensor, rounds: int) -> tuple:
    """(R,) bool categorical-round flags and the (R, 32 W) bool go-left
    sets of a (R * (1 + W),) i32 categorical table."""
    c = cat.reshape(rounds, -1).to(torch.int64)
    words = c[:, 1:] & 0xFFFFFFFF                               # (R, W)
    bit = torch.arange(32, dtype=torch.int64, device=cat.device)
    sets = ((words[:, :, None] >> bit) & 1).reshape(rounds, -1) != 0
    return c[:, 0] > 0, sets


def route_rows_plain(bins_t: torch.Tensor, table: torch.Tensor,
                     num_splits: torch.Tensor,
                     cat: Optional[torch.Tensor] = None,
                     num_values: int = 256) -> torch.Tensor:
    """Plain torch twin of the kernel: same inputs, same (Npad,) i32
    leaf ids. Each round's direction is a function of the column's bin
    alone, so it is tabulated first for all rounds and all ``num_values``
    bin values (256 for u8; every bin value present for u16) (the table's
    arithmetic on an (R, V) grid; a categorical round's row is its go-left
    set, a bin past the set not in it); then one pass over all rows per
    round looks it up. Every round of the table runs, rounds at or past ``num_splits``
    leaving the leaf ids as they are, so nothing is read back to the host
    (the device tree loop routes through it on host tensors)."""
    F = bins_t.shape[0]
    flat = bins_t.reshape(F, -1)
    tbl = table.reshape(-1, TBL_W).to(torch.int64)
    (col_idx, leaf, tbin, miss, dl, plain, off, dpos, nbm1,
     rest) = (c[:, None] for c in tbl.unbind(1))
    nv = int(num_values)
    v = torch.arange(nv, dtype=torch.int64, device=bins_t.device)[None, :]
    rank = v - off
    bundled = plain != 1
    eff = torch.where(bundled, rank + (rank >= dpos).to(torch.int64), v)
    go = eff <= tbin
    go = torch.where((miss >= 0) & (eff == miss), dl != 0, go)
    in_range = (v >= off) & (v < off + nbm1)
    go = torch.where(bundled & ~in_range, rest != 0, go)          # (R, V)
    if cat is not None:
        is_cat, sets = cat_go_table(cat, tbl.shape[0])
        w = min(nv, sets.shape[1])
        sets = torch.cat([sets[:, :w], torch.zeros(
            (sets.shape[0], nv - w), dtype=torch.bool, device=sets.device)],
            dim=1)
        go = torch.where(is_cat[:, None], sets, go)
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
               num_splits: torch.Tensor,
               cat: Optional[torch.Tensor] = None,
               num_values: int = 256) -> torch.Tensor:
    """(F, Npad/128, 128) u8 or u16 (an int16 view) bins + (R*TBL_W,) i32
    table + device scalar num_splits -> (Npad,) i32 leaf ids. ``cat``, the
    (R * (1 + W),) i32 categorical table (:func:`build_cat_table`), routes
    categorical rounds by their go-left sets. ``num_values`` bounds the
    bin values (256 for u8; the twin tabulates over it). Padding rows
    route harmlessly (callers slice [:n])."""
    if bins_t.dim() != 3 or bins_t.shape[2] != ROUTE_ROW_ALIGN:
        raise ValueError("route_rows: bins_t must be (F, Npad/128, 128), "
                         "got %s" % (tuple(bins_t.shape),))
    if bins_t.dtype not in (torch.uint8, torch.int16, torch.uint16):
        raise TypeError("route_rows: bins_t must be uint8 or 16-bit, got %s"
                        % bins_t.dtype)
    if table.dtype != torch.int32 or table.dim() != 1 \
            or table.numel() % TBL_W:
        raise ValueError("route_rows: table must be a flat int32 tensor "
                         "of R*%d entries" % TBL_W)
    if num_splits.dtype != torch.int32 or num_splits.numel() != 1:
        raise ValueError("route_rows: num_splits must be one int32")
    rounds = table.numel() // TBL_W
    u8 = bins_t.dtype == torch.uint8
    cat_words = CAT_WORDS
    if cat is not None:
        cat_words = cat.numel() // max(1, rounds) - 1
        if cat.dtype != torch.int32 or cat.dim() != 1 or cat_words < 1 \
                or cat.numel() != rounds * (1 + cat_words) \
                or (u8 and cat_words != CAT_WORDS):
            raise ValueError("route_rows: cat must be a flat int32 tensor of "
                             "R*(1 + W) entries (W = %d for u8 bins)"
                             % CAT_WORDS)
    if bins_t.device.type == "cpu":
        return route_rows_plain(bins_t, table, num_splits, cat,
                                256 if u8 else num_values)
    if bins_t.device.type != "cuda":
        raise RuntimeError("route_rows: no kernel for device %s"
                           % bins_t.device)
    extra = () if cat is None else (("cat", cat),)
    for name, t in (("table", table), ("num_splits", num_splits)) + extra:
        if t.device != bins_t.device:
            raise ValueError("route_rows: %s is on %s, bins_t on %s"
                             % (name, t.device, bins_t.device))
    if not (bins_t.is_contiguous() and table.is_contiguous()
            and (cat is None or cat.is_contiguous())):
        raise ValueError("route_rows: inputs must be contiguous")
    npad = bins_t.shape[1] * ROUTE_ROW_ALIGN
    plan = route_plan(npad, bins_t.shape[0], rounds,
                      sm_count(bins_t.device.index), cat is not None,
                      bins_t.element_size(), cat_words)
    out = torch.empty(npad, dtype=torch.int32, device=bins_t.device)
    if npad:
        head = (bins_t.data_ptr(), bins_t.shape[0], npad, table.data_ptr(),
                rounds, num_splits.data_ptr())
        tail = (int(plan.staged), plan.grid, plan.smem, out.data_ptr(),
                stream_of(bins_t))
        if not u8:
            ROUTE_U16_KERNEL.launch(*head, 0 if cat is None
                                    else cat.data_ptr(), cat_words, *tail)
        elif cat is None:
            ROUTE_KERNEL.launch(*head, *tail)
        else:
            ROUTE_CAT_KERNEL.launch(*head, cat.data_ptr(), *tail)
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


def build_cat_table(log) -> torch.Tensor:
    """The (R * (1 + W),) i32 categorical table of a TreeLog, on the log's
    device: per round the kind flag (``log.kind``) and the go-left row
    packed as W words of 32 bits (W = CAT_WORDS up to 256 bins, else
    enough for the row's B; bins past B are 0)."""
    go = log.go_left
    r, b = go.shape
    words_n = max(CAT_WORDS, -(-b // 32))
    if b < 32 * words_n:
        go = torch.cat([go, torch.zeros((r, 32 * words_n - b),
                                        dtype=torch.bool, device=go.device)],
                       dim=1)
    bit = torch.arange(32, dtype=torch.int64, device=go.device)
    words = (go.reshape(r, words_n, 32).to(torch.int64) << bit).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    kind = log.kind.to(torch.int64).reshape(r, 1)
    return torch.cat([kind, words], dim=1).to(torch.int32).reshape(-1)
