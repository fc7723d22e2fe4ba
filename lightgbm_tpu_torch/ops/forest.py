"""Forest-at-once ensemble inference (PyTorch port of
``lightgbm_tpu/ops/forest.py``).

:class:`ForestPack` is the inference-shaped repack of the ensemble: node
tables are SPLIT-MAJOR ``(R rounds, T trees)`` and thresholds live in BIN
space (the per-split conversion ``split_bin_table`` in ops/predict.py), so
every routing comparison is a small-int compare. :func:`forest_predict_impl`
evaluates the whole ensemble for a batch of rows: on a CUDA tensor it
launches the hand-written kernel ``csrc/forest_predict.cu`` once (a walk
per (row, tree) along the child links of :func:`forest_walk`, sized by
:func:`forest_plan`), on a CPU tensor it runs :func:`forest_predict_plain`,
the same front update as plain torch ops. Both sum leaf values in the
``predict_raw_impl`` oracle's grouping, so the three agree to float32
rounding (the kernel and the twin bit for bit for one class without
linear leaves).

The raw-threshold walk serves the models that have no BIN-space pack (no
bin mappers, or thresholds inside the serving bins): :func:`raw_walk`
derives its tables from a ``PackedSplits`` once per pack, and
:func:`forest_raw_impl` launches ``csrc/forest_predict.cu``'s raw entry
point over (N, F) f32 raw rows, the same walk along :func:`walk_links`
with f32 comparisons, reading a group's tables from device memory where
they do not fit a block's shared memory. It equals
``ops/predict.predict_raw_impl`` bit for bit without linear leaves;
``ops/predict.predict_raw`` is its wrapper.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .kernels import CudaKernel, register, stream_of
from .partition import sm_count
from .predict import K_ZERO, TREE_BATCH, accumulate_scores

#: Bound on the node tables' bytes for a model to be eligible (the name
#: and value of the TPU package's VMEM budget, so the same models are
#: eligible in both). On this card the tables live in device memory and
#: the kernel stages one group of trees at a time into shared memory, so
#: here it bounds device bytes, not on-chip memory.
FOREST_VMEM_BUDGET = 8 << 20

#: Trees the kernel stages and sums as one group (the oracle's
#: tree_batch, kTB in the kernel: the lanes of an 8-lane set); the pack
#: pads T to a multiple of it.
FOREST_TREE_BATCH = TREE_BATCH

#: threads of a block, and the rows one pass of them walks (one row per
#: 8-lane set)
FOREST_THREADS = 256
FOREST_PASS_ROWS = FOREST_THREADS // FOREST_TREE_BATCH
#: shared memory a block may take on an H100 (its opt-in limit less the
#: kernel's static room; the kernel refuses a plan over what it reads on
#: the card at hand), an SM's shared memory, and the most blocks an SM
#: runs (the kernel's launch bounds): the plan's sizes
FOREST_SMEM_BYTES = 232448 - 128
FOREST_SM_SMEM_BYTES = 233472
FOREST_BLOCKS_PER_SM = 4
#: the link that ends a walk (the forest kernel's links are 16-bit; the
#: raw walk's 29- and 32-bit)
FOREST_END = 0xFFFF
FOREST_RAW_END = (1 << 29) - 1
#: the feature word's flag of a categorical round, and the missing bin of
#: a round whose movable-missing bin does not change the direction (no
#: bin is INT_MIN)
FOREST_CAT = 1 << 31
FOREST_NO_MISS = -(1 << 31)


def forest_smem_bytes(rounds: int, num_cols: int, staged: bool,
                      tables: bool = True) -> int:
    """Shared memory of one block of the kernel: when ``tables``, a
    group's 16-byte node entries and f32 leaf values (``rounds + 1``
    slots), and, when ``staged``, two buffers of a pass's rows of
    ``num_cols`` 4-byte values."""
    b = FOREST_TREE_BATCH * (16 * rounds + 4 * (rounds + 1)) if tables \
        else 0
    if staged:
        b += 2 * FOREST_PASS_ROWS * num_cols * 4
    return b


#: Most routing rounds (num_leaves - 1) whose group of node entries and
#: leaf values fits the shared memory one block may use (the bins then
#: come from device memory): the forest kernel's limit, past which the
#: raw walk reads its tables from device memory.
FOREST_MAX_ROUNDS = max(r for r in range(1, FOREST_END)
                        if forest_smem_bytes(r, 0, False)
                        <= FOREST_SMEM_BYTES)


class ForestPack(NamedTuple):
    """Inference-shaped ensemble tables, BIN space, split-major, on one
    torch device.

    (R routing rounds, T trees — padded to a FOREST_TREE_BATCH multiple, L
    leaf slots, Kc max left-routing category bins, Km max linear leaf
    features). ``default_left``/``movable`` ride as i32 0/1 and
    ``coeff_mask`` as f32 0/1, as in the TPU pack.
    """
    slot: torch.Tensor          # (R, T) i32 leaf slot split in round r
    feature: torch.Tensor       # (R, T) i32 INNER feature index
    tbin: torch.Tensor          # (R, T) i32 threshold bin (left: b <= tbin)
    kind: torch.Tensor          # (R, T) i32 0 numerical / 1 categorical
    default_left: torch.Tensor  # (R, T) i32 0/1
    miss_bin: torch.Tensor      # (R, T) i32 movable-missing bin
    movable: torch.Tensor       # (R, T) i32 0/1 miss_bin overrides compare
    num_splits: torch.Tensor    # (T,) i32
    value_of_slot: torch.Tensor  # (T, L) f32 leaf outputs by slot
    tree_class: torch.Tensor    # (T,) i32
    cat_bins: torch.Tensor      # (R, T, Kc) i32 bins routed LEFT, pad -2
    # linear-leaf tables (RAW space: evaluated against the raw rows in
    # inner-feature column order)
    const_of_slot: torch.Tensor  # (T, L) f32
    coeff: torch.Tensor         # (T, L, Km) f32
    coeff_feat: torch.Tensor    # (T, L, Km) i32 inner feature index
    coeff_mask: torch.Tensor    # (T, L, Km) f32 0/1


def forest_table_bytes(fp: ForestPack) -> int:
    """Device bytes of the node tables (the eligibility bound)."""
    return int(sum(a.numel() * a.element_size() for a in fp))


def forest_pack(trees: List, dataset, num_class: int = 1,
                device: torch.device = torch.device("cpu")
                ) -> Tuple[ForestPack, bool, bool]:
    """Pack host trees into BIN-space split-major tables on ``device``.

    ``dataset`` supplies the bin mappers. Raises ``ValueError`` when a
    split's feature has no inner index in the dataset (BIN-space routing
    is undefined; the raw oracle path serves those), when a threshold lies
    inside one of its bins (BIN routing would differ from the raw
    thresholds: a model trained on other bins) or when the trees are
    deeper than the kernel's shared memory holds. Returns ``(pack,
    has_cat, has_linear)``.
    """
    from .predict import split_bin_table

    T = max(len(trees), 1)
    Tp = T + (-T) % FOREST_TREE_BATCH
    arrs = [t.to_split_arrays() for t in trees]
    tables = []
    for a in arrs:
        tbl = split_bin_table(a, dataset)
        if not bool(tbl["valid"].all()):
            raise ValueError(
                "forest pack: split feature(s) absent from the dataset's "
                "bin mappers (loaded model?) — BIN-space routing undefined")
        if not bool(tbl["exact"].all()):
            raise ValueError(
                "forest pack: %d threshold(s) inside the dataset's bins (a "
                "model trained on other bins): BIN routing would differ "
                "from the raw thresholds" % int((~tbl["exact"]).sum()))
        tables.append(tbl)
    R = max(max((len(a["slot"]) for a in arrs), default=0), 1)
    if R > FOREST_MAX_ROUNDS:
        raise ValueError("forest pack: %d routing rounds exceed the "
                         "kernel's %d" % (R, FOREST_MAX_ROUNDS))
    L = R + 1
    Kc = max((len(c) for tbl in tables for c in tbl["cat_bins"].values()),
             default=0)
    has_cat = Kc > 0
    Kc = max(Kc, 1)

    slot = np.zeros((Tp, R), np.int32)
    feature = np.zeros((Tp, R), np.int32)
    tbin = np.zeros((Tp, R), np.int32)
    kind = np.zeros((Tp, R), np.int32)
    default_left = np.zeros((Tp, R), np.int32)
    miss_bin = np.zeros((Tp, R), np.int32)
    movable = np.zeros((Tp, R), np.int32)
    num_splits = np.zeros(Tp, np.int32)
    value_of_slot = np.zeros((Tp, L), np.float32)
    tree_class = np.zeros(Tp, np.int32)
    cat_bins = np.full((Tp, R, Kc), -2, np.int64)
    for ti, (t, a, tbl) in enumerate(zip(trees, arrs, tables)):
        r = len(a["slot"])
        num_splits[ti] = r
        tree_class[ti] = ti % num_class
        slot[ti, :r] = a["slot"]
        feature[ti, :r] = tbl["feature"][:r]
        tbin[ti, :r] = tbl["tbin"][:r]
        kind[ti, :r] = a["kind"]
        default_left[ti, :r] = a["default_left"]
        miss_bin[ti, :r] = tbl["miss_bin"][:r]
        movable[ti, :r] = tbl["movable"][:r]
        lv = t.leaf_value[a["leaf_of_slot"][:r + 1]] if t.num_leaves > 1 \
            else t.leaf_value[:1]
        value_of_slot[ti, :len(lv)] = lv
        for rr, bins_left in tbl["cat_bins"].items():
            cat_bins[ti, rr, :len(bins_left)] = bins_left
    from ..linear.pack import linear_pack_arrays
    const_of_slot, coeff, coeff_feat, coeff_mask, has_linear = \
        linear_pack_arrays(trees, arrs, value_of_slot[:T])
    # linear tables come back (T, L, Km); pad trees and remap coefficient
    # features to INNER indices (the raw rows arrive in inner order)
    Km = coeff.shape[2]
    cfeat_inner = np.zeros((Tp, L, Km), np.int32)
    if has_linear:
        inner_of = np.array(
            [dataset.inner_feature_index(j)
             for j in range(int(dataset.num_total_features))], np.int64)
        cf = np.asarray(coeff_feat, np.int64)
        mapped = inner_of[np.clip(cf, 0, len(inner_of) - 1)]
        if bool(((mapped < 0) & np.asarray(coeff_mask, bool)).any()):
            raise ValueError(
                "forest pack: linear-leaf feature absent from the "
                "dataset's bin mappers — raw gather column undefined")
        cfeat_inner[:T] = np.where(np.asarray(coeff_mask, bool),
                                   np.clip(mapped, 0, None), 0)

    def pad(a):
        out = np.zeros((Tp,) + a.shape[1:], a.dtype)
        out[:T] = a
        return out

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                            dtype=dtype)

    fp = ForestPack(
        slot=dev(slot.T, torch.int32),
        feature=dev(feature.T, torch.int32),
        tbin=dev(tbin.T, torch.int32),
        kind=dev(kind.T, torch.int32),
        default_left=dev(default_left.T, torch.int32),
        miss_bin=dev(miss_bin.T, torch.int32),
        movable=dev(movable.T, torch.int32),
        num_splits=dev(num_splits, torch.int32),
        value_of_slot=dev(value_of_slot, torch.float32),
        tree_class=dev(tree_class, torch.int32),
        cat_bins=dev(np.transpose(cat_bins, (1, 0, 2)), torch.int32),
        const_of_slot=dev(pad(np.asarray(const_of_slot)), torch.float32),
        coeff=dev(pad(np.asarray(coeff)), torch.float32),
        coeff_feat=dev(cfeat_inner, torch.int32),
        coeff_mask=dev(pad(np.asarray(coeff_mask, np.float32)),
                       torch.float32))
    return fp, has_cat, bool(has_linear)


class ForestWalk(NamedTuple):
    """The kernel's view of a :class:`ForestPack`, derived once per pack
    (:func:`forest_walk`) and kept beside it: per round r and tree t a
    16-byte node entry, and the round where each tree's walk starts."""
    nodes: torch.Tensor   # (R, T, 4) i32 {feature | FOREST_CAT, tbin,
    #                       miss, next_left | next_right << 16}
    first: torch.Tensor   # (T,) i32 first round that splits slot 0


def forest_walk(fp: ForestPack) -> ForestWalk:
    """Node entries and child links of ``fp``, on its device, with torch
    ops over all trees at once (no host sync).

    For round r < ns = min(num_splits, R) of tree t: ``next_left[r]`` is
    the first r' > r (r' < ns) that splits the same slot (a row that goes
    left keeps its slot) and ``next_right[r]`` the first r' > r that
    splits slot r + 1 (a right child's slot); FOREST_END where there is
    none. The links come from each tree's rounds keyed slot << 16 | r and
    sorted: next_left is the next key if it has the same slot, next_right
    and the walk's start (the first round that splits slot 0) are
    searches. Rounds at or past ns are padding: they get no key, so no
    link leads to them, and a tree with ns = 0 starts at FOREST_END (its
    rows stay at slot 0). A walk that ends at round r leaves the row at
    slot[r] if it went left, else r + 1: the slot the front update of
    :func:`forest_slots_plain` reaches. The feature word carries
    FOREST_CAT for a categorical round, and the entry's missing bin is
    the movable-missing bin only where its default direction differs from
    the threshold's (else FOREST_NO_MISS), so the kernel's numerical step
    is go = (b <= tbin) != (b == miss)."""
    i64 = torch.int64
    nl, nr, first = walk_links(fp.slot.t(), fp.num_splits, FOREST_END)
    links = nl | nr << 16
    tbin = fp.tbin.t().to(i64)
    miss = fp.miss_bin.t().to(i64)
    flips = (fp.movable.t() == 1) & ((fp.default_left.t() == 1)
                                     != (miss <= tbin))
    miss = torch.where(flips, miss, FOREST_NO_MISS)
    word = fp.feature.t().to(i64) | (fp.kind.t() > 0).to(i64) * FOREST_CAT
    nodes = torch.stack([word, tbin, miss, links], dim=2).transpose(0, 1)
    return ForestWalk(_as_i32(nodes), first.to(torch.int32).contiguous())


def _as_i32(a: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) or [-2^31, 2^31) -> their int32 bits."""
    a = torch.where(a >= 1 << 31, a - (1 << 32), a)
    return a.to(torch.int32).contiguous()


def walk_links(slot: torch.Tensor, num_splits: torch.Tensor, end: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T, R) i64 child links ``next_left`` and ``next_right`` and (T,)
    i64 starting rounds of trees whose round r splits leaf slot
    ``slot[t, r]`` (rounds at or past ``num_splits[t]`` are padding), on
    ``slot``'s device with torch ops over all trees at once (no host
    sync); ``end`` where there is no link. See :func:`forest_walk`."""
    T, R = slot.shape
    dev = slot.device
    i64 = torch.int64
    none = 1 << 62
    # keys slot << S | r: wide enough for any round
    S = max(1, R).bit_length()
    mask = (1 << S) - 1
    ns = num_splits.to(i64).clamp(0, R)
    r = torch.arange(R, dtype=i64, device=dev)[None, :]
    slot = slot.to(i64)
    # a slot outside [0, R] is never a row's: such a round is not reached
    reach = (r < ns[:, None]) & (slot >= 0) & (slot <= R)
    key = torch.where(reach, slot << S | r, none)
    skey = torch.sort(key, dim=1).values
    nxt = torch.cat([skey[:, 1:], torch.full((T, 1), none, dtype=i64,
                                             device=dev)], dim=1)
    same = (nxt != none) & ((nxt >> S) == (skey >> S))
    at = torch.where(skey != none, skey & mask, R)            # R: dropped
    nl = torch.full((T, R + 1), end, dtype=i64, device=dev)
    nl.scatter_(1, at, torch.where(same, nxt & mask, end))
    want = (r + 1) << S | (r + 1)
    q = torch.searchsorted(skey, want.expand(T, R).contiguous())
    kq = torch.gather(skey, 1, q.clamp(max=R - 1))
    nr = torch.where((q < R) & (kq != none) & ((kq >> S) == r + 1),
                     kq & mask, end)
    nl = torch.where(reach, nl[:, :R], end)
    nr = torch.where(reach, nr, end)
    k0 = skey[:, 0]
    first = torch.where((k0 != none) & ((k0 >> S) == 0), k0 & mask, end)
    return nl, nr, first


class ForestPlan(NamedTuple):
    """The launch of one forest call (csrc/forest_predict.cu): a grid of
    (chunks, spans) blocks, block (c, s) walks rows [c * rows_per_block,
    (c + 1) * rows_per_block) through tree groups [s * span, (s + 1) *
    span) in order, and writes one partial a (row, class) to its span's
    slice of the scratch."""
    staged: bool          # each pass's rows' bins staged in shared memory
    rows_per_block: int   # a multiple of FOREST_PASS_ROWS
    chunks: int           # row chunks (grid x)
    groups: int           # tree groups of FOREST_TREE_BATCH
    span: int             # groups a block walks (1 for one class)
    spans: int            # group spans (grid y)
    smem: int             # dynamic shared memory of a block
    tables: bool = True   # a group's entries and leaf values in shared
    #                       memory (else read from device memory: the raw
    #                       walk past FOREST_MAX_ROUNDS)


@functools.lru_cache(maxsize=1024)
def forest_plan(n: int, T: int, R: int, sms: int, F: int,
                K: int, raw: bool = False) -> ForestPlan:
    """Size a forest call over ``n`` rows of ``F`` i32 bins and ``T``
    trees (a multiple of FOREST_TREE_BATCH) of ``R`` rounds and ``K``
    classes on a card of ``sms`` SMs. Every block stages one group's node
    entries and leaf values at a time (:func:`forest_smem_bytes`) and,
    while they fit beside them, its passes' bins. The tree groups spread
    over blocks too: one group a block for one class (its partials are
    then summed in group order, which keeps the oracle's association),
    ``K`` groups a block for ``K`` classes, so the scratch of (span, row,
    class) partials never exceeds one class's (groups x n floats) by more
    than n x K. The rows are cut into as many chunks as fill one wave of
    the blocks the card holds (FOREST_BLOCKS_PER_SM an SM, fewer where
    shared memory binds) with every span, at least one pass of rows
    each, so a 256-row rung of one class runs groups x 8 blocks and the
    top rung about one wave.

    ``raw`` plans the raw walk over f32 rows: ``K`` classes walk every
    group in one span (each class chains its groups in order, as the twin
    does), and trees deeper than FOREST_MAX_ROUNDS read their tables from
    device memory (``tables`` False) where the forest kernel refuses
    them."""
    name = "forest_raw" if raw else "forest_predict"
    end = FOREST_RAW_END if raw else FOREST_END
    if R >= end or (R > FOREST_MAX_ROUNDS and not raw):
        raise ValueError("%s: %d rounds exceed the %d a block's shared "
                         "memory holds" % (name, R, FOREST_MAX_ROUNDS))
    if T < FOREST_TREE_BATCH or T % FOREST_TREE_BATCH:
        raise ValueError("%s: the kernel walks groups of %d trees; got "
                         "T=%d" % (name, FOREST_TREE_BATCH, T))
    groups = T // FOREST_TREE_BATCH
    span = min(groups, max(1, K))
    if raw and K > 1:
        span = groups
    spans = -(-groups // span)
    tables = R <= FOREST_MAX_ROUNDS
    smem = forest_smem_bytes(R, F, True, tables)
    staged = smem <= FOREST_SMEM_BYTES
    if not staged:
        smem = forest_smem_bytes(R, F, False, tables)
    per_sm = max(1, min(FOREST_BLOCKS_PER_SM,
                        FOREST_SM_SMEM_BYTES // (smem + 1024)))
    want = max(1, sms * per_sm // spans)
    rows = -(-max(n, 1) // want)
    rows = -(-rows // FOREST_PASS_ROWS) * FOREST_PASS_ROWS
    return ForestPlan(staged, rows, max(1, -(-n // rows)), groups, span,
                      spans, smem, tables)


def forest_slots_plain(bins: torch.Tensor, fp: ForestPack,
                       has_cat: bool = False) -> torch.Tensor:
    """(T, n) i32 leaf slot of every (tree, row): the TPU kernel's front
    update over all (row, tree) pairs, one vectorised step per round
    below min(num_splits, R)."""
    n = bins.shape[0]
    R, T = fp.slot.shape
    front = torch.zeros((n, T), dtype=torch.int32, device=bins.device)
    rounds = min(int(fp.num_splits.max()), R) if T else 0
    for r in range(rounds):
        colb = bins[:, fp.feature[r].long()]                # (n, T)
        go = colb <= fp.tbin[r]
        go = torch.where((fp.movable[r] == 1) & (colb == fp.miss_bin[r]),
                         fp.default_left[r] == 1, go)
        if has_cat:
            in_set = (colb[:, :, None] == fp.cat_bins[r][None]).any(dim=2)
            go = torch.where(fp.kind[r] > 0, in_set, go)
        upd = torch.where((front == fp.slot[r]) & ~go, r + 1, front)
        front = torch.where(r < fp.num_splits, upd, front)
    return front.t()


def forest_predict_plain(bins: torch.Tensor, X: Optional[torch.Tensor],
                         fp: ForestPack, *, num_class: int = 1,
                         has_cat: bool = False, has_linear: bool = False
                         ) -> torch.Tensor:
    """Plain torch twin of the kernel: :func:`forest_slots_plain`, then
    the leaf values summed by :func:`accumulate_scores`."""
    from ..linear.pack import linear_values_by_row

    slots = forest_slots_plain(bins, fp, has_cat)           # (T, n)
    if has_linear:
        vals = linear_values_by_row(X, slots, fp.value_of_slot,
                                    fp.const_of_slot, fp.coeff,
                                    fp.coeff_feat, fp.coeff_mask)
    else:
        vals = torch.gather(fp.value_of_slot, 1, slots.long())
    return accumulate_scores(vals, fp.tree_class, max(1, num_class))


_P = ctypes.c_void_p
_I = ctypes.c_int
FOREST_KERNEL = register(CudaKernel(
    "forest_predict", "forest_predict.cu",
    [_P, _P, _I, _I] + [_P] * 9 + [_I] * 13 + [_P] * 4))

#: (device index, stream) -> (f32 partials, i32 tickets): the kernel's
#: per-(span, row, class) partial sums and per-chunk tickets; the tickets are
#: zero between launches (the last block of each chunk zeroes its own)
_FOREST_SCRATCH = {}


def _forest_scratch(device: torch.device, stream: int, floats: int,
                    chunks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's partials and tickets for launches on ``stream`` of
    ``device``, grown (the tickets zeroed) when a launch needs more.
    Launches on one stream run in order, so they share them safely."""
    key = (device.index, stream)
    part, ticket = _FOREST_SCRATCH.get(key, (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty(max(floats, 1 << 16), dtype=torch.float32,
                           device=device)
    if ticket is None or ticket.numel() < chunks:
        ticket = torch.zeros(max(chunks, 1024), dtype=torch.int32,
                             device=device)
    _FOREST_SCRATCH[key] = (part, ticket)
    return part, ticket


def forest_predict_impl(bins: torch.Tensor, X: Optional[torch.Tensor],
                        fp: ForestPack, *, walk: ForestWalk,
                        num_class: int = 1, has_cat: bool = False,
                        has_linear: bool = False) -> torch.Tensor:
    """(N, F) i32 inner-feature bins (+ (N, F) f32 raw rows in inner
    order when ``has_linear``) -> (N,) or (N, K) f32 raw scores.

    A CUDA ``bins`` launches the forest kernel once, with ``walk`` (the
    pack's :func:`forest_walk`, which a caller that serves the pack keeps
    beside it); a CPU ``bins`` runs the plain twin."""
    K = max(1, int(num_class))
    if bins.dim() != 2 or bins.dtype != torch.int32:
        raise ValueError("forest_predict: bins must be (N, F) int32, got "
                         "%s %s" % (tuple(bins.shape), bins.dtype))
    if has_linear and (X is None or X.shape != bins.shape
                       or X.dtype != torch.float32):
        raise ValueError("forest_predict: linear leaves need (N, F) "
                         "float32 raw rows beside the bins")
    if bins.device.type == "cpu":
        return forest_predict_plain(bins, X, fp, num_class=K,
                                    has_cat=has_cat, has_linear=has_linear)
    if bins.device.type != "cuda":
        raise RuntimeError("forest_predict: no kernel for device %s"
                           % bins.device)
    R, T = fp.slot.shape
    n, F = bins.shape
    plan = forest_plan(n, T, R, sm_count(bins.device.index), F, K)
    for name, t in fp._asdict().items():
        if t.device != bins.device or not t.is_contiguous():
            raise ValueError("forest_predict: table %s must be contiguous "
                             "on %s" % (name, bins.device))
        want = torch.float32 if name in (
            "value_of_slot", "const_of_slot", "coeff", "coeff_mask") \
            else torch.int32
        if t.dtype != want:
            raise TypeError("forest_predict: table %s must be %s, got %s"
                            % (name, want, t.dtype))
    L = fp.value_of_slot.shape[1]
    if L != R + 1:
        raise ValueError("forest_predict: %d leaf slots for %d rounds"
                         % (L, R))
    if walk.nodes.shape != (R, T, 4) or walk.first.shape != (T,) \
            or walk.nodes.device != bins.device \
            or walk.first.device != bins.device:
        raise ValueError("forest_predict: walk tables do not match the "
                         "pack")
    # the passes' bins are copied 16 bytes at a time
    bins = bins.contiguous()
    if bins.data_ptr() % 16:
        bins = bins.clone()
    Kc = fp.cat_bins.shape[2]
    Km = fp.coeff.shape[2]
    x_ptr = 0
    if has_linear:
        X = X.contiguous()
        if X.device != bins.device:
            raise ValueError("forest_predict: X must be on %s" % bins.device)
        x_ptr = X.data_ptr()
    out = torch.empty((n, K), dtype=torch.float32, device=bins.device)
    if n:
        stream = stream_of(bins)
        part, ticket = _forest_scratch(bins.device, stream,
                                       plan.spans * n * K, plan.chunks)
        FOREST_KERNEL.launch(
            bins.data_ptr(), x_ptr, n, F,
            walk.nodes.data_ptr(), walk.first.data_ptr(),
            fp.value_of_slot.data_ptr(), fp.tree_class.data_ptr(),
            fp.cat_bins.data_ptr(), fp.const_of_slot.data_ptr(),
            fp.coeff.data_ptr(), fp.coeff_feat.data_ptr(),
            fp.coeff_mask.data_ptr(),
            R, T, L, K, Kc, Km, int(has_cat), int(has_linear),
            int(plan.staged), plan.rows_per_block, plan.chunks, plan.span,
            plan.smem,
            part.data_ptr(), ticket.data_ptr(), out.data_ptr(), stream)
    return out[:, 0] if K == 1 else out


# ------------------------------------------------------------------ raw walk
class RawWalk(NamedTuple):
    """The raw-threshold walk's view of a ``PackedSplits``, derived once
    per pack (:func:`raw_walk`) and kept beside it; trees padded to a
    FOREST_TREE_BATCH multiple (the pads have no split and a zero leaf).
    ``num_features`` is one more than the largest column a split or a
    linear leaf reads: the rows must have at least that many."""
    nodes: torch.Tensor          # (R, T, 4) i32 {feature | FOREST_CAT,
    #                              f32 threshold bits, missing_type |
    #                              default_left << 2 | next_right << 3,
    #                              next_left}
    first: torch.Tensor          # (T,) i32 first round that splits slot 0
    value_of_slot: torch.Tensor  # (T, L) f32
    tree_class: torch.Tensor     # (T,) i32
    cat_values: torch.Tensor     # (R, T, Kc) i32, pad -2
    const_of_slot: torch.Tensor  # (T, L) f32
    coeff: torch.Tensor          # (T, L, Km) f32
    coeff_feat: torch.Tensor     # (T, L, Km) i32 column of X
    coeff_mask: torch.Tensor     # (T, L, Km) f32 0/1
    num_features: int


def raw_walk(pack) -> RawWalk:
    """Walk tables of ``pack`` (``ops/predict.PackedSplits``) on its
    device: the child links of :func:`walk_links` (FOREST_RAW_END where
    there is none) beside each round's column, f32 threshold bits,
    missing type and default direction, the category sets round-major
    as the forest kernel's, and the leaf tables padded to whole groups of
    trees. One read back of the largest column used."""
    T, R = pack.slot.shape
    dev = pack.slot.device
    i64 = torch.int64
    Tp = T + (-T) % FOREST_TREE_BATCH

    def pad(a: torch.Tensor, fill=0) -> torch.Tensor:
        if Tp == T:
            return a
        extra = torch.full((Tp - T,) + tuple(a.shape[1:]), fill,
                           dtype=a.dtype, device=dev)
        return torch.cat([a, extra])

    nl, nr, first = walk_links(pack.slot, pack.num_splits, FOREST_RAW_END)
    word = pack.feature.to(i64) | (pack.kind > 0).to(i64) * FOREST_CAT
    thr = pack.threshold.to(torch.float32).contiguous() \
        .view(torch.int32).to(i64)
    meta = pack.missing_type.to(i64) | pack.default_left.to(i64) << 2 \
        | nr << 3
    nodes = pad(torch.stack([word, thr, meta, nl], dim=2))
    first = pad(first, FOREST_RAW_END)
    linear = torch.where(pack.coeff_mask, pack.coeff_feat, 0)
    num_features = int(torch.maximum(pack.feature.max(), linear.max())) + 1
    return RawWalk(
        nodes=_as_i32(nodes.transpose(0, 1)),
        first=first.to(torch.int32).contiguous(),
        value_of_slot=pad(pack.value_of_slot.to(torch.float32)).contiguous(),
        tree_class=pad(pack.tree_class.to(torch.int32)).contiguous(),
        cat_values=pad(pack.cat_values.to(torch.int32), -2)
        .transpose(0, 1).contiguous(),
        const_of_slot=pad(pack.const_of_slot.to(torch.float32)).contiguous(),
        coeff=pad(pack.coeff.to(torch.float32)).contiguous(),
        coeff_feat=pad(pack.coeff_feat.to(torch.int32)).contiguous(),
        coeff_mask=pad(pack.coeff_mask.to(torch.float32)).contiguous(),
        num_features=num_features)


def raw_walk_slots_plain(X: torch.Tensor, rw: RawWalk,
                         has_cat: bool = False) -> torch.Tensor:
    """(T, N) i32 leaf slot of every (tree, row) by the kernel's walk as
    plain torch: every (row, tree) pair starts at its tree's first round
    and follows the entry's links round by round, exactly the decisions
    the raw walk (``csrc/forest_predict.cu``, ``RawRow``) makes (the
    tables' oracle in the tests)."""
    X = X.to(torch.float32)
    R, T, _ = rw.nodes.shape
    n = X.shape[0]
    dev = X.device
    nodes = rw.nodes.to(torch.int64) & 0xFFFFFFFF
    r = rw.first.to(torch.int64)[None, :].expand(n, T).clone()
    state = torch.zeros((n, T), dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev)[:, None].expand(n, T)
    trees = torch.arange(T, device=dev)[None, :].expand(n, T)
    while True:
        live = r < R
        if not bool(live.any()):
            break
        rr = torch.where(live, r, 0)
        e = nodes[rr, trees]                                  # (n, T, 4)
        word = e[..., 0]
        v = X[rows, word & 0x7FFFFFFF]
        thr = torch.where(e[..., 1] >= 1 << 31, e[..., 1] - (1 << 32),
                          e[..., 1]).to(torch.int32).view(torch.float32)
        mt = e[..., 2] & 3
        dl = ((e[..., 2] >> 2) & 1) == 1
        nan = torch.isnan(v)
        u = torch.where(nan & (mt != 2), 0.0, v)
        go = u <= thr
        go = torch.where((mt == 2) & nan, dl, go)
        go = torch.where((mt == 1) & (u.abs() <= K_ZERO), dl, go)
        if has_cat:
            iv = torch.where(torch.isfinite(v), v, -1.0).to(torch.int32)
            cv = rw.cat_values[rr, trees]                     # (n, T, Kc)
            in_set = (cv == iv[..., None]).any(dim=2)
            go = torch.where(word >= 1 << 31, in_set, go)
        state = torch.where(live & ~go, rr + 1, state)
        nxt = torch.where(go, e[..., 3], e[..., 2] >> 3)
        r = torch.where(live, nxt, r)
    return state.to(torch.int32).t()


FOREST_RAW_KERNEL = register(CudaKernel(
    "forest_raw", "forest_predict.cu",
    [_P, _I, _I] + [_P] * 9 + [_I] * 14 + [_P] * 4))


def forest_raw_impl(X: torch.Tensor, rw: RawWalk, *, num_class: int = 1,
                    has_cat: bool = False,
                    has_linear: bool = False) -> torch.Tensor:
    """(N, F) f32 raw rows on a CUDA device -> (N,) or (N, K) f32 raw
    scores by one launch of the raw walk (``csrc/forest_predict.cu``'s
    ``forest_raw``, planned by :func:`forest_plan` with ``raw=True``) over
    the walk tables ``rw`` (:func:`raw_walk` of the pack, on the same
    device). The plain twin is ``ops/predict.predict_raw_impl``;
    ``ops/predict.predict_raw`` picks between them by the tensor's
    device."""
    K = max(1, int(num_class))
    if X.device.type != "cuda":
        raise RuntimeError("forest_raw: the kernel runs on a CUDA tensor, "
                           "got %s" % X.device)
    if X.dim() != 2:
        raise ValueError("forest_raw: X must be (N, F), got %s"
                         % (tuple(X.shape),))
    n, F = X.shape
    if F < rw.num_features:
        raise ValueError("forest_raw: the model reads column %d but the "
                         "rows have %d" % (rw.num_features - 1, F))
    R, T, _ = rw.nodes.shape
    L = rw.value_of_slot.shape[1]
    if L != R + 1:
        raise ValueError("forest_raw: %d leaf slots for %d rounds" % (L, R))
    want = {"nodes": torch.int32, "first": torch.int32,
            "value_of_slot": torch.float32, "tree_class": torch.int32,
            "cat_values": torch.int32, "const_of_slot": torch.float32,
            "coeff": torch.float32, "coeff_feat": torch.int32,
            "coeff_mask": torch.float32}
    for name, dtype in want.items():
        t = getattr(rw, name)
        if t.device != X.device or not t.is_contiguous() \
                or t.dtype != dtype:
            raise ValueError("forest_raw: table %s must be contiguous %s "
                             "on %s" % (name, dtype, X.device))
    # the passes' rows are copied 16 bytes at a time
    X = X.to(torch.float32).contiguous()
    if X.data_ptr() % 16:
        X = X.clone()
    out = torch.empty((n, K), dtype=torch.float32, device=X.device)
    if n:
        plan = forest_plan(n, T, R, sm_count(X.device.index), F, K,
                           raw=True)
        stream = stream_of(X)
        part, ticket = _forest_scratch(X.device, stream,
                                       plan.spans * n * K, plan.chunks)
        FOREST_RAW_KERNEL.launch(
            X.data_ptr(), n, F, rw.nodes.data_ptr(), rw.first.data_ptr(),
            rw.value_of_slot.data_ptr(), rw.tree_class.data_ptr(),
            rw.cat_values.data_ptr(), rw.const_of_slot.data_ptr(),
            rw.coeff.data_ptr(), rw.coeff_feat.data_ptr(),
            rw.coeff_mask.data_ptr(), R, T, L, K,
            rw.cat_values.shape[2], rw.coeff.shape[2], int(has_cat),
            int(has_linear), int(plan.staged), int(plan.tables),
            plan.rows_per_block, plan.chunks, plan.span, plan.smem,
            part.data_ptr(), ticket.data_ptr(), out.data_ptr(), stream)
    return out[:, 0] if K == 1 else out
