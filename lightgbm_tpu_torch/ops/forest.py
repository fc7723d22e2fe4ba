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
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .kernels import CudaKernel, register, stream_of
from .partition import sm_count
from .predict import TREE_BATCH, accumulate_scores

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
#: the link that ends a walk (links are 16-bit)
FOREST_END = 0xFFFF
#: the feature word's flag of a categorical round, and the missing bin of
#: a round whose movable-missing bin does not change the direction (no
#: bin is INT_MIN)
FOREST_CAT = 1 << 31
FOREST_NO_MISS = -(1 << 31)


def forest_smem_bytes(rounds: int, num_cols: int, staged: bool) -> int:
    """Shared memory of one block of the kernel: a group's 16-byte node
    entries and f32 leaf values (``rounds + 1`` slots), and, when
    ``staged``, two buffers of a pass's rows of ``num_cols`` i32 bins."""
    b = FOREST_TREE_BATCH * (16 * rounds + 4 * (rounds + 1))
    if staged:
        b += 2 * FOREST_PASS_ROWS * num_cols * 4
    return b


#: Most routing rounds (num_leaves - 1) whose group of node entries and
#: leaf values fits the shared memory one block may use (the bins then
#: come from device memory).
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
    R, T = fp.slot.shape
    dev = fp.slot.device
    i64 = torch.int64
    none = 1 << 40
    ns = fp.num_splits.to(i64).clamp(0, R)
    r = torch.arange(R, dtype=i64, device=dev)[None, :]
    slot = fp.slot.t().to(i64)                                # (T, R)
    # a slot outside [0, R] is never a row's: such a round is not reached
    reach = (r < ns[:, None]) & (slot >= 0) & (slot <= R)
    key = torch.where(reach, slot << 16 | r, none)
    skey = torch.sort(key, dim=1).values
    nxt = torch.cat([skey[:, 1:], torch.full((T, 1), none, dtype=i64,
                                             device=dev)], dim=1)
    same = (nxt != none) & ((nxt >> 16) == (skey >> 16))
    at = torch.where(skey != none, skey & 0xFFFF, R)          # R: dropped
    nl = torch.full((T, R + 1), FOREST_END, dtype=i64, device=dev)
    nl.scatter_(1, at, torch.where(same, nxt & 0xFFFF, FOREST_END))
    want = (r + 1) << 16 | (r + 1)
    q = torch.searchsorted(skey, want.expand(T, R).contiguous())
    kq = torch.gather(skey, 1, q.clamp(max=R - 1))
    nr = torch.where((q < R) & (kq != none) & ((kq >> 16) == r + 1),
                     kq & 0xFFFF, FOREST_END)
    links = torch.where(reach, nl[:, :R] | nr << 16,
                        FOREST_END | FOREST_END << 16)
    k0 = skey[:, 0]
    first = torch.where((k0 != none) & ((k0 >> 16) == 0), k0 & 0xFFFF,
                        FOREST_END)
    tbin = fp.tbin.t().to(i64)
    miss = fp.miss_bin.t().to(i64)
    flips = (fp.movable.t() == 1) & ((fp.default_left.t() == 1)
                                     != (miss <= tbin))
    miss = torch.where(flips, miss, FOREST_NO_MISS)
    word = fp.feature.t().to(i64) | (fp.kind.t() > 0).to(i64) * FOREST_CAT
    nodes = torch.stack([word, tbin, miss, links], dim=2).transpose(0, 1)
    nodes = torch.where(nodes >= 1 << 31, nodes - (1 << 32), nodes)
    return ForestWalk(nodes.to(torch.int32).contiguous(),
                      first.to(torch.int32).contiguous())


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


@functools.lru_cache(maxsize=1024)
def forest_plan(n: int, T: int, R: int, sms: int, F: int,
                K: int) -> ForestPlan:
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
    top rung about one wave."""
    if R > FOREST_MAX_ROUNDS:
        raise ValueError("forest_predict: %d rounds exceed the %d a block's "
                         "shared memory holds" % (R, FOREST_MAX_ROUNDS))
    if T < FOREST_TREE_BATCH or T % FOREST_TREE_BATCH:
        raise ValueError("forest_predict: the kernel walks groups of %d "
                         "trees; got T=%d" % (FOREST_TREE_BATCH, T))
    groups = T // FOREST_TREE_BATCH
    span = min(groups, max(1, K))
    spans = -(-groups // span)
    smem = forest_smem_bytes(R, F, True)
    staged = smem <= FOREST_SMEM_BYTES
    if not staged:
        smem = forest_smem_bytes(R, F, False)
    per_sm = max(1, min(FOREST_BLOCKS_PER_SM,
                        FOREST_SM_SMEM_BYTES // (smem + 1024)))
    want = max(1, sms * per_sm // spans)
    rows = -(-max(n, 1) // want)
    rows = -(-rows // FOREST_PASS_ROWS) * FOREST_PASS_ROWS
    return ForestPlan(staged, rows, max(1, -(-n // rows)), groups, span,
                      spans, smem)


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
