"""Forest-at-once ensemble inference (PyTorch port of
``lightgbm_tpu/ops/forest.py``).

:class:`ForestPack` is the inference-shaped repack of the ensemble: node
tables are SPLIT-MAJOR ``(R rounds, T trees)`` and thresholds live in BIN
space (the per-split conversion ``split_bin_table`` in ops/predict.py), so
every routing comparison is a small-int compare. :func:`forest_predict_impl`
evaluates the whole ensemble for a batch of rows: on a CUDA tensor it
launches the hand-written kernel ``csrc/forest_predict.cu`` once, on a CPU
tensor it runs :func:`forest_predict_plain`, the same front update as
plain torch ops. Both sum leaf values in the ``predict_raw_impl`` oracle's
grouping, so the three agree to float32 rounding.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .kernels import CudaKernel, register, stream_of
from .predict import TREE_BATCH, accumulate_scores

#: Bound on the node tables' bytes for a model to be eligible (the name
#: and value of the TPU package's VMEM budget, so the same models are
#: eligible in both). On this card the tables live in device memory and
#: the kernel stages one group of trees at a time into shared memory, so
#: here it bounds device bytes, not on-chip memory.
FOREST_VMEM_BUDGET = 8 << 20

#: Trees the kernel stages and sums as one group (the oracle's
#: tree_batch, kTB in the kernel); the pack pads T to a multiple of it.
FOREST_TREE_BATCH = TREE_BATCH

#: Most routing rounds (num_leaves - 1) whose group tables fit the shared
#: memory one block may use: 8 trees x (5 i32 tables x R + (R + 1) f32
#: leaf values) <= 227 KB.
FOREST_MAX_ROUNDS = 1200


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
    is undefined; the raw oracle path serves those) or when the trees are
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


def forest_predict_plain(bins: torch.Tensor, X: Optional[torch.Tensor],
                         fp: ForestPack, *, num_class: int = 1,
                         has_cat: bool = False, has_linear: bool = False
                         ) -> torch.Tensor:
    """Plain torch twin of the kernel: the TPU kernel's front update over
    all (row, tree) pairs, one vectorised step per round."""
    from ..linear.pack import linear_values_by_row

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
    slots = front.t()                                       # (T, n)
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
    [_P, _P, _I, _I] + [_P] * 15 + [_I] * 8 + [_P, _P]))


def forest_predict_impl(bins: torch.Tensor, X: Optional[torch.Tensor],
                        fp: ForestPack, *, num_class: int = 1,
                        has_cat: bool = False, has_linear: bool = False
                        ) -> torch.Tensor:
    """(N, F) i32 inner-feature bins (+ (N, F) f32 raw rows in inner
    order when ``has_linear``) -> (N,) or (N, K) f32 raw scores.

    A CUDA ``bins`` launches the forest kernel once; a CPU ``bins`` runs
    the plain twin."""
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
    if T % FOREST_TREE_BATCH:
        raise ValueError("forest_predict: the kernel sums groups of %d "
                         "trees; got T=%d" % (FOREST_TREE_BATCH, T))
    if R > FOREST_MAX_ROUNDS:
        raise ValueError("forest_predict: %d rounds exceed the kernel's %d"
                         % (R, FOREST_MAX_ROUNDS))
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
    bins = bins.contiguous()
    n, F = bins.shape
    L = fp.value_of_slot.shape[1]
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
        FOREST_KERNEL.launch(
            bins.data_ptr(), x_ptr, n, F,
            fp.slot.data_ptr(), fp.feature.data_ptr(), fp.tbin.data_ptr(),
            fp.kind.data_ptr(), fp.default_left.data_ptr(),
            fp.miss_bin.data_ptr(), fp.movable.data_ptr(),
            fp.num_splits.data_ptr(), fp.value_of_slot.data_ptr(),
            fp.tree_class.data_ptr(), fp.cat_bins.data_ptr(),
            fp.const_of_slot.data_ptr(), fp.coeff.data_ptr(),
            fp.coeff_feat.data_ptr(), fp.coeff_mask.data_ptr(),
            R, T, L, K, Kc, Km, int(has_cat), int(has_linear),
            out.data_ptr(), stream_of(bins))
    return out[:, 0] if K == 1 else out
