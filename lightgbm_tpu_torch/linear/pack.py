"""Slot-ordered per-leaf coefficient tables for linear-leaf predict
(PyTorch port of ``lightgbm_tpu/linear/pack.py``).

``ops.predict`` routes rows to leaf SLOTS (``Tree.to_split_arrays``
order); linear prediction then needs the slot's constant term, feature
indices and coefficients. The tables pad every tree of a pack to the
ensemble's max leaf-feature count so one shape serves the whole model;
non-linear trees ride along with ``const == value`` and an all-false
mask, which evaluates to exactly the plain leaf output.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def linear_pack_arrays(trees: List, arrs: List[dict],
                       value_of_slot: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray, bool]:
    """(const_of_slot (T, L) f32, coeff (T, L, km) f32, coeff_feat
    (T, L, km) i32, coeff_mask (T, L, km) bool, has_linear) for the packed
    trees; ``arrs`` are their ``to_split_arrays`` dicts (for the
    slot -> leaf mapping) and ``value_of_slot`` the already-built constant
    table that non-linear slots inherit."""
    T, L = value_of_slot.shape
    has_linear = any(getattr(t, "is_linear", False) for t in trees)
    km = 1
    for t in trees:
        if getattr(t, "is_linear", False):
            for feats in t.leaf_features.values():
                km = max(km, len(feats))
    const_of_slot = value_of_slot.astype(np.float32).copy()
    coeff = np.zeros((T, L, km), np.float32)
    coeff_feat = np.zeros((T, L, km), np.int32)
    coeff_mask = np.zeros((T, L, km), bool)
    if not has_linear:
        return const_of_slot, coeff, coeff_feat, coeff_mask, False
    for ti, (t, a) in enumerate(zip(trees, arrs)):
        if not getattr(t, "is_linear", False):
            continue
        leaf_of_slot = a["leaf_of_slot"]
        n_slots = len(a["slot"]) + 1 if t.num_leaves > 1 else 1
        for s in range(n_slots):
            leaf = int(leaf_of_slot[s]) if t.num_leaves > 1 else 0
            const_of_slot[ti, s] = t.leaf_const[leaf]
            feats = t.leaf_features.get(leaf)
            if feats is None or len(feats) == 0:
                continue
            k = len(feats)
            coeff_feat[ti, s, :k] = feats
            coeff[ti, s, :k] = t.leaf_coeff[leaf]
            coeff_mask[ti, s, :k] = True
    return const_of_slot, coeff, coeff_feat, coeff_mask, True


def linear_values_by_row(X: torch.Tensor, slots: torch.Tensor,
                         value_of_slot: torch.Tensor,
                         const_of_slot: torch.Tensor, coeff: torch.Tensor,
                         coeff_feat: torch.Tensor,
                         coeff_mask: torch.Tensor) -> torch.Tensor:
    """Per-row linear-leaf outputs for every packed tree at once:
    (N, F) rows + (T, N) slots + (T, L[, Km]) tables -> (T, N) f32.

    Gathers each row's slot entries, then its features, and evaluates
    ``const + sum(coeff * x)``. A row with NaN in any of its leaf's used
    features falls back to the plain leaf value, exactly as
    ``Tree.linear_predict`` on the host. ``coeff_mask`` may be bool or
    f32 0/1 (the forest pack's form)."""
    T, n = slots.shape
    km = coeff.shape[2]
    s = slots.long()
    base = torch.gather(value_of_slot, 1, s)
    cst = torch.gather(const_of_slot, 1, s)
    sk = s[:, :, None].expand(T, n, km)
    cf = torch.gather(coeff, 1, sk)                        # (T, N, km)
    fi = torch.gather(coeff_feat.long(), 1, sk)
    cm = torch.gather(coeff_mask.to(torch.float32), 1, sk) > 0.5
    rows = torch.arange(n, device=X.device)[None, :, None]
    z = X.to(torch.float32)[rows, fi]                      # (T, N, km)
    nan = torch.isnan(z)
    nanrow = (nan & cm).any(dim=2)
    zz = torch.where(cm & ~nan, z, 0.0)
    contrib = (zz * cf).sum(dim=2)
    return torch.where(nanrow, base, cst + contrib)
