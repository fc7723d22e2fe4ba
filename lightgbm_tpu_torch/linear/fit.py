"""Batched fit of the ridge linear leaf models (PyTorch port of
``lightgbm_tpu/linear/fit.py``).

One pass per tree fits every leaf at once: the Gram sums of each leaf's
normal equations ``-(Z^T H Z + lambda I') beta = Z^T g`` over the leaf's
branch-path numerical features (:func:`gram_sums`: on a CUDA tensor the
hand-written kernel ``csrc/linear_gram.cu``, on a CPU tensor its plain
twin :func:`gram_sums_plain`), then one batched solve
(``torch.linalg.solve_ex``, as the JAX package leaves its batched solve to
XLA outside any Pallas kernel). A singular leaf is not fit: its solve
reports it and nothing waits on the stream for the report.

Kept from the JAX package (tests/test_torch_linear.py holds both):

- only branch-path NUMERICAL features enter a leaf's model;
- a row with NaN in any of its leaf's features drops out of that leaf's
  sums (its weights and features are zeroed);
- the ridge ``linear_lambda`` lands on feature diagonals only, never on
  the intercept; a padded dimension gets a unit diagonal;
- a leaf is fit only when it has features and at least ``k + 1`` rows
  and ``k + 1`` NaN-free rows, and its solution is finite; every other
  leaf keeps its constant output (the host oracle's ``continue``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..obs import telemetry
from ..ops.kernels import CudaKernel, register, stream_of

#: rows per accumulation step of the plain twin (the JAX package's chunk)
_CHUNK = 8192

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: the Gram sums: each product rounded before it is added, as the twin's
GRAM_KERNEL = register(CudaKernel(
    "linear_gram", "linear_gram.cu",
    [_P, _I, _P, _P, _L, _P, _P, _I, _I, _I, _I, _L, _P, _P, _P],
    flags=("-fmad=false",)))
#: shared memory the kernel's accumulators may take in a block, the most
#: leaves a block holds, the row-leaf tile and the blocks a call asks for
GRAM_SMEM_BYTES = 96 * 1024
GRAM_SMEM_MAX = 232448 - 1024
GRAM_MAX_LEAVES = 8
GRAM_TILE = 256
GRAM_TARGET_BLOCKS = 4096


def leaf_feature_table(tree, ds, num_leaves_cap: int
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Per-leaf branch-path numerical features as padded index and mask
    tables (Lp, kp): the host oracle's feature filter (categorical and
    dropped columns excluded); the feature axis padded to a power of two
    and the leaf axis to ``num_leaves_cap``. None when no leaf has a
    usable feature."""
    from ..ops.binning import BIN_CATEGORICAL

    per_leaf = []
    kmax = 0
    for l in range(tree.num_leaves):
        feats = [int(f) for f in tree.branch_features(l)
                 if ds.inner_feature_index(int(f)) >= 0
                 and ds.bin_mappers[ds.inner_feature_index(int(f))]
                 .bin_type != BIN_CATEGORICAL]
        per_leaf.append(feats)
        kmax = max(kmax, len(feats))
    if kmax == 0:
        return None
    kp = 1
    while kp < kmax:
        kp *= 2
    Lp = max(int(num_leaves_cap), tree.num_leaves)
    feat_idx = np.zeros((Lp, kp), np.int32)
    feat_mask = np.zeros((Lp, kp), bool)
    for l, feats in enumerate(per_leaf):
        feat_idx[l, :len(feats)] = feats
        feat_mask[l, :len(feats)] = True
    return feat_idx, feat_mask


class GramSums(NamedTuple):
    """Every leaf's Gram sums: ``A`` (L, kp1, kp1), ``B`` (L, kp1), row
    counts ``cnt`` and NaN-free row counts ``vcnt`` (L,), f32."""
    A: torch.Tensor
    B: torch.Tensor
    cnt: torch.Tensor
    vcnt: torch.Tensor


def _masked_rows(X, row_leaf, g, h, feat_idx, feat_mask):
    """Per row: its leaf's features with NaN and padding zeroed, the
    validity flag and the NaN-masked g and h (the JAX function's
    preamble, op for op)."""
    f32 = torch.float32
    rl = row_leaf.long()
    fi = feat_idx.long().index_select(0, rl)                  # (N, km)
    fm = feat_mask.index_select(0, rl)
    z = torch.gather(X.to(f32), 1, fi)
    nan = torch.isnan(z)
    valid = (~torch.any(nan & fm, dim=1)).to(f32)
    z = torch.where(fm & ~nan, z, torch.zeros((), dtype=f32, device=z.device))
    return z, valid, h.to(f32) * valid, g.to(f32) * valid


def gram_sums_plain(X: torch.Tensor, row_leaf: torch.Tensor,
                    g: torch.Tensor, h: torch.Tensor,
                    feat_idx: torch.Tensor,
                    feat_mask: torch.Tensor) -> GramSums:
    """Plain twin of the Gram kernel: the weighted outer products
    ``(z_i * z_j) * wh`` and ``z_i * wg`` of every row (``z`` its leaf's
    features then 1) summed into its leaf, ``_CHUNK`` rows at a time
    (``index_add_``), with the row and NaN-free row counts."""
    L, km = feat_idx.shape
    kp1 = km + 1
    n = row_leaf.shape[0]
    f32 = torch.float32
    dev = X.device
    A = torch.zeros((L, kp1 * kp1), dtype=f32, device=dev)
    B = torch.zeros((L, kp1), dtype=f32, device=dev)
    cnt = torch.zeros(L, dtype=f32, device=dev)
    vcnt = torch.zeros(L, dtype=f32, device=dev)
    for c0 in range(0, n, _CHUNK):
        sl = slice(c0, min(n, c0 + _CHUNK))
        rl = row_leaf[sl].long()
        z, valid, wh, wg = _masked_rows(X[sl], row_leaf[sl], g[sl], h[sl],
                                        feat_idx, feat_mask)
        zk = torch.cat([z, torch.ones((z.shape[0], 1), dtype=f32,
                                      device=dev)], dim=1)
        outer = (zk[:, :, None] * zk[:, None, :]) * wh[:, None, None]
        A.index_add_(0, rl, outer.reshape(-1, kp1 * kp1))
        B.index_add_(0, rl, zk * wg[:, None])
        cnt.index_add_(0, rl, torch.ones_like(valid))
        vcnt.index_add_(0, rl, valid)
    return GramSums(A.reshape(L, kp1, kp1), B, cnt, vcnt)


class GramPlan(NamedTuple):
    """A Gram kernel call: ``leaves`` a block (one warp each), ``slices``
    row slices of ``rows`` rows, ``smem`` bytes of shared memory."""
    leaves: int
    slices: int
    rows: int
    smem: int


def gram_plan(n: int, num_leaves: int, km: int) -> GramPlan:
    """Size a Gram kernel call over ``n`` rows, ``num_leaves`` leaves and
    ``km`` features a leaf: as many leaves a block as GRAM_SMEM_BYTES of
    accumulators hold (at most GRAM_MAX_LEAVES), and enough row slices for
    about GRAM_TARGET_BLOCKS blocks. Raises where one leaf's accumulators
    exceed a block's shared memory (more than 128 features on a path)."""
    kp1 = km + 1
    w = kp1 * kp1 + kp1 + 2
    per_leaf = (w + kp1 + km) * 4
    if per_leaf + GRAM_TILE * 4 > GRAM_SMEM_MAX:
        raise ValueError("linear_gram: %d features on a leaf's path exceed "
                         "a block's shared memory" % km)
    g = max(1, min(GRAM_MAX_LEAVES, num_leaves,
                   GRAM_SMEM_BYTES // per_leaf))
    groups = -(-num_leaves // g)
    tiles = max(1, -(-n // GRAM_TILE))
    s = max(1, min(tiles, -(-GRAM_TARGET_BLOCKS // groups)))
    rows = -(-tiles // s) * GRAM_TILE
    s = max(1, -(-n // rows))
    return GramPlan(g, s, rows, g * per_leaf + GRAM_TILE * 4)


def gram_sums(X: torch.Tensor, row_leaf: torch.Tensor, ghc: torch.Tensor,
              feat_idx: torch.Tensor, feat_mask: torch.Tensor) -> GramSums:
    """Every leaf's Gram sums from the raw features ``X`` (N, ldx) f32,
    the rows' leaves ``row_leaf`` (N,) i32, the (N, 3) channels ``ghc``
    (g and h in columns 0 and 1) and the (L, km) ``feat_idx`` (i32) and
    ``feat_mask`` (bool) tables. On a CUDA tensor one call of
    ``csrc/linear_gram.cu`` (deterministic; within
    :func:`gram_sum_bound` of the twin); on a CPU tensor
    :func:`gram_sums_plain`."""
    L, km = feat_idx.shape
    n = row_leaf.shape[0]
    if X.dim() != 2 or X.shape[0] != n or ghc.shape != (n, 3):
        raise ValueError("linear_gram: X (N, F), row_leaf (N,) and ghc "
                         "(N, 3) must agree on N")
    if feat_mask.shape != (L, km) or feat_mask.dtype != torch.bool \
            or feat_idx.dtype != torch.int32:
        raise ValueError("linear_gram: feat_idx (L, k) int32 and feat_mask "
                         "(L, k) bool")
    if X.device.type == "cpu":
        return gram_sums_plain(X, row_leaf, ghc[:, 0], ghc[:, 1], feat_idx,
                               feat_mask)
    if X.device.type != "cuda":
        raise RuntimeError("linear_gram: no kernel for device %s" % X.device)
    for name, t in (("row_leaf", row_leaf), ("ghc", ghc),
                    ("feat_idx", feat_idx), ("feat_mask", feat_mask)):
        if t.device != X.device or not t.is_contiguous():
            raise ValueError("linear_gram: %s must be contiguous on %s"
                             % (name, X.device))
    if X.dtype != torch.float32 or not X.is_contiguous() \
            or row_leaf.dtype != torch.int32 or ghc.dtype != torch.float32:
        raise ValueError("linear_gram: X f32, row_leaf int32, ghc f32, "
                         "contiguous")
    plan = gram_plan(n, L, km)
    kp1 = km + 1
    w = kp1 * kp1 + kp1 + 2
    partial = torch.empty((plan.slices, L, w), dtype=torch.float32,
                          device=X.device)
    out = torch.empty((L, w), dtype=torch.float32, device=X.device)
    GRAM_KERNEL.launch(X.data_ptr(), X.shape[1], row_leaf.data_ptr(),
                       ghc.data_ptr(), n, feat_idx.data_ptr(),
                       feat_mask.data_ptr(), L, km, plan.leaves, plan.slices,
                       plan.rows, partial.data_ptr(), out.data_ptr(),
                       stream_of(X))
    na = kp1 * kp1
    return GramSums(out[:, :na].reshape(L, kp1, kp1), out[:, na:na + kp1],
                    out[:, w - 2], out[:, w - 1])


def gram_sum_bound(X: torch.Tensor, row_leaf: torch.Tensor,
                   ghc: torch.Tensor, feat_idx: torch.Tensor,
                   feat_mask: torch.Tensor) -> GramSums:
    """How far two f32 sums of the Gram terms in any two orders may lie
    apart, per entry: ``2 (n_l - 1) u sum |term|`` with ``u = 2^-24`` and
    ``n_l`` the leaf's rows (each order's recursive-summation bound; the
    products themselves are rounded alike). Counts are exact: 0."""
    absg = torch.abs(ghc)
    s = gram_sums_plain(torch.abs(X), row_leaf, absg[:, 0], absg[:, 1],
                        feat_idx, feat_mask)
    k = 2.0 * torch.clamp(s.cnt - 1.0, min=0.0) * 2.0 ** -24
    return GramSums(s.A * k[:, None, None], s.B * k[:, None],
                    torch.zeros_like(s.cnt), torch.zeros_like(s.vcnt))


def ridge_system(sums: GramSums, feat_mask: torch.Tensor,
                 lam) -> torch.Tensor:
    """Every leaf's (L, kp1, kp1) system matrix: ``A`` with the ridge on
    the feature diagonals, 1 on a padded dimension, 0 on the intercept."""
    A = sums.A
    L, kp1, _ = A.shape
    f32 = torch.float32
    dev = A.device
    lam_t = torch.as_tensor(lam, dtype=f32).to(dev)
    one = torch.ones((), dtype=f32, device=dev)
    diag = torch.cat([torch.where(feat_mask, lam_t, one),
                      torch.zeros((L, 1), dtype=f32, device=dev)], dim=1)
    return A + diag[:, :, None] * torch.eye(kp1, dtype=f32, device=dev)[None]


def solve_leaves(sums: GramSums, feat_mask: torch.Tensor,
                 lam) -> Tuple[torch.Tensor, torch.Tensor]:
    """``beta`` (L, kp1) = ``-solve(A + ridge, B)`` (:func:`ridge_system`)
    with the intercept last, and ``fit_ok`` (L,): features, ``k + 1`` rows
    and NaN-free rows, a nonsingular system (``solve_ex``'s info, read on
    the device) and a finite solution."""
    _, B, cnt, vcnt = sums
    f32 = torch.float32
    sol, info = torch.linalg.solve_ex(ridge_system(sums, feat_mask, lam),
                                      B[:, :, None])
    beta = -sol[:, :, 0]
    k_l = torch.sum(feat_mask.to(f32), dim=1)
    fit_ok = (k_l > 0) & (cnt >= k_l + 1) & (vcnt >= k_l + 1) & (info == 0)
    fit_ok = fit_ok & torch.all(torch.isfinite(beta), dim=1)
    return beta, fit_ok


def fit_leaves_plain(X, row_leaf, g, h, feat_idx, feat_mask,
                     lam) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the JAX package's ``fit_leaves_impl``: the Gram sums
    by :func:`gram_sums_plain`, then :func:`solve_leaves`."""
    return solve_leaves(gram_sums_plain(X, row_leaf, g, h, feat_idx,
                                        feat_mask), feat_mask, lam)


def fit_leaves(X, row_leaf, ghc, feat_idx, feat_mask,
               lam) -> Tuple[torch.Tensor, torch.Tensor]:
    """All leaves' ridge fits: :func:`gram_sums` (the kernel on a CUDA
    tensor), then :func:`solve_leaves`. No read back to the host."""
    return solve_leaves(gram_sums(X, row_leaf, ghc, feat_idx, feat_mask),
                        feat_mask, lam)


def _device_raw(ds, device) -> torch.Tensor:
    """The raw numeric matrix on ``device``, uploaded once per dataset."""
    cache = ds.__dict__.setdefault("_device_raw_numeric", {})
    if device not in cache:
        cache[device] = torch.as_tensor(
            np.ascontiguousarray(ds.raw_numeric, np.float32)).to(device)
    return cache[device]


def fit_linear_leaves(tree, ds, row_leaf, ghc, *, lam: float, rate: float,
                      num_leaves_cap: int) -> None:
    """The batched counterpart of the host oracle's per-leaf loop: the
    feature tables on the host, the fit on ``row_leaf``'s device, and the
    surviving leaves' ``leaf_features`` / ``leaf_coeff`` / ``leaf_const``
    written onto the tree after ONE device->host transfer. Leaves whose
    fit declined keep their constant outputs, as in the oracle."""
    tables = leaf_feature_table(tree, ds, num_leaves_cap)
    if tables is None:
        return
    feat_idx, feat_mask = tables
    dev = row_leaf.device
    telemetry.count("linear/device_fits")
    beta, fit_ok = fit_leaves(
        _device_raw(ds, dev), row_leaf.to(torch.int32).contiguous(),
        ghc.contiguous(), torch.as_tensor(feat_idx).to(dev),
        torch.as_tensor(feat_mask).to(dev), lam)
    both = torch.cat([beta.to(torch.float64),
                      fit_ok.to(torch.float64)[:, None]], dim=1).cpu()
    beta_h = both[:, :-1].numpy()
    ok_h = both[:, -1].numpy() != 0
    solved = 0
    for l in range(tree.num_leaves):
        if not ok_h[l]:
            continue
        m = feat_mask[l]
        coefs = beta_h[l, :-1][m]
        keep = np.abs(coefs) > 1e-35
        tree.leaf_features[l] = feat_idx[l, m].astype(np.int64)[keep]
        tree.leaf_coeff[l] = coefs[keep] * rate
        tree.leaf_const[l] = float(beta_h[l, -1]) * rate
        solved += 1
    telemetry.count("linear/leaves_solved", solved)
    attempted = int(feat_mask[:tree.num_leaves].any(axis=1).sum())
    telemetry.count("linear/solve_fallback", attempted - solved)
