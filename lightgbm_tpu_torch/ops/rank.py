"""LambdaRank's pairwise lambdas: the gradients and hessians of
``objective=lambdarank`` from the scores (``objective.LambdarankNDCG``).

The JAX package computes them in XLA (``lightgbm_tpu/objective.py``,
``LambdarankNDCG._bucket_lambdas`` and the scatter of ``get_gradients``):
queries bucketed by padded length, a stable argsort of each padded row,
and about fifteen (Q_b, K, P_b) pair tensors per bucket. On a CUDA tensor
:func:`lambdarank_gradients` is one launch of the hand-written kernel
``csrc/rank_lambdas.cu`` (one block per query, no padded tensors; see the
source for its design); on a CPU tensor it is the plain twin
:func:`lambdarank_gradients_plain`, that XLA code ported to torch op for
op, bucket by bucket in the same order.

The kernel and the twin sum each document's lambdas in different orders
(the kernel rank by rank, XLA and torch by their reductions), so they
agree within :data:`LAMBDA_RTOL` of the query's largest ``|grad|``, not
bit for bit; the kernel's order is fixed, so training on the card is
deterministic run to run.

The kernel's truncation is ``K = min(lambdarank_truncation_level,
len_q)`` per query, where the twin uses ``K_b = min(trunc, P_b)`` per
bucket with ``trunc = min(lambdarank_truncation_level, P_max)``. The two
take the same pairs: a query's padded slots hold score -inf, sort after
its ``len_q`` documents and are masked out of every pair, so the twin's
ranks at or past ``len_q`` add nothing, and ``min(truncation_level,
P_max, P_b, len_q) = min(truncation_level, len_q)`` because ``len_q <=
P_b`` and ``len_q <= P_max``. A NaN score sorts after every number and
after the padding in both (``argsort`` of ``-s``); the kernel ranks a NaN
document as the twin does within its bucket (``top_ranks`` in the
source), so the same pairs, and the same rows, come out NaN.

An empty query is left out of every bucket, as in the JAX package; the
kernel gives it a block that does nothing.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .kernels import CudaKernel, register, stream_of
from .partition import check_on_card

_P = ctypes.c_void_p
#: the pair arithmetic follows the JAX package's op order (no contraction)
RANK_KERNEL = register(CudaKernel(
    "rank_lambdas", "rank_lambdas.cu",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
     ctypes.c_int, _P],
    flags=("-fmad=false",)))

#: the longest query whose arrays the kernel keeps in shared memory (7
#: words a document: 28 KB a block); longer queries work in a global
#: scratch of 5 words a row
RANK_SMEM_DOCS = 1024
#: kernel vs twin: |diff| <= LAMBDA_RTOL * (the query's largest |grad|
#: or |hess|): sums of up to ~len_q f32 terms in two orders
LAMBDA_RTOL = 1e-5


class RankTables(NamedTuple):
    """A training set's LambdaRank tables on one device.

    The kernel reads ``qb``, ``gains``, ``inv_max_dcg`` and ``discount``;
    the twin reads ``buckets``, kept on the host as numpy and moved to the
    scores' device when the twin runs (:func:`bucket_tensors`): per padded
    length ``P_b``, ``(P_b, K_b, safe_idx (Q_b, P_b) i64, valid (Q_b, P_b)
    bool, gains (Q_b, P_b) f32, inv_max_dcg (Q_b,) f32)``, the JAX
    package's bucket tables."""
    qb: torch.Tensor             # (Q+1,) i32 query boundaries
    gains: torch.Tensor          # (N,) f32 label gain of each row
    inv_max_dcg: torch.Tensor    # (Q,) f32
    discount: torch.Tensor       # (P,) f32 1 / log2(rank + 2)
    buckets: Tuple
    sigmoid: float
    truncation_level: int
    norm: bool
    max_len: int                 # the longest query
    smem_docs: int               # the longest query <= RANK_SMEM_DOCS

    @classmethod
    def build(cls, qb: np.ndarray, gains: np.ndarray, inv_max_dcg: np.ndarray,
              discount: np.ndarray, buckets: Sequence, *, sigmoid: float,
              truncation_level: int, norm: bool,
              device: torch.device) -> "RankTables":
        """Tables from host arrays (``buckets`` as numpy tuples)."""
        sizes = np.diff(np.asarray(qb, np.int64))
        if len(sizes) and qb[-1] >= 2 ** 31:
            raise ValueError("rank tables: too many rows for i32 bounds")
        small = sizes[sizes <= RANK_SMEM_DOCS]

        def dev(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a, dtype)).to(device)

        return cls(
            qb=dev(qb, np.int32), gains=dev(gains, np.float32),
            inv_max_dcg=dev(inv_max_dcg, np.float32),
            discount=dev(discount, np.float32),
            buckets=tuple((int(p_b), int(k_b),
                           np.ascontiguousarray(safe, np.int64),
                           np.ascontiguousarray(valid, np.bool_),
                           np.ascontiguousarray(g, np.float32),
                           np.ascontiguousarray(inv, np.float32))
                          for p_b, k_b, safe, valid, g, inv in buckets),
            sigmoid=float(sigmoid), truncation_level=int(truncation_level),
            norm=bool(norm), max_len=int(sizes.max()) if len(sizes) else 0,
            smem_docs=int(small.max()) if len(small) else 0)

    @property
    def num_queries(self) -> int:
        return self.qb.shape[0] - 1


def bucket_tensors(t: RankTables, device: torch.device):
    """The twin's bucket tables of ``t`` as tensors on ``device`` (a view
    of the host arrays on the CPU)."""
    for p_b, k_b, *arrays in t.buckets:
        yield (p_b, k_b) + tuple(torch.as_tensor(a).to(device)
                                 for a in arrays)


def _bucket_lambdas(score: torch.Tensor, t: RankTables, p_b: int, K: int,
                    safe_idx, valid, gains, inv_max_dcg):
    """Per-bucket (Q_b, P_b) grad / hess via padded pairwise lambdas (the
    JAX package's ``_bucket_lambdas``, op for op)."""
    ninf = torch.full((), float("-inf"), dtype=torch.float32,
                      device=score.device)
    s = torch.where(valid, score[safe_idx], ninf)                # (Q, P)
    order = torch.argsort(-s, dim=1, stable=True)                # rank->slot
    s_sorted = torch.gather(s, 1, order)
    g_sorted = torch.gather(gains, 1, order)
    valid_sorted = torch.gather(valid, 1, order)
    # pairs: i in the top-K ranks x j in all ranks; j > i counted once
    si = s_sorted[:, :K]                                         # (Q, K)
    gi = g_sorted[:, :K]
    vi = valid_sorted[:, :K]
    di = t.discount[:K]
    disc = t.discount[:p_b]
    delta_s = si[:, :, None] - s_sorted[:, None, :]              # (Q, K, P)
    worse = gi[:, :, None] > g_sorted[:, None, :]
    better = gi[:, :, None] < g_sorted[:, None, :]
    pair_mask = (worse | better) & vi[:, :, None] & valid_sorted[:, None, :]
    # |delta NDCG| of swapping ranks i <-> j
    dd = torch.abs(di[None, :, None] - disc[None, None, :])
    dgain = torch.abs(gi[:, :, None] - g_sorted[:, None, :])
    delta_ndcg = dd * dgain * inv_max_dcg[:, None, None]
    # orient each pair so "hi" is the better-labelled document
    one = torch.ones((), dtype=torch.float32, device=score.device)
    sgn = torch.where(worse, one, -one)
    d = sgn * delta_s                                            # s_hi - s_lo
    sig = t.sigmoid
    p = 1.0 / (1.0 + torch.exp(sig * d))                         # misorder
    lam = -sig * p * delta_ndcg
    hess = (sig * sig) * p * (1.0 - p) * delta_ndcg
    zero = torch.zeros((), dtype=torch.float32, device=score.device)
    lam = torch.where(pair_mask, lam, zero)
    hess = torch.where(pair_mask, hess, zero)
    jr = torch.arange(p_b, device=score.device)[None, None, :]
    ir = torch.arange(K, device=score.device)[None, :, None]
    once = jr > ir
    lam = torch.where(once, lam, zero)
    hess = torch.where(once, hess, zero)
    lam_i = torch.sum(lam * sgn, dim=2)                          # (Q, K)
    lam_j = -lam * sgn                                           # (Q, K, P)
    hess_i = torch.sum(hess, dim=2)
    grad_sorted = torch.zeros_like(s_sorted)
    grad_sorted[:, :K] += lam_i
    grad_sorted = grad_sorted + torch.sum(lam_j, dim=1)
    hess_sorted = torch.zeros_like(s_sorted)
    hess_sorted[:, :K] += hess_i
    hess_sorted = hess_sorted + torch.sum(hess, dim=1)
    if t.norm:
        norm = torch.sum(torch.abs(grad_sorted), dim=1, keepdim=True)
        scale = torch.where(
            norm > 0, torch.log2(1 + norm) / torch.clamp(norm, min=1e-20),
            one)
        grad_sorted = grad_sorted * scale
        hess_sorted = hess_sorted * scale
    # unsort ranks back to slots
    inv = torch.argsort(order, dim=1)
    return torch.gather(grad_sorted, 1, inv), torch.gather(hess_sorted, 1, inv)


def lambdarank_gradients_plain(score: torch.Tensor, t: RankTables,
                               weight: Optional[torch.Tensor] = None):
    """Plain torch twin of ``csrc/rank_lambdas.cu``: (N,) f32 score ->
    (N,) grad, hess, one padded pairwise-lambda pass per length bucket
    scattered back in one disjoint update, then ``max(hess, 1e-20)`` and
    the weights (the JAX package's ``get_gradients``). Runs on any
    device; ``lambdarank_gradients`` takes it only for a CPU tensor."""
    n = score.shape[0]
    idx_parts, g_parts, h_parts = [], [], []
    zero = torch.zeros((), dtype=torch.float32, device=score.device)
    for p_b, k_b, safe_idx, valid, gains, inv in bucket_tensors(
            t, score.device):
        grad_q, hess_q = _bucket_lambdas(score, t, p_b, k_b, safe_idx,
                                         valid, gains, inv)
        vm = valid.reshape(-1)
        idx_parts.append(safe_idx.reshape(-1))
        g_parts.append(torch.where(vm, grad_q.reshape(-1), zero))
        h_parts.append(torch.where(vm, hess_q.reshape(-1), zero))
    grad = torch.zeros(n, dtype=torch.float32, device=score.device)
    hess = torch.zeros(n, dtype=torch.float32, device=score.device)
    if idx_parts:
        flat = torch.cat(idx_parts)
        grad.index_add_(0, flat, torch.cat(g_parts))
        hess.index_add_(0, flat, torch.cat(h_parts))
    hess = torch.clamp(hess, min=1e-20)
    if weight is not None:
        grad, hess = grad * weight, hess * weight
    return grad, hess


def lambdarank_gradients(score: torch.Tensor, t: RankTables,
                         weight: Optional[torch.Tensor] = None):
    """(N,) f32 scores -> (N,) f32 grad, hess of LambdaRank. On a CUDA
    tensor one launch of ``csrc/rank_lambdas.cu`` (no fallback: a failed
    build or launch raises); on a CPU tensor
    :func:`lambdarank_gradients_plain`."""
    n = score.shape[0]
    if score.dim() != 1 or score.dtype != torch.float32 \
            or t.gains.shape[0] != n:
        raise ValueError("lambdarank_gradients: want (%d,) f32 scores, got "
                         "%s %s" % (t.gains.shape[0], tuple(score.shape),
                                    score.dtype))
    if score.device.type == "cpu":
        return lambdarank_gradients_plain(score, t, weight)
    extra = () if weight is None else (weight,)
    score = score.contiguous()
    check_on_card("rank_lambdas", score, t.qb, t.gains, t.inv_max_dcg,
                  t.discount, *extra)
    grad = torch.empty_like(score)
    hess = torch.empty_like(score)
    if t.num_queries == 0:
        return grad, hess
    # the long queries' arrays, per call (the caching allocator's block)
    scratch = torch.empty(5 * n, dtype=torch.float32, device=score.device) \
        if t.max_len > RANK_SMEM_DOCS else None
    RANK_KERNEL.launch(
        score.data_ptr(), t.gains.data_ptr(), t.qb.data_ptr(),
        t.inv_max_dcg.data_ptr(), t.discount.data_ptr(),
        0 if weight is None else weight.data_ptr(), grad.data_ptr(),
        hess.data_ptr(), 0 if scratch is None else scratch.data_ptr(), n,
        t.num_queries, t.smem_docs, t.sigmoid,
        float(t.sigmoid * t.sigmoid), min(t.truncation_level, t.max_len),
        int(t.norm), stream_of(score))
    return grad, hess
