"""Objective functions (PyTorch port of ``lightgbm_tpu/objective.py``).

Every objective of the JAX package trains and serves: the regression
family (L2, L1, Huber, Fair, Poisson, Quantile, MAPE, Gamma, Tweedie),
binary logloss, multiclass softmax and one-vs-all, the two cross-entropy
objectives and the ranking objectives ``lambdarank`` and ``rank_xendcg``.

``init(metadata, device)`` binds the training labels and weights (f32, on
``device``); ``get_gradients(score)`` (``get_gradients(score, it)`` where
``needs_iter``) computes f32 gradients and hessians on that device with
the JAX package's arithmetic in its order; ``boost_from_score`` is the
initial score; ``renew_leaf_values`` (``need_renew``: L1, Quantile, MAPE)
refits a tree's leaves on the host from the rows' leaves and the scores
before the tree; ``convert_output`` takes any array-like raw score to
prediction space as a torch tensor of the input's float dtype.

LambdaRank's pairwise lambdas run in one hand-written CUDA launch on the
card (``ops/rank.lambdarank_gradients``, ``csrc/rank_lambdas.cu``); on a
host tensor its plain twin, the JAX package's padded bucket form ported op
for op. ``rank_xendcg`` is plain torch on either device: a per-query
softmax over the padded (Q, P) layout, with Gumbel noise from the port's
threefry (``prng.gumbel``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import prng
from .config import Config, OBJECTIVE_ALIASES
from .utils.log import Log


def _as_float(score) -> torch.Tensor:
    t = torch.as_tensor(score)
    return t if t.is_floating_point() else t.to(torch.float64)


def _rdiv(x: float, t: torch.Tensor) -> torch.Tensor:
    """``x / t`` as one division, as XLA computes a Python scalar over an
    array (torch's ``x / t`` is a reciprocal times ``x``, two roundings)."""
    return torch.div(torch.full_like(t, x), t)


def _weighted(grad, hess, weight):
    if weight is None:
        return grad, hess
    return grad * weight, hess * weight


def _percentile_weighted(values: np.ndarray, weights: Optional[np.ndarray],
                         alpha: float) -> float:
    """Weighted alpha-percentile with the reference's interpolation semantics
    (reference: regression_objective.hpp:18 PercentileFun, :50
    WeightedPercentileFun, including its boundary quirks)."""
    n = len(values)
    if n == 0:
        return 0.0
    if n <= 1:
        return float(values[0])
    if weights is None:
        v = np.sort(values)
        float_pos = (1.0 - alpha) * n
        pos = int(float_pos)
        if pos < 1:
            return float(v[-1])
        if pos >= n:
            return float(v[0])
        bias = float_pos - pos
        v1 = v[n - pos]          # pos-th largest
        v2 = v[n - 1 - pos]      # (pos+1)-th largest
        return float(v1 - (v1 - v2) * bias)
    order = np.argsort(values, kind="stable")
    v = values[order]
    cw = np.cumsum(weights[order].astype(np.float64))
    threshold = alpha * cw[-1]
    pos = int(np.searchsorted(cw, threshold, side="right"))
    pos = min(pos, n - 1)
    if pos == 0 or pos == n - 1:
        return float(v[pos])
    v1, v2 = float(v[pos - 1]), float(v[pos])
    if cw[pos + 1] - cw[pos] >= 1.0:
        return (threshold - cw[pos]) / (cw[pos + 1] - cw[pos]) * (v2 - v1) + v1
    return v2


def _renew_by_leaf(leaf_assign: np.ndarray, num_leaves: int,
                   resid: np.ndarray, weights: Optional[np.ndarray],
                   alpha: float) -> np.ndarray:
    """Each leaf's weighted alpha-percentile of the residuals of its rows
    (0 for a leaf without rows), the rows in their original order: one
    stable sort by leaf gives each leaf's rows as ``resid[leaf_assign ==
    l]`` does."""
    out = np.zeros(num_leaves)
    order = np.argsort(leaf_assign, kind="stable")
    bounds = np.searchsorted(leaf_assign[order], np.arange(num_leaves + 1))
    for leaf in range(num_leaves):
        rows = order[bounds[leaf]:bounds[leaf + 1]]
        if len(rows):
            out[leaf] = _percentile_weighted(
                resid[rows], None if weights is None else weights[rows],
                alpha)
    return out


class ObjectiveFunction:
    """Interface (reference: include/LightGBM/objective_function.h:19)."""

    name = "custom"
    num_model_per_iteration = 1
    need_renew = False
    is_ranking = False
    #: get_gradients takes the iteration index (per-iteration randomness)
    needs_iter = False

    def __init__(self, config: Config) -> None:
        self.config = config
        self.label: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None
        self.num_data = 0

    def init(self, metadata, device: torch.device = torch.device("cpu")
             ) -> None:
        """Bind the training labels and weights (f32, on ``device``)."""
        if metadata.label is None:
            Log.fatal("objective %s needs labels", self.name)
        self.num_data = metadata.num_data
        self._label_host = np.array(metadata.label, np.float32)
        self._weight_host = None if metadata.weight is None \
            else np.array(metadata.weight, np.float32)
        self.label = torch.as_tensor(self._label_host).to(device)
        self.weight = None if self._weight_host is None \
            else torch.as_tensor(self._weight_host).to(device)

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        """Initial raw score (reference: BoostFromScore, gbdt.cpp:333)."""
        return 0.0

    def convert_output(self, score) -> torch.Tensor:
        """Raw score -> prediction space (reference: ConvertOutput)."""
        return _as_float(score)

    def renew_leaf_values(self, leaf_assign: np.ndarray, num_leaves: int,
                          score_before: np.ndarray) -> Optional[np.ndarray]:
        """Refit leaf outputs from each row's leaf and the training scores
        before the tree (``need_renew`` objectives), or None."""
        return None


# ---------------------------------------------------------------- regression

class RegressionL2(ObjectiveFunction):
    """L2 loss; with reg_sqrt the model fits sqrt(|label|)*sign(label)
    (reference: regression_objective.hpp RegressionL2loss)."""
    name = "regression"

    def init(self, metadata, device=torch.device("cpu")) -> None:
        super().init(metadata, device)
        if self.config.reg_sqrt:
            lab = self._label_host
            self._label_host = (np.sign(lab) * np.sqrt(np.abs(lab))) \
                .astype(np.float32)
            self.label = torch.as_tensor(self._label_host).to(device)

    def get_gradients(self, score):
        g = score - self.label
        h = torch.ones_like(score)
        return _weighted(g, h, self.weight)

    def boost_from_score(self, class_id: int = 0) -> float:
        return float(np.average(self._label_host, weights=self._weight_host))

    def convert_output(self, score):
        s = _as_float(score)
        if self.config.reg_sqrt:
            return torch.sign(s) * s * s
        return s


class RegressionL1(RegressionL2):
    """L1 loss with leaf renewal by the residual median
    (reference: RegressionL1loss::RenewTreeOutput)."""
    name = "regression_l1"
    need_renew = True

    def get_gradients(self, score):
        diff = score - self.label
        g = torch.sign(diff)
        h = torch.ones_like(score)
        return _weighted(g, h, self.weight)

    def boost_from_score(self, class_id: int = 0) -> float:
        return _percentile_weighted(self._label_host, self._weight_host, 0.5)

    def renew_leaf_values(self, leaf_assign, num_leaves, score_before):
        resid = self._label_host - score_before
        return _renew_by_leaf(leaf_assign, num_leaves, resid,
                              self._weight_host, 0.5)


class RegressionHuber(RegressionL2):
    """Huber loss (reference: RegressionHuberLoss), alpha = transition
    point."""
    name = "huber"

    def get_gradients(self, score):
        a = self.config.alpha
        diff = score - self.label
        g = torch.where(torch.abs(diff) <= a, diff, a * torch.sign(diff))
        h = torch.ones_like(score)
        return _weighted(g, h, self.weight)


class RegressionFair(RegressionL2):
    """Fair loss (reference: RegressionFairLoss), c = fair_c."""
    name = "fair"

    def get_gradients(self, score):
        c = self.config.fair_c
        diff = score - self.label
        g = c * diff / (torch.abs(diff) + c)
        h = _rdiv(c * c, (torch.abs(diff) + c) ** 2)
        return _weighted(g, h, self.weight)


class RegressionPoisson(RegressionL2):
    """Poisson with log link (reference: RegressionPoissonLoss)."""
    name = "poisson"

    def init(self, metadata, device=torch.device("cpu")) -> None:
        super().init(metadata, device)
        if np.any(self._label_host < 0):
            Log.fatal("[poisson]: labels must be non-negative")

    def get_gradients(self, score):
        g = torch.exp(score) - self.label
        h = torch.exp(score + self.config.poisson_max_delta_step)
        return _weighted(g, h, self.weight)

    def boost_from_score(self, class_id: int = 0) -> float:
        avg = np.average(self._label_host, weights=self._weight_host)
        return float(np.log(max(avg, 1e-20)))

    def convert_output(self, score):
        return torch.exp(_as_float(score))


class RegressionQuantile(RegressionL2):
    """Pinball (quantile) loss with renewal
    (reference: RegressionQuantileloss)."""
    name = "quantile"
    need_renew = True

    def get_gradients(self, score):
        a = self.config.alpha
        g = torch.where(score < self.label, torch.full_like(score, -a),
                        torch.full_like(score, 1.0 - a))
        h = torch.ones_like(score)
        return _weighted(g, h, self.weight)

    def boost_from_score(self, class_id: int = 0) -> float:
        return _percentile_weighted(self._label_host, self._weight_host,
                                    self.config.alpha)

    def renew_leaf_values(self, leaf_assign, num_leaves, score_before):
        resid = self._label_host - score_before
        return _renew_by_leaf(leaf_assign, num_leaves, resid,
                              self._weight_host, self.config.alpha)


class RegressionMAPE(RegressionL2):
    """MAPE: L1 with 1/|label| weights and weighted-median renewal
    (reference: RegressionMAPELOSS). The weights fold into the label
    weights, and ``weight`` is then None."""
    name = "mape"
    need_renew = True

    def init(self, metadata, device=torch.device("cpu")) -> None:
        super().init(metadata, device)
        lab = self._label_host
        lw = 1.0 / np.maximum(1.0, np.abs(lab))
        w = self._weight_host
        self._label_weight = lw if w is None else lw * w
        self._lw = torch.as_tensor(
            np.asarray(self._label_weight, np.float32)).to(device)
        self.weight = None          # folded into the label weights
        self._weight_host = None    # the host mirror tracks self.weight

    def get_gradients(self, score):
        diff = score - self.label
        g = torch.sign(diff) * self._lw
        h = self._lw
        return g, h

    def boost_from_score(self, class_id: int = 0) -> float:
        return _percentile_weighted(self._label_host, self._label_weight, 0.5)

    def renew_leaf_values(self, leaf_assign, num_leaves, score_before):
        resid = self._label_host - score_before
        return _renew_by_leaf(leaf_assign, num_leaves, resid,
                              self._label_weight, 0.5)


class RegressionGamma(RegressionPoisson):
    """Gamma deviance with log link (reference: RegressionGammaLoss)."""
    name = "gamma"

    def get_gradients(self, score):
        g = 1.0 - self.label * torch.exp(-score)
        h = self.label * torch.exp(-score)
        return _weighted(g, h, self.weight)


class RegressionTweedie(RegressionPoisson):
    """Tweedie with log link (reference: RegressionTweedieLoss)."""
    name = "tweedie"

    def get_gradients(self, score):
        rho = self.config.tweedie_variance_power
        e1 = torch.exp((1.0 - rho) * score)
        e2 = torch.exp((2.0 - rho) * score)
        g = -self.label * e1 + e2
        h = -self.label * (1.0 - rho) * e1 + (2.0 - rho) * e2
        return _weighted(g, h, self.weight)


# -------------------------------------------------------------------- binary

class BinaryLogloss(ObjectiveFunction):
    """Sigmoid binary cross-entropy (reference: binary_objective.hpp),
    with is_unbalance / scale_pos_weight label weighting."""
    name = "binary"

    def init(self, metadata, device=torch.device("cpu")) -> None:
        super().init(metadata, device)
        lab = self._label_host
        uniq = np.unique(lab)
        if not np.all(np.isin(uniq, [0, 1])):
            Log.fatal("[binary]: labels must be 0 or 1, got %s", uniq[:5])
        w = self._weight_host
        cnt_pos = float(np.sum((lab > 0) * (w if w is not None else 1.0)))
        cnt_neg = float(np.sum((lab <= 0) * (w if w is not None else 1.0)))
        self._pavg = cnt_pos / max(cnt_pos + cnt_neg, 1e-10)
        pos_w, neg_w = 1.0, 1.0
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                neg_w = cnt_pos / cnt_neg
            else:
                pos_w = cnt_neg / cnt_pos
        pos_w *= self.config.scale_pos_weight
        self._label_sign = torch.as_tensor(
            np.where(lab > 0, 1.0, -1.0).astype(np.float32)).to(device)
        self._label_w = torch.as_tensor(
            np.where(lab > 0, pos_w, neg_w).astype(np.float32)).to(device)

    def get_gradients(self, score):
        sig = self.config.sigmoid
        y = self._label_sign
        response = -y * sig / (1.0 + torch.exp(y * sig * score))
        absr = torch.abs(response)
        g = response * self._label_w
        h = absr * (sig - absr) * self._label_w
        return _weighted(g, h, self.weight)

    def boost_from_score(self, class_id: int = 0) -> float:
        p = np.clip(self._pavg, 1e-15, 1 - 1e-15)
        return float(np.log(p / (1 - p)) / self.config.sigmoid)

    def convert_output(self, score):
        return 1.0 / (1.0 + torch.exp(-self.config.sigmoid
                                      * _as_float(score)))


# ---------------------------------------------------------------- multiclass

class MulticlassSoftmax(ObjectiveFunction):
    """Softmax, K trees per iteration
    (reference: multiclass_objective.hpp MulticlassSoftmax)."""
    name = "multiclass"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.num_class = int(config.num_class)
        self.num_model_per_iteration = self.num_class

    def init(self, metadata, device=torch.device("cpu")) -> None:
        super().init(metadata, device)
        lab = self._label_host.astype(np.int32)
        if lab.min() < 0 or lab.max() >= self.num_class:
            Log.fatal("[multiclass]: labels must be in [0, num_class)")
        self._onehot = torch.as_tensor(
            np.eye(self.num_class, dtype=np.float32)[lab]).to(device)

    def get_gradients(self, score):
        p = torch.softmax(score, dim=1)
        g = p - self._onehot
        # hessian upper-bound factor K/(K-1) (multiclass_objective.hpp:31)
        factor = self.num_class / max(self.num_class - 1, 1)
        h = factor * p * (1.0 - p)
        if self.weight is not None:
            g = g * self.weight[:, None]
            h = h * self.weight[:, None]
        return g, h

    def convert_output(self, score):
        return torch.softmax(_as_float(score), dim=1)


class MulticlassOVA(ObjectiveFunction):
    """K one-vs-all binary objectives (reference: MulticlassOVA)."""
    name = "multiclassova"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.num_class = int(config.num_class)
        self.num_model_per_iteration = self.num_class

    def init(self, metadata, device=torch.device("cpu")) -> None:
        super().init(metadata, device)
        lab = self._label_host.astype(np.int32)
        self._sign = torch.as_tensor(np.where(
            np.eye(self.num_class, dtype=np.float32)[lab] > 0, 1.0, -1.0)
            .astype(np.float32)).to(device)

    def get_gradients(self, score):
        sig = self.config.sigmoid
        y = self._sign
        response = -y * sig / (1.0 + torch.exp(y * sig * score))
        absr = torch.abs(response)
        g, h = response, absr * (sig - absr)
        if self.weight is not None:
            g = g * self.weight[:, None]
            h = h * self.weight[:, None]
        return g, h

    def convert_output(self, score):
        return 1.0 / (1.0 + torch.exp(-self.config.sigmoid
                                      * _as_float(score)))


# ------------------------------------------------------------- cross entropy

class CrossEntropy(ObjectiveFunction):
    """Cross-entropy with probabilistic labels in [0, 1]
    (reference: xentropy_objective.hpp CrossEntropy), sigmoid link."""
    name = "cross_entropy"

    def init(self, metadata, device=torch.device("cpu")) -> None:
        super().init(metadata, device)
        lab = self._label_host
        if lab.min() < 0 or lab.max() > 1:
            Log.fatal("[cross_entropy]: labels must be in [0, 1]")

    def get_gradients(self, score):
        p = 1.0 / (1.0 + torch.exp(-score))
        g = p - self.label
        h = p * (1.0 - p)
        return _weighted(g, h, self.weight)

    def boost_from_score(self, class_id: int = 0) -> float:
        avg = np.average(self._label_host, weights=self._weight_host)
        p = np.clip(avg, 1e-15, 1 - 1e-15)
        return float(np.log(p / (1 - p)))

    def convert_output(self, score):
        return torch.sigmoid(_as_float(score))


class CrossEntropyLambda(ObjectiveFunction):
    """Alternative-parameterization cross-entropy (reference:
    CrossEntropyLambda: log1p(exp) link with the weights folded into the
    link)."""
    name = "cross_entropy_lambda"

    def get_gradients(self, score):
        w = self.weight if self.weight is not None else 1.0
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - self.label + self.label * torch.exp(w * hhat)
        enf = torch.exp(-score)
        g = (1.0 - self.label / z) * w / (1.0 + enf)
        c = 1.0 / (1.0 - (1.0 - 1e-12) / z)
        h = w * epf / ((1.0 + epf) ** 2) * (
            1.0 + w * epf / (1.0 + epf)
            * (1.0 - 1.0 / torch.clamp(c, min=1e-12)))
        h = torch.abs(h) + 1e-6
        return g, h

    def boost_from_score(self, class_id: int = 0) -> float:
        avg = np.average(self._label_host, weights=self._weight_host)
        p = np.clip(avg, 1e-15, 1 - 1e-15)
        return float(np.log(np.expm1(p)) if p > 0 else 0.0)

    def convert_output(self, score):
        return torch.log1p(torch.exp(_as_float(score)))


# ------------------------------------------------------------------- ranking

def _pad_queries(qb: np.ndarray) -> Tuple[np.ndarray, int]:
    """(Q+1,) boundaries -> (Q, P) row-index matrix padded with -1."""
    sizes = np.diff(qb)
    P = int(sizes.max()) if len(sizes) else 1
    Q = len(sizes)
    idx = np.full((Q, P), -1, dtype=np.int32)
    for q in range(Q):
        idx[q, : sizes[q]] = np.arange(qb[q], qb[q + 1], dtype=np.int32)
    return idx, P


#: padded query lengths of the lambda twin's buckets (the JAX package's
#: ladder: one (Q_b, K, P_b) set of pair tensors per rung)
_BUCKET_LADDER = (8, 16, 24, 32, 48, 64, 96, 128, 160, 192, 224, 256,
                  320, 384, 448, 512, 640, 768, 1024)


def _bucket_queries(qb: np.ndarray):
    """(Q+1,) boundaries -> list of (P_b, query_index_array) buckets."""
    sizes = np.diff(qb)
    ladder = np.asarray(_BUCKET_LADDER)
    out = []
    for p_b in _BUCKET_LADDER:
        lo = 0 if p_b == _BUCKET_LADDER[0] else ladder[ladder < p_b].max()
        sel = np.where((sizes > lo) & (sizes <= p_b))[0]
        if len(sel):
            out.append((p_b, sel))
    big = np.where(sizes > _BUCKET_LADDER[-1])[0]
    if len(big):
        # beyond the ladder: one bucket per 256-multiple
        pmax = int(sizes[big].max())
        for p_b in range(_BUCKET_LADDER[-1] + 256, pmax + 256, 256):
            sel = big[(sizes[big] > p_b - 256) & (sizes[big] <= p_b)]
            if len(sel):
                out.append((p_b, sel))
    return out


class LambdarankNDCG(ObjectiveFunction):
    """LambdaRank with NDCG lambda gradients (reference:
    rank_objective.hpp:100 LambdarankNDCG): per-query pairwise lambdas
    weighted by |delta NDCG|, ``lambdarank_truncation_level`` capping the
    higher-ranked side of each pair, optional ``lambdarank_norm``. The
    tables are the JAX package's (per-row gains from ``label_gain``,
    default 2^i - 1; each query's inverse max DCG over ALL its positions;
    the discount 1 / log2(rank + 2)); the lambdas are one launch of
    ``csrc/rank_lambdas.cu`` on the card (``ops/rank``)."""
    name = "lambdarank"
    is_ranking = True

    def init(self, metadata, device=torch.device("cpu")) -> None:
        from .ops.rank import RankTables

        super().init(metadata, device)
        if metadata.query_boundaries is None:
            Log.fatal("[lambdarank]: query data (group) required")
        cfg = self.config
        label_gain = cfg.label_gain or [float(2 ** i - 1) for i in range(31)]
        lab = self._label_host.astype(np.int32)
        if lab.max() >= len(label_gain):
            Log.fatal("[lambdarank]: label %d exceeds label_gain size",
                      lab.max())
        self._gains_np = np.asarray(label_gain, np.float64)[lab] \
            .astype(np.float32)
        qb = np.asarray(metadata.query_boundaries, np.int64)
        sizes = np.diff(qb)
        self.P = int(sizes.max()) if len(sizes) else 1
        self.trunc = min(int(cfg.lambdarank_truncation_level), self.P)
        # queries bucketed by padded length (_BUCKET_LADDER), the JAX
        # package's tables; inv_max_dcg per bucket row exactly as it sums
        # them (over every position of the query, padding included), then
        # gathered per query for the kernel
        buckets = _bucket_queries(qb)
        p_max = max((p_b for p_b, _ in buckets), default=1)
        disc_np = 1.0 / np.log2(np.arange(p_max) + 2.0)
        inv_q = np.zeros(len(sizes), np.float32)
        tables = []
        for p_b, qsel in buckets:
            q_b = len(qsel)
            idx = np.full((q_b, p_b), -1, dtype=np.int32)
            for row, q in enumerate(qsel):
                idx[row, : sizes[q]] = np.arange(qb[q], qb[q + 1],
                                                 dtype=np.int32)
            valid = idx >= 0
            safe = np.maximum(idx, 0)
            gains = np.where(valid, self._gains_np[safe], 0.0)
            g_sorted = -np.sort(-gains, axis=1)
            max_dcg = (g_sorted * disc_np[None, :p_b]).sum(axis=1)
            inv = np.where(max_dcg > 0, 1.0 / np.maximum(max_dcg, 1e-20),
                           0.0).astype(np.float32)
            inv_q[qsel] = inv
            tables.append((p_b, min(self.trunc, p_b), safe, valid,
                           gains.astype(np.float32), inv))
        self.tables = RankTables.build(
            qb, self._gains_np, inv_q, disc_np.astype(np.float32), tables,
            sigmoid=float(cfg.sigmoid),
            truncation_level=int(cfg.lambdarank_truncation_level),
            norm=bool(cfg.lambdarank_norm), device=device)

    def get_gradients(self, score):
        """(N,) score -> (N,) grad / hess: the kernel on a CUDA tensor,
        the twin (the JAX package's bucket form) on a CPU tensor."""
        from .ops.rank import lambdarank_gradients

        return lambdarank_gradients(score, self.tables, self.weight)


class RankXENDCG(ObjectiveFunction):
    """XE-NDCG listwise surrogate (reference: rank_objective.hpp
    RankXENDCG, per Bruch et al.): the cross-entropy between a sampled
    Gumbel-perturbed label distribution and the score softmax, per query,
    over the (Q, P) padded layout. The noise of iteration ``it`` is
    ``gumbel(fold_in(PRNGKey(objective_seed or 5), it), (Q, P))``, the
    JAX package's draw bit for bit up to ``log``'s last ulp."""
    name = "rank_xendcg"
    is_ranking = True
    needs_iter = True

    def init(self, metadata, device=torch.device("cpu")) -> None:
        super().init(metadata, device)
        if metadata.query_boundaries is None:
            Log.fatal("[rank_xendcg]: query data (group) required")
        lab = self._label_host
        doc_idx, self.P = _pad_queries(metadata.query_boundaries)
        self.doc_valid = torch.as_tensor(doc_idx >= 0).to(device)
        self.safe_idx = torch.as_tensor(
            np.maximum(doc_idx, 0).astype(np.int64)).to(device)
        phi = (2.0 ** lab - 1.0).astype(np.float32)
        self.q_phi = torch.where(
            self.doc_valid, torch.as_tensor(phi).to(device)[self.safe_idx],
            torch.zeros((), dtype=torch.float32, device=device))
        self.key = prng.PRNGKey(int(self.config.objective_seed or 5))

    def get_gradients(self, score, it=0):
        key = prng.fold_in(self.key, int(it))
        valid = self.doc_valid
        ninf = torch.full((), float("-inf"), dtype=torch.float32,
                          device=score.device)
        s = torch.where(valid, score[self.safe_idx], ninf)
        # sampled relevance distribution: softmax(phi + gumbel)
        gumbel = prng.gumbel(key, tuple(s.shape), device=score.device)
        phi_pert = torch.where(valid, self.q_phi + gumbel, ninf)
        target = torch.softmax(phi_pert, dim=1)
        rho = torch.softmax(s, dim=1)
        grad_q = rho - target
        hess_q = rho * (1.0 - rho)
        return _scatter_rows(score.shape[0], self.safe_idx, valid, grad_q,
                             hess_q)


def _scatter_rows(n: int, safe_idx: torch.Tensor, valid: torch.Tensor,
                  grad_q: torch.Tensor, hess_q: torch.Tensor):
    """(Q, P) per-slot values -> (N,) rows, as the JAX package's
    ``zeros(N).at[idx].add(where(valid, v, 0))``: every row is one slot's
    (``0 + v``), padded slots add 0 to row 0; hess floored at 1e-20."""
    flat = safe_idx.reshape(-1)
    vm = valid.reshape(-1)
    zero = torch.zeros((), dtype=torch.float32, device=grad_q.device)
    grad = torch.zeros(n, dtype=torch.float32, device=grad_q.device) \
        .index_add_(0, flat, torch.where(vm, grad_q.reshape(-1), zero))
    hess = torch.zeros(n, dtype=torch.float32, device=grad_q.device) \
        .index_add_(0, flat, torch.where(vm, hess_q.reshape(-1), zero))
    return grad, torch.clamp(hess, min=1e-20)


class NoneObjective(ObjectiveFunction):
    """Custom objective: raw scores pass through; gradients come from the
    caller's ``fobj``."""
    name = "none"

    def get_gradients(self, score):
        Log.fatal("objective=none trains only with an fobj that supplies "
                  "gradients and hessians")


_REGISTRY = {cls.name: cls for cls in (
    RegressionL2, RegressionL1, RegressionHuber, RegressionFair,
    RegressionPoisson, RegressionQuantile, RegressionMAPE, RegressionGamma,
    RegressionTweedie, BinaryLogloss, MulticlassSoftmax, MulticlassOVA,
    CrossEntropy, CrossEntropyLambda, LambdarankNDCG, RankXENDCG,
    NoneObjective)}


def create_objective(config: Config) -> ObjectiveFunction:
    """Factory (reference: src/objective/objective_function.cpp:15)."""
    name = OBJECTIVE_ALIASES.get(config.objective, config.objective)
    if name not in _REGISTRY:
        Log.fatal("Unknown objective: %s", config.objective)
    return _REGISTRY[name](config)
