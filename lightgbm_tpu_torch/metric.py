"""Evaluation metrics (PyTorch port of ``lightgbm_tpu/metric.py``).

Every metric of the JAX package, with its aliases: the regression family
(l1, l2, rmse, quantile, huber, fair, poisson, mape, gamma,
gamma_deviance, tweedie), binary logloss and error, auc,
average_precision, multiclass logloss and top-k error, auc_mu, the
cross-entropy family (cross_entropy, cross_entropy_lambda,
kullback_leibler) and the ranking metrics ndcg@k and map@k (reference:
src/metric/metric.cpp:17 factory; regression_metric.hpp,
binary_metric.hpp, rank_metric.hpp, multiclass_metric.hpp,
xentropy_metric.hpp, map_metric.hpp, dcg_calculator.cpp). They run in
host numpy over *converted* predictions (the objective's
``convert_output`` already applied on the device), as in the JAX package:
evaluation is off the training hot path. An unknown metric name warns and
is skipped, as there.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from .config import Config
from .utils.log import Log


class Metric:
    name = "metric"
    greater_is_better = False

    def __init__(self, config: Config) -> None:
        self.config = config

    def eval(self, pred: np.ndarray, label: np.ndarray,
             weight: Optional[np.ndarray],
             query_boundaries: Optional[np.ndarray] = None) -> List:
        """Returns [(name, value)] pairs."""
        raise NotImplementedError


def _avg(values: np.ndarray, weight: Optional[np.ndarray]) -> float:
    return float(np.average(values, weights=weight))


class _PointwiseMetric(Metric):
    def point(self, pred: np.ndarray, label: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def eval(self, pred, label, weight, query_boundaries=None):
        return [(self.name, _avg(self.point(pred.ravel(), label), weight))]


class L2Metric(_PointwiseMetric):
    name = "l2"

    def point(self, p, y):
        return (p - y) ** 2


class RMSEMetric(_PointwiseMetric):
    name = "rmse"

    def eval(self, pred, label, weight, query_boundaries=None):
        return [(self.name,
                 float(np.sqrt(_avg((pred.ravel() - label) ** 2, weight))))]


class L1Metric(_PointwiseMetric):
    name = "l1"

    def point(self, p, y):
        return np.abs(p - y)


class QuantileMetric(_PointwiseMetric):
    name = "quantile"

    def point(self, p, y):
        a = self.config.alpha
        d = y - p
        return np.where(d >= 0, a * d, (a - 1) * d)


class HuberMetric(_PointwiseMetric):
    name = "huber"

    def point(self, p, y):
        a = self.config.alpha
        d = np.abs(p - y)
        return np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))


class FairMetric(_PointwiseMetric):
    name = "fair"

    def point(self, p, y):
        c = self.config.fair_c
        x = np.abs(p - y)
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_PointwiseMetric):
    """Poisson negative log-likelihood (reference: PoissonMetric — eval over
    converted prediction, i.e. the rate)."""
    name = "poisson"

    def point(self, p, y):
        eps = 1e-10
        return p - y * np.log(np.maximum(p, eps))


class MAPEMetric(_PointwiseMetric):
    name = "mape"

    def point(self, p, y):
        return np.abs((y - p) / np.maximum(1.0, np.abs(y)))


class GammaMetric(_PointwiseMetric):
    """Gamma negative log-likelihood (reference: GammaMetric)."""
    name = "gamma"

    def point(self, p, y):
        psi = 1.0
        theta = -1.0 / np.maximum(p, 1e-10)
        a = psi
        b = -np.log(-theta)
        c = 1.0 / psi * np.log(y / psi) - np.log(y) - 0  # lgamma(1/psi)=0
        return -(y * theta - b) / a - c


class GammaDevianceMetric(_PointwiseMetric):
    """(reference: GammaDevianceMetric)"""
    name = "gamma_deviance"

    def point(self, p, y):
        eps = 1e-10
        frac = y / np.maximum(p, eps)
        return 2.0 * (frac - np.log(np.maximum(frac, eps)) - 1.0)


class TweedieMetric(_PointwiseMetric):
    name = "tweedie"

    def point(self, p, y):
        rho = self.config.tweedie_variance_power
        eps = 1e-10
        p = np.maximum(p, eps)
        a = y * np.power(p, 1.0 - rho) / (1.0 - rho)
        b = np.power(p, 2.0 - rho) / (2.0 - rho)
        return -a + b


class BinaryLoglossMetric(_PointwiseMetric):
    name = "binary_logloss"

    def point(self, p, y):
        eps = 1e-15
        p = np.clip(p, eps, 1 - eps)
        return -(y * np.log(p) + (1 - y) * np.log(1 - p))


class BinaryErrorMetric(_PointwiseMetric):
    name = "binary_error"

    def point(self, p, y):
        return ((p > 0.5) != (y > 0)).astype(np.float64)


class AUCMetric(Metric):
    """ROC AUC via weighted rank statistic (reference: binary_metric.hpp
    AUCMetric — sorted-by-score positive/negative mass accumulation)."""
    name = "auc"
    greater_is_better = True

    def eval(self, pred, label, weight, query_boundaries=None):
        p = pred.ravel()
        y = (label > 0).astype(np.float64)
        w = np.ones_like(y) if weight is None else weight.astype(np.float64)
        order = np.argsort(p, kind="mergesort")
        p, y, w = p[order], y[order], w[order]
        pos_w, neg_w = w * y, w * (1 - y)
        # ties: average rank, by distinct score groups
        _, idx_start = np.unique(p, return_index=True)
        group_id = np.zeros(len(p), dtype=np.int64)
        group_id[idx_start[1:]] = 1
        group_id = np.cumsum(group_id)
        neg_in_group = np.bincount(group_id, weights=neg_w)
        pos_in_group = np.bincount(group_id, weights=pos_w)
        neg_before = np.concatenate([[0.0], np.cumsum(neg_in_group)[:-1]])
        auc_sum = np.sum(pos_in_group * (neg_before + 0.5 * neg_in_group))
        tot_pos, tot_neg = pos_w.sum(), neg_w.sum()
        if tot_pos <= 0 or tot_neg <= 0:
            return [(self.name, 1.0)]
        return [(self.name, float(auc_sum / (tot_pos * tot_neg)))]


class AveragePrecisionMetric(Metric):
    """(reference: AveragePrecisionMetric)"""
    name = "average_precision"
    greater_is_better = True

    def eval(self, pred, label, weight, query_boundaries=None):
        p = pred.ravel()
        y = (label > 0).astype(np.float64)
        w = np.ones_like(y) if weight is None else weight.astype(np.float64)
        order = np.argsort(-p, kind="mergesort")
        y, w = y[order], w[order]
        tp = np.cumsum(w * y)
        total = np.cumsum(w)
        precision = tp / np.maximum(total, 1e-20)
        pos_total = (w * y).sum()
        if pos_total <= 0:
            return [(self.name, 1.0)]
        ap = np.sum(precision * w * y) / pos_total
        return [(self.name, float(ap))]


class AucMuMetric(Metric):
    """Multiclass AUC-mu (reference: multiclass_metric.hpp AucMuMetric):
    mean pairwise class AUC on the decision statistic."""
    name = "auc_mu"
    greater_is_better = True

    def eval(self, pred, label, weight, query_boundaries=None):
        K = self.config.num_class
        pred = pred.reshape(-1, K)
        lab = label.astype(np.int64)
        w = np.ones(len(lab)) if weight is None else weight
        # auc_mu_weights: KxK misclassification-cost matrix defining each
        # pair's separating direction (reference: multiclass_metric.hpp
        # AucMuMetric::Eval, Kleiman & Page's AUC-mu: the pair (a, b)
        # decision value is t1 * <W[a,:] - W[b,:], scores>)
        if self.config.auc_mu_weights:
            wm = np.asarray(self.config.auc_mu_weights, np.float64)
            if wm.size != K * K:
                Log.fatal("auc_mu_weights must have num_class^2 = %d "
                          "entries, got %d", K * K, wm.size)
            wm = wm.reshape(K, K)
        else:
            wm = 1.0 - np.eye(K)
        aucs = []
        auc_helper = AUCMetric(self.config)
        for a in range(K):
            for b in range(a + 1, K):
                m = (lab == a) | (lab == b)
                if not np.any(lab[m] == a) or not np.any(lab[m] == b):
                    continue
                curr_v = wm[a] - wm[b]                      # (K,)
                t1 = curr_v[a] - curr_v[b]
                s = t1 * (pred[m] @ curr_v)
                yy = (lab[m] == a).astype(np.float64)
                aucs.append(auc_helper.eval(s, yy, w[m])[0][1])
        return [(self.name, float(np.mean(aucs)) if aucs else 1.0)]


class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def eval(self, pred, label, weight, query_boundaries=None):
        K = self.config.num_class
        pred = pred.reshape(-1, K)
        lab = label.astype(np.int64)
        eps = 1e-15
        p = np.clip(pred[np.arange(len(lab)), lab], eps, 1.0)
        return [(self.name, _avg(-np.log(p), weight))]


class MultiErrorMetric(Metric):
    """Top-k error (reference: MultiErrorMetric with multi_error_top_k)."""
    name = "multi_error"

    def eval(self, pred, label, weight, query_boundaries=None):
        K = self.config.num_class
        k = max(1, self.config.multi_error_top_k)
        pred = pred.reshape(-1, K)
        lab = label.astype(np.int64)
        true_p = pred[np.arange(len(lab)), lab]
        # error when the true class's prob is not within the top k
        rank = np.sum(pred > true_p[:, None], axis=1)
        err = (rank >= k).astype(np.float64)
        return [(self.name, _avg(err, weight))]


class CrossEntropyMetric(_PointwiseMetric):
    name = "cross_entropy"

    def point(self, p, y):
        eps = 1e-15
        p = np.clip(p, eps, 1 - eps)
        return -(y * np.log(p) + (1 - y) * np.log(1 - p))


class CrossEntropyLambdaMetric(Metric):
    name = "cross_entropy_lambda"

    def eval(self, pred, label, weight, query_boundaries=None):
        # pred is converted: hhat = log1p(exp(score))
        hhat = pred.ravel()
        eps = 1e-15
        p = 1.0 - np.exp(-np.maximum(hhat, eps))
        p = np.clip(p, eps, 1 - eps)
        loss = -(label * np.log(p) + (1 - label) * np.log(1 - p))
        return [(self.name, _avg(loss, weight))]


class KullbackLeiblerMetric(_PointwiseMetric):
    """(reference: KullbackLeiblerDivergence in xentropy_metric.hpp)"""
    name = "kullback_leibler"

    def point(self, p, y):
        eps = 1e-15
        p = np.clip(p, eps, 1 - eps)
        yy = np.clip(y, eps, 1 - eps)
        ref = yy * np.log(yy) + (1 - yy) * np.log(1 - yy)
        xe = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return ref + xe


def _dcg_at(gains_sorted: np.ndarray, k: int) -> float:
    k = min(k, len(gains_sorted))
    if k <= 0:
        return 0.0
    disc = 1.0 / np.log2(np.arange(k) + 2.0)
    return float(np.sum(gains_sorted[:k] * disc))


class NDCGMetric(Metric):
    """NDCG at eval_at positions (reference: rank_metric.hpp NDCGMetric +
    dcg_calculator.cpp)."""
    name = "ndcg"
    greater_is_better = True

    def eval(self, pred, label, weight, query_boundaries=None):
        if query_boundaries is None:
            Log.fatal("[ndcg]: query data required")
        cfg = self.config
        label_gain = cfg.label_gain or [float(2 ** i - 1) for i in range(31)]
        lg = np.asarray(label_gain)
        ks = cfg.eval_at or [1, 2, 3, 4, 5]
        p = pred.ravel()
        results = {k: [] for k in ks}
        qb = query_boundaries
        for q in range(len(qb) - 1):
            s, e = qb[q], qb[q + 1]
            gains = lg[label[s:e].astype(np.int64)]
            order = np.argsort(-p[s:e], kind="mergesort")
            g_pred = gains[order]
            g_best = -np.sort(-gains)
            for k in ks:
                ideal = _dcg_at(g_best, k)
                results[k].append(1.0 if ideal <= 0
                                  else _dcg_at(g_pred, k) / ideal)
        return [("%s@%d" % (self.name, k), float(np.mean(results[k])))
                for k in ks]


class MapMetric(Metric):
    """MAP at eval_at positions (reference: map_metric.hpp)."""
    name = "map"
    greater_is_better = True

    def eval(self, pred, label, weight, query_boundaries=None):
        if query_boundaries is None:
            Log.fatal("[map]: query data required")
        ks = self.config.eval_at or [1, 2, 3, 4, 5]
        p = pred.ravel()
        qb = query_boundaries
        results = {k: [] for k in ks}
        for q in range(len(qb) - 1):
            s, e = qb[q], qb[q + 1]
            rel = (label[s:e] > 0).astype(np.float64)
            order = np.argsort(-p[s:e], kind="mergesort")
            rel = rel[order]
            hits = np.cumsum(rel)
            prec = hits / (np.arange(len(rel)) + 1.0)
            for k in ks:
                kk = min(k, len(rel))
                npos = rel[:kk].sum()
                results[k].append(
                    0.0 if npos <= 0
                    else float(np.sum(prec[:kk] * rel[:kk]) / npos))
        return [("%s@%d" % (self.name, k), float(np.mean(results[k])))
                for k in ks]


_REGISTRY: Dict[str, Callable] = {
    "l1": L1Metric, "mean_absolute_error": L1Metric, "mae": L1Metric,
    "regression_l1": L1Metric,
    "l2": L2Metric, "mean_squared_error": L2Metric, "mse": L2Metric,
    "regression": L2Metric, "regression_l2": L2Metric,
    "rmse": RMSEMetric, "root_mean_squared_error": RMSEMetric,
    "l2_root": RMSEMetric,
    "quantile": QuantileMetric,
    "huber": HuberMetric,
    "fair": FairMetric,
    "poisson": PoissonMetric,
    "mape": MAPEMetric, "mean_absolute_percentage_error": MAPEMetric,
    "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric,
    "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "average_precision": AveragePrecisionMetric,
    "auc_mu": AucMuMetric,
    "multi_logloss": MultiLoglossMetric, "multiclass": MultiLoglossMetric,
    "softmax": MultiLoglossMetric, "multiclassova": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
    "cross_entropy": CrossEntropyMetric, "xentropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "xentlambda": CrossEntropyLambdaMetric,
    "kullback_leibler": KullbackLeiblerMetric, "kldiv": KullbackLeiblerMetric,
    "ndcg": NDCGMetric, "lambdarank": NDCGMetric, "rank_xendcg": NDCGMetric,
    "map": MapMetric, "mean_average_precision": MapMetric,
}

_DEFAULT_FOR_OBJECTIVE = {
    "regression": "l2", "regression_l1": "l1", "huber": "huber",
    "fair": "fair", "poisson": "poisson", "quantile": "quantile",
    "mape": "mape", "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary_logloss", "multiclass": "multi_logloss",
    "multiclassova": "multi_logloss", "cross_entropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "lambdarank": "ndcg",
    "rank_xendcg": "ndcg",
}


def create_metrics(config: Config, objective_name: str) -> List[Metric]:
    """Factory (reference: src/metric/metric.cpp:17). Empty metric config
    defaults to the objective's natural metric."""
    names = [m for m in config.metric
             if m not in ("", "null", "na", "none", "custom")]
    if not names:
        default = _DEFAULT_FOR_OBJECTIVE.get(objective_name)
        names = [default] if default else []
    out = []
    seen = set()
    for name in names:
        if name in seen:
            continue
        seen.add(name)
        if name not in _REGISTRY:
            Log.warning("Unknown metric: %s", name)
            continue
        out.append(_REGISTRY[name](config))
    return out
