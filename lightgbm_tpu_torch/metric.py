"""Evaluation metrics (PyTorch port of ``lightgbm_tpu/metric.py``).

Metrics run in host numpy over *converted* predictions (the objective's
``convert_output`` already applied on the device), as in the JAX package:
evaluation is off the training hot path. Ported: ``l2``, ``rmse``,
``binary_logloss``, ``binary_error``, ``auc`` and ``multi_logloss`` with
their aliases; asking for another metric raises (ROADMAP A10).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from .config import Config
from .utils.log import LightGBMError


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
    """ROC AUC via the weighted rank statistic, ties at average rank
    (reference: binary_metric.hpp AUCMetric)."""
    name = "auc"
    greater_is_better = True

    def eval(self, pred, label, weight, query_boundaries=None):
        p = pred.ravel()
        y = (label > 0).astype(np.float64)
        w = np.ones_like(y) if weight is None else weight.astype(np.float64)
        order = np.argsort(p, kind="mergesort")
        p, y, w = p[order], y[order], w[order]
        pos_w, neg_w = w * y, w * (1 - y)
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


class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def eval(self, pred, label, weight, query_boundaries=None):
        K = self.config.num_class
        pred = pred.reshape(-1, K)
        lab = label.astype(np.int64)
        p = np.clip(pred[np.arange(len(lab)), lab], 1e-15, 1.0)
        return [(self.name, _avg(-np.log(p), weight))]


_REGISTRY: Dict[str, Callable] = {
    "l2": L2Metric, "mean_squared_error": L2Metric, "mse": L2Metric,
    "regression": L2Metric, "regression_l2": L2Metric,
    "rmse": RMSEMetric, "root_mean_squared_error": RMSEMetric,
    "l2_root": RMSEMetric,
    "binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "multi_logloss": MultiLoglossMetric, "multiclass": MultiLoglossMetric,
    "softmax": MultiLoglossMetric,
}

_DEFAULT_FOR_OBJECTIVE = {
    "regression": "l2", "binary": "binary_logloss",
    "multiclass": "multi_logloss",
}


def create_metrics(config: Config, objective_name: str) -> List[Metric]:
    """Factory (reference: src/metric/metric.cpp:17). An empty metric
    config defaults to the objective's natural metric."""
    names = [m for m in config.metric
             if m not in ("", "null", "na", "none", "custom")]
    if not names:
        default = _DEFAULT_FOR_OBJECTIVE.get(objective_name)
        names = [default] if default else []
    out, seen = [], set()
    for name in names:
        if name in seen:
            continue
        seen.add(name)
        if name not in _REGISTRY:
            raise LightGBMError("metric %s is not ported to the PyTorch/CUDA "
                                "package yet (ROADMAP A10)" % name)
        out.append(_REGISTRY[name](config))
    return out
