"""The port's metrics against the JAX package's, on the CPU.

Both packages evaluate in host numpy over converted predictions, so each
of the metric classes of JAX ``metric.py`` gives the same value on the
same numpy arrays: within METRIC_TOL (1e-12, relative), with and without
weights, ``ndcg@k`` and ``map@k`` over query boundaries included.
"""
import numpy as np
import pytest

from lightgbm_tpu import metric as jax_metric
from lightgbm_tpu.config import Config as JConfig

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import metric as port_metric
from lightgbm_tpu_torch.config import Config

METRIC_TOL = 1e-12

#: every metric class, by one of its registry names, and the kind of
#: (prediction, label) it evaluates
METRICS = {
    "l1": "regression", "l2": "regression", "rmse": "regression",
    "quantile": "regression", "huber": "regression", "fair": "regression",
    "poisson": "positive", "mape": "regression", "gamma": "positive",
    "gamma_deviance": "positive", "tweedie": "positive",
    "binary_logloss": "binary", "binary_error": "binary", "auc": "binary",
    "average_precision": "binary", "auc_mu": "multiclass",
    "multi_logloss": "multiclass", "multi_error": "multiclass",
    "cross_entropy": "probability", "cross_entropy_lambda": "probability",
    "kullback_leibler": "probability", "ndcg": "ranking", "map": "ranking",
}
PARAMS = {"num_class": 3, "alpha": 0.7, "fair_c": 0.8,
          "tweedie_variance_power": 1.3, "eval_at": [1, 3, 10],
          "multi_error_top_k": 2}


def inputs(kind, rng, n=600):
    """(pred, label, query boundaries or None) of one kind."""
    qb = None
    if kind == "regression":
        pred, y = rng.randn(n), np.round(rng.randn(n) * 8) / 8
    elif kind == "positive":
        pred, y = np.exp(rng.randn(n)), np.exp(rng.randn(n)) + 0.1
    elif kind == "binary":
        pred = np.round(rng.rand(n) * 20) / 20          # tied scores
        y = (rng.rand(n) < pred).astype(np.float64)
    elif kind == "multiclass":
        p = rng.rand(n, 3)
        pred, y = p / p.sum(axis=1, keepdims=True), rng.randint(0, 3, n)
        y = y.astype(np.float64)
    elif kind == "probability":
        pred, y = rng.rand(n), rng.rand(n)
        y[:20] = 0.0
        y[20:40] = 1.0
    else:
        sizes = np.array([1, 12, 40, 3, 100, 7, 60])
        sizes = np.concatenate([sizes, [n - sizes.sum()]])
        qb = np.concatenate([[0], np.cumsum(sizes)])
        pred = np.round(rng.randn(n) * 4) / 4
        y = rng.randint(0, 5, n).astype(np.float64)
        y[qb[3]:qb[4]] = 0.0                       # a query of no relevance
    return pred, y, qb


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_equals_jax(name, weighted):
    rng = np.random.RandomState(sorted(METRICS).index(name))
    pred, y, qb = inputs(METRICS[name], rng)
    w = rng.uniform(0.2, 3.0, len(y)) if weighted else None
    params = dict(PARAMS, metric=[name])
    jm = jax_metric.create_metrics(JConfig.from_params(params), "custom")
    pm = port_metric.create_metrics(Config.from_params(params), "custom")
    assert len(jm) == len(pm) == 1
    assert type(pm[0]).__name__ == type(jm[0]).__name__
    assert pm[0].greater_is_better == jm[0].greater_is_better
    want = jm[0].eval(pred, y, w, qb)
    got = pm[0].eval(pred, y, w, qb)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert np.isfinite(a)
        assert abs(a - b) <= METRIC_TOL * max(1.0, abs(b)), (name, a, b)


def test_auc_mu_weights_and_unknown_names():
    """auc_mu with a misclassification-cost matrix equals JAX's, a matrix
    of the wrong size raises, and an unknown metric name warns and is
    skipped (as in the JAX package)."""
    rng = np.random.RandomState(0)
    pred, y, _ = inputs("multiclass", rng)
    wm = [0, 1, 2, 1, 0, 1, 3, 1, 0]
    params = {"num_class": 3, "metric": ["auc_mu"], "auc_mu_weights": wm}
    a = port_metric.create_metrics(Config.from_params(params), "x")[0]
    b = jax_metric.create_metrics(JConfig.from_params(params), "x")[0]
    assert a.eval(pred, y, None) == b.eval(pred, y, None)
    bad = port_metric.create_metrics(Config.from_params(
        dict(params, auc_mu_weights=[1, 2])), "x")[0]
    with pytest.raises(lgt.LightGBMError, match="auc_mu_weights"):
        bad.eval(pred, y, None)
    got = port_metric.create_metrics(Config.from_params(
        {"metric": ["no_such_metric", "l1"]}), "x")
    assert [m.name for m in got] == ["l1"]


@pytest.mark.parametrize("name", ["ndcg", "map"])
def test_ranking_metrics_need_queries(name):
    m = port_metric.create_metrics(Config.from_params({"metric": [name]}),
                                   "x")[0]
    with pytest.raises(lgt.LightGBMError, match="query"):
        m.eval(np.zeros(4), np.zeros(4), None, None)
