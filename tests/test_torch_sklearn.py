"""The port's scikit-learn wrappers against the JAX package's on the CPU:
``LGBMRegressor``, ``LGBMClassifier`` (binary and three classes,
``predict_proba``, ``classes_``) and ``LGBMRanker`` grow the JAX
package's trees and predict its answers; the plots draw with matplotlib's
Agg backend, as tests/test_io_aux.py draws the JAX package's."""
import numpy as np
import pytest

from torch_port_cases import (RTOL, ATOL, assert_same_trees,
                              make_train_data, torch_threads)

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lgt

#: the estimators' settings in both packages (parity needs splits by real
#: gains, see torch_port_cases.train_params)
EST = dict(n_estimators=3, num_leaves=7, min_split_gain=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_module():
    with torch_threads(1):
        yield


def _fit_both(cls, X, y, **fit):
    j = getattr(lgb, cls)(**EST).fit(X, y, **fit)
    p = getattr(lgt, cls)(device_type="cpu", **EST).fit(X, y, **fit)
    assert_same_trees(j.booster_.inner.models, p.booster_.inner.models)
    return j, p


def test_regressor_equals_jax():
    rng = np.random.RandomState(21)
    X, y, _ = make_train_data(rng, 500, objective="regression")
    j, p = _fit_both("LGBMRegressor", X, y)
    np.testing.assert_allclose(p.predict(X[:50]), j.predict(X[:50]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(p.feature_importances_,
                                  j.feature_importances_)
    assert p.n_features_ == 8 and p.best_iteration_ == j.best_iteration_
    assert p.get_params()["min_split_gain"] == 1e-3
    assert p.get_params()["device_type"] == "cpu"


@pytest.mark.parametrize("classes", [2, 3])
def test_classifier_equals_jax(classes):
    rng = np.random.RandomState(22)
    objective = "binary" if classes == 2 else "multiclass"
    X, y, _ = make_train_data(rng, 500, objective=objective)
    labels = np.array(["no", "yes", "maybe"])[y.astype(int)]
    j, p = _fit_both("LGBMClassifier", X, labels,
                     eval_set=[(X[:100], labels[:100])])
    assert list(p.classes_) == list(j.classes_) and p.n_classes_ == classes
    np.testing.assert_array_equal(p.predict(X[:60]), j.predict(X[:60]))
    proba = p.predict_proba(X[:60])
    assert proba.shape == (60, classes)
    np.testing.assert_allclose(proba, j.predict_proba(X[:60]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=0, atol=1e-6)
    # the eval_set's history, recorded per iteration
    (name, hist), = p.evals_result_.items()
    assert name == "valid_0" and all(len(v) == 3 for v in hist.values())
    for m in hist:
        np.testing.assert_allclose(hist[m], j.evals_result_["valid_0"][m],
                                   rtol=0, atol=1e-6)


def test_ranker_equals_jax():
    rng = np.random.RandomState(23)
    X = np.round(rng.randn(300, 6) * 16) / 64
    y = np.clip(np.round(X[:, 0] * 2 + X[:, 1] + 1), 0, 3)
    group = [30] * 10
    j, p = _fit_both("LGBMRanker", X, y, group=group)
    np.testing.assert_allclose(p.predict(X[:40]), j.predict(X[:40]),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(lgt.LightGBMError, match="group"):
        lgt.LGBMRanker(device_type="cpu").fit(X, y)


def test_plotting_smoke():
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    rng = np.random.RandomState(24)
    X, y, _ = make_train_data(rng, 400)
    res = {}
    bst = lgt.train({"objective": "binary", "num_leaves": 7,
                     "verbosity": -1, "metric": ["auc"],
                     "device_type": "cpu"},
                    lgt.Dataset(X, label=y), num_boost_round=3,
                    valid_sets=[lgt.Dataset(X[:100], label=y[:100])],
                    callbacks=[lgt.record_evaluation(res)])
    assert lgt.plot_importance(bst) is not None
    assert lgt.plot_metric(res) is not None
    pytest.importorskip("graphviz")
    g = lgt.create_tree_digraph(bst, tree_index=1)
    assert "leaf" in g.source and "split0" in g.source
