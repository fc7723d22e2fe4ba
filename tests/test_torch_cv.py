"""The port's ``cv`` against the JAX package's on the CPU: stratified,
shuffled, grouped (lambdarank) and ``return_cvbooster`` folds. The fold
row sets are equal, each fold grows the JAX package's trees and the
metric histories (``valid <metric>-mean`` / ``-stdv``) agree within
1e-6."""
import numpy as np
import pytest

from torch_port_cases import (CPU, assert_same_trees, make_train_data,
                              torch_threads, train_params)

import lightgbm_tpu as lgb
from lightgbm_tpu.engine import _make_n_folds as jax_folds

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.engine import _make_n_folds as port_folds

#: metric histories, port vs JAX (leaf values differ by an ulp of exp)
CV_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread_module():
    with torch_threads(1):
        yield


def _rank_data(rng, n_query=12, per=25):
    X = np.round(rng.randn(n_query * per, 6) * 16) / 64
    y = np.clip(np.round(X[:, 0] * 2 + X[:, 1] + 1), 0, 3)
    return X, y, [per] * n_query


CASES = {
    # name: (params, cv keywords)
    # metrics= replaces the params' metric
    "stratified": (dict(train_params("binary", leaves=7), metric=["l2"]),
                   dict(stratified=True, shuffle=True,
                        metrics=["auc", "binary_logloss"])),
    "shuffled": (dict(train_params("regression", leaves=7), metric=["l2"]),
                 dict(stratified=False, shuffle=True, seed=3)),
    "grouped": ({"objective": "lambdarank", "num_leaves": 7,
                 "verbosity": -1, "min_data_in_leaf": 5,
                 "min_gain_to_split": 1e-3, "metric": ["ndcg"],
                 "eval_at": [5]},
                dict(stratified=False, shuffle=True)),
}


def _case_data(name):
    rng = np.random.RandomState(11)
    if name == "grouped":
        return _rank_data(rng)
    objective = CASES[name][0]["objective"]
    X, y, _ = make_train_data(rng, 450, objective=objective)
    return X, y, None


@pytest.mark.parametrize("name", sorted(CASES))
def test_cv_equals_jax(name):
    params, kw = CASES[name]
    X, y, group = _case_data(name)
    folds = {}
    for pkg, fn, extra in (("jax", jax_folds, {}), ("port", port_folds, CPU)):
        mod = lgb if pkg == "jax" else lgt
        ds = mod.Dataset(X, label=y, group=group)
        folds[pkg] = list(fn(ds, 3, dict(params, **extra), kw.get("seed", 0),
                             kw["stratified"], kw["shuffle"]))
    for (tj, vj), (tp, vp) in zip(folds["jax"], folds["port"]):
        np.testing.assert_array_equal(tp, tj)
        np.testing.assert_array_equal(vp, vj)
    res_j = lgb.cv(dict(params), lgb.Dataset(X, label=y, group=group), 3,
                   nfold=3, return_cvbooster=True, **kw)
    res_p = lgt.cv(dict(params, **CPU), lgt.Dataset(X, label=y, group=group),
                   3, nfold=3, return_cvbooster=True, **kw)
    keys = sorted(k for k in res_j if k != "cvbooster")
    assert keys == sorted(k for k in res_p if k != "cvbooster") and keys
    if "metrics" in kw:
        assert keys == ["valid auc-mean", "valid auc-stdv",
                        "valid binary_logloss-mean",
                        "valid binary_logloss-stdv"]
    for k in keys:
        assert len(res_p[k]) == 3
        np.testing.assert_allclose(res_p[k], res_j[k], rtol=0, atol=CV_TOL,
                                   err_msg=k)
    cj, cp = res_j["cvbooster"], res_p["cvbooster"]
    assert len(cp.boosters) == 3 and cp.best_iteration == cj.best_iteration
    for bj, bp in zip(cj.boosters, cp.boosters):
        assert bp.inner.device.type == "cpu"
        assert_same_trees(bj.inner.models, bp.inner.models)
    # CVBooster forwards a call to every fold booster
    Xq = X[:20]
    for a, b in zip(cj.predict(Xq), cp.predict(Xq)):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
