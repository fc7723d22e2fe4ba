"""The port's objectives against the JAX package's, on the CPU.

For each objective beyond binary, L2 and softmax (L1, Huber, Fair, Quantile,
MAPE, Poisson, Gamma, Tweedie, multiclassova, cross_entropy,
cross_entropy_lambda), on the same seeded labels, weights and f32 scores:
- the gradients and hessians within GRAD_RTOL / GRAD_ATOL (the same f32
  operations in the same order; torch's exp and log may round an ulp away
  from XLA's);
- ``boost_from_score`` and ``renew_leaf_values`` (host numpy in both
  packages, ``_percentile_weighted`` with its boundary quirks included)
  equal;
- five boosting rounds from the JAX package's bins against its trees
  (``assert_same_trees`` at TRAIN_RTOL / TRAIN_ATOL); the L1, Quantile and
  MAPE rounds renew their leaves on the per-iteration path.

Every objective and metric name of the JAX registries creates in the port;
chip_smoke's phase 3g runs at a small size.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_cases import (CPU, assert_same_trees, grid,
                              one_torch_thread)

import lightgbm_tpu as lgb
from lightgbm_tpu import metric as jax_metric
from lightgbm_tpu import objective as jax_obj
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import Metadata as JMetadata

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import metric as port_metric
from lightgbm_tpu_torch import objective as port_obj
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.dataset import Metadata

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """The training tests here run the port on the host: one torch thread
    (torch_port_cases.one_torch_thread)."""


#: gradients port vs JAX: the same f32 ops; exp / log1p may differ by an
#: ulp between torch and XLA, which the following ops can grow a little
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6

OBJECTIVES = ("regression_l1", "huber", "fair", "quantile", "mape",
              "poisson", "gamma", "tweedie", "multiclassova",
              "cross_entropy", "cross_entropy_lambda")
#: dyadic alpha (Huber's transition point, the quantile): the constant
#: gradients -alpha and 1 - alpha then sum exactly in f32 in any order, so
#: training parity is decided by real gains, as with the 1/64 grid labels
PARAMS = {"huber": {"alpha": 0.75}, "quantile": {"alpha": 0.75},
          "multiclassova": {"num_class": 3}, "fair": {"fair_c": 0.5},
          "tweedie": {"tweedie_variance_power": 1.25}}


def labels(objective, z, rng):
    """Valid labels for ``objective`` from the signal ``z`` on a 1/64
    grid: positive for the log links, 3 classes for OVA, [0, 1] for the
    cross-entropies."""
    if objective in ("poisson", "tweedie"):
        y = np.round(np.exp(z) * 8) / 8 * (rng.rand(len(z)) > 0.2)
    elif objective == "gamma":
        y = np.round(np.exp(z) * 8 + 1) / 8
    elif objective == "multiclassova":
        y = np.digitize(z, [-0.3, 0.3]).astype(np.float64)
    elif objective.startswith("cross_entropy"):
        y = np.round(1 / (1 + np.exp(-2 * z)) * 64) / 64
    else:
        y = np.round(z * 64) / 64
    return y


def _pair(objective, y, w=None, extra=None):
    """(JAX objective, port objective) initialised on the same labels."""
    p = dict(PARAMS.get(objective, {}), objective=objective)
    p.update(extra or {})
    jo = jax_obj.create_objective(JConfig.from_params(p))
    jo.init(JMetadata(len(y), label=y, weight=w))
    po = port_obj.create_objective(Config.from_params(p))
    po.init(Metadata(len(y), label=y, weight=w))
    return jo, po


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_gradients_and_init_equal_jax(objective, weighted):
    rng = np.random.RandomState(OBJECTIVES.index(objective))
    n = 997
    z = rng.randn(n)
    y = labels(objective, z, rng)
    w = rng.uniform(0.25, 2.0, n) if weighted else None
    jo, po = _pair(objective, y, w)
    k = po.num_model_per_iteration
    shape = (n, k) if k > 1 else (n,)
    s = (rng.randn(*shape) * 1.5).astype(np.float32)
    gj, hj = jo.get_gradients(jnp.asarray(s))
    gp, hp = po.get_gradients(torch.as_tensor(s))
    np.testing.assert_allclose(gp.numpy(), np.asarray(gj), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL, err_msg="grad")
    np.testing.assert_allclose(hp.numpy(), np.asarray(hj), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL, err_msg="hess")
    assert gp.dtype == hp.dtype == torch.float32
    for c in range(k):
        assert po.boost_from_score(c) == jo.boost_from_score(c)
    assert po.need_renew == jo.need_renew
    assert po.is_ranking == jo.is_ranking and po.needs_iter == jo.needs_iter


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("objective", ["regression_l1", "quantile", "mape"])
def test_renew_leaf_values_equal_jax(objective, weighted):
    rng = np.random.RandomState(11)
    n = 1500
    y = labels(objective, rng.randn(n), rng)
    w = rng.uniform(0.25, 2.0, n) if weighted else None
    jo, po = _pair(objective, y, w, {"alpha": 0.3})
    leaf = rng.randint(0, 9, n).astype(np.int32)
    leaf[leaf == 4] = 5                     # a leaf without rows
    before = (rng.randn(n) * 0.5).astype(np.float32)
    want = jo.renew_leaf_values(leaf, 9, before)
    got = po.renew_leaf_values(leaf, 9, before)
    np.testing.assert_array_equal(got, want)
    assert got[4] == 0.0


@pytest.mark.parametrize("alpha", [0.0, 0.1, 0.5, 0.9, 1.0])
def test_percentile_weighted_equals_jax(alpha):
    """The reference's percentile with its boundary quirks: empty, one
    value, positions at and past the ends, weighted steps under 1."""
    rng = np.random.RandomState(2)
    for n in (0, 1, 2, 3, 10, 101):
        v = np.round(rng.randn(n) * 8) / 8
        for w in (None, rng.uniform(0.1, 3.0, n), np.full(n, 0.5)):
            assert port_obj._percentile_weighted(v, w, alpha) == \
                jax_obj._percentile_weighted(v, w, alpha)


def test_every_objective_and_metric_creates():
    """The port's registries are the JAX package's: every objective
    creates, every metric name creates (none refused), and each
    objective's default metric is the same."""
    assert set(port_obj._REGISTRY) == set(jax_obj._REGISTRY)
    for name in jax_obj._REGISTRY:
        cfg = Config.from_params({"objective": name, "num_class": 3})
        assert port_obj.create_objective(cfg).name == name
    assert set(port_metric._REGISTRY) == set(jax_metric._REGISTRY)
    assert port_metric._DEFAULT_FOR_OBJECTIVE == \
        jax_metric._DEFAULT_FOR_OBJECTIVE
    cfg = Config.from_params({"metric": sorted(port_metric._REGISTRY)})
    got = port_metric.create_metrics(cfg, "regression")
    want = jax_metric.create_metrics(
        JConfig.from_params({"metric": sorted(jax_metric._REGISTRY)}),
        "regression")
    assert [type(m).__name__ for m in got] == \
        [type(m).__name__ for m in want]
    for objective in jax_metric._DEFAULT_FOR_OBJECTIVE:
        got = port_metric.create_metrics(Config(), objective)
        assert [m.name for m in got] == [
            m.name for m in jax_metric.create_metrics(JConfig(), objective)]


# -------------------------------------------------------------- training

@pytest.mark.parametrize("objective", OBJECTIVES)
def test_training_equals_jax(objective, tmp_path):
    rng = np.random.RandomState(3)
    n, f = 1000, 8
    X = grid(rng, n, f)
    w = np.array([1.0, -0.8, 0.6, -0.45, 0.3, -0.2, 0.12, 0.07])
    z = X @ w + 0.5 * grid(rng, n, 1)[:, 0]
    y = labels(objective, z, rng)
    p = dict(objective=objective, verbosity=-1, num_leaves=15,
             min_gain_to_split=1e-3, **PARAMS.get(objective, {}))
    ds = lgb.Dataset(X, label=y)
    ds.construct(p)
    path = str(tmp_path / "train.npz")
    ds.save_binary(path)
    jb = lgb.train(dict(p), ds, 5)
    pb = lgt.train(dict(p, **CPU), lgt.dataset_from_reference(path, CPU), 5)
    renew = pb.inner.objective.need_renew
    assert (getattr(pb.inner, "_fused", None) is None) == renew
    np.testing.assert_array_equal(pb.inner.init_scores, jb.inner.init_scores)
    assert_same_trees(jb.inner.models, pb.inner.models)
    np.testing.assert_allclose(pb.predict(X[:200]), jb.predict(X[:200]),
                               rtol=1e-4, atol=1e-5)


def test_objectives_phase_small_on_cpu():
    """chip_smoke's phase 3g at a small size (card and host both the
    host here)."""
    data = chip_smoke.training_data(0, 3000, 0)
    out = chip_smoke.phase_objectives(torch.device("cpu"), data, "cpu",
                                      rows=3000, trees=2, leaves=7)
    assert set(out) == set(chip_smoke.OBJECTIVES)
    assert all(r["card"] == r["host"] for r in out.values())
    assert [o for o, r in out.items() if not r["fused"]] == [
        "regression_l1", "quantile", "mape"]
