"""Row and column samplers of the PyTorch port (``lightgbm_tpu_torch/
fused.py``) against the JAX package's ``fused.make_sampler``,
``make_balanced_sampler`` and ``make_feature_mask_fn`` on the CPU: the
in-bag masks, GOSS's amplification (warm-up iterations included) and the
per-tree feature masks are equal at every iteration drawn."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu import fused as jfused
from lightgbm_tpu.config import Config as JConfig

from lightgbm_tpu_torch import fused
from lightgbm_tpu_torch.config import Config

N = 3001
ITERS = [0, 1, 2, 3, 7, 20]

ROW_CASES = {
    "bagging": {"bagging_fraction": 0.7, "bagging_freq": 1},
    "bagging_freq3": {"bagging_fraction": 0.55, "bagging_freq": 3,
                      "bagging_seed": 17},
    "goss": {"data_sample_strategy": "goss", "learning_rate": 0.34},
    "goss_rates": {"data_sample_strategy": "goss", "learning_rate": 0.5,
                   "top_rate": 0.3, "other_rate": 0.25, "bagging_seed": 5},
}


def _cfgs(params):
    p = dict(params, verbosity=-1)
    return JConfig.from_params(p), Config.from_params(p)


def _grads(seed):
    rng = np.random.RandomState(seed)
    g = (np.round(rng.randn(N) * 64) / 64).astype(np.float32)
    h = (np.abs(np.round(rng.randn(N) * 64)) / 64 + 0.25).astype(np.float32)
    return g, h


@pytest.mark.parametrize("name", sorted(ROW_CASES))
@pytest.mark.parametrize("it", ITERS)
def test_row_sampler_equals_jax(name, it):
    jc, pc = _cfgs(ROW_CASES[name])
    js = jfused.make_sampler(jc, N)
    ps = fused.make_sampler(pc, N)
    g, h = _grads(it)
    ji, ja = js(None, it, jnp.asarray(g), jnp.asarray(h))
    pi, pa = ps(it, torch.as_tensor(g), torch.as_tensor(h))
    assert pi.dtype == pa.dtype == torch.float32
    assert np.array_equal(pi.numpy(), np.asarray(ji))
    assert np.array_equal(pa.numpy(), np.asarray(ja))
    if name.startswith("goss"):
        warm = it < int(1.0 / pc.learning_rate)
        assert (pi.numpy().min() == 1.0) == warm
        if not warm:     # the k-th largest |g h| is in; amplified rows > 1
            assert pa.numpy().max() > 1.0


def test_goss_threshold_ties():
    """Scores with many ties at the k-th largest value: is_top keeps every
    tie, as jax.lax.top_k's threshold does."""
    jc, pc = _cfgs(ROW_CASES["goss"])
    g = np.ones(N, np.float32)
    g[::3] = 2.0
    h = np.ones(N, np.float32)
    ji, ja = jfused.make_sampler(jc, N)(None, 9, jnp.asarray(g),
                                        jnp.asarray(h))
    pi, pa = fused.make_sampler(pc, N)(9, torch.as_tensor(g),
                                       torch.as_tensor(h))
    assert np.array_equal(pi.numpy(), np.asarray(ji))
    assert np.array_equal(pa.numpy(), np.asarray(ja))


@pytest.mark.parametrize("it", ITERS)
def test_balanced_sampler_equals_jax(it):
    params = {"bagging_freq": 2, "pos_bagging_fraction": 0.8,
              "neg_bagging_fraction": 0.3, "bagging_seed": 9}
    jc, pc = _cfgs(params)
    label = (np.random.RandomState(1).rand(N) < 0.3).astype(np.float32)
    ji, _ = jfused.make_balanced_sampler(jc, jnp.asarray(label))(
        None, it, None, None)
    pi, pa = fused.make_balanced_sampler(pc, torch.as_tensor(label))(
        it, None, None)
    assert np.array_equal(pi.numpy(), np.asarray(ji))
    assert float(pa.min()) == 1.0


@pytest.mark.parametrize("frac,nf", [(0.6, 28), (0.8, 28), (0.25, 7),
                                     (0.5, 1)])
def test_feature_mask_equals_jax(frac, nf):
    jc, pc = _cfgs({"feature_fraction": frac, "feature_fraction_seed": 4})
    jm = jfused.make_feature_mask_fn(jc, nf)
    pm = fused.make_feature_mask_fn(pc, nf)
    for it in ITERS:
        got = pm(it)
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), np.asarray(jm(it))), it
        assert int(got.sum()) == max(1, int(np.ceil(frac * nf)))


def test_samplers_off():
    _, pc = _cfgs({})
    assert fused.make_sampler(pc, N) is None
    assert fused.make_feature_mask_fn(pc, 10) is None
    _, pc = _cfgs({"data_sample_strategy": "goss", "top_rate": 0.5,
                   "other_rate": 0.5})
    assert fused.make_sampler(pc, N) is None
