"""DART and random-forest training of the PyTorch port
(``lightgbm_tpu_torch``) on the CPU, against the JAX package.

The bars:
- (a) DART (default, ``uniform_drop``, ``xgboost_dart_mode``,
  ``skip_drop=0``) and RF (binary and multiclass) with a valid set, the
  same numpy inputs through both packages: the same trees (leaf values
  within TRAIN_RTOL / TRAIN_ATOL), training and valid scores and metrics,
  and predictions before and after a model-string round trip;
- (b) RF's gradients stay at the init scores (the port's score updates
  are in place, so RF keeps a copy of the init scores, not the tracker's
  tensor);
- (c) both run on the per-iteration path (no fused block), and DART's
  drop schedule is the JAX package's draw for draw.

The parity cases set ``min_gain_to_split=1e-3`` (torch_port_cases).
"""
import numpy as np
import pytest
import torch

from torch_port_cases import (CPU, TRAIN_ATOL, TRAIN_RTOL, assert_same_trees,
                              jax_dataset, one_torch_thread, train_params)

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lgt


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """Training-heavy: one torch thread (torch_port_cases)."""


CASES = {
    "dart": ("binary", {"boosting": "dart", "drop_rate": 0.3}),
    "dart_uniform": ("binary", {"boosting": "dart", "drop_rate": 0.3,
                                "uniform_drop": True}),
    "dart_xgboost": ("binary", {"boosting": "dart", "drop_rate": 0.3,
                                "xgboost_dart_mode": True,
                                "learning_rate": 0.2}),
    "dart_skip0": ("regression", {"boosting": "dart", "drop_rate": 0.2,
                                  "skip_drop": 0.0, "max_drop": 2}),
    "rf_binary": ("binary", {"boosting": "rf", "bagging_fraction": 0.7,
                             "bagging_freq": 1, "feature_fraction": 0.8}),
    "rf_multiclass": ("multiclass", {"boosting": "rf",
                                     "bagging_fraction": 0.6,
                                     "bagging_freq": 1}),
}


def _train_both(tmp_path, name, rounds=6):
    """(jax booster, port booster, X, valid X) after ``rounds`` iterations
    with a valid set."""
    case, extra = CASES[name]
    ds, path, X, _, (Xv, yv) = jax_dataset(case, tmp_path, n=1200, seed=6,
                                           valid_rows=300)
    params = dict(train_params(case), **extra)
    jb = lgb.train(dict(params), ds, rounds,
                   valid_sets=[lgb.Dataset(Xv, label=yv, reference=ds)])
    ptr = lgt.dataset_from_reference(path, CPU)
    pb = lgt.train(dict(params, **CPU), ptr, rounds,
                   valid_sets=[lgt.Dataset(Xv, label=yv, reference=ptr)])
    return jb, pb, X, Xv


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(tmp_path, name):
    jb, pb, X, Xv = _train_both(tmp_path, name)
    assert pb.inner.name == jb.inner.name
    assert getattr(pb.inner, "_fused", None) is None
    assert_same_trees(jb.inner.models, pb.inner.models)
    assert sum(t.num_leaves > 1 for t in pb.inner.models) > 3
    np.testing.assert_allclose(pb.inner.train_score.np(),
                               np.asarray(jb.inner.train_score.score),
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    np.testing.assert_allclose(pb.inner.valid_sets[0][2].np(),
                               np.asarray(jb.inner.valid_sets[0][2].score),
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    for (_, ja, va, _), (_, pa, vb, _) in zip(
            jb.eval_train() + jb.eval_valid(),
            pb.eval_train() + pb.eval_valid()):
        assert ja == pa
        assert vb == pytest.approx(va, rel=1e-4, abs=1e-6)
    for Z in (X, Xv):
        want = jb.predict(Z, raw_score=True)
        np.testing.assert_allclose(pb.predict(Z, raw_score=True), want,
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
        back = lgt.Booster(model_str=pb.model_to_string(), params=CPU)
        np.testing.assert_allclose(back.predict(Z, raw_score=True), want,
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL)


def test_dart_drop_schedule_matches_jax(tmp_path):
    """The drop sets of the port's DART are the JAX package's, draw for
    draw (the seeded numpy streams); with skip_drop=0 iterations drop."""
    from lightgbm_tpu.boosting import DART as JDART
    from lightgbm_tpu.config import Config as JConfig

    from lightgbm_tpu_torch.boosting import DART
    from lightgbm_tpu_torch.config import Config

    for extra in ({"drop_rate": 0.3}, {"drop_rate": 0.3, "uniform_drop": True},
                  {"drop_rate": 0.5, "skip_drop": 0.0, "max_drop": 3}):
        params = dict(extra, boosting="dart", drop_seed=11)
        jd = JDART(JConfig.from_params(dict(params)), None)
        pd = DART(Config.from_params(dict(params, **CPU)), None)
        dropped = 0
        for it in range(12):
            pd.iter_ = it
            jd.iter_ = it
            got = pd._drop_set()
            # the JAX package draws its set inline in train_one_iter
            cfg, rng = jd.config, jd._drop_rng
            want = []
            if rng.rand() >= cfg.skip_drop and it > 0:
                if cfg.uniform_drop:
                    want = list(np.flatnonzero(rng.rand(it) < cfg.drop_rate))
                else:
                    k = min(cfg.max_drop, np.random.RandomState(
                        cfg.drop_seed + it).binomial(it, min(1.0,
                                                             cfg.drop_rate)))
                    if k > 0:
                        want = list(rng.choice(it, size=k, replace=False))
            assert got == [int(w) for w in want], (extra, it)
            dropped += len(got)
        assert dropped > 0


@pytest.mark.parametrize("name", ["rf_binary", "rf_multiclass"])
def test_rf_gradients_stay_at_init_scores(tmp_path, name):
    """RF computes every iteration's gradients at the constant init score:
    those of iteration 3 equal those of iteration 0, although the
    training scores (the running average, updated in place column by
    column with several classes) have moved."""
    case, extra = CASES[name]
    ds, path, _, _, _ = jax_dataset(case, tmp_path, n=600, seed=3)
    params = dict(train_params(case), **extra, **CPU)
    bst = lgt.Booster(params, lgt.dataset_from_reference(path, CPU))
    g = bst.inner
    seen = []
    orig = g.objective.get_gradients

    def spy(score, *rest):
        seen.append(score.clone())
        return orig(score, *rest)

    g.objective.get_gradients = spy
    before = g.train_score.score.clone()
    for _ in range(4):
        bst.update()
    assert len(seen) == 4
    assert torch.equal(seen[3], seen[0])
    assert torch.equal(seen[0], before)
    assert not torch.equal(g.train_score.score, before)
    grads = [orig(s)[0] for s in (seen[0], seen[3])]
    assert torch.equal(grads[0], grads[1])
