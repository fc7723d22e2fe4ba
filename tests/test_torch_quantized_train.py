"""Training slice 3 of the PyTorch port against the JAX package, on the
CPU: int8 quantized gradients, bagging, balanced bagging, GOSS,
``feature_fraction`` and the rows work layout, five iterations each from
the JAX package's own bins (``dataset_from_reference``).

Every case must grow the same trees (``torch_port_cases.assert_same_trees``:
equal structure, leaf values within TRAIN_RTOL / TRAIN_ATOL) and predict
within the same tolerance. The samplers' masks and the quantization dither
are threefry draws, equal bit for bit in both packages (test_torch_prng.py,
test_torch_sampling.py); the int8 histograms are integer sums, equal byte
for byte (test_torch_rows.py).

One tolerance is wider, with its reason: quantized multiclass leaf values
within QUANT_SOFTMAX_ATOL. The softmax gradients differ by an ulp between
XLA's exp and torch's, and stochastic rounding turns an ulp on a row that
sits on a rounding edge into a whole quantum (max |g| / 127) of its leaf's
gradient sum: at learning rate 0.1 and these leaves' hessian sums, ~6e-5
of leaf value per flipped row. The trees' structure stays equal.
"""
import numpy as np
import pytest

from torch_port_cases import (CPU, TRAIN_ATOL, TRAIN_RTOL, assert_same_trees,
                              jax_dataset, train_params)

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.obs import telemetry

QUANT = {"use_quantized_grad": True}
#: one or two flipped quanta per leaf (module docstring)
QUANT_SOFTMAX_ATOL = 2e-4
BAG = {"bagging_fraction": 0.7, "bagging_freq": 1}

CASES = {
    "quantized_binary": ("binary", QUANT),
    "quantized_regression": ("regression", QUANT),
    "quantized_multiclass": ("multiclass", QUANT),
    "int8_precision_knob": ("binary", {"tpu_hist_precision": "int8"}),
    "bagging": ("binary", BAG),
    "balanced_bagging": ("binary", {"bagging_freq": 2,
                                    "pos_bagging_fraction": 0.8,
                                    "neg_bagging_fraction": 0.5}),
    "goss": ("binary", {"data_sample_strategy": "goss",
                        "learning_rate": 0.5}),
    "goss_multiclass": ("multiclass", {"data_sample_strategy": "goss",
                                       "learning_rate": 0.5}),
    "feature_fraction": ("binary", {"feature_fraction": 0.6}),
    "rows": ("binary", {"tpu_work_layout": "rows"}),
    "rows_hist_mxu": ("regression", {"tpu_hist_mxu": "on"}),
    "quantized_sampled": ("binary", dict(QUANT, feature_fraction=0.8,
                                         **BAG)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_five_iterations_equal_jax(tmp_path, name):
    case, extra = CASES[name]
    ds, path, X, _, _ = jax_dataset(case, tmp_path, n=1200)
    params = dict(train_params(case), **extra)
    jb = lgb.Booster(params, ds)
    for _ in range(5):
        jb.update()
    telemetry.reset()
    pb = lgt.train(dict(params, **CPU), lgt.dataset_from_reference(path, CPU),
                   5)
    layout = {r["knob"]: r["value"]
              for r in telemetry.records("auto_resolution")}
    want = "rows" if ("tpu_work_layout" in extra or "tpu_hist_mxu" in extra
                      or extra.get("use_quantized_grad")
                      or extra.get("tpu_hist_precision") == "int8") \
        else "planes"
    assert pb.inner.learner._kw["work_layout"] == want
    if "tpu_work_layout" not in extra:
        assert layout["tpu_work_layout"] == want
    assert pb.current_iteration == 5
    # quantized multiclass: a leaf tolerance per tree, summed over 5 trees
    atol, score_atol = (QUANT_SOFTMAX_ATOL, 5 * QUANT_SOFTMAX_ATOL) \
        if name == "quantized_multiclass" else (TRAIN_ATOL, TRAIN_ATOL)
    assert_same_trees(jb.inner.models, pb.inner.models, atol=atol)
    np.testing.assert_allclose(pb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True),
                               rtol=TRAIN_RTOL, atol=score_atol)
    np.testing.assert_allclose(pb.inner.train_score.np(),
                               np.asarray(jb.inner.train_score.score),
                               rtol=TRAIN_RTOL, atol=score_atol)


def test_inbag_counts_reach_the_histograms(tmp_path):
    """With bagging, a leaf's segment holds all its rows and its int8
    count channel only the in-bag ones (the invariants chip_smoke.py checks
    on the card)."""
    import torch

    _, path, _, _, _ = jax_dataset("binary", tmp_path, n=900, seed=3)
    params = dict(train_params("binary"), **CPU, **QUANT, **BAG)
    bst = lgt.Booster(params, lgt.dataset_from_reference(path, CPU))
    bst.update()
    g = bst.inner
    st = g.learner.last_stats
    ns = st["num_splits"]
    cnt = st["leaf_cnt"][:ns + 1].long()
    leaf = st["row_leaf"].long()
    assert int(cnt.sum()) == 900 and ns > 0
    assert torch.equal(cnt, torch.bincount(leaf, minlength=ns + 1))
    inbag = torch.bincount(leaf, weights=g._inbag.double(),
                           minlength=ns + 1)
    assert torch.equal(st["hist_cnt"][:ns + 1].double(), inbag)
    assert 0 < float(g._inbag.sum()) < 900
