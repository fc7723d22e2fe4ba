"""Split scan of the PyTorch port (``lightgbm_tpu_torch/ops/split.py``)
against the JAX package's ``find_best_split``, on the CPU.

Histograms come from seeded rows whose g and h sit on a 1/64 grid, so
every bin sum and prefix sum is exact in both packages and the scans see
the same numbers. The winner (feature, bin, kind, default_left, routing
table) must be equal; gains, child sums and outputs agree within rtol
1e-5 (f32 gain arithmetic in another op order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import split as JS

from lightgbm_tpu_torch.ops import split as PS
from lightgbm_tpu_torch.ops.histogram import build_histogram_np

F, B = 6, 32


def _case(seed, missing=None, cat=None):
    """(hist (F, B, 3), parent sum (3,), meta kwargs) from seeded rows."""
    rng = np.random.RandomState(seed)
    n = 3000
    nb = rng.randint(B // 2, B + 1, F)
    if cat == "onehot":
        nb[2] = 4
    bins = np.stack([rng.randint(0, nb[f], n) for f in range(F)], axis=1)
    g = np.round(rng.randn(n) * 16) / 64 + 0.3 * (bins[:, 1] > nb[1] // 2)
    g = np.round(g * 64) / 64
    if cat is not None:
        g = g + np.isin(bins[:, 2], (1, 3)) * 0.5
    h = (np.round(np.abs(rng.randn(n)) * 16) + 6) / 64
    ghc = np.stack([g, h, np.ones(n)], axis=1)
    hist = build_histogram_np(bins, ghc, B)
    meta = dict(num_bins=nb, movable_missing=np.zeros(F, bool),
                missing_bin=np.zeros(F, np.int32),
                is_categorical=np.zeros(F, bool),
                monotone=np.zeros(F, np.int8), penalty=np.ones(F, np.float32),
                cegb_coupled=np.zeros(F, np.float32))
    if missing == "nan":
        meta["movable_missing"][[0, 3]] = True
        meta["missing_bin"][[0, 3]] = nb[[0, 3]] - 1
    elif missing == "zero":
        meta["movable_missing"][[1, 4]] = True
        meta["missing_bin"][[1, 4]] = 2
    if cat is not None:
        meta["is_categorical"][2] = True
    return hist, ghc.sum(axis=0).astype(np.float32), meta


def _both(hist, psum, meta, hp_kw, **kw):
    jmeta = JS.FeatureMeta(**{k: jnp.asarray(v) for k, v in meta.items()})
    pmeta = PS.FeatureMeta(**{k: torch.as_tensor(v) for k, v in meta.items()})
    jhp = JS.SplitHyper(**hp_kw)
    php = PS.SplitHyper(**hp_kw)
    mask = np.ones(F, bool)
    mask[5] = False                       # a masked-out feature
    a = JS.find_best_split(jnp.asarray(hist), jnp.asarray(psum), jmeta,
                           jnp.asarray(mask), jhp,
                           **{k: jnp.float32(v) for k, v in kw.items()})
    b = PS.find_best_split(torch.as_tensor(hist), torch.as_tensor(psum),
                           pmeta, torch.as_tensor(mask), php, **kw)
    return a, b


def _check(a, b):
    assert float(a.gain) > 0
    for fld in ("feature", "bin", "kind", "default_left", "go_left"):
        np.testing.assert_array_equal(np.asarray(getattr(a, fld)),
                                      getattr(b, fld).numpy(), err_msg=fld)
    for fld in ("gain", "left_sum", "right_sum", "left_output",
                "right_output"):
        np.testing.assert_allclose(getattr(b, fld).numpy(),
                                   np.asarray(getattr(a, fld)), rtol=1e-5,
                                   atol=1e-6, err_msg=fld)


HP = [
    {},
    {"min_data_in_leaf": 300.0},
    {"min_sum_hessian_in_leaf": 40.0},
    {"lambda_l1": 2.0},
    {"lambda_l2": 5.0},
    {"max_delta_step": 0.05},
    {"path_smooth": 20.0},
    {"min_gain_to_split": 1.0},
]


@pytest.mark.parametrize("missing,hp", [(None, hp) for hp in HP]
                         + [("nan", {}), ("zero", {}),
                            ("nan", {"lambda_l1": 2.0, "path_smooth": 20.0})],
                         ids=lambda v: ",".join(v) if isinstance(v, dict)
                         else str(v))
def test_numerical_split_equals_jax(missing, hp):
    hist, psum, meta = _case(11, missing=missing)
    a, b = _both(hist, psum, meta, dict(hp, min_data_in_leaf=hp.get(
        "min_data_in_leaf", 20.0)), parent_output=0.01)
    _check(a, b)


@pytest.mark.parametrize("cat", ["onehot", "many_vs_many"])
@pytest.mark.parametrize("hp", [{}, {"cat_smooth": 1.0, "cat_l2": 1.0},
                                {"max_cat_threshold": 1}],
                         ids=["default", "smooth", "threshold"])
def test_categorical_split_equals_jax(cat, hp):
    hist, psum, meta = _case(12, cat=cat)
    kw = dict(hp, has_categorical=True, min_data_per_group=10.0)
    hist = hist.copy()
    hist[[0, 1, 3, 4]] = 0.0               # only the categorical feature
    hist[[0, 1, 3, 4], 0, :] = psum        # its whole mass in one bin
    a, b = _both(hist, psum, meta, kw)
    _check(a, b)
    assert int(b.kind) == (1 if cat == "onehot" else int(a.kind))
    if cat == "many_vs_many":
        assert int(b.kind) in (2, 3)


def test_monotone_basic_clamps_like_jax():
    hist, psum, meta = _case(13)
    meta["monotone"][1] = -1     # the direction of the signal
    meta["monotone"][3] = 1
    a, b = _both(hist, psum, meta, {"has_monotone": True},
                 leaf_lower=-0.5, leaf_upper=0.02)
    _check(a, b)


def test_batched_scan_equals_unbatched():
    hists, sums = [], []
    for seed in (21, 22):
        h, s, meta = _case(seed, missing="nan")
        hists.append(h)
        sums.append(s)
    pmeta = PS.FeatureMeta(**{k: torch.as_tensor(v) for k, v in meta.items()})
    hp = PS.SplitHyper()
    mask = torch.ones(F, dtype=torch.bool)
    both = PS.find_best_split(torch.as_tensor(np.stack(hists)),
                              torch.as_tensor(np.stack(sums)), pmeta, mask, hp,
                              parent_output=torch.tensor([0.1, -0.2]))
    for i in range(2):
        one = PS.find_best_split(torch.as_tensor(hists[i]),
                                 torch.as_tensor(sums[i]), pmeta, mask, hp,
                                 parent_output=[0.1, -0.2][i])
        for fld, x in zip(PS.SplitInfo._fields, one):
            assert torch.equal(getattr(both, fld)[i], x), fld


def test_no_valid_split_gives_minus_inf():
    hist, psum, meta = _case(14)
    a, b = _both(hist, psum, meta, {"min_data_in_leaf": 1e9})
    assert float(a.gain) == float(b.gain) == float("-inf")
    assert int(a.feature) == int(b.feature) == 0 and int(b.bin) == 0
