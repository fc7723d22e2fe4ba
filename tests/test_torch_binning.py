"""Binning and datasets of the PyTorch port (ops/binning.py, dataset.py)
against the JAX package, on the CPU.

Host code, so the bar is byte equality: bin bounds, categories, default
and missing bins, EFB groups and the binned matrix, for numerical, NaN,
zero-as-missing, categorical and EFB-bundled inputs; and a ``save_binned``
file written by the JAX package loads in the port unchanged.
"""
import os

import numpy as np
import pytest

from torch_port_cases import grid

from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.dataset import construct_dataset as jax_construct
from lightgbm_tpu.dataset import save_binned as jax_save_binned

from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.dataset import construct_dataset, load_binned
from lightgbm_tpu_torch.ops.binning import find_bin


def _data(kind, rng):
    n = 2000
    if kind == "numerical":
        return grid(rng, n, 6), {}
    if kind == "nan":
        X = rng.randn(n, 5)
        X[rng.rand(n, 5) < 0.2] = np.nan
        return X, {}
    if kind == "zero_as_missing":
        X = rng.randn(n, 4)
        X[rng.rand(n, 4) < 0.3] = 0.0
        return X, {"zero_as_missing": True}
    if kind == "categorical":
        X = grid(rng, n, 4)
        X[:, 0] = rng.randint(0, 30, n)
        X[:, 2] = rng.randint(0, 4, n)
        X[rng.rand(n) < 0.05, 2] = np.nan
        return X, {"categorical_feature": "0,2"}
    if kind == "efb":
        ids = rng.randint(0, 12, (n, 3))
        X = np.zeros((n, 36))
        for b in range(3):
            X[np.arange(n), b * 12 + ids[:, b]] = rng.rand(n) + 0.5
        return np.concatenate([X, grid(rng, n, 2)], axis=1), {}
    if kind == "max_bin_63":
        return rng.randn(n, 3) * 10, {"max_bin": 63}
    raise ValueError(kind)


KINDS = ["numerical", "nan", "zero_as_missing", "categorical", "efb",
         "max_bin_63"]

MAPPER_FIELDS = ("num_bins", "bin_type", "missing_type", "is_trivial",
                 "default_bin", "most_freq_bin", "missing_bin",
                 "sparse_rate", "min_value", "max_value")


def _assert_same_dataset(a, b):
    assert a.used_feature_indices == b.used_feature_indices
    assert len(a.bin_mappers) == len(b.bin_mappers)
    for ma, mb in zip(a.bin_mappers, b.bin_mappers):
        for f in MAPPER_FIELDS:
            assert getattr(ma, f) == getattr(mb, f), f
        assert np.asarray(ma.upper_bounds).tobytes() \
            == np.asarray(mb.upper_bounds).tobytes()
        assert np.asarray(ma.categories).tobytes() \
            == np.asarray(mb.categories).tobytes()
    assert [(g.feature_indices, g.bin_offsets, g.num_bins)
            for g in a.groups] == [(g.feature_indices, g.bin_offsets,
                                    g.num_bins) for g in b.groups]
    assert a.binned.dtype == b.binned.dtype
    assert a.binned.shape == b.binned.shape
    assert a.binned.tobytes() == b.binned.tobytes()
    assert np.array_equal(a.feature_to_group, b.feature_to_group)
    assert np.array_equal(a.feature_group_offset, b.feature_group_offset)


@pytest.mark.parametrize("kind", KINDS)
def test_binned_dataset_byte_equal(kind):
    X, params = _data(kind, np.random.RandomState(5))
    y = np.random.RandomState(6).rand(len(X))
    params = dict(params, verbosity=-1)
    a = jax_construct(X, JaxConfig.from_params(params), label=y)
    b = construct_dataset(X, Config.from_params(params), label=y)
    _assert_same_dataset(a, b)
    if kind == "efb":
        assert b.has_bundles
        for k, v in a.bundle_maps().items():
            assert np.array_equal(v, b.bundle_maps()[k]), k


@pytest.mark.parametrize("kind", KINDS)
def test_save_binned_from_jax_loads_in_port(kind, tmp_path):
    X, params = _data(kind, np.random.RandomState(8))
    y = np.random.RandomState(9).rand(len(X))
    params = dict(params, verbosity=-1)
    a = jax_construct(X, JaxConfig.from_params(params), label=y)
    path = os.path.join(str(tmp_path), "ds.npz")
    jax_save_binned(a, path)
    b = load_binned(path)
    _assert_same_dataset(a, b)
    assert b.metadata.label.tobytes() == a.metadata.label.tobytes()
    # and the port bins new rows with the loaded mappers as JAX does
    Xn, _ = _data(kind, np.random.RandomState(10))
    for j, (ma, mb) in enumerate(zip(a.bin_mappers, b.bin_mappers)):
        col = Xn[:, a.used_feature_indices[j]]
        assert np.array_equal(ma.value_to_bin(col), mb.value_to_bin(col))


def test_find_bin_matches_jax():
    from lightgbm_tpu.ops.binning import find_bin as jax_find_bin
    rng = np.random.RandomState(12)
    vals = np.concatenate([rng.randn(900), np.zeros(80),
                           np.full(20, np.nan)])
    for mb in (15, 255):
        a = jax_find_bin(vals, len(vals), mb, 3)
        b = find_bin(vals, len(vals), mb, 3)
        assert np.asarray(a.upper_bounds).tobytes() \
            == np.asarray(b.upper_bounds).tobytes()
        assert (a.missing_type, a.default_bin) == (b.missing_type,
                                                   b.default_bin)
