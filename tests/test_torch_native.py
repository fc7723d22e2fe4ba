"""The port's native bin applier (``native/binning.cpp`` through
``io_native.apply_bins_native``) against the port's numpy path and the JAX
package's applier, byte for byte; ``Dataset.construct`` on mixed data
against the JAX package's; and the no-fallback rule: a host library that
does not build raises."""
import os
import shutil

import numpy as np
import pytest

from torch_port_cases import CPU, make_train_data

from lightgbm_tpu import Dataset as JaxDataset
from lightgbm_tpu import io_native as jax_native

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import io_native
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.dataset import construct_dataset
from lightgbm_tpu_torch.ops.binning import (MISSING_NAN, MISSING_NONE,
                                            MISSING_ZERO, find_bin)
from lightgbm_tpu_torch.utils.log import LightGBMError

#: missing type -> find_bin's (use_missing, zero_as_missing)
MISSING = {MISSING_NONE: (False, False), MISSING_ZERO: (True, True),
           MISSING_NAN: (True, False)}


def _applier_case(missing, max_bin, seed=0, n=3001, f=5):
    """(X, specs) with NaN, +-inf, zeros and values equal to every finite
    bound, one mapper per column of ``missing`` type and ``max_bin``."""
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, f) * 64) / 64
    X[rng.rand(n, f) < 0.1] = 0.0
    if missing == MISSING_NAN:
        X[rng.rand(n, f) < 0.1] = np.nan
    use_missing, zero_as_missing = MISSING[missing]
    specs = []
    for j in range(f):
        m = find_bin(X[:2000, j], 2000, max_bin, 3, use_missing=use_missing,
                     zero_as_missing=zero_as_missing)
        assert m.missing_type == missing
        specs.append((j, m.upper_bounds, m.missing_type, m.missing_bin,
                      f - 1 - j, m))
    # every finite bound as a value, then the infinities and NaN
    for j, (_, ub, _, _, _, _) in enumerate(specs):
        fin = ub[np.isfinite(ub)]
        X[:len(fin), j] = fin
    X[-6:, :] = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e300])[:, None]
    return X, specs


@pytest.mark.parametrize("nthreads", [1, 3, 8])
@pytest.mark.parametrize("max_bin", [2, 255])
@pytest.mark.parametrize("missing", [MISSING_NONE, MISSING_ZERO,
                                     MISSING_NAN])
def test_applier_equals_numpy_and_jax(missing, max_bin, nthreads):
    X, specs = _applier_case(missing, max_bin)
    n, f = X.shape
    plain = [s[:5] for s in specs]
    got = np.zeros((n, f), np.uint8)
    io_native.apply_bins_native(X, plain, got, nthreads=nthreads)
    want = np.zeros((n, f), np.uint8)
    for j, _, _, _, col, m in specs:
        want[:, col] = m.value_to_bin(X[:, j]).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    jax = np.zeros((n, f), np.uint8)
    assert jax_native.apply_bins_native(X, plain, jax, nthreads=nthreads)
    np.testing.assert_array_equal(got, jax)


def test_applier_reads_a_column_subset():
    """Non-contiguous input and a subset of columns land in their own
    output columns; other columns stay untouched."""
    X, specs = _applier_case(MISSING_NAN, 255, seed=3)
    Xf = np.asfortranarray(X)
    out = np.full((X.shape[0], 7), 9, np.uint8)
    io_native.apply_bins_native(Xf, [(1, specs[1][1], MISSING_NAN,
                                      specs[1][3], 6)], out)
    np.testing.assert_array_equal(out[:, 6],
                                  specs[1][5].value_to_bin(X[:, 1]))
    assert (out[:, :6] == 9).all()


@pytest.mark.parametrize("max_bin", [63, 255])
def test_construct_mixed_equals_jax(max_bin):
    """Numerical, NaN, categorical and one-hot blocks that EFB bundles: the
    native and numpy routes write one matrix, equal to the JAX package's
    and to the all-numpy route."""
    rng = np.random.RandomState(5)
    X, y, _ = make_train_data(rng, 4000, efb=True)
    X[:, -1] = rng.randint(0, 7, len(X))          # categorical
    X[rng.rand(len(X)) < 0.2, -2] = np.nan        # NaN in a dense column
    cat = [X.shape[1] - 1]
    params = {"max_bin": max_bin, "verbosity": -1, "num_threads": 3}
    port = lgt.Dataset(X, label=y, categorical_feature=cat,
                       params=dict(params, **CPU)).construct()
    jax = JaxDataset(X, label=y, categorical_feature=cat,
                     params=params).construct()
    assert port.has_bundles
    kinds = {(len(g.feature_indices) > 1,
              port.bin_mappers[g.feature_indices[0]].bin_type)
             for g in port.groups}
    assert kinds == {(True, 0), (False, 0), (False, 1)}
    assert port.binned.dtype == np.uint8
    np.testing.assert_array_equal(port.binned, jax.binned)
    plain = construct_dataset(X, Config.from_params(dict(params, **CPU)),
                              label=y, categorical_feature=cat, native=False)
    np.testing.assert_array_equal(port.binned, plain.binned)
    # a validation set through the reference's mappers
    Xv = X[:500] + 1.0 / 64
    pv = lgt.Dataset(Xv, reference=lgt.Dataset(X, label=y,
                                                categorical_feature=cat,
                                                params=dict(params, **CPU)))
    jv = JaxDataset(Xv, reference=JaxDataset(X, label=y,
                                             categorical_feature=cat,
                                             params=params))
    np.testing.assert_array_equal(pv.construct().binned,
                                  jv.construct().binned)


def test_uint16_matrix_keeps_numpy():
    """More than 256 bins: a uint16 matrix, the numpy route, equal to
    the JAX package's."""
    rng = np.random.RandomState(2)
    X = np.round(rng.randn(3000, 3) * 1024) / 1024
    params = {"max_bin": 1000, "verbosity": -1}
    port = lgt.Dataset(X, params=dict(params, **CPU)).construct()
    jax = JaxDataset(X, params=params).construct()
    assert port.binned.dtype == np.uint16
    np.testing.assert_array_equal(port.binned, jax.binned)


def test_library_is_built_once_under_the_build_dir():
    lib = io_native.get_binning_lib()
    assert io_native.get_binning_lib() is lib
    path = io_native.library_path(io_native.NATIVE_DIR / "binning.cpp",
                                  io_native.LIBRARY_FLAGS["binning.cpp"])
    assert path.exists() and path.parent == io_native.BUILD_DIR
    assert path.name.startswith("binning-")
    # the JAX package's cache is never read
    assert "lightgbm_tpu/" not in str(path).replace("lightgbm_tpu_torch",
                                                    "")


def _broken_native_dir(tmp_path):
    """A copy of native/ whose sources do not compile."""
    d = tmp_path / "native"
    shutil.copytree(io_native.NATIVE_DIR, d)
    for name in ("binning.cpp", "parser.cpp"):
        src = (d / name).read_text()
        (d / name).write_text(src + "\nthis is not C++;\n")
    return d


def test_broken_build_raises_and_does_not_fall_back(tmp_path, monkeypatch):
    """A source that does not compile raises LightGBMError with g++'s
    message, from the build, from Dataset construction (no numpy binning)
    and from text loading (no Python parsing)."""
    broken = _broken_native_dir(tmp_path)
    with pytest.raises(LightGBMError, match="g..? failed to build"):
        io_native.build_library(broken / "binning.cpp", ("-pthread",),
                                out_dir=tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setattr(io_native, "NATIVE_DIR", broken)
    monkeypatch.setattr(io_native, "_LIBS", {})
    X = np.random.RandomState(0).randn(200, 3)
    with pytest.raises(LightGBMError, match="binning.cpp") as err:
        construct_dataset(X, Config.from_params(dict(CPU, verbosity=-1)))
    assert "this is not C++" in str(err.value) or "error" in str(err.value)
    # a numpy-only input still constructs: routing is by input, not fault
    cat = construct_dataset(X.round(), Config.from_params(
        dict(CPU, verbosity=-1, categorical_feature="0,1,2")))
    assert cat.binned.shape == (200, cat.num_groups)
    from lightgbm_tpu_torch.io import load_text_file
    path = tmp_path / "d.csv"
    np.savetxt(path, X, delimiter=",")
    with pytest.raises(LightGBMError, match="parser.cpp"):
        load_text_file(str(path), Config.from_params(CPU))
    for p in io_native.BUILD_DIR.glob("*.tmp"):
        assert str(os.getpid()) not in p.name
