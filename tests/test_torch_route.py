"""Row router of the PyTorch port (lightgbm_tpu_torch/ops/route.py and
learner.assign_leaves) against the JAX package, on the CPU.

Leaf ids are integers, so the bar is equality: with the JAX
``assign_leaves`` (its XLA router, the path the JAX package takes off the
TPU) and with the JAX Pallas ``route_rows`` run under the interpreter
(``lightgbm_tpu.ops.partition._INTERPRET``, read at call time). Dense
numerical trees with NaN-missing bins, EFB-bundled trees, and
categorical trees (which stay on the plain router in both packages).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from torch_port_cases import CPU, train_case

import lightgbm_tpu as lgb
import lightgbm_tpu.ops.partition
from lightgbm_tpu.learner import assign_leaves as jax_assign_leaves
from lightgbm_tpu.ops.predict import tree_to_bin_log as jax_bin_log
from lightgbm_tpu.ops.route import ROUTE_BLOCK_ROWS
from lightgbm_tpu.ops.route import build_route_table as jax_route_table
from lightgbm_tpu.ops.route import route_rows as jax_route_rows

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.learner import assign_leaves, route_layout
from lightgbm_tpu_torch.ops.predict import tree_to_bin_log
from lightgbm_tpu_torch.ops.route import (ROUTE_KERNEL, TBL_W,
                                          build_route_table, route_rows,
                                          route_rows_plain)


def _efb_case(tmp_path):
    """One-hot blocks (bundled by EFB) beside two dense columns."""
    rng = np.random.RandomState(3)
    n = 1500
    blocks, w = [], []
    for _ in range(4):
        ids = rng.randint(0, 10, n)
        blocks.append(sp.csr_matrix((np.ones(n), (np.arange(n), ids)),
                                    shape=(n, 10)))
        w.append(rng.randn(10))
    dense = np.round(rng.randn(n, 2) * 16) / 64.0
    Xs = sp.hstack(blocks).toarray()
    X = np.concatenate([Xs, dense], axis=1)
    y = (Xs @ np.concatenate(w) + dense[:, 0] + 0.2 * rng.randn(n)
         > 0).astype(np.float64)
    ds = lgb.Dataset(X, label=y)
    bst = lgb.train({"objective": "binary", "num_leaves": 15,
                     "verbosity": -1, "min_data_in_leaf": 5}, ds,
                    num_boost_round=4)
    path = os.path.join(str(tmp_path), "efb_train.npz")
    ds.save_binary(path)
    port = lgt.booster_from_reference(bst.model_to_string(), path, CPU)
    assert bst.inner.train_set.has_bundles
    return bst, port


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    d = tmp_path_factory.mktemp("route")
    out = {name: train_case(name, d, rounds=4)[:2]
           for name in ("nan_missing", "categorical")}
    out["efb"] = _efb_case(d)
    return out


def _jax_side(bst):
    ds = bst.inner.train_set
    bundle = None
    if ds.has_bundles:
        bundle = {k: jnp.asarray(v) for k, v in ds.bundle_maps().items()}
    return ds, jnp.asarray(ds.binned), bundle


def _port_side(port):
    ds = port.inner.train_set
    bundle = None
    if ds.has_bundles:
        bundle = {k: torch.as_tensor(v) for k, v in ds.bundle_maps().items()}
    return ds, torch.as_tensor(ds.binned), bundle


@pytest.mark.parametrize("name", ["nan_missing", "efb"])
def test_route_rows_equals_jax(cases, name, monkeypatch):
    bst, port = cases[name]
    jds, jbins, jbundle = _jax_side(bst)
    pds, pbins, pbundle = _port_side(port)
    n, g = jds.binned.shape
    npad = -(-n // ROUTE_BLOCK_ROWS) * ROUTE_BLOCK_ROWS
    jbt = jnp.pad(jbins.T, ((0, 0), (0, npad - n))).reshape(g, -1, 128)
    pbt = route_layout(pbins)
    monkeypatch.setattr(lightgbm_tpu.ops.partition, "_INTERPRET", True)
    before = ROUTE_KERNEL.launches
    for tree, ptree in zip(bst.inner.models, port.inner.models):
        jlog = jax_bin_log(tree, jds)
        plog = tree_to_bin_log(ptree, pds)
        jtab = np.asarray(jax_route_table(jlog, None, jbundle))
        ptab = build_route_table(plog, pbundle)
        assert np.array_equal(jtab, ptab.numpy())
        ref_xla = np.asarray(jax_assign_leaves(
            jbins, jlog, has_categorical=False, bundle=jbundle))
        ref_pallas = np.asarray(jax_route_rows(
            jbt, jnp.asarray(jtab), jlog.num_splits, n))[:n]
        got = assign_leaves(pbins, plog, has_categorical=False,
                            bundle=pbundle, bins_t=pbt)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), ref_xla)
        assert np.array_equal(got.numpy(), ref_pallas)
        # the wrapper's CPU path is its plain twin
        direct = route_rows(pbt, ptab, plog.num_splits)
        assert torch.equal(direct, route_rows_plain(pbt, ptab,
                                                    plog.num_splits))
    assert ROUTE_KERNEL.launches == before


def test_categorical_trees_use_plain_router(cases):
    bst, port = cases["categorical"]
    jds, jbins, _ = _jax_side(bst)
    pds, pbins, _ = _port_side(port)
    assert any((t.decision_type & 1).any() for t in port.inner.models)
    for tree, ptree in zip(bst.inner.models, port.inner.models):
        ref = np.asarray(jax_assign_leaves(jbins, jax_bin_log(tree, jds),
                                           has_categorical=True))
        got = assign_leaves(pbins, tree_to_bin_log(ptree, pds),
                            has_categorical=True)
        assert np.array_equal(got.numpy(), ref)


def test_route_tree_device_matches_jax(cases):
    """GBDT._route_tree_device: leaf values and slots per tree."""
    for name in ("nan_missing", "efb"):
        bst, port = cases[name]
        for tree, ptree in zip(bst.inner.models, port.inner.models):
            jv, jl = bst.inner._route_tree_device(tree, bst.inner.train_set)
            pv, pl = port.inner._route_tree_device(ptree,
                                                   port.inner.train_set)
            assert np.array_equal(np.asarray(jl), pl.numpy())
            assert np.asarray(jv).tobytes() == pv.tobytes()


def test_route_rows_validates_inputs():
    tbl = torch.zeros(TBL_W, dtype=torch.int32)
    ns = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        route_rows(torch.zeros((2, 4, 64), dtype=torch.uint8), tbl, ns)
    with pytest.raises(TypeError):
        route_rows(torch.zeros((2, 1, 128), dtype=torch.int32), tbl, ns)
    with pytest.raises(ValueError):
        route_rows(torch.zeros((2, 1, 128), dtype=torch.uint8),
                   torch.zeros(7, dtype=torch.int32), ns)
