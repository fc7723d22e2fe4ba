"""Forest kernel of the PyTorch port (lightgbm_tpu_torch/ops/forest.py)
against the JAX package, on the CPU.

For all six model classes of tests/test_forest_kernel.py the port's
forest path (its plain twin on the CPU) and its plain raw-threshold
predict must agree with the JAX oracle ``predict_raw_impl`` and with the
JAX Pallas forest kernel under the interpreter, within RTOL/ATOL (f32
sums in another order). The BIN-space tables themselves must be equal.
"""
import numpy as np
import pytest
import torch

from torch_port_cases import ATOL, CLASSES, CPU, RTOL, train_case

import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops.forest import forest_pack as jax_forest_pack
from lightgbm_tpu.serve import PredictSession as JaxSession
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.ops.forest import (FOREST_KERNEL, forest_pack,
                                           forest_predict_impl,
                                           forest_predict_plain, forest_walk)
from lightgbm_tpu_torch.serve import PredictSession


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    d = tmp_path_factory.mktemp("forest")
    return {name: train_case(name, d) for name in CLASSES}


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_forest_scores_match_jax(cases, name):
    bst, port, Xq, _ = cases[name]
    oracle = JaxSession(bst, buckets=(256,), forest="off").raw_scores(Xq)
    pallas = JaxSession(bst, buckets=(256,), forest="on").raw_scores(Xq)
    obs.telemetry.reset()
    sess = PredictSession(port, buckets=(256,), forest="on")
    got = sess.raw_scores(Xq)
    assert obs.telemetry.counter("serve/forest_dispatches") == 1
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_plain_predict_matches_jax(cases, name):
    bst, port, Xq, _ = cases[name]
    oracle = JaxSession(bst, buckets=(256,), forest="off").raw_scores(Xq)
    got = PredictSession(port, buckets=(256,), forest="off").raw_scores(Xq)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_forest_tables_equal_jax(cases, name):
    """The BIN-space split-major repack is integer-for-integer the JAX
    package's (and its f32 leaf tables bit-equal)."""
    bst, port, _, _ = cases[name]
    K = bst.inner.num_tree_per_iteration
    ref, rc, rl = jax_forest_pack(bst.inner.models, bst.inner.train_set,
                                  num_class=K)
    fp, c, lin = forest_pack(port.inner.models, port.inner.train_set,
                             num_class=K)
    assert (c, lin) == (rc, rl)
    assert c == (name == "categorical")
    assert lin == name.startswith("linear")
    for field in fp._fields:
        a = np.asarray(getattr(ref, field))
        b = getattr(fp, field).numpy()
        assert a.shape == b.shape, field
        assert a.tobytes() == b.astype(a.dtype).tobytes(), field


def test_final_predictions_match_jax(cases):
    """Booster.predict (init score + sigmoid) on the forest path."""
    bst, port, Xq, _ = cases["binary"]
    Xbig = np.concatenate([Xq, Xq])     # >= DEVICE_PREDICT_MIN_ROWS
    np.testing.assert_allclose(port.predict(Xbig), bst.predict(Xbig),
                               rtol=RTOL, atol=ATOL)
    mc, pmc, Xm, _ = cases["multiclass"]
    Xm2 = np.concatenate([Xm, Xm])
    np.testing.assert_allclose(pmc.predict(Xm2), mc.predict(Xm2),
                               rtol=RTOL, atol=ATOL)


def test_multi_chunk_dispatch(cases):
    """A request past the top rung chunks into padded dispatches."""
    bst, port, _, _ = cases["binary"]
    rng = np.random.RandomState(11)
    Xq = np.round(rng.randn(700, 8) * 16) / 64.0
    oracle = JaxSession(bst, buckets=(256,), forest="off").raw_scores(Xq)
    got = PredictSession(port, buckets=(256,), forest="on").raw_scores(Xq)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)


def test_cpu_wrapper_uses_plain_twin_and_counts_nothing(cases):
    _, port, Xq, _ = cases["categorical"]
    fp, has_cat, _ = forest_pack(port.inner.models, port.inner.train_set)
    sess = PredictSession(port, buckets=(256,))
    bins, _ = sess._bin_rows(np.asarray(Xq, np.float32))
    bins = torch.from_numpy(bins)
    before = FOREST_KERNEL.launches
    a = forest_predict_impl(bins, None, fp, walk=forest_walk(fp),
                            has_cat=has_cat)
    b = forest_predict_plain(bins, None, fp, has_cat=has_cat)
    assert torch.equal(a, b)
    assert FOREST_KERNEL.launches == before


def test_ineligible_model_serves_plain(cases):
    """Without bin mappers the forest path is ineligible: the session
    records why and serves through the plain predict."""
    bst, _, Xq, _ = cases["binary"]
    loaded = lgt.Booster(params=CPU, model_str=bst.model_to_string())
    obs.telemetry.reset()
    got = PredictSession(loaded, buckets=(256,)).raw_scores(Xq)
    oracle = JaxSession(bst, buckets=(256,), forest="off").raw_scores(Xq)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)
    assert obs.telemetry.counter("serve/forest_dispatches") == 0
    assert obs.telemetry.records("forest_ineligible")


def test_forest_knob_auto_resolves_on(cases):
    _, port, _, _ = cases["binary"]
    obs.telemetry.reset()
    assert port.inner._forest_knob() == "on"
    rec = obs.telemetry.records("auto_resolution")[0]
    assert rec["knob"] == "tpu_forest_kernel" and rec["value"] == "on"
    off = lgt.Booster(params=dict(CPU, tpu_forest_kernel="off"),
                      model_str=port.model_to_string())
    assert off.inner._forest_knob() == "off"


def test_forest_wrapper_validates_inputs(cases):
    _, port, _, _ = cases["binary"]
    fp, _, _ = forest_pack(port.inner.models, port.inner.train_set)
    walk = forest_walk(fp)
    with pytest.raises(ValueError):
        forest_predict_impl(torch.zeros((4, 8), dtype=torch.int64), None, fp,
                            walk=walk)
    with pytest.raises(ValueError):
        forest_predict_impl(torch.zeros((4, 8), dtype=torch.int32), None,
                            fp, walk=walk, has_linear=True)
