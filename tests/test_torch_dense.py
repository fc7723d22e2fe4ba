"""The dense tree builder of the PyTorch port (``lightgbm_tpu_torch``)
against the JAX package, on the CPU: the builder past 256 bins (u16) and
for ``tree_builder=dense``, with the kernels' plain twins.

The bars:
- ``ops/histogram.build_histogram_plain`` against JAX ``build_histogram``
  and ``build_histogram_np`` over u8 and u16 bins, masked and with
  ``mxu_bf16``: EQUAL on 1/64-grid channels (every sum exact in f32);
  ``dense_histogram_plain`` by leaf and by a split's header equal to the
  JAX builder's ``hist_of_leaf``;
- one tree against JAX ``build_tree`` at 31 and 255 leaves and 511 bins:
  every split (leaf, feature, bin, kind, default_left, routing table) and
  every row's leaf EQUAL, gains, sums and leaf values within rtol 1e-5;
  the same with the options the dense builder honours (by-node sampling,
  extra-trees, interaction constraints, forced splits, max_depth, the
  basic monotone clamp);
- the gates and fatals of the JAX package (advanced monotone falls back
  to basic with a warning; CEGB, quantized gradients and EFB with the
  dense builder are fatal; tree_builder=partition past 256 bins too);
- dense against partition on u8 bins: the same trees;
- the split scan past 256 bins against JAX ``find_best_split``;
- the u16 router's twin against the round-by-round plain router and the
  dense loop's leaves; training at 1023 bins against the JAX package
  (trees, predictions, pred_leaf); the device tree loop's dense mode
  against the per-split host loop, field by field; phase 3j of
  ``chip_smoke.py`` at a small size.
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_cases import (CPU, REPO, TRAIN_ATOL, TRAIN_RTOL,
                              assert_same_trees, one_torch_thread,
                              torch_threads)

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import construct_dataset as jax_construct
from lightgbm_tpu.learner import SerialTreeLearner as JLearner
from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops.split import FeatureMeta as JMeta
from lightgbm_tpu.ops.split import SplitHyper as JHyper
from lightgbm_tpu.ops.split import find_best_split as jax_scan

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.dataset import construct_dataset
from lightgbm_tpu_torch.learner import (SerialTreeLearner, assign_leaves,
                                        assign_leaves_plain, device_bins,
                                        route_layout)
from lightgbm_tpu_torch.ops import histogram as H
from lightgbm_tpu_torch.ops.split import find_best_split as port_scan
from lightgbm_tpu_torch.prng import PRNGKey
from lightgbm_tpu_torch.utils.log import LightGBMError, set_thread_log_sink

if REPO not in sys.path:
    sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """Every test here runs the port on the host: one torch thread
    (torch_port_cases.one_torch_thread)."""


@pytest.fixture(autouse=True, scope="module")
def _one_thread_module():
    """Module-scoped fixtures run before function-scoped ones: one torch
    thread for them too."""
    with torch_threads(1):
        yield


def _wide_grid(rng, n, f):
    """Features on a 1/1024 grid: past 256 distinct values a column."""
    return np.round(rng.randn(n, f) * 256) / 1024.0


def _channels(rng, n):
    g = np.round(rng.randn(n) * 16) / 64
    h = (np.round(np.abs(rng.randn(n)) * 16) + 6) / 64
    return np.stack([g, h, np.ones(n)], axis=1).astype(np.float32)


# ------------------------------------------------------------- histograms

@pytest.mark.parametrize("case", ["u8", "u16", "u8_masked", "u16_masked",
                                  "u16_bf16", "u8_short_chunk"])
def test_build_histogram_plain_matches_jax(case):
    rng = np.random.RandomState(len(case))
    n, f = 1500, 7
    B = 1000 if case.startswith("u16") else 200
    bins = rng.randint(0, B, (n, f)).astype(
        np.uint16 if B > 256 else np.uint8)
    ghc = _channels(rng, n)
    if "masked" in case:
        ghc = ghc * (rng.rand(n) < 0.4)[:, None].astype(np.float32)
    bf16 = case.endswith("bf16")
    chunk = 256 if case.endswith("short_chunk") else 512
    got = H.build_histogram_plain(device_bins(bins, "cpu"),
                                  torch.as_tensor(ghc), B, chunk, bf16)
    want = np.asarray(JH.build_histogram(jnp.asarray(bins),
                                         jnp.asarray(ghc), B, chunk, bf16))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  JH.build_histogram_np(bins, ghc, B))


def test_dense_histogram_plain_by_leaf_and_header():
    """By host leaf (-1: every row), by a live header (either child
    smaller) and by a dead one: the JAX builder's masked histogram, and
    DenseHistogram's output buffer left as it was where the header is
    dead."""
    rng = np.random.RandomState(7)
    n, f, B = 1200, 5, 700
    bins_np = rng.randint(0, B, (n, f)).astype(np.uint16)
    bins = device_bins(bins_np, "cpu")
    ghc = torch.as_tensor(_channels(rng, n))
    row_leaf = torch.as_tensor(rng.randint(0, 6, n).astype(np.int32))

    def jax_leaf(leaf):
        mask = (leaf < 0) | (row_leaf.numpy() == leaf)
        return np.asarray(JH.build_histogram(
            jnp.asarray(bins_np), jnp.asarray(ghc.numpy() * mask[:, None]),
            B, 4096))

    op = H.DenseHistogram(bins, ghc, row_leaf, B)
    for leaf in (-1, 0, 3, 9):
        np.testing.assert_array_equal(op(leaf).numpy(), jax_leaf(leaf))
        np.testing.assert_array_equal(
            H.dense_histogram(bins, ghc, row_leaf, leaf, num_bins=B).numpy(),
            jax_leaf(leaf))
    for ls, small in ((1, 2), (0, 5)):
        hdr = torch.tensor([0, 0, 0, 1, ls, 2, 1, 2], dtype=torch.int32)
        np.testing.assert_array_equal(op(hdr=hdr, new_leaf=5).numpy(),
                                      jax_leaf(small))
    op.out.fill_(3.0)
    dead = torch.tensor([0, 0, 0, 1, 1, 2, 0, 2], dtype=torch.int32)
    assert bool((op(hdr=dead, new_leaf=5) == 3.0).all())


def test_dense_row_update_plain():
    """The row update moves exactly the parent's rows whose bin goes right,
    and nothing under a dead header."""
    rng = np.random.RandomState(8)
    n, f, B = 900, 4, 600
    bins_np = rng.randint(0, B, (n, f)).astype(np.uint16)
    bins = device_bins(bins_np, "cpu")
    leaf = rng.randint(0, 4, n).astype(np.int32)
    go = rng.rand(B) < 0.5
    for live in (1, 0):
        rl = torch.as_tensor(leaf.copy())
        hdr = torch.tensor([0, 0, 0, 2, 1, 1, live, 3], dtype=torch.int32)
        H.dense_row_update(bins, rl, torch.as_tensor(go), hdr, 7)
        want = leaf.copy()
        if live:
            want[(leaf == 3) & ~go[bins_np[:, 2]]] = 7
        np.testing.assert_array_equal(rl.numpy(), want)


def test_dense_plan_and_bound():
    """The kernel's plan fits its shared memory at any bin count (features
    grouped, bins tiled past one feature's share) and sizes the partials
    for every row; the bound grows with the selected rows."""
    for n, F, B in ((2_000_000, 28, 1023), (2_000_000, 28, 255),
                    (1000, 3, 65535), (10, 1, 2)):
        p = H.dense_plan(n, F, B)
        assert p.smem <= H.DENSE_SMEM_BYTES
        assert 1 <= p.feats <= 8 and 1 <= p.bins <= B
        assert p.chunks * H.DENSE_CHUNK >= n
    assert H.dense_plan(2_000_000, 28, 1023).feats == 2
    assert H.dense_plan(2_000_000, 28, 255).feats == 8
    assert H.dense_plan(100, 3, 65535).bins < 65535
    assert H.dense_sum_bound(10) < H.dense_sum_bound(100_000)


# --------------------------------------------------------------- one tree

def _one_tree(extra, n=2999, f=8, leaves=31, seed=0, p_extra=None):
    """(JAX log, port log, port learner) of one tree from the same
    channels, 511 bins unless ``extra`` says otherwise."""
    rng = np.random.RandomState(seed)
    X = _wide_grid(rng, n, f)
    y = (X @ rng.randn(f) > 0).astype(np.float64)
    ghc = _channels(rng, n)
    p = {"objective": "binary", "num_leaves": leaves, "max_bin": 511,
         "min_data_in_leaf": 2, "verbosity": -1, "min_gain_to_split": 1e-3}
    p.update(extra)
    jcfg = JConfig.from_params(dict(p))
    jds = jax_construct(X, jcfg, label=y)
    jl = JLearner(jcfg, jds)
    a = jax.device_get(jl.train(jnp.asarray(ghc),
                                jnp.ones(jds.num_features, bool),
                                jax.random.PRNGKey(seed)))
    pcfg = Config.from_params(dict(p, device_type="cpu"))
    lrn = SerialTreeLearner(pcfg, construct_dataset(X, pcfg, label=y))
    b = lrn.train(torch.as_tensor(ghc), key=PRNGKey(seed))
    return a, b, lrn, jl


def _assert_same_log(a, b):
    ns = int(a.num_splits)
    assert ns == int(b.num_splits[0]) > 0
    for fld in ("split_leaf", "feature", "bin", "kind", "default_left",
                "go_left"):
        np.testing.assert_array_equal(np.asarray(getattr(a, fld))[:ns],
                                      getattr(b, fld).numpy()[:ns],
                                      err_msg=fld)
    np.testing.assert_array_equal(np.asarray(a.row_leaf), b.row_leaf.numpy())
    for fld in ("gain", "left_sum", "right_sum", "leaf_value", "leaf_sum"):
        np.testing.assert_allclose(getattr(b, fld).numpy(),
                                   np.asarray(getattr(a, fld)),
                                   rtol=1e-5, atol=1e-6, err_msg=fld)
    return ns


@pytest.mark.parametrize("leaves,n", [(31, 2999), (255, 1501)])
def test_one_tree_equals_jax(leaves, n):
    a, b, lrn, jl = _one_tree({}, n=n, leaves=leaves)
    assert lrn.dense and not jl.use_partition()
    assert lrn.bins.dtype == torch.int16 and lrn.num_bin > 256
    assert _assert_same_log(a, b) == leaves - 1


def _forced_file(tmp_path):
    import json
    path = tmp_path / "forced.json"
    path.write_text(json.dumps({"feature": 1, "threshold": 0.0,
                                "left": {"feature": 2, "threshold": 0.1},
                                "right": {"feature": 0,
                                          "threshold": -0.2}}))
    return str(path)


OPTIONS = {
    "bynode_extra": {"feature_fraction_bynode": 0.5, "extra_trees": True},
    "constraints": {"interaction_constraints": "[0,1,2],[2,3,4,5,6,7]"},
    "max_depth": {"max_depth": 4},
    "monotone": {"monotone_constraints": [1, -1, 0, 0, 0, 0, 0, 1]},
    "intermediate": {"monotone_constraints": [1, -1, 0, 0, 0, 0, 0, 1],
                     "monotone_constraints_method": "intermediate"},
    "forced": None,
    "dense_u8": {"tree_builder": "dense", "max_bin": 63},
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_options_one_tree_equal_jax(name, tmp_path):
    """The options the dense builder honours, one tree each against the
    JAX builder (the intermediate method takes the basic clamp in the
    dense builder of both packages)."""
    extra = OPTIONS[name]
    if extra is None:
        extra = {"forcedsplits_filename": _forced_file(tmp_path)}
    a, b, lrn, _ = _one_tree(extra, seed=3)
    assert lrn.dense
    _assert_same_log(a, b)
    if name == "forced":
        assert int(b.feature[0]) == 1


def test_gates_and_fatals(tmp_path):
    """The JAX package's gates of the dense builder: advanced monotone
    falls back to the basic method with a warning (and grows the basic
    method's tree); CEGB, quantized gradients and EFB bundles with the
    dense builder are fatal, and so is tree_builder=partition past 256
    bins."""
    rng = np.random.RandomState(4)
    X = _wide_grid(rng, 800, 6)
    y = (X[:, 0] > 0).astype(float)
    base = {"objective": "binary", "max_bin": 511, "verbosity": -1,
            "num_leaves": 15, "device_type": "cpu"}
    lines = []
    set_thread_log_sink(lines.append)
    try:
        mono = dict(base, monotone_constraints=[1, 0, 0, 0, 0, 0])
        adv = lgt.train(dict(mono, monotone_constraints_method="advanced"),
                        lgt.Dataset(X, label=y, params=dict(mono)), 2)
        basic = lgt.train(mono, lgt.Dataset(X, label=y, params=dict(mono)),
                          2)
    finally:
        set_thread_log_sink(None)
    assert any("applies the basic (midpoint) method" in ln for ln in lines)
    assert not adv.inner.learner.hp.mono_advanced
    assert adv.model_to_string().split("parameters:")[0] == \
        basic.model_to_string().split("parameters:")[0]
    for extra, match in (({"cegb_penalty_split": 0.1}, "CEGB"),
                         ({"use_quantized_grad": True}, "quantized"),
                         ({"tree_builder": "partition"}, "max_bin <= 256")):
        with pytest.raises(LightGBMError, match=match):
            lgt.train(dict(base, **extra), lgt.Dataset(X, label=y), 1)
    Xe = np.zeros((600, 9))
    Xe[np.arange(600), rng.randint(0, 8, 600)] = 1.0
    Xe[:, 8] = rng.randn(600)
    with pytest.raises(LightGBMError, match="EFB bundles|does not support"):
        lgt.train(dict(base, tree_builder="dense", max_bin=63),
                  lgt.Dataset(Xe, label=(Xe[:, 8] > 0).astype(float)), 1)


def test_dense_equals_partition_on_u8():
    """On u8 bins the dense builder grows the partitioned builder's tree
    (the JAX package's tests/test_partition.py holds its two alike)."""
    rng = np.random.RandomState(5)
    X = np.round(rng.randn(2500, 8) * 16) / 64
    y = (X @ rng.randn(8) > 0).astype(np.float64)
    ghc = torch.as_tensor(_channels(rng, 2500))
    logs = {}
    for mode in ("dense", "partition"):
        cfg = Config.from_params({"objective": "binary", "num_leaves": 31,
                                  "max_bin": 63, "verbosity": -1,
                                  "min_data_in_leaf": 2,
                                  "tree_builder": mode, "device_type": "cpu"})
        lrn = SerialTreeLearner(cfg, construct_dataset(X, cfg, label=y))
        assert lrn.dense == (mode == "dense")
        logs[mode] = lrn.train(ghc)
    a, b = logs["dense"], logs["partition"]
    ns = int(a.num_splits[0])
    assert ns == int(b.num_splits[0]) == 30
    for fld in ("split_leaf", "feature", "bin", "kind", "go_left",
                "row_leaf"):
        assert torch.equal(getattr(a, fld), getattr(b, fld)), fld
    for fld in ("gain", "leaf_value"):
        np.testing.assert_allclose(getattr(a, fld).numpy(),
                                   getattr(b, fld).numpy(), rtol=1e-5,
                                   atol=1e-6)


# ------------------------------------------------- scan, router, training

@pytest.mark.parametrize("B,cat", [(511, False), (1023, False), (700, True)])
def test_scan_past_256_bins_matches_jax(B, cat):
    """find_best_split over (2, F, B, 3) children past 256 bins (the twin
    of the split scan kernel's wide mode) against the JAX package's, on
    exact sums: every field equal but the float ones, within 1e-6."""
    ht, pair, meta, hp, fmask = chip_smoke.wide_scan_case(
        torch.device("cpu"), np.random.RandomState(B), B, cat=cat)
    sums = pair[0:6].view(2, 3)
    got = port_scan(ht, sums, meta, fmask, hp, parent_output=pair[6:8],
                    leaf_lower=pair[8:10], leaf_upper=pair[10:12],
                    node_depth=2)
    jmeta = JMeta(**{k: jnp.asarray(v.numpy())
                     for k, v in meta._asdict().items()
                     if k in JMeta._fields})
    want = jax.device_get(jax.vmap(
        lambda h, s, o: jax_scan(h, s, jmeta, jnp.asarray(fmask.numpy()),
                                 JHyper(**hp._asdict()), parent_output=o),
    )(jnp.asarray(ht.numpy()), jnp.asarray(sums.numpy()),
      jnp.asarray(pair[6:8].numpy())))
    assert float(got.gain.max()) > 0
    for fld in ("feature", "bin", "kind", "default_left", "go_left"):
        np.testing.assert_array_equal(getattr(got, fld).numpy(),
                                      np.asarray(getattr(want, fld)),
                                      err_msg=fld)
    for fld in ("gain", "left_sum", "right_sum", "left_output",
                "right_output"):
        np.testing.assert_allclose(getattr(got, fld).numpy(),
                                   np.asarray(getattr(want, fld)),
                                   rtol=1e-6, atol=1e-6, err_msg=fld)


@pytest.mark.parametrize("cat_frac,ns", [(0.0, 254), (0.5, 120), (0.0, 0)])
def test_u16_router_twin(cat_frac, ns):
    """The router over u16 bins on the host (route_rows' twin, through
    assign_leaves) against the round-by-round plain router: numerical
    rounds with movable-missing bins, categorical rounds over 1023 bins,
    num_splits 0."""
    rng = np.random.RandomState(ns + 1)
    F, B = 12, 1023
    bins = device_bins(rng.randint(0, B, (3000, F)).astype(np.uint16),
                       "cpu")
    log = chip_smoke.random_log(rng, torch.device("cpu"), 254, F, B,
                                cat_frac)
    log = log._replace(num_splits=torch.tensor([ns], dtype=torch.int32))
    got = assign_leaves(bins, log, has_categorical=True,
                        bins_t=route_layout(bins))
    want = assign_leaves_plain(bins, log, True)
    assert torch.equal(got, want)
    if ns:
        assert int(got.max()) > 0


@pytest.mark.parametrize("objective", ["regression", "nan"])
def test_training_at_1023_bins_matches_jax(objective):
    """Five iterations at max_bin 1023 (u16 bins) with a valid set (the
    per-split host loop, the u16 router for the valid rows) against the
    JAX package, with and without NaN (missing) values: the same trees,
    raw predictions, pred_leaf and valid metrics; the fused path (no valid
    set) equals it. L2 on 1/64-grid labels keeps every histogram sum
    exact; inexact gradients (multiclass, binary) tie adjacent thresholds
    of 1023 bins to the last bit (ROADMAP C)."""
    rng = np.random.RandomState(9)
    n, nv, f = 2500, 500, 6
    X = _wide_grid(rng, n + nv, f)
    z = X @ np.array([1.0, -0.8, 0.6, -0.45, 0.3, -0.2]) \
        + 0.5 * np.round(rng.randn(n + nv) * 16) / 64
    p = {"objective": "regression", "num_leaves": 31, "max_bin": 1023,
         "verbosity": -1, "min_gain_to_split": 1e-3}
    y = np.round(z * 64) / 64
    if objective == "nan":
        # NaN in the columns past the first, which keep few distinct values
        # (near ties between adjacent thresholds of 1023 bins are a matter
        # of summation order, ROADMAP C; the first column keeps them wide)
        X[:, 1:] = np.round(X[:, 1:] * 16) / 16
        X[:, 1:][rng.rand(n + nv, f - 1) < 0.1] = np.nan
    Xv, yv, X, y = X[n:], y[n:], X[:n], y[:n]
    dj = lgb.Dataset(X, label=y, params=dict(p))
    ej, et = {}, {}
    jb = lgb.train(p, dj, 5, valid_sets=[lgb.Dataset(Xv, label=yv,
                                                     reference=dj)],
                   valid_names=["v"], callbacks=[lgb.record_evaluation(ej)])
    pc = dict(p, **CPU)
    dt = lgt.Dataset(X, label=y, params=dict(pc))
    pb = lgt.train(pc, dt, 5, valid_sets=[lgt.Dataset(Xv, label=yv,
                                                      reference=dt)],
                   valid_names=["v"], callbacks=[lgt.record_evaluation(et)])
    assert pb.inner.learner.dense and pb.inner.learner.num_bin > 256
    assert_same_trees(jb.inner.models, pb.inner.models)
    for rows in (X, Xv):
        np.testing.assert_allclose(pb.predict(rows, raw_score=True),
                                   jb.predict(rows, raw_score=True),
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
        np.testing.assert_array_equal(pb.predict(rows, pred_leaf=True),
                                      jb.predict(rows, pred_leaf=True))
    for m in ej["v"]:
        np.testing.assert_allclose(et["v"][m], ej["v"][m], rtol=1e-5)
    fused = lgt.train(pc, lgt.Dataset(X, label=y, params=dict(pc)), 5)
    assert fused.inner._fused is not None
    assert fused.model_to_string() == pb.model_to_string()


@pytest.mark.parametrize("extra", [
    {"max_bin": 511},
    {"tree_builder": "dense", "max_bin": 63, "max_depth": 5},
    {"max_bin": 511, "feature_fraction_bynode": 0.5, "extra_trees": True,
     "interaction_constraints": "[0,1,2],[2,3,4,5]"},
    {"max_bin": 511, "monotone_constraints": [1, -1, 0, 0, 0, 0]},
    "forced"])
def test_device_loop_equals_host_loop(extra, tmp_path):
    """The device tree loop in its dense mode (ops/chain.DenseSplit: the
    row update, the smaller child's histogram by header, the scan, the
    commit) grows the per-split host loop's tree on host tensors, every
    field of the log equal; on host tensors the learner's ``train`` is
    the per-split host loop."""
    rng = np.random.RandomState(6)
    X = _wide_grid(rng, 2000, 6)
    y = np.round((X @ np.array([1.0, -0.8, 0.6, -0.45, 0.3, -0.2])) * 64) \
        / 64
    if extra == "forced":
        extra = {"max_bin": 511,
                 "forcedsplits_filename": _forced_file(tmp_path)}
    p = dict({"objective": "regression", "num_leaves": 31, "verbosity": -1,
              "min_gain_to_split": 1e-3}, device_type="cpu", **extra)
    bst = lgt.Booster(p, lgt.Dataset(X, label=y, params=dict(p)))
    g = bst.inner
    lrn = g.learner
    assert lrn.dense and lrn.device_loop_eligible()
    assert not lrn.train_on_loop
    grad, hess = g.gradients(0)
    ghc = g._tree_channels(grad, hess, 0)
    for t in range(2):
        a = lrn.train_host_loop(ghc, key=PRNGKey(t))
        b = lrn.train_device(ghc, key=PRNGKey(t))
        for fld, x, z in zip(a._fields, a, b):
            assert torch.equal(x, z), (t, fld)


def test_linear_dense_phase_small_on_cpu():
    """Phase 3j of chip_smoke.py at a small size on the host (the plain
    twins): the kernel checks, linear trees (the fits captured and held,
    sha256 stable, valid AUC above the plain GBDT's, card vs host) and
    the dense builder at 1023 and 255 bins (fused equal to per iteration,
    the kernels at the root and a deep leaf)."""
    data = chip_smoke.training_data(0, 3000, 800)
    summary, counts, errs, rows = chip_smoke.phase_linear_dense(
        torch.device("cpu"), data, "cpu", leaves=15, timed=False,
        linear_trees=3, dense_trees=2, per_iter=1, host_rows=800,
        host_trees=2, host_leaves=7, kernel_rows=2000, linear_device="on")
    assert rows == {}
    assert summary["linear"]["sha256_stable"]
    assert summary["linear"]["valid_auc"] > \
        summary["linear"]["plain_gbdt_valid_auc"]
    assert summary["u16_1023"]["bins_dtype"] == "torch.int16"
    assert summary["u16_1023"]["num_bin"] > 256
    assert summary["dense_255"]["bins_dtype"] == "torch.uint8"
    for name in chip_smoke.DENSE_CONFIGS:
        assert summary[name]["per_iteration_equal"]
    assert any(k.startswith("linear_gram/full_width") for k in errs)
    assert any(k.startswith("router_u16/u16_1023") for k in errs)
