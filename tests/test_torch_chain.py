"""The device tree loop on every configuration (``learner.DeviceTreeLoop``
with ``ops/chain.ChainSplit``, the three-launch chain) on the CPU, where
every launch runs its plain twin.

The bars:
- (a) the chain's ``TreeLog`` equals the per-split host loop's
  (``build_tree_partitioned``) field by field, and so do the per-leaf
  segment and histogram counts, on the planes, resident and rows layouts
  (hi/lo, bf16, int8 with two keys in turn through one loop), with EFB
  bundles, one-vs-rest and many-vs-many categorical splits, max_depth,
  basic monotone constraints and a multiclass class's gradients; the
  one-kernel split on categorical data (now routed on the device) too;
- (b) the loop reads nothing back to the host on any layout: with the
  tensor-to-host conversions patched to raise it still grows the tree;
- (c) the categorical row router (``route_rows`` with a categorical table)
  equals the port's round-by-round router and the JAX package's
  ``assign_leaves`` on the same log;
- (d) the chain's static-plan launches (sized for the root) give the
  per-split path's bytes and sums on a deep segment, and a dead header
  moves nothing;
- (e) fused training through the device loop against the JAX package's
  fused path for int8, categorical and EFB data;
- (f) the recorded reasons and launch counts (ROADMAP C1-C3).

Tolerances: (a)-(d) are exact (integer outputs equal, float outputs
bit-equal: the twins sum in float64 and zeros leave those sums as they
are); (e) as ``test_torch_fused.py``, ``TRAIN_RTOL`` / ``TRAIN_ATOL`` on
leaf values and predictions, structure equal.
"""
import numpy as np
import pytest
import torch

from torch_port_cases import (CPU, TRAIN_ATOL, TRAIN_CASES, TRAIN_RTOL,
                              assert_same_trees, jax_dataset,
                              make_train_data, train_params)

import jax.numpy as jnp
import lightgbm_tpu as lgb
from lightgbm_tpu import learner as jax_learner

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import learner as L
from lightgbm_tpu_torch.obs import telemetry
from lightgbm_tpu_torch.ops import histogram as H
from lightgbm_tpu_torch.ops import partition as P
from lightgbm_tpu_torch.ops import route as R
from lightgbm_tpu_torch.ops.chain import ChainSplit
from lightgbm_tpu_torch.prng import PRNGKey


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: the loop's twins run many small ops, which
    OpenMP threads of several test workers sharing the host's cores slow
    down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _learner(case, extra, n=1500, seed=0, klass=0):
    """A CPU learner on ``case``'s data and one tree's (grad, hess, inbag)
    channels (a fifth of the rows out of bag; class ``klass`` of a
    multiclass objective)."""
    spec = TRAIN_CASES[case]
    rng = np.random.RandomState(seed)
    X, y, cats = make_train_data(rng, n, objective=spec["objective"],
                                 cat=spec.get("cat", False),
                                 nan=spec.get("nan", False),
                                 efb=spec.get("efb", False))
    p = dict(train_params(case), **CPU, **extra)
    bst = lgt.Booster(p, lgt.Dataset(X, label=y, categorical_feature=cats,
                                     params=p))
    g = bst.inner
    grad, hess = g.objective.get_gradients(g.train_score.score)
    if grad.dim() > 1:
        grad, hess = grad[:, klass], hess[:, klass]
    inbag = (torch.as_tensor(rng.rand(n)) < 0.8).to(torch.float32)
    return g.learner, torch.stack([grad * inbag, hess * inbag, inbag], dim=1)


def _assert_same(got, want):
    for fld in got._fields:
        assert torch.equal(getattr(got, fld), getattr(want, fld)), fld


#: the data seed whose first tree splits on the categorical feature, one
#: vs rest and many vs many
CAT_SEED = 5
#: (training case, params): every configuration of the partitioned builder
CHAIN_CASES = {
    "planes": ("binary", {}),
    "resident": ("nan_missing", {"tpu_resident_state": "on"}),
    "rows_hilo": ("binary", {"tpu_work_layout": "rows"}),
    "rows_bf16": ("regression", {"tpu_work_layout": "rows",
                                 "tpu_hist_precision": "bf16"}),
    "efb": ("efb", {}),
    "cat_onehot": ("categorical", {}),
    "cat_mvm": ("categorical", {"max_cat_to_onehot": 2,
                                "min_data_per_group": 20,
                                "cat_smooth": 1.0}),
    "max_depth": ("binary", {"max_depth": 3}),
    "monotone": ("binary", {"monotone_constraints": [1, -1, 0, 0, 1, 0, 0,
                                                     0],
                            "monotone_penalty": 1.5}),
    "multiclass": ("multiclass", {}),
}


@pytest.mark.parametrize("name", sorted(CHAIN_CASES))
def test_chain_loop_equals_host_loop(name):
    case, extra = CHAIN_CASES[name]
    lrn, ghc = _learner(case, extra, klass=1,
                        seed=CAT_SEED if name.startswith("cat") else 0)
    fmask = torch.ones(lrn.dataset.num_features, dtype=torch.bool)
    fmask[5] = False
    kinds = set()
    for scale in (1.0, 0.5):         # two trees through one loop
        want = lrn.train(ghc * scale, fmask)
        want_stats = dict(lrn.last_stats)
        got = lrn.train_device(ghc * scale, fmask)
        _assert_same(got, want)
        for k in ("leaf_cnt", "hist_cnt"):
            assert torch.equal(lrn.last_stats[k], want_stats[k]), k
        assert int(want.num_splits[0]) > 3
        kinds |= set(want.kind[:int(want.num_splits[0])].tolist())
    assert isinstance(lrn._loop.split, ChainSplit)
    if name == "efb":
        assert lrn.bundle is not None and lrn.bins.shape[1] < \
            lrn.dataset.num_features
    if name == "cat_onehot":
        assert 1 in kinds
    if name == "cat_mvm":
        assert {2, 3} <= kinds
    if name == "max_depth":
        assert int(want.num_splits[0]) <= 7


def test_one_kernel_loop_on_categorical_data():
    """The one-kernel split's device loop now takes categorical data: its
    trees route through the categorical router."""
    lrn, ghc = _learner("categorical", {"tpu_split_kernel": "on"},
                        seed=CAT_SEED)
    assert lrn._kw["split_kernel"] == "on"
    want = lrn.train(ghc)
    got = lrn.train_device(ghc)
    _assert_same(got, want)
    assert 1 in set(want.kind.tolist())


def test_chain_int8_two_keys():
    """int8 quantized gradients through one loop, two keys in turn: each
    tree equals the host loop's with the same key (the dither is drawn from
    the key's words in the loop's static buffer, not from a frozen key),
    and the two keys grow different trees."""
    lrn, ghc = _learner("binary", {"use_quantized_grad": True})
    assert lrn._kw["hist_mode"] == "int8" and \
        lrn._kw["work_layout"] == "rows"
    logs = []
    for key in (PRNGKey(3), PRNGKey(11), PRNGKey(3)):
        want = lrn.train(ghc, None, key)
        got = lrn.train_device(ghc, None, key)
        _assert_same(got, want)
        logs.append(got)
    assert not torch.equal(logs[0].leaf_value, logs[1].leaf_value)
    _assert_same(logs[0], logs[2])


@pytest.mark.parametrize("name", ["planes", "resident", "rows_hilo",
                                  "int8", "efb", "cat_mvm"])
def test_chain_makes_no_host_read(monkeypatch, name):
    case, extra = CHAIN_CASES.get(name, ("binary",
                                         {"use_quantized_grad": True}))
    lrn, ghc = _learner(case, extra)
    want = lrn.train(ghc, None, PRNGKey(5))
    lrn.train_device(ghc, None, PRNGKey(5))       # builds the loop
    fmask = torch.ones(lrn.dataset.num_features, dtype=torch.bool)

    def refuse(*_args, **_kwargs):
        raise AssertionError("a host read inside the device tree loop")

    for attr in ("item", "tolist", "__bool__", "__int__", "__float__",
                 "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, attr, refuse)
    with pytest.raises(AssertionError, match="host read"):
        bool(ghc[0, 0] > 0)
    got = lrn._loop.run(ghc, fmask, PRNGKey(5))
    monkeypatch.undo()
    assert int(got.num_splits[0]) == int(want.num_splits[0]) > 1
    _assert_same(got, want._replace(row_leaf=got.row_leaf))
    assert torch.equal(got.row_leaf, want.row_leaf)


# ------------------------------------------------------------------- (c)

def _jax_log(log):
    fields = {k: jnp.asarray(getattr(log, k).numpy())
              for k in jax_learner.TreeLog._fields}
    fields["num_splits"] = jnp.asarray(int(log.num_splits[0]), jnp.int32)
    return jax_learner.TreeLog(**fields)


@pytest.mark.parametrize("name", ["cat_onehot", "cat_mvm"])
def test_categorical_router_equals_plain_and_jax(name):
    case, extra = CHAIN_CASES[name]
    lrn, ghc = _learner(case, extra, seed=CAT_SEED)
    log = lrn.train(ghc)
    assert int((log.kind > 0).sum()) > 0
    got = L.assign_leaves(lrn.bins, log, has_categorical=True,
                          bins_t=lrn.bins_t)
    plain = L.assign_leaves_plain(lrn.bins, log, has_categorical=True)
    ref = jax_learner.assign_leaves(jnp.asarray(lrn.bins.numpy()),
                                    _jax_log(log), has_categorical=True)
    assert torch.equal(got, plain)
    assert torch.equal(got, log.row_leaf)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_categorical_router_random_tables():
    """Random trees whose rounds are half categorical (random go-left
    sets over 64 bins) and half numerical: the router's twin with the
    categorical table equals the round-by-round router."""
    rng = np.random.RandomState(4)
    n, F, B, rounds = 3000, 5, 64, 40
    bins = torch.as_tensor(rng.randint(0, B, (n, F)).astype(np.uint8))
    kind = torch.as_tensor((rng.rand(rounds) < 0.5).astype(np.int32))
    go = torch.as_tensor(rng.rand(rounds, B) < 0.5)
    log = L.TreeLog(
        num_splits=torch.tensor([rounds - 3], dtype=torch.int32),
        split_leaf=torch.as_tensor([rng.randint(0, r + 1)
                                    for r in range(rounds)]).to(torch.int32),
        feature=torch.as_tensor(rng.randint(0, F, rounds)).to(torch.int32),
        bin=torch.as_tensor(rng.randint(0, B, rounds)).to(torch.int32),
        kind=kind, default_left=torch.as_tensor(rng.rand(rounds) < 0.5),
        gain=torch.zeros(rounds), left_sum=torch.zeros(rounds, 3),
        right_sum=torch.zeros(rounds, 3), go_left=go,
        miss_bin=torch.as_tensor(rng.randint(0, B, rounds)).to(torch.int32),
        movable=torch.as_tensor(rng.rand(rounds) < 0.3),
        leaf_value=torch.zeros(rounds + 1),
        leaf_sum=torch.zeros(rounds + 1, 3),
        row_leaf=torch.zeros(0, dtype=torch.int32))
    got = L.assign_leaves(bins, log, has_categorical=True)
    assert torch.equal(got, L.assign_leaves_plain(bins, log, True))
    cat = R.build_cat_table(log)
    assert cat.shape == (rounds * R.CAT_W,)
    is_cat, sets = R.cat_go_table(cat, rounds)
    assert torch.equal(is_cat, kind > 0)
    assert torch.equal(sets[:, :B], go) and not sets[:, B:].any()
    assert R.route_table_bytes(254, True) == 64 * 254 + 4 * 256
    assert R.route_table_bytes(R.ROUTE_MAX_ROUNDS_CAT, True) \
        <= R.ROUTE_SMEM_BYTES < R.route_table_bytes(
            R.ROUTE_MAX_ROUNDS_CAT + 1, True)


# ------------------------------------------------------------------- (d)

def _hdr(seg, ls, live):
    return torch.tensor(list(seg) + [ls, 1, live, 0], dtype=torch.int32)


@pytest.mark.parametrize("layout", ["planes", "rows", "int8", "resident"])
def test_static_plan_twins(layout):
    """The chain's launches on a split header, planned for the root (a
    cnt_max far above the segment), against the per-split twins on the
    host's segment: the same bytes, lt and histogram bits; a dead header
    leaves the buffer and lt and gives a zero histogram."""
    rng = np.random.RandomState(7)
    n, nb, F = 2500, 32, 6
    bins = torch.as_tensor(rng.randint(0, nb, (n, F)).astype(np.uint8))
    ghc = torch.as_tensor(np.stack([rng.randn(n), np.abs(rng.randn(n)),
                                    (rng.rand(n) < 0.8) * 1.0], axis=1)
                          .astype(np.float32))
    quantized = layout == "int8"
    wl = "rows" if quantized else layout
    work = P.work_buffer(n, F, wl, quantized, "cpu")
    scale = resident = None
    if quantized:
        scales = P.quantize_scales(ghc)
        scale = H.dequant_scale(scales)
        work[0, 128:128 + n] = P.pack_rows_quantized(bins, ghc, PRNGKey(1),
                                                     scales)
    elif layout == "rows":
        work[0, 128:128 + n] = P.pack_rows(bins, ghc)
    elif layout == "resident":
        resident = L.route_layout(bins).reshape(F, -1)
        work[0, :, 128:128 + n] = P.pack_resident(torch.arange(n), ghc)
    else:
        work[0, :, 128:128 + n] = P.pack_planes(bins, ghc)
    table = torch.as_tensor(rng.rand(nb) < 0.4)
    seg = [0, 128 + 37, 1801, 4]
    for ls, live in ((1, 1), (0, 1), (1, 0)):
        a, b = work.clone(), work.clone()
        hdr = _hdr(seg, ls, live)
        lt = torch.full((1,), -7, dtype=torch.int32)
        if resident is not None:
            P.RouteGather(a, resident, cnt_max=10 ** 6)(hdr)
        P.SegmentPartition(a, layout=wl, cnt_max=10 ** 6)(hdr, table, lt)
        small = H.SegmentHistogram(
            a, layout=layout, num_bins=nb, num_feat=F, cnt_max=10 ** 6,
            resident=resident, scale=scale)(hdr, lt)
        if not live:
            assert torch.equal(a, work) and int(lt) == -7
            assert not bool(small.any())
            continue
        sg = torch.tensor(seg, dtype=torch.int32)
        if resident is not None:
            P.write_route_plane(b, resident, sg, seg[2])
            lt_b = P.partition_segment(b, P.on_route_plane(sg), table, seg[2])
        elif wl == "rows":
            lt_b = P.partition_segment_rows(b, sg, table, seg[2])
        else:
            lt_b = P.partition_segment(b, sg, table, seg[2])
        k = int(lt_b)
        hs = torch.tensor([1, seg[1], k] if ls
                          else [1, seg[1] + k, seg[2] - k], dtype=torch.int32)
        kw = dict(num_bins=nb, num_feat=F, cnt_bound=10 ** 6)
        if quantized:
            want = H.segment_histogram_q(b, hs, scale, **kw)
        elif layout == "resident":
            want = H.segment_histogram_resident(b, resident, hs, **kw)
        elif layout == "rows":
            want = H.segment_histogram_rows(b, hs, **kw)
        else:
            want = H.segment_histogram(b, hs, **kw)
        assert int(lt) == k and torch.equal(a, b)
        assert torch.equal(small.view(torch.int32), want.view(torch.int32))


# ------------------------------------------------------------------- (e)

@pytest.mark.parametrize("name,extra", [("binary",
                                         {"use_quantized_grad": True}),
                                        ("categorical", {}), ("efb", {})])
def test_device_loop_fused_equals_jax_fused(tmp_path, name, extra):
    """The port's fused blocks through the device tree loop (as on the
    card; the CPU trainer takes the host loop unless told) against the
    JAX package's fused path on the same npz: same trees, leaf values and
    predictions within TRAIN_RTOL / TRAIN_ATOL."""
    from lightgbm_tpu_torch.fused import FusedTrainer
    ds, path, X, _, _ = jax_dataset(name, tmp_path, n=1000, seed=2)
    params = dict(train_params(name), **extra)
    jb = lgb.train(dict(params), ds, 4)
    assert jb.inner._fused is not None
    pb = lgt.Booster(dict(params, **CPU),
                     lgt.dataset_from_reference(path, CPU))
    pb.inner._fused = FusedTrainer(pb.inner)
    pb.inner._fused.device_loop = True
    pb.inner.train_block(4)
    pb.inner.finish_fused("test")
    assert isinstance(pb.inner.learner._loop.split, ChainSplit)
    assert pb.current_iteration == jb.current_iteration == 4
    assert_same_trees(jb.inner.models, pb.inner.models)
    np.testing.assert_allclose(pb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True),
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)


# ------------------------------------------------------------------- (f)

def test_rows_partition_source_recorded():
    """ROADMAP C1: the rows partition's kernel lives in
    csrc/partition_rows.cu."""
    part, hist = L.kernel_sources("rows", False)
    assert part == "csrc/partition_rows.cu (partition_segment_rows)"
    assert hist == "csrc/segment_histogram.cu (segment_histogram_rows)"
    assert L.kernel_sources("rows", True)[1] == \
        "csrc/segment_histogram_q.cu"
    assert L.kernel_sources("planes", False)[0] == \
        "csrc/partition_segment.cu (partition_segment)"
    assert L.kernel_sources("resident", False)[0].startswith(
        "csrc/resident_route.cu, then csrc/partition_segment.cu")


def test_resident_auto_reason():
    """ROADMAP C2: on the card the resident auto resolution records what
    PR 10 measured and why it stays off."""
    lrn, _ = _learner("binary", {})
    got = []
    layout = lrn._resolve_resident("planes", True,
                                   lambda *a: got.append(a))
    assert layout == "planes"
    (knob, value, why), = got
    assert (knob, value) == ("tpu_resident_state", "off")
    assert "5.1%" in why and "8.8%" in why and "A1" in why
    assert "host loop sets the pace" not in why


@pytest.mark.parametrize("split_kernel,want", [("on", 2), ("off", 4)])
def test_launches_per_split_counts(split_kernel, want):
    """ROADMAP C3: the device tree loop's launches a split slot (the
    one-kernel split and the commit; K3, K4, the split scan and the
    commit), in ``traffic_spec`` and the gauge of a fused run through the
    loop; the per-split host loop's in the per-iteration gauge; the
    ``learner/*`` counters equal either way."""
    from lightgbm_tpu_torch.fused import FusedTrainer
    assert L.launches_per_split("resident", False) == 5
    assert L.launches_per_split("resident", False, device_loop=False) == 4
    assert L.launches_per_split("rows", False) == 4
    assert L.launches_per_split("planes", True, device_loop=False) == 1
    lrn, _ = _learner("binary", {"tpu_split_kernel": split_kernel})
    spec = lrn.traffic_spec()
    assert spec["launches_per_split"] == want
    assert spec["launches_per_split_host_loop"] == want // 2 + (
        1 if want == 4 else 0)
    spec_host = spec["launches_per_split_host_loop"]
    rng = np.random.RandomState(3)
    X, y, _ = make_train_data(rng, 900)
    p = dict(train_params("binary"), **CPU, tpu_split_kernel=split_kernel,
             tpu_iter_block=3)
    telemetry.reset()
    lgt.train(dict(p), lgt.Dataset(X, label=y, params=p), 3,
              callbacks=[lambda env: None])
    counters = {k: v for k, v in telemetry.snapshot()["counters"].items()
                if k.startswith("learner/")}
    assert telemetry.snapshot()["gauges"]["learner/launches_per_split"] \
        == spec_host
    telemetry.reset()
    bst = lgt.Booster(dict(p), lgt.Dataset(X, label=y, params=p))
    bst.inner._fused = FusedTrainer(bst.inner)
    bst.inner._fused.device_loop = True
    bst.inner.train_block(3)
    bst.inner.finish_fused("test")
    snap = telemetry.snapshot()
    assert snap["gauges"]["learner/launches_per_split"] == want
    assert {k: v for k, v in snap["counters"].items()
            if k.startswith("learner/")} == counters
