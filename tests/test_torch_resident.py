"""The resident layout of the PyTorch port (``tpu_resident_state=on``) on
the CPU, against the JAX package: the pack and its root histogram, the
route gather and the gather histogram (the plain twins of
``csrc/resident_route.cu`` and ``segment_histogram_resident``) against
``pack_resident_fold_root``, ``write_route_plane`` and
``hist16_segment_resident``; one tree of the port's resident layout
against the JAX package's resident tree; the one-kernel split's resident
mode against the JAX package's under the Pallas interpreter; the port's
resident model strings byte-equal to its planes ones in both split modes;
the knob's errors and ``auto`` records, ``traffic_spec``, ``resident_spec``
and the launch telemetry.

The port's ridx is the original row index (the JAX package stores
``guard + i`` in planes with guard lanes), so the tests hand each package
its own resident planes and compare what the ridx point at, not the ridx
bytes. Histogram bars are tests/test_torch_histogram.py's: counts equal,
g/h within 2^-18 of the bin's sum of |x| (the f32 sums run in another
order); the port's resident and planes twins agree bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_cases import (CPU, TRAIN_CASES, assert_same_trees, grid,
                              make_train_data, one_kernel_tree_data,
                              one_torch_thread, train_params)

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import construct_dataset as jax_construct
from lightgbm_tpu.learner import SerialTreeLearner as JLearner
from lightgbm_tpu.ops import partition as JP
from lightgbm_tpu.ops.histogram import hist16_segment_resident

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.dataset import construct_dataset
from lightgbm_tpu_torch.learner import SerialTreeLearner
from lightgbm_tpu_torch.obs import telemetry
from lightgbm_tpu_torch.ops import histogram as PH
from lightgbm_tpu_torch.ops import partition as PP
from lightgbm_tpu_torch.ops import split as PS
from lightgbm_tpu_torch.utils.log import LightGBMError


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """Every test here runs the port on the host: one torch thread
    (torch_port_cases.one_torch_thread)."""


CH = 256
JG = JP.guard_rows(CH)         # the JAX buffers' guard lanes
G = PP.GUARD                   # the port's
N, F, NB = 1500, 7, 32


def _rows(seed, n=N, f=F, nb=NB):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, nb, (n, f)).astype(np.uint8)
    ghc = np.stack([rng.randn(n) * 3, np.abs(rng.randn(n)) + 0.01,
                    np.ones(n)], axis=1).astype(np.float32)
    return rng, bins, ghc


def _near(bins, ghc, rel=2.0 ** -18):
    absum = PH.build_histogram_np(bins, np.abs(ghc).astype(np.float64), NB)
    return rel * absum.astype(np.float64) + 1e-12


def _slim_pair(rows, ghc, jax_side):
    """Slim pairs holding ``rows`` (indices into the binned matrix) in
    order at the guard: the JAX one with its absolute-lane ridx (and the
    lane count of its resident planes, which its decoder clamps to), the
    port's with the row index itself. Buffer 1 and the other lanes hold
    junk (stale bytes)."""
    m = len(rows)
    rng = np.random.RandomState(m)
    if jax_side:
        npad = JP.planes_npad(N, JG, "xla")
        work = rng.randint(0, 256, (2, JP.RST_WIDTH, npad)).astype(np.uint8)
        pos = jnp.asarray(JG + rows, jnp.int32)
        gb = np.asarray(ghc, np.float32).view(np.uint8).reshape(m, 12).T
        work[0, :, JG:JG + m] = np.concatenate(
            [np.zeros((1, m), np.uint8), np.asarray(JP._encode_ridx(pos)),
             gb])
        return jnp.asarray(work)
    npad = PP.planes_npad(m)
    work = torch.as_tensor(rng.randint(0, 256, (2, PP.RST_WIDTH, npad))
                           .astype(np.uint8))
    work[0, :, G:G + m] = PP.pack_resident(torch.as_tensor(rows),
                                           torch.as_tensor(ghc))
    return work


# -------------------------------------------------------------- op level

def test_pack_resident_fold_root_matches_jax():
    _, bins, ghc = _rows(1)
    jnpad = JP.planes_npad(N, JG, "xla")
    jres = JP.resident_bin_planes(jnp.asarray(bins), JG, jnpad)
    jwork = jnp.zeros((2, JP.RST_WIDTH, jnpad), jnp.uint8)
    jwork, jroot = JP.pack_resident_fold_root(
        jwork, jnp.asarray(bins), jnp.asarray(ghc), JG, num_bins=NB,
        exact=True, chunk=CH)
    b, g = torch.as_tensor(bins), torch.as_tensor(ghc)
    res = PP.resident_bin_planes(b)
    work = PP.work_buffer(N, F, "resident", False, torch.device("cpu"))
    assert work.shape == (2, PP.RST_WIDTH, PP.planes_npad(N))
    root = PP.pack_resident_fold_root(work, res, g, G, num_bins=NB,
                                      num_feat=F, exact=True).numpy()
    jroot = np.asarray(jroot)
    assert np.array_equal(root[..., 2], jroot[..., 2])
    assert (np.abs(root - jroot) <= _near(bins, ghc)).all()
    # the planes pack's root, bit for bit
    pwork = PP.work_buffer(N, F, "planes", False, torch.device("cpu"))
    proot = PP.pack_planes_fold_root(pwork, b, g, G, num_bins=NB,
                                     exact=True).numpy()
    assert np.array_equal(root.view(np.uint32), proot.view(np.uint32))
    # the g/h/cnt planes are the JAX pack's; ridx is the row index
    w = work.numpy()
    assert np.array_equal(w[0, PP.RST_GH_OFF:, G:G + N],
                          np.asarray(jwork)[0, JP.RST_GH_OFF:, JG:JG + N])
    ridx = PP.decode_ridx(work[0, PP.RST_ROUTE:PP.RST_GH_OFF, G:G + N],
                          res.shape[1])
    assert torch.equal(ridx, torch.arange(N))
    assert np.array_equal(res.numpy()[:, :N], bins.T)


@pytest.mark.parametrize("start,cnt,feat", [(0, 1000, 3), (137, 700, 0),
                                            (513, 1, 6), (200, 0, 2)])
def test_write_route_plane_matches_jax(start, cnt, feat):
    """A sparse ascending segment (a deep leaf's rows): the port's route
    bytes equal the JAX package's; nothing else is written."""
    rng, bins, ghc = _rows(2)
    rows = np.sort(rng.choice(N, 1000, replace=False))
    jres = JP.resident_bin_planes(jnp.asarray(bins), JG,
                                  JP.planes_npad(N, JG, "xla"))
    jw = JP.write_route_plane(_slim_pair(rows, ghc[rows], True), jres,
                              jnp.int32(0), jnp.int32(JG + start),
                              jnp.int32(cnt), jnp.int32(feat), ch=CH)
    work = _slim_pair(rows, ghc[rows], False)
    before = work.clone()
    res = PP.resident_bin_planes(torch.as_tensor(bins))
    seg = torch.tensor([0, G + start, cnt, feat], dtype=torch.int32)
    PP.write_route_plane(work, res, seg, max(cnt, 1))
    got = work.numpy()[0, 0, G + start:G + start + cnt]
    want = np.asarray(jw)[0, 0, JG + start:JG + start + cnt]
    assert np.array_equal(got, want)
    assert np.array_equal(got, bins[rows[start:start + cnt], feat])
    before[0, 0, G + start:G + start + cnt] = torch.as_tensor(got)
    assert torch.equal(work, before)


@pytest.mark.parametrize("exact,start,cnt", [
    (True, 0, 1000), (True, 137, 700), (True, 333, 1), (False, 57, 900),
    (False, 900, 0)])
def test_segment_histogram_resident_matches_jax(exact, start, cnt):
    rng, bins, ghc = _rows(3)
    rows = np.sort(rng.choice(N, 1000, replace=False))
    jres = JP.resident_bin_planes(jnp.asarray(bins), JG,
                                  JP.planes_npad(N, JG, "xla"))
    want = np.asarray(hist16_segment_resident(
        _slim_pair(rows, ghc[rows], True), jres, jnp.int32(0),
        jnp.int32(JG + start), jnp.int32(cnt), num_bins=NB, num_feat=F,
        exact=exact, chunk=CH))
    work = _slim_pair(rows, ghc[rows], False)
    res = PP.resident_bin_planes(torch.as_tensor(bins))
    seg = torch.tensor([0, G + start, cnt], dtype=torch.int32)
    got = PH.segment_histogram_resident(work, res, seg, num_bins=NB,
                                        num_feat=F, exact=exact,
                                        cnt_bound=cnt).numpy()
    sel = rows[start:start + cnt]
    assert np.array_equal(got[..., 2], want[..., 2])
    assert (np.abs(got - want) <= _near(bins[sel], ghc[sel])).all()
    # the planes twin on the same rows in the same order, bit for bit
    pwork = torch.zeros((2, F + 12, PP.planes_npad(1000)), dtype=torch.uint8)
    pwork[0, :, G:G + 1000] = PP.pack_planes(torch.as_tensor(bins[rows]),
                                             torch.as_tensor(ghc[rows]))
    planes = PH.segment_histogram(pwork, seg, num_bins=NB, num_feat=F,
                                  exact=exact, cnt_bound=cnt).numpy()
    assert np.array_equal(got.view(np.uint32), planes.view(np.uint32))


def test_decode_ridx_clamps_stale_lanes():
    """Stale bytes decode as the JAX package's i32 does (a top byte >= 128
    is negative) and clamp into the planes."""
    pos = torch.tensor([0, 5, 2 ** 24 + 3, 2 ** 31 - 1, 2 ** 32 - 7])
    got = PP.decode_ridx(PP.encode_ridx(pos), 1000)
    want = JP._decode_ridx(JP._encode_ridx(jnp.asarray(
        pos.numpy().astype(np.uint32).view(np.int32))), 1000)
    assert got.tolist() == np.asarray(want).tolist() == [0, 5, 999, 999, 0]


def test_one_kernel_resident_twin_equals_planes_twin():
    """The one-kernel split's resident twin against its planes twin on the
    same rows (a sparse ascending third of the resident planes): lt, the
    routed g/h/cnt bytes and the rows the routed ridx point at, the child
    histograms and every SplitInfo field, bit for bit."""
    import chip_smoke

    rng = np.random.RandomState(4)
    case = chip_smoke.split_case("categorical_mvm", rng, n=2000)
    work, seg, table, kw = chip_smoke.split_inputs(torch.device("cpu"), case)
    bins_all, res, rows = chip_smoke.seeded_resident(rng, case[0],
                                                     torch.device("cpu"))
    slim, _ = chip_smoke.resident_pair(torch.device("cpu"), bins_all, res,
                                       rows, torch.as_tensor(case[1]), rng)
    sg = torch.tensor(seg, dtype=torch.int32)
    a = PP.one_kernel_split_planes(slim, sg, table, cnt_bound=seg[2],
                                   resident=res, **kw)
    b = PP.one_kernel_split_planes(work, sg, table, cnt_bound=seg[2], **kw)
    assert int(a[0]) == int(b[0])
    for x, y in zip(a[1:3], b[1:3]):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    for fld in a[3]._fields:
        assert torch.equal(getattr(a[3], fld), getattr(b[3], fld)), fld
    s = slice(seg[1], seg[1] + seg[2])
    ridx = PP.decode_ridx(slim[1, PP.RST_ROUTE:PP.RST_GH_OFF, s],
                          res.shape[1])
    assert torch.equal(res[:, ridx], work[1, :case[0].shape[1], s])
    assert torch.equal(slim[1, PP.RST_GH_OFF:, s],
                       work[1, case[0].shape[1]:, s])


def test_resident_validations():
    res = torch.zeros((6, 256), dtype=torch.uint8)
    seg = torch.tensor([0, 128, 10, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="slim pair"):
        PP.write_route_plane(torch.zeros((2, 18, 384), dtype=torch.uint8),
                             res, seg, 10)
    slim = torch.zeros((2, PP.RST_WIDTH, 384), dtype=torch.uint8)
    with pytest.raises(ValueError, match="resident must be"):
        PP.write_route_plane(slim, res.to(torch.int32), seg, 10)
    with pytest.raises(ValueError):
        PH.segment_histogram_resident(slim, res, seg[:3], num_bins=16,
                                      num_feat=7, cnt_bound=10)
    meta = PS.FeatureMeta(
        num_bins=torch.full((6,), 16, dtype=torch.int32),
        movable_missing=torch.zeros(6, dtype=torch.bool),
        missing_bin=torch.zeros(6, dtype=torch.int32),
        is_categorical=torch.zeros(6, dtype=torch.bool),
        monotone=torch.zeros(6, dtype=torch.int8), penalty=torch.ones(6),
        cegb_coupled=torch.zeros(6))
    with pytest.raises(ValueError, match="resident has 5 planes"):
        PP.OneKernelSplit(slim, meta, torch.ones(6, dtype=torch.bool),
                          PS.SplitHyper(), num_bins=16, num_feat=6,
                          cnt_max=10, resident=res[:5])


# ------------------------------------------------------------ tree level

def test_one_tree_resident_equals_jax():
    """One 255-leaf tree on the resident layout in both packages from the
    same (grad, hess, inbag) channels: every split and every row's leaf
    equal, floats within rtol 1e-5 (test_torch_train's one-tree bars)."""
    n, f, leaves = 2999, 28, 255
    rng = np.random.RandomState(0)
    X = np.round(rng.randn(n, f) * 16) / 64.0
    y = (X @ rng.randn(f) > 0).astype(np.float64)
    g = np.round(rng.randn(n) * 16) / 64
    h = (np.round(np.abs(rng.randn(n)) * 16) + 6) / 64
    ghc = np.stack([g, h, np.ones(n)], axis=1).astype(np.float32)
    p = {"objective": "binary", "num_leaves": leaves, "max_bin": 63,
         "min_data_in_leaf": 2, "min_gain_to_split": 1e-3, "verbosity": -1,
         "tpu_resident_state": "on"}
    jcfg = JConfig.from_params(dict(p, tree_builder="partition",
                                    tpu_work_layout="planes"))
    jds = jax_construct(X, jcfg, label=y)
    jl = JLearner(jcfg, jds)
    assert jl.build_kwargs()["work_layout"] == "resident"
    a = jax.device_get(jl.train(jnp.asarray(ghc),
                                jnp.ones(jds.num_features, bool),
                                jax.random.PRNGKey(0)))
    pcfg = Config.from_params(dict(p, device_type="cpu"))
    lrn = SerialTreeLearner(pcfg, construct_dataset(X, pcfg, label=y))
    assert lrn.build_kwargs()["work_layout"] == "resident"
    b = lrn.train(torch.as_tensor(ghc))
    ns = int(a.num_splits)
    assert ns == int(b.num_splits[0]) > 100
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
    cnt = lrn.last_stats["leaf_cnt"][:ns + 1]
    assert torch.equal(cnt, torch.bincount(b.row_leaf, minlength=ns + 1)
                       .to(torch.int32))


def test_one_kernel_resident_equals_jax(tmp_path, monkeypatch):
    """tests/test_one_kernel.py's resident shape (1101 rows, 16 features,
    7 leaves): both packages with tpu_split_kernel=on and
    tpu_resident_state=on, the JAX one-kernel split under the Pallas
    interpreter."""
    from torch_port_cases import JAX_ONE_KERNEL

    monkeypatch.setattr(JP, "_INTERPRET", True)
    X, y = one_kernel_tree_data(np.random.RandomState(0), n=1101, f=16)
    params = dict(JAX_ONE_KERNEL, objective="binary", num_leaves=7,
                  verbosity=-1, min_gain_to_split=1e-3,
                  tpu_split_kernel="on", tpu_resident_state="on")
    ds = lgb.Dataset(X, label=y)
    ds.construct(params)
    path = str(tmp_path / "resident.npz")
    ds.save_binary(path)
    jb = lgb.train(dict(params), ds, 2)
    assert jb.inner.learner.build_kwargs()["work_layout"] == "resident"
    pb = lgt.train(dict(params, **CPU), lgt.dataset_from_reference(path, CPU),
                   2)
    kw = pb.inner.learner._kw
    assert kw["work_layout"] == "resident" and kw["split_kernel"] == "on"
    assert all(t.num_leaves == 7 for t in pb.inner.models)
    assert_same_trees(jb.inner.models, pb.inner.models)


@pytest.mark.parametrize("split_kernel", ["off", "on"])
@pytest.mark.parametrize("name", ["binary", "multiclass", "nan_missing",
                                  "categorical", "efb"])
def test_resident_model_string_equals_planes(name, split_kernel):
    """The resident layout grows the planes layout's trees bit for bit:
    byte-equal model strings in both split modes (EFB: the one-kernel
    split is ineligible and both layouts train three launches)."""
    spec = TRAIN_CASES[name]
    X, y, cats = make_train_data(
        np.random.RandomState(6), 1200, objective=spec["objective"],
        cat=spec.get("cat", False), nan=spec.get("nan", False),
        efb=spec.get("efb", False))
    models = {}
    for rs in ("off", "on"):
        p = dict(train_params(name), tpu_resident_state=rs,
                 tpu_split_kernel=split_kernel, **CPU)
        bst = lgt.train(p, lgt.Dataset(X, label=y, categorical_feature=cats,
                                       params=p), 3)
        kw = bst.inner.learner._kw
        assert kw["work_layout"] == ("resident" if rs == "on" else "planes")
        models[rs] = bst.model_to_string()
    assert models["on"] == models["off"]
    if name == "efb":
        assert bst.inner.train_set.has_bundles


# --------------------------------------------------- resolution and gates

def _booster(wide=False, **extra):
    rng = np.random.RandomState(5)
    if wide:            # the HIGGS width
        X = grid(rng, 400, 28)
        y = (X @ rng.randn(28) > 0).astype(np.float64)
    else:
        X, y, _ = make_train_data(rng, 400)
    p = dict(objective="binary", verbosity=-1, num_leaves=7, **CPU, **extra)
    return lgt.Booster(p, lgt.Dataset(X, label=y, params=p))


@pytest.mark.parametrize("extra,words", [
    ({"tpu_work_layout": "rows"}, "requires the planes work layout"),
    ({"use_quantized_grad": True}, "does not support int8"),
    ({"tpu_hist_precision": "int8"}, "does not support int8"),
    ({"tpu_hist_mxu": "on"}, "tpu_hist_mxu=on needs the rows"),
])
def test_resident_on_refuses(extra, words):
    with pytest.raises(LightGBMError, match=words):
        _booster(tpu_resident_state="on", **extra)


def test_resident_auto_records():
    """``auto`` resolves to off, on the host and on the card, with its
    reason; ``on`` resolves without a record."""
    telemetry.reset()
    bst = _booster()
    assert bst.inner.learner._kw["work_layout"] == "planes"
    recs = [r for r in telemetry.records("auto_resolution")
            if r["knob"] == "tpu_resident_state"]
    assert [r["value"] for r in recs] == ["off"]
    assert "host" in recs[0]["reason"]
    lrn = bst.inner.learner
    lrn.device = torch.device("cuda")
    assert lrn.build_kwargs()["work_layout"] == "planes"
    recs = [r for r in telemetry.records("auto_resolution")
            if r["knob"] == "tpu_resident_state"]
    assert [r["value"] for r in recs] == ["off", "off"]
    assert "PERF.md" in recs[1]["reason"]
    lrn.config.tpu_work_layout = "rows"
    lrn.build_kwargs()
    recs = [r for r in telemetry.records("auto_resolution")
            if r["knob"] == "tpu_resident_state"]
    assert "layout rows" in recs[-1]["reason"]
    telemetry.reset()
    on = _booster(tpu_resident_state="on")
    assert on.inner.learner._kw["work_layout"] == "resident"
    assert not [r for r in telemetry.records("auto_resolution")
                if r["knob"] == "tpu_resident_state"]


def test_traffic_spec_resident():
    """At the HIGGS width (F = 28) the resident partition moves half the
    planes partition's bytes per row: 2 x 17 + the route gather's 6
    against 2 x 40; its histogram reads the slim row and 28 gathered
    bins; the route gather is one launch more per split (the device tree
    loop also commits every split)."""
    planes = _booster(wide=True).inner.learner
    off = _booster(wide=True, tpu_resident_state="on",
                   tpu_split_kernel="off").inner.learner
    on = _booster(wide=True, tpu_resident_state="on",
                  tpu_split_kernel="on").inner.learner
    p, r, k = planes.traffic_spec(), off.traffic_spec(), on.traffic_spec()
    assert p["partition_bytes_per_row"] == 80 and p["hist_bytes_per_row"] == 40
    assert r["work_layout"] == "resident" and r["work_width"] == 17
    assert 2 * r["partition_bytes_per_row"] == p["partition_bytes_per_row"]
    assert r["hist_bytes_per_row"] == 17 + 28
    assert (p["launches_per_split"], r["launches_per_split"],
            k["launches_per_split"]) == (4, 5, 2)      # the device loop
    assert (p["launches_per_split_host_loop"],
            r["launches_per_split_host_loop"],
            k["launches_per_split_host_loop"]) == (3, 4, 1)
    assert planes.resident_spec() is None
    assert off.resident_spec() == (0, off.bins_t.numel() // 28)


def test_telemetry_route_gathers():
    """The resident three-launch path counts one route gather per split and
    reports 4 launches per split; the one-kernel split 1 and none."""
    for sk, gathers, per_split in (("off", True, 4), ("on", False, 1)):
        telemetry.reset()
        bst = _booster(tpu_resident_state="on", tpu_split_kernel=sk)
        for _ in range(2):
            bst.update()
        snap = telemetry.snapshot()
        c = snap["counters"]
        splits = c["tree/splits"]
        assert splits > 0
        assert c.get("learner/route_gather_launches", 0) == (
            splits if gathers else 0)
        assert snap["gauges"]["learner/launches_per_split"] == per_split
