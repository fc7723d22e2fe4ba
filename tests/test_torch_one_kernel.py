"""One-kernel split of the PyTorch port (``tpu_split_kernel=on``) on the
CPU: the plain twin of ``csrc/one_kernel_split.cu``
(``ops.partition.one_kernel_split_planes`` on host tensors) against the
JAX package's ``one_kernel_split_planes`` under the Pallas interpreter,
as tests/test_one_kernel.py runs it; trees grown with the split kernel on
against off (the twin is the three-launch chain, so the model strings are
byte-equal) and against the JAX package's on; the knob's resolution, the
eligibility gate, the traffic spec and the launch telemetry.

Op-level bars (inputs from ``chip_smoke.split_case`` on the 1/64 grid, so
every histogram sum is exact in both packages): ``lt`` and the left rows
byte-equal (the JAX kernel leaves the order of the right rows unspecified:
equal as a set); histogram counts equal, g and h within
``ops.histogram.sum_error_bound``; ``feature``, ``bin``, ``kind``,
``default_left`` and ``go_left`` equal; gains, sums and outputs within the
rtol 1e-5 / atol 1e-6 of tests/test_torch_split.py.
"""
import numpy as np
import pytest
import torch

import jax

from torch_port_cases import (CPU, JAX_ONE_KERNEL, assert_same_trees,
                              make_train_data, one_kernel_jax_inputs,
                              one_kernel_tree_data, one_torch_thread)

import chip_smoke
import lightgbm_tpu as lgb
from lightgbm_tpu.ops import partition as JP

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.learner import Comm, build_tree_partitioned
from lightgbm_tpu_torch.obs import telemetry
from lightgbm_tpu_torch.ops import histogram as PH
from lightgbm_tpu_torch.ops import partition as PP
from lightgbm_tpu_torch.ops import split as PS


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """Every test here runs the port on the host: one torch thread
    (torch_port_cases.one_torch_thread)."""


#: the op-level cases: chip_smoke.SPLIT_CASES but the second many-vs-many
#: direction and the shallow monotone penalty, which the card covers, and
#: "ties" (test_exact_tie_order: the JAX package's XLA scan rounds the tied
#: one-vs-rest gain an ulp above the numerical one)
OP_CASES = ("numerical", "nan_left", "nan_right", "categorical_onehot",
            "categorical_mvm", "monotone_penalty", "masked_fmask",
            "no_split", "nan_gains", "l1_clip", "path_smooth")


# --------------------------------------------------------------- op level

@pytest.mark.parametrize("name", OP_CASES)
def test_op_matches_jax(name, monkeypatch):
    monkeypatch.setattr(JP, "_INTERPRET", True)
    case = chip_smoke.split_case(name, np.random.RandomState(17), n=1500)
    jargs, jkw, pkw, jwork, seg = one_kernel_jax_inputs(case)
    w_j, lt_j, hl_j, hr_j, inf_j = jax.device_get(
        JP.one_kernel_split_planes(*jargs, **jkw))
    src, start, cnt, _ = seg
    f = pkw["num_feat"]
    work = torch.as_tensor(jwork[:, :f + 12].copy())
    lt, hl, hr, inf = PP.one_kernel_split_planes(
        work, torch.tensor(seg, dtype=torch.int32), **pkw)
    got = work.numpy()
    want = np.asarray(w_j)[:, :f + 12]
    n_left = int(lt)
    assert lt.dtype == torch.int32 and n_left == int(lt_j)
    s0, s1 = start, start + cnt
    assert np.array_equal(got[1, :, s0:s0 + n_left],
                          want[1, :, s0:s0 + n_left])
    assert sorted(map(bytes, got[1, :, s0 + n_left:s1].T)) == \
        sorted(map(bytes, want[1, :, s0 + n_left:s1].T))
    assert np.array_equal(got[0], want[0])
    small = min(n_left, cnt - n_left)
    for a, b in ((hl, hl_j), (hr, hr_j)):
        a, b = a.numpy(), np.asarray(b)
        assert np.array_equal(a[..., 2], b[..., 2])
        tol = PH.sum_error_bound(small) * np.abs(b).sum()
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    for fld in ("feature", "bin", "kind", "default_left", "go_left"):
        np.testing.assert_array_equal(getattr(inf, fld).numpy(),
                                      np.asarray(getattr(inf_j, fld)),
                                      err_msg=fld)
    for fld in ("gain", "left_sum", "right_sum", "left_output",
                "right_output"):
        np.testing.assert_allclose(getattr(inf, fld).numpy(),
                                   np.asarray(getattr(inf_j, fld)),
                                   rtol=1e-5, atol=1e-6, err_msg=fld)
    if name == "no_split":
        assert np.isneginf(inf.gain.numpy()).all()
    elif name in ("nan_left", "nan_right"):
        assert inf.default_left.tolist() == [name == "nan_left"] * 2


def test_exact_tie_order():
    """Numerical features 4 and 5 and one-vs-rest feature 2 hold one
    column: their gains tie exactly in torch's arithmetic (and in the
    kernel's), and the flat first maximum of (kind, feature, bin) takes
    kind 0 before kind 1, then the smaller feature."""
    case = chip_smoke.split_case("ties", np.random.RandomState(17), n=1500)
    work, seg, table, kw = chip_smoke.split_inputs(torch.device("cpu"), case)
    _, hl, hr, inf = PP.one_kernel_split_planes(
        work, torch.tensor(seg, dtype=torch.int32), table, cnt_bound=seg[2],
        **kw)
    assert inf.kind.tolist() == [0, 0] and inf.feature.tolist() == [4, 4]
    assert inf.bin.tolist() == [0, 0]
    cand = PS.find_best_split(
        torch.stack([hl, hr]), kw["sums2"], kw["meta"], kw["fmask"],
        kw["hp"], parent_output=kw["outs2"], node_depth=kw["depth"],
        want_candidates=True)                        # (2, 4, F, B)
    for c in (0, 1):
        tied = [float(cand[c, 0, 4, 0]), float(cand[c, 0, 5, 0]),
                float(cand[c, 1, 2, 0])]
        assert tied == [float(cand[c].max())] * 3


def test_op_validations():
    work = torch.zeros((2, 18, 1280), dtype=torch.uint8)      # F = 6
    f, nb = 6, 16
    meta = PS.FeatureMeta(
        num_bins=torch.full((f,), nb, dtype=torch.int32),
        movable_missing=torch.zeros(f, dtype=torch.bool),
        missing_bin=torch.zeros(f, dtype=torch.int32),
        is_categorical=torch.zeros(f, dtype=torch.bool),
        monotone=torch.zeros(f, dtype=torch.int8),
        penalty=torch.ones(f), cegb_coupled=torch.zeros(f))
    kw = dict(go_left=torch.zeros(nb, dtype=torch.bool), left_smaller=True,
              depth=1, parent_hist=torch.zeros((f, nb, 3)), meta=meta,
              fmask=torch.ones(f, dtype=torch.bool), sums2=torch.zeros(2, 3),
              outs2=torch.zeros(2), lows2=torch.full((2,), -np.inf),
              ups2=torch.full((2,), np.inf), hp=PS.SplitHyper(),
              num_bins=nb, num_feat=f, cnt_bound=64)
    seg = torch.tensor([0, 128, 64, 0], dtype=torch.int32)
    PP.one_kernel_split_planes(work.clone(), seg, **kw)     # accepted
    bad = [
        (dict(), work[:, :17]),                             # W != F + 12
        (dict(), work[:, :, :1200]),                        # Npad % 128
        (dict(parent_hist=torch.zeros((f, nb, 2))), work),
        (dict(go_left=torch.zeros(nb + 1, dtype=torch.bool)), work),
        (dict(meta=meta._replace(monotone=torch.zeros(f))), work),
        (dict(sums2=torch.zeros(3)), work),
        (dict(hp=PS.SplitHyper(use_cegb=True)), work),
    ]
    for over, w in bad:
        with pytest.raises(ValueError):
            PP.one_kernel_split_planes(w.clone(), seg, **dict(kw, **over))


# ------------------------------------------------------------ tree level

ON_OFF_CASES = {
    "binary": ({"objective": "binary"}, {}),
    "regression": ({"objective": "regression"}, {"objective": "regression"}),
    "multiclass": ({"objective": "multiclass", "num_class": 3},
                   {"objective": "multiclass"}),
    "nan_missing": ({"objective": "binary"}, {"nan": True}),
    "categorical": ({"objective": "binary", "max_cat_to_onehot": 8},
                    {"cat": True}),
    "goss": ({"objective": "binary", "data_sample_strategy": "goss",
              "learning_rate": 0.5}, {}),
}


@pytest.mark.parametrize("name", list(ON_OFF_CASES))
def test_tree_on_equals_off_on_host(name):
    params, data_kw = ON_OFF_CASES[name]
    X, y, cats = make_train_data(np.random.RandomState(3), 1500, **data_kw)
    models = {}
    for sk in ("off", "on"):
        p = dict(params, verbosity=-1, num_leaves=15, min_gain_to_split=1e-3,
                 tpu_split_kernel=sk, **CPU)
        bst = lgt.train(p, lgt.Dataset(X, label=y, categorical_feature=cats,
                                       params=p), 4)
        assert bst.inner.learner._kw["split_kernel"] == sk
        models[sk] = bst.model_to_string()
    assert models["on"] == models["off"]
    if name == "categorical":
        assert any(t.num_cat for t in bst.inner.models)


def test_tree_on_equals_jax_on(tmp_path, monkeypatch):
    """The shapes of tests/test_one_kernel.py's planes tree case, both
    packages with tpu_split_kernel=on, the JAX one under the interpreter."""
    monkeypatch.setattr(JP, "_INTERPRET", True)
    X, y = one_kernel_tree_data(np.random.RandomState(0))
    params = dict(JAX_ONE_KERNEL, objective="binary", num_leaves=15,
                  verbosity=-1, min_gain_to_split=1e-3, tpu_split_kernel="on")
    ds = lgb.Dataset(X, label=y)
    ds.construct(params)
    path = str(tmp_path / "one_kernel.npz")
    ds.save_binary(path)
    jb = lgb.train(dict(params), ds, 2)
    pb = lgt.train(dict(params, **CPU), lgt.dataset_from_reference(path, CPU),
                   2)
    assert pb.inner.learner._kw["split_kernel"] == "on"
    assert all(t.num_leaves == 15 for t in pb.inner.models)
    assert_same_trees(jb.inner.models, pb.inner.models)


# --------------------------------------------------- resolution and gates

def _small_booster(**extra):
    X, y, _ = make_train_data(np.random.RandomState(5), 400)
    p = dict(objective="binary", verbosity=-1, num_leaves=7, **CPU, **extra)
    return lgt.Booster(p, lgt.Dataset(X, label=y, params=p))


def test_auto_resolves_off_with_reason():
    telemetry.reset()
    bst = _small_booster()
    assert bst.inner.learner._kw["split_kernel"] == "off"
    recs = [r for r in telemetry.records("auto_resolution")
            if r["knob"] == "tpu_split_kernel"]
    assert len(recs) == 1 and recs[0]["value"] == "off"
    assert "one_kernel_split.cu" in recs[0]["reason"]


def test_build_tree_rejects_ineligible_on():
    f = 4
    meta = PS.FeatureMeta(
        num_bins=torch.full((f,), 8, dtype=torch.int32),
        movable_missing=torch.zeros(f, dtype=torch.bool),
        missing_bin=torch.zeros(f, dtype=torch.int32),
        is_categorical=torch.zeros(f, dtype=torch.bool),
        monotone=torch.zeros(f, dtype=torch.int8), penalty=torch.ones(f),
        cegb_coupled=torch.zeros(f))
    with pytest.raises(ValueError, match="not eligible"):
        build_tree_partitioned(
            torch.zeros((64, f), dtype=torch.uint8), torch.zeros((64, 3)),
            meta, torch.ones(f, dtype=torch.bool), PS.SplitHyper(),
            num_leaves=4, num_bin=8, comm=Comm(), split_kernel="on",
            work_layout="rows")


def test_traffic_spec_launches():
    off = _small_booster(tpu_split_kernel="off").inner.learner.traffic_spec()
    on = _small_booster(tpu_split_kernel="on").inner.learner.traffic_spec()
    # the device tree loop's count (the split commit in every slot; the
    # split scan kernel on the chain), and the per-split host loop's
    assert off["launches_per_split"] == 4 and off["split_kernel"] == "off"
    assert on["launches_per_split"] == 2 and on["split_kernel"] == "on"
    assert (off["launches_per_split_host_loop"],
            on["launches_per_split_host_loop"]) == (3, 1)
    assert on["work_layout"] == "planes" and on["work_width"] == 8 + 12
    assert on["partition_bytes_per_row"] == 2 * on["hist_bytes_per_row"]


def test_telemetry_one_launch_per_split():
    """One launch per split: partition_launches == splits, one histogram
    launch per tree (the root), no scan launches; the three-launch path
    reports 3 per split."""
    for sk, per_split in (("on", 1), ("off", 3)):
        telemetry.reset()
        bst = _small_booster(tpu_split_kernel=sk)
        for _ in range(2):
            bst.update()
        snap = telemetry.snapshot()
        c = snap["counters"]
        splits, trees = c["tree/splits"], c["tree/trees"]
        assert splits > trees > 0
        assert c["learner/partition_launches"] == splits
        assert c["learner/hist_launches"] == (
            trees if sk == "on" else splits + trees)
        assert c.get("learner/scan_launches", 0) == (
            0 if sk == "on" else splits)
        assert snap["gauges"]["learner/launches_per_split"] == per_split
