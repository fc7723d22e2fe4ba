"""``chip_smoke.py`` rehearsed on the CPU at a small size: its seeded data
builders, the kernels-vs-plain phase, the training phase and the serving
of the trained model run end to end through the kernels' plain twins (on
the card the same code launches the kernels), and the script itself
refuses to run without a card."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

CPU = torch.device("cpu")


ROWS_KEYS = {
    "partition_rows/%s/%s" % (w, name)
    for w in ("w39", "w31", "w30")
    for name in ("unaligned", "whole", "under_one_block", "empty_left",
                 "empty_right", "one_row")} | {
    "histogram_rows/w39/%s/%s" % (mode, name)
    for mode in ("hilo", "bf16")
    for name in ("whole", "unaligned", "one_row", "empty")} | {
    "histogram_q/%s/%s" % (w, name)
    for w in ("w31", "w30")
    for name in ("whole", "unaligned", "one_row", "empty")}


def test_kernels_phase_covers_every_branch_on_cpu():
    errs = chip_smoke.phase_kernels(CPU, 0)
    assert set(errs) == {
        "forest/numerical", "forest/nan_missing", "forest/categorical",
        "forest/multiclass3", "forest/linear", "forest/linear_nan",
        "router/dense", "router/efb_bundles", "partition/bundle_column",
        "partition/unaligned", "partition/whole",
        "partition/under_one_block", "partition/empty_left",
        "partition/empty_right", "partition/one_row",
        "histogram/hilo/whole", "histogram/hilo/unaligned",
        "histogram/hilo/one_row", "histogram/hilo/empty",
        "histogram/bf16/whole", "histogram/bf16/unaligned",
        "histogram/bf16/one_row", "histogram/bf16/empty"} | ROWS_KEYS
    assert all(e <= 1e-6 for e in errs.values()), errs


@pytest.fixture(scope="module")
def data():
    return chip_smoke.training_data(0, 2000, 500)


@pytest.fixture(scope="module")
def trained(data):
    ds = chip_smoke.build_datasets(CPU, data, 15)
    bst, counts, summary = chip_smoke.phase_train(CPU, ds, 3, 15)
    return data, bst, ds[0], counts, summary


@pytest.fixture(scope="module")
def quantized(data):
    ds = chip_smoke.build_datasets(CPU, data, 15, chip_smoke.QUANT_PARAMS)
    bst, counts, summary = chip_smoke.phase_train(CPU, ds, 3, 15,
                                                  chip_smoke.QUANT_PARAMS)
    return bst, ds[0], counts, summary


def test_train_phase_small_on_cpu(trained):
    data, bst, train, counts, summary = trained
    assert counts["partition_segment"] == counts["segment_histogram"] \
        == counts["route_rows"] == 0                       # plain twins
    assert summary["trees"] == 3 and summary["splits"] > 0
    assert summary["layout"] == "planes"
    assert 0.6 < summary["valid_auc"] <= 1.0
    chip_smoke.check_determinism(CPU, train, 15, iters=1)
    res = chip_smoke.card_vs_host(CPU, data, 1000, 7, iters=1)
    assert res["splits_agree"] == res["splits"] > 0


def test_quantized_phase_small_on_cpu(trained, quantized):
    """The slice-3 phase at a tiny size: int8 gradients, bagging and
    column sampling on the rows layout, its full-width kernel checks, its
    determinism and card-vs-host runs, and the AUC against planes."""
    data, _, _, _, planes = trained
    bst, train, counts, summary = quantized
    assert summary["layout"] == "rows" and summary["splits"] > 0
    assert all(v == 0 for v in counts.values())             # plain twins
    assert abs(summary["valid_auc"] - planes["valid_auc"]) \
        <= chip_smoke.AUC_TOL + 0.05     # 3 trees on 2000 rows: noisier
    errs = {}
    assert chip_smoke.full_width_rows_kernels(bst, CPU, errs,
                                              timed=False) == {}
    want = {"histogram_rows/full_width"}
    for tag, _, _ in chip_smoke.ROWS_SEGMENTS:
        want |= {"partition_rows/full_width_" + tag,
                 "partition_rows/full_width_%s_w%d"
                 % (tag, chip_smoke.HIGGS_FEATURES + 12),
                 "histogram_q/full_width_" + tag}
    assert set(errs) == want
    assert max(errs.values()) <= 1e-6
    chip_smoke.check_determinism(CPU, train, 15, iters=1,
                                 extra=chip_smoke.QUANT_PARAMS)
    res = chip_smoke.card_vs_host(CPU, data, 1000, 7, iters=2,
                                  extra=chip_smoke.QUANT_PARAMS,
                                  first_tree_equal=True)
    assert res["first_tree"][0] == res["first_tree"][1] > 0


def test_rows_vs_planes_and_goss_small_on_cpu(trained):
    data = trained[0]
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.rows_vs_planes(CPU, data, 1000, 7)    # twins launch none
    res = chip_smoke.card_vs_host(CPU, data, 1000, 7, iters=4,
                                  extra=chip_smoke.GOSS_PARAMS)
    assert res["splits_agree"] == res["splits"] > 0


def test_one_kernel_phases_small_on_cpu(trained):
    """The slice-4 checks at a tiny size: every seeded one-kernel case
    (the twin against itself through the three-launch chain and the torch
    scan), the 2M-row check's code path, and the one-kernel training
    phase, which on the host trains the same trees as the three-launch
    one."""
    data, bst, _, _, summary = trained
    errs = chip_smoke.phase_one_kernel(CPU, np.random.RandomState(3))
    assert set(errs) == {"one_kernel/%s" % k for k in (
        "unaligned", "empty_left", "empty_right", "under_one_tile", "whole",
        "one_row_left", "one_row_right", "bagged_left", "bagged_right")} | {
        "one_kernel/scan/%s" % k for k in chip_smoke.SPLIT_CASES}
    assert max(errs.values()) == 0.0
    errs = {}
    assert chip_smoke.full_width_one_kernel(bst, CPU, errs,
                                            timed=False) == {}
    assert errs == {"one_kernel/full_width": 0.0}
    _, counts, one = chip_smoke.phase_one_kernel_train(CPU, data, 3, 15,
                                                       summary, 1000)
    assert all(v == 0 for v in counts.values())              # plain twins
    assert one["splits"] == summary["splits"]
    assert one["valid_auc"] == summary["valid_auc"]
    assert one["on_vs_off"]["splits_agree"] == one["on_vs_off"]["splits"]


def test_resident_phases_small_on_cpu(trained):
    """The slice-5 checks at a tiny size: every seeded resident case (the
    route gather, the resident histogram and the one-kernel split's
    resident mode, twins against twins and the planes layout's), the
    resident training phase (its model byte-equal to the one-kernel
    phase's, its three-launch run byte-equal to planes') and the
    full-width checks at the root and a deep leaf."""
    data, _, _, _, summary = trained
    errs = chip_smoke.phase_resident_kernels(CPU, np.random.RandomState(5))
    assert set(errs) == {"route/%s" % c[0] for c in chip_smoke.PART_CASES} \
        | {"histogram_resident/%s/%s" % (m, c[0])
           for m in ("hilo", "bf16") for c in chip_smoke.HIST_CASES} \
        | {"one_kernel_resident/%s" % k for k in (
            "unaligned", "empty_left", "under_one_tile", "whole",
            "bagged")} \
        | {"one_kernel_resident/scan/%s" % k for k in chip_smoke.SPLIT_CASES}
    assert max(errs.values()) == 0.0
    one = chip_smoke.phase_one_kernel_train(CPU, data, 3, 15, summary, 1000)
    bst, counts, res = chip_smoke.phase_resident_train(
        CPU, data, 3, 15, (one[0], one[2]), 1000)
    assert all(v == 0 for v in counts.values())              # plain twins
    assert res["layout"] == "resident" and res["splits"] == one[2]["splits"]
    assert res["card_vs_host"]["splits_agree"] == res["card_vs_host"][
        "splits"]
    errs = {}
    assert chip_smoke.full_width_resident(bst, CPU, errs, timed=False) == {}
    assert set(errs) == {"%s/full_width_%s" % (k, t)
                         for k in ("route", "histogram_resident",
                                   "one_kernel_resident")
                         for t in ("root", "deep")}
    assert max(errs.values()) == 0.0


def test_planes_and_router_phases_small_on_cpu(data, trained):
    """K3 planes on PLANES_SEGMENTS of the planes model at W = 40 and 17,
    the router on its four shapes, and both kernels' edge cases
    (without the resident limits' large buffers), through the twins."""
    import lightgbm_tpu_torch as lgt
    _, bst, train, _, _ = trained
    errs = {}
    assert chip_smoke.full_width_planes(bst, CPU, errs, timed=False) == {}
    valid = lgt.Dataset(data[2], label=data[3], reference=train)
    assert chip_smoke.full_width_route(bst, valid.construct(), CPU, errs,
                                       timed=False) == {}
    assert set(errs) == {
        "partition/full_width_%s_w%d" % (tag, w)
        for tag in ("root", "mid", "deep") for w in (40, 17)} | {
        "router/full_width_" + s
        for s in ("train", "valid", "serve", "chain")}
    errs = chip_smoke.phase_planes_route_kernels(
        CPU, np.random.RandomState(2), full=False)
    assert len(errs) == 2 * (6 + 4 * 2) + 3 * 7
    assert max(errs.values()) == 0.0


def test_serve_phase_small_on_cpu(quantized):
    bst, train, _, _ = quantized
    assert bst.inner.train_set.num_total_features \
        == chip_smoke.HIGGS_FEATURES
    rng = np.random.RandomState(1)
    out, counts = chip_smoke.phase_serve(bst, train, rng, 5000)
    assert counts["forest_predict"] == 0 and counts["route_rows"] == 0
    errs = chip_smoke.check_serve(bst, out)
    assert max(errs.values()) <= 1e-6, errs
    assert out["binned"].shape == (5000,)


def test_forest_phases_small_on_cpu(quantized):
    """The forest kernel's edge packs and its full-width shapes (the
    serving model at the 256, 4096 and 65,536-row rungs and a chain forest
    over the top rung) against the twin, and the per-request latency,
    through the plain twin; no kernel launches."""
    bst, _, _, _ = quantized
    errs = chip_smoke.phase_forest_kernels(CPU, np.random.RandomState(3))
    assert set(errs) == {"forest_edge/%s/%d" % (c, n)
                         for c in chip_smoke.FOREST_EDGE_CASES
                         for n in chip_smoke.FOREST_EDGE_ROWS}
    assert max(errs.values()) == 0.0
    rng = np.random.RandomState(2)
    reqs = {n: chip_smoke.higgs_like(rng, n)
            for n in chip_smoke.REQUEST_ROWS}
    errs = {}
    shapes = chip_smoke.full_width_forest(bst, reqs, CPU, errs, timed=False)
    assert set(shapes) == {tag for tag, _ in chip_smoke.FOREST_SHAPES}
    assert errs == {"forest/full_width_" + tag: 0.0 for tag in shapes}
    leaves = 15
    for tag, rows in chip_smoke.FOREST_SHAPES:
        v = shapes[tag]
        assert v["rows"] == rows and v["trees"] == 3
        assert v["trees"] * rows <= v["steps"] \
            <= v["trees"] * rows * (leaves - 1)
    # the chain's rows walk most of its 14 rounds
    assert shapes["chain"]["steps"] > 10 * 3 * 65536
    lat = chip_smoke.serve_latency(bst, {1: reqs[1], 256: reqs[256]},
                                   reps=2)
    assert set(lat) == {1, 256} and all(t > 0 for t in lat.values())


def test_higgs_like_is_float32_exact():
    X = chip_smoke.higgs_like(np.random.RandomState(1), 1000)
    assert X.shape == (1000, 28)
    assert np.array_equal(X.astype(np.float32).astype(np.float64), X)


def test_smoke_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, os.path.join(REPO,
                                                       "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: every phase here runs many small ops on
    the host (the kernels' twins, the device loop's and the chain's),
    which OpenMP threads of several test workers sharing the host's cores
    slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_fused_phases_small_on_cpu(data, trained, one_thread):
    """The slice-10 and slice-11 checks at a tiny size: the split commit's
    seeded cases and the one-kernel header's (twins against twins), phase
    3d (fused planes and resident byte-equal to the per-iteration
    one-kernel model, its valid AUC from predict equal to that model's;
    the three-launch chain and quantized fused runs; on host tensors the
    fused blocks take the host loop), the split scan at the chain models'
    root and deep leaf, and the full-width commit check."""
    import types
    errs = chip_smoke.phase_commit_kernel(CPU, np.random.RandomState(23))
    assert set(errs) == {"commit/%s" % c[0] for c in chip_smoke.COMMIT_CASES}
    errs.update(chip_smoke.phase_one_kernel_header(
        CPU, np.random.RandomState(29)))
    assert {"one_kernel_header/unaligned", "one_kernel_header/whole"} \
        <= set(errs)
    ds = chip_smoke.build_datasets(CPU, data, 15,
                                   chip_smoke.ONE_KERNEL_PARAMS)
    bst_k, _, per_iter = chip_smoke.phase_train(
        CPU, ds, 3, 15, chip_smoke.ONE_KERNEL_PARAMS)
    per_iter["predict_auc"] = chip_smoke.auc_np(data[3],
                                                bst_k.predict(data[2]))
    args = types.SimpleNamespace(seed=0, trees=3, leaves=15,
                                 train_rows=len(data[0]),
                                 valid_rows=len(data[2]))
    bst, counts, summary, chain_rows = chip_smoke.phase_fused(
        CPU, data, 3, 15, per_iter, args, "cpu", errs)
    assert set(summary) == {"planes", "resident", "three_launch",
                            "quantized"}
    assert summary["planes"]["model_sha256"] == per_iter["model_sha256"]
    assert all(v == 0 for c in counts.values() for v in c.values())
    assert chain_rows == {}
    assert {"split_scan/%s/%s" % (t, w) for t in ("three_launch",
                                                  "quantized")
            for w in ("root", "deep")} <= set(errs)
    assert chip_smoke.full_width_commit(bst, CPU, errs, timed=False) == {}
    assert max(errs.values()) == 0.0 and "commit/full_width" in errs


def test_chain_kernels_phase_on_cpu(one_thread):
    """phase_chain_kernels at its own size on host tensors (twins against
    twins): every static-plan case on every layout, the split scan on every
    SPLIT_CASES case, the categorical router's tables."""
    errs = chip_smoke.phase_chain_kernels(CPU, np.random.RandomState(37))
    layouts = ("planes", "rows", "int8", "resident")
    assert {"chain/%s/%s" % (lay, c[0]) for lay in layouts
            for c in chip_smoke.CHAIN_CASES} <= set(errs)
    assert {"split_scan/" + c for c in chip_smoke.SPLIT_CASES} <= set(errs)
    assert sum(k.startswith("router_cat/") for k in errs) == 4
    assert max(errs.values()) == 0.0


def test_mixed_phase_small_on_cpu(one_thread):
    """Phase 3e at 20,000 rows x 3 trees on host tensors: categorical and
    EFB data, fused byte-equal to per iteration with one-vs-rest and
    many-vs-many splits, the categorical router's twin on the model's
    trees."""
    _, counts, summary, errs, row = chip_smoke.phase_mixed(
        CPU, 0, "cpu", rows=20000, trees=3, timed=False)
    assert summary["one_vs_rest"] > 0 and summary["many_vs_many"] > 0
    assert all(v == 0 for v in counts.values()) and row == {}
    assert len(errs) == 8 and max(errs.values()) == 0.0
    assert {"split_scan/mixed/root", "split_scan/mixed/deep"} <= set(errs)


def test_options_phase_small_on_cpu(data, one_thread):
    """Phase 3h at a tiny size on host tensors: (a)-(d) fused with the
    per-iteration trees byte-equal to the first fused ones, (d)'s trees
    with the forced splits at their top levels, compaction on vs off, the
    node inputs, forced-leaf scan, extended scan and commit checks (twins
    against twins here), card vs host (host against host)."""
    summary, counts, errs, rows = chip_smoke.phase_options(
        CPU, data, "cpu", trees=3, per_iter=2, leaves=15, host_rows=1500,
        host_trees=2, host_leaves=15, timed=False)
    assert set(summary) == {"bynode_extra", "constraints_cegb_forced",
                            "goss_compact_on", "goss_compact_off",
                            "forced_one_kernel"}
    assert all(summary[k]["per_iteration_equal"] for k in (
        "bynode_extra", "constraints_cegb_forced", "forced_one_kernel"))
    assert summary["goss_compact_on"]["equal_to_off"]
    assert {"node_inputs/F28", "node_inputs/F137", "node_inputs/F137/S300",
            "goss_compact/bits", "split_scan/options/root",
            "split_scan/options/deep"} <= set(errs)
    assert {"commit/" + c[0] for c in chip_smoke.COMMIT_FORCED_CASES} \
        <= set(errs)
    assert len([k for k in errs if k.startswith("split_scan/forced_leaf/")]) \
        == len(chip_smoke.OPTIONS_FORCED)
    assert max(errs.values()) == 0.0
    assert all(v == 0 for c in counts.values() for v in c.values())
    assert rows == {"extended": {}}


def test_monotone_phase_small_on_cpu(data, one_thread):
    """Phase 3i at a tiny size on host tensors: (a) intermediate and (b)
    advanced, and (e) and (f) on the two pair columns, fused with the
    per-iteration trees byte-equal to the first fused ones (not (e)) and
    the monotonicity sweep, (b) equal to (a) and (f) not equal to (e); (c)
    DART and (d) RF per iteration with the valid set, the monotone
    kernels', extended commit's and extended scan's checks (twins against
    twins here; on the fused learners too), card vs host (host against
    host)."""
    summary, counts, errs, rows = chip_smoke.phase_monotone(
        CPU, data, "cpu", trees=3, per_iter=2, leaves=15, host_rows=1500,
        host_trees=2, host_leaves=15, timed=False)
    assert set(summary) == {"intermediate", "advanced", "dart", "rf",
                            "intermediate_pair", "advanced_pair"}
    for name, columns in (("intermediate", chip_smoke.MONO_COLUMNS),
                          ("advanced", chip_smoke.MONO_COLUMNS),
                          ("intermediate_pair", chip_smoke.MONO_PAIR_SIGNS),
                          ("advanced_pair", chip_smoke.MONO_PAIR_SIGNS)):
        assert summary[name].get("per_iteration_equal", False) \
            == (name != "intermediate_pair")
        assert summary[name]["sweeps"] == min(
            chip_smoke.MONO_SWEEP_ROWS, len(data[2])) * len(columns)
        assert summary[name]["worst_step"] >= -chip_smoke.MONO_SWEEP_TOL
    assert summary["advanced"]["equal_to_intermediate"]
    assert not summary["advanced_pair"]["equal_to_intermediate"]
    for name in ("intermediate", "advanced", "dart", "rf", "advanced_pair"):
        assert "card_vs_host" in summary[name]
    assert 0.5 < summary["dart"]["valid_auc"] <= 1.0
    assert 0.5 < summary["rf"]["valid_auc"] <= 1.0
    assert {"mono_bounds/F%d/%s" % (F, c)
            for F in chip_smoke.MONO_CHECK_FEATURES
            for c in ("numerical", "categorical", "invalid")} <= set(errs)
    assert {"mono_bounds/F28_L15/numerical", "mono_commit/F28_L15/invalid",
            "commit/mono1/mid/full_width", "commit/mono2/final/full_width",
            "split_scan/advanced/root", "split_scan/advanced/deep",
            "commit/mono1/mid", "commit/mono2/forced_invalid"} <= set(errs)
    assert {"%s/%s_%s" % (k, tag, where)
            for k in ("commit/mono1", "commit/mono2", "mono_commit",
                      "mono_bounds", "split_scan/advanced")
            for tag in ("full_width", "pair")
            for where in ("mid", "deep")} <= set(errs)
    assert max(errs.values()) == 0.0
    assert all(v == 0 for c in counts.values() for v in c.values())
    assert rows == {"extended": {}}
