"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: a CUDA kernel has no interpret mode, so on a host
without a card these tests skip (the CPU suites test the plain twins
against the JAX package instead). On the card:
``python -m pytest --noconftest tests/test_torch_cuda.py`` (the suite's
conftest imports JAX, which the port and this file do not need)."""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
# importing the op modules registers their kernels' launch counters
from lightgbm_tpu_torch.linear import fit as linear_fit  # noqa: E402,F401
from lightgbm_tpu_torch.ops import (commit, forest,  # noqa: E402,F401
                                    histogram, kernels, monotone, node,
                                    partition, rank, route, scan)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.build_all()
    return torch.device("cuda", torch.cuda.current_device())


def test_kernels_match_plain_on_card(card):
    before = kernels.launch_counts()
    errs = chip_smoke.phase_kernels(card, 3)
    assert max(errs.values()) <= 1e-5, errs
    after = kernels.launch_counts()
    for name in ("forest_predict", "route_rows", "partition_segment",
                 "segment_histogram", "partition_segment_rows",
                 "segment_histogram_rows", "segment_histogram_q"):
        assert after[name] > before[name], name


def test_forest_edges_match_plain_on_card(card):
    """The forest kernel's walk against its twin on the edge packs (a
    254-round chain, padded trees and rounds, num_splits 0 and past R,
    categorical, NaN-missing bins, 1000 features with bins read from
    device memory: bit-equal; 3 classes over two spans of groups and
    linear leaves with NaN rows: within tolerance) at 1, 255, 257 and
    4097 rows (chip_smoke.phase_forest_kernels)."""
    for rows in chip_smoke.FOREST_EDGE_ROWS:
        assert not forest.forest_plan(
            rows, 16, 254, partition.sm_count(card.index),
            chip_smoke.FOREST_WIDE_F, 1).staged
    before = kernels.launch_counts()["forest_predict"]
    errs = chip_smoke.phase_forest_kernels(card, np.random.RandomState(9))
    assert max(errs.values()) <= 1e-5, errs
    assert kernels.launch_counts()["forest_predict"] - before \
        == len(chip_smoke.FOREST_EDGE_CASES) * len(chip_smoke.FOREST_EDGE_ROWS)


def test_one_kernel_split_matches_plain_on_card(card):
    """One seeded split per case: the cooperative kernel's routed bytes and
    lt equal to its twin's and K3's, its child histograms bit-equal to K3 +
    K4 + the subtraction, its SplitInfo held to the torch scan on the same
    histograms (chip_smoke.check_one_kernel)."""
    before = kernels.launch_counts()["one_kernel_split"]
    errs = chip_smoke.phase_one_kernel(card, np.random.RandomState(7))
    assert max(errs.values()) <= 1.0, errs
    assert kernels.launch_counts()["one_kernel_split"] > before


def test_segment_kernels_match_plain_on_card(card):
    before = kernels.launch_counts()
    errs = chip_smoke.phase_segment_kernels(card, np.random.RandomState(5))
    errs.update(chip_smoke.phase_rows_kernels(card,
                                              np.random.RandomState(6)))
    assert all(np.isfinite(list(errs.values())))
    after = kernels.launch_counts()
    for name in ("partition_segment", "segment_histogram",
                 "partition_segment_rows", "segment_histogram_rows",
                 "segment_histogram_q"):
        assert after[name] > before[name], name


@pytest.fixture(scope="module")
def data():
    return chip_smoke.training_data(1, 20000, 5000)


@pytest.fixture(scope="module")
def trained_on_card(card, data):
    ds = chip_smoke.build_datasets(card, data, 63)
    return chip_smoke.phase_train(card, ds, 4, 63) + (ds[0],)


def test_small_training_path_on_card(card, trained_on_card):
    bst, counts, summary, train = trained_on_card
    assert counts["partition_segment"] == summary["splits"]
    assert counts["segment_histogram"] == summary["splits"] + 4
    assert counts["route_rows"] == 8        # training set + valid set
    chip_smoke.check_determinism(card, train, 63, iters=2)


def test_small_quantized_training_on_card(card, data, trained_on_card):
    ds = chip_smoke.build_datasets(card, data, 63, chip_smoke.QUANT_PARAMS)
    bst, counts, summary = chip_smoke.phase_train(card, ds, 4, 63,
                                                  chip_smoke.QUANT_PARAMS)
    assert summary["layout"] == "rows"
    assert counts["partition_segment_rows"] == summary["splits"]
    assert counts["segment_histogram_q"] == summary["splits"] + 4
    assert counts["partition_segment"] == counts["segment_histogram"] == 0
    errs = {}
    chip_smoke.full_width_rows_kernels(bst, card, errs, timed=False)
    assert max(errs.values()) <= 1e-5, errs
    chip_smoke.check_determinism(card, ds[0], 63, iters=2,
                                 extra=chip_smoke.QUANT_PARAMS)
    chip_smoke.card_vs_host(card, data, 5000, 15, iters=2,
                            extra=chip_smoke.QUANT_PARAMS,
                            first_tree_equal=True)
    chip_smoke.rows_vs_planes(card, data, 5000, 15, iters=2)


def test_small_one_kernel_training_on_card(card, data, trained_on_card):
    ds = chip_smoke.build_datasets(card, data, 63,
                                   chip_smoke.ONE_KERNEL_PARAMS)
    bst, counts, summary = chip_smoke.phase_train(
        card, ds, 4, 63, chip_smoke.ONE_KERNEL_PARAMS)
    assert counts["one_kernel_split"] == summary["splits"]
    assert counts["partition_segment"] == 0
    assert counts["segment_histogram"] == 4          # the roots
    errs = {}
    chip_smoke.full_width_one_kernel(trained_on_card[0], card, errs,
                                     timed=False)
    assert set(errs) == {"one_kernel/full_width"}
    chip_smoke.check_determinism(card, ds[0], 63, iters=2,
                                 extra=chip_smoke.ONE_KERNEL_PARAMS)
    chip_smoke.split_kernel_on_vs_off(card, data, 5000, 15, iters=2)


def test_small_serving_path_on_card(card, trained_on_card):
    bst, _, _, train = trained_on_card
    rng = np.random.RandomState(1)
    out, counts = chip_smoke.phase_serve(bst, train, rng, 100000)
    assert counts["forest_predict"] > 0 and counts["route_rows"] == 4
    errs = chip_smoke.check_serve(bst, out)
    assert np.isfinite(list(errs.values())).all()


def test_resident_kernels_match_plain_on_card(card):
    """The route gather, the resident histogram and the one-kernel split's
    resident mode against their twins and the planes kernels on the same
    rows (chip_smoke.phase_resident_kernels): route bytes equal, the
    resident histogram bit-equal to K4 planes, the resident split's routed
    bytes equal to the chain's and its histograms and SplitInfo bit-equal
    to the planes mode's."""
    before = kernels.launch_counts()
    errs = chip_smoke.phase_resident_kernels(card, np.random.RandomState(9))
    assert np.isfinite(list(errs.values())).all()
    after = kernels.launch_counts()
    for name in ("write_route_plane", "segment_histogram_resident",
                 "one_kernel_split_resident"):
        assert after[name] > before[name], name


def test_small_resident_training_on_card(card, data):
    """Resident one-kernel training byte-equal to planes one-kernel
    training, resident three-launch byte-equal to planes three-launch, card
    against host (chip_smoke.phase_resident_train), then the full-width
    checks at the root and a deep leaf."""
    ds = chip_smoke.build_datasets(card, data, 63,
                                   chip_smoke.ONE_KERNEL_PARAMS)
    one = chip_smoke.phase_train(card, ds, 4, 63,
                                 chip_smoke.ONE_KERNEL_PARAMS)
    bst, counts, summary = chip_smoke.phase_resident_train(
        card, data, 4, 63, (one[0], one[2]), 5000)
    assert counts["one_kernel_split_resident"] == summary["splits"]
    assert summary["three_launch"]["write_route_plane"] > 0
    errs = {}
    assert chip_smoke.full_width_resident(bst, card, errs, timed=False) == {}
    assert len(errs) == 6


def test_histogram_order_ignores_cnt_bound_on_card(card):
    """K4 planes, rows and resident on a 20,000-row segment (three chunks,
    an unaligned start) with cnt_bound at the count, 2x and 8x it: the
    same bits (chip_smoke.check_bound_invariant), and within the f32
    summation bound of the twin."""
    rng = np.random.RandomState(13)
    n, nb, F = 20000, 64, 10
    bins = rng.randint(0, nb, (n, F)).astype(np.uint8)
    work = chip_smoke.seeded_work(rng, torch.as_tensor(bins), card)
    seg = [0, 128 + 5, n - 5]
    for exact in (True, False):
        chip_smoke.check_histogram("order/planes", work, seg, nb, F, exact)
        chip_smoke.check_histogram("order/rows",
                                   work.transpose(1, 2).contiguous(), seg,
                                   nb, F, exact, rows=True)
    bins_all, res, rows = chip_smoke.seeded_resident(rng, bins, card)
    ghc = torch.as_tensor(np.stack([rng.randn(n), np.abs(rng.randn(n)),
                                    np.ones(n)], axis=1)
                          .astype(np.float32)).to(card)
    slim, planes = chip_smoke.resident_pair(card, bins_all, res, rows, ghc,
                                            rng)
    chip_smoke.check_histogram_resident("order/resident", slim, res, planes,
                                        seg, nb, F, True)


def test_one_kernel_bagged_child_on_card(card):
    """B7 on segments whose smaller child by the count channel holds ~3/4
    of the parent's rows (bagging's zeroed count channel): routed bytes,
    lt, the child histograms bit-equal to K3 + K4 + the subtraction, and
    the SplitInfo (chip_smoke.check_one_kernel)."""
    rng = np.random.RandomState(21)
    case = chip_smoke.split_case("numerical", rng, n=30000)
    work, seg, table, kw = chip_smoke.split_inputs(card, case)
    nb, col = kw["num_bins"], seg[3]
    w_bag, t_bag = chip_smoke.bagged_work(rng, work, col, nb)
    for tbl in (t_bag, ~t_bag):
        sg = [0, 128 + 13, seg[2] - 13, col]
        skw = chip_smoke.segment_split(w_bag, sg, tbl, kw)
        chip_smoke.check_bagged_shape("bagged", w_bag, sg, tbl, skw)
        chip_smoke.check_one_kernel("bagged", w_bag, sg, tbl, skw)


def _rows_pair(card, rng, n, F, quantized, nb=64, skew=False):
    """A seeded (2, Npad, W) rows pair of ``n`` rows from row 128
    (chip_smoke.seeded_rows_work); with ``skew`` feature 0 takes three
    values, ~55% of rows on one (the b-tag features' shape)."""
    bins = rng.randint(0, nb, (n, F)).astype(np.uint8)
    if skew:
        bins[:, 0] = np.where(rng.rand(n) < 0.55, 7,
                              rng.choice([2, 11], n))
    return chip_smoke.seeded_rows_work(rng, torch.as_tensor(bins), card,
                                       quantized)


#: (bin columns, quantized) of the rows partition cases: W = 31, 40, an
#: EFB-like bundle width of 21 and a 16-byte multiple of 64
ROWS_WIDTHS = ((28, True), (28, False), (9, False), (61, True))


@pytest.mark.parametrize("F,quantized", ROWS_WIDTHS)
def test_rows_partition_edges_on_card(card, F, quantized):
    """K3 rows against its twin (whole pair and lt equal) at the counts
    where the launch changes shape: 1, 31, a tile - 1 and + 1, the
    resident limit - 1, at it and + 1 (partition_rows_plan), from an
    unaligned start; all left, all right and empty; the same bytes twice
    in a row."""
    rng = np.random.RandomState(F + 100 * quantized)
    width = F + (3 if quantized else 12)
    sms = partition.sm_count(card.index)
    plan = partition.partition_rows_plan(1, width, sms)
    limit = sms * (partition.PART_ROWS_SMEM_BYTES // plan.slot_bytes) \
        * plan.tile_rows
    assert partition.partition_rows_plan(limit, width, sms).resident
    assert not partition.partition_rows_plan(limit + 1, width, sms).resident
    work, _ = _rows_pair(card, rng, limit + 64, F, quantized)
    tables = chip_smoke._tables(rng, 64, card)
    start = 128 + 13
    for cnt in (1, 31, plan.tile_rows - 1, plan.tile_rows + 1, limit - 1,
                limit, limit + 1):
        chip_smoke.check_partition("rows/%d" % cnt, work,
                                   [0, start, cnt, cnt % F], tables["table"],
                                   rows=True)
    for tbl in ("all", "none"):
        chip_smoke.check_partition("rows/" + tbl, work, [0, start, 5000, 1],
                                   tables[tbl], rows=True)
    chip_smoke.check_partition("rows/empty", work, [0, start, 0, 1],
                               tables["table"], rows=True)
    a, b = work.clone(), work.clone()
    seg = torch.tensor([0, start, 77777, 2], dtype=torch.int32, device=card)
    lt_a = partition.partition_segment_rows(a, seg, tables["table"], 77777)
    lt_b = partition.partition_segment_rows(b, seg, tables["table"], 77777)
    assert int(lt_a) == int(lt_b) and torch.equal(a, b)


@pytest.mark.parametrize("F,nb", ((28, 256), (61, 64), (5, 64), (200, 256)))
def test_int8_histogram_edges_on_card(card, F, nb):
    """K5 against its twin, byte for byte, call after call on one kept
    accumulator (each call must leave it zero): 0, 1, 31, 32 and 33 rows,
    a row block -1 and +1, a whole cluster of row blocks +1, the 2M-row
    root's grid, from an unaligned start; an all out-of-bag segment; a
    skewed feature; W = F + 3 = 31, 64, 8 and 203 (read in place, three
    feature groups at 256 bins)."""
    rng = np.random.RandomState(F)
    rpb = histogram.HIST_Q_ROWS_PER_BLOCK
    block_rows = histogram.HIST_Q_CLUSTER * rpb
    n = 140_000 if F < 100 else 40_000
    work, scale = _rows_pair(card, rng, n, F, True, nb, skew=True)
    start = 128 + 13
    for cnt in (0, 1, 31, 32, 33, rpb - 1, rpb + 1, block_rows + 1,
                n - 13):
        chip_smoke.check_histogram_q("q/%d" % cnt, work, [0, start, cnt],
                                     nb, F, scale)
    oob = work.clone()
    oob[0, start:start + 3000, F:F + 3] = 0
    chip_smoke.check_histogram_q("q/out_of_bag", oob, [0, start, 3000], nb,
                                 F, scale)
    got = histogram.segment_histogram_q(
        oob, torch.tensor([0, start, 3000], dtype=torch.int32, device=card),
        scale, num_bins=nb, num_feat=F, cnt_bound=3000)
    assert int(torch.count_nonzero(got)) == 0
    chip_smoke.check_histogram_q("q/after", work, [0, start + 1, 4099], nb,
                                 F, scale)


def test_planes_partition_edges_on_card(card):
    """K3 planes against its twin (whole pair and lt equal) at W = 17 and
    40: the counts where its launch changes shape (the resident limits
    included), all left, all right and alternating tables, buffer 1 as the
    source; the router against its twin on the chain, leaf-0, padded,
    bundled and 4000-round tables over 28, 136 and 3000 columns
    (chip_smoke.phase_planes_route_kernels)."""
    before = kernels.launch_counts()
    errs = chip_smoke.phase_planes_route_kernels(card,
                                                 np.random.RandomState(23))
    assert max(errs.values()) == 0.0
    after = kernels.launch_counts()
    for name in ("partition_segment", "route_rows"):
        assert after[name] > before[name], name


def test_planes_partition_same_bytes_twice_on_card(card):
    """One launch per split, the same bytes and lt call after call, with
    a bound far above the count."""
    rng = np.random.RandomState(29)
    work = chip_smoke.planes_pair(rng, 40, partition.planes_npad(90_000),
                                  card)
    table = torch.as_tensor(rng.rand(64) < 0.5).to(card)
    seg = torch.tensor([0, 128 + 7, 77777, 3], dtype=torch.int32,
                       device=card)
    a, b = work.clone(), work.clone()
    n0 = kernels.launch_counts()["partition_segment"]
    lt_a = partition.partition_segment(a, seg, table, 77777)
    lt_b = partition.partition_segment(b, seg, table, 2_000_000)
    assert kernels.launch_counts()["partition_segment"] == n0 + 2
    assert int(lt_a) == int(lt_b) and torch.equal(a, b)
    chip_smoke.check_partition("planes/twice", work, [0, 128 + 7, 77777, 3],
                               table)


def test_split_commit_matches_twin_on_card(card):
    """The split commit against its twin on seeded states: tied and NaN
    gains, max_depth, monotone bounds, a split after the tree stopped
    (live 0), the final commit; every table, log and header bit-equal
    (chip_smoke.phase_commit_kernel)."""
    before = kernels.launch_counts()["split_commit"]
    errs = chip_smoke.phase_commit_kernel(card, np.random.RandomState(13))
    assert set(errs.values()) == {0.0}
    assert kernels.launch_counts()["split_commit"] - before \
        == len(chip_smoke.COMMIT_CASES)


def test_split_commit_full_width_slots_on_card(card):
    """The split commit at L = 255, F = 28, B = 255: the first, a middle,
    a dead and the final slot, tied and NaN gains, copying the children
    (B7, EFB: one wave of 16-byte copy blocks) and not (the scan pooled
    them), against its twin bit for bit."""
    errs = chip_smoke.phase_commit_kernel(card, np.random.RandomState(17),
                                          L=255, F=28, B=255,
                                          modes=(False, True))
    assert set(errs.values()) == {0.0}
    assert len(errs) == 2 * len(chip_smoke.COMMIT_CASES)
    assert commit.commit_blocks(28 * 255 * 3, False) > 2


def test_split_scan_fold_shapes_on_card(card):
    """The split scan with the chain's sibling folded in at F = 28 and
    137, B = 255, 907 and 1023, numerical and categorical, either child
    the smaller and a dead header: the pool rows and every output
    bit-equal to the torch sequence on the card, and direct mode bit-equal
    to find_best_split (chip_smoke.phase_fold_kernels). F = 137 loops the
    cluster's items."""
    before = kernels.launch_counts()["split_scan"]
    errs = chip_smoke.phase_fold_kernels(card, np.random.RandomState(43))
    assert set(errs.values()) == {0.0}, errs
    assert kernels.launch_counts()["split_scan"] > before
    assert scan.scan_shape(28, 255)["rounds"] == 1
    assert scan.scan_shape(137, 255)["rounds"] > 1     # the items loop
    for F, B in ((137, 255), (28, 907), (28, 1023)):
        assert scan.scan_shape(F, B)["ctas"] <= 16, (F, B)


def test_refused_launch_raises_without_fallback_on_card(card, monkeypatch):
    """A launch the kernels' entry points refuse raises, and no plain twin
    runs in its place."""
    def twin(*args, **kwargs):
        raise AssertionError("a plain twin ran on the card")

    monkeypatch.setattr(scan, "split_scan_plain", twin)
    monkeypatch.setattr(scan, "split_scan_fold_plain", twin)
    monkeypatch.setattr(commit, "split_commit_plain", twin)
    rng = np.random.RandomState(5)
    meta, hp, fmask, pool, small, pair = chip_smoke.seeded_scan_state(
        rng, card, 28, 255)
    op = scan.SplitScan(meta, fmask, hp, num_feat=28, num_bins=255,
                        device=card)
    out = partition.split_out(28, 255, card)
    hdr = chip_smoke.chain_header([0, 0, 0, 0], 1, 1, card, 3, slot=2)
    op._args.B = 4000                    # past the kernel's bins: refused
    with pytest.raises(RuntimeError, match="split_scan"):
        op.fold(small, pool, hdr, 3, pair, out)
    st, cout = chip_smoke.commit_state(card, rng, 63, 9, 40)
    cop = commit.SplitCommit(st, cout, max_depth=-1,
                             monotone=torch.zeros(9, dtype=torch.int8,
                                                  device=card),
                             has_monotone=False)
    cop._blocks = 1                      # a copying commit without copy
    with pytest.raises(RuntimeError, match="split_commit"):  # blocks
        cop(5)


def test_one_kernel_header_on_card(card):
    """B7 through its device header: the parent read from a pool row gives
    the bits the parent alone gives, and live = 0 writes nothing
    (chip_smoke.check_one_kernel_header)."""
    errs = chip_smoke.phase_one_kernel_header(card,
                                              np.random.RandomState(15))
    assert set(errs.values()) == {0.0}


@pytest.fixture(scope="module")
def fused_data():
    return chip_smoke.training_data(2, 200000, 5000)


@pytest.mark.parametrize("extra", ["one_kernel", "resident", "three_launch",
                                   "resident_three_launch", "rows",
                                   "quantized"])
def test_fused_training_equals_per_iteration_on_card(card, fused_data,
                                                     extra):
    """200,000 rows: the fused path (the device tree loop and its CUDA
    graph: the one-kernel split, or the three-launch chain with the split
    scan on planes, resident, rows and int8 rows) byte-equal to the
    per-iteration path (the per-split host loop and torch's scan)."""
    import lightgbm_tpu_torch as lgt
    X, y = fused_data[0], fused_data[1]
    params = chip_smoke.train_params(card, 63, {
        "one_kernel": chip_smoke.ONE_KERNEL_PARAMS,
        "resident": chip_smoke.RESIDENT_PARAMS,
        "three_launch": {"tpu_split_kernel": "off"},
        "resident_three_launch": {"tpu_resident_state": "on",
                                  "tpu_split_kernel": "off"},
        "rows": {"tpu_work_layout": "rows"},
        "quantized": chip_smoke.QUANT_PARAMS}[extra])
    kernels.reset_launch_counts()
    fused = lgt.train(params, lgt.Dataset(X, label=y, params=params), 4)
    counts = kernels.launch_counts()
    eager = lgt.train(params, lgt.Dataset(X, label=y, params=params), 4,
                      callbacks=[lambda env: None])
    assert fused.inner._fused is not None
    assert fused.model_to_string() == eager.model_to_string()
    assert counts["split_commit"] == 4 * 63
    assert counts["split_scan"] == (0 if extra in ("one_kernel", "resident")
                                    else 4 * 62)
    assert fused.inner.learner._loop.graph is not None


def test_chain_kernels_match_plain_on_card(card):
    """The chain's launches with static plans against the per-split path,
    the split scan against find_best_split on the card bit for bit, and
    the categorical router against its twin
    (chip_smoke.phase_chain_kernels)."""
    before = kernels.launch_counts()
    errs = chip_smoke.phase_chain_kernels(card, np.random.RandomState(41))
    assert max(errs.values()) == 0.0, errs
    after = kernels.launch_counts()
    for name in ("split_scan", "route_rows_cat", "partition_segment",
                 "partition_segment_rows", "segment_histogram_q",
                 "write_route_plane", "segment_histogram_resident"):
        assert after[name] > before[name], name


def test_mixed_fused_equals_per_iteration_on_card(card):
    """Categorical and EFB data (chip_smoke.mixed_data, 50,000 rows, 3
    trees): fused through the device loop byte-equal to per iteration,
    with one-vs-rest and many-vs-many splits; the categorical router on
    the model's trees equal to its twin."""
    _, counts, summary, errs, _ = chip_smoke.phase_mixed(
        card, 1, "test", rows=50000, trees=3, timed=False)
    assert summary["one_vs_rest"] > 0 and summary["many_vs_many"] > 0
    assert counts["route_rows_cat"] == 3 and max(errs.values()) == 0.0


def test_graph_replay_equals_loop_on_card(card, fused_data):
    """The device tree loop replayed from its CUDA graph equals the same
    loop run eagerly without the graph, tree after tree, and each replay
    counts its captured launches."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.learner import TreeLog
    X, y = fused_data[0], fused_data[1]
    params = chip_smoke.train_params(card, 63, chip_smoke.ONE_KERNEL_PARAMS)
    g = lgt.Booster(params, lgt.Dataset(X, label=y, params=params)).inner
    lrn = g.learner
    grad, hess = g.objective.get_gradients(g.train_score.score)
    fmask = torch.ones(lrn.dataset.num_features, dtype=torch.bool,
                       device=card)
    for i, scale in enumerate((1.0, 0.5, 2.0, 1.0)):
        ghc = torch.stack([grad * scale, hess, torch.ones_like(grad)], dim=1)
        before = kernels.launch_counts()
        got = lrn.train_device(ghc, fmask)
        after = kernels.launch_counts()
        loop = lrn._loop
        assert (loop.graph is not None) == (i > 0)
        if i > 1:
            assert {k: after[k] - before[k] for k in after
                    if after[k] != before[k]} == loop.replay_launches
        want = TreeLog(*(t.clone() for t in loop.grow()))
        for fld in got._fields:
            assert torch.equal(getattr(got, fld), getattr(want, fld)), fld


def test_lambda_kernel_matches_twin_on_card(card):
    """The lambda kernel against its twin (chip_smoke.phase_rank_kernels):
    a 5,000- and a 1,100-document query (the global-memory path), one
    document, an empty query, all labels 0, all-tied, seeded, grid and
    partly NaN scores, weights, no norm and truncations above, below and
    between the lengths; NaN in the twin's rows, each other row within
    rank.LAMBDA_RTOL of its query's largest value."""
    before = kernels.launch_counts()["rank_lambdas"]
    errs = chip_smoke.phase_rank_kernels(card, np.random.RandomState(13))
    assert len(errs) == 16 and np.isfinite(list(errs.values())).all()
    assert kernels.launch_counts()["rank_lambdas"] - before == 16


def test_cuda_tensor_never_takes_the_lambda_twin(card, monkeypatch):
    """On a CUDA tensor the objective launches the kernel and never calls
    the twin; a failed launch raises instead of falling back."""
    obj = chip_smoke.rank_objective(card, (40, 7, 300),
                                    np.random.RandomState(2))

    def refuse(*_a, **_k):
        raise AssertionError("the twin ran on a CUDA tensor")

    monkeypatch.setattr(rank, "lambdarank_gradients_plain", refuse)
    score = torch.randn(obj.num_data, device=card)
    before = kernels.launch_counts()["rank_lambdas"]
    g, h = obj.get_gradients(score)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["rank_lambdas"] == before + 1
    assert torch.isfinite(g).all() and bool((h > 0).all())

    def broken(*_a, **_k):
        raise RuntimeError("rank_lambdas: CUDA error 1 (invalid argument)")

    monkeypatch.setattr(rank.RANK_KERNEL, "launch", broken)
    with pytest.raises(RuntimeError, match="rank_lambdas"):
        obj.get_gradients(score)


def test_small_ranking_training_on_card(card):
    """Phase 3f at a small size: lambdarank fused through the lambda
    kernel and the device tree loop (a second run byte-equal, the
    per-iteration trees byte-equal to the fused ones), the lambda checks,
    rank_xendcg's draws card vs host and fused rank_xendcg trees."""
    summary, counts, _, errs = chip_smoke.phase_rank(
        card, "test", rows=40000, trees=4, per_iter=2, xendcg_trees=2,
        timed=False, extra={"num_leaves": 31, "tpu_iter_block": 2})
    assert counts["rank_lambdas"] == 4
    assert summary["model_sha256"] == summary["second_model_sha256"]
    assert errs["prng/gumbel_ulps"] <= 2.0
    assert {"rank/one_kernel/full_width", "rank/one_kernel/deep",
            "rank/commit/full_width_s1",
            "rank/router/full_width_valid"} <= set(errs)


def test_small_objectives_card_vs_host(card):
    """Phase 3g at a small size: every other objective on the
    card and on the host."""
    data = chip_smoke.training_data(1, 20000, 0)
    out = chip_smoke.phase_objectives(card, data, "test", rows=20000,
                                      trees=2, leaves=15)
    assert set(out) == set(chip_smoke.OBJECTIVES)


def test_node_inputs_match_twin_on_card(card):
    """The node inputs kernel against its twin run by torch on the card
    (chip_smoke.check_node_draws): by-node masks, extra-trees bins,
    constraint masks and CEGB penalties bit-equal at F = 28 and 137 (and
    137 with 300 constraint sets), the leaf given or read from a header
    word, a dead live word."""
    before = kernels.launch_counts()["node_inputs"]
    rng = np.random.RandomState(21)
    for F, S in ((28, 3), (137, 3), (137, chip_smoke.NODE_MANY_SETS)):
        assert chip_smoke.check_node_draws("F%d" % F, card, rng, F,
                                           S=S) == 0.0
    assert kernels.launch_counts()["node_inputs"] - before == 3 * (8 + 1)


def test_extended_commit_matches_twin_on_card(card):
    """The split commit with forced splits and used features against its
    twin: a forced round, a forced round whose leaf cannot split there and
    one where nothing can split (chip_smoke.phase_commit_options)."""
    errs = chip_smoke.phase_commit_options(card, np.random.RandomState(8))
    assert set(errs) == {"commit/" + c[0]
                         for c in chip_smoke.COMMIT_FORCED_CASES}


def test_options_scan_and_forced_leaf_on_card(card, tmp_path):
    """The split scan with every node input live against find_best_split
    at a small learner's root and deep leaf, and the forced leaf's scan at
    each forced slot (chip_smoke.phase_options_kernels)."""
    data = chip_smoke.training_data(2, 30000, 0)
    forced = chip_smoke.forced_json(str(tmp_path / "forced.json"))
    errs, _, _ = chip_smoke.phase_options_kernels(
        card, np.random.RandomState(9), data, forced, 30000, 31)
    assert {"split_scan/options/root", "split_scan/options/deep"} \
        <= set(errs)
    assert max(errs.values()) == 0.0


def test_monotone_kernels_match_twins_on_card(card):
    """mono_bounds and mono_commit against their twins run by torch on the
    card, bit for bit, at F = 28 and 137 (L = 63) and at F = 28, L = 255:
    a numerical winner, a categorical one and an invalid round
    (chip_smoke.check_mono_kernels)."""
    before = kernels.launch_counts()
    rng = np.random.RandomState(31)
    shapes = [(F, 63) for F in chip_smoke.MONO_CHECK_FEATURES] + [(28, 255)]
    for F, L in shapes:
        errs = chip_smoke.check_mono_kernels(card, rng, F, L=L)
        assert len(errs) == 9 and max(errs.values()) == 0.0
    after = kernels.launch_counts()
    n = len(shapes) * 3
    assert after["mono_bounds"] - before["mono_bounds"] == 2 * n
    assert after["mono_commit"] - before["mono_commit"] == n


def test_monotone_commit_matches_twin_on_card(card):
    """The split commit under the intermediate and advanced methods (the
    re-clamp, the swap, the boxes, the neighbour refresh) against its twin
    at L = 63, F = 9, B = 40 and at L = 255, F = 28, B = 255
    (chip_smoke.check_commit_mono)."""
    rng = np.random.RandomState(33)
    errs = chip_smoke.check_commit_mono(card, rng)
    errs.update(chip_smoke.check_commit_mono(card, rng, L=255, F=28, B=255,
                                             suffix="/full_width"))
    assert len(errs) == 2 * 2 * (len(chip_smoke.COMMIT_MONO_CASES) + 1)


def test_advanced_scan_on_card(card):
    """The split scan with per-candidate bounds against find_best_split
    with adv_bounds at a small advanced learner's root and deep leaf
    (chip_smoke.phase_monotone_kernels)."""
    data = chip_smoke.training_data(3, 30000, 0)
    errs = chip_smoke.phase_monotone_kernels(
        card, np.random.RandomState(35), data, 30000, 31)
    assert {"split_scan/advanced/root", "split_scan/advanced/deep"} \
        <= set(errs)
    assert max(errs.values()) == 0.0


@pytest.mark.parametrize("method", ["intermediate", "advanced"])
def test_monotone_fused_equals_per_iteration_on_card(card, method):
    """Both monotone methods train fused on the card's device tree loop
    (the chain) and give the per-iteration model byte for byte."""
    import lightgbm_tpu_torch as lgt
    X, y, _, _ = chip_smoke.training_data(4, 20000, 0)
    params = chip_smoke.train_params(
        card, 31, chip_smoke.monotone_configs()[method])
    fused = lgt.train(dict(params), lgt.Dataset(X, label=y, params=params),
                      4)
    assert fused.inner._fused is not None
    eager = lgt.train(dict(params), lgt.Dataset(X, label=y, params=params),
                      4, callbacks=[lambda env: None])
    assert fused.model_to_string() == eager.model_to_string()


def test_linear_dense_kernels_match_plain_on_card(card):
    """Phase 3j's kernels against their twins on seeded inputs
    (chip_smoke.phase_linear_dense_kernels): the Gram kernel within its
    f32 summation bound with equal counts and fit_ok; the dense histogram
    within its bound, counts equal, on u8 and u16 rows, by leaf and by
    header, a dead header writing nothing; the row update equal; the split
    scan past 256 bins bit-equal to find_best_split; the u16 router equal
    to the plain router."""
    before = kernels.launch_counts()
    chip_smoke.phase_linear_dense_kernels(card, np.random.RandomState(61))
    after = kernels.launch_counts()
    for name in ("linear_gram", "dense_histogram", "dense_row_update",
                 "split_scan", "route_rows_u16"):
        assert after[name] > before[name], name


def test_dense_device_loop_equals_host_loop_on_card(card):
    """The dense builder's device tree loop (the row update and the
    smaller child's histogram by header, the scan and the commit; a CUDA
    graph from the second tree) grows the per-split host loop's trees on
    the card, field by field, at 1023 bins (u16) and at 255; on the
    card the learner's ``train`` is the device loop."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.prng import PRNGKey

    X, y, _, _ = chip_smoke.training_data(2, 100_000, 0)
    for extra in ({"max_bin": 1023}, {"tree_builder": "dense"}):
        params = chip_smoke.train_params(card, 63, extra)
        bst = lgt.Booster(params, lgt.Dataset(X, label=y, params=params))
        g = bst.inner
        lrn = g.learner
        assert lrn.dense and lrn.train_on_loop
        grad, hess = g.objective.get_gradients(g.train_score.score)
        for t in range(3):
            ghc = torch.stack([grad * (1 + t), hess, torch.ones_like(grad)],
                              dim=1)
            a = lrn.train_host_loop(ghc, key=PRNGKey(t))
            b = lrn.train(ghc, key=PRNGKey(t))
            for fld, x, z in zip(a._fields, a, b):
                assert torch.equal(x, z), (extra, t, fld)


def test_linear_device_off_refused_on_card(card):
    """``linear_device=off`` (the host oracle) is refused on the card;
    ``auto`` fits with the Gram kernel there."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.utils.log import LightGBMError

    X, y, _, _ = chip_smoke.training_data(4, 5_000, 0)
    for mode in ("off", "auto"):
        params = chip_smoke.train_params(card, 15, {
            "linear_tree": True, "linear_device": mode})
        ds = lgt.Dataset(X, label=y, params=params)
        if mode == "off":
            with pytest.raises(LightGBMError, match="linear_device=off"):
                lgt.train(params, ds, 2)
            continue
        before = kernels.launch_counts()["linear_gram"]
        lgt.train(params, ds, 2)
        assert kernels.launch_counts()["linear_gram"] > before


def test_linear_training_card_vs_host(card):
    """Linear trees on the card (the Gram kernel) against the host (its
    twin) at a small size: splits agree, train logloss within
    chip_smoke.LINEAR_METRIC_TOL."""
    data = chip_smoke.training_data(3, 30_000, 0)
    res = chip_smoke.linear_card_vs_host(card, data, 30_000, 3, 31)
    assert res["splits_agree"] == res["splits"] > 0


def test_raw_walk_edges_match_twin_on_card(card):
    """The raw-threshold walk (csrc/forest_predict.cu's forest_raw)
    against its twin on every chip_smoke.RAW_EDGE_CASES pack (each
    missing type at its edges, categorical sets with NaN, inf and
    non-integers, 3 classes, linear leaves with NaN, a 254-round chain, a
    chain past FOREST_MAX_ROUNDS (tables in device memory), no splits,
    padded rounds and trees, 1000 columns read from device memory) at 1,
    255, 257 and 4097 rows: bit-equal, linear leaves within tolerance."""
    before = kernels.launch_counts()["forest_raw"]
    errs = chip_smoke.phase_raw_kernels(card, np.random.RandomState(13))
    assert max(errs.values()) <= 1e-5, errs
    assert kernels.launch_counts()["forest_raw"] > before


def test_model_text_serves_through_the_raw_walk_on_card(card):
    """A booster read from its text has no bin mappers: its session on the
    card launches the raw walk, never the twin, and answers as the twin
    does on the host, bit for bit."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import predict as predict_ops
    from lightgbm_tpu_torch.serve import PredictSession

    rng = np.random.RandomState(4)
    X = chip_smoke.higgs_like(rng, 3000)
    y = chip_smoke.higgs_labels(rng, X)
    bst = lgt.train({"objective": "binary", "num_leaves": 31,
                     "verbosity": -1, "device_type": "cpu"},
                    lgt.Dataset(X, label=y), 5)
    text = bst.model_to_string()
    on_card = PredictSession(lgt.Booster({"device_type": "cuda"},
                                         model_str=text))
    on_host = PredictSession(lgt.Booster({"device_type": "cpu"},
                                         model_str=text))
    calls = []
    twin = predict_ops.predict_raw_impl

    def counted(X_, *a, **k):
        calls.append(X_.device.type)
        return twin(X_, *a, **k)

    predict_ops.predict_raw_impl = counted
    try:
        before = kernels.launch_counts()["forest_raw"]
        got = on_card.predict(X[:700])
        after = kernels.launch_counts()["forest_raw"]
        want = on_host.predict(X[:700])
    finally:
        predict_ops.predict_raw_impl = twin
    assert after > before and calls == ["cpu"]
    assert np.asarray(got).tobytes() == np.asarray(want).tobytes()


def test_deep_model_text_serves_through_the_raw_walk_on_card(card):
    """Chain trees one round deeper than the forest kernel's shared
    memory holds (chip_smoke.chain_trees, FOREST_MAX_ROUNDS + 1 rounds),
    served from their text: the raw walk reads the tables from device
    memory and answers as the twin does on the host, bit for bit."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import forest as Fo
    from lightgbm_tpu_torch.serve import PredictSession

    rng = np.random.RandomState(6)
    X = chip_smoke.higgs_like(rng, 3000)
    y = chip_smoke.higgs_labels(rng, X)
    bst = lgt.train({"objective": "binary", "num_leaves": 7,
                     "verbosity": -1, "device_type": "cpu"},
                    lgt.Dataset(X, label=y), 8)
    g = bst.inner
    g.models = chip_smoke.chain_trees(g.train_set, rng, 8,
                                      Fo.FOREST_MAX_ROUNDS + 1)
    g._bump_model_version()
    text = bst.model_to_string()
    on_card = lgt.Booster({"device_type": "cuda"}, model_str=text)
    pk = on_card.inner._packed_model(0, 8)[0]
    R, T = pk.slot.shape[1], pk.slot.shape[0]
    assert R == Fo.FOREST_MAX_ROUNDS + 1
    assert not Fo.forest_plan(700, T, R, 132, X.shape[1], 1,
                              raw=True).tables
    before = kernels.launch_counts()["forest_raw"]
    got = PredictSession(on_card).predict(X[:700])
    assert kernels.launch_counts()["forest_raw"] > before
    want = PredictSession(lgt.Booster({"device_type": "cpu"},
                                      model_str=text)).predict(X[:700])
    assert np.asarray(got).tobytes() == np.asarray(want).tobytes()


def test_data_parallel_group_card_vs_host_on_card(card, tmp_path):
    """Two ranks sharing the card (gloo, the card's tensors staged through
    host memory) train tree_learner=data, and the same group trains it on
    the host: every rank's model equal, the card's first tree equal to the
    host's split for split, train logloss within LOGLOSS_TOL, and every
    rank launched the partition, histogram and router kernels (never the
    one-kernel split)."""
    import lightgbm_tpu_torch as lgt

    X, y, _, _ = chip_smoke.training_data(3, 20_000, 0)
    params = dict(chip_smoke.train_params(card, 31), verbosity=-1,
                  tree_learner="data", metric=["binary_logloss"])
    npz = str(tmp_path / "train.npz")
    lgt.Dataset(X, label=y, params=params).save_binary(npz)
    cases = [(name, "train", on_card, 2, dict(npz=npz, valid_npz=None,
                                              params=params, trees=3,
                                              want_text=True))
             for name, on_card in (("card", True), ("host", False))]
    outs = chip_smoke.run_rank_group(card, 2, cases, str(tmp_path / "g"),
                                     timeout_s=600)
    for name in ("card", "host"):
        assert len({o[name]["sha"] for o in outs}) == 1, name
    for o in outs:
        assert o["backend"] == "gloo" and o["device"].startswith("cuda")
        got = o["card"]["launches"]
        for k in chip_smoke.PARALLEL_F32_KERNELS:
            assert got.get(k, 0) > 0, (k, got)
        assert got.get("one_kernel_split", 0) == 0
        assert o["card"]["comm"]["staged_bytes"] > 0
        assert o["host"]["comm"]["staged_bytes"] == 0
    ca = lgt.Booster({"device_type": "cpu"}, model_str=outs[0]["card"]["text"])
    ho = lgt.Booster({"device_type": "cpu"}, model_str=outs[0]["host"]["text"])
    _, _, first = chip_smoke.split_agreement(ca, ho)
    assert first[0] == first[1]
    assert abs(outs[0]["card"]["train_metric"]
               - outs[0]["host"]["train_metric"]) <= chip_smoke.LOGLOSS_TOL
