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
from lightgbm_tpu_torch.ops import (forest, histogram, kernels,  # noqa: E402
                                    partition, route)  # noqa: F401

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
