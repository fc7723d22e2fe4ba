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


def test_small_serving_path_on_card(card, trained_on_card):
    bst, _, _, train = trained_on_card
    rng = np.random.RandomState(1)
    out, counts = chip_smoke.phase_serve(bst, train, rng, 100000)
    assert counts["forest_predict"] > 0 and counts["route_rows"] == 4
    errs = chip_smoke.check_serve(bst, out)
    assert np.isfinite(list(errs.values())).all()
