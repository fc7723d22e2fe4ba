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
# importing forest and route registers their kernels' launch counters
from lightgbm_tpu_torch.ops import forest, kernels, route  # noqa: E402,F401

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
    assert after["forest_predict"] > before["forest_predict"]
    assert after["route_rows"] > before["route_rows"]


def test_small_serving_path_on_card(card, tmp_path):
    bst, train, rng = chip_smoke.build_main_model(
        1, 16, 63, 20000, str(tmp_path))
    out, counts = chip_smoke.phase_serve(bst, train, rng, 100000)
    assert counts["forest_predict"] > 0 and counts["route_rows"] == 16
    errs = chip_smoke.check_serve(bst, out)
    assert np.isfinite(list(errs.values())).all()
