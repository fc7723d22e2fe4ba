"""``chip_smoke.py`` rehearsed on the CPU at a small size: its seeded
model and data builders, the kernels-vs-plain phase and the main serving
path run end to end through the kernels' plain twins (on the card the
same code launches the kernels), and the script itself refuses to run
without a card."""
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


def test_kernels_phase_covers_every_branch_on_cpu():
    errs = chip_smoke.phase_kernels(CPU, 0)
    assert set(errs) == {
        "forest/numerical", "forest/nan_missing", "forest/categorical",
        "forest/multiclass3", "forest/linear", "forest/linear_nan",
        "router/dense", "router/efb_bundles"}
    assert all(e <= 1e-6 for e in errs.values()), errs


def test_serve_phase_small_on_cpu(tmp_path):
    bst, train, rng = chip_smoke.build_main_model(
        0, 8, 31, 3000, str(tmp_path), device_type="cpu")
    assert bst.inner.train_set.num_total_features \
        == chip_smoke.HIGGS_FEATURES
    out, counts = chip_smoke.phase_serve(bst, train, rng, 5000)
    assert counts == {"forest_predict": 0, "route_rows": 0}  # plain twins
    errs = chip_smoke.check_serve(bst, out)
    assert max(errs.values()) <= 1e-6, errs
    assert out["binned"].shape == (5000,)


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
