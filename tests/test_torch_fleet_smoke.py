"""chip_smoke.py's phase 3l (the fleet on the card) rehearsed on the host
at a tiny size: the raw walk's edge packs and the served models against
the twin (both sides the twin here), a trainer and two replicas (one a
``python -m lightgbm_tpu_torch task=serve fleet_role=replica``
subprocess) serving and training, every answer one published version's,
failover with a fenced zombie, and snapshot compaction."""
import os
import sys

import pytest
import torch

from torch_port_cases import torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread_module():
    with torch_threads(1):
        yield


def test_phase_fleet_rehearsal(monkeypatch):
    for name, value in (("RAW_EDGE_ROWS", (1, 255, 257, 600)),
                        ("RAW_EDGE_CASES", ("mixed_missing", "categorical",
                                            "multiclass3", "linear_nan")),
                        ("FLEET_INGEST_ROWS", 256),
                        ("FLEET_LATENCY_WINDOW_S", 0.3),
                        ("FLEET_PREDICT_PAUSE_S", 0.05)):
        monkeypatch.setattr(chip_smoke, name, value)
    data = chip_smoke.training_data(0, 3000, 2000)
    summary, counts, row, errs = chip_smoke.phase_fleet(
        torch.device("cpu"), data, "cpu", trees=3, leaves=7, timed=False,
        kind_rows=(2000, 2000, 2000))
    assert row is None and max(errs.values()) == 0.0
    serving = summary["serving"]
    assert serving["failures"] == 0 and serving["answers"] > 0
    assert serving["served_versions"] == [1, 2]
    assert set(serving["predict_latency_ms"]) == {"before", "cycle",
                                                  "after"}
    failover = summary["failover"]
    assert failover["takeover_s"] <= 2 * chip_smoke.FLEET_TTL_S
    assert failover["lease_epoch"] == 2 and failover["win_streak"] == 1
    assert "fenced off" in failover["zombie_refused"]
    assert failover["buffer_sha256"] and failover["snapshot_rows"] > 0
