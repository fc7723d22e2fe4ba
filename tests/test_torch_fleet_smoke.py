"""chip_smoke.py's phase 3l (the fleet on the card) rehearsed on the host
at a tiny size: the raw walk's edge packs and the served models against
the twin (both sides the twin here), a trainer and two replicas (one a
``python -m lightgbm_tpu_torch task=serve fleet_role=replica``
subprocess) serving and training, every answer one published version's,
failover with a fenced zombie, and snapshot compaction.

The rehearsal runs in a fresh interpreter: its servers, trainer and
replica watcher are threads that share the interpreter lock, and a test
worker may still hold busy threads that an earlier test file left behind
(tests/test_failover.py's HTTP servers keep more than a core busy after
the file ends; after it in one process the rehearsal ran many times
longer)."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REHEARSAL = r"""
import json, sys
import torch
sys.path.insert(0, %r)
import chip_smoke
torch.set_num_threads(1)
for name, value in (("RAW_EDGE_ROWS", (1, 255, 257, 600)),
                    ("RAW_EDGE_CASES", ("mixed_missing", "categorical",
                                        "multiclass3", "linear_nan")),
                    ("FLEET_INGEST_ROWS", 256),
                    ("FLEET_LATENCY_WINDOW_S", 0.3),
                    ("FLEET_PREDICT_PAUSE_S", 0.05)):
    setattr(chip_smoke, name, value)
data = chip_smoke.training_data(0, 3000, 2000)
summary, counts, row, errs = chip_smoke.phase_fleet(
    torch.device("cpu"), data, "cpu", trees=3, leaves=7, timed=False,
    kind_rows=(2000, 2000, 2000))
print(json.dumps({"summary": summary, "row": row, "errs": errs},
                 default=str))
""" % REPO


def test_phase_fleet_rehearsal():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _REHEARSAL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    res = json.loads(out.stdout.strip().splitlines()[-1])
    summary, row, errs = res["summary"], res["row"], res["errs"]
    assert row is None and max(errs.values()) == 0.0
    serving = summary["serving"]
    assert serving["failures"] == 0 and serving["answers"] > 0
    assert serving["served_versions"] == [1, 2]
    assert set(serving["predict_latency_ms"]) == {"before", "cycle",
                                                  "after"}
    failover = summary["failover"]
    sys.path.insert(0, REPO)
    import chip_smoke
    assert failover["takeover_s"] <= 2 * chip_smoke.FLEET_TTL_S
    assert failover["lease_epoch"] == 2 and failover["win_streak"] == 1
    assert "fenced off" in failover["zombie_refused"]
    assert failover["buffer_sha256"] and failover["snapshot_rows"] > 0
