"""The port's fleet failover on the CPU, mirroring the non-slow cases of
tests/test_failover.py: the trainer lease with epoch fencing, corrupt
artifacts and orphan reaping, torn tails, compaction that replays bit for
bit, standby takeover, the seeded chaos plans and the remote store."""

import json
import os
import shutil
import sys
import threading
import time
from urllib.request import urlopen

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import lightgbm_tpu_torch as lgb  # noqa: E402
from lightgbm_tpu_torch.fleet import FleetStore, RemoteStore, ReplicaWatcher, \
    CorruptArtifactError, StaleLeaseError, TransportError, chaos  # noqa: E402
from lightgbm_tpu_torch.fleet.chaos import FaultPlan, InjectedFault  # noqa: E402
from lightgbm_tpu_torch.obs import telemetry  # noqa: E402
from lightgbm_tpu_torch.online import OnlineTrainer  # noqa: E402
from lightgbm_tpu_torch.serve import PredictServer  # noqa: E402
from lightgbm_tpu_torch.utils.log import LightGBMError  # noqa: E402

from torch_port_cases import CPU, torch_threads  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread_module():
    with torch_threads(1):
        yield

W = np.array([1.2, -0.8, 0.5, 0.0, 0.3, -0.4])


def _data(n, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, len(W))
    y = (X @ W + 0.2 * rng.randn(n) > 0).astype(np.float64)
    return X, y


def _train(n=300, seed=0, rounds=6):
    X, y = _data(n, seed)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "min_data_in_leaf": 5, "device_type": "cpu"}
    return lgb.train(params, lgb.Dataset(X, label=y),
                     num_boost_round=rounds)


def _start_server(server):
    th = threading.Thread(target=server.serve_forever,
                          name="failover-test-http", daemon=True)
    th.start()
    return th


def _trainer(bst, store, **kw):
    """Trainer with the gate wide open (threshold 2.0) so a refit
    candidate always banks a win — the tests exercise durability and
    failover, not the gate's judgment."""
    args = dict(trigger_rows=10**9, min_rows=50, shadow_rows=120,
                promote_threshold=2.0, promote_patience=2,
                store=store, start=False)
    args.update(kw)
    return OnlineTrainer(bst, **args)


# ----------------------------------------------------------------- lease

def test_lease_acquire_renew_release_and_epoch_bump(tmp_path):
    store = FleetStore(str(tmp_path), "m")
    assert store.lease_state()["held"] is False
    assert store.acquire_lease("a", ttl_s=30.0) == 1
    # held by a live holder: nobody else gets it
    assert store.acquire_lease("b", ttl_s=30.0) is None
    st = store.lease_state()
    assert st["held"] and st["holder"] == "a" and st["epoch"] == 1
    # heartbeat renews only at the exact (holder, epoch)
    assert store.renew_lease("a", 1, 30.0) is True
    assert store.renew_lease("a", 2, 30.0) is False
    assert store.renew_lease("b", 1, 30.0) is False
    # clean release expires immediately but keeps the epoch
    assert store.release_lease("b", 1) is False
    assert store.release_lease("a", 1) is True
    st = store.lease_state()
    assert st["held"] is False and st["epoch"] == 1
    # EVERY acquisition bumps the epoch — takeover and re-acquisition
    assert store.acquire_lease("b", ttl_s=30.0) == 2
    assert store.release_lease("b", 2) is True
    assert store.acquire_lease("b", ttl_s=30.0) == 3
    with pytest.raises(LightGBMError):
        store.acquire_lease("c", ttl_s=0.0)


def test_lease_expiry_allows_takeover(tmp_path):
    store = FleetStore(str(tmp_path), "m")
    assert store.acquire_lease("a", ttl_s=0.15) == 1
    assert store.acquire_lease("b", ttl_s=30.0) is None
    time.sleep(0.3)
    # the dead holder's lease lapsed: takeover, at a HIGHER epoch
    assert store.acquire_lease("b", ttl_s=30.0) == 2
    st = store.lease_state()
    assert st["holder"] == "b" and st["epoch"] == 2
    # the late original holder can still heartbeat-fail cleanly
    assert store.renew_lease("a", 1, 30.0) is False


def test_lease_renew_release_guarded_against_concurrent_acquirer(tmp_path):
    """renew/release run the same cross-process O_EXCL guard as
    acquire_lease: an old holder's read-modify-write must never land
    around a standby's takeover and resurrect the dead epoch. While a
    live acquirer holds the guard, renew/release back off (and the
    caller demotes) instead of writing blind."""
    store = FleetStore(str(tmp_path), "m")
    assert store.acquire_lease("a", ttl_s=30.0) == 1
    guard = os.path.join(str(tmp_path), "m", "lease.json.lock")
    with open(guard, "w") as f:
        f.write("424242")   # a live (fresh-mtime) concurrent acquirer
    assert store.renew_lease("a", 1, 30.0) is False
    assert store.release_lease("a", 1) is False
    # the lease file itself was never touched through the held guard
    assert store.lease_state()["holder"] == "a"
    os.unlink(guard)
    assert store.renew_lease("a", 1, 30.0) is True
    assert store.release_lease("a", 1) is True
    assert store.lease_state()["held"] is False


def test_unfenced_publish_applied_after_fenced_history(tmp_path):
    """Leasing switched OFF after a fenced tenure: epoch-0 publishes are
    exempt from stale-epoch rejection (the fleet must keep converging),
    but each one is counted and the first is warned about."""
    store = FleetStore(str(tmp_path), "m")
    assert store.acquire_lease("a", ttl_s=30.0) == 1
    store.set_fence("a", 1)
    assert store.publish("model-one") == 1
    assert store.release_lease("a", 1) is True
    # operator restarts the trainer with fleet_lease_ttl_s=0: no fence
    store.clear_fence()
    unfenced0 = telemetry.counter("fleet/unfenced_publishes")
    rejected0 = telemetry.counter("fleet/stale_publishes_rejected")
    assert store.publish("model-two") == 2
    assert telemetry.counter("fleet/unfenced_publishes") == unfenced0 + 1
    # replicas and cold boots both apply the unfenced publish
    assert store.latest_publish()["version"] == 2
    fresh = FleetStore(str(tmp_path), "m", orphan_grace_s=3600.0)
    assert [e["version"] for e in fresh.publishes()] == [1, 2]
    event, model = fresh.latest_valid_publish(0)
    assert event["version"] == 2 and model == "model-two"
    assert telemetry.counter("fleet/stale_publishes_rejected") == rejected0


def test_publish_fencing_blocks_zombie(tmp_path):
    store_a = FleetStore(str(tmp_path), "m")
    assert store_a.acquire_lease("a", ttl_s=0.15) == 1
    store_a.set_fence("a", 1)
    assert store_a.publish("model-one") == 1
    assert next(store_a.events("publish"))["lease_epoch"] == 1
    time.sleep(0.3)
    # a second process takes over after the ttl lapses
    store_b = FleetStore(str(tmp_path), "m")
    assert store_b.acquire_lease("b", ttl_s=30.0) == 2
    store_b.set_fence("b", 2)
    assert store_b.publish("model-two") == 2
    # the zombie's publish is refused BEFORE anything lands
    blocked0 = telemetry.counter("fleet/stale_publishes_blocked")
    with pytest.raises(StaleLeaseError):
        store_a.publish("zombie-model")
    assert telemetry.counter("fleet/stale_publishes_blocked") == blocked0 + 1
    # no event, no artifact, and the version sequence is untouched
    assert [e["version"] for e in store_b.publishes()] == [1, 2]
    assert store_b.publish("model-three") == 3
    assert store_b.load_model(3) == "model-three"


def test_stale_epoch_publish_rejected_by_readers(tmp_path):
    """A zombie write that RACED the fence check on another host: its
    event is in the log, but readers reject any publish whose epoch is
    below one already seen — while its version still raises the
    allocation floor so tokens are never reused."""
    store = FleetStore(str(tmp_path), "m")
    assert store.acquire_lease("a", ttl_s=0.05) == 1
    store.set_fence("a", 1)
    assert store.publish("model-one") == 1
    time.sleep(0.1)
    assert store.acquire_lease("b", ttl_s=30.0) == 2
    store.set_fence("b", 2)
    assert store.publish("model-two") == 2
    # forge the raced zombie append: epoch 1 landing AFTER epoch 2
    import hashlib
    data = b"zombie-model"
    with open(store.artifact_path(3), "wb") as f:
        f.write(data)
    with open(store.events_path, "a", encoding="utf-8") as f:
        f.write(json.dumps({
            "v": 1, "kind": "publish", "ts": 0.0, "version": 3,
            "artifact": "v000003.txt", "event": "promotion",
            "sha256": hashlib.sha256(data).hexdigest(),
            "bytes": len(data), "lease_epoch": 1, "meta": None}) + "\n")
    rejected0 = telemetry.counter("fleet/stale_publishes_rejected")
    fresh = FleetStore(str(tmp_path), "m", orphan_grace_s=3600.0)
    assert [e["version"] for e in fresh.publishes()] == [1, 2]
    assert fresh.latest_publish()["version"] == 2
    event, model = fresh.latest_valid_publish(0)
    assert event["version"] == 2 and model == "model-two"
    assert telemetry.counter("fleet/stale_publishes_rejected") \
        == rejected0 + 1
    # repeat scans dedupe the counter per version
    fresh.publishes()
    assert telemetry.counter("fleet/stale_publishes_rejected") \
        == rejected0 + 1
    # the zombie's token is burned: the next publish allocates past it
    fresh.set_fence("b", 2)
    assert fresh.publish("model-four") == 4


# ------------------------------------------------------------- integrity

def test_corrupt_artifact_fallback_and_dedup(tmp_path):
    store = FleetStore(str(tmp_path), "m")
    assert store.publish("model-one", event="boot") == 1
    assert store.publish("model-two") == 2
    # flip bytes in the newest artifact: same length, wrong sha256
    with open(store.artifact_path(2), "wb") as f:
        f.write(b"model-twX")
    corrupt0 = telemetry.counter("fleet/corrupt_artifacts")
    event, model = store.latest_valid_publish(0)
    assert event["version"] == 1 and model == "model-one"
    assert telemetry.counter("fleet/corrupt_artifacts") == corrupt0 + 1
    # counted once per version per instance, not per probe
    assert store.latest_valid_publish(0)[0]["version"] == 1
    assert telemetry.counter("fleet/corrupt_artifacts") == corrupt0 + 1
    # a truncated artifact fails the length check the same way
    with open(store.artifact_path(2), "wb") as f:
        f.write(b"model")
    with pytest.raises(CorruptArtifactError):
        store.load_publish(list(store.publishes())[-1])
    # a fresh, intact publish ends the fallback
    assert store.publish("model-three") == 3
    assert store.latest_valid_publish(0)[1] == "model-three"


def test_replica_skips_corrupt_artifact(tmp_path):
    bst_a, bst_b = _train(seed=0), _train(seed=3, rounds=8)
    store = FleetStore(str(tmp_path), "m")
    store.publish(bst_a.model_to_string(), event="boot")
    store.publish(bst_b.model_to_string())
    # corrupt the newest artifact on disk
    with open(store.artifact_path(2), "r+b") as f:
        f.write(b"corrupted beyond recognition")
    serving = lgb.Booster(CPU, model_str=bst_a.model_to_string())
    watcher = ReplicaWatcher(serving, store, start=False)
    # v2 is newer but corrupt: the poll falls back to v1 (the newest
    # publish that VERIFIES) instead of serving garbage or crashing
    assert watcher.poll_once() is True
    assert watcher.applied_version == 1
    Xq = _data(40, seed=9)[0]
    np.testing.assert_allclose(np.asarray(serving.predict(Xq)),
                               np.asarray(bst_a.predict(Xq)), rtol=1e-9)
    # the next good publish converges past the corruption
    store.publish(bst_b.model_to_string())
    assert watcher.poll_once() is True
    assert watcher.applied_version == 3
    np.testing.assert_allclose(np.asarray(serving.predict(Xq)),
                               np.asarray(bst_b.predict(Xq)), rtol=1e-9)


def test_orphan_artifacts_reaped_on_open(tmp_path):
    store = FleetStore(str(tmp_path), "m")
    store.publish("model-one")
    models = os.path.dirname(store.artifact_path(1))
    # a publisher that died between artifact replace and event append
    # leaves an unreferenced artifact; a died publish also leaves tmps
    orphan = os.path.join(models, "v000009.txt")
    stray = os.path.join(models, "v000002.txt.tmp.12345")
    for p in (orphan, stray):
        with open(p, "w", encoding="utf-8") as f:
            f.write("never published")
    # within the grace window nothing is touched (could be a live
    # publish racing this open)
    fresh = FleetStore(str(tmp_path), "m")
    assert os.path.exists(orphan) and os.path.exists(stray)
    assert fresh.state()["orphan_artifacts_reaped"] == 0
    # past the grace both are reaped; the referenced artifact survives
    reaped0 = telemetry.counter("fleet/orphan_artifacts_reaped")
    fresh = FleetStore(str(tmp_path), "m", orphan_grace_s=0.0)
    assert not os.path.exists(orphan) and not os.path.exists(stray)
    assert os.path.exists(fresh.artifact_path(1))
    assert fresh.state()["orphan_artifacts_reaped"] == 2
    assert telemetry.counter("fleet/orphan_artifacts_reaped") == reaped0 + 2
    assert fresh.load_model(1) == "model-one"


def test_torn_append_repaired_on_open(tmp_path):
    store = FleetStore(str(tmp_path), "m")
    X, y = _data(4, seed=1)
    store.append_ingest(X, y)
    store.append_gate("rejected", 0, 4, None)
    size_before = store.log_bytes()
    plan = FaultPlan({"store/append": [("torn", 0.4)]})
    with chaos.inject(plan):
        with pytest.raises(InjectedFault):
            store.append_gate("deferred", 1, 8, None)
    assert plan.injected() == {"store/append": 1}
    # the torn prefix is on disk, ending mid-line
    assert store.log_bytes() > size_before
    with open(store.events_path, "rb") as f:
        assert not f.read().endswith(b"\n")
    # a restarted store truncates the torn tail so its own appends can
    # never glue onto it and vanish
    repaired0 = telemetry.counter("fleet/torn_tail_repaired")
    fresh = FleetStore(str(tmp_path), "m")
    assert telemetry.counter("fleet/torn_tail_repaired") == repaired0 + 1
    assert fresh.log_bytes() == size_before
    fresh.append_gate("promoted", 0, 8, None)
    kinds = [(e["kind"], e.get("result")) for e in fresh.events()]
    assert kinds == [("ingest", None), ("gate", "rejected"),
                     ("gate", "promoted")]


def test_read_only_open_skips_destructive_maintenance(tmp_path):
    """A replica-role open over a shared filesystem is a pure reader: it
    must not truncate a tail it may be seeing mid-write, must not reap
    artifacts, and refuses to write outright."""
    store = FleetStore(str(tmp_path), "m")
    store.append_gate("rejected", 0, 4, None)
    assert store.publish("model-one", event="boot") == 1
    # a torn tail + an orphan artifact, as a reader might observe them
    # while a live writer is mid-publish
    with open(store.events_path, "a", encoding="utf-8") as f:
        f.write('{"v": 1, "kind": "ga')
    with open(store.artifact_path(9), "wb") as f:
        f.write(b"in-flight")
    size = store.log_bytes()
    repaired0 = telemetry.counter("fleet/torn_tail_repaired")
    replica = FleetStore(str(tmp_path), "m", read_only=True,
                         orphan_grace_s=0.0)
    assert replica.log_bytes() == size   # tail untouched
    assert os.path.exists(store.artifact_path(9))   # orphan untouched
    assert telemetry.counter("fleet/torn_tail_repaired") == repaired0
    assert replica.state()["read_only"] is True
    # reads work; every write surface is refused
    assert replica.latest_publish()["version"] == 1
    with pytest.raises(LightGBMError):
        replica.append_gate("promoted", 0, 8, None)
    with pytest.raises(LightGBMError):
        replica.publish("model-two")
    with pytest.raises(LightGBMError):
        replica.compact(watermark=0, wins=0, keep_rows=10)
    # a writer-role reopen still repairs the dead tail
    fresh = FleetStore(str(tmp_path), "m", orphan_grace_s=3600.0)
    assert fresh.log_bytes() < size
    assert telemetry.counter("fleet/torn_tail_repaired") == repaired0 + 1


# ------------------------------------------------------------ compaction

def test_compaction_replay_is_bit_identical(tmp_path):
    """The tentpole retention guarantee: compaction lands mid-shadow-
    window and a trainer replaying the compacted log is indistinguishable
    from one replaying the full log — same buffers, same streak, same
    next promotion, same promoted model string."""
    base = _train()
    base_str = base.model_to_string()
    orig = str(tmp_path / "orig")
    full = str(tmp_path / "full")
    store = FleetStore(orig, "m")
    tr = _trainer(lgb.Booster(CPU, model_str=base_str), store)
    for seed in (1, 2, 3):
        tr.ingest(*_data(30, seed=seed))
    assert tr.run_once() == "deferred"      # wins=1, watermark=90
    for seed in (4, 5):
        tr.ingest(*_data(25, seed=seed))    # 50 untrained rows on top
    st = tr.state()
    assert st["consumed_rows"] == 90 and st["win_streak"] == 1
    # shadow window (cap 120) spans the watermark: chunks 2..5 = 110 rows
    assert tr.buffer.shadow_rows == 110 and tr.buffer.rows == 50
    shutil.copytree(orig, full)
    summary = store.compact(watermark=90, wins=1,
                            keep_rows=tr.buffer.shadow_capacity)
    assert summary["dropped_rows"] == 30 and summary["dropped_events"] > 0
    full_store = FleetStore(full, "m")
    assert store.log_bytes() < full_store.log_bytes()
    kinds = [e["kind"] for e in store.events()]
    assert kinds[0] == "compact" and kinds.count("ingest") == 4
    # two cold boots: compacted vs untouched log
    bst_c = lgb.Booster(CPU, model_str=base_str)
    bst_f = lgb.Booster(CPU, model_str=base_str)
    tr_c = _trainer(bst_c, FleetStore(orig, "m"))
    tr_f = _trainer(bst_f, full_store)
    for a, b in ((tr_c, tr_f),):
        assert a.state()["consumed_rows"] == b.state()["consumed_rows"] == 90
        assert a.state()["win_streak"] == b.state()["win_streak"] == 1
        assert a.buffer.rows == b.buffer.rows == 50
        assert a.buffer.shadow_rows == b.buffer.shadow_rows == 110
    Xc, yc = tr_c.buffer.shadow()
    Xf, yf = tr_f.buffer.shadow()
    np.testing.assert_array_equal(Xc, Xf)
    np.testing.assert_array_equal(yc, yf)
    # the banked win completes identically: both promote, and the
    # refit on the replayed buffers yields the SAME model string
    assert tr_c.run_once() == "promoted"
    assert tr_f.run_once() == "promoted"
    assert bst_c.model_to_string() == bst_f.model_to_string()
    assert tr_c.state()["consumed_rows"] == tr_f.state()["consumed_rows"]


def test_trainer_compacts_and_bounds_log_and_artifacts(tmp_path):
    compactions0 = telemetry.counter("fleet/compactions")
    store = FleetStore(str(tmp_path), "m")
    bst = _train()
    tr = _trainer(bst, store, min_rows=40, shadow_rows=80,
                  promote_patience=1, compact_bytes=6000,
                  keep_artifacts=2)
    for i in range(6):
        tr.ingest(*_data(40, seed=10 + i))
        assert tr.run_once() == "promoted"
    st = store.state()
    assert st["compactions"] >= 2
    assert st["last_compaction_ts"] > 0
    assert telemetry.counter("fleet/compactions") >= compactions0 + 2
    # retention: ingest rows in the log are bounded by the shadow
    # capacity (+ at most the newest chunk), publishes by keep_artifacts
    assert sum(e["n"] for e in store.events("ingest")) <= 120
    pubs = store.publishes()
    assert len(pubs) <= 2
    assert pubs[-1]["version"] == 6
    models_dir = os.path.dirname(store.artifact_path(1))
    kept = [n for n in os.listdir(models_dir) if n.endswith(".txt")]
    assert len(kept) <= 2
    # dropped artifacts are really gone; kept ones still verify
    assert not os.path.exists(store.artifact_path(1))
    assert store.latest_valid_publish(0)[0]["version"] == 6
    # a cold boot over the compacted log still resumes cleanly and the
    # version sequence never rewinds
    tr2 = _trainer(lgb.Booster(CPU, model_str=bst.model_to_string()),
                   FleetStore(str(tmp_path), "m"),
                   min_rows=40, shadow_rows=80, promote_patience=1)
    assert tr2.state()["consumed_rows"] == 240
    assert tr2.buffer.shadow_rows == tr.buffer.shadow_rows
    tr2.ingest(*_data(40, seed=99))
    assert tr2.run_once() == "promoted"
    assert tr2.state()["store"]["last_published_version"] == 7


def test_compaction_retention_skips_stale_publishes(tmp_path):
    """keep_artifacts must count VALID publishes only: a zombie's
    stale-epoch events must neither fill the retention window (evicting
    the newest good artifacts) nor survive the rewrite — the compact
    record's version/epoch floors stand in for them."""
    import hashlib
    store = FleetStore(str(tmp_path), "m")
    assert store.acquire_lease("a", ttl_s=30.0) == 1
    store.set_fence("a", 1)
    assert store.publish("model-one") == 1
    assert store.release_lease("a", 1) is True
    assert store.acquire_lease("b", ttl_s=30.0) == 2
    store.set_fence("b", 2)
    assert store.publish("model-two") == 2
    assert store.publish("model-three") == 3
    # forge a raced zombie append at the OLD epoch, newest in the log
    data = b"zombie-model"
    with open(store.artifact_path(4), "wb") as f:
        f.write(data)
    with open(store.events_path, "a", encoding="utf-8") as f:
        f.write(json.dumps({
            "v": 1, "kind": "publish", "ts": 0.0, "version": 4,
            "artifact": "v000004.txt", "event": "promotion",
            "sha256": hashlib.sha256(data).hexdigest(),
            "bytes": len(data), "lease_epoch": 1, "meta": None}) + "\n")
    summary = store.compact(watermark=0, wins=0, keep_rows=10**9,
                            keep_artifacts=2)
    # the window kept v2+v3 (newest VALID), not v3+zombie-v4
    assert [e["version"] for e in store.publishes()] == [2, 3]
    assert store.latest_valid_publish(0)[0]["version"] == 3
    assert summary["dropped_artifacts"] == 2   # v1 and the zombie's v4
    assert not os.path.exists(store.artifact_path(1))
    assert not os.path.exists(store.artifact_path(4))
    # the zombie's token is still burned: allocation resumes past it
    assert store.publish("model-five") == 5


def test_compaction_never_loses_concurrent_appends(tmp_path):
    """The multi-writer hole the failover feature opens: a standby
    trainer (another process — here a second store instance, which holds
    its own flock fd) persists ingest chunks to the same events.jsonl
    while the active trainer compacts. Every acked append must survive
    every snapshot→rewrite, whatever the interleaving."""
    active = FleetStore(str(tmp_path), "m")
    standby = FleetStore(str(tmp_path), "m")
    n_chunks, errors = 40, []

    def standby_ingest():
        try:
            for i in range(n_chunks):
                X = np.full((1, len(W)), float(i))
                standby.append_ingest(X, [float(i)])
        except BaseException as exc:   # surfaced after join
            errors.append(exc)

    th = threading.Thread(target=standby_ingest, daemon=True)
    th.start()
    # compact repeatedly while the other writer streams appends;
    # watermark 0 + huge keep_rows => every ingest chunk is retained
    for _ in range(8):
        active.compact(watermark=0, wins=0, keep_rows=10**9)
    th.join(30.0)
    assert not th.is_alive() and not errors
    active.compact(watermark=0, wins=0, keep_rows=10**9)
    labels = sorted(int(e["labels"][0]) for e in active.events("ingest"))
    assert labels == list(range(n_chunks))


# -------------------------------------------------------------- failover

def test_standby_takeover_resumes_watermark_and_streak(tmp_path):
    base_str = _train().model_to_string()
    store_a = FleetStore(str(tmp_path), "m")
    tr_a = _trainer(lgb.Booster(CPU, model_str=base_str), store_a,
                    lease_ttl_s=1.0, holder_id="a")
    assert tr_a.state()["role"] == "standby"
    assert tr_a.wait_for_lease(5.0) is True
    st = tr_a.state()
    assert st["role"] == "active" and st["lease_epoch"] == 1
    # a second trainer on the same store stays standby while A is live
    store_b = FleetStore(str(tmp_path), "m")
    tr_b = _trainer(lgb.Booster(CPU, model_str=base_str), store_b,
                    lease_ttl_s=1.0, holder_id="b")
    assert tr_b.try_acquire() is False
    assert tr_b.run_once() == "standby"
    # A trains through a full promotion (deferred win, then promote)
    for seed in (21, 22, 23):
        tr_a.ingest(*_data(30, seed=seed))
    assert tr_a.run_once() == "deferred"
    tr_a.ingest(*_data(50, seed=24))
    assert tr_a.run_once() == "promoted"
    pubs = store_a.publishes()
    assert [p["version"] for p in pubs] == [1]
    assert pubs[0]["lease_epoch"] == 1
    # standby ingest persists to the log but never buffers locally —
    # takeover replays the log, so local state would double-count
    rows0 = sum(e["n"] for e in store_b.events("ingest"))
    assert rows0 == 140
    assert tr_b.ingest(*_data(5, seed=20)) == 0
    assert tr_b.buffer.rows == 0 and tr_b.buffer.shadow_rows == 0
    assert sum(e["n"] for e in store_a.events("ingest")) == rows0 + 5
    # crash A: worker gone, lease NOT released, fence still armed
    tr_a.close(release_lease=False)
    takeovers0 = telemetry.counter("fleet/lease_takeovers")
    assert tr_b.wait_for_lease(10.0) is True
    st = tr_b.state()
    assert st["role"] == "active" and st["lease_epoch"] == 2
    assert telemetry.counter("fleet/lease_takeovers") >= takeovers0 + 1
    # B resumed the dead holder's durable state from the log alone:
    # watermark and streak from A's last gate, and the 5 rows it
    # standby-persisted after that gate land as the trainable tail —
    # nothing lost, nothing double-counted
    assert st["consumed_rows"] == 140
    assert st["win_streak"] == 0               # the promotion reset it
    assert tr_b.buffer.rows == 5
    assert tr_b.buffer.shadow_rows == 115      # 30+30+50 kept + 5 fresh
    # the zombie's store is fenced off at its dead epoch
    blocked0 = telemetry.counter("fleet/stale_publishes_blocked")
    with pytest.raises(StaleLeaseError):
        store_a.publish("zombie-model")
    assert telemetry.counter("fleet/stale_publishes_blocked") == blocked0 + 1
    # B publishes under epoch 2 with a fresh, unique version token
    tr_b.ingest(*_data(60, seed=25))
    assert tr_b.run_once() == "deferred"
    tr_b.ingest(*_data(60, seed=26))
    assert tr_b.run_once() == "promoted"
    pubs = store_b.publishes()
    assert [p["version"] for p in pubs] == [1, 2]
    assert [p["lease_epoch"] for p in pubs] == [1, 2]
    assert len({p["version"] for p in pubs}) == len(pubs)
    tr_b.close()
    assert store_b.lease_state()["held"] is False


def test_worker_thread_heartbeats_and_acquires(tmp_path):
    """The worker's lease tick end-to-end: a STARTED standby trainer
    acquires on its own, heartbeats past several ttls, and a started
    second trainer stays standby the whole time."""
    base_str = _train().model_to_string()
    tr_a = _trainer(lgb.Booster(CPU, model_str=base_str),
                    FleetStore(str(tmp_path), "m"),
                    lease_ttl_s=0.3, holder_id="a", start=True)
    tr_b = None
    try:
        # A must hold the lease before B's worker exists, or the two
        # workers would race for the first acquisition
        assert tr_a.wait_for_lease(5.0) is True
        tr_b = _trainer(lgb.Booster(CPU, model_str=base_str),
                        FleetStore(str(tmp_path), "m"),
                        lease_ttl_s=0.3, holder_id="b", start=True)
        # several ttls of heartbeats: A keeps the lease, B stays standby
        time.sleep(1.0)
        assert tr_a.state()["role"] == "active"
        assert tr_b.state()["role"] == "standby"
        st = FleetStore(str(tmp_path), "m").lease_state()
        assert st["held"] and st["holder"] == "a" and st["epoch"] == 1
        # A dies without releasing; B's worker takes over by itself
        tr_a.close(release_lease=False)
        assert tr_b.wait_for_lease(10.0) is True
        assert tr_b.state()["lease_epoch"] == 2
    finally:
        tr_a.close()
        if tr_b is not None:
            tr_b.close()


# ----------------------------------------------------------------- chaos

def test_chaos_seeded_plan_is_deterministic():
    def schedule(plan):
        out = []
        for point in chaos.FAILURE_POINTS:
            while True:
                act = plan.next_action(point)
                if act is None:
                    break
                kind = act[0]
                val = str(act[1]) if kind == "raise" else float(act[1])
                out.append((point, kind, val))
        return out
    counts = {"transport/request": 5, "store/append": 3, "store/lease": 2}
    s1 = schedule(FaultPlan.seeded(7, counts))
    s2 = schedule(FaultPlan.seeded(7, counts))
    assert s1 == s2 and len(s1) == 10
    assert s1 != schedule(FaultPlan.seeded(8, counts))
    kinds = {k for _, k, _ in s1}
    assert kinds <= {"raise", "torn", "sleep"}
    with pytest.raises(ValueError):
        FaultPlan().add("store/definitely_not_a_point", ("raise", None))


def test_chaos_install_uninstall_and_bookkeeping(tmp_path):
    assert chaos.active() is None
    assert chaos.hit("store/append") is None    # no plan: free no-op
    store = FleetStore(str(tmp_path), "m")
    store.publish("model-one")
    plan = FaultPlan({
        "store/artifact_read": [("raise", InjectedFault("boom")),
                                ("sleep", 0.0), ("torn", 0.5)]})
    injected0 = telemetry.counter("chaos/injected/store/artifact_read")
    with chaos.inject(plan) as p:
        assert chaos.active() is p
        with pytest.raises(InjectedFault):
            store.load_model(1)
        assert store.load_model(1) == "model-one"   # sleep: delayed, intact
        with pytest.raises(CorruptArtifactError):   # torn: checksum catches
            store.load_publish(store.publishes()[0])
        assert p.pending() == {}
        assert p.injected() == {"store/artifact_read": 3}
    assert chaos.active() is None
    assert telemetry.counter("chaos/injected/store/artifact_read") \
        == injected0 + 3
    # a plan never leaks past its block, even when the test body raised
    with pytest.raises(RuntimeError):
        with chaos.inject(FaultPlan({"store/append": [("raise",
                                                       InjectedFault())]})):
            raise RuntimeError("test body blew up")
    assert chaos.active() is None
    assert store.load_model(1) == "model-one"


# ------------------------------------------------------------- transport

def test_remote_store_serves_feed_and_artifacts(tmp_path):
    bst = _train(seed=1)
    store = FleetStore(str(tmp_path), "default")
    server = PredictServer(bst, port=0, warmup=False)
    server.fleet_store = store
    _start_server(server)
    host, port = server.address
    base = "http://%s:%d" % (host, port)
    try:
        remote = RemoteStore(base, timeout_s=5.0, retries=1,
                             backoff_base_s=0.01, backoff_max_s=0.05)
        # empty store: 404 is an answer, not a retry storm
        assert remote.latest_publish() is None
        assert remote.latest_valid_publish(0) is None
        store.publish("model-one", event="boot")
        store.publish(bst.model_to_string())
        latest = remote.latest_publish()
        assert latest["version"] == 2 and latest["lease_epoch"] == 0
        assert remote.load_model(1) == "model-one"
        event, model = remote.latest_valid_publish(0)
        assert event["version"] == 2
        assert model == bst.model_to_string()
        # already-applied floor: nothing newer than v2
        assert remote.latest_valid_publish(2) is None
        st = remote.state()
        assert st["requests"] >= 5 and st["errors"] == 0
        with pytest.raises(LightGBMError):
            RemoteStore("ftp://nope")
        with pytest.raises(LightGBMError):
            RemoteStore(base, timeout_s=0.0)
    finally:
        server.close()


def test_remote_store_resumes_after_partition(tmp_path):
    store = FleetStore(str(tmp_path), "default")
    store.publish("model-one")
    server = PredictServer(_train(), port=0, warmup=False)
    server.fleet_store = store
    _start_server(server)
    host, port = server.address
    remote = RemoteStore("http://%s:%d" % (host, port), retries=2,
                         backoff_base_s=0.001, backoff_max_s=0.005,
                         jitter_seed=42)
    errors0 = telemetry.counter("fleet/transport_errors")
    retries0 = telemetry.counter("fleet/transport_retries")
    try:
        # 6 consecutive drops vs 3 attempts/call: two calls fail whole,
        # the third sails through — resume needs no extra state
        plan = FaultPlan({"transport/request":
                          [("raise", InjectedFault("partition"))] * 6})
        with chaos.inject(plan):
            with pytest.raises(TransportError):
                remote.latest_publish()
            with pytest.raises(TransportError):
                remote.latest_publish()
            assert remote.latest_publish()["version"] == 1
        st = remote.state()
        assert st["errors"] == 2 and st["retries"] >= 4
        assert "InjectedFault" in st["last_error"]
        assert telemetry.counter("fleet/transport_errors") == errors0 + 2
        assert telemetry.counter("fleet/transport_retries") >= retries0 + 4
    finally:
        server.close()


def test_remote_replica_converges_through_faults(tmp_path):
    """Satellite e2e: a replica behind the HTTP transport ends
    byte-identical to a filesystem replica despite injected drops,
    stalls and torn responses on BOTH sides of the wire — and the
    faults show up on the serving process's /metrics."""
    bst_v1, bst_v2 = _train(seed=0), _train(seed=3, rounds=8)
    store = FleetStore(str(tmp_path), "default")
    store.publish(bst_v1.model_to_string(), event="boot")
    server = PredictServer(_train(), port=0, warmup=False)
    server.fleet_store = store
    _start_server(server)
    host, port = server.address
    base = "http://%s:%d" % (host, port)
    base_str = _train(seed=5).model_to_string()
    bst_remote = lgb.Booster(CPU, model_str=base_str)
    bst_fs = lgb.Booster(CPU, model_str=base_str)
    remote = RemoteStore(base, retries=4, backoff_base_s=0.002,
                         backoff_max_s=0.01, jitter_seed=3)
    w_remote = ReplicaWatcher(bst_remote, remote, start=False)
    w_fs = ReplicaWatcher(bst_fs, FleetStore(str(tmp_path), "default"),
                          start=False)
    checksum0 = telemetry.counter("fleet/transport_checksum_failures")
    try:
        plan = FaultPlan.seeded(1234, {"transport/request": 4,
                                       "transport/serve": 4})
        with chaos.inject(plan):
            store.publish(bst_v2.model_to_string())
            # drive both replicas through the fault schedule; a poll may
            # fail whole (the watcher thread would back off and retry —
            # here the loop is the retry)
            for _ in range(12):
                try:
                    w_remote.poll_once()
                except Exception:
                    pass
                w_fs.poll_once()
                if not plan.pending() \
                        and w_remote.applied_version == 2:
                    break
        # out of the storm: one clean poll settles any leftover gap
        w_remote.poll_once()
        w_fs.poll_once()
        assert w_remote.applied_version == w_fs.applied_version == 2
        # byte-identical convergence, remote vs filesystem — and both
        # serve exactly the published model
        assert bst_remote.model_to_string() == bst_fs.model_to_string()
        Xq = _data(40, seed=11)[0]
        np.testing.assert_allclose(np.asarray(bst_remote.predict(Xq)),
                                   np.asarray(bst_v2.predict(Xq)),
                                   rtol=1e-9)
        # the storm left fingerprints: retries/backoff and (if a torn
        # body got through) checksum rejections, all in the telemetry
        # registry (the port's /metrics is ROADMAP item 10)
        st = remote.state()
        assert st["requests"] > 0
        assert telemetry.counter("fleet/transport_requests") > 0
        injected = plan.injected()
        assert sum(injected.values()) > 0
        assert telemetry.counter("fleet/transport_checksum_failures") \
            >= checksum0
    finally:
        server.close()


def test_replica_poll_backoff_grows_and_resets(tmp_path):
    class FlakyStore:
        """Duck-typed store that fails until told otherwise."""
        def __init__(self):
            self.broken = True
            self.polls = 0

        def latest_publish(self):
            self.polls += 1
            if self.broken:
                raise OSError("store unreachable")
            return None

    flaky = FlakyStore()
    bst = _train()
    errors0 = telemetry.counter("fleet/replica_poll_errors")
    watcher = ReplicaWatcher(bst, flaky, poll_interval_s=0.02,
                             backoff_max_s=0.08, start=True)
    try:
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            st = watcher.state()
            if st["poll_errors"] >= 3 and st["poll_backoff_s"] >= 0.08:
                break
            time.sleep(0.01)
        st = watcher.state()
        assert st["poll_errors"] >= 3
        assert st["poll_backoff_s"] == 0.08       # capped, not unbounded
        assert "OSError" in st["last_error"]
        assert telemetry.counter("fleet/replica_poll_errors") >= errors0 + 3
        # first success resets the backoff to the plain poll interval
        flaky.broken = False
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if watcher.state()["poll_backoff_s"] == 0.0:
                break
            time.sleep(0.01)
        assert watcher.state()["poll_backoff_s"] == 0.0
    finally:
        watcher.close()
    with pytest.raises(LightGBMError):
        ReplicaWatcher(bst, flaky, poll_interval_s=0.5, backoff_max_s=0.1,
                       start=False)


# ---------------------------------------------------------- observability

def test_healthz_and_telemetry_expose_fleet_hardening(tmp_path):
    bst = _train(seed=2)
    store = FleetStore(str(tmp_path), "default")
    assert store.acquire_lease("trainer-1", ttl_s=30.0) == 1
    store.set_fence("trainer-1", 1)
    store.publish(bst.model_to_string(), event="boot")
    server = PredictServer(bst, port=0, warmup=False)
    server.fleet_store = store
    _start_server(server)
    host, port = server.address
    base = "http://%s:%d" % (host, port)
    try:
        server.fleet_transport = RemoteStore(base, timeout_s=2.0,
                                             retries=0)
        with urlopen(base + "/healthz", timeout=30) as resp:
            doc = json.loads(resp.read())
        fs = doc["fleet_store"]
        assert fs["lease"]["holder"] == "trainer-1"
        assert fs["lease"]["epoch"] == 1 and fs["lease"]["held"] is True
        assert fs["events_log_bytes"] > 0
        assert fs["compactions"] == 0
        assert doc["fleet_transport"]["base_url"] == base
        gauges = telemetry.snapshot()["gauges"]
        assert gauges["fleet/lease_epoch"] == 1
        assert gauges["fleet/events_log_bytes"] > 0
        assert telemetry.counter("fleet/lease_acquired") >= 1
    finally:
        server.close()


# -------------------------------------------------------- SIGKILL e2e
