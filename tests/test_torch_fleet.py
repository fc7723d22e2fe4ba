"""The port's fleet on the CPU, mirroring the non-slow cases of
tests/test_fleet.py: durable store semantics, replay on boot, promotion
hysteresis, auto-rollback on a live regression, multi-replica model
distribution and per-tenant fair queuing. Then the store read across
packages: a directory the JAX ``FleetStore`` wrote read by the port's and
the reverse, and one log replayed by both trainers."""

import json
import os
import sys
import threading
import time
from urllib.request import Request, urlopen

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import lightgbm_tpu_torch as lgb  # noqa: E402
from lightgbm_tpu_torch.fleet import FleetStore, ReplicaWatcher, \
    bootstrap_model  # noqa: E402
from lightgbm_tpu_torch.obs import telemetry  # noqa: E402
from lightgbm_tpu_torch.online import ModelRegistry, OnlineTrainer  # noqa: E402
from lightgbm_tpu_torch.serve import MicroBatcher, PredictServer  # noqa: E402
from lightgbm_tpu_torch.serve.batcher import QueueFullError  # noqa: E402
from lightgbm_tpu_torch.utils.log import LightGBMError  # noqa: E402

from torch_port_cases import CPU, torch_threads  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread_module():
    with torch_threads(1):
        yield

W = np.array([1.2, -0.8, 0.5, 0.0, 0.3, -0.4])


def _data(n, seed=0, flip=0.0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, len(W))
    y = (X @ W + 0.2 * rng.randn(n) > 0).astype(np.float64)
    if flip:
        m = rng.rand(n) < flip
        y[m] = 1.0 - y[m]
    return X, y


def _train(n=300, seed=0, rounds=6):
    X, y = _data(n, seed)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "min_data_in_leaf": 5, "device_type": "cpu"}
    return lgb.train(params, lgb.Dataset(X, label=y),
                     num_boost_round=rounds)


def _post(url, obj, timeout=30, headers=None):
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    req = Request(url, data=json.dumps(obj).encode(), headers=hdrs)
    with urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _get(url, timeout=30):
    with urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _start_server(server):
    th = threading.Thread(target=server.serve_forever,
                          name="fleet-test-http", daemon=True)
    th.start()
    return th


def _degraded_factory(bst):
    """Candidate factory returning a maximally wrong model (every leaf
    pinned at +1e3 logit) — promotable only because the test sets a
    generous gate threshold."""
    src = bst.model_to_string()

    def degraded(X, y):
        cand = lgb.Booster(CPU, model_str=src)
        for t in cand.inner.models:
            t.leaf_value[:] = 1e3
        cand.inner._bump_model_version()
        return cand
    return degraded


# ---------------------------------------------------------------- store

def test_store_roundtrip_and_corrupt_line_skip(tmp_path):
    store = FleetStore(str(tmp_path), "m")
    X, y = _data(3, seed=1)
    store.append_ingest(X, y)
    store.append_gate("rejected", 0, 3, {"current": 1.0})
    v = store.publish("hello model", event="boot")
    assert v == 1
    # a corrupt line mid-log (bad JSON) and a torn final line (the
    # SIGKILL-mid-append shape: no trailing newline) are both skipped
    with open(store.events_path, "a", encoding="utf-8") as f:
        f.write('{"v": 1, "kind": "gate", oops}\n')
        f.write('{"v": 1, "kind": "ing')
    fresh = FleetStore(str(tmp_path), "m")
    events = list(fresh.events())
    assert [e["kind"] for e in events] == ["ingest", "gate", "publish"]
    ing = events[0]
    assert ing["n"] == 3
    np.testing.assert_allclose(np.asarray(ing["rows"]), X)
    np.testing.assert_allclose(np.asarray(ing["labels"]), y)
    assert events[1]["result"] == "rejected"
    latest = fresh.latest_publish()
    assert latest["version"] == 1 and latest["event"] == "boot"
    assert fresh.load_model(1) == "hello model"
    assert fresh.state()["ingest_rows_persisted"] == 0  # per-process counter
    assert store.state()["ingest_rows_persisted"] == 3


def test_store_versions_monotonic_across_processes(tmp_path):
    a = FleetStore(str(tmp_path), "m")
    assert a.publish("one") == 1
    assert a.publish("two", event="rollback") == 2
    # a second store over the same directory (a restarted trainer)
    # resumes the version sequence instead of reissuing tokens
    b = FleetStore(str(tmp_path), "m")
    assert b.publish("three") == 3
    assert [p["version"] for p in b.publishes()] == [1, 2, 3]
    for ver, txt in ((1, "one"), (2, "two"), (3, "three")):
        assert os.path.exists(b.artifact_path(ver))
        assert b.load_model(ver) == txt
    with pytest.raises(LightGBMError):
        a.publish("x", event="nope")
    for bad in ("", "a/b", ".hidden"):
        with pytest.raises(LightGBMError):
            FleetStore(str(tmp_path), bad)


# -------------------------------------------------------------- replica

def test_bootstrap_and_replica_one_bump_per_publish(tmp_path):
    store = FleetStore(str(tmp_path), "m")
    assert bootstrap_model(store, CPU) == (None, 0)
    bst = _train(seed=0)
    bst2 = _train(seed=4, rounds=4)
    Xq = _data(16, seed=9)[0]
    store.publish(bst.model_to_string(), event="boot")
    rb, ver = bootstrap_model(store, CPU)
    assert ver == 1
    np.testing.assert_allclose(rb.predict(Xq), bst.predict(Xq),
                               rtol=1e-6, atol=1e-8)
    w = ReplicaWatcher(rb, store, applied_version=ver, start=False)
    assert w.poll_once() is False               # nothing newer yet
    v0 = rb.inner.model_version
    store.publish(bst2.model_to_string(), event="promotion")
    assert w.poll_once() is True
    # the whole-model invariant: one applied publish == one version bump
    assert rb.inner.model_version == v0 + 1
    assert w.applied_version == 2
    np.testing.assert_allclose(rb.predict(Xq), bst2.predict(Xq),
                               rtol=1e-6, atol=1e-8)
    assert w.poll_once() is False               # idempotent
    assert rb.inner.model_version == v0 + 1
    # a rollback is just another publish: replicas converge on the
    # newest token and the restored model distributes identically
    store.publish(bst.model_to_string(), event="rollback")
    assert w.poll_once() is True
    assert rb.inner.model_version == v0 + 2
    np.testing.assert_allclose(rb.predict(Xq), bst.predict(Xq),
                               rtol=1e-6, atol=1e-8)
    st = w.state()
    assert st["applied_version"] == 3 and st["swaps"] == 2
    assert st["poll_errors"] == 0
    # a late-booting second replica skips straight to the newest version
    rb2, ver2 = bootstrap_model(store, CPU)
    assert ver2 == 3
    np.testing.assert_allclose(rb2.predict(Xq), bst.predict(Xq),
                               rtol=1e-6, atol=1e-8)


def test_replica_background_thread_applies_and_survives_errors(tmp_path):
    store = FleetStore(str(tmp_path), "m")
    bst = _train(seed=0)
    store.publish(bst.model_to_string(), event="boot")
    rb, ver = bootstrap_model(store, CPU)
    with ReplicaWatcher(rb, store, poll_interval_s=0.05,
                        applied_version=ver) as w:
        # a torn/garbage artifact must not kill the poller thread
        bad = store.publish("not a model", event="promotion")
        deadline = time.time() + 30
        while w.state()["poll_errors"] == 0 and time.time() < deadline:
            time.sleep(0.02)
        assert w.state()["poll_errors"] >= 1
        assert w.applied_version == ver         # nothing applied
        os.remove(store.artifact_path(bad))     # heal: newest valid wins
        store.publish(bst.model_to_string(), event="promotion")
        while w.applied_version < bad + 1 and time.time() < deadline:
            time.sleep(0.02)
        assert w.applied_version == bad + 1
    assert not w.state()["running"]


# ----------------------------------------------------- trainer + store

def test_trainer_persists_ingest_gates_and_publishes(tmp_path):
    store = FleetStore(str(tmp_path), "m")
    bst = _train()
    tr = OnlineTrainer(bst, trigger_rows=10**6, min_rows=32,
                       promote_threshold=1.5, store=store, start=False)
    X, y = _data(200, seed=1)
    tr.ingest(X, y)
    ing = list(store.events("ingest"))
    assert sum(e["n"] for e in ing) == 200      # persisted before the push
    assert tr.run_once() == "promoted"
    gates = list(store.events("gate"))
    assert len(gates) == 1
    assert gates[0]["result"] == "promoted"
    assert gates[0]["consumed_rows"] == 200     # the replay watermark
    latest = store.latest_publish()
    assert latest["version"] == 1 and latest["event"] == "promotion"
    # the published artifact IS the model now serving
    Xq = _data(16, seed=9)[0]
    np.testing.assert_allclose(
        lgb.Booster(CPU, model_str=store.load_model(1)).predict(Xq),
        bst.predict(Xq), rtol=1e-6, atol=1e-8)
    assert tr.state()["store"]["last_published_version"] == 1


def test_replay_watermark_splits_trained_from_buffered(tmp_path):
    store = FleetStore(str(tmp_path), "m")
    bst = _train()
    kw = dict(trigger_rows=10**6, min_rows=64, shadow_rows=10**6,
              promote_threshold=1.5)
    tr1 = OnlineTrainer(bst, store=store, start=False, **kw)
    tr1.ingest(*_data(100, seed=2))
    assert tr1.run_once() in ("promoted", "rejected")   # watermark -> 100
    tr1.ingest(*_data(40, seed=3))                      # untrained tail
    assert tr1.buffer.rows == 40
    # "restart": a fresh trainer over the same store resumes mid-window
    tr2 = OnlineTrainer(_train(), store=store, start=False, **kw)
    assert tr2.buffer.rows == 40                # trained rows NOT re-buffered
    assert tr2.buffer.total_rows == 140
    assert tr2.buffer.shadow_rows == 140        # but all judge promotions
    st = tr2.state()
    assert st["consumed_rows"] == 100
    assert st["replayed_rows"] == 140
    # replay=False cold-starts (watermark state still resumes from gates)
    tr3 = OnlineTrainer(_train(), store=store, replay=False,
                        start=False, **kw)
    assert tr3.buffer.rows == 0 and tr3.state()["replayed_rows"] == 0


def test_replay_splits_chunk_straddling_watermark(tmp_path):
    # synthetic log: one 50-row chunk, watermark at 30 — only the
    # 20-row untrained tail may re-enter the training buffer
    store = FleetStore(str(tmp_path), "m")
    store.append_ingest(*_data(50, seed=5))
    store.append_gate("rejected", 0, 30)
    tr = OnlineTrainer(_train(), trigger_rows=10**6, min_rows=64,
                       shadow_rows=10**6, store=store, start=False)
    assert tr.buffer.rows == 20
    assert tr.buffer.shadow_rows == 50
    assert tr.state()["consumed_rows"] == 30


# ------------------------------------------------ hysteresis + rollback

def test_promote_patience_defers_then_promotes():
    bst = _train()
    v0 = bst.inner.model_version
    tr = OnlineTrainer(bst, trigger_rows=10**6, min_rows=32,
                       promote_threshold=2.0, promote_patience=2,
                       start=False)
    d0 = telemetry.counter("online/deferrals")
    tr.ingest(*_data(100, seed=1))
    # first shadow win is banked, not acted on: no swap yet
    assert tr.run_once() == "deferred"
    assert bst.inner.model_version == v0
    assert tr.state()["win_streak"] == 1
    assert telemetry.counter("online/deferrals") == d0 + 1
    tr.ingest(*_data(100, seed=2))
    # second consecutive win completes the streak: single-bump promotion
    assert tr.run_once() == "promoted"
    assert bst.inner.model_version == v0 + 1
    assert tr.state()["win_streak"] == 0


def test_rejection_breaks_win_streak():
    bst = _train()
    behavior = {"degrade": False}
    good = _degraded_factory(bst)               # built lazily below

    def factory(X, y):
        if behavior["degrade"]:
            return good(X, y)
        return lgb.Booster(CPU, model_str=bst.model_to_string()).refit(X, y)

    tr = OnlineTrainer(bst, trigger_rows=10**6, min_rows=32,
                       promote_threshold=2.0, promote_patience=2,
                       candidate_factory=factory, start=False)
    tr.ingest(*_data(100, seed=1))
    assert tr.run_once() == "deferred"
    behavior["degrade"] = True                  # force a shadow loss
    tr.ingest(*_data(100, seed=2))
    assert tr.run_once() == "rejected"
    assert tr.state()["win_streak"] == 0        # the loss reset the streak
    behavior["degrade"] = False
    tr.ingest(*_data(100, seed=3))
    assert tr.run_once() == "deferred"          # counting starts over


def test_replay_resumes_win_streak_toward_promotion(tmp_path):
    store = FleetStore(str(tmp_path), "m")
    store.append_gate("deferred", 1, 0)         # one banked win on disk
    bst = _train()
    v0 = bst.inner.model_version
    tr = OnlineTrainer(bst, trigger_rows=10**6, min_rows=32,
                       promote_threshold=2.0, promote_patience=2,
                       store=store, start=False)
    assert tr.state()["win_streak"] == 1        # hysteresis state resumed
    tr.ingest(*_data(100, seed=1))
    # the restarted trainer's next win completes the dead process's streak
    assert tr.run_once() == "promoted"
    assert bst.inner.model_version == v0 + 1


def test_watch_confirms_good_promotion():
    bst = _train()
    tr = OnlineTrainer(bst, trigger_rows=10**6, min_rows=32,
                       promote_threshold=2.0, rollback_threshold=1.5,
                       rollback_min_rows=32, start=False)
    tr.ingest(*_data(100, seed=1))
    assert tr.run_once() == "promoted"
    st = tr.state()
    assert st["watch_armed"] and st["watch_rows"] == 0
    assert tr.watch_once() is None              # not enough live rows yet
    v1 = bst.inner.model_version
    c0 = telemetry.counter("online/watch_confirms")
    tr.ingest(*_data(40, seed=2))               # fresh post-swap traffic
    assert tr.watch_once() is False             # live loss fine: confirmed
    assert bst.inner.model_version == v1        # no extra swap
    assert telemetry.counter("online/watch_confirms") == c0 + 1
    st = tr.state()
    assert not st["watch_armed"] and st["auto_rollbacks"] == 0
    assert st["can_rollback"]                   # manual rollback still open
    assert tr.watch_once() is None              # one verdict per promotion


def test_auto_rollback_restores_model_and_publishes(tmp_path):
    store = FleetStore(str(tmp_path), "m")
    bst = _train()
    v0 = bst.inner.model_version
    s0 = bst.model_to_string()
    Xq = _data(16, seed=9)[0]
    p0 = np.asarray(bst.predict(Xq))
    tr = OnlineTrainer(bst, trigger_rows=10**6, min_rows=32,
                       promote_threshold=10**9,  # gate waves anything in
                       rollback_threshold=1.2, rollback_min_rows=32,
                       candidate_factory=_degraded_factory(bst),
                       store=store, start=False)
    tr.ingest(*_data(100, seed=1))
    assert tr.run_once() == "promoted"          # the bad model is live
    assert bst.inner.model_version == v0 + 1
    assert store.latest_publish()["event"] == "promotion"
    a0 = telemetry.counter("online/auto_rollbacks")
    tr.ingest(*_data(50, seed=2))               # live traffic exposes it
    assert tr.watch_once() is True
    # exactly one version bump each way: promote, then restore
    assert bst.inner.model_version == v0 + 2
    assert bst.model_to_string() == s0
    np.testing.assert_allclose(bst.predict(Xq), p0, rtol=1e-9)
    assert telemetry.counter("online/auto_rollbacks") == a0 + 1
    st = tr.state()
    assert st["auto_rollbacks"] == 1 and st["last_rollback_ts"] > 0
    assert not st["watch_armed"] and not st["can_rollback"]
    # the rollback distributed as a publish under a NEW version token
    pubs = store.publishes()
    assert [p["event"] for p in pubs] == ["promotion", "rollback"]
    assert [p["version"] for p in pubs] == [1, 2]
    # a replica that saw neither event converges straight to the
    # restored model with exactly one swap
    rb = lgb.Booster(CPU, model_str=s0)
    rv0 = rb.inner.model_version
    w = ReplicaWatcher(rb, store, start=False)
    assert w.poll_once() is True
    assert rb.inner.model_version == rv0 + 1
    np.testing.assert_allclose(rb.predict(Xq), p0, rtol=1e-9)


# ------------------------------------------------- per-tenant fairness

class _SlowSession:
    """MicroBatcher-shaped fake: dispatch sleeps, predictions are row
    sums (so slicing bugs would show)."""

    buckets = (64,)

    def __init__(self, delay=0.05):
        self.delay = delay

    def dispatch(self, X):
        time.sleep(self.delay)
        return [(np.asarray(X).sum(axis=1), len(X))]

    def collect(self, pieces):
        return np.concatenate([np.asarray(p)[:n] for p, n in pieces])

    def finalize(self, raw, raw_score=False):
        return np.asarray(raw)


def _tag(order, name):
    return lambda _f: order.append(name)


def test_fair_queue_interleaves_equal_weight_tenants():
    b = MicroBatcher(_SlowSession(0.15), max_batch_rows=8, max_wait_ms=1.0)
    order = []
    try:
        warm = b.submit(np.ones((8, 4)))        # occupies the worker
        warm.add_done_callback(_tag(order, "warm"))
        time.sleep(0.05)
        futs = []
        for i in range(3):                      # a's backlog, then b's
            futs.append(b.submit(np.ones((8, 4)), tenant="a"))
            futs[-1].add_done_callback(_tag(order, "a"))
        for i in range(3):
            futs.append(b.submit(np.ones((8, 4)), tenant="b"))
            futs[-1].add_done_callback(_tag(order, "b"))
        for f in futs:
            np.testing.assert_allclose(f.result(timeout=60), 4.0)
        # start-time fair queuing drains equal-weight backlogs
        # alternately even though a's requests all arrived first
        assert order == ["warm", "a", "b", "a", "b", "a", "b"]
        stats = b.tenant_stats()
        assert stats["a"]["served_rows"] == 24
        assert stats["b"]["served_requests"] == 3
        assert stats["a"]["queue_rows"] == 0
    finally:
        b.close()


def test_fair_queue_weighted_shares():
    b = MicroBatcher(_SlowSession(0.15), max_batch_rows=8, max_wait_ms=1.0,
                     tenant_weights={"heavy": 3.0})
    order = []
    try:
        warm = b.submit(np.ones((8, 4)))
        warm.add_done_callback(_tag(order, "warm"))
        time.sleep(0.05)
        futs = []
        for i in range(4):
            futs.append(b.submit(np.ones((8, 4)), tenant="heavy"))
            futs[-1].add_done_callback(_tag(order, "heavy"))
        for i in range(2):
            futs.append(b.submit(np.ones((8, 4)), tenant="light"))
            futs[-1].add_done_callback(_tag(order, "light"))
        for f in futs:
            np.testing.assert_allclose(f.result(timeout=60), 4.0)
        # weight 3 tenant drains ~3 rows per light row over the backlog
        assert order == ["warm", "heavy", "light", "heavy", "heavy",
                         "heavy", "light"]
        assert b.tenant_stats()["heavy"]["weight"] == 3.0
    finally:
        b.close()


def test_tenant_quota_sheds_only_the_flooder():
    b = MicroBatcher(_SlowSession(0.2), max_batch_rows=8, max_wait_ms=1.0,
                     tenant_quota_rows=8, overload="shed")
    try:
        futs = [b.submit(np.ones((8, 4)), tenant="noisy")]  # worker busy
        time.sleep(0.05)
        futs.append(b.submit(np.ones((8, 4)), tenant="noisy"))  # quota full
        with pytest.raises(QueueFullError):
            b.submit(np.ones((8, 4)), tenant="noisy")
        # the polite tenant is untouched by the flooder's quota
        futs.append(b.submit(np.ones((8, 4)), tenant="polite"))
        # per-tenant oversize carve-out: a request alone bigger than the
        # quota is admitted when that tenant's queue is empty
        futs.append(b.submit(np.ones((32, 4)), tenant="big"))
        stats = b.tenant_stats()
        assert stats["noisy"]["shed"] == 1
        assert stats["noisy"]["shed_rows"] == 8
        assert stats["polite"]["shed"] == 0
        for f in futs:
            np.testing.assert_allclose(f.result(timeout=60), 4.0)
    finally:
        b.close()


# ------------------------------------------------------ healthz surface

def test_healthz_reports_tenants_promotions_and_fleet(tmp_path):
    bst = _train(seed=7)
    server = PredictServer(bst, port=0, buckets=(64,), max_wait_ms=1.0,
                           tenant_quota_rows=4096,
                           online=dict(trigger_rows=10**6, min_rows=32))
    store = FleetStore(str(tmp_path), "default")
    store.publish(bst.model_to_string(), event="boot")
    server.fleet_watcher = ReplicaWatcher(bst, store, applied_version=1,
                                          start=False)
    host, port = server.address
    base = "http://%s:%d" % (host, port)
    th = _start_server(server)
    try:
        Xq = _data(5, seed=14)[0]
        # tenant via header and via payload both land in the stats
        code, _ = _post(base + "/predict", {"rows": Xq.tolist()},
                        headers={"X-Tenant": "acme"})
        assert code == 200
        code, _ = _post(base + "/predict", {"rows": Xq.tolist(),
                                            "tenant": "beta"})
        assert code == 200
        health = _get(base + "/healthz")
        assert set(health["tenants"]) >= {"acme", "beta"}
        for t in ("acme", "beta"):
            assert health["tenants"][t]["queue_rows"] == 0
            assert health["tenants"][t]["shed"] == 0
        # per-model promotion/rollback timestamps are hoisted for ops
        assert health["promotions"]["default"]["last_promotion_ts"] == 0.0
        assert health["promotions"]["default"]["last_rollback_ts"] == 0.0
        served = health["models"]["default"]["tenants"]
        assert served["acme"]["served_rows"] == 5
        # replica-mode watcher state rides along
        assert health["fleet"]["applied_version"] == 1
        assert health["fleet"]["swaps"] == 0
    finally:
        server.shutdown()
        th.join(timeout=10)
        server.close()


# ------------------------------------------------------------------ e2e

def test_rollback_on_regression_e2e_under_load(tmp_path):
    """Satellite 3: a deliberately degraded model is promoted under
    closed-loop predict load; the live watch rolls it back automatically,
    restoring the prior model with exactly one version bump each way and
    publishing the rollback under a new version token."""
    store = FleetStore(str(tmp_path), "default")
    bst = _train(seed=8)
    v0 = bst.inner.model_version
    s0 = bst.model_to_string()
    Xq = _data(8, seed=15)[0]
    p0 = np.asarray(bst.predict(Xq))
    tr = OnlineTrainer(bst, trigger_rows=256, min_rows=64,
                       shadow_rows=1024, promote_threshold=10**9,
                       rollback_threshold=1.2, rollback_min_rows=64,
                       candidate_factory=_degraded_factory(bst),
                       store=store, start=True)
    registry = ModelRegistry()
    registry.register("default", bst, buckets=(64,), max_wait_ms=1.0,
                      online=tr)
    server = PredictServer(registry=registry, port=0)
    host, port = server.address
    base = "http://%s:%d" % (host, port)
    th = _start_server(server)
    failures = []
    stop = threading.Event()

    def client():
        while not stop.is_set():
            try:
                code, out = _post(base + "/predict", {"rows": Xq.tolist()})
                if code != 200 or len(out["predictions"]) != 8:
                    failures.append(out)
            except Exception as exc:  # noqa: BLE001 - collected for assert
                failures.append(repr(exc))

    clients = [threading.Thread(target=client, name="fleet-e2e-%d" % i)
               for i in range(2)]
    for c in clients:
        c.start()
    try:
        def wait_for(pred, what, timeout=60):
            deadline = time.time() + timeout
            while time.time() < deadline:
                if pred(tr.state()):
                    return
                time.sleep(0.05)
            pytest.fail("timed out waiting for %s: %s" % (what, tr.state()))

        # phase 1: enough labeled traffic to trigger one train cycle —
        # the degraded candidate sails through the wide-open gate
        X, y = _data(300, seed=21)
        code, _ = _post(base + "/ingest", {"rows": X.tolist(),
                                           "labels": y.tolist()})
        assert code == 200
        wait_for(lambda s: s["promotions"] == 1, "promotion")
        # phase 2: fresh labeled traffic feeds the live watch (stays
        # below trigger_rows so no second cycle races the verdict)
        X2, y2 = _data(100, seed=22)
        code, _ = _post(base + "/ingest", {"rows": X2.tolist(),
                                           "labels": y2.tolist()})
        assert code == 200
        wait_for(lambda s: s["auto_rollbacks"] == 1, "auto rollback")
    finally:
        stop.set()
        for c in clients:
            c.join(timeout=30)
        server.shutdown()
        th.join(timeout=10)
        server.close()
    assert not failures, failures[:3]
    # one bump up (promotion), one bump down (restore) — and the served
    # model is byte-identical to the pre-promotion one
    assert bst.inner.model_version == v0 + 2
    assert bst.model_to_string() == s0
    np.testing.assert_allclose(np.asarray(bst.predict(Xq)), p0, rtol=1e-9)
    pubs = store.publishes()
    assert [p["event"] for p in pubs] == ["promotion", "rollback"]
    assert [p["version"] for p in pubs] == [1, 2]
    health_rollback = tr.state()["last_rollback_ts"]
    assert health_rollback > 0


# ------------------------------------------------------- across packages
#
# The store's files are the JAX package's, byte for byte: a directory one
# package wrote reads the same in the other, and one log replays to the
# same trainer state in both.

import hashlib  # noqa: E402

import lightgbm_tpu as jlgb  # noqa: E402
from lightgbm_tpu.fleet import FleetStore as JaxFleetStore  # noqa: E402
from lightgbm_tpu.online import OnlineTrainer as JaxOnlineTrainer  # noqa: E402

STORES = {"jax": JaxFleetStore, "port": FleetStore}


def _store_life(Store, root, models):
    """One store's life: ingest chunks and gate verdicts, a boot and a
    promotion publish, a compaction into a snapshot cut mid-window, then
    more ingest and a rollback publish. Returns the store."""
    store = Store(root, "m")
    for seed in (1, 2, 3):
        store.append_ingest(*_data(30, seed=seed))
    store.append_gate("deferred", 1, 90, {"current": 0.5,
                                          "candidate": 0.25})
    assert store.publish(models[0], event="boot") == 1
    store.append_ingest(*_data(25, seed=4))
    store.append_gate("rejected", 0, 115, None)
    assert store.publish(models[1], event="promotion") == 2
    summary = store.compact(watermark=115, wins=0, keep_rows=80,
                            snapshot_rows=60)
    assert isinstance(summary.get("snapshot"), dict)
    store.append_ingest(*_data(20, seed=5))
    assert store.publish(models[0], event="rollback") == 3
    return store


def _untimed(doc):
    """A store record without its wall-clock stamps (keys ending "ts")."""
    if isinstance(doc, dict):
        return {k: _untimed(v) for k, v in doc.items()
                if not str(k).endswith("ts")}
    if isinstance(doc, (list, tuple)):
        return [_untimed(v) for v in doc]
    return doc


def _read_back(store):
    """Everything a reader takes from a store: events, publishes, each
    artifact's text, the snapshot chunks of every compact record."""
    events = list(store.events())
    compacts = [e for e in events if e["kind"] == "compact"]
    return dict(
        events=events, publishes=store.publishes(),
        latest=store.latest_valid_publish(0),
        models={p["version"]: store.load_model(p["version"])
                for p in store.publishes()},
        chunks=[list(store.snapshot_chunks(c)) for c in compacts])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_directory_reads_the_same_in_both_packages(tmp_path, writer):
    bst = _train(seed=3)
    models = [bst.model_to_string(), _train(seed=4).model_to_string()]
    root = str(tmp_path / "store")
    _store_life(STORES[writer], root, models)
    jax_view = _read_back(JaxFleetStore(root, "m", read_only=True))
    port_view = _read_back(FleetStore(root, "m", read_only=True))
    assert jax_view == port_view
    assert [e["kind"] for e in port_view["events"]][:1] == ["compact"]
    assert [p["version"] for p in port_view["publishes"]] == [1, 2, 3]
    for p in port_view["publishes"]:
        data = port_view["models"][p["version"]].encode("utf-8")
        assert p["sha256"] == hashlib.sha256(data).hexdigest()
    assert port_view["latest"][1] == models[0]
    # the other package, doing the same, writes the same records, the
    # same artifacts and the same snapshot
    other = "port" if writer == "jax" else "jax"
    root2 = str(tmp_path / "store2")
    _store_life(STORES[other], root2, models)
    again = _read_back(FleetStore(root2, "m", read_only=True))
    assert _untimed(again) == _untimed(port_view)
    for v in (1, 2, 3):
        with open(FleetStore(root, "m").artifact_path(v), "rb") as f1, \
                open(FleetStore(root2, "m").artifact_path(v), "rb") as f2:
            assert f1.read() == f2.read()


def test_both_trainers_replay_one_log_alike(tmp_path):
    """One log (written by the JAX trainer's store) replayed on boot by the
    JAX trainer and by the port's: the same watermark, win streak and
    replayed rows, and the same training buffer and shadow window, row for
    row."""
    base = _train(seed=5)
    base_str = base.model_to_string()
    root = str(tmp_path / "log")
    writer = JaxFleetStore(root, "m")
    tr = JaxOnlineTrainer(jlgb.Booster(model_str=base_str), mode="refit",
                          trigger_rows=10**9, min_rows=16,
                          shadow_rows=100, promote_threshold=2.0,
                          promote_patience=3, store=writer, start=False)
    for seed in (1, 2, 3):
        tr.ingest(*_data(30, seed=seed))
    assert tr.run_once() == "deferred"
    for seed in (4, 5):
        tr.ingest(*_data(25, seed=seed))
    writer.compact(watermark=90, wins=1, keep_rows=100, snapshot_rows=40)
    tr.ingest(*_data(15, seed=6))
    kw = dict(mode="refit", trigger_rows=10**9, min_rows=16,
              shadow_rows=100, promote_threshold=2.0, promote_patience=3,
              start=False)
    jax_tr = JaxOnlineTrainer(jlgb.Booster(model_str=base_str),
                              store=JaxFleetStore(root, "m"), **kw)
    port_tr = OnlineTrainer(lgb.Booster(CPU, model_str=base_str),
                            store=FleetStore(root, "m"), **kw)
    js, ps = jax_tr.state(), port_tr.state()
    for key in ("consumed_rows", "win_streak", "replayed_rows",
                "buffered_rows", "shadow_rows", "total_ingested_rows"):
        assert js[key] == ps[key], key
    assert ps["consumed_rows"] == 90 and ps["win_streak"] == 1
    for a, b in ((jax_tr.buffer.shadow(), port_tr.buffer.shadow()),
                 (jax_tr.buffer.take_training(),
                  port_tr.buffer.take_training())):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
