"""The port's online training on the CPU, mirroring the non-fleet cases
of tests/test_online.py: the TrafficBuffer, the shadow-scoring promotion
gate, the atomic hot swap, refit and continue modes, rollback, the worker
thread, admission control, multi-tenant routing with ``/ingest`` (409
when online training is off), the graceful drain and the closed loop of
concurrent ``/predict`` and ``/ingest``. Then the served answers after a
continue-mode promotion against the JAX package's, and chip_smoke's phase
3k at a tiny size."""
import json
import threading
import time
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest

from torch_port_cases import CPU, assert_same_trees, torch_threads

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.obs import telemetry
from lightgbm_tpu_torch.online import ModelRegistry, OnlineTrainer
from lightgbm_tpu_torch.online.buffer import TrafficBuffer
from lightgbm_tpu_torch.online.registry import RegistryEntry
from lightgbm_tpu_torch.serve import (MicroBatcher, PredictServer,
                                      PredictSession)
from lightgbm_tpu_torch.serve.batcher import QueueFullError
from lightgbm_tpu_torch.utils.log import LightGBMError

W = np.array([1.2, -0.8, 0.5, 0.0, 0.3, -0.4])
PARAMS = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
          "min_data_in_leaf": 5, "device_type": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_module():
    with torch_threads(1):
        yield


def _data(n, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, len(W))
    y = (X @ W + 0.2 * rng.randn(n) > 0).astype(np.float64)
    return X, y


def _train(n=300, seed=0, rounds=6):
    X, y = _data(n, seed)
    return lgt.train(dict(PARAMS), lgt.Dataset(X, label=y),
                     num_boost_round=rounds)


def _post(url, obj, timeout=30):
    req = Request(url, data=json.dumps(obj).encode(),
                  headers={"Content-Type": "application/json"})
    with urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _get(url, timeout=30):
    with urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _start(server):
    th = threading.Thread(target=server.serve_forever,
                          name="online-test-http", daemon=True)
    th.start()
    return th


# --------------------------------------------------------------- buffer

def test_buffer_bounded_drop_oldest_and_shadow_window():
    buf = TrafficBuffer(capacity_rows=100, shadow_rows=50)
    for i in range(5):
        buf.push(np.full((30, 2), i, np.float64), np.full(30, i))
    assert buf.rows == 90 and buf.dropped_rows == 60
    assert buf.total_rows == 150 and buf.shadow_rows <= 60
    Xs, ys = buf.shadow()
    assert set(np.unique(ys)) <= {3.0, 4.0}
    X, y = buf.take_training()
    assert len(y) == 90 and buf.rows == 0
    assert buf.take_training() is None and buf.shadow() is not None
    buf.push(np.zeros((200, 2)), np.zeros(200))
    assert buf.rows == 200


def test_buffer_validates_shapes():
    buf = TrafficBuffer()
    with pytest.raises(ValueError):
        buf.push(np.zeros((3, 2)), np.zeros(4))
    with pytest.raises(ValueError):
        buf.push(np.zeros((2, 2, 2)), np.zeros(2))
    assert buf.push(np.zeros((0, 2)), np.zeros(0)) == 0
    assert buf.push(np.zeros(4), [1.0]) == 1


# ------------------------------------------------------- trainer cycle

def test_run_once_skips_below_min_rows_and_restores_buffer():
    tr = OnlineTrainer(_train(), trigger_rows=1000, min_rows=64, start=False)
    tr.ingest(*_data(20, seed=3))
    assert tr.run_once() == "skipped"
    assert tr.buffer.rows == 20 and tr.state()["last_result"] == "skipped"


def test_refit_promotion_bumps_version_once_and_serves_new_model():
    bst = _train()
    sess = PredictSession(bst, buckets=(64,))
    Xq = _data(32, seed=9)[0]
    before = sess.predict(Xq)
    v0 = bst.inner.model_version
    tr = OnlineTrainer(bst, mode="refit", trigger_rows=100, min_rows=32,
                       shadow_rows=256, start=False)
    promos0 = telemetry.counter("online/promotions")
    tr.ingest(*_data(200, seed=4))
    assert tr.run_once() == "promoted"
    assert bst.inner.model_version == v0 + 1
    assert telemetry.counter("online/promotions") == promos0 + 1
    st = tr.state()
    assert st["promotions"] == 1 and st["can_rollback"]
    assert st["last_losses"]["candidate"] <= st["last_losses"]["current"]
    after = sess.predict(Xq)
    assert not np.allclose(before, after)
    np.testing.assert_allclose(after, bst.predict(Xq), rtol=1e-5, atol=1e-6)


def test_shadow_gate_rejects_degraded_candidate_pack_identical():
    bst = _train(seed=1)
    sess = PredictSession(bst, buckets=(64,))
    sess.predict(_data(8, seed=5)[0])
    fp0 = sess.pack_fingerprint()
    v0 = bst.inner.model_version

    def degraded(X, y):
        cand = lgt.Booster(CPU, model_str=bst.model_to_string())
        for t in cand.inner.models:
            t.leaf_value[:] = 1e3
        cand.inner._bump_model_version()
        return cand

    tr = OnlineTrainer(bst, trigger_rows=100, min_rows=32,
                       candidate_factory=degraded, start=False)
    rej0 = telemetry.counter("online/rejections")
    tr.ingest(*_data(200, seed=6))
    assert tr.run_once() == "rejected"
    assert telemetry.counter("online/rejections") == rej0 + 1
    assert bst.inner.model_version == v0
    assert sess.pack_fingerprint() == fp0
    st = tr.state()
    assert st["rejections"] == 1 and st["last_result"] == "rejected"
    assert st["last_losses"]["candidate"] > st["last_losses"]["current"]


def test_shadow_decay_weighted_loss_matches_manual():
    from lightgbm_tpu_torch.online.trainer import _EPS, _CandidateBuilder
    bst = _train(seed=5)
    src = bst.model_to_string()
    Xs, ys = _data(50, seed=7)
    cand = lgt.Booster(CPU, model_str=src)
    p = np.clip(bst.predict(Xs), _EPS, 1.0 - _EPS)
    per_row = -(ys * np.log(p) + (1 - ys) * np.log(1 - p))
    uni = _CandidateBuilder("refit", src, {}, 1, None, device_type="cpu")
    cur_u, cand_u = uni.score_pair(cand, Xs, ys)
    assert cur_u == cand_u == float(np.mean(per_row))
    dec = _CandidateBuilder("refit", src, {}, 1, None, shadow_decay=0.9,
                            device_type="cpu")
    cur_d, _ = dec.score_pair(cand, Xs, ys)
    w = 0.9 ** np.arange(len(ys) - 1, -1, -1, dtype=np.float64)
    np.testing.assert_allclose(cur_d, np.average(per_row, weights=w),
                               rtol=1e-12)
    assert cur_d != cur_u


def test_shadow_decay_flips_promotion_under_drift():
    X_new, y_new = _data(200, seed=11)
    cand_src = lgt.train(dict(PARAMS), lgt.Dataset(X_new, label=1 - y_new),
                         num_boost_round=6).model_to_string()

    def run(decay):
        bst = _train(seed=1)
        cand = lgt.Booster(CPU, model_str=cand_src)
        tr = OnlineTrainer(bst, trigger_rows=10_000, min_rows=32,
                           shadow_rows=1024, shadow_decay=decay,
                           candidate_factory=lambda X, y: cand, start=False)
        tr.ingest(*_data(600, seed=12))
        tr.ingest(X_new, 1 - y_new)
        return tr.run_once()

    assert run(1.0) == "rejected"
    assert run(0.95) == "promoted"


def test_trainer_settings_validated_and_surfaced():
    bst = _train(seed=6)
    for bad in (dict(shadow_decay=0.0), dict(shadow_decay=1.5),
                dict(mode="nope"), dict(promote_patience=0),
                dict(rollback_threshold=-1.0), dict(trigger_rows=0)):
        with pytest.raises(LightGBMError):
            OnlineTrainer(bst, start=False, **bad)
    tr = OnlineTrainer(bst, shadow_decay=0.98, start=False)
    assert tr.state()["shadow_decay"] == 0.98


def test_promote_threshold_zero_rejects_everything():
    tr = OnlineTrainer(_train(seed=2), trigger_rows=100, min_rows=32,
                       promote_threshold=0.0, start=False)
    tr.ingest(*_data(200, seed=7))
    assert tr.run_once() == "rejected"


def test_patience_defers_then_promotes():
    bst = _train(seed=2)
    v0 = bst.inner.model_version
    # a generous gate: this test is about the streak, not the scoring
    tr = OnlineTrainer(bst, trigger_rows=100, min_rows=32,
                       promote_threshold=1.25, promote_patience=2,
                       start=False)
    tr.ingest(*_data(200, seed=8))
    assert tr.run_once() == "deferred" and bst.inner.model_version == v0
    tr.ingest(*_data(200, seed=9))
    assert tr.run_once() == "promoted"
    assert bst.inner.model_version == v0 + 1


def test_continue_mode_adds_rounds():
    bst = _train(seed=3, rounds=4)
    n0 = len(bst.inner.models)
    tr = OnlineTrainer(bst, mode="continue", continue_rounds=2,
                       trigger_rows=100, min_rows=32, start=False)
    tr.ingest(*_data(256, seed=8))
    assert tr.run_once() == "promoted"
    assert len(bst.inner.models) == n0 + 2


def test_rollback_restores_previous_model_and_live_watch():
    bst = _train(seed=4)
    tr = OnlineTrainer(bst, trigger_rows=100, min_rows=32,
                       promote_threshold=1.25, rollback_threshold=1e-9,
                       rollback_min_rows=50, start=False)
    s_before = bst.model_to_string()
    tr.ingest(*_data(200, seed=9))
    assert tr.run_once() == "promoted"
    assert bst.model_to_string() != s_before
    assert tr.state()["watch_armed"]
    # the live watch: a threshold near 0 judges the promoted model worse
    # on the rows ingested after the swap, and rolls back once
    tr.ingest(*_data(60, seed=10))
    assert tr.watch_once() is True
    assert bst.model_to_string() == s_before
    assert tr.state()["auto_rollbacks"] == 1
    assert not tr.rollback()
    tr.ingest(*_data(200, seed=13))
    assert tr.run_once() in ("promoted", "rejected")


def test_worker_thread_triggers_on_row_count():
    bst = _train(seed=5)
    tr = OnlineTrainer(bst, trigger_rows=128, min_rows=64,
                       shadow_rows=256, start=True)
    try:
        v0 = bst.inner.model_version
        tr.ingest(*_data(256, seed=11))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and tr.state()["trains"] < 1:
            time.sleep(0.05)
        st = tr.state()
        assert st["trains"] >= 1 and st["errors"] == 0, st
        if st["promotions"]:
            assert bst.inner.model_version > v0
    finally:
        tr.close(timeout=30)
    assert tr.state()["running"] is False


def test_atomic_swap_every_batch_is_one_whole_version():
    """Serve threads predict while the main thread promotes: every output
    equals the model at one whole version."""
    bst = _train(seed=6)
    sess = PredictSession(bst, buckets=(64,))
    Xq = np.ascontiguousarray(_data(16, seed=12)[0])
    expected = {bst.inner.model_version: bst.predict(Xq)}
    observed = []
    stop = threading.Event()

    def serve():
        while not stop.is_set() and len(observed) < 200:
            v0 = bst.inner.model_version
            out = np.asarray(sess.predict(Xq), np.float64)
            observed.append((v0, out, bst.inner.model_version))

    th = threading.Thread(target=serve, name="online-test-serve")
    th.start()
    try:
        tr = OnlineTrainer(bst, trigger_rows=64, min_rows=32,
                           shadow_rows=128, start=False)
        for i in range(3):
            tr.ingest(*_data(96, seed=20 + i))
            tr.run_once()
            expected[bst.inner.model_version] = bst.predict(Xq)
    finally:
        stop.set()
        th.join(timeout=60)
    assert not th.is_alive() and observed and len(expected) >= 2
    for v0, out, v1 in observed:
        assert any(v in expected and np.allclose(out, expected[v],
                                                 rtol=1e-5, atol=1e-6)
                   for v in range(v0, v1 + 1)), (v0, v1)


def test_fleet_knobs_raise_naming_item_8(tmp_path):
    """The trainer's fleet settings raised, naming ROADMAP item 8, until
    the fleet was ported. Now each of them runs over a store, and their
    bad values raise the JAX trainer's errors."""
    import lightgbm_tpu as jlgb
    from lightgbm_tpu.online import OnlineTrainer as JaxOnlineTrainer

    from lightgbm_tpu_torch.fleet import FleetStore

    bst = _train(seed=7)
    store = FleetStore(str(tmp_path), "m")
    for knobs in (dict(), dict(lease_ttl_s=1.0), dict(replay=False),
                  dict(holder_id="node-1"), dict(compact_bytes=1 << 20),
                  dict(keep_artifacts=2), dict(snapshot_rows=100),
                  dict(heartbeat_interval_s=1.0),
                  dict(advertise_url="http://localhost:1")):
        tr = OnlineTrainer(bst, start=False, store=store, **knobs)
        try:
            st = tr.state()
            assert st["role"] == ("standby" if knobs.get("lease_ttl_s")
                                  else "solo"), knobs
            assert st["store"]["model_id"] == "m"
            tr.ingest(*_data(8, seed=1))
        finally:
            tr.close()
    assert [e["n"] for e in store.events("ingest")] == [8] * 9
    jb = jlgb.Booster(model_str=bst.model_to_string())
    for knobs in (dict(lease_ttl_s=-1.0), dict(snapshot_rows=100),
                  dict(snapshot_rows=-1), dict(lease_ttl_s=1.0),
                  dict(compact_bytes=1 << 20), dict(compact_bytes=-1),
                  dict(heartbeat_interval_s=-1.0)):
        with pytest.raises(jlgb.utils.log.LightGBMError) as want:
            JaxOnlineTrainer(jb, start=False, **knobs)
        with pytest.raises(LightGBMError) as got:
            OnlineTrainer(bst, start=False, **knobs)
        assert str(got.value) == str(want.value), knobs


# ---------------------------------------------------- admission control

class _SlowSession:
    """MicroBatcher-shaped fake: dispatch sleeps, predictions are row
    sums."""

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


def test_admission_control_shed_raises_and_counts():
    shed0 = telemetry.counter("serve/shed")
    b = MicroBatcher(_SlowSession(0.2), max_batch_rows=8, max_wait_ms=1.0,
                     max_queue_rows=8, overload="shed")
    try:
        futs = [b.submit(np.ones((8, 4)))]
        time.sleep(0.05)
        futs.append(b.submit(np.ones((8, 4))))
        with pytest.raises(QueueFullError):
            for _ in range(20):
                futs.append(b.submit(np.ones((8, 4))))
        for f in futs:
            np.testing.assert_allclose(f.result(timeout=30), 4.0)
    finally:
        b.close()
    assert telemetry.counter("serve/shed") >= shed0 + 1


def test_admission_control_block_waits_and_completes():
    b = MicroBatcher(_SlowSession(0.02), max_batch_rows=8, max_wait_ms=1.0,
                     max_queue_rows=8, overload="block")
    try:
        futs = [b.submit(np.full((4, 4), i, np.float64)) for i in range(12)]
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(timeout=60), 4.0 * i)
    finally:
        b.close()


# ------------------------------------------------- multi-tenant serving

def test_multi_tenant_routing_healthz_and_ingest_409():
    clf = _train(seed=7)
    Xr = _data(200, seed=13)[0]
    reg_bst = lgt.train(dict(PARAMS, objective="regression", num_leaves=7),
                        lgt.Dataset(Xr, label=Xr @ W), num_boost_round=4)
    registry = ModelRegistry()
    registry.register("clf", clf, buckets=(64,))
    registry.register("reg", reg_bst, buckets=(64,),
                      online=dict(trigger_rows=10_000, start=False))
    server = PredictServer(registry=registry, port=0)
    base = "http://%s:%d" % server.address
    th = _start(server)
    try:
        Xq = _data(5, seed=14)[0]
        code, out = _post(base + "/predict/clf", {"rows": Xq.tolist()})
        assert code == 200 and out["rows"] == 5
        np.testing.assert_allclose(out["predictions"], clf.predict(Xq),
                                   rtol=1e-5, atol=1e-6)
        code, out2 = _post(base + "/predict", {"rows": Xq.tolist(),
                                               "model": "reg"})
        np.testing.assert_allclose(out2["predictions"], reg_bst.predict(Xq),
                                   rtol=1e-4, atol=1e-5)
        for path in ("/predict", "/predict/nope"):
            with pytest.raises(HTTPError) as ei:
                _post(base + path, {"rows": Xq.tolist()})
            assert ei.value.code == 404
        # ingest without online training on the target model
        with pytest.raises(HTTPError) as ei:
            _post(base + "/ingest/clf", {"rows": Xq.tolist(),
                                         "labels": [1] * 5})
        assert ei.value.code == 409
        # per-tenant routing: the rows land in reg's trainer only
        code, out3 = _post(base + "/ingest/reg",
                           {"rows": Xq.tolist(),
                            "labels": (Xq @ W).tolist()})
        assert code == 200 and out3 == {"buffered_rows": 5, "rows": 5}
        with pytest.raises(HTTPError) as ei:
            _post(base + "/ingest/reg", {"rows": Xq.tolist(),
                                         "labels": [1.0] * 4})
        assert ei.value.code == 400
        assert registry.get("reg").online.buffer.rows == 5
        assert sorted(_get(base + "/models")["models"]) == ["clf", "reg"]
        health = _get(base + "/healthz")
        assert health["status"] == "ok" and health["model_count"] == 2
        assert health["models"]["clf"]["online"] is None
        assert health["models"]["reg"]["online"]["buffered_rows"] == 5
        assert set(health["promotions"]) == {"reg"}
    finally:
        server.shutdown()
        th.join(timeout=10)
        server.close()


def test_graceful_drain_503_and_queued_work_completes():
    registry = ModelRegistry()

    class _B:                                   # booster stub for /healthz
        class inner:
            model_version = 1

    sess = _SlowSession(0.3)
    batcher = MicroBatcher(sess, max_batch_rows=8, max_wait_ms=1.0)
    registry.add_entry(RegistryEntry("default", _B(), sess, batcher))
    server = PredictServer(registry=registry, port=0)
    base = "http://%s:%d" % server.address
    th = _start(server)
    results = {}

    def post_slow(key):
        try:
            results[key] = _post(base + "/predict",
                                 {"rows": [[1.0] * 4] * 8})
        except HTTPError as exc:
            results[key] = (exc.code, json.loads(exc.read()))

    try:
        t1 = threading.Thread(target=post_slow, args=("inflight",))
        t1.start()
        time.sleep(0.1)
        t2 = threading.Thread(target=post_slow, args=("queued",))
        t2.start()
        time.sleep(0.05)
        drainer = threading.Thread(target=server.begin_shutdown)
        drainer.start()
        time.sleep(0.05)
        post_slow("during_drain")
        for t in (t1, t2, drainer):
            t.join(timeout=30)
        assert results["during_drain"][0] == 503
        for key in ("inflight", "queued"):
            assert results[key][0] == 200, results[key]
            np.testing.assert_allclose(results[key][1]["predictions"], 4.0)
        th.join(timeout=10)
        assert not th.is_alive()
    finally:
        server.close()


def test_e2e_concurrent_predict_ingest_promotion_zero_failures():
    bst = _train(seed=8)
    server = PredictServer(bst, port=0, buckets=(64,), max_wait_ms=1.0,
                           online=dict(trigger_rows=64, min_rows=32,
                                       shadow_rows=256))
    base = "http://%s:%d" % server.address
    th = _start(server)
    failures = []
    stop = threading.Event()
    Xq = _data(8, seed=15)[0]

    def predict_loop():
        while not stop.is_set():
            try:
                code, out = _post(base + "/predict", {"rows": Xq.tolist()})
                if code != 200 or len(out["predictions"]) != 8:
                    failures.append(out)
            except Exception as exc:        # noqa: BLE001 - record all
                failures.append(repr(exc))
            time.sleep(0.005)

    preds = [threading.Thread(target=predict_loop) for _ in range(2)]
    for p in preds:
        p.start()
    try:
        deadline = time.monotonic() + 90
        seed = 30
        while time.monotonic() < deadline:
            Xn, yn = _data(48, seed=seed)
            seed += 1
            code, _ = _post(base + "/ingest", {"rows": Xn.tolist(),
                                               "labels": yn.tolist()})
            assert code == 200
            st = _get(base + "/healthz")["models"]["default"]["online"]
            if st["promotions"] >= 1:
                break
            time.sleep(0.1)
        assert st["promotions"] >= 1 and st["errors"] == 0, st
        assert server.online.state()["promotions"] >= 1
    finally:
        stop.set()
        for p in preds:
            p.join(timeout=30)
        server.shutdown()
        th.join(timeout=10)
        server.close()
    assert not failures, failures[:3]
    for name in ("online/promotions", "online/rejections",
                 "online/train_runs"):
        assert name in telemetry.snapshot()["counters"], name


# -------------------------------------------- the JAX package's answers

def test_continue_promotion_serves_the_jax_answers(tmp_path):
    """A continue-mode candidate trains on the buffer's own bins, so some
    thresholds fall inside the serving train_set's bins. The port then
    serves through the raw thresholds (the forest path is ineligible), as
    the JAX package serves by default: served answers equal the JAX
    package's and each package's raw predict; BIN routing (the JAX
    package's ``forest="on"``) would not."""
    import lightgbm_tpu as lgb
    from lightgbm_tpu.online import OnlineTrainer as JaxTrainer
    from lightgbm_tpu.serve import PredictSession as JaxSession
    from lightgbm_tpu_torch.ops.forest import forest_pack

    def grid(n, seed):
        X, y = _data(n, seed)
        return np.round(X * 64) / 64, y

    X, y = grid(600, 0)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "min_data_in_leaf": 5, "min_gain_to_split": 1e-3}
    ds = lgb.Dataset(X, label=y)
    jb = lgb.train(dict(params), ds, 4)
    path = str(tmp_path / "train.npz")
    ds.save_binary(path)
    pb = lgt.booster_from_reference(jb.model_to_string(), path, CPU)
    cont = {"min_gain_to_split": 1e-3, "min_data_in_leaf": 5,
            "num_leaves": 15}
    Xn, yn = grid(400, 5)
    for bst, cls in ((jb, JaxTrainer), (pb, OnlineTrainer)):
        tr = cls(bst, mode="continue", continue_rounds=2, trigger_rows=100,
                 min_rows=32, start=False, continue_params=cont)
        tr.ingest(Xn, yn)
        assert tr.run_once() == "promoted"
    assert_same_trees(jb.inner.models, pb.inner.models)
    with pytest.raises(ValueError, match="inside the dataset's bins"):
        forest_pack(pb.inner.models, pb.inner.train_set)
    Xq = np.random.RandomState(9).randn(300, len(W))   # off the grid
    served = PredictSession(pb).predict(Xq)
    np.testing.assert_allclose(served, JaxSession(jb).predict(Xq),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(served, pb.predict(Xq), rtol=1e-5,
                               atol=1e-6)
    binned = np.asarray(JaxSession(jb, forest="on").predict(Xq))
    assert np.abs(binned - served).max() > 1e-4


def test_chip_smoke_api_online_phase_on_cpu(monkeypatch):
    """chip_smoke's phase 3k at a tiny size on the host: every part runs
    and checks (cv folds and trees card = host, the classifier, the
    schedule, refit, SHAP, the compiled model, online serving)."""
    import shutil
    import torch
    import chip_smoke
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    for name, v in (("API_CONVERT_ROWS", 300), ("API_CONTRIB_ROWS", 100),
                    ("API_INGEST_ROWS", 128), ("API_PREDICT_ROWS", 16)):
        monkeypatch.setattr(chip_smoke, name, v)
    data = chip_smoke.training_data(0, 3000, 800)
    summary, counts = chip_smoke.phase_api_online(
        torch.device("cpu"), data, "cpu", leaves=7, host_rows=1500,
        host_leaves=5, fit_rounds=3)
    assert summary["online"]["failures"] == 0
    assert summary["online"]["verdicts"] >= 1
    assert set(summary["online"]["predict_latency_ms"]) == {
        "idle", "refit", "continue", "after_continue"}
    assert summary["cv"]["card_vs_host"]["tree_diffs"] == []
    assert set(counts) >= {"cv", "sklearn_fit", "refit", "online_refit",
                           "online_continue", "online_idle",
                           "online_after_continue"}
