"""The port's fleet control plane on the CPU, mirroring the non-slow
cases of tests/test_control.py: the remote write surface, multi-endpoint
failover, ingest forwarding, snapshot compaction and the chaos
partition and reorder kinds. Then a refit-mode fleet cycle on both
packages from the same seeded ingest."""

import json
import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import lightgbm_tpu_torch as lgb  # noqa: E402
from lightgbm_tpu_torch.fleet import FleetStore, IngestForwarder, \
    MultiEndpointStore, RemoteStore, RemoteWriteStore, ReplicaWatcher, \
    StaleLeaseError, TransportError, bootstrap_model, chaos  # noqa: E402
from lightgbm_tpu_torch.fleet.chaos import FaultPlan  # noqa: E402
from lightgbm_tpu_torch.fleet.control import EndpointSelector  # noqa: E402
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


def _trainer(bst, store, **kw):
    """Trainer with the gate wide open (threshold 2.0) so a refit
    candidate always banks a win — these tests exercise the control
    plane, not the gate's judgment."""
    kw.setdefault("trigger_rows", 10 ** 9)
    kw.setdefault("min_rows", 64)
    kw.setdefault("shadow_rows", 120)
    kw.setdefault("promote_threshold", 2.0)
    kw.setdefault("promote_patience", 2)
    kw.setdefault("start", False)
    return OnlineTrainer(bst, store=store, **kw)


def _host(store, bst=None, online=None, forwarder=None):
    """One in-process store-host endpoint: a PredictServer with the
    given FleetStore attached (and optionally a live trainer and/or an
    ingest forwarder), serving on an ephemeral port."""
    server = PredictServer(bst if bst is not None else _train(), port=0,
                           buckets=(16, 64), max_wait_ms=1.0,
                           online=online)
    server.fleet_store = store
    if forwarder is not None:
        server.ingest_forwarder = forwarder
    th = threading.Thread(target=server.serve_forever,
                          name="control-test-http", daemon=True)
    th.start()
    host, port = server.address
    return server, th, "http://%s:%d" % (host, port)


def _stop(server, thread):
    server.shutdown()
    thread.join(timeout=30)
    server.close()


# ------------------------------------------------------------ remote lease

def test_remote_lease_acquire_renew_release_epoch_bumps(tmp_path):
    """POST /fleet/lease round-trips the full lease lifecycle, and every
    acquisition bumps the fencing epoch — the remote client sees the
    SAME monotonic epochs a local holder would."""
    store = FleetStore(str(tmp_path), "m")
    server, th, base = _host(store)
    try:
        remote = RemoteWriteStore(base, timeout_s=10.0)
        assert remote.lease_state()["held"] is False
        e1 = remote.acquire_lease("t1", 30.0, url="http://t1:80")
        assert e1 == 1
        lease = remote.lease_state()
        assert lease["held"] and lease["holder"] == "t1"
        assert lease["epoch"] == 1 and lease["url"] == "http://t1:80"
        # a live lease refuses a second holder, over HTTP as locally
        assert remote.acquire_lease("t2", 30.0) is None
        assert remote.renew_lease("t1", e1, 30.0) is True
        # renewing with a forged epoch is refused
        assert remote.renew_lease("t1", e1 + 7, 30.0) is False
        assert remote.release_lease("t1", e1) is True
        assert remote.lease_state()["held"] is False
        # the epoch NEVER rewinds: next acquisition fences out epoch 1
        assert remote.acquire_lease("t2", 30.0) == 2
        # the host-side lease is the same record the local path sees
        assert store.lease_state()["holder"] == "t2"
    finally:
        _stop(server, th)


def test_remote_fenced_publish_forged_epoch_409_never_adopted(tmp_path):
    """The acceptance pin, in-process: a remote publish carrying a stale
    lease epoch is rejected 409 by the store host, raises the same
    StaleLeaseError the local fence raises, writes NOTHING, and a
    watching replica never adopts it."""
    store = FleetStore(str(tmp_path), "m")
    store.publish(_train().model_to_string(), event="boot")
    server, th, base = _host(store)
    try:
        # the replica, over plain read-only HTTP
        rb, applied = bootstrap_model(RemoteStore(base, timeout_s=10.0), CPU)
        watcher = ReplicaWatcher(rb, RemoteStore(base, timeout_s=10.0),
                                 applied_version=applied, start=False)
        v0 = rb.inner.model_version

        writer = RemoteWriteStore(base, timeout_s=10.0)
        epoch = writer.acquire_lease("t1", 30.0)
        writer.set_fence("t1", epoch)
        assert writer.publish(_train(seed=1).model_to_string()) == 2
        assert watcher.poll_once() is True
        assert rb.inner.model_version == v0 + 1

        # the lease moves on (crash + takeover): epoch bumps to 2
        assert writer.release_lease("t1", epoch)
        zombie = RemoteWriteStore(base, timeout_s=10.0)
        zombie.set_fence("t1", epoch)          # stale fence, forged on
        e2 = writer.acquire_lease("t2", 30.0)  # the wire by a dead node
        assert e2 == epoch + 1
        blocked0 = telemetry.counter("fleet/stale_publishes_blocked_remote")
        with pytest.raises(StaleLeaseError):
            zombie.publish(_train(seed=2).model_to_string())
        assert telemetry.counter(
            "fleet/stale_publishes_blocked_remote") == blocked0 + 1
        # nothing landed: same head version, and the replica sees no
        # newer publish to adopt
        assert store.latest_publish()["version"] == 2
        assert watcher.poll_once() is False
        assert rb.inner.model_version == v0 + 1

        # a torn upload (sha mismatch) dies BEFORE the fence check: 400
        # on the wire, CorruptArtifactError at the client, nothing written
        from lightgbm_tpu_torch.fleet import CorruptArtifactError
        writer.set_fence("t2", e2)
        good = _train(seed=3).model_to_string()
        orig = writer._request

        def corrupting(path, data=None, no_retry=()):
            if path.endswith("/publish") and data is not None:
                body = json.loads(data.decode("utf-8"))
                body["model"] = body["model"] + "x"   # bytes != sha256
                data = json.dumps(body, sort_keys=True).encode("utf-8")
            return orig(path, data=data, no_retry=no_retry)

        writer._request = corrupting
        with pytest.raises(CorruptArtifactError):
            writer.publish(good)
        writer._request = orig
        assert store.latest_publish()["version"] == 2
    finally:
        _stop(server, th)


def test_remote_trainer_full_cycle_over_http(tmp_path):
    """OnlineTrainer(store=RemoteWriteStore(url)) runs the whole fleet
    cycle — lease, ingest persistence, gate appends, fenced publish —
    without touching the store's filesystem, and a second remote
    standby replays the identical state from the same endpoint."""
    store = FleetStore(str(tmp_path), "m")
    base_str = _train().model_to_string()
    store.publish(base_str, event="boot")
    server, th, base = _host(store)
    try:
        remote = RemoteWriteStore(base, timeout_s=10.0)
        tr = _trainer(lgb.Booster(CPU, model_str=base_str), remote,
                      lease_ttl_s=30.0)
        assert tr.try_acquire() is True
        tr.ingest(*_data(150, seed=5))
        assert tr.run_once() == "deferred"           # banks one win
        tr.ingest(*_data(60, seed=6))                # untrained tail
        st = tr.state()
        assert st["consumed_rows"] == 150 and st["win_streak"] == 1
        # everything the trainer persisted went over the wire
        assert sum(e["n"] for e in store.events("ingest")) == 210
        assert list(store.events("gate"))[-1]["wins"] == 1

        # remote standby: same endpoint, fresh booster, replayed state
        standby = _trainer(lgb.Booster(CPU, model_str=base_str),
                           RemoteWriteStore(base, timeout_s=10.0))
        assert standby.state()["consumed_rows"] == 150
        assert standby.state()["win_streak"] == 1
        assert standby.buffer.rows == tr.buffer.rows == 60
        Xa, ya = tr.buffer.shadow()
        Xb, yb = standby.buffer.shadow()
        np.testing.assert_array_equal(Xa, Xb)
        np.testing.assert_array_equal(ya, yb)

        # the banked win completes THROUGH the write surface
        tr.ingest(*_data(100, seed=7))
        assert tr.run_once() == "promoted"
        assert store.latest_publish()["version"] == 2
        assert store.latest_publish()["lease_epoch"] >= 1
    finally:
        _stop(server, th)


# -------------------------------------------------------- endpoint selector

def test_endpoint_selector_ranking_cooldown_and_switches():
    sel = EndpointSelector(["http://a", "http://b", "http://c"],
                           cooldown_base_s=0.05, cooldown_max_s=0.2)
    assert sel.current() == "http://a"
    # sticky current leads; liveness evidence ranks the rest
    sel.observe("http://b", head_version=3, heartbeat_age_s=1.0)
    sel.observe("http://c", head_version=5, heartbeat_age_s=9.0)
    assert sel.candidates() == ["http://a", "http://c", "http://b"]
    # equal heads: the fresher heartbeat wins the tie
    sel.observe("http://c", head_version=3, heartbeat_age_s=9.0)
    assert sel.candidates() == ["http://a", "http://b", "http://c"]
    # a failure cools the primary: it drops to the BACK, never vanishes
    sel.report_failure("http://a")
    cands = sel.candidates()
    assert cands[-1] == "http://a" and set(cands) == set(sel.urls)
    # success on the runner-up is a counted switch
    s0 = sel.state()["switches"]
    sel.report_success("http://b")
    assert sel.current() == "http://b"
    assert sel.state()["switches"] == s0 + 1
    # capped exponential: repeated failures double up to the cap
    for _ in range(8):
        sel.report_failure("http://a")
    assert sel.state()["endpoints"]["http://a"]["cooling_s"] <= 0.2
    # cooldown expires: the endpoint returns to the healthy pool
    time.sleep(0.25)
    assert "http://a" in sel.candidates()
    with pytest.raises(LightGBMError):
        EndpointSelector([])
    with pytest.raises(LightGBMError):
        EndpointSelector(["http://a", "http://a/"])


def test_multi_endpoint_failover_one_bump_per_publish(tmp_path):
    """The acceptance pin: a watcher following two endpoints through a
    MultiEndpointStore keeps adopting when its primary dies mid-poll —
    switching within the cooldown cap, with exactly one version bump per
    applied publish (failover must never double-adopt)."""
    store = FleetStore(str(tmp_path), "m")
    store.publish(_train().model_to_string(), event="boot")
    s1, t1, b1 = _host(FleetStore(str(tmp_path), "m"))
    s2, t2, b2 = _host(FleetStore(str(tmp_path), "m"))
    try:
        mstore = MultiEndpointStore([b1, b2], timeout_s=10.0,
                                    cooldown_base_s=0.05,
                                    cooldown_max_s=0.5)
        rb, applied = bootstrap_model(mstore, CPU)
        watcher = ReplicaWatcher(rb, mstore, applied_version=applied,
                                 start=False)
        v0 = rb.inner.model_version
        assert mstore.base_url == b1

        store.publish(_train(seed=1).model_to_string())
        assert watcher.poll_once() is True
        assert rb.inner.model_version == v0 + 1

        # kill the PRIMARY endpoint; the next poll sweeps to the
        # secondary inside the same call — no lost adoption window
        _stop(s1, t1)
        s1 = None
        switches0 = telemetry.counter("fleet/endpoint_switches")
        store.publish(_train(seed=2).model_to_string())
        assert watcher.poll_once() is True
        assert mstore.base_url == b2
        assert telemetry.counter("fleet/endpoint_switches") == switches0 + 1
        # exactly one bump per applied publish, across the failover
        st = watcher.state()
        assert rb.inner.model_version - v0 == st["swaps"] == 2
        # nothing new: poll is a no-op, still on the survivor
        assert watcher.poll_once() is False
        assert rb.inner.model_version == v0 + 2

        # both endpoints dark -> a real TransportError, not a hang
        _stop(s2, t2)
        s2 = None
        with pytest.raises(TransportError):
            mstore.latest_publish()
    finally:
        if s1 is not None:
            _stop(s1, t1)
        if s2 is not None:
            _stop(s2, t2)


# --------------------------------------------------------- ingest forwarding

def test_ingest_forwarding_relays_to_lease_holder(tmp_path):
    """Labeled traffic POSTed to a node with no trainer is relayed to
    the lease holder's /ingest and lands in ITS buffer; the response
    names the node that actually trained on the rows."""
    from urllib.request import Request, urlopen
    store = FleetStore(str(tmp_path), "m")
    bst = _train()
    leader_tr = _trainer(lgb.Booster(CPU, model_str=bst.model_to_string()),
                         None)
    ls, lt, lbase = _host(store, bst=bst, online=leader_tr)
    fstore = FleetStore(str(tmp_path), "m")
    fs, ft, fbase = _host(fstore,
                          forwarder=IngestForwarder(store=fstore,
                                                    timeout_s=10.0))
    try:
        assert store.acquire_lease("leader", 30.0, url=lbase) == 1
        X, y = _data(48, seed=9)
        body = json.dumps({"rows": X.tolist(),
                           "labels": y.tolist()}).encode()
        fwd0 = telemetry.counter("fleet/forwarded_rows")
        with urlopen(Request(fbase + "/ingest", data=body),
                     timeout=30) as resp:
            doc = json.loads(resp.read())
        assert doc["forwarded_to"] == lbase
        assert leader_tr.buffer.rows == 48
        assert telemetry.counter("fleet/forwarded_rows") == fwd0 + 48
    finally:
        _stop(fs, ft)
        _stop(ls, lt)


def test_ingest_forwarding_follows_leader_hint_and_bounds_hops(tmp_path):
    """A stale cached leader is corrected by the 409 leader_hint within
    the hop budget; a relay arriving AT the budget is refused (503 on
    the wire), so a cycling hint chain dies instead of looping."""
    from urllib.error import HTTPError
    from urllib.request import Request, urlopen
    store = FleetStore(str(tmp_path), "m")
    bst = _train()
    leader_tr = _trainer(lgb.Booster(CPU, model_str=bst.model_to_string()),
                         None)
    ls, lt, lbase = _host(store, bst=bst, online=leader_tr)
    # a second trainer-less node: answers ingest with 409 + leader_hint
    ws, wt, wbase = _host(FleetStore(str(tmp_path), "m"))
    fstore = FleetStore(str(tmp_path), "m")
    fwd = IngestForwarder(store=fstore, timeout_s=10.0, max_hops=3)
    try:
        assert store.acquire_lease("leader", 30.0, url=lbase) == 1
        # prime the forwarder's cache with the WRONG node (a leader that
        # just moved): the 409 hint must re-aim the relay to the truth
        fwd._cached_leader = wbase
        fwd._cached_at = time.monotonic()  # graftlint: disable=naked-timer -- priming the forwarder's own monotonic cache stamp
        X, y = _data(32, seed=11)
        doc = fwd.forward("default", X.tolist(), y.tolist())
        assert doc["forwarded_to"] == lbase
        assert leader_tr.buffer.rows == 32

        # the hop budget: an incoming relay already at max_hops is
        # refused at the forwarder...
        with pytest.raises(TransportError):
            fwd.forward("default", X.tolist(), y.tolist(),
                        hops=fwd.max_hops)
        # ...and over the wire the host maps that to a 503
        fs, ft, fbase = _host(fstore, forwarder=fwd)
        try:
            body = json.dumps({"rows": X.tolist(),
                               "labels": y.tolist()}).encode()
            req = Request(fbase + "/ingest", data=body,
                          headers={"X-Fleet-Hops": str(fwd.max_hops)})
            with pytest.raises(HTTPError) as exc_info:
                urlopen(req, timeout=30)
            assert exc_info.value.code == 503
        finally:
            _stop(fs, ft)
        # no trainer + NO forwarder stays the PR-13 contract: 409 with
        # a leader_hint the client may chase itself
        body = json.dumps({"rows": X.tolist(),
                           "labels": y.tolist()}).encode()
        with pytest.raises(HTTPError) as exc_info:
            urlopen(Request(wbase + "/ingest", data=body), timeout=30)
        assert exc_info.value.code == 409
        hint = json.loads(exc_info.value.read()).get("leader_hint")
        assert hint == lbase
    finally:
        _stop(ws, wt)
        _stop(ls, lt)


# --------------------------------------------------------- snapshot bootstrap

def test_snapshot_bootstrap_bit_identity(tmp_path):
    """Satellite 4: compaction with snapshot_rows folds the retained
    ingest chunks into ONE snapshot artifact, the cut lands mid-shadow-
    window, and a standby booted from snapshot + tail is BIT-identical
    to a full-replay boot — same watermark, same streak, same buffers,
    and the banked win refits to the SAME model string. A second
    standby boots the same snapshot over HTTP only."""
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
    assert tr.buffer.shadow_rows == 110 and tr.buffer.rows == 50
    shutil.copytree(orig, full)

    summary = store.compact(watermark=90, wins=1,
                            keep_rows=tr.buffer.shadow_capacity,
                            snapshot_rows=tr.buffer.shadow_capacity)
    snap = summary.get("snapshot")
    assert isinstance(snap, dict) and snap["rows"] == 110
    assert os.path.exists(store.snapshot_path(snap["id"]))
    # the log itself holds NO ingest lines any more — they live in the
    # snapshot blob; replay offsets come from the compact record
    kinds = [e["kind"] for e in store.events()]
    assert kinds.count("ingest") == 0 and kinds[0] == "compact"

    # three cold boots: snapshot+tail (local), snapshot+tail (HTTP),
    # and the untouched full log
    bst_s = lgb.Booster(CPU, model_str=base_str)
    bst_f = lgb.Booster(CPU, model_str=base_str)
    tr_s = _trainer(bst_s, FleetStore(orig, "m"))
    tr_f = _trainer(bst_f, FleetStore(full, "m"))
    server, th, base_url = _host(FleetStore(orig, "m"))
    try:
        tr_r = _trainer(lgb.Booster(CPU, model_str=base_str),
                        RemoteWriteStore(base_url, timeout_s=10.0))
        for a in (tr_s, tr_r):
            assert a.state()["consumed_rows"] \
                == tr_f.state()["consumed_rows"] == 90
            assert a.state()["win_streak"] \
                == tr_f.state()["win_streak"] == 1
            assert a.buffer.rows == tr_f.buffer.rows == 50
            assert a.buffer.shadow_rows == tr_f.buffer.shadow_rows == 110
            Xa, ya = a.buffer.shadow()
            Xf, yf = tr_f.buffer.shadow()
            np.testing.assert_array_equal(Xa, Xf)
            np.testing.assert_array_equal(ya, yf)
        # the banked win completes identically on both boot paths: the
        # SAME fresh rows trigger the SAME refit over the SAME buffers
        X6, y6 = _data(100, seed=6)
        tr_s.ingest(X6, y6)
        tr_f.ingest(X6, y6)
        assert tr_s.run_once() == "promoted"
        assert tr_f.run_once() == "promoted"
        assert bst_s.model_to_string() == bst_f.model_to_string()
    finally:
        _stop(server, th)


def test_snapshot_corruption_degrades_not_crashes(tmp_path):
    """A missing/corrupt snapshot blob costs the buffered rows it held,
    never misaligns replay: the standby boots with empty buffers at the
    compact record's row_base instead of crashing or double-counting."""
    base_str = _train().model_to_string()
    store = FleetStore(str(tmp_path), "m")
    tr = _trainer(lgb.Booster(CPU, model_str=base_str), store)
    for seed in (1, 2):
        tr.ingest(*_data(30, seed=seed))
    summary = store.compact(watermark=0, wins=0, keep_rows=200,
                            snapshot_rows=200)
    sid = summary["snapshot"]["id"]
    with open(store.snapshot_path(sid), "r+b") as f:
        f.write(b"}corrupt{")
    fails0 = telemetry.counter("fleet/snapshot_load_failures")
    tr2 = _trainer(lgb.Booster(CPU, model_str=base_str),
                   FleetStore(str(tmp_path), "m"))
    assert telemetry.counter("fleet/snapshot_load_failures") == fails0 + 1
    assert tr2.buffer.rows == 0
    # offsets stayed intact: new ingest lands PAST the snapshot rows
    tr2.ingest(*_data(10, seed=3))
    assert tr2.buffer.total_rows == 10


# ------------------------------------------------------------ chaos kinds

def test_chaos_partition_darkens_write_surface_then_heals(tmp_path):
    """The new ("partition", n) kind: n CONSECUTIVE transport failures
    from one scheduled action. A retrying remote publish rides out a
    window shorter than its retry budget; a window longer than the
    budget surfaces as TransportError — and the next call, with the
    window drained, goes straight through."""
    store = FleetStore(str(tmp_path), "m")
    server, th, base = _host(store)
    try:
        remote = RemoteWriteStore(base, timeout_s=10.0, retries=4,
                                  backoff_base_s=0.01, backoff_max_s=0.05)
        with chaos.inject(FaultPlan(
                {"transport/request": [("partition", 3)]})) as plan:
            assert remote.publish(_train(seed=1).model_to_string()) == 1
            assert plan.injected()["transport/request"] == 3
        # a window wider than the retry budget: the call fails...
        with chaos.inject(FaultPlan(
                {"transport/request": [("partition", 8)]})):
            with pytest.raises(TransportError):
                remote.publish(_train(seed=2).model_to_string())
        # ...and with the partition healed the surface works again
        assert remote.publish(_train(seed=2).model_to_string()) == 2
        assert store.latest_publish()["version"] == 2
    finally:
        _stop(server, th)


def test_chaos_partition_seeded_mix_is_deterministic():
    """seeded(kinds=KINDS_ALL) schedules the new kinds from the same
    integer seed: two builds produce byte-identical plans, and the
    legacy default mix is untouched by the new kinds."""
    def drain(plan):
        out = []
        while True:
            act = plan.next_action("transport/request")
            if act is None:
                return out
            # drop exception INSTANCES from the comparison (two builds
            # allocate distinct objects); every seeded parameter stays
            out.append(tuple(x for x in act
                             if not isinstance(x, Exception)))

    a = drain(FaultPlan.seeded(7, {"transport/request": 40},
                               kinds=FaultPlan.KINDS_ALL))
    b = drain(FaultPlan.seeded(7, {"transport/request": 40},
                               kinds=FaultPlan.KINDS_ALL))
    assert a == b and len(a) == 40
    kinds = {act[0] for act in a}
    assert "partition" in kinds and "reorder" in kinds
    legacy = drain(FaultPlan.seeded(7, {"transport/request": 40}))
    assert {act[0] for act in legacy} <= {"raise", "torn", "sleep"}


def test_chaos_reorder_delays_append_past_successor(tmp_path):
    """The new ("reorder",) kind against the write surface: one remote
    ingest append is parked and lands AFTER its successor. The log holds
    both chunks (reordered), and a replaying standby still reconstructs
    every row — the delayed-write race costs ordering, never data."""
    store = FleetStore(str(tmp_path), "m")
    base_str = _train().model_to_string()
    store.publish(base_str, event="boot")
    server, th, base = _host(store)
    try:
        remote = RemoteWriteStore(base, timeout_s=10.0)
        Xa, ya = _data(30, seed=1)
        Xb, yb = _data(20, seed=2)
        with chaos.inject(FaultPlan({"store/append": [("reorder",)]})):
            remote.append_ingest(Xa, ya)     # parked, not yet in the log
            assert sum(e["n"] for e in store.events("ingest")) == 0
            remote.append_ingest(Xb, yb)     # lands, then drains A
        chunks = [e["n"] for e in store.events("ingest")]
        assert chunks == [20, 30]            # successor first
        # replay tolerates the swap: all 50 rows, nothing duplicated
        tr = _trainer(lgb.Booster(CPU, model_str=base_str),
                      FleetStore(str(tmp_path), "m"))
        assert tr.buffer.total_rows == 50 and tr.buffer.rows == 50
    finally:
        _stop(server, th)


# ------------------------------------------------------- multi-process pin


# ------------------------------------------------------- across packages

import lightgbm_tpu as jlgb  # noqa: E402
from lightgbm_tpu.fleet import FleetStore as JaxFleetStore  # noqa: E402
from lightgbm_tpu.online import OnlineTrainer as JaxOnlineTrainer  # noqa: E402

from torch_port_cases import REFIT_ATOL, REFIT_RTOL, \
    assert_same_trees  # noqa: E402


def test_refit_fleet_cycle_matches_the_jax_package(tmp_path):
    """A refit-mode fleet cycle on both packages from the same seeded
    ingest, each into its own store: the same gate records (verdict, win
    streak, watermark; losses at the online tests' 1e-5), and published
    models with the same trees, leaves at refit's tolerances
    (torch_port_cases.REFIT_*), that predict alike at 1e-5 / 1e-6."""
    base_str = _train(seed=9).model_to_string()
    kw = dict(mode="refit", trigger_rows=10 ** 9, min_rows=64,
              shadow_rows=120, promote_threshold=2.0, promote_patience=2,
              start=False)
    jax_store = JaxFleetStore(str(tmp_path / "jax"), "m")
    port_store = FleetStore(str(tmp_path / "port"), "m")
    jax_tr = JaxOnlineTrainer(jlgb.Booster(model_str=base_str),
                              store=jax_store, **kw)
    port_tr = OnlineTrainer(lgb.Booster(CPU, model_str=base_str),
                            store=port_store, **kw)
    results = []
    for cycle in range(3):
        chunk = _data(80, seed=20 + cycle)
        jax_tr.ingest(*chunk)
        port_tr.ingest(*chunk)
        results.append((jax_tr.run_once(), port_tr.run_once()))
    assert [r[0] for r in results] == [r[1] for r in results] \
        == ["deferred", "promoted", "deferred"]
    jg = [e for e in jax_store.events() if e["kind"] == "gate"]
    pg = [e for e in port_store.events() if e["kind"] == "gate"]
    assert [(e["result"], e["wins"], e["consumed_rows"]) for e in jg] \
        == [(e["result"], e["wins"], e["consumed_rows"]) for e in pg]
    for a, b in zip(jg, pg):
        assert sorted(a["losses"]) == sorted(b["losses"])
        for key in a["losses"]:
            np.testing.assert_allclose(b["losses"][key], a["losses"][key],
                                       rtol=1e-5, err_msg=key)
    jp, pp = jax_store.publishes(), port_store.publishes()
    assert [(p["version"], p["event"]) for p in jp] \
        == [(p["version"], p["event"]) for p in pp] == [(1, "promotion")]
    jm = jlgb.Booster(model_str=jax_store.load_model(1))
    pm = lgb.Booster(CPU, model_str=port_store.load_model(1))
    assert_same_trees(jm.inner.models, pm.inner.models, rtol=REFIT_RTOL,
                      atol=REFIT_ATOL)
    Xq = _data(50, seed=30)[0]
    np.testing.assert_allclose(pm.predict(Xq), jm.predict(Xq), rtol=1e-5,
                               atol=1e-6)
