"""Serving replicas: watch the fleet store, hot-swap whole models
(PyTorch port of ``lightgbm_tpu/fleet/replica.py``).

One trainer process publishes promoted models as version-tokened
artifacts (:meth:`~lightgbm_tpu_torch.fleet.store.FleetStore.publish`); each
serving replica runs a :class:`ReplicaWatcher` that polls the store and
adopts newer versions through the existing ``Booster.adopt`` path — the
same single-version-bump atomic swap the in-process online trainer uses,
so every concurrent ``PredictSession`` snapshot on the replica sees the
old ensemble or the new one whole. Replicas never train; they only
apply whole historical models.

The store is duck-typed: a filesystem
:class:`~lightgbm_tpu_torch.fleet.store.FleetStore`, a
:class:`~lightgbm_tpu_torch.fleet.transport.RemoteStore` polling one
trainer's ``/fleet`` endpoints over HTTP, or a
:class:`~lightgbm_tpu_torch.fleet.control.MultiEndpointStore` failing over
across a LIST of fleet endpoints (liveness-ranked, capped cooldowns) —
the watcher code is identical in all three: version tokens are global,
so exactly one version bump per applied publish holds no matter which
endpoint served which poll. Loads
go through ``latest_valid_publish``, which verifies each artifact
against the sha256 + length in its publish event and walks back to the
previous good publish past corruption; stale-epoch publishes from a
fenced-off zombie trainer are rejected inside the store scan. A failing
store backs the poll off exponentially (capped, reset on first success)
so a dead store is not hammered at ``poll_interval_s``.

Rollbacks distribute the same way: the trainer publishes the restored
model under a NEW version token, and replicas converge by always
applying the newest token (exactly one local version bump per applied
publish — pinned in tests/test_fleet.py).
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..obs import telemetry, tracer
from ..utils.log import LightGBMError, Log

#: per-watcher publish->adopt lag samples kept for heartbeat p50/p99
_LAG_WINDOW = 64


def _percentile(sorted_vals: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile of an ascending list (None when empty)."""
    if not sorted_vals:
        return None
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def bootstrap_model(store, params: Optional[Dict[str, Any]] = None):
    """(booster, version) from the store's newest verified publish, or
    (None, 0) when nothing usable was published yet (the replica then
    needs an ``input_model`` to boot from). ``params`` go to the booster
    (its ``device_type``: the card unless they say otherwise)."""
    loaded = store.latest_valid_publish(0)
    if loaded is None:
        return None, 0
    event, model_str = loaded
    from ..basic import Booster
    return Booster(dict(params or {}), model_str=model_str), \
        int(event["version"])


class _ArtifactLoader:
    """Thread-confined model build for one swap: constructed fresh per
    applied publish, so the candidate booster it parses is private to
    that poll (the online trainer's _CandidateBuilder pattern), on the
    serving booster's device, and the only shared-model call left on the
    poller thread is the lock-guarded ``adopt``."""

    def __init__(self, store, device_type: str = "cuda") -> None:
        self._store = store
        self._device = {"device_type": device_type}

    def fetch(self, min_version: int):
        """(event, candidate booster) for the newest verified publish
        past ``min_version``, or None."""
        loaded = self._store.latest_valid_publish(min_version)
        if loaded is None:
            return None
        event, model_str = loaded
        from ..basic import Booster
        return event, Booster(self._device, model_str=model_str)


class ReplicaWatcher:
    """Poll the store for newer published versions and hot-swap them
    into one serving booster.

    ``start=True`` (default) runs a named daemon thread polling every
    ``poll_interval_s``; tests drive :meth:`poll_once` synchronously with
    ``start=False``. Each applied publish is one ``Booster.adopt`` — one
    version bump, whole model, never a partial state. Poll failures back
    off exponentially up to ``backoff_max_s`` (gauge
    ``fleet/poll_backoff_ms``), reset by the next success.
    """

    def __init__(self, booster, store, *,
                 poll_interval_s: float = 0.5,
                 applied_version: int = 0,
                 backoff_max_s: float = 10.0,
                 heartbeat_interval_s: float = 0.0,
                 node_id: Optional[str] = None,
                 role: str = "replica",
                 start: bool = True) -> None:
        if poll_interval_s <= 0:
            raise LightGBMError("fleet poll_interval_s must be > 0, "
                                "got %g" % poll_interval_s)
        if backoff_max_s < poll_interval_s:
            raise LightGBMError("fleet backoff_max_s must be >= "
                                "poll_interval_s, got %g < %g"
                                % (backoff_max_s, poll_interval_s))
        self._booster = booster
        # candidates are built on the serving booster's device
        self._device_type = getattr(getattr(booster, "config", None),
                                    "device_type", "cuda")
        self._store = store
        self._poll = float(poll_interval_s)
        self._backoff_max = float(backoff_max_s)
        # guards the applied-version token, the swap counters and the
        # error-backoff state (the poller thread writes them, /healthz
        # handler threads read), and doubles as the poller's wakeup so
        # close() never waits a full poll interval
        self._lock = threading.Condition()
        self._applied = int(applied_version)
        self._swaps = 0
        self._errors = 0
        self._backoff = 0.0
        self._last_error = ""
        self._last_swap_ts = 0.0
        self._stopped = False
        # convergence observability: newest head version seen on the
        # store, publish->adopt lag of the last swap plus a bounded
        # sample window for heartbeat p50/p99, consecutive poll errors
        # (reset on success — /healthz surfaces "is it failing NOW")
        self._head_version = int(applied_version)
        self._last_adopt_lag_ms: Optional[float] = None
        self._lag_samples: deque = deque(maxlen=_LAG_WINDOW)
        self._consec_errors = 0
        self._node = str(node_id) if node_id else "pid-%d" % os.getpid()
        self._role = str(role)
        self._hb_interval = float(heartbeat_interval_s)
        self._hb_last = 0.0
        self._hb_sent = 0
        self._hb_errors = 0
        telemetry.gauge("fleet/applied_version", self._applied)
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._worker, name="lgbtpu-fleet-replica",
                daemon=True)
            self._thread.start()

    # ----------------------------------------------------------------- polling
    def poll_once(self) -> bool:
        """Check the store once; adopt a newer version if one was
        published. Returns True when a swap happened.

        Spans and trace ids across processes come with the port's span
        recorder (ROADMAP item 10)."""
        telemetry.count("fleet/replica_polls")
        latest = self._store.latest_publish()
        if latest is None:
            return False
        head = int(latest["version"])
        with self._lock:
            applied = self._applied
            self._head_version = head
        telemetry.gauge("fleet/version_skew", max(0, head - applied))
        if head <= applied:
            return False
        # checksum-verified fetch, falling back past corrupt artifacts;
        # build the private candidate off-lock, then adopt — ONE version
        # bump, whole-model invariant held
        loaded = _ArtifactLoader(self._store,
                                 self._device_type).fetch(applied)
        if loaded is None:
            return False
        event, candidate = loaded
        version = int(event["version"])
        with tracer.span("fleet/replica_swap", domain="serve",
                         version=version):
            self._booster.adopt(candidate)
        now = time.time()
        # publish->adopt convergence lag: the publish event is stamped
        # with the trainer's wall clock (store._stamp), so the delta is
        # exactly how stale this replica was when it caught up
        ev_ts = float(event.get("ts", 0.0) or 0.0)
        lag_ms = max(0.0, (now - ev_ts) * 1e3) if ev_ts > 0.0 else None
        with self._lock:
            self._applied = version
            self._swaps += 1
            self._last_swap_ts = now
            if lag_ms is not None:
                self._last_adopt_lag_ms = lag_ms
                self._lag_samples.append(lag_ms)
        telemetry.count("fleet/replica_swaps")
        telemetry.gauge("fleet/applied_version", version)
        telemetry.gauge("fleet/version_skew", max(0, head - version))
        if lag_ms is not None:
            telemetry.observe("fleet/publish_adopt_lag_ms", lag_ms)
        Log.info("fleet: replica adopted published model v%d (%s)",
                 version, event.get("event"))
        return True

    def _worker(self) -> None:
        while True:
            with self._lock:
                if self._stopped:
                    return
                wait = self._backoff if self._backoff > 0 else self._poll
                self._lock.wait(timeout=wait)
                if self._stopped:
                    return
            try:
                self.poll_once()
                with self._lock:
                    had_backoff = self._backoff > 0
                    self._backoff = 0.0
                    self._consec_errors = 0
                if had_backoff:
                    telemetry.gauge("fleet/poll_backoff_ms", 0.0)
            except Exception as exc:
                # a torn read or transient FS/network error must not kill
                # the watcher: count it, back off, retry
                with self._lock:
                    self._errors += 1
                    self._consec_errors += 1
                    self._last_error = "%s: %s" % (type(exc).__name__, exc)
                    self._backoff = min(
                        self._backoff_max,
                        (self._backoff if self._backoff > 0
                         else self._poll) * 2.0)
                    backoff = self._backoff
                telemetry.count("fleet/replica_poll_errors")
                telemetry.gauge("fleet/poll_backoff_ms",
                                backoff * 1000.0)
                Log.warning("fleet: replica poll failed (backoff %gs): "
                            "%s: %s", backoff, type(exc).__name__, exc)
            try:
                self.maybe_heartbeat()
            except Exception:
                # heartbeats are observability: a store that cannot take
                # one must not perturb the poll/backoff loop
                with self._lock:
                    self._hb_errors += 1
                telemetry.count("fleet/heartbeat_errors")

    # -------------------------------------------------------------- heartbeats
    def heartbeat_doc(self) -> Dict[str, Any]:
        """Compact node summary recorded to the store each heartbeat
        (role, version, skew, lag percentiles, key counters) — the unit
        the ``/fleet/status`` rollup federates."""
        with self._lock:
            lags = sorted(self._lag_samples)
            return {
                "node": self._node,
                "role": self._role,
                "pid": os.getpid(),
                "version": self._applied,
                "head_version": self._head_version,
                "skew": max(0, self._head_version - self._applied),
                "swaps": self._swaps,
                "poll_errors": self._errors,
                "consec_poll_errors": self._consec_errors,
                "poll_backoff_s": self._backoff,
                "last_swap_ts": self._last_swap_ts,
                "lag_ms": {
                    "last": self._last_adopt_lag_ms,
                    "p50": _percentile(lags, 0.50),
                    "p99": _percentile(lags, 0.99),
                },
            }

    def maybe_heartbeat(self, force: bool = False) -> bool:
        """Record a heartbeat when one is due (``heartbeat_interval_s``
        elapsed; 0 disables unless ``force``). Duck-tolerant: a store
        without ``record_heartbeat`` is a no-op."""
        if self._hb_interval <= 0 and not force:
            return False
        record = getattr(self._store, "record_heartbeat", None)
        if record is None:
            return False
        now = time.monotonic()
        with self._lock:
            if not force and now - self._hb_last < self._hb_interval:
                return False
            self._hb_last = now
        if not record(self.heartbeat_doc()):
            return False
        with self._lock:
            self._hb_sent += 1
        return True

    # ------------------------------------------------------------------- state
    @property
    def applied_version(self) -> int:
        with self._lock:
            return self._applied

    def state(self) -> Dict[str, Any]:
        """JSON-serializable watcher state (surfaced on /healthz)."""
        with self._lock:
            return {
                "running": self._thread.is_alive()
                if self._thread is not None else False,
                "node": self._node,
                "role": self._role,
                "applied_version": self._applied,
                "head_version": self._head_version,
                "version_skew": max(0, self._head_version - self._applied),
                "swaps": self._swaps,
                "poll_errors": self._errors,
                "consec_poll_errors": self._consec_errors,
                "poll_backoff_s": self._backoff,
                "last_error": self._last_error,
                "last_swap_ts": self._last_swap_ts,
                "last_adopt_lag_ms": self._last_adopt_lag_ms,
                "poll_interval_s": self._poll,
                "heartbeats": {
                    "interval_s": self._hb_interval,
                    "sent": self._hb_sent,
                    "errors": self._hb_errors,
                },
            }

    # ---------------------------------------------------------------- shutdown
    def close(self, timeout: Optional[float] = None) -> None:
        """Stop the poller thread. Idempotent."""
        with self._lock:
            self._stopped = True
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)

    def __enter__(self) -> "ReplicaWatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
