"""Region-scale fleet control plane: the remote WRITE surface (PyTorch
port of ``lightgbm_tpu/fleet/control.py``).

Without it every writer touches one disk: the lease, the event log and
the artifacts live in one ``FleetStore`` directory, ``/fleet/*`` over
HTTP is read-only, and each replica follows exactly one endpoint. This
module removes the shared-filesystem requirement from every role:

- :class:`RemoteWriteStore` — a trainer's store over HTTP. It
  duck-types the full write surface :class:`~..online.trainer.
  OnlineTrainer` uses (``acquire_lease`` / ``renew_lease`` /
  ``release_lease``, fenced ``publish``, ``append_ingest`` /
  ``append_gate``, ``compact``, ``events`` replay, snapshot loads), so
  a trainer on a machine that shares NOTHING with the store host runs
  the identical lease/fence/replay code as a local one. Fencing is
  enforced server-side: the client stamps its (holder, epoch) into
  every ``POST /fleet/publish`` body and the store host re-checks the
  lease under its own lock — a zombie's stale epoch is answered 409
  (never retried; retrying a fence verdict would just hammer the new
  leader) and surfaces here as the same :class:`~.store.
  StaleLeaseError` the local path raises.
- :class:`EndpointSelector` + :class:`MultiEndpointStore` — the read
  side's failover. A replica gets a LIST of ``fleet_urls``; the
  selector keeps a sticky current endpoint, puts failing ones in
  capped-exponential cooldown, and ranks the rest by the liveness
  evidence the heartbeat sidecars already publish (``/fleet/
  status`` head version + freshest heartbeat age). ``ReplicaWatcher``
  code is untouched: version tokens are global, so adopting each
  publish exactly once holds no matter which endpoint served it.
- :class:`IngestForwarder` — labeled traffic hitting ANY node is
  relayed to whichever node currently holds the trainer lease. The
  lease record itself advertises the holder's serving URL (written at
  acquire/renew time), responses carry a ``leader_hint``, and the
  redirect chain is bounded by an ``X-Fleet-Hops`` header so a stale
  hint loop degrades to 503, not an infinite relay.

Everything here is stdlib HTTP over the fleet transport (same retries,
same capped deterministic-jitter backoff, same chaos points), entirely
CPU-testable.
"""
from __future__ import annotations

import hashlib
import json
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from ..obs import telemetry
from ..utils.log import LightGBMError, Log
from .store import (CorruptArtifactError, StaleLeaseError, _verify_snapshot)
from .transport import RemoteStore, TransportError, _NotFound, _Rejected

_LEASE = "/fleet/lease"
_PUBLISH = "/fleet/publish"
_INGEST = "/fleet/ingest"
_GATE = "/fleet/gate"
_COMPACT = "/fleet/compact"
_EVENTS = "/fleet/events"
_SNAPSHOT = "/fleet/snapshot/%d"
_STATUS = "/fleet/status"

#: forwarded-ingest hop header: bounds the redirect chain so a stale
#: leader hint cycling between two nodes 503s instead of relaying forever
HOPS_HEADER = "X-Fleet-Hops"


class RemoteWriteStore(RemoteStore):
    """Full fleet-store write surface over HTTP.

    Extends the read-only :class:`~.transport.RemoteStore` with every
    method the online trainer drives a local :class:`~.store.FleetStore`
    with, so ``OnlineTrainer(store=RemoteWriteStore(url))`` needs no
    trainer changes: lease acquire/renew/release round-trip ``POST
    /fleet/lease``; ``publish`` uploads the whole model with its sha256
    + byte length (the host verifies the upload before it verifies the
    fence — a torn upload is 400, a zombie is 409); ingest/gate appends
    and compaction requests are relayed verbatim; ``events()`` replay
    and snapshot loads come back over GET. The fence is client-side
    state (`set_fence`) stamped into each publish body — enforcement
    happens on the store host, under the same store lock as local
    publishes, so a remote zombie and a local zombie die identically.
    """

    def __init__(self, base_url: str, **kwargs: Any) -> None:
        super().__init__(base_url, **kwargs)
        self._fence_w: Optional[Tuple[str, int]] = None
        self._last_version = 0
        self._publishes_sent = 0
        self._ingest_rows_sent = 0

    # ------------------------------------------------------------------ lease
    def _lease_op(self, op: str, body: Dict[str, Any]) -> Dict[str, Any]:
        body = dict(body)
        body["op"] = op
        data = json.dumps(body, sort_keys=True).encode("utf-8")
        try:
            doc = json.loads(self._request(_LEASE, data=data)
                             .decode("utf-8"))
        except _NotFound:
            raise TransportError(
                "%s%s not found: the store host predates the fleet "
                "control plane (no remote lease ops)" % (self._base, _LEASE))
        return doc if isinstance(doc, dict) else {}

    def acquire_lease(self, holder: str, ttl_s: float,
                      url: Optional[str] = None) -> Optional[int]:
        """Remote lease acquisition. Returns the new fencing epoch, or
        None while another live holder has it — same contract as the
        local store (the host runs the same O_EXCL-guarded code)."""
        doc = self._lease_op("acquire", {
            "holder": str(holder), "ttl_s": float(ttl_s),
            "url": str(url) if url else None})
        epoch = doc.get("epoch")
        return int(epoch) if epoch is not None else None

    def renew_lease(self, holder: str, epoch: int, ttl_s: float,
                    url: Optional[str] = None) -> bool:
        doc = self._lease_op("renew", {
            "holder": str(holder), "epoch": int(epoch),
            "ttl_s": float(ttl_s), "url": str(url) if url else None})
        return bool(doc.get("ok"))

    def release_lease(self, holder: str, epoch: int) -> bool:
        doc = self._lease_op("release", {
            "holder": str(holder), "epoch": int(epoch)})
        return bool(doc.get("ok"))

    def lease_state(self) -> Dict[str, Any]:
        doc = self._lease_op("state", {})
        lease = doc.get("lease")
        if isinstance(lease, dict):
            return lease
        return {"held": False, "holder": None, "epoch": 0,
                "expires_ts": 0.0, "url": None}

    def set_fence(self, holder: str, epoch: int) -> None:
        with self._lock:
            self._fence_w = (str(holder), int(epoch))

    def clear_fence(self) -> None:
        with self._lock:
            self._fence_w = None

    # ---------------------------------------------------------------- publish
    def publish(self, model_str: str, event: str = "promotion",
                meta: Optional[Dict[str, Any]] = None) -> int:
        """Upload + publish one whole model. The body carries the
        model's sha256 and byte length (host verifies before writing —
        a torn upload can never become an artifact) and this client's
        fence; a 409 from the host's fence check raises the same
        :class:`StaleLeaseError` a fenced-off local publish does."""
        data = model_str.encode("utf-8")
        with self._lock:
            fence = self._fence_w
        body = {
            "model": model_str, "event": str(event), "meta": meta,
            "sha256": hashlib.sha256(data).hexdigest(),
            "bytes": len(data),
            "holder": fence[0] if fence else None,
            "lease_epoch": fence[1] if fence else 0,
        }
        payload = json.dumps(body, sort_keys=True).encode("utf-8")
        try:
            doc = json.loads(
                self._request(_PUBLISH, data=payload,
                              no_retry=(400, 409)).decode("utf-8"))
        except _Rejected as exc:
            verdict = exc.doc()
            if exc.code == 409:
                telemetry.count("fleet/stale_publishes_blocked_remote")
                raise StaleLeaseError(
                    "remote publish fenced off by %s: %s (leader hint: "
                    "%s)" % (self._base, verdict.get("error"),
                             verdict.get("leader_hint")))
            raise CorruptArtifactError(
                "remote publish rejected by %s: %s"
                % (self._base, verdict.get("error")))
        version = int(doc.get("version", 0))
        with self._lock:
            self._publishes_sent += 1
            if version > self._last_version:
                self._last_version = version
        return version

    # ---------------------------------------------------------------- appends
    def append_ingest(self, X, y) -> None:
        import numpy as np
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X[None, :]
        y = np.asarray(y, np.float64).ravel()
        body = json.dumps({"rows": X.tolist(), "labels": y.tolist()},
                          sort_keys=True).encode("utf-8")
        self._request(_INGEST, data=body)
        with self._lock:
            self._ingest_rows_sent += int(len(y))

    def append_gate(self, result: str, wins: int, consumed_rows: int,
                    losses: Optional[Dict[str, float]] = None) -> None:
        body = json.dumps({
            "result": str(result), "wins": int(wins),
            "consumed_rows": int(consumed_rows), "losses": losses},
            sort_keys=True).encode("utf-8")
        self._request(_GATE, data=body)

    # ------------------------------------------------------------- compaction
    def compact(self, *, watermark: int, wins: int, keep_rows: int,
                keep_artifacts: int = 0,
                snapshot_rows: int = 0) -> Dict[str, Any]:
        body = json.dumps({
            "watermark": int(watermark), "wins": int(wins),
            "keep_rows": int(keep_rows),
            "keep_artifacts": int(keep_artifacts),
            "snapshot_rows": int(snapshot_rows)},
            sort_keys=True).encode("utf-8")
        doc = json.loads(self._request(_COMPACT, data=body)
                         .decode("utf-8"))
        return doc if isinstance(doc, dict) else {}

    # ----------------------------------------------------------------- replay
    def events(self, kind: Optional[str] = None
               ) -> Iterator[Dict[str, Any]]:
        """The store host's full event log (one GET). Cold-boot replay
        for a remote standby; with snapshot compaction on, the log is a
        compact record + publishes + tail, so this stays small."""
        try:
            doc = json.loads(self._request(_EVENTS).decode("utf-8"))
        except _NotFound:
            return
        for e in (doc.get("events") or []) if isinstance(doc, dict) else []:
            if isinstance(e, dict) and (kind is None
                                        or e.get("kind") == kind):
                yield e

    def log_bytes(self) -> int:
        try:
            doc = json.loads(self._request(_STATUS).decode("utf-8"))
        except (_NotFound, TransportError, ValueError):
            return 0
        return int(doc.get("log_bytes", 0)) if isinstance(doc, dict) else 0

    def load_snapshot(self, record: Dict[str, Any]) -> Dict[str, Any]:
        """Download + verify the snapshot behind one compact record —
        the remote standby's one-blob bootstrap read."""
        snap = record.get("snapshot") or {}
        data = self._request(_SNAPSHOT % int(snap.get("id", 0)))
        _verify_snapshot(record, data)
        return json.loads(data.decode("utf-8"))

    def snapshot_chunks(self, record: Dict[str, Any]
                        ) -> List[Tuple[int, int, Dict[str, Any]]]:
        """Same degrade-to-empty contract as the local store: a missing
        or corrupt snapshot costs buffered rows, never misaligns replay
        (the compact record's ``row_base`` already sits past it)."""
        snap = record.get("snapshot")
        if not isinstance(snap, dict):
            return []
        try:
            doc = self.load_snapshot(record)
        except (_NotFound, TransportError, ValueError,
                CorruptArtifactError) as exc:
            telemetry.count("fleet/snapshot_load_failures")
            Log.warning("fleet: remote snapshot s%06d unreadable (%s); "
                        "replay continues degraded",
                        int(snap.get("id", 0)), exc)
            return []
        out: List[Tuple[int, int, Dict[str, Any]]] = []
        for c in doc.get("chunks", []):
            ev = c.get("event") or {}
            lo = int(c.get("lo", 0))
            out.append((lo, lo + int(ev.get("n", 0)), ev))
        return out

    # ------------------------------------------------------------------ state
    def state(self) -> Dict[str, Any]:
        doc = super().state()
        with self._lock:
            doc["last_published_version"] = self._last_version
            doc["publishes_sent"] = self._publishes_sent
            doc["ingest_rows_sent"] = self._ingest_rows_sent
            doc["write_surface"] = True
        return doc


class EndpointSelector:
    """Sticky-with-cooldown choice over a list of fleet endpoints.

    The current endpoint stays current until it fails (stickiness keeps
    the replica's polls on one host's warm caches); a failure puts it
    in capped-exponential cooldown (``base * 2^(failures-1)``, capped)
    and the next candidate takes over. :meth:`candidates` always yields
    EVERY endpoint — cooled-down ones last, ordered by soonest expiry —
    so a total outage degrades to one failed sweep per poll, never to
    an endpoint silently dropped forever. Liveness evidence from the
    heartbeat sidecars (``/fleet/status`` head version + freshest
    heartbeat age) feeds :meth:`observe`, which prefers the most
    caught-up endpoint on the next reorder. Thread-safe; time source is
    monotonic (cooldowns are durations, not wall-clock stamps).
    """

    def __init__(self, urls: Sequence[str], *,
                 cooldown_base_s: float = 0.25,
                 cooldown_max_s: float = 8.0) -> None:
        urls = [str(u).rstrip("/") for u in urls]
        if not urls:
            raise LightGBMError("EndpointSelector needs >= 1 url")
        if len(set(urls)) != len(urls):
            raise LightGBMError("duplicate fleet urls: %r" % (urls,))
        self._lock = threading.Lock()
        self._urls = list(urls)
        self._current = urls[0]
        self._cool_base = float(cooldown_base_s)
        self._cool_max = float(cooldown_max_s)
        self._failures: Dict[str, int] = {u: 0 for u in urls}
        self._cool_until: Dict[str, float] = {u: 0.0 for u in urls}
        #: liveness evidence: url -> (head_version, -heartbeat_age_s)
        self._score: Dict[str, Tuple[int, float]] = {}
        self._switches = 0

    @property
    def urls(self) -> List[str]:
        return list(self._urls)

    def current(self) -> str:
        with self._lock:
            return self._current

    def candidates(self) -> List[str]:
        """Every endpoint, best-first: sticky current, then healthy ones
        by liveness score, then cooling ones by soonest expiry."""
        now = time.monotonic()
        with self._lock:
            healthy, cooling = [], []
            for u in self._urls:
                (cooling if self._cool_until[u] > now else healthy).append(u)
            healthy.sort(key=lambda u: (u != self._current,
                                        tuple(-s for s in
                                              self._score.get(u, (0, 0.0)))))
            cooling.sort(key=lambda u: self._cool_until[u])
            return healthy + cooling

    def observe(self, url: str, head_version: int,
                heartbeat_age_s: float) -> None:
        """Record liveness evidence for ``url`` (from a ``/fleet/status``
        probe): higher head version wins, fresher heartbeats break
        ties."""
        with self._lock:
            self._score[str(url).rstrip("/")] = (
                int(head_version), -float(heartbeat_age_s))

    def report_success(self, url: str) -> None:
        with self._lock:
            self._failures[url] = 0
            self._cool_until[url] = 0.0
            if url != self._current:
                self._switches += 1
                telemetry.count("fleet/endpoint_switches")
                Log.info("fleet: endpoint failover -> %s", url)
            self._current = url

    def report_failure(self, url: str) -> None:
        now = time.monotonic()
        with self._lock:
            n = self._failures.get(url, 0) + 1
            self._failures[url] = n
            cool = min(self._cool_max,
                       self._cool_base * (2.0 ** (n - 1)))
            self._cool_until[url] = now + cool
        telemetry.count("fleet/endpoint_failures")

    def state(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            return {
                "current": self._current,
                "switches": self._switches,
                "endpoints": {
                    u: {"failures": self._failures[u],
                        "cooling_s": round(max(
                            0.0, self._cool_until[u] - now), 3)}
                    for u in self._urls},
            }


class MultiEndpointStore:
    """Read-side store over SEVERAL fleet endpoints, duck-typing the
    replica-facing surface (``latest_publish``, ``latest_valid_publish``,
    ``load_model``, ``record_heartbeat``, ``state``) so
    :class:`~.replica.ReplicaWatcher` and ``bootstrap_model`` run
    UNCHANGED over a multi-homed region.

    Each call walks the selector's candidate order and returns the
    first endpoint's answer, reporting failures into the cooldown
    ranking as it goes; per-endpoint retries default to 1 so failover
    to the next endpoint happens within one poll, not after a full
    backoff ladder on the dead one. Correctness needs nothing more:
    publish version tokens are global, so the watcher's exactly-one-
    bump-per-publish invariant holds regardless of which endpoint
    served which poll. :meth:`probe` sweeps every endpoint's
    ``/fleet/status`` and feeds head-version + heartbeat-freshness
    evidence to the selector — the liveness ranking the heartbeat
    sidecars exist to enable.
    """

    def __init__(self, urls: Sequence[str], *,
                 timeout_s: float = 5.0,
                 retries: int = 1,
                 backoff_base_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 jitter_seed: int = 0,
                 cooldown_base_s: float = 0.25,
                 cooldown_max_s: float = 8.0) -> None:
        self.selector = EndpointSelector(urls,
                                         cooldown_base_s=cooldown_base_s,
                                         cooldown_max_s=cooldown_max_s)
        self._stores: Dict[str, RemoteStore] = {}
        for i, url in enumerate(self.selector.urls):
            self._stores[url] = RemoteStore(
                url, timeout_s=timeout_s, retries=retries,
                backoff_base_s=backoff_base_s,
                backoff_max_s=backoff_max_s,
                # decorrelate the endpoints' jitter streams while
                # keeping the whole schedule a function of one seed
                jitter_seed=int(jitter_seed) + i)

    @property
    def base_url(self) -> str:
        """The sticky current endpoint (healthz/debug display)."""
        return self.selector.current()

    def _call(self, name: str, *args: Any, **kwargs: Any) -> Any:
        errors: List[str] = []
        for url in self.selector.candidates():
            store = self._stores[url]
            try:
                out = getattr(store, name)(*args, **kwargs)
            except TransportError as exc:
                self.selector.report_failure(url)
                errors.append("%s: %s" % (url, exc))
                continue
            self.selector.report_success(url)
            return out
        telemetry.count("fleet/all_endpoints_failed")
        raise TransportError(
            "%s failed on all %d fleet endpoint(s): %s"
            % (name, len(self._stores), "; ".join(errors)))

    # ----------------------------------------------------- store duck-typing
    def latest_publish(self) -> Optional[Dict[str, Any]]:
        return self._call("latest_publish")

    def latest_valid_publish(self, min_version: int = 0
                             ) -> Optional[Tuple[Dict[str, Any], str]]:
        return self._call("latest_valid_publish", min_version)

    def load_model(self, version: int) -> str:
        return self._call("load_model", version)

    def record_heartbeat(self, doc: Dict[str, Any]) -> bool:
        return self._call("record_heartbeat", doc)

    # ------------------------------------------------------------------ probe
    def probe(self) -> Dict[str, Any]:
        """Sweep every endpoint's ``/fleet/status`` once, feed the
        selector's liveness ranking, and return the per-endpoint view
        (reachable, head version, freshest heartbeat age) — also the
        evidence ``fleetctl`` renders."""
        out: Dict[str, Any] = {}
        for url in self.selector.urls:
            store = self._stores[url]
            try:
                doc = json.loads(store._request(_STATUS).decode("utf-8"))
            except (TransportError, _NotFound, ValueError):
                out[url] = {"reachable": False}
                continue
            head = int(doc.get("head_version", 0) or 0)
            ages = [float(n.get("age_s", 0.0))
                    for n in doc.get("nodes") or []
                    if isinstance(n, dict)]
            age = min(ages) if ages else float("inf")
            self.selector.observe(url, head, age)
            out[url] = {"reachable": True, "head_version": head,
                        "freshest_heartbeat_age_s":
                            (round(age, 3) if ages else None)}
        return out

    # ------------------------------------------------------------------ state
    def state(self) -> Dict[str, Any]:
        doc = {"selector": self.selector.state(),
               "endpoints": {u: s.state()
                             for u, s in self._stores.items()}}
        doc["base_url"] = self.selector.current()
        return doc


class IngestForwarder:
    """Relay labeled traffic to the node that can actually train on it.

    A replica (or a standby trainer on another box) has no online
    trainer to buffer ingest rows; before the control plane it answered
    409 and the rows were lost unless the client knew the trainer's
    address. The forwarder closes that gap: it resolves the current
    leader's serving URL — from the local store's lease record when the
    node hosts one (the lease advertises the holder's URL), otherwise
    by probing the configured fleet endpoints' ``/fleet/status`` — and
    re-POSTs the rows to the leader's ``/ingest/<model>``, stamping
    ``X-Fleet-Hops`` so a stale hint chain is bounded: a relay that
    arrives with ``hops >= max_hops`` is refused rather than forwarded
    again. A 409 answer carrying a ``leader_hint`` re-aims the relay
    once within the same hop budget. Resolution is cached briefly
    (``cache_ttl_s``) so a hot ingest path does not probe per chunk.
    """

    def __init__(self, *, store: Any = None,
                 urls: Sequence[str] = (),
                 timeout_s: float = 5.0,
                 max_hops: int = 3,
                 cache_ttl_s: float = 2.0) -> None:
        if store is None and not urls:
            raise LightGBMError(
                "IngestForwarder needs a local store or >= 1 fleet url")
        self._store = store
        self._urls = [str(u).rstrip("/") for u in urls]
        self._timeout = float(timeout_s)
        self._max_hops = max(1, int(max_hops))
        self._cache_ttl = float(cache_ttl_s)
        self._lock = threading.Lock()
        self._cached_leader: Optional[str] = None
        self._cached_at = 0.0
        self._forwarded_rows = 0
        self._forwarded = 0
        self._failed = 0

    @property
    def max_hops(self) -> int:
        return self._max_hops

    # ----------------------------------------------------------- leader lookup
    def _status_leader(self, url: str) -> Optional[str]:
        req = urllib.request.Request(url + _STATUS)
        try:
            with urllib.request.urlopen(req,
                                        timeout=self._timeout) as resp:
                doc = json.loads(resp.read().decode("utf-8"))
        except (OSError, ValueError):
            return None
        lease = doc.get("lease") if isinstance(doc, dict) else None
        if isinstance(lease, dict) and lease.get("held") \
                and lease.get("url"):
            return str(lease["url"]).rstrip("/")
        return None

    def leader_url(self) -> Optional[str]:
        """The current lease holder's advertised serving URL, or None
        when no live leader advertises one."""
        now = time.monotonic()
        with self._lock:
            if (self._cached_leader is not None
                    and now - self._cached_at < self._cache_ttl):
                return self._cached_leader
        leader: Optional[str] = None
        if self._store is not None:
            try:
                lease = self._store.lease_state()
            except Exception:
                lease = {}
            if lease.get("held") and lease.get("url"):
                leader = str(lease["url"]).rstrip("/")
        if leader is None:
            for url in self._urls:
                leader = self._status_leader(url)
                if leader is not None:
                    break
        with self._lock:
            if leader is not None:
                self._cached_leader = leader
                self._cached_at = now
        return leader

    def invalidate(self) -> None:
        with self._lock:
            self._cached_leader = None

    # -------------------------------------------------------------- forwarding
    def forward(self, model_id: str, rows: Any, labels: Any,
                hops: int = 0) -> Dict[str, Any]:
        """Relay one labeled chunk to the leader's ``/ingest/<model>``.

        ``hops`` is the count already stamped on the INCOMING request;
        the outgoing relay carries ``hops + 1``. Raises
        :class:`TransportError` when the budget is exhausted, no leader
        is known, or the leader refuses — the HTTP handler maps it to
        503 (try again once a leader emerges)."""
        hops = int(hops)
        if hops >= self._max_hops:
            telemetry.count("fleet/forward_hop_limit")
            raise TransportError(
                "ingest relay exceeded %d hop(s) without reaching the "
                "lease holder (stale leader hints?)" % self._max_hops)
        leader = self.leader_url()
        if leader is None:
            with self._lock:
                self._failed += 1
            telemetry.count("fleet/forward_no_leader")
            raise TransportError(
                "no lease holder advertises a serving url; ingest "
                "cannot be forwarded")
        body = json.dumps({"rows": rows, "labels": labels},
                          sort_keys=True).encode("utf-8")
        n = len(labels) if hasattr(labels, "__len__") else 1
        attempted: List[str] = []
        while hops < self._max_hops:
            attempted.append(leader)
            req = urllib.request.Request(
                "%s/ingest/%s" % (leader, model_id), data=body,
                headers={"Content-Type": "application/json",
                         HOPS_HEADER: str(hops + 1)})
            try:
                with urllib.request.urlopen(
                        req, timeout=self._timeout) as resp:
                    doc = json.loads(resp.read().decode("utf-8"))
            except urllib.error.HTTPError as exc:
                try:
                    err = json.loads(exc.read().decode("utf-8"))
                except (ValueError, OSError):
                    err = {}
                hint = err.get("leader_hint") if isinstance(err, dict) \
                    else None
                if exc.code == 409 and hint \
                        and str(hint).rstrip("/") not in attempted:
                    # the node we relayed to is not the leader but knows
                    # (or thinks it knows) who is: re-aim within budget
                    self.invalidate()
                    leader = str(hint).rstrip("/")
                    hops += 1
                    continue
                with self._lock:
                    self._failed += 1
                telemetry.count("fleet/forward_errors")
                raise TransportError(
                    "ingest relay to %s refused: HTTP %d %s"
                    % (leader, exc.code, err.get("error")))
            except (OSError, ValueError) as exc:
                self.invalidate()
                with self._lock:
                    self._failed += 1
                telemetry.count("fleet/forward_errors")
                raise TransportError("ingest relay to %s failed: %s: %s"
                                     % (leader, type(exc).__name__, exc))
            with self._lock:
                self._forwarded += 1
                self._forwarded_rows += int(n)
            telemetry.count("fleet/forwarded_chunks")
            telemetry.count("fleet/forwarded_rows", int(n))
            doc = dict(doc) if isinstance(doc, dict) else {}
            doc["forwarded_to"] = leader
            return doc
        telemetry.count("fleet/forward_hop_limit")
        raise TransportError(
            "ingest relay exceeded %d hop(s) without reaching the "
            "lease holder (stale leader hints?)" % self._max_hops)

    def state(self) -> Dict[str, Any]:
        with self._lock:
            return {"forwarded_chunks": self._forwarded,
                    "forwarded_rows": self._forwarded_rows,
                    "failed": self._failed,
                    "cached_leader": self._cached_leader,
                    "max_hops": self._max_hops}
