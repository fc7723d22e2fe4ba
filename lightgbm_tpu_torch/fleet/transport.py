"""Network distribution for the fleet store: replicas off the trainer's
filesystem (PyTorch port of ``lightgbm_tpu/fleet/transport.py``).

The trainer-side :class:`~lightgbm_tpu_torch.serve.http.PredictServer` (when
given a ``fleet_store``) serves the store's publish feed and artifacts
over the existing stdlib HTTP stack:

    GET /fleet/latest             newest valid publish event (404: none)
    GET /fleet/publishes          {"publishes": [events oldest-first]}
    GET /fleet/artifact/<version> raw whole-model artifact bytes

:class:`RemoteStore` is the client half: it duck-types the three store
methods :class:`~lightgbm_tpu_torch.fleet.replica.ReplicaWatcher` and
``bootstrap_model`` use (``latest_publish``, ``latest_valid_publish``,
``load_model``), so a replica pointed at a URL runs the identical
watcher code as one on the shared filesystem. The version-token
protocol already tolerates an unreliable transport — replicas converge
by applying the newest token whenever they can next reach the feed —
so the client only needs timeouts, capped exponential backoff with
deterministic jitter (seeded, so chaos tests reproduce byte-identical
schedules), and sha256 verification of every downloaded artifact
against its publish event: a partition stalls convergence, never
corrupts it, and resume needs no extra state.
"""
from __future__ import annotations

import http.client
import json
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Optional, Tuple

from ..obs import telemetry
from ..utils.log import LightGBMError, Log
from . import chaos
from .store import CorruptArtifactError, _verify_artifact

_LATEST = "/fleet/latest"
_PUBLISHES = "/fleet/publishes"
_ARTIFACT = "/fleet/artifact/%d"
_HEARTBEAT = "/fleet/heartbeat"

#: the header that carries a request's trace id once the port records
#: spans (ROADMAP item 10); no request sends it before then
TRACE_HEADER = "X-Trace-Id"


class TransportError(LightGBMError):
    """A /fleet request failed every retry (store unreachable)."""


class _NotFound(Exception):
    """Internal: the remote answered 404 (a meaning, not a failure)."""


class _Rejected(Exception):
    """Internal: the remote answered a status listed in ``no_retry`` —
    a protocol verdict (fence 409, bad upload 400), not an outage.
    Carries the code and decoded body so the caller can read the
    verdict's payload (e.g. a ``leader_hint``)."""

    def __init__(self, code: int, body: bytes) -> None:
        super().__init__("HTTP %d" % code)
        self.code = int(code)
        self.body = body

    def doc(self) -> Dict[str, Any]:
        try:
            doc = json.loads(self.body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return {}
        return doc if isinstance(doc, dict) else {}


class RemoteStore:
    """Read-only fleet store over HTTP, duck-typing ``FleetStore``'s
    replica-facing surface.

    Every request gets ``retries`` attempts with capped exponential
    backoff; the jitter factor is drawn from a ``jitter_seed``ed RNG so
    two runs with the same seed back off identically (no wall-clock
    flake in the chaos tests). Artifact bytes are verified against the
    publish event's sha256 + length — a torn or tampered download is
    counted (``fleet/transport_checksum_failures``) and the previous
    good publish is used instead, exactly like a corrupt local artifact.
    """

    def __init__(self, base_url: str, *,
                 timeout_s: float = 5.0,
                 retries: int = 4,
                 backoff_base_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 jitter_seed: int = 0) -> None:
        base_url = str(base_url).rstrip("/")
        if not base_url.startswith(("http://", "https://")):
            raise LightGBMError("fleet url must be http(s)://..., got %r"
                                % base_url)
        if timeout_s <= 0:
            raise LightGBMError("fleet timeout_s must be > 0, got %g"
                                % timeout_s)
        self._base = base_url
        self._timeout = float(timeout_s)
        self._retries = max(0, int(retries))
        self._backoff_base = float(backoff_base_s)
        self._backoff_max = float(backoff_max_s)
        # guards the retry counters and the jitter RNG (poller thread +
        # boot-time bootstrap + /healthz state reads)
        self._lock = threading.Lock()
        self._rng = random.Random(int(jitter_seed))
        self._requests = 0
        self._retried = 0
        self._errors = 0
        self._checksum_failures = 0
        self._heartbeats_sent = 0
        self._last_error = ""
        self._corrupt_seen: set = set()

    @property
    def base_url(self) -> str:
        return self._base

    # --------------------------------------------------------------- requests
    def _sleep_s(self, attempt: int) -> float:
        """Deterministic-jitter capped exponential backoff for retry
        ``attempt`` (0-based): base·2^attempt capped, scaled by a seeded
        factor in [0.5, 1.0]."""
        with self._lock:
            factor = 0.5 + 0.5 * self._rng.random()
        return min(self._backoff_max,
                   self._backoff_base * (2.0 ** attempt)) * factor

    def _request(self, path: str, data: Optional[bytes] = None,
                 no_retry: Tuple[int, ...] = ()) -> bytes:
        """GET ``path`` (POST when ``data`` is given) with retries.
        Raises :class:`_NotFound` on 404 (no retry — absence is an
        answer), :class:`_Rejected` for statuses in ``no_retry`` (a
        protocol verdict — retrying a fence rejection would just hammer
        the new leader's 409), and :class:`TransportError` once every
        attempt failed. No request carries :data:`TRACE_HEADER` until
        the port records spans."""
        last: Optional[BaseException] = None
        headers = {}
        if data is not None:
            headers["Content-Type"] = "application/json"
        for attempt in range(self._retries + 1):
            if attempt > 0:
                with self._lock:
                    self._retried += 1
                telemetry.count("fleet/transport_retries")
                delay = self._sleep_s(attempt - 1)
                telemetry.gauge("fleet/transport_backoff_ms",
                                delay * 1000.0)
                time.sleep(delay)
            with self._lock:
                self._requests += 1
            telemetry.count("fleet/transport_requests")
            try:
                act = chaos.hit("transport/request")
                req = urllib.request.Request(self._base + path, data=data,
                                             headers=headers)
                with urllib.request.urlopen(req,
                                            timeout=self._timeout) as resp:
                    body = resp.read()
                if act is not None and act[0] == "torn":
                    body = body[:int(len(body) * float(act[1]))]
                return body
            except urllib.error.HTTPError as exc:
                if exc.code == 404:
                    raise _NotFound(path)
                if exc.code in no_retry:
                    raise _Rejected(exc.code, exc.read() or b"")
                last = exc  # 5xx/4xx: retry — the server may be mid-restart
            except (OSError, http.client.HTTPException,
                    chaos.InjectedFault) as exc:
                last = exc  # refused/reset/timeout/short read/injected drop
        with self._lock:
            self._errors += 1
            self._last_error = "%s: %s" % (type(last).__name__, last)
        telemetry.count("fleet/transport_errors")
        raise TransportError("%s %s%s failed after %d attempt(s): %s: %s"
                             % ("POST" if data is not None else "GET",
                                self._base, path, self._retries + 1,
                                type(last).__name__, last))

    # ------------------------------------------------------- store duck-typing
    def latest_publish(self) -> Optional[Dict[str, Any]]:
        try:
            doc = json.loads(self._request(_LATEST).decode("utf-8"))
        except _NotFound:
            return None
        return doc if isinstance(doc, dict) else None

    def load_model(self, version: int) -> str:
        """Raw artifact fetch, no checksum (prefer
        :meth:`latest_valid_publish`)."""
        try:
            return self._request(_ARTIFACT % int(version)).decode("utf-8")
        except _NotFound:
            raise CorruptArtifactError("remote artifact v%d not found"
                                       % int(version))

    def latest_valid_publish(self, min_version: int = 0
                             ) -> Optional[Tuple[Dict[str, Any], str]]:
        """Newest publish past ``min_version`` whose downloaded artifact
        verifies, walking back past torn/corrupt/missing downloads —
        the same fallback contract as the filesystem store."""
        try:
            doc = json.loads(self._request(_PUBLISHES).decode("utf-8"))
        except _NotFound:
            return None
        pubs = doc.get("publishes") if isinstance(doc, dict) else None
        for e in reversed(pubs or []):
            version = int(e.get("version", 0))
            if version <= int(min_version):
                break
            try:
                data = self._request(_ARTIFACT % version)
                _verify_artifact(e, data)
                return e, data.decode("utf-8")
            except (_NotFound, CorruptArtifactError,
                    UnicodeDecodeError) as exc:
                with self._lock:
                    seen = version in self._corrupt_seen
                    self._corrupt_seen.add(version)
                    self._checksum_failures += 1
                telemetry.count("fleet/transport_checksum_failures")
                if not seen:
                    telemetry.count("fleet/corrupt_artifacts")
                    Log.warning("fleet: remote artifact v%d rejected "
                                "(%s: %s); falling back", version,
                                type(exc).__name__, exc)
        return None

    def record_heartbeat(self, doc: Dict[str, Any]) -> bool:
        """POST a node heartbeat to the trainer's ``/fleet/heartbeat``.

        Duck-types :meth:`FleetStore.record_heartbeat` so remote
        replicas federate into the same ``/fleet/status`` rollup as
        shared-filesystem nodes. Returns False (without retrying the
        whole backoff ladder into an error) when the trainer predates
        the endpoint (404) — heartbeats are observability, not state."""
        body = json.dumps(doc, sort_keys=True).encode("utf-8")
        try:
            self._request(_HEARTBEAT, data=body)
        except _NotFound:
            return False
        with self._lock:
            self._heartbeats_sent += 1
        telemetry.count("fleet/heartbeats_sent")
        return True

    # ------------------------------------------------------------------ state
    def state(self) -> Dict[str, Any]:
        """JSON-serializable transport summary (surfaced on /healthz)."""
        with self._lock:
            return {
                "base_url": self._base,
                "requests": self._requests,
                "retries": self._retried,
                "errors": self._errors,
                "checksum_failures": self._checksum_failures,
                "heartbeats_sent": self._heartbeats_sent,
                "last_error": self._last_error,
                "timeout_s": self._timeout,
            }
