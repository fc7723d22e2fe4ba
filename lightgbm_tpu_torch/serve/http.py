"""Stdlib-HTTP JSON prediction endpoint (PyTorch port of the serving
routes of ``lightgbm_tpu/serve/http.py``).

    POST /predict              {"rows": [[f0, f1, ...], ...]}
                               -> {"predictions": [...], "rows": n,
                                   "model_version": v}
    POST /predict/<model_id>   same, routed to one registry entry
                               (also: {"model": "<id>"} in the body)
    POST /ingest[/<model_id>]  {"rows": [[...]], "labels": [...]} ->
                               {"buffered_rows": b, "rows": n}: labeled
                               traffic for the model's OnlineTrainer
                               (409 when online training is off for it)
    GET  /healthz              liveness + per-model version/queue/online
                               state (+ the fleet watcher, store,
                               transport and forwarder sections)
    GET  /models               registered model ids
    GET  /fleet/latest         newest fleet publish event (trainer mode)
    GET  /fleet/publishes      all valid publish events oldest-first
    GET  /fleet/artifact/<v>   raw whole-model artifact bytes
    GET  /fleet/status         rollup: head version, lease, every node's
                               latest heartbeat with its version skew
    GET  /fleet/events         the whole event log (remote replay)
    GET  /fleet/snapshot/<id>  raw snapshot blob (remote cold bootstrap)
    POST /fleet/heartbeat      remote nodes report their heartbeat docs
    POST /fleet/lease          remote lease acquire/renew/release/state
    POST /fleet/publish        sha256-checked model upload, fenced by
                               (holder, lease_epoch); a zombie epoch: 409
    POST /fleet/ingest         append one labeled chunk to the store log
    POST /fleet/gate           append one promotion-gate record
    POST /fleet/compact        run log compaction (snapshot mode too)

The server fronts a :class:`~lightgbm_tpu_torch.online.registry.ModelRegistry`;
the single-model constructor registers its booster under ``"default"``
(``online=``: an OnlineTrainer or its keyword arguments).
An over-limit submit under the shed policy answers **429**; during
:meth:`PredictServer.begin_shutdown` new requests get **503** while queued
work drains. ``ThreadingHTTPServer`` gives one handler thread per
connection, so concurrent POSTs land in the MicroBatcher together and
coalesce into one device dispatch.

The /fleet routes exist when a local ``FleetStore`` is attached
(``server.fleet_store``). The GETs are the transport remote replicas
(:class:`~lightgbm_tpu_torch.fleet.transport.RemoteStore`) converge
through; the POSTs are the control plane's write surface
(:class:`~lightgbm_tpu_torch.fleet.control.RemoteWriteStore`): fencing is
enforced here under the store's lock, so a remote zombie's stale epoch
is refused 409 (with a ``leader_hint``) exactly like a local one. Both
carry the ``transport/serve`` chaos point, and the write routes answer
during a drain (a draining store host keeps serving lease renewals). On
a node without a trainer, ``POST /ingest`` is relayed to the lease
holder through an attached ``server.ingest_forwarder``. ``/metrics``,
``/telemetry`` and trace-id propagation come with the observability
slice (ROADMAP item 10).
"""
from __future__ import annotations

import hashlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np

from .. import obs
from ..obs import telemetry
from ..utils.log import LightGBMError, Log
from .batcher import QueueFullError


class PredictServer:
    """ModelRegistry (PredictSessions + MicroBatchers) behind a stdlib
    HTTP server. ``port=0`` binds an ephemeral port; read it back from
    ``server.address``. ``serve_forever()`` blocks; ``close()`` stops the
    server and the batcher workers."""

    def __init__(self, model=None, *, registry=None,
                 host: str = "127.0.0.1", port: int = 8080,
                 max_batch_rows: int = 8192, max_wait_ms: float = 2.0,
                 buckets: Optional[Sequence[int]] = None,
                 raw_score: bool = False, warmup: bool = True,
                 request_timeout_s: float = 30.0,
                 max_queue_rows: int = 0, overload: str = "shed",
                 tenant_quota_rows: int = 0, tenant_weights=None,
                 dispatch_mode: str = "continuous", forest=None,
                 online=None) -> None:
        from ..online.registry import ModelRegistry

        if registry is None:
            if model is None:
                raise LightGBMError(
                    "PredictServer needs a model or a registry")
            registry = ModelRegistry()
            registry.register("default", model, buckets=buckets,
                              max_batch_rows=max_batch_rows,
                              max_wait_ms=max_wait_ms,
                              max_queue_rows=max_queue_rows,
                              overload=overload,
                              tenant_quota_rows=tenant_quota_rows,
                              tenant_weights=tenant_weights,
                              raw_score=raw_score,
                              dispatch_mode=dispatch_mode, forest=forest,
                              warmup=warmup, online=online)
        elif model is not None or online is not None:
            raise LightGBMError(
                "pass either model/online or a pre-built registry, "
                "not both")
        self.registry = registry
        self.request_timeout_s = float(request_timeout_s)
        # fleet replica mode: the ReplicaWatcher attached here shows on
        # /healthz (applied version, swaps) and close() stops it
        self.fleet_watcher = None
        # fleet trainer mode: a local FleetStore attached here turns on
        # the /fleet/* routes and the /healthz store section
        self.fleet_store = None
        # remote-replica mode: the RemoteStore, for /healthz retry stats
        self.fleet_transport = None
        # control plane: an IngestForwarder attached here relays labeled
        # traffic that reaches this node to the current lease holder
        self.ingest_forwarder = None
        self._started_at = obs.monotonic()
        # guards the draining flag (flipped by begin_shutdown, read on
        # every handler thread)
        self._lock = threading.Lock()
        self._draining = False
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                Log.debug("serve: " + fmt % args)

            def _json(self, code: int, obj) -> None:
                self._raw(code, json.dumps(obj).encode("utf-8"),
                          "application/json")

            def _raw(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, server.healthz())
                elif self.path == "/models":
                    self._json(200, {"models": server.registry.ids()})
                elif self.path.startswith("/fleet/"):
                    self._fleet()
                else:
                    self._json(404, {"error": "unknown path %s" % self.path})

            def _fleet(self) -> None:
                """The replica-facing transport routes over the attached
                local store's publish feed and artifacts. A torn chaos
                action truncates the body under an intact
                Content-Length (the client's checksum, not a short read,
                must catch it); a raise action answers 500."""
                store = server.fleet_store
                if store is None:
                    self._json(404, {"error": "no fleet store attached"})
                    return
                from ..fleet import chaos
                try:
                    act = chaos.hit("transport/serve")
                except Exception as exc:
                    self._json(500, {"error": "%s: %s"
                                     % (type(exc).__name__, exc)})
                    return
                torn = float(act[1]) if act is not None \
                    and act[0] == "torn" else None

                def send(body: bytes, ctype: str) -> None:
                    if torn is not None:
                        body = body[:int(len(body) * torn)]
                    self._raw(200, body, ctype)

                def read_file(path: str, what: str) -> Optional[bytes]:
                    try:
                        with open(path, "rb") as f:
                            return f.read()
                    except OSError:
                        self._json(404, {"error": "no %s" % what})
                        return None

                seg = [s for s in self.path.split("/") if s]
                if seg == ["fleet", "status"]:
                    send(json.dumps(server.fleet_status())
                         .encode("utf-8"), "application/json")
                elif seg == ["fleet", "events"]:
                    # a remote standby's cold-boot replay: the whole
                    # event log in one response
                    send(json.dumps({"events": list(store.events())})
                         .encode("utf-8"), "application/json")
                elif seg == ["fleet", "latest"]:
                    latest = store.latest_publish()
                    if latest is None:
                        self._json(404, {"error": "nothing published yet"})
                        return
                    send(json.dumps(latest).encode("utf-8"),
                         "application/json")
                elif seg == ["fleet", "publishes"]:
                    send(json.dumps({"publishes": store.publishes()})
                         .encode("utf-8"), "application/json")
                elif seg[:2] in (["fleet", "snapshot"],
                                 ["fleet", "artifact"]) and len(seg) == 3:
                    try:
                        num = int(seg[2])
                    except ValueError:
                        self._json(404, {"error": "bad %s id %r"
                                         % (seg[1], seg[2])})
                        return
                    if seg[1] == "snapshot":
                        data = read_file(store.snapshot_path(num),
                                         "snapshot s%06d" % num)
                        ctype = "application/json"
                    else:
                        data = read_file(store.artifact_path(num),
                                         "artifact v%d" % num)
                        ctype = "text/plain; charset=utf-8"
                    if data is not None:
                        send(data, ctype)
                else:
                    self._json(404, {"error": "unknown path %s" % self.path})

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    payload = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, OSError) as exc:
                    self._json(400, {"error": "bad request body: %s" % exc})
                    return
                if self.path == "/fleet/heartbeat":
                    # heartbeats keep arriving while the serving side
                    # drains, so this precedes the 503 gate
                    self._fleet_heartbeat(payload)
                    return
                if self.path.startswith("/fleet/"):
                    # the write surface precedes the drain gate too: a
                    # draining store host keeps answering lease renewals
                    # and fence checks, or a healthy remote trainer
                    # demotes for no reason
                    self._fleet_post(payload)
                    return
                if server.draining():
                    telemetry.count("serve/drain_rejected")
                    self._json(503, {"error": "server is draining"})
                    return
                seg = [s for s in self.path.split("/") if s]
                route = seg[0] if seg else ""
                if route not in ("predict", "ingest") or len(seg) > 2 \
                        or not isinstance(payload, dict):
                    self._json(404, {"error": "unknown path %s" % self.path})
                    return
                model_id = seg[1] if len(seg) == 2 else payload.get("model")
                try:
                    entry = server.registry.get(model_id)
                except KeyError as exc:
                    self._json(404, {"error": str(exc)})
                    return
                if route == "predict":
                    self._predict(entry, payload)
                else:
                    self._ingest(entry, payload)

            def _fleet_post(self, payload) -> None:
                """``POST /fleet/{lease,publish,ingest,gate,compact}``:
                the store host's half of the remote write surface, over
                the attached local store. Fencing is enforced here,
                under the store's own lock, so a remote zombie's stale
                epoch is refused exactly like a local one (409, with a
                ``leader_hint`` naming the holder now). Chaos
                ``transport/serve`` actions apply as on the GET side."""
                store = server.fleet_store
                if store is None:
                    self._json(404, {"error": "no fleet store attached"})
                    return
                if not isinstance(payload, dict):
                    self._json(400, {"error": "body must be a JSON "
                                     "object"})
                    return
                from ..fleet import chaos
                from ..fleet.store import StaleLeaseError
                try:
                    act = chaos.hit("transport/serve")
                except Exception as exc:
                    self._json(500, {"error": "%s: %s"
                                     % (type(exc).__name__, exc)})
                    return
                torn = float(act[1]) if act is not None \
                    and act[0] == "torn" else None

                def send(code: int, obj) -> None:
                    body = json.dumps(obj).encode("utf-8")
                    if torn is not None:
                        body = body[:int(len(body) * torn)]
                    self._raw(code, body, "application/json")

                seg = [s for s in self.path.split("/") if s]
                route = seg[1] if len(seg) == 2 else ""
                try:
                    if route == "lease":
                        self._fleet_lease(store, payload, send)
                    elif route == "publish":
                        self._fleet_publish(store, payload, send)
                    elif route == "ingest":
                        store.append_ingest(payload["rows"],
                                            payload["labels"])
                        rows = payload.get("labels") or []
                        send(200, {"ok": True, "rows": len(rows)})
                    elif route == "gate":
                        store.append_gate(
                            payload["result"], int(payload["wins"]),
                            int(payload["consumed_rows"]),
                            payload.get("losses"))
                        send(200, {"ok": True})
                    elif route == "compact":
                        send(200, store.compact(
                            watermark=int(payload["watermark"]),
                            wins=int(payload["wins"]),
                            keep_rows=int(payload["keep_rows"]),
                            keep_artifacts=int(
                                payload.get("keep_artifacts", 0)),
                            snapshot_rows=int(
                                payload.get("snapshot_rows", 0))))
                    else:
                        self._json(404, {"error": "unknown path %s"
                                         % self.path})
                except StaleLeaseError as exc:
                    doc = {"error": str(exc)}
                    hint = server._leader_hint()
                    if hint:
                        doc["leader_hint"] = hint
                    send(409, doc)
                except (KeyError, TypeError, ValueError,
                        LightGBMError) as exc:
                    send(400, {"error": "%s: %s"
                               % (type(exc).__name__, exc)})

            def _fleet_lease(self, store, payload, send) -> None:
                op = payload.get("op")
                holder = payload.get("holder")
                url = payload.get("url") or None
                if op == "acquire":
                    epoch = store.acquire_lease(
                        str(holder), float(payload["ttl_s"]), url=url)
                    send(200, {"epoch": epoch,
                               "lease": store.lease_state()})
                elif op == "renew":
                    ok = store.renew_lease(
                        str(holder), int(payload["epoch"]),
                        float(payload["ttl_s"]), url=url)
                    send(200, {"ok": ok})
                elif op == "release":
                    ok = store.release_lease(str(holder),
                                             int(payload["epoch"]))
                    send(200, {"ok": ok})
                elif op == "state":
                    send(200, {"lease": store.lease_state()})
                else:
                    send(400, {"error": "unknown lease op %r" % op})

            def _fleet_publish(self, store, payload, send) -> None:
                model = payload.get("model")
                if not isinstance(model, str) or not model:
                    send(400, {"error": "publish needs a non-empty "
                               "model string"})
                    return
                data = model.encode("utf-8")
                want_sha = payload.get("sha256")
                want_bytes = int(payload.get("bytes", -1))
                got_sha = hashlib.sha256(data).hexdigest()
                if (want_bytes >= 0 and want_bytes != len(data)) \
                        or (want_sha and want_sha != got_sha):
                    # the upload is checked before the fence: a torn
                    # body never becomes an artifact, fenced or not
                    telemetry.count("fleet/upload_checksum_failures")
                    send(400, {"error": "model upload failed its "
                               "checksum (%d bytes, sha %s...)"
                               % (len(data), got_sha[:12])})
                    return
                fence = (str(payload.get("holder")),
                         int(payload.get("lease_epoch", 0)))
                version = store.publish(
                    model, str(payload.get("event", "promotion")),
                    payload.get("meta"), fence=fence)
                send(200, {"version": version})

            def _fleet_heartbeat(self, payload) -> None:
                store = server.fleet_store
                if store is None:
                    self._json(404, {"error": "no fleet store attached"})
                    return
                try:
                    ok = store.record_heartbeat(
                        payload if isinstance(payload, dict) else {})
                except Exception as exc:
                    self._json(500, {"error": "%s: %s"
                                     % (type(exc).__name__, exc)})
                    return
                if not ok:
                    self._json(400, {"error": "heartbeat needs a node id"})
                    return
                self._json(200, {"ok": True})

            def _ingest(self, entry, payload) -> None:
                if entry.online is None:
                    fwd = server.ingest_forwarder
                    if fwd is not None:
                        # this node cannot train on the rows, but the
                        # control plane knows who can: relay them to the
                        # lease holder instead of dropping the chunk
                        hops = int(self.headers.get("X-Fleet-Hops") or 0)
                        try:
                            doc = fwd.forward(entry.model_id,
                                              payload.get("rows"),
                                              payload.get("labels"),
                                              hops=hops)
                        except Exception as exc:
                            self._json(503, {"error": "ingest forward "
                                             "failed: %s" % exc})
                            return
                        self._json(200, doc)
                        return
                    doc = {"error": "online training is not enabled "
                           "for model %r" % entry.model_id}
                    hint = server._leader_hint()
                    if hint:
                        # no forwarder here, but the client learns who
                        # the leader is
                        doc["leader_hint"] = hint
                    self._json(409, doc)
                    return
                try:
                    rows = np.asarray(payload["rows"], np.float64)
                    labels = np.asarray(payload["labels"], np.float64)
                    buffered = entry.online.ingest(rows, labels)
                    self._json(200, {"buffered_rows": int(buffered),
                                     "rows": int(len(labels.ravel()))})
                except Exception as exc:
                    self._json(400, {"error": "%s: %s"
                                     % (type(exc).__name__, exc)})

            def _predict(self, entry, payload) -> None:
                try:
                    X = np.asarray(payload["rows"], np.float64)
                    if X.ndim == 1:
                        X = X[None, :]
                    # tenant for fair queuing: header wins, body is the
                    # curl-friendly fallback, absent means "default"
                    tenant = self.headers.get("X-Tenant") \
                        or payload.get("tenant")
                    fut = entry.batcher.submit(X, tenant=tenant)
                    out = fut.result(timeout=server.request_timeout_s)
                    self._json(200, {"predictions": out.tolist(),
                                     "rows": int(X.shape[0]),
                                     "model_version":
                                         entry.booster.inner.model_version})
                except QueueFullError as exc:
                    self._json(429, {"error": "overloaded: %s" % exc})
                except Exception as exc:  # the handler thread must answer
                    Log.debug("serve: predict failed: %r" % (exc,))
                    self._json(400, {"error": "%s: %s"
                                     % (type(exc).__name__, exc)})

        self.httpd = ThreadingHTTPServer((host, int(port)), Handler)

    @property
    def session(self):
        """Default entry's PredictSession (single-model callers)."""
        return self.registry.get().session

    @property
    def batcher(self):
        """Default entry's MicroBatcher (single-model callers)."""
        return self.registry.get().batcher

    @property
    def online(self):
        """Default entry's OnlineTrainer (None when online is off)."""
        return self.registry.get().online

    @property
    def address(self):
        """(host, port) actually bound — resolves port=0."""
        return self.httpd.server_address[:2]

    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def healthz(self) -> dict:
        """The /healthz document: model versions, registry size, queue
        depth, per-tenant queues (per model and merged), uptime, the
        online trainer's state per model (with its last promotion and
        rollback times hoisted into ``promotions``), the serving device,
        the session dispatches and the kernels launched so far
        (``dispatches``, ``kernel_launches``), and in fleet
        modes the watcher's applied version, the store's
        lease and log, the transport's retries and the forwarder."""
        models = self.registry.info()
        # per-tenant depth and sheds merged across models
        tenants: dict = {}
        for m in models.values():
            for t, st in (m.get("tenants") or {}).items():
                agg = tenants.setdefault(
                    t, {"queue_rows": 0, "shed": 0, "shed_rows": 0})
                agg["queue_rows"] += st.get("queue_rows", 0)
                agg["shed"] += st.get("shed", 0)
                agg["shed_rows"] += st.get("shed_rows", 0)
        doc = {
            "status": "draining" if self.draining() else "ok",
            "uptime_s": round(obs.monotonic() - self._started_at, 3),
            "model_count": len(self.registry),
            "models": models,
            "queue_rows": sum(m["queue_rows"] for m in models.values()),
            "tenants": tenants,
            "requests": telemetry.counter("serve/requests"),
            # session dispatches: each launches a serving kernel per
            # top-rung chunk
            "dispatches": telemetry.counter("serve/dispatches"),
        }
        promotions = {
            mid: {"last_promotion_ts": m["online"]["last_promotion_ts"],
                  "last_rollback_ts": m["online"]["last_rollback_ts"]}
            for mid, m in models.items() if m.get("online")}
        if promotions:
            doc["promotions"] = promotions
        if self.fleet_watcher is not None:
            doc["fleet"] = self.fleet_watcher.state()
        if self.fleet_store is not None:
            # lease holder, epoch and expiry, log size, last compaction
            doc["fleet_store"] = self.fleet_store.state()
        if self.fleet_transport is not None:
            # remote replica: request, retry and checksum-failure counts
            doc["fleet_transport"] = self.fleet_transport.state()
        if self.ingest_forwarder is not None:
            # control plane: relayed chunks and the cached leader
            doc["ingest_forwarder"] = self.ingest_forwarder.state()
        # the hand-written kernels this process launched (ops/kernels)
        from ..ops import kernels
        doc["kernel_launches"] = {k: v for k, v in
                                  kernels.launch_counts().items() if v}
        try:
            default = self.registry.get()
            doc["model_version"] = default.booster.inner.model_version
            doc["buckets"] = list(default.session.buckets)
            doc["device"] = str(default.session.device)
        except KeyError:
            pass
        return doc

    def _leader_hint(self) -> Optional[str]:
        """The current lease holder's advertised serving URL (from the
        attached local store's lease record), or None: stamped into 409
        bodies so a refused writer learns where to go."""
        store = self.fleet_store
        if store is None:
            return None
        try:
            lease = store.lease_state()
        except Exception:
            return None
        if lease.get("held") and lease.get("url"):
            return str(lease["url"])
        return None

    def fleet_status(self) -> dict:
        """The ``GET /fleet/status`` rollup from the trainer's vantage:
        the store's head version, lease and log size, and every node's
        latest heartbeat (local replicas and standbys write them to the
        store; remote replicas POST them to ``/fleet/heartbeat``), each
        with its version skew and heartbeat age."""
        store = self.fleet_store
        if store is None:
            return {"nodes": []}
        st = store.state()
        head = int(st["last_published_version"])
        now = time.time()
        nodes = []
        for hb in store.heartbeats():
            node = dict(hb)
            node["skew"] = max(0, head - int(node.get("version", 0) or 0))
            node["age_s"] = round(max(0.0, now - float(node.get("ts", now))),
                                  3)
            nodes.append(node)
        return {
            "model_id": st["model_id"],
            "head_version": head,
            "lease": st["lease"],
            "log_bytes": st["events_log_bytes"],
            "compactions": st["compactions"],
            "nodes": nodes,
        }

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        """Unblock serve_forever() (callable from any thread)."""
        self.httpd.shutdown()

    def begin_shutdown(self, drain_timeout_s: float = 30.0) -> None:
        """Graceful drain: answer new requests 503, wait until the
        batcher queues are empty, then stop the accept loop. Not from
        the thread inside serve_forever."""
        with self._lock:
            already = self._draining
            self._draining = True
        if already:
            return
        telemetry.count("serve/drain_begin")
        deadline = obs.monotonic() + drain_timeout_s
        while obs.monotonic() < deadline:
            if all(e.batcher.queue_rows() == 0
                   for e in self.registry.entries()):
                break
            time.sleep(0.01)
        self.httpd.shutdown()

    def close(self) -> None:
        try:
            self.httpd.server_close()
        finally:
            if self.fleet_watcher is not None:
                self.fleet_watcher.close()
            self.registry.close()
