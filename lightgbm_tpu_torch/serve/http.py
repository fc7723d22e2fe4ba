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
                               state
    GET  /models               registered model ids

The server fronts a :class:`~lightgbm_tpu_torch.online.registry.ModelRegistry`;
the single-model constructor registers its booster under ``"default"``
(``online=``: an OnlineTrainer or its keyword arguments).
An over-limit submit under the shed policy answers **429**; during
:meth:`PredictServer.begin_shutdown` new requests get **503** while queued
work drains. ``ThreadingHTTPServer`` gives one handler thread per
connection, so concurrent POSTs land in the MicroBatcher together and
coalesce into one device dispatch. The JAX package's ``/fleet/*`` routes
and ingest forwarding (queue A item 8), ``/metrics`` and ``/telemetry``
(item 10) come with later slices.
"""
from __future__ import annotations

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
                body = json.dumps(obj).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, server.healthz())
                elif self.path == "/models":
                    self._json(200, {"models": server.registry.ids()})
                else:
                    self._json(404, {"error": "unknown path %s" % self.path})

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    payload = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, OSError) as exc:
                    self._json(400, {"error": "bad request body: %s" % exc})
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

            def _ingest(self, entry, payload) -> None:
                if entry.online is None:
                    self._json(409, {"error": "online training is not "
                                     "enabled for model %r"
                                     % entry.model_id})
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
        depth, per-tenant queues, uptime, the online trainer's state per
        model (with its last promotion and rollback times hoisted into
        ``promotions``), the serving device."""
        models = self.registry.info()
        doc = {
            "status": "draining" if self.draining() else "ok",
            "uptime_s": round(obs.monotonic() - self._started_at, 3),
            "model_count": len(self.registry),
            "models": models,
            "queue_rows": sum(m["queue_rows"] for m in models.values()),
            "requests": telemetry.counter("serve/requests"),
        }
        promotions = {
            mid: {"last_promotion_ts": m["online"]["last_promotion_ts"],
                  "last_rollback_ts": m["online"]["last_rollback_ts"]}
            for mid, m in models.items() if m.get("online")}
        if promotions:
            doc["promotions"] = promotions
        try:
            default = self.registry.get()
            doc["model_version"] = default.booster.inner.model_version
            doc["buckets"] = list(default.session.buckets)
            doc["device"] = str(default.session.device)
        except KeyError:
            pass
        return doc

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
            self.registry.close()
