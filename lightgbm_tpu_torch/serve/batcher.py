"""Micro-batching request dispatcher with per-tenant fair queuing
(PyTorch port of ``lightgbm_tpu/serve/batcher.py``, unchanged in
behaviour; the device->host sync is ``PredictSession.collect``).

A background worker drains the pending queues, batching concurrent
``submit(X)`` calls into bucketed device dispatches — ensemble
inference throughput is won by amortizing launches over large batches,
so at batch size 1 the dominant cost is dispatch, not math. Two
dispatch disciplines:

- ``continuous`` (default): a standing dispatch loop. The worker seals
  a tile from whatever is queued RIGHT NOW and launches it
  asynchronously; a separate deliver thread performs the one
  device->host sync and resolves futures. While one tile's sync is in
  flight, newly-submitted requests accumulate and are admitted into the
  next tile — batching emerges from device-side backpressure (a bounded
  in-flight window) instead of from a wall-clock company wait, so an
  idle server answers a lone request immediately instead of parking it
  for ``max_wait_ms``.
- ``coalesce``: the classic single-thread discipline — the first
  request of a batch waits up to ``max_wait_ms`` for company, then the
  batch is dispatched and delivered inline before the next is formed.

Two knobs bound batch growth in both modes: ``max_batch_rows`` caps how
much a tile grows; ``max_wait_ms`` caps the company wait (coalesce
only — continuous never waits for company).

Results come back through ``concurrent.futures.Future``; a worker
exception fails every future of its batch (callers see the real error,
the worker keeps serving). ``close()`` finishes the in-flight batch,
fails whatever is still queued, then joins the thread.

Multi-tenant fairness (the fleet layer): every request belongs to a
tenant (default ``"default"``), each tenant has its own pending deque,
and the worker picks the next request by **start-time fair queuing**:
the active tenant with the smallest virtual time goes first, and
dequeuing ``r`` rows advances that tenant's clock by ``r / weight`` —
so over any backlog window tenants drain rows proportionally to their
weights and a flooding tenant cannot starve the rest. An idle tenant's
clock is pulled up to the global virtual clock when it becomes active
again (no credit hoarding).

Admission control, two layers:

- ``max_queue_rows`` bounds TOTAL queued-but-undispatched rows (the
  memory/latency bound).
- ``tenant_quota_rows`` bounds each single tenant's queued rows (the
  noisy-neighbor bound): one tenant hitting its quota sheds/blocks only
  itself while others keep being admitted.

Overflow behavior is the ``overload`` policy — ``shed`` raises
:class:`QueueFullError` at submit (the HTTP layer maps it to 429, so
overload degrades into fast rejections instead of unbounded latency),
``block`` parks the submitter until the worker drains space. Per-tenant
shed counts and queue depths are exported as ``serve/tenant/<t>/*``
counters//gauges and via :meth:`MicroBatcher.tenant_stats` (/healthz).
"""
from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np

from .. import obs
from ..obs import telemetry, tracer

OVERLOAD_POLICIES = ("shed", "block")

DISPATCH_MODES = ("continuous", "coalesce")

DEFAULT_TENANT = "default"

# continuous mode: how many dispatched-but-undelivered tiles may be in
# flight before the dispatch loop blocks. Depth 2 overlaps the next
# tile's launch with the current tile's host sync without letting an
# unbounded pipeline hide queue growth from admission control.
_INFLIGHT_DEPTH = 2


class QueueFullError(RuntimeError):
    """submit() rejected because the queue holds ``max_queue_rows`` (or
    the tenant holds ``tenant_quota_rows``) under the ``shed`` overload
    policy (HTTP maps this to 429)."""


class _Request:
    __slots__ = ("X", "rows", "future", "t0", "trace_id", "tenant")

    def __init__(self, X: np.ndarray, trace_id: Optional[int] = None,
                 tenant: str = DEFAULT_TENANT) -> None:
        self.X = X
        self.rows = X.shape[0]
        self.future: Future = Future()
        self.t0 = obs.monotonic()
        self.trace_id = trace_id
        self.tenant = tenant


class _TenantState:
    """Per-tenant accounting, all guarded by the batcher lock."""

    __slots__ = ("pending", "queued_rows", "vtime", "weight",
                 "shed", "shed_rows", "served_rows", "served_requests")

    def __init__(self, weight: float) -> None:
        self.pending: deque = deque()
        self.queued_rows = 0
        self.vtime = 0.0
        self.weight = weight
        self.shed = 0
        self.shed_rows = 0
        self.served_rows = 0
        self.served_requests = 0


class MicroBatcher:
    """Coalesce concurrent predict requests into one device dispatch.

    ``raw_score`` applies to every request of the batcher (requests in one
    coalesced dispatch must share the output transform).
    ``tenant_weights`` maps tenant id -> relative fair-share weight
    (unlisted tenants weigh 1.0); ``tenant_quota_rows`` caps any single
    tenant's queued rows (0 = no per-tenant cap). ``dispatch_mode``
    picks the discipline: ``continuous`` (standing dispatch loop +
    deliver thread, no company wait) or ``coalesce`` (single thread,
    first request waits up to ``max_wait_ms`` for company).
    """

    def __init__(self, session, *, max_batch_rows: int = 8192,
                 max_wait_ms: float = 2.0, raw_score: bool = False,
                 latency_window: int = 2048, max_queue_rows: int = 0,
                 overload: str = "shed", tenant_quota_rows: int = 0,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 dispatch_mode: str = "continuous") -> None:
        if max_batch_rows < 1:
            raise ValueError("max_batch_rows must be >= 1")
        if max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        if max_queue_rows < 0:
            raise ValueError("max_queue_rows must be >= 0 (0 = unbounded)")
        if tenant_quota_rows < 0:
            raise ValueError("tenant_quota_rows must be >= 0 (0 = no "
                             "per-tenant cap)")
        if overload not in OVERLOAD_POLICIES:
            raise ValueError("overload must be one of %s, got %r"
                             % ("|".join(OVERLOAD_POLICIES), overload))
        if dispatch_mode not in DISPATCH_MODES:
            raise ValueError("dispatch_mode must be one of %s, got %r"
                             % ("|".join(DISPATCH_MODES), dispatch_mode))
        weights = dict(tenant_weights or {})
        for t, w in weights.items():
            if not w > 0:
                raise ValueError("tenant weight must be > 0, got %s=%r"
                                 % (t, w))
        self._session = session
        self._max_rows = int(max_batch_rows)
        self._max_wait = float(max_wait_ms) / 1000.0
        self._raw = bool(raw_score)
        self._max_queue_rows = int(max_queue_rows)
        self._tenant_quota = int(tenant_quota_rows)
        self._overload_shed = overload == "shed"
        self._weights = weights
        # one lock, all jobs: (a) makes submit's closed-check atomic with
        # the enqueue so no request can slip in after close() and hang its
        # Future forever; (b) guards the tenant queues + fair-queuing
        # clocks; (c) guards the latency histogram, which the worker
        # feeds while callers read latency_stats(); (d) guards the
        # queued-row accounting behind admission control. It is a
        # Condition so block-policy submitters can park on it until the
        # worker drains space, and so the worker can park on it while the
        # queues are empty.
        self._lock = threading.Condition()
        self._tenants: Dict[str, _TenantState] = {}
        self._queued_rows = 0      # total rows queued, all tenants
        self._queued_requests = 0
        self._vclock = 0.0         # global virtual time (last pick's start)
        # log-bucketed histogram over submit->delivery latency in ms:
        # bounded memory at any request count, exact bucket counts for
        # /metrics; also mirrored into the global registry under
        # serve/latency_ms. latency_window is kept for signature compat
        # with the old deque-based stats and is ignored.
        del latency_window
        self._hist = obs.Histogram()
        self._closed = False
        self.dispatch_mode = dispatch_mode
        self._continuous = dispatch_mode == "continuous"
        # continuous-mode in-flight window: the dispatch loop appends
        # (batch, pieces) after launching, the deliver thread pops and
        # performs the host sync. Its own Condition so delivery never
        # contends with submit/fair-queuing on the main lock.
        self._dcond = threading.Condition()
        self._inflight: deque = deque()   # graftlint: guarded-by=_dcond
        self._prod_done = False           # graftlint: guarded-by=_dcond
        self._thread = threading.Thread(
            target=self._worker, name="lgbtorch-serve-batcher", daemon=True)
        self._thread.start()
        self._deliver_thread: Optional[threading.Thread] = None
        if self._continuous:
            self._deliver_thread = threading.Thread(
                target=self._deliverer, name="lgbtorch-serve-deliver",
                daemon=True)
            self._deliver_thread.start()

    # ---------------------------------------------------------------- tenants
    def _tenant(self, tenant: str) -> _TenantState:
        # lock held. A tenant re-activating after idling starts at the
        # global virtual clock — fairness is about the backlog window,
        # not about banking credit while away.
        st = self._tenants.get(tenant)   # graftlint: guarded-by=_lock -- caller holds it
        if st is None:
            st = self._tenants[tenant] = _TenantState(  # graftlint: guarded-by=_lock
                self._weights.get(tenant, 1.0))
        return st

    @staticmethod
    def _metric_tenant(tenant: str) -> str:
        return obs.safe_metric_part(tenant)

    # ---------------------------------------------------------------- submit
    def submit(self, X, trace_id: Optional[int] = None,
               tenant: Optional[str] = None) -> Future:
        """Queue one request; returns a Future resolving to its predictions
        (same shapes as ``PredictSession.predict``). A 1-D row is treated
        as a single-row batch. ``trace_id`` (from the http handler) links
        this request's queue/coalesce/dispatch spans to its request span
        when span tracing is on; ``tenant`` buckets it for fair queuing
        and per-tenant admission control. Raises ``RuntimeError`` once
        the batcher is closed — atomically with close(), so a submit
        either lands before the close (and gets an answer or a
        deterministic 'closed' failure from the drain) or raises here; it
        never hangs.

        With ``max_queue_rows``/``tenant_quota_rows`` set, an over-limit
        submit raises :class:`QueueFullError` (shed policy) or waits for
        queue space (block policy). A request alone bigger than the whole
        bound is admitted when its scope (queue / tenant queue) is empty
        — it can never fit better than that, so rejecting it forever
        would deadlock block-policy callers."""
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X[None, :]
        tenant = DEFAULT_TENANT if tenant is None else str(tenant)
        req = _Request(X, trace_id, tenant)
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            st = self._tenant(tenant)
            while self._over_limit(st, req.rows):
                if self._overload_shed:
                    st.shed += 1
                    st.shed_rows += req.rows
                    depth = self._queued_rows
                    t_queued = st.queued_rows
                    self._count_shed(tenant, req.rows)
                    raise QueueFullError(
                        "queue holds %d rows (%d for tenant %r); admitting "
                        "%d more would exceed max_queue_rows=%d / "
                        "tenant_quota_rows=%d"
                        % (depth, t_queued, tenant, req.rows,
                           self._max_queue_rows, self._tenant_quota))
                self._lock.wait()
                if self._closed:
                    raise RuntimeError("MicroBatcher is closed")
                st = self._tenant(tenant)
            if not st.pending:
                # (re-)activation: start at the global virtual clock so
                # an idle period does not bank dequeue credit
                st.vtime = max(st.vtime, self._vclock)
            st.pending.append(req)
            st.queued_rows += req.rows
            self._queued_rows += req.rows
            self._queued_requests += 1
            depth = self._queued_rows
            n_queued = self._queued_requests
            t_depth = st.queued_rows
            self._lock.notify_all()
        telemetry.count("serve/requests")
        telemetry.count("serve/rows", req.rows)
        telemetry.gauge("serve/queue_depth", n_queued)
        telemetry.observe("serve/queue_depth_rows", depth)
        telemetry.gauge("serve/tenant/%s/queue_rows"
                        % self._metric_tenant(tenant), t_depth)
        return req.future

    def _over_limit(self, st: _TenantState, rows: int) -> bool:
        # lock held. The oversize carve-out is per scope: a request alone
        # bigger than the global bound is admitted when the whole queue
        # is empty; one bigger than its tenant quota when that tenant's
        # queue is empty.
        total = self._queued_rows   # graftlint: guarded-by=_lock -- caller holds it
        mine = st.queued_rows       # graftlint: guarded-by=_lock -- caller holds it
        if self._max_queue_rows > 0 and total > 0 \
                and total + rows > self._max_queue_rows:
            return True
        if self._tenant_quota > 0 and mine > 0 \
                and mine + rows > self._tenant_quota:
            return True
        return False

    def _count_shed(self, tenant: str, rows: int) -> None:
        telemetry.count("serve/shed")
        telemetry.count("serve/shed_rows", rows)
        telemetry.count("serve/tenant/%s/shed" % self._metric_tenant(tenant))
        telemetry.count("serve/tenant/%s/shed_rows"
                        % self._metric_tenant(tenant), rows)

    def queue_rows(self) -> int:
        """Rows submitted but not yet picked up by the worker (the
        admission-control quantity; /healthz queue depth)."""
        with self._lock:
            return self._queued_rows

    def tenant_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant queue/shed/served snapshot (the /healthz
        ``tenants`` section)."""
        with self._lock:
            return {t: {"queue_rows": st.queued_rows,
                        "shed": st.shed,
                        "shed_rows": st.shed_rows,
                        "served_requests": st.served_requests,
                        "served_rows": st.served_rows,
                        "weight": st.weight}
                    for t, st in sorted(self._tenants.items())}

    # ---------------------------------------------------------------- worker
    def _pick_locked(self) -> Optional[_Request]:
        """Start-time-fair pick: the active tenant with the smallest
        virtual time goes first; dequeuing advances its clock by
        rows/weight. Lock held; returns None when nothing is queued."""
        best: Optional[str] = None
        best_v = 0.0
        for t, st in self._tenants.items():   # graftlint: guarded-by=_lock -- caller holds it
            if st.pending and (best is None or st.vtime < best_v
                               or (st.vtime == best_v and t < best)):
                best, best_v = t, st.vtime
        if best is None:
            return None
        st = self._tenants[best]   # graftlint: guarded-by=_lock -- caller holds it
        req = st.pending.popleft()
        self._vclock = st.vtime    # graftlint: guarded-by=_lock -- caller holds it
        st.vtime += req.rows / st.weight
        st.queued_rows -= req.rows
        self._queued_rows -= req.rows      # graftlint: guarded-by=_lock -- caller holds it
        self._queued_requests -= 1         # graftlint: guarded-by=_lock -- caller holds it
        st.served_requests += 1
        st.served_rows += req.rows
        # a dequeued request frees its queue-space reservation; wake any
        # block-policy submitters parked in submit()
        self._lock.notify_all()
        return req

    def _worker(self) -> None:
        try:
            if self._continuous:
                self._worker_continuous()
            else:
                self._worker_coalesce()
        finally:
            if self._continuous:
                # no more tiles will be launched; let the deliver thread
                # drain the in-flight window and exit
                with self._dcond:
                    self._prod_done = True   # graftlint: guarded-by=_dcond
                    self._dcond.notify_all()

    def _worker_coalesce(self) -> None:
        while True:
            with self._lock:
                while self._queued_requests == 0 and not self._closed:
                    self._lock.wait()
                if self._closed:
                    # requests admitted before the close flag flipped are
                    # failed deterministically — submit can no longer
                    # enqueue behind us, so this drains everything
                    self._drain_locked()
                    return
                req = self._pick_locked()
            batch = [req]
            rows = req.rows
            t_first = obs.monotonic()    # lead request leaves the queue
            deadline = req.t0 + self._max_wait
            while rows < self._max_rows:
                # requests already queued join for free — draining them
                # never delays anyone. Only WAITING for company is bounded
                # by the deadline; otherwise a dispatch slower than
                # max_wait_ms degenerates every backlog into batches of 1.
                with self._lock:
                    if self._queued_requests == 0 and not self._closed:
                        remain = deadline - obs.monotonic()
                        if remain > 0:
                            self._lock.wait(remain)
                    nxt = self._pick_locked()
                if nxt is None:
                    break
                batch.append(nxt)
                rows += nxt.rows
            self._seal_batch(batch, t_first, rows)
            pieces = self._launch(batch)
            if pieces is not None:
                self._deliver(batch, pieces)

    def _worker_continuous(self) -> None:
        # the standing dispatch loop: seal a tile from whatever is
        # queued right now and launch it — never wait for company. While
        # the deliver thread syncs an in-flight tile, new submissions
        # accumulate and ride the NEXT tile; under load the bounded
        # in-flight window is what grows batches, not a wall-clock wait.
        while True:
            with self._lock:
                while self._queued_requests == 0 and not self._closed:
                    self._lock.wait()
                if self._closed:
                    self._drain_locked()
                    return
                req = self._pick_locked()
            batch = [req]
            rows = req.rows
            t_first = obs.monotonic()
            while rows < self._max_rows:
                with self._lock:
                    nxt = self._pick_locked()
                if nxt is None:
                    break
                batch.append(nxt)
                rows += nxt.rows
            self._seal_batch(batch, t_first, rows)
            pieces = self._launch(batch)
            if pieces is None:
                continue
            with self._dcond:
                # bounded in-flight window: block the dispatch loop when
                # the deliver thread falls behind, so queue depth (the
                # admission-control quantity) reflects real backlog
                while len(self._inflight) >= _INFLIGHT_DEPTH:  # graftlint: guarded-by=_dcond
                    self._dcond.wait()
                self._inflight.append((batch, pieces))  # graftlint: guarded-by=_dcond
                self._dcond.notify_all()

    def _deliverer(self) -> None:
        # continuous mode's delivery side: pop in-flight tiles in launch
        # order, host-sync, finalize, resolve futures
        while True:
            with self._dcond:
                while not self._inflight and not self._prod_done:  # graftlint: guarded-by=_dcond
                    self._dcond.wait()
                if not self._inflight:   # graftlint: guarded-by=_dcond
                    return
                batch, pieces = self._inflight.popleft()  # graftlint: guarded-by=_dcond
                self._dcond.notify_all()
            self._deliver(batch, pieces)

    def _seal_batch(self, batch, t_first: float, rows: int) -> None:
        """Account for one sealed batch: queue-wait histogram (submit
        until its batch was sealed — the knob continuous batching exists
        to shrink), queue-depth gauge, and retroactive trace spans."""
        with self._lock:
            depth = self._queued_requests
        telemetry.gauge("serve/queue_depth", depth)
        now = obs.monotonic()
        for r in batch:
            telemetry.observe("serve/queue_wait_ms", (now - r.t0) * 1000.0)
        if tracer.serve_on:
            # retroactive spans: each request's time-in-queue plus one
            # coalesce span for the assembly window itself
            for r in batch:
                tracer.record("serve/queue_wait", r.t0, now,
                              trace_id=r.trace_id)
            tracer.record("serve/coalesce", t_first, now,
                          trace_id=batch[0].trace_id,
                          args={"requests": len(batch), "rows": rows})

    def _launch(self, batch):
        """Concatenate + dispatch one sealed batch on the device (async —
        no host sync here). Returns the dispatched pieces, or None after
        failing the batch's futures on a dispatch error."""
        n_rows = sum(r.rows for r in batch)
        telemetry.count("serve/batches")
        telemetry.count("serve/batch_rows", n_rows)
        telemetry.observe("serve/batch_rows", n_rows)
        try:
            with tracer.span("serve/batch", domain="serve",
                             trace_id=batch[0].trace_id,
                             requests=len(batch), rows=n_rows):
                X = batch[0].X if len(batch) == 1 else \
                    np.concatenate([r.X for r in batch], axis=0)
                with obs.wall("serve/batch"):
                    pieces = self._session.dispatch(X)
        except BaseException as exc:
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(exc)
            return None
        return pieces

    def _deliver(self, batch, pieces) -> None:
        """Host-sync one launched batch, finalize, resolve its futures.
        Runs on the deliver thread (continuous) or inline (coalesce)."""
        try:
            # the serve path's one sanctioned device->host sync: pull
            # the coalesced scores for result delivery
            with tracer.span("serve/slice_back", domain="serve",
                             trace_id=batch[0].trace_id):
                raw = self._session.collect(pieces)
            out = self._session.finalize(raw, raw_score=self._raw)
        except BaseException as exc:
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(exc)
            return
        off = 0
        now = obs.monotonic()
        for r in batch:
            r.future.set_result(np.array(out[off:off + r.rows]))
            off += r.rows
            dt = now - r.t0
            with self._lock:
                self._hist.observe(dt * 1000.0)
            telemetry.observe("serve/latency_ms", dt * 1000.0)
            telemetry.add_time("wall/serve/request", dt)
        self._update_latency_gauges()

    def _update_latency_gauges(self) -> None:
        with self._lock:
            if self._hist.count == 0:
                return
            p50 = self._hist.percentile(0.50)
            p99 = self._hist.percentile(0.99)
        telemetry.gauge("serve/latency_p50_ms", round(p50, 4))
        telemetry.gauge("serve/latency_p99_ms", round(p99, 4))

    def latency_stats(self) -> dict:
        """count + p50/p90/p99/p999 (seconds) derived from the latency
        histogram buckets (bucket-interpolated, not exact order stats)."""
        with self._lock:
            n = self._hist.count
            pcts = {label: self._hist.percentile(q) / 1000.0
                    for q, label in obs._PCTS}
        if n == 0:
            return {"count": 0, "p50_s": 0.0, "p90_s": 0.0,
                    "p99_s": 0.0, "p999_s": 0.0}
        return {"count": n,
                "p50_s": pcts["p50"], "p90_s": pcts["p90"],
                "p99_s": pcts["p99"], "p999_s": pcts["p999"]}

    # -------------------------------------------------------------- shutdown
    def _drain_locked(self) -> None:
        # lock held; fail every still-queued future so no caller hangs on
        # a stopped worker
        while True:
            req = self._pick_locked()
            if req is None:
                return
            if not req.future.done():
                req.future.set_exception(RuntimeError("MicroBatcher closed"))

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop accepting requests, finish + deliver every in-flight
        batch, fail any still-queued futures, join the worker(s).
        Idempotent. The flag flips under the submit lock, so every
        request that beat the flip is either dispatched with an
        in-flight batch or failed deterministically by the worker's
        drain; block-policy submitters parked for queue space are woken
        and raise instead of hanging on a dead worker. In continuous
        mode the dispatch loop exits first (marking the in-flight window
        done), then the deliver thread drains launched tiles to their
        futures and exits — graceful drain, no dropped answers."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._lock.notify_all()
        self._thread.join(timeout)
        if self._deliver_thread is not None:
            self._deliver_thread.join(timeout)

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
