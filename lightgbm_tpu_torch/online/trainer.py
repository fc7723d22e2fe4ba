"""Continual refit with a shadow-scoring promotion gate (PyTorch port of
``lightgbm_tpu/online/trainer.py``).

:class:`OnlineTrainer` closes the loop "train and serve in one process":
labeled traffic is ingested into a bounded
:class:`~lightgbm_tpu_torch.online.buffer.TrafficBuffer`, a background
worker trains a CANDIDATE model off the serving thread (``refit``: leaf
values re-estimated on the frozen structure, the reference
GBDT::RefitTree contract; or ``continue``: more boosting rounds through
``init_model``), and the candidate is promoted into the serving booster
only if it shadow-scores at least as well as the incumbent on a sliding
window of recent live traffic.

Promotion is atomic: :meth:`GBDT.adopt` swaps the model list under the
booster's ``_cache_lock`` with a SINGLE version-token bump, so every
concurrent ``PredictSession`` snapshot sees the old ensemble or the new
one whole. The displaced model is kept as a rollback token
(:meth:`OnlineTrainer.rollback`).

- **Hysteresis** (``promote_patience``): a candidate must win K
  consecutive shadow evaluations before the swap (``run_once`` returns
  ``"deferred"`` for the wins before).
- **Auto-rollback** (``rollback_threshold``): after a promotion the
  trainer watches the traffic ingested after the swap; once
  ``rollback_min_rows`` rows arrived it scores promoted against displaced
  on them and rolls back when the promoted model's loss exceeds
  ``rollback_threshold`` x the displaced model's.
- **Recency** (``shadow_decay``): the shadow window's rows are weighted
  by ``shadow_decay ** age``.

Every booster the trainer builds from a model string (the candidate base,
the incumbent copy, the watch's pair) lives on the serving booster's
device (``device_type``); a continue-mode candidate trains there too, on
the worker thread beside the serving threads.

- **Durability** (``store``): a :class:`~lightgbm_tpu_torch.fleet.FleetStore`
  persists every ingest chunk, every gate verdict (with the win streak
  and a consumed-row watermark) and publishes every promotion and
  rollback as a version-tokened whole-model artifact. On boot the trainer
  replays the store: rows at or below the watermark re-enter only the
  shadow window (they were trained on already), rows above it re-enter
  both, and the win streak resumes where the dead process left it.
- **Failover** (``lease_ttl_s`` > 0): the trainer starts in standby (it
  persists ingest but neither buffers nor trains) until it wins the
  store's trainer lease. On acquisition it arms publish fencing with its
  lease epoch, rebuilds its state through the replay path and goes
  active; the worker renews the lease every ttl/3 and demotes itself to
  standby the moment a renewal fails, from which point the fencing epoch
  refuses its publishes. ``compact_bytes`` > 0 compacts the store
  (snapshot + truncate, ``FleetStore.compact``; ``snapshot_rows`` > 0
  moves the compacted chunks into a snapshot blob) whenever the event
  log outgrows that bound, after the gate verdict that made the state
  durable.

Telemetry: ``online/ingested_rows``, ``online/train_runs``,
``online/promotions``, ``online/rejections``, ``online/train_errors``
counters; ``online/train_ms``, ``online/shadow_ms``,
``online/promote_swap_ms`` histograms; ``online/*`` spans go to the
port's span recorder (a no-op until the observability slice).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..obs import telemetry, tracer
from ..utils.log import Log, LightGBMError
from .buffer import TrafficBuffer

MODES = ("refit", "continue")

#: floor for probabilities inside log-losses (reference binary_objective
#: uses a sigmoid that never saturates to exactly 0/1; host-side clipping
#: keeps a degenerate candidate finite instead of -inf)
_EPS = 1e-15


def _objective_loss(model, X: np.ndarray, y: np.ndarray,
                    w: Optional[np.ndarray] = None) -> float:
    """Objective-matched (weighted) mean loss: logloss for binary,
    multi-logloss for multiclass, MSE otherwise (predictions come back
    transformed, so probabilities are directly comparable). Shared by the
    shadow gate and the post-promotion live watch — both must judge by
    the same yardstick or a promotion could pass one and fail the
    other on scale alone."""
    pred = np.asarray(model.predict(X), np.float64)
    obj = getattr(model.inner.objective, "name", "") \
        if model.inner.objective is not None else ""
    n = len(y)
    if obj == "binary":
        p = np.clip(pred.ravel(), _EPS, 1.0 - _EPS)
        per_row = -(y * np.log(p) + (1 - y) * np.log(1 - p))
    elif obj.startswith("multiclass"):
        p = pred.reshape(n, -1)
        picked = p[np.arange(n), y.astype(np.int64)]
        per_row = -np.log(np.clip(picked, _EPS, 1.0))
    else:
        per_row = (pred.ravel() - y) ** 2
    return float(np.average(per_row, weights=w))


class _CandidateBuilder:
    """Thread-confined candidate factory for one train cycle.

    Holds a serialized snapshot of the serving model plus plain arrays;
    every object it builds (base booster, candidate, incumbent copy,
    datasets) is private to the worker's cycle, on the serving booster's
    device (``device_type``). The cycle's only cross-thread surfaces are
    the trainer's lock-guarded snapshot cache and the guarded ``adopt``
    that publishes the winner."""

    def __init__(self, mode: str, model_str: str,
                 train_params: Dict[str, Any], continue_rounds: int,
                 decay_rate: Optional[float],
                 shadow_decay: float = 1.0,
                 device_type: str = "cuda") -> None:
        self._mode = mode
        self._device = {"device_type": device_type}
        self._src = model_str
        self._params = dict(train_params)
        self._rounds = int(continue_rounds)
        self._decay = decay_rate
        self._shadow_decay = float(shadow_decay)

    def build(self, X: np.ndarray, y: np.ndarray):
        """Train the candidate: leaf re-estimation on the frozen
        structure (``refit``, the reference GBDT::RefitTree contract) or
        more boosting rounds from the snapshot (``continue``)."""
        from ..basic import Booster, Dataset
        base = Booster(self._device, model_str=self._src)
        if self._mode == "refit":
            return base.refit(X, y, decay_rate=self._decay)
        from ..engine import train as _train
        return _train(self._params, Dataset(X, label=y),
                      num_boost_round=self._rounds, init_model=base)

    def serialize(self, candidate) -> str:
        """Candidate's model string (the next cycle's snapshot when this
        one wins promotion). Runs here, not in the trainer, so the
        serialization stays on the worker's private objects."""
        return candidate.model_to_string()

    def score_pair(self, candidate, X: np.ndarray,
                   y: np.ndarray) -> tuple:
        """(incumbent_loss, candidate_loss) on the shadow window. The
        incumbent is scored as a private copy of the snapshot so shadow
        scoring never contends with live serving dispatches."""
        from ..basic import Booster
        incumbent = Booster(self._device, model_str=self._src)
        w = None
        if self._shadow_decay < 1.0:
            # shadow rows arrive oldest -> newest (TrafficBuffer.shadow):
            # the newest row carries weight 1 and every step back decays,
            # so live drift dominates the promotion verdict
            w = self._shadow_decay ** np.arange(len(y) - 1, -1, -1,
                                                dtype=np.float64)
        return (_objective_loss(incumbent, X, y, w),
                _objective_loss(candidate, X, y, w))


class _WatchScorer:
    """Thread-confined scorer for one live-watch verdict.

    Same confinement contract as :class:`_CandidateBuilder`: constructed
    fresh per evaluation from serialized model strings, so the boosters
    it builds and scores are private to that call."""

    def __init__(self, cand_str: str, prev_str: str,
                 device_type: str = "cuda") -> None:
        self._cand = cand_str
        self._prev = prev_str
        self._device = {"device_type": device_type}

    def losses(self, X: np.ndarray, y: np.ndarray) -> tuple:
        """(promoted_loss, displaced_loss) on the post-swap traffic."""
        from ..basic import Booster
        promoted = Booster(self._device, model_str=self._cand)
        displaced = Booster(self._device, model_str=self._prev)
        return (_objective_loss(promoted, X, y),
                _objective_loss(displaced, X, y))


class OnlineTrainer:
    """Background continual-training loop over one serving booster.

    ``booster`` is the live ``lgt.Booster`` the serving sessions hold;
    promotions mutate it in place (atomically) so every
    ``PredictSession``/``MicroBatcher`` over it picks the new model up on
    its next dispatch without reconnecting anything.

    With ``start=True`` (default) a named daemon worker thread watches
    the buffer and trains whenever ``trigger_rows`` rows accumulated (or
    ``trigger_interval_s`` elapsed with at least ``min_rows`` buffered).
    Tests drive the same cycle synchronously via :meth:`run_once` with
    ``start=False``.
    """

    def __init__(self, booster, *, mode: str = "refit",
                 trigger_rows: int = 2048,
                 trigger_interval_s: float = 0.0,
                 buffer_rows: int = 65536, shadow_rows: int = 4096,
                 promote_threshold: float = 1.0, min_rows: int = 64,
                 continue_rounds: int = 10,
                 continue_params: Optional[Dict[str, Any]] = None,
                 decay_rate: Optional[float] = None,
                 shadow_decay: float = 1.0,
                 promote_patience: int = 1,
                 rollback_threshold: float = 0.0,
                 rollback_min_rows: int = 64,
                 store=None, replay: bool = True,
                 lease_ttl_s: float = 0.0,
                 holder_id: Optional[str] = None,
                 compact_bytes: int = 0,
                 keep_artifacts: int = 0,
                 snapshot_rows: int = 0,
                 heartbeat_interval_s: float = 0.0,
                 advertise_url: Optional[str] = None,
                 candidate_factory=None,
                 start: bool = True) -> None:
        if mode not in MODES:
            raise LightGBMError("online mode must be one of %s, got %r"
                                % ("|".join(MODES), mode))
        if not 0.0 < float(shadow_decay) <= 1.0:
            raise LightGBMError("online shadow_decay must be in (0, 1], "
                                "got %g" % shadow_decay)
        if promote_patience < 1:
            raise LightGBMError("online promote_patience must be >= 1, "
                                "got %d" % promote_patience)
        if rollback_threshold < 0:
            raise LightGBMError("online rollback_threshold must be >= 0 "
                                "(0 disables the live watch), got %g"
                                % rollback_threshold)
        if rollback_min_rows < 1:
            raise LightGBMError("online rollback_min_rows must be >= 1")
        if not hasattr(booster, "refit") or not hasattr(booster, "inner"):
            raise LightGBMError(
                "OnlineTrainer needs a lightgbm_tpu_torch.Booster (refit "
                "and adopt live on the Booster API)")
        if trigger_rows < 1:
            raise LightGBMError("online trigger_rows must be >= 1")
        if promote_threshold < 0:
            raise LightGBMError("online promote_threshold must be >= 0")
        if lease_ttl_s < 0:
            raise LightGBMError("online lease_ttl_s must be >= 0 "
                                "(0 disables failover leasing), got %g"
                                % lease_ttl_s)
        if compact_bytes < 0 or keep_artifacts < 0:
            raise LightGBMError("online compact_bytes/keep_artifacts "
                                "must be >= 0")
        if snapshot_rows < 0:
            raise LightGBMError("online snapshot_rows must be >= 0 "
                                "(0 disables snapshot compaction), got %d"
                                % snapshot_rows)
        if snapshot_rows > 0 and store is None:
            raise LightGBMError("online snapshot_rows needs a fleet "
                                "store to snapshot into")
        if heartbeat_interval_s < 0:
            raise LightGBMError("online heartbeat_interval_s must be "
                                ">= 0 (0 disables heartbeats), got %g"
                                % heartbeat_interval_s)
        if lease_ttl_s > 0 and store is None:
            raise LightGBMError("online lease_ttl_s needs a fleet store "
                                "to hold the lease in")
        if compact_bytes > 0 and store is None:
            raise LightGBMError("online compact_bytes needs a fleet "
                                "store to compact")
        self._booster = booster
        self._mode = mode
        self._trigger_rows = int(trigger_rows)
        self._interval = float(trigger_interval_s)
        self._min_rows = max(1, int(min_rows))
        self._threshold = float(promote_threshold)
        self._continue_rounds = int(continue_rounds)
        self._decay = decay_rate
        self._shadow_decay = float(shadow_decay)
        self._patience = int(promote_patience)
        self._rb_threshold = float(rollback_threshold)
        self._rb_min_rows = int(rollback_min_rows)
        # the fleet store is duck-typed (append_ingest/append_gate/
        # publish/events, plus acquire/renew/release_lease and compact
        # when the failover and retention knobs are on), so tests can
        # inject fakes
        self._store = store
        self._lease_ttl = float(lease_ttl_s)
        self._holder = str(holder_id) if holder_id \
            else "pid-%d" % os.getpid()
        self._compact_bytes = int(compact_bytes)
        self._keep_artifacts = int(keep_artifacts)
        self._snapshot_rows = int(snapshot_rows)
        # the URL this trainer's serving endpoint is reachable at,
        # advertised in the lease record at acquire/renew time (the
        # leader hint ingest forwarding follows). Public and mutable: a
        # server bound to an ephemeral port learns its address after the
        # trainer exists, and the next renewal advertises it.
        self.advertise_url = str(advertise_url) if advertise_url else None
        self._replay_on_acquire = bool(replay)
        # test/extension hook: a callable (X, y) -> Booster replaces the
        # default candidate build (degraded-candidate gate tests)
        self._candidate_factory = candidate_factory
        # continue-mode params frozen here (main thread) so the worker
        # never reads live config off the shared booster; every booster
        # the worker builds lives on the serving booster's device
        cfg = booster.config
        self._device_type = cfg.device_type
        params: Dict[str, Any] = {"verbosity": -1}
        params.update(objective=cfg.objective, num_class=cfg.num_class,
                      learning_rate=cfg.learning_rate,
                      num_leaves=cfg.num_leaves, max_bin=cfg.max_bin)
        params.update(continue_params or {})
        params["device_type"] = self._device_type
        self._train_params = params
        # serving-model snapshot cache: serialized HERE (main thread,
        # before the worker exists) and thereafter only updated at
        # promotion/rollback from strings the worker computed on its own
        # private candidate. Contract: the trainer is the sole mutator of
        # the served model after start.
        self._model_str = booster.model_to_string()
        self.buffer = TrafficBuffer(buffer_rows, shadow_rows)
        # Condition doubles as the state lock (counters, last-result
        # strings, the rollback token) and the worker's wakeup: ingest
        # notifies when a trigger is reached, close notifies to stop.
        self._lock = threading.Condition()
        self._stopped = False
        self._trains = 0
        self._promotions = 0
        self._rejections = 0
        self._errors = 0
        self._last_result = "idle"
        self._last_error = ""
        self._last_losses: Optional[Dict[str, float]] = None
        self._rollback: Optional[tuple] = None
        self._last_train_t = obs.monotonic()
        # hysteresis win-streak, consumed-row watermark (rows drained
        # into a train cycle: the replay boundary between shadow-only
        # and trainable traffic) and the post-promotion live watch
        self._wins = 0
        self._consumed_rows = 0
        self._replayed_rows = 0
        self._auto_rollbacks = 0
        self._last_promotion_ts = 0.0
        self._last_rollback_ts = 0.0
        self._watch: Optional[Dict[str, Any]] = None
        self._watch_chunks: List[Tuple[np.ndarray, np.ndarray]] = []
        # failover: with a lease ttl the trainer boots in standby (no
        # replay, no training) until it wins the lease; try_acquire()
        # then replays and goes active with fencing armed
        self._standby = self._lease_ttl > 0
        self._lease_epoch = 0
        self._lease_lost = 0
        self._last_renew_t = obs.monotonic()
        # periodic heartbeats into the store's sidecar (role, version,
        # lease, counters) for the /fleet/status rollup
        self._hb_interval = float(heartbeat_interval_s)
        self._hb_last = 0.0
        self._hb_sent = 0
        self._hb_errors = 0
        if self._store is not None and replay and not self._standby:
            self._replay()
        # pre-touch the promotion counters so a freshly started online
        # server shows the whole family before the first train cycle
        telemetry.count("online/promotions", 0)
        telemetry.count("online/rejections", 0)
        telemetry.count("online/train_runs", 0)
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._worker, name="lgbt-online-trainer",
                daemon=True)
            self._thread.start()

    # --------------------------------------------------------------- ingest
    def ingest(self, X, y) -> int:
        """Add labeled rows (features, labels) to the training buffer and
        shadow window; returns the buffered row count. Called from HTTP
        handler threads (POST /ingest) or embedding code; never blocks on
        training.

        With a fleet store the chunk is persisted BEFORE the in-memory
        push: a crash after the append replays the chunk on restart
        instead of losing it; a crash before it loses a chunk the caller
        never saw acknowledged."""
        X_arr = np.asarray(X, np.float64)
        y_arr = np.asarray(y, np.float64).ravel()
        if self._store is not None:
            self._store.append_ingest(X_arr, y_arr)
        with self._lock:
            standby = self._standby
        if standby:
            # a standby keeps no local state: on takeover it rebuilds
            # everything from the log (which just got this chunk), so
            # buffering here would count it twice
            telemetry.count("online/ingested_rows", int(y_arr.size))
            return 0
        buffered = self.buffer.push(X_arr, y_arr)
        self._feed_watch(X_arr, y_arr)
        telemetry.count("online/ingested_rows", int(y_arr.size))
        telemetry.gauge("online/buffered_rows", buffered)
        if buffered >= self._trigger_rows:
            with self._lock:
                self._lock.notify_all()
        return buffered

    def _feed_watch(self, X: np.ndarray, y: np.ndarray) -> None:
        """Route fresh post-promotion traffic into the live watch (the
        rollback verdict must come from rows the promoted model is
        actually serving, not from the shadow window the gate already
        judged)."""
        with self._lock:
            watch = self._watch
            if watch is None or watch["rows"] >= self._rb_min_rows:
                return
            if X.ndim == 1:
                X = X[None, :]
            self._watch_chunks.append((X, y))
            watch["rows"] += int(len(y))
            armed = watch["rows"] >= self._rb_min_rows
        if armed:
            with self._lock:
                self._lock.notify_all()

    # --------------------------------------------------------------- replay
    def _replay(self) -> None:
        """Rebuild buffer and hysteresis state from the fleet store.

        Gate events carry the consumed-row watermark: ingest rows at or
        below it were already drained into a train cycle by the dead
        process, so they re-enter ONLY the shadow window (training on
        them again would count their gradients twice); rows above it
        re-enter the training buffer too. The win streak resumes from the
        newest gate event.

        A ``compact`` record stands in for everything truncated before
        it: its watermark/wins snapshot seeds the gate fold, and its
        ``row_base`` seeds the global row offset, so the retained ingest
        suffix replays at the offsets it first held: replay from a
        compacted log equals replay from the full log bit for bit."""
        events = list(self._store.events())
        watermark = 0
        wins = 0
        for e in events:
            kind = e.get("kind")
            if kind == "compact":
                watermark = max(watermark, int(e.get("watermark", 0)))
                wins = int(e.get("wins", 0))
            elif kind == "gate":
                watermark = max(watermark, int(e.get("consumed_rows", 0)))
                wins = int(e.get("wins", 0))
        with self._lock:
            self._wins = wins
        seen = 0
        replayed = 0

        def push_chunk(lo: int, e: Dict[str, Any]) -> int:
            try:
                X = np.asarray(e["rows"], np.float64)
                y = np.asarray(e["labels"], np.float64).ravel()
            except (KeyError, TypeError, ValueError):
                return 0   # a malformed entry must not block the boot
            if X.ndim == 1:
                X = X[None, :]
            if len(y) == 0 or X.shape[0] != len(y):
                return 0
            hi = lo + len(y)
            if hi <= watermark:
                self.buffer.push(X, y, training=False)
            elif lo >= watermark:
                self.buffer.push(X, y)
            else:
                # the chunk straddles the watermark: only its untrained
                # tail re-enters the training buffer
                cut = watermark - lo
                self.buffer.push(X[:cut], y[:cut], training=False)
                self.buffer.push(X[cut:], y[cut:])
            return len(y)

        for e in events:
            kind = e.get("kind")
            if kind == "compact":
                if isinstance(e.get("snapshot"), dict):
                    # snapshot bootstrap: the record's row_base already
                    # sits past the snapshotted span, so its chunks are
                    # pushed here at their recorded offsets; a missing
                    # or corrupt snapshot degrades to no chunks with the
                    # offsets intact (lost buffer warmth, never a
                    # misaligned replay)
                    loader = getattr(self._store, "snapshot_chunks",
                                     None)
                    if loader is not None:
                        for lo, _hi, ev in loader(e):
                            replayed += push_chunk(lo, ev)
                seen = max(seen, int(e.get("row_base", 0)))
                continue
            if kind != "ingest":
                continue
            n = push_chunk(seen, e)
            seen += n
            replayed += n
        with self._lock:
            self._consumed_rows = min(watermark, seen)
            self._replayed_rows = replayed
            wins_now = self._wins
        if replayed:
            telemetry.count("fleet/replayed_rows", replayed)
            Log.info("fleet: replayed %d ingest rows (%d shadow-only at "
                     "watermark %d), win-streak=%d", replayed,
                     min(watermark, seen), watermark, wins_now)

    # --------------------------------------------------------------- worker
    def _worker(self) -> None:
        # poll granularity: the interval trigger when set, else a coarse
        # tick — row triggers arrive via notify so the tick only bounds
        # shutdown latency
        poll = self._interval if self._interval > 0 else 0.5
        if self._lease_ttl > 0:
            # the renewal must fire well inside the ttl however coarse
            # the train trigger is
            poll = min(poll, self._lease_ttl / 3.0)
        while True:
            with self._lock:
                if self._stopped:
                    return
                self._lock.wait(timeout=poll)
                if self._stopped:
                    return
            active = self._lease_ttl <= 0 or self._lease_tick()
            # standbys heartbeat too: the /fleet/status rollup shows the
            # warm spare waiting on the lease, not just the holder
            self.maybe_heartbeat()
            if not active:
                continue   # standby (or just demoted): no watch, no train
            try:
                # the live watch outranks training: a regressed model
                # should be rolled back before another cycle builds a
                # candidate on top of it
                self.watch_once()
            except BaseException as exc:
                self._count_error("live watch", exc)
            if self._should_train():
                try:
                    self.run_once()
                except BaseException as exc:
                    # a failed train cycle must never take serving down:
                    # record, count, keep looping
                    self._count_error("train cycle", exc)

    def _count_error(self, what: str, exc: BaseException) -> None:
        telemetry.count("online/train_errors")
        with self._lock:
            self._errors += 1
            self._last_error = "%s: %s" % (type(exc).__name__, exc)
        Log.warning("online: %s failed: %s: %s", what, type(exc).__name__,
                    exc)

    def _should_train(self) -> bool:
        rows = self.buffer.rows
        if rows >= self._trigger_rows:
            return True
        if self._interval > 0 and rows >= self._min_rows:
            with self._lock:
                last = self._last_train_t
            return obs.monotonic() - last >= self._interval
        return False

    # --------------------------------------------------------------- failover
    def try_acquire(self) -> bool:
        """One lease-acquisition attempt. On success: arm publish
        fencing with the new epoch, rebuild state from the log through
        the replay path (the watermark and win streak the dead holder
        made durable), go active. Returns True when this trainer is (now)
        the active publisher; always True when leasing is off."""
        if self._lease_ttl <= 0:
            return True
        with self._lock:
            if not self._standby:
                return True
        try:
            # url= only when advertised: fake stores in tests take two
            # positionals
            if self.advertise_url:
                epoch = self._store.acquire_lease(
                    self._holder, self._lease_ttl,
                    url=self.advertise_url)
            else:
                epoch = self._store.acquire_lease(self._holder,
                                                  self._lease_ttl)
        except Exception as exc:
            Log.warning("fleet: lease acquisition failed: %s: %s",
                        type(exc).__name__, exc)
            return False
        if epoch is None:
            return False
        self._store.set_fence(self._holder, int(epoch))
        if self._replay_on_acquire:
            # rebuilt from the log alone: nothing this process buffered
            # while standby (there should be nothing) survives
            self.buffer.reset()
            with self._lock:
                self._wins = 0
                self._consumed_rows = 0
                self._replayed_rows = 0
            self._replay()
        with self._lock:
            self._standby = False
            self._lease_epoch = int(epoch)
            self._last_renew_t = obs.monotonic()
        telemetry.count("fleet/lease_takeovers")
        Log.info("fleet: %s is now the ACTIVE trainer (lease epoch %d)",
                 self._holder, epoch)
        return True

    def wait_for_lease(self, timeout_s: float) -> bool:
        """Block until this trainer holds the lease, up to
        ``timeout_s``. With the worker running the worker's own tick
        acquires; without one (``start=False``) this polls
        :meth:`try_acquire` directly."""
        deadline = obs.monotonic() + float(timeout_s)
        while True:
            with self._lock:
                if not self._standby:
                    return True
            if self._thread is None and self.try_acquire():
                return True
            remaining = deadline - obs.monotonic()
            if remaining <= 0:
                return False
            time.sleep(min(0.05, remaining))

    def _lease_tick(self) -> bool:
        """Worker-side lease duty: acquire when standby, renew every
        ttl/3 when active, demote the moment a renewal fails (the fence
        epoch then blocks any publish this process still attempts).
        Returns True when active."""
        with self._lock:
            standby = self._standby
            epoch = self._lease_epoch
            last_renew = self._last_renew_t
        if standby:
            return self.try_acquire()
        if obs.monotonic() - last_renew < self._lease_ttl / 3.0:
            return True
        renewed = False
        try:
            if self.advertise_url:
                renewed = self._store.renew_lease(
                    self._holder, epoch, self._lease_ttl,
                    url=self.advertise_url)
            else:
                renewed = self._store.renew_lease(self._holder, epoch,
                                                  self._lease_ttl)
        except Exception as exc:
            Log.warning("fleet: lease renewal errored: %s: %s",
                        type(exc).__name__, exc)
        if renewed:
            with self._lock:
                self._last_renew_t = obs.monotonic()
            return True
        with self._lock:
            self._standby = True
            self._lease_epoch = 0
            self._lease_lost += 1
        telemetry.count("fleet/lease_lost")
        Log.warning("fleet: %s lost the trainer lease (epoch %d) — "
                    "demoting to standby", self._holder, epoch)
        return False

    # ------------------------------------------------------------- heartbeats
    def heartbeat_doc(self) -> Dict[str, Any]:
        """Compact node summary recorded to the store each heartbeat:
        the trainer's half of the ``/fleet/status`` rollup (replicas
        record the watcher's)."""
        version = 0
        if self._store is not None:
            state = getattr(self._store, "state", None)
            if state is not None:
                try:
                    version = int(state().get("last_published_version", 0))
                except Exception:
                    version = 0
        with self._lock:
            doc = {
                "node": self._holder,
                "role": ("standby" if self._standby else "active")
                if self._lease_ttl > 0 else "solo",
                "pid": os.getpid(),
                "version": version,
                "lease_epoch": self._lease_epoch,
                "trains": self._trains,
                "promotions": self._promotions,
                "rejections": self._rejections,
                "consumed_rows": self._consumed_rows,
            }
        doc["buffered_rows"] = self.buffer.rows
        return doc

    def maybe_heartbeat(self, force: bool = False) -> bool:
        """Record a heartbeat when one is due (``heartbeat_interval_s``
        elapsed; 0 disables unless ``force``). Never raises: a store that
        cannot take a heartbeat must not perturb the train loop."""
        if self._store is None or (self._hb_interval <= 0 and not force):
            return False
        record = getattr(self._store, "record_heartbeat", None)
        if record is None:
            return False
        now = obs.monotonic()
        with self._lock:
            if not force and now - self._hb_last < self._hb_interval:
                return False
            self._hb_last = now
        try:
            ok = bool(record(self.heartbeat_doc()))
        except Exception:
            with self._lock:
                self._hb_errors += 1
            telemetry.count("fleet/heartbeat_errors")
            return False
        if ok:
            with self._lock:
                self._hb_sent += 1
        return ok

    # ---------------------------------------------------------------- cycle
    def run_once(self) -> str:
        """One synchronous train cycle: drain the buffer, build a
        candidate, shadow-score it, promote or reject. Returns
        ``"promoted"``, ``"rejected"``, ``"deferred"`` (shadow win
        banked toward ``promote_patience``, no swap yet) or
        ``"skipped"`` (not enough data), or ``"standby"`` (this trainer
        does not hold the lease: only the active holder trains). Tests
        call this directly with ``start=False``."""
        with self._lock:
            if self._standby:
                return "standby"
            self._last_train_t = obs.monotonic()
        data = self.buffer.take_training()
        if data is None or len(data[1]) < self._min_rows:
            if data is not None:
                # not enough signal yet — put it back for the next cycle
                self.buffer.push(data[0], data[1])
            self._finish("skipped", None)
            return "skipped"
        X, y = data
        with tracer.span("online/train_cycle", domain="online",
                         rows=int(len(y)), mode=self._mode):
            telemetry.count("online/train_runs")
            telemetry.count("online/trained_rows", int(len(y)))
            with self._lock:
                self._trains += 1
                # snapshot of the serving model, kept across promotions
                # and rollbacks — everything downstream is private to the
                # builder until the guarded adopt publishes the winner
                src = self._model_str
            builder = _CandidateBuilder(self._mode, src,
                                        self._train_params,
                                        self._continue_rounds, self._decay,
                                        self._shadow_decay,
                                        self._device_type)
            with telemetry.timed_observe("online/train_ms"), \
                    tracer.span("online/train", domain="online"):
                candidate = (self._candidate_factory(X, y)
                             if self._candidate_factory is not None
                             else builder.build(X, y))
            accept, losses = False, None
            shadow = self.buffer.shadow()
            if shadow is not None:  # no traffic to judge on => reject
                Xs, ys = shadow
                with telemetry.timed_observe("online/shadow_ms"), \
                        tracer.span("online/shadow_score", domain="online",
                                    rows=int(len(ys))):
                    cur, cand = builder.score_pair(candidate, Xs, ys)
                losses = {"current": float(cur), "candidate": float(cand),
                          "threshold": self._threshold,
                          "rows": int(len(ys))}
                accept = bool(np.isfinite(cand)
                              and cand <= self._threshold * cur + 1e-12)
            # the drained rows are consumed either way (a rejected
            # candidate's training data is gone too), so the replay
            # watermark advances on every real cycle
            with self._lock:
                self._consumed_rows += int(len(y))
                consumed = self._consumed_rows
            if accept:
                with self._lock:
                    self._wins += 1
                    wins = self._wins
                if wins < self._patience:
                    # hysteresis: a win is banked, not acted on, until
                    # the streak reaches promote_patience
                    telemetry.count("online/deferrals")
                    self._record_gate("deferred", wins, consumed, losses)
                    self._maybe_compact(wins, consumed)
                    self._finish("deferred", losses)
                    return "deferred"
                with self._lock:
                    self._wins = 0
                self._promote(candidate, builder.serialize(candidate), src)
                self._record_gate("promoted", 0, consumed, losses)
                self._maybe_compact(0, consumed)
                self._finish("promoted", losses)
                return "promoted"
            telemetry.count("online/rejections")
            with self._lock:
                self._rejections += 1
                self._wins = 0   # a loss breaks the streak
            self._record_gate("rejected", 0, consumed, losses)
            self._maybe_compact(0, consumed)
            self._finish("rejected", losses)
            return "rejected"

    def _record_gate(self, result: str, wins: int, consumed: int,
                     losses) -> None:
        if self._store is None:
            return
        try:
            self._store.append_gate(result, wins, consumed, losses)
        except Exception as exc:
            # durability is best-effort on a full or broken disk; the
            # live promotion decision already happened
            Log.warning("fleet: gate append failed: %s: %s",
                        type(exc).__name__, exc)

    def _maybe_compact(self, wins: int, consumed: int) -> None:
        """Retention: once the event log outgrows ``compact_bytes``,
        snapshot (the gate verdict just recorded made the watermark and
        streak durable) and truncate. ``keep_rows`` is the shadow
        window's capacity: the retained ingest suffix rebuilds both
        windows bit for bit."""
        if (self._store is None or self._compact_bytes <= 0
                or not hasattr(self._store, "compact")):
            return
        try:
            if self._store.log_bytes() <= self._compact_bytes:
                return
            kw = {}
            if self._snapshot_rows > 0:
                # passed only when on, so fake stores with the narrow
                # compact signature keep working
                kw["snapshot_rows"] = self._snapshot_rows
            self._store.compact(watermark=consumed, wins=wins,
                                keep_rows=self.buffer.shadow_capacity,
                                keep_artifacts=self._keep_artifacts, **kw)
        except Exception as exc:
            # retention is best-effort; an uncompacted log only costs
            # disk, never correctness
            Log.warning("fleet: compaction failed: %s: %s",
                        type(exc).__name__, exc)

    # ------------------------------------------------------------ promotion
    def _promote(self, candidate, cand_str: str, prev_str: str) -> None:
        with telemetry.timed_observe("online/promote_swap_ms"), \
                tracer.span("online/promote", domain="online"):
            token = self._booster.adopt(candidate)
        with self._lock:
            # the rollback token carries the displaced model's string so
            # the snapshot cache rewinds with the swap
            self._rollback = (token, prev_str)
            self._model_str = cand_str
            self._promotions += 1
            self._last_promotion_ts = time.time()
            if self._rb_threshold > 0:
                # arm the live watch: the verdict comes from traffic
                # ingested from here on, which the shadow gate never saw
                self._watch = {"cand_str": cand_str, "prev_str": prev_str,
                               "rows": 0}
                self._watch_chunks = []
        telemetry.count("online/promotions")
        telemetry.gauge("online/model_version",
                        self._booster.inner.model_version)
        self._publish("promotion", cand_str)

    def _publish(self, event: str, model_str: str,
                 meta: Optional[Dict[str, Any]] = None) -> None:
        if self._store is None:
            return
        try:
            self._store.publish(model_str, event=event, meta=meta)
        except Exception as exc:
            # replicas keep serving the previous published version
            Log.warning("fleet: publish(%s) failed: %s: %s", event,
                        type(exc).__name__, exc)

    def rollback(self) -> bool:
        """Restore the model displaced by the last promotion (single
        atomic swap, like the promotion itself). Returns False when
        there is nothing to roll back to."""
        with self._lock:
            tok = self._rollback
            self._rollback = None
            self._watch = None   # the watched promotion is being undone
            self._watch_chunks = []
        if tok is None:
            return False
        snapshot, prev_str = tok
        self._booster.restore(snapshot)
        with self._lock:
            self._model_str = prev_str
            self._last_rollback_ts = time.time()
        telemetry.count("online/rollbacks")
        # a rollback distributes like any publish: replicas converge on
        # the newest version token, which is now the restored model
        self._publish("rollback", prev_str)
        return True

    # ------------------------------------------------------------ live watch
    def watch_once(self) -> Optional[bool]:
        """Evaluate the post-promotion live watch if it is armed and
        ``rollback_min_rows`` fresh labeled rows arrived since the swap:
        score promoted vs. displaced on exactly those rows and roll back
        when the promoted model's live loss exceeds
        ``rollback_threshold`` x the displaced model's.

        One verdict per promotion. Returns True (rolled back), False
        (promotion confirmed, watch disarmed) or None (nothing to do
        yet). The worker calls this every tick; tests with ``start=False``
        drive it directly."""
        with self._lock:
            watch = self._watch
            if watch is None or watch["rows"] < self._rb_min_rows:
                return None
            self._watch = None   # claim it: one evaluation, one verdict
            chunks = self._watch_chunks
            self._watch_chunks = []
        X = np.concatenate([c[0] for c in chunks], axis=0)
        y = np.concatenate([c[1] for c in chunks])
        # private rebuilds from strings: scoring never touches the live
        # serving booster
        scorer = _WatchScorer(watch["cand_str"], watch["prev_str"],
                              self._device_type)
        with telemetry.timed_observe("online/watch_ms"), \
                tracer.span("online/live_watch", domain="online",
                            rows=int(len(y))):
            cand, prev = scorer.losses(X, y)
        losses = {"promoted": float(cand), "displaced": float(prev),
                  "threshold": self._rb_threshold, "rows": int(len(y))}
        regressed = bool(not np.isfinite(cand)
                         or cand > self._rb_threshold * prev + 1e-12)
        if not regressed:
            Log.info("online: live watch confirmed promotion "
                     "(promoted=%.6g displaced=%.6g)", cand, prev)
            telemetry.count("online/watch_confirms")
            self._finish("confirmed", losses)
            return False
        Log.warning("online: live loss regressed past bound "
                    "(promoted=%.6g > %.2f x displaced=%.6g) — rolling "
                    "back", cand, self._rb_threshold, prev)
        telemetry.count("online/auto_rollbacks")
        with self._lock:
            self._auto_rollbacks += 1
        self.rollback()
        self._finish("auto_rollback", losses)
        return True

    def _finish(self, result: str, losses) -> None:
        with self._lock:
            self._last_result = result
            if losses is not None:
                self._last_losses = losses

    # ----------------------------------------------------------------- state
    def state(self) -> Dict[str, Any]:
        """JSON-serializable trainer state (surfaced on /healthz)."""
        with self._lock:
            st = {
                "running": self._thread.is_alive()
                if self._thread is not None else False,
                "mode": self._mode,
                "trigger_rows": self._trigger_rows,
                "shadow_decay": self._shadow_decay,
                "trains": self._trains,
                "promotions": self._promotions,
                "rejections": self._rejections,
                "errors": self._errors,
                "last_result": self._last_result,
                "last_error": self._last_error,
                "last_losses": self._last_losses,
                "can_rollback": self._rollback is not None,
                "promote_patience": self._patience,
                "win_streak": self._wins,
                "consumed_rows": self._consumed_rows,
                "replayed_rows": self._replayed_rows,
                "auto_rollbacks": self._auto_rollbacks,
                "last_promotion_ts": self._last_promotion_ts,
                "last_rollback_ts": self._last_rollback_ts,
                "watch_armed": self._watch is not None,
                "watch_rows": self._watch["rows"]
                if self._watch is not None else 0,
                "role": ("standby" if self._standby else "active")
                if self._lease_ttl > 0 else "solo",
                "lease_epoch": self._lease_epoch,
                "lease_holder": self._holder
                if self._lease_ttl > 0 else None,
                "lease_lost": self._lease_lost,
                "heartbeats": {
                    "interval_s": self._hb_interval,
                    "sent": self._hb_sent,
                    "errors": self._hb_errors,
                },
            }
        if self._store is not None:
            st["store"] = self._store.state()
        st["buffered_rows"] = self.buffer.rows
        st["shadow_rows"] = self.buffer.shadow_rows
        st["dropped_rows"] = self.buffer.dropped_rows
        st["total_ingested_rows"] = self.buffer.total_rows
        st["model_version"] = self._booster.inner.model_version
        return st

    # -------------------------------------------------------------- shutdown
    def close(self, timeout: Optional[float] = None, *,
              release_lease: bool = True) -> None:
        """Stop the worker (the in-flight cycle finishes). Idempotent.

        ``release_lease=False`` leaves the lease to expire on its own (a
        crash: the standby waits out the ttl), and the fence stays armed,
        so this instance's late publishes still raise
        ``StaleLeaseError`` like a real zombie's."""
        with self._lock:
            self._stopped = True
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        if self._lease_ttl > 0 and self._store is not None \
                and release_lease:
            with self._lock:
                epoch = self._lease_epoch
                active = not self._standby
            if active:
                try:
                    self._store.release_lease(self._holder, epoch)
                    self._store.clear_fence()
                except Exception as exc:
                    Log.warning("fleet: lease release failed: %s: %s",
                                type(exc).__name__, exc)

    def __enter__(self) -> "OnlineTrainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
