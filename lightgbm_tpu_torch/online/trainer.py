"""Continual refit with a shadow-scoring promotion gate (PyTorch port of
``lightgbm_tpu/online/trainer.py`` without the fleet).

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

The fleet knobs of the JAX trainer (``store``, ``replay``, ``holder_id``,
``lease_ttl_s``, ``compact_bytes``, ``keep_artifacts``, ``snapshot_rows``,
``heartbeat_interval_s``, ``advertise_url``) raise when set: the fleet is
queue A item 8 of ROADMAP.md.

Telemetry: ``online/ingested_rows``, ``online/train_runs``,
``online/promotions``, ``online/rejections``, ``online/train_errors``
counters; ``online/train_ms``, ``online/shadow_ms``,
``online/promote_swap_ms`` histograms; ``online/*`` spans go to the
port's span recorder (a no-op until the observability slice).
"""
from __future__ import annotations

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
        from ..learner import _refuse

        fleet = [name for name, on in (
            ("store", store is not None), ("replay", not replay),
            ("holder_id", holder_id is not None),
            ("lease_ttl_s", lease_ttl_s > 0),
            ("compact_bytes", bool(compact_bytes)),
            ("keep_artifacts", bool(keep_artifacts)),
            ("snapshot_rows", bool(snapshot_rows)),
            ("heartbeat_interval_s", heartbeat_interval_s > 0),
            ("advertise_url", bool(advertise_url))) if on]
        if fleet:
            _refuse("the online trainer's fleet settings (%s)"
                    % ", ".join(fleet), "A12, queue A item 8")
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
        # hysteresis win-streak, consumed-row count and the
        # post-promotion live watch
        self._wins = 0
        self._consumed_rows = 0
        self._auto_rollbacks = 0
        self._last_promotion_ts = 0.0
        self._last_rollback_ts = 0.0
        self._watch: Optional[Dict[str, Any]] = None
        self._watch_chunks: List[Tuple[np.ndarray, np.ndarray]] = []
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
        training."""
        X_arr = np.asarray(X, np.float64)
        y_arr = np.asarray(y, np.float64).ravel()
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

    # --------------------------------------------------------------- worker
    def _worker(self) -> None:
        # poll granularity: the interval trigger when set, else a coarse
        # tick — row triggers arrive via notify so the tick only bounds
        # shutdown latency
        poll = self._interval if self._interval > 0 else 0.5
        while True:
            with self._lock:
                if self._stopped:
                    return
                self._lock.wait(timeout=poll)
                if self._stopped:
                    return
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

    # ---------------------------------------------------------------- cycle
    def run_once(self) -> str:
        """One synchronous train cycle: drain the buffer, build a
        candidate, shadow-score it, promote or reject. Returns
        ``"promoted"``, ``"rejected"``, ``"deferred"`` (shadow win
        banked toward ``promote_patience``, no swap yet) or
        ``"skipped"`` (not enough data). Tests call this directly with
        ``start=False``."""
        with self._lock:
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
            with self._lock:
                self._consumed_rows += int(len(y))
            if accept:
                with self._lock:
                    self._wins += 1
                    wins = self._wins
                if wins < self._patience:
                    # hysteresis: a win is banked, not acted on, until
                    # the streak reaches promote_patience
                    telemetry.count("online/deferrals")
                    self._finish("deferred", losses)
                    return "deferred"
                with self._lock:
                    self._wins = 0
                self._promote(candidate, builder.serialize(candidate), src)
                self._finish("promoted", losses)
                return "promoted"
            telemetry.count("online/rejections")
            with self._lock:
                self._rejections += 1
                self._wins = 0   # a loss breaks the streak
            self._finish("rejected", losses)
            return "rejected"

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
                "auto_rollbacks": self._auto_rollbacks,
                "last_promotion_ts": self._last_promotion_ts,
                "last_rollback_ts": self._last_rollback_ts,
                "watch_armed": self._watch is not None,
                "watch_rows": self._watch["rows"]
                if self._watch is not None else 0,
                "role": "solo",
            }
        st["buffered_rows"] = self.buffer.rows
        st["shadow_rows"] = self.buffer.shadow_rows
        st["dropped_rows"] = self.buffer.dropped_rows
        st["total_ingested_rows"] = self.buffer.total_rows
        st["model_version"] = self._booster.inner.model_version
        return st

    # -------------------------------------------------------------- shutdown
    def close(self, timeout: Optional[float] = None) -> None:
        """Stop the worker (the in-flight cycle finishes). Idempotent."""
        with self._lock:
            self._stopped = True
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)

    def __enter__(self) -> "OnlineTrainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
