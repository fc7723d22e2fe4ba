"""Run counters for the serving path (PyTorch port of ``lightgbm_tpu/obs.py``).

Only what the serving modules call is here: the process-global
:data:`telemetry` registry (counters, gauges, timers, histograms and
structured records), :func:`monotonic`, :func:`wall` and the log-bucketed
:class:`Histogram` the MicroBatcher keeps its latency window in. Spans are
a no-op (:data:`tracer`) until the observability slice ports
``obs_trace.py``; the serving code already opens them, so that slice only
has to fill in the recorder.

All updates run on the host and never synchronise the device.
"""
from __future__ import annotations

import contextlib
import re
import threading
import time
from bisect import bisect_left
from collections import defaultdict
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple


def monotonic() -> float:
    """Monotonic timestamp (``perf_counter``) for spans whose start and
    end live in different frames (the MicroBatcher's submit->delivery
    latency)."""
    return time.perf_counter()


@contextlib.contextmanager
def wall(name: str) -> Iterator[None]:
    """Host wall timer around a block, recorded under ``wall/<name>``.
    Device work inside the block is only enqueued, not waited for."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        telemetry.add_time("wall/" + name, time.perf_counter() - t0)


def _jsonable(v):
    """Coerce numpy scalars / arrays so snapshot() survives json.dumps."""
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "item"):
        try:
            return v.item()
        except (TypeError, ValueError, RuntimeError):
            pass
    if hasattr(v, "tolist"):
        return v.tolist()
    return repr(v)


def _log_bounds(lo: float = 2.0 ** -10, hi: float = 2.0 ** 20,
                factor: float = 2.0) -> Tuple[float, ...]:
    """Geometric bucket upper bounds lo, lo*f, ..., >= hi."""
    bounds = []
    b = float(lo)
    while b <= hi * (1 + 1e-12):
        bounds.append(b)
        b *= factor
    return tuple(bounds)


# powers of two from ~0.001 to ~1M: one ladder covers latencies in ms
# and batch sizes in rows at ~2x resolution
DEFAULT_HIST_BOUNDS = _log_bounds()

_PCTS = ((0.50, "p50"), (0.90, "p90"), (0.99, "p99"), (0.999, "p999"))


class Histogram:
    """Log-bucketed histogram: exact counts per geometric bucket,
    percentiles by linear interpolation inside the hit bucket. Not
    internally locked: registry instances are guarded by the Telemetry
    lock, standalone users (the MicroBatcher window) bring their own."""

    __slots__ = ("bounds", "counts", "count", "sum")

    def __init__(self, bounds: Optional[Sequence[float]] = None) -> None:
        self.bounds = tuple(bounds) if bounds else DEFAULT_HIST_BOUNDS
        self.counts = [0] * (len(self.bounds) + 1)   # last = +Inf overflow
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.counts[bisect_left(self.bounds, v)] += 1   # le-inclusive

    def percentile(self, q: float) -> float:
        """q in [0, 1] (Prometheus histogram_quantile semantics)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum, lo = 0, 0.0
        for i, hi in enumerate(self.bounds):
            c = self.counts[i]
            if c > 0 and cum + c >= target:
                return lo + (hi - lo) * ((target - cum) / c)
            cum += c
            lo = hi
        return self.bounds[-1]   # overflow bucket: clamp to top bound

    def snapshot(self) -> Dict[str, Any]:
        snap: Dict[str, Any] = {"count": self.count,
                                "sum": round(self.sum, 6)}
        for q, label in _PCTS:
            snap[label] = round(self.percentile(q), 6)
        return snap


class Telemetry:
    """Process-global registry of counters, gauges, timers, histograms
    and records. Thread-safe: every mutation is a dict update under one
    lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = defaultdict(int)
        self._gauges: Dict[str, Any] = {}
        self._timers: Dict[str, float] = defaultdict(float)
        self._records: Dict[str, List[dict]] = defaultdict(list)
        self._hists: Dict[str, Histogram] = {}

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += int(n)

    def gauge(self, name: str, value) -> None:
        with self._lock:
            self._gauges[name] = _jsonable(value)

    def add_time(self, name: str, seconds: float) -> None:
        with self._lock:
            self._timers[name] += float(seconds)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(value)

    @contextlib.contextmanager
    def timed_observe(self, name: str) -> Iterator[None]:
        """Observe the block's host wall time in milliseconds into
        histogram ``name`` (online train cycles, promotion swaps)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, (time.perf_counter() - t0) * 1e3)

    def record(self, name: str, dedupe_key=None, **payload) -> None:
        """Append a structured event to the ``name`` list; with
        ``dedupe_key`` an event with the same key is kept once."""
        with self._lock:
            lst = self._records[name]
            if dedupe_key is not None:
                key = _jsonable(dedupe_key)
                if any(r.get("_key") == key for r in lst):
                    return
                payload = dict(payload, _key=key)
            lst.append(_jsonable(payload))

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def records(self, name: str) -> List[dict]:
        with self._lock:
            return [{k: v for k, v in r.items() if k != "_key"}
                    for r in self._records.get(name, [])]

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable view of everything recorded so far."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "timers": {k: round(v, 6) for k, v in self._timers.items()},
                "records": {k: [{a: b for a, b in r.items() if a != "_key"}
                                for r in v]
                            for k, v in self._records.items()},
                "histograms": {k: h.snapshot()
                               for k, h in self._hists.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timers.clear()
            self._records.clear()
            self._hists.clear()


telemetry = Telemetry()


def safe_metric_part(part: str, max_len: int = 48) -> str:
    """Untrusted id (an HTTP tenant name) -> safe registry-key segment:
    alnum/dash/underscore only, bounded length, never empty."""
    s = re.sub(r"[^a-zA-Z0-9_\-]", "_", str(part))[:max_len]
    return s or "_"


class _NoSpans:
    """Span recorder stand-in: every span is a no-op context manager and
    ``serve_on`` is False, so callers skip trace-id bookkeeping."""

    serve_on = False

    @contextlib.contextmanager
    def span(self, name: str, **_kwargs) -> Iterator[None]:
        yield

    def record(self, *_args, **_kwargs) -> None:
        pass


tracer = _NoSpans()
