"""Deterministic fault injection for the fleet layer (PyTorch port of
``lightgbm_tpu/fleet/chaos.py``).

The durability claims in this package (torn appends are skipped on
replay, a zombie trainer's publishes are fenced, a replica survives
dropped connections and torn artifact reads) are only claims until a
test can *make* those faults happen on demand. This module is the
switchboard: production code calls :func:`hit` at named failure points,
and a test installs a :class:`FaultPlan` — an explicit, seeded,
per-point FIFO of actions — so every fault fires at a deterministic
call count, never off a wall-clock race.

Failure points (the strings passed to :func:`hit`):

- ``store/append``        before an event-log line is written
- ``store/publish``       after artifact replace, before the event lands
- ``store/artifact_read`` before a model artifact is read back
- ``store/lease``         before a lease record is replaced
- ``transport/request``   client side, before an HTTP request is issued
- ``transport/serve``     server side, before a /fleet response is sent

Actions are tuples: ``("raise", exc)`` raises inside :func:`hit`;
``("sleep", seconds)`` stalls inside :func:`hit` (slow store / slow
response); ``("torn", fraction)`` is RETURNED to the caller, which is
responsible for truncating its write/read/response body to that
fraction — tearing is inherently caller-specific. Two fleet-control
kinds ride the same queues: ``("partition", n)`` makes the point fail
``n`` CONSECUTIVE times (it raises and re-queues itself at the front
with ``n-1``, so one action simulates an endpoint dark for a whole
window of requests, not one random drop); ``("reorder",)`` is returned
to the caller like torn — the append path parks the entry it was about
to write (:meth:`FaultPlan.park`) and lands it right AFTER its
successor (:meth:`FaultPlan.take_parked`), the delayed-write-past-its-
successor race a replicated log must tolerate. With no plan installed
``hit`` is one global load and a None check, so the hooks cost nothing
in production.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..obs import telemetry

#: every failure point production code calls hit() with, for validation
FAILURE_POINTS = (
    "store/append",
    "store/publish",
    "store/artifact_read",
    "store/lease",
    "transport/request",
    "transport/serve",
)


class InjectedFault(Exception):
    """Default exception for ("raise", ...) actions — distinguishable
    from real faults in test assertions and log lines."""


Action = Tuple[Any, ...]


class FaultPlan:
    """A per-point FIFO of fault actions, consumed by :func:`hit`.

    Build one explicitly (``FaultPlan({"store/append": [("torn", 0.5)]})``)
    when a test needs one exact fault at one exact call, or with
    :meth:`seeded` when a scenario wants *many* faults whose mix is
    reproducible from a single integer. Consumption is thread-safe; the
    schedule itself is fixed at construction so two runs with the same
    plan inject identically regardless of thread timing per point.
    """

    def __init__(self, actions: Optional[Dict[str, Sequence[Action]]] = None
                 ) -> None:
        self._lock = threading.Lock()
        self._queues: Dict[str, List[Action]] = {}
        self._injected: Dict[str, int] = {}
        self._parked: Dict[str, List[Any]] = {}
        for point, acts in (actions or {}).items():
            self.add(point, *acts)

    #: seeded() default mix — frozen so pre-existing seeds keep their
    #: byte-identical schedules; scenarios opt into the control-plane
    #: kinds with kinds=KINDS_ALL
    KINDS_DEFAULT = ("raise", "torn", "sleep")
    KINDS_ALL = ("raise", "torn", "sleep", "partition", "reorder")

    @classmethod
    def seeded(cls, seed: int, counts: Dict[str, int], *,
               sleep_s: float = 0.05,
               kinds: Sequence[str] = KINDS_DEFAULT) -> "FaultPlan":
        """A plan with ``counts[point]`` faults per point, the action mix
        drawn deterministically from ``random.Random(seed)``. Same seed +
        counts → byte-identical schedule, independent of wall clock.
        ``kinds`` selects the mix (uniform over the tuple): the default
        keeps the original raise/torn/sleep stream so existing seeds
        reproduce; :data:`KINDS_ALL` adds partition/reorder for the
        write-surface drills."""
        rng = random.Random(int(seed))
        plan = cls()
        kinds = tuple(kinds)
        legacy = kinds == cls.KINDS_DEFAULT
        for point in sorted(counts):
            for _ in range(int(counts[point])):
                roll = rng.random()
                if legacy:
                    # the frozen original thresholds + draw order: same
                    # seed → the exact schedule every pre-existing
                    # chaos scenario was tuned against
                    kind = ("raise" if roll < 0.4
                            else "torn" if roll < 0.7 else "sleep")
                else:
                    kind = kinds[min(int(roll * len(kinds)),
                                     len(kinds) - 1)]
                if kind == "raise":
                    act: Action = ("raise",
                                   InjectedFault("chaos@%s" % point))
                elif kind == "torn":
                    act = ("torn", 0.1 + 0.8 * rng.random())
                elif kind == "partition":
                    act = ("partition", 1 + int(rng.random() * 3))
                elif kind == "reorder":
                    act = ("reorder",)
                else:
                    act = ("sleep", sleep_s * rng.random())
                plan.add(point, act)
        return plan

    def add(self, point: str, *actions: Action) -> "FaultPlan":
        if point not in FAILURE_POINTS:
            raise ValueError("unknown chaos point %r (known: %s)"
                             % (point, ", ".join(FAILURE_POINTS)))
        with self._lock:
            self._queues.setdefault(point, []).extend(actions)
        return self

    def push_front(self, point: str, *actions: Action) -> "FaultPlan":
        """Queue ``actions`` ahead of everything pending at ``point`` —
        how a ("partition", n) action re-queues its remaining n-1
        failures so they hit the very next requests."""
        if point not in FAILURE_POINTS:
            raise ValueError("unknown chaos point %r (known: %s)"
                             % (point, ", ".join(FAILURE_POINTS)))
        with self._lock:
            self._queues.setdefault(point, [])[:0] = list(actions)
        return self

    def next_action(self, point: str) -> Optional[Action]:
        with self._lock:
            queue = self._queues.get(point)
            if not queue:
                return None
            self._injected[point] = self._injected.get(point, 0) + 1
            return queue.pop(0)

    def park(self, point: str, obj: Any) -> None:
        """Reorder support: hold ``obj`` (an event the caller was about
        to write) until the next write at ``point`` lands, then the
        caller drains it via :meth:`take_parked` — the parked entry hits
        the log AFTER its successor."""
        with self._lock:
            self._parked.setdefault(point, []).append(obj)

    def take_parked(self, point: str) -> List[Any]:
        with self._lock:
            return self._parked.pop(point, [])

    def pending(self) -> Dict[str, int]:
        with self._lock:
            return {p: len(q) for p, q in self._queues.items() if q}

    def injected(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._injected)


#: the installed plan; None (the fast path) outside chaos tests
_active: Optional[FaultPlan] = None
_active_lock = threading.Lock()


def install(plan: FaultPlan) -> None:
    global _active
    with _active_lock:
        _active = plan


def uninstall() -> None:
    global _active
    with _active_lock:
        _active = None


class inject:
    """``with chaos.inject(plan): ...`` — install for the block, always
    uninstall after, so a failing test can't leak faults into the next."""

    def __init__(self, plan: FaultPlan) -> None:
        self._plan = plan

    def __enter__(self) -> FaultPlan:
        install(self._plan)
        return self._plan

    def __exit__(self, *exc) -> None:
        uninstall()


def active() -> Optional[FaultPlan]:
    return _active


def hit(point: str) -> Optional[Action]:
    """Consume one fault at ``point`` if a plan is installed.

    Raises for ("raise", exc) and ("partition", n) actions (a partition
    additionally re-queues itself at the front with n-1, so the point
    stays dark for n consecutive calls), stalls for ("sleep", s)
    actions, and returns ("torn", fraction) / ("reorder",) for the
    caller to apply. Returns None (and does nothing) when no plan is
    installed or the point's queue is empty."""
    plan = _active
    if plan is None:
        return None
    act = plan.next_action(point)
    if act is None:
        return None
    telemetry.count("chaos/injected/" + point)
    kind = act[0]
    if kind == "raise":
        exc = act[1]
        if isinstance(exc, BaseException):
            raise exc
        raise exc("chaos@%s" % point)
    if kind == "partition":
        remaining = int(act[1])
        if remaining > 1:
            plan.push_front(point, ("partition", remaining - 1))
        raise InjectedFault("partition@%s (%d request(s) left dark)"
                            % (point, remaining))
    if kind == "sleep":
        time.sleep(float(act[1]))
        return None
    return act
