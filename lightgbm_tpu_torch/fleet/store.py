"""Durable fleet state: one directory per served model (PyTorch port of
``lightgbm_tpu/fleet/store.py``; the files are byte-compatible with it).

    <root>/<model_id>/events.jsonl      append-only event log
    <root>/<model_id>/models/v%06d.txt  immutable whole-model artifacts
    <root>/<model_id>/lease.json        trainer lease (holder + epoch)

The event log rides the run ledger's substrate
(:func:`~lightgbm_tpu_torch.obs_ledger.append_jsonl` /
:func:`~lightgbm_tpu_torch.obs_ledger.read_jsonl`): every append is ONE write
call of one JSON line, so concurrent writers (HTTP ingest handlers, the
trainer worker) interleave whole lines and a SIGKILL mid-append leaves at
most one partial line, skipped on read. Event kinds:

- ``ingest``: one labeled traffic chunk (rows + labels). Replayed on
  boot so a restarted server resumes its shadow window and training
  buffer instead of cold-starting.
- ``gate``: one promotion-gate cycle (result, consecutive-win count for
  promotion hysteresis, the consumed-row watermark separating
  already-trained traffic from still-buffered traffic).
- ``publish``: a whole model became servable under a monotonically
  increasing **version token**. The artifact is written to a temp file
  and ``os.replace``d into place BEFORE the event lands, so a replica
  that sees the event always reads a complete model — whole historical
  models only, never a torn artifact. The event records the artifact's
  ``sha256`` + byte length (verified on load) and the publisher's
  ``lease_epoch`` (zombie fencing, below).
- ``compact``: a snapshot record (watermark, win streak, row base,
  version/epoch floors) standing in for every event truncated before it
  — replay from a compacted log is bit-identical to the full log.

Rollbacks are publishes too (``event="rollback"``): replicas converge by
always applying the newest version token, so a rollback distributes
exactly like a promotion.

**Failover.** Exactly one trainer may publish at a time. The lease file
holds ``{holder, epoch, expires_ts}`` and is swapped atomically
(``os.replace``); every acquisition — takeover OR re-acquisition —
bumps ``epoch``, the fencing token. A trainer arms its store with
:meth:`set_fence`; :meth:`publish` then re-reads the lease and refuses
(:class:`StaleLeaseError`) unless holder+epoch still match, so a paused
("zombie") trainer that lost its lease cannot publish over its
successor. Readers additionally reject any publish event whose non-zero
epoch is below an epoch already seen earlier in the log (a zombie write
that raced the fence check on another host). Epoch 0 marks an UNFENCED
publisher (leasing disabled) and is exempt from that rejection —
turning ``fleet_lease_ttl_s`` off after a fenced tenure must not
silently drop every later publish (it is warned about and counted
instead).

**Cross-process writes.** The failover feature makes the log genuinely
multi-writer: a standby trainer persists every ingest chunk to the same
``events.jsonl`` the active holder appends to. Single appends interleave
safely (one write call per line), but compaction's snapshot→rewrite and
the open-time torn-tail repair do not — so every append, the repair and
the whole compaction critical section hold a cross-process writer mutex
(``flock`` on the ``events.jsonl.lock`` sidecar, released by the kernel
if the holder dies). Replica-role opens pass ``read_only=True`` and
never mutate the log at all.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

try:
    import fcntl   # POSIX: cross-process writer mutex via flock
except ImportError:   # pragma: no cover — non-POSIX fallback below
    fcntl = None

from .. import obs
from ..obs import telemetry
from ..obs_ledger import append_jsonl, read_jsonl
from ..utils.log import LightGBMError, Log
from . import chaos

#: schema version stamped on every event; readers skip newer majors
STORE_VERSION = 1

#: publish-event reasons (reporting only — replicas apply them all)
PUBLISH_EVENTS = ("boot", "promotion", "rollback")

_ARTIFACT_FMT = "v%06d.txt"
_SNAPSHOT_FMT = "s%06d.json"

#: a lease-acquisition guard file older than this is a crashed acquirer
_GUARD_STALE_S = 5.0


def _verify_blob(what: str, want_sha: Optional[str], want_bytes: int,
                 data: bytes) -> None:
    """sha256 + byte-length check shared by model artifacts and buffer
    snapshots (and the HTTP transport's downloaded copies of both).
    ``want_sha`` None passes (records from before checksums). Raises
    :class:`CorruptArtifactError` on mismatch."""
    if want_sha is None:
        return
    if want_bytes >= 0 and len(data) != want_bytes:
        raise CorruptArtifactError(
            "%s truncated: %d bytes, event says %d"
            % (what, len(data), want_bytes))
    got = hashlib.sha256(data).hexdigest()
    if got != want_sha:
        raise CorruptArtifactError(
            "%s sha256 mismatch: %s != %s" % (what, got, want_sha))


def _verify_artifact(event: Dict[str, Any], data: bytes) -> None:
    """Check artifact ``data`` against its publish event's sha256 + byte
    length. Events from before checksums carry no ``sha256`` and pass.
    Raises :class:`CorruptArtifactError` on mismatch."""
    _verify_blob("artifact v%d" % int(event.get("version", 0)),
                 event.get("sha256"), int(event.get("bytes", -1)), data)


def _verify_snapshot(record: Dict[str, Any], data: bytes) -> None:
    """Check snapshot ``data`` against its compact record's ``snapshot``
    section (shared with the HTTP transport's downloaded copies)."""
    snap = record.get("snapshot") or {}
    _verify_blob("snapshot s%06d" % int(snap.get("id", 0)),
                 snap.get("sha256"), int(snap.get("bytes", -1)), data)


class StaleLeaseError(LightGBMError):
    """A fenced publish was refused: the store's lease is no longer held
    by this trainer at this epoch (another trainer took over)."""


class CorruptArtifactError(LightGBMError):
    """A model artifact failed its publish-event sha256/length check."""


class FleetStore:
    """Durable event log + model-artifact directory for one served model.

    Thread-safe: appends arrive from HTTP handler threads (ingest) and
    the trainer worker (gate/publish); reads come from replica-watcher
    threads and boot-time replay. The in-memory counters exist only for
    cheap ``state()`` snapshots — the file is the source of truth.

    ``orphan_grace_s``: on open, artifact files newer than every publish
    event (a publisher died between ``os.replace`` and its event append)
    are reaped — but only when older than this grace, so opening a store
    never races another process's in-flight publish.

    ``read_only``: a replica-role open over a shared filesystem. Skips
    the destructive open-time maintenance (torn-tail repair, orphan
    reaping) a pure reader must never run against a live writer's files.
    """

    def __init__(self, root: str, model_id: str = "default", *,
                 orphan_grace_s: float = 60.0,
                 read_only: bool = False) -> None:
        model_id = str(model_id)
        if not model_id or "/" in model_id or model_id.startswith("."):
            raise LightGBMError("fleet model_id must be a plain name, "
                                "got %r" % model_id)
        self._root = os.path.abspath(root)
        self._model_id = model_id
        self._dir = os.path.join(self._root, model_id)
        self._events_path = os.path.join(self._dir, "events.jsonl")
        self._models_dir = os.path.join(self._dir, "models")
        self._lease_path = os.path.join(self._dir, "lease.json")
        self._heartbeats_dir = os.path.join(self._dir, "heartbeats")
        self._snapshots_dir = os.path.join(self._dir, "snapshots")
        os.makedirs(self._models_dir, exist_ok=True)
        # guards version allocation, the fence, compaction's rewrite and
        # the state counters; re-entrant because publish/compact append
        # through the same locked _append as the HTTP ingest path
        self._lock = threading.RLock()
        self._fence: Optional[Tuple[str, int]] = None
        self._ingest_rows = 0
        self._publishes = 0
        self._compactions = 0
        self._last_compact_ts = 0.0
        self._orphans_reaped = 0
        self._stale_seen: set = set()
        self._corrupt_seen: set = set()
        self._warned_unfenced = False
        self._read_only = bool(read_only)
        if not self._read_only:
            # under the writer mutex: a tail that is torn while no other
            # writer can be mid-append is genuinely dead, never a
            # partially-visible in-flight line of a live process
            with self._writer_mutex():
                self._repair_torn_tail()
        valid, max_version, _max_epoch, _stale = self._scan_publishes()
        self._last_version = max_version
        if not self._read_only:
            self._reap_orphans(max_version, float(orphan_grace_s))

    # ---------------------------------------------------------------- identity
    @property
    def root(self) -> str:
        return self._root

    @property
    def model_id(self) -> str:
        return self._model_id

    @property
    def events_path(self) -> str:
        return self._events_path

    def log_bytes(self) -> int:
        try:
            return os.path.getsize(self._events_path)
        except OSError:
            return 0

    # ----------------------------------------------------------------- append
    def _stamp(self, kind: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        entry = {"v": STORE_VERSION, "kind": kind,
                 "ts": time.time()}
        entry.update(payload)
        return entry

    def _repair_torn_tail(self) -> None:
        """Truncate a partial final line (a writer SIGKILLed mid-append).
        Readers already skip it, but without the truncation the NEXT
        append would glue onto the torn prefix and both lines would read
        back as one corrupt line — a restarted trainer's first event
        silently lost. Runs once, on open."""
        try:
            size = os.path.getsize(self._events_path)
        except OSError:
            return
        if size == 0:
            return
        with open(self._events_path, "rb+") as f:
            f.seek(-1, os.SEEK_END)
            if f.read(1) == b"\n":
                return
            # walk back block-wise to the last complete line's newline
            pos, keep = size, 0
            while pos > 0:
                step = min(4096, pos)
                pos -= step
                f.seek(pos)
                idx = f.read(step).rfind(b"\n")
                if idx >= 0:
                    keep = pos + idx + 1
                    break
            f.truncate(keep)
        telemetry.count("fleet/torn_tail_repaired")
        Log.warning("fleet: truncated %d-byte torn tail line in %s",
                    size - keep, self._events_path)

    @contextmanager
    def _writer_mutex(self):
        """Cross-process mutex over every ``events.jsonl`` mutation.

        The in-process RLock cannot serialize a standby trainer's ingest
        appends (another process, its own store instance) against this
        process's compaction rewrite — a line appended between the scan
        and the ``os.replace`` would die with the old inode. So every
        append, the open-time torn-tail repair and the whole compaction
        critical section hold an exclusive ``flock`` on the
        ``events.jsonl.lock`` sidecar: it blocks until free and the
        kernel releases it when the holder dies, so there is no stale
        state to break. Non-POSIX fallback: the lease-style O_EXCL
        guard, best-effort (proceeds with a warning if never acquired).
        """
        path = self._events_path + ".lock"
        if fcntl is not None:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX)
                yield
            finally:
                os.close(fd)   # closing the fd drops the flock
            return
        held = self._guard_wait(path,   # pragma: no cover — non-POSIX
                                timeout_s=2.0 * _GUARD_STALE_S)
        if not held:   # pragma: no cover
            Log.warning("fleet: events writer guard %s stuck busy; "
                        "proceeding unserialized", path)
            yield
            return
        try:   # pragma: no cover
            yield
        finally:
            self._guard_release(path)

    def _assert_writable(self) -> None:
        if self._read_only:
            raise LightGBMError(
                "fleet store %s opened read_only (replica role) cannot "
                "append, publish or compact" % self._dir)

    def _append(self, entry: Dict[str, Any]) -> None:
        """All event appends funnel here: serialized against compaction's
        atomic rewrite (in-process by the store lock, cross-process by
        the events writer mutex), and carrying the ``store/append`` chaos
        point (a torn action writes a prefix of the line and raises — the
        simulated crash the corrupt-line skip on replay recovers from; a
        reorder action parks the line so it lands right AFTER the next
        append — the delayed-write-past-its-successor race replay's
        log-order row offsets must stay consistent under)."""
        self._assert_writable()
        with self._lock, self._writer_mutex():
            act = chaos.hit("store/append")
            if act is not None and act[0] == "torn":
                line = (json.dumps(entry, sort_keys=True)
                        + "\n").encode("utf-8")
                cut = max(1, int(len(line) * float(act[1])))
                with open(self._events_path, "ab") as f:
                    f.write(line[:cut])
                raise chaos.InjectedFault(
                    "torn append (%d/%d bytes) at %s"
                    % (cut, len(line), entry.get("kind")))
            plan = chaos.active()
            if act is not None and act[0] == "reorder" and plan is not None:
                plan.park("store/append", entry)
                return
            append_jsonl(self._events_path, entry)
            if plan is not None:
                for parked in plan.take_parked("store/append"):
                    append_jsonl(self._events_path, parked)

    def append_ingest(self, X, y) -> None:
        """Persist one labeled traffic chunk (one JSONL line). Called on
        the ingest path BEFORE the in-memory buffer push, so a crash
        after the append replays the chunk instead of losing it."""
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X[None, :]
        y = np.asarray(y, np.float64).ravel()
        self._append(self._stamp("ingest", {
            "n": int(len(y)), "rows": X.tolist(), "labels": y.tolist()}))
        with self._lock:
            self._ingest_rows += int(len(y))
        telemetry.count("fleet/ingest_rows_persisted", int(len(y)))

    def append_gate(self, result: str, wins: int, consumed_rows: int,
                    losses: Optional[Dict[str, float]] = None) -> None:
        """Persist one promotion-gate cycle: its verdict, the
        consecutive-win counter (promotion-hysteresis state a restarted
        trainer must resume), and the consumed-row watermark (rows
        ingested before it are already trained — replay keeps them out
        of the training buffer but in the shadow window)."""
        self._append(self._stamp("gate", {
            "result": str(result), "wins": int(wins),
            "consumed_rows": int(consumed_rows),
            "losses": losses}))

    # ------------------------------------------------------------------ lease
    def _read_lease(self) -> Optional[Dict[str, Any]]:
        try:
            with open(self._lease_path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        return doc if isinstance(doc, dict) else None

    def _write_lease(self, doc: Dict[str, Any]) -> None:
        chaos.hit("store/lease")
        tmp = self._lease_path + ".tmp.%d" % os.getpid()
        data = json.dumps(doc, sort_keys=True).encode("utf-8")
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            done = 0
            while done < len(data):
                done += os.write(fd, data[done:])
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, self._lease_path)

    def _guard_acquire(self, path: str) -> bool:
        """O_EXCL guard file serializing a read-modify-write across
        processes; a guard left by a crashed acquirer is broken after
        ``_GUARD_STALE_S``. Returns False when another acquirer is live
        right now (the caller treats that as guard-unavailable)."""
        for _ in range(2):
            try:
                fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL,
                             0o644)
            except FileExistsError:
                try:
                    age = time.time() - os.path.getmtime(path)
                except OSError:
                    continue
                if age > _GUARD_STALE_S:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                    continue
                return False
            os.write(fd, b"%d" % os.getpid())
            os.close(fd)
            return True
        return False

    def _guard_release(self, path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    def _guard_wait(self, path: str, timeout_s: float = 0.5) -> bool:
        """Blocking :meth:`_guard_acquire`: the guard's critical sections
        are a tiny json read+write, so a busy guard clears in
        microseconds — spin briefly instead of failing a heartbeat (and
        demoting a healthy trainer) over a concurrent standby's probe."""
        deadline = obs.monotonic() + float(timeout_s)
        while True:
            if self._guard_acquire(path):
                return True
            if obs.monotonic() >= deadline:
                return False
            time.sleep(0.01)

    def acquire_lease(self, holder: str, ttl_s: float,
                      url: Optional[str] = None) -> Optional[int]:
        """Try to take the trainer lease. Returns the new fencing epoch,
        or None while another live holder has it. EVERY successful
        acquisition — takeover of an expired lease, or re-acquisition by
        the same holder — bumps the epoch, so an epoch uniquely names
        one continuous tenure.

        ``url`` advertises the holder's serving endpoint in the lease
        record: it is the ``leader_hint`` the control plane hands to
        nodes whose labeled traffic must be forwarded to whoever can
        actually train on it."""
        holder = str(holder)
        if ttl_s <= 0:
            raise LightGBMError("lease ttl_s must be > 0, got %g" % ttl_s)
        with self._lock:
            if not self._guard_acquire(self._lease_path + ".lock"):
                return None
            try:
                cur = self._read_lease()
                now = time.time()
                if (cur is not None and cur.get("holder") != holder
                        and float(cur.get("expires_ts", 0.0)) > now):
                    return None
                epoch = int(cur.get("epoch", 0)) + 1 if cur else 1
                doc = {
                    "v": STORE_VERSION, "holder": holder, "epoch": epoch,
                    "expires_ts": now + float(ttl_s), "acquired_ts": now,
                    "pid": os.getpid()}
                if url:
                    doc["url"] = str(url)
                self._write_lease(doc)
            finally:
                self._guard_release(self._lease_path + ".lock")
        telemetry.count("fleet/lease_acquired")
        telemetry.gauge("fleet/lease_epoch", epoch)
        Log.info("fleet: %s acquired trainer lease (epoch %d, ttl %gs)",
                 holder, epoch, ttl_s)
        return epoch

    def renew_lease(self, holder: str, epoch: int, ttl_s: float,
                    url: Optional[str] = None) -> bool:
        """Heartbeat: extend the lease iff still held by ``holder`` at
        ``epoch``. An expired-but-untaken lease renews fine (the holder
        merely heartbeat late); a lease re-acquired by anyone (epoch
        moved on) does not — the caller must demote to standby.

        Runs inside the same O_EXCL guard as :meth:`acquire_lease`:
        without it, an old holder's renew racing a standby's takeover
        could read the pre-takeover lease and write it back (extended,
        old epoch) AFTER the takeover's ``os.replace``, resurrecting the
        dead epoch and flapping both trainers active/standby."""
        lock = self._lease_path + ".lock"
        with self._lock:
            if not self._guard_wait(lock):
                Log.warning("fleet: lease renewal for %s blocked by a "
                            "concurrent acquirer; demoting", holder)
                return False
            try:
                cur = self._read_lease()
                if (cur is None or cur.get("holder") != str(holder)
                        or int(cur.get("epoch", -1)) != int(epoch)):
                    return False
                now = time.time()
                cur["expires_ts"] = now + float(ttl_s)
                if url:
                    # a holder that learned its bound address after the
                    # acquisition (ephemeral port) advertises it here
                    cur["url"] = str(url)
                self._write_lease(cur)
            finally:
                self._guard_release(lock)
        return True

    def release_lease(self, holder: str, epoch: int) -> bool:
        """Clean handoff: expire the lease immediately (epoch kept, so
        the next acquirer still bumps past it). No-op unless still held
        by ``holder`` at ``epoch``. Guarded like :meth:`renew_lease` —
        an unguarded release racing a takeover could clobber the new
        holder's lease with an expired copy of the old one."""
        lock = self._lease_path + ".lock"
        with self._lock:
            if not self._guard_wait(lock):
                Log.warning("fleet: lease release for %s blocked by a "
                            "concurrent acquirer; leaving it to expire",
                            holder)
                return False
            try:
                cur = self._read_lease()
                if (cur is None or cur.get("holder") != str(holder)
                        or int(cur.get("epoch", -1)) != int(epoch)):
                    return False
                cur["expires_ts"] = 0.0
                cur["released_ts"] = time.time()
                self._write_lease(cur)
            finally:
                self._guard_release(lock)
        return True

    def lease_state(self) -> Dict[str, Any]:
        """JSON-serializable lease summary (surfaced on /healthz)."""
        cur = self._read_lease()
        if cur is None:
            return {"held": False, "holder": None, "epoch": 0,
                    "expires_ts": 0.0, "url": None}
        expires = float(cur.get("expires_ts", 0.0))
        return {
            "held": expires > time.time(),
            "holder": cur.get("holder"),
            "epoch": int(cur.get("epoch", 0)),
            "expires_ts": expires,
            "url": cur.get("url"),
        }

    def set_fence(self, holder: str, epoch: int) -> None:
        """Arm publish fencing: every later :meth:`publish` re-checks the
        lease against this (holder, epoch) and stamps the epoch into the
        publish event."""
        with self._lock:
            self._fence = (str(holder), int(epoch))

    def clear_fence(self) -> None:
        with self._lock:
            self._fence = None

    # ---------------------------------------------------------------- publish
    def publish(self, model_str: str, event: str = "promotion",
                meta: Optional[Dict[str, Any]] = None, *,
                fence: Optional[Tuple[str, int]] = None) -> int:
        """Publish one whole model under the next version token.

        The artifact is written to a temp path and ``os.replace``d (atomic
        on POSIX) before the publish event is appended — a watcher that
        sees the event can always read the complete artifact. The event
        carries the artifact's sha256 + byte length (verified by
        :meth:`load_publish`) and the publisher's fencing epoch. When a
        fence is armed and the lease moved on, raises
        :class:`StaleLeaseError` BEFORE anything is written. Returns the
        allocated version token.

        ``fence`` is a per-call (holder, epoch) override for publishes
        relayed on behalf of a REMOTE trainer (``POST /fleet/publish``):
        the remote writer's claimed identity is checked against the
        lease exactly like the local fence, without touching whatever
        fence this process's own trainer armed via :meth:`set_fence`.
        Epoch <= 0 in the override means an unfenced remote publisher
        (same contract as local epoch-0 publishes)."""
        if event not in PUBLISH_EVENTS:
            raise LightGBMError("publish event must be one of %s, got %r"
                                % ("|".join(PUBLISH_EVENTS), event))
        self._assert_writable()
        with self._lock:
            eff_fence = self._fence
            if fence is not None:
                eff_fence = ((str(fence[0]), int(fence[1]))
                             if int(fence[1]) > 0 else None)
            epoch = 0
            if eff_fence is not None:
                lease = self._read_lease()
                if (lease is None
                        or lease.get("holder") != eff_fence[0]
                        or int(lease.get("epoch", -1)) != eff_fence[1]):
                    telemetry.count("fleet/stale_publishes_blocked")
                    raise StaleLeaseError(
                        "publish fenced off: lease now %r, this publisher "
                        "held %r" % (lease, eff_fence))
                epoch = eff_fence[1]
            # a previous active trainer (another process, another store
            # instance over the same dir) may have published since this
            # store was opened: re-read the allocation floor from the log
            # so a standby that takes over never reuses a version token
            _valid, max_version, max_epoch, _stale = self._scan_publishes()
            if max_version > self._last_version:
                self._last_version = max_version
            if epoch == 0 and max_epoch > 0:
                # unfenced publish into a log with fenced history:
                # leasing was on once and is off now — readers apply the
                # publish (epoch 0 is exempt from stale rejection) but
                # the likely misconfiguration must be loud
                telemetry.count("fleet/unfenced_publishes")
                if not self._warned_unfenced:
                    self._warned_unfenced = True
                    Log.warning(
                        "fleet: unfenced publish (lease epoch 0) into a "
                        "store whose log has fenced publishes up to "
                        "epoch %d — was fleet_lease_ttl_s disabled on "
                        "purpose?", max_epoch)
            version = self._last_version + 1
            name = _ARTIFACT_FMT % version
            final = os.path.join(self._models_dir, name)
            tmp = final + ".tmp.%d" % os.getpid()
            data = model_str.encode("utf-8")
            view = memoryview(data)
            fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
            try:
                done = 0
                while done < len(view):
                    done += os.write(fd, view[done:])
                os.fsync(fd)
            finally:
                os.close(fd)
            os.replace(tmp, final)
            # the crash-between-replace-and-event window orphan reaping
            # covers; a ("raise",...) action here leaves exactly that
            chaos.hit("store/publish")
            self._append(self._stamp("publish", {
                "version": version, "artifact": name, "event": event,
                "sha256": hashlib.sha256(data).hexdigest(),
                "bytes": len(data), "lease_epoch": epoch,
                "meta": dict(meta) if meta else None}))
            self._last_version = version
            self._publishes += 1
        telemetry.count("fleet/publishes")
        telemetry.gauge("fleet/published_version", version)
        telemetry.gauge("fleet/events_log_bytes", self.log_bytes())
        return version

    # ------------------------------------------------------------------ read
    def events(self, kind: Optional[str] = None) -> Iterator[Dict[str, Any]]:
        """Events oldest-first (corrupt/partial lines skipped)."""
        for e in read_jsonl(self._events_path, max_version=STORE_VERSION):
            if kind is None or e.get("kind") == kind:
                yield e

    def _scan_publishes(self) -> Tuple[List[Dict[str, Any]], int, int,
                                       List[Dict[str, Any]]]:
        """One pass over the log → (valid publishes in append order,
        max version over ALL publishes incl. stale + compact floor,
        max epoch, stale publishes).

        A publish is STALE when its NON-ZERO lease epoch is below an
        epoch already seen earlier in the log — a zombie trainer's write
        that raced the fence. Epoch 0 marks an unfenced publisher
        (leasing disabled) and is exempt: an operator turning
        ``fleet_lease_ttl_s`` off after a fenced tenure must not have
        every later publish silently dropped forever. Stale versions
        still raise the allocation floor (tokens are never reused) but
        are never applied. Compact records carry the floors for
        everything they truncated."""
        valid: List[Dict[str, Any]] = []
        stale: List[Dict[str, Any]] = []
        max_version = 0
        max_epoch = 0
        for e in self.events():
            kind = e.get("kind")
            if kind == "compact":
                max_version = max(max_version,
                                  int(e.get("last_version", 0)))
                max_epoch = max(max_epoch, int(e.get("lease_epoch", 0)))
                continue
            if kind != "publish":
                continue
            v = e.get("version")
            if not isinstance(v, int):
                continue
            max_version = max(max_version, v)
            epoch = int(e.get("lease_epoch", 0))
            if 0 < epoch < max_epoch:
                stale.append(e)
                continue
            max_epoch = max(max_epoch, epoch)
            valid.append(e)
        if stale:
            with self._lock:
                fresh = [e for e in stale
                         if e["version"] not in self._stale_seen]
                self._stale_seen.update(e["version"] for e in fresh)
            if fresh:
                telemetry.count("fleet/stale_publishes_rejected",
                                len(fresh))
                Log.warning(
                    "fleet: rejected %d stale-epoch publish(es): %s",
                    len(fresh),
                    ", ".join("v%d@e%d" % (e["version"],
                                           int(e.get("lease_epoch", 0)))
                              for e in fresh))
        return valid, max_version, max_epoch, stale

    def latest_publish(self) -> Optional[Dict[str, Any]]:
        """Newest valid (non-stale-epoch) publish event whose artifact
        exists on disk, or None. Re-reads the log, so a replica polling
        this sees other processes' publishes."""
        valid, max_version, _max_epoch, _stale = self._scan_publishes()
        if not valid:
            return None
        latest = valid[-1]
        if not os.path.exists(self.artifact_path(latest["version"])):
            return None
        with self._lock:
            if max_version > self._last_version:
                self._last_version = max_version
        return latest

    def latest_valid_publish(self, min_version: int = 0
                             ) -> Optional[Tuple[Dict[str, Any], str]]:
        """Newest publish (newer than ``min_version``) whose artifact
        verifies against the event's sha256/length — walking back past
        corrupt or missing artifacts to the previous good publish, each
        counted once per version under ``fleet/corrupt_artifacts``.
        Returns (event, model_str) or None."""
        valid, _maxv, _maxe, _stale = self._scan_publishes()
        for e in reversed(valid):
            version = int(e["version"])
            if version <= int(min_version):
                break
            try:
                return e, self.load_publish(e)
            except (CorruptArtifactError, OSError) as exc:
                with self._lock:
                    seen = version in self._corrupt_seen
                    self._corrupt_seen.add(version)
                if not seen:
                    telemetry.count("fleet/corrupt_artifacts")
                    Log.warning("fleet: skipping publish v%d (%s: %s); "
                                "falling back to previous good publish",
                                version, type(exc).__name__, exc)
        return None

    def artifact_path(self, version: int) -> str:
        return os.path.join(self._models_dir, _ARTIFACT_FMT % int(version))

    def _read_artifact(self, version: int) -> bytes:
        act = chaos.hit("store/artifact_read")
        with open(self.artifact_path(version), "rb") as f:
            data = f.read()
        if act is not None and act[0] == "torn":
            data = data[:int(len(data) * float(act[1]))]
        return data

    def load_model(self, version: int) -> str:
        """The whole-model string published under ``version`` — raw read,
        no checksum (prefer :meth:`load_publish`)."""
        return self._read_artifact(version).decode("utf-8")

    def load_publish(self, event: Dict[str, Any]) -> str:
        """Read the artifact behind one publish event, verifying the
        event's sha256 + byte length when present. Raises
        :class:`CorruptArtifactError` on mismatch."""
        data = self._read_artifact(int(event["version"]))
        _verify_artifact(event, data)
        return data.decode("utf-8")

    def publishes(self) -> List[Dict[str, Any]]:
        """Valid (non-stale-epoch) publish events oldest-first."""
        valid, _maxv, _maxe, _stale = self._scan_publishes()
        return valid

    # ---------------------------------------------------------------- orphans
    def _reap_orphans(self, max_version: int, grace_s: float) -> None:
        """Delete artifact files no publish event references (a publisher
        died between the artifact ``os.replace`` and its event append)
        plus stray ``*.tmp.*`` files — both only when older than
        ``grace_s``, so opening a store never races a live publish."""
        now = time.time()
        reaped = 0
        try:
            names = os.listdir(self._models_dir)
        except OSError:
            return
        for name in names:
            path = os.path.join(self._models_dir, name)
            orphan = False
            if ".tmp." in name:
                orphan = True
            elif name.startswith("v") and name.endswith(".txt"):
                try:
                    orphan = int(name[1:-4]) > max_version
                except ValueError:
                    continue
            if not orphan:
                continue
            try:
                if now - os.path.getmtime(path) < grace_s:
                    continue
                os.unlink(path)
                reaped += 1
            except OSError:
                continue
        if reaped:
            self._orphans_reaped = reaped
            telemetry.count("fleet/orphan_artifacts_reaped", reaped)
            Log.info("fleet: reaped %d orphan artifact file(s) in %s",
                     reaped, self._models_dir)

    # ------------------------------------------------------------- compaction
    def compact(self, *, watermark: int, wins: int, keep_rows: int,
                keep_artifacts: int = 0,
                snapshot_rows: int = 0) -> Dict[str, Any]:
        """Snapshot trainer state and truncate the replayed prefix.

        Writes one ``compact`` record carrying the gate snapshot
        (``watermark``/``wins`` — standing in for every dropped gate
        event), the global row offset of the first retained ingest
        (``row_base``), and the version/epoch floors for dropped
        publishes; then atomically rewrites ``events.jsonl`` as
        [compact record] + retained publishes + retained ingests.

        Retention keeps every ingest chunk with rows above ``watermark``
        (still-unconsumed training traffic) plus the maximal contiguous
        suffix of earlier chunks totalling ≤ ``keep_rows`` rows — because
        the shadow window drops oldest-first chunk-wise, replaying any
        suffix that covers its final content reproduces it bit-for-bit
        (pinned in tests/test_failover.py, including a compaction landing
        mid-shadow-window). Pass the shadow window's capacity as
        ``keep_rows``.

        ``keep_artifacts`` > 0 additionally retains only that many newest
        VALID publish events (stale-epoch zombie publishes never fill the
        retention window — they are dropped and their artifacts deleted;
        the compact record's version/epoch floors stand in for them) and
        deletes the unretained artifact files; 0 keeps all publishes.

        ``snapshot_rows`` > 0 turns on **snapshot bootstrap** mode: the
        retained ingest chunks (the retention rule above, with the keep
        floor raised to ``max(keep_rows, snapshot_rows)``) are written
        to ONE versioned snapshot artifact under ``snapshots/`` instead
        of back into the log, and the compact record carries the
        snapshot's id + sha256 + byte length. A cold standby then
        bootstraps from snapshot + log tail — one sequential blob read
        (or one HTTP GET) instead of replaying per-chunk JSONL — and a
        later compaction splices the previous snapshot's chunks back
        into its retention scan, so nothing covered by the shadow window
        is ever silently dropped across snapshot generations. Replay of
        snapshot + tail is bit-identical to full-log replay (pinned in
        tests/test_control.py, including a mid-shadow-window cut).

        Returns a summary dict. The whole snapshot→rewrite section holds
        the cross-process events writer mutex: a standby trainer's
        ingest append from another process blocks until the ``os.replace``
        lands instead of dying with the old inode (in-process appends are
        additionally serialized by the store lock)."""
        self._assert_writable()
        with self._lock, self._writer_mutex():
            events = list(self.events())
            row_base = 0
            last_version = 0
            lease_epoch = 0
            snap_floor = 0
            ingests: List[Tuple[int, int, Dict[str, Any]]] = []
            # (event, is_stale) — staleness mirrors _scan_publishes:
            # a non-zero epoch below the running max (which includes
            # prior compact records' floors) is a zombie's write
            publishes: List[Tuple[Dict[str, Any], bool]] = []
            seen = None
            for e in events:
                kind = e.get("kind")
                if kind == "compact":
                    snap = e.get("snapshot")
                    if isinstance(snap, dict):
                        snap_floor = max(snap_floor,
                                         int(snap.get("id", 0)))
                        # splice the previous snapshot's chunks back in
                        # as virtual ingest events at their original
                        # offsets: this compaction's retention (and its
                        # own snapshot, if any) sees one uniform
                        # contiguous chunk list
                        for lo, hi, ev in self.snapshot_chunks(e):
                            ingests.append((lo, hi, ev))
                    base = int(e.get("row_base", 0))
                    seen = base if seen is None else seen
                    row_base = base
                    last_version = max(last_version,
                                       int(e.get("last_version", 0)))
                    lease_epoch = max(lease_epoch,
                                      int(e.get("lease_epoch", 0)))
                elif kind == "ingest":
                    lo = row_base if seen is None else seen
                    seen = lo + int(e.get("n", 0))
                    ingests.append((lo, seen, e))
                elif kind == "publish":
                    v = e.get("version")
                    is_stale = False
                    if isinstance(v, int):
                        last_version = max(last_version, v)
                        epoch = int(e.get("lease_epoch", 0))
                        is_stale = 0 < epoch < lease_epoch
                        lease_epoch = max(lease_epoch, epoch)
                    publishes.append((e, is_stale))
            total_rows = ingests[-1][1] if ingests else row_base
            # the earliest row any replay could still reconstruct before
            # this compaction (spliced snapshot chunks included) — the
            # baseline dropped_rows is measured against
            old_floor = ingests[0][0] if ingests else row_base
            # retained = mandatory unconsumed suffix + shadow-cover
            # suffix; snapshot mode raises the keep floor so the
            # snapshot warms at least snapshot_rows of recent traffic
            eff_keep = int(keep_rows)
            if int(snapshot_rows) > 0:
                eff_keep = max(eff_keep, int(snapshot_rows))
            keep_from = len(ingests)
            acc = 0
            for i in range(len(ingests) - 1, -1, -1):
                lo, hi, e = ingests[i]
                n = int(e.get("n", 0))
                if hi > int(watermark) or acc + n <= eff_keep:
                    acc += n
                    keep_from = i
                else:
                    break
            kept_ingests = ingests[keep_from:]
            new_row_base = kept_ingests[0][0] if kept_ingests else total_rows
            kept_publishes = [e for e, _ in publishes]
            dropped_artifacts = 0
            if int(keep_artifacts) > 0:
                valid_pubs = [e for e, is_stale in publishes
                              if not is_stale]
                kept_publishes = valid_pubs[-int(keep_artifacts):]
                kept_versions = {int(e["version"]) for e in kept_publishes
                                 if isinstance(e.get("version"), int)}
                for e, _ in publishes:
                    v = e.get("version")
                    if isinstance(v, int) and v not in kept_versions:
                        try:
                            os.unlink(self.artifact_path(v))
                            dropped_artifacts += 1
                        except OSError:
                            pass
            snap_section = None
            if int(snapshot_rows) > 0 and kept_ingests:
                snap_section = self._write_snapshot(
                    snap_floor + 1, new_row_base, int(total_rows),
                    kept_ingests)
            record = self._stamp("compact", {
                "watermark": int(watermark), "wins": int(wins),
                # with a snapshot the log itself keeps NO ingest lines:
                # its row offsets resume at total_rows and the snapshot
                # section carries the preserved [row_base, top_row) span
                "row_base": int(total_rows) if snap_section is not None
                else int(new_row_base),
                "last_version": int(last_version),
                "lease_epoch": int(lease_epoch),
                # clamped: spliced snapshot chunks are not log lines, so
                # they can outnumber the events they were folded from
                "dropped_events": max(0, len(events) - len(kept_ingests)
                                      - len(kept_publishes)),
                "dropped_rows": int(new_row_base - old_floor)})
            if snap_section is not None:
                record["snapshot"] = snap_section
            lines = [record] + kept_publishes
            if snap_section is None:
                lines += [e for _, _, e in kept_ingests]
            tmp = self._events_path + ".tmp.%d" % os.getpid()
            data = "".join(json.dumps(entry, sort_keys=True) + "\n"
                           for entry in lines).encode("utf-8")
            fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
            try:
                view = memoryview(data)
                done = 0
                while done < len(view):
                    done += os.write(fd, view[done:])
                os.fsync(fd)
            finally:
                os.close(fd)
            os.replace(tmp, self._events_path)
            self._compactions += 1
            self._last_compact_ts = record["ts"]
            if last_version > self._last_version:
                self._last_version = last_version
        telemetry.count("fleet/compactions")
        telemetry.count("fleet/compacted_events",
                        max(0, int(record["dropped_events"])))
        telemetry.count("fleet/compacted_rows",
                        max(0, int(record["dropped_rows"])))
        telemetry.gauge("fleet/events_log_bytes", self.log_bytes())
        telemetry.gauge("fleet/last_compaction_ts", record["ts"])
        Log.info("fleet: compacted %s: dropped %d event(s) / %d row(s) "
                 "/ %d artifact(s), kept %d ingest + %d publish",
                 self._model_id, record["dropped_events"],
                 record["dropped_rows"], dropped_artifacts,
                 len(kept_ingests), len(kept_publishes))
        return {"dropped_events": record["dropped_events"],
                "dropped_rows": record["dropped_rows"],
                "dropped_artifacts": dropped_artifacts,
                "row_base": int(new_row_base),
                "snapshot": snap_section,
                "log_bytes": self.log_bytes()}

    # -------------------------------------------------------------- snapshots
    def snapshot_path(self, sid: int) -> str:
        return os.path.join(self._snapshots_dir, _SNAPSHOT_FMT % int(sid))

    def _scan_snapshot_ids(self) -> List[int]:
        try:
            names = os.listdir(self._snapshots_dir)
        except OSError:
            return []
        ids = []
        for name in names:
            if name.startswith("s") and name.endswith(".json"):
                try:
                    ids.append(int(name[1:-5]))
                except ValueError:
                    continue
        return sorted(ids)

    def _write_snapshot(self, sid_min: int, row_base: int, top_row: int,
                        kept_ingests: List[Tuple[int, int, Dict[str, Any]]]
                        ) -> Dict[str, Any]:
        """Write the retained ingest chunks to one versioned snapshot
        blob (``snapshots/s%06d.json``, tmp + fsync + ``os.replace``) and
        return the ``snapshot`` section for the compact record. The
        chunks carry their original ingest events verbatim plus their
        global row offsets, so replaying snapshot + tail is bit-identical
        to replaying the uncompacted log. Ids are monotonic across
        generations (never below ``sid_min``, the prior snapshot's id +
        1, even if its file was already pruned); older snapshot files are
        pruned after the replace — the log's compact record is the only
        pointer, and it always points at the newest."""
        os.makedirs(self._snapshots_dir, exist_ok=True)
        existing = self._scan_snapshot_ids()
        sid = max(int(sid_min), (existing[-1] + 1) if existing else 1)
        doc = {"v": STORE_VERSION, "kind": "snapshot", "id": sid,
               "model_id": self._model_id,
               "row_base": int(row_base), "top_row": int(top_row),
               "chunks": [{"lo": int(lo), "event": e}
                          for lo, _hi, e in kept_ingests]}
        data = json.dumps(doc, sort_keys=True).encode("utf-8")
        path = self.snapshot_path(sid)
        tmp = path + ".tmp.%d" % os.getpid()
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            view = memoryview(data)
            done = 0
            while done < len(view):
                done += os.write(fd, view[done:])
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
        for old in existing:
            if old < sid:
                try:
                    os.unlink(self.snapshot_path(old))
                except OSError:
                    pass
        rows = sum(int(e.get("n", 0)) for _lo, _hi, e in kept_ingests)
        telemetry.count("fleet/snapshots_written")
        telemetry.gauge("fleet/snapshot_bytes", len(data))
        Log.info("fleet: wrote snapshot s%06d for %s: %d row(s) in "
                 "[%d, %d), %d bytes", sid, self._model_id, rows,
                 row_base, top_row, len(data))
        return {"id": sid, "sha256": hashlib.sha256(data).hexdigest(),
                "bytes": len(data), "rows": rows,
                "row_base": int(row_base), "top_row": int(top_row)}

    def snapshot_bytes(self, sid: int) -> bytes:
        """Raw snapshot blob (chaos ``store/artifact_read`` torn actions
        apply, mirroring model-artifact reads)."""
        act = chaos.hit("store/artifact_read")
        with open(self.snapshot_path(sid), "rb") as f:
            data = f.read()
        if act is not None and act[0] == "torn":
            data = data[:int(len(data) * float(act[1]))]
        return data

    def load_snapshot(self, record: Dict[str, Any]) -> Dict[str, Any]:
        """Read + verify the snapshot behind one compact record's
        ``snapshot`` section. Raises :class:`CorruptArtifactError` on
        sha256/length mismatch, ``OSError`` when the file is gone."""
        snap = record.get("snapshot") or {}
        data = self.snapshot_bytes(int(snap.get("id", 0)))
        _verify_snapshot(record, data)
        return json.loads(data.decode("utf-8"))

    def snapshot_chunks(self, record: Dict[str, Any]
                        ) -> List[Tuple[int, int, Dict[str, Any]]]:
        """The ingest chunks preserved by ``record``'s snapshot, as
        ``(lo, hi, event)`` at their original global row offsets — what
        replay and the next compaction splice back in place of the log
        lines the snapshot replaced. Degrades to ``[]`` (with a warning)
        when the snapshot is missing or corrupt: because the compact
        record's ``row_base`` already equals the snapshot's ``top_row``,
        later offsets stay consistent — the failure costs buffered rows,
        never misaligns the log."""
        snap = record.get("snapshot")
        if not isinstance(snap, dict):
            return []
        try:
            doc = self.load_snapshot(record)
        except (OSError, ValueError, CorruptArtifactError) as exc:
            telemetry.count("fleet/snapshot_load_failures")
            Log.warning("fleet: snapshot s%06d unreadable (%s); replay "
                        "continues degraded without its %s buffered "
                        "row(s)", int(snap.get("id", 0)), exc,
                        snap.get("rows", "?"))
            return []
        out: List[Tuple[int, int, Dict[str, Any]]] = []
        for c in doc.get("chunks", []):
            ev = c.get("event") or {}
            lo = int(c.get("lo", 0))
            out.append((lo, lo + int(ev.get("n", 0)), ev))
        return out

    # ------------------------------------------------------------- heartbeats
    def record_heartbeat(self, doc: Dict[str, Any]) -> bool:
        """Persist one node heartbeat, latest-wins.

        Heartbeats are observability, not replicated state: each node
        owns ONE small sidecar file under ``heartbeats/`` that is
        atomically replaced on every beat, so N nodes occupy O(N) bytes
        no matter how long they run — heartbeats never touch
        ``events.jsonl`` (replay and compaction stay bit-identical) and
        read-only replica opens may record them (the ``read_only``
        contract protects the event log and artifacts, not sidecar
        observability). Returns False when ``doc`` carries no usable
        ``node`` id."""
        node = str(doc.get("node") or "").strip()
        if not node:
            return False
        entry = self._stamp("heartbeat", dict(doc))
        entry["node"] = node
        fname = re.sub(r"[^A-Za-z0-9_.-]", "_", node)[:80] + ".json"
        os.makedirs(self._heartbeats_dir, exist_ok=True)
        path = os.path.join(self._heartbeats_dir, fname)
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w") as f:
            f.write(json.dumps(entry, sort_keys=True))
        os.replace(tmp, path)
        telemetry.count("fleet/heartbeats_recorded")
        return True

    def heartbeats(self, max_age_s: Optional[float] = None
                   ) -> List[Dict[str, Any]]:
        """Latest heartbeat per node (sorted by node id), skipping
        torn/corrupt files; ``max_age_s`` filters out beats from nodes
        that stopped reporting that long ago."""
        try:
            names = sorted(os.listdir(self._heartbeats_dir))
        except OSError:
            return []
        now = time.time()
        out: List[Dict[str, Any]] = []
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self._heartbeats_dir, name)) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            if not isinstance(doc, dict) or not doc.get("node"):
                continue
            if (max_age_s is not None
                    and now - float(doc.get("ts", 0.0)) > max_age_s):
                continue
            out.append(doc)
        out.sort(key=lambda d: str(d.get("node")))
        return out

    # ------------------------------------------------------------------ state
    def state(self) -> Dict[str, Any]:
        """JSON-serializable store summary (surfaced on /healthz)."""
        with self._lock:
            return {
                "root": self._root,
                "model_id": self._model_id,
                "read_only": self._read_only,
                "last_published_version": self._last_version,
                "publishes_this_process": self._publishes,
                "ingest_rows_persisted": self._ingest_rows,
                "lease": self.lease_state(),
                "events_log_bytes": self.log_bytes(),
                "compactions": self._compactions,
                "last_compaction_ts": self._last_compact_ts,
                "orphan_artifacts_reaped": self._orphans_reaped,
                "heartbeat_nodes": len(self.heartbeats()),
            }
