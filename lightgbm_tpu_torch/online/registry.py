"""Multi-tenant model registry: model id -> (booster, session, batcher)
(PyTorch port of ``lightgbm_tpu/online/registry.py``).

One process serves N models behind one HTTP endpoint
(``/predict/<model_id>``). Each entry owns its own
:class:`~lightgbm_tpu_torch.serve.session.PredictSession` and
:class:`~lightgbm_tpu_torch.serve.batcher.MicroBatcher`, plus optionally
an :class:`~lightgbm_tpu_torch.online.trainer.OnlineTrainer` refreshing
it from ingested traffic (``/ingest/<model_id>``).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from .. import obs
from ..obs import telemetry
from ..utils.log import LightGBMError
from .trainer import OnlineTrainer


class RegistryEntry:
    """One served model: booster + session + batcher (+ online trainer)."""

    __slots__ = ("model_id", "booster", "session", "batcher", "online",
                 "created_at")

    def __init__(self, model_id: str, booster, session, batcher,
                 online: Optional[OnlineTrainer] = None) -> None:
        self.model_id = model_id
        self.booster = booster
        self.session = session
        self.batcher = batcher
        self.online = online
        self.created_at = obs.monotonic()

    def info(self) -> Dict[str, Any]:
        """JSON-serializable per-model state (surfaced on /healthz)."""
        stats = getattr(self.batcher, "tenant_stats", None)
        return {
            "model_version": self.booster.inner.model_version,
            "buckets": list(self.session.buckets),
            "queue_rows": self.batcher.queue_rows(),
            # fake batchers in tests may lack the tenant surface
            "tenants": stats() if callable(stats) else {},
            "age_s": round(obs.monotonic() - self.created_at, 3),
            "online": self.online.state() if self.online is not None
            else None,
        }

    def close(self) -> None:
        if self.online is not None:
            self.online.close()
        self.batcher.close()


class ModelRegistry:
    """Thread-safe id -> :class:`RegistryEntry` map. ``get(None)``
    resolves the sole entry (or the one named ``"default"``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[str, RegistryEntry] = {}

    def register(self, model_id: str, booster, *, buckets=None,
                 max_batch_rows: int = 8192, max_wait_ms: float = 2.0,
                 max_queue_rows: int = 0, overload: str = "shed",
                 tenant_quota_rows: int = 0, tenant_weights=None,
                 raw_score: bool = False, warmup: bool = False,
                 dispatch_mode: str = "continuous",
                 forest: Optional[str] = None,
                 online=None) -> RegistryEntry:
        """Build and register the serving stack for one model.

        ``online`` is either a ready :class:`OnlineTrainer` or a dict of
        its keyword arguments (a trainer is built over ``booster``).
        """
        from ..serve.batcher import MicroBatcher
        from ..serve.session import PredictSession

        model_id = str(model_id)
        if not model_id:
            raise LightGBMError("model_id must be non-empty")
        session = PredictSession(booster, buckets=buckets, forest=forest)
        if warmup:
            session.warmup()
        batcher = MicroBatcher(session, max_batch_rows=max_batch_rows,
                               max_wait_ms=max_wait_ms, raw_score=raw_score,
                               max_queue_rows=max_queue_rows,
                               overload=overload,
                               tenant_quota_rows=tenant_quota_rows,
                               tenant_weights=tenant_weights,
                               dispatch_mode=dispatch_mode)
        trainer = online
        try:
            if isinstance(online, dict):
                trainer = OnlineTrainer(booster, **online)
            entry = RegistryEntry(model_id, booster, session, batcher,
                                  trainer)
            return self.add_entry(entry)
        except BaseException:
            if trainer is not None and trainer is not online:
                trainer.close()
            batcher.close()
            raise

    def add_entry(self, entry: RegistryEntry) -> RegistryEntry:
        """Register a pre-built entry (tests inject fake sessions)."""
        with self._lock:
            if entry.model_id in self._entries:
                raise LightGBMError("model id %r is already registered"
                                    % entry.model_id)
            self._entries[entry.model_id] = entry
            count = len(self._entries)
        telemetry.gauge("serve/models", count)
        return entry

    def get(self, model_id: Optional[str] = None) -> RegistryEntry:
        with self._lock:
            if model_id is None:
                if len(self._entries) == 1:
                    return next(iter(self._entries.values()))
                entry = self._entries.get("default")
                if entry is not None:
                    return entry
                raise KeyError(
                    "model id required (%d models registered, none named "
                    "'default')" % len(self._entries))
            entry = self._entries.get(str(model_id))
            if entry is None:
                raise KeyError("unknown model id %r (registered: %s)"
                               % (model_id, ", ".join(sorted(self._entries))
                                  or "<none>"))
            return entry

    def ids(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def entries(self) -> List[RegistryEntry]:
        with self._lock:
            return list(self._entries.values())

    def info(self) -> Dict[str, Any]:
        return {e.model_id: e.info() for e in self.entries()}

    def close(self) -> None:
        """Close every entry (online trainers first, then batchers)."""
        for e in self.entries():
            e.close()
