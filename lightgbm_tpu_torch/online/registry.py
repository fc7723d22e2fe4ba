"""Multi-tenant model registry: model id -> (booster, session, batcher)
(PyTorch port of the serving part of ``lightgbm_tpu/online/registry.py``).

One process serves N models behind one HTTP endpoint
(``/predict/<model_id>``). Each entry owns its own
:class:`~lightgbm_tpu_torch.serve.session.PredictSession` and
:class:`~lightgbm_tpu_torch.serve.batcher.MicroBatcher`. Online training
(an ``OnlineTrainer`` per entry) comes with the training slice.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from .. import obs
from ..obs import telemetry
from ..utils.log import LightGBMError


class RegistryEntry:
    """One served model: booster + session + batcher."""

    __slots__ = ("model_id", "booster", "session", "batcher", "created_at")

    def __init__(self, model_id: str, booster, session, batcher) -> None:
        self.model_id = model_id
        self.booster = booster
        self.session = session
        self.batcher = batcher
        self.created_at = obs.monotonic()

    def info(self) -> Dict[str, Any]:
        """JSON-serializable per-model state (surfaced on /healthz)."""
        return {
            "model_version": self.booster.inner.model_version,
            "buckets": list(self.session.buckets),
            "queue_rows": self.batcher.queue_rows(),
            "tenants": self.batcher.tenant_stats(),
            "age_s": round(obs.monotonic() - self.created_at, 3),
        }

    def close(self) -> None:
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
                 forest: Optional[str] = None) -> RegistryEntry:
        """Build and register the serving stack for one model."""
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
        entry = RegistryEntry(model_id, booster, session, batcher)
        with self._lock:
            if model_id in self._entries:
                batcher.close()
                raise LightGBMError("model id %r is already registered"
                                    % model_id)
            self._entries[model_id] = entry
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
        for e in self.entries():
            e.close()
