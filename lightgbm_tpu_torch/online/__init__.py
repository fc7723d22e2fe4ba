"""Online continual learning: train and serve in one process (PyTorch
port of ``lightgbm_tpu/online/`` without the fleet).

- :class:`TrafficBuffer`: a bounded labeled-traffic buffer and a sliding
  shadow window of recent live rows;
- :class:`OnlineTrainer`: a background worker that refits (or continues
  training) off the serving thread, shadow-scores the candidate against
  recent traffic and promotes it atomically into the serving booster
  (one version-token bump under ``_cache_lock``; rollback kept);
- :class:`ModelRegistry`: model id -> per-model PredictSession and
  MicroBatcher (and trainer) behind ``/predict/<model_id>`` and
  ``/ingest/<model_id>``.

    bst = lgt.train(params, train_set)
    ot = lgt.online.OnlineTrainer(bst, trigger_rows=4096)
    ot.ingest(X_live, y_live)

The command line wires it into ``task=serve`` with ``online_train=true``.
The fleet (a durable store, leases, replicas) is queue A item 8 of
ROADMAP.md.
"""
from .buffer import TrafficBuffer
from .registry import ModelRegistry, RegistryEntry
from .trainer import OnlineTrainer

__all__ = ["TrafficBuffer", "OnlineTrainer", "ModelRegistry",
           "RegistryEntry"]
