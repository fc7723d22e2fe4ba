"""Serving: device-resident prediction sessions, micro-batching and the
HTTP endpoint (PyTorch port of ``lightgbm_tpu/serve``)."""
from .batcher import MicroBatcher, QueueFullError
from .http import PredictServer
from .session import PredictSession

__all__ = ["MicroBatcher", "QueueFullError", "PredictServer",
           "PredictSession"]
