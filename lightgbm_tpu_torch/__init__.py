"""LightGBM-TPU on PyTorch and CUDA: the port of ``lightgbm_tpu`` to an
NVIDIA H100.

It trains (``train``, ``Booster(params, train_set)``) and serves
(``Booster.predict``, ``serve.PredictSession``, ``serve.MicroBatcher``,
``serve.PredictServer``). Hand-written CUDA kernels carry the hot paths:
the segment partition (``ops/partition.py``) and segment histogram
(``ops/histogram.py``) of tree growth, the binned row router
(``ops/route.py``) and the forest walk (``ops/forest.py``). Module paths
mirror the JAX package's. The port imports torch and numpy, never JAX
and nothing of ``lightgbm_tpu``. Everything runs on the CUDA card unless
``device_type=cpu`` asks for the host.

    import lightgbm_tpu_torch as lgt
    bst = lgt.train({"objective": "binary"}, lgt.Dataset(X, label=y))
    preds = bst.predict(X)
"""

__version__ = "0.1.0"

from .config import Config
from .utils.log import Log, LightGBMError
from . import obs
from .basic import Booster, Dataset
from .callback import early_stopping, log_evaluation, record_evaluation
from .convert import booster_from_reference, dataset_from_reference
from .engine import train
from . import serve  # noqa: F401 — lgt.serve.PredictSession et al.

__all__ = ["Config", "Log", "LightGBMError", "obs", "Booster", "Dataset",
           "train", "early_stopping", "log_evaluation", "record_evaluation",
           "booster_from_reference", "dataset_from_reference", "serve"]
