"""LightGBM-TPU on PyTorch and CUDA: the port of ``lightgbm_tpu`` to an
NVIDIA H100.

This first slice serves trained models: ``Booster(model_str=...)`` /
``Booster.predict``, ``serve.PredictSession``, ``serve.MicroBatcher`` and
``serve.PredictServer``, with hand-written CUDA kernels for the forest
walk (``ops/forest.py``) and the binned row router (``ops/route.py``).
Module paths mirror the JAX package's. The port imports torch and numpy,
never JAX and nothing of ``lightgbm_tpu``. Everything runs on the CUDA
card unless ``device_type=cpu`` asks for the host.

    import lightgbm_tpu_torch as lgt
    bst = lgt.booster_from_reference(model_text, "train_binned.npz")
    preds = bst.predict(X)
"""

__version__ = "0.1.0"

from .config import Config
from .utils.log import Log, LightGBMError
from . import obs
from .basic import Booster, Dataset
from .convert import booster_from_reference
from . import serve  # noqa: F401 — lgt.serve.PredictSession et al.

__all__ = ["Config", "Log", "LightGBMError", "obs", "Booster", "Dataset",
           "booster_from_reference", "serve"]
