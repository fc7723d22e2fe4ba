"""LightGBM-TPU on PyTorch and CUDA: the port of ``lightgbm_tpu`` to an
NVIDIA H100.

It trains (``train``, ``cv``, ``Booster(params, train_set)``, the
scikit-learn wrappers ``LGBMRegressor`` / ``LGBMClassifier`` /
``LGBMRanker``), refits (``Booster.refit``), explains
(``predict(pred_contrib=True)``, ``feature_importance``, ``dump_model``,
the ``plot_*`` functions) and serves (``Booster.predict``,
``serve.PredictSession``, ``serve.MicroBatcher``, ``serve.PredictServer``,
online training behind ``POST /ingest``: ``online.OnlineTrainer``). Hand-written CUDA kernels carry the hot paths:
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
from .callback import (EarlyStopException, early_stopping, log_evaluation,
                       print_evaluation, record_evaluation, reset_parameter)
from .convert import booster_from_reference, dataset_from_reference
from .engine import CVBooster, cv, train
from . import serve  # noqa: F401 — lgt.serve.PredictSession et al.
from . import online  # noqa: F401 — lgt.online.OnlineTrainer et al.

#: names resolved at first use: the scikit-learn wrappers import
#: scikit-learn (when it is installed) and the plots their backends
_LAZY = {"LGBMModel": "sklearn", "LGBMRegressor": "sklearn",
         "LGBMClassifier": "sklearn", "LGBMRanker": "sklearn",
         "plot_importance": "plotting", "plot_metric": "plotting",
         "plot_tree": "plotting", "create_tree_digraph": "plotting"}

__all__ = ["Config", "Log", "LightGBMError", "obs", "Booster", "Dataset",
           "train", "cv", "CVBooster", "early_stopping", "log_evaluation",
           "print_evaluation", "record_evaluation", "reset_parameter",
           "EarlyStopException", "booster_from_reference",
           "dataset_from_reference", "serve", "online"] + list(_LAZY)


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module("." + _LAZY[name], __name__),
                       name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
