"""scikit-learn estimator wrappers (PyTorch port of
``lightgbm_tpu/sklearn.py``).

Equivalent of the reference sklearn API (reference:
python-package/lightgbm/sklearn.py:343 LGBMModel, :809 LGBMRegressor,
:835 LGBMClassifier, :956 LGBMRanker). scikit-learn is optional: without
it the estimators keep the same surface over small stand-ins for its base
classes and ``LabelEncoder``. Extra keyword arguments are training
parameters (``device_type="cpu"`` trains on the host). ``fit`` records
the evaluation history only when it has an ``eval_set``, so a fit
without one trains in fused blocks; the trees are the same either way.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .callback import record_evaluation
from .engine import train as _train
from .utils.log import LightGBMError

#: filled at the first use of an estimator class (:func:`_build`)
_SKLEARN_INSTALLED = None
_BASES: Dict[str, Any] = {}
_NAMES = ("LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker")


class _LabelEncoder:
    """``sklearn.preprocessing.LabelEncoder``'s stand-in."""

    def fit(self, y):
        self.classes_ = np.unique(y)
        return self

    def transform(self, y):
        return np.searchsorted(self.classes_, y)

    def fit_transform(self, y):
        return self.fit(y).transform(y)

    def inverse_transform(self, y):
        return self.classes_[np.asarray(y, dtype=np.int64)]


def _sklearn_bases() -> Dict[str, Any]:
    """scikit-learn's base classes and ``LabelEncoder``, or stand-ins
    without it. Imported at the first use of an estimator class, not with
    this module: importing scikit-learn takes seconds and loads modules
    the port does not need."""
    global _SKLEARN_INSTALLED
    if not _BASES:
        try:
            from sklearn.base import (BaseEstimator, ClassifierMixin,
                                      RegressorMixin)
            from sklearn.preprocessing import LabelEncoder
            _SKLEARN_INSTALLED = True
        except ImportError:
            _SKLEARN_INSTALLED = False
            BaseEstimator = type("BaseEstimator", (), {})
            ClassifierMixin = type("ClassifierMixin", (), {})
            RegressorMixin = type("RegressorMixin", (), {})
            LabelEncoder = _LabelEncoder
        _BASES.update(BaseEstimator=BaseEstimator,
                      ClassifierMixin=ClassifierMixin,
                      RegressorMixin=RegressorMixin,
                      LabelEncoder=LabelEncoder)
    return _BASES


class _Model:
    """Base estimator (reference: sklearn.py:343); ``LGBMModel`` is this
    over scikit-learn's ``BaseEstimator``."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[str] = None, class_weight=None,
                 min_split_gain: float = 0.0, min_child_weight: float = 1e-3,
                 min_child_samples: int = 20, subsample: float = 1.0,
                 subsample_freq: int = 0, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 random_state: Optional[int] = None, n_jobs: int = -1,
                 importance_type: str = "split", **kwargs: Any) -> None:
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.importance_type = importance_type
        self._other_params: Dict[str, Any] = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._evals_result: Dict = {}
        self._best_iteration = -1

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = super().get_params(deep=deep) if _SKLEARN_INSTALLED else {
            k: getattr(self, k) for k in (
                "boosting_type num_leaves max_depth learning_rate n_estimators "
                "subsample_for_bin objective class_weight min_split_gain "
                "min_child_weight min_child_samples subsample subsample_freq "
                "colsample_bytree reg_alpha reg_lambda random_state n_jobs "
                "importance_type").split()}
        params.update(self._other_params)
        return params

    def set_params(self, **params: Any) -> "LGBMModel":
        for key, value in params.items():
            if hasattr(self, key):
                setattr(self, key, value)
            else:
                self._other_params[key] = value
        return self

    def _default_objective(self) -> str:
        return "regression"

    def _train_params(self) -> Dict[str, Any]:
        params = {
            "boosting": self.boosting_type,
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "bin_construct_sample_cnt": self.subsample_for_bin,
            "objective": self.objective or self._default_objective(),
            "min_gain_to_split": self.min_split_gain,
            "min_sum_hessian_in_leaf": self.min_child_weight,
            "min_data_in_leaf": self.min_child_samples,
            "bagging_fraction": self.subsample,
            "bagging_freq": self.subsample_freq,
            "feature_fraction": self.colsample_bytree,
            "lambda_l1": self.reg_alpha,
            "lambda_l2": self.reg_lambda,
            "verbosity": -1,
        }
        if self.random_state is not None:
            params["seed"] = self.random_state
        params.update(self._other_params)
        return params

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_group=None, eval_metric=None,
            callbacks: Optional[List[Callable]] = None) -> "LGBMModel":
        params = self._train_params()
        if eval_metric:
            params["metric"] = eval_metric if isinstance(eval_metric, list) \
                else [eval_metric]
        train_set = Dataset(X, label=y, weight=sample_weight, group=group,
                            init_score=init_score)
        valid_sets, valid_names = [], []
        if eval_set:
            for i, (vx, vy) in enumerate(eval_set):
                if vx is X and vy is y:
                    valid_sets.append(train_set)
                else:
                    vw = eval_sample_weight[i] if eval_sample_weight else None
                    vg = eval_group[i] if eval_group else None
                    valid_sets.append(train_set.create_valid(
                        vx, label=vy, weight=vw, group=vg))
                valid_names.append(eval_names[i] if eval_names and
                                   i < len(eval_names) else "valid_%d" % i)
        self._evals_result = {}
        callbacks = list(callbacks or [])
        if valid_sets:
            callbacks.append(record_evaluation(self._evals_result))
        self._Booster = _train(params, train_set,
                               num_boost_round=self.n_estimators,
                               valid_sets=valid_sets, valid_names=valid_names,
                               callbacks=callbacks)
        self._best_iteration = self._Booster.best_iteration
        self._n_features = np.asarray(X).shape[1] if hasattr(X, "shape") else \
            len(X[0])
        return self

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs) -> np.ndarray:
        if self._Booster is None:
            raise LightGBMError("Estimator not fitted")
        return self._Booster.predict(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib)

    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise LightGBMError("Estimator not fitted")
        return self._Booster

    @property
    def best_iteration_(self) -> int:
        return self._best_iteration

    @property
    def evals_result_(self) -> Dict:
        return self._evals_result

    @property
    def feature_importances_(self) -> np.ndarray:
        return self.booster_.feature_importance(self.importance_type)

    @property
    def n_features_(self) -> int:
        return self._n_features


class _Regressor:
    """(reference: sklearn.py:809)"""

    def _default_objective(self) -> str:
        return "regression"


class _Classifier:
    """(reference: sklearn.py:835)"""

    def _default_objective(self) -> str:
        return "binary"

    def fit(self, X, y, **kwargs):
        self._le = _sklearn_bases()["LabelEncoder"]().fit(y)
        y_enc = self._le.transform(y)
        self._classes = self._le.classes_
        self._n_classes = len(self._classes)
        if self._n_classes > 2:
            if not self.objective or self.objective in ("binary",):
                self.objective = "multiclass"
            self._other_params["num_class"] = self._n_classes
        eval_set = kwargs.get("eval_set")
        if eval_set:
            kwargs["eval_set"] = [(vx, self._le.transform(vy))
                                  for vx, vy in eval_set]
        return super().fit(X, y_enc, **kwargs)

    def predict(self, X, raw_score=False, **kwargs):
        result = super().predict(X, raw_score=raw_score, **kwargs)
        if raw_score or kwargs.get("pred_leaf") or kwargs.get("pred_contrib"):
            return result
        if self._n_classes > 2:
            idx = np.argmax(result, axis=1)
        else:
            idx = (result > 0.5).astype(np.int64)
        return self._le.inverse_transform(idx)

    def predict_proba(self, X, **kwargs) -> np.ndarray:
        result = super().predict(X, **kwargs)
        if self._n_classes > 2:
            return result
        return np.column_stack([1.0 - result, result])

    @property
    def classes_(self) -> np.ndarray:
        return self._classes

    @property
    def n_classes_(self) -> int:
        return self._n_classes


class _Ranker:
    """(reference: sklearn.py:956)"""

    def _default_objective(self) -> str:
        return "lambdarank"

    def fit(self, X, y, group=None, **kwargs):
        if group is None:
            raise LightGBMError("Ranker needs group information")
        return super().fit(X, y, group=group, **kwargs)


def _build() -> None:
    """Make the four estimator classes over scikit-learn's bases (or the
    stand-ins) as module attributes."""
    b = _sklearn_bases()
    ns = {"__module__": __name__}
    model = type("LGBMModel", (_Model, b["BaseEstimator"]),
                 dict(ns, __doc__=_Model.__doc__))
    globals().update(
        LGBMModel=model,
        LGBMRegressor=type("LGBMRegressor",
                           (_Regressor, model, b["RegressorMixin"]),
                           dict(ns, __doc__=_Regressor.__doc__)),
        LGBMClassifier=type("LGBMClassifier",
                            (_Classifier, model, b["ClassifierMixin"]),
                            dict(ns, __doc__=_Classifier.__doc__)),
        LGBMRanker=type("LGBMRanker", (_Ranker, model),
                        dict(ns, __doc__=_Ranker.__doc__)))


def __getattr__(name: str):
    if name in _NAMES:
        _build()
        return globals()[name]
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
