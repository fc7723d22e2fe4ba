"""User-facing Dataset and Booster (PyTorch port of
``lightgbm_tpu/basic.py``).

``Dataset`` bins lazily at ``construct()`` (or loads a ``save_binned``
npz); ``Booster(params, train_set)`` trains (``update``, ``add_valid``,
``eval_train`` / ``eval_valid``, ``rollback_one_iter``), and
``Booster(model_file=|model_str=)`` loads a model; both predict. The
booster's device comes from ``params["device_type"]``: ``cpu`` for the
host, the CUDA card otherwise (the default).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np

from .boosting import GBDT, create_boosting
from .config import Config
from .dataset import BinnedDataset, construct_dataset
from .utils.log import LightGBMError, Log


def _to_2d(data) -> np.ndarray:
    if hasattr(data, "toarray"):  # scipy sparse
        data = data.toarray()
    if hasattr(data, "values") and not isinstance(data, np.ndarray):
        data = data.values
    arr = np.asarray(data, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    return arr


def _to_1d(data) -> Optional[np.ndarray]:
    if data is None:
        return None
    if hasattr(data, "values") and not isinstance(data, np.ndarray):
        data = data.values
    return np.asarray(data).ravel()


class Dataset:
    """Lazily-constructed dataset (reference: basic.py:1035). ``data``
    is a matrix, or the path of a ``save_binned`` npz."""

    def __init__(self, data, label=None, *,
                 reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None) -> None:
        self.data = data
        self.label = _to_1d(label)
        self.weight = _to_1d(weight)
        self.group = _to_1d(group)
        self.init_score = None if init_score is None else np.asarray(init_score)
        self.reference = reference
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params) if params else {}
        self._constructed: Optional[BinnedDataset] = None
        self._used_params: Optional[Dict[str, Any]] = None

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A validation set binned with this dataset's bin mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score, params=params)

    def save_binary(self, filename: str) -> "Dataset":
        """Write the constructed binned dataset (``Dataset(path)`` loads
        it back without re-binning)."""
        from .dataset import save_binned
        save_binned(self.construct(), filename)
        return self

    def construct(self, params: Optional[Dict[str, Any]] = None
                  ) -> BinnedDataset:
        merged = dict(self.params)
        if params:
            merged.update(params)
        if self._constructed is not None and (
                self._used_params == merged or self.data is None):
            # a dataset built elsewhere (the two-round loader) keeps its bins
            return self._constructed
        if isinstance(self.data, str):
            # binary dataset cache; metadata passed here overrides the
            # cached copy
            from .dataset import Metadata, load_binned
            ds = load_binned(self.data)
            if any(v is not None for v in
                   (self.label, self.weight, self.group, self.init_score)):
                md = Metadata(ds.num_data, self.label, self.weight,
                              self.group, self.init_score)
                for f in ("label", "weight", "init_score",
                          "query_boundaries", "query_id"):
                    v = getattr(md, f)
                    if v is not None:
                        setattr(ds.metadata, f, v)
            self._constructed = ds
            self._used_params = merged
            return self._constructed
        cfg = Config.from_params(merged)
        X = self.data if hasattr(self.data, "tocsc") else _to_2d(self.data)
        feature_names = list(self.feature_name) \
            if isinstance(self.feature_name, (list, tuple)) else None
        cat = self.categorical_feature
        if cat == "auto":
            cat = None
        ref_binned = self.reference.construct(params) \
            if self.reference else None
        self._constructed = construct_dataset(
            X, cfg, label=self.label, weight=self.weight, group=self.group,
            init_score=self.init_score, feature_names=feature_names,
            categorical_feature=cat, reference=ref_binned)
        self._used_params = merged
        return self._constructed


class Booster:
    """Model handle (reference: basic.py:2142): trains from a
    ``train_set`` or loads a model from ``model_file`` / ``model_str``."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None) -> None:
        params = dict(params or {})
        self.params = params
        self.train_dataset = train_set
        self.best_score: Dict[str, Dict[str, float]] = {}
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("train_set must be a Dataset")
            binned = train_set.construct(params)
            self.config = Config.from_params(params)
            self.inner: GBDT = create_boosting(self.config, binned)
            self.best_iteration = -1
            return
        if model_file is not None:
            with open(model_file) as f:
                model_str = f.read()
        if model_str is None:
            raise LightGBMError("Need train_set, model_file or model_str")
        self.inner = GBDT.model_from_string(model_str,
                                            Config.from_params(params))
        self.config = self.inner.config
        # loaded models keep their stored best_iteration so predict()
        # defaults to the early-stopped tree count like the reference
        self.best_iteration = self.inner.best_iteration

    # ----------------------------------------------------------- training
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        if data.reference is None:
            data.reference = self.train_dataset
        self.inner.add_valid(name, data.construct(self.params))
        return self

    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting iteration; returns True if no tree could grow
        (reference: basic.py:2565 update)."""
        if train_set is not None:
            raise LightGBMError("Resetting train_set is not supported")
        if fobj is not None:
            grad, hess = fobj(self.inner.train_score.np(), self.train_dataset)
            return self.inner.train_one_iter(np.asarray(grad),
                                             np.asarray(hess))
        return self.inner.train_one_iter()

    def rollback_one_iter(self) -> "Booster":
        self.inner.rollback_one_iter()
        return self

    @property
    def current_iteration(self) -> int:
        return self.inner.current_iteration

    def num_trees(self) -> int:
        return self.inner.num_trees()

    def eval_train(self, feval=None):
        return self.inner.eval_train(feval)

    def eval_valid(self, feval=None):
        return self.inner.eval_valid(feval)

    def save_model(self, filename: str, num_iteration: Optional[int] = None
                   ) -> "Booster":
        with self.inner._cache_lock:
            self.inner.best_iteration = self.best_iteration
        self.inner.save_model(filename,
                              -1 if num_iteration is None else num_iteration)
        return self

    # ------------------------------------------------------------ serving
    def predict(self, data, *, raw_score: bool = False,
                start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                pred_leaf: bool = False) -> np.ndarray:
        X = _to_2d(data)
        expected = self.num_feature()
        if expected > 0 and X.shape[1] != expected \
                and not self.config.predict_disable_shape_check:
            Log.fatal(
                "The number of features in data (%d) is not the same as in "
                "the model (%d). Set predict_disable_shape_check=true to "
                "bypass.", X.shape[1], expected)
        if num_iteration is None:
            num_iteration = self.best_iteration \
                if self.best_iteration > 0 else -1
        return self.inner.predict(X, raw_score=raw_score,
                                  start_iteration=start_iteration,
                                  num_iteration=num_iteration,
                                  pred_leaf=pred_leaf)

    def model_to_string(self, num_iteration: Optional[int] = None) -> str:
        return self.inner.model_to_string(
            -1 if num_iteration is None else num_iteration)

    def num_feature(self) -> int:
        """Number of features the model was trained on; -1 when
        unknown."""
        if self.inner.train_set is not None:
            return self.inner.train_set.num_total_features
        names = getattr(self.inner, "_feature_names", None)
        return len(names) if names else -1

    def adopt(self, other: "Booster") -> tuple:
        """Atomically swap this booster's served model for ``other``'s;
        returns a rollback token for :meth:`restore`."""
        token = self.inner.adopt(getattr(other, "inner", other))
        with self.inner._cache_lock:
            self.best_iteration = self.inner.best_iteration
        return token

    def restore(self, snapshot: tuple) -> "Booster":
        self.inner.restore(snapshot)
        with self.inner._cache_lock:
            self.best_iteration = self.inner.best_iteration
        return self
