"""User-facing Dataset and Booster (PyTorch port of
``lightgbm_tpu/basic.py``).

``Dataset`` bins lazily at ``construct()`` (or loads a ``save_binned``
npz), takes ranking queries (``group=``, ``set_group`` / ``get_group``)
and the label, weight and init score setters and getters;
``Booster(params, train_set)`` trains (``update``, ``add_valid``,
``eval_train`` / ``eval_valid``, ``rollback_one_iter``,
``reset_parameter``), and ``Booster(model_file=|model_str=)`` loads a
model; both predict (``pred_contrib``: TreeSHAP on the host, as in the
JAX package), dump (``dump_model``, ``feature_importance``) and refit
their leaves on new data (``refit``). The booster's device comes from
``params["device_type"]``: ``cpu`` for the host, the CUDA card otherwise
(the default). A booster that ``refit`` builds from a model string keeps
its parent's device.
"""
from __future__ import annotations

import copy
import json
from typing import Any, Dict, List, Optional, Union

import numpy as np

from .boosting import GBDT, create_boosting
from .config import Config
from .dataset import BinnedDataset, construct_dataset
from .fused import make_feature_mask_fn
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

    def set_label(self, label) -> "Dataset":
        self.label = _to_1d(label)
        if self._constructed is not None:
            self._constructed.metadata.label = np.ascontiguousarray(
                self.label, dtype=np.float32)
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = _to_1d(weight)
        if self._constructed is not None:
            self._constructed.metadata.weight = None if weight is None else \
                np.ascontiguousarray(self.weight, dtype=np.float32)
        return self

    def set_group(self, group) -> "Dataset":
        """Query sizes (or contiguous per-row query ids) of a ranking
        dataset; the dataset is constructed again at its next use."""
        self.group = _to_1d(group)
        self._constructed = None
        return self

    def set_init_score(self, init_score) -> "Dataset":
        """The dataset is constructed again at its next use."""
        self.init_score = None if init_score is None \
            else np.asarray(init_score)
        self._constructed = None
        return self

    def get_label(self):
        return self.label

    def get_weight(self):
        return self.weight

    def get_group(self):
        """The query sizes: from the constructed dataset's boundaries
        when it has them, else as given."""
        if self._constructed is not None and \
                self._constructed.metadata.query_boundaries is not None:
            return np.diff(self._constructed.metadata.query_boundaries)
        return self.group

    def get_init_score(self):
        return self.init_score

    def num_data(self) -> int:
        if self._constructed is not None:
            return self._constructed.num_data
        return _to_2d(self.data).shape[0]

    def num_feature(self) -> int:
        if self._constructed is not None:
            return self._constructed.num_total_features
        return _to_2d(self.data).shape[1]

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

    def num_model_per_iteration(self) -> int:
        return self.inner.num_tree_per_iteration

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
                pred_leaf: bool = False,
                pred_contrib: bool = False) -> np.ndarray:
        """Predictions of ``data``'s rows. ``pred_contrib`` returns each
        row's TreeSHAP contributions, ``(n, F + 1)`` a class with the
        expected value last; they run on the host, as in the JAX
        package."""
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
        if pred_contrib:
            from .shap import tree_shap_contribs
            self.inner.finish_fused("pred_contrib")
            return tree_shap_contribs(self.inner, X, num_iteration)
        return self.inner.predict(X, raw_score=raw_score,
                                  start_iteration=start_iteration,
                                  num_iteration=num_iteration,
                                  pred_leaf=pred_leaf)

    def model_to_string(self, num_iteration: Optional[int] = None) -> str:
        return self.inner.model_to_string(
            -1 if num_iteration is None else num_iteration)

    def dump_model(self, num_iteration: Optional[int] = None
                   ) -> Dict[str, Any]:
        """The model as JSON-ready dicts (``GBDT.dump_json``)."""
        return json.loads(self.inner.dump_json(
            -1 if num_iteration is None else num_iteration))

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        """Per-feature split counts (``split``) or summed gains
        (``gain``) over the first ``iteration`` iterations."""
        return self.inner.feature_importance(
            importance_type, -1 if iteration is None else iteration)

    def feature_name(self) -> List[str]:
        if self.inner.train_set is not None:
            return self.inner.train_set.feature_names
        return getattr(self.inner, "_feature_names", [])

    def num_feature(self) -> int:
        """Number of features the model was trained on; -1 when
        unknown."""
        if self.inner.train_set is not None:
            return self.inner.train_set.num_total_features
        names = getattr(self.inner, "_feature_names", None)
        return len(names) if names else -1

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Apply new parameters to the trees still to grow (reference:
        gbdt.cpp:684 ResetConfig): rebuild the learner, keeping its class
        and process group (a distributed learner must not turn serial in
        the middle of training), and the row and column samplers, and drop
        the fused trainer. Settings that would move
        the work to another device raise before anything changes
        (``GBDT.check_device_config``)."""
        inner = self.inner
        inner.check_device_config(copy.copy(self.config).set(params))
        self.params.update(params)
        self.config.set(params)
        # under the model lock: serving threads read the learner's knobs
        # while it is swapped
        with inner._cache_lock:
            if inner.learner is not None:
                inner.finish_fused("reset_parameter")
                from .parallel.mesh import create_tree_learner
                inner.learner = create_tree_learner(
                    self.config, inner.train_set,
                    getattr(inner.learner, "group", None), inner.device,
                    bins=inner._valid_bins(inner.train_set),
                    bins_t=inner._valid_bins_t(inner.train_set))
                inner._sampler = inner._make_sampler()
                inner._fmask_fn = make_feature_mask_fn(
                    self.config, inner.train_set.num_features,
                    inner.device)
            inner._fused = None
        return self

    def refit(self, data, label, decay_rate: Optional[float] = None,
              weight=None, group=None, **kwargs) -> "Booster":
        """A new booster with this model's trees and leaf values refit on
        ``data`` (reference: gbdt.cpp:285 RefitTree): tree by tree, each
        leaf moves to ``decay * old + (1 - decay) * new * shrinkage``
        where ``new = -sum(g) / (sum(h) + lambda_l2)`` over the leaf's
        rows at the scores of the trees before it. ``weight`` / ``group``
        carry the new rows' metadata; a ranking objective needs
        ``group``. Rows route to their leaves and the gradients run on
        this booster's device; the new booster lives there too. As in the
        JAX package it is built from the model text alone, so
        ``lambda_l2`` is the default's."""
        import torch

        from .dataset import Metadata
        from .ops.predict import leaf_indices

        decay = self.config.refit_decay_rate if decay_rate is None \
            else decay_rate
        X = _to_2d(data)
        y = _to_1d(label)
        new_booster = Booster({"device_type": self.config.device_type},
                              model_str=self.model_to_string())
        inner = new_booster.inner
        dev = inner.device
        K = inner.num_tree_per_iteration
        meta = Metadata(num_data=len(y), label=np.asarray(y, np.float32),
                        weight=None if weight is None else _to_1d(weight),
                        group=None if group is None else _to_1d(group))
        obj = inner.objective
        if obj.is_ranking and meta.query_boundaries is None:
            Log.fatal("refit with a ranking objective requires group=")
        obj.init(meta, dev)
        Xd = torch.as_tensor(X).to(dev)
        score = torch.as_tensor(
            np.broadcast_to(inner.init_scores[None, :K],
                            (X.shape[0], K)).copy()).to(dev)
        lam = new_booster.config.lambda_l2
        # the candidate is private to this call, but refit also runs on
        # the online trainer's worker thread: rewrite its leaves under its
        # model lock so the leaf values and the version bump land as one
        with inner._cache_lock:
            leaves = leaf_indices(inner.models, Xd)            # (T, N)
            for i, tree in enumerate(inner.models):
                k = i % K
                s = score if K > 1 else score[:, 0]
                g, h = obj.get_gradients(s.to(torch.float32))
                g = g.reshape(len(y), -1)[:, k].double()
                h = h.reshape(len(y), -1)[:, k].double()
                L = tree.num_leaves
                leaf = leaves[i]
                gs = torch.zeros(L, dtype=torch.float64, device=dev)
                hs = torch.zeros(L, dtype=torch.float64, device=dev)
                gs.index_add_(0, leaf, g)
                hs.index_add_(0, leaf, h)
                # the new value in f32, as the JAX package computes it
                new_val = (-gs / (hs + lam)).float().double().cpu().numpy()
                rows = torch.bincount(leaf, minlength=L).cpu().numpy()
                for l in np.flatnonzero(rows):
                    tree.leaf_value[l] = decay * tree.leaf_value[l] + \
                        (1 - decay) * new_val[l] * tree.shrinkage
                    if tree.is_linear:
                        # linear leaves output leaf_const (+ coeffs);
                        # decay it the same way
                        tree.leaf_const[l] = decay * tree.leaf_const[l] + \
                            (1 - decay) * new_val[l] * tree.shrinkage
                if tree.is_linear:
                    # linear outputs need the raw features: the host walk
                    vals = torch.as_tensor(tree.predict(X)).to(dev)
                else:
                    vals = torch.as_tensor(tree.leaf_value[:L]).to(dev)[leaf]
                score[:, k] += vals
            # leaf values were rewritten in place on the fresh trees
            inner._bump_model_version()
        return new_booster

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
