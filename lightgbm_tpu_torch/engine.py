"""Training entry point (PyTorch port of ``lightgbm_tpu/engine.py``;
reference: python-package/lightgbm/engine.py:14 train).

With no custom objective or eval, no valid set and no user callback, the
booster trains in fused blocks of ``tpu_iter_block`` iterations
(``fused.FusedTrainer``; the JAX package's fast path). Otherwise the
eager loop runs, one ``Booster.update`` per iteration with callbacks and
valid-set evaluation between iterations. ``cv`` trains one booster a
fold (stratified, group-aware or shuffled folds, ``_make_n_folds``) with
the fold's rows as its valid set, and returns the folds' mean and
standard deviation of every valid metric per iteration.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from .basic import Booster, Dataset
from .callback import CallbackEnv, EarlyStopException, early_stopping, \
    log_evaluation, record_evaluation
from .config import resolve_aliases
from .obs import telemetry
from .utils.log import Log


def _load_init_model(init_model: Union[str, Booster]) -> str:
    """Model text of ``init_model``: a Booster, a model file's path, or the
    model text itself (for instance a JAX package ``model_to_string``)."""
    if isinstance(init_model, Booster):
        return init_model.model_to_string()
    if os.path.exists(init_model):
        with open(init_model) as f:
            return f.read()
    return init_model


def train(
    params: Dict[str, Any],
    train_set: Dataset,
    num_boost_round: int = 100,
    valid_sets: Optional[List[Dataset]] = None,
    valid_names: Optional[List[str]] = None,
    fobj: Optional[Callable] = None,
    feval: Optional[Callable] = None,
    init_model: Optional[Union[str, Booster]] = None,
    callbacks: Optional[List[Callable]] = None,
) -> Booster:
    """Train a booster (reference: engine.py:14)."""
    params = resolve_aliases(dict(params))
    num_boost_round = int(params.pop("num_iterations", num_boost_round))
    if fobj is not None:
        params.setdefault("objective", "none")
    early_rounds = params.pop("early_stopping_round", 0)

    booster = Booster(params, train_set)
    if init_model is not None:
        # continued training: preload the trees and replay their scores
        from .boosting import GBDT
        prev = GBDT.model_from_string(_load_init_model(init_model),
                                      booster.inner.config.clone())
        with booster.inner._cache_lock:
            booster.inner.models = prev.models
            booster.inner.init_scores = prev.init_scores
            booster.inner.iter_ = prev.iter_
        booster.inner._rebuild_scores()

    valid_sets = valid_sets or []
    valid_names = valid_names or []
    for i, vs in enumerate(valid_sets):
        if vs is not train_set:
            name = valid_names[i] if i < len(valid_names) else "valid_%d" % i
            booster.add_valid(vs, name)
    has_train_in_valid = any(vs is train_set for vs in valid_sets)

    callbacks = list(callbacks or [])
    if early_rounds and int(early_rounds) > 0:
        callbacks.append(early_stopping(
            int(early_rounds),
            first_metric_only=bool(params.get("first_metric_only", False))))
    auto_callbacks = []
    if int(params.get("verbosity", 1)) > 0 \
            and not any(getattr(c, "order", None) == 10 for c in callbacks):
        auto_callbacks.append(log_evaluation(int(params.get("metric_freq",
                                                            1))))
        callbacks.extend(auto_callbacks)
    callbacks_before = sorted(
        (c for c in callbacks if getattr(c, "before_iteration", False)),
        key=lambda c: getattr(c, "order", 0))
    callbacks_after = sorted(
        (c for c in callbacks if not getattr(c, "before_iteration", False)),
        key=lambda c: getattr(c, "order", 0))

    begin = booster.inner.iter_
    end = begin + num_boost_round
    # fused fast path: no per-iteration observation -> K iterations per
    # block (only the engine's own log_evaluation is inert without valid
    # sets; any user-supplied callback disables fusing)
    user_callbacks = [c for c in callbacks if c not in auto_callbacks]
    if (fobj is None and feval is None and not valid_sets
            and not user_callbacks and booster.inner.supports_fused()):
        _train_fused(booster, begin, end)
        return booster
    for it in range(begin, end):
        for cb in callbacks_before:
            cb(CallbackEnv(booster, params, it, begin, end, None, telemetry))
        stop = booster.update(fobj=fobj)
        evals = []
        if has_train_in_valid:
            evals.extend(booster.eval_train(feval))
        evals.extend(booster.eval_valid(feval))
        try:
            for cb in callbacks_after:
                cb(CallbackEnv(booster, params, it, begin, end, evals,
                               telemetry))
        except EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            for name, metric, value, _ in e.best_score or []:
                booster.best_score.setdefault(name, {})[metric] = value
            break
        if stop:
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            break
    if booster.best_iteration < 0:
        booster.best_iteration = booster.inner.iter_
    with booster.inner._cache_lock:
        booster.inner.best_iteration = booster.best_iteration
    return booster


def _train_fused(booster: Booster, begin: int, end: int) -> None:
    """Iterations [begin, end) in fused blocks of ``tpu_iter_block``
    (the JAX package's engine fast path)."""
    inner = booster.inner
    block = int(inner.config.tpu_iter_block)
    stopped = False
    scheduled = begin       # iter_ lags by the in-flight pipelined block
    try:
        while scheduled < end:
            k = min(block, end - scheduled)
            stopped = inner.train_block(k)
            if stopped:
                break
            scheduled += k
    except BaseException:
        # best-effort cleanup; never mask the primary error
        try:
            inner.finish_fused("train_error")
        except BaseException:
            pass
        raise
    else:
        # the host trees are built one block behind the device: finalize
        # the block in flight
        stopped = inner.finish_fused("train_end") or stopped
    if stopped:
        Log.warning("Stopped training because there are no more leaves "
                    "that meet the split requirements")
    booster.best_iteration = inner.iter_
    # adopt()/restore() update this field from watcher threads under the
    # model lock; take it here too so the field has one guard
    with inner._cache_lock:
        inner.best_iteration = booster.best_iteration


class CVBooster:
    """Ensemble of per-fold boosters (reference: engine.py CVBooster)."""

    def __init__(self) -> None:
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name: str):
        def handler(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler


def _make_n_folds(full_data: Dataset, nfold: int, params: Dict[str, Any],
                  seed: int, stratified: bool, shuffle: bool):
    """(reference: engine.py _make_n_folds — stratified / group-aware folds)"""
    binned = full_data.construct(params)
    num_data = binned.num_data
    rng = np.random.RandomState(seed)
    group_info = binned.metadata.query_boundaries
    if group_info is not None:
        # group-wise folds: keep queries intact
        nq = len(group_info) - 1
        q_idx = rng.permutation(nq) if shuffle else np.arange(nq)
        folds_q = np.array_split(q_idx, nfold)
        for fq in folds_q:
            test_rows = np.concatenate(
                [np.arange(group_info[q], group_info[q + 1]) for q in fq]) \
                if len(fq) else np.array([], dtype=np.int64)
            train_rows = np.setdiff1d(np.arange(num_data), test_rows)
            yield train_rows, test_rows
        return
    label = binned.metadata.label
    if stratified and label is not None and len(np.unique(label)) < 50:
        order = []
        for v in np.unique(label):
            idx = np.flatnonzero(label == v)
            if shuffle:
                rng.shuffle(idx)
            order.append(idx)
        # interleave classes, then slice round-robin
        folds = [[] for _ in range(nfold)]
        for idx in order:
            for i, row in enumerate(idx):
                folds[i % nfold].append(row)
        for i in range(nfold):
            test_rows = np.asarray(sorted(folds[i]), dtype=np.int64)
            train_rows = np.setdiff1d(np.arange(num_data), test_rows)
            yield train_rows, test_rows
        return
    idx = rng.permutation(num_data) if shuffle else np.arange(num_data)
    for test_rows in np.array_split(idx, nfold):
        train_rows = np.setdiff1d(np.arange(num_data), test_rows)
        yield np.asarray(train_rows), np.asarray(sorted(test_rows))


def cv(
    params: Dict[str, Any],
    train_set: Dataset,
    num_boost_round: int = 100,
    nfold: int = 5,
    stratified: bool = True,
    shuffle: bool = True,
    metrics: Optional[Union[str, List[str]]] = None,
    fobj: Optional[Callable] = None,
    feval: Optional[Callable] = None,
    seed: int = 0,
    callbacks: Optional[List[Callable]] = None,
    eval_train_metric: bool = False,
    return_cvbooster: bool = False,
) -> Dict[str, Any]:
    """Cross-validation (reference: engine.py cv)."""
    params = resolve_aliases(dict(params))
    num_boost_round = int(params.pop("num_iterations", num_boost_round))
    if metrics:
        params["metric"] = metrics if isinstance(metrics, list) else [metrics]
    early_rounds = int(params.pop("early_stopping_round", 0) or 0)

    X = train_set.data
    label = train_set.label
    weight = train_set.weight
    group = train_set.group

    Xa = np.asarray(X, dtype=np.float64)
    cvb = CVBooster()
    fold_iters = []
    per_fold: List[Dict[str, List[float]]] = []
    for train_rows, test_rows in _make_n_folds(train_set, nfold, params, seed,
                                               stratified, shuffle):
        def subset_group(rows):
            if group is None:
                return None
            qb = train_set.construct(params).metadata.query_boundaries
            qid = np.zeros(len(label), dtype=np.int64)
            for q in range(len(qb) - 1):
                qid[qb[q]:qb[q + 1]] = q
            sub_qid = qid[rows]
            _, sizes = np.unique(sub_qid, return_counts=True)
            return sizes
        tr = Dataset(Xa[train_rows],
                     label=None if label is None else label[train_rows],
                     weight=None if weight is None else weight[train_rows],
                     group=subset_group(train_rows), params=dict(params))
        te = tr.create_valid(Xa[test_rows],
                             label=None if label is None else label[test_rows],
                             weight=None if weight is None else weight[test_rows],
                             group=subset_group(test_rows))
        fold_params = dict(params)
        fold_params["verbosity"] = -1
        if early_rounds:
            fold_params["early_stopping_round"] = early_rounds
        history: Dict[str, Dict[str, List[float]]] = {}
        bst = train(fold_params, tr, num_boost_round, valid_sets=[te],
                    valid_names=["valid"], fobj=fobj, feval=feval,
                    callbacks=list(callbacks or []) + [record_evaluation(history)])
        cvb.append(bst)
        fold_iters.append(bst.best_iteration)
        per_fold.append(history.get("valid", {}))
    cvb.best_iteration = int(np.min(fold_iters)) if fold_iters else -1

    # aggregate per-iteration metric history across folds
    # (reference cv contract: one list entry per boosting round)
    out: Dict[str, Any] = {}
    metrics_seen = sorted({m for h in per_fold for m in h})
    for metric in metrics_seen:
        series = [h[metric] for h in per_fold if metric in h]
        n_iters = min(len(s) for s in series)
        arr = np.asarray([s[:n_iters] for s in series])
        out["valid %s-mean" % metric] = [float(v) for v in arr.mean(axis=0)]
        out["valid %s-stdv" % metric] = [float(v) for v in arr.std(axis=0)]
    if return_cvbooster:
        out["cvbooster"] = cvb
    return out
