"""Training entry point (PyTorch port of ``lightgbm_tpu/engine.py``;
reference: python-package/lightgbm/engine.py:14 train).

The port runs the JAX package's eager loop, one ``Booster.update`` per
iteration with callbacks and valid-set evaluation between iterations. The
fused K-iteration block (ROADMAP A9) and ``cv`` are later work.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Union

from .basic import Booster, Dataset
from .callback import CallbackEnv, EarlyStopException, early_stopping, \
    log_evaluation
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
    if int(params.get("verbosity", 1)) > 0 \
            and not any(getattr(c, "order", None) == 10 for c in callbacks):
        callbacks.append(log_evaluation(int(params.get("metric_freq", 1))))
    callbacks_before = sorted(
        (c for c in callbacks if getattr(c, "before_iteration", False)),
        key=lambda c: getattr(c, "order", 0))
    callbacks_after = sorted(
        (c for c in callbacks if not getattr(c, "before_iteration", False)),
        key=lambda c: getattr(c, "order", 0))

    begin = booster.inner.iter_
    end = begin + num_boost_round
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
