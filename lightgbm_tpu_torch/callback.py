"""Training callbacks (PyTorch port of ``lightgbm_tpu/callback.py``;
reference: python-package/lightgbm/callback.py print_evaluation /
record_evaluation / reset_parameter / early_stopping, with the same
CallbackEnv protocol)."""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Union

from .utils.log import Log

# ``telemetry`` (the process-global obs.Telemetry registry) defaults to None
# so positional six-field constructions keep working.
CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list", "telemetry"],
    defaults=(None,))


class EarlyStopException(Exception):
    """(reference: callback.py EarlyStopException)"""

    def __init__(self, best_iteration: int, best_score) -> None:
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def _fmt_eval(res) -> str:
    name, metric, value, _ = res[:4]
    return "%s's %s: %g" % (name, metric, value)


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """(reference: callback.py:51 print_evaluation)"""

    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(_fmt_eval(x) for x in env.evaluation_result_list)
            Log.info("[%d]\t%s", env.iteration + 1, result)

    _callback.order = 10
    return _callback


print_evaluation = log_evaluation


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]) -> Callable:
    """(reference: callback.py:74)"""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _init(env: CallbackEnv) -> None:
        for name, metric, _, _ in env.evaluation_result_list or []:
            eval_result.setdefault(name, collections.OrderedDict())
            eval_result[name].setdefault(metric, [])

    def _callback(env: CallbackEnv) -> None:
        if not eval_result:
            _init(env)
        for name, metric, value, _ in env.evaluation_result_list or []:
            eval_result.setdefault(name, collections.OrderedDict())
            eval_result[name].setdefault(metric, []).append(value)

    _callback.order = 20
    return _callback


def reset_parameter(**kwargs: Union[list, Callable]) -> Callable:
    """Schedule parameters by iteration, e.g. learning_rate=list|fn
    (reference: callback.py:105)."""

    def _callback(env: CallbackEnv) -> None:
        new_params = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError("Length of list %r should equal num_boost_round"
                                     % key)
                new_params[key] = value[env.iteration - env.begin_iteration]
            elif callable(value):
                new_params[key] = value(env.iteration - env.begin_iteration)
        if new_params:
            env.model.reset_parameter(new_params)

    _callback.before_iteration = True
    _callback.order = 10
    return _callback


class _MetricState:
    """Best-so-far tracker for one (dataset, metric) evaluation stream."""

    __slots__ = ("best_value", "best_round", "best_results", "sign", "tol")

    def __init__(self, greater_is_better: bool, min_delta: float) -> None:
        # store scores as "higher is better" internally so one comparison
        # serves both orientations
        self.sign = 1.0 if greater_is_better else -1.0
        self.tol = abs(min_delta)
        self.best_value = float("-inf")
        self.best_round = 0
        self.best_results = None

    def update(self, value: float, round_idx: int, results) -> None:
        oriented = self.sign * value
        if oriented > self.best_value + self.tol or self.best_results is None:
            self.best_value = oriented
            self.best_round = round_idx
            self.best_results = results

    def rounds_since_best(self, round_idx: int) -> int:
        return round_idx - self.best_round


class _EarlyStopper:
    """Stop when no tracked validation metric improved for
    ``stopping_rounds`` consecutive rounds (reference behavior:
    python-package/lightgbm/callback.py early_stopping; implementation is
    original)."""

    order = 30
    before_iteration = False

    def __init__(self, stopping_rounds: int, first_metric_only: bool,
                 verbose: bool, min_delta: float) -> None:
        if stopping_rounds <= 0:
            raise ValueError("stopping_rounds must be positive")
        self.patience = int(stopping_rounds)
        self.first_metric_only = first_metric_only
        self.verbose = verbose
        self.min_delta = min_delta
        self.states: Dict[tuple, _MetricState] = {}
        self.active = None  # None = not yet initialized

    def _report(self, prefix: str, state: _MetricState) -> None:
        if self.verbose:
            detail = "\t".join(_fmt_eval(x) for x in state.best_results)
            Log.info("%s best iteration is: [%d]\t%s",
                     prefix, state.best_round + 1, detail)

    def __call__(self, env: CallbackEnv) -> None:
        results = env.evaluation_result_list
        if self.active is None:
            self.active = bool(results)
            if not self.active:
                Log.warning("Early stopping requires at least one validation set")
            elif self.verbose:
                Log.info("Training until validation scores don't improve "
                         "for %d rounds", self.patience)
        if not self.active:
            return
        tracked_metric = results[0][1]
        stop_with = None
        for name, metric, value, greater_is_better in results:
            key = (name, metric)
            state = self.states.get(key)
            if state is None:
                state = self.states[key] = _MetricState(greater_is_better,
                                                        self.min_delta)
            state.update(value, env.iteration, results)
            if name == "training":
                continue  # never stop on the training metric
            if self.first_metric_only and metric != tracked_metric:
                continue
            if stop_with is None and \
                    state.rounds_since_best(env.iteration) >= self.patience:
                stop_with = state
        last_round = env.iteration == env.end_iteration - 1
        if stop_with is None and last_round:
            for (name, _), state in self.states.items():
                if name != "training":
                    self._report("Did not meet early stopping.", state)
                    raise EarlyStopException(state.best_round, state.best_results)
        if stop_with is not None:
            self._report("Early stopping,", stop_with)
            raise EarlyStopException(stop_with.best_round, stop_with.best_results)


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True, min_delta: float = 0.0) -> Callable:
    """Early-stopping callback factory (same surface as the reference
    python package's ``early_stopping``)."""
    return _EarlyStopper(stopping_rounds, first_metric_only, verbose, min_delta)
