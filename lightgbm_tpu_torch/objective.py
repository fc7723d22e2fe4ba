"""Objective output transforms (PyTorch port of the serving part of
``lightgbm_tpu/objective.py``).

Serving needs an objective's identity and its ``convert_output`` (raw
score -> prediction space), for the regression family, binary,
multiclass softmax / one-vs-all and the cross-entropy objectives.
Gradients, hessians and ``boost_from_score`` come with the training slice.
``convert_output`` takes any array-like and returns a torch tensor of the
input's float dtype.
"""
from __future__ import annotations

import torch

from .config import Config, OBJECTIVE_ALIASES
from .utils.log import Log


def _as_float(score) -> torch.Tensor:
    t = torch.as_tensor(score)
    return t if t.is_floating_point() else t.to(torch.float64)


class ObjectiveFunction:
    """Interface (reference: include/LightGBM/objective_function.h:19)."""

    name = "custom"
    num_model_per_iteration = 1

    def __init__(self, config: Config) -> None:
        self.config = config

    def convert_output(self, score) -> torch.Tensor:
        """Raw score -> prediction space (reference: ConvertOutput)."""
        return _as_float(score)


class RegressionL2(ObjectiveFunction):
    """L2 loss; with reg_sqrt the model fits sqrt(|label|)*sign(label)."""
    name = "regression"

    def convert_output(self, score):
        s = _as_float(score)
        if self.config.reg_sqrt:
            return torch.sign(s) * s * s
        return s


class RegressionL1(RegressionL2):
    name = "regression_l1"


class RegressionHuber(RegressionL2):
    name = "huber"


class RegressionFair(RegressionL2):
    name = "fair"


class RegressionQuantile(RegressionL2):
    name = "quantile"


class RegressionMAPE(RegressionL2):
    name = "mape"


class RegressionPoisson(RegressionL2):
    """Log link (poisson, gamma, tweedie)."""
    name = "poisson"

    def convert_output(self, score):
        return torch.exp(_as_float(score))


class RegressionGamma(RegressionPoisson):
    name = "gamma"


class RegressionTweedie(RegressionPoisson):
    name = "tweedie"


class BinaryLogloss(ObjectiveFunction):
    name = "binary"

    def convert_output(self, score):
        return 1.0 / (1.0 + torch.exp(-self.config.sigmoid
                                      * _as_float(score)))


class MulticlassSoftmax(ObjectiveFunction):
    """Softmax, K trees per iteration."""
    name = "multiclass"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.num_class = int(config.num_class)
        self.num_model_per_iteration = self.num_class

    def convert_output(self, score):
        return torch.softmax(_as_float(score), dim=1)


class MulticlassOVA(MulticlassSoftmax):
    """K one-vs-all binary objectives."""
    name = "multiclassova"

    def convert_output(self, score):
        return 1.0 / (1.0 + torch.exp(-self.config.sigmoid
                                      * _as_float(score)))


class CrossEntropy(ObjectiveFunction):
    name = "cross_entropy"

    def convert_output(self, score):
        return torch.sigmoid(_as_float(score))


class CrossEntropyLambda(ObjectiveFunction):
    name = "cross_entropy_lambda"

    def convert_output(self, score):
        return torch.log1p(torch.exp(_as_float(score)))


class NoneObjective(ObjectiveFunction):
    """Custom objective: raw scores pass through."""
    name = "none"


_REGISTRY = {cls.name: cls for cls in (
    RegressionL2, RegressionL1, RegressionHuber, RegressionFair,
    RegressionPoisson, RegressionQuantile, RegressionMAPE, RegressionGamma,
    RegressionTweedie, BinaryLogloss, MulticlassSoftmax, MulticlassOVA,
    CrossEntropy, CrossEntropyLambda, NoneObjective)}


def create_objective(config: Config) -> ObjectiveFunction:
    """Factory (reference: src/objective/objective_function.cpp:15)."""
    name = OBJECTIVE_ALIASES.get(config.objective, config.objective)
    if name not in _REGISTRY:
        Log.fatal("Objective %s is not served by the port yet",
                  config.objective)
    return _REGISTRY[name](config)
