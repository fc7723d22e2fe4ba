"""Objective functions (PyTorch port of ``lightgbm_tpu/objective.py``).

Serving needs an objective's identity and its ``convert_output`` (raw
score -> prediction space), for the regression family, binary,
multiclass softmax / one-vs-all and the cross-entropy objectives.
``convert_output`` takes any array-like and returns a torch tensor of the
input's float dtype.

Training needs ``init(metadata, device)``, ``get_gradients(score)`` (f32
device tensors, the JAX package's arithmetic in its order) and
``boost_from_score``. They are ported for L2 regression, binary logloss
(with ``is_unbalance`` / ``scale_pos_weight``) and multiclass softmax; the
other objectives serve but refuse to train (ROADMAP A10).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config, OBJECTIVE_ALIASES
from .utils.log import LightGBMError, Log


def _as_float(score) -> torch.Tensor:
    t = torch.as_tensor(score)
    return t if t.is_floating_point() else t.to(torch.float64)


class ObjectiveFunction:
    """Interface (reference: include/LightGBM/objective_function.h:19)."""

    name = "custom"
    num_model_per_iteration = 1
    need_renew = False
    #: the port has this objective's gradients (the others serve only)
    trainable = False

    def __init__(self, config: Config) -> None:
        self.config = config
        self.label: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None
        self.num_data = 0

    def init(self, metadata, device: torch.device = torch.device("cpu")
             ) -> None:
        """Bind the training labels and weights (f32, on ``device``)."""
        if not self.trainable:
            raise LightGBMError("training objective=%s is not ported to the "
                                "PyTorch/CUDA package yet (ROADMAP A10)"
                                % self.name)
        if metadata.label is None:
            raise LightGBMError("objective %s needs labels" % self.name)
        self.num_data = metadata.num_data
        self._label_host = np.array(metadata.label, np.float32)
        self._weight_host = None if metadata.weight is None \
            else np.array(metadata.weight, np.float32)
        self.label = torch.as_tensor(self._label_host).to(device)
        self.weight = None if self._weight_host is None \
            else torch.as_tensor(self._weight_host).to(device)

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        """Initial raw score (reference: BoostFromScore, gbdt.cpp:333)."""
        return 0.0

    def convert_output(self, score) -> torch.Tensor:
        """Raw score -> prediction space (reference: ConvertOutput)."""
        return _as_float(score)


def _weighted(grad, hess, weight):
    if weight is None:
        return grad, hess
    return grad * weight, hess * weight


class RegressionL2(ObjectiveFunction):
    """L2 loss; with reg_sqrt the model fits sqrt(|label|)*sign(label)
    (reference: regression_objective.hpp RegressionL2loss)."""
    name = "regression"
    trainable = True

    def init(self, metadata, device=torch.device("cpu")) -> None:
        super().init(metadata, device)
        if self.config.reg_sqrt:
            lab = self._label_host
            self._label_host = (np.sign(lab) * np.sqrt(np.abs(lab))) \
                .astype(np.float32)
            self.label = torch.as_tensor(self._label_host).to(device)

    def get_gradients(self, score):
        g = score - self.label
        h = torch.ones_like(score)
        return _weighted(g, h, self.weight)

    def boost_from_score(self, class_id: int = 0) -> float:
        return float(np.average(self._label_host, weights=self._weight_host))

    def convert_output(self, score):
        s = _as_float(score)
        if self.config.reg_sqrt:
            return torch.sign(s) * s * s
        return s


class RegressionL1(RegressionL2):
    name = "regression_l1"
    need_renew = True
    trainable = False


class RegressionHuber(RegressionL2):
    name = "huber"
    trainable = False


class RegressionFair(RegressionL2):
    name = "fair"
    trainable = False


class RegressionQuantile(RegressionL2):
    name = "quantile"
    need_renew = True
    trainable = False


class RegressionMAPE(RegressionL2):
    name = "mape"
    need_renew = True
    trainable = False


class RegressionPoisson(RegressionL2):
    """Log link (poisson, gamma, tweedie)."""
    name = "poisson"
    trainable = False

    def convert_output(self, score):
        return torch.exp(_as_float(score))


class RegressionGamma(RegressionPoisson):
    name = "gamma"


class RegressionTweedie(RegressionPoisson):
    name = "tweedie"


class BinaryLogloss(ObjectiveFunction):
    """Sigmoid binary cross-entropy (reference: binary_objective.hpp),
    with is_unbalance / scale_pos_weight label weighting."""
    name = "binary"
    trainable = True

    def init(self, metadata, device=torch.device("cpu")) -> None:
        super().init(metadata, device)
        lab = self._label_host
        uniq = np.unique(lab)
        if not np.all(np.isin(uniq, [0, 1])):
            Log.fatal("[binary]: labels must be 0 or 1, got %s", uniq[:5])
        w = self._weight_host
        cnt_pos = float(np.sum((lab > 0) * (w if w is not None else 1.0)))
        cnt_neg = float(np.sum((lab <= 0) * (w if w is not None else 1.0)))
        self._pavg = cnt_pos / max(cnt_pos + cnt_neg, 1e-10)
        pos_w, neg_w = 1.0, 1.0
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                neg_w = cnt_pos / cnt_neg
            else:
                pos_w = cnt_neg / cnt_pos
        pos_w *= self.config.scale_pos_weight
        self._label_sign = torch.as_tensor(
            np.where(lab > 0, 1.0, -1.0).astype(np.float32)).to(device)
        self._label_w = torch.as_tensor(
            np.where(lab > 0, pos_w, neg_w).astype(np.float32)).to(device)

    def get_gradients(self, score):
        sig = self.config.sigmoid
        y = self._label_sign
        response = -y * sig / (1.0 + torch.exp(y * sig * score))
        absr = torch.abs(response)
        g = response * self._label_w
        h = absr * (sig - absr) * self._label_w
        return _weighted(g, h, self.weight)

    def boost_from_score(self, class_id: int = 0) -> float:
        p = np.clip(self._pavg, 1e-15, 1 - 1e-15)
        return float(np.log(p / (1 - p)) / self.config.sigmoid)

    def convert_output(self, score):
        return 1.0 / (1.0 + torch.exp(-self.config.sigmoid
                                      * _as_float(score)))


class MulticlassSoftmax(ObjectiveFunction):
    """Softmax, K trees per iteration."""
    name = "multiclass"
    trainable = True

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.num_class = int(config.num_class)
        self.num_model_per_iteration = self.num_class

    def init(self, metadata, device=torch.device("cpu")) -> None:
        super().init(metadata, device)
        lab = self._label_host.astype(np.int32)
        if lab.min() < 0 or lab.max() >= self.num_class:
            Log.fatal("[multiclass]: labels must be in [0, num_class)")
        self._onehot = torch.as_tensor(
            np.eye(self.num_class, dtype=np.float32)[lab]).to(device)

    def get_gradients(self, score):
        p = torch.softmax(score, dim=1)
        g = p - self._onehot
        # hessian upper-bound factor K/(K-1) (multiclass_objective.hpp:31)
        factor = self.num_class / max(self.num_class - 1, 1)
        h = factor * p * (1.0 - p)
        if self.weight is not None:
            g = g * self.weight[:, None]
            h = h * self.weight[:, None]
        return g, h

    def convert_output(self, score):
        return torch.softmax(_as_float(score), dim=1)


class MulticlassOVA(MulticlassSoftmax):
    """K one-vs-all binary objectives."""
    name = "multiclassova"
    trainable = False

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
    """Custom objective: raw scores pass through; gradients come from the
    caller's ``fobj``."""
    name = "none"
    trainable = True

    def get_gradients(self, score):
        raise LightGBMError("objective=none trains only with an fobj that "
                            "supplies gradients and hessians")


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
