"""Objective functions: score -> (gradient, hessian) as torch tensor ops.

Port of ``lightgbm_tpu/core/objective.py`` for the objectives of the
first slice: ``RegressionL2`` and ``BinaryLogloss`` (ref:
include/LightGBM/objective_function.h:20, src/objective/
regression_objective.hpp, binary_objective.hpp).

``get_gradients`` runs on the score's device in f32 and repeats the JAX
package's expression term for term, so the per-row rounding is the same
(up to the last ulp of ``exp``, which differs between math libraries).
Host-side set-up (label statistics, the boost-from-average score) stays
numpy in f64, exactly as the JAX package does it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config, canonical_objective
from ..utils import log

# ref: include/LightGBM/meta.h kEpsilon
K_EPSILON = 1e-15


class ObjectiveFunction:
    """Base objective (ref: objective_function.h:20)."""

    NAME = "custom"

    def __init__(self, config: Config):
        self.config = config
        self.num_data = 0
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self._label_dev: Optional[torch.Tensor] = None
        self._weight_dev: Optional[torch.Tensor] = None

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        self.num_data = num_data
        self.label = metadata.label
        self.weight = metadata.weight
        f32 = lambda a: (torch.as_tensor(a, dtype=torch.float32,
                                         device=device)
                         if a is not None else None)
        self._label_dev = f32(self.label)
        self._weight_dev = f32(self.weight)

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """score f32 [N] -> (grad, hess) f32 [N]."""
        raise NotImplementedError

    def _apply_weight(self, grad, hess):
        if self._weight_dev is not None:
            grad = grad * self._weight_dev
            hess = hess * self._weight_dev
        return grad, hess

    @property
    def num_model_per_iteration(self) -> int:
        return 1

    def class_need_train(self, class_id: int) -> bool:
        return True

    def boost_from_score(self, class_id: int) -> float:
        return 0.0

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        """Raw score -> prediction space (ref: ConvertOutput)."""
        return raw

    def to_string(self) -> str:
        return self.NAME


class RegressionL2(ObjectiveFunction):
    """ref: regression_objective.hpp RegressionL2loss."""

    NAME = "regression"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = bool(config.reg_sqrt)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if self.sqrt:
            lbl = np.sign(self.label) * np.sqrt(np.abs(self.label))
            self.label = lbl.astype(np.float32)
            self._label_dev = torch.as_tensor(self.label, device=device)

    def get_gradients(self, score):
        grad = score - self._label_dev
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id):
        if self.weight is not None:
            return float(np.sum(self.label * self.weight) /
                         np.sum(self.weight))
        return float(np.mean(self.label))

    def convert_output(self, raw):
        if self.sqrt:
            return np.sign(raw) * raw * raw
        return raw

    def to_string(self):
        return self.NAME + (" sqrt" if self.sqrt else "")


class BinaryLogloss(ObjectiveFunction):
    """ref: binary_objective.hpp BinaryLogloss."""

    NAME = "binary"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0:
            log.fatal(f"Sigmoid parameter {self.sigmoid} should be > 0")
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)
        if self.is_unbalance and abs(self.scale_pos_weight - 1.0) > 1e-6:
            log.fatal("Cannot set is_unbalance and scale_pos_weight together")
        self.need_train = True
        self.num_pos_data = 0

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        pos_mask = self.label > 0
        cnt_pos = int(pos_mask.sum())
        cnt_neg = num_data - cnt_pos
        self.num_pos_data = cnt_pos
        self.need_train = cnt_pos > 0 and cnt_neg > 0
        if not self.need_train:
            log.warning("Contains only one class")
        log.info(f"Number of positive: {cnt_pos}, number of negative: "
                 f"{cnt_neg}")
        w_pos, w_neg = 1.0, 1.0
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.scale_pos_weight
        # per-row signed label (+1/-1) and label weight, as f32 tensors
        self._sign = torch.as_tensor(np.where(pos_mask, 1.0, -1.0),
                                     dtype=torch.float32, device=device)
        self._lw = torch.as_tensor(np.where(pos_mask, w_pos, w_neg),
                                   dtype=torch.float32, device=device)
        self._pos_mask = pos_mask

    def get_gradients(self, score):
        if not self.need_train:
            return torch.zeros_like(score), torch.zeros_like(score)
        # the JAX package's expression, operation for operation
        response = -self._sign * self.sigmoid / (
            1.0 + torch.exp(self._sign * self.sigmoid * score))
        abs_response = torch.abs(response)
        grad = response * self._lw
        hess = abs_response * (self.sigmoid - abs_response) * self._lw
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id):
        if self.weight is not None:
            suml = float(np.sum(self._pos_mask * self.weight))
            sumw = float(np.sum(self.weight))
        else:
            suml = float(np.sum(self._pos_mask))
            sumw = float(self.num_data)
        pavg = min(max(suml / sumw, K_EPSILON), 1.0 - K_EPSILON)
        initscore = math.log(pavg / (1.0 - pavg)) / self.sigmoid
        log.info(f"[{self.NAME}:BoostFromScore]: pavg={pavg:.6f} -> "
                 f"initscore={initscore:.6f}")
        return initscore

    def class_need_train(self, class_id):
        return self.need_train

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * raw))

    def to_string(self):
        return f"{self.NAME} sigmoid:{self.sigmoid:g}"


_OBJECTIVES = {"regression": RegressionL2, "binary": BinaryLogloss}


def create_objective(name: str, config: Config) -> ObjectiveFunction:
    canonical = canonical_objective(name)
    if canonical not in _OBJECTIVES:
        log.fatal(f"objective {name!r} is not ported yet; the port "
                  f"trains {'/'.join(_OBJECTIVES)}")
    return _OBJECTIVES[canonical](config)
