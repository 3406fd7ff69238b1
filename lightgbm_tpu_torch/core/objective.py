"""Objective functions: score -> (gradient, hessian) as torch tensor ops.

Port of ``lightgbm_tpu/core/objective.py`` (ref:
include/LightGBM/objective_function.h:20, src/objective/
regression_objective.hpp, binary_objective.hpp, multiclass_objective.hpp,
xentropy_objective.hpp): the regression family (L2, L1, Huber, Fair,
Poisson, Quantile, MAPE, Gamma, Tweedie), binary logloss, multiclass
softmax and one-vs-all, the two cross-entropies and the adapter for
gradients the caller supplies (``CustomObjective``). Ranking
(``lambdarank``, ``rank_xendcg``) is refused: it needs query metadata
(ROADMAP A12.2b).

``get_gradients`` runs on the score's device in f32 and repeats the JAX
package's expression term for term, so the per-row rounding is the same
up to the last ulps of ``exp`` and of the logistic function, which differ
between math libraries (ROADMAP C1(a)): ``torch.exp`` is within 1 ulp of
XLA's CPU ``exp``, and ``torch.sigmoid``, the closest torch expression to
``jax.nn.sigmoid`` (``lax.logistic``), within 2 ulp. The softmax is
written as ``jax.nn.softmax`` computes it (``x - max``, ``exp``, divide
by the sum over classes), so with the same ``exp`` values it is the JAX
package's bit for bit. Host-side set-up (label statistics, the
boost-from-average score) and the percentile leaf renewal of L1,
quantile and MAPE stay numpy in f64, exactly as the JAX package does
them.

Score layout: ``[N]`` for one model per iteration, ``[K, N]`` class-major
for the multiclass objectives.
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


def _percentile(values: np.ndarray, alpha: float) -> float:
    """Unweighted percentile (ref: regression_objective.hpp
    PercentileFun): an interpolated order statistic counted from the top
    of the descending order."""
    values = np.asarray(values, dtype=np.float64)
    n = len(values)
    if n == 0:
        return 0.0
    if n <= 1:
        return float(values[0])
    s = np.sort(values)[::-1]
    float_pos = (n - 1) * (1.0 - alpha)
    pos = int(float_pos) + 1
    if pos < 1:
        return float(s.min())
    if pos >= n:
        return float(s.max())
    bias = float_pos - (pos - 1)
    v1 = s[pos - 1]
    v2 = s[pos]
    return float(v1 - (v1 - v2) * bias)


def _weighted_percentile(values: np.ndarray, weights: np.ndarray,
                         alpha: float) -> float:
    """Weighted percentile (ref: regression_objective.hpp
    WeightedPercentileFun)."""
    values = np.asarray(values, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)
    n = len(values)
    if n == 0:
        return 0.0
    if n <= 1:
        return float(values[0])
    order = np.argsort(values, kind="stable")
    wcdf = np.cumsum(weights[order])
    threshold = wcdf[-1] * alpha
    pos = int(np.searchsorted(wcdf, threshold, side="right"))
    pos = min(pos, n - 1)
    if pos == 0 or pos == n - 1:
        return float(values[order[pos]])
    v1 = float(values[order[pos - 1]])
    v2 = float(values[order[pos]])
    if wcdf[pos] - wcdf[pos - 1] >= 1.0:
        return (threshold - wcdf[pos - 1]) / (wcdf[pos] - wcdf[pos - 1]) \
            * (v2 - v1) + v1
    return v1


def _exp(x):
    """``exp`` of a numpy array or a torch tensor."""
    return torch.exp(x) if isinstance(x, torch.Tensor) else np.exp(x)


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
        """score f32 [N] (or [K, N]) -> (grad, hess) of the same shape."""
        raise NotImplementedError

    def _apply_weight(self, grad, hess):
        if self._weight_dev is not None:
            grad = grad * self._weight_dev
            hess = hess * self._weight_dev
        return grad, hess

    @property
    def num_model_per_iteration(self) -> int:
        return 1

    @property
    def num_predict_one_row(self) -> int:
        return 1

    def is_renew_tree_output(self) -> bool:
        return False

    def class_need_train(self, class_id: int) -> bool:
        return True

    def boost_from_score(self, class_id: int) -> float:
        return 0.0

    def convert_output(self, raw):
        """Raw score -> prediction space (ref: ConvertOutput), for a numpy
        array or a torch tensor alike."""
        return raw

    def renew_tree_output(self, pred: np.ndarray, residual_fn,
                          leaf_index: np.ndarray, num_leaves: int
                          ) -> Optional[np.ndarray]:
        """Per-leaf outputs refit on the host (ref: RenewTreeOutput):
        f64 ``[num_leaves]``, or None to keep the grower's."""
        return None

    def to_string(self) -> str:
        return self.NAME


# ---------------------------------------------------------------------------
# Regression family (ref: regression_objective.hpp)
# ---------------------------------------------------------------------------

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
            sign = (torch.sign if isinstance(raw, torch.Tensor)
                    else np.sign)
            return sign(raw) * raw * raw
        return raw

    def to_string(self):
        return self.NAME + (" sqrt" if self.sqrt else "")


class _PercentileRenew:
    """Leaf renewal of the percentile objectives (L1, quantile, MAPE)."""

    def _renew_weights(self, idx: np.ndarray) -> Optional[np.ndarray]:
        return None if self.weight is None else self.weight[idx]

    def _renew(self, residual_fn, leaf_index, num_leaves, alpha):
        """Each leaf's (weighted) ``alpha`` percentile of the residuals
        ``label - score`` of its rows, the score taken before this tree."""
        out = np.zeros(num_leaves, dtype=np.float64)
        residual = residual_fn()
        for leaf in range(num_leaves):
            idx = np.flatnonzero(leaf_index == leaf)
            if len(idx) == 0:
                continue
            w = self._renew_weights(idx)
            out[leaf] = (_percentile(residual[idx], alpha) if w is None
                         else _weighted_percentile(residual[idx], w, alpha))
        return out


class RegressionL1(_PercentileRenew, RegressionL2):
    """ref: regression_objective.hpp RegressionL1loss: the sign of the
    residual, leaves renewed to the residuals' median."""

    NAME = "regression_l1"
    RENEW_ALPHA = 0.5

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = False

    def get_gradients(self, score):
        grad = torch.sign(score - self._label_dev)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def is_renew_tree_output(self):
        return True

    def boost_from_score(self, class_id):
        if self.weight is not None:
            return _weighted_percentile(self.label, self.weight,
                                        self.RENEW_ALPHA)
        return _percentile(self.label, self.RENEW_ALPHA)

    def renew_tree_output(self, pred, residual_fn, leaf_index, num_leaves):
        return self._renew(residual_fn, leaf_index, num_leaves,
                           self.RENEW_ALPHA)

    def to_string(self):
        return self.NAME


class RegressionHuber(RegressionL2):
    NAME = "huber"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = False
        self.alpha = float(config.alpha)

    def get_gradients(self, score):
        grad = torch.clamp(score - self._label_dev, -self.alpha, self.alpha)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def to_string(self):
        return self.NAME


class RegressionFair(RegressionL2):
    """Fair loss; like the JAX package it keeps ``reg_sqrt``."""

    NAME = "fair"

    def __init__(self, config: Config):
        super().__init__(config)
        self.c = float(config.fair_c)

    def get_gradients(self, score):
        x = score - self._label_dev
        denom = torch.abs(x) + self.c
        grad = self.c * x / denom
        hess = self.c * self.c / (denom * denom)
        return self._apply_weight(grad, hess)

    def to_string(self):
        return self.NAME


class RegressionPoisson(RegressionL2):
    NAME = "poisson"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = False
        self.max_delta_step = float(config.poisson_max_delta_step)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if np.min(self.label) < 0.0:
            log.fatal(f"[{self.NAME}]: at least one target label is negative")
        if np.sum(self.label) == 0.0:
            log.fatal(f"[{self.NAME}]: sum of labels is zero")

    def get_gradients(self, score):
        exp_score = torch.exp(score)
        grad = exp_score - self._label_dev
        hess = exp_score * math.exp(self.max_delta_step)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id):
        mean = RegressionL2.boost_from_score(self, class_id)
        return math.log(mean) if mean > 0 else math.log(K_EPSILON)

    def convert_output(self, raw):
        return _exp(raw)

    def to_string(self):
        return self.NAME


class RegressionQuantile(_PercentileRenew, RegressionL2):
    """Quantile loss, leaves renewed to the residuals' ``alpha``
    percentile; like the JAX package it keeps ``reg_sqrt``."""

    NAME = "quantile"

    def __init__(self, config: Config):
        super().__init__(config)
        self.alpha = float(config.alpha)
        if not (0.0 < self.alpha < 1.0):
            log.fatal("alpha must be in (0, 1) for quantile objective")

    def get_gradients(self, score):
        delta = score - self._label_dev
        # two Python scalars: f32, as the JAX package's weak-typed ones
        grad = torch.where(delta >= 0, 1.0 - self.alpha, -self.alpha)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def is_renew_tree_output(self):
        return True

    def boost_from_score(self, class_id):
        if self.weight is not None:
            return _weighted_percentile(self.label, self.weight, self.alpha)
        return _percentile(self.label, self.alpha)

    def renew_tree_output(self, pred, residual_fn, leaf_index, num_leaves):
        return self._renew(residual_fn, leaf_index, num_leaves, self.alpha)

    def to_string(self):
        return self.NAME


class RegressionMAPE(RegressionL1):
    """MAPE: the L1 gradient scaled by ``1 / max(1, |label|)`` (times the
    weight), leaves renewed to the weighted median of the residuals."""

    NAME = "mape"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if np.any(np.abs(self.label) < 1):
            log.warning("Some label values are < 1 in absolute value. MAPE "
                        "is unstable with such values; rounding them to 1.0")
        lw = 1.0 / np.maximum(1.0, np.abs(self.label))
        if self.weight is not None:
            lw = lw * self.weight
        self.label_weight = lw.astype(np.float32)
        self._label_weight_dev = torch.as_tensor(self.label_weight,
                                                 device=device)

    def get_gradients(self, score):
        grad = torch.sign(score - self._label_dev) * self._label_weight_dev
        hess = (self._weight_dev if self._weight_dev is not None
                else torch.ones_like(score))
        return grad, hess

    def boost_from_score(self, class_id):
        return _weighted_percentile(self.label, self.label_weight, 0.5)

    def _renew_weights(self, idx):
        return self.label_weight[idx]


class RegressionGamma(RegressionPoisson):
    NAME = "gamma"

    def get_gradients(self, score):
        exp_neg = torch.exp(-score)
        grad = 1.0 - self._label_dev * exp_neg
        hess = self._label_dev * exp_neg
        return self._apply_weight(grad, hess)


class RegressionTweedie(RegressionPoisson):
    NAME = "tweedie"

    def __init__(self, config: Config):
        super().__init__(config)
        self.rho = float(config.tweedie_variance_power)

    def get_gradients(self, score):
        e1 = torch.exp((1.0 - self.rho) * score)
        e2 = torch.exp((2.0 - self.rho) * score)
        grad = -self._label_dev * e1 + e2
        hess = -self._label_dev * (1.0 - self.rho) * e1 + (2.0 - self.rho) * e2
        return self._apply_weight(grad, hess)


# ---------------------------------------------------------------------------
# Binary classification (ref: binary_objective.hpp)
# ---------------------------------------------------------------------------

class BinaryLogloss(ObjectiveFunction):
    """ref: binary_objective.hpp BinaryLogloss. ``is_pos`` maps the label
    array to the positive mask (one-vs-all passes ``label == k``)."""

    NAME = "binary"

    def __init__(self, config: Config, is_pos=None):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0:
            log.fatal(f"Sigmoid parameter {self.sigmoid} should be > 0")
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)
        if self.is_unbalance and abs(self.scale_pos_weight - 1.0) > 1e-6:
            log.fatal("Cannot set is_unbalance and scale_pos_weight together")
        self.is_pos = is_pos or (lambda y: y > 0)
        self.need_train = True
        self.num_pos_data = 0

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        pos_mask = self.is_pos(self.label)
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
        return 1.0 / (1.0 + _exp(-self.sigmoid * raw))

    def to_string(self):
        return f"{self.NAME} sigmoid:{self.sigmoid:g}"


# ---------------------------------------------------------------------------
# Multiclass (ref: multiclass_objective.hpp)
# ---------------------------------------------------------------------------

def softmax(x, axis: int):
    """``jax.nn.softmax``'s order of operations: subtract the maximum over
    ``axis``, ``exp``, divide by the sum over ``axis``; a numpy array or a
    torch tensor."""
    if isinstance(x, torch.Tensor):
        e = torch.exp(x - x.amax(dim=axis, keepdim=True))
        return e / e.sum(dim=axis, keepdim=True)
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


class MulticlassSoftmax(ObjectiveFunction):
    """Softmax over ``[K, N]`` class-major scores."""

    NAME = "multiclass"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        self.factor = self.num_class / (self.num_class - 1.0)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        label_int = self.label.astype(np.int32)
        if label_int.min() < 0 or label_int.max() >= self.num_class:
            log.fatal(f"Label must be in [0, {self.num_class})")
        w = self.weight if self.weight is not None else np.ones(num_data)
        probs = np.zeros(self.num_class)
        np.add.at(probs, label_int, w)
        self.class_init_probs = probs / w.sum()
        # one-hot labels [K, N] on the training device
        self._onehot = torch.as_tensor(
            label_int[None, :] == np.arange(self.num_class)[:, None],
            dtype=torch.float32, device=device)

    def get_gradients(self, score):
        p = softmax(score, 0)
        grad = p - self._onehot
        hess = self.factor * p * (1.0 - p)
        if self._weight_dev is not None:
            grad = grad * self._weight_dev[None, :]
            hess = hess * self._weight_dev[None, :]
        return grad, hess

    @property
    def num_model_per_iteration(self):
        return self.num_class

    @property
    def num_predict_one_row(self):
        return self.num_class

    def boost_from_score(self, class_id):
        return math.log(max(K_EPSILON, self.class_init_probs[class_id]))

    def class_need_train(self, class_id):
        p = self.class_init_probs[class_id]
        return K_EPSILON < abs(p) < 1.0 - K_EPSILON

    def convert_output(self, raw):
        """``[..., K]`` raw scores -> softmax over the last axis."""
        return softmax(raw, -1)

    def to_string(self):
        return f"{self.NAME} num_class:{self.num_class}"


class MulticlassOVA(ObjectiveFunction):
    """One binary logloss per class, positive where ``label == k``."""

    NAME = "multiclassova"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        self.sigmoid = float(config.sigmoid)
        self.binary_losses = [
            BinaryLogloss(config,
                          is_pos=(lambda y, k=k: y.astype(np.int32) == k))
            for k in range(self.num_class)]

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        for b in self.binary_losses:
            b.init(metadata, num_data, device)

    def get_gradients(self, score):
        pairs = [b.get_gradients(score[k])
                 for k, b in enumerate(self.binary_losses)]
        return (torch.stack([g for g, _ in pairs]),
                torch.stack([h for _, h in pairs]))

    @property
    def num_model_per_iteration(self):
        return self.num_class

    @property
    def num_predict_one_row(self):
        return self.num_class

    def boost_from_score(self, class_id):
        return self.binary_losses[class_id].boost_from_score(0)

    def class_need_train(self, class_id):
        return self.binary_losses[class_id].need_train

    def convert_output(self, raw):
        return 1.0 / (1.0 + _exp(-self.sigmoid * raw))

    def to_string(self):
        return (f"{self.NAME} num_class:{self.num_class} "
                f"sigmoid:{self.sigmoid:g}")


# ---------------------------------------------------------------------------
# Cross-entropy on [0, 1] labels (ref: xentropy_objective.hpp)
# ---------------------------------------------------------------------------

class CrossEntropy(ObjectiveFunction):
    NAME = "cross_entropy"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if self.label.min() < 0 or self.label.max() > 1:
            log.fatal("[cross_entropy]: label must be in [0, 1]")

    def get_gradients(self, score):
        z = torch.sigmoid(score)
        grad = z - self._label_dev
        hess = z * (1.0 - z)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id):
        w = self.weight if self.weight is not None else np.ones(self.num_data)
        pavg = float(np.sum(self.label * w) / np.sum(w))
        pavg = min(max(pavg, K_EPSILON), 1.0 - K_EPSILON)
        initscore = math.log(pavg / (1.0 - pavg))
        log.info(f"[{self.NAME}:BoostFromScore]: pavg={pavg:.6f} -> "
                 f"initscore={initscore:.6f}")
        return initscore

    def convert_output(self, raw):
        return 1.0 / (1.0 + _exp(-raw))


class CrossEntropyLambda(ObjectiveFunction):
    """Weights enter the link (ref: xentropy_objective.hpp:186
    CrossEntropyLambda)."""

    NAME = "cross_entropy_lambda"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if self.label.min() < 0 or self.label.max() > 1:
            log.fatal("[cross_entropy_lambda]: label must be in [0, 1]")

    def get_gradients(self, score):
        if self._weight_dev is None:
            z = torch.sigmoid(score)
            grad = z - self._label_dev
            hess = z * (1.0 - z)
            return grad, hess
        w = self._weight_dev
        y = self._label_dev
        epf = torch.exp(score)
        enf = 1.0 / epf
        z = 1.0 - torch.exp(-w * torch.log1p(epf))
        grad = (1.0 - y / torch.clamp(z, min=K_EPSILON)) * w / (1.0 + enf)
        c = 1.0 / (1.0 - torch.clamp(z, max=1.0 - K_EPSILON))
        b = 1.0 + w * epf - c
        a = w * epf / ((1.0 + epf) * (1.0 + epf))
        hess = a * (1.0 + y * b)
        return grad, hess

    def boost_from_score(self, class_id):
        w = self.weight if self.weight is not None else np.ones(self.num_data)
        havg = float(np.sum(self.label * w) / np.sum(w))
        initscore = math.log(math.expm1(max(havg, K_EPSILON)))
        log.info(f"[{self.NAME}:BoostFromScore]: havg={havg:.6f} -> "
                 f"initscore={initscore:.6f}")
        return initscore

    def convert_output(self, raw):
        if isinstance(raw, torch.Tensor):
            return torch.log1p(torch.exp(raw))
        return np.log1p(np.exp(raw))


# ---------------------------------------------------------------------------
# Gradients from the caller (fobj)
# ---------------------------------------------------------------------------

class CustomObjective(ObjectiveFunction):
    """Gradients supplied by the caller through ``Booster.update(fobj=)``
    (ref: gbdt.cpp:364-381 custom path; 'custom'/'none' factory names,
    objective_function.cpp:147)."""

    NAME = "custom"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = int(config.num_class)

    def get_gradients(self, score):
        raise RuntimeError("custom objective: gradients must be passed to "
                           "Booster.update(train_set, fobj)")

    @property
    def num_model_per_iteration(self):
        return self.num_class

    @property
    def num_predict_one_row(self):
        return self.num_class


# ---------------------------------------------------------------------------
# Factory (ref: objective_function.cpp:58 CreateObjectiveFunction)
# ---------------------------------------------------------------------------

_OBJECTIVES = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": RegressionHuber,
    "fair": RegressionFair,
    "poisson": RegressionPoisson,
    "quantile": RegressionQuantile,
    "mape": RegressionMAPE,
    "gamma": RegressionGamma,
    "tweedie": RegressionTweedie,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
    "custom": CustomObjective,
}

# need query metadata the port's Dataset does not hold yet
_RANKING = ("lambdarank", "rank_xendcg")


def create_objective(name: str, config: Config) -> ObjectiveFunction:
    canonical = canonical_objective(name)
    if canonical in _RANKING:
        log.fatal(f"objective {name!r} is not ported yet: ranking needs "
                  "query data (Dataset(group=)), ROADMAP A12.2b")
    if canonical not in _OBJECTIVES:
        log.fatal(f"Unknown objective type name: {name}")
    return _OBJECTIVES[canonical](config)
