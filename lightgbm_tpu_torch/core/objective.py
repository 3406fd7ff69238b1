"""Objective functions: score -> (gradient, hessian) as torch tensor ops.

Port of ``lightgbm_tpu/core/objective.py`` (ref:
include/LightGBM/objective_function.h:20, src/objective/
regression_objective.hpp, binary_objective.hpp, multiclass_objective.hpp,
xentropy_objective.hpp): the regression family (L2, L1, Huber, Fair,
Poisson, Quantile, MAPE, Gamma, Tweedie), binary logloss, multiclass
softmax and one-vs-all, the two cross-entropies, ranking (``lambdarank``
with its position bias, ``rank_xendcg``; rank_objective.hpp) and the
adapter for gradients the caller supplies (``CustomObjective``).

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

Ranking groups its queries into power-of-two length buckets, each a
padded ``[Q, M]`` block, as the JAX package does; lambdarank's all-pairs
pass over a bucket runs in chunks of whole queries whose ``[Q_c, M, M]``
f32 temporaries stay under ``PAIR_CHUNK_BYTES`` (every reduction runs
along one query's axes, so a chunk computes what the whole bucket would).

Score layout: ``[N]`` for one model per iteration, ``[K, N]`` class-major
for the multiclass objectives.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, canonical_objective
from ..utils import log, prng

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

    def is_constant_hessian(self) -> bool:
        return False

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

    def is_constant_hessian(self):
        return self.weight is None

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

    def is_constant_hessian(self):
        return False

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

    def is_constant_hessian(self):
        return False

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

    def is_constant_hessian(self):
        return True

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
# Ranking (ref: rank_objective.hpp LambdarankNDCG / RankXENDCG)
# ---------------------------------------------------------------------------

def default_label_gain(max_label: int = 31) -> np.ndarray:
    """2^i - 1 gains (ref: dcg_calculator.cpp DefaultLabelGain)."""
    return np.power(2.0, np.arange(max_label + 1)) - 1.0


# the most bytes one [Q_c, M, M] f32 temporary of lambdarank's pairwise
# pass may take: a bucket's queries are processed in chunks under it
PAIR_CHUNK_BYTES = 256 << 20


class _QueryBucket:
    """One length bucket of queries padded to a shared width, built once
    on the training device."""

    def __init__(self, qids: np.ndarray, qb: np.ndarray, width: int,
                 label: np.ndarray, device):
        self.qids = qids                       # i64 [Qb] original query ids
        counts = qb[qids + 1] - qb[qids]
        slot = np.arange(width)
        valid = slot[None, :] < counts[:, None]
        idx = np.where(valid, qb[qids][:, None] + slot[None, :], 0)
        self.idx = torch.as_tensor(idx, device=device)        # [Qb, Mb]
        self.valid = torch.as_tensor(valid, device=device)    # [Qb, Mb]
        self.label_np = np.where(valid, label[idx], 0.0).astype(np.float32)
        self.label_q = torch.as_tensor(self.label_np, device=device)

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.idx.shape)


class _RankingObjective(ObjectiveFunction):
    """Queries grouped into pow2 length buckets, each padded to its width,
    so the per-query work becomes dense masked ``[Q, M]`` (and ``[Q, M,
    M]``) tensor ops (ref: rank_objective.hpp:56 GetGradients; the JAX
    package's core/objective.py:705-752)."""

    MIN_BUCKET_WIDTH = 16

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            log.fatal("Ranking tasks require query information")
        qb = metadata.query_boundaries.astype(np.int64)
        self.query_boundaries = qb
        self.num_queries = len(qb) - 1
        counts = np.diff(qb)
        widths = np.maximum(self.MIN_BUCKET_WIDTH,
                            2 ** np.ceil(np.log2(np.maximum(counts, 1)))
                            .astype(np.int64))
        self.buckets = [
            _QueryBucket(np.flatnonzero(widths == w), qb, int(w), self.label,
                         device)
            for w in np.unique(widths)]

    def scatter_back(self, flat: Optional[torch.Tensor], bk: _QueryBucket,
                     padded: torch.Tensor, q0: int = 0) -> torch.Tensor:
        """Add the padded ``[Q_c, M]`` values of queries ``q0 ..`` of
        bucket ``bk`` into the flat ``[N]`` f32 (zeros when None). Every
        document sits in one slot of one bucket, so each row receives its
        value once, added to +0.0: a -0.0 comes out +0.0, as the JAX
        package's ``.at[].add`` gives."""
        if flat is None:
            flat = torch.zeros(self.num_data, dtype=torch.float32,
                               device=padded.device)
        q1 = q0 + padded.shape[0]
        vals = torch.where(bk.valid[q0:q1], padded, 0.0)
        return flat.index_add_(0, bk.idx[q0:q1].reshape(-1),
                               vals.reshape(-1))


class LambdarankNDCG(_RankingObjective):
    """ref: rank_objective.hpp LambdarankNDCG, the exact sigmoid in place
    of its lookup table; the JAX package's core/objective.py:755-876."""

    NAME = "lambdarank"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0:
            log.fatal(f"Sigmoid param {self.sigmoid} should be > 0")
        self.norm = bool(config.lambdarank_norm)
        self.truncation_level = int(config.lambdarank_truncation_level)
        lg = list(config.label_gain)
        self.label_gain = (np.asarray(lg, np.float64) if lg
                           else default_label_gain())
        self._bias_reg = float(config.lambdarank_position_bias_regularization)
        self._bias_lr = float(config.learning_rate)
        self.positions = None

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if self.label.max() >= len(self.label_gain):
            log.fatal(f"Label {int(self.label.max())} exceeds label_gain "
                      "size; set label_gain explicitly")
        # per-query inverse max DCG at the truncation level, in f64
        inv = np.zeros(self.num_queries)
        gains = self.label_gain
        for q in range(self.num_queries):
            lo, hi = self.query_boundaries[q], self.query_boundaries[q + 1]
            lbl = np.sort(self.label[lo:hi])[::-1][:self.truncation_level]
            dcg = np.sum(gains[lbl.astype(np.int64)] /
                         np.log2(np.arange(len(lbl)) + 2.0))
            inv[q] = 1.0 / dcg if dcg > 0 else 0.0
        for bk in self.buckets:
            bk.inv_max_dcg = torch.as_tensor(
                inv[bk.qids].astype(np.float32), device=device)
            bk.gain_q = torch.as_tensor(
                gains[bk.label_np.astype(np.int64)].astype(np.float32),
                device=device)
        # position bias (ref: rank_objective.hpp:44-57)
        if metadata.position is not None:
            self.positions = metadata.position.astype(np.int64)
            self.num_position_ids = int(self.positions.max()) + 1
            self.pos_biases = np.zeros(self.num_position_ids, np.float64)
            self._positions_dev = torch.as_tensor(self.positions,
                                                  device=device)
            log.info(f"Using position bias correction with "
                     f"{self.num_position_ids} position ids")

    @property
    def uses_position_bias(self) -> bool:
        return self.positions is not None

    def update_position_bias(self, lambdas: np.ndarray,
                             hessians: np.ndarray) -> None:
        """Newton-Raphson update of the per-position bias factors on the
        host in f64 (ref: rank_objective.hpp:303
        UpdatePositionBiasFactors)."""
        n = self.num_position_ids
        first = -np.bincount(self.positions, weights=lambdas, minlength=n)
        second = -np.bincount(self.positions, weights=hessians, minlength=n)
        counts = np.bincount(self.positions, minlength=n)
        first -= self.pos_biases * self._bias_reg * counts
        second -= self._bias_reg * counts
        self.pos_biases += self._bias_lr * first / (np.abs(second) + 0.001)

    def chunks(self, bk: _QueryBucket) -> List[Tuple[int, int]]:
        """Query ranges of ``bk`` whose ``[Q_c, M, M]`` f32 temporaries
        fit ``PAIR_CHUNK_BYTES`` (at least one query each)."""
        Q, M = bk.shape
        step = max(1, PAIR_CHUNK_BYTES // (4 * M * M))
        return [(q0, min(q0 + step, Q)) for q0 in range(0, Q, step)]

    def _chunk_gradients(self, bk: _QueryBucket, score: torch.Tensor,
                         q0: int, q1: int):
        """All-pairs lambdas and hessians ``[Q_c, M]`` of queries ``q0 ..
        q1`` of one bucket (ref: rank_objective.hpp:181
        GetGradientsForOneQuery), the JAX package's expression term for
        term. Padded slots hold -inf scores, so their score differences
        are NaN or infinite: ``torch.where`` drops them before any sum."""
        valid = bk.valid[q0:q1]
        lbl = bk.label_q[q0:q1]
        gain = bk.gain_q[q0:q1]
        Q, M = valid.shape
        s = torch.where(valid, score[bk.idx[q0:q1]], -torch.inf)
        # rank of each doc in its query by descending score (stable)
        order = torch.argsort(-s, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(M, device=s.device).expand(Q, M))
        discount = 1.0 / torch.log2(rank.to(torch.float32) + 2.0)

        pair_valid = (valid[:, :, None] & valid[:, None, :] &
                      (lbl[:, :, None] != lbl[:, None, :]))
        # truncation: a pair needs one doc ranked < truncation_level
        in_trunc = rank < self.truncation_level
        pair_valid &= in_trunc[:, :, None] | in_trunc[:, None, :]
        # orient: i = high-label doc, j = low; count each pair once
        high_is_i = lbl[:, :, None] > lbl[:, None, :]
        pair_valid &= high_is_i

        delta_score = s[:, :, None] - s[:, None, :]            # s_i - s_j
        delta_ndcg = (gain[:, :, None] - gain[:, None, :]).abs_()
        delta_ndcg *= (discount[:, :, None] - discount[:, None, :]).abs_()
        delta_ndcg *= bk.inv_max_dcg[q0:q1, None, None]
        if self.norm:
            best = s.amax(dim=1)
            worst = torch.where(valid, s, torch.inf).amin(dim=1)
            norm_ok = (best != worst)[:, None, None]
            delta_ndcg = torch.where(
                norm_ok, delta_ndcg / (0.01 + delta_score.abs()), delta_ndcg)
        # signed delta from high to low: 1 / (1 + e^{sigma (s_h - s_l)});
        # each [Q_c, M, M] temporary is dropped once used, so a few live
        # at once
        hl_delta = torch.where(high_is_i, delta_score, -delta_score)
        del delta_score, high_is_i
        p = torch.sigmoid(-self.sigmoid * hl_delta)
        del hl_delta
        p_lambda = -self.sigmoid * delta_ndcg * p
        p_hess = self.sigmoid * self.sigmoid * delta_ndcg * p * (1.0 - p)
        del delta_ndcg, p
        p_lambda = torch.where(pair_valid, p_lambda, 0.0)
        p_hess = torch.where(pair_valid, p_hess, 0.0)
        del pair_valid

        # i (high) receives +lambda, j (low) receives -lambda
        lambdas = p_lambda.sum(dim=2) - p_lambda.sum(dim=1)
        hess = p_hess.sum(dim=2) + p_hess.sum(dim=1)
        if self.norm:
            sum_lambdas = -2.0 * p_lambda.sum(dim=(1, 2))
            nf = torch.where(sum_lambdas > 0,
                             torch.log2(1.0 + sum_lambdas) /
                             sum_lambdas.clamp(min=K_EPSILON), 1.0)
            lambdas = lambdas * nf[:, None]
            hess = hess * nf[:, None]
        return lambdas, hess

    def get_gradients(self, score, pos_biases: Optional[torch.Tensor] = None):
        """Bucketed, chunked all-pairs lambdas ``[N]``. ``pos_biases``
        (f32 ``[num_position_ids]``) is added to the score before the
        pairwise pass (ref: rank_objective.hpp:69-74)."""
        if pos_biases is not None and self.positions is not None:
            score = score + pos_biases[self._positions_dev]
        grad = hess = None
        for bk in self.buckets:
            for q0, q1 in self.chunks(bk):
                g, h = self._chunk_gradients(bk, score, q0, q1)
                grad = self.scatter_back(grad, bk, g, q0)
                hess = self.scatter_back(hess, bk, h, q0)
        return grad, hess


class RankXENDCG(_RankingObjective):
    """Cross-entropy surrogate for NDCG (ref: rank_objective.hpp
    RankXENDCG; Bruch et al., 'An Alternative Cross Entropy Loss for
    Learning-to-Rank'). Its temporaries are ``[Q, M]``: no chunking."""

    NAME = "rank_xendcg"

    def __init__(self, config: Config):
        super().__init__(config)
        self.seed = int(config.objective_seed)
        self._iter = 0

    def _bucket_gradients(self, bk: _QueryBucket, score, key):
        valid = bk.valid
        s = torch.where(valid, score[bk.idx], -torch.inf)
        rho = torch.where(valid, softmax(s, 1), 0.0)
        # phi(label, gumbel) = 2^label - gumbel
        gumbel = prng.gumbel(key, bk.shape, s.device)
        phi = torch.where(valid, torch.pow(2.0, bk.label_q) - gumbel, 0.0)
        phi_sum = phi.sum(dim=1, keepdim=True).clamp(min=K_EPSILON)
        ys = phi / phi_sum
        l1 = rho - ys
        # second-order correction terms (ref: rank_objective.hpp:400-430)
        l2_denom = (1.0 - rho).clamp(min=K_EPSILON)
        params = ys + l1 * rho / l2_denom
        lambdas = l1 + rho * (params.sum(dim=1, keepdim=True) - params)
        hess = rho * (1.0 - rho)
        return lambdas, hess

    def get_gradients(self, score):
        # fresh noise each call: the keys split from PRNGKey(seed + calls)
        self._iter += 1
        keys = prng.split(prng.prng_key(self.seed + self._iter),
                          len(self.buckets))
        grad = hess = None
        for bk, key in zip(self.buckets, keys):
            g, h = self._bucket_gradients(bk, score, key)
            grad = self.scatter_back(grad, bk, g)
            hess = self.scatter_back(hess, bk, h)
        return grad, hess


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
    "lambdarank": LambdarankNDCG,
    "rank_xendcg": RankXENDCG,
    "custom": CustomObjective,
}


def create_objective(name: str, config: Config) -> ObjectiveFunction:
    canonical = canonical_objective(name)
    if canonical not in _OBJECTIVES:
        log.fatal(f"Unknown objective type name: {name}")
    return _OBJECTIVES[canonical](config)
