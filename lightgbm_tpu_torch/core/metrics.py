"""Evaluation metrics: on the host in numpy f64, or on the device.

Port of ``lightgbm_tpu/core/metrics.py`` (ref: regression_metric.hpp,
binary_metric.hpp, multiclass_metric.hpp, xentropy_metric.hpp): the
regression metrics (``l1``, ``l2``, ``rmse``, ``quantile``, ``huber``,
``fair``, ``poisson``, ``mape``, ``gamma``, ``gamma_deviance``,
``tweedie``, ``r2``), the binary ones (``binary_logloss``,
``binary_error``, ``auc``, ``average_precision``), the multiclass ones
(``multi_logloss``, ``multi_error`` with ``multi_error_top_k``,
``auc_mu``), the cross-entropies (``cross_entropy``,
``cross_entropy_lambda``, ``kullback_leibler``) and the ranking ones
(``ndcg``, ``map``; rank_metric.hpp, map_metric.hpp), which loop over the
queries on the host, as the JAX package's do.

Each metric's ``eval`` returns ``[(name, value, is_higher_better)]`` from
a numpy score (``[N]``, or ``[K, N]`` class-major), in f64 as the JAX
package computes it on its CPU path. Where the JAX package has a device
form (``l2``, ``rmse``, ``l1``, ``binary_logloss``, ``binary_error``,
``auc``, ``multi_logloss``, ``multi_error``), ``eval_device`` computes
the same f64 formula from the f32 score where it lives and returns 0-d
device tensors, so the engine reads every value back in one copy; the
others return None and the engine evaluates them on the host from one
read of the score. The device forms run in f64, not in the JAX package's
f32: on the card they are held to the host's values within 1e-5.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, canonical_metric
from ..utils import log
from .objective import default_label_gain, softmax

K_EPSILON = 1e-15

MetricResult = List[Tuple[str, float, bool]]
DeviceResult = Optional[List[Tuple[str, torch.Tensor, bool]]]


class Metric:
    """Base metric (ref: metric.h)."""

    NAME = "metric"
    HIGHER_BETTER = False

    def __init__(self, config: Config):
        self.config = config
        self.num_data = 0
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.sum_weights = 0.0
        self._dev_cache = None

    def init(self, metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = (np.asarray(metadata.label, np.float64)
                      if metadata.label is not None else None)
        self.weight = (np.asarray(metadata.weight, np.float64)
                       if metadata.weight is not None else None)
        self.sum_weights = (float(self.weight.sum())
                            if self.weight is not None else float(num_data))
        self._dev_cache = None

    @property
    def names(self) -> List[str]:
        return [self.NAME]

    def eval(self, score: np.ndarray, objective=None) -> MetricResult:
        raise NotImplementedError

    def eval_device(self, score: torch.Tensor, objective=None
                    ) -> DeviceResult:
        """``eval`` on the score's device in f64: ``[(name, 0-d tensor,
        is_higher_better)]``, or None where there is no device form."""
        return None

    def _dev(self, device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Label and weight as f64 tensors on ``device``, uploaded once."""
        cached = self._dev_cache
        if cached is None or cached[0].device != torch.device(device):
            f64 = lambda a: (torch.as_tensor(a, dtype=torch.float64,
                                             device=device)
                             if a is not None else None)
            cached = self._dev_cache = (f64(self.label), f64(self.weight))
        return cached

    def _mean(self, losses, weight):
        """The (weighted) mean of per-row losses, numpy or torch."""
        if weight is not None:
            return (losses * weight).sum() / self.sum_weights
        return losses.mean()


# ---------------------------------------------------------------------------
# Regression metrics (ref: regression_metric.hpp — average of PointLoss)
# ---------------------------------------------------------------------------

class _PointwiseMetric(Metric):
    """Average pointwise loss with the objective's transform applied.
    A metric with a device form defines ``point_loss_dev``."""

    def transform(self, score, objective):
        if objective is not None:
            return objective.convert_output(score)
        return score

    def point_loss(self, pred, label):
        raise NotImplementedError

    def finalize(self, value: float) -> float:
        return value

    def eval(self, score, objective=None) -> MetricResult:
        pred = self.transform(np.asarray(score, np.float64), objective)
        losses = self.point_loss(pred, self.label)
        value = float(self._mean(losses, self.weight))
        return [(self.NAME, self.finalize(value), self.HIGHER_BETTER)]

    point_loss_dev = None

    def finalize_dev(self, value):
        return value

    def transform_dev(self, score, objective):
        """The objective's ``convert_output`` on the device; None for an
        objective of several outputs a row, whose metrics the engine
        evaluates on the host."""
        if objective is None:
            return score
        if objective.num_predict_one_row > 1:
            return None
        return objective.convert_output(score)

    def eval_device(self, score, objective=None):
        if self.point_loss_dev is None:
            return None
        label, weight = self._dev(score.device)
        pred = self.transform_dev(score.double(), objective)
        if pred is None:
            return None
        value = self._mean(self.point_loss_dev(pred, label), weight)
        return [(self.NAME, self.finalize_dev(value), self.HIGHER_BETTER)]


class L2Metric(_PointwiseMetric):
    NAME = "l2"

    def point_loss(self, pred, label):
        d = pred - label
        return d * d

    point_loss_dev = point_loss


class RMSEMetric(L2Metric):
    NAME = "rmse"

    def finalize(self, value):
        return math.sqrt(value)

    def finalize_dev(self, value):
        return torch.sqrt(value)


class L1Metric(_PointwiseMetric):
    NAME = "l1"

    def point_loss(self, pred, label):
        return np.abs(pred - label)

    def point_loss_dev(self, pred, label):
        return torch.abs(pred - label)


class QuantileMetric(_PointwiseMetric):
    NAME = "quantile"

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(config.alpha)

    def point_loss(self, pred, label):
        d = label - pred
        return np.where(d >= 0, self.alpha * d, (self.alpha - 1.0) * d)


class HuberMetric(_PointwiseMetric):
    NAME = "huber"

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(config.alpha)

    def point_loss(self, pred, label):
        d = np.abs(pred - label)
        return np.where(d <= self.alpha, 0.5 * d * d,
                        self.alpha * (d - 0.5 * self.alpha))


class FairMetric(_PointwiseMetric):
    NAME = "fair"

    def __init__(self, config):
        super().__init__(config)
        self.c = float(config.fair_c)

    def point_loss(self, pred, label):
        x = np.abs(pred - label)
        return self.c * x - self.c * self.c * np.log1p(x / self.c)


class PoissonMetric(_PointwiseMetric):
    NAME = "poisson"

    def point_loss(self, pred, label):
        return pred - label * np.log(np.maximum(pred, 1e-10))


class MAPEMetric(_PointwiseMetric):
    NAME = "mape"

    def point_loss(self, pred, label):
        return np.abs((label - pred) / np.maximum(1.0, np.abs(label)))


class GammaMetric(_PointwiseMetric):
    """Up to label-only constants (ref: regression_metric.hpp
    GammaMetric)."""

    NAME = "gamma"

    def point_loss(self, pred, label):
        eps = 1e-10
        psi = label / np.maximum(pred, eps)
        theta = -1.0 / np.maximum(pred, eps)
        a = psi + np.log(-1.0 / theta)
        return psi * theta - a


class GammaDevianceMetric(_PointwiseMetric):
    NAME = "gamma_deviance"

    def point_loss(self, pred, label):
        eps = 1e-10
        frac = label / np.maximum(pred, eps)
        return 2.0 * (frac - np.log(np.maximum(frac, eps)) - 1.0)


class TweedieMetric(_PointwiseMetric):
    NAME = "tweedie"

    def __init__(self, config):
        super().__init__(config)
        self.rho = float(config.tweedie_variance_power)

    def point_loss(self, pred, label):
        p = np.maximum(pred, 1e-10)
        a = label * np.power(p, 1.0 - self.rho) / (1.0 - self.rho)
        b = np.power(p, 2.0 - self.rho) / (2.0 - self.rho)
        return -a + b


class R2Metric(_PointwiseMetric):
    NAME = "r2"
    HIGHER_BETTER = True

    def eval(self, score, objective=None) -> MetricResult:
        pred = self.transform(np.asarray(score, np.float64), objective)
        w = self.weight if self.weight is not None else np.ones(self.num_data)
        ybar = np.sum(self.label * w) / np.sum(w)
        ss_res = np.sum(w * (self.label - pred) ** 2)
        ss_tot = np.sum(w * (self.label - ybar) ** 2)
        value = 1.0 - ss_res / max(ss_tot, K_EPSILON)
        return [(self.NAME, float(value), True)]


# ---------------------------------------------------------------------------
# Binary metrics (ref: binary_metric.hpp)
# ---------------------------------------------------------------------------

class _ProbabilityMetric(_PointwiseMetric):
    """A metric of probabilities: with no objective the raw score goes
    through the logistic function."""

    def transform(self, score, objective):
        if objective is not None:
            return objective.convert_output(score)
        return 1.0 / (1.0 + np.exp(-score))

    def transform_dev(self, score, objective):
        if objective is None:
            return torch.sigmoid(score)
        return super().transform_dev(score, objective)


class BinaryLoglossMetric(_ProbabilityMetric):
    NAME = "binary_logloss"

    def point_loss(self, prob, label):
        p = np.clip(prob, K_EPSILON, 1.0 - K_EPSILON)
        return -(label * np.log(p) + (1.0 - label) * np.log(1.0 - p))

    def point_loss_dev(self, prob, label):
        p = prob.clamp(K_EPSILON, 1.0 - K_EPSILON)
        return -(label * torch.log(p) + (1.0 - label) * torch.log(1.0 - p))


class BinaryErrorMetric(_ProbabilityMetric):
    NAME = "binary_error"

    def point_loss(self, prob, label):
        return ((prob > 0.5) != (label > 0)).astype(np.float64)

    def point_loss_dev(self, prob, label):
        return ((prob > 0.5) != (label > 0)).double()


def _auc(label_pos: np.ndarray, score: np.ndarray,
         weight: Optional[np.ndarray]) -> float:
    """Weighted AUC with tied-score grouping (ref: binary_metric.hpp:160
    AUCMetric::Eval)."""
    w = weight if weight is not None else np.ones(len(score), np.float64)
    order = np.argsort(score, kind="stable")
    s = score[order]
    pos = label_pos[order].astype(np.float64) * w[order]
    neg = (~label_pos[order]).astype(np.float64) * w[order]
    # one block per run of equal scores; a positive counts the negatives
    # below its block plus half of those tied with it
    boundary = np.flatnonzero(np.diff(s) != 0)
    idx = np.concatenate([boundary + 1, [len(s)]])
    start = np.concatenate([[0], boundary + 1])
    cum_neg = 0.0
    accum = 0.0
    for a, b in zip(start, idx):
        bp = pos[a:b].sum()
        bn = neg[a:b].sum()
        accum += bp * (cum_neg + bn * 0.5)
        cum_neg += bn
    sum_pos = pos.sum()
    if sum_pos == 0 or cum_neg == 0:
        log.warning("AUC: data contains only one class")
        return 1.0
    return float(accum / (sum_pos * cum_neg))


class AUCMetric(Metric):
    NAME = "auc"
    HIGHER_BETTER = True

    def eval(self, score, objective=None) -> MetricResult:
        return [(self.NAME,
                 _auc(self.label > 0, np.asarray(score, np.float64),
                      self.weight), True)]

    def eval_device(self, score, objective=None):
        """``_auc`` vectorized, with no read from the device: sort; each
        row's block of equal scores is bounded by the negatives before
        its first row and up to its last row (the negatives' running
        sum, propagated across the block by a running max and a reversed
        running min); ``sum pos_i * (neg below + neg in block / 2)`` in
        f64."""
        label, weight = self._dev(score.device)
        s, order = torch.sort(score.double(), stable=True)
        is_pos = label[order] > 0
        w = weight[order] if weight is not None else torch.ones_like(s)
        zero = torch.zeros_like(w)
        pos = torch.where(is_pos, w, zero)
        neg = torch.where(is_pos, zero, w)
        cum_neg = neg.cumsum(0)
        first = torch.ones_like(is_pos)
        first[1:] = s[1:] != s[:-1]
        last = torch.ones_like(is_pos)
        last[:-1] = first[1:]
        below = torch.where(first, cum_neg - neg, zero).cummax(0).values
        inf = torch.full_like(w, float("inf"))
        upto = torch.where(last, cum_neg, inf).flip(0).cummin(0) \
            .values.flip(0)
        accum = (pos * (below + 0.5 * (upto - below))).sum()
        sum_pos, sum_neg = pos.sum(), cum_neg[-1]
        auc = torch.where((sum_pos == 0) | (sum_neg == 0),
                          torch.ones_like(accum),
                          accum / (sum_pos * sum_neg))
        return [(self.NAME, auc, True)]


class AveragePrecisionMetric(Metric):
    """ref: binary_metric.hpp AveragePrecisionMetric."""

    NAME = "average_precision"
    HIGHER_BETTER = True

    def eval(self, score, objective=None) -> MetricResult:
        w = self.weight if self.weight is not None else \
            np.ones(self.num_data, np.float64)
        order = np.argsort(-np.asarray(score, np.float64), kind="stable")
        pos = (self.label[order] > 0).astype(np.float64) * w[order]
        tp = np.cumsum(pos)
        total = np.cumsum(w[order])
        precision = tp / np.maximum(total, K_EPSILON)
        sum_pos = pos.sum()
        if sum_pos == 0:
            return [(self.NAME, 1.0, True)]
        return [(self.NAME, float(np.sum(precision * pos) / sum_pos), True)]


# ---------------------------------------------------------------------------
# Multiclass metrics (ref: multiclass_metric.hpp), over raw [K, N] scores
# ---------------------------------------------------------------------------

class MultiLoglossMetric(Metric):
    """Mean ``-log`` of the softmax probability of the true class, for
    softmax and one-vs-all models alike (the JAX package's rule)."""

    NAME = "multi_logloss"

    def eval(self, score, objective=None) -> MetricResult:
        score = np.asarray(score, np.float64)
        p = softmax(score, 0)
        li = self.label.astype(np.int64)
        pt = np.clip(p[li, np.arange(score.shape[1])], K_EPSILON, 1.0)
        value = float(self._mean(-np.log(pt), self.weight))
        return [(self.NAME, value, False)]

    def eval_device(self, score, objective=None):
        if score.ndim != 2:
            return None
        label, weight = self._dev(score.device)
        p = softmax(score.double(), 0)
        pt = p.gather(0, label.long()[None, :])[0].clamp(K_EPSILON, 1.0)
        return [(self.NAME, self._mean(-torch.log(pt), weight), False)]


class MultiErrorMetric(Metric):
    """A row is an error when ``multi_error_top_k`` or more classes score
    strictly above its true class (``multi_error@k`` for k > 1)."""

    NAME = "multi_error"

    def __init__(self, config):
        super().__init__(config)
        self.top_k = int(config.multi_error_top_k)
        self.name = (self.NAME if self.top_k <= 1
                     else f"multi_error@{self.top_k}")

    def eval(self, score, objective=None) -> MetricResult:
        score = np.asarray(score, np.float64)
        li = self.label.astype(np.int64)
        true_score = score[li, np.arange(score.shape[1])]
        rank = (score > true_score[None, :]).sum(axis=0)
        err = (rank >= self.top_k).astype(np.float64)
        return [(self.name, float(self._mean(err, self.weight)), False)]

    def eval_device(self, score, objective=None):
        if score.ndim != 2:
            return None
        label, weight = self._dev(score.device)
        true_score = score.gather(0, label.long()[None, :])
        rank = (score > true_score).sum(dim=0)
        err = (rank >= self.top_k).double()
        return [(self.name, self._mean(err, weight), False)]


class AucMuMetric(Metric):
    """Multiclass AUC-mu (ref: multiclass_metric.hpp auc_mu; Kleiman &
    Page 2019): the mean over class pairs of the AUC of ``S_a - S_b``
    between the rows of class a and of class b."""

    NAME = "auc_mu"
    HIGHER_BETTER = True

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)

    def eval(self, score, objective=None) -> MetricResult:
        score = np.asarray(score, np.float64)
        K, N = score.shape
        li = self.label.astype(np.int64)
        w = self.weight if self.weight is not None else np.ones(N)
        total = 0.0
        npairs = 0
        for a in range(K):
            for b in range(a + 1, K):
                mask = (li == a) | (li == b)
                if not mask.any():
                    continue
                is_a = li[mask] == a
                if is_a.all() or (~is_a).all():
                    continue
                total += _auc(is_a, score[a, mask] - score[b, mask],
                              w[mask])
                npairs += 1
        return [(self.NAME, float(total / max(npairs, 1)), True)]


# ---------------------------------------------------------------------------
# Cross-entropy metrics (ref: xentropy_metric.hpp)
# ---------------------------------------------------------------------------

class CrossEntropyMetric(_ProbabilityMetric):
    NAME = "cross_entropy"

    def point_loss(self, p, label):
        p = np.clip(p, K_EPSILON, 1.0 - K_EPSILON)
        return -(label * np.log(p) + (1.0 - label) * np.log(1.0 - p))


class CrossEntropyLambdaMetric(_PointwiseMetric):
    NAME = "cross_entropy_lambda"

    def transform(self, score, objective):
        if objective is not None:
            return objective.convert_output(score)
        return np.log1p(np.exp(score))

    def point_loss(self, hhat, label):
        hhat = np.maximum(hhat, K_EPSILON)
        return (1.0 - label) * hhat - label * np.log(
            np.maximum(np.expm1(hhat), K_EPSILON))


class KullbackLeiblerMetric(CrossEntropyMetric):
    NAME = "kullback_leibler"

    def point_loss(self, p, label):
        eps = K_EPSILON
        p = np.clip(p, eps, 1.0 - eps)
        y = np.clip(label, 0.0, 1.0)
        # KL(y || p) = xent(y, p) - H(y)
        hy = np.where((y > 0) & (y < 1),
                      -(y * np.log(y + eps) + (1 - y) * np.log(1 - y + eps)),
                      0.0)
        xent = -(y * np.log(p) + (1.0 - y) * np.log(1.0 - p))
        return xent - hy


# ---------------------------------------------------------------------------
# Ranking metrics (ref: rank_metric.hpp NDCGMetric, map_metric.hpp)
# ---------------------------------------------------------------------------

class _RankingMetric(Metric):
    """A metric per query at each ``eval_at`` cut-off, averaged with
    uniform query weights, on the host in f64 (the JAX package's
    core/metrics.py:593-686)."""

    HIGHER_BETTER = True

    def __init__(self, config):
        super().__init__(config)
        self.eval_at = list(config.eval_at) or [1, 2, 3, 4, 5]

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            log.fatal(f"{self.NAME} metric requires query information")
        self.query_boundaries = metadata.query_boundaries
        self.num_queries = len(self.query_boundaries) - 1

    @property
    def names(self):
        return [f"{self.NAME}@{k}" for k in self.eval_at]

    def query_values(self, lbl: np.ndarray, sc: np.ndarray) -> List[float]:
        """The metric of one query at each cut-off."""
        raise NotImplementedError

    def eval(self, score, objective=None) -> MetricResult:
        score = np.asarray(score, np.float64)
        results = np.zeros(len(self.eval_at))
        for q in range(self.num_queries):
            lo, hi = self.query_boundaries[q], self.query_boundaries[q + 1]
            results += self.query_values(self.label[lo:hi], score[lo:hi])
        results /= max(self.num_queries, 1)
        return [(name, float(v), True)
                for name, v in zip(self.names, results)]


class NDCGMetric(_RankingMetric):
    """A query whose labels are all 0 counts 1."""

    NAME = "ndcg"

    def __init__(self, config):
        super().__init__(config)
        lg = list(config.label_gain)
        self.label_gain = (np.asarray(lg, np.float64) if lg
                           else default_label_gain())

    def query_values(self, lbl, sc):
        gains = self.label_gain[lbl.astype(np.int64)]
        order = np.argsort(-sc, kind="stable")
        sorted_gain = gains[order]
        ideal_gain = np.sort(gains)[::-1]
        disc = 1.0 / np.log2(np.arange(len(lbl)) + 2.0)
        out = []
        for k in self.eval_at:
            kk = min(k, len(lbl))
            max_dcg = float(np.sum(ideal_gain[:kk] * disc[:kk]))
            out.append(1.0 if max_dcg <= 0.0 else
                       float(np.sum(sorted_gain[:kk] * disc[:kk])) / max_dcg)
        return out


class MapMetric(_RankingMetric):
    """A query with no relevant document in the cut-off counts 0."""

    NAME = "map"

    def query_values(self, lbl, sc):
        rel_sorted = (lbl > 0)[np.argsort(-sc, kind="stable")]
        prec = np.cumsum(rel_sorted) / np.arange(1, len(rel_sorted) + 1)
        out = []
        for k in self.eval_at:
            kk = min(k, len(rel_sorted))
            nrel = rel_sorted[:kk].sum()
            out.append(float(np.sum(prec[:kk] * rel_sorted[:kk]) / nrel)
                       if nrel > 0 else 0.0)
        return out


# ---------------------------------------------------------------------------
# Factory (ref: metric.cpp:26 Metric::CreateMetric)
# ---------------------------------------------------------------------------

_METRICS = {
    "l1": L1Metric,
    "l2": L2Metric,
    "rmse": RMSEMetric,
    "quantile": QuantileMetric,
    "huber": HuberMetric,
    "fair": FairMetric,
    "poisson": PoissonMetric,
    "mape": MAPEMetric,
    "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric,
    "tweedie": TweedieMetric,
    "r2": R2Metric,
    "binary_logloss": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "average_precision": AveragePrecisionMetric,
    "auc_mu": AucMuMetric,
    "multi_logloss": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
    "cross_entropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "kullback_leibler": KullbackLeiblerMetric,
    "ndcg": NDCGMetric,
    "map": MapMetric,
}

# the objective's own metric (ref: Config::GetMetricType)
DEFAULT_METRIC_FOR_OBJECTIVE = {
    "regression": "l2",
    "regression_l1": "l1",
    "huber": "huber",
    "fair": "fair",
    "poisson": "poisson",
    "quantile": "quantile",
    "mape": "mape",
    "gamma": "gamma",
    "tweedie": "tweedie",
    "binary": "binary_logloss",
    "multiclass": "multi_logloss",
    "multiclassova": "multi_logloss",
    "cross_entropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "lambdarank": "ndcg",
    "rank_xendcg": "ndcg",
}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    """The metric of ``name``; ``ndcg@1,3`` sets its own ``eval_at``."""
    base, _, at = canonical_metric(name).partition("@")
    if base in ("none", "na", "null", "custom"):
        return None
    if base not in _METRICS:
        log.fatal(f"Unknown metric type name: {name}")
    if at:
        config = config.copy()
        config.set("eval_at", [int(a) for a in at.split(",")])
    return _METRICS[base](config)


def metrics_for_config(config: Config, objective_name: str) -> List[Metric]:
    """The metric list, defaulting to the objective's own metric."""
    names = list(config.metric)
    if not names:
        default = DEFAULT_METRIC_FOR_OBJECTIVE.get(objective_name)
        names = [default] if default else []
    out = []
    for n in dict.fromkeys(names):
        if n in ("none", "null", "na", "custom", ""):
            continue
        m = create_metric(n, config)
        if m is not None:
            out.append(m)
    return out
