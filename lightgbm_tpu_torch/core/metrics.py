"""Evaluation metrics, host side in numpy f64.

Port of the first slice's metrics from ``lightgbm_tpu/core/metrics.py``:
``L2Metric`` (:170), ``BinaryLoglossMetric`` (:323) and ``AUCMetric`` /
``_auc`` (:377-404) (ref: regression_metric.hpp, binary_metric.hpp). The
JAX package evaluates these on the host in f64 on its CPU path; so does
the port, from the f32 score pulled off the device once per evaluation.
Each metric returns ``[(name, value, is_higher_better)]``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..config import Config, canonical_metric
from ..utils import log

K_EPSILON = 1e-15

MetricResult = List[Tuple[str, float, bool]]


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

    def init(self, metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = (np.asarray(metadata.label, np.float64)
                      if metadata.label is not None else None)
        self.weight = (np.asarray(metadata.weight, np.float64)
                       if metadata.weight is not None else None)
        self.sum_weights = (float(self.weight.sum())
                            if self.weight is not None else float(num_data))

    def eval(self, score: np.ndarray, objective=None) -> MetricResult:
        raise NotImplementedError


class _PointwiseMetric(Metric):
    """Average pointwise loss with the objective's transform applied."""

    def transform(self, score, objective):
        if objective is not None:
            return objective.convert_output(score)
        return score

    def point_loss(self, pred, label):
        raise NotImplementedError

    def eval(self, score, objective=None) -> MetricResult:
        pred = self.transform(np.asarray(score, np.float64), objective)
        losses = self.point_loss(pred, self.label)
        if self.weight is not None:
            value = float(np.sum(losses * self.weight) / self.sum_weights)
        else:
            value = float(np.mean(losses))
        return [(self.NAME, value, self.HIGHER_BETTER)]


class L2Metric(_PointwiseMetric):
    NAME = "l2"

    def point_loss(self, pred, label):
        d = pred - label
        return d * d


class BinaryLoglossMetric(_PointwiseMetric):
    NAME = "binary_logloss"

    def point_loss(self, prob, label):
        p = np.clip(prob, K_EPSILON, 1.0 - K_EPSILON)
        return -(label * np.log(p) + (1.0 - label) * np.log(1.0 - p))

    def transform(self, score, objective):
        if objective is not None:
            return objective.convert_output(score)
        return 1.0 / (1.0 + np.exp(-score))


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


_METRICS = {"l2": L2Metric, "binary_logloss": BinaryLoglossMetric,
            "auc": AUCMetric}

DEFAULT_METRIC_FOR_OBJECTIVE = {"regression": "l2",
                                "binary": "binary_logloss"}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    base = canonical_metric(name).partition("@")[0]
    if base in ("none", "na", "null", "custom"):
        return None
    if base not in _METRICS:
        log.fatal(f"metric {name!r} is not ported yet; the port evaluates "
                  f"{'/'.join(_METRICS)}")
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
