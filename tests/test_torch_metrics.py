"""The port's metrics against the JAX package's, on the host and on the
device path (mirrors ``tests/test_metrics_device.py``).

``eval`` is numpy in f64 in both packages, the same expressions: equal to
rtol 1e-12, with and without weights, each under the objective whose
output it reads. Where the JAX package has a device form (``l2``,
``rmse``, ``l1``, ``binary_logloss``, ``binary_error``, ``auc``,
``multi_logloss``, ``multi_error``), the port's ``eval_device`` (f64 on
the score's device; here the CPU) equals the port's ``eval`` to rtol
1e-10 and the JAX package's f32 ``eval_device`` to 2e-5 relative (that
file's tolerance); the other metrics return None in both packages and are
evaluated on the host. The engine keeps the metric order when device and
host metrics mix (``tpu_device_eval=true`` on the CPU). The ranking
metrics (``ndcg``, ``map``) loop over the queries on the host in both
packages: equal bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.core import metrics as JM
from lightgbm_tpu.core import objective as JO
from lightgbm_tpu.io.dataset_core import Metadata as JMeta
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.core import metrics as TM
from lightgbm_tpu_torch.core import objective as TO
from lightgbm_tpu_torch.io.dataset_core import Metadata as TMeta


class _Meta:
    def __init__(self, label, weight=None):
        self.label = label
        self.weight = weight


RNG = np.random.default_rng(0)
N = 3000
K = 4
SCORE = RNG.normal(size=N).astype(np.float32)
SCORE_K = RNG.normal(size=(K, N)).astype(np.float32)
LABELS = {
    "reg": RNG.normal(size=N) * 2.0,
    "pos": RNG.gamma(2.0, 1.0, size=N),
    "bin": (RNG.uniform(size=N) < 0.4).astype(np.float64),
    "unit": RNG.uniform(size=N),
    "class": RNG.integers(0, K, size=N).astype(np.float64),
}
WEIGHT = RNG.uniform(0.5, 2.0, size=N)

# metric -> (label kind, objective it reads, JAX package has a device form)
CASES = {
    "l2": ("reg", "regression", True),
    "rmse": ("reg", "regression", True),
    "l1": ("reg", "regression_l1", True),
    "quantile": ("reg", "quantile", False),
    "huber": ("reg", "huber", False),
    "fair": ("reg", "fair", False),
    "poisson": ("pos", "poisson", False),
    "mape": ("reg", "mape", False),
    "gamma": ("pos", "gamma", False),
    "gamma_deviance": ("pos", "gamma", False),
    "tweedie": ("pos", "tweedie", False),
    "r2": ("reg", "regression", False),
    "binary_logloss": ("bin", "binary", True),
    "binary_error": ("bin", "binary", True),
    "auc": ("bin", "binary", True),
    "average_precision": ("bin", "binary", False),
    "cross_entropy": ("unit", "cross_entropy", False),
    "cross_entropy_lambda": ("unit", "cross_entropy_lambda", False),
    "kullback_leibler": ("unit", "cross_entropy", False),
    "multi_logloss": ("class", "multiclass", True),
    "multi_error": ("class", "multiclass", True),
    "auc_mu": ("class", "multiclass", False),
}


def _make(metric, kind, objective, weighted, **cfg):
    label = LABELS[kind]
    weight = WEIGHT if weighted else None
    params = {"objective": objective, "metric": metric, **cfg}
    if kind == "class":
        params["num_class"] = K
    out = []
    for M, O, C in ((JM, JO, JConfig), (TM, TO, TConfig)):
        config = C(params)
        m = M.create_metric(metric, config)
        m.init(_Meta(label, weight), N)
        obj = (O.create_objective(objective, config) if objective != "none"
               else None)
        if obj is not None:
            meta = _Meta(label.astype(np.float32),
                         None if weight is None else weight.astype(np.float32))
            if O is JO:
                obj.init(meta, N)
            else:
                obj.init(meta, N, torch.device("cpu"))
        out.append((m, obj))
    return out


def _check(metric, weighted, objective=None, **cfg):
    kind, default_obj, has_device = CASES[metric]
    objective = objective or default_obj
    (jm, jo), (tm, to) = _make(metric, kind, objective, weighted, **cfg)
    score = SCORE_K if kind == "class" else SCORE
    host_j = jm.eval(score.astype(np.float64), jo)
    host_t = tm.eval(score.astype(np.float64), to)
    assert [(n, b) for n, _, b in host_t] == [(n, b) for n, _, b in host_j]
    for (_, tv, _), (_, jv, _) in zip(host_t, host_j):
        np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=1e-300)
    dev_j = jm.eval_device(jnp.asarray(score), jo)
    dev_t = tm.eval_device(torch.from_numpy(score), to)
    if not has_device:
        assert dev_j is None and dev_t is None
        return
    assert dev_j is not None and dev_t is not None
    assert [(n, b) for n, _, b in dev_t] == [(n, b) for n, _, b in host_t]
    for (_, dv, _), (_, hv, _), (_, jv, _) in zip(dev_t, host_t, dev_j):
        assert dv.dtype == torch.float64 and dv.dim() == 0
        np.testing.assert_allclose(float(dv), hv, rtol=1e-10, atol=1e-12)
        assert abs(float(dv) - float(jv)) < 2e-5 * max(1.0, abs(hv))


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("metric", list(CASES))
def test_metric_matches_jax(metric, weighted):
    _check(metric, weighted)


@pytest.mark.parametrize("metric", ["binary_logloss", "binary_error"])
def test_probability_metrics_without_an_objective(metric):
    """No objective: the raw score goes through the logistic function."""
    _check(metric, True, objective="none")
    _check(metric, False, objective="none")


@pytest.mark.parametrize("objective", ["multiclassova", "custom"])
def test_multiclass_metrics_under_other_objectives(objective):
    """``multi_logloss`` takes the softmax of the raw scores whatever the
    objective (the JAX package's rule), one-vs-all and custom included."""
    for metric in ("multi_logloss", "multi_error"):
        _check(metric, True, objective=objective)


def test_multi_error_top_k():
    _check("multi_error", True, multi_error_top_k=2)
    (_, _), (tm, _) = _make("multi_error", "class", "multiclass", False,
                            multi_error_top_k=2)
    assert tm.eval(SCORE_K.astype(np.float64))[0][0] == "multi_error@2"


def test_auc_device_with_ties():
    s = (np.round(SCORE * 4) / 4).astype(np.float32)
    (jm, _), (tm, _) = _make("auc", "bin", "binary", True)
    host = tm.eval(s.astype(np.float64))[0][1]
    assert host == jm.eval(s.astype(np.float64))[0][1]
    np.testing.assert_allclose(float(tm.eval_device(torch.from_numpy(s))[0][1]),
                               host, rtol=1e-12)


@pytest.mark.parametrize("objective", ["regression", "binary", "multiclass"])
def test_engine_eval_mixed_device_host_ordering(objective):
    """The engine's batched device read keeps metric order and values when
    device metrics mix with host-only ones, as the JAX package's does."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(800, 6))
    if objective == "regression":
        y = X[:, 0] + 0.1 * rng.normal(size=800)
        metrics = ["l2", "huber", "l1", "r2", "rmse"]
    elif objective == "binary":
        y = (X[:, 0] > 0).astype(np.float64)
        metrics = ["binary_logloss", "average_precision", "auc",
                   "binary_error"]
    else:
        y = np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float64)
        metrics = ["multi_logloss", "auc_mu", "multi_error"]
    params = dict(objective=objective, num_leaves=7, verbose=-1,
                  metric=metrics, device_type="cpu",
                  num_class=3 if objective == "multiclass" else 1)
    out = {}
    for pkg in (lgb, lgt):
        ds = pkg.Dataset(X, label=y)
        b = pkg.Booster(params, ds)
        b.add_valid(pkg.Dataset(X[:300], label=y[:300], reference=ds), "v")
        for _ in range(3):
            b.update()
        out[pkg] = b
    host = out[lgt]._engine.eval_valid()
    out[lgt]._engine.config.set("tpu_device_eval", "true")
    dev = out[lgt]._engine.eval_valid()
    jax_res = out[lgb]._engine.eval_valid()
    assert [r[1] for r in host] == [r[1] for r in dev] == \
        [r[1] for r in jax_res] == metrics
    for h, d, j in zip(host, dev, jax_res):
        assert h[3] == d[3] == j[3]
        np.testing.assert_allclose(d[2], h[2], rtol=1e-10)
        np.testing.assert_allclose(h[2], j[2], rtol=1e-6)


@pytest.mark.parametrize("name", ["ndcg", "map", "ndcg@3", "lambdarank"])
def test_ranking_metrics_match_jax(rng, name):
    """The metric of each name (``lambdarank`` is an alias of ``ndcg``)
    created in both packages gives the same names and values bit for bit
    on the same scores, ties included."""
    sizes = rng.integers(1, 30, size=40)
    n = int(sizes.sum())
    label = rng.integers(0, 5, size=n).astype(np.float32)
    label[:sizes[0]] = 0.0                  # an all-zero query
    score = np.round(rng.normal(size=n) * 3) / 3
    out = []
    for mod, cfg, meta in ((JM, JConfig, JMeta), (TM, TConfig, TMeta)):
        m = mod.create_metric(name, cfg({}))
        md = meta(n)
        md.set_label(label)
        md.set_query(sizes)
        m.init(md, n)
        out.append((type(m).__name__, m.names, m.eval(score)))
    assert out[1] == out[0]


def test_default_metrics_follow_the_jax_package():
    for obj, metric in TM.DEFAULT_METRIC_FOR_OBJECTIVE.items():
        assert JM.DEFAULT_METRIC_FOR_OBJECTIVE[obj] == metric
    assert set(JM.DEFAULT_METRIC_FOR_OBJECTIVE) - \
        set(TM.DEFAULT_METRIC_FOR_OBJECTIVE) == set()
