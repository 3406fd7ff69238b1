"""The pointwise objectives of the PyTorch port against the JAX package.

``get_gradients`` on the same f32 score, with and without weights:

- L2 (plain and ``reg_sqrt``), L1, Huber, Fair, quantile and MAPE have no
  transcendental function: bit for bit against the JAX package's jitted
  gradients, which its engine runs.
- Poisson, Gamma, Tweedie and the two cross-entropies go through ``exp``,
  ``log1p`` and the logistic function, whose last ulps differ between
  XLA's CPU and torch (ROADMAP C1(a)). With the JAX package's values of
  those functions on the same arguments the port's gradients equal its
  eager gradients bit for bit (the expressions are the same term for
  term). Against the jitted gradients (XLA fuses some products into FMAs)
  every row is within 2 ulp of ``m = 1 + |label| + |grad| + |hess|``.
  ``cross_entropy_lambda`` with weights loses digits in
  ``z = 1 - exp(-w log1p(e^s))`` as z -> 0 and its hessian cancels again
  in ``1 + y (1 + w e^s - 1 / (1 - z))``: its gradient is within 2 ulp of
  ``m / z``, its hessian within 64 (at most 54 over ten seeds; the JAX
  package's own jitted and eager hessians differ by up to 1,254 ulp).

``boost_from_score`` and ``renew_tree_output`` (L1, quantile, MAPE) are
numpy in f64 in both packages: equal. Trained trees (2,000 rows, 15
leaves, 4 rounds, compact grower): bit for bit for L1, Huber, Fair,
quantile and MAPE, weighted too; to the binary standard of
``tests/test_torch_multiclass.py`` for Poisson, Gamma, Tweedie and the
cross-entropies, and for L1 and quantile on the hybrid and full growers
(ROADMAP C1(b), C1(c)).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_multiclass import assert_trees_to_binary_standard
from test_torch_train import _trees

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.core import objective as jobj
from lightgbm_tpu.io.dataset_core import Metadata as JMeta
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.core import objective as tobj
from lightgbm_tpu_torch.io.dataset_core import Metadata as TMeta

N = 2000
EXACT = ["regression", "regression_sqrt", "regression_l1", "huber", "fair",
         "quantile", "mape"]
TRANSCENDENTAL = ["poisson", "gamma", "tweedie", "cross_entropy",
                  "cross_entropy_lambda"]
EPS32 = 2.0 ** -23


class _Meta:
    def __init__(self, label, weight=None):
        self.label = label
        self.weight = weight


def _params(name):
    if name == "regression_sqrt":
        return {"objective": "regression", "reg_sqrt": True}
    return {"objective": name}


def _label(rng, name, n=N):
    if name in ("poisson", "gamma", "tweedie"):
        return rng.gamma(2.0, 1.0, size=n).astype(np.float32)
    if name.startswith("cross_entropy"):
        return rng.uniform(size=n).astype(np.float32)
    return (3.0 * rng.normal(size=n)).astype(np.float32)


def _pair(name, label, weight):
    """The JAX package's and the port's objective, initialised on the same
    label and weight."""
    jo = jobj.create_objective(_params(name)["objective"],
                               JConfig(_params(name)))
    jo.init(_Meta(label, weight), len(label))
    to = tobj.create_objective(_params(name)["objective"],
                               TConfig(_params(name)))
    to.init(_Meta(label, weight), len(label), torch.device("cpu"))
    return jo, to


def _weight(rng, weighted, n=N):
    return rng.uniform(0.5, 2.0, size=n).astype(np.float32) \
        if weighted else None


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("name", EXACT)
def test_gradients_bit_for_bit(rng, name, weighted):
    import jax
    label, weight = _label(rng, name), _weight(rng, weighted)
    jo, to = _pair(name, label, weight)
    score = (1.5 * rng.normal(size=N)).astype(np.float32)
    jg, jh = (np.asarray(a) for a in jax.jit(jo.get_gradients)(
        jnp.asarray(score)))
    tg, th = (a.numpy() for a in to.get_gradients(torch.from_numpy(score)))
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(th, jh)
    assert to.boost_from_score(0) == jo.boost_from_score(0)


def _jax_valued(fn):
    """``fn`` (a jnp function) on a torch tensor's values."""
    return lambda t: torch.from_numpy(np.array(fn(jnp.asarray(t.numpy()))))


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("name", TRANSCENDENTAL)
def test_gradients_within_ulps(rng, monkeypatch, name, weighted):
    import jax
    label, weight = _label(rng, name), _weight(rng, weighted)
    jo, to = _pair(name, label, weight)
    score = (1.5 * rng.normal(size=N)).astype(np.float32)
    js = jnp.asarray(score)
    jg, jh = (np.asarray(a, np.float64)
              for a in jax.jit(jo.get_gradients)(js))
    tg, th = (a.numpy().astype(np.float64)
              for a in to.get_gradients(torch.from_numpy(score)))
    scale = EPS32 * (1.0 + np.abs(label) + np.abs(jg) + np.abs(jh))
    hess_ulps = 2
    if name == "cross_entropy_lambda" and weighted:
        w, s = weight.astype(np.float64), score.astype(np.float64)
        scale /= 1.0 - np.exp(-w * np.log1p(np.exp(s)))
        hess_ulps = 64
    np.testing.assert_array_less(np.abs(tg - jg), 2 * scale)
    np.testing.assert_array_less(np.abs(th - jh), hess_ulps * scale)
    assert to.boost_from_score(0) == jo.boost_from_score(0)

    monkeypatch.setattr(torch, "exp", _jax_valued(jnp.exp))
    monkeypatch.setattr(torch, "log1p", _jax_valued(jnp.log1p))
    monkeypatch.setattr(torch, "sigmoid", _jax_valued(jax.nn.sigmoid))
    eg, eh = (np.asarray(a) for a in jo.get_gradients(js))
    tg, th = (a.numpy() for a in to.get_gradients(torch.from_numpy(score)))
    np.testing.assert_array_equal(tg, eg)
    np.testing.assert_array_equal(th, eh)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("name", ["regression_l1", "quantile", "mape"])
def test_renew_tree_output_equal(rng, name, weighted):
    label, weight = _label(rng, name), _weight(rng, weighted)
    jo, to = _pair(name, label, weight)
    assert to.is_renew_tree_output() and jo.is_renew_tree_output()
    score = (1.5 * rng.normal(size=N)).astype(np.float32).astype(np.float64)
    leaf = rng.integers(0, 9, size=N)
    leaf[leaf == 4] = 5             # an empty leaf keeps 0
    residual = lambda: label.astype(np.float64) - score
    jv = jo.renew_tree_output(score, residual, leaf, 9)
    tv = to.renew_tree_output(score, residual, leaf, 9)
    np.testing.assert_array_equal(tv, jv)
    assert tv[4] == 0.0
    assert to.boost_from_score(0) == jo.boost_from_score(0)


def _train_data(rng, name, n=N):
    X = rng.normal(size=(n, 7))
    X[rng.uniform(size=n) < 0.05, 3] = np.nan
    signal = X[:, 0] + 0.5 * X[:, 1] ** 2 - np.nan_to_num(X[:, 3])
    noisy = signal + 0.3 * rng.normal(size=n)
    if name in ("poisson", "gamma", "tweedie"):
        y = np.exp(0.5 * noisy)
    elif name.startswith("cross_entropy"):
        y = 1.0 / (1.0 + np.exp(-noisy))
    else:
        y = noisy + rng.standard_t(2, size=n)
    return X, y


def _grad_hess_bounds(b):
    """Bounds of a row's |gradient| and hessian over the run: twice the
    largest at the JAX engine's first (boost-from-average) and last
    score."""
    eng = b._engine
    first = jnp.full_like(eng.score, eng.objective.boost_from_score(0))
    g_max = h_max = 0.0
    for score in (first, eng.score):
        g, h = (np.abs(np.asarray(a)) for a in eng._gh_fn(score))
        g_max, h_max = max(g_max, g.max()), max(h_max, h.max())
    return 2 * g_max, 2 * h_max


TRAIN_CASES = (
    [pytest.param(n, False, "compact", id=n) for n in
     ["regression_l1", "huber", "fair", "quantile", "mape"]] +
    [pytest.param(n, True, "compact", id=f"{n}-weighted") for n in
     ["regression_l1", "quantile", "mape"]] +
    [pytest.param(n, False, "compact", id=n) for n in TRANSCENDENTAL] +
    [pytest.param(n, False, path, id=f"{n}-{path}")
     for n in ["regression_l1", "quantile"] for path in ("hybrid", "full")])
SCHED = {"compact": "compact", "hybrid": "level", "full": "full"}


@pytest.mark.parametrize("name,weighted,path", TRAIN_CASES)
def test_trained_trees_match_jax(rng, name, weighted, path):
    X, y = _train_data(rng, name)
    w = rng.uniform(0.5, 2.0, size=len(y)) if weighted else None
    params = {"objective": name, "num_leaves": 15, "learning_rate": 0.1,
              "device_type": "cpu", "verbosity": -1,
              "tpu_row_scheduling": SCHED[path]}
    jds = lgb.Dataset(X, label=y, weight=w)
    tds = lgt.Dataset(X, label=y, weight=w)
    jb = lgb.train(params, jds, num_boost_round=4, valid_sets=[jds],
                   valid_names=["train"], keep_training_booster=True)
    tb = lgt.train(params, tds, num_boost_round=4, valid_sets=[tds],
                   valid_names=["train"])
    assert tb.num_trees() == jb.num_trees() == 4
    metric = lgt.core.metrics.DEFAULT_METRIC_FOR_OBJECTIVE[name]
    if name in TRANSCENDENTAL or path != "compact":
        g_max, h_max = _grad_hess_bounds(jb)
        assert_trees_to_binary_standard(jb, tb, X, g_max=g_max,
                                        h_max=h_max)
        np.testing.assert_allclose(tb.best_score["train"][metric],
                                   jb.best_score["train"][metric],
                                   rtol=1e-6)
        return
    assert _trees(tb.model_to_string()) == _trees(jb.model_to_string())
    np.testing.assert_array_equal(tb.predict(X), jb.predict(X))
    assert tb.best_score["train"][metric] == jb.best_score["train"][metric]


@pytest.mark.parametrize("name", ["lambdarank", "rank_xendcg", "xendcg"])
def test_ranking_objectives_match_jax(rng, name):
    """The objective of each name (``xendcg`` is an alias of
    ``rank_xendcg``) created in both packages: the same class name and
    string, and gradients within rtol 1e-5, atol 1e-6 of the JAX
    package's (``tests/test_torch_ranking.py`` holds them in detail)."""
    sizes = rng.integers(2, 40, size=20)
    n = int(sizes.sum())
    label = rng.integers(0, 4, size=n).astype(np.float32)
    score = rng.normal(size=n).astype(np.float32)
    jmeta, tmeta = JMeta(n), TMeta(n)
    for md in (jmeta, tmeta):
        md.set_label(label)
        md.set_query(sizes)
    jo = jobj.create_objective(name, JConfig({"objective": name}))
    to = tobj.create_objective(name, TConfig({"objective": name}))
    jo.init(jmeta, n)
    to.init(tmeta, n, torch.device("cpu"))
    assert type(to).__name__ == type(jo).__name__
    assert to.to_string() == jo.to_string()
    jg, jh = jo.get_gradients(jnp.asarray(score))
    tg, th = to.get_gradients(torch.as_tensor(score))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-6)


def test_objective_strings_round_trip(rng):
    """``to_string`` as the JAX package writes it, and back through a
    model's text."""
    X, y = _train_data(rng, "quantile", n=300)
    for name in ["regression_l1", "huber", "fair", "quantile", "mape",
                 "poisson", "gamma", "tweedie", "cross_entropy",
                 "cross_entropy_lambda"]:
        jo = jobj.create_objective(name, JConfig({"objective": name}))
        to = tobj.create_objective(name, TConfig({"objective": name}))
        assert to.to_string() == jo.to_string()
        yy = (np.abs(y) if name not in ("cross_entropy",
                                        "cross_entropy_lambda")
              else 1.0 / (1.0 + np.exp(-y)))
        b = lgt.train({"objective": name, "num_leaves": 4,
                       "device_type": "cpu", "verbosity": -1},
                      lgt.Dataset(X, label=yy), num_boost_round=1)
        loaded = lgt.Booster({"device_type": "cpu"},
                             model_str=b.model_to_string())
        assert loaded._engine.objective.NAME == name
        np.testing.assert_array_equal(loaded.predict(X), b.predict(X))
