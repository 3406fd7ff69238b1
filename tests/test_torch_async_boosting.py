"""Asynchronous boosting (``tpu_async_boosting``) in the PyTorch port.

The port's grower returns host trees, so asynchronous boosting changes
one thing: GOSS draws on the device from the stateless threefry chain
``fold_in(PRNGKey(bagging_seed), iter)`` (``GOSSStrategy.sample_dev``),
the JAX package's asynchronous draw, and no ``[K, N]`` gradient reaches
the host. Every other model is the synchronous one, string for string:
the cases below train each setting with ``tpu_async_boosting`` true and
false on the CPU and compare the tree blocks of the model text. The GOSS
draw is held to the JAX package's ``sample_dev`` bit for bit, and an L2
GOSS model under ``true`` to the JAX package's own, string for string
(ROADMAP C14: the port once ignored the option and drew GOSS on the
host).
"""
import jax
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.models.sample_strategy import GOSSStrategy as JaxGOSS
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.models.sample_strategy import GOSSStrategy
from lightgbm_tpu_torch.utils import prng

N, F, ROUNDS = 800, 6, 6


def _data(n=N, seed=0, objective="binary"):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F))
    signal = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.1 * rng.normal(size=n)
    if objective == "binary":
        return X, (signal > 0).astype(np.float64)
    return X, signal


def _params(**extra):
    return {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1,
            "min_data_in_leaf": 5, "verbosity": -1, "device_type": "cpu",
            "seed": 7, **extra}


def _trees(bst):
    s = bst.model_to_string()
    return s[s.index("Tree=0"):s.index("end of trees")]


def _pair(params, X, y, rounds=ROUNDS, **train_kw):
    """The same run with ``tpu_async_boosting`` false and true."""
    out = {}
    for mode in ("false", "true"):
        out[mode] = lgt.train(dict(params, tpu_async_boosting=mode),
                              lgt.Dataset(X, label=y),
                              num_boost_round=rounds, **train_kw)
    return out["false"], out["true"]


def _assert_same(sync, asyn, X):
    assert sync.num_trees() == asyn.num_trees()
    assert _trees(sync) == _trees(asyn)
    np.testing.assert_array_equal(sync.predict(X), asyn.predict(X))


SAME_CASES = {
    "plain": {},
    "bagging_feature_fraction": dict(bagging_fraction=0.8, bagging_freq=1,
                                     feature_fraction=0.9),
    "device_bagging": dict(bagging_fraction=0.7, bagging_freq=2,
                           tpu_device_bagging=True),
    "multiclass": dict(objective="multiclass", num_class=3, num_leaves=7),
}


@pytest.mark.parametrize("name", sorted(SAME_CASES))
def test_async_matches_sync(name):
    extra = SAME_CASES[name]
    X, y = _data()
    if extra.get("objective") == "multiclass":
        y = np.digitize(X[:, 0] + 0.3 * X[:, 1], [-0.5, 0.5]).astype(float)
    sync, asyn = _pair(_params(**extra), X, y)
    assert asyn._engine._async_mode is True
    assert sync._engine._async_mode is False
    _assert_same(sync, asyn, X)


FALLBACK_CASES = {
    "linear": dict(linear_tree=True),
    "cegb": dict(cegb_penalty_split=0.1),
    "renew_l1": dict(objective="regression_l1"),
    "quantized_renew": dict(use_quantized_grad=True,
                            quant_train_renew_leaf=True),
    "dart": dict(boosting="dart", drop_rate=0.3),
    "rf": dict(boosting="rf", bagging_fraction=0.6, bagging_freq=1),
}


@pytest.mark.parametrize("name", sorted(FALLBACK_CASES))
def test_fallback_features_train_synchronously(name):
    """The settings that need a host step each iteration leave
    asynchronous boosting, with the JAX package's one-time log line, and
    give the synchronous model."""
    extra = FALLBACK_CASES[name]
    X, y = _data(objective="regression"
                 if extra.get("objective") == "regression_l1" else "binary")
    params = _params(**extra)
    out = {}
    for mode in ("false", "true"):
        p = dict(params, tpu_async_boosting=mode)
        out[mode] = lgt.train(p, lgt.Dataset(X, label=y, params=p),
                              num_boost_round=4)
    assert out["true"]._engine._async_on() is False
    assert _trees(out["true"]) == _trees(out["false"])


def test_fallback_is_logged_once():
    from lightgbm_tpu_torch.utils import log
    X, y = _data()
    msgs = []
    log.register_logger(msgs.append)
    try:
        p = _params(cegb_penalty_split=0.1, tpu_async_boosting="true",
                    verbosity=1)
        lgt.train(p, lgt.Dataset(X, label=y), num_boost_round=3)
    finally:
        log.register_logger(None)
        log.set_verbosity(-1)
    said = [m for m in msgs if "falling back to the synchronous path" in m]
    assert len(said) == 1, msgs


def test_custom_gradients_train_synchronously():
    """An iteration given its gradients (``fobj``) takes the synchronous
    body, as in the JAX package; the model is the synchronous one."""
    X, y = _data(objective="regression")

    def fobj(score, ds):
        return score - ds.get_label(), np.ones_like(score)

    out = {}
    for mode in ("false", "true"):
        p = _params(objective=fobj, tpu_async_boosting=mode)
        out[mode] = lgt.train(p, lgt.Dataset(X, label=y), num_boost_round=4)
    assert _trees(out["true"]) == _trees(out["false"])


def test_async_valid_set_eval_matches():
    X, y = _data()
    Xv, yv = _data(n=300, seed=1)
    hist = {}
    for mode in ("false", "true"):
        ds = lgt.Dataset(X, label=y)
        rec = {}
        lgt.train(_params(tpu_async_boosting=mode), ds, num_boost_round=5,
                  valid_sets=[lgt.Dataset(Xv, label=yv, reference=ds)],
                  valid_names=["v"], callbacks=[lgt.record_evaluation(rec)])
        hist[mode] = rec["v"]["binary_logloss"]
    assert hist["true"] == hist["false"]


def test_async_stop_detection_exact():
    """Training that runs out of splits stops at the same iteration with
    the same model."""
    rng = np.random.default_rng(5)
    X = rng.integers(0, 3, size=(200, 3)).astype(np.float64)
    y = (X[:, 0] > 1).astype(np.float64)
    params = _params(num_leaves=4, learning_rate=0.5,
                     min_gain_to_split=1e-3)
    sync, asyn = _pair(params, X, y, rounds=40)
    assert sync.current_iteration() < 40
    _assert_same(sync, asyn, X)


def test_async_first_iteration_degenerate():
    """No valid split at iteration 0: both keep the boost-from-average
    constant tree and stop."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(400, 4))
    y = (rng.uniform(size=400) < 0.75).astype(np.float64)
    sync, asyn = _pair(_params(num_leaves=4, min_gain_to_split=1e6), X, y,
                       rounds=5)
    _assert_same(sync, asyn, X)
    assert abs(float(asyn.predict(X[:1])[0]) - 0.75) < 0.05


def test_async_model_text_round_trip():
    X, y = _data()
    _, asyn = _pair(_params(), X, y)
    back = lgt.Booster({"device_type": "cpu"},
                       model_str=asyn.model_to_string())
    np.testing.assert_array_equal(back.predict(X), asyn.predict(X))


def test_async_rollback_one_iter():
    X, y = _data()
    scores = {}
    for mode in ("false", "true"):
        b = lgt.Booster(_params(tpu_async_boosting=mode),
                        lgt.Dataset(X, label=y))
        for _ in range(4):
            b.update()
        before = b._engine.score.clone()
        b.update()
        b.rollback_one_iter()
        assert b.current_iteration() == 4
        torch.testing.assert_close(b._engine.score, before, rtol=0,
                                   atol=1e-6)
        scores[mode] = b._engine.score.numpy().copy()
    np.testing.assert_array_equal(scores["true"], scores["false"])


def test_async_continued_training_matches_sync():
    X, y = _data()
    first = lgt.train(_params(tpu_async_boosting="true"),
                      lgt.Dataset(X, label=y), num_boost_round=4)
    text = first.model_to_string()
    out = {}
    for mode in ("false", "true"):
        out[mode] = lgt.train(
            _params(tpu_async_boosting=mode), lgt.Dataset(X, label=y),
            num_boost_round=3,
            init_model=lgt.Booster({"device_type": "cpu"}, model_str=text))
    assert out["true"].num_trees() == 7
    _assert_same(out["false"], out["true"], X)


def test_async_early_stopping_matches_sync():
    X, y = _data()
    Xv, yv = _data(n=300, seed=9)
    best = {}
    for mode in ("false", "true"):
        ds = lgt.Dataset(X, label=y)
        b = lgt.train(_params(tpu_async_boosting=mode, num_leaves=31,
                              learning_rate=0.5, min_data_in_leaf=2),
                      ds, num_boost_round=40,
                      valid_sets=[lgt.Dataset(Xv, label=yv, reference=ds)],
                      callbacks=[lgt.early_stopping(3, verbose=False)])
        best[mode] = (b.best_iteration, _trees(b))
    assert 0 < best["true"][0] < 40
    assert best["true"] == best["false"]


def test_auto_is_off_on_the_cpu():
    X, y = _data()
    b = lgt.train(_params(), lgt.Dataset(X, label=y), num_boost_round=1)
    assert b._engine._async_mode is False


# ---------------------------------------------------------------------------
# GOSS: the device draw
# ---------------------------------------------------------------------------

GOSS = dict(data_sample_strategy="goss", learning_rate=0.5, top_rate=0.2,
            other_rate=0.2)


def test_c14_async_goss_l2_matches_jax_string_for_string():
    """ROADMAP C14. ``data_sample_strategy=goss`` with
    ``tpu_async_boosting=true`` draws GOSS from the device chain in the
    JAX package; the port once ignored the option and drew on the host,
    so the models differed. Five rounds pass the warm-up of
    int(1 / 0.5) = 2 iterations."""
    X, y = _data(n=2000, objective="regression")
    params = dict(_params(objective="regression", num_leaves=7, **GOSS),
                  tpu_async_boosting="true")
    jb = lgb.train(dict(params), lgb.Dataset(X, label=y), num_boost_round=5)
    tb = lgt.train(dict(params), lgt.Dataset(X, label=y), num_boost_round=5)
    assert _trees(tb) == _trees(jb)
    np.testing.assert_array_equal(tb._engine.score.numpy(),
                                  np.asarray(jb._engine.score))
    assert tb._engine._goss_dev_used


def test_async_goss_differs_from_sync_goss():
    """The device draw is a GOSS draw of its own, not the host
    generator's: the two models part from the first sampled
    iteration."""
    X, y = _data(objective="regression")
    sync, asyn = _pair(_params(objective="regression", **GOSS), X, y,
                       rounds=4)
    assert not sync._engine._goss_dev_used and asyn._engine._goss_dev_used
    t_sync, t_async = _trees(sync), _trees(asyn)
    cut = t_sync.index("Tree=2")
    assert t_sync[:cut] == t_async[:cut]
    assert t_sync[cut:] != t_async[cut:]


@pytest.mark.parametrize("K", [1, 3])
def test_goss_sample_dev_matches_jax_bit_for_bit(K):
    rng = np.random.default_rng(K)
    n = 3000
    grad = rng.normal(size=(K, n)).astype(np.float32)
    hess = rng.uniform(0.05, 1.0, size=(K, n)).astype(np.float32)
    # ties at the threshold: whole runs of equal |g h|
    grad[:, :200] = 0.5
    hess[:, :200] = 0.5
    params = dict(GOSS, bagging_seed=11)
    jdraw = JaxGOSS(JaxConfig(params), n, K).sample_dev(
        4, jax.numpy.asarray(grad), jax.numpy.asarray(hess),
        jax.random.fold_in(jax.random.PRNGKey(11), 4))
    tdraw = GOSSStrategy(Config(params), n, K).sample_dev(
        4, torch.from_numpy(grad), torch.from_numpy(hess),
        prng.fold_in(prng.prng_key(11), 4))
    for j, t in zip(jdraw, tdraw):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert 0 < float(tdraw[0].sum()) < n
    # the warm-up draws nothing
    assert GOSSStrategy(Config(params), n, K).sample_dev(
        1, torch.from_numpy(grad), torch.from_numpy(hess), (0, 1)) is None


def test_async_goss_reads_no_gradient_to_the_host(monkeypatch):
    """Under asynchronous boosting GOSS never calls the host sampler."""
    X, y = _data(objective="regression")
    b = lgt.Booster(_params(objective="regression",
                            tpu_async_boosting="true", **GOSS),
                    lgt.Dataset(X, label=y))

    def host_draw(*a, **k):
        raise AssertionError("host GOSS draw under async boosting")
    monkeypatch.setattr(b._engine.sample_strategy, "sample", host_draw)
    for _ in range(4):
        b.update()
    assert b._engine._goss_dev_used


def test_sync_iteration_after_device_goss_rederives_the_draw():
    """Once GOSS has drawn on the device, a synchronous iteration (here
    one given its gradients: L2's own, exact on f32 labels) re-derives
    the same stateless draw, as the JAX package does after its
    stop-check replay."""
    X, y = _data(objective="regression")
    y = y.astype(np.float32).astype(np.float64)
    texts = {}
    for custom in (False, True):
        b = lgt.Booster(_params(objective="regression",
                                tpu_async_boosting="true", **GOSS),
                        lgt.Dataset(X, label=y))
        for _ in range(3):
            b.update()
        assert b._engine._goss_dev_used
        if custom:
            b.update(fobj=lambda s, ds: (s - ds.get_label(),
                                         np.ones_like(s)))
        else:
            b.update()
        texts[custom] = _trees(b)
    assert texts[True] == texts[False]
