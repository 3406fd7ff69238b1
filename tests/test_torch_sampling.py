"""Row and column sampling in the PyTorch port against the JAX package.

Bagging (uniform, balanced by label, by query, ``tpu_device_bagging``'s
threefry draw), GOSS and column sampling (``feature_fraction`` a tree,
``feature_fraction_bynode`` a node): the same params and the same data,
made with numpy from a seed, through both packages on the CPU, the port
through its kernels' plain versions. The samplers draw from numpy
generators seeded as the JAX package's are, so both packages draw the
same bags and masks.

Regression (L2, and L1 with its percentile refit over the bag) through
the compact grower is held bit for bit: every tree's text and the
training score. Binary and
multiclass go through ``exp``, whose last ulp differs between XLA's CPU
and torch (ROADMAP C1(a)): their trees are held to the binary standard
of ``tests/test_torch_multiclass.py``, with GOSS's amplification in the
bound on a row's gradient and hessian.
"""
import numpy as np
import pytest
from test_torch_multiclass import assert_trees_to_binary_standard

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.models.sample_strategy import BaggingStrategy
from lightgbm_tpu_torch.utils import log

N, F, ROUNDS = 1000, 8, 5
GOSS = {"data_sample_strategy": "goss", "learning_rate": 0.5,
        "top_rate": 0.2, "other_rate": 0.2}
# GOSS multiplies the gradient and hessian of a sampled small-gradient
# row by (1 - top_rate) / other_rate
GOSS_AMP = 4.0
BAGGING = {"bagging_fraction": 0.6, "bagging_freq": 2}


def _data(seed=0, n=N, objective="regression"):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F))
    X[rng.uniform(size=n) < 0.05, 3] = np.nan
    signal = X[:, 0] + 0.5 * X[:, 1] ** 2 - np.nan_to_num(X[:, 3])
    if objective == "binary":
        return X, (signal + 0.5 * rng.normal(size=n) > 0.5).astype(float)
    return X, signal + 0.1 * rng.normal(size=n)


def _params(objective="regression", **extra):
    return {"objective": objective, "num_leaves": 15, "min_data_in_leaf": 5,
            "verbosity": -1, "device_type": "cpu", **extra}


def _train(pkg, params, X, y, rounds=ROUNDS, **ds_kw):
    return pkg.train(params, pkg.Dataset(X, label=y, **ds_kw),
                     num_boost_round=rounds)


def _tree_text(bst):
    s = bst.model_to_string()
    return s[s.index("Tree=0"):s.index("end of trees")]


def assert_bit_for_bit(jb, tb):
    """Every tree's text and the training score, bit for bit."""
    assert tb.num_trees() == jb.num_trees()
    assert _tree_text(tb) == _tree_text(jb)
    np.testing.assert_array_equal(tb._engine.score.numpy(),
                                  np.asarray(jb._engine.score))


def _both(params, X, y, rounds=ROUNDS, **ds_kw):
    return (_train(lgb, params, X, y, rounds, **ds_kw),
            _train(lgt, params, X, y, rounds, **ds_kw))


def test_balanced_bagging_is_not_ignored():
    """ROADMAP C9: ``pos_bagging_fraction`` bags every iteration even at
    ``bagging_freq=0``; the port once trained as if it were absent."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(400, 5))
    y = (X[:, 0] + rng.normal(size=400) > 0).astype(float)
    params = _params("binary", num_leaves=7, pos_bagging_fraction=0.3)
    jb, tb = _both(params, X, y, rounds=2)
    assert _tree_text(jb) != _tree_text(_train(
        lgb, _params("binary", num_leaves=7), X, y, rounds=2))
    assert_trees_to_binary_standard(jb, tb, X, g_max=1.0, h_max=0.25)


VARIANTS = {
    "bagging": BAGGING,
    "balanced": {"pos_bagging_fraction": 0.5, "neg_bagging_fraction": 0.7},
    "by_query": {"bagging_fraction": 0.5, "bagging_freq": 1,
                 "bagging_by_query": True},
    "device_bagging": {**BAGGING, "tpu_device_bagging": True},
    "feature_fraction": {"feature_fraction": 0.6},
    "bynode": {"feature_fraction": 0.8, "feature_fraction_bynode": 0.5},
    "goss": GOSS,
    "l1_bagging": {"objective": "regression_l1", **BAGGING},
    "quantized_bagging": {"use_quantized_grad": True, **BAGGING},
    "quantized_goss": {"use_quantized_grad": True, **GOSS},
}


@pytest.mark.parametrize("variant", VARIANTS)
def test_l2_sampling_matches_jax_bit_for_bit(variant):
    X, y = _data()
    ds_kw = {}
    if variant == "by_query":
        ds_kw["group"] = np.full(N // 50, 50)
    jb, tb = _both(_params(**VARIANTS[variant]), X, y, **ds_kw)
    assert_bit_for_bit(jb, tb)
    if variant == "device_bagging":
        # the device draw keeps about, not exactly, the fraction
        sel = tb._engine.sample_strategy._dev_cached[1][0]
        assert 0.5 < float(sel.mean()) < 0.7


PATHS = {"full": {"tpu_row_scheduling": "full"},
         "level": {"tpu_row_scheduling": "level", "max_depth": 4},
         "hybrid": {"tpu_row_scheduling": "level",
                    "tpu_level_handoff_depth": 2}}


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("sampling", ["bagging", "feature_fraction"])
def test_sampling_through_every_grower(path, sampling):
    """Bagging and column sampling through the full, level and hybrid
    growers (compact above): every physical row stays in the partition,
    and each grower picks the child it builds as the JAX package's
    does. These growers' regression trees agree with the JAX package's
    to f32 reassociation, not bit for bit (ROADMAP C1(b), C1(c)), so
    they are held to the binary standard on the raw score."""
    X, y = _data(seed=2)
    extra = BAGGING if sampling == "bagging" else {"feature_fraction": 0.6}
    jb, tb = _both(_params(**PATHS[path], **extra), X, y, rounds=4)
    assert_trees_to_binary_standard(jb, tb, X, g_max=2 * np.abs(y).max(),
                                    h_max=1.0, converted=False)


def test_bynode_on_level_falls_back_to_compact(capsys):
    X, y = _data(seed=3)
    log.logged_once.clear()
    params = _params(tpu_row_scheduling="level", max_depth=4,
                     feature_fraction_bynode=0.5, verbosity=0)
    tb = lgt.Booster(params, lgt.Dataset(X, label=y))
    assert tb._engine.row_sched == "compact"
    assert ("tpu_row_scheduling='level' does not support "
            "feature_fraction_bynode — falling back to 'compact'"
            in capsys.readouterr().err)
    for _ in range(3):
        tb.update()
    jb = _train(lgb, {**params, "verbosity": -1}, X, y, rounds=3)
    assert_bit_for_bit(jb, tb)


@pytest.mark.parametrize("extra", [BAGGING, GOSS],
                         ids=["bagging", "goss"])
def test_binary_sampling_to_the_binary_standard(extra):
    X, y = _data(seed=4, objective="binary")
    params = _params("binary", **extra)
    jb, tb = _both(params, X, y)
    amp = GOSS_AMP if extra is GOSS else 1.0
    bags = None
    if extra is BAGGING:
        # the bags, drawn again from a sampler seeded as the engine's
        sampler = BaggingStrategy(lgt.Config(params), N)
        bags = [sampler.sample(it)[0] > 0 for it in range(ROUNDS)]
    assert_trees_to_binary_standard(jb, tb, X, g_max=amp, h_max=0.25 * amp,
                                    rate=extra.get("learning_rate", 0.1),
                                    bags=bags)


def test_softmax_with_bagging_and_feature_fraction():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(N, F))
    s = np.stack([X[:, 0], X[:, 1] - X[:, 2], 0.5 * X[:, 4] ** 2])
    y = np.argmax(s + 0.5 * rng.normal(size=s.shape), axis=0).astype(float)
    params = _params("multiclass", num_class=3, feature_fraction=0.7,
                     **BAGGING)
    jb, tb = _both(params, X, y, rounds=4)
    assert_trees_to_binary_standard(jb, tb, X, objective="multiclass")


def test_reset_parameter_changes_the_bag_mid_run():
    X, y = _data(seed=6)
    params = _params(bagging_fraction=0.8, bagging_freq=1)
    boosters = []
    for pkg in (lgb, lgt):
        b = pkg.Booster(params, pkg.Dataset(X, label=y))
        for _ in range(2):
            b.update()
        b.reset_parameter({"bagging_fraction": 0.4})
        for _ in range(2):
            b.update()
        boosters.append(b)
    jb, tb = boosters
    assert tb._engine.sample_strategy.config.bagging_fraction == 0.4
    assert_bit_for_bit(jb, tb)


def test_regressor_subsample_and_colsample_reach_the_engine():
    X, y = _data(seed=7)
    kw = dict(n_estimators=4, num_leaves=15, min_child_samples=5,
              subsample=0.7, subsample_freq=1, colsample_bytree=0.6,
              verbose=-1)
    j = lgb.LGBMRegressor(**kw).fit(X, y)
    t = lgt.LGBMRegressor(device_type="cpu", **kw).fit(X, y)
    cfg = t.booster_._engine.config
    assert (cfg.bagging_fraction, cfg.bagging_freq,
            cfg.feature_fraction) == (0.7, 1, 0.6)
    assert _tree_text(t.booster_) == _tree_text(j.booster_)
    np.testing.assert_array_equal(t.predict(X), j.predict(X))
