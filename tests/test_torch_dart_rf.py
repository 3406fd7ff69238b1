"""DART and random forest boosting in the PyTorch port against the JAX
package: the same params and the same data, made with numpy from a
seed, through both packages on the CPU.

Regression (L2, and L1's percentile refit in RF) is held bit for bit:
every tree's text and the training and validation scores. DART drops and
rescales earlier trees in place (uniform and weighted drops, with and
without ``xgboost_dart_mode``); RF keeps the running average of its
trees, so its text carries ``average_output`` and ``predict`` gives the
mean of the trees on every route (ROADMAP C10: a loaded RF model once
predicted their sum). Both models' texts load into the other package.
"""
import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.utils.log import LightGBMError

N, F, ROUNDS = 1000, 8, 5
RF_BAGGING = {"boosting": "rf", "bagging_fraction": 0.7, "bagging_freq": 1}


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


def _no_params(model_str):
    return model_str[:model_str.index("\nparameters:")]


_TRAINED = {}


def _train_both(params, seed=0, rounds=ROUNDS):
    """Both packages' boosters on the same rows, with a validation set;
    trained once a module for each set of arguments (most of a case's
    time is the JAX package's trace and compile)."""
    key = (tuple(sorted(params.items())), seed, rounds)
    if key not in _TRAINED:
        X, y = _data(seed)
        Xv, yv = _data(seed + 100, n=500)
        out = []
        for pkg in (lgb, lgt):
            tr = pkg.Dataset(X, label=y)
            out.append(pkg.train(params, tr, num_boost_round=rounds,
                                 valid_sets=[pkg.Dataset(
                                     Xv, label=yv, reference=tr)]))
        _TRAINED[key] = (X, out[0], out[1])
    return _TRAINED[key]


def assert_bit_for_bit(jb, tb):
    """Model text (bar the parameters block), training and validation
    scores, bit for bit."""
    assert _no_params(tb.model_to_string()) == _no_params(
        jb.model_to_string())
    np.testing.assert_array_equal(tb._engine.score.numpy(),
                                  np.asarray(jb._engine.score))
    for tv, jv in zip(tb._engine.valid_sets, jb._engine.valid_sets):
        np.testing.assert_array_equal(tv.score.numpy(), np.asarray(jv.score))


def _dart_params(uniform_drop=False, xgboost_dart_mode=False):
    return _params(boosting="dart", drop_rate=0.5, skip_drop=0.2,
                   uniform_drop=uniform_drop,
                   xgboost_dart_mode=xgboost_dart_mode)


@pytest.mark.parametrize("xgboost_dart_mode", [False, True],
                         ids=["dart", "xgboost_dart"])
@pytest.mark.parametrize("uniform_drop", [False, True],
                         ids=["weighted", "uniform"])
def test_dart_matches_jax_bit_for_bit(uniform_drop, xgboost_dart_mode):
    X, jb, tb = _train_both(_dart_params(uniform_drop, xgboost_dart_mode))
    assert tb._engine.NAME == "dart"
    assert_bit_for_bit(jb, tb)
    np.testing.assert_array_equal(tb.predict(X), jb.predict(X))


RF_VARIANTS = {"bagging": RF_BAGGING,
               "feature_fraction": {"boosting": "rf",
                                    "feature_fraction": 0.6},
               "l1": {**RF_BAGGING, "objective": "regression_l1"}}


@pytest.mark.parametrize("variant", RF_VARIANTS)
def test_rf_matches_jax_bit_for_bit(variant):
    X, jb, tb = _train_both(_params(**RF_VARIANTS[variant]), seed=1)
    assert tb._engine.average_output
    assert "\naverage_output\n" in tb.model_to_string()
    assert_bit_for_bit(jb, tb)
    np.testing.assert_array_equal(tb.predict(X), jb.predict(X))
    # the device route averages too (f32 sums on the CPU)
    np.testing.assert_allclose(tb.predict(X, device=True), jb.predict(X),
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def jax_rf():
    """A binary RF trained by the JAX package, its rows and its text."""
    X, y = _data(2, objective="binary")
    params = _params("binary", **RF_BAGGING)
    jb = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=3)
    return X, jb, jb.model_to_string()


def test_loaded_rf_predicts_the_mean_of_its_trees(jax_rf, tmp_path):
    """ROADMAP C10: the port predicted the sum of a loaded RF's trees,
    three times the JAX package's raw score at three iterations."""
    X, jb, text = jax_rf
    tb = lgt.Booster({"device_type": "cpu"}, model_str=text)
    for raw in (True, False):
        np.testing.assert_allclose(tb.predict(X, raw_score=raw),
                                   jb.predict(X, raw_score=raw), rtol=1e-9)
        np.testing.assert_allclose(tb.predict(X, raw_score=raw, device=True),
                                   tb.predict(X, raw_score=raw),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb.predict(X, num_iteration=2, raw_score=True),
                               jb.predict(X, num_iteration=2, raw_score=True),
                               rtol=1e-9)
    path = tmp_path / "rows.csv"
    np.savetxt(path, np.column_stack([np.zeros(len(X)), X]), delimiter=",")
    np.testing.assert_allclose(tb.predict(str(path)), jb.predict(X),
                               rtol=1e-9)


def test_rf_pred_contrib_is_the_jax_packages(jax_rf):
    """The JAX package does not average an RF's contributions: they sum
    to the trees' total, not to the averaged raw score."""
    X, jb, text = jax_rf
    tb = lgt.Booster({"device_type": "cpu"}, model_str=text)
    contrib = tb.predict(X[:50], pred_contrib=True)
    np.testing.assert_allclose(contrib, jb.predict(X[:50], pred_contrib=True),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(contrib.sum(axis=1),
                               3 * tb.predict(X[:50], raw_score=True),
                               rtol=1e-9)


@pytest.mark.parametrize("boosting", ["dart", "rf"])
def test_model_text_loads_both_ways(boosting):
    X, jb, tb = (_train_both(_dart_params()) if boosting == "dart" else
                 _train_both(_params(**RF_BAGGING), seed=1))
    t_in_j = lgb.Booster(model_str=tb.model_to_string())
    j_in_t = lgt.Booster({"device_type": "cpu"},
                         model_str=jb.model_to_string())
    for loaded, trained in ((t_in_j, tb), (j_in_t, jb)):
        np.testing.assert_allclose(loaded.predict(X), trained.predict(X),
                                   rtol=1e-9)


@pytest.mark.parametrize("boosting", ["dart", "rf"])
def test_init_model_continues_as_the_jax_package(boosting, tmp_path):
    """Continued training indexes this run's trees past the init
    model's (DART's drops, RF's running average)."""
    params = (_params(boosting="dart", drop_rate=0.5, skip_drop=0.0)
              if boosting == "dart" else _params(**RF_BAGGING))
    X, y = _data(4)
    first = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=3)
    path = str(tmp_path / "init.txt")
    first.save_model(path)
    jb = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=3,
                   init_model=path)
    tb = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=3,
                   init_model=path)
    assert tb._engine.num_init_iteration == 3
    assert tb.current_iteration() == 6
    assert_bit_for_bit(jb, tb)


@pytest.mark.parametrize("boosting,engine", [
    ("gbrt", "gbdt"), ("goss", "gbdt"), ("random_forest", "rf"),
    ("dart", "dart")])
def test_every_spelling_builds_its_engine(boosting, engine):
    """``create_boosting`` takes the JAX package's spellings; ``goss``
    is gbdt with the GOSS sampler."""
    from lightgbm_tpu_torch.models.sample_strategy import (BaggingStrategy,
                                                           GOSSStrategy)
    X, y = _data(6, n=200)
    b = lgt.Booster(_params(boosting=boosting, **(
        {"feature_fraction": 0.5} if engine == "rf" else {})),
        lgt.Dataset(X, label=y))
    assert b._engine.NAME == engine
    sampler = GOSSStrategy if boosting == "goss" else BaggingStrategy
    assert type(b._engine.sample_strategy) is sampler
    assert not b.update()


def test_rf_needs_sampling_and_refuses_a_custom_objective():
    X, y = _data(5)
    with pytest.raises(LightGBMError, match="RF mode requires bagging"):
        lgt.train(_params(boosting="rf"), lgt.Dataset(X, label=y),
                  num_boost_round=1)
    with pytest.raises(LightGBMError, match="custom objective"):
        lgt.train(_params(objective=lambda s, d: (s - y, np.ones_like(s)),
                          **RF_BAGGING), lgt.Dataset(X, label=y),
                  num_boost_round=1)
