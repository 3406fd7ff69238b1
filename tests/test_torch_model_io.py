"""Model text loading in the PyTorch port against the JAX package.

The golden models of the reference LightGBM (``tests/data/golden``, a
binary model with categorical splits and a regression model) load in the
port and predict the reference's predictions within rtol 1e-9 / atol
1e-12 (as ``tests/test_consistency.py``), and the port's host walk gives
the JAX package's answers bit for bit, categorical nodes included. Text
round trips (the port's own models, and each package's model loaded by
the other) give the same text apart from the parameters block, the same
predictions bit for bit, and the same ``dump_model``. A loaded model's
device route runs on the device its params name, ``cuda`` by default:
with no card it raises instead of answering from the CPU.
"""
import json
import os

import numpy as np
import pytest
import torch
from conftest import GOLDEN_DIR, load_golden_csv

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.utils.log import LightGBMError

CPU = {"device_type": "cpu"}
GOLDEN = [pytest.param("model.txt", "test.csv", "pred.txt", id="binary"),
          pytest.param("reg_model.txt", "reg_train.csv", "reg_pred.txt",
                       id="regression")]


def _no_params(model_str):
    """A model's text without its parameters block."""
    return model_str[:model_str.index("\nparameters:")]


def _data(rng, objective, n=1200, f=6):
    X = rng.normal(size=(n, f))
    X[rng.uniform(size=n) < 0.05, 2] = np.nan
    signal = X[:, 0] * 2 + np.sin(X[:, 1] * 3) - np.nan_to_num(X[:, 2])
    if objective == "binary":
        return X, (signal + rng.normal(size=n) > 0).astype(np.float64)
    return X, signal + rng.normal(scale=0.1, size=n)


def _params(objective, **extra):
    return {"objective": objective, "num_leaves": 15, "verbosity": -1,
            **CPU, **extra}


@pytest.mark.parametrize("model,data,pred", GOLDEN)
def test_golden_model_predicts_reference_and_jax_bit_for_bit(model, data,
                                                             pred):
    _, X = load_golden_csv(data)
    ref = np.loadtxt(os.path.join(GOLDEN_DIR, pred))
    path = os.path.join(GOLDEN_DIR, model)
    tb = lgt.Booster(CPU, model_file=path)
    jb = lgb.Booster(model_file=path)
    np.testing.assert_allclose(tb.predict(X), ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(tb.predict(X), jb.predict(X))
    np.testing.assert_array_equal(tb.predict(X, raw_score=True),
                                  jb.predict(X, raw_score=True))
    np.testing.assert_array_equal(tb.predict(X, pred_leaf=True),
                                  jb.predict(X, pred_leaf=True))
    assert tb.num_trees() == jb.num_trees()
    assert tb.num_model_per_iteration() == 1


def test_golden_model_has_categorical_nodes_decided_like_jax():
    """model.txt's categorical trees: unseen categories, negative values
    and NaN go right, in both packages alike."""
    tb = lgt.Booster(CPU, model_file=os.path.join(GOLDEN_DIR, "model.txt"))
    jb = lgb.Booster(model_file=os.path.join(GOLDEN_DIR, "model.txt"))
    cats = [t for t in tb._engine.models if t.num_cat > 0]
    assert {t.num_cat for t in cats} >= {2, 3}
    _, X = load_golden_csv("test.csv")
    X = np.repeat(X[:50], 5, axis=0)
    X[:, 7] = np.tile([np.nan, -1.0, 0.0, 3.0, 1e6], 50)
    for t in cats:
        assert t.cat_values(0) == jb._engine.models[
            tb._engine.models.index(t)].cat_values(0)
    np.testing.assert_array_equal(tb.predict(X, raw_score=True),
                                  jb.predict(X, raw_score=True))


def test_categorical_model_device_route_warns_and_uses_host_walk(capfd):
    tb = lgt.Booster({**CPU, "verbosity": 1},
                     model_file=os.path.join(GOLDEN_DIR, "model.txt"))
    _, X = load_golden_csv("test.csv")
    X = X.astype(np.float32).astype(np.float64)
    out = tb.predict(X, device=True, raw_score=True)
    assert "categorical splits" in capfd.readouterr().err
    np.testing.assert_array_equal(out, tb.predict(X, raw_score=True))


@pytest.mark.parametrize("model,data,pred", GOLDEN)
def test_golden_text_and_dump_equal_jax(model, data, pred):
    path = os.path.join(GOLDEN_DIR, model)
    tb = lgt.Booster(CPU, model_file=path)
    jb = lgb.Booster(model_file=path)
    assert _no_params(tb.model_to_string()) == \
        _no_params(jb.model_to_string())
    assert tb.dump_model() == jb.dump_model()
    for kind in ("split", "gain"):
        np.testing.assert_array_equal(tb.feature_importance(kind),
                                      jb.feature_importance(kind))


@pytest.mark.parametrize("objective", ["regression", "binary"])
def test_port_model_round_trips_through_both_packages(rng, objective):
    X, y = _data(rng, objective)
    tb = lgt.train(_params(objective), lgt.Dataset(X, label=y),
                   num_boost_round=6)
    text = tb.model_to_string()
    from_port = lgt.Booster(CPU, model_str=text)
    from_jax = lgb.Booster(model_str=text)
    assert _no_params(from_port.model_to_string()) == _no_params(text)
    assert _no_params(from_jax.model_to_string()) == _no_params(text)
    want = tb.predict(X, raw_score=True)
    np.testing.assert_array_equal(from_port.predict(X, raw_score=True),
                                  want)
    np.testing.assert_array_equal(from_jax.predict(X, raw_score=True), want)
    np.testing.assert_array_equal(from_port.predict(X), tb.predict(X))
    assert from_port.dump_model() == from_jax.dump_model()


@pytest.mark.parametrize("objective", ["regression", "binary"])
def test_jax_model_loads_in_port_with_equal_text(rng, objective):
    X, y = _data(rng, objective)
    jb = lgb.train(_params(objective), lgb.Dataset(X, label=y),
                   num_boost_round=6)
    text = jb.model_to_string()
    tb = lgt.Booster(CPU, model_str=text)
    assert _no_params(tb.model_to_string()) == _no_params(text)
    np.testing.assert_array_equal(tb.predict(X, raw_score=True),
                                  jb.predict(X, raw_score=True))
    np.testing.assert_array_equal(tb.predict(X), jb.predict(X))
    assert tb.dump_model() == lgb.Booster(model_str=text).dump_model()


def test_save_model_file_and_model_from_string(rng, tmp_path):
    X, y = _data(rng, "regression")
    tb = lgt.train(_params("regression"), lgt.Dataset(X, label=y),
                   num_boost_round=4)
    path = tmp_path / "model.txt"
    tb.save_model(path)
    loaded = lgt.Booster(CPU, model_file=str(path))
    np.testing.assert_array_equal(loaded.predict(X), tb.predict(X))
    other = lgt.Booster(CPU, model_str=lgt.Booster(
        CPU, model_file=os.path.join(GOLDEN_DIR, "reg_model.txt"))
        .model_to_string())
    other.model_from_string(path.read_text())
    np.testing.assert_array_equal(other.predict(X), tb.predict(X))
    assert other.num_trees() == 4


def test_dump_model_is_json_with_every_tree(rng):
    X, y = _data(rng, "regression")
    tb = lgt.train(_params("regression"), lgt.Dataset(X, label=y),
                   num_boost_round=3)
    d = json.loads(json.dumps(tb.dump_model()))
    assert d["version"] == "v4" and len(d["tree_info"]) == 3
    root = d["tree_info"][0]["tree_structure"]
    assert "split_feature" in root and "left_child" in root
    assert len(tb.dump_model(num_iteration=2)["tree_info"]) == 2
    # of the same text, the JAX package's dump_model_dict equals the
    # port's (a live model's dump holds unrounded gains the text rounds)
    text = tb.model_to_string()
    assert lgt.Booster(CPU, model_str=text).dump_model() == \
        lgb.Booster(model_str=text).dump_model()


def test_loaded_model_raw_device_route_on_the_cpu(rng):
    """The raw route, asked for on the CPU, equals the host walk within
    f32 accumulation and is the engine's device answer."""
    X, y = _data(rng, "regression")
    X = X.astype(np.float32).astype(np.float64)
    tb = lgt.train(_params("regression"), lgt.Dataset(X, label=y),
                   num_boost_round=5)
    loaded = lgt.Booster(CPU, model_str=tb.model_to_string())
    dev = loaded.predict(X, device=True, raw_score=True)
    np.testing.assert_allclose(dev, loaded.predict(X, raw_score=True),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        dev, loaded._engine.predict_device(X, 0, 5)[:, 0])
    assert loaded._engine._serving.device.type == "cpu"


def test_loaded_model_device_is_cuda_unless_asked(monkeypatch):
    """The file's ``[device_type: cpu]`` is dropped at load: a loaded
    model runs on the card by default, and with no card its device route
    raises instead of answering from the CPU."""
    path = os.path.join(GOLDEN_DIR, "reg_model.txt")
    assert "[device_type: cpu]" in open(path).read()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, X = load_golden_csv("reg_train.csv")
    X = X.astype(np.float32).astype(np.float64)
    tb = lgt.Booster(model_file=path)
    assert tb.config.device_type == "cuda"
    with pytest.raises(LightGBMError, match="device_type"):
        tb.predict(X, device=True)
    host = tb.predict(X)
    cpu = lgt.Booster(CPU, model_file=path)
    np.testing.assert_allclose(cpu.predict(X, device=True), host, rtol=0,
                               atol=1e-5)


def test_linear_tree_model_is_refused(rng):
    X, y = _data(rng, "regression")
    text = lgt.train(_params("regression"), lgt.Dataset(X, label=y),
                     num_boost_round=2).model_to_string()
    assert "is_linear=0" in text
    with pytest.raises(LightGBMError, match="A12.6"):
        lgt.Booster(CPU, model_str=text.replace("is_linear=0",
                                                "is_linear=1", 1))


def test_loaded_tree_copy_is_deep():
    tb = lgt.Booster(CPU, model_file=os.path.join(GOLDEN_DIR, "model.txt"))
    t = next(t for t in tb._engine.models if t.num_cat > 0)
    c = t.copy()
    c.leaf_value[0] += 1.0
    c.cat_threshold[0] ^= 1
    assert c.leaf_value[0] != t.leaf_value[0]
    assert c.cat_threshold[0] != t.cat_threshold[0]
    assert c.from_text and t.from_text


def test_reg_sqrt_objective_survives_the_round_trip(rng):
    X, y = _data(rng, "regression")
    tb = lgt.train(_params("regression", reg_sqrt=True),
                   lgt.Dataset(X, label=np.abs(y)), num_boost_round=3)
    text = tb.model_to_string()
    assert "objective=regression sqrt" in text
    loaded = lgt.Booster(CPU, model_str=text)
    assert loaded._engine.objective.sqrt
    np.testing.assert_array_equal(loaded.predict(X), tb.predict(X))
