"""The scikit-learn estimators of the PyTorch port against the JAX
package's: ``LGBMRegressor``, ``LGBMClassifier`` (binary, multiclass,
string labels, ``class_weight``), ``LGBMRanker``, their parameters
(``get_params``, ``set_params``, ``sklearn.base.clone``), early stopping
through ``eval_set``, pickling, and fitting where scikit-learn cannot be
imported. Same inputs (numpy, from a seed), both packages on the CPU;
800 rows, 5 features, 15 leaves, 5 rounds.

Regression (L2) is the JAX package's bit for bit in the port on the CPU:
predictions, importances and ``evals_result_`` are held to rtol 1e-9.
Binary, multiclass and lambdarank go through ``exp`` (ROADMAP C1(a)):
the trees to the binary standard of ``tests/test_torch_multiclass.py``,
probabilities within rtol 1e-5 (atol 1e-7), raw scores within 1e-5 of
max(1, |score|), and the predicted classes equal.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
from test_torch_multiclass import assert_trees_to_binary_standard

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.utils.log import LightGBMError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, F = 800, 5
KW = {"n_estimators": 5, "num_leaves": 15, "min_child_samples": 5,
      "verbose": -1}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    X = rng.normal(size=(N, F))
    X[rng.uniform(size=N) < 0.05, 2] = np.nan
    y = X[:, 0] * 2 + np.sin(X[:, 1] * 3) + rng.normal(scale=0.5, size=N)
    s = np.stack([X[:, 0], X[:, 1] - X[:, 3], 0.5 * X[:, 4] ** 2])
    y3 = np.argmax(s + 0.5 * rng.normal(size=s.shape), axis=0)
    return {"X": X, "y": y, "yb": (y > np.median(y)).astype(np.int64),
            "y3": y3, "sizes": np.full(40, 20),
            "rel": np.searchsorted(np.quantile(y, [0.5, 0.75, 0.9, 0.97]),
                                   y).astype(np.float64)}


def _fit_both(cls_name, X, y, ctor=None, **fit_kw):
    ctor = {**KW, **(ctor or {})}
    return tuple(getattr(pkg, cls_name)(
        **ctor, **({"device_type": "cpu"} if pkg is lgt else {}))
        .fit(X, y, **fit_kw) for pkg in (lgb, lgt))


def _assert_raw_close(t, j):
    np.testing.assert_array_less(np.abs(t - j),
                                 1e-5 * np.maximum(1.0, np.abs(j)))


def test_regressor_matches_jax(data):
    j, t = _fit_both("LGBMRegressor", data["X"], data["y"])
    X = data["X"]
    np.testing.assert_allclose(t.predict(X), j.predict(X), rtol=1e-9,
                               atol=0)
    np.testing.assert_array_equal(t.feature_importances_,
                                  j.feature_importances_)
    assert t.n_features_in_ == j.n_features_in_ == F
    assert t.n_estimators_ == j.n_estimators_ == 5
    assert t.objective_ == j.objective_ == "regression"
    assert t.booster_.model_to_string()[:200] == \
        j.booster_.model_to_string()[:200]
    with pytest.raises(AttributeError):
        t.feature_names_in_
    with pytest.raises(ValueError, match="n_features"):
        t.predict(X[:, :3])


@pytest.mark.parametrize("case", ["binary", "multiclass", "string_labels",
                                  "class_weight"])
def test_classifier_matches_jax(data, case):
    X = data["X"]
    if case == "multiclass":
        y, ctor = data["y3"], None
    elif case == "string_labels":
        y, ctor = np.where(data["yb"] > 0, "yes", "no"), None
    elif case == "class_weight":
        y, ctor = data["y3"], {"class_weight": {0: 1.0, 1: 3.0, 2: 0.5}}
    else:
        y, ctor = data["yb"], None
    j, t = _fit_both("LGBMClassifier", X, y, ctor)
    np.testing.assert_array_equal(t.classes_, j.classes_)
    assert t.n_classes_ == j.n_classes_ == len(np.unique(y))
    obj = "binary" if t.n_classes_ == 2 else "multiclass"
    assert t.objective_ == j.objective_ == obj
    k = 1 if obj == "binary" else 3
    assert_trees_to_binary_standard(
        j.booster_, t.booster_, X, g_max=1.0 if ctor is None else 3.0,
        h_max=0.25 if k == 1 else 0.375 * (1.0 if ctor is None else 3.0))
    proba = t.predict_proba(X)
    assert proba.shape == (N, t.n_classes_)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-12)
    np.testing.assert_allclose(proba, j.predict_proba(X), rtol=1e-5,
                               atol=1e-7)
    _assert_raw_close(t.decision_function(X), j.decision_function(X))
    np.testing.assert_array_equal(t.predict(X), j.predict(X))
    np.testing.assert_array_equal(
        t.predict(X, raw_score=True), t.decision_function(X))


def test_ranker_matches_jax(data):
    j, t = _fit_both("LGBMRanker", data["X"], data["rel"],
                     group=data["sizes"], eval_at=[3])
    assert t.objective_ == j.objective_ == "lambdarank"
    assert_trees_to_binary_standard(j.booster_, t.booster_, data["X"],
                                    g_max=1.0, h_max=1.0, converted=False)
    _assert_raw_close(t.predict(data["X"]), j.predict(data["X"]))
    with pytest.raises(ValueError, match="group"):
        lgt.LGBMRanker(**KW).fit(data["X"], data["rel"])


def test_early_stopping_through_eval_set_matches_jax(data):
    X, y = data["X"], data["y"]
    fit_kw = dict(eval_set=[(X[600:], y[600:]), (X[:600], y[:600])],
                  eval_names=["held", "seen"], eval_metric="l1",
                  callbacks=None)
    out = {}
    for pkg in (lgb, lgt):
        kw = {**KW, "n_estimators": 200, "learning_rate": 0.3,
              "early_stopping_round": 3}
        if pkg is lgt:
            kw["device_type"] = "cpu"
        out[pkg] = pkg.LGBMRegressor(**kw).fit(X[:600], y[:600], **fit_kw)
    t, j = out[lgt], out[lgb]
    assert 1 < t.best_iteration_ < 200
    assert t.best_iteration_ == j.best_iteration_
    assert t.evals_result_.keys() == j.evals_result_.keys() == \
        {"held", "seen"}
    for name in ("held", "seen"):
        for metric in ("l1",):
            np.testing.assert_allclose(t.evals_result_[name][metric],
                                       j.evals_result_[name][metric],
                                       rtol=1e-9)
    np.testing.assert_allclose(t.best_score_["held"]["l1"],
                               j.best_score_["held"]["l1"], rtol=1e-9)
    np.testing.assert_allclose(t.predict(X), j.predict(X), rtol=1e-9)


def test_params_set_params_and_clone(data):
    base = pytest.importorskip("sklearn.base")
    t = lgt.LGBMRegressor(num_leaves=7, device_type="cpu", reg_lambda=0.5)
    j = lgb.LGBMRegressor(num_leaves=7, reg_lambda=0.5)
    tp, jp = t.get_params(), j.get_params()
    assert tp.pop("device_type") == "cpu"
    assert tp == jp
    assert t.set_params(n_estimators=3, min_child_samples=5) is t
    assert t.get_params()["n_estimators"] == 3
    c = base.clone(t)
    assert c is not t and c.get_params() == t.get_params()
    c.fit(data["X"], data["y"])
    assert c.n_estimators_ == 3
    with pytest.raises(LightGBMError, match="fit"):
        t.predict(data["X"])


def test_pickled_estimator_predicts_the_same(data):
    t = lgt.LGBMClassifier(**KW, device_type="cpu").fit(data["X"],
                                                        data["y3"])
    back = pickle.loads(pickle.dumps(t))
    np.testing.assert_array_equal(back.predict_proba(data["X"]),
                                  t.predict_proba(data["X"]))
    np.testing.assert_array_equal(back.classes_, t.classes_)


def test_sparse_and_categorical_input_refused(data):
    sparse = pytest.importorskip("scipy.sparse")
    t = lgt.LGBMRegressor(**KW, device_type="cpu")
    with pytest.raises(LightGBMError, match="A12.5"):
        t.fit(sparse.csr_matrix(np.nan_to_num(data["X"])), data["y"])
    with pytest.raises(LightGBMError, match="A12.5"):
        t.fit(data["X"], data["y"], categorical_feature=[1])


def test_estimators_fit_without_scikit_learn(data, tmp_path):
    """With ``sklearn`` unimportable the module imports, the stand-ins
    give ``get_params`` by the signature, and a classifier of string
    labels fits and predicts what it does with scikit-learn."""
    code = "\n".join([
        "import sys, numpy as np",
        "sys.modules['sklearn'] = None",
        "import lightgbm_tpu_torch as lgt",
        "from lightgbm_tpu_torch import sklearn as sk",
        "assert not sk._SKLEARN_INSTALLED",
        "X = np.load(sys.argv[1]); y = np.load(sys.argv[2])",
        "m = lgt.LGBMClassifier(n_estimators=3, num_leaves=7,",
        "                       min_child_samples=5, device_type='cpu',",
        "                       verbose=-1).fit(X, y)",
        "p = m.get_params()",
        "assert p['num_leaves'] == 7 and p['device_type'] == 'cpu', p",
        "assert 'n_estimators' in p and 'reg_alpha' in p",
        "np.save(sys.argv[3], m.predict_proba(X))",
        "np.save(sys.argv[4], m.predict(X))",
    ])
    paths = [str(tmp_path / f"{n}.npy") for n in ("X", "y", "proba", "pred")]
    y = np.where(data["yb"] > 0, "yes", "no")
    np.save(paths[0], data["X"])
    np.save(paths[1], y)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code, *paths], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    m = lgt.LGBMClassifier(n_estimators=3, num_leaves=7, min_child_samples=5,
                           device_type="cpu", verbose=-1).fit(data["X"], y)
    np.testing.assert_array_equal(np.load(paths[2]),
                                  m.predict_proba(data["X"]))
    np.testing.assert_array_equal(np.load(paths[3]), m.predict(data["X"]))
