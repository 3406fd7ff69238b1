"""Linear trees (``linear_tree``, ``linear_lambda``) in the PyTorch port
against the JAX package, on the CPU.

Each leaf of a tree after the first holds a ridge fit over the numerical
features on its path, on the host in f64 from the raw features a
``Dataset`` built with ``linear_tree`` keeps (ref: linear_tree_learner.cpp;
arXiv:1802.05640, Eq 3). The fit runs on identical inputs in both
packages, so the L2 model text, coefficients included, and the training
and validation scores are the JAX package's string for string and bit
for bit. Prediction is the host walk: both device routes refuse a linear
window, and ``Booster.predict`` says once that the host walk answers.
"""
import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops.forest import (LINEAR_TREES_ON_HOST,
                                           DeviceRouteUnavailable)
from lightgbm_tpu_torch.utils import log

PARAMS = {"objective": "regression", "num_leaves": 8, "verbosity": -1,
          "linear_tree": True, "linear_lambda": 0.1, "device_type": "cpu",
          "min_data_in_leaf": 20}


def _pw_linear(seed, n=2000, f=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[rng.uniform(size=n) < 0.03, 1] = np.nan
    y = np.where(X[:, 0] > 0, 2.0 * np.nan_to_num(X[:, 1]) + 1,
                 -1.5 * X[:, 2]) + rng.normal(scale=0.1, size=n)
    return X, y


def _no_params(model_str):
    return model_str[:model_str.index("\nparameters:")]


@pytest.fixture(scope="module")
def pair():
    """Both packages' linear models with a validation set, and the rows."""
    X, y = _pw_linear(0)
    Xv, yv = _pw_linear(1, n=500)
    out = []
    for pkg in (lgb, lgt):
        tr = pkg.Dataset(X, label=y, params=PARAMS)
        rec = {}
        bst = pkg.train({**PARAMS, "metric": "l2"}, tr, num_boost_round=4,
                        valid_sets=[pkg.Dataset(Xv, label=yv, reference=tr,
                                                params=PARAMS)],
                        valid_names=["v"],
                        callbacks=[pkg.record_evaluation(rec)])
        out.append((bst, rec))
    return X, Xv, out[0], out[1]


def test_linear_model_matches_jax(pair):
    X, Xv, (jb, jrec), (tb, trec) = pair
    s = tb.model_to_string()
    assert "is_linear=1" in s and "leaf_coeff=" in s
    assert _no_params(s) == _no_params(jb.model_to_string())
    np.testing.assert_array_equal(tb._engine.score.numpy(),
                                  np.asarray(jb._engine.score))
    np.testing.assert_array_equal(tb._engine.valid_sets[0].score.numpy(),
                                  np.asarray(jb._engine.valid_sets[0].score))
    assert trec == jrec
    np.testing.assert_array_equal(tb.predict(Xv), jb.predict(Xv))


def test_first_tree_is_constant_and_later_trees_fit(pair):
    _, _, _, (tb, _) = pair
    first, second = tb._engine.models[0], tb._engine.models[1]
    assert first.is_linear and not any(first.leaf_features)
    assert any(len(c) for c in second.leaf_coeff)


def test_linear_text_round_trips_across_packages(pair):
    X, _, (jb, _), (tb, _) = pair
    loaded = lgt.Booster(model_str=jb.model_to_string(),
                         params={"device_type": "cpu"})
    np.testing.assert_array_equal(loaded.predict(X), jb.predict(X))
    back = lgb.Booster(model_str=tb.model_to_string())
    np.testing.assert_array_equal(back.predict(X), tb.predict(X))
    assert _no_params(loaded.model_to_string()) == \
        _no_params(tb.model_to_string())


def test_nan_rows_take_the_leaf_constant(pair):
    X, _, _, (tb, _) = pair
    Xn = X[:50].copy()
    Xn[:, 2] = np.nan
    p = tb.predict(Xn)
    assert np.isfinite(p).all()
    t = tb._engine.models[1]
    leaf = t.predict_leaf(Xn)
    with_f2 = np.asarray([2 in t.leaf_features[l] for l in leaf])
    np.testing.assert_array_equal(
        t.linear_output(Xn, leaf)[with_f2], t.leaf_const[leaf][with_f2])


def test_device_routes_refuse_and_the_host_walk_answers_once(pair):
    """Both device routes raise DeviceRouteUnavailable for a linear
    window; predict(device=True) warns once and gives the host walk."""
    X, _, _, (tb, _) = pair
    with pytest.raises(DeviceRouteUnavailable, match="linear trees"):
        tb._engine.predict_device(X, 0, 4)
    loaded = lgt.Booster(model_str=tb.model_to_string(),
                         params={"device_type": "cpu"})
    with pytest.raises(DeviceRouteUnavailable, match="linear trees"):
        loaded._engine.predict_device(X, 0, 4)
    msgs = []
    log.register_logger(msgs.append)
    log.logged_once.clear()
    try:
        log.set_verbosity(0)
        p1 = tb.predict(X, device=True)
        p2 = tb.predict(X, device=True)
    finally:
        log.register_logger(None)
        log.set_verbosity(-1)
    hits = [m for m in msgs if LINEAR_TREES_ON_HOST in m]
    assert len(hits) == 1
    np.testing.assert_array_equal(p1, tb.predict(X))
    np.testing.assert_array_equal(p2, p1)


def test_cv_folds_keep_the_raw_features():
    X, y = _pw_linear(2, n=900)
    out = lgt.cv({**PARAMS, "metric": "l2"}, lgt.Dataset(X, label=y,
                                                         params=PARAMS),
                 num_boost_round=3, nfold=3)
    assert len(out["valid l2-mean"]) == 3


@pytest.mark.parametrize("case", ["l1", "plain_dataset", "plain_valid",
                                  "sparse", "sequence"])
def test_linear_refusals(case):
    X, y = _pw_linear(3, n=400)
    params = dict(PARAMS)
    if case == "l1":
        params["objective"] = "regression_l1"
        match = "Cannot use regression_l1 objective when fitting linear"
    elif case in ("plain_dataset", "plain_valid"):
        match = ("constructed with linear_tree=true" if case ==
                 "plain_dataset" else "constructed without raw features")
    elif case == "sparse":
        import scipy.sparse as sp
        X = sp.csr_matrix(np.where(np.abs(X) > 1, X, 0.0))
        match = "sparse inputs are not supported"
    else:
        from lightgbm_tpu_torch.io.sequence import Sequence

        class Rows(Sequence):
            batch_size = 64

            def __getitem__(self, i):
                return X[i]

            def __len__(self):
                return len(X)
        X = Rows()
        match = "Sequences are streamed"
    with pytest.raises(lgt.basic.LightGBMError, match=match):
        # a Dataset constructed before training keeps the params it was
        # built with
        tr = lgt.Dataset(X, label=y, params=None if case == "plain_dataset"
                         else params)
        if case == "plain_dataset":
            tr.construct()
        valid = None
        if case == "plain_valid":
            valid = [lgt.Dataset(_pw_linear(4, n=100)[0], reference=tr,
                                 label=np.zeros(100),
                                 params={"device_type": "cpu"}).construct()]
        lgt.train(params, tr, num_boost_round=2, valid_sets=valid)
