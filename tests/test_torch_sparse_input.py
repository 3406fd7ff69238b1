"""scipy sparse input in the PyTorch port against the JAX package.

The storage a sparse source gets (``tpu_sparse_storage``: ``auto``
packs one-hot data straight into EFB groups, stores wide data whose
features conflict as multi-value pairs, and keeps dense, narrow or
validation data as the logical bins; ``multival`` and ``dense`` force
it) is the JAX package's, and so are its arrays; ``ensure_logical_bins``
decodes either back to the dense matrix's bins; ``subset`` and ``cv``
run over grouped data; ``predict`` of a CSR matrix in row blocks gives
the dense matrix's values on the host walk and on the device route, and
``pred_contrib`` of CSR input is CSR; ``add_features_from`` of two CSR
datasets stacks their matrices and bins; the estimators fit and predict
CSR input as the JAX package's do. Regression (L2): values bit for bit.
"""
import numpy as np
import pytest
import scipy.sparse as sp
from test_torch_efb import BASE, onehot_csr
from test_torch_model_io import _no_params

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops.hist_multival import densify

PARAMS = {"objective": "regression", **BASE}
ROUNDS = 3


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(12)
    X, y, _ = onehot_csr(rng, n=1500, groups=12, with_cat=False)
    # wide rows of four entries at random: the features conflict
    n, F, K = 1500, 64, 4
    rows = np.repeat(np.arange(n), K)
    cols = np.argsort(rng.uniform(size=(n, F)), axis=1)[:, :K].reshape(-1)
    Xw = sp.csr_matrix((rng.uniform(1, 5, size=K * n), (rows, cols)),
                       shape=(n, F))
    yw = np.asarray(Xw[:, 3].todense()).ravel() - Xw[:, 40].toarray().ravel()
    return {"X": X, "y": y, "Xw": Xw, "yw": yw + rng.normal(size=n)}


def _binned(pkg, X, y, **params):
    ds = pkg.Dataset(X, label=y, params={"verbosity": -1, **params})
    return ds.binned if pkg is lgt else ds.construct()._binned


def _storage(b):
    return ("grouped" if b.bins_grouped is not None else
            "multival" if b.bins_mv is not None else "dense")


@pytest.mark.parametrize("case,want", [
    ("onehot", "grouped"), ("wide_conflicting", "multival"),
    ("dense_rows", "dense"), ("narrow", "dense"),
    ("onehot_forced_multival", "multival"), ("onehot_forced_dense", "dense"),
    ("onehot_no_bundle", "dense")])
def test_auto_storage_choice_matches_jax(data, case, want):
    X, y, params = data["X"], data["y"], {}
    if case == "wide_conflicting":
        X, y = data["Xw"], data["yw"]
    elif case == "dense_rows":
        X = sp.csr_matrix(np.random.default_rng(0).normal(size=(500, 40)))
        y = y[:500]
    elif case == "narrow":
        X = X[:, :20]
    elif case.startswith("onehot_forced"):
        params["tpu_sparse_storage"] = case.rsplit("_", 1)[1]
    elif case == "onehot_no_bundle":
        params["enable_bundle"] = False
    t, j = _binned(lgt, X, y, **params), _binned(lgb, X, y, **params)
    assert _storage(t) == _storage(j) == want
    if want == "grouped":
        np.testing.assert_array_equal(t.bins_grouped, j.bins_grouped.T)
    elif want == "multival":
        for a, b in zip(t.bins_mv, j.bins_mv):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(t.bins, j.bins.T)


@pytest.mark.parametrize("case", ["onehot", "wide_conflicting"])
def test_ensure_logical_bins(data, case):
    X, y = ((data["X"], data["y"]) if case == "onehot"
            else (data["Xw"], data["yw"]))
    t = _binned(lgt, X, y)
    j = _binned(lgb, X, y)
    dense = _binned(lgt, X.toarray(), y)
    assert t.bins is None
    got = t.ensure_logical_bins()
    np.testing.assert_array_equal(got, dense.bins)
    if case == "onehot":
        want = j.ensure_logical_bins()
    else:
        # the JAX package decodes multi-value pairs in its engine
        dflt = [m.default_bin for m in j.used_bin_mappers()]
        want = densify(*j.bins_mv, np.asarray(dflt))
    np.testing.assert_array_equal(got, want.T)


def test_subset_and_cv_of_grouped_data(data):
    ds = lgt.Dataset(data["X"], label=data["y"]).construct()
    rows = np.arange(0, 1500, 3)
    sub = ds.subset(rows).construct().binned
    assert sub.bins is None and sub.efb_info is ds.binned.efb_info
    np.testing.assert_array_equal(sub.bins_grouped,
                                  ds.binned.bins_grouped[rows])
    res = {}
    for pkg in (lgb, lgt):
        p = PARAMS if pkg is lgt else {k: v for k, v in PARAMS.items()
                                       if k != "device_type"}
        res[pkg] = pkg.cv(p, pkg.Dataset(data["X"], label=data["y"]),
                          num_boost_round=ROUNDS, nfold=3)
    np.testing.assert_allclose(res[lgt]["valid l2-mean"],
                               res[lgb]["valid l2-mean"], rtol=1e-6)


@pytest.fixture(scope="module")
def booster(data):
    return lgt.train(PARAMS, lgt.Dataset(data["X"], label=data["y"]),
                     num_boost_round=ROUNDS)


@pytest.mark.parametrize("device", [False, True])
def test_row_blocked_predict_equals_dense(data, booster, device):
    X = data["X"]
    want = booster.predict(X.toarray(), device=device)
    got = booster.predict(X, device=device, predict_sparse_block_rows=400)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(booster.predict(X.tocsc(), device=device),
                                  want)
    leaves = booster.predict(X, pred_leaf=True, predict_sparse_block_rows=400)
    np.testing.assert_array_equal(leaves, booster.predict(X.toarray(),
                                                          pred_leaf=True))


def test_pred_contrib_of_csr_is_csr(data, booster):
    X = data["X"][:300]
    got = booster.predict(X, pred_contrib=True, predict_sparse_block_rows=128)
    assert sp.issparse(got) and got.format == "csr"
    want = booster.predict(X.toarray(), pred_contrib=True)
    np.testing.assert_array_equal(got.toarray(), want)


def test_add_features_from_sparse(data):
    X, y = data["X"], data["y"]
    res = {}
    for pkg in (lgt, lgb):
        a = pkg.Dataset(X[:, :48], label=y, free_raw_data=False)
        b = pkg.Dataset(X[:, 48:], free_raw_data=False)
        a.construct()
        b.construct()
        a.add_features_from(b)
        res[pkg] = a
    t, j = res[lgt], res[lgb]
    assert sp.issparse(t.data) and t.data.shape == X.shape
    np.testing.assert_array_equal(t.data.toarray(), X.toarray())
    np.testing.assert_array_equal(t.binned.bins, j._binned.bins.T)
    assert t.binned.bins_grouped is None
    whole = _binned(lgt, X.toarray(), y)
    np.testing.assert_array_equal(t.binned.bins, whole.bins)


@pytest.mark.parametrize("est", ["LGBMRegressor", "LGBMClassifier"])
def test_estimators_on_csr(data, est):
    X = data["X"]
    y = data["y"] if est == "LGBMRegressor" else \
        (data["y"] > np.median(data["y"])).astype(int)
    kw = dict(n_estimators=ROUNDS, num_leaves=15, min_child_samples=5,
              verbose=-1)
    t = getattr(lgt, est)(**kw, device_type="cpu").fit(X, y)
    j = getattr(lgb, est)(**kw).fit(X, y)
    assert t.booster_._engine._bundle is not None
    if est == "LGBMRegressor":
        np.testing.assert_array_equal(t.predict(X), j.predict(X))
    else:
        np.testing.assert_allclose(t.predict_proba(X), j.predict_proba(X),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(t.predict(X), j.predict(X))


def test_traversal_paths_decode_grouped_bins(data):
    """DART's drops and ``rollback_one_iter`` walk the training rows by
    their logical bins, decoded once from the groups: DART gives the JAX
    package's model text, and a rollback the score of one round less."""
    X, y = data["X"], data["y"]
    dart = {**PARAMS, "boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0}
    t = lgt.train(dart, lgt.Dataset(X, label=y), num_boost_round=ROUNDS)
    j = lgb.train({k: v for k, v in dart.items() if k != "device_type"},
                  lgb.Dataset(X, label=y), num_boost_round=ROUNDS)
    assert t._engine._bundle is not None
    assert _no_params(t.model_to_string()) == _no_params(j.model_to_string())
    ds = lgt.Dataset(X, label=y)
    bst = lgt.train(PARAMS, ds, num_boost_round=ROUNDS,
                    keep_training_booster=True)
    two = lgt.train(PARAMS, lgt.Dataset(X, label=y), num_boost_round=2)
    bst.rollback_one_iter()
    np.testing.assert_allclose(bst._engine.score.numpy(),
                               two._engine.score.numpy(), rtol=0, atol=1e-6)
    assert ds.binned.bins is not None and ds.binned.bins_grouped is not None
