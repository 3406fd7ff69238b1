"""``cv``, ``CVBooster`` and the fold makers of the PyTorch port against
the JAX package: the same folds (stratified, shuffled, plain, whole
queries, a splitter's), the same result keys and per-round means and
standard deviations, early stopping, ``feval``, ``fpreproc``,
``eval_train_metric``, callbacks and the ``CVBooster`` text. Same inputs
(numpy, from a seed), both packages on the CPU; 900 rows, 5 features,
7 to 15 leaves, 3 folds.

Regression (L2) trains the JAX package's trees bit for bit in the port
(``tests/test_torch_train.py``), so its ``l2`` means and deviations are
held to rtol 1e-9. Binary and lambdarank go through ``exp`` (ROADMAP
C1(a)): their means within 1e-6, and every fold's trees to the binary
standard of ``tests/test_torch_multiclass.py``.
"""
import numpy as np
import pytest
from test_torch_multiclass import assert_trees_to_binary_standard

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.engine import _make_n_folds as jax_folds
from lightgbm_tpu_torch.engine import _make_n_folds as port_folds

N, F, NFOLD, ROUNDS, RATE = 900, 5, 3, 4, 0.1


def _params(objective, **extra):
    return {"objective": objective, "num_leaves": 15, "verbosity": -1,
            "min_data_in_leaf": 5, "learning_rate": RATE,
            "device_type": "cpu", **extra}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    X = rng.normal(size=(N, F))
    X[rng.uniform(size=N) < 0.05, 1] = np.nan
    y = X[:, 0] * 2 + np.sin(X[:, 1] * 3) + rng.normal(scale=0.5, size=N)
    y = np.nan_to_num(y)
    yb = (y > np.median(y)).astype(np.float64)
    sizes = np.full(45, 20)
    rel = np.searchsorted(np.quantile(y, [0.5, 0.75, 0.9, 0.97]),
                          y).astype(np.float64)
    return {"X": X, "y": y, "yb": yb, "sizes": sizes, "rel": rel}


@pytest.fixture(scope="module")
def regression_cv(data):
    """Both packages' cv of the same L2 task, with the training metric."""
    out = {}
    for pkg in (lgb, lgt):
        out[pkg] = pkg.cv(_params("regression", metric=["l2", "l1"]),
                          pkg.Dataset(data["X"], label=data["y"]),
                          num_boost_round=ROUNDS, nfold=NFOLD, seed=3,
                          eval_train_metric=True, return_cvbooster=True)
    return out


def _tree_blocks(bst):
    s = bst.model_to_string()
    return s[s.index("Tree=0"):s.index("end of trees")]


class _Splitter:
    """A splitter object (``split(X, y, groups)``) without scikit-learn:
    every third row of the query order a fold."""

    def split(self, X, y, groups):
        idx = np.argsort(groups, kind="stable")
        for f in range(NFOLD):
            test = np.sort(idx[f::NFOLD])
            yield np.setdiff1d(np.arange(len(X)), test), test


@pytest.mark.parametrize("kind", ["stratified", "shuffled", "plain",
                                  "group", "splitter", "given"])
def test_folds_equal_jax(data, kind):
    label = data["yb"] if kind == "stratified" else data["y"]
    group = data["sizes"] if kind in ("group", "splitter") else None
    folds = None
    if kind == "splitter":
        folds = _Splitter()
    elif kind == "given":
        folds = [(np.arange(300, N), np.arange(300)),
                 (np.arange(300), np.arange(300, N))]
    out = {}
    for pkg, make in ((lgb, jax_folds), (lgt, port_folds)):
        ds = pkg.Dataset(data["X"], label=label, group=group)
        args = (folds, NFOLD) + (({},) if pkg is lgb else ()) + \
            (5, kind == "stratified", kind != "plain")
        out[pkg] = list(make(ds, *args))
    assert len(out[lgt]) == len(out[lgb])
    for (ttr, tte), (jtr, jte) in zip(out[lgt], out[lgb]):
        np.testing.assert_array_equal(ttr, jtr)
        np.testing.assert_array_equal(tte, jte)
    if kind == "group":
        bounds = np.concatenate([[0], np.cumsum(data["sizes"])])
        for _, test in out[lgt]:
            assert np.isin(bounds[:-1], test).sum() * 20 == len(test)


def test_cv_regression_matches_jax(data, regression_cv):
    t, j = regression_cv[lgt], regression_cv[lgb]
    assert sorted(k for k in t if k != "cvbooster") == \
        sorted(k for k in j if k != "cvbooster")
    assert "training l2-mean" in t and "valid l1-stdv" in t
    for key in t:
        if key != "cvbooster":
            assert len(t[key]) == ROUNDS
            np.testing.assert_allclose(t[key], j[key], rtol=1e-9, atol=0,
                                       err_msg=key)
    assert np.all(np.diff(t["valid l2-mean"]) < 0)
    for tb, jb in zip(t["cvbooster"].boosters, j["cvbooster"].boosters):
        assert tb.num_trees() == ROUNDS
        assert_trees_to_binary_standard(jb, tb, data["X"], g_max=20.0,
                                        h_max=1.0, rate=RATE,
                                        converted=False)
        assert _tree_blocks(tb) == _tree_blocks(jb)    # L2: bit for bit


def test_cvbooster_text_round_trip(data, regression_cv, tmp_path):
    cvb = regression_cv[lgt]["cvbooster"]
    X = data["X"][:100]
    path = str(tmp_path / "cv.json")
    cvb.save_model(path)
    for loaded in (lgt.CVBooster(model_file=path),
                   lgt.CVBooster().model_from_string(cvb.model_to_string())):
        assert len(loaded.boosters) == NFOLD
        for a, b in zip(cvb.boosters, loaded.boosters):
            np.testing.assert_array_equal(a.predict(X), b.predict(X))
    # an attribute CVBooster lacks is called on each fold's Booster
    assert cvb.num_trees() == [ROUNDS] * NFOLD
    np.testing.assert_array_equal(cvb.predict(X)[1],
                                  cvb.boosters[1].predict(X))
    with pytest.raises(AttributeError):
        cvb.__missing_dunder__


def test_cv_binary_matches_jax(data):
    out = {pkg: pkg.cv(_params("binary", num_leaves=7), pkg.Dataset(
        data["X"], label=data["yb"]), num_boost_round=ROUNDS, nfold=NFOLD,
        seed=0, return_cvbooster=True) for pkg in (lgb, lgt)}
    t, j = out[lgt], out[lgb]
    assert t.keys() == j.keys()
    np.testing.assert_allclose(t["valid binary_logloss-mean"],
                               j["valid binary_logloss-mean"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(t["valid binary_logloss-stdv"],
                               j["valid binary_logloss-stdv"], rtol=0,
                               atol=1e-6)
    for tb, jb in zip(t["cvbooster"].boosters, j["cvbooster"].boosters):
        assert_trees_to_binary_standard(jb, tb, data["X"], g_max=1.0,
                                        h_max=0.25, rate=RATE)
    # fold 0's Booster evaluates its own held-out rows as the result did
    b = t["cvbooster"].boosters[0]
    last = [v for _, m, v, _ in b.eval(b.valid_sets[0], "valid")
            if m == "binary_logloss"]
    p = b.predict(data["X"][b.valid_sets[0].used_indices])
    yv = data["yb"][b.valid_sets[0].used_indices]
    host = -np.mean(yv * np.log(p) + (1 - yv) * np.log(1 - p))
    np.testing.assert_allclose(last, host, rtol=0, atol=1e-6)


def test_cv_early_stopping_feval_fpreproc_match_jax(data):
    """Early stopping from the params on a custom metric, ``fpreproc``
    rewriting each fold, and a recording callback, in both packages."""
    def feval(raw, ds):
        return "mae", float(np.mean(np.abs(raw - ds.get_label()))), False

    def fpreproc(tr, te, params):
        params["learning_rate"] = 0.3
        return tr, te, params

    out, rec = {}, {}
    for pkg in (lgb, lgt):
        rec[pkg] = {}
        out[pkg] = pkg.cv(
            _params("regression", num_leaves=7, early_stopping_round=2,
                    metric="l2", first_metric_only=False),
            pkg.Dataset(data["X"], label=data["y"]), num_boost_round=60,
            nfold=NFOLD, stratified=False, seed=1, feval=feval,
            fpreproc=fpreproc, return_cvbooster=True,
            callbacks=[pkg.record_evaluation(rec[pkg])])
    t, j = out[lgt], out[lgb]
    best = t["cvbooster"].best_iteration
    assert 1 < best < 60 and best == j["cvbooster"].best_iteration
    assert all(b.best_iteration == best for b in t["cvbooster"].boosters)
    for key in ("valid l2-mean", "valid mae-mean", "valid mae-stdv"):
        assert len(t[key]) == best
        np.testing.assert_allclose(t[key], j[key], rtol=1e-9, err_msg=key)
    assert rec[lgt].keys() == rec[lgb].keys() == {"cv_agg"}
    np.testing.assert_allclose(rec[lgt]["cv_agg"]["valid mae"],
                               rec[lgb]["cv_agg"]["valid mae"], rtol=1e-9)


def test_cv_group_folds_lambdarank_match_jax(data):
    # at least 20 rows a leaf: on 5-row tails a split of lambdarank's
    # tiny gains ties, and the exp ulp (C1(a)) picks another threshold
    p = _params("lambdarank", num_leaves=7, metric="ndcg", eval_at=[3],
                min_data_in_leaf=20)
    out = {pkg: pkg.cv(p, pkg.Dataset(data["X"], label=data["rel"],
                                      group=data["sizes"]),
                       num_boost_round=2, nfold=NFOLD, seed=2,
                       return_cvbooster=True) for pkg in (lgb, lgt)}
    np.testing.assert_allclose(out[lgt]["valid ndcg@3-mean"],
                               out[lgb]["valid ndcg@3-mean"], rtol=0,
                               atol=1e-6)
    for tb, jb in zip(out[lgt]["cvbooster"].boosters,
                      out[lgb]["cvbooster"].boosters):
        # every fold holds whole queries
        assert tb.train_set.get_group().sum() == tb.train_set.num_data()
        assert tb.valid_sets[0].get_group().sum() == \
            tb.valid_sets[0].num_data()
        jt, tt = (b._engine.models[0] for b in (jb, tb))
        assert int(tt.split_feature[0]) == int(jt.split_feature[0])


def test_cv_init_model_continues_each_fold(data):
    """Each fold Booster starts from the init model's trees, as
    ``train(init_model=)`` does on that fold (the JAX package's ``cv``
    ignores ``init_model``)."""
    p = _params("regression", num_leaves=7)
    full = lgt.Dataset(data["X"], label=data["y"])
    init = lgt.train(p, full, num_boost_round=2)
    res = lgt.cv(p, full, num_boost_round=2, nfold=NFOLD, seed=4,
                 init_model=init, return_cvbooster=True)
    folds = port_folds(full, None, NFOLD, 4, False, True)
    means = []
    for b, (tr, te) in zip(res["cvbooster"].boosters, folds):
        assert b.num_trees() == 4
        ref = lgt.train(p, full.subset(tr), num_boost_round=2,
                        init_model=init, valid_sets=[full.subset(te)],
                        valid_names=["valid"])
        assert ref.model_to_string() == b.model_to_string()
        means.append(ref.best_score["valid"]["l2"])
    np.testing.assert_allclose(res["valid l2-mean"][-1], np.mean(means),
                               rtol=1e-12)
