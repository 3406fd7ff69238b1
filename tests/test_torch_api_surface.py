"""The rest of ``Dataset`` and ``Booster`` in the PyTorch port against the
JAX package: subsets, fields, feature helpers, ``add_features_from``,
binary dataset files written by either package, ``refit``, leaf output
access, ``trees_to_dataframe``, split-value histograms, bounds,
``shuffle_models``, pickling and copies, the packed device forest after a
change of the trees, ``pred_contrib`` and prediction from a file or with
the shape check disabled. Same inputs (numpy, from a seed), both packages
on the CPU; 1,200 rows, 6 features, 15 leaves.

Regression (L2) trains the JAX package's trees bit for bit in the port on
the CPU (``tests/test_torch_train.py``), so its frames, histograms,
bounds and shuffled texts are held equal, its refitted leaf values
within 1e-9 (the refit sums per leaf in f64, the leaf output in f32, in
both packages). Binary trees go through ``exp`` (ROADMAP C1(a)) and
differ in the last ulps of their leaves, so the contributions of binary
and multiclass models are taken by the port over the JAX package's trees
(its model text loaded): within 1e-9 of max(1, |phi|) of the JAX
package's, every row's contributions summing to its raw score within
1e-9 of max(1, |score|).
"""
import contextlib
import copy
import gc
import importlib
import pickle
import weakref

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu import config as jax_config
from lightgbm_tpu_torch import config as port_config
from lightgbm_tpu_torch.utils.log import LightGBMError

N, F, ROUNDS = 1200, 6, 4
CPU = {"device_type": "cpu"}


def _params(objective, **extra):
    return {"objective": objective, "num_leaves": 15, "verbosity": -1,
            "min_data_in_leaf": 5, **CPU, **extra}


def _data(rng, n=N, f=F):
    X = rng.normal(size=(n, f))
    X[rng.uniform(size=n) < 0.05, 2] = np.nan
    y = X[:, 0] * 2 + np.sin(X[:, 1] * 3) - np.nan_to_num(X[:, 2]) \
        + rng.normal(scale=0.5, size=n)
    return X, y


def _tree_blocks(model_str):
    return model_str[model_str.index("Tree=0"):
                     model_str.index("end of trees")]


@contextlib.contextmanager
def _log_lines(pkg):
    """The lines ``pkg``'s logger emits inside the block, at warning
    level and above unless a Config sets another verbosity."""
    log = importlib.import_module(pkg.__name__ + ".utils.log")
    lines, level = [], log._level
    log.register_logger(lines.append)
    log.set_verbosity(log.WARNING)
    try:
        yield lines
    finally:
        log.register_logger(None)
        log.set_verbosity(level)


def _message(line):
    """A log line without the package's ``[name] [Level]`` prefix."""
    return line.split("] ", 2)[-1]


@pytest.fixture(scope="module")
def models():
    """The same L2 and binary models trained by both packages, and the
    data: built once for the module."""
    rng = np.random.default_rng(7)
    X, y = _data(rng)
    yb = (y > np.median(y)).astype(np.float64)
    out = {"X": X, "y": y, "yb": yb, "X_new": _data(rng)}
    for name, obj, label in (("l2", "regression", y),
                             ("binary", "binary", yb)):
        out[name] = tuple(
            pkg.train(_params(obj), pkg.Dataset(X, label=label),
                      num_boost_round=ROUNDS) for pkg in (lgb, lgt))
    jl, tl = out["l2"]
    assert _tree_blocks(jl.model_to_string()) == \
        _tree_blocks(tl.model_to_string())
    return out


# -- Dataset ---------------------------------------------------------------

@pytest.mark.parametrize("with_group", [False, True],
                         ids=["no_group", "group"])
def test_subset_equals_jax(with_group):
    rng = np.random.default_rng(1)
    X, y = _data(rng, n=400)
    w = rng.uniform(0.5, 2.0, size=400)
    init = rng.normal(size=400)
    group = np.full(20, 20) if with_group else None
    pos = np.tile(np.arange(20), 20) if with_group else None
    rows = rng.permutation(400)[:170]         # unsorted; subset sorts
    subs = {}
    for pkg in (lgb, lgt):
        full = pkg.Dataset(X, label=y, weight=w, init_score=init,
                           group=group, position=pos)
        subs[pkg] = full.subset(rows).construct()
        assert subs[pkg].num_data() == 170
    j, t = subs[lgb].binned, subs[lgt].binned
    np.testing.assert_array_equal(t.bins.T, j.bins)
    assert t.bin_mappers is subs[lgt].reference.binned.bin_mappers
    for field in ("label", "weight", "init_score", "query_boundaries",
                  "position"):
        a, b = getattr(t.metadata, field), getattr(j.metadata, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=field)
    # the subset's positions are dropped, as in the JAX package
    assert t.metadata.position is None
    if with_group:
        np.testing.assert_array_equal(subs[lgt].get_field("group"),
                                      subs[lgb].get_field("group"))


def test_fields_and_feature_helpers_equal_jax():
    rng = np.random.default_rng(2)
    X, y = _data(rng, n=300)
    names = [f"f{i}" for i in range(F)]
    sizes = np.asarray([100, 150, 50])
    dss = {pkg: pkg.Dataset(X, label=y, group=sizes, feature_name=names,
                            free_raw_data=False)
           for pkg in (lgb, lgt)}
    with pytest.raises(LightGBMError, match="before construct"):
        dss[lgt].get_field("group")
    w = rng.uniform(0.5, 1.5, size=300)
    init = rng.normal(size=300)
    for pkg, ds in dss.items():
        ds.construct()
        ds.set_field("weight", w)
        ds.set_init_score(init)
    t, j = dss[lgt], dss[lgb]
    for field in ("label", "weight", "init_score", "group"):
        np.testing.assert_array_equal(t.get_field(field), j.get_field(field))
    np.testing.assert_array_equal(t.get_field("group"), [0, 100, 250, 300])
    np.testing.assert_array_equal(t.get_group(), sizes)
    np.testing.assert_array_equal(t.get_label(), j.get_label())
    np.testing.assert_array_equal(t.get_weight(), j.get_weight())
    np.testing.assert_array_equal(t.get_init_score(), j.get_init_score())
    with pytest.raises(LightGBMError, match="Unknown field"):
        t.get_field("nope")
    t.set_field("label", None)
    assert t.get_field("label") is None
    assert t.get_feature_name() == j.get_feature_name() == names
    for f in (0, 3, "f5"):
        assert t.feature_num_bin(f) == j.feature_num_bin(f)
    t.set_feature_name([f"g{i}" for i in range(F)])
    assert t.get_feature_name()[0] == "g0"
    with pytest.raises(LightGBMError, match="Length of feature names"):
        t.set_feature_name(["a"])
    np.testing.assert_array_equal(t.get_data(), X)
    params = {"max_bin": 63}
    tr = lgt.Dataset(X, label=y, params=params)
    va = lgt.Dataset(X[:50], label=y[:50]).set_reference(tr)
    assert va.get_ref_chain() == {va, tr}
    assert tr.get_params() == params and tr.get_params() is not tr.params


def test_add_features_from_equals_jax():
    rng = np.random.default_rng(3)
    X, y = _data(rng, n=500)
    X2 = rng.normal(size=(500, 3))
    merged = {}
    for pkg in (lgb, lgt):
        a = pkg.Dataset(X, label=y, free_raw_data=False).construct()
        a.add_features_from(pkg.Dataset(X2, free_raw_data=False).construct())
        merged[pkg] = a
    t, j = merged[lgt], merged[lgb]
    assert t.num_feature() == j.num_feature() == F + 3
    np.testing.assert_array_equal(t.binned.bins.T, j.binned.bins)
    np.testing.assert_array_equal(t.binned.used_feature_map,
                                  j.binned.used_feature_map)
    assert t.get_feature_name() == j.get_feature_name()
    np.testing.assert_array_equal(t.get_data(), np.hstack([X, X2]))
    bst = {pkg: pkg.train(_params("regression"), merged[pkg],
                          num_boost_round=2) for pkg in (lgb, lgt)}
    assert _tree_blocks(bst[lgt].model_to_string()) == \
        _tree_blocks(bst[lgb].model_to_string())
    with pytest.raises(LightGBMError, match="rows"):
        t.add_features_from(lgt.Dataset(X2[:10]))


@pytest.mark.parametrize("free", [True, False])
def test_free_raw_data_matches_jax(free):
    """``free_raw_data``: ``construct`` drops the raw matrix (the default)
    or keeps it in both packages; a subset carries the flag and trains the
    same trees; ``set_categorical_feature`` after a freed construct raises
    in both, after a kept one bins again at the next construct."""
    rng = np.random.default_rng(5)
    X, y = _data(rng, n=400)
    trees = {}
    for pkg in (lgb, lgt):
        ds = pkg.Dataset(X, label=y, free_raw_data=free)
        assert ds.free_raw_data is free and ds.get_data() is X
        ds.construct()
        if free:
            assert ds.get_data() is None
        else:
            np.testing.assert_array_equal(ds.get_data(), X)
        sub = ds.subset(np.arange(0, 400, 2))
        assert sub.free_raw_data is free
        trees[pkg] = _tree_blocks(pkg.train(
            _params("regression"), sub, num_boost_round=2).model_to_string())
        if free:
            with pytest.raises(Exception, match="free_raw_data=False") as e:
                ds.set_categorical_feature([1])
            assert type(e.value).__name__ == "LightGBMError"
        else:
            ds.set_categorical_feature([1])
            assert ds._binned is None and ds.get_data() is X
    assert trees[lgt] == trees[lgb]


def test_cv_of_a_freed_constructed_dataset_matches_jax():
    """The folds of ``cv`` are subsets of the binned rows: a Dataset
    constructed, and so freed, under the default trains them in both
    packages, to the same L2 scores."""
    rng = np.random.default_rng(6)
    X, y = _data(rng, n=300)
    res = {}
    for pkg in (lgb, lgt):
        ds = pkg.Dataset(X, label=y).construct()
        assert ds.get_data() is None
        res[pkg] = pkg.cv(_params("regression", metric="l2"), ds, nfold=3,
                          num_boost_round=2, stratified=False, seed=1)
    assert res[lgt].keys() == res[lgb].keys()
    for key in res[lgb]:
        np.testing.assert_allclose(res[lgt][key], res[lgb][key], rtol=1e-9)


def test_add_features_from_a_freed_dataset_warns_and_drops():
    """``add_features_from`` keeps the raw data only when both sides hold
    it: with the other side freed both packages warn and drop it."""
    rng = np.random.default_rng(8)
    X, y = _data(rng, n=200)
    X2 = rng.normal(size=(200, 2))
    said = {}
    for pkg in (lgb, lgt):
        a = pkg.Dataset(X, label=y, free_raw_data=False).construct()
        b = pkg.Dataset(X2).construct()
        with _log_lines(pkg) as lines:
            a.add_features_from(b)
        assert a.get_data() is None and a.num_feature() == F + 2
        said[pkg] = [_message(line) for line in lines]
    assert said[lgt] == said[lgb]
    assert len(said[lgt]) == 1 and "free_raw_data=True" in said[lgt][0]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_binary_crosses_packages(writer, tmp_path):
    """A file written by either package loads in the other, with the same
    bins, mappers and metadata, and trains the same trees."""
    rng = np.random.default_rng(4)
    X, y = _data(rng, n=600)
    w = rng.uniform(0.5, 1.5, size=600)
    group = np.full(30, 20)
    path = str(tmp_path / "train.bin")
    src, dst = (lgt, lgb) if writer == "port" else (lgb, lgt)
    orig = src.Dataset(X, label=y, weight=w, group=group)
    orig.save_binary(path)
    loaded = {dst: dst.Dataset(path).construct(),
              src: src.Dataset(path).construct()}
    t, j = loaded[lgt].binned, loaded[lgb].binned
    np.testing.assert_array_equal(t.bins.T, j.bins)
    np.testing.assert_array_equal(t.bins, lgt.Dataset(X).binned.bins)
    for field in ("label", "weight", "query_boundaries"):
        np.testing.assert_array_equal(getattr(t.metadata, field),
                                      getattr(j.metadata, field))
    assert t.feature_infos() == j.feature_infos()
    trees = {pkg: _tree_blocks(pkg.train(
        _params("regression"), loaded[pkg],
        num_boost_round=3).model_to_string()) for pkg in (lgb, lgt)}
    assert trees[lgt] == trees[lgb]
    direct = lgt.train(_params("regression"),
                       lgt.Dataset(X, label=y, weight=w), num_boost_round=3)
    assert _tree_blocks(direct.model_to_string()) == trees[lgt]


# -- Booster ---------------------------------------------------------------

def test_refit_matches_jax(models):
    jl, tl = models["l2"]
    Xn, yn = models["X_new"]
    for kw in ({"decay_rate": 0.9}, {"decay_rate": 0.5, "lambda_l2": 2.0}):
        jr, tr = jl.refit(Xn, yn, **kw), tl.refit(Xn, yn, **kw)
        assert tr is not tl and tr.num_trees() == tl.num_trees()
        for a, b, old in zip(tr._engine.models, jr._engine.models,
                             tl._engine.models):
            assert a.num_leaves == old.num_leaves
            np.testing.assert_array_equal(a.split_feature, old.split_feature)
            np.testing.assert_array_equal(a.threshold_real,
                                          old.threshold_real)
            np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=0,
                                       atol=1e-9)
            assert not np.array_equal(a.leaf_value, old.leaf_value)
        np.testing.assert_allclose(tr.predict(Xn), jr.predict(Xn), rtol=0,
                                   atol=1e-9)
    # the refitted model fits the new rows better than the old one
    mse = lambda b: float(np.mean((b.predict(Xn) - yn) ** 2))
    assert mse(tl.refit(Xn, yn, decay_rate=0.0)) < mse(tl)


def test_leaf_output_bounds_and_names_equal_jax(models):
    jl, tl = models["l2"]
    assert tl.lower_bound() == jl.lower_bound()
    assert tl.upper_bound() == jl.upper_bound()
    assert tl.feature_name() == jl.feature_name()
    assert tl.num_feature() == jl.num_feature() == F
    assert tl.num_class_ == jl.num_class_ == 1
    for tree, leaf in ((0, 0), (1, 5), (ROUNDS - 1, 14)):
        assert tl.get_leaf_output(tree, leaf) == \
            jl.get_leaf_output(tree, leaf)
    c = copy.deepcopy(tl)
    before = c.predict(models["X"])
    c.set_leaf_output(0, 3, c.get_leaf_output(0, 3) + 1.0)
    rows = tl._engine.models[0].predict_leaf(models["X"]) == 3
    np.testing.assert_allclose((c.predict(models["X"]) - before)[rows], 1.0)
    np.testing.assert_array_equal(c.predict(models["X"])[~rows],
                                  before[~rows])
    assert c.set_train_data_name("tr") is c and c.train_data_name == "tr"


def test_trees_to_dataframe_equals_jax(models):
    pd = pytest.importorskip("pandas")
    jl, tl = models["l2"]
    tf, jf = tl.trees_to_dataframe(), jl.trees_to_dataframe()
    pd.testing.assert_frame_equal(tf, jf)
    roots = tf[tf["node_depth"] == 1]
    assert (roots["count"] == N).all() and len(roots) == ROUNDS


def test_split_value_histogram_equals_jax(models):
    jl, tl = models["l2"]
    for feature in (0, 1, "Column_2"):
        for bins in (None, 4):
            th, te = tl.get_split_value_histogram(feature, bins=bins)
            jh, je = jl.get_split_value_histogram(feature, bins=bins)
            np.testing.assert_array_equal(th, jh)
            np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(
            tl.get_split_value_histogram(feature, xgboost_style=True),
            jl.get_split_value_histogram(feature, xgboost_style=True))


def test_shuffle_models_equals_jax_under_the_same_seed(models):
    jl, tl = models["l2"]
    jc, tc = copy.deepcopy(jl), copy.deepcopy(tl)
    for pkg_bst in (jc, tc):
        np.random.seed(11)
        pkg_bst.shuffle_models(start_iteration=1)
    assert _tree_blocks(tc.model_to_string()) == \
        _tree_blocks(jc.model_to_string())
    assert _tree_blocks(tc.model_to_string()) != \
        _tree_blocks(tl.model_to_string())
    np.testing.assert_allclose(tc.predict(models["X"]),
                               tl.predict(models["X"]), rtol=0, atol=1e-12)


@pytest.mark.parametrize("how", ["pickle", "copy", "deepcopy"])
def test_pickle_and_copies_are_independent(models, how):
    tl = models["binary"][1]
    tl.best_iteration = 3
    other = {"pickle": lambda b: pickle.loads(pickle.dumps(b)),
             "copy": copy.copy, "deepcopy": copy.deepcopy}[how](tl)
    X = models["X"]
    assert other is not tl and other._engine is not tl._engine
    assert other.num_trees() == tl.num_trees()
    assert other.best_iteration == 3 and other.params == tl.params
    np.testing.assert_array_equal(other.predict(X), tl.predict(X))
    assert other.model_to_string() == tl.model_to_string()
    # the copy predicts on the device its params name (here the CPU)
    X32 = X.astype(np.float32).astype(np.float64)
    np.testing.assert_array_equal(other.predict(X32, device=True),
                                  tl.predict(X32, device=True))
    v = tl.get_leaf_output(0, 0)
    other.set_leaf_output(0, 0, v + 1.0)
    assert tl.get_leaf_output(0, 0) == v
    tl.best_iteration = -1


def test_dropped_copies_free_their_engines_without_the_cyclic_collector(
        models):
    """A pickled or deep-copied Booster that served on the device frees its
    engine and packed forest as soon as it is dropped (on the card, its
    device tensors), not when the cyclic collector next runs."""
    X = models["X"].astype(np.float32).astype(np.float64)
    tl = models["l2"][1]
    for make in (lambda b: pickle.loads(pickle.dumps(b)), copy.deepcopy):
        c = make(tl)
        c.predict(X, device=True)
        assert c._engine._serving is not None
        refs = (weakref.ref(c._engine), weakref.ref(c._engine._serving))
        gc.disable()
        try:
            del c
            assert all(r() is None for r in refs)
        finally:
            gc.enable()


def test_device_forest_repacks_after_the_trees_change(models):
    """``predict(device=True)`` after ``set_leaf_output``,
    ``shuffle_models`` or on a ``refit`` model equals the host walk, on
    the binned route (a trained Booster) and the raw route (a loaded
    one)."""
    X = models["X"].astype(np.float32).astype(np.float64)
    Xn, yn = models["X_new"]
    trained = lgt.train(_params("regression"),
                        lgt.Dataset(models["X"], label=models["y"]),
                        num_boost_round=ROUNDS)
    loaded = lgt.Booster(CPU, model_str=trained.model_to_string())
    for bst in (trained, loaded):
        before = bst.predict(X, device=True)
        np.testing.assert_allclose(before, bst.predict(X), rtol=0,
                                   atol=1e-5)
        bst.set_leaf_output(1, 2, bst.get_leaf_output(1, 2) + 5.0)
        after = bst.predict(X, device=True)
        np.testing.assert_allclose(after, bst.predict(X), rtol=0, atol=1e-5)
        assert np.abs(after - before).max() > 1.0
        np.random.seed(5)
        bst.shuffle_models()
        np.testing.assert_allclose(bst.predict(X, device=True),
                                   bst.predict(X), rtol=0, atol=1e-5)
        refit = bst.refit(Xn, yn)
        np.testing.assert_allclose(refit.predict(X, device=True),
                                   refit.predict(X), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["l2", "binary"])
def test_pred_contrib_matches_jax(models, name):
    jb = models[name][0]
    # the JAX package's trees, loaded into the port: the binary trees the
    # two train differ in the last ulps of their leaves (C1(a))
    tb = lgt.Booster(CPU, model_str=jb.model_to_string())
    X = models["X"][:300]
    t = tb.predict(X, pred_contrib=True)
    j = jb.predict(X, pred_contrib=True)
    assert t.shape == j.shape == (300, F + 1)
    np.testing.assert_array_less(np.abs(t - j),
                                 1e-9 * np.maximum(1.0, np.abs(j)))
    raw = tb.predict(X, raw_score=True)
    np.testing.assert_array_less(np.abs(t.sum(axis=1) - raw),
                                 1e-9 * np.maximum(1.0, np.abs(raw)))
    part = tb.predict(X, pred_contrib=True, start_iteration=1,
                      num_iteration=2)
    np.testing.assert_allclose(
        part, jb.predict(X, pred_contrib=True, start_iteration=1,
                         num_iteration=2), rtol=0, atol=1e-9)
    # on the device (the loaded model's raw route, which needs f32
    # values): the JAX package's device explanation within its tolerance
    X32 = X.astype(np.float32).astype(np.float64)
    dev = tb.predict(X32, pred_contrib=True, device=True)
    assert tb._engine._serving.raw_shap_pack is not None
    np.testing.assert_allclose(
        dev, jb.predict(X32, pred_contrib=True, device=True),
        rtol=1e-4, atol=1e-5)


def test_pred_contrib_multiclass_matches_jax():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(600, 4))
    y = np.argmax(np.stack([X[:, 0], X[:, 1], -X[:, 0] - X[:, 1]])
                  + rng.normal(size=(3, 600)), axis=0).astype(np.float64)
    p = _params("multiclass", num_class=3, num_leaves=7)
    jb = lgb.train(p, lgb.Dataset(X, label=y), num_boost_round=2)
    tb = lgt.Booster(CPU, model_str=jb.model_to_string())
    out = {pkg: b.predict(X[:100], pred_contrib=True)
           for pkg, b in ((lgb, jb), (lgt, tb))}
    raw = tb.predict(X[:100], raw_score=True)
    np.testing.assert_allclose(out[lgt].reshape(100, 3, 5).sum(axis=2), raw,
                               rtol=0, atol=1e-9)
    assert out[lgt].shape == (100, 3 * 5)
    np.testing.assert_array_less(np.abs(out[lgt] - out[lgb]),
                                 1e-9 * np.maximum(1.0, np.abs(out[lgb])))


@pytest.mark.parametrize("fmt", ["csv", "libsvm"])
def test_predict_from_file_equals_array(models, fmt, tmp_path):
    jl, tl = models["l2"]
    X = np.nan_to_num(models["X"][:200])
    X[:, -1] = 0.0            # LibSVM leaves out the trailing zero feature
    path = str(tmp_path / f"pred.{fmt}")
    with open(path, "w") as f:
        for label, row in zip(models["y"][:200], X):
            if fmt == "csv":
                f.write(",".join(repr(float(v)) for v in [label, *row]))
            else:
                f.write(" ".join([repr(float(label))] +
                                 [f"{i}:{float(v)!r}" for i, v in enumerate(row)
                                  if v != 0.0]))
            f.write("\n")
    expect = tl.predict(X)
    np.testing.assert_array_equal(tl.predict(path), expect)
    np.testing.assert_array_equal(tl.predict(path), jl.predict(path))


def test_set_network_and_free_network_match_jax(models):
    """No socket network: ``set_network`` logs where a world is joined
    instead and returns the booster, a no-op for one machine;
    ``free_network`` returns the booster. The lines are the JAX
    package's, with the port's distributed module named."""
    said = {}
    for pkg, bst in zip((lgb, lgt), models["l2"]):
        with _log_lines(pkg) as lines:
            assert bst.set_network("127.0.0.1:12400,127.0.0.1:12401",
                                   num_machines=2) is bst
            assert bst.set_network("127.0.0.1:12400") is bst
            assert bst.free_network() is bst
        said[pkg] = [_message(line) for line in lines]
    assert len(said[lgt]) == len(said[lgb]) == 2
    assert said[lgt][1] == said[lgb][1]
    assert "lightgbm_tpu_torch.distributed.init_distributed(" in said[lgt][0]
    assert "num_processes=2" in said[lgt][0] and \
        "num_processes=2" in said[lgb][0]


@pytest.mark.parametrize("importance_type", ["split", "gain"])
def test_dump_model_importance_type_equals_jax(models, importance_type):
    """``dump_model(importance_type=)`` is the JAX package's dict: the L2
    model's as trained (bit for bit), the binary model's as both packages
    load the JAX package's text; the keyword changes nothing."""
    text = models["binary"][0].model_to_string()
    for jb, tb in (models["l2"], (lgb.Booster(model_str=text),
                                  lgt.Booster(params=CPU, model_str=text))):
        got = tb.dump_model(importance_type=importance_type)
        assert got == jb.dump_model(importance_type=importance_type)
        assert got == tb.dump_model()


# the JAX package's redirected parameters, each set to a value that
# trains the same trees: a machine list, ports, threads, cards, layouts
REDIRECTED = {"machines": "127.0.0.1:12400,127.0.0.1:12401",
              "machine_list_filename": "mlist.txt", "num_machines": 2,
              "local_listen_port": 12401, "time_out": 30,
              "gpu_platform_id": 0, "gpu_device_id": 0,
              "gpu_use_dp": True, "num_gpu": 1, "num_threads": 2,
              "force_col_wise": True, "force_row_wise": False,
              "is_enable_sparse": False, "precise_float_parser": True,
              "parser_config_file": "parser.json"}


def test_redirected_parameters_warn_as_in_jax(models):
    """Each redirected parameter set explicitly is warned once an engine,
    the same names by both packages, read from each package's logger;
    the trees are those trained without them."""
    assert set(port_config._REDIRECTED_PARAMS) == \
        set(jax_config._REDIRECTED_PARAMS) == set(REDIRECTED)
    X, y = models["X"], models["y"]
    warned = {}
    for pkg, plain in zip((lgb, lgt), models["l2"]):
        with _log_lines(pkg) as lines:
            bst = pkg.train(_params("regression", verbosity=0, **REDIRECTED),
                            pkg.Dataset(X, label=y), num_boost_round=ROUNDS)
        warned[pkg] = sorted(_message(line).split(" has no effect here")[0]
                             for line in lines
                             if " has no effect here: " in line)
        assert _tree_blocks(bst.model_to_string()) == \
            _tree_blocks(plain.model_to_string())
    assert warned[lgt] == warned[lgb] == sorted(REDIRECTED)


def test_predict_disable_shape_check_equals_jax(models):
    jl, tl = models["l2"]
    X = models["X"][:100, :F - 2]
    with pytest.raises(LightGBMError, match="predict_disable_shape_check"):
        tl.predict(X)
    padded = np.hstack([X, np.zeros((100, 2))])
    out = tl.predict(X, predict_disable_shape_check=True)
    np.testing.assert_array_equal(out, tl.predict(padded))
    np.testing.assert_array_equal(
        out, jl.predict(X, predict_disable_shape_check=True))
    wide = np.hstack([models["X"][:100], np.ones((100, 3))])
    np.testing.assert_array_equal(
        tl.predict(wide, predict_disable_shape_check=True),
        tl.predict(models["X"][:100]))


def test_validate_features_checks_frame_names(models):
    pd = pytest.importorskip("pandas")
    tl = models["l2"][1]
    X = models["X"][:20]
    good = pd.DataFrame(X, columns=tl.feature_name())
    np.testing.assert_array_equal(
        tl.predict(good, validate_features=True), tl.predict(X))
    bad = pd.DataFrame(X, columns=[f"x{i}" for i in range(F)])
    with pytest.raises(LightGBMError, match="feature names"):
        tl.predict(bad, validate_features=True)
    np.testing.assert_array_equal(tl.predict(bad), tl.predict(X))
