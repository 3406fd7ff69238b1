"""Column input in the PyTorch port against the JAX package: pandas
DataFrames (their column names the feature names, categorical features
by name), Arrow tables and ``__arrow_c_stream__`` producers (through
``io/dataset_core.ArrowColumns``), ``Dataset.set_categorical_feature``,
``trees_to_dataframe`` of categorical nodes, the estimators'
``categorical_feature`` and ``cv`` over categorical data; scipy sparse
input, refused until ROADMAP A12.5b, now trains and predicts as its
dense matrix does (``tests/test_torch_sparse_input.py`` holds the rest
of it); training and prediction on numpy
input import neither pandas nor pyarrow (the card's machine has
neither).

600 rows, two categorical features (12 and 6 categories) and two
numerical ones, 7 leaves, 3 rounds: each model's text is the JAX
package's string for string (L2 has no transcendental function).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.utils.log import LightGBMError

pd = pytest.importorskip("pandas")
pa = pytest.importorskip("pyarrow")

NAMES = ["month", "dist", "carrier", "dep_time"]
PARAMS = {"objective": "regression", "num_leaves": 7, "verbosity": -1,
          "device_type": "cpu", "min_data_in_leaf": 5,
          "min_data_per_group": 10, "cat_smooth": 2.0}
ROUNDS = 3


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    n = 600
    month = rng.integers(1, 13, size=n)
    carrier = rng.integers(0, 6, size=n)
    X = np.column_stack([month, rng.uniform(30, 4900, size=n), carrier,
                         rng.integers(0, 2400, size=n)]).astype(np.float64)
    eff = rng.normal(size=13), rng.normal(size=6)
    y = eff[0][month] + eff[1][carrier] + X[:, 1] / 5000 + \
        0.2 * rng.normal(size=n)
    return dict(X=X, y=y, df=pd.DataFrame(X, columns=NAMES))


def _both(make, y, categorical_feature, params=PARAMS):
    out = []
    for pkg in (lgb, lgt):
        ds = pkg.Dataset(make(), label=y,
                         categorical_feature=categorical_feature)
        out.append(pkg.train(params, ds, num_boost_round=ROUNDS))
    return out


def test_frame_names_and_categorical_by_name_match_jax(data):
    jb, tb = _both(lambda: data["df"], data["y"], ["month", "carrier"])
    text = tb.model_to_string()
    assert text == jb.model_to_string()
    assert "feature_names=month dist carrier dep_time" in text
    assert "cat_threshold=" in text
    assert tb.feature_name() == NAMES
    np.testing.assert_array_equal(tb.predict(data["df"]),
                                  jb.predict(data["df"]))
    # names, the params' index string and indices bin alike
    by_index = lgt.train(PARAMS, lgt.Dataset(data["df"], label=data["y"],
                                             categorical_feature=[0, 2]),
                         num_boost_round=ROUNDS)
    by_param = lgt.train({**PARAMS, "categorical_feature": "0,2"},
                         lgt.Dataset(data["df"], label=data["y"]),
                         num_boost_round=ROUNDS)
    assert by_index.model_to_string() == text
    assert by_param.model_to_string().split("parameters:")[0] == \
        text.split("parameters:")[0]


def test_arrow_table_matches_jax_and_the_frame(data):
    X = data["X"].copy()
    X[::17, 1] = np.nan
    arrays = [pa.array(X[:, i]) for i in range(4)]
    # an Arrow null reads as NaN
    arrays[3] = pa.array([None if i % 23 == 0 else v
                          for i, v in enumerate(X[:, 3])])
    table = pa.table(arrays, names=NAMES)
    jb, tb = _both(lambda: table, data["y"], [0, 2])
    assert tb.model_to_string() == jb.model_to_string()
    Xn = X.copy()
    Xn[::23, 3] = np.nan
    frame = lgt.train(PARAMS, lgt.Dataset(pd.DataFrame(Xn, columns=NAMES),
                                          label=data["y"],
                                          categorical_feature=[0, 2]),
                      num_boost_round=ROUNDS)
    assert frame.model_to_string() == tb.model_to_string()
    np.testing.assert_array_equal(tb.predict(table), tb.predict(Xn))
    batch = table.to_batches()[0]
    from_batch = lgt.train(PARAMS, lgt.Dataset(batch, label=data["y"],
                                               categorical_feature=[0, 2]),
                           num_boost_round=ROUNDS)
    assert from_batch.model_to_string() == tb.model_to_string()


class _CStream:
    """A producer of the Arrow C stream that is not a pyarrow object (as
    a polars DataFrame is)."""

    def __init__(self, table):
        self._table = table

    def __arrow_c_stream__(self, requested_schema=None):
        return self._table.__arrow_c_stream__(requested_schema)


def test_arrow_c_stream_producer_trains_as_its_table(data):
    table = pa.table([pa.array(data["X"][:, i]) for i in range(4)],
                     names=NAMES)
    want = lgt.train(PARAMS, lgt.Dataset(table, label=data["y"],
                                         categorical_feature=["month"]),
                     num_boost_round=ROUNDS)
    got = lgt.train(PARAMS, lgt.Dataset(_CStream(table), label=data["y"],
                                        categorical_feature=["month"]),
                    num_boost_round=ROUNDS)
    assert got.model_to_string() == want.model_to_string()
    assert got.feature_name() == NAMES


def test_set_categorical_feature_rebins(data):
    """The ``set_categorical_feature`` half of the JAX checklist's
    ``test_booster_eval_and_histogram``: a constructed Dataset bins again
    at its next construct; an unchanged call does nothing."""
    ds = lgt.Dataset(data["X"], label=data["y"],
                     free_raw_data=False).construct()
    binned = ds._binned
    ds.set_categorical_feature("auto")
    assert ds._binned is binned
    ds.set_categorical_feature([2])
    assert ds._binned is None
    bst = lgt.train(PARAMS, ds, num_boost_round=2)
    assert ds.binned.bin_mappers[2].bin_type == "categorical"
    assert ds.binned.bin_mappers[0].bin_type == "numerical"
    assert np.isfinite(bst.predict(data["X"])).all()
    jds = lgb.Dataset(data["X"], label=data["y"], free_raw_data=False)
    jds.construct().set_categorical_feature([2])
    jbst = lgb.train(PARAMS, jds, num_boost_round=2)
    assert bst.model_to_string() == jbst.model_to_string()
    sub = lgt.Dataset(data["X"], label=data["y"]).subset(np.arange(100))
    sub.construct()
    with pytest.raises(LightGBMError, match="raw data"):
        sub.set_categorical_feature([2])


def test_trees_to_dataframe_lists_categories(data):
    """JAX checklist ``test_trees_to_dataframe_categorical``: a categorical
    node's threshold is its ``||``-joined categories; the frame is the
    JAX package's."""
    jb, tb = _both(lambda: data["X"], data["y"], [0, 2])
    df = tb.trees_to_dataframe()
    cat_rows = df[df["decision_type"] == "=="]
    assert len(cat_rows) > 0
    for v in cat_rows["threshold"]:
        assert all(p.isdigit() for p in str(v).split("||")), v
    pd.testing.assert_frame_equal(df, jb.trees_to_dataframe())


def test_estimators_take_categorical_feature(data):
    """The estimators pass ``categorical_feature`` to their Dataset (by a
    frame's column name or by index); with a frame they keep its names
    (the JAX checklist's ``test_sklearn_feature_names_in`` and
    ``test_pandas_input``)."""
    kw = dict(n_estimators=ROUNDS, num_leaves=7, min_child_samples=5,
              verbose=-1, min_data_per_group=10, cat_smooth=2.0)
    t = lgt.LGBMRegressor(**kw, device_type="cpu").fit(
        data["df"], data["y"], categorical_feature=["month", "carrier"])
    j = lgb.LGBMRegressor(**kw).fit(
        data["df"], data["y"], categorical_feature=["month", "carrier"])
    np.testing.assert_array_equal(t.predict(data["df"]),
                                  j.predict(data["df"]))
    assert "cat_threshold=" in t.booster_.model_to_string()
    np.testing.assert_array_equal(t.feature_names_in_, NAMES)
    assert t.feature_name_ == NAMES
    assert t.predict(data["df"]).shape == (len(data["y"]),)
    yc = (data["y"] > np.median(data["y"])).astype(int)
    c = lgt.LGBMClassifier(**kw, device_type="cpu").fit(
        data["X"], yc, categorical_feature=[0, 2])
    jc = lgb.LGBMClassifier(**kw).fit(data["X"], yc,
                                      categorical_feature=[0, 2])
    assert "cat_threshold=" in c.booster_.model_to_string()
    np.testing.assert_allclose(c.predict_proba(data["X"]),
                               jc.predict_proba(data["X"]), rtol=1e-5,
                               atol=1e-7)


def test_cv_folds_keep_the_categorical_bins(data):
    """``cv`` folds are subsets sharing the full Dataset's bin mappers, so
    each fold trains on the categorical bins; the results are the JAX
    package's."""
    params = {**PARAMS, "categorical_feature": "0,2"}
    res = {}
    for pkg in (lgb, lgt):
        res[pkg] = pkg.cv(params, pkg.Dataset(data["X"], label=data["y"]),
                          num_boost_round=ROUNDS, nfold=3,
                          return_cvbooster=True)
    t, j = res[lgt], res[lgb]
    np.testing.assert_allclose(t["valid l2-mean"], j["valid l2-mean"],
                               rtol=1e-6)
    for b in t["cvbooster"].boosters:
        assert "cat_threshold=" in b.model_to_string()


def test_sparse_input_is_refused_naming_a12_5b(data):
    """Refused until ROADMAP A12.5b ported it: a CSR matrix of the rows
    trains the dense matrix's model text and predicts its values."""
    sparse = pytest.importorskip("scipy.sparse")
    X = np.nan_to_num(data["X"])
    m = sparse.csr_matrix(X)
    got = lgt.train(PARAMS, lgt.Dataset(m, label=data["y"]),
                    num_boost_round=ROUNDS)
    want = lgt.train(PARAMS, lgt.Dataset(X, label=data["y"]),
                     num_boost_round=ROUNDS)
    assert got.model_to_string() == want.model_to_string()
    np.testing.assert_array_equal(got.predict(m), want.predict(X))


def test_numpy_path_imports_neither_pandas_nor_pyarrow(data, tmp_path):
    """Training with categorical features and predicting on numpy input,
    on both device routes, loads neither pandas nor pyarrow. As on the
    card's machine, scikit-learn is absent (here it would import pandas
    itself)."""
    np.save(tmp_path / "X.npy", data["X"])
    np.save(tmp_path / "y.npy", data["y"])
    code = "\n".join([
        "import sys, numpy as np",
        "sys.modules['sklearn'] = None",
        "import lightgbm_tpu_torch as lgt",
        "X = np.load(sys.argv[1]); y = np.load(sys.argv[2])",
        f"b = lgt.train({PARAMS!r}, lgt.Dataset(X, label=y, "
        "categorical_feature=[0, 2]), num_boost_round=2)",
        "b.predict(X); b.predict(X, device=True)",
        "assert 'cat_threshold=' in b.model_to_string()",
        "bad = [m for m in ('pandas', 'pyarrow') if m in sys.modules]",
        "assert not bad, bad"])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", code, str(tmp_path / "X.npy"),
                    str(tmp_path / "y.npy")], check=True, env=env,
                   timeout=300)
