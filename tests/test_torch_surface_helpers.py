"""The helpers of the JAX package's surface that a caller may reach, in
the PyTorch port against the JAX package: ``Metric.names``,
``is_constant_hessian``, ``BinMapper.bin_to_value``, the binned
Dataset's feature counts, ``GBDT.num_iterations_trained``,
``TreeArrays.max_leaves``, ``HostTree.add_output``, ``shap_one_tree``,
``tree_leaf_bins`` / ``tree_output_bins``, ``meta_has_categorical``,
``is_hessian_change`` and ``stall_pending``.

One L2 model a package, 600 rows, 6 features (one categorical, one with
missing values), 7 leaves, 3 rounds: the port trains the JAX package's
trees string for string there, so every helper is held equal on the same
trees, the port's tensors read back to numpy. A ``TreeArrays`` is the JAX
package's ``host_tree_to_arrays`` of a tree, read into the port's
``TreeArrays`` as numpy, so both packages walk the same arrays.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.core import metrics as jmetrics
from lightgbm_tpu.core import objective as jobjective
from lightgbm_tpu.core import shap as jshap
from lightgbm_tpu.core import tree as jtree
from lightgbm_tpu.models.sample_strategy import SampleStrategy as JSample
from lightgbm_tpu.ops import predict as jpredict
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.robustness import heartbeat as jheartbeat
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.core import metrics as tmetrics
from lightgbm_tpu_torch.core import objective as tobjective
from lightgbm_tpu_torch.core import shap as tshap
from lightgbm_tpu_torch.core import tree as ttree
from lightgbm_tpu_torch.models.sample_strategy import \
    SampleStrategy as TSample
from lightgbm_tpu_torch.ops import predict as tpredict
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.robustness import heartbeat as theartbeat

N, F, ROUNDS = 600, 6, 3
PARAMS = {"objective": "regression", "num_leaves": 7, "min_data_in_leaf": 5,
          "verbosity": -1, "device_type": "cpu"}


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(N, F))
    X[:, 5] = rng.integers(0, 6, size=N)
    X[rng.uniform(size=N) < 0.1, 1] = np.nan
    y = X[:, 0] + 3.0 * (X[:, 5] == 2) - np.nan_to_num(X[:, 1]) \
        + rng.normal(scale=0.3, size=N)
    out = {"X": X, "binned": {}}
    for pkg in (lgb, lgt):
        ds = pkg.Dataset(X, label=y, categorical_feature=[5]).construct()
        out["binned"][pkg] = ds._binned
        out[pkg] = pkg.train(PARAMS, ds, num_boost_round=ROUNDS)
    jt, tt = (out[p].model_to_string() for p in (lgb, lgt))
    assert jt[jt.index("Tree=0"):jt.index("end of trees")] == \
        tt[tt.index("Tree=0"):tt.index("end of trees")]
    return out


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _port_arrays(j):
    """The port's ``TreeArrays`` holding the JAX package's arrays ``j``
    as numpy, its scalars as host numbers."""
    return ttree.TreeArrays(**{
        f: (None if getattr(j, f) is None else np.array(getattr(j, f)))
        for f in ttree.TreeArrays._fields}
        )._replace(num_leaves=int(j.num_leaves),
                   shrinkage=float(j.shrinkage))


def test_metric_names_equal_jax():
    params = {"metric": ["l2", "ndcg", "multi_error", "auc"],
              "eval_at": [1, 3]}
    names = {}
    for mod, cfg in ((jmetrics, JConfig), (tmetrics, TConfig)):
        names[mod] = [m.names for m in
                      mod.metrics_for_config(cfg(params), "regression")]
    assert names[tmetrics] == names[jmetrics]
    assert names[tmetrics][0] == ["l2"]
    assert names[tmetrics][1] == ["ndcg@1", "ndcg@3"]


@pytest.mark.parametrize("objective", [
    "regression", "regression_l1", "huber", "fair", "poisson", "quantile",
    "mape", "gamma", "tweedie", "binary"])
def test_is_constant_hessian_equals_jax(objective):
    got = {}
    for mod, cfg in ((jobjective, JConfig), (tobjective, TConfig)):
        obj = mod.create_objective(objective, cfg({"objective": objective}))
        unweighted = obj.is_constant_hessian()
        obj.weight = np.ones(4)
        got[mod] = (unweighted, obj.is_constant_hessian())
    assert got[tobjective] == got[jobjective]


def test_binned_dataset_helpers_equal_jax(both):
    jd, td = (both["binned"][p] for p in (lgb, lgt))
    assert td.num_used_features == jd.num_used_features == F
    np.testing.assert_array_equal(td.num_bins_per_feature(),
                                  jd.num_bins_per_feature())
    for jm, tm in zip(jd.bin_mappers, td.bin_mappers):
        for b in range(tm.num_bin - (tm.missing_type == "nan")):
            assert tm.bin_to_value(b) == jm.bin_to_value(b)
    assert any(m.bin_type == "categorical" for m in td.bin_mappers)


def test_engine_helpers_equal_jax(both):
    je, te = (both[p]._engine for p in (lgb, lgt))
    assert te.num_iterations_trained == je.num_iterations_trained == ROUNDS


def test_tree_arrays_helpers_equal_jax(both):
    je, te = (both[p]._engine for p in (lgb, lgt))
    for jh, th in zip(je.models, te.models):
        j = jtree.host_tree_to_arrays(jh, 9)
        t = _port_arrays(j)
        assert t.max_leaves == j.max_leaves == 9
        # the JAX package's arrays make the port's host tree
        back = ttree.HostTree(t, both["binned"][lgt].used_feature_map)
        np.testing.assert_array_equal(back.leaf_value, th.leaf_value)
        np.testing.assert_array_equal(back.split_feature, th.split_feature)
    delta = np.linspace(-1, 1, je.models[0].num_leaves)
    j, t = je.models[0].copy(), te.models[0].copy()
    j.add_output(delta)
    t.add_output(delta)
    np.testing.assert_array_equal(t.leaf_value, j.leaf_value)
    np.testing.assert_array_equal(t.leaf_value - te.models[0].leaf_value,
                                  delta)


def test_shap_one_tree_equals_jax(both):
    X = both["X"]
    je, te = (both[p]._engine for p in (lgb, lgt))
    for jh, th in zip(je.models, te.models):
        for row in (0, 7, 123):
            np.testing.assert_allclose(
                tshap.shap_one_tree(th, X[row], F),
                jshap.shap_one_tree(jh, X[row], F), rtol=1e-12, atol=1e-15)


def test_tree_leaf_and_output_bins_equal_jax(both):
    je, te = (both[p]._engine for p in (lgb, lgt))
    td = both["binned"][lgt]
    mappers = [td.bin_mappers[i] for i in td.used_feature_map]
    nbin = np.asarray([m.num_bin for m in mappers], np.int32)
    miss = np.asarray([jsplit.MISSING_ENUM[m.missing_type] for m in mappers],
                      np.int32)
    dflt = np.asarray([m.default_bin for m in mappers], np.int32)
    bins_t = np.ascontiguousarray(td.bins.T)
    jbins = je.bins_dev
    jmeta = [jnp.asarray(a) for a in (nbin, miss, dflt)]
    for jh, th in zip(je.models, te.models):
        L = th.num_leaves + 2
        j = jtree.host_tree_to_arrays(jh, L)
        t = _port_arrays(j)
        want = _np(jpredict.tree_leaf_bins(j, jbins, *jmeta))
        got = tpredict.tree_leaf_bins(t, torch.as_tensor(bins_t), nbin,
                                      miss, dflt)
        np.testing.assert_array_equal(_np(got), want)
        out = _np(tpredict.tree_output_bins(t, torch.as_tensor(bins_t),
                                            nbin, miss, dflt))
        np.testing.assert_array_equal(
            out, _np(jpredict.tree_output_bins(j, jbins, *jmeta)))
        # the leaves the host walk finds over the raw rows, and the
        # outputs of the engine's own device walk of the host tree
        np.testing.assert_array_equal(_np(got), th.predict_leaf(both["X"]))
        np.testing.assert_array_equal(
            out, _np(te._tree_outputs(th, torch.as_tensor(bins_t))))
    assert any(t.cat_count is not None and t.cat_count.any()
               for t in (_port_arrays(jtree.host_tree_to_arrays(h, 9))
                         for h in je.models))


def test_meta_has_categorical_equals_jax(both):
    td = both["binned"][lgt]
    mappers = [td.bin_mappers[i] for i in td.used_feature_map]
    for ms in (mappers, mappers[:5]):
        assert tsplit.meta_has_categorical(
            tsplit.FeatureMeta.from_mappers(ms)) == \
            jsplit.meta_has_categorical(jsplit.FeatureMeta.from_mappers(ms))
    assert tsplit.meta_has_categorical(tsplit.FeatureMeta.from_mappers(
        mappers))


@pytest.mark.parametrize("params", [
    {}, {"bagging_fraction": 0.5, "bagging_freq": 1},
    {"data_sample_strategy": "goss"}], ids=["none", "bagging", "goss"])
def test_is_hessian_change_equals_jax(params):
    got = [cls.create(cfg(params), 100, 1).is_hessian_change()
           for cls, cfg in ((JSample, JConfig), (TSample, TConfig))]
    assert got[0] == got[1] == ("data_sample_strategy" in params)


def test_stall_pending_without_a_watchdog_equals_jax():
    assert theartbeat.stall_pending() is jheartbeat.stall_pending() is False
