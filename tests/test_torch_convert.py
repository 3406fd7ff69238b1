"""Trees trained by the JAX package, carried into the PyTorch port.

``lightgbm_tpu_torch.convert`` takes each tree's ``HostTree`` arrays as
numpy and the dataset's bin mappers; the port's host walk must then
predict bit for bit what the JAX package's host walk predicts, for rows
with NaNs, zeros and values outside the training range too.
"""
import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu_torch.convert import (TREE_FIELDS, bin_mapper_from_fields,
                                        booster_from_arrays,
                                        trees_from_arrays)


def _trained(rng, objective):
    n = 2000
    X = rng.normal(size=(n, 6))
    X[rng.uniform(size=n) < 0.1, 2] = np.nan
    X[:, 4] = np.where(rng.uniform(size=n) < 0.6, 0.0, X[:, 4])
    signal = X[:, 0] - np.nan_to_num(X[:, 2], nan=1.0) + X[:, 4]
    y = ((signal > 0).astype(float) if objective == "binary"
         else signal + 0.1 * rng.normal(size=n))
    params = {"objective": objective, "num_leaves": 15, "verbosity": -1,
              "device_type": "cpu"}
    ds = lgb.Dataset(X, label=y)
    bst = lgb.train(params, ds, num_boost_round=4, keep_training_booster=True)
    return bst, ds, params


def _carry(bst, ds):
    binned = ds.binned
    trees = [{f: getattr(t, f) for f in TREE_FIELDS}
             for t in bst._engine.models]
    mappers = [bin_mapper_from_fields(vars(m)) for m in binned.bin_mappers]
    return trees, mappers, binned.used_feature_map


def _probe_rows(rng):
    X = rng.normal(size=(500, 6)) * 2.0
    X[::7, 2] = np.nan
    X[::5, 4] = 0.0
    X[::11, 0] = 1e6
    X[::13, 1] = -np.inf
    return X


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_carried_trees_predict_bit_for_bit(rng, objective):
    bst, ds, params = _trained(rng, objective)
    trees, mappers, used = _carry(bst, ds)
    port = booster_from_arrays(params, trees, mappers, used)
    X = _probe_rows(rng)
    for kw in ({}, {"raw_score": True}, {"pred_leaf": True},
               {"num_iteration": 2}):
        np.testing.assert_array_equal(port.predict(X, **kw),
                                      bst.predict(X, **kw))


def test_carried_trees_keep_thresholds_and_text(rng):
    bst, ds, params = _trained(rng, "regression")
    trees, mappers, used = _carry(bst, ds)
    for jt, tt in zip(bst._engine.models,
                      trees_from_arrays(trees, mappers, used)):
        assert tt.num_leaves == jt.num_leaves
        np.testing.assert_array_equal(tt.split_feature, jt.split_feature)
        np.testing.assert_array_equal(tt.threshold_real, jt.threshold_real)
        np.testing.assert_array_equal(tt.decision_type, jt.decision_type)
        np.testing.assert_array_equal(tt.leaf_value, jt.leaf_value)
    port = booster_from_arrays(params, trees, mappers, used)
    jtext, ttext = bst.model_to_string(), port.model_to_string()
    cut = lambda s: s[s.index("Tree=0"):s.index("end of trees")]
    assert cut(ttext) == cut(jtext)
