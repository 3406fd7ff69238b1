"""``Sequence`` input in the PyTorch port against the JAX package.

A ``Sequence`` (random-access rows, read in ``batch_size`` ranges) or a
list of them bins to the bins of the dense matrix of their rows, with a
categorical feature and with ``bin_construct_sample_cnt`` under the row
count (the sample drawn by random access), as the JAX package's
``Sequence`` does; a validation Sequence bins with its reference's
mappers; the trained model text is the dense matrix's.
"""
import numpy as np
import pytest
from test_torch_model_io import _no_params

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.io.sequence import Sequence as JSequence


def _seq_class(base):
    class Rows(base):
        def __init__(self, X, batch_size):
            self.X = X
            self.batch_size = batch_size

        def __getitem__(self, idx):
            return self.X[idx]

        def __len__(self):
            return len(self.X)
    return Rows


TRows, JRows = _seq_class(lgt.Sequence), _seq_class(JSequence)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(15)
    X = rng.normal(size=(1800, 6))
    X[:, 4] = rng.integers(0, 9, size=1800)
    X[rng.uniform(size=1800) < 0.05, 1] = np.nan
    y = X[:, 0] - np.nan_to_num(X[:, 1]) + (X[:, 4] == 3) + \
        0.2 * rng.normal(size=1800)
    return X, y


@pytest.mark.parametrize("params", [{}, {"bin_construct_sample_cnt": 700}])
def test_sequence_bins_equal_dense_and_jax(data, params):
    X, y = data
    params = {"verbosity": -1, **params}
    parts = [X[:500], X[500:1300], X[1300:]]
    t = lgt.Dataset([TRows(p, 128) for p in parts], label=y, params=params,
                    categorical_feature=[4]).binned
    dense = lgt.Dataset(X, label=y, params=params,
                        categorical_feature=[4]).binned
    j = lgb.Dataset([JRows(p, 128) for p in parts], label=y, params=params,
                    categorical_feature=[4]).construct()._binned
    np.testing.assert_array_equal(t.bins, dense.bins)
    np.testing.assert_array_equal(t.bins, j.bins.T)
    np.testing.assert_array_equal(t.metadata.label, dense.metadata.label)


def test_sequence_valid_and_training(data):
    X, y = data
    params = {"objective": "regression", "num_leaves": 15, "verbosity": -1,
              "device_type": "cpu"}
    train = lgt.Dataset(TRows(X[:1500], 256), label=y[:1500])
    valid = lgt.Dataset(TRows(X[1500:], 100), label=y[1500:],
                        reference=train)
    rec = {}
    bst = lgt.train(params, train, num_boost_round=3, valid_sets=[valid],
                    callbacks=[lgt.record_evaluation(rec)])
    dense = lgt.train(params, lgt.Dataset(X[:1500], label=y[:1500]),
                      num_boost_round=3)
    assert _no_params(bst.model_to_string()) == \
        _no_params(dense.model_to_string())
    np.testing.assert_array_equal(
        valid.binned.bins,
        lgt.Dataset(X[1500:], reference=train).binned.bins)
    assert len(rec["valid_0"]["l2"]) == 3
