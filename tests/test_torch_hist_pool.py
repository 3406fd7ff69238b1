"""The histogram-pool policy in the PyTorch port against the JAX package.

Past ``histogram_pool_size`` the compact grower keeps no full
``[L, G, B, 3]`` pool: as many LRU slots as fit (``bounded``, at least
two; a cached parent subtracts, a miss histograms both children from
their rows) or none (``none``: both children of every split from their
rows), as the JAX package's models/gbdt.py:1080-1126 decides. Which
children are histogrammed from rows decides the f32 bits of their sums,
so L2 model text equal to the JAX package's at a budget of six slots,
where misses happen, shows the same slots taken and evicted. Dense
numerical rows and EFB groups (where the budget counts groups), 31
leaves, 3 rounds.
"""
import numpy as np
import pytest
from test_torch_efb import BASE, onehot_csr
from test_torch_model_io import _no_params

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

ROUNDS = 3


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(14)
    X = rng.normal(size=(3000, 8))
    X[rng.uniform(size=3000) < 0.05, 2] = np.nan
    y = X[:, 0] * 2 + np.sin(X[:, 1] * 3) - np.nan_to_num(X[:, 2])
    Xs, ys, _ = onehot_csr(rng, n=2000, groups=16, with_cat=False)
    return {"dense": (X, y + rng.normal(size=3000) * 0.3), "efb": (Xs, ys)}


def _slot_mb(X, y, slots):
    eng = lgt.Booster({"objective": "regression", **BASE},
                      lgt.Dataset(X, label=y))._engine
    row_bytes = eng._hist_budget()[0]
    return (slots + 0.5) * row_bytes / (1 << 20)


@pytest.mark.parametrize("source", ["dense", "efb"])
@pytest.mark.parametrize("policy,slots", [("bounded", 6), ("none", 1)])
def test_pool_policy_trees_equal_jax(data, source, policy, slots):
    X, y = data[source]
    params = {"objective": "regression", **BASE, "num_leaves": 31,
              "histogram_pool_size": _slot_mb(X, y, slots)}
    tbst = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=ROUNDS)
    jbst = lgb.train({k: v for k, v in params.items() if k != "device_type"},
                     lgb.Dataset(X, label=y), num_boost_round=ROUNDS)
    tcfg, jcfg = tbst._engine.grower_cfg, jbst._engine.grower_cfg
    assert tcfg.hist_pool == jcfg.hist_pool == policy
    assert tcfg.pool_slots == jcfg.pool_slots
    assert (tbst._engine._bundle is not None) == (source == "efb")
    counts = tbst._engine._grow.pool_counts
    assert counts["misses"] > 0
    if policy == "none":
        assert counts["hits"] == 0
    else:
        assert tcfg.pool_slots == slots and counts["hits"] > 0
    assert _no_params(tbst.model_to_string()) == \
        _no_params(jbst.model_to_string())


def test_full_pool_within_the_budget(data):
    X, y = data["dense"]
    params = {"objective": "regression", **BASE, "num_leaves": 31,
              "histogram_pool_size": _slot_mb(X, y, 31)}
    bst = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=1)
    assert bst._engine.grower_cfg.hist_pool == "full"
    assert bst._engine._grow.pool_counts["misses"] == 0


def test_multival_over_the_budget_keeps_no_pool():
    """Multi-value storage never takes the bounded pool (its histograms
    lack the default bins' mass until the scan): over the budget it
    keeps none, as the JAX package does, and trains its model text."""
    rng = np.random.default_rng(16)
    X, y, _ = onehot_csr(rng, n=1500, groups=10, with_cat=False)
    params = {"objective": "regression", **BASE, "num_leaves": 15,
              "tpu_sparse_storage": "multival",
              "histogram_pool_size": 6.5 * X.shape[1] * 2 * 12 / (1 << 20)}
    tbst = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=2)
    jbst = lgb.train({k: v for k, v in params.items() if k != "device_type"},
                     lgb.Dataset(X, label=y), num_boost_round=2)
    assert tbst._engine._multival
    assert tbst._engine.grower_cfg.hist_pool == \
        jbst._engine.grower_cfg.hist_pool == "none"
    assert _no_params(tbst.model_to_string()) == \
        _no_params(jbst.model_to_string())
