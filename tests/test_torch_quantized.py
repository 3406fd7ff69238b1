"""Quantized-gradient training in the PyTorch port against the JAX package.

Under ``use_quantized_grad`` gradients are quantized to int8 once per tree
and every histogram sum is an exact int32 (ref: gradient_discretizer.cpp),
so the port must agree with the JAX package bit for bit wherever both see
the same int8 rows:

- ``quantize_gradients`` given the same uniforms (JAX's own
  ``jax.random.uniform`` draws, or 0.5 without stochastic rounding);
- one tree of the compact grower on the same f32 gh: identical
  ``TreeArrays`` and leaf ids, with stochastic rounding off, and on with
  the port handed the uniforms that JAX draws from
  ``split(fold_in(PRNGKey(seed), iter))``.

The port draws those bits itself (``utils/prng.py``, the threefry chain
of ``jax.random``; ``tests/test_torch_prng.py``), so whole trainings
compare with stochastic rounding on, as by default, and off. The
gradients of the binary objective come from each framework's own
``exp``, which can differ in the last ulp, so the quantization scale
``max|g| / 2`` can too: tree structure must be identical, and leaf values
and raw scores agree to 1e-5 of their largest magnitude (a regression
training with stochastic rounding is the JAX package's bit for bit:
``tests/test_torch_train.py::test_train_matches_jax``).
``quant_train_renew_leaf`` refits leaves in f64 from the f32 gradient
sums of each leaf; the two packages' f32 gradients agree to an ulp, so
renewed leaf values agree to rtol=1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.core import grower as jgrower
from lightgbm_tpu.io.binning import BinMapper as JBinMapper
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.core import grower as tgrower
from lightgbm_tpu_torch.io.binning import BinMapper as TBinMapper
from lightgbm_tpu_torch.ops import split as tsplit

STRUCTURE_KEYS = ("num_leaves", "split_feature", "threshold",
                  "decision_type", "left_child", "right_child", "leaf_count",
                  "internal_count")
TREE_FIELDS = ("split_feature", "threshold_bin", "default_left",
               "left_child", "right_child", "split_gain", "internal_value",
               "internal_weight", "internal_count", "leaf_value",
               "leaf_weight", "leaf_count", "leaf_parent")


def _logloss_gh(rng, R):
    score = rng.normal(size=R).astype(np.float32)
    y = (rng.uniform(size=R) < 0.3).astype(np.float32)
    p = (1.0 / (1.0 + np.exp(-score))).astype(np.float32)
    return np.stack([p - y, p * (1.0 - p), np.ones(R, np.float32)], axis=1)


def _jax_uniforms(seed, it, R):
    """The uniforms the JAX grower draws for tree ``it`` of a run seeded
    ``seed`` (models/gbdt.py:2308 fold_in, core/grower.py:255-258)."""
    kg, kh = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 it))
    return (np.array(jax.random.uniform(kg, (R,), jnp.float32)),
            np.array(jax.random.uniform(kh, (R,), jnp.float32)))


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("quant_bins", [4, 16])
def test_quantize_gradients_bit_for_bit(rng, stochastic, quant_bins):
    R = 3000
    gh = _logloss_gh(rng, R)
    key = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    jcfg = jgrower.GrowerConfig(quantized=True, quant_bins=quant_bins,
                                stochastic_rounding=stochastic)
    jq, jconv = jgrower.quantize_gradients(jcfg, jnp.asarray(gh), key)
    if stochastic:
        ug, uh = (torch.from_numpy(u) for u in _jax_uniforms(7, 3, R))
    else:
        ug = uh = 0.5
    tq, tconv = tgrower.quantize_gradients(torch.from_numpy(gh), quant_bins,
                                           ug, uh)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    sums = rng.integers(-50000, 50000, size=(5, 3)).astype(np.int32)
    np.testing.assert_array_equal(tconv(torch.from_numpy(sums)).numpy(),
                                  np.asarray(jconv(jnp.asarray(sums))))


def _binned(rng, R, F):
    X = rng.normal(size=(R, F))
    X[rng.uniform(size=(R, F)) < 0.05] = np.nan
    jm = [JBinMapper.find_bin(X[:, f], R, 63, 3, 20) for f in range(F)]
    tm = [TBinMapper.find_bin(X[:, f], R, 63, 3, 20) for f in range(F)]
    bins = np.stack([m.value_to_bin(X[:, f]) for f, m in enumerate(jm)],
                    axis=1).astype(np.uint8)
    return bins, jm, tm


@pytest.mark.parametrize("stochastic", [False, True])
def test_quantized_tree_matches_jax_bit_for_bit(rng, stochastic):
    R, F, L, seed, it = 4000, 8, 31, 11, 2
    bins, jm, tm = _binned(rng, R, F)
    gh = _logloss_gh(rng, R)
    B = max(m.num_bin for m in jm)
    jcfg = jgrower.GrowerConfig(
        num_leaves=L, num_bin=B,
        hparams=jsplit.SplitHyperParams(min_data_in_leaf=20),
        row_sched="compact", hist_rm_backend="scatter",
        partition_mode="scatter", min_bucket=R, quantized=True,
        stochastic_rounding=stochastic)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), it)
    jt, jleaf = jgrower.make_tree_grower(
        jcfg, jsplit.FeatureMeta.from_mappers(jm))(
            jnp.asarray(bins), jnp.asarray(gh), None, None, key)
    tcfg = tgrower.GrowerConfig(
        num_leaves=L, num_bin=B,
        hparams=tsplit.SplitHyperParams(min_data_in_leaf=20),
        quantized=True, stochastic_rounding=stochastic)
    uniforms = (tuple(torch.from_numpy(u) for u in _jax_uniforms(seed, it, R))
                if stochastic else None)
    tt, tleaf = tgrower.make_tree_grower(
        tcfg, tsplit.FeatureMeta.from_mappers(tm))(
            torch.from_numpy(bins), torch.from_numpy(gh), uniforms)
    n = int(jt.num_leaves)
    assert tt.num_leaves == n > 1
    for f in TREE_FIELDS:
        cut = n if f.startswith("leaf") else n - 1
        np.testing.assert_array_equal(np.asarray(getattr(tt, f))[:cut],
                                      np.asarray(getattr(jt, f))[:cut], f)
    np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))


def _trees(model_str):
    body = model_str[model_str.index("Tree=0"):
                     model_str.index("end of trees")]
    return [dict(ln.split("=", 1) for ln in block.splitlines()[1:])
            for block in body.strip().split("\n\n")]


def _data(rng, n=3000, f=8):
    X = rng.normal(size=(n, f))
    logit = X[:, 0] * 2 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float64)
    return X, y


@pytest.mark.parametrize("extra", [{}, {"quant_train_renew_leaf": True},
                                   {"num_grad_quant_bins": 16},
                                   {"stochastic_rounding": True}],
                         ids=["plain", "renew_leaf", "16_bins",
                              "stochastic_rounding"])
def test_quantized_training_matches_jax(rng, extra):
    X, y = _data(rng)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "device_type": "cpu", "use_quantized_grad": True,
              "stochastic_rounding": False, **extra}
    jb = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=5)
    tb = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=5)
    jt, tt = _trees(jb.model_to_string()), _trees(tb.model_to_string())
    assert len(jt) == len(tt) == 5
    for j, t in zip(jt, tt):
        for k in STRUCTURE_KEYS:
            assert t[k] == j[k], k
        jv = np.asarray(j["leaf_value"].split(), float)
        tv = np.asarray(t["leaf_value"].split(), float)
        np.testing.assert_allclose(tv, jv, rtol=1e-5,
                                   atol=1e-5 * np.abs(jv).max())
    jraw = jb.predict(X, raw_score=True)
    np.testing.assert_allclose(tb.predict(X, raw_score=True), jraw, rtol=0,
                               atol=1e-5 * np.abs(jraw).max())


def test_renew_leaf_refits_from_true_gradients(rng):
    """The renewed first tree's leaves are -G/(H + eps) of the f32
    gradients of each leaf's rows, not the quantized sums."""
    X, y = _data(rng, n=2000)
    params = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
              "device_type": "cpu", "use_quantized_grad": True,
              "quant_train_renew_leaf": True, "boost_from_average": False,
              "learning_rate": 1.0}
    tb = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=1)
    tree = tb._engine.models[0]
    leaf = tb.predict(X, pred_leaf=True)[:, 0]
    g = (0.5 - y).astype(np.float32).astype(np.float64)
    h = np.full(len(y), 0.25)
    for v in range(tree.num_leaves):
        rows = leaf == v
        expect = -g[rows].sum() / (h[rows].sum() + 1e-15)
        np.testing.assert_allclose(tree.leaf_value[v], expect, rtol=1e-6)


def test_stochastic_rounding_is_seeded(rng):
    """The port draws its uniforms from the threefry chain keyed by
    ``seed``: the same seed gives the same model, another seed another
    one."""
    X, y = _data(rng, n=1500)
    base = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
            "device_type": "cpu", "use_quantized_grad": True}
    runs = [lgt.train({**base, "seed": s}, lgt.Dataset(X, label=y),
                      num_boost_round=3).model_to_string()
            for s in (1, 1, 2)]
    body = lambda s: s[s.index("Tree=0"):s.index("end of trees")]
    assert body(runs[0]) == body(runs[1])
    assert body(runs[0]) != body(runs[2])


def test_bf16_tree_matches_jax_bf16_histograms(rng):
    """tpu_hist_dtype=bfloat16: gh is rounded to bf16 for the histograms
    only, where the JAX grower's ``hist_rowmajor(dtype="bfloat16")``
    rounds it (its einsum path); root sums stay f32. Dyadic gh whose
    values bf16 holds make every sum exact, so the trees are identical."""
    R, F, L = 4000, 8, 31
    bins, jm, tm = _binned(rng, R, F)
    g = rng.integers(-16, 17, size=R).astype(np.float32) / 8
    gh = np.stack([g, np.ones(R, np.float32), np.ones(R, np.float32)], 1)
    B = max(m.num_bin for m in jm)
    jcfg = jgrower.GrowerConfig(
        num_leaves=L, num_bin=B,
        hparams=jsplit.SplitHyperParams(min_data_in_leaf=20),
        row_sched="compact", hist_rm_backend="einsum", hist_dtype="bfloat16",
        partition_mode="scatter", min_bucket=R)
    jt, _ = jgrower.make_tree_grower(jcfg, jsplit.FeatureMeta.from_mappers(
        jm))(jnp.asarray(bins), jnp.asarray(gh))
    tcfg = tgrower.GrowerConfig(
        num_leaves=L, num_bin=B, hparams=tsplit.SplitHyperParams(
            min_data_in_leaf=20), hist_dtype="bfloat16")
    tt, _ = tgrower.make_tree_grower(tcfg, tsplit.FeatureMeta.from_mappers(
        tm))(torch.from_numpy(bins), torch.from_numpy(gh))
    n = int(jt.num_leaves)
    assert tt.num_leaves == n > 1
    for f in TREE_FIELDS:
        cut = n if f.startswith("leaf") else n - 1
        np.testing.assert_array_equal(np.asarray(getattr(tt, f))[:cut],
                                      np.asarray(getattr(jt, f))[:cut], f)
