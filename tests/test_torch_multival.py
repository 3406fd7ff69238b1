"""Multi-value sparse storage in the PyTorch port against the JAX package.

``ops/hist_multival.py``: ``hist_multival`` (the stored entries'
scatter, each slot's entries added in ``[R, K]`` row-major order on the
CPU, as XLA's CPU scatter adds them) is the JAX package's bit for bit on
f32 and int8 gh, padding included; the default-bin fix (leaf totals
minus the stored mass) too; a partition column reads the default bin
where a row stores no entry of the feature.

Training at 1,500 rows of 64 features, four random entries a row (the
features conflict, so the auto rule stores them multi-value), 15
leaves, 3 rounds: L2 through the compact and the full grower and
quantized gives the JAX package's model text string for string; level
scheduling falls back to compact, as in the JAX package.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from test_torch_efb import BASE
from test_torch_model_io import _no_params

import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import hist_multival as jmv
from lightgbm_tpu_torch.ops import hist_multival as tmv

ROUNDS = 3


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(13)
    n, F, K = 1500, 64, 4
    rows = np.repeat(np.arange(n), K)
    cols = np.argsort(rng.uniform(size=(n, F)), axis=1)[:, :K].reshape(-1)
    X = sp.csr_matrix((rng.uniform(1, 5, size=K * n), (rows, cols)),
                      shape=(n, F))
    y = (X[:, 3].toarray().ravel() - 0.7 * X[:, 40].toarray().ravel()
         + rng.normal(size=n))
    return {"X": X, "y": y}


def _sparse_bins(rng, R=700, F=12, K=5, B=7):
    """[R, K] ids (-1 padded, each feature at most once a row) and bins."""
    idx = np.full((R, K), -1, np.int32)
    binv = np.zeros((R, K), np.int32)
    for r in range(R):
        k = rng.integers(0, K + 1)
        idx[r, :k] = np.sort(rng.choice(F, size=k, replace=False))
        binv[r, :k] = rng.integers(0, B, size=k)
    return idx, binv


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_scatter_matches_jax(rng, mode):
    F, B = 12, 7
    idx, binv = _sparse_bins(rng, F=F, B=B)
    R = len(idx)
    if mode == "f32":
        gh = rng.normal(size=(R, 3)).astype(np.float32)
    else:
        gh = rng.integers(-8, 9, size=(R, 3)).astype(np.int8)
    want = np.asarray(jmv.hist_multival(
        jmv.SparseBins(jnp.asarray(idx), jnp.asarray(binv), F),
        jnp.asarray(gh), B))
    sb = tmv.SparseBins(torch.from_numpy(idx), torch.from_numpy(binv), F)
    got = tmv.hist_multival(sb, torch.from_numpy(gh), B)
    assert got.dtype == (torch.int32 if mode == "int8" else torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    rows = torch.from_numpy(np.sort(rng.choice(R, 300, replace=False)))
    np.testing.assert_array_equal(
        tmv.hist_multival(sb.index_select(0, rows), torch.from_numpy(gh)[rows],
                          B).numpy(),
        np.asarray(jmv.hist_multival(
            jmv.take_rows(jmv.SparseBins(jnp.asarray(idx), jnp.asarray(binv),
                                         F), jnp.asarray(rows.numpy())),
            jnp.asarray(gh)[rows.numpy()], B)))


def test_default_bin_fix_and_fetch_match_jax(rng):
    F, B = 12, 7
    idx, binv = _sparse_bins(rng, F=F, B=B)
    dflt = rng.integers(0, B, size=F).astype(np.int32)
    hist = rng.normal(size=(2, F, B, 3)).astype(np.float32)
    tot = rng.normal(size=(2, 3)).astype(np.float32) * 40
    fix = tmv.make_default_bin_fix(dflt, B, "cpu")
    jfix = jmv.make_default_bin_fix(dflt, B)
    got = fix(torch.from_numpy(hist), torch.from_numpy(tot)).numpy()
    for n in range(2):
        want = np.asarray(jfix(jnp.asarray(hist[n]),
                               tuple(jnp.asarray(tot[n])) + (0.0,))[0])
        np.testing.assert_array_equal(got[n], want)
    sb = tmv.SparseBins(torch.from_numpy(idx), torch.from_numpy(binv), F)
    jfetch = jmv.make_fetch_bin_column(dflt)
    jsb = jmv.SparseBins(jnp.asarray(idx), jnp.asarray(binv), F)
    for f in range(F):
        np.testing.assert_array_equal(
            tmv.fetch_bin_column(sb, f, int(dflt[f])).numpy(),
            np.asarray(jfetch(jsb, f)))


@pytest.mark.parametrize("extra", [
    pytest.param({}, id="compact"),
    pytest.param({"tpu_row_scheduling": "full"}, id="full"),
    pytest.param({"use_quantized_grad": True}, id="quantized"),
    pytest.param({"tpu_sparse_storage": "multival",
                  "tpu_row_scheduling": "level", "max_depth": 4},
                 id="level_falls_back_to_compact")])
def test_multival_trees_equal_jax(data, extra):
    params = {"objective": "regression", **BASE, **extra}
    ds = lgt.Dataset(data["X"], label=data["y"], params=params)
    assert ds.binned.bins_mv is not None and ds.binned.bins is None
    tbst = lgt.train(params, ds, num_boost_round=ROUNDS)
    jbst = lgb.train({k: v for k, v in params.items() if k != "device_type"},
                     lgb.Dataset(data["X"], label=data["y"]),
                     num_boost_round=ROUNDS)
    eng = tbst._engine
    assert eng._multival and eng._bundle is None
    assert eng.row_sched == extra.get("tpu_row_scheduling", "compact") \
        .replace("level", "compact")
    assert _no_params(tbst.model_to_string()) == \
        _no_params(jbst.model_to_string())
