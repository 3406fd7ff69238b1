"""One tree from the PyTorch port's full-row-scheduling grower against the
JAX package's full grower (``GrowerConfig(row_sched="full")`` over
feature-major bins, with its ``hist_xla`` or ``hist_scatter`` histogram),
on the same binned rows and gradients.

- Dyadic L2 gradients: identical trees field for field, leaf ids
  included; binary logloss gradients: identical structure and floats
  within the bounds of ``tests/test_torch_grower.py``.
- Quantized gradients (stochastic rounding off, or on with the JAX
  package's own uniforms handed to the port): every histogram sum is an
  exact int32, so the tree is the JAX full grower's bit for bit, and the
  port's compact grower's on the same uniforms.
- ``tpu_row_scheduling="leaf"`` trains the same model as ``"full"``;
  ``tpu_hist_dtype="bfloat16"`` changes nothing under full scheduling, as
  in the JAX package (its ``hist_dtype`` is read on the compact path
  only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu.core import grower as jgrower
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.core import grower as tgrower
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.hist_cuda import hist_cuda_fm
from test_torch_grower import _data, _gradients, assert_tree_matches
from test_torch_quantized import TREE_FIELDS, _jax_uniforms

R, F, L = 4000, 8, 31


def _jax_full(bins, gh, jm, max_depth=-1, backend="scatter", key=None,
              **cfg):
    jcfg = jgrower.GrowerConfig(
        num_leaves=L, max_depth=max_depth,
        num_bin=max(m.num_bin for m in jm),
        hparams=jsplit.SplitHyperParams(min_data_in_leaf=20),
        row_sched="full", hist_backend=backend, **cfg)
    jt, jleaf = jgrower.make_tree_grower(
        jcfg, jsplit.FeatureMeta.from_mappers(jm))(
            jnp.asarray(bins.T), jnp.asarray(gh), None, None, key)
    return jt, np.asarray(jleaf)


def _port(bins, gh, tm, row_sched="full", max_depth=-1, uniforms=None,
          hist_fn=None, **cfg):
    tcfg = tgrower.GrowerConfig(
        num_leaves=L, max_depth=max_depth,
        num_bin=max(m.num_bin for m in tm),
        hparams=tsplit.SplitHyperParams(min_data_in_leaf=20),
        row_sched=row_sched, **cfg)
    layout = bins.T if row_sched == "full" else bins
    tt, tleaf = tgrower.make_tree_grower(
        tcfg, tsplit.FeatureMeta.from_mappers(tm), hist_fn=hist_fn)(
            torch.from_numpy(np.ascontiguousarray(layout)),
            torch.from_numpy(gh), uniforms)
    return tt, tleaf.numpy()


def _assert_identical(jt, jleaf, tt, tleaf):
    n = int(jt.num_leaves)
    assert tt.num_leaves == n > 1
    for f in TREE_FIELDS:
        cut = n if f.startswith("leaf") else n - 1
        np.testing.assert_array_equal(np.asarray(getattr(tt, f))[:cut],
                                      np.asarray(getattr(jt, f))[:cut], f)
    np.testing.assert_array_equal(tleaf, jleaf)


@pytest.mark.parametrize("kind,max_depth,backend",
                         [("l2_dyadic", -1, "xla"),
                          ("l2_dyadic", 4, "scatter"),
                          ("logloss", -1, "scatter")])
def test_full_tree_matches_jax(rng, kind, max_depth, backend):
    bins, jm, tm = _data(rng, R, F)
    gh = _gradients(rng, R, kind)
    jt, jleaf = _jax_full(bins, gh, jm, max_depth, backend)
    tt, tleaf = _port(bins, gh, tm, max_depth=max_depth)
    assert_tree_matches(kind, gh, jt, jleaf, tt, tleaf)


@pytest.mark.parametrize("stochastic", [False, True])
def test_quantized_full_tree_matches_jax_and_compact(rng, stochastic):
    seed, it = 11, 2
    bins, jm, tm = _data(rng, R, F)
    gh = _gradients(rng, R, "logloss")
    jt, jleaf = _jax_full(bins, gh, jm, quantized=True,
                          stochastic_rounding=stochastic,
                          key=jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 it))
    uniforms = (tuple(torch.from_numpy(u) for u in
                      _jax_uniforms(seed, it, R)) if stochastic else None)
    q = dict(quantized=True, stochastic_rounding=stochastic,
             uniforms=uniforms)
    tt, tleaf = _port(bins, gh, tm, **q)
    _assert_identical(jt, jleaf, tt, tleaf)
    ct, cleaf = _port(bins, gh, tm, row_sched="compact", **q)
    _assert_identical(jt, jleaf, ct, cleaf)


def test_bf16_is_ignored_under_full_scheduling(rng):
    """The JAX full grower builds f32 histograms whatever hist_dtype says;
    so does the port (logloss gradients, which bf16 would round)."""
    bins, jm, tm = _data(rng, R, F)
    gh = _gradients(rng, R, "logloss")
    jt, jleaf = _jax_full(bins, gh, jm, hist_dtype="bfloat16")
    jt32, jleaf32 = _jax_full(bins, gh, jm)
    _assert_identical(jt32, jleaf32, jt, jleaf)
    tt, tleaf = _port(bins, gh, tm, hist_dtype="bfloat16")
    tt32, tleaf32 = _port(bins, gh, tm)
    _assert_identical(tt32, tleaf32, tt, tleaf)


def test_every_histogram_is_a_masked_full_pass(rng):
    """The root and one smaller child per split: num_leaves passes, each
    over all R rows, the root's adding every row and a child's only the
    rows whose leaf id is the child's (the mask fused into the pass, gh
    itself unmasked), the child chosen by the split record's counts (the
    smaller one)."""
    bins, _, tm = _data(rng, R, F)
    gh = _gradients(rng, R, "l2_dyadic")
    seen = []

    def counting_hist(b, g, num_bin, *, leaf_id=None, leaf=None):
        assert torch.equal(g, torch.from_numpy(gh))
        rows = R if leaf_id is None else int((leaf_id == leaf).sum())
        seen.append((tuple(b.shape), rows))
        return hist_cuda_fm(b, g, num_bin, leaf_id=leaf_id, leaf=leaf)

    tt, _ = _port(bins, gh, tm, hist_fn=counting_hist)
    assert tt.num_leaves == L and len(seen) == L
    assert all(shape == (F, R) for shape, _ in seen)
    assert seen[0][1] == R
    assert all(2 * rows <= R for _, rows in seen[1:])


def _binary_data(rng, n=3000, f=8):
    X = rng.normal(size=(n, f))
    X[rng.uniform(size=n) < 0.05, 3] = np.nan
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2 - np.nan_to_num(X[:, 3]) > 0.5)
    return X, y.astype(np.float64)


@pytest.mark.parametrize("extra", [{}, {"use_quantized_grad": True,
                                        "stochastic_rounding": False},
                                   {"tpu_hist_dtype": "bfloat16"}],
                         ids=["f32", "quantized", "bf16"])
def test_leaf_scheduling_trains_the_full_model(rng, extra):
    """``leaf`` is ``full``; under full scheduling the engine holds the
    bins feature-major only, and bf16 trains the f32 model."""
    X, y = _binary_data(rng)
    body = lambda s: s[s.index("Tree=0"):s.index("end of trees")]
    base = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
            "device_type": "cpu"}
    models = {}
    for sched in ("full", "leaf"):
        bst = lgt.train({**base, "tpu_row_scheduling": sched, **extra},
                        lgt.Dataset(X, label=y), num_boost_round=3)
        assert tuple(bst._engine.bins.shape) == (X.shape[1], len(y))
        models[sched] = body(bst.model_to_string())
    assert models["full"] == models["leaf"]
    if "tpu_hist_dtype" in extra:
        f32 = lgt.train({**base, "tpu_row_scheduling": "full"},
                        lgt.Dataset(X, label=y), num_boost_round=3)
        assert models["full"] == body(f32.model_to_string())
