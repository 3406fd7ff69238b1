"""One tree grown by the PyTorch port's compact grower against the JAX
package's compact grower, on the same binned rows and gradients.

With dyadic L2 gradients every sum is exact in f32, so the two trees
must be identical field for field, leaf ids included. With binary
logloss gradients the histogram and cumulative sums add in different
orders, so the structure (split features, thresholds, default
directions, child pointers, counts) must be identical, and each float
is held to 1e-6 of the size of the terms that make it. A child's sums
are its parent's less its sibling's, so they carry the rounding of the
root's sums: a node's hessian sum H is held to 1e-6 · H_root, its output
-G/H to 1e-6 · (Σ|g| + |output| · H_root) / H over all rows, and a
split's gain Σ G²/H to 1e-6 · (|gain| + 2 · max|output| · Σ|g|), since
dgain/dG = 2 · output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.core import grower as jgrower
from lightgbm_tpu.io.binning import BinMapper as JBinMapper
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.core import grower as tgrower
from lightgbm_tpu_torch.io.binning import BinMapper as TBinMapper
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.hist_cuda import hist_cuda_rm

STRUCTURE = ("split_feature", "threshold_bin", "default_left", "left_child",
             "right_child", "internal_count", "leaf_count", "leaf_parent")


def _data(rng, R, F):
    X = rng.normal(size=(R, F))
    X[rng.uniform(size=(R, F)) < 0.05] = np.nan     # NaN-bin features
    X[:, 1] = np.where(rng.uniform(size=R) < 0.5, 0.0, X[:, 1])
    jm = [JBinMapper.find_bin(X[:, f], R, 63, 3, 20) for f in range(F)]
    tm = [TBinMapper.find_bin(X[:, f], R, 63, 3, 20) for f in range(F)]
    bins = np.stack([m.value_to_bin(X[:, f]) for f, m in enumerate(jm)],
                    axis=1).astype(np.uint8)
    return bins, jm, tm


def _gradients(rng, R, kind):
    if kind == "l2_dyadic":
        g = rng.integers(-16, 17, size=R).astype(np.float32) / 8
        h = np.ones(R, np.float32)
    else:
        score = rng.normal(size=R).astype(np.float32)
        y = (rng.uniform(size=R) < 0.3).astype(np.float32)
        p = (1.0 / (1.0 + np.exp(-score))).astype(np.float32)
        g = p - y
        h = p * (1.0 - p)
    return np.stack([g, h, np.ones(R, np.float32)], axis=1)


def _grow_both(bins, gh, jm, tm, num_leaves, max_depth):
    B = max(m.num_bin for m in jm)
    jcfg = jgrower.GrowerConfig(
        num_leaves=num_leaves, max_depth=max_depth, num_bin=B,
        hparams=jsplit.SplitHyperParams(min_data_in_leaf=20),
        row_sched="compact", hist_rm_backend="scatter",
        partition_mode="scatter", min_bucket=len(bins))
    jt, jleaf = jgrower.make_tree_grower(
        jcfg, jsplit.FeatureMeta.from_mappers(jm))(jnp.asarray(bins),
                                                    jnp.asarray(gh))
    tcfg = tgrower.GrowerConfig(
        num_leaves=num_leaves, max_depth=max_depth, num_bin=B,
        hparams=tsplit.SplitHyperParams(min_data_in_leaf=20))
    tt, tleaf = tgrower.make_tree_grower(
        tcfg, tsplit.FeatureMeta.from_mappers(tm))(torch.from_numpy(bins),
                                                    torch.from_numpy(gh))
    return jt, np.asarray(jleaf), tt, tleaf.numpy()


@pytest.mark.parametrize("kind,max_depth", [("l2_dyadic", -1),
                                            ("l2_dyadic", 4),
                                            ("logloss", -1)])
def test_tree_matches_jax(rng, kind, max_depth):
    R, F, L = 4000, 8, 31
    bins, jm, tm = _data(rng, R, F)
    gh = _gradients(rng, R, kind)
    jt, jleaf, tt, tleaf = _grow_both(bins, gh, jm, tm, L, max_depth)
    assert_tree_matches(kind, gh, jt, jleaf, tt, tleaf)


def assert_tree_matches(kind, gh, jt, jleaf, tt, tleaf):
    """The port's tree and leaf ids against the JAX package's: identical
    for dyadic gradients, identical structure and floats within the
    bounds of the module docstring otherwise."""
    n = int(jt.num_leaves)
    assert tt.num_leaves == n > 1
    for f in STRUCTURE:
        cut = n if f.startswith("leaf") else n - 1
        np.testing.assert_array_equal(np.asarray(getattr(tt, f))[:cut],
                                      np.asarray(getattr(jt, f))[:cut], f)
    np.testing.assert_array_equal(tleaf, jleaf)
    get = lambda t, f, cut: np.asarray(getattr(t, f))[:cut].astype(
        np.float64)
    fields = [("internal", n - 1), ("leaf", n)]
    if kind == "l2_dyadic":
        for f in ("split_gain", "internal_value", "internal_weight",
                  "leaf_value", "leaf_weight"):
            cut = n if f.startswith("leaf") else n - 1
            np.testing.assert_array_equal(get(tt, f, cut), get(jt, f, cut),
                                          f)
        return
    g_abs, h_root = np.abs(gh[:, 0]).sum(), gh[:, 1].sum()
    for prefix, cut in fields:
        out, w = get(jt, f"{prefix}_value", cut), get(jt, f"{prefix}_weight",
                                                     cut)
        np.testing.assert_array_less(
            np.abs(get(tt, f"{prefix}_weight", cut) - w), 1e-6 * h_root)
        np.testing.assert_array_less(
            np.abs(get(tt, f"{prefix}_value", cut) - out),
            1e-6 * (g_abs + np.abs(out) * h_root) / w)
    max_out = np.abs(get(jt, "leaf_value", n)).max()
    gain = get(jt, "split_gain", n - 1)
    np.testing.assert_array_less(
        np.abs(get(tt, "split_gain", n - 1) - gain),
        1e-6 * (np.abs(gain) + 2 * max_out * g_abs))


def test_histogram_launches_once_per_leaf(rng, monkeypatch):
    """Root plus one smaller child per split: num_leaves histograms."""
    R, F, L = 3000, 5, 15
    bins, _, tm = _data(rng, R, F)
    gh = _gradients(rng, R, "l2_dyadic")
    calls = []

    def counting_hist(b, g, num_bin):
        calls.append(b.shape[0])
        return hist_cuda_rm(b, g, num_bin)

    cfg = tgrower.GrowerConfig(num_leaves=L, num_bin=max(m.num_bin
                                                         for m in tm))
    tree, _ = tgrower.make_tree_grower(
        cfg, tsplit.FeatureMeta.from_mappers(tm), hist_fn=counting_hist)(
            torch.from_numpy(bins), torch.from_numpy(gh))
    assert tree.num_leaves == L
    assert len(calls) == L
    assert calls[0] == R
    # each later pass covers the smaller child only
    assert all(2 * s <= R for s in calls[1:])
