"""The numerical split scan of the PyTorch port against the JAX package.

``best_split_for_leaf`` gets the same histogram and leaf sums in both
packages: the winning feature, threshold and default direction must be
equal, and planted ties must break the way the reference breaks them.
Both packages compute in f32, but their cumulative sums add in different
orders (XLA's ``cumsum`` and ``torch.cumsum`` each have their own), so
each float is held to 1e-6 of the size of the terms that make it: a
side's gradient sum to 1e-6 of the leaf's sum of |gradient| (the right
side is the total less the left, which cancels), counts exactly, and the
net gain (the split's gain less the parent's) to 1e-6 of the two gains
it cancels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.ops.histogram import hist_scatter
from lightgbm_tpu_torch.ops import split as tsplit

RECORD_INTS = ("feature", "threshold", "default_left")


def _metas(num_bin, missing, default_bin):
    F = len(num_bin)
    jm = jsplit.FeatureMeta(
        num_bin=jnp.asarray(num_bin, jnp.int32),
        missing_type=jnp.asarray(missing, jnp.int32),
        default_bin=jnp.asarray(default_bin, jnp.int32),
        is_categorical=jnp.zeros(F, bool))
    tm = tsplit.FeatureMeta(
        num_bin=torch.tensor(num_bin, dtype=torch.int32),
        missing_type=torch.tensor(missing, dtype=torch.int32),
        default_bin=torch.tensor(default_bin, dtype=torch.int32),
        has_missing=any(m != 0 for m in missing))
    return jm, tm


def _leaf(rng, S, num_bin, binary_grads):
    F, B = len(num_bin), max(num_bin)
    bins = np.stack([rng.integers(0, nb, size=S) for nb in num_bin],
                    axis=1).astype(np.uint8)
    if binary_grads:
        p = 1.0 / (1.0 + np.exp(-rng.normal(size=S)))
        y = rng.uniform(size=S) < 0.4
        g = (p - y).astype(np.float32)
        h = (p * (1.0 - p)).astype(np.float32)
    else:
        g = rng.normal(size=S).astype(np.float32)
        h = np.ones(S, np.float32)
    gh = np.stack([g, h, np.ones(S, np.float32)], axis=1)
    hist = np.array(hist_scatter(jnp.asarray(bins.T), jnp.asarray(gh), B))
    sums = gh.sum(axis=0, dtype=np.float32)
    return hist, sums, np.abs(gh).sum(axis=0)


def _both(hist, sums, parent_out, jm, tm, **hp):
    jr = jsplit.best_split_for_leaf(
        jnp.asarray(hist), jnp.float32(sums[0]), jnp.float32(sums[1]),
        jnp.float32(sums[2]), jnp.float32(parent_out), jm,
        jsplit.SplitHyperParams(**hp))
    tr = tsplit.best_split_for_leaf(
        torch.from_numpy(hist), float(sums[0]), float(sums[1]),
        float(sums[2]), float(parent_out), tm, tsplit.SplitHyperParams(**hp))
    return jr, tr


def _assert_same(jr, tr, sums, abs_sums, **hp):
    """``abs_sums``: the leaf's sums of |grad|, |hess|, count."""
    get = lambda rec, f: float(np.asarray(getattr(rec, f)))
    close = lambda f, tol: np.testing.assert_allclose(
        get(tr, f), get(jr, f), rtol=0, atol=tol, err_msg=f)
    for f in RECORD_INTS:
        assert int(get(jr, f)) == int(get(tr, f)), f
    # the split's gain is the net gain plus the parent's leaf gain
    parent = jsplit.leaf_gain(np.float32(sums[0]), np.float32(sums[1]),
                              jsplit.SplitHyperParams(**hp))
    close("gain", 1e-6 * (abs(get(jr, "gain")) + abs(float(parent))))
    for side in ("left", "right"):
        g, h = get(jr, f"{side}_sum_gradient"), get(jr, f"{side}_sum_hessian")
        close(f"{side}_sum_gradient", 1e-6 * abs_sums[0])
        close(f"{side}_sum_hessian", 1e-6 * abs_sums[1])
        assert get(jr, f"{side}_count") == get(tr, f"{side}_count")
        close(f"{side}_output",
              1e-6 * (abs_sums[0] / h + abs(g) * abs_sums[1] / h ** 2))


@pytest.mark.parametrize("missing", ["none", "zero", "nan"])
@pytest.mark.parametrize("binary_grads", [False, True],
                         ids=["l2", "logloss"])
def test_best_split_matches_jax(rng, missing, binary_grads):
    num_bin = [16, 31, 8, 63, 2, 40]
    m = jsplit.MISSING_ENUM[missing]
    jm, tm = _metas(num_bin, [m] * len(num_bin),
                    [min(3, nb - 1) for nb in num_bin])
    hist, sums, abs_sums = _leaf(rng, 3000, num_bin, binary_grads)
    for hp in ({}, {"lambda_l1": 0.5, "lambda_l2": 1.0},
               {"max_delta_step": 0.3, "min_data_in_leaf": 50}):
        jr, tr = _both(hist, sums, 0.0, jm, tm, **hp)
        assert int(tr.feature) >= 0
        _assert_same(jr, tr, sums, abs_sums, **hp)


def test_batched_scan_equals_per_leaf(rng):
    """The grower scans both children at once ([N, F, B, 3])."""
    num_bin = [20, 20, 20, 20]
    _, tm = _metas(num_bin, [2, 0, 1, 0], [0, 0, 5, 0])
    leaves = [_leaf(rng, 1500, num_bin, True) for _ in range(2)]
    hp = tsplit.SplitHyperParams()
    batched = tsplit.best_split_for_leaf(
        torch.from_numpy(np.stack([h for h, _, _ in leaves])),
        torch.tensor([s[0] for _, s, _ in leaves]),
        torch.tensor([s[1] for _, s, _ in leaves]),
        torch.tensor([s[2] for _, s, _ in leaves]),
        torch.zeros(2), tm, hp)
    for n, (hist, sums, _) in enumerate(leaves):
        one = tsplit.best_split_for_leaf(
            torch.from_numpy(hist), float(sums[0]), float(sums[1]),
            float(sums[2]), 0.0, tm, hp)
        for f in tsplit.SplitRecord._fields:
            assert torch.equal(getattr(batched, f)[n], getattr(one, f)), f


# the shape of the scans above ([6, 63, 3]): JAX compiles each eager op
# once per shape, so the small cases below reuse those compilations
F_TEST, B_TEST = 6, 63


def test_planted_ties_break_like_the_reference():
    """Equal gains: across features the smaller index wins; within the
    reverse scan the larger threshold wins."""
    B = 8
    # features 1 and 2 carry identical histograms, and each is mirror
    # symmetric: threshold 0 and threshold 6 give the same gain; the
    # other features have every row in one bin
    g = np.asarray([2, 0, 0, 0, 0, 0, 0, -2], np.float32)
    hist = np.zeros((F_TEST, B_TEST, 3), np.float32)
    hist[:, 0] = [0.0, 32.0, 32.0]
    hist[1:3, :B] = np.stack([g, np.full(B, 4.0, np.float32),
                              np.full(B, 4.0, np.float32)], axis=1)
    sums = hist[0].sum(axis=0)
    jm, tm = _metas([B] * F_TEST, [0] * F_TEST, [0] * F_TEST)
    hp = dict(min_data_in_leaf=1, min_sum_hessian_in_leaf=0.0)
    jr, tr = _both(hist, sums, 0.0, jm, tm, **hp)
    for f in tsplit.SplitRecord._fields:
        assert float(getattr(tr, f)) == float(np.asarray(getattr(jr, f)))
    assert int(tr.feature) == 1
    # the reverse scan meets threshold 6 first and keeps it
    assert int(tr.threshold) == 6


def test_no_valid_split_reports_invalid():
    hist = np.zeros((F_TEST, B_TEST, 3), np.float32)
    hist[:, 0] = [1.0, 5.0, 5.0]        # every row in one bin
    jm, tm = _metas([4] * F_TEST, [0] * F_TEST, [0] * F_TEST)
    jr, tr = _both(hist, hist[0].sum(axis=0), 0.0, jm, tm)
    assert int(tr.feature) == -1 == int(np.asarray(jr.feature))
    assert float(tr.gain) == -np.inf
