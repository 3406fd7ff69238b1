"""Kernel K2's contract in the PyTorch port against the JAX package.

The port's ``ops/hist_level.hist_level`` is the plain version of the
hand-written CUDA kernel (``lightgbm_tpu_torch/csrc/hist_level.cu``); the
wrapper ``hist_level_cuda`` runs it for CPU tensors. Both are held
against the JAX package's Pallas kernel ``hist_level`` (run in interpret
mode, as tests/test_hist_level.py runs it) on the cases of that file:
ragged segments with an empty and a single-row node, all rows in one
node, all rows out of the level, and quantized int8 gh; the ragged case
also over uint16 bins at 300 bins (the port holds them as int16; a
``torch.uint16`` tensor is taken as its int16 view), uniform and skewed
(most rows in one bin, one feature of three values).

f32 cases use dyadic gh (small multiples of 0.25) and bf16 cases values
that bf16 holds exactly, so every summation order gives the same f32
sums and the comparison is bit for bit; int8 sums are exact int32 by
construction. One case with normal gh is held to rtol=1e-5, atol=1e-4
(sums of up to 3,000 values of magnitude ~1 in f32). The kernel itself
runs only on the card and is held against the plain version by
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.hist_level_pallas import hist_level as jax_hist_level
from lightgbm_tpu_torch.ops.hist_level import hist_level
from lightgbm_tpu_torch.ops.hist_level_cuda import hist_level_cuda
from lightgbm_tpu_torch.ops.histogram import hist_rowmajor


def _dyadic_gh(rng, n):
    return (rng.integers(-8, 8, (n, 3)) * 0.25).astype(np.float32)


def _both(bins, gh, local, in_lvl, n_d, B, bf16=False):
    """(port plain version, JAX Pallas kernel in interpret mode)."""
    tgh = torch.from_numpy(gh)
    jgh = jnp.asarray(gh)
    if bf16:
        tgh, jgh = tgh.to(torch.bfloat16), jgh.astype(jnp.bfloat16)
    port = hist_level(torch.from_numpy(bins), tgh, torch.from_numpy(local),
                      torch.from_numpy(in_lvl), n_d, B).numpy()
    ref = np.asarray(jax_hist_level(jnp.asarray(bins), jgh,
                                    jnp.asarray(local), jnp.asarray(in_lvl),
                                    n_d, B, block_rows=128, interpret=True))
    return port, ref


def _ragged(rng, R, n_d):
    local = rng.integers(-1, n_d + 2, R).astype(np.int32)
    if n_d >= 4:
        local[local == 1] = 2              # node 1: empty
        one = np.where(local == 0)[0]
        if len(one) > 1:
            local[one[1:]] = 3             # node 0: a single row
    return local, (local >= 0) & (local < n_d)


def _skewed_bins(rng, R, F, B):
    """Four rows in five in bin B // 3, and feature 0 of three values."""
    bins = rng.integers(0, B, (R, F))
    bins[rng.uniform(size=(R, F)) < 0.8] = B // 3
    bins[:, 0] = rng.choice([0, B // 2, B - 1], size=R)
    return bins


@pytest.mark.parametrize("n_d,mode", [(1, "f32"), (4, "bf16"), (16, "f32"),
                                      (64, "f32"), (64, "bf16"),
                                      (16, "f32_u16"), (4, "bf16_u16"),
                                      (16, "int8_u16"),
                                      (16, "f32_u16_skewed"),
                                      (4, "int8_u16_skewed")])
def test_ragged_matches_jax_bit_for_bit(n_d, mode):
    rng = np.random.default_rng(7 + n_d)
    R, F = 3000, 7
    u16 = "_u16" in mode
    B = 300 if u16 else 64
    bins = (_skewed_bins(rng, R, F, B) if mode.endswith("_skewed")
            else rng.integers(0, B, (R, F))).astype(
        np.uint16 if u16 else np.uint8)
    gh = (rng.integers(-128, 128, (R, 3)).astype(np.int8)
          if mode.startswith("int8") else _dyadic_gh(rng, R))
    local, in_lvl = _ragged(rng, R, n_d)
    port, ref = _both(bins, gh, local, in_lvl, n_d, B,
                      bf16=mode.startswith("bf16"))
    assert port.shape == (n_d, F, B, 3)
    assert port.dtype == (np.int32 if mode.startswith("int8")
                          else np.float32)
    np.testing.assert_array_equal(port, ref)
    if n_d >= 4:
        assert np.all(port[1] == 0)        # the empty node is exact zeros


def test_normal_gh_within_f32_tolerance():
    rng = np.random.default_rng(3)
    R, F, B, n_d = 3000, 5, 32, 8
    bins = rng.integers(0, B, (R, F), dtype=np.uint8)
    gh = rng.normal(size=(R, 3)).astype(np.float32)
    local, in_lvl = _ragged(rng, R, n_d)
    port, ref = _both(bins, gh, local, in_lvl, n_d, B)
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-4)


def test_all_rows_one_node():
    rng = np.random.default_rng(11)
    R, F, B, n_d = 2000, 5, 32, 8
    bins = rng.integers(0, B, (R, F), dtype=np.uint8)
    gh = _dyadic_gh(rng, R)
    local = np.full(R, 5, np.int32)
    in_lvl = np.ones(R, bool)
    port, ref = _both(bins, gh, local, in_lvl, n_d, B)
    np.testing.assert_array_equal(port, ref)
    assert np.all(port[[0, 1, 2, 3, 4, 6, 7]] == 0)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_all_rows_out_of_the_level(quantized):
    rng = np.random.default_rng(13)
    R, F, B, n_d = 1000, 4, 32, 4
    bins = rng.integers(0, B, (R, F), dtype=np.uint8)
    gh = (rng.integers(-8, 8, (R, 3)).astype(np.int8) if quantized
          else _dyadic_gh(rng, R))
    local = np.zeros(R, np.int32)
    in_lvl = np.zeros(R, bool)
    port, ref = _both(bins, gh, local, in_lvl, n_d, B)
    assert np.all(port == 0) and np.all(ref == 0)


@pytest.mark.parametrize("n_d,bins_kind", [
    pytest.param(1, "u8", id="1"), pytest.param(16, "u8", id="16"),
    pytest.param(16, "u16_skewed", id="16-u16_skewed")])
def test_int8_exact(n_d, bins_kind):
    """Quantized int8 gh: exact int32 sums on both sides."""
    rng = np.random.default_rng(17)
    R, F = 3000, 6
    if bins_kind == "u8":
        B = 64
        bins = rng.integers(0, B, (R, F), dtype=np.uint8)
    else:
        B = 300
        bins = _skewed_bins(rng, R, F, B).astype(np.uint16)
    gh = rng.integers(-128, 128, (R, 3)).astype(np.int8)
    local = rng.integers(0, n_d, R).astype(np.int32)
    in_lvl = rng.uniform(size=R) < 0.9
    port, ref = _both(bins, gh, local, in_lvl, n_d, B)
    assert port.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(port, ref)


def test_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(19)
    R, F, B, n_d = 500, 3, 16, 4
    bins = torch.from_numpy(rng.integers(0, B, (R, F), dtype=np.uint8))
    gh = torch.from_numpy(_dyadic_gh(rng, R))
    local = torch.from_numpy(rng.integers(0, n_d, R))
    in_lvl = torch.ones(R, dtype=torch.bool)
    before = dict(hist_level_cuda.launches)
    out = hist_level_cuda(bins, gh, local, in_lvl, n_d, B)
    assert torch.equal(out, hist_level(bins, gh, local, in_lvl, n_d, B))
    assert hist_level_cuda.launches == before   # no kernel launched


@pytest.mark.parametrize("case", ["local_f32", "local_len", "in_lvl_int",
                                  "n_nodes_zero", "f64_gh", "u16_bins",
                                  "i32_bins"])
def test_wrapper_rejects_unsupported_input(case):
    R, F = 64, 4
    bins = torch.zeros((R, F), dtype=torch.uint8)
    gh = torch.zeros((R, 3), dtype=torch.float32)
    local = torch.zeros(R, dtype=torch.int64)
    in_lvl = torch.ones(R, dtype=torch.bool)
    n_nodes = 2
    if case == "local_f32":
        local = local.float()
    elif case == "local_len":
        local = local[:-1]
    elif case == "in_lvl_int":
        in_lvl = in_lvl.int()
    elif case == "n_nodes_zero":
        n_nodes = 0
    elif case == "f64_gh":
        gh = gh.double()
    num_bin = 16
    if case == "u16_bins":     # u16 bins (int16) take at most 2^16 bins
        bins = bins.to(torch.int16)
        num_bin = (1 << 16) + 1
    elif case == "i32_bins":
        bins = bins.to(torch.int32)
    with pytest.raises(ValueError):
        hist_level_cuda(bins, gh, local, in_lvl, n_nodes, num_bin)


# ---- the node order carried from level to level (no sort) ---------------

def _grow_orders(seed, R, depth, p_valid):
    """Random partitions down ``depth`` levels: at each level the carried
    ``(order, seg)`` and the stable sort of that level's keys, as pairs."""
    from lightgbm_tpu_torch.ops.hist_level import carry_order, node_order
    rng = np.random.default_rng(seed)
    heap = torch.zeros(R, dtype=torch.long)
    order, seg = torch.arange(R), torch.tensor([0, R])
    pairs = []
    for d in range(depth + 1):
        n = 1 << d
        local = heap - (n - 1)
        in_lvl = (local >= 0) & (local < n)
        pairs.append(((order, seg), node_order(local, in_lvl, n),
                      (local, in_lvl, n)))
        # nodes that do not split: their rows leave the level
        valid = torch.from_numpy(rng.uniform(size=n) < p_valid)
        go_left = torch.from_numpy(rng.uniform(size=R) < 0.4)
        descend = in_lvl & valid[torch.where(in_lvl, local, 0)]
        order, seg = carry_order(order, seg, local, go_left, descend)
        heap = torch.where(descend, 2 * heap + 1 + (~go_left).long(), heap)
    return pairs


@pytest.mark.parametrize("seed,R,depth,p_valid",
                         [(0, 1, 4, 1.0), (1, 37, 5, 0.6), (2, 1000, 7, 0.8),
                          (3, 2048, 10, 0.9), (4, 500, 6, 0.0)])
def test_carried_order_is_the_stable_sort(seed, R, depth, p_valid):
    """``carry_order`` gives, at every level, the permutation and segment
    bounds of ``torch.sort(level_keys(...), stable=True)`` (the JAX
    package's order, ``ops/hist_level_pallas.py:242``), rows that leave
    the level included (last, in row-id order)."""
    for d, (carried, ref, _) in enumerate(_grow_orders(seed, R, depth,
                                                        p_valid)):
        assert torch.equal(carried[0], ref[0]), d
        assert torch.equal(carried[1], ref[1]), d


def _hist_in_order(bins, gh, order, seg, B):
    """The level histogram from the rows in node order: node v's
    histogram over positions seg[v] .. seg[v + 1] - 1 of the gathered
    bins and gh (what the kernel reads)."""
    sb, sg = bins.index_select(0, order), gh.index_select(0, order)
    n = seg.shape[0] - 1
    return torch.stack([hist_rowmajor(sb[seg[v]:seg[v + 1]],
                                      sg[seg[v]:seg[v + 1]], B)
                        for v in range(n)])


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_wrapper_with_the_carried_order_gives_the_same_bits(mode):
    """On the levels of a random tree, ``hist_level_cuda`` with the
    carried order equals it without (which sorts itself) bit for bit, and
    so does the histogram of each node's rows gathered into the carried
    order (dyadic and int8 gh: exact in any order of adds)."""
    rng = np.random.default_rng(29)
    R, F, B = 1500, 5, 32
    bins = torch.from_numpy(rng.integers(0, B, (R, F), dtype=np.uint8))
    gh = torch.from_numpy(rng.integers(-128, 128, (R, 3)).astype(np.int8)
                          if mode == "int8" else _dyadic_gh(rng, R))
    for (order, seg), _, (local, in_lvl, n) in _grow_orders(5, R, 6, 0.85):
        with_order = hist_level_cuda(bins, gh, local, in_lvl, n, B,
                                     order=order, seg=seg)
        without = hist_level_cuda(bins, gh, local, in_lvl, n, B)
        assert torch.equal(with_order, without)
        assert torch.equal(_hist_in_order(bins, gh, order, seg, B),
                           without)


@pytest.mark.parametrize("case", ["order_alone", "seg_len", "order_i32",
                                  "seg_i32"])
def test_wrapper_rejects_a_bad_carried_order(case):
    R, F, n = 64, 4, 2
    bins = torch.zeros((R, F), dtype=torch.uint8)
    gh = torch.zeros((R, 3), dtype=torch.float32)
    local = torch.zeros(R, dtype=torch.int64)
    in_lvl = torch.ones(R, dtype=torch.bool)
    kw = dict(order=torch.arange(R), seg=torch.tensor([0, R, R]))
    if case == "order_alone":
        del kw["seg"]
    elif case == "seg_len":
        kw["seg"] = kw["seg"][:-1]
    elif case == "order_i32":
        kw["order"] = kw["order"].int()
    elif case == "seg_i32":
        kw["seg"] = kw["seg"].int()
    with pytest.raises(ValueError):
        hist_level_cuda(bins, gh, local, in_lvl, n, 16, **kw)


def test_level_phase_carries_the_sorted_order(monkeypatch):
    """Through a pure level tree and a hybrid one, the order and segments
    handed to the level histogram at every level are the stable sort of
    that level's keys."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.core import level_grower as tlevel
    from lightgbm_tpu_torch.ops.hist_level import node_order
    seen = []

    def checking(bins, gh, local, in_lvl, n_nodes, num_bin, *, order=None,
                 seg=None):
        ref = node_order(local, in_lvl, n_nodes)
        seen.append(n_nodes)
        assert torch.equal(order, ref[0]) and torch.equal(seg, ref[1])
        return hist_level_cuda(bins, gh, local, in_lvl, n_nodes, num_bin,
                               order=order, seg=seg)

    orig = tlevel.make_level_phase

    def phase_with(*a, **kw):
        kw["hist_fn"] = checking
        return orig(*a, **kw)

    monkeypatch.setattr(tlevel, "make_level_phase", phase_with)
    from lightgbm_tpu_torch.core import hybrid_grower
    monkeypatch.setattr(hybrid_grower, "make_level_phase", phase_with)
    rng = np.random.default_rng(31)
    X = rng.normal(size=(3000, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float32)
    for depth in (5, -1):
        seen.clear()
        lgt.train({"objective": "binary", "num_leaves": 31,
                   "max_depth": depth, "min_data_in_leaf": 40,
                   "device_type": "cpu", "verbosity": -1,
                   "tpu_row_scheduling": "level"},
                  lgt.Dataset(X, label=y), num_boost_round=2)
        assert seen and seen[:3] == [1, 2, 4]


def test_partition_wrapper_on_cpu_runs_the_plain_version():
    """``carry_order_cuda`` (the card's partition) takes ``carry_order``'s
    contract; on CPU tensors it is the plain version and counts no
    launch; it refuses what its kernels do not take."""
    from lightgbm_tpu_torch.ops.hist_level import carry_order
    from lightgbm_tpu_torch.ops.hist_level_cuda import carry_order_cuda
    before = carry_order_cuda.launches
    for (order, seg), _, (local, in_lvl, n) in _grow_orders(9, 700, 5, 0.8):
        rng = np.random.default_rng(n)
        go_left = torch.from_numpy(rng.uniform(size=700) < 0.5)
        descend = in_lvl & torch.from_numpy(rng.uniform(size=700) < 0.9)
        out = carry_order_cuda(order, seg, local, go_left, descend)
        ref = carry_order(order, seg, local, go_left, descend)
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert carry_order_cuda.launches == before
    with pytest.raises(ValueError):
        carry_order_cuda(order.int(), seg, local, go_left, descend)
    with pytest.raises(ValueError):
        carry_order_cuda(order, seg, local, go_left.int(), descend)
