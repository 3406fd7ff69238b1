"""Kernel K2's contract in the PyTorch port against the JAX package.

The port's ``ops/hist_level.hist_level`` is the plain version of the
hand-written CUDA kernel (``lightgbm_tpu_torch/csrc/hist_level.cu``); the
wrapper ``hist_level_cuda`` runs it for CPU tensors. Both are held
against the JAX package's Pallas kernel ``hist_level`` (run in interpret
mode, as tests/test_hist_level.py runs it) on the cases of that file:
ragged segments with an empty and a single-row node, all rows in one
node, all rows out of the level, and quantized int8 gh.

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


@pytest.mark.parametrize("n_d,mode", [(1, "f32"), (4, "bf16"), (16, "f32"),
                                      (64, "f32"), (64, "bf16")])
def test_ragged_matches_jax_bit_for_bit(n_d, mode):
    rng = np.random.default_rng(7 + n_d)
    R, F, B = 3000, 7, 64
    bins = rng.integers(0, B, (R, F), dtype=np.uint8)
    gh = _dyadic_gh(rng, R)
    local, in_lvl = _ragged(rng, R, n_d)
    port, ref = _both(bins, gh, local, in_lvl, n_d, B, bf16=mode == "bf16")
    assert port.shape == (n_d, F, B, 3) and port.dtype == np.float32
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


@pytest.mark.parametrize("n_d", [1, 16])
def test_int8_exact(n_d):
    """Quantized int8 gh: exact int32 sums on both sides."""
    rng = np.random.default_rng(17)
    R, F, B = 3000, 6, 64
    bins = rng.integers(0, B, (R, F), dtype=np.uint8)
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
                                  "n_nodes_zero", "f64_gh", "u16_bins"])
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
    elif case == "u16_bins":
        bins = bins.to(torch.int16)
    with pytest.raises(ValueError):
        hist_level_cuda(bins, gh, local, in_lvl, n_nodes, 16)
