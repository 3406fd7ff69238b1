"""Kernel K1's contract in the PyTorch port against the JAX package.

The port's ``hist_rowmajor`` is the plain version of the hand-written
CUDA kernel (``lightgbm_tpu_torch/csrc/hist_rowmajor.cu``); the wrapper
``hist_cuda_rm`` runs it for CPU tensors. Both are held against the JAX
package's Pallas kernel ``hist_pallas_rm`` (run in interpret mode, as
tests/test_hist_pallas.py runs it) and its ``hist_scatter``, in the
kernel's three modes: f32, int8 (exact int32 sums, so bit for bit) and
bf16 (gh rounded to bf16 once, f32 sums), over uint8 bins and, at 300
bins, uint16 ones (the port holds them as int16; a ``torch.uint16``
tensor is taken as its int16 view). The kernel itself runs only on the
card and is held against the plain version by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.hist_pallas import hist_pallas_rm
from lightgbm_tpu.ops.histogram import hist_rowmajor as jax_hist_rowmajor
from lightgbm_tpu.ops.histogram import hist_scatter
from lightgbm_tpu_torch.ops.hist_cuda import hist_cuda_rm
from lightgbm_tpu_torch.ops.histogram import (CHUNK_ROWS, hist_rowmajor,
                                               hist_rowmajor_chunked)

# (S, F, B): u8 shapes, and u16 bins at 300 (a width the interpreter
# runs quickly)
SHAPES = [(4096, 8, 64), (3000, 11, 63), (500, 3, 256), (1000, 3, 300)]


def _port_bins(bins):
    """The port's tensor of numpy bins: uint8, or uint16 as int16."""
    return torch.from_numpy(bins.view(np.int16) if bins.dtype == np.uint16
                            else bins)


def _inputs(rng, S, F, B, dyadic):
    bins = rng.integers(0, B, size=(S, F)).astype(
        np.uint8 if B <= 256 else np.uint16)
    if dyadic:
        gh = rng.integers(-16, 17, size=(S, 3)).astype(np.float32) / 4
    else:
        gh = rng.normal(size=(S, 3)).astype(np.float32)
    return bins, gh


def _jax_refs(bins, gh, B):
    pallas = np.asarray(hist_pallas_rm(jnp.asarray(bins), jnp.asarray(gh), B,
                                       block_rows=512, feature_tile=8,
                                       interpret=True))
    scatter = np.asarray(hist_scatter(jnp.asarray(bins.T), jnp.asarray(gh),
                                      B))
    return pallas, scatter


@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "normal"])
@pytest.mark.parametrize("S,F,B", SHAPES)
def test_plain_matches_jax_pallas_and_scatter(rng, S, F, B, dyadic):
    bins, gh = _inputs(rng, S, F, B, dyadic)
    out = hist_rowmajor(_port_bins(bins), torch.from_numpy(gh), B).numpy()
    assert out.shape == (F, B, 3) and out.dtype == np.float32
    pallas, scatter = _jax_refs(bins, gh, B)
    if dyadic:
        # every partial sum is exact: any summation order gives these bits
        np.testing.assert_array_equal(out, pallas)
        np.testing.assert_array_equal(out, scatter)
    else:
        np.testing.assert_allclose(out, pallas, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(out, scatter, rtol=1e-5, atol=1e-4)


def test_plain_chunked_sum_matches_scatter(rng):
    """More rows than one partial histogram of the chunked yardstick
    holds: the plain version adds each slot's rows in row order, as the
    JAX package's ``hist_scatter`` does, so it gives its bits (ROADMAP
    C1(c)); the chunked two-level sum equals them for dyadic gh and
    within f32 reassociation otherwise."""
    S, F, B = 3 * CHUNK_ROWS + 17, 5, 32
    for dyadic in (True, False):
        bins, gh = _inputs(rng, S, F, B, dyadic)
        out = hist_rowmajor(torch.from_numpy(bins), torch.from_numpy(gh),
                            B).numpy()
        chunked = hist_rowmajor_chunked(torch.from_numpy(bins),
                                        torch.from_numpy(gh), B).numpy()
        ref = np.asarray(hist_scatter(jnp.asarray(bins.T), jnp.asarray(gh),
                                      B))
        np.testing.assert_array_equal(out, ref)
        if dyadic:
            np.testing.assert_array_equal(chunked, ref)
        else:
            np.testing.assert_allclose(chunked, ref, rtol=1e-5, atol=1e-4)


def test_zero_mass_rows_are_invisible(rng):
    """Rows with gh = 0 (leaf padding in the JAX grower) add nothing."""
    S, F, B = 2048, 4, 32
    bins, gh = _inputs(rng, S, F, B, dyadic=False)
    keep = rng.uniform(size=S) < 0.5
    masked = gh * keep[:, None].astype(np.float32)
    out = hist_rowmajor(torch.from_numpy(bins), torch.from_numpy(masked),
                        B).numpy()
    ref = hist_rowmajor(torch.from_numpy(bins[keep].copy()),
                        torch.from_numpy(gh[keep].copy()), B).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(out[:, :, 2], ref[:, :, 2])


@pytest.mark.parametrize("S,F,B", SHAPES)
def test_plain_int8_matches_jax_pallas_bit_for_bit(rng, S, F, B):
    """Quantized gh: exact int32 sums, so any order gives these bits."""
    bins, _ = _inputs(rng, S, F, B, dyadic=True)
    ghq = rng.integers(-128, 128, size=(S, 3)).astype(np.int8)
    out = hist_rowmajor(_port_bins(bins), torch.from_numpy(ghq), B).numpy()
    assert out.shape == (F, B, 3) and out.dtype == np.int32
    pallas, scatter = _jax_refs(bins, ghq, B)
    assert pallas.dtype == np.int32
    np.testing.assert_array_equal(out, pallas)
    np.testing.assert_array_equal(out, scatter)


@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "normal"])
def test_plain_bf16_matches_jax_bf16_mode(rng, dyadic):
    """bf16 mode: the port rounds gh to bf16 once (torch's
    round-to-nearest-even, as jnp's astype) and sums in f32; the JAX
    package's ``hist_rowmajor(dtype="bfloat16")`` does the same on its
    einsum path. Dyadic gh with few bits are exact in bf16 and their sums
    exact in f32, so those agree bit for bit; normal gh agree within f32
    reassociation (rtol=1e-5, atol=1e-4, sums of up to 4,096 values of
    magnitude ~1)."""
    S, F, B = 4096, 8, 64
    bins, gh = _inputs(rng, S, F, B, dyadic)
    out = hist_rowmajor(torch.from_numpy(bins),
                        torch.from_numpy(gh).to(torch.bfloat16), B).numpy()
    assert out.dtype == np.float32
    ref = np.asarray(jax_hist_rowmajor(jnp.asarray(bins), jnp.asarray(gh), B,
                                       dtype="bfloat16", backend="einsum"))
    if dyadic:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)
        # and it is not the f32 histogram: the rounding happened
        f32 = hist_rowmajor(torch.from_numpy(bins), torch.from_numpy(gh),
                            B).numpy()
        assert np.abs(out - f32).max() > 1e-3


def test_wrapper_on_cpu_runs_the_plain_version(rng):
    before = dict(hist_cuda_rm.launches)
    for B in (40, 300):
        bins, gh = _inputs(rng, 1000, 6, B, dyadic=False)
        for g in (torch.from_numpy(gh),
                  torch.from_numpy(gh).to(torch.bfloat16),
                  torch.from_numpy(gh * 8).to(torch.int8)):
            out = hist_cuda_rm(_port_bins(bins), g, B)
            ref = hist_rowmajor(_port_bins(bins), g, B)
            assert torch.equal(out, ref)
            if B > 256:        # a torch.uint16 tensor: its int16 view
                assert torch.equal(hist_cuda_rm(torch.from_numpy(bins), g,
                                                B), ref)
    assert hist_cuda_rm.launches == before   # no kernel launched


@pytest.mark.parametrize("case", [
    "u16_bins", "num_bin_over_256", "num_bin_zero", "f64_gh",
    "gh_channels", "row_mismatch", "non_contiguous", "bins_1d", "i16_gh",
    "gh_non_contiguous", "i32_bins"])
def test_wrapper_rejects_unsupported_input(case):
    S, F = 64, 4
    bins = torch.zeros((S, F), dtype=torch.uint8)
    gh = torch.zeros((S, 3), dtype=torch.float32)
    num_bin = 16
    if case == "u16_bins":     # u16 bins (int16) take at most 2^16 bins
        bins = bins.to(torch.int16)
        num_bin = (1 << 16) + 1
    elif case == "num_bin_over_256":     # uint8 bins at most 256
        num_bin = 257
    elif case == "i32_bins":
        bins = bins.to(torch.int32)
    elif case == "num_bin_zero":
        num_bin = 0
    elif case == "f64_gh":
        gh = gh.double()
    elif case == "gh_channels":
        gh = torch.zeros((S, 2), dtype=torch.float32)
    elif case == "row_mismatch":
        gh = torch.zeros((S + 1, 3), dtype=torch.float32)
    elif case == "non_contiguous":
        bins = torch.zeros((F, S), dtype=torch.uint8).T
    elif case == "bins_1d":
        bins = torch.zeros(S, dtype=torch.uint8)
    elif case == "i16_gh":
        gh = gh.to(torch.int16)
    elif case == "gh_non_contiguous":
        gh = torch.zeros((3, S), dtype=torch.int8).T
    with pytest.raises(ValueError):
        hist_cuda_rm(bins, gh, num_bin)
