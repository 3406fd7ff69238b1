"""The feature-major histogram of the full/leaf row scheduler (kernel B2's
contract) in the PyTorch port against the JAX package.

The port's plain version ``hist_featmajor`` takes uint8 ``[F, R]`` bins
(or uint16 ones, held as int16 or given as ``torch.uint16``) and gh
``[R, 3]`` already masked to a leaf, as the JAX package's
``hist_pallas`` (run here in the Pallas interpreter, as its own tests run
it) and ``hist_xla`` do. int8 gh sum exactly into int32, and dyadic f32
gh (k / 8) make every partial sum exact, so those agree bit for bit. For
normal f32 gh the three sum in different orders: each slot is held to
``1e-5 * sum |gh|`` of its channel, the rounding of an f32 sum over all
rows, plus ``rtol=1e-5``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.hist_pallas import fit_tiles, hist_pallas
from lightgbm_tpu.ops.histogram import hist_xla
from lightgbm_tpu_torch.ops.hist_cuda import (feature_major_bins,
                                              hist_cuda_fm, hist_cuda_rm)
from lightgbm_tpu_torch.ops.histogram import hist_featmajor, hist_rowmajor

# (F, R, B): the shapes of tests/test_hist_pallas.py, a ragged R at
# B = 255 (the bench's bins), and u16 bins at B = 300
SHAPES = [(8, 4096, 64), (11, 3000, 63), (3, 500, 256), (5, 1037, 255),
          (3, 1000, 300)]


def _inputs(rng, F, R, B, kind, dist="uniform"):
    """Feature-major bins and gh; ``dist="skewed"``: four rows in five in
    bin B // 3, and feature 0 of three values (the skew the card's wide
    body sums in f64 registers)."""
    bins = rng.integers(0, B, size=(F, R))
    if dist == "skewed":
        bins[rng.uniform(size=(F, R)) < 0.8] = B // 3
        bins[0] = rng.choice([0, B // 2, B - 1], size=R)
    bins = bins.astype(np.uint8 if B <= 256 else np.uint16)
    if kind == "int8":
        gh = rng.integers(-128, 128, size=(R, 3)).astype(np.int8)
    elif kind == "dyadic":
        gh = (rng.integers(-64, 65, size=(R, 3)) / 8).astype(np.float32)
    else:
        gh = rng.normal(size=(R, 3)).astype(np.float32)
    return bins, gh


@pytest.mark.parametrize("kind", ["int8", "dyadic", "normal"])
@pytest.mark.parametrize("F,R,B", SHAPES)
def test_plain_matches_jax_pallas_and_xla(rng, F, R, B, kind):
    bins, gh = _inputs(rng, F, R, B, kind)
    out = hist_featmajor(torch.from_numpy(bins), torch.from_numpy(gh),
                         B).numpy()
    assert out.shape == (F, B, 3)
    assert out.dtype == (np.int32 if kind == "int8" else np.float32)
    pallas = np.asarray(hist_pallas(jnp.asarray(bins), jnp.asarray(gh), B,
                                    block_rows=512, feature_tile=4,
                                    interpret=True))
    xla = np.asarray(hist_xla(jnp.asarray(bins), jnp.asarray(gh), B,
                              block_rows=512))
    for ref in (pallas, xla):
        assert ref.dtype == out.dtype
        if kind == "normal":
            atol = 1e-5 * np.abs(gh).sum(axis=0)
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=atol.max())
        else:
            np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("kind", ["int8", "normal"])
def test_masked_rows_are_invisible(rng, kind):
    """gh masked to one leaf (the full path's ``gh * (leaf_id == s)``)
    gives the histogram of that leaf's rows alone."""
    F, R, B = 6, 2000, 32
    bins, gh = _inputs(rng, F, R, B, kind)
    leaf = rng.integers(0, 4, size=R)
    gh_t = torch.from_numpy(gh)
    mask = torch.from_numpy(leaf == 2)
    out = hist_featmajor(torch.from_numpy(bins),
                         gh_t * mask[:, None].to(gh_t.dtype), B)
    rows = np.flatnonzero(leaf == 2)
    ref = hist_rowmajor(torch.from_numpy(np.ascontiguousarray(
        bins[:, rows].T)), gh_t[rows], B)
    if kind == "int8":
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    else:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_wrapper_on_cpu_runs_the_plain_version(rng):
    """On a CPU tensor ``hist_cuda_fm`` is the plain version, counts no
    launch, reads a padded device copy (row stride > R, a multiple of 16
    elements; u16 bins held as int16) as its [F, R] view, and refuses
    bf16 gh and a non-unit column stride."""
    F, R = 5, 1037
    before = dict(hist_cuda_fm.launches)
    for B in (255, 300):
        bins, gh = _inputs(rng, F, R, B, "normal")
        padded = feature_major_bins(np.ascontiguousarray(bins.T),
                                    torch.device("cpu"))
        assert padded.shape == (F, R) and padded.stride(0) % 16 == 0
        assert padded.stride(0) > R
        assert padded.dtype == (torch.uint8 if B <= 256 else torch.int16)
        np.testing.assert_array_equal(padded.numpy().view(bins.dtype), bins)
        gh_t = torch.from_numpy(gh)
        out = hist_cuda_fm(padded, gh_t, B)
        torch.testing.assert_close(
            out, hist_featmajor(torch.from_numpy(bins), gh_t, B), rtol=0,
            atol=0)
        # the same function as K1 over the transposed block
        torch.testing.assert_close(
            out, hist_cuda_rm(torch.from_numpy(np.ascontiguousarray(bins.T)),
                              gh_t, B), rtol=0, atol=0)
    assert hist_cuda_fm.launches == before == {
        "f32": 0, "int8": 0, "f32_u16": 0, "int8_u16": 0}
    with pytest.raises(ValueError, match="float32 or int8"):
        hist_cuda_fm(padded, gh_t.to(torch.bfloat16), B)
    with pytest.raises(ValueError, match="stride"):
        hist_cuda_fm(torch.from_numpy(np.ascontiguousarray(bins.T)).T[:, ::2],
                     gh_t[::2].contiguous(), B)


@pytest.mark.parametrize("kind", ["int8", "dyadic", "normal"])
@pytest.mark.parametrize("leaf_rows", [0, 1, 97, 4000])
def test_fused_leaf_mask_equals_the_masked_form(rng, kind, leaf_rows):
    """``hist_cuda_fm(bins, gh, B, leaf_id=, leaf=)`` (the mask fused) on
    the plain route equals the masked form ``hist_featmajor(bins, gh *
    (leaf_id == leaf))`` bit for bit, from an empty leaf to all rows, on
    the engine's padded device copy."""
    F, R, B = 7, 4000, 255
    bins, gh = _inputs(rng, F, R, B, kind)
    gh[:, 2] = 1                       # the count channel
    leaf_id = torch.from_numpy(rng.integers(1, 9, R))
    leaf_id[torch.from_numpy(rng.permutation(R)[:leaf_rows])] = 0
    padded = feature_major_bins(np.ascontiguousarray(bins.T),
                                torch.device("cpu"))
    gh_t = torch.from_numpy(gh)
    mask = (leaf_id == 0)[:, None].to(gh_t.dtype)
    out = hist_cuda_fm(padded, gh_t, B, leaf_id=leaf_id, leaf=0)
    ref = hist_featmajor(torch.from_numpy(bins), gh_t * mask, B)
    assert torch.equal(out, ref)
    assert int(out[0, :, 2].sum()) == leaf_rows


@pytest.mark.parametrize("case", ["leaf_alone", "leaf_id_i32", "leaf_id_len",
                                  "negative_leaf", "leaf_id_2d"])
def test_fused_form_rejects_unsupported_input(case):
    F, R, B = 3, 64, 16
    bins = torch.zeros((F, R), dtype=torch.uint8)
    gh = torch.zeros((R, 3), dtype=torch.float32)
    kw = dict(leaf_id=torch.zeros(R, dtype=torch.int64), leaf=0)
    if case == "leaf_alone":
        del kw["leaf_id"]
    elif case == "leaf_id_i32":
        kw["leaf_id"] = kw["leaf_id"].int()
    elif case == "leaf_id_len":
        kw["leaf_id"] = kw["leaf_id"][:-1]
    elif case == "negative_leaf":
        kw["leaf"] = -1
    elif case == "leaf_id_2d":
        kw["leaf_id"] = kw["leaf_id"][:, None]
    with pytest.raises(ValueError):
        hist_cuda_fm(bins, gh, B, **kw)


@pytest.mark.parametrize("kind", ["int8", "dyadic", "normal"])
@pytest.mark.parametrize("leaf_rows", [0, 1, 97, 4000])
@pytest.mark.parametrize("dist", ["uniform", "skewed"])
@pytest.mark.parametrize("B", [1023, 4095])
def test_u16_fused_leaf_mask_matches_jax(rng, B, dist, leaf_rows, kind):
    """B2's contract over u16 bins (the card's wide path): the fused form
    on the engine's padded device copy, from an empty leaf to every row,
    against the JAX package's ``hist_pallas`` of gh masked to the leaf. At
    1,023 bins that is the Pallas kernel in the interpreter; at 4,095 it
    is the ``hist_xla`` that ``hist_pallas`` falls back to, since
    ``fit_tiles`` finds no tile for that many bins. int8 and dyadic gh
    agree bit for bit; normal f32 gh within the rounding of an f32 sum
    over all rows."""
    F, R = 3, 4000
    bins, gh = _inputs(rng, F, R, B, kind, dist)
    gh[:, 2] = 1                       # the count channel
    leaf_id = rng.integers(1, 9, R)
    leaf_id[rng.permutation(R)[:leaf_rows]] = 0
    padded = feature_major_bins(np.ascontiguousarray(bins.T),
                                torch.device("cpu"))
    out = hist_cuda_fm(padded, torch.from_numpy(gh), B,
                       leaf_id=torch.from_numpy(leaf_id), leaf=0).numpy()
    masked = gh * (leaf_id == 0)[:, None].astype(gh.dtype)
    assert fit_tiles(4, B, 512)[2] == (B == 1023)
    ref = np.asarray(hist_pallas(jnp.asarray(bins), jnp.asarray(masked), B,
                                 block_rows=512, feature_tile=4,
                                 interpret=True))
    assert out.shape == ref.shape == (F, B, 3) and out.dtype == ref.dtype
    if kind == "normal":
        atol = 1e-5 * np.abs(masked).sum(axis=0)
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=atol.max())
    else:
        np.testing.assert_array_equal(out, ref)
    assert int(out[0, :, 2].sum()) == leaf_rows
