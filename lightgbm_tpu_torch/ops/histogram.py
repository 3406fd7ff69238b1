"""Histogram construction, plain PyTorch versions.

Port of ``lightgbm_tpu/ops/histogram.py`` ``hist_rowmajor`` and
``hist_scatter`` (ref: include/LightGBM/bin.h:351-422
Bin::ConstructHistogram): the histogram of (grad, hess, count) over a
ROW-major ``[S, F]`` block of bins — one leaf's rows, gathered
contiguously by the compact grower — and over FEATURE-major ``[F, R]``
bins of all rows, with gh masked to one leaf — the full/leaf scheduler's
pass. These are the contracts of kernels K1 and B2
(``ops/hist_cuda.py``); the functions here are their plain versions,
which serve CPU tensors and are what the card's kernels are held against.

Bins are uint8, or u16 bins (``max_bin > 256``) held as int16 with the
same bits (``bin_ids`` reads them back; torch's CPU has no comparisons on
``torch.uint16``, so the port stores u16 bins under int16 everywhere).

The mode follows gh's dtype, as in the JAX package: float32 gh give an
f32 histogram; bfloat16 gh (the ``tpu_hist_dtype=bfloat16`` path, gh
rounded to bf16 once) are widened to f32, exactly, and summed as f32;
int8 gh (quantized gradients) are summed exactly into int32.
"""
from __future__ import annotations

import torch

# rows per partial histogram of the chunked yardstick
CHUNK_ROWS = 4096
# the dtypes that hold bins: uint8, and int16 holding u16 bins' bits
BIN_DTYPES = (torch.uint8, torch.int16)


def bin_ids(bins: torch.Tensor) -> torch.Tensor:
    """int64 bin numbers of uint8 bins, or of u16 bins held as int16 (or
    as ``torch.uint16``): the 16 bits read as unsigned."""
    if bins.dtype == torch.uint8:
        return bins.long()
    if bins.dtype in (torch.int16, torch.uint16):
        return bins.view(torch.int16).long() & 0xFFFF
    raise ValueError(f"bins must be uint8 or 16-bit; got {bins.dtype}")


def as_bin_storage(bins: torch.Tensor) -> torch.Tensor:
    """``bins`` under the port's bin dtypes: a ``torch.uint16`` tensor
    viewed as int16 (the same bits), anything else unchanged."""
    return bins.view(torch.int16) if bins.dtype == torch.uint16 else bins


def hist_rowmajor(bins_rm: torch.Tensor, gh: torch.Tensor,
                  num_bin: int) -> torch.Tensor:
    """``hist[f, b, c] = sum_r gh[r, c] * [bins_rm[r, f] == b]``.

    Parameters
    ----------
    bins_rm : uint8 (or u16 as int16) [S, F] row-major bin indices
        (< num_bin).
    gh : [S, C] per-row values, typically (grad, hess, count): float32,
        bfloat16 or int8.
    num_bin : B, the histogram width.

    Returns [F, num_bin, C]: int32 for int8 gh (an exact integer
    scatter), else f32: one scatter-add, every slot's rows added one
    after another in row order from 0.0, which is the order of the JAX
    package's CPU formulation (``hist_scatter``, one XLA scatter), so
    the CPU training route builds its histograms bit for bit.
    """
    return _scatter(bins_rm, gh, num_bin, None)


def hist_rowmajor_chunked(bins_rm: torch.Tensor, gh: torch.Tensor,
                          num_bin: int) -> torch.Tensor:
    """``hist_rowmajor``'s function, summed in two levels: each chunk of
    ``CHUNK_ROWS`` rows scattered into its own partial histogram, then a
    tree sum over the partials. One scatter over a million rows adds
    thousands of values into each slot one after another, and its
    rounding error grows with them; the two-level sum keeps the error at
    a few ulp, so it is the yardstick the card's kernels are held
    against at full size (``chip_smoke.py``). int8 gh sum exactly either
    way."""
    return _scatter(bins_rm, gh, num_bin, CHUNK_ROWS)


def _scatter(bins_rm, gh, num_bin, chunk_rows):
    S, F = bins_rm.shape
    C = gh.shape[1]
    dev = bins_rm.device
    ids = bin_ids(bins_rm)
    if gh.dtype == torch.int8:
        slot = ids + torch.arange(F, device=dev) * num_bin
        out = torch.zeros(F * num_bin, C, dtype=torch.int32, device=dev)
        out.index_add_(0, slot.reshape(-1),
                       gh.to(torch.int32).repeat_interleave(F, dim=0))
        return out.reshape(F, num_bin, C)
    rows = max(S, 1) if chunk_rows is None else chunk_rows
    n_chunks = max(-(-S // rows), 1)
    # flat (chunk, feature, bin) slot of every cell, then one scatter-add
    # over the [n_chunks * F * B, C] accumulator
    chunk = torch.arange(S, device=dev) // rows
    slot = (ids + torch.arange(F, device=dev) * num_bin
            + (chunk * (F * num_bin))[:, None])
    vals = gh.to(torch.float32).repeat_interleave(F, dim=0)
    out = torch.zeros(n_chunks * F * num_bin, C, dtype=torch.float32,
                      device=dev)
    out.scatter_add_(0, slot.reshape(-1, 1).expand(S * F, C), vals)
    if n_chunks == 1:
        return out.reshape(F, num_bin, C)
    # the chunk axis innermost, so the sum over it is a tree reduction
    parts = out.reshape(n_chunks, F * num_bin * C).T.contiguous()
    return parts.sum(dim=1).reshape(F, num_bin, C)


def hist_featmajor(bins_fm: torch.Tensor, gh: torch.Tensor,
                   num_bin: int) -> torch.Tensor:
    """``hist[f, b, c] = sum_r gh[r, c] * [bins_fm[f, r] == b]`` over
    feature-major ``[F, R]`` bins (uint8, or u16 as int16; any row stride)
    and gh ``[R, C]`` (float32, or int8 summed exactly into int32), which
    arrives already masked to the leaf: rows outside it carry zeros.
    ``hist_rowmajor`` over the transposed view."""
    return hist_rowmajor(bins_fm.T, gh, num_bin)


def hist_featmajor_chunked(bins_fm: torch.Tensor, gh: torch.Tensor,
                           num_bin: int) -> torch.Tensor:
    """``hist_featmajor`` summed as ``hist_rowmajor_chunked`` sums."""
    return hist_rowmajor_chunked(bins_fm.T, gh, num_bin)
