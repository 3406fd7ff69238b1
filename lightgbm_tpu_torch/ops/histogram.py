"""Histogram construction, plain PyTorch versions.

Port of ``lightgbm_tpu/ops/histogram.py`` ``hist_rowmajor`` and
``hist_xla`` (ref: include/LightGBM/bin.h:351-422
Bin::ConstructHistogram): the histogram of (grad, hess, count) over a
ROW-major ``[S, F]`` block of bins — one leaf's rows, gathered
contiguously by the compact grower — and over FEATURE-major ``[F, R]``
bins of all rows, with gh masked to one leaf — the full/leaf scheduler's
pass. These are the contracts of kernels K1 and B2
(``ops/hist_cuda.py``); the functions here are their plain versions,
which serve CPU tensors and are what the card's kernels are held against.

The mode follows gh's dtype, as in the JAX package: float32 gh give an
f32 histogram; bfloat16 gh (the ``tpu_hist_dtype=bfloat16`` path, gh
rounded to bf16 once) are widened to f32, exactly, and summed as f32;
int8 gh (quantized gradients) are summed exactly into int32.
"""
from __future__ import annotations

import torch

# rows per partial histogram of the plain version
CHUNK_ROWS = 4096


def hist_rowmajor(bins_rm: torch.Tensor, gh: torch.Tensor,
                  num_bin: int) -> torch.Tensor:
    """``hist[f, b, c] = sum_r gh[r, c] * [bins_rm[r, f] == b]``.

    Parameters
    ----------
    bins_rm : uint8 [S, F] row-major bin indices (< num_bin).
    gh : [S, C] per-row values, typically (grad, hess, count): float32,
        bfloat16 or int8.
    num_bin : B, the histogram width.

    Returns [F, num_bin, C]: int32 for int8 gh (an exact integer
    scatter), else f32, accumulated in f32: a scatter-add of each chunk
    of ``CHUNK_ROWS`` rows into its own partial histogram, then a sum
    over the partials. A single scatter over a million rows adds
    thousands of values into each slot one after another, and its
    rounding error grows with them; the two-level sum keeps the error at
    a few ulp, so the plain version is a sound yardstick for the kernel.
    """
    S, F = bins_rm.shape
    C = gh.shape[1]
    dev = bins_rm.device
    if gh.dtype == torch.int8:
        slot = bins_rm.long() + torch.arange(F, device=dev) * num_bin
        out = torch.zeros(F * num_bin, C, dtype=torch.int32, device=dev)
        out.index_add_(0, slot.reshape(-1),
                       gh.to(torch.int32).repeat_interleave(F, dim=0))
        return out.reshape(F, num_bin, C)
    n_chunks = max(-(-S // CHUNK_ROWS), 1)
    # flat (chunk, feature, bin) slot of every cell, then one scatter-add
    # over the [n_chunks * F * B, C] accumulator
    chunk = torch.arange(S, device=dev) // CHUNK_ROWS
    slot = (bins_rm.long() + torch.arange(F, device=dev) * num_bin
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
    feature-major uint8 ``[F, R]`` bins (any row stride) and gh ``[R, C]``
    (float32, or int8 summed exactly into int32), which arrives already
    masked to the leaf: rows outside it carry zeros. The same chunked
    two-level sum as ``hist_rowmajor``, over the transposed view."""
    return hist_rowmajor(bins_fm.T, gh, num_bin)
