"""Histogram construction, plain PyTorch version.

Port of ``lightgbm_tpu/ops/histogram.py`` ``hist_rowmajor`` (ref:
include/LightGBM/bin.h:351-422 Bin::ConstructHistogram): the histogram of
(grad, hess, count) over a ROW-major ``[S, F]`` block of bins — one
leaf's rows, gathered contiguously by the compact grower. This is the
contract of kernel K1 (``ops/hist_cuda.py``); the function here is its
plain version, which serves CPU tensors and is what the card's kernel is
held against.
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
    gh : f32 [S, C] per-row values, typically (grad, hess, count).
    num_bin : B, the histogram width.

    Returns f32 [F, num_bin, C], accumulated in f32: a scatter-add of
    each chunk of ``CHUNK_ROWS`` rows into its own partial histogram,
    then a sum over the partials. A single scatter over a million rows
    adds thousands of values into each slot one after another, and its
    rounding error grows with them; the two-level sum keeps the error at
    a few ulp, so the plain version is a sound yardstick for the kernel.
    """
    S, F = bins_rm.shape
    C = gh.shape[1]
    dev = bins_rm.device
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
