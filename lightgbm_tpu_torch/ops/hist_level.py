"""Per-level histograms of every node at one depth, plain PyTorch version.

The contract of kernel K2 (``ops/hist_level_cuda.py``, port of
``lightgbm_tpu/ops/hist_level_pallas.py`` ``hist_level``; same function
as ``lightgbm_tpu/core/level_grower.py`` ``hist_level_scatter``):

    hist_level(bins_rm u8 [R, F], gh [R, 3], local int [R], in_lvl bool [R],
               n_nodes, num_bin) -> [n_nodes, F, num_bin, 3]

``local`` is each row's node within the level and ``in_lvl`` says which
rows are in the level at all (rows that left it add nothing). The mode
follows gh's dtype as for K1 (``ops/histogram.py``): float32 and bfloat16
gh give an f32 result, int8 gh an exact int32 one. Empty nodes are exact
zeros.

The plain version here serves CPU tensors and is what the card's kernel
is held against. It scatters one feature at a time into a
``[(n_nodes + 1) * num_bin, 3]`` accumulator (slot ``n_nodes`` collects
the rows out of the level), in float64 for f32 and bf16 gh (then rounded
once to f32, so its error is about half an ulp whatever the order of the
adds) and in int64 for int8 gh.
"""
from __future__ import annotations

import torch


def level_keys(local: torch.Tensor, in_lvl: torch.Tensor,
               n_nodes: int) -> torch.Tensor:
    """int64 node key of each row; ``n_nodes`` for rows out of the level."""
    return torch.where(in_lvl, local.long(),
                       torch.full_like(local, n_nodes, dtype=torch.long))


def hist_level(bins_rm: torch.Tensor, gh: torch.Tensor, local: torch.Tensor,
               in_lvl: torch.Tensor, n_nodes: int,
               num_bin: int) -> torch.Tensor:
    R, F = bins_rm.shape
    C = gh.shape[1]
    dev = bins_rm.device
    quantized = gh.dtype == torch.int8
    acc = torch.int64 if quantized else torch.float64
    vals = gh.to(acc) if quantized else gh.to(torch.float32).to(acc)
    base = level_keys(local, in_lvl, n_nodes) * num_bin
    out = torch.zeros(F, (n_nodes + 1) * num_bin, C, dtype=acc, device=dev)
    for f in range(F):
        out[f].index_add_(0, base + bins_rm[:, f].long(), vals)
    out = out.reshape(F, n_nodes + 1, num_bin, C)[:, :n_nodes]
    return out.permute(1, 0, 2, 3).contiguous().to(
        torch.int32 if quantized else torch.float32)
