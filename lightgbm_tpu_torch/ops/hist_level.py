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


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """[n + 1] int64: 0, x[0], x[0] + x[1], ..."""
    out = torch.zeros(x.shape[0] + 1, dtype=torch.long, device=x.device)
    torch.cumsum(x, 0, out=out[1:])
    return out


def node_order(local: torch.Tensor, in_lvl: torch.Tensor, n_nodes: int):
    """``(order, seg)`` of one level from its row keys: the row ids in
    node order (a stable sort of ``level_keys``, as the JAX function
    sorts them, ``ops/hist_level_pallas.py:242``; rows out of the level
    last) and node v's positions ``seg[v] .. seg[v + 1] - 1``."""
    keys, order = torch.sort(level_keys(local, in_lvl, n_nodes), stable=True)
    seg = torch.searchsorted(keys, torch.arange(n_nodes + 1,
                                                device=keys.device))
    return order, seg


def carry_order(order: torch.Tensor, seg: torch.Tensor, local: torch.Tensor,
                go_left: torch.Tensor, descend: torch.Tensor):
    """The next level's ``(order, seg)`` from this level's, without a sort.

    ``order``/``seg`` are this level's (``node_order``'s contract),
    ``local`` each row's node in it, and ``descend``/``go_left`` (bool
    ``[R]`` by row id) which rows move down and to which child. Node v's
    children are 2v and 2v + 1 of the next level, so each parent's
    segment is partitioned stably, its left rows then its right rows, in
    node order; the rows that leave the level (``~descend``) go last, in
    row-id order. Exclusive cumulative sums of the left and right flags
    over the positions give every row its place and the new segment
    bounds, and one scatter writes the order: O(R). The result is the
    permutation ``node_order`` gives for the next level's keys."""
    R = order.shape[0]
    n = seg.shape[0] - 1
    dev = order.device
    desc = descend[order]
    left = desc & go_left[order]                   # by position
    right = desc & ~left
    cl = _exclusive_cumsum(left)                   # [R + 1]
    cr = _exclusive_cumsum(right)
    a, b = cl[seg], cr[seg]                        # at the segment bounds
    # child 2v starts after every descending row of the parents before v;
    # child 2v + 1 after the left rows of v too
    new_seg = torch.cat([torch.stack([a[:-1] + b[:-1], a[1:] + b[:-1]],
                                     1).reshape(-1), a[-1:] + b[-1:]])
    v = local[order].clamp(0, n - 1)               # node of each position
    dest = torch.where(left, cl[:-1] + b[v], a[v + 1] + cr[:-1])
    # rows out of the next level: after the others, in row-id order
    tail = new_seg[-1] + _exclusive_cumsum(~descend)[:-1]
    dest_row = tail.scatter(0, order, torch.where(desc, dest, tail[order]))
    nxt = torch.empty(R, dtype=order.dtype, device=dev)
    nxt[dest_row] = torch.arange(R, dtype=order.dtype, device=dev)
    return nxt, new_seg


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
