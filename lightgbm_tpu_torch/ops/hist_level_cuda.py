"""Kernel K2: all of one level's node histograms in one launch,
hand-written in CUDA for Hopper.

Port of ``lightgbm_tpu/ops/hist_level_pallas.py`` ``hist_level`` (the
Pallas kernel ``_hist_level_kernel`` via ``_hist_level_impl``) in its
f32, bf16 and int8 modes. The kernel source is ``csrc/hist_level.cu``
(its body is shared with K1 in ``csrc/hist_common.cuh``); its note gives
the bound and the design.

``hist_level_cuda`` takes the contract of ``ops/hist_level.hist_level``.
Here, in PyTorch, the rows are sorted by node (a stable sort of the node
keys, as the JAX function does, ``:241-266``) and each node's segment
offsets and block range are computed; the kernel then reads each node's
rows through the sort order. A CPU tensor runs the plain version; a CUDA
tensor launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from .hist_cuda import (MIN_ROWS_PER_BLOCK, MODES, TILE_FEATURES, check_bins,
                        check_gh, load_kernel, raise_on, resident_blocks)
from .hist_level import hist_level, level_keys

KERNEL = "hist_level"


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(x.shape[0] + 1, dtype=torch.long, device=x.device)
    torch.cumsum(x, 0, out=out[1:])
    return out


def hist_level_cuda(bins_rm: torch.Tensor, gh: torch.Tensor,
                    local: torch.Tensor, in_lvl: torch.Tensor, n_nodes: int,
                    num_bin: int) -> torch.Tensor:
    """[n_nodes, F, num_bin, 3] histograms of one level's nodes.

    ``hist_level_cuda.launches[mode]`` counts kernel launches per gh mode
    (``f32``, ``bf16``, ``int8``), never the plain version's calls."""
    check_bins(bins_rm, num_bin)
    R, F = bins_rm.shape
    check_gh(gh, R)
    if local.dtype not in (torch.int32, torch.int64) or \
            tuple(local.shape) != (R,):
        raise ValueError(f"local must be int32/int64 [R]; got {local.dtype} "
                         f"{tuple(local.shape)}")
    if in_lvl.dtype != torch.bool or tuple(in_lvl.shape) != (R,):
        raise ValueError(f"in_lvl must be bool [R]; got {in_lvl.dtype} "
                         f"{tuple(in_lvl.shape)}")
    if not (1 <= int(n_nodes) <= 65535):
        raise ValueError(f"n_nodes={n_nodes} outside [1, 65535]")
    if len({t.device for t in (bins_rm, gh, local, in_lvl)}) != 1:
        raise ValueError("bins, gh, local and in_lvl must share a device")
    if bins_rm.device.type == "cpu":
        return hist_level(bins_rm, gh, local, in_lvl, n_nodes, num_bin)
    if bins_rm.device.type != "cuda":
        raise ValueError(f"unsupported device {bins_rm.device}")
    mode, key, out_dtype = MODES[gh.dtype]
    n = int(n_nodes)
    dev = bins_rm.device
    lib, fn = load_kernel(KERNEL, [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p])
    n_tiles = -(-F // TILE_FEATURES)
    with torch.cuda.device(dev):
        # a level whose rows sit in one node fills one wave of blocks
        wave = max(resident_blocks(lib, KERNEL, dev, int(num_bin), mode)
                   // n_tiles, 1)
        rpb = max(MIN_ROWS_PER_BLOCK, -(-R // wave))
        max_blocks = R // rpb + n     # >= sum over nodes of ceil(rows / rpb)
        keys, order = torch.sort(level_keys(local, in_lvl, n), stable=True)
        # node v's rows are order[seg[v]:seg[v + 1]]
        seg = torch.searchsorted(keys, torch.arange(n + 1, device=dev))
        first = _exclusive_cumsum((seg[1:] - seg[:-1] + rpb - 1) // rpb)
        out = torch.empty(n, F, num_bin, 3, dtype=out_dtype, device=dev)
        partials = torch.empty(
            max_blocks * n_tiles * 3 * num_bin * TILE_FEATURES,
            dtype=out_dtype, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        raise_on(lib, fn(bins_rm.data_ptr(), gh.data_ptr(), order.data_ptr(),
                         seg.data_ptr(), first.data_ptr(), out.data_ptr(),
                         partials.data_ptr(), F, int(num_bin), n, mode, rpb,
                         max_blocks, stream), KERNEL)
    hist_level_cuda.launches[key] += 1
    return out


hist_level_cuda.launches = {key: 0 for _, key, _ in MODES.values()}
