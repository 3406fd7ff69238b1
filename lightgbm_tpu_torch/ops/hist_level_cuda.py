"""Kernel K2: all of one level's node histograms in one launch,
hand-written in CUDA for Hopper.

Port of ``lightgbm_tpu/ops/hist_level_pallas.py`` ``hist_level`` (the
Pallas kernel ``_hist_level_kernel`` via ``_hist_level_impl``) in its
f32, bf16 and int8 modes, over uint8 bins or u16 bins held as int16
(``ops/histogram.bin_ids``). The kernel source is ``csrc/hist_level.cu``
(its block body is ``csrc/hist_grouped.cuh``); its note gives the bound
and the design.

``hist_level_cuda`` takes the contract of ``ops/hist_level.hist_level``.
The rows' node order comes in as ``order``/``seg``: the level grower
carries it from level to level with ``carry_order_cuda`` (a stable
partition of each parent's rows into its children's, two small kernels
of the same source around two cumulative sums; its plain version is
``ops/hist_level.carry_order``). Without them the wrapper sorts the node
keys itself (``node_order``). It then gathers bins and gh into that
order once, so that the kernel reads each node's rows as consecutive
rows, 16 bytes at a time. A CPU tensor runs the plain version (the
module-level ``hist_level``, called with the contract's six arguments);
a CUDA tensor launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from .hist_cuda import (MIN_ROWS_PER_BLOCK, MODES, TILE_FEATURES, bind,
                        check_bins, check_gh, columns, mode_key, plan,
                        raise_on, stream_handle)
from .hist_level import _exclusive_cumsum, carry_order, hist_level, node_order
from .histogram import as_bin_storage

KERNEL = "hist_level"


def _gathered(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``x[order]`` in a fresh buffer the kernel may read in whole 16-byte
    chunks: with room up to the next multiple of 16 bytes after the last
    row (the caching allocator's blocks are aligned; the kernel refuses
    a buffer that is not)."""
    pad = -(-16 // x.element_size())
    buf = torch.empty(x.numel() + pad, dtype=x.dtype, device=x.device)
    out = buf[:x.numel()].view(x.shape)
    torch.index_select(x, 0, order, out=out)
    return out


def hist_level_cuda(bins_rm: torch.Tensor, gh: torch.Tensor,
                    local: torch.Tensor, in_lvl: torch.Tensor, n_nodes: int,
                    num_bin: int, *, order: Optional[torch.Tensor] = None,
                    seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[n_nodes, F, num_bin, 3] histograms of one level's nodes.

    ``order`` (int64 ``[R]``) and ``seg`` (int64 ``[n_nodes + 1]``), given
    together, are the rows in node order as ``node_order`` returns them
    for ``local``/``in_lvl``.

    ``hist_level_cuda.launches[mode]`` counts kernel launches per gh mode
    and bin width (``f32``, ``bf16``, ``int8``, ``f32_u16``, ...), never
    the plain version's calls."""
    bins_rm = as_bin_storage(bins_rm)
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
    n = int(n_nodes)
    if (order is None) != (seg is None):
        raise ValueError("order and seg go together")
    if order is not None and (
            order.dtype != torch.int64 or tuple(order.shape) != (R,)
            or seg.dtype != torch.int64 or tuple(seg.shape) != (n + 1,)):
        raise ValueError(f"order must be int64 [R] and seg int64 "
                         f"[n_nodes + 1]; got {order.dtype} "
                         f"{tuple(order.shape)}, {seg.dtype} "
                         f"{tuple(seg.shape)}")
    carried = () if order is None else (order, seg)
    if len({t.device for t in (bins_rm, gh, local, in_lvl) + carried}) != 1:
        raise ValueError("bins, gh, local, in_lvl, order and seg must share "
                         "a device")
    if bins_rm.device.type == "cpu":
        return hist_level(bins_rm, gh, local, in_lvl, n_nodes, num_bin)
    if bins_rm.device.type != "cuda":
        raise ValueError(f"unsupported device {bins_rm.device}")
    mode, key, out_dtype = MODES[gh.dtype]
    dev = bins_rm.device
    gpu = dev.index
    lib = _build.load(KERNEL)
    fn = bind(lib, "lgbm_hist_level", [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 6 + [ctypes.c_longlong, ctypes.c_longlong,
                             ctypes.c_int, ctypes.c_void_p])
    bb = bins_rm.element_size()
    num_bin = int(num_bin)
    win, resident = plan(lib, KERNEL, gpu, num_bin, mode, bb, F)
    n_cols = columns(F, num_bin, win)
    # a level whose rows sit in one node fills one wave of blocks
    wave = max(resident // n_cols, 1)
    rpb = max(MIN_ROWS_PER_BLOCK, -(-R // wave))
    max_blocks = R // rpb + n     # >= sum over nodes of ceil(rows / rpb)
    if order is None:
        order, seg = node_order(local, in_lvl, n)
    order, seg = order.contiguous(), seg.contiguous()
    first = _exclusive_cumsum((seg[1:] - seg[:-1] + rpb - 1) // rpb)
    bins_k, gh_k = _gathered(bins_rm, order), _gathered(gh, order)
    out = torch.empty(n, F, num_bin, 3, dtype=out_dtype, device=dev)
    partials = torch.empty(max_blocks * n_cols * 3 * win * TILE_FEATURES,
                           dtype=out_dtype, device=dev)
    raise_on(lib, fn(bins_k.data_ptr(), gh_k.data_ptr(),
                     seg.data_ptr(), first.data_ptr(), out.data_ptr(),
                     partials.data_ptr(), F, num_bin, n, mode, bb, win,
                     rpb, max_blocks, gpu, stream_handle(gpu)), KERNEL)
    hist_level_cuda.launches[mode_key(key, bins_rm)] += 1
    return out


hist_level_cuda.launches = {f"{key}{width}": 0
                            for _, key, _ in MODES.values()
                            for width in ("", "_u16")}


def carry_order_cuda(order: torch.Tensor, seg: torch.Tensor,
                     local: torch.Tensor, go_left: torch.Tensor,
                     descend: torch.Tensor):
    """The next level's ``(order, seg)``: ``ops/hist_level.carry_order``'s
    contract (int64 ``order`` [R], ``seg`` [n + 1] and ``local`` [R], bool
    ``go_left`` and ``descend`` [R]), on the card by ``pack_flags`` and
    ``place_rows`` of ``csrc/hist_level.cu`` around two
    ``torch.cumsum``; a CPU tensor runs the plain version.

    ``carry_order_cuda.launches`` counts the card's partitions."""
    R = order.shape[0]
    n = seg.shape[0] - 1
    for name, t, dtype in (("order", order, torch.int64),
                           ("local", local, torch.int64),
                           ("go_left", go_left, torch.bool),
                           ("descend", descend, torch.bool)):
        if t.dtype != dtype or tuple(t.shape) != (R,):
            raise ValueError(f"{name} must be {dtype} [R]; got {t.dtype} "
                             f"{tuple(t.shape)}")
    if seg.dtype != torch.int64 or n < 1 or R < 1:
        raise ValueError(f"seg must be int64 [n + 1] with n >= 1 and R >= 1; "
                         f"got {seg.dtype} {tuple(seg.shape)}, R={R}")
    if len({t.device for t in (order, seg, local, go_left, descend)}) != 1:
        raise ValueError("order, seg, local, go_left and descend must share "
                         "a device")
    if order.device.type == "cpu":
        return carry_order(order, seg, local, go_left, descend)
    if order.device.type != "cuda":
        raise ValueError(f"unsupported device {order.device}")
    lib = _build.load(KERNEL)
    pack_flags = bind(lib, "lgbm_level_pack_flags", [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    place_rows = bind(lib, "lgbm_level_place_rows", [ctypes.c_void_p] * 9 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    order, seg, local = order.contiguous(), seg.contiguous(), local.contiguous()
    go_left, descend = go_left.contiguous(), descend.contiguous()
    dev = order.device
    stream = stream_handle(dev.index)
    packed = torch.empty(R, dtype=torch.int64, device=dev)
    leaving = torch.empty(R, dtype=torch.int64, device=dev)
    raise_on(lib, pack_flags(
        order.data_ptr(), go_left.data_ptr(), descend.data_ptr(),
        packed.data_ptr(), leaving.data_ptr(), R, dev.index, stream), KERNEL)
    cum = torch.cumsum(packed, 0)
    cum_out = torch.cumsum(leaving, 0)
    nxt = torch.empty(R, dtype=torch.int64, device=dev)
    new_seg = torch.empty(2 * n + 1, dtype=torch.int64, device=dev)
    raise_on(lib, place_rows(
        order.data_ptr(), seg.data_ptr(), local.data_ptr(),
        descend.data_ptr(), packed.data_ptr(), cum.data_ptr(),
        cum_out.data_ptr(), nxt.data_ptr(), new_seg.data_ptr(), R, n,
        dev.index, stream), KERNEL)
    carry_order_cuda.launches += 1
    return nxt, new_seg


carry_order_cuda.launches = 0
