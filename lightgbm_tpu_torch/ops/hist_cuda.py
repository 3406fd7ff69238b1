"""Kernels K1 and B2: the row-major and the feature-major histogram,
hand-written in CUDA for Hopper.

K1 ports ``lightgbm_tpu/ops/hist_pallas.py`` ``hist_pallas_rm`` (the
Pallas kernel ``_hist_kernel`` in its f32, bf16 and int8 modes); its
source is ``csrc/hist_rowmajor.cu``. B2 ports ``hist_pallas`` (the same
Pallas kernel over feature-major bins, the full/leaf scheduler's pass) in
its f32 and int8 modes; its source is ``csrc/hist_featmajor.cu``. Both,
and K2, share the block body ``csrc/hist_grouped.cuh``. Each source's
note gives the bound and the design.

Bins are uint8, or u16 bins (``max_bin > 256``) held as int16 with the
same bits (``ops/histogram.bin_ids``); a ``torch.uint16`` tensor is taken
as its int16 view. Every number of bins binning can give is served: a
histogram too wide for one block's shared memory is cut into bin windows
of at most ``WINDOW_BINS`` bins, each block adding one window.

``hist_cuda_rm`` takes K1's contract: bins ``[S, F]`` (contiguous), gh
``[S, 3]`` (contiguous) in float32, bfloat16 or int8, and returns ``[F,
num_bin, 3]`` in float32 (int32 for int8 gh). A leaf of at most
``SMALL_LEAF_ROWS`` rows takes K1's small path (a block per feature, its
cost growing with the rows), a larger one the dense path. ``hist_cuda_fm``
takes B2's: bins ``[F, R]`` (unit column stride, any row stride), gh
``[R, 3]`` in float32 or int8, and optionally each row's leaf id and one
leaf: then only that leaf's rows are added (the mask is fused into the
kernel; without them every row is added, so gh masked by the caller still
works); ``feature_major_bins`` makes the device copy whose row stride lets
B2 use vector loads. A CPU tensor runs the plain version
(``ops/histogram.hist_rowmajor`` / ``hist_featmajor``); a CUDA tensor
launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .histogram import (BIN_DTYPES, as_bin_storage, hist_featmajor,
                        hist_rowmajor)

KERNEL = "hist_rowmajor"
KERNEL_FM = "hist_featmajor"

# gh dtype -> (the kernel's mode number, launch-count key, output dtype)
MODES = {torch.float32: (0, "f32", torch.float32),
         torch.bfloat16: (1, "bf16", torch.float32),
         torch.int8: (2, "int8", torch.int32)}
TILE_FEATURES = 32      # features per block (one warp, lane = feature)
MIN_ROWS_PER_BLOCK = 256  # a block's fixed cost (zero, write) needs rows
BATCH_ROWS = 32         # B2's rows per step; a block's rows are a multiple
MAX_PARTS = 4096        # blocks a reduction sums at most
# the widest bin window of a block: a histogram of more bins is split
# into windows, each block adding one (the rows are read once a window)
WINDOW_BINS = 512
# K1: a leaf of at most this many rows takes the small path
SMALL_LEAF_ROWS = 1024
# B2 reads a lane's 32 bins of a batch as 16-byte vectors where a
# feature's row starts 16-byte aligned: the device copy of feature-major
# bins pads each row to a multiple of this many elements (never read)
FM_ROW_ALIGN = 16

_plans: dict = {}
# the raw handle of a device's current stream (torch's own accessor where
# it has one: torch.cuda.current_stream() costs microseconds a call)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_handle(index: int) -> int:
    """The raw handle of CUDA device ``index``'s current stream."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def mode_key(key: str, bins: torch.Tensor) -> str:
    """The launch-count key of a gh mode over ``bins``: ``f32``, ...,
    and ``f32_u16``, ... for u16 bins."""
    return key if bins.dtype == torch.uint8 else f"{key}_u16"


def bind(lib, name: str, argtypes: list, restype=ctypes.c_int):
    """``lib.<name>`` with its C signature set (once), and the library's
    error-string function's."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
        lib.lgbm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.lgbm_cuda_error_string.restype = ctypes.c_char_p
    return fn


def plan(lib, kernel: str, gpu: int, num_bin: int, mode: int,
         bin_bytes: int, features=None):
    """``(win, resident)`` of ``kernel`` on device ``gpu``: its bin
    window and the blocks resident at once, at ``num_bin`` bins of
    ``bin_bytes`` (and ``features`` features, for a kernel whose shared
    memory depends on them), asked of the library once per key."""
    key = (kernel, gpu, num_bin, mode, bin_bytes, features, WINDOW_BINS)
    if key not in _plans:
        head = [ctypes.c_int] * (5 if features is not None else 4)
        fn = bind(lib, f"lgbm_{kernel}_plan", head + [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_longlong)])
        win, n = ctypes.c_int(0), ctypes.c_longlong(0)
        args = ((num_bin, mode) if features is None
                else (num_bin, features, mode))
        raise_on(lib, fn(*args, bin_bytes, WINDOW_BINS, gpu,
                         ctypes.byref(win), ctypes.byref(n)), kernel)
        _plans[key] = (win.value, n.value)
    return _plans[key]


def columns(F: int, num_bin: int, win: int) -> int:
    """Histogram columns of a launch: feature tiles x bin windows."""
    return -(-F // TILE_FEATURES) * -(-num_bin // win)


def check_gh(gh: torch.Tensor, rows: int) -> None:
    """gh must be a contiguous [rows, 3] tensor of a kernel mode."""
    if gh.dtype not in MODES or gh.dim() != 2 or gh.shape[1] != 3:
        raise ValueError(f"gh must be float32, bfloat16 or int8 [S, 3]; "
                         f"got {gh.dtype} {tuple(gh.shape)}")
    if gh.shape[0] != rows:
        raise ValueError(f"bins has {rows} rows, gh {gh.shape[0]}")
    if not gh.is_contiguous():
        raise ValueError("gh must be contiguous")


def check_bin_width(bins: torch.Tensor, num_bin: int) -> None:
    """2-D uint8 bins with num_bin in [1, 256], or u16 bins (int16) with
    num_bin in [1, 65536]."""
    if bins.dtype not in BIN_DTYPES or bins.dim() != 2:
        raise ValueError(f"bins must be 2-D uint8, or u16 held as int16; "
                         f"got {bins.dtype} {tuple(bins.shape)}")
    most = 256 if bins.dtype == torch.uint8 else 1 << 16
    if not (1 <= int(num_bin) <= most):
        raise ValueError(f"num_bin={num_bin} outside [1, {most}] for "
                         f"{bins.dtype} bins")


def check_bins(bins_rm: torch.Tensor, num_bin: int) -> None:
    check_bin_width(bins_rm, num_bin)
    if not bins_rm.is_contiguous():
        raise ValueError("bins must be contiguous")


def raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.lgbm_cuda_error_string(rc).decode())


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it whose storage starts 16-byte aligned (the
    kernels copy rows 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def hist_cuda_rm(bins_rm: torch.Tensor, gh: torch.Tensor,
                 num_bin: int) -> torch.Tensor:
    """[F, num_bin, 3] histogram of a row-major leaf block.

    ``hist_cuda_rm.launches[mode]`` counts kernel launches per gh mode
    and bin width (``f32``, ``bf16``, ``int8``, ``f32_u16``, ...), never
    the plain version's calls."""
    bins_rm = as_bin_storage(bins_rm)
    check_bins(bins_rm, num_bin)
    check_gh(gh, bins_rm.shape[0])
    gpu = gh.get_device()          # -1: not a CUDA tensor
    if bins_rm.get_device() != gpu:
        raise ValueError(f"bins on {bins_rm.device}, gh on {gh.device}")
    if gpu < 0:
        if bins_rm.device.type != "cpu":
            raise ValueError(f"unsupported device {bins_rm.device}")
        return hist_rowmajor(bins_rm, gh, num_bin)
    mode, key, out_dtype = MODES[gh.dtype]
    S, F = bins_rm.shape
    num_bin = int(num_bin)
    if S == 0:
        return torch.zeros(F, num_bin, 3, dtype=out_dtype,
                           device=bins_rm.device)
    lib = _build.load(KERNEL)
    bb = bins_rm.element_size()
    out = torch.empty(F, num_bin, 3, dtype=out_dtype, device=bins_rm.device)
    if S <= SMALL_LEAF_ROWS:
        fn = bind(lib, "lgbm_hist_rowmajor_small", [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p])
        rc = fn(bins_rm.data_ptr(), gh.data_ptr(), out.data_ptr(), S, F,
                num_bin, mode, bb, gpu, stream_handle(gpu))
    else:
        bins_rm, gh = aligned16(bins_rm), aligned16(gh)
        win, resident = plan(lib, KERNEL, gpu, num_bin, mode, bb, F)
        n_cols = columns(F, num_bin, win)
        # at least MIN_ROWS_PER_BLOCK rows a block, at most one wave
        blocks = max(1, min(-(-S // MIN_ROWS_PER_BLOCK), resident // n_cols,
                            MAX_PARTS))
        partials = (torch.empty(blocks * n_cols * 3 * win * TILE_FEATURES,
                                dtype=out_dtype, device=bins_rm.device)
                    if blocks > 1 else None)
        fn = bind(lib, "lgbm_hist_rowmajor", [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong] + [ctypes.c_int] * 5 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        rc = fn(bins_rm.data_ptr(), gh.data_ptr(), out.data_ptr(),
                None if partials is None else partials.data_ptr(), S, F,
                num_bin, mode, bb, win, blocks, gpu, stream_handle(gpu))
    raise_on(lib, rc, KERNEL)
    hist_cuda_rm.launches[mode_key(key, bins_rm)] += 1
    return out


hist_cuda_rm.launches = {f"{key}{width}": 0 for _, key, _ in MODES.values()
                         for width in ("", "_u16")}


def device_bins(bins_rm: np.ndarray, device) -> torch.Tensor:
    """The row-major ``[R, F]`` bins on ``device`` under the port's bin
    dtypes: uint8, or uint16 held as int16."""
    bins_rm = np.ascontiguousarray(bins_rm)
    if bins_rm.dtype == np.uint16:
        bins_rm = bins_rm.view(np.int16)
    return torch.from_numpy(bins_rm).to(device)


def feature_major_bins(bins_rm: np.ndarray,
                       device: torch.device) -> torch.Tensor:
    """The feature-major ``[F, R]`` device copy of row-major bins (uint8,
    or uint16 held as int16), each row's storage padded to a multiple of
    ``FM_ROW_ALIGN`` elements."""
    R, F = bins_rm.shape
    ld = -(-max(R, 1) // FM_ROW_ALIGN) * FM_ROW_ALIGN
    src = device_bins(bins_rm.T, "cpu")
    buf = torch.zeros((F, ld), dtype=src.dtype, device=device)
    buf[:, :R] = src
    return buf[:, :R]


def hist_cuda_fm(bins_fm: torch.Tensor, gh: torch.Tensor, num_bin: int, *,
                 leaf_id=None, leaf=None) -> torch.Tensor:
    """[F, num_bin, 3] histogram of feature-major bins over the rows with
    ``leaf_id == leaf`` (int64 ``[R]`` and an int), or over every row
    when neither is given; its plain version is
    ``hist_featmajor(bins, gh * (leaf_id == leaf)[:, None], num_bin)``.

    ``hist_cuda_fm.launches[mode]`` counts kernel launches per gh mode
    and bin width (``f32``, ``int8``, ``f32_u16``, ``int8_u16``), never
    the plain version's calls."""
    bins_fm = as_bin_storage(bins_fm)
    check_bin_width(bins_fm, num_bin)
    F, R = bins_fm.shape
    if (R > 1 and bins_fm.stride(1) != 1) or \
            (F > 1 and bins_fm.stride(0) < R):
        raise ValueError("bins must have unit column stride and a row "
                         f"stride >= R; got strides {bins_fm.stride()}")
    check_gh(gh, R)
    if gh.dtype == torch.bfloat16:
        raise ValueError("the feature-major histogram takes float32 or "
                         "int8 gh (the full path builds no bf16 "
                         "histograms)")
    gpu = gh.get_device()          # -1: not a CUDA tensor
    if bins_fm.get_device() != gpu:
        raise ValueError(f"bins on {bins_fm.device}, gh on {gh.device}")
    if (leaf_id is None) != (leaf is None):
        raise ValueError("leaf_id and leaf go together")
    if leaf_id is not None:
        if leaf_id.dtype != torch.int64 or tuple(leaf_id.shape) != (R,) \
                or not leaf_id.is_contiguous():
            raise ValueError(f"leaf_id must be contiguous int64 [R]; got "
                             f"{leaf_id.dtype} {tuple(leaf_id.shape)}")
        if leaf_id.get_device() != gpu:
            raise ValueError(f"leaf_id on {leaf_id.device}, gh on "
                             f"{gh.device}")
        if int(leaf) < 0:
            raise ValueError(f"leaf={leaf} must be >= 0")
    if gpu < 0:
        for t in (bins_fm, gh) + (() if leaf_id is None else (leaf_id,)):
            if t.device.type != "cpu":
                raise ValueError(f"unsupported device {t.device}")
        if leaf_id is not None:
            gh = gh * (leaf_id == int(leaf))[:, None].to(gh.dtype)
        return hist_featmajor(bins_fm, gh, num_bin)
    mode, key, out_dtype = MODES[gh.dtype]
    dev = bins_fm.device
    num_bin = int(num_bin)
    if R == 0:
        return torch.zeros(F, num_bin, 3, dtype=out_dtype, device=dev)
    gh = aligned16(gh)        # the kernel copies gh 16 bytes at a time
    lib = _build.load(KERNEL_FM)
    fn = bind(lib, "lgbm_hist_featmajor", [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 5 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p])
    fused = leaf_id is not None
    bb = bins_fm.element_size()
    blocks, rpb, win, words = _fm_geometry(lib, gpu, R, F, num_bin, mode, bb,
                                           fused)
    out = torch.empty(F, num_bin, 3, dtype=out_dtype, device=dev)
    # partials, flags and the sparse pass's lists in one buffer
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    raise_on(lib, fn(bins_fm.data_ptr(), gh.data_ptr(),
                     leaf_id.data_ptr() if fused else None,
                     int(leaf) if fused else 0, scratch.data_ptr(),
                     out.data_ptr(), R, max(bins_fm.stride(0), R), F,
                     num_bin, mode, bb, win, blocks, rpb, gpu,
                     stream_handle(gpu)), KERNEL_FM)
    hist_cuda_fm.launches[mode_key(key, bins_fm)] += 1
    return out


_fm_geometries: dict = {}


def _fm_geometry(lib, gpu: int, R: int, F: int, num_bin: int, mode: int,
                 bin_bytes: int, fused: bool):
    """B2's grid for R rows: (blocks, rows per block, bin window, scratch
    words), at least MIN_ROWS_PER_BLOCK rows a block and at most one wave
    per column, a block's rows a whole number of 32-row batches; computed
    once per key."""
    key = (gpu, R, F, num_bin, mode, bin_bytes, fused, WINDOW_BINS)
    if key not in _fm_geometries:
        win, resident = plan(lib, KERNEL_FM, gpu, num_bin, mode, bin_bytes)
        cap = resident // columns(F, num_bin, win)
        blocks = max(1, min(-(-R // MIN_ROWS_PER_BLOCK), cap, MAX_PARTS))
        rpb = -(-R // blocks)
        rpb = -(-rpb // BATCH_ROWS) * BATCH_ROWS
        blocks = -(-R // rpb)
        query = bind(lib, "lgbm_hist_featmajor_scratch_words", [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int], ctypes.c_longlong)
        _fm_geometries[key] = (blocks, rpb, win,
                               query(R, F, num_bin, win, blocks, int(fused)))
    return _fm_geometries[key]


hist_cuda_fm.launches = {f"{key}{width}": 0 for key in ("f32", "int8")
                         for width in ("", "_u16")}
