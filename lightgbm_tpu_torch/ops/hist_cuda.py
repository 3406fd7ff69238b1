"""Kernels K1 and B2: the row-major and the feature-major histogram,
hand-written in CUDA for Hopper.

K1 ports ``lightgbm_tpu/ops/hist_pallas.py`` ``hist_pallas_rm`` (the
Pallas kernel ``_hist_kernel`` in its f32, bf16 and int8 modes); its
source is ``csrc/hist_rowmajor.cu``. B2 ports ``hist_pallas`` (the same
Pallas kernel over feature-major bins, the full/leaf scheduler's pass) in
its f32 and int8 modes; its source is ``csrc/hist_featmajor.cu``. K1's
block body is ``csrc/hist_common.cuh``; B2 shares ``csrc/hist_grouped.cuh``
with K2. Each source's note gives the bound and the design.

``hist_cuda_rm`` takes K1's contract: uint8 bins ``[S, F]`` (contiguous,
``num_bin <= 256``), gh ``[S, 3]`` (contiguous) in float32, bfloat16 or
int8, and returns ``[F, num_bin, 3]`` in float32 (int32 for int8 gh).
``hist_cuda_fm`` takes B2's: uint8 bins ``[F, R]`` (unit column stride,
any row stride), gh ``[R, 3]`` in float32 or int8, and optionally each
row's leaf id and one leaf: then only that leaf's rows are added (the
mask is fused into the kernel; without them every row is added, so gh
masked by the caller still works); ``feature_major_bins`` makes the
device copy whose row stride lets B2 use vector loads. A CPU tensor runs
the plain version (``ops/histogram.hist_rowmajor`` / ``hist_featmajor``);
a CUDA tensor launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .histogram import hist_featmajor, hist_rowmajor

KERNEL = "hist_rowmajor"
KERNEL_FM = "hist_featmajor"

# gh dtype -> (the kernel's mode number, launch-count key, output dtype)
MODES = {torch.float32: (0, "f32", torch.float32),
         torch.bfloat16: (1, "bf16", torch.float32),
         torch.int8: (2, "int8", torch.int32)}
TILE_FEATURES = 32      # features per block (one warp, lane = feature)
MIN_ROWS_PER_BLOCK = 256  # a block's fixed cost (zero, write) needs rows
BATCH_ROWS = 32         # B2's rows per step; a block's rows are a multiple
# B2 reads a lane's 32 bins of a batch as two 16-byte vectors where a
# feature's row starts 16-byte aligned: the device copy of feature-major
# bins pads each row to a multiple of this many bytes (never read)
FM_ROW_ALIGN = 16

_resident: dict = {}
# the raw handle of a device's current stream (torch's own accessor where
# it has one: torch.cuda.current_stream() costs microseconds a call)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_handle(index: int) -> int:
    """The raw handle of CUDA device ``index``'s current stream."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def resident_blocks(lib, kernel: str, device: torch.device, num_bin: int,
                    mode: int, features=None) -> int:
    """Blocks of ``kernel`` in ``mode`` resident on ``device`` at once at
    ``num_bin`` bins (and ``features`` features, for a kernel whose shared
    memory depends on them), asked of the library once per key."""
    key = (kernel, device.index, num_bin, mode, features)
    if key not in _resident:
        n = ctypes.c_longlong(0)
        args = (num_bin, mode) if features is None else \
            (num_bin, features, mode)
        with torch.cuda.device(device):
            raise_on(lib, getattr(lib, f"lgbm_{kernel}_resident")(
                *args, ctypes.byref(n)), kernel)
        _resident[key] = n.value
    return _resident[key]


def load_kernel(kernel: str, launch_args: list, resident_args: int = 2):
    """The kernel's library with the C signatures of its launch function
    (``launch_args``) and of its resident-blocks query (``resident_args``
    ints, then the result's pointer) set."""
    lib = _build.load(kernel)
    fn = getattr(lib, f"lgbm_{kernel}")
    if fn.argtypes is None:
        query = getattr(lib, f"lgbm_{kernel}_resident")
        query.argtypes = [ctypes.c_int] * resident_args + [
            ctypes.POINTER(ctypes.c_longlong)]
        query.restype = ctypes.c_int
        fn.argtypes = launch_args
        fn.restype = ctypes.c_int
        lib.lgbm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.lgbm_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def check_gh(gh: torch.Tensor, rows: int) -> None:
    """gh must be a contiguous [rows, 3] tensor of a kernel mode."""
    if gh.dtype not in MODES or gh.dim() != 2 or gh.shape[1] != 3:
        raise ValueError(f"gh must be float32, bfloat16 or int8 [S, 3]; "
                         f"got {gh.dtype} {tuple(gh.shape)}")
    if gh.shape[0] != rows:
        raise ValueError(f"bins has {rows} rows, gh {gh.shape[0]}")
    if not gh.is_contiguous():
        raise ValueError("gh must be contiguous")


def check_bins(bins_rm: torch.Tensor, num_bin: int) -> None:
    if bins_rm.dtype != torch.uint8 or bins_rm.dim() != 2:
        raise ValueError(f"bins must be uint8 [S, F]; got {bins_rm.dtype} "
                         f"{tuple(bins_rm.shape)}")
    if not (1 <= int(num_bin) <= 256):
        raise ValueError(f"num_bin={num_bin} outside [1, 256]")
    if not bins_rm.is_contiguous():
        raise ValueError("bins must be contiguous")


def raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.lgbm_cuda_error_string(rc).decode())


def hist_cuda_rm(bins_rm: torch.Tensor, gh: torch.Tensor,
                 num_bin: int) -> torch.Tensor:
    """[F, num_bin, 3] histogram of a row-major leaf block.

    ``hist_cuda_rm.launches[mode]`` counts kernel launches per gh mode
    (``f32``, ``bf16``, ``int8``), never the plain version's calls."""
    check_bins(bins_rm, num_bin)
    check_gh(gh, bins_rm.shape[0])
    if bins_rm.device != gh.device:
        raise ValueError(f"bins on {bins_rm.device}, gh on {gh.device}")
    if bins_rm.device.type == "cpu":
        return hist_rowmajor(bins_rm, gh, num_bin)
    if bins_rm.device.type != "cuda":
        raise ValueError(f"unsupported device {bins_rm.device}")
    mode, key, out_dtype = MODES[gh.dtype]
    S, F = bins_rm.shape
    dev = bins_rm.device
    if S == 0:
        return torch.zeros(F, num_bin, 3, dtype=out_dtype, device=dev)
    lib, fn = load_kernel(KERNEL, [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p])
    n_tiles = -(-F // TILE_FEATURES)
    with torch.cuda.device(dev):
        # at least MIN_ROWS_PER_BLOCK rows a block, at most one wave
        cap = resident_blocks(lib, KERNEL, dev, int(num_bin), mode) // n_tiles
        blocks = max(1, min(-(-S // MIN_ROWS_PER_BLOCK), cap))
        out = torch.empty(F, num_bin, 3, dtype=out_dtype, device=dev)
        partials = torch.empty(
            blocks * n_tiles * 3 * num_bin * TILE_FEATURES if blocks > 1
            else 0, dtype=out_dtype, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        raise_on(lib, fn(bins_rm.data_ptr(), gh.data_ptr(), out.data_ptr(),
                         partials.data_ptr(), S, F, int(num_bin), mode,
                         blocks, stream), KERNEL)
    hist_cuda_rm.launches[key] += 1
    return out


hist_cuda_rm.launches = {key: 0 for _, key, _ in MODES.values()}


def feature_major_bins(bins_rm: np.ndarray,
                       device: torch.device) -> torch.Tensor:
    """The feature-major ``[F, R]`` device copy of row-major bins, each
    row's storage padded to a multiple of ``FM_ROW_ALIGN`` bytes."""
    R, F = bins_rm.shape
    ld = -(-max(R, 1) // FM_ROW_ALIGN) * FM_ROW_ALIGN
    buf = torch.zeros((F, ld), dtype=torch.uint8, device=device)
    buf[:, :R] = torch.from_numpy(np.ascontiguousarray(bins_rm.T))
    return buf[:, :R]


def hist_cuda_fm(bins_fm: torch.Tensor, gh: torch.Tensor, num_bin: int, *,
                 leaf_id=None, leaf=None) -> torch.Tensor:
    """[F, num_bin, 3] histogram of feature-major bins over the rows with
    ``leaf_id == leaf`` (int64 ``[R]`` and an int), or over every row
    when neither is given; its plain version is
    ``hist_featmajor(bins, gh * (leaf_id == leaf)[:, None], num_bin)``.

    ``hist_cuda_fm.launches[mode]`` counts kernel launches per gh mode
    (``f32``, ``int8``), never the plain version's calls."""
    if bins_fm.dtype != torch.uint8 or bins_fm.dim() != 2:
        raise ValueError(f"bins must be uint8 [F, R]; got {bins_fm.dtype} "
                         f"{tuple(bins_fm.shape)}")
    if not (1 <= int(num_bin) <= 256):
        raise ValueError(f"num_bin={num_bin} outside [1, 256]")
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
    if R == 0:
        return torch.zeros(F, num_bin, 3, dtype=out_dtype, device=dev)
    if gh.data_ptr() % 16:
        gh = gh.clone()       # the kernel copies gh 16 bytes at a time
    lib, fn = load_kernel(KERNEL_FM, [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p])
    fused = leaf_id is not None
    blocks, rpb, words = _fm_geometry(lib, dev, R, F, int(num_bin), mode,
                                      fused)
    out = torch.empty(F, num_bin, 3, dtype=out_dtype, device=dev)
    # partials, flags and the sparse pass's lists in one buffer
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    raise_on(lib, fn(bins_fm.data_ptr(), gh.data_ptr(),
                     leaf_id.data_ptr() if fused else None,
                     int(leaf) if fused else 0, scratch.data_ptr(),
                     out.data_ptr(), R, max(bins_fm.stride(0), R), F,
                     int(num_bin), mode, blocks, rpb, gpu,
                     stream_handle(gpu)), KERNEL_FM)
    hist_cuda_fm.launches[key] += 1
    return out


_fm_geometries: dict = {}


def _fm_geometry(lib, dev: torch.device, R: int, F: int, num_bin: int,
                 mode: int, fused: bool):
    """B2's grid for R rows: (blocks, rows per block, scratch words), at
    least MIN_ROWS_PER_BLOCK rows a block and at most one wave, a block's
    rows a whole number of 32-row batches; computed once per key."""
    key = (dev.index, R, F, num_bin, mode, fused)
    if key not in _fm_geometries:
        n_tiles = -(-F // TILE_FEATURES)
        cap = resident_blocks(lib, KERNEL_FM, dev, num_bin, mode) // n_tiles
        blocks = max(1, min(-(-R // MIN_ROWS_PER_BLOCK), cap))
        rpb = -(-R // blocks)
        rpb = -(-rpb // BATCH_ROWS) * BATCH_ROWS
        blocks = -(-R // rpb)
        query = lib.lgbm_hist_featmajor_scratch_words
        query.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_int]
        query.restype = ctypes.c_longlong
        _fm_geometries[key] = (blocks, rpb,
                               query(R, F, num_bin, blocks, int(fused)))
    return _fm_geometries[key]


hist_cuda_fm.launches = {"f32": 0, "int8": 0}
