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
as its int16 view. Every number of bins binning can give is served. The
body is chosen by the bin width, which binning takes from the number of
bins (u16 past 256): K1's dense path and K2 add uint8 bins through the
grouped body (a warp a block, lane = feature, all bins in one block) and
u16 bins through the wide body (a warp per feature, lane = row;
``wide_geometry`` gives its tiles and windows). B2 picks its body the
same way: the grouped body for uint8 bins, the wide body for u16 bins,
staged feature-major with the leaf mask (``fm_wide_geometry``).

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
from typing import NamedTuple

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
# K1: a leaf of at most this many rows takes the small path
SMALL_LEAF_ROWS = 1024
# the wide body's geometry (K1's dense path, K2 and B2 over u16 bins), as
# the kernels read it: at most this many warps a block; a feature's bins split
# between warps down to runs of this many; stages of at most this many
# rows (fewer where only that lets a block hold its features' bins), and
# this many stages (kWideStages of csrc/hist_grouped.cuh; a launch whose
# shared memory does not fit fails)
WIDE_MAX_WARPS = 16
WIDE_MIN_RUN_BINS = 2048
WIDE_STAGE_ROWS = 512
WIDE_STAGES = 2
# a wide block zeroes and writes a histogram of up to ~200 KB, and its
# warps add their rows 32 at a time one after another: a mid-size leaf
# needs many blocks of a few hundred rows each
WIDE_MIN_ROWS_PER_BLOCK = 512
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


def grouped_plan(lib, kernel: str, gpu: int, num_bin: int, F: int,
                 mode: int) -> int:
    """The blocks of ``kernel``'s grouped body (K1's dense path, K2 or
    B2, over uint8 bins, all ``num_bin`` bins in one block) resident at
    once on device ``gpu`` at ``F`` features, asked of the library once
    per key."""
    key = (kernel, gpu, num_bin, F, mode)
    if key not in _plans:
        fn = bind(lib, f"lgbm_{kernel}_plan", [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_longlong)])
        n = ctypes.c_longlong(0)
        raise_on(lib, fn(num_bin, F, mode, gpu, ctypes.byref(n)), kernel)
        _plans[key] = n.value
    return _plans[key]


class WideGeometry(NamedTuple):
    """A wide launch's histogram columns: ``n_ftiles`` tiles of ``ft``
    features times ``n_win`` windows of ``win`` bins (a multiple of 4 *
    ``wpf``), each feature's window split between ``wpf`` warps,
    ``stage_rows`` rows staged at a time, and a block's dynamic shared
    memory."""
    ft: int
    n_ftiles: int
    win: int
    n_win: int
    wpf: int
    stage_rows: int
    shared_bytes: int

    @property
    def columns(self) -> int:
        return self.n_ftiles * self.n_win

    @property
    def slots(self) -> int:
        """Accumulators of one block's histograms."""
        return 3 * self.ft * self.win


def _slot_bytes(nbytes: int) -> int:
    """A ring slot for ``nbytes`` staged bytes: widened to whole 16-byte
    chunks at either end (``gh_slot_bytes`` in hist_grouped.cuh)."""
    return (nbytes + 47) // 16 * 16


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _wide_columns(num_bin: int, F: int, optin: int, stage_bytes,
                  per_row) -> WideGeometry:
    """The wide body's columns at ``num_bin`` bins and ``F`` features in
    blocks of at most ``optin`` bytes of shared memory (232,448 on the
    H100), a stage of ``r`` rows of a tile of ``ft`` features taking
    ``stage_bytes(ft, r)`` bytes, at most ``r * per_row(ft) + 62``: all of
    a feature's bins in one window wherever they fit beside the smallest
    ring, else the fewest equal windows; then as many features a tile as
    fit, in the fewest tiles of equal width, with the largest stages that
    fit beside them; then the warps left over split each feature's bins
    into runs. The shared bytes are 12 a bin of the histograms, one a bin
    of tags, then ``WIDE_STAGES`` stages."""
    def shared(ft, win, rows):
        return 12 * ft * win + _ceil_to(ft * win, 16) + \
            WIDE_STAGES * stage_bytes(ft, rows)

    def stage_rows(ft, win):
        """The largest stage, a multiple of 32 rows and at most
        WIDE_STAGE_ROWS, that fits; None if 32 rows do not."""
        room = optin - 12 * ft * win - _ceil_to(ft * win, 16)
        rows = min(WIDE_STAGE_ROWS, max(room // WIDE_STAGES - 62, 0)
                   // per_row(ft) // 32 * 32)
        while (rows + 32 <= WIDE_STAGE_ROWS
               and shared(ft, win, rows + 32) <= optin):
            rows += 32
        return rows if rows >= 32 and shared(ft, win, rows) <= optin \
            else None

    # the fewest windows whose bins fit one feature beside the least ring
    most = (optin - shared(1, 0, 32) - 15) // 13 // 4 * 4
    if most < 4:
        raise ValueError(f"{F} features do not fit the wide body's ring "
                         f"in {optin} bytes of shared memory")
    n_win = -(-num_bin // most)
    win = _ceil_to(-(-num_bin // n_win), 4)
    # as many features as fit (the ring grows with them: count it at the
    # widest tile, then try one more)
    top = min(F, WIDE_MAX_WARPS)
    ft = max(1, min(top, (optin - shared(top, 0, 32) - 15) // (13 * win)))
    while ft < top and stage_rows(ft + 1, win) is not None:
        ft += 1
    while stage_rows(ft, win) is None:
        ft -= 1
    ft = -(-F // -(-F // ft))         # the fewest tiles, of equal width
    wpf = max(1, min(WIDE_MAX_WARPS // ft, win // WIDE_MIN_RUN_BINS))
    while wpf > 1 and stage_rows(ft, _ceil_to(win, 4 * wpf)) is None:
        wpf -= 1
    win = _ceil_to(win, 4 * wpf)
    rows = stage_rows(ft, win)
    return WideGeometry(ft, -(-F // ft), win, -(-num_bin // win), wpf, rows,
                        shared(ft, win, rows))


def wide_geometry(num_bin: int, F: int, bin_bytes: int, gh_bytes: int,
                  optin: int) -> WideGeometry:
    """K1's and K2's wide columns (``_wide_columns``) over row-major rows
    of ``F`` bins of ``bin_bytes`` bytes and gh of ``gh_bytes`` bytes a
    channel: a stage holds each row's tile of bins (``tile_row_bytes`` of
    hist_grouped.cuh: the tile's own bytes where a copy of 16, 8 or 4
    bytes divides both the row and the tile, else the 16-byte chunks
    holding it), then the rows' gh (``wide_stage_bytes``)."""
    def row_bytes(ft):
        if any(F * bin_bytes % g == 0 and ft * bin_bytes % g == 0
               for g in (16, 8, 4)):
            return ft * bin_bytes
        return (ft * bin_bytes + 30) // 16 * 16

    return _wide_columns(
        num_bin, F, optin,
        lambda ft, rows: _ceil_to(rows * row_bytes(ft), 16)
        + _slot_bytes(rows * 3 * gh_bytes),
        lambda ft: row_bytes(ft) + 3 * gh_bytes)


def fm_wide_geometry(num_bin: int, F: int, gh_bytes: int,
                     optin: int) -> WideGeometry:
    """B2's wide columns (``_wide_columns``) over feature-major u16 bins
    and gh of ``gh_bytes`` bytes a channel: a stage holds each feature of
    the tile's run of the stage's bins (2 bytes a row and feature, whatever
    F is), the rows' gh, a 2-byte place a row in the list of the leaf's
    rows, and a 16-byte header (``fm_stage_bytes`` of
    csrc/hist_featmajor.cu)."""
    return _wide_columns(
        num_bin, F, optin,
        lambda ft, rows: rows * (2 * ft + 3 * gh_bytes + 2) + 16,
        lambda ft: 2 * ft + 3 * gh_bytes + 2)


_wide_plans: dict = {}


def wide_plan(lib, kernel: str, gpu: int, num_bin: int, F: int,
              mode: int):
    """``(geometry, resident)`` of ``kernel``'s wide body (u16 bins) on
    device ``gpu``: its ``WideGeometry`` (B2's feature-major layout for
    ``KERNEL_FM``) and the blocks of it resident at once, asked of the
    library once per key."""
    key = (kernel, gpu, num_bin, F, mode, WIDE_MAX_WARPS,
           WIDE_MIN_RUN_BINS, WIDE_STAGE_ROWS)
    if key not in _wide_plans:
        fn = bind(lib, f"lgbm_{kernel}_wide_plan", [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)])
        optin, n = ctypes.c_int(0), ctypes.c_longlong(0)
        raise_on(lib, fn(F, mode, 0, 4, 1, 32, gpu, ctypes.byref(optin),
                         ctypes.byref(n)), kernel)
        gh_bytes = (4, 2, 1)[mode]
        geo = (fm_wide_geometry(num_bin, F, gh_bytes, optin.value)
               if kernel == KERNEL_FM else
               wide_geometry(num_bin, F, 2, gh_bytes, optin.value))
        raise_on(lib, fn(F, mode, geo.ft, geo.win, geo.wpf, geo.stage_rows,
                         gpu, ctypes.byref(optin), ctypes.byref(n)), kernel)
        _wide_plans[key] = (geo, n.value)
    return _wide_plans[key]


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
    elif bb == 2:
        bins_rm, gh = aligned16(bins_rm), aligned16(gh)
        geo, resident = wide_plan(lib, KERNEL, gpu, num_bin, F, mode)
        blocks = max(1, min(-(-S // WIDE_MIN_ROWS_PER_BLOCK),
                            resident // geo.columns, MAX_PARTS))
        partials = (torch.empty(blocks * geo.columns * geo.slots,
                                dtype=out_dtype, device=bins_rm.device)
                    if blocks > 1 else None)
        fn = bind(lib, "lgbm_hist_rowmajor_wide", [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong] + [ctypes.c_int] * 7 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        rc = fn(bins_rm.data_ptr(), gh.data_ptr(), out.data_ptr(),
                None if partials is None else partials.data_ptr(), S, F,
                num_bin, mode, geo.ft, geo.win, geo.wpf, geo.stage_rows,
                blocks, gpu, stream_handle(gpu))
    else:
        bins_rm, gh = aligned16(bins_rm), aligned16(gh)
        resident = grouped_plan(lib, KERNEL, gpu, num_bin, F, mode)
        n_cols = columns(F, num_bin, num_bin)
        # at least MIN_ROWS_PER_BLOCK rows a block, at most one wave
        blocks = max(1, min(-(-S // MIN_ROWS_PER_BLOCK), resident // n_cols,
                            MAX_PARTS))
        partials = (torch.empty(blocks * n_cols * 3 * num_bin
                                * TILE_FEATURES, dtype=out_dtype,
                                device=bins_rm.device)
                    if blocks > 1 else None)
        fn = bind(lib, "lgbm_hist_rowmajor", [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong] + [ctypes.c_int] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        rc = fn(bins_rm.data_ptr(), gh.data_ptr(), out.data_ptr(),
                None if partials is None else partials.data_ptr(), S, F,
                num_bin, mode, blocks, gpu, stream_handle(gpu))
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
    ``FM_ROW_ALIGN`` elements; transposed on the device (a host transpose
    of 13.2M x 200 bytes takes seconds)."""
    R, F = bins_rm.shape
    ld = -(-max(R, 1) // FM_ROW_ALIGN) * FM_ROW_ALIGN
    src = device_bins(bins_rm, device)
    buf = torch.zeros((F, ld), dtype=src.dtype, device=device)
    buf[:, :R] = src.T
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
            # the leaf's rows in row order: the masked pass's other rows
            # would add zeros, which change no sum
            rows = torch.nonzero(leaf_id == int(leaf)).squeeze(1)
            bins_fm, gh = bins_fm.index_select(1, rows), gh[rows]
        return hist_featmajor(bins_fm, gh, num_bin)
    mode, key, out_dtype = MODES[gh.dtype]
    dev = bins_fm.device
    num_bin = int(num_bin)
    if R == 0:
        return torch.zeros(F, num_bin, 3, dtype=out_dtype, device=dev)
    gh = aligned16(gh)        # the kernel copies gh 16 bytes at a time
    lib = _build.load(KERNEL_FM)
    fused = leaf_id is not None
    bb = bins_fm.element_size()
    geo, blocks, rpb, words = _fm_geometry(lib, gpu, R, F, num_bin, mode,
                                           bb, fused)
    out = torch.empty(F, num_bin, 3, dtype=out_dtype, device=dev)
    # partials, flags and the sparse pass's lists in one buffer
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    head = (bins_fm.data_ptr(), gh.data_ptr(),
            leaf_id.data_ptr() if fused else None,
            int(leaf) if fused else 0, scratch.data_ptr(), out.data_ptr(),
            R, max(bins_fm.stride(0), R), F, num_bin, mode)
    if geo is None:
        fn = bind(lib, "lgbm_hist_featmajor", _FM_HEAD + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p])
        rc = fn(*head, blocks, rpb, gpu, stream_handle(gpu))
    else:
        fn = bind(lib, "lgbm_hist_featmajor_wide", _FM_HEAD + [
            ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_void_p])
        rc = fn(*head, geo.ft, geo.win, geo.wpf, geo.stage_rows, blocks, rpb,
                gpu, stream_handle(gpu))
    raise_on(lib, rc, KERNEL_FM)
    hist_cuda_fm.launches[mode_key(key, bins_fm)] += 1
    return out


# B2's leading arguments: bins, gh, leaf_id, leaf, scratch, out, R, ld, F,
# num_bin, mode
_FM_HEAD = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.c_longlong] + [ctypes.c_int] * 3
_fm_geometries: dict = {}


def _fm_geometry(lib, gpu: int, R: int, F: int, num_bin: int, mode: int,
                 bin_bytes: int, fused: bool):
    """B2's launch for R rows: (the wide body's geometry, None for uint8
    bins; blocks; rows per block; scratch words), at least
    MIN_ROWS_PER_BLOCK rows a block (WIDE_MIN_ROWS_PER_BLOCK on the wide
    body) and at most one wave per column, a block's rows a whole number
    of 32-row batches; computed once per key."""
    key = (gpu, R, F, num_bin, mode, bin_bytes, fused)
    if key not in _fm_geometries:
        if bin_bytes == 2:
            geo, resident = wide_plan(lib, KERNEL_FM, gpu, num_bin, F, mode)
            cap, least = resident // geo.columns, WIDE_MIN_ROWS_PER_BLOCK
        else:
            geo = None
            resident = grouped_plan(lib, KERNEL_FM, gpu, num_bin, F, mode)
            cap = resident // columns(F, num_bin, num_bin)
            least = MIN_ROWS_PER_BLOCK
        blocks = max(1, min(-(-R // least), cap, MAX_PARTS))
        rpb = -(-R // blocks)
        rpb = -(-rpb // BATCH_ROWS) * BATCH_ROWS
        blocks = -(-R // rpb)
        if geo is None:
            query = bind(lib, "lgbm_hist_featmajor_scratch_words", [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_int], ctypes.c_longlong)
            words = query(R, F, num_bin, blocks, int(fused))
        else:
            query = bind(lib, "lgbm_hist_featmajor_wide_scratch_words", [
                ctypes.c_longlong] + [ctypes.c_int] * 7 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int],
                ctypes.c_longlong)
            words = query(R, F, num_bin, mode, geo.ft, geo.win, geo.wpf,
                          geo.stage_rows, blocks, int(fused), gpu)
        if words < 0:
            raise RuntimeError(f"{KERNEL_FM} scratch query failed on device "
                               f"{gpu}")
        _fm_geometries[key] = (geo, blocks, rpb, words)
    return _fm_geometries[key]


hist_cuda_fm.launches = {f"{key}{width}": 0 for key in ("f32", "int8")
                         for width in ("", "_u16")}
