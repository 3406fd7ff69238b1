"""Kernel K1: the row-major histogram, hand-written in CUDA for Hopper.

Port of ``lightgbm_tpu/ops/hist_pallas.py`` ``hist_pallas_rm`` (the
Pallas kernel ``_hist_kernel`` in its f32 mode). The kernel source is
``csrc/hist_rowmajor.cu``; its note gives the bound and the design.

``hist_cuda_rm`` takes K1's f32 contract: uint8 bins ``[S, F]``
(contiguous, ``num_bin <= 256``), f32 gh ``[S, 3]`` (contiguous), f32
output ``[F, num_bin, 3]``. A CPU tensor runs the plain version
(``ops/histogram.hist_rowmajor``); a CUDA tensor launches the kernel or
raises — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .histogram import hist_rowmajor

KERNEL = "hist_rowmajor"


def _kernel_fn():
    lib = _build.load(KERNEL)
    fn = lib.lgbm_hist_rowmajor_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.lgbm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.lgbm_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _check(bins_rm: torch.Tensor, gh: torch.Tensor, num_bin: int) -> None:
    if bins_rm.dtype != torch.uint8 or bins_rm.dim() != 2:
        raise ValueError(f"bins must be uint8 [S, F]; got {bins_rm.dtype} "
                         f"{tuple(bins_rm.shape)}")
    if gh.dtype != torch.float32 or gh.dim() != 2 or gh.shape[1] != 3:
        raise ValueError(f"gh must be float32 [S, 3]; got {gh.dtype} "
                         f"{tuple(gh.shape)}")
    if gh.shape[0] != bins_rm.shape[0]:
        raise ValueError(f"bins has {bins_rm.shape[0]} rows, gh "
                         f"{gh.shape[0]}")
    if not (1 <= int(num_bin) <= 256):
        raise ValueError(f"num_bin={num_bin} outside [1, 256]")
    if not (bins_rm.is_contiguous() and gh.is_contiguous()):
        raise ValueError("bins and gh must be contiguous")
    if bins_rm.device != gh.device:
        raise ValueError(f"bins on {bins_rm.device}, gh on {gh.device}")


def hist_cuda_rm(bins_rm: torch.Tensor, gh: torch.Tensor,
                 num_bin: int) -> torch.Tensor:
    """f32 [F, num_bin, 3] histogram of a row-major leaf block.

    ``hist_cuda_rm.launches`` counts kernel launches (never the plain
    version's calls)."""
    _check(bins_rm, gh, num_bin)
    if bins_rm.device.type == "cpu":
        return hist_rowmajor(bins_rm, gh, num_bin)
    if bins_rm.device.type != "cuda":
        raise ValueError(f"unsupported device {bins_rm.device}")
    S, F = bins_rm.shape
    out = torch.zeros(F, num_bin, 3, dtype=torch.float32,
                      device=bins_rm.device)
    if S == 0:
        return out
    lib, fn = _kernel_fn()
    with torch.cuda.device(bins_rm.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(bins_rm.data_ptr(), gh.data_ptr(), out.data_ptr(), S, F,
                int(num_bin), stream)
    if rc != 0:
        raise RuntimeError("hist_rowmajor kernel launch failed: "
                           + lib.lgbm_cuda_error_string(rc).decode())
    hist_cuda_rm.launches += 1
    return out


hist_cuda_rm.launches = 0
