"""ctypes convenience wrapper over the native C API (c_api.cpp).

Copy of ``lightgbm_tpu/native/capi.py``. ``NativeBooster`` serves a saved
model.txt through the LGBM_* ABI with no torch in the loop — the
deployment path for C/C++/FFI hosts; these bindings exist for tests and
for Python users who want interpreter-light serving.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from . import get_lib

C_API_DTYPE_FLOAT32 = 0
C_API_DTYPE_FLOAT64 = 1
C_API_PREDICT_NORMAL = 0
C_API_PREDICT_RAW_SCORE = 1
C_API_PREDICT_LEAF_INDEX = 2


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    if getattr(lib, "_capi_declared", False):
        return lib
    lib.LGBM_GetLastError.restype = ctypes.c_char_p
    lib.LGBM_BoosterCreateFromModelfile.restype = ctypes.c_int
    lib.LGBM_BoosterCreateFromModelfile.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_void_p)]
    lib.LGBM_BoosterLoadModelFromString.restype = ctypes.c_int
    lib.LGBM_BoosterLoadModelFromString.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_void_p)]
    lib.LGBM_BoosterFree.argtypes = [ctypes.c_void_p]
    for name in ("LGBM_BoosterGetNumClasses", "LGBM_BoosterGetNumFeature",
                 "LGBM_BoosterGetCurrentIteration",
                 "LGBM_BoosterNumModelPerIteration"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.LGBM_BoosterPredictForMat.restype = ctypes.c_int
    lib.LGBM_BoosterPredictForMat.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double)]
    lib._capi_declared = True
    return lib


class NativeBooster:
    """Model served by the native library (prediction only)."""

    def __init__(self, model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable (no compiler?)")
        self._lib = _declare(lib)
        self._handle = ctypes.c_void_p()
        n_iter = ctypes.c_int()
        if model_file is not None:
            rc = self._lib.LGBM_BoosterCreateFromModelfile(
                str(model_file).encode(), ctypes.byref(n_iter),
                ctypes.byref(self._handle))
        elif model_str is not None:
            rc = self._lib.LGBM_BoosterLoadModelFromString(
                model_str.encode(), ctypes.byref(n_iter),
                ctypes.byref(self._handle))
        else:
            raise ValueError("model_file or model_str required")
        if rc != 0:
            raise RuntimeError(self._lib.LGBM_GetLastError().decode())
        self.num_iterations = n_iter.value

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.LGBM_BoosterFree(self._handle)
            self._handle = None

    def _get_int(self, fn_name: str) -> int:
        out = ctypes.c_int()
        getattr(self._lib, fn_name)(self._handle, ctypes.byref(out))
        return out.value

    @property
    def num_classes(self) -> int:
        return self._get_int("LGBM_BoosterGetNumClasses")

    @property
    def num_features(self) -> int:
        return self._get_int("LGBM_BoosterGetNumFeature")

    @property
    def num_model_per_iteration(self) -> int:
        return self._get_int("LGBM_BoosterNumModelPerIteration")

    def predict(self, X: np.ndarray, raw_score: bool = False,
                pred_leaf: bool = False, start_iteration: int = 0,
                num_iteration: int = -1) -> np.ndarray:
        X = np.ascontiguousarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X[None, :]
        nrow, ncol = X.shape
        K = self.num_model_per_iteration
        if pred_leaf:
            ptype = C_API_PREDICT_LEAF_INDEX
            total = self.num_iterations if num_iteration <= 0 else \
                min(self.num_iterations, start_iteration + num_iteration)
            width = (total - start_iteration) * K
        else:
            ptype = (C_API_PREDICT_RAW_SCORE if raw_score
                     else C_API_PREDICT_NORMAL)
            width = K
        out = np.empty((nrow, width), np.float64)
        out_len = ctypes.c_int64()
        rc = self._lib.LGBM_BoosterPredictForMat(
            self._handle, X.ctypes.data_as(ctypes.c_void_p),
            C_API_DTYPE_FLOAT64, nrow, ncol, 1, ptype, start_iteration,
            num_iteration, b"",
            ctypes.byref(out_len),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if rc != 0:
            raise RuntimeError(self._lib.LGBM_GetLastError().decode())
        assert out_len.value == nrow * width
        if pred_leaf:
            return out.astype(np.int32)
        return out[:, 0] if width == 1 else out
