"""The native library: the C++ text parser, TreeSHAP and the C ABIs.

Port of ``lightgbm_tpu/native/__init__.py``. The sources in this folder
(``parser.cpp``, ``shap.cpp``, ``c_api.cpp``, ``c_api_train.cpp``,
``arrow_ingest.cpp`` and ``lgbm_c_api.h``) build with ``g++`` at first use
into ``lightgbm_tpu_torch/_build/native/lgbm_native-<hash>.so``, the hash
covering the sources and the flags, so an edited source rebuilds. Each
source compiles in its own ``g++`` process, all started together, then
one link; a file lock around the build lets concurrent processes (the
test workers) build it once. The library stays four levels below the repo
root, where ``c_api_train.cpp``'s bootstrap looks for the package.

Behind ``parse_dense_chunk``, ``parse_libsvm_chunk`` and ``count_cols``
is the C++ body when the library loads, and the numpy body (the plain
version, the JAX package's fallback) when ``g++`` is missing or
``LIGHTGBM_TPU_NO_NATIVE`` is set. The token rules are the JAX package's:
``na``, ``nan``, ``null``, ``?`` and blanks parse to NaN, a token that is
not a number gives NaN, empty lines are skipped, and in LibSVM ``qid:``
and other tokens that are not ``index:value`` are skipped.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..utils import log

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build", "native")
SOURCES = ["parser.cpp", "c_api.cpp", "c_api_train.cpp", "shap.cpp",
           "arrow_ingest.cpp"]
HEADERS = ["lgbm_c_api.h"]
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread"]
LINK_FLAGS = ["-shared", "-pthread", "-ldl"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# why the last build failed (None after a good build or none tried)
build_error: Optional[str] = None


def library_path() -> str:
    """Where the library of the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(_HERE, name), "rb") as fh:
            digest.update(name.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR,
                        f"lgbm_native-{digest.hexdigest()[:12]}.so")


def build(gxx: str = "g++") -> str:
    """Build the library unless it is built; returns its path. Raises
    with the compiler's output if a step fails."""
    path = library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.isfile(path):   # another process built it meanwhile
            return path
        work = tempfile.mkdtemp(dir=BUILD_DIR)
        try:
            objs: List[str] = []
            jobs = []
            for name in SOURCES:
                obj = os.path.join(work, name[:-4] + ".o")
                objs.append(obj)
                jobs.append((name, subprocess.Popen(
                    [gxx, *CXX_FLAGS, "-c", os.path.join(_HERE, name),
                     "-o", obj], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)))
            failures = []
            for name, proc in jobs:
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    failures.append(f"{name}: g++ exited "
                                    f"{proc.returncode}\n{out}")
            if failures:
                raise RuntimeError("native build failed:\n" +
                                   "\n".join(failures))
            tmp = os.path.join(work, "lgbm_native.so")
            res = subprocess.run([gxx, *objs, *LINK_FLAGS, "-o", tmp],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"native link failed:\n{res.stdout}")
            os.replace(tmp, path)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return path


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.lgbm_count_cols.restype = ctypes.c_int64
    lib.lgbm_count_cols.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char]
    lib.lgbm_parse_dense.restype = ctypes.c_int64
    lib.lgbm_parse_dense.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
    lib.lgbm_parse_libsvm.restype = ctypes.c_int64
    lib.lgbm_parse_libsvm.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
    lib.lgbm_tree_shap_batch.restype = ctypes.c_int
    lib.lgbm_tree_shap_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int32),   # split_feature
        ctypes.POINTER(ctypes.c_double),  # threshold_real
        ctypes.POINTER(ctypes.c_int32),   # decision_type
        ctypes.POINTER(ctypes.c_int32),   # left_child
        ctypes.POINTER(ctypes.c_int32),   # right_child
        ctypes.POINTER(ctypes.c_double),  # leaf_value
        ctypes.POINTER(ctypes.c_double),  # leaf_count
        ctypes.POINTER(ctypes.c_double),  # internal_count
        ctypes.c_int32,                   # n_int
        ctypes.POINTER(ctypes.c_int32),   # cat_boundaries
        ctypes.POINTER(ctypes.c_uint32),  # cat_threshold
        ctypes.c_int32,                   # num_cat
        ctypes.c_int32,                   # n_cat_words
        ctypes.POINTER(ctypes.c_double),  # X
        ctypes.c_int64,                   # nrow
        ctypes.c_int32,                   # ncol
        ctypes.POINTER(ctypes.c_double),  # out
        ctypes.c_int64,                   # out_stride
        ctypes.c_int32]                   # nthreads
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None: ``LIGHTGBM_TPU_NO_NATIVE`` is
    set, ``g++`` is missing, or the build failed (``build_error`` says
    why). The first call builds it."""
    global _lib, _tried, build_error
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("LIGHTGBM_TPU_NO_NATIVE"):
            return None
        gxx = shutil.which("g++")
        if gxx is None:
            build_error = "g++ not found"
            return None
        try:
            # conlint: disable=CL002 — deliberate: double-checked
            # one-time build; holding _lock across the g++ run is the
            # point (every other thread needs the built library first)
            path = build(gxx)
        except (OSError, RuntimeError) as e:
            build_error = str(e)
            log.warning(f"native library build failed; the numpy "
                        f"parsers stand in: {e}")
            return None
        build_error = None
        _lib = _declare(ctypes.CDLL(path))
        return _lib


def count_cols(chunk: bytes, sep: str) -> int:
    """Number of ``sep``-separated fields on the first non-empty line."""
    lib = get_lib()
    if lib is not None:
        return int(lib.lgbm_count_cols(chunk, len(chunk), sep.encode()[0]))
    return count_cols_numpy(chunk, sep)


def count_cols_numpy(chunk: bytes, sep: str) -> int:
    """``count_cols``'s plain body."""
    body = chunk.lstrip(b"\r\n")
    if not body:
        return 0
    return body.split(b"\n", 1)[0].count(sep.encode()) + 1


_NAN_TOKENS = ("na", "nan", "null", "?")


def _parse_token(tok: str) -> float:
    tok = tok.strip()
    if tok == "" or tok.lower() in _NAN_TOKENS:
        return np.nan
    try:
        return float(tok)
    except ValueError:
        return np.nan


def parse_dense_chunk(chunk: bytes, sep: str, n_cols: int) -> np.ndarray:
    """Parse a newline-aligned CSV/TSV byte chunk -> float64 [rows, n_cols]
    (a short line's missing columns are NaN, a long line's extra ones
    dropped)."""
    lib = get_lib()
    if lib is not None:
        max_rows = chunk.count(b"\n") + 1
        out = np.empty((max_rows, n_cols), np.float64)
        n = lib.lgbm_parse_dense(
            chunk + b"\0", len(chunk), sep.encode()[0], n_cols,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_rows)
        return out[:n]
    return parse_dense_numpy(chunk, sep, n_cols)


def parse_dense_numpy(chunk: bytes, sep: str, n_cols: int) -> np.ndarray:
    """``parse_dense_chunk``'s plain body."""
    rows = [ln for ln in chunk.decode("utf-8", "replace").split("\n")
            if ln.strip()]
    out = np.full((len(rows), n_cols), np.nan)
    for i, ln in enumerate(rows):
        toks = ln.split(sep)[:n_cols]
        try:
            # every token a number: float() strips blanks and reads
            # "nan" as NaN, so this is the token rule's own answer
            vals = [float(t) for t in toks]
        except ValueError:
            vals = [_parse_token(t) for t in toks]
        out[i, :len(vals)] = vals
    return out


def parse_libsvm_chunk(chunk: bytes) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray, np.ndarray, int]:
    """Parse a LibSVM byte chunk -> (labels, rows, cols, vals, max_col)."""
    lib = get_lib()
    if lib is not None:
        max_rows = chunk.count(b"\n") + 1
        max_nnz = max(chunk.count(b":"), 1)
        labels = np.empty(max_rows, np.float64)
        rows = np.empty(max_nnz, np.int32)
        cols = np.empty(max_nnz, np.int32)
        vals = np.empty(max_nnz, np.float64)
        nnz = ctypes.c_int64()
        max_col = ctypes.c_int32()
        n = lib.lgbm_parse_libsvm(
            chunk + b"\0", len(chunk),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_rows,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_nnz,
            ctypes.byref(nnz), ctypes.byref(max_col))
        k = nnz.value
        return labels[:n], rows[:k], cols[:k], vals[:k], int(max_col.value)
    return parse_libsvm_numpy(chunk)


def parse_libsvm_numpy(chunk: bytes) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray, np.ndarray, int]:
    """``parse_libsvm_chunk``'s plain body."""
    lines = [ln for ln in chunk.decode("utf-8", "replace").split("\n")
             if ln.strip()]
    labels = np.zeros(len(lines))
    r_l, c_l, v_l = [], [], []
    max_col = -1
    for i, ln in enumerate(lines):
        toks = ln.split()
        if toks:
            try:
                labels[i] = float(toks[0])
            except ValueError:
                labels[i] = np.nan
        for t in toks[1:]:
            if ":" not in t:
                continue
            k, _, v = t.partition(":")
            try:
                idx = int(k)
                val = float(v)
            except ValueError:
                continue
            r_l.append(i)
            c_l.append(idx)
            v_l.append(val)
            max_col = max(max_col, idx)
    return (labels, np.asarray(r_l, np.int32), np.asarray(c_l, np.int32),
            np.asarray(v_l, np.float64), max_col)


def iter_file_chunks(path: str, skip_lines: int = 0,
                     chunk_bytes: int = 32 << 20) -> Iterator[bytes]:
    """Yield newline-aligned byte chunks of a text file."""
    with open(path, "rb") as f:
        for _ in range(skip_lines):
            f.readline()
        carry = b""
        while True:
            block = f.read(chunk_bytes)
            if not block:
                if carry.strip():
                    yield carry
                return
            block = carry + block
            cut = block.rfind(b"\n")
            if cut < 0:
                carry = block
                continue
            yield block[:cut + 1]
            carry = block[cut + 1:]
