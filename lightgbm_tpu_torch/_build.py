"""Build the port's CUDA kernels from ``csrc/`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with
``nvcc`` alone into ``_build/lib<name>-<hash>.so`` (the hash covers the
source and the flags, so an edited source rebuilds), loaded with
``ctypes``. No PyTorch headers and no ``ninja`` are involved, which keeps
a build at seconds. Kernels build at first use; ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, List, Tuple

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each fresh build
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH); the port's CUDA kernels build from source")


def _target(name: str) -> Tuple[str, str]:
    src = os.path.join(SRC_DIR, f"{name}.cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def kernel_names() -> List[str]:
    """Every kernel source in ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(SRC_DIR) if f.endswith(".cu"))


def build_all(names: Iterable[str]) -> List[str]:
    """Compile every named kernel that is not built yet, one ``nvcc``
    process per source, all started together. Returns the library paths;
    raises with the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    paths = []
    for name in names:
        src, lib = _target(name)
        paths.append(lib)
        if os.path.isfile(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, lib, tmp, proc))
    failures = []
    for name, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all([name])[0]
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib
