"""The training C ABI of the port's native library, driven from C.

The JAX package's own harnesses (``tests/c_train_harness.c``,
``tests/c_csrfunc_harness.cpp``, and the slow wave-2 and concurrent ones)
compile against the port's library (``lightgbm_tpu_torch/native``) and
run: LGBM_DatasetCreateFromMat -> SetField -> BoosterCreate ->
UpdateOneIter x N -> PredictForMat -> SaveModel -> serving reload parity,
with the library's embedded interpreter training ``lightgbm_tpu_torch``.
They run on the CPU: ``c_train_harness.c`` names ``device_type=cpu``, and
``LIGHTGBM_TPU_PLATFORM=cpu`` (the JAX tests' pin of their platform) makes
the CPU the port's default for the harnesses that name no device. A
Python host whose executable holds the interpreter (a distribution's
python) drives the ABI in its own interpreter, with no libpython loaded
beside it.
"""
import os
import shutil
import subprocess
import sysconfig

import pytest

from lightgbm_tpu_torch import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO, "lightgbm_tpu_torch", "native")

pytestmark = pytest.mark.skipif(
    native.get_lib() is None or shutil.which("gcc") is None,
    reason="no native toolchain")


def _harness_env():
    env = dict(os.environ)
    # the embedded interpreter needs the venv's site-packages (numpy,
    # torch) on its default path
    env["PYTHONPATH"] = (sysconfig.get_paths()["purelib"] + os.pathsep +
                         env.get("PYTHONPATH", ""))
    env["LIGHTGBM_TPU_PLATFORM"] = "cpu"
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ldlib = sysconfig.get_config_var("LDLIBRARY") or ""
    if libdir and ldlib:
        env.setdefault("LGBM_TPU_LIBPYTHON", os.path.join(libdir, ldlib))
    return env


def _build_and_run(tmp_path, compiler, source, extra_flags, args,
                   timeout):
    so_path = native.library_path()
    assert os.path.exists(so_path)
    exe = str(tmp_path / os.path.splitext(source)[0])
    subprocess.run(
        [compiler, "-O1", *extra_flags, "-I", NATIVE_DIR,
         os.path.join(REPO, "tests", source), so_path, "-lm", "-o", exe],
        check=True, capture_output=True, timeout=120)
    return subprocess.run([exe, *args], env=_harness_env(),
                          capture_output=True, text=True, timeout=timeout)


def test_c_train_harness(tmp_path):
    out = _build_and_run(tmp_path, "gcc", "c_train_harness.c", [],
                         [str(tmp_path / "model.txt")], 600)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert "C-TRAIN-OK" in out.stdout
    with open(tmp_path / "model.txt") as fh:
        assert "[device_type: cpu]" in fh.read()


def test_c_csrfunc_harness(tmp_path):
    """LGBM_DatasetCreateFromCSRFunc (the SWIG row-iterator variant): a
    C++ std::function produces rows; training matches the FromMat path."""
    out = _build_and_run(tmp_path, "g++", "c_csrfunc_harness.cpp",
                         ["-std=c++17"], [], 600)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert "C-CSRFUNC-OK" in out.stdout


@pytest.mark.slow
def test_c_wave2_harness(tmp_path):
    """Streaming creation, CSC, dataset ops, introspection, single-row
    fast predictions, contrib and sparse output, external collectives."""
    out = _build_and_run(tmp_path, "gcc", "c_wave2_harness.c", ["-pthread"],
                         [str(tmp_path / "model.txt")], 900)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
    assert "C-WAVE2-OK" in out.stdout


@pytest.mark.slow
def test_c_train_concurrent_harness(tmp_path):
    """Per-handle locking: independent boosters train from two host
    threads; a contended booster serializes."""
    out = _build_and_run(tmp_path, "gcc", "c_train_concurrent_harness.c",
                         ["-pthread"], [], 600)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert "C-TRAIN-CONCURRENT-OK" in out.stdout


def _python_without_libpython():
    """A python on the PATH whose executable holds the interpreter itself
    (no libpython among its needed libraries), or None."""
    for name in ("python3.11", "python3.10", "python3.13", "python3"):
        exe = shutil.which(name)
        if exe is None:
            continue
        try:
            needed = subprocess.run(["ldd", exe], capture_output=True,
                                    text=True, timeout=30).stdout
        except OSError:
            return None
        if "libpython" not in needed:
            return exe
    return None


_HOST_CODE = r"""
import ctypes, sys
lib = ctypes.CDLL(sys.argv[1])
X = (ctypes.c_double * 4)(1, 2, 3, 4)
out = ctypes.c_void_p()
lib.LGBM_DatasetCreateFromMat(X, 1, 2, 2, 1, b"", None, ctypes.byref(out))
# the bootstrap's first statement puts the repo root on sys.path: it ran
# in this interpreter, not in a second one loaded beside it
print("ROOT-IN-HOST", sys.path[0] == sys.argv[2])
"""


@pytest.mark.skipif(_python_without_libpython() is None,
                    reason="no python here holds its interpreter in its "
                           "executable")
def test_python_host_of_a_static_interpreter_keeps_its_runtime(tmp_path):
    """A Python host whose executable holds the interpreter (as a
    distribution's python does) drives the training ABI in its own
    interpreter: the library loads no libpython beside it."""
    script = tmp_path / "host.py"
    script.write_text(_HOST_CODE)
    out = subprocess.run(
        [_python_without_libpython(), str(script), native.library_path(),
         REPO], capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items()
             if k not in ("PYTHONPATH", "PYTHONHOME")})
    assert "ROOT-IN-HOST True" in out.stdout, (out.stdout, out.stderr)
