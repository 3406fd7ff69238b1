"""The port's native library against its numpy bodies and the JAX
package's library, on the CPU.

- The text parser: the C++ body (``native/parser.cpp``) and the numpy
  body of ``parse_dense_chunk``, ``parse_libsvm_chunk`` and ``count_cols``
  give equal arrays, NaNs in the same places, and both equal the JAX
  package's native parser, over NaN tokens, empty lines (``\\r\\n`` too)
  and short and long lines; on ``tests/test_torch_stream_loader.py``'s
  junk corpus (where C++ and numpy differ in either package) the C++
  body is the JAX package's C++ body; and the file-parser fuzz of
  ``tests/test_c_api_fuzz.py`` (the two-round loader included) survives
  through the port's loaders.
- ``NativeBooster`` (the interpreter-free serving ABI, ``c_api.cpp``):
  the cases of ``tests/test_c_api.py`` on models the port trained, at
  that file's tolerances (1e-12, 1e-10 for multiclass, linear trees and
  the special transforms), and the model-parser fuzz
  (``scripts/_native_fuzz_driver.py``) against the port's library.
- The Arrow entry points (``arrow_ingest.cpp``): the cases of
  ``tests/test_c_api_arrow.py``, training the port through its C ABI in
  this process.
- TreeSHAP: the C++ kernel against the port's numpy walk (rtol 1e-9) and
  against the JAX package's native kernel, bit for bit, on the same model
  text.
- The build: two processes asking for the library at once leave one
  library, which loads.
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest
from test_torch_stream_loader import DENSE_CORPUS as STREAM_DENSE
from test_torch_stream_loader import LIBSVM_CORPUS as STREAM_LIBSVM

import lightgbm_tpu as lgb
import lightgbm_tpu.native as jax_native
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import native
from lightgbm_tpu_torch.native import get_lib

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="no native toolchain")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device_type": "cpu"}


# -- the parser ------------------------------------------------------------

DENSE_CHUNKS = [
    b"1,2,3\n4,5,6\n",
    b"1.5,NA,3\n,nan,Null\n?,-2.5e3,inf\n",      # NaN tokens, blanks
    b"\n\n1,2,3\n\n\n4,5,6\n\n",                  # empty lines
    b"1,2,3\r\n\r\n4,5,6\r\n",                    # CRLF and an empty line
    b"1\n1,2\n1,2,3,4,5\n",                       # short and long lines
    b" 1 , 2 ,3 \n-0,+7,1e-300\n",                # padded tokens, signs
    b"0.1,0.2,0.30000000000000004\n1e308,-1e308,5e-324\n",
    b"7,8,9",                                     # no trailing newline
]


@pytest.mark.parametrize("chunk", DENSE_CHUNKS)
@pytest.mark.parametrize("sep", [",", "\t"])
def test_dense_parser_bodies_agree_with_jax(chunk, sep):
    chunk = chunk.replace(b",", sep.encode())
    got_cpp = native.parse_dense_chunk(chunk, sep, 3)
    np.testing.assert_array_equal(got_cpp,
                                  native.parse_dense_numpy(chunk, sep, 3))
    np.testing.assert_array_equal(
        got_cpp, jax_native.parse_dense_chunk(chunk, sep, 3))
    assert got_cpp.dtype == np.float64 and got_cpp.shape[1] == 3
    assert native.count_cols(chunk, sep) == \
        native.count_cols_numpy(chunk, sep)


SVM_CHUNKS = [
    b"1 1:0.5 3:2\n0 2:1.5\n",
    b"1 qid:3 0:1 4:-2\n\n0 1:1e-3 7:inf\n",      # qid skipped
    b"\r\n2 5:1\r\n-1\n",                          # CRLF, a label alone
    b"0.5 10:0.25 11:nan",                         # no trailing newline
]


@pytest.mark.parametrize("chunk", SVM_CHUNKS)
def test_libsvm_parser_bodies_agree_with_jax(chunk):
    got_cpp = native.parse_libsvm_chunk(chunk)
    got_np = native.parse_libsvm_numpy(chunk)
    jax_out = jax_native.parse_libsvm_chunk(chunk)
    for a, b, c in zip(got_cpp, got_np, jax_out):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("name", sorted(STREAM_DENSE))
@pytest.mark.parametrize("sep", [",", "\t"])
def test_cpp_dense_parser_is_the_jax_cpp_parser_on_junk(name, sep):
    """On ``tests/test_torch_stream_loader.py``'s corpus (junk such as
    ``0x10`` and ``1_0``, blank-only lines, where the C++ and numpy bodies
    of either package differ) the port's C++ body is the JAX package's."""
    if jax_native.get_lib() is None:
        pytest.skip("the JAX package's native library did not build")
    chunk = STREAM_DENSE[name].replace(b",", sep.encode())
    for n_cols in (1, 3, 5):
        np.testing.assert_array_equal(
            native.parse_dense_chunk(chunk, sep, n_cols),
            jax_native.parse_dense_chunk(chunk, sep, n_cols))


@pytest.mark.parametrize("name", sorted(STREAM_LIBSVM))
def test_cpp_libsvm_parser_is_the_jax_cpp_parser_on_junk(name):
    if jax_native.get_lib() is None:
        pytest.skip("the JAX package's native library did not build")
    got = native.parse_libsvm_chunk(STREAM_LIBSVM[name])
    want = jax_native.parse_libsvm_chunk(STREAM_LIBSVM[name])
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    assert got[4] == want[4]


def test_parser_bodies_agree_on_a_large_chunk():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(2000, 8))
    X[rng.uniform(size=X.shape) < 0.05] = np.nan
    lines = [",".join("" if np.isnan(v) else repr(float(v)) for v in row)
             for row in X]
    chunk = ("\n".join(lines) + "\n").encode()
    got_cpp = native.parse_dense_chunk(chunk, ",", 8)
    np.testing.assert_array_equal(got_cpp,
                                  native.parse_dense_numpy(chunk, ",", 8))
    np.testing.assert_array_equal(got_cpp, X)


_FILE_FUZZ_CODE = r"""
import os, random, resource, sys
resource.setrlimit(resource.RLIMIT_AS, (8 << 30, 8 << 30))
sys.path.insert(0, sys.argv[2])
from lightgbm_tpu_torch import native
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.file_loader import load_svm_or_csv
from lightgbm_tpu_torch.io.stream_loader import load_binned_two_round
assert native.get_lib() is not None

rng = random.Random(7)
base_csv = "\n".join(
    ",".join(f"{rng.random():.4g}" for _ in range(5)) for _ in range(50))
base_svm = "\n".join(
    f"{i % 2} " + " ".join(f"{j}:{rng.random():.4g}"
                           for j in sorted(rng.sample(range(20), 3)))
    for i in range(50))
tmp = sys.argv[1]

def try_parse(text, suffix):
    p = os.path.join(tmp, f"f{suffix}")
    with open(p, "w") as fh:
        fh.write(text)
    try:
        load_svm_or_csv(p, Config({"min_data_in_leaf": 1,
                                   "device_type": "cpu"}))
    except Exception:
        pass

def try_stream(text, suffix):
    p = os.path.join(tmp, f"s{suffix}")
    with open(p, "w") as fh:
        fh.write(text)
    try:
        load_binned_two_round(p, Config({"two_round": True,
                                         "min_data_in_bin": 1,
                                         "min_data_in_leaf": 1,
                                         "device_type": "cpu"}),
                              chunk_bytes=256)
    except Exception:
        pass

cases = 0
for base in (base_csv, base_svm):
    for _ in range(30):
        b = list(base)
        for _ in range(8):
            b[rng.randrange(len(b))] = chr(rng.randrange(1, 127))
        try_parse("".join(b), cases)
        cases += 1
    lines = base.split("\n")
    for _ in range(20):
        m = list(lines)
        i = rng.randrange(len(m))
        m[i] = m[i] * 50 if rng.random() < 0.5 else m[i][:rng.randrange(
            len(m[i]) + 1)]
        try_parse("\n".join(m), cases)
        cases += 1
for text in (":", "1:", "a:b c:d", ",,,,,", "\x00\x01\x02", "9" * 10000,
             "1 99999999999999:1"):
    try_parse(text, cases)
    cases += 1
for base in (base_csv, base_svm):
    for _ in range(10):
        b = list(base)
        for _ in range(8):
            b[rng.randrange(len(b))] = chr(rng.randrange(1, 127))
        try_stream("".join(b), cases)
        cases += 1
print("FILE-FUZZ-OK", cases)
"""


def test_file_parser_fuzz(tmp_path):
    """The port's CSV/TSV/LibSVM ingestion, the native chunk parsers of
    the two-round loader included, rejects or survives corrupt files."""
    script = tmp_path / "filefuzz.py"
    script.write_text(_FILE_FUZZ_CODE)
    out = subprocess.run([sys.executable, str(script), str(tmp_path), REPO],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, (out.returncode, out.stderr[-2000:])
    assert "FILE-FUZZ-OK" in out.stdout


# -- NativeBooster on models the port trained -------------------------------

def _native(path):
    from lightgbm_tpu_torch.native.capi import NativeBooster
    return NativeBooster(model_file=path)


def _train_save(tmp_path, params, X, y, rounds=10, **ds_kw):
    bst = lgt.train(dict(params, verbose=-1, min_data_in_leaf=5, **CPU),
                    lgt.Dataset(X, label=y, **ds_kw),
                    num_boost_round=rounds)
    path = str(tmp_path / "m.txt")
    bst.save_model(path)
    return bst, path


def test_regression_parity(rng, tmp_path):
    X = rng.normal(size=(400, 8))
    y = X[:, 0] * 2 + np.sin(X[:, 1])
    bst, path = _train_save(tmp_path, {"objective": "regression"}, X, y)
    nb = _native(path)
    assert nb.num_iterations == 10 and nb.num_features == 8
    np.testing.assert_allclose(nb.predict(X), bst.predict(X),
                               rtol=1e-12, atol=1e-12)


def test_binary_sigmoid_and_raw(rng, tmp_path):
    X = rng.normal(size=(500, 6))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    bst, path = _train_save(tmp_path, {"objective": "binary"}, X, y)
    nb = _native(path)
    np.testing.assert_allclose(nb.predict(X), bst.predict(X),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(nb.predict(X, raw_score=True),
                               bst.predict(X, raw_score=True),
                               rtol=1e-12, atol=1e-12)


def test_multiclass_softmax(rng, tmp_path):
    k = 4
    centers = rng.normal(scale=2.0, size=(k, 5))
    yid = rng.integers(0, k, size=600)
    X = centers[yid] + rng.normal(size=(600, 5))
    bst, path = _train_save(tmp_path,
                            {"objective": "multiclass", "num_class": k},
                            X, yid.astype(np.float32))
    nb = _native(path)
    assert nb.num_classes == k
    np.testing.assert_allclose(nb.predict(X), bst.predict(X),
                               rtol=1e-10, atol=1e-12)


def test_categorical_and_nan(rng, tmp_path):
    n = 600
    X = rng.normal(size=(n, 5))
    X[:, 2] = rng.integers(0, 10, size=n)
    X[rng.uniform(size=n) < 0.1, 0] = np.nan
    y = ((X[:, 2] % 3 == 1) | (np.nan_to_num(X[:, 0]) > 1)).astype(
        np.float32)
    bst, path = _train_save(tmp_path, {"objective": "binary"}, X, y,
                            categorical_feature=[2])
    nb = _native(path)
    np.testing.assert_allclose(nb.predict(X), bst.predict(X),
                               rtol=1e-12, atol=1e-12)
    X2 = X[:5].copy()
    X2[0, 2] = 99
    X2[1, :] = np.nan
    np.testing.assert_allclose(nb.predict(X2), bst.predict(X2),
                               rtol=1e-12, atol=1e-12)


def test_linear_tree_parity(rng, tmp_path):
    X = rng.normal(size=(500, 4))
    y = 3 * X[:, 0] + X[:, 1] + 0.05 * rng.normal(size=500)
    ds = lgt.Dataset(X, label=y, params={"linear_tree": True, **CPU})
    bst = lgt.train({"objective": "regression", "linear_tree": True,
                     "linear_lambda": 0.1, "verbose": -1,
                     "min_data_in_leaf": 5, **CPU}, ds, num_boost_round=10)
    path = str(tmp_path / "m.txt")
    bst.save_model(path)
    np.testing.assert_allclose(_native(path).predict(X), bst.predict(X),
                               rtol=1e-10, atol=1e-10)


def test_leaf_index_and_iteration_window(rng, tmp_path):
    X = rng.normal(size=(300, 6))
    y = X[:, 0] - X[:, 1]
    bst, path = _train_save(tmp_path, {"objective": "regression"}, X, y)
    nb = _native(path)
    np.testing.assert_array_equal(nb.predict(X, pred_leaf=True),
                                  bst.predict(X, pred_leaf=True))
    np.testing.assert_allclose(
        nb.predict(X, raw_score=True, start_iteration=2, num_iteration=5),
        bst.predict(X, raw_score=True, start_iteration=2, num_iteration=5),
        rtol=1e-12, atol=1e-12)


def test_model_from_string(rng, tmp_path):
    from lightgbm_tpu_torch.native.capi import NativeBooster
    X = rng.normal(size=(200, 4))
    y = X[:, 0]
    bst, _ = _train_save(tmp_path, {"objective": "regression"}, X, y,
                         rounds=3)
    nb = NativeBooster(model_str=bst.model_to_string())
    np.testing.assert_allclose(nb.predict(X), bst.predict(X),
                               rtol=1e-12, atol=1e-12)


def test_rf_average_output(rng, tmp_path):
    X = rng.normal(size=(400, 6))
    y = (X[:, 0] > 0).astype(np.float32)
    bst, path = _train_save(tmp_path,
                            {"objective": "binary", "boosting": "rf",
                             "bagging_freq": 1, "bagging_fraction": 0.7},
                            X, y)
    np.testing.assert_allclose(_native(path).predict(X), bst.predict(X),
                               rtol=1e-12, atol=1e-12)


def test_special_transforms(rng, tmp_path):
    X = rng.normal(size=(300, 5))
    y = (X[:, 0] + 2.5) ** 2
    bst, path = _train_save(tmp_path,
                            {"objective": "regression", "reg_sqrt": True},
                            X, np.abs(y))
    np.testing.assert_allclose(_native(path).predict(X), bst.predict(X),
                               rtol=1e-10, atol=1e-10)
    y2 = rng.uniform(0.0, 1.0, size=300)
    bst2, path2 = _train_save(tmp_path, {"objective": "xentlambda"}, X, y2)
    np.testing.assert_allclose(_native(path2).predict(X), bst2.predict(X),
                               rtol=1e-10, atol=1e-12)


def test_garbage_model_rejected():
    from lightgbm_tpu_torch.native.capi import NativeBooster
    with pytest.raises(RuntimeError, match="parse"):
        NativeBooster(model_str="hello world\nnot a model\n")


def test_reference_golden_model():
    """A model trained by the reference CLI serves through the port's
    library as the reference predicted it, and as the port's host walk."""
    from conftest import GOLDEN_DIR, load_golden_csv
    _, X = load_golden_csv("test.csv")
    path = os.path.join(GOLDEN_DIR, "model.txt")
    got = _native(path).predict(X)
    np.testing.assert_allclose(got, np.loadtxt(os.path.join(GOLDEN_DIR,
                                                            "pred.txt")),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        got, lgt.Booster(params=CPU, model_file=path).predict(X),
        rtol=1e-12, atol=1e-12)


def test_predict_for_csr(rng, tmp_path):
    import scipy.sparse as sp
    X = np.zeros((300, 12))
    mask = rng.uniform(size=X.shape) < 0.2
    X[mask] = rng.normal(size=int(mask.sum()))
    y = (X[:, 0] - X[:, 1] > 0).astype(np.float64)
    bst, path = _train_save(tmp_path, {"objective": "binary"}, X, y)
    lib = get_lib()
    handle = ctypes.c_void_p()
    n_iter = ctypes.c_int()
    assert lib.LGBM_BoosterCreateFromModelfile(
        path.encode(), ctypes.byref(n_iter), ctypes.byref(handle)) == 0
    csr = sp.csr_matrix(X)
    indptr = np.asarray(csr.indptr, np.int32)
    indices = np.asarray(csr.indices, np.int32)
    data = np.asarray(csr.data, np.float64)
    out = np.zeros(300, np.float64)
    out_len = ctypes.c_int64()
    rc = lib.LGBM_BoosterPredictForCSR(
        handle, indptr.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(2),
        indices.ctypes.data_as(ctypes.c_void_p),
        data.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(1),
        ctypes.c_int64(len(indptr)), ctypes.c_int64(len(data)),
        ctypes.c_int64(X.shape[1]), ctypes.c_int(0), ctypes.c_int(0),
        ctypes.c_int(0), b"", ctypes.byref(out_len),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    assert rc == 0 and out_len.value == 300
    np.testing.assert_allclose(out, bst.predict(X), rtol=1e-6, atol=1e-9)
    lib.LGBM_BoosterFree(handle)


def test_model_parser_fuzz(rng, tmp_path):
    """Mutated and truncated model text through the port's library: a
    clean rejection or a load that predicts, never a crash."""
    X = rng.normal(size=(400, 6))
    X[:, 2] = rng.integers(0, 5, size=400)
    y = (X[:, 0] > 0).astype(np.float64)
    _, path = _train_save(tmp_path, {"objective": "binary",
                                     "num_leaves": 7}, X, y, rounds=4,
                          categorical_feature=[2])
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "_native_fuzz_driver.py"),
         native.library_path(), path],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-1500:]
    assert "FUZZ-OK" in out.stdout


# -- Arrow ------------------------------------------------------------------

# spec struct sizes on LP64: ArrowSchema 72 B, ArrowArray 88 B,
# ArrowArrayStream 40 B — allocate raw, pyarrow fills them
_SCHEMA_SZ, _ARRAY_SZ, _STREAM_SZ = 72, 88, 40


def _export_batch(batch):
    sbuf = ctypes.create_string_buffer(_SCHEMA_SZ)
    abuf = ctypes.create_string_buffer(_ARRAY_SZ)
    batch._export_to_c(ctypes.addressof(abuf), ctypes.addressof(sbuf))
    return abuf, sbuf


def _export_reader(reader):
    stbuf = ctypes.create_string_buffer(_STREAM_SZ)
    reader._export_to_c(ctypes.addressof(stbuf))
    return stbuf


@pytest.fixture(scope="module")
def arrow_data():
    pa = pytest.importorskip("pyarrow")
    rng = np.random.default_rng(3)
    n = 500
    x0 = rng.normal(size=n)
    x1 = rng.integers(0, 100, size=n).astype(np.int32)
    x2 = rng.normal(size=n).astype(np.float32)
    y = (x0 * 2 - x1 * 0.01 + rng.normal(scale=0.1, size=n)).astype(
        np.float32)
    mask = rng.uniform(size=n) < 0.1
    tbl = pa.table({"a": pa.array(x0), "b": pa.array(x1),
                    "c": pa.array(np.where(mask, np.nan, x2), mask=mask)})
    X = np.column_stack([x0, x1.astype(np.float64),
                         np.where(mask, np.nan, x2)])
    return pa, tbl, X, y


def _train_via_arrow(lib, pa, tbl, y, streaming):
    ds = ctypes.c_void_p()
    params = b"max_bin=63 min_data_in_leaf=5 verbosity=-1 device_type=cpu"
    if streaming:
        st = _export_reader(pa.RecordBatchReader.from_batches(
            tbl.schema, tbl.to_batches(max_chunksize=120)))
        rc = lib.LGBM_DatasetCreateFromArrowStream(
            ctypes.c_void_p(ctypes.addressof(st)), params, None,
            ctypes.byref(ds))
    else:
        abuf, sbuf = _export_batch(tbl.combine_chunks().to_batches()[0])
        rc = lib.LGBM_DatasetCreateFromArrow(
            ctypes.c_int64(1), ctypes.c_void_p(ctypes.addressof(abuf)),
            ctypes.c_void_p(ctypes.addressof(sbuf)), params, None,
            ctypes.byref(ds))
    assert rc == 0, lib.LGBM_GetLastError()
    la, ls = _export_batch(pa.record_batch({"y": pa.array(y)}))
    rc = lib.LGBM_DatasetSetFieldFromArrow(
        ds, b"label", ctypes.c_int64(1),
        ctypes.c_void_p(ctypes.addressof(la)),
        ctypes.c_void_p(ctypes.addressof(ls)))
    assert rc == 0, lib.LGBM_GetLastError()
    bst = ctypes.c_void_p()
    rc = lib.LGBM_BoosterCreate(
        ds, b"objective=regression num_leaves=15 min_data_in_leaf=5 "
            b"verbosity=-1 device_type=cpu", ctypes.byref(bst))
    assert rc == 0, lib.LGBM_GetLastError()
    fin = ctypes.c_int(0)
    for _ in range(6):
        assert lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)) == 0
    return ds, bst


def test_arrow_create_train_predict(arrow_data):
    pa, tbl, X, y = arrow_data
    lib = get_lib()
    ds, bst = _train_via_arrow(lib, pa, tbl, y, streaming=False)
    n, f = X.shape
    out_mat = np.zeros(n)
    out_len = ctypes.c_int64(0)
    Xc = np.ascontiguousarray(X)
    rc = lib.LGBM_BoosterPredictForMat(
        bst, Xc.ctypes.data_as(ctypes.c_void_p), 1, n, f, 1, 0, 0, -1,
        b"", ctypes.byref(out_len),
        out_mat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    assert rc == 0, lib.LGBM_GetLastError()
    # the model the ABI trained is the port's Python API's on the same rows
    ref = lgt.train({"objective": "regression", "num_leaves": 15,
                     "min_data_in_leaf": 5, "verbosity": -1, "max_bin": 63,
                     **CPU}, lgt.Dataset(X, label=y, params={"max_bin": 63,
                                                             **CPU}),
                    num_boost_round=6)
    np.testing.assert_array_equal(out_mat, ref.predict(X))
    abuf, sbuf = _export_batch(tbl.combine_chunks().to_batches()[0])
    out_arrow = np.zeros(n)
    rc = lib.LGBM_BoosterPredictForArrow(
        bst, ctypes.c_int64(1), ctypes.c_void_p(ctypes.addressof(abuf)),
        ctypes.c_void_p(ctypes.addressof(sbuf)), 0, 0, -1, b"",
        ctypes.byref(out_len),
        out_arrow.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    assert rc == 0, lib.LGBM_GetLastError()
    np.testing.assert_allclose(out_arrow, out_mat, rtol=1e-9)
    assert np.mean((out_mat - y) ** 2) < np.var(y) * 0.5
    lib.LGBM_BoosterFree(bst)
    lib.LGBM_DatasetFree(ds)


def test_arrow_stream_create_and_predict(arrow_data):
    pa, tbl, X, y = arrow_data
    lib = get_lib()
    ds, bst = _train_via_arrow(lib, pa, tbl, y, streaming=True)
    n = X.shape[0]
    out_len = ctypes.c_int64(0)
    out_stream = np.zeros(n)
    st = _export_reader(pa.RecordBatchReader.from_batches(
        tbl.schema, tbl.to_batches(max_chunksize=77)))
    rc = lib.LGBM_BoosterPredictForArrowStream(
        bst, ctypes.c_void_p(ctypes.addressof(st)), 0, 0, -1, b"",
        ctypes.byref(out_len),
        out_stream.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    assert rc == 0, lib.LGBM_GetLastError()
    assert out_len.value == n and np.isfinite(out_stream).all()
    assert np.mean((out_stream - y) ** 2) < np.var(y) * 0.5
    lib.LGBM_BoosterFree(bst)
    lib.LGBM_DatasetFree(ds)


def test_arrow_unsupported_format_errors(arrow_data):
    pa = arrow_data[0]
    lib = get_lib()
    abuf, sbuf = _export_batch(pa.table({"s": pa.array(["a", "b", "c"])})
                               .to_batches()[0])
    ds = ctypes.c_void_p()
    rc = lib.LGBM_DatasetCreateFromArrow(
        ctypes.c_int64(1), ctypes.c_void_p(ctypes.addressof(abuf)),
        ctypes.c_void_p(ctypes.addressof(sbuf)), b"", None,
        ctypes.byref(ds))
    assert rc != 0
    lib.LGBM_GetLastError.restype = ctypes.c_char_p
    assert b"format" in lib.LGBM_GetLastError()


# -- TreeSHAP ----------------------------------------------------------------

@pytest.fixture(scope="module")
def shap_models():
    rng = np.random.default_rng(17)
    n = 800
    X = rng.normal(size=(n, 6))
    X[:, 2] = rng.integers(0, 8, size=n)
    X[rng.uniform(size=n) < 0.08, 0] = np.nan
    y = X[:, 1] * 2 + (X[:, 2] % 3 == 1) - np.nan_to_num(X[:, 0])
    yc = np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])).astype(np.float64)
    out = {"X": X}
    for name, params, label in (
            ("l2_categorical", {"objective": "regression"}, y),
            ("multiclass", {"objective": "multiclass", "num_class": 3}, yc)):
        out[name] = lgt.train(
            {**params, "num_leaves": 15, "min_data_in_leaf": 5,
             "verbosity": -1, **CPU},
            lgt.Dataset(X, label=label, categorical_feature=[2]),
            num_boost_round=5)
    return out


@pytest.mark.parametrize("name", ["l2_categorical", "multiclass"])
def test_native_tree_shap(shap_models, name, monkeypatch):
    X, bst = shap_models["X"], shap_models[name]
    got = bst.predict(X, pred_contrib=True)
    jax_got = lgb.Booster(model_str=bst.model_to_string()).predict(
        X, pred_contrib=True)
    np.testing.assert_array_equal(got, jax_got)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    walk = bst.predict(X, pred_contrib=True)
    np.testing.assert_allclose(got, walk, rtol=1e-9, atol=1e-12)
    raw = bst.predict(X, raw_score=True).reshape(len(X), -1)
    K = raw.shape[1]
    np.testing.assert_allclose(got.reshape(len(X), K, -1).sum(axis=2), raw,
                               rtol=1e-9, atol=1e-9)


def test_numpy_bodies_stand_in_without_the_library(monkeypatch):
    """Without the library (no g++, or LIGHTGBM_TPU_NO_NATIVE) the public
    names answer with the numpy bodies."""
    monkeypatch.setattr(native, "get_lib", lambda: None)
    got = native.parse_dense_chunk(b"1,NA\n\n3\n", ",", 2)
    np.testing.assert_array_equal(got, [[1.0, np.nan], [3.0, np.nan]])
    assert native.count_cols(b"\n\n1,2,3\n", ",") == 3
    assert native.parse_libsvm_chunk(b"1 2:0.5\n")[4] == 2


def test_no_native_env_forces_the_numpy_bodies():
    code = ("import os, sys; sys.path.insert(0, sys.argv[1]); "
            "os.environ['LIGHTGBM_TPU_NO_NATIVE'] = '1'; "
            "from lightgbm_tpu_torch import native; "
            "assert native.get_lib() is None; print('NO-NATIVE-OK')")
    out = subprocess.run([sys.executable, "-c", code, REPO],
                         capture_output=True, text=True, timeout=120)
    assert "NO-NATIVE-OK" in out.stdout, out.stderr[-2000:]


# -- the build ---------------------------------------------------------------

_BUILD_CODE = r"""
import ctypes, sys
sys.path.insert(0, sys.argv[2])
from lightgbm_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
path = native.build()
lib = ctypes.CDLL(path)
assert lib.lgbm_count_cols(b"1,2,3\n", 6, b","[0]) == 3
print("BUILT", path)
"""


def test_two_processes_build_one_library(tmp_path):
    """Two processes asking for the library at once under the build lock
    leave one library, named by the hash of its sources, which loads."""
    build_dir = tmp_path / "native"
    script = tmp_path / "build.py"
    script.write_text(_BUILD_CODE)
    procs = [subprocess.Popen([sys.executable, str(script), str(build_dir),
                               REPO], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    paths = {out.split("BUILT ")[1].strip() for out, _ in outs}
    libs = sorted(f for f in os.listdir(build_dir) if f.endswith(".so"))
    assert len(paths) == 1 and len(libs) == 1
    assert libs[0] == os.path.basename(native.library_path())
    assert sorted(os.listdir(build_dir)) == ["build.lock", libs[0]]
