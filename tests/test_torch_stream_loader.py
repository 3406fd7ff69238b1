"""The PyTorch port's text chunk parsers, stream follower and two-round
loader (``lightgbm_tpu_torch/native``, ``io/stream_loader.py``) against
the JAX package's on the same numpy-seeded inputs.

Both packages run their numpy parsers (``LIGHTGBM_TPU_NO_NATIVE=1``,
each library handle reset; the C++ bodies are held to each other on the
same corpus by ``tests/test_torch_native.py``): the parsers give the same
arrays (NaN where NaN) on a corpus of NaN tokens, blanks, junk, blank
lines, LibSVM ``qid:`` and duplicate ids; two followers fed the same
appended bytes (torn tails, ragged and unparseable lines, the skip
budget) give the same matrix at every poll, the same cursor and the same
``.deadletter`` bytes; ``load_binned_two_round`` gives the JAX dataset's
bin bounds, used features, bins (the port's row-major ``[R, F]`` against
the JAX feature-major ``[F, R]`` transposed), multi-value pairs and
metadata over CSV with a header and label/weight/group/ignore columns,
side files, TSV, LibSVM (dense and multi-value), chunks of 64 bytes, a
row sample under the row count and a validation file with
``reference=``; and ``train`` of L2 from a file with ``two_round=true``
gives the JAX model text string for string.
"""
import os

import numpy as np
import pytest
from test_torch_model_io import _no_params

import lightgbm_tpu as lgb
import lightgbm_tpu.native as jnative
import lightgbm_tpu_torch as lgt
import lightgbm_tpu_torch.native as tnative
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.stream_loader import StreamFollower as JFollower
from lightgbm_tpu.io.stream_loader import \
    load_binned_two_round as j_two_round
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.stream_loader import StreamFollower as TFollower
from lightgbm_tpu_torch.io.stream_loader import \
    load_binned_two_round as t_two_round

CPU = {"device_type": "cpu"}


@pytest.fixture(autouse=True)
def jax_numpy_parser(monkeypatch):
    """Both packages' numpy parsers, whatever another test of this
    process built: each library handle reset and the build refused."""
    monkeypatch.setenv("LIGHTGBM_TPU_NO_NATIVE", "1")
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, \
        (a.shape, b.shape, a.dtype, b.dtype)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), (a, b)


DENSE_CORPUS = {
    "nan_tokens": b"1.5,na,NaN\nnull,?,-3\n NA , nan ,7e2\n",
    "blanks_and_junk": b"1,,3\n,x,\n4, 5 ,abc\n1e400,-inf,0x10\n",
    "blank_lines": b"\n1,2,3\n\n   \n4,5,6\n",
    "short_and_long": b"1,2\n3,4,5,6,7\n8\n",
    "no_final_newline": b"1,2,3\n4,5,6",
    "underscores_and_signs": b"+1,-0,1_0\n.5,5.,-.25e-3\n",
}


@pytest.mark.parametrize("name", sorted(DENSE_CORPUS))
@pytest.mark.parametrize("sep", [",", "\t"])
def test_parse_dense_chunk_matches_jax(name, sep):
    chunk = DENSE_CORPUS[name].replace(b",", sep.encode())
    for n_cols in (1, 3, 5):
        _same(tnative.parse_dense_chunk(chunk, sep, n_cols),
              jnative.parse_dense_chunk(chunk, sep, n_cols))


LIBSVM_CORPUS = {
    "qid_and_duplicates": b"2 qid:7 1:0.5 3:1\n0 qid:7 3:2 3:4 0:1\n",
    "junk_tokens": b"1 a:1 2:b 4:x 5:1.5 junk 7:\nbad 1:1\n",
    "blank_lines": b"\n\n1 0:1\n  \n0 9:2\n",
    "labels_only": b"1\n0\n-1.5\n",
    "zero_and_one_based": b"1 0:0.1 1:0.2\n0 1:0.3 10:-1e-3\n",
}


@pytest.mark.parametrize("name", sorted(LIBSVM_CORPUS))
def test_parse_libsvm_chunk_matches_jax(name):
    got = tnative.parse_libsvm_chunk(LIBSVM_CORPUS[name])
    want = jnative.parse_libsvm_chunk(LIBSVM_CORPUS[name])
    for a, b in zip(got[:4], want[:4]):
        _same(a, b)
    assert got[4] == want[4]


@pytest.mark.parametrize("chunk_bytes", [1, 7, 64, 1 << 20])
@pytest.mark.parametrize("skip", [0, 2])
def test_iter_file_chunks_matches_jax(tmp_path, chunk_bytes, skip):
    path = str(tmp_path / "f.csv")
    with open(path, "wb") as fh:
        fh.write(b"h1,h2\n1,2\n\n3,4\n55555,666666666\n7,8")
    got = list(tnative.iter_file_chunks(path, skip, chunk_bytes))
    assert got == list(jnative.iter_file_chunks(path, skip, chunk_bytes))
    assert b"".join(got).replace(b"\n", b"") != b""


# ---------------------------------------------------------------------------
# the stream follower
# ---------------------------------------------------------------------------

def _rows(n, f=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] > 0).astype(np.float32)
    return np.column_stack([y, X])


def _lines(block):
    return "".join(",".join(repr(float(v)) for v in r) + "\n"
                   for r in block).encode()


# each step appends its bytes to the stream, then both followers poll
FOLLOW_STEPS = [
    _lines(_rows(4)),
    b"0.5,0.1",                                  # a torn tail
    b",1,2,3,4,5\n",                             # ... completed
    b"",                                         # nothing new
    b"0.5,0.25\n" + _lines(_rows(3, seed=1)),    # ragged, then good rows
    b"not,numbers,at,all,x,y,z\n",               # unparseable only
    b"1,2,3,4,5,6,7\n,,,,,,\nna,?,null,,nan,NA,\n" + _lines(
        _rows(2, seed=2)),                       # all-NaN rows among good
    b"1;2;3\n",                                  # wrong separator
    b"a\nb\n",                                   # past the skip budget
]


def _follower_trace(cls, path, max_skips):
    f = cls(path, max_skips=max_skips)
    trace = []
    if os.path.exists(path):
        os.remove(path)
    if os.path.exists(f.deadletter_path):
        os.remove(f.deadletter_path)
    open(path, "wb").close()
    for step in FOLLOW_STEPS:
        with open(path, "ab") as fh:
            fh.write(step)
        try:
            got = f.poll()
        except ValueError as e:
            trace.append(("raised", str(e)))
            break
        trace.append((got, f.offset, f.rows_seen, f.rows_skipped,
                      f.n_cols))
    with open(f.deadletter_path, "rb") as fh:
        dead = fh.read()
    return trace, dead


@pytest.mark.parametrize("max_skips", [6, 64])
def test_stream_follower_matches_jax(tmp_path, max_skips):
    t_trace, t_dead = _follower_trace(TFollower, str(tmp_path / "s.csv"),
                                      max_skips)
    j_trace, j_dead = _follower_trace(JFollower, str(tmp_path / "s.csv"),
                                      max_skips)
    assert len(t_trace) == len(j_trace)
    for a, b in zip(t_trace, j_trace):
        if a[0] is None or b[0] is None or isinstance(a[0], str):
            assert a == b
            continue
        _same(a[0], b[0])
        assert a[1:] == b[1:]
    assert t_dead == j_dead
    assert (t_trace[-1][0] == "raised") == (max_skips == 6)
    assert b"0.5,0.25\n" in t_dead and b"1;2;3\n" in t_dead
    # the poll that completes the torn line returns that one row
    assert t_trace[2][0].shape == (1, 7) and t_trace[1][0] is None


# ---------------------------------------------------------------------------
# the two-round loader
# ---------------------------------------------------------------------------

def _write(path, arr, sep=",", header=None):
    with open(path, "w") as fh:
        if header is not None:
            fh.write(sep.join(header) + "\n")
        for r in arr:
            fh.write(sep.join("" if np.isnan(v) else f"{v:.9g}"
                              for v in r) + "\n")


def _write_libsvm(path, y, X, qid=False):
    with open(path, "w") as fh:
        for i, (lab, row) in enumerate(zip(y, X)):
            toks = [f"{lab:g}"] + (["qid:%d" % (i // 7)] if qid else [])
            toks += [f"{j}:{v:.9g}" for j, v in enumerate(row) if v != 0]
            fh.write(" ".join(toks) + "\n")


def _table(rng, n, f=5, nan_share=0.05):
    X = rng.normal(size=(n, f))
    X[:, 1] = np.round(X[:, 1] * 2)                  # ties
    X[rng.random(X.shape) < nan_share] = np.nan
    y = X[:, 0] * 0.7 + np.nan_to_num(X[:, 2]) + 0.1 * rng.normal(size=n)
    return X, y


def _sparse_table(rng, n, f=12):
    X = rng.normal(size=(n, f))
    X[rng.random(X.shape) < 0.8] = 0.0
    return X, (X[:, 0] + X[:, 3] > 0).astype(np.float64)


def _case_csv_header_columns(tmp, rng):
    X, y = _table(rng, 700)
    w = rng.uniform(0.5, 2.0, size=700)
    q = np.repeat(np.arange(70), 10).astype(np.float64)
    junk = rng.normal(size=700)
    arr = np.column_stack([X[:, :2], y, w, junk, q, X[:, 2:]])
    names = ["a", "b", "target", "wt", "junk", "qid", "c", "d", "e"]
    path = os.path.join(tmp, "h.csv")
    _write(path, arr, header=names)
    return path, {"header": True, "label_column": "name:target",
                  "weight_column": "name:wt", "group_column": "name:qid",
                  "ignore_column": "name:junk"}, {}


def _case_side_files(tmp, rng):
    X, y = _table(rng, 600)
    path = os.path.join(tmp, "side.csv")
    _write(path, np.column_stack([y, X]))
    np.savetxt(path + ".weight", rng.uniform(0.5, 1.5, size=600),
               fmt="%.6f")
    np.savetxt(path + ".query", np.full(60, 10), fmt="%d")
    np.savetxt(path + ".position", rng.integers(0, 5, size=600), fmt="%d")
    return path, {}, {}


def _case_tsv(tmp, rng):
    X, y = _table(rng, 500)
    path = os.path.join(tmp, "d.tsv")
    _write(path, np.column_stack([y, X]), sep="\t")
    return path, {}, {}


def _case_tiny_chunks(tmp, rng):
    X, y = _table(rng, 300, f=4)
    path = os.path.join(tmp, "tiny.csv")
    _write(path, np.column_stack([y, X]))
    return path, {}, {"chunk_bytes": 64}


def _case_reservoir_sample(tmp, rng):
    X, y = _table(rng, 1500, f=4)
    path = os.path.join(tmp, "res.csv")
    _write(path, np.column_stack([y, X]))
    return path, {"bin_construct_sample_cnt": 400,
                  "min_data_in_leaf": 40}, {"chunk_bytes": 4096}


def _case_categorical(tmp, rng):
    X, y = _table(rng, 600, f=4, nan_share=0.0)
    X[:, 2] = rng.integers(0, 6, size=600)
    path = os.path.join(tmp, "cat.csv")
    _write(path, np.column_stack([y, X]))
    return path, {"categorical_feature": "2"}, {}


def _case_libsvm(tmp, rng):
    X, y = _sparse_table(rng, 500)
    path = os.path.join(tmp, "d.svm")
    _write_libsvm(path, y, X, qid=True)
    return path, {"bin_construct_sample_cnt": 300}, {"chunk_bytes": 512}


def _case_libsvm_multival(tmp, rng):
    X, y = _sparse_table(rng, 500)
    path = os.path.join(tmp, "mv.svm")
    _write_libsvm(path, y, X)
    with open(path, "a") as fh:
        fh.write("1 3:0.25 3:-0.5 0:1\n")           # a duplicate id
    return path, {"tpu_sparse_storage": "multival"}, {}


TWO_ROUND_CASES = {
    "csv_header_columns": _case_csv_header_columns,
    "side_files": _case_side_files,
    "tsv": _case_tsv,
    "tiny_chunks": _case_tiny_chunks,
    "reservoir_sample": _case_reservoir_sample,
    "categorical": _case_categorical,
    "libsvm": _case_libsvm,
    "libsvm_multival": _case_libsvm_multival,
}


def _mapper_state(m):
    return {k: v for k, v in vars(m).items() if not k.startswith("_")}


def _assert_same_dataset(t, j):
    assert t.num_data == j.num_data
    assert t.num_total_features == j.num_total_features
    assert t.max_bin == j.max_bin
    assert list(t.feature_names) == list(j.feature_names)
    _same(t.used_feature_map, j.used_feature_map)
    assert len(t.bin_mappers) == len(j.bin_mappers)
    for mt, mj in zip(t.bin_mappers, j.bin_mappers):
        st, sj = _mapper_state(mt), _mapper_state(mj)
        assert set(st) == set(sj)
        for k in st:
            if isinstance(st[k], np.ndarray):
                _same(st[k], sj[k])
            else:
                assert st[k] == sj[k], k
    if j.bins is None:
        assert t.bins is None
    else:
        _same(t.bins, np.ascontiguousarray(j.bins.T))
    jmv = getattr(j, "bins_mv", None)
    if jmv is None:
        assert t.bins_mv is None
    else:
        for a, b in zip(t.bins_mv, jmv):
            _same(a, b)
    mt, mj = t.metadata, j.metadata
    for field in ("label", "weight", "query_boundaries", "position"):
        a, b = getattr(mt, field), getattr(mj, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", sorted(TWO_ROUND_CASES))
def test_two_round_dataset_matches_jax(tmp_path, case):
    rng = np.random.default_rng(sorted(TWO_ROUND_CASES).index(case))
    path, params, kw = TWO_ROUND_CASES[case](str(tmp_path), rng)
    params = dict(params, two_round=True, verbose=-1)
    t = t_two_round(path, TConfig(params), **kw)
    j = j_two_round(path, JConfig(params), **kw)
    _assert_same_dataset(t, j)
    md = t.metadata
    if case in ("csv_header_columns", "side_files"):
        assert md.weight is not None and md.query_boundaries is not None
    assert (md.position is not None) == (case == "side_files")
    assert (t.bins_mv is not None) == (case == "libsvm_multival")
    # through Dataset too: the file branch's two-round exit
    td = lgt.Dataset(path, params=dict(params, **CPU)).construct().binned
    jd = lgb.Dataset(path, params=params).construct().binned
    _assert_same_dataset(td, jd)


def test_two_round_validation_file_uses_reference(tmp_path):
    rng = np.random.default_rng(40)
    X, y = _table(rng, 900)
    tr, va = str(tmp_path / "tr.csv"), str(tmp_path / "va.csv")
    _write(tr, np.column_stack([y[:600], X[:600]]))
    Xv = X[600:] * 3.0                        # outside the train range
    _write(va, np.column_stack([y[600:], Xv]))
    params = {"two_round": True, "verbose": -1}
    t_train = lgt.Dataset(tr, params=dict(params, **CPU))
    j_train = lgb.Dataset(tr, params=params)
    tv = lgt.Dataset(va, reference=t_train,
                     params=dict(params, **CPU)).construct().binned
    jv = lgb.Dataset(va, reference=j_train,
                     params=params).construct().binned
    _assert_same_dataset(tv, jv)
    assert tv.bin_mappers is t_train.binned.bin_mappers


@pytest.mark.parametrize("fmt", ["csv", "libsvm"])
def test_two_round_l2_training_gives_jax_text(tmp_path, fmt):
    rng = np.random.default_rng(41)
    if fmt == "csv":
        X, y = _table(rng, 1200)
        path = str(tmp_path / "l2.csv")
        _write(path, np.column_stack([y, X]))
    else:
        X, y = _sparse_table(rng, 1200)
        y = y + X[:, 5]
        path = str(tmp_path / "l2.svm")
        _write_libsvm(path, y, X)
    params = {"objective": "regression", "num_leaves": 15,
              "min_data_in_leaf": 10, "two_round": True, "verbose": -1,
              "bin_construct_sample_cnt": 800}
    jb = lgb.train(params, lgb.Dataset(path, params=params),
                   num_boost_round=4)
    tb = lgt.train(dict(params, **CPU),
                   lgt.Dataset(path, params=dict(params, **CPU)),
                   num_boost_round=4)
    assert _no_params(tb.model_to_string()) == \
        _no_params(jb.model_to_string())


def test_in_memory_dataset_ignores_two_round():
    """``two_round`` names the way a FILE is loaded: a matrix bins as it
    would without it, in both packages."""
    rng = np.random.default_rng(42)
    X, y = _table(rng, 400)
    params = {"two_round": True, "verbose": -1}
    tj = lgb.Dataset(X, label=y, params=params).construct().binned
    tj0 = lgb.Dataset(X, label=y).construct().binned
    tt = lgt.Dataset(X, label=y, params=dict(params, **CPU)).construct()
    tt0 = lgt.Dataset(X, label=y, params=CPU).construct()
    np.testing.assert_array_equal(tj.bins, tj0.bins)
    np.testing.assert_array_equal(tt.binned.bins, tt0.binned.bins)
    np.testing.assert_array_equal(tt.binned.bins, tj.bins.T)
    bst = lgt.train(dict(params, objective="regression", **CPU), tt,
                    num_boost_round=1)
    assert bst.num_trees() == 1
