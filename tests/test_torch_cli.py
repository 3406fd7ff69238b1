"""The PyTorch port's command-line application against the JAX package's.

The cases of ``tests/test_cli.py`` run through ``lightgbm_tpu_torch.cli``
and ``lightgbm_tpu.cli`` on the same files (numpy data from a seed, 300
rows, 6 features, NaNs in one column), both on the CPU. L2 models are the
JAX package's text for text (bar the parameters block, which names each
package's device); binary models are held to the binary standard of
``tests/test_torch_multiclass.py`` (ROADMAP C1(a)); prediction, refit and
convert_model run both CLIs over the same model file and give the same
files line for line (the generated source bar its first comment line),
and the compiled source is within 1e-12 of the host walk. The R shim's
contract (``tests/test_r_layer.py``: conf files, label-first CSVs with a
``.weight`` sidecar, tab-separated predictions, the ``valid_N's metric``
lines ``lgb.cv`` parses) holds through the port's CLI with the JAX CLI's
results. ``tpu_fallback_to_cpu=true`` is refused, and a run that names no
device asks for the card, which this box has not. Each CLI runs in the
test's process; one case starts ``python -m lightgbm_tpu_torch``.
"""
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
from test_torch_model_io import _no_params
from test_torch_multiclass import assert_trees_to_binary_standard

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.cli import run as jax_run
from lightgbm_tpu_torch.cli import run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device_type": "cpu"}
N, F = 300, 6


def _write_csv(path, X, y):
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.8g")


def _read(path):
    with open(path) as fh:
        return fh.read()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(23)
    X = rng.normal(size=(N, F))
    X[rng.uniform(size=N) < 0.05, 3] = np.nan
    yb = (X[:, 0] + X[:, 1] ** 2 > 0.5).astype(np.float64)
    yr = X[:, 0] * 2 - np.nan_to_num(X[:, 3]) + 0.1 * rng.normal(size=N)
    d = tmp_path_factory.mktemp("cli")
    paths = {"binary": str(d / "train.csv"), "l2": str(d / "reg.csv")}
    _write_csv(paths["binary"], X, yb)
    _write_csv(paths["l2"], X, yr)
    # the same rows as libsvm-free CSV read back (the %.8g round trip)
    Xf = np.loadtxt(paths["binary"], delimiter=",")[:, 1:]
    return {"dir": d, "X": Xf, "yb": yb, "yr": yr, **paths}


def _train_both(tmp_path, args):
    """Train with both CLIs; returns the (jax, port) model paths."""
    out = []
    for name, fn, extra in (("jax", jax_run, []),
                            ("port", run, ["device_type=cpu"])):
        model = str(tmp_path / f"{name}_model.txt")
        assert fn([*args, f"output_model={model}", *extra]) == 0, name
        out.append(model)
    return out


def test_cli_train_and_predict(tmp_path, data):
    conf = tmp_path / "train.conf"
    conf.write_text(
        "task = train\n"
        "objective = binary  # comment here\n"
        f"data = {data['binary']}\n"
        "num_iterations = 8\n"
        "num_leaves = 7\n"
        "min_data_in_leaf = 5\n"
        "verbosity = -1\n")
    jm, tm = _train_both(tmp_path, [f"config={conf}"])
    jb = lgb.Booster(model_file=jm)
    tb = lgt.Booster(params=CPU, model_file=tm)
    assert tb.num_trees() == 8
    assert_trees_to_binary_standard(jb, tb, data["X"], g_max=1.0,
                                    h_max=0.25)

    # the predict task over the same model file: line for line
    outs = []
    for name, fn, extra in (("jax", jax_run, []),
                            ("port", run, ["device_type=cpu"])):
        out = str(tmp_path / f"{name}_preds.txt")
        assert fn(["task=predict", f"data={data['binary']}",
                   f"input_model={jm}", f"output_result={out}",
                   "verbosity=-1", *extra]) == 0
        outs.append(_read(out))
    assert outs[0] == outs[1]
    preds = np.loadtxt(tmp_path / "port_preds.txt")
    assert preds.shape == (N,)
    assert ((preds > 0.5) == data["yb"]).mean() > 0.85

    # CLI args override config-file values
    model2 = str(tmp_path / "model2.txt")
    assert run([f"config={conf}", "num_iterations=2",
                f"output_model={model2}", "device_type=cpu"]) == 0
    assert lgt.Booster(params=CPU, model_file=model2).num_trees() == 2


def test_cli_l2_text_matches_jax(tmp_path, data):
    """L2 through the train task, with a validation file, metric_freq and
    gain importances: the JAX package's text."""
    jm, tm = _train_both(tmp_path, [
        "task=train", f"data={data['l2']}", "objective=regression",
        "num_iterations=4", "num_leaves=15", "min_data_in_leaf=5",
        f"valid={data['l2']}", "metric_freq=1", "verbosity=-1",
        "saved_feature_importance_type=1"])
    assert _no_params(_read(tm)) == _no_params(_read(jm))


def test_cli_unknown_task(data):
    assert jax_run(["task=nope", f"data={data['binary']}"]) == 1
    assert run(["task=nope", f"data={data['binary']}",
                "device_type=cpu"]) == 1


def test_cli_module_entry(tmp_path, data):
    """``python -m lightgbm_tpu_torch`` trains in a child process."""
    model_path = str(tmp_path / "m.txt")
    r = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", "task=train",
         f"data={data['l2']}", "objective=regression", "num_iterations=2",
         "num_leaves=4", "min_data_in_leaf=5", "verbosity=-1",
         "device_type=cpu", f"output_model={model_path}"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert lgt.Booster(params=CPU, model_file=model_path).num_trees() == 2


def test_save_binary_roundtrip(tmp_path):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(200, 5))
    y = X[:, 0] * 2 + 0.1 * rng.normal(size=200)
    w = rng.uniform(0.5, 2.0, size=200)
    ds = lgt.Dataset(X, label=y, weight=w,
                     params={"min_data_in_leaf": 5, **CPU}).construct()
    bin_path = str(tmp_path / "data.bin")
    ds.save_binary(bin_path)
    loaded = lgt.Dataset(bin_path, params=CPU).construct()
    assert loaded.num_data() == 200 and loaded.num_feature() == 5
    np.testing.assert_array_equal(loaded.get_label(), y.astype(np.float32))
    np.testing.assert_array_equal(loaded.get_weight(), w.astype(np.float32))
    np.testing.assert_array_equal(loaded.binned.bins, ds.binned.bins)
    # training from the binary file gives the JAX package's model from
    # the matrix (the binary carries the weight column)
    params = {"objective": "regression", "num_leaves": 7,
              "min_data_in_leaf": 5, "verbosity": -1}
    jb = lgb.train(params, lgb.Dataset(X, label=y, weight=w),
                   num_boost_round=3)
    tb = lgt.train({**params, **CPU}, lgt.Dataset(bin_path, params=CPU),
                   num_boost_round=3)
    assert _no_params(tb.model_to_string()) == \
        _no_params(jb.model_to_string())


def test_cli_save_binary_task(data, tmp_path):
    src = str(tmp_path / "sb.csv")
    shutil.copy(data["binary"], src)
    assert run(["task=save_binary", f"data={src}", "verbosity=-1",
                "device_type=cpu"]) == 0
    ds = lgt.Dataset(src + ".bin", params=CPU).construct()
    assert ds.num_data() == N
    ref = lgb.Dataset(src, params={"verbosity": -1}).construct()
    # the JAX package holds its bins feature-major
    np.testing.assert_array_equal(np.asarray(ds.binned.bins),
                                  np.asarray(ref.binned.bins).T)


def test_refit_matches_jax():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(400, 6))
    y = X[:, 0] + 0.5 * X[:, 1] + 0.05 * rng.normal(size=400)
    params = {"objective": "regression", "num_leaves": 15,
              "min_data_in_leaf": 5, "verbosity": -1}
    jb = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=5)
    tb = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y),
                   num_boost_round=5)
    assert _no_params(tb.model_to_string()) == \
        _no_params(jb.model_to_string())
    y2 = y + 1.0
    for decay in (0.0, 0.9):
        jr = jb.refit(X, y2, decay_rate=decay)
        tr = tb.refit(X, y2, decay_rate=decay)
        assert _no_params(tr.model_to_string()) == \
            _no_params(jr.model_to_string())
    np.testing.assert_array_equal(tb.refit(X, y2, decay_rate=1.0)
                                  .predict(X), tb.predict(X))


def test_cli_refit_task(tmp_path, data):
    jm, _ = _train_both(tmp_path, [
        "task=train", f"data={data['l2']}", "objective=regression",
        "num_iterations=5", "num_leaves=7", "min_data_in_leaf=5",
        "verbosity=-1"])
    texts = []
    for name, fn, extra in (("jax", jax_run, []),
                            ("port", run, ["device_type=cpu"])):
        out = str(tmp_path / f"{name}_refit.txt")
        assert fn(["task=refit", f"data={data['l2']}", f"input_model={jm}",
                   f"output_model={out}", "verbosity=-1", *extra]) == 0
        texts.append(_no_params(_read(out)))
    assert texts[0] == texts[1]
    assert lgt.Booster(params=CPU, model_file=str(
        tmp_path / "port_refit.txt")).num_trees() == 5


_HARNESS = (
    '#include <cstdio>\n#include "model.cpp"\n'
    "int main() {\n"
    "  double arr[6]; double out[1];\n"
    "  while (scanf(\"%lf %lf %lf %lf %lf %lf\", arr, arr+1, arr+2,"
    " arr+3, arr+4, arr+5) == 6) {\n"
    "    lightgbm_tpu_model::PredictRaw(arr, out);\n"
    "    printf(\"%.17g\\n\", out[0]);\n"
    "  }\n  return 0;\n}\n")


def test_convert_model(tmp_path, data):
    jm, _ = _train_both(tmp_path, [
        "task=train", f"data={data['binary']}", "objective=binary",
        "num_iterations=3", "num_leaves=7", "min_data_in_leaf=5",
        "verbosity=-1"])
    srcs = []
    for name, fn, extra in (("jax", jax_run, []),
                            ("port", run, ["device_type=cpu"])):
        out = str(tmp_path / f"{name}_model.cpp")
        assert fn(["task=convert_model", f"input_model={jm}",
                   f"convert_model={out}", "verbosity=-1", *extra]) == 0
        srcs.append(_read(out).split("\n"))
    assert srcs[1][0] == \
        "// Generated by lightgbm_tpu_torch (task=convert_model)."
    assert srcs[1][1:] == srcs[0][1:]

    shutil.copy(tmp_path / "port_model.cpp", tmp_path / "model.cpp")
    (tmp_path / "harness.cpp").write_text(_HARNESS)
    exe = str(tmp_path / "model_exe")
    subprocess.run(["g++", "-O0", "-o", exe, "harness.cpp"], check=True,
                   cwd=tmp_path, timeout=120)
    # NaN-free rows: scanf reads no "nan" portably
    rows = data["X"][~np.isnan(data["X"]).any(axis=1)][:40]
    inp = "\n".join(" ".join(repr(float(v)) for v in row) for row in rows)
    r = subprocess.run([exe], input=inp, capture_output=True, text=True,
                       timeout=60)
    got = np.asarray([float(v) for v in r.stdout.split()])
    want = lgt.Booster(params=CPU, model_file=jm).predict(rows,
                                                          raw_score=True)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_cli_snapshots_are_written_and_pruned(tmp_path, data):
    out = str(tmp_path / "snap.txt")
    assert run(["task=train", f"data={data['l2']}", "objective=regression",
                "num_iterations=5", "num_leaves=7", "min_data_in_leaf=5",
                "snapshot_freq=1", "snapshot_keep_last=2", "verbosity=-1",
                f"output_model={out}", "device_type=cpu"]) == 0
    snaps = sorted(f for f in os.listdir(tmp_path) if ".snapshot_iter_" in f)
    assert snaps == ["snap.txt.snapshot_iter_4", "snap.txt.snapshot_iter_5"]
    last = lgt.Booster(params=CPU, model_file=str(
        tmp_path / "snap.txt.snapshot_iter_5"))
    assert _no_params(last.model_to_string()) == _no_params(_read(out))


@pytest.fixture
def captured_log():
    lines = []
    lgt.register_logger(lines.append)
    yield lines
    lgt.register_logger(None)


def test_cli_refuses_tpu_fallback_to_cpu(data, tmp_path, captured_log):
    out = str(tmp_path / "m.txt")
    assert run(["task=train", f"data={data['l2']}", "num_iterations=1",
                "tpu_fallback_to_cpu=true", f"output_model={out}"]) == 1
    assert not os.path.exists(out)
    assert any("Met Exceptions" in m and "tpu_fallback_to_cpu" in m
               for m in captured_log), captured_log


@pytest.mark.skipif(lgt.Config({}).device_type != "cuda",
                    reason="LIGHTGBM_TPU_PLATFORM=cpu set at import")
def test_cli_without_device_type_asks_for_the_card(data, tmp_path,
                                                   captured_log):
    """A run that names no device trains on the card; this box has none,
    so it fails and does not fall back to the CPU."""
    import torch
    out = str(tmp_path / "m.txt")
    rc = run(["task=train", f"data={data['l2']}", "num_iterations=1",
              f"output_model={out}"])
    if torch.cuda.is_available():   # pragma: no cover - on the card
        assert rc == 0 and "[device_type: cuda]" in _read(out)
        return
    assert rc == 1 and not os.path.exists(out)
    assert any("device_type='cuda'" in m for m in captured_log), captured_log


def test_r_shim_contract(tmp_path):
    """The files and conf lines the R shim writes (R-package/R) through
    the port's CLI give the JAX CLI's results."""
    rng = np.random.default_rng(31)
    n, f = 400, 5
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + X[:, 1] > 0).astype(float)
    w = rng.uniform(0.5, 1.5, size=n)
    rows = np.column_stack([y, X])
    trf, vaf = tmp_path / "fold_train.csv", tmp_path / "fold_valid.csv"
    np.savetxt(trf, rows[: n // 2], delimiter=",")
    np.savetxt(vaf, rows[n // 2:], delimiter=",")
    (tmp_path / "fold_train.csv.weight").write_text(
        "\n".join(repr(float(v)) for v in w[: n // 2]) + "\n")
    results = {}
    for name, fn in (("jax", jax_run), ("port", run)):
        model_file = tmp_path / f"{name}_model.txt"
        conf = tmp_path / f"{name}_train.conf"
        conf.write_text("\n".join([
            "task = train", f"data = {trf}", f"valid = {vaf}",
            "num_iterations = 6", f"output_model = {model_file}",
            "metric_freq = 1", "verbosity = 1", "objective = binary",
            "metric = binary_logloss", "num_leaves = 7",
            "min_data_in_leaf = 5", "device_type = cpu"]) + "\n")
        lines = []
        (lgb if name == "jax" else lgt).register_logger(lines.append)
        try:
            assert fn([f"config={conf}"]) == 0
        finally:
            (lgb if name == "jax" else lgt).register_logger(None)
        # the regex lgb.cv.R applies to the evaluation lines
        pat = re.compile(
            r"\[(\d+)\]\s+valid_\d+'s ([^:]+): ([-0-9.eE+naif]+)")
        hits = [h for h in map(pat.search, lines) if h]
        assert sorted({int(h.group(1)) for h in hits}) == list(range(1, 7))
        pred_csv = tmp_path / "pred.csv"
        np.savetxt(pred_csv, np.column_stack([np.zeros(8), X[:8]]),
                   delimiter=",")
        outs = {}
        for kind, extra in (("prob", []), ("raw", ["predict_raw_score = true"]),
                            ("contrib", ["predict_contrib = true"])):
            out = tmp_path / f"{name}_{kind}.txt"
            pconf = tmp_path / f"{name}_{kind}.conf"
            pconf.write_text("\n".join([
                "task = predict", f"data = {pred_csv}",
                f"input_model = {model_file}", f"output_result = {out}",
                "header = false", "device_type = cpu", *extra]) + "\n")
            assert fn([f"config={pconf}"]) == 0
            outs[kind] = np.loadtxt(out)
        results[name] = (model_file, [h.groups() for h in hits], outs)
    (jmf, jhits, jouts), (tmf, thits, touts) = results["jax"], results["port"]
    assert_trees_to_binary_standard(
        lgb.Booster(model_file=str(jmf)),
        lgt.Booster(params=CPU, model_file=str(tmf)), X[: n // 2],
        g_max=1.0, h_max=0.25 * 1.5)
    assert [h[:2] for h in thits] == [h[:2] for h in jhits]
    np.testing.assert_allclose([float(h[2]) for h in thits],
                               [float(h[2]) for h in jhits], rtol=1e-5)
    for kind in ("prob", "raw", "contrib"):
        np.testing.assert_allclose(touts[kind], jouts[kind], rtol=1e-4,
                                   atol=1e-5)
    assert touts["contrib"].shape == (8, f + 1)
    np.testing.assert_allclose(touts["contrib"].sum(axis=1), touts["raw"],
                               rtol=1e-4, atol=1e-5)
