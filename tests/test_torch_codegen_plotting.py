"""The port's model-to-C++ codegen and plotting against the JAX package.

Codegen: the cases of ``tests/test_codegen_compile.py``. The port's
source for a model file is the JAX package's line for line but for the
generator's name in its first comment line (the golden model with
categorical splits and NaNs, and a 3-class model); compiled with ``g++``
it reproduces the port's host walk raw scores within 1e-12
(rtol and atol, the JAX test's standard).

Plotting: ``tests/test_sklearn.py::test_plot_importance_and_metric``
with the Agg backend, both packages over the same model text (400 rows,
5 features): the importance bars and their labels, the metric curves,
the split-value histogram and ``create_tree_digraph``'s source are the
JAX package's.
"""
import os
import shutil
import subprocess

import numpy as np
import pytest
from conftest import GOLDEN_DIR, load_golden_csv

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.io.codegen import model_to_cpp_ifelse as jax_codegen
from lightgbm_tpu_torch.io.codegen import model_to_cpp_ifelse

CPU = {"device_type": "cpu"}

_MAIN = r"""
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <vector>

using namespace lightgbm_tpu_model;

int main() {
  // stdin: one row per line, comma separated, NaN for empty fields
  char line[65536];
  std::vector<double> row;
  double out[64];
  while (fgets(line, sizeof line, stdin)) {
    row.clear();
    char* p = line;
    while (*p && *p != '\n') {
      char* e = p;
      while (*e && *e != ',' && *e != '\n') ++e;
      if (e == p) row.push_back(NAN);
      else row.push_back(strtod(p, nullptr));
      p = (*e == ',') ? e + 1 : e;
    }
    if (p > line && p[-1] == ',') row.push_back(NAN);
    if (row.empty()) continue;
    PredictRaw(row.data(), out);
    for (int k = 0; k < kNumClass; ++k)
      printf(k + 1 == kNumClass ? "%.17g\n" : "%.17g,", out[k]);
  }
  return 0;
}
"""


def _compile_and_run(src, X, tmp_path):
    cpp = tmp_path / "model.cpp"
    cpp.write_text(src + _MAIN)
    exe = str(tmp_path / "model_bin")
    subprocess.run(["g++", "-O1", "-o", exe, str(cpp)], check=True,
                   capture_output=True, timeout=300)
    lines = "\n".join(
        ",".join("" if np.isnan(v) else repr(float(v)) for v in row)
        for row in X)
    out = subprocess.run([exe], input=lines, text=True, capture_output=True,
                         timeout=120, check=True)
    return np.asarray([[float(v) for v in ln.split(",")]
                       for ln in out.stdout.strip().splitlines()])


def _assert_same_source(port_src, jax_src):
    p, j = port_src.split("\n"), jax_src.split("\n")
    assert p[0] == "// Generated by lightgbm_tpu_torch (task=convert_model)."
    assert j[0] == "// Generated by lightgbm_tpu (task=convert_model)."
    assert p[1:] == j[1:]


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ compiler")
def test_codegen_matches_reference_golden(tmp_path):
    _, X = load_golden_csv("test.csv")
    path = os.path.join(GOLDEN_DIR, "model.txt")
    bst = lgt.Booster(params=CPU, model_file=path)
    src = model_to_cpp_ifelse(bst._engine, bst.config)
    jb = lgb.Booster(model_file=path)
    _assert_same_source(src, jax_codegen(jb._engine, jb.config))
    got = _compile_and_run(src, X, tmp_path)[:, 0]
    np.testing.assert_allclose(got, bst.predict(X, raw_score=True),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ compiler")
def test_codegen_multiclass(tmp_path):
    rng = np.random.default_rng(42)
    k = 3
    centers = rng.normal(scale=2.0, size=(k, 4))
    yid = rng.integers(0, k, size=400)
    X = centers[yid] + rng.normal(size=(400, 4))
    params = {"objective": "multiclass", "num_class": k, "verbose": -1,
              "min_data_in_leaf": 5}
    bst = lgt.train({**params, **CPU},
                    lgt.Dataset(X, label=yid.astype(np.float32)),
                    num_boost_round=4)
    src = model_to_cpp_ifelse(bst._engine, bst.config)
    # the same model text through both packages' codegen
    text = bst.model_to_string()
    jb = lgb.Booster(model_str=text)
    _assert_same_source(src, jax_codegen(jb._engine, jb.config))
    got = _compile_and_run(src, X, tmp_path)
    np.testing.assert_allclose(got, bst.predict(X, raw_score=True),
                               rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def plot_models():
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    rng = np.random.default_rng(42)
    X = rng.normal(size=(400, 5))
    y = X[:, 0] * 2 + np.sin(X[:, 1]) + 0.1 * rng.normal(size=400)
    rec = {}
    train = lgt.Dataset(X, label=y)
    bst = lgt.train({"objective": "regression", "num_leaves": 7,
                     "min_data_in_leaf": 5, "verbosity": -1, **CPU},
                    train, num_boost_round=10,
                    valid_sets=[lgt.Dataset(X, label=y, reference=train)],
                    valid_names=["train"],
                    callbacks=[lgt.record_evaluation(rec)])
    text = bst.model_to_string()
    return (lgb.Booster(model_str=text),
            lgt.Booster(params=CPU, model_str=text), rec)


def _bars(ax):
    return [(p.get_x(), p.get_y(), p.get_width(), p.get_height())
            for p in ax.patches]


def _labels(ax):
    return ([t.get_text() for t in ax.texts],
            [t.get_text() for t in ax.get_yticklabels()],
            ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
            ax.get_xlim(), ax.get_ylim())


@pytest.mark.parametrize("importance_type", ["split", "gain"])
def test_plot_importance_matches_jax(plot_models, importance_type):
    import matplotlib.pyplot as plt
    jb, tb, _ = plot_models
    ja = lgb.plot_importance(jb, importance_type=importance_type)
    ta = lgt.plot_importance(tb, importance_type=importance_type)
    assert len(ta.patches) > 0
    assert _bars(ta) == _bars(ja)
    assert _labels(ta) == _labels(ja)
    plt.close("all")


def test_plot_metric_and_split_histogram_match_jax(plot_models):
    import matplotlib.pyplot as plt
    jb, tb, rec = plot_models
    ja, ta = lgb.plot_metric(rec), lgt.plot_metric(rec)
    assert ta.get_xlabel() == "Iterations"
    assert [ln.get_xydata().tolist() for ln in ta.get_lines()] == \
        [ln.get_xydata().tolist() for ln in ja.get_lines()]
    assert _labels(ta) == _labels(ja)
    ja = lgb.plot_split_value_histogram(jb, feature=0)
    ta = lgt.plot_split_value_histogram(tb, feature=0)
    assert len(ta.patches) > 0
    assert _bars(ta) == _bars(ja)
    assert _labels(ta) == _labels(ja)
    with pytest.raises(TypeError):
        lgt.plot_metric(tb)
    plt.close("all")


def test_plot_from_estimator():
    """An estimator fitted with an eval set plots its importances and its
    recorded metric, as the JAX package's sklearn test does."""
    pytest.importorskip("matplotlib").use("Agg")
    import matplotlib.pyplot as plt
    rng = np.random.default_rng(42)
    X = rng.normal(size=(200, 5))
    y = X[:, 0] * 2 + 0.1 * rng.normal(size=200)
    model = lgt.LGBMRegressor(n_estimators=10, num_leaves=7,
                              min_child_samples=5, device_type="cpu",
                              verbose=-1)
    model.fit(X, y, eval_set=[(X, y)])
    assert len(lgt.plot_importance(model).patches) > 0
    assert lgt.plot_metric(model.evals_result_).get_xlabel() == "Iterations"
    assert len(lgt.plot_split_value_histogram(model, feature=0).patches) > 0
    plt.close("all")


@pytest.mark.parametrize("show_info", [[], ["split_gain", "internal_count",
                                            "leaf_count", "data_percentage"]])
def test_create_tree_digraph_matches_jax(plot_models, show_info):
    pytest.importorskip("graphviz")
    jb, tb, _ = plot_models
    for tree_index in (0, 9):
        js = lgb.create_tree_digraph(jb, tree_index=tree_index,
                                     show_info=show_info).source
        ts = lgt.create_tree_digraph(tb, tree_index=tree_index,
                                     show_info=show_info).source
        assert ts == js
    with pytest.raises(IndexError):
        lgt.create_tree_digraph(tb, tree_index=10)
