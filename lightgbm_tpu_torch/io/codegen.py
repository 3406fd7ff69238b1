"""Model -> standalone C++ if-else source (task=convert_model).

Copy of ``lightgbm_tpu/io/codegen.py`` over the port's ``HostTree``
(ref: GBDT::SaveModelToIfElse, src/boosting/gbdt_model_text.cpp
ModelToIfElse; CLI task kConvertModel, application.cpp). The source is
the JAX package's line for line but for the generator's name in the
first comment line. Emits one `PredictTree{i}` per tree
mirroring HostTree.predict_leaf's traversal semantics (core/tree.py):
decision_type bit0 = categorical, bit1 = default-left, bits 2-3 = missing
type (0 none: NaN->0, 1 zero, 2 nan).
"""
from __future__ import annotations

from typing import List

_HEADER = """\
// Generated by lightgbm_tpu_torch (task=convert_model).
// Mirrors src/boosting/gbdt_model_text.cpp ModelToIfElse output shape.
#include <cmath>
#include <cstddef>

namespace lightgbm_tpu_model {

static inline bool IsZero(double v) { return v > -1e-35 && v < 1e-35; }
"""


def _emit_node(t, node: int, indent: str, lines: List[str]) -> None:
    if node < 0:  # leaf
        val = float(t.leaf_value[~node])
        lines.append(f"{indent}return {val!r};")
        return
    f = int(t.split_feature[node])
    thr = float(t.threshold_real[node])
    dt = int(t.decision_type[node])
    is_cat = bool(dt & 1)
    default_left = bool(dt & 2)
    mtype = (dt >> 2) & 3

    if is_cat:
        # decode the node's bitset back to explicit category values
        # (ref: Tree::CategoricalDecisionIfElse, src/io/tree.cpp)
        left_vals = t.cat_values(int(thr))
        conds = [f"(int)arr[{f}] == {v}" for v in left_vals]
        cond = " || ".join(conds) if conds else "false"
        lines.append(f"{indent}if ({cond}) {{")
    else:
        fv = f"arr[{f}]"
        le = f"(std::isnan({fv}) ? 0.0 : {fv}) <= {thr!r}"
        if mtype == 2:      # nan
            miss = f"std::isnan({fv})"
        elif mtype == 1:    # zero — NaN maps to 0 first, so NaN IS missing
            miss = f"IsZero(std::isnan({fv}) ? 0.0 : {fv})"
        else:               # none: NaN routed as 0.0
            miss = None
        if miss is None:
            cond = le
        elif default_left:
            cond = f"{miss} || ({le})"
        else:
            cond = f"!{miss} && ({le})"
        lines.append(f"{indent}if ({cond}) {{")
    _emit_node(t, int(t.left_child[node]), indent + "  ", lines)
    lines.append(f"{indent}}} else {{")
    _emit_node(t, int(t.right_child[node]), indent + "  ", lines)
    lines.append(f"{indent}}}")


def model_to_cpp_ifelse(engine, config) -> str:
    """Emit the full C++ translation unit for `engine`'s model."""
    K = engine.num_tree_per_iteration
    n_trees = len(engine.models)
    out: List[str] = [_HEADER]

    for i, t in enumerate(engine.models):
        out.append(f"double PredictTree{i}(const double* arr) {{")
        lines: List[str] = []
        if t.num_leaves <= 1:
            v = float(t.leaf_value[0]) if len(t.leaf_value) else 0.0
            lines.append(f"  return {v!r};")
        else:
            _emit_node(t, 0, "  ", lines)
        out.extend(lines)
        out.append("}")
        out.append("")

    avg = "true" if getattr(engine, "average_output", False) else "false"
    out.append(f"const int kNumClass = {K};")
    out.append(f"const int kNumTrees = {n_trees};")
    out.append(f"const bool kAverageOutput = {avg};")
    out.append("")
    out.append("void PredictRaw(const double* arr, double* output) {")
    out.append("  for (int k = 0; k < kNumClass; ++k) output[k] = 0.0;")
    for i in range(n_trees):
        out.append(f"  output[{i % K}] += PredictTree{i}(arr);")
    out.append("  if (kAverageOutput)")
    out.append("    for (int k = 0; k < kNumClass; ++k)")
    out.append(f"      output[k] /= {max(n_trees // max(K, 1), 1)}.0;")
    out.append("}")
    out.append("")

    obj_fn = getattr(engine, "objective", None)
    obj = obj_fn.NAME if obj_fn is not None else \
        str(getattr(config, "objective", "regression")).split(" ")[0]
    sigmoid = float(getattr(obj_fn, "sigmoid", None)
                    or getattr(config, "sigmoid", 1.0))
    out.append("void Predict(const double* arr, double* output) {")
    out.append("  PredictRaw(arr, output);")
    if obj in ("binary", "cross_entropy"):
        out.append(f"  output[0] = 1.0 / (1.0 + std::exp(-{sigmoid!r} * "
                   "output[0]));")
    elif obj in ("multiclass",):
        out.append("  double m = output[0], s = 0.0;")
        out.append("  for (int k = 1; k < kNumClass; ++k)")
        out.append("    if (output[k] > m) m = output[k];")
        out.append("  for (int k = 0; k < kNumClass; ++k)")
        out.append("    { output[k] = std::exp(output[k] - m); "
                   "s += output[k]; }")
        out.append("  for (int k = 0; k < kNumClass; ++k) output[k] /= s;")
    elif obj in ("multiclassova",):
        out.append("  for (int k = 0; k < kNumClass; ++k)")
        out.append(f"    output[k] = 1.0 / (1.0 + std::exp(-{sigmoid!r} * "
                   "output[k]));")
    elif obj in ("poisson", "gamma", "tweedie"):
        out.append("  for (int k = 0; k < kNumClass; ++k)")
        out.append("    output[k] = std::exp(output[k]);")
    out.append("}")
    out.append("")
    out.append("}  // namespace lightgbm_tpu_model")
    out.append("")
    return "\n".join(out)
