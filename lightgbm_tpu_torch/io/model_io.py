"""LightGBM-compatible model text, save side.

Port of ``model_to_string`` / ``save_model_file`` from
``lightgbm_tpu/io/model_io.py`` for the numerical trees of the first
slice (ref: src/boosting/gbdt_model_text.cpp:315 SaveModelToString,
Tree::ToString src/io/tree.cpp:344). The tree blocks are written exactly
as the JAX package writes them, so the two packages' models can be
compared text for text. Loading a model from text is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import Config
from ..core.tree import HostTree

K_MODEL_VERSION = "v4"


def _arr_to_str(arr, fmt="{}") -> str:
    return " ".join(fmt.format(v) for v in arr)


def _tree_to_string(t: HostTree) -> str:
    """ref: Tree::ToString (src/io/tree.cpp:344)."""
    n = t.num_leaves
    ni = n - 1
    lines = [f"num_leaves={n}", f"num_cat={t.num_cat}"]
    lines.append("split_feature=" + _arr_to_str(t.split_feature[:ni]))
    lines.append("split_gain=" + _arr_to_str(
        [f"{v:g}" for v in t.split_gain[:ni]]))
    lines.append("threshold=" + " ".join(
        repr(float(v)) for v in t.threshold_real[:ni]))
    lines.append("decision_type=" + _arr_to_str(t.decision_type[:ni]))
    lines.append("left_child=" + _arr_to_str(t.left_child[:ni]))
    lines.append("right_child=" + _arr_to_str(t.right_child[:ni]))
    lines.append("leaf_value=" + " ".join(
        repr(float(v)) for v in t.leaf_value[:n]))
    lines.append("leaf_weight=" + " ".join(
        repr(float(v)) for v in t.leaf_weight[:n]))
    lines.append("leaf_count=" + _arr_to_str(
        np.asarray(t.leaf_count[:n], np.int64)))
    lines.append("internal_value=" + _arr_to_str(
        [f"{v:g}" for v in t.internal_value[:ni]]))
    lines.append("internal_weight=" + _arr_to_str(
        [f"{v:g}" for v in t.internal_weight[:ni]]))
    lines.append("internal_count=" + _arr_to_str(
        np.asarray(t.internal_count[:ni], np.int64)))
    lines.append(f"is_linear={int(t.is_linear)}")
    lines.append(f"shrinkage={t.shrinkage:g}")
    return "\n".join(lines) + "\n"


def model_to_string(engine, config: Config,
                    num_iteration: Optional[int] = None,
                    start_iteration: int = 0,
                    importance_type: str = "split") -> str:
    """ref: GBDT::SaveModelToString (gbdt_model_text.cpp:315)."""
    K = engine.num_tree_per_iteration
    obj = engine.objective
    lines = ["tree", f"version={K_MODEL_VERSION}", f"num_class={K}",
             f"num_tree_per_iteration={K}",
             f"label_index={engine.label_idx}",
             f"max_feature_idx={engine.max_feature_idx}"]
    if obj is not None:
        lines.append(f"objective={obj.to_string()}")
    if engine.average_output:
        lines.append("average_output")
    lines.append("feature_names=" + " ".join(engine.feature_names))
    lines.append("feature_infos=" + " ".join(engine.feature_infos))

    total_iteration = len(engine.models) // max(K, 1)
    start_iteration = min(max(start_iteration, 0), total_iteration)
    num_used_model = len(engine.models)
    if num_iteration is not None and num_iteration > 0:
        num_used_model = min((start_iteration + num_iteration) * K,
                             num_used_model)
    start_model = start_iteration * K

    tree_strs = [f"Tree={i - start_model}\n"
                 + _tree_to_string(engine.models[i]) + "\n"
                 for i in range(start_model, num_used_model)]
    lines.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
    lines.append("")
    body = "\n".join(lines)
    body += "\n" + "".join(tree_strs)
    body += "end of trees\n"

    # feature importances (ref: :377)
    imp = np.zeros(engine.max_feature_idx + 1)
    for t in engine.models[start_model:num_used_model]:
        for i in range(t.num_leaves - 1):
            if importance_type == "split":
                if t.split_gain[i] > 0:
                    imp[int(t.split_feature[i])] += 1
            else:
                imp[int(t.split_feature[i])] += max(t.split_gain[i], 0.0)
    cast = int if importance_type == "split" else lambda v: repr(float(v))
    body += "\nfeature_importances:\n"
    for i in np.argsort(-imp, kind="stable"):
        if imp[i] > 0:
            body += f"{engine.feature_names[i]}={cast(imp[i])}\n"

    body += "\nparameters:\n" + config.to_string() + \
        "\nend of parameters\n"
    return body


def save_model_file(engine, config: Config, filename: str,
                    num_iteration: Optional[int] = None,
                    start_iteration: int = 0,
                    importance_type: str = "split") -> None:
    with open(filename, "w") as f:
        f.write(model_to_string(engine, config, num_iteration,
                                start_iteration, importance_type))
