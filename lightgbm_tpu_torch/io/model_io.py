"""LightGBM-compatible model text: save, load and JSON dump.

Port of ``lightgbm_tpu/io/model_io.py`` (ref:
src/boosting/gbdt_model_text.cpp:315 SaveModelToString, :425
LoadModelFromString, :37 DumpModel; Tree::ToString src/io/tree.cpp:344
and its parser). The tree blocks are written exactly as the JAX package
writes them, so the two packages' models can be compared text for text.

A loaded model is a ``_LoadedEngine``: trees with ORIGINAL feature
indices and real thresholds, no bin mappers. Its device prediction takes
the raw-threshold route of ``ops/forest.py`` on the device its
``Config`` names (``device_type``, ``cuda`` by default): the
``device_type`` in the file's parameters block says where the model was
trained, not where it is to run, and is dropped at load. A linear
tree's block carries its leaves' constants, features and coefficients
(ref: Tree::ToString, src/io/tree.cpp:385-399); such a model predicts by
the host walk.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Config
from ..core.objective import create_objective
from ..core.tree import HostTree, max_leaf_depth
from ..utils import log

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
    if t.num_cat > 0:
        lines.append("cat_boundaries=" + _arr_to_str(t.cat_boundaries))
        lines.append("cat_threshold=" + _arr_to_str(t.cat_threshold))
    lines.append(f"is_linear={int(t.is_linear)}")
    if t.is_linear:
        lines.append("leaf_const=" + " ".join(
            repr(float(v)) for v in t.leaf_const[:n]))
        lines.append("num_features=" + _arr_to_str(
            [len(t.leaf_coeff[i]) for i in range(n)]))
        lines.append("leaf_features=" + " ".join(
            " ".join(str(f) for f in t.leaf_features[i])
            for i in range(n) if len(t.leaf_features[i])))
        lines.append("leaf_coeff=" + " ".join(
            " ".join(repr(float(c)) for c in t.leaf_coeff[i])
            for i in range(n) if len(t.leaf_coeff[i])))
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
                    importance_type: str = "split",
                    atomic: bool = False) -> None:
    """``atomic=True``: crash-safe write via tmp + fsync + rename
    (``robustness/checkpoint.py``), as the CLI's snapshots are written, so
    a kill mid-write cannot leave a torn model file (ref: the JAX
    package's io/model_io.py:138)."""
    text = model_to_string(engine, config, num_iteration,
                           start_iteration, importance_type)
    if atomic:
        from ..robustness.checkpoint import atomic_write_text
        atomic_write_text(filename, text)
        return
    with open(filename, "w") as f:
        f.write(text)


# ---------------------------------------------------------------------------
# Loading (ref: GBDT::LoadModelFromString gbdt_model_text.cpp:425,
# Tree::Tree(const char*, size_t*) tree.cpp)
# ---------------------------------------------------------------------------

# parameters of the file's block that say how it was trained, not how it
# is to be used: the objective comes from the header, the device from the
# caller (ref: the JAX package drops ``objective``, io/model_io.py:360)
_DROPPED_AT_LOAD = ("objective", "device_type")


def _parse_kv_block(lines: List[str]) -> Dict[str, str]:
    out = {}
    for ln in lines:
        if "=" in ln:
            k, _, v = ln.partition("=")
            out[k.strip()] = v.strip()
    return out


def _tree_from_block(block: Dict[str, str]) -> HostTree:
    n = int(block["num_leaves"])
    if "cat_value_to_bin" in block:
        log.fatal("this model was saved with the removed interim "
                  "categorical format (cat_value_to_bin); re-train it "
                  "with the current version")
    t = HostTree.constant(0.0)
    t.num_leaves = n
    ni = max(n - 1, 0)

    def ints(key, count, dtype=np.int32):
        if count == 0 or key not in block or not block[key]:
            return np.zeros(count, dtype)
        return np.asarray([int(float(x)) for x in block[key].split()],
                          dtype)

    def floats(key, count):
        if count == 0 or key not in block or not block[key]:
            return np.zeros(count, np.float64)
        return np.asarray([float(x) for x in block[key].split()], np.float64)

    t.split_feature = ints("split_feature", ni)
    t.split_feature_inner = t.split_feature.copy()
    t.split_gain = floats("split_gain", ni)
    t.threshold_real = floats("threshold", ni)
    t.threshold_bin = np.zeros(ni, np.int32)
    t.decision_type = ints("decision_type", ni)
    t.default_left = (t.decision_type & 2) != 0
    t.left_child = ints("left_child", ni)
    t.right_child = ints("right_child", ni)
    t.leaf_value = floats("leaf_value", n)
    t.leaf_weight = floats("leaf_weight", n)
    t.leaf_count = ints("leaf_count", n).astype(np.int64)
    t.internal_value = floats("internal_value", ni)
    t.internal_weight = floats("internal_weight", ni)
    t.internal_count = ints("internal_count", ni).astype(np.int64)
    t.num_cat = int(block.get("num_cat", 0))
    t.shrinkage = float(block.get("shrinkage", 1.0))
    t.leaf_parent = np.full(n, -1, np.int32)
    t.is_linear = bool(int(block.get("is_linear", 0)))
    t._init_linear_fields()
    if t.is_linear:
        t.leaf_const = floats("leaf_const", n)
        nf = ints("num_features", n)
        flat_f = [int(float(x)) for x in block.get("leaf_features",
                                                   "").split()]
        flat_c = [float(x) for x in block.get("leaf_coeff", "").split()]
        if not int(nf.sum()) == len(flat_f) == len(flat_c):
            log.fatal(f"linear tree block: num_features counts "
                      f"{int(nf.sum())} features, leaf_features lists "
                      f"{len(flat_f)} and leaf_coeff {len(flat_c)}")
        pos = 0
        for i in range(n):
            k = int(nf[i])
            t.leaf_features[i] = flat_f[pos:pos + k]
            t.leaf_coeff[i] = np.asarray(flat_c[pos:pos + k], np.float64)
            pos += k
    if t.num_cat > 0:
        t.cat_boundaries = ints("cat_boundaries",
                                t.num_cat + 1).astype(np.int64)
        nthr = int(t.cat_boundaries[-1]) if len(t.cat_boundaries) else 0
        # bitset words use all 32 bits: parse wider than int32
        t.cat_threshold = ints("cat_threshold", nthr,
                               np.int64).astype(np.uint32)
    t.from_text = True
    t.max_depth = max_leaf_depth(t.left_child, t.right_child, t.num_leaves)
    return t


class _LoadedEngine:
    """Engine facade of a model loaded from text: prediction, save, dump
    and importance, no training state (ref: the prediction-only Booster,
    c_api.cpp LGBM_BoosterCreateFromModelfile)."""

    def __init__(self) -> None:
        self.models: List[HostTree] = []
        self.num_tree_per_iteration = 1
        self.objective = None
        self.average_output = False
        self.max_feature_idx = 0
        self.label_idx = 0
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        self.config = Config()
        self.valid_sets: List = []
        # advanced by invalidate_serving_cache: the next device
        # prediction repacks
        self._model_gen = 0
        self._serving = None

    def invalidate_serving_cache(self) -> None:
        """Call after changing the trees (``set_leaf_output``, ``refit``,
        ``shuffle_models``): the packed forest is rebuilt at the next
        device prediction."""
        self._model_gen += 1

    def current_iteration(self) -> int:
        return len(self.models) // max(self.num_tree_per_iteration, 1)

    def predict_device(self, X: np.ndarray, start_iteration: int,
                       end_iteration: int) -> np.ndarray:
        """[R, K] raw scores of iterations [start, end) by the
        raw-threshold route (a loaded model has no bin mappers) on the
        device ``config.device_type`` names; raises without a card unless
        that is ``cpu``. ``DeviceRouteUnavailable`` for an empty range or
        a categorical node (bitset membership stays on the host walk)."""
        K = max(self.num_tree_per_iteration, 1)
        lo, hi = start_iteration * K, end_iteration * K
        srv = self._serving_engine()
        out = srv.predict_raw(self.models, self._model_gen, X, lo, hi)
        return out.T

    def _serving_engine(self):
        """The packed-forest engine on the device ``config.device_type``
        names (made anew when that changes)."""
        from ..models.gbdt import resolve_device
        from ..ops.forest import ServingEngine
        dev = resolve_device(self.config)
        if self._serving is None or self._serving.device != dev:
            cap = max([t.num_leaves for t in self.models] + [2])
            self._serving = ServingEngine(
                cap, max(self.num_tree_per_iteration, 1), dev)
        return self._serving

    def explain_device(self, X: np.ndarray, start_iteration: int,
                       end_iteration: int) -> np.ndarray:
        """[R, (F+1)*K] device SHAP contributions by the raw route (ref:
        the JAX package's io/model_io.py:294-315); a linear or categorical
        model raises ``DeviceRouteUnavailable``."""
        K = max(self.num_tree_per_iteration, 1)
        return self._serving_engine().explain_raw(
            self.models, self._model_gen, X, start_iteration * K,
            end_iteration * K, self.max_feature_idx + 1)

    def serving_state(self):
        """A model server's source (serving/server.py): a loaded model has
        no bin mappers, so it serves and explains by the raw route."""
        return list(self.models), self._model_gen, None, None

    def eval_train(self) -> List:
        return []

    def eval_valid(self) -> List:
        return []


def load_model_string(model_str: str,
                      params: Optional[Dict] = None
                      ) -> Tuple[_LoadedEngine, Config]:
    """ref: GBDT::LoadModelFromString (gbdt_model_text.cpp:425). The
    Config is the file's parameters block less ``_DROPPED_AT_LOAD``,
    updated by ``params``; the engine predicts on the device it names."""
    lines = model_str.split("\n")
    first_tree = next((i for i, ln in enumerate(lines)
                       if ln.startswith("Tree=")), len(lines))
    header = _parse_kv_block(lines[:first_tree])
    eng = _LoadedEngine()
    eng.num_tree_per_iteration = int(header.get("num_tree_per_iteration", 1))
    eng.max_feature_idx = int(header.get("max_feature_idx", 0))
    eng.label_idx = int(header.get("label_index", 0))
    eng.feature_names = header.get("feature_names", "").split()
    eng.feature_infos = header.get("feature_infos", "").split()
    eng.average_output = any(
        ln.strip() == "average_output" for ln in lines[:first_tree])
    obj_str = header.get("objective", "")
    if obj_str:
        eng.objective = _objective_from_string(obj_str)

    kept = {}
    if "parameters:" in lines and "end of parameters" in lines:
        p_start = lines.index("parameters:")
        p_end = lines.index("end of parameters")
        for ln in lines[p_start + 1:p_end]:
            ln = ln.strip()
            if ln.startswith("[") and ln.endswith("]") and ": " in ln:
                k, _, v = ln[1:-1].partition(": ")
                if k not in _DROPPED_AT_LOAD:
                    kept[k] = v
    if obj_str:
        # the header's objective, so that num_class > 1 is consistent
        kept["objective"] = obj_str.split()[0]
    cfg = Config(kept)
    if params:
        cfg.update(params)
    eng.config = cfg

    current: List[str] = []
    for ln in lines[first_tree:]:
        if ln.startswith("Tree=") or ln.strip() == "end of trees":
            if current:
                eng.models.append(_tree_from_block(_parse_kv_block(current)))
            current = []
            if ln.strip() == "end of trees":
                break
        elif ln.strip():
            current.append(ln)
    return eng, cfg


def load_model_file(filename: str, params: Optional[Dict] = None
                    ) -> Tuple[_LoadedEngine, Config]:
    with open(filename) as f:
        return load_model_string(f.read(), params)


def _objective_from_string(s: str):
    """Rebuild an objective from its model-file string (ref:
    ObjectiveFunction::CreateObjectiveFunction(str) overload)."""
    parts = s.split()
    name = parts[0]
    kv = dict(p.partition(":")[::2] for p in parts[1:] if ":" in p)
    params = {"objective": name}
    if "num_class" in kv:
        params["num_class"] = int(kv["num_class"])
    if "sigmoid" in kv:
        params["sigmoid"] = float(kv["sigmoid"])
    if "sqrt" in parts[1:]:
        params["reg_sqrt"] = True
    return create_objective(name, Config(params))


# ---------------------------------------------------------------------------
# JSON dump (ref: GBDT::DumpModel gbdt_model_text.cpp:37)
# ---------------------------------------------------------------------------

def _node_to_dict(t: HostTree, node: int) -> Dict:
    if node < 0:  # leaf
        leaf = -(node + 1)
        return {
            "leaf_index": int(leaf),
            "leaf_value": float(t.leaf_value[leaf]),
            "leaf_weight": float(t.leaf_weight[leaf]),
            "leaf_count": int(t.leaf_count[leaf]),
        }
    dt = int(t.decision_type[node])
    return {
        "split_index": int(node),
        "split_feature": int(t.split_feature[node]),
        "split_gain": float(t.split_gain[node]),
        "threshold": float(t.threshold_real[node]),
        "decision_type": "==" if (dt & 1) else "<=",
        "default_left": bool(dt & 2),
        "missing_type": ["None", "Zero", "NaN", "NaN"][(dt >> 2) & 3],
        "internal_value": float(t.internal_value[node]),
        "internal_weight": float(t.internal_weight[node]),
        "internal_count": int(t.internal_count[node]),
        "left_child": _node_to_dict(t, int(t.left_child[node])),
        "right_child": _node_to_dict(t, int(t.right_child[node])),
    }


def dump_model_dict(engine, config: Config,
                    num_iteration: Optional[int] = None,
                    start_iteration: int = 0,
                    importance_type: str = "split") -> Dict:
    """The model as a JSON-ready dict (ref: GBDT::DumpModel). ``config``
    and ``importance_type`` are taken as the JAX package's are; the dict
    holds no importance, so neither changes it."""
    K = engine.num_tree_per_iteration
    obj = engine.objective
    total_iteration = len(engine.models) // max(K, 1)
    start_iteration = min(max(start_iteration, 0), total_iteration)
    num_used = len(engine.models)
    if num_iteration is not None and num_iteration > 0:
        num_used = min((start_iteration + num_iteration) * K, num_used)
    trees = []
    for i in range(start_iteration * K, num_used):
        t = engine.models[i]
        trees.append({
            "tree_index": i,
            "num_leaves": t.num_leaves,
            "num_cat": t.num_cat,
            "shrinkage": t.shrinkage,
            "tree_structure": _node_to_dict(t, 0 if t.num_leaves > 1
                                            else -1),
        })
    return {
        "name": "tree",
        "version": K_MODEL_VERSION,
        "num_class": K,
        "num_tree_per_iteration": K,
        "label_index": engine.label_idx,
        "max_feature_idx": engine.max_feature_idx,
        "objective": obj.to_string() if obj else "",
        "average_output": engine.average_output,
        "feature_names": list(engine.feature_names),
        "feature_infos": list(engine.feature_infos),
        "tree_info": trees,
    }
