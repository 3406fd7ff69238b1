"""Plotting library.

Copy of ``lightgbm_tpu/plotting.py`` for the port (the charts read the
Booster's ``feature_importance``, ``feature_name`` and ``dump_model``).
Behavioral equivalent of the reference plotting module
(ref: python-package/lightgbm/plotting.py — plot_importance,
plot_split_value_histogram, plot_metric, plot_tree, create_tree_digraph),
restructured around a shared axes pipeline: every chart goes through
``_new_axes`` -> draw -> ``_finish_axes`` with declarative default limits,
instead of repeating the limit/label boilerplate per function.
matplotlib / graphviz are optional imports, checked at call time.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from .basic import Booster
from .sklearn import LGBMModel

__all__ = ["plot_importance", "plot_split_value_histogram", "plot_metric",
           "plot_tree", "create_tree_digraph"]


def _pyplot(what: str):
    try:
        import matplotlib.pyplot as plt
        return plt
    except ImportError:
        raise ImportError(f"You must install matplotlib to plot {what}.")


def _fmt(value, precision: Optional[int]) -> str:
    """Number -> string honoring an optional decimal precision."""
    if precision is None or isinstance(value, str):
        return str(value)
    return f"{value:.{precision}f}"


def _pair(value, name: str) -> Tuple:
    """Validate a 2-tuple argument (xlim/ylim/figsize)."""
    if not isinstance(value, tuple) or len(value) != 2:
        raise TypeError(f"{name} must be a tuple of 2 elements.")
    return value


def _get_booster(booster: Union[Booster, LGBMModel]) -> Booster:
    if isinstance(booster, LGBMModel):
        return booster.booster_
    if isinstance(booster, Booster):
        return booster
    raise TypeError("booster must be Booster or LGBMModel.")


def _new_axes(ax, figsize, dpi):
    if ax is not None:
        return ax
    plt = _pyplot("charts")
    if figsize is not None:
        _pair(figsize, "figsize")
    _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    return ax


def _finish_axes(ax, *, xlim, ylim, default_xlim, default_ylim,
                 title, xlabel, ylabel, grid,
                 subs: Optional[Dict[str, str]] = None) -> None:
    """Apply limits / labels / grid with templated substitutions."""
    ax.set_xlim(_pair(xlim, "xlim") if xlim is not None else default_xlim)
    ax.set_ylim(_pair(ylim, "ylim") if ylim is not None else default_ylim)

    def expand(text):
        for key, val in (subs or {}).items():
            text = text.replace(key, val)
        return text

    if title is not None:
        ax.set_title(expand(title))
    if xlabel is not None:
        ax.set_xlabel(expand(xlabel))
    if ylabel is not None:
        ax.set_ylabel(expand(ylabel))
    ax.grid(grid)


def plot_importance(booster: Union[Booster, LGBMModel], ax=None,
                    height: float = 0.2, xlim=None, ylim=None,
                    title: Optional[str] = "Feature importance",
                    xlabel: Optional[str] = "Feature importance",
                    ylabel: Optional[str] = "Features",
                    importance_type: str = "auto",
                    max_num_features: Optional[int] = None,
                    ignore_zero: bool = True, figsize=None, dpi=None,
                    grid: bool = True, precision: Optional[int] = 3,
                    **kwargs):
    """Horizontal bar chart of feature importances."""
    _pyplot("importance")
    if importance_type == "auto":
        importance_type = (booster.importance_type
                           if isinstance(booster, LGBMModel) else "split")
    bst = _get_booster(booster)
    imp = np.asarray(bst.feature_importance(
        importance_type=importance_type), dtype=np.float64)
    names = np.asarray(bst.feature_name(), dtype=object)
    if imp.size == 0:
        raise ValueError("Booster's feature_importance is empty.")

    order = np.argsort(imp, kind="stable")
    if ignore_zero:
        order = order[imp[order] > 0]
    if max_num_features is not None and max_num_features > 0:
        order = order[-max_num_features:]
    vals = imp[order]

    ax = _new_axes(ax, figsize, dpi)
    rows = np.arange(vals.size)
    ax.barh(rows, vals, align="center", height=height, **kwargs)
    is_gain = importance_type == "gain"
    for r, v in enumerate(vals):
        ax.text(v + 1, r, _fmt(v, precision) if is_gain else str(int(v)),
                va="center")
    ax.set_yticks(rows)
    ax.set_yticklabels(names[order])
    _finish_axes(ax, xlim=xlim, ylim=ylim,
                 default_xlim=(0, float(vals.max()) * 1.1),
                 default_ylim=(-1, vals.size),
                 title=title, xlabel=xlabel, ylabel=ylabel, grid=grid,
                 subs={"@importance_type@": importance_type})
    return ax


def _split_thresholds(model: Dict[str, Any], fidx: int) -> List[float]:
    """All numerical split thresholds on one feature across the model."""
    out: List[float] = []
    stack = [t["tree_structure"] for t in model["tree_info"]]
    while stack:
        node = stack.pop()
        if "split_feature" not in node:
            continue
        if (int(node["split_feature"]) == fidx and
                node.get("decision_type") == "<="):
            out.append(float(node["threshold"]))
        stack.append(node["left_child"])
        stack.append(node["right_child"])
    return out


def plot_split_value_histogram(booster: Union[Booster, LGBMModel],
                               feature: Union[int, str], bins=None, ax=None,
                               width_coef: float = 0.8, xlim=None, ylim=None,
                               title: Optional[str] =
                               "Split value histogram for feature with "
                               "@index/name@ @feature@",
                               xlabel: Optional[str] = "Feature split value",
                               ylabel: Optional[str] = "Count",
                               figsize=None, dpi=None, grid: bool = True,
                               **kwargs):
    """Histogram of a feature's split thresholds across the model."""
    _pyplot("split value histogram")
    from matplotlib.ticker import MaxNLocator

    bst = _get_booster(booster)
    model = bst.dump_model()
    feature_names = model.get("feature_names", bst.feature_name())
    if isinstance(feature, str):
        if feature not in feature_names:
            raise ValueError(f"feature {feature} not found")
        fidx = feature_names.index(feature)
    else:
        fidx = int(feature)

    values = _split_thresholds(model, fidx)
    if not values:
        raise ValueError(
            "Cannot plot split value histogram, "
            f"because feature {feature} was not used in splitting")

    counts, edges = np.histogram(values, bins=bins or "auto")
    ax = _new_axes(ax, figsize, dpi)
    ax.bar((edges[:-1] + edges[1:]) / 2.0, counts,
           width=width_coef * (edges[1] - edges[0]), align="center",
           **kwargs)
    ax.yaxis.set_major_locator(MaxNLocator(integer=True))
    span = edges[-1] - edges[0]
    _finish_axes(ax, xlim=xlim, ylim=ylim,
                 default_xlim=(edges[0] - span * 0.2,
                               edges[-1] + span * 0.2),
                 default_ylim=(0, float(counts.max()) * 1.1),
                 title=title, xlabel=xlabel, ylabel=ylabel, grid=grid,
                 subs={"@feature@": str(feature),
                       "@index/name@": ("name" if isinstance(feature, str)
                                        else "index")})
    return ax


def plot_metric(booster: Union[Dict, LGBMModel], metric: Optional[str] = None,
                dataset_names: Optional[List[str]] = None, ax=None,
                xlim=None, ylim=None,
                title: Optional[str] = "Metric during training",
                xlabel: Optional[str] = "Iterations",
                ylabel: Optional[str] = "@metric@", figsize=None, dpi=None,
                grid: bool = True):
    """Curves of a recorded eval metric over boosting iterations."""
    _pyplot("metric")
    if isinstance(booster, LGBMModel):
        eval_results = deepcopy(booster.evals_result_)
    elif isinstance(booster, dict):
        eval_results = deepcopy(booster)
    elif isinstance(booster, Booster):
        raise TypeError("booster must be dict or LGBMModel. To use plot_"
                        "metric with Booster type, first record the metrics "
                        "using record_evaluation callback then pass that to "
                        "plot_metric as argument `booster`")
    else:
        raise TypeError("booster must be dict or LGBMModel.")
    if not eval_results:
        raise ValueError("eval results cannot be empty.")

    names = (list(eval_results.keys()) if dataset_names is None
             else list(dataset_names))
    if not names:
        raise ValueError("dataset_names cannot be empty.")
    first = eval_results[names[0]]
    if metric is None:
        if len(first) > 1:
            raise ValueError(
                "more than one metric available, pick one with metric=...")
        metric = next(iter(first))
    elif metric not in first:
        raise KeyError("No given metric in eval results.")

    curves = [(name, eval_results[name][metric]) for name in names]
    ax = _new_axes(ax, figsize, dpi)
    for name, series in curves:
        ax.plot(range(len(series)), series, label=name)
    ax.legend(loc="best")

    flat = [v for _, series in curves for v in series]
    lo, hi = min(flat), max(flat)
    span = hi - lo
    _finish_axes(ax, xlim=xlim, ylim=ylim,
                 default_xlim=(0, len(curves[0][1])),
                 default_ylim=(lo - span * 0.2, hi + span * 0.2),
                 title=title, xlabel=xlabel, ylabel=ylabel, grid=grid,
                 subs={"@metric@": metric})
    return ax


def _node_label(node: Dict[str, Any], feature_names, precision,
                show_info: List[str], max_category_values: int,
                total_count) -> Tuple[str, str, Optional[Tuple[str, str]]]:
    """(node_name, label, (left_edge, right_edge)|None) for one dump node."""
    if "split_index" in node:
        fidx = int(node["split_feature"])
        feat = (feature_names[fidx]
                if feature_names is not None and fidx < len(feature_names)
                else f"feature_{fidx}")
        if node.get("decision_type") == "==":
            edges = ("is", "isn't")
            cats = str(node["threshold"]).split("||")
            if len(cats) > max_category_values:
                cats = cats[:max_category_values] + ["..."]
            thr = "||".join(cats)
        else:
            edges = ("<=", ">")
            thr = _fmt(node["threshold"], precision)
        label = f"{feat} {edges[0]} {thr}"
        for info in ("split_gain", "internal_value", "internal_weight",
                     "internal_count"):
            if info in show_info and info in node:
                label += f"\n{info.split('_')[-1]}: " + \
                    _fmt(node[info], precision)
        return f"split{node['split_index']}", label, edges
    label = (f"leaf {node['leaf_index']}: " +
             _fmt(node["leaf_value"], precision))
    if "leaf_weight" in show_info and "leaf_weight" in node:
        label += "\nweight: " + _fmt(node["leaf_weight"], precision)
    if "leaf_count" in show_info and "leaf_count" in node:
        label += f"\ncount: {node['leaf_count']}"
        if "data_percentage" in show_info and total_count:
            label += (f"\n{node['leaf_count'] / total_count * 100:.2f}"
                      "% of data")
    return f"leaf{node['leaf_index']}", label, None


def _to_graphviz(tree_info: Dict[str, Any], show_info: List[str],
                 feature_names: List[str], precision: Optional[int],
                 orientation: str, constraints=None, example_case=None,
                 max_category_values: int = 10, **kwargs):
    """Build a graphviz Digraph for one tree."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("You must install graphviz to plot tree.")

    graph = Digraph(**kwargs)
    graph.attr("graph", nodesep="0.05", ranksep="0.3",
               rankdir="LR" if orientation == "horizontal" else "TB")
    struct = tree_info["tree_structure"]
    total_count = struct.get("internal_count", 0)

    stack = [(struct, None, None)]
    while stack:
        node, parent, decision = stack.pop()
        name, label, edges = _node_label(node, feature_names, precision,
                                         show_info, max_category_values,
                                         total_count)
        shape = "rectangle" if edges is not None else None
        graph.node(name, label=label,
                   **({"shape": shape} if shape else {}))
        if parent is not None:
            graph.edge(parent, name, decision)
        if edges is not None:
            stack.append((node["right_child"], name, edges[1]))
            stack.append((node["left_child"], name, edges[0]))
    return graph


def create_tree_digraph(booster: Union[Booster, LGBMModel],
                        tree_index: int = 0,
                        show_info: Optional[List[str]] = None,
                        precision: Optional[int] = 3,
                        orientation: str = "horizontal",
                        example_case=None, max_category_values: int = 10,
                        **kwargs):
    """Graphviz digraph of one tree from the JSON dump."""
    bst = _get_booster(booster)
    model = bst.dump_model()
    tree_infos = model["tree_info"]
    feature_names = model.get("feature_names", bst.feature_name())
    if tree_index >= len(tree_infos):
        raise IndexError("tree_index is out of range.")
    return _to_graphviz(tree_infos[tree_index], show_info or [],
                        feature_names, precision, orientation,
                        max_category_values=max_category_values, **kwargs)


def plot_tree(booster: Union[Booster, LGBMModel], ax=None,
              tree_index: int = 0, figsize=None, dpi=None,
              show_info: Optional[List[str]] = None,
              precision: Optional[int] = 3,
              orientation: str = "horizontal", example_case=None, **kwargs):
    """Render one tree to a matplotlib axis via graphviz."""
    plt = _pyplot("tree")
    import matplotlib.image as image
    ax = _new_axes(ax, figsize, dpi)
    graph = create_tree_digraph(booster=booster, tree_index=tree_index,
                                show_info=show_info, precision=precision,
                                orientation=orientation,
                                example_case=example_case, **kwargs)
    from io import BytesIO
    buf = BytesIO(graph.pipe(format="png"))
    ax.imshow(image.imread(buf))
    ax.axis("off")
    return ax
