"""Carry trained trees across from the JAX package.

A model trained by ``lightgbm_tpu`` is handed over as plain data — each
tree's ``HostTree`` arrays as numpy, and the dataset's bin mappers — so
this module needs nothing of the JAX package. The port's host walk then
predicts with them exactly as the JAX package's host walk does.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from .basic import Booster
from .config import Config
from .core.objective import create_objective
from .core.tree import HostTree, TreeArrays
from .io.binning import BinMapper
from .models.gbdt import GBDT, finalize_tree

# the HostTree arrays a tree is carried by (split_feature_inner holds the
# used-feature index; leaf_value is the stored, shrunk value)
TREE_FIELDS = ("split_feature_inner", "threshold_bin", "default_left",
               "left_child", "right_child", "split_gain", "internal_value",
               "internal_weight", "internal_count", "leaf_value",
               "leaf_weight", "leaf_count", "leaf_parent", "num_leaves",
               "shrinkage")


def bin_mapper_from_fields(fields: Mapping[str, Any]) -> BinMapper:
    """A port BinMapper holding the given attribute values (for instance
    ``vars()`` of a JAX-package BinMapper)."""
    m = BinMapper()
    for k, v in fields.items():
        setattr(m, k, v.copy() if isinstance(v, np.ndarray) else v)
    return m


def trees_from_arrays(trees: Sequence[Mapping[str, Any]],
                      bin_mappers: Sequence[BinMapper],
                      used_feature_map: np.ndarray) -> List[HostTree]:
    """Port HostTrees from per-tree arrays (``TREE_FIELDS``), with real
    thresholds resolved through ``bin_mappers`` (one per ORIGINAL
    feature) as the JAX package resolves them."""
    used_feature_map = np.asarray(used_feature_map, np.int32)
    out = []
    for t in trees:
        arrays = TreeArrays(
            split_feature=np.asarray(t["split_feature_inner"], np.int32),
            **{f: np.asarray(t[f]) for f in TREE_FIELDS[1:-2]},
            num_leaves=int(t["num_leaves"]), shrinkage=float(t["shrinkage"]))
        host = HostTree(arrays, used_feature_map)
        if host.num_leaves > 1:
            finalize_tree(host, bin_mappers)
        out.append(host)
    return out


def booster_from_arrays(params: Optional[Dict[str, Any]],
                        trees: Sequence[Mapping[str, Any]],
                        bin_mappers: Sequence[BinMapper],
                        used_feature_map: np.ndarray,
                        feature_names: Optional[Sequence[str]] = None
                        ) -> Booster:
    """A prediction-only port Booster over carried-across trees."""
    config = Config(params or {})
    engine = GBDT(config, None, create_objective(config.objective, config))
    engine.models = trees_from_arrays(trees, bin_mappers, used_feature_map)
    engine.max_feature_idx = len(bin_mappers) - 1
    engine.feature_names = (list(feature_names) if feature_names else
                            [f"Column_{i}" for i in range(len(bin_mappers))])
    engine.feature_infos = [m.feature_info() for m in bin_mappers]
    return Booster.from_engine(params, engine)
