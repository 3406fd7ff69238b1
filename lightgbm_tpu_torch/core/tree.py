"""Tree model arrays and the host-side tree.

Port of ``lightgbm_tpu/core/tree.py`` (ref: include/LightGBM/tree.h:27,
src/io/tree.cpp). A categorical node holds its category set twice: as
the grower chose it, the set of BINS (``cat_bins_inner``, what the
binned device route tests), and as model text stores it, a bitset of
RAW category values (``cat_boundaries``/``cat_threshold``, what the host
walk tests). Node numbering matches Tree::Split:
splitting leaf ``l`` at step ``s`` creates internal node ``s``; the left
child keeps leaf index ``l``, the right child becomes leaf ``s+1``; leaves
are encoded in child pointers as ``~leaf_idx``.

The grower builds trees on the host (its per-split decisions are host
decisions), so ``TreeArrays`` holds numpy arrays here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


def _f32_round(arr32: np.ndarray) -> np.ndarray:
    """Widen an f32 result back to the f64 storage dtype (exact)."""
    return arr32.astype(np.float64)


def max_leaf_depth(left_child, right_child, num_leaves) -> int:
    """Max root->leaf path length in DECISIONS (0 for a single leaf).
    Malformed child pointers (cyclic / out of range) fall back to the
    exhaustive ``num_leaves - 1`` bound instead of looping."""
    n = int(num_leaves) - 1
    if n <= 0:
        return 0
    lc = np.asarray(left_child[:n], np.int64)
    rc = np.asarray(right_child[:n], np.int64)
    best = 1
    stack = [(0, 1)]
    budget = 4 * n + 8
    while stack:
        budget -= 1
        if budget <= 0:
            return n
        node, d = stack.pop()
        if d > best:
            best = d
        if d >= n:        # deeper than any well-formed tree: cycle
            return n
        for c in (int(lc[node]), int(rc[node])):
            if 0 <= c < n:
                stack.append((c, d + 1))
    return best


class TreeArrays(NamedTuple):
    """One tree. Internal-node arrays have length L-1, leaf arrays L."""
    split_feature: np.ndarray    # i32 [L-1] inner (used-feature) index
    threshold_bin: np.ndarray    # i32 [L-1]
    default_left: np.ndarray     # bool [L-1]
    left_child: np.ndarray       # i32 [L-1]; >=0 internal, <0 is ~leaf
    right_child: np.ndarray      # i32 [L-1]
    split_gain: np.ndarray       # f32 [L-1]
    internal_value: np.ndarray   # f32 [L-1] node output
    internal_weight: np.ndarray  # f32 [L-1] sum_hessian at node
    internal_count: np.ndarray   # f32 [L-1]
    leaf_value: np.ndarray       # f32 [L]
    leaf_weight: np.ndarray      # f32 [L] sum_hessian
    leaf_count: np.ndarray       # f32 [L]
    leaf_parent: np.ndarray      # i32 [L]
    num_leaves: int
    shrinkage: float
    # categorical splits (None without categorical features; ref: tree.h
    # cat_threshold_inner_): each node's set of category BINS
    cat_count: Optional[np.ndarray] = None  # i32 [L-1]; 0 = numerical
    cat_bins: Optional[np.ndarray] = None   # i32 [L-1, MAXK], -1 padded

    @property
    def max_leaves(self) -> int:
        return len(self.leaf_value)


class HostTree:
    """Host-side (numpy) view of a trained tree for model IO and
    prediction. Thresholds are resolved to real values by
    ``models/gbdt.finalize_tree`` through the dataset's BinMappers."""

    def __init__(self, arrays: TreeArrays, used_feature_map: np.ndarray):
        a = arrays._asdict()
        self.num_leaves = int(a["num_leaves"])
        n_int = max(self.num_leaves - 1, 0)
        self.split_feature_inner = np.asarray(
            a["split_feature"][:n_int]).astype(np.int32)
        self.split_feature = (
            used_feature_map[self.split_feature_inner]
            if n_int else np.zeros(0, np.int32))
        self.threshold_bin = np.asarray(a["threshold_bin"][:n_int])
        self.default_left = np.asarray(a["default_left"][:n_int])
        self.left_child = np.asarray(a["left_child"][:n_int])
        self.right_child = np.asarray(a["right_child"][:n_int])
        self.split_gain = np.asarray(a["split_gain"][:n_int]).astype(np.float64)
        self.internal_value = np.asarray(
            a["internal_value"][:n_int]).astype(np.float64)
        self.internal_weight = np.asarray(
            a["internal_weight"][:n_int]).astype(np.float64)
        self.internal_count = np.asarray(
            a["internal_count"][:n_int]).astype(np.int64)
        L = self.num_leaves
        self.leaf_value = np.asarray(a["leaf_value"][:L]).astype(np.float64)
        self.leaf_weight = np.asarray(a["leaf_weight"][:L]).astype(np.float64)
        self.leaf_count = np.asarray(a["leaf_count"][:L]).astype(np.int64)
        self.leaf_parent = np.asarray(a["leaf_parent"][:L])
        self.shrinkage = float(a["shrinkage"])
        self.max_depth = max_leaf_depth(self.left_child, self.right_child,
                                        self.num_leaves)
        # each node's category-BIN set from the grower (-1 padded; empty
        # for a numerical node); init_model rebinds a text tree's sets
        if a["cat_bins"] is not None and n_int:
            self.cat_bins_inner = np.asarray(
                a["cat_bins"][:n_int]).astype(np.int32)
            self.cat_count_inner = np.asarray(
                a["cat_count"][:n_int]).astype(np.int32)
        else:
            self.cat_bins_inner = np.zeros((n_int, 0), np.int32)
            self.cat_count_inner = np.zeros(n_int, np.int32)
        # filled by models/gbdt.finalize_tree
        self.threshold_real: np.ndarray = np.zeros(n_int, np.float64)
        self.decision_type: np.ndarray = np.zeros(n_int, np.int32)
        self.is_linear = False
        self.num_cat = 0
        # bitsets of RAW category values, one per categorical node (ref:
        # tree.h cat_boundaries_/cat_threshold_); only text trees have them
        self.cat_boundaries: np.ndarray = np.zeros(1, np.int64)
        self.cat_threshold: np.ndarray = np.zeros(0, np.uint32)
        # a tree parsed from model text holds ORIGINAL feature indices
        # and real thresholds only; GBDT.init_from_model rebinds it
        self.from_text = False
        self._init_linear_fields()

    def _init_linear_fields(self) -> None:
        """Each leaf's linear model (ref: tree.h leaf_const_/leaf_coeff_/
        leaf_features_), filled when ``is_linear``: features by ORIGINAL
        index."""
        L = self.num_leaves
        self.leaf_const = np.zeros(L, np.float64)
        self.leaf_coeff: list = [np.zeros(0, np.float64)] * L
        self.leaf_features: list = [[] for _ in range(L)]

    @classmethod
    def constant(cls, value: float) -> "HostTree":
        """Single-leaf constant tree (ref: tree.cpp Tree::AsConstantTree)."""
        zi = np.zeros(0, np.int32)
        zf = np.zeros(0, np.float32)
        return cls(TreeArrays(
            split_feature=zi, threshold_bin=zi, default_left=zi.astype(bool),
            left_child=zi, right_child=zi, split_gain=zf,
            internal_value=zf, internal_weight=zf, internal_count=zf,
            leaf_value=np.asarray([value], np.float64),
            leaf_weight=np.zeros(1), leaf_count=np.zeros(1),
            leaf_parent=np.full(1, -1, np.int32), num_leaves=1,
            shrinkage=1.0), np.zeros(0, np.int32))

    def copy(self) -> "HostTree":
        """Deep copy of every array (continued training keeps the source
        model intact)."""
        new = self.__class__.__new__(self.__class__)
        for k, v in self.__dict__.items():
            new.__dict__[k] = v.copy() if isinstance(v, (np.ndarray, list)) \
                else v
        return new

    def shrink(self, rate: float) -> None:
        """ref: tree.h Tree::Shrinkage.

        The product rounds through f32: the f32 score accumulator adds
        ``f32(leaf_value) * f32(rate)``, so the STORED value must be that
        exact product (an f64 product can differ by one ulp)."""
        self.leaf_value = _f32_round(
            self.leaf_value.astype(np.float32) * np.float32(rate))
        self.internal_value = _f32_round(
            self.internal_value.astype(np.float32) * np.float32(rate))
        self.shrinkage *= rate
        if self.is_linear:
            # the linear terms predict in f64 from raw features
            self.leaf_const = self.leaf_const * rate
            self.leaf_coeff = [c * rate for c in self.leaf_coeff]

    def add_bias(self, val: float) -> None:
        """ref: tree.cpp Tree::AddBias — folds the boost-from-average init
        score into the first tree. Rounds through f32 like :meth:`shrink`:
        the live score received ``f32(bias)`` and ``f32(leaf_value)`` as
        separate f32 adds."""
        self.leaf_value = _f32_round(
            self.leaf_value.astype(np.float32) + np.float32(val))
        self.internal_value = _f32_round(
            self.internal_value.astype(np.float32) + np.float32(val))
        if self.is_linear:
            self.leaf_const = self.leaf_const + val

    def add_output(self, delta: np.ndarray) -> None:
        self.leaf_value = self.leaf_value + delta

    def linear_output(self, X: np.ndarray, leaf: np.ndarray) -> np.ndarray:
        """f64 output of a LINEAR tree at each row, given the rows' raw
        features and leaves (ref: tree.cpp PredictionFunLinear): a row
        with NaN in one of its leaf's features gets the leaf's constant."""
        out = self.leaf_const[leaf]
        for l in range(self.num_leaves):
            feats = self.leaf_features[l]
            if not feats:
                continue
            rows = leaf == l
            if not rows.any():
                continue
            Xl = X[rows][:, feats].astype(np.float64)
            lin = Xl @ self.leaf_coeff[l]
            out[rows] += np.where(np.isnan(Xl).any(axis=1), 0.0, lin)
        return out

    def predict_leaf(self, X: np.ndarray) -> np.ndarray:
        """Raw-feature traversal -> leaf index per row."""
        n = X.shape[0]
        out = np.zeros(n, dtype=np.int64)
        if self.num_leaves == 1:
            return out
        node = np.zeros(n, dtype=np.int64)
        active = np.ones(n, dtype=bool)
        # decision_type bits (ref: tree.h kCategoricalMask=1,
        # kDefaultLeftMask=2, missing type in bits 2-3)
        for _ in range(self.num_leaves):  # depth bound
            if not active.any():
                break
            f = self.split_feature[node]
            thr = self.threshold_real[node]
            dl = (self.decision_type[node] & 2) != 0
            is_cat = (self.decision_type[node] & 1) != 0
            mtype = (self.decision_type[node] >> 2) & 3
            x = X[np.arange(n), f]
            isnan = np.isnan(x)
            x0 = np.where(isnan, 0.0, x)
            le = x0 <= thr
            if is_cat.any():
                # bitset membership on RAW category values (ref:
                # tree.h:375 CategoricalDecision + FindInBitset)
                le = np.where(is_cat,
                              self._cat_in_bitset(node, x0, isnan), le)
            # missing handling: 0 none (NaN->0), 1 zero, 2 nan
            miss = np.where(mtype == 2, isnan,
                            (mtype == 1) & (np.abs(x0) <= 1e-35))
            miss = miss & ~is_cat  # cat NaN/unseen goes right (not in set)
            go_left = np.where(miss, dl, le)
            child = np.where(go_left, self.left_child[node],
                             self.right_child[node])
            is_leaf = child < 0
            upd = active & is_leaf
            out[upd] = ~child[upd]
            active = active & ~is_leaf
            node = np.where(active, np.maximum(child, 0), node)
        return out

    def cat_values(self, cat_idx: int) -> list:
        """The raw category values of one categorical node's bitset (ref:
        Common::FindInBitset layout, 32-bit words)."""
        lo = int(self.cat_boundaries[cat_idx])
        hi = int(self.cat_boundaries[min(cat_idx + 1,
                                         len(self.cat_boundaries) - 1)])
        return [w * 32 + b for w in range(hi - lo) for b in range(32)
                if (int(self.cat_threshold[lo + w]) >> b) & 1]

    def _cat_in_bitset(self, node: np.ndarray, x0: np.ndarray,
                       isnan: np.ndarray) -> np.ndarray:
        """Vectorized FindInBitset over per-node category bitsets (ref:
        include/LightGBM/utils/common.h FindInBitset, tree.h:375-391
        CategoricalDecision). ``threshold_real`` of a categorical node
        holds its index into ``cat_boundaries``; NaN, negative values and
        values past the bitset are not in it."""
        cat_idx = self.threshold_real[node].astype(np.int64)
        cat_idx = np.clip(cat_idx, 0, max(self.num_cat - 1, 0))
        lo = self.cat_boundaries[cat_idx]
        hi = self.cat_boundaries[np.minimum(cat_idx + 1,
                                            len(self.cat_boundaries) - 1)]
        v = np.where(isnan | (x0 < 0), -1, np.floor(x0)).astype(np.int64)
        word = lo + (v >> 5)
        ok = (v >= 0) & (word < hi)
        word_c = np.clip(word, 0, max(len(self.cat_threshold) - 1, 0))
        bits = (self.cat_threshold[word_c] if len(self.cat_threshold)
                else np.zeros_like(word_c, np.uint32))
        return ok & (((bits >> (v & 31).astype(np.uint32)) & 1) != 0)

    def predict(self, X: np.ndarray) -> np.ndarray:
        leaf = self.predict_leaf(X)
        if self.is_linear:
            return self.linear_output(X, leaf)
        return self.leaf_value[leaf]
