"""Batched tree traversal on the device.

Port of ``lightgbm_tpu/ops/predict.py`` (ref: include/LightGBM/tree.h:135
NumericalDecision, src/io/tree.cpp, src/treelearner/cuda/cuda_tree.cu
AddPredictionToScore): every row advances in lockstep through
structure-of-arrays tree nodes, one gather and one vectorized compare per
step, for ``depth_steps`` steps — the deepest leaf's depth (rounded up to
a multiple of 4), not the worst-case ``num_leaves - 1``. Rows that reach
a leaf early stay there through the ``active`` mask, so more steps than a
row needs never change its leaf.

The functions take one tree (node arrays ``[L-1]``) or a stack of ``T``
trees (``[T, L-1]``, as ``ops/forest.py`` packs them) and return the leaf
of every row, ``[R]`` or ``[T, R]``. Two entry points:

- ``forest_leaf_bins``: over BINNED rows ``[F, R]`` (int32, uint8, or
  u16 bins held as int16) with integer bin thresholds and each node's
  missing routing folded into two constants; a categorical node tests
  its bitset over bins (ref: tree.h CategoricalDecisionInner);
- ``tree_leaf_raw``: over RAW feature values ``[R, C]`` (a model without
  the training bin mappers), missing handling resolved per node from its
  ``decision_type``.

Each has a fleet form (``fleet_leaf_bins``, ``fleet_leaf_raw``) over a
shape bucket's stacked mega-pack of many tenants' trees, in which each
row walks the trees of its own tenant (``tid``); a node's fields are read
from the flattened ``[T * (L-1)]`` arrays at ``tid * (L-1) + node``.

Plain PyTorch: the JAX package has no Pallas kernel here either.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .split import MISSING_ENUM

K_ZERO_THRESHOLD = 1e-35      # ref: tree.h kZeroThreshold
# f32 floor of kZeroThreshold for the device compare: float32(1e-35)
# rounds UP, so x = float32(1e-35) would pass |x| <= float32(1e-35) but
# not the host walk's |x| <= 1e-35. The largest f32 <= 1e-35 compares
# like the f64 constant for every f32 input.
_ZT32 = np.float32(K_ZERO_THRESHOLD)
if float(_ZT32) > K_ZERO_THRESHOLD:
    _ZT32 = np.nextafter(_ZT32, np.float32(-np.inf))
K_ZERO_THRESHOLD_F32 = float(_ZT32)


def depth_steps(max_depth: Optional[int], max_leaves: int) -> int:
    """Traversal step count for a tree (or a stack of trees) of the given
    max leaf depth: rounded UP to a multiple of 4, capped at the
    exhaustive ``max_leaves - 1``. Extra steps change no leaf."""
    if max_depth is None:
        return max_leaves - 1
    d = int(max_depth)
    if d <= 0:
        return 0
    return min(max_leaves - 1, ((d + 3) // 4) * 4)


def _resolve_steps(num_steps: Optional[int], max_leaves: int) -> int:
    """Loop bound: ``num_steps`` (the packs give ``depth_steps`` of their
    window), else the exhaustive ``max_leaves - 1``."""
    if num_steps is not None:
        return min(int(num_steps), max_leaves - 1)
    return max_leaves - 1


class BinnedTreeArrays(NamedTuple):
    """One tree, or ``T`` trees stacked on a leading axis, in binned
    serving form (device tensors). ``special``/``flip`` fold each node's
    missing routing (see ``forest_leaf_bins``); a categorical node
    (``is_cat``) holds its set of bins as a bitset of ``W`` 32-bit words
    (``cat_words``; W is 0 when no feature is categorical)."""
    split_feature: torch.Tensor   # int64 [.., L-1] used-feature index
    threshold_bin: torch.Tensor   # int32 [.., L-1]
    special: torch.Tensor         # int32 [.., L-1]; -1 none
    flip: torch.Tensor            # bool [.., L-1]
    left_child: torch.Tensor      # int64 [.., L-1]; >=0 internal, <0 ~leaf
    right_child: torch.Tensor     # int64 [.., L-1]
    leaf_value: torch.Tensor      # f32 [.., L]
    num_leaves: torch.Tensor      # int64 [..]
    is_cat: torch.Tensor          # bool [.., L-1]
    cat_words: torch.Tensor       # int32 [.., L-1, W]

    @property
    def max_leaves(self) -> int:
        return self.leaf_value.shape[-1]


class RawTreeArrays(NamedTuple):
    """One tree, or ``T`` stacked trees, in raw serving form: ORIGINAL
    column indices, thresholds stored as the f32 floor of the f64 model
    threshold (so the f32 compare decides like the host f64 walk for
    every f32 input, ``ops/forest.f32_floor``) and the missing type of
    each node from its decision_type."""
    split_feature: torch.Tensor   # int64 [.., L-1] ORIGINAL column index
    threshold: torch.Tensor       # f32 [.., L-1]
    default_left: torch.Tensor    # bool [.., L-1]
    missing_type: torch.Tensor    # int32 [.., L-1] per MISSING_ENUM
    left_child: torch.Tensor      # int64 [.., L-1]
    right_child: torch.Tensor     # int64 [.., L-1]
    leaf_value: torch.Tensor      # f32 [.., L]
    num_leaves: torch.Tensor      # int64 [..]

    @property
    def max_leaves(self) -> int:
        return self.leaf_value.shape[-1]


def _walk(tree, cols: torch.Tensor, steps: int, go_left_fn,
          tid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The lockstep walk shared by both routes: ``cols`` is the
    feature-major ``[F, R]`` row matrix, ``go_left_fn(x, idx)`` the
    direction at each row's node given its value ``x`` and the node's
    index ``idx`` into the flattened ``[T * (L-1)]`` node arrays. Without
    ``tid`` tree t of a stack walks every row (``[T, R]``); with it
    (``[W, R]``, the fleet) row r walks tree ``tid[w, r]`` in slot w."""
    single = tree.left_child.dim() == 1
    li = tree.left_child.shape[-1]
    lc = tree.left_child.reshape(-1)
    rc = tree.right_child.reshape(-1)
    feat = tree.split_feature.reshape(-1)
    R, dev = cols.shape[1], cols.device
    if tid is None:
        T = 1 if single else tree.left_child.shape[0]
        tid = torch.arange(T, device=dev)[:, None].expand(T, R)
    base = tid * li
    node = torch.zeros_like(base)
    leaf = torch.zeros_like(base)
    active = tree.num_leaves.reshape(-1)[tid] > 1
    for _ in range(steps):
        idx = base + node
        x = cols.gather(0, feat[idx])
        child = torch.where(go_left_fn(x, idx), lc[idx], rc[idx])
        leaf = torch.where(active & (child < 0), -(child + 1), leaf)
        active = active & (child >= 0)
        node = torch.where(active, child.clamp(min=0), node)
    return leaf[0] if single else leaf


def fold_missing(split_feature, threshold_bin, default_left, is_cat,
                 feat_nbin, feat_miss, feat_dflt):
    """``special`` (int32) and ``flip`` (bool) of each node for
    ``forest_leaf_bins``: the one bin of the node's feature whose missing
    routing may disagree with ``b <= threshold_bin`` (the NaN bin of a
    nan-missing feature, the default bin of a zero-missing one, -1 for
    none or a categorical node) and whether it does, from the per-feature
    bin counts, missing types (``MISSING_ENUM``) and default bins."""
    f = np.asarray(split_feature, np.int64)
    miss = np.asarray(feat_miss)[f]
    sp = np.where(miss == MISSING_ENUM["nan"], np.asarray(feat_nbin)[f] - 1,
                  np.where(miss == MISSING_ENUM["zero"],
                           np.asarray(feat_dflt)[f], -1))
    special = np.where(is_cat, -1, sp).astype(np.int32)
    flip = (special >= 0) & (np.asarray(default_left, bool) !=
                             (sp <= np.asarray(threshold_bin, np.int64)))
    return special, flip


def cat_bitset(cat_bins, cat_count, is_cat, width: int) -> np.ndarray:
    """uint32 ``[nodes, width]``: for each categorical node the bitset of
    its first ``cat_count`` bins of ``cat_bins`` (bit ``b % 32`` of word
    ``b // 32``)."""
    words = np.zeros((len(is_cat), width), np.uint32)
    for i in np.flatnonzero(is_cat):
        b = np.asarray(cat_bins[i, :cat_count[i]], np.int64)
        np.bitwise_or.at(words[i], b >> 5,
                         np.left_shift(np.uint32(1),
                                       (b & 31).astype(np.uint32)))
    return words


def tree_leaf_bins(tree, bins_t: torch.Tensor, feat_num_bin, feat_missing,
                   feat_default_bin, num_steps: Optional[int] = None
                   ) -> torch.Tensor:
    """Leaf index per row (int64 ``[R]``) of one ``core/tree.TreeArrays``
    over binned rows ``bins_t`` ``[F, R]`` (the JAX package's
    ops/predict.py:88): the tree is packed as ``forest_leaf_bins`` walks
    it, each node's missing routing folded by ``fold_missing`` from the
    per-feature ``feat_num_bin``, ``feat_missing`` and
    ``feat_default_bin``."""
    li = tree.max_leaves - 1
    count = (np.zeros(li, np.int64) if tree.cat_count is None
             else np.asarray(tree.cat_count))
    is_cat = count > 0
    width = (int(np.asarray(tree.cat_bins)[is_cat].max()) >> 5) + 1 \
        if is_cat.any() else 0
    special, flip = fold_missing(tree.split_feature, tree.threshold_bin,
                                 tree.default_left, is_cat, feat_num_bin,
                                 feat_missing, feat_default_bin)
    dev = bins_t.device

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    packed = BinnedTreeArrays(
        split_feature=t(tree.split_feature, torch.int64),
        threshold_bin=t(tree.threshold_bin, torch.int32),
        special=t(special, torch.int32), flip=t(flip, torch.bool),
        left_child=t(tree.left_child, torch.int64),
        right_child=t(tree.right_child, torch.int64),
        leaf_value=t(tree.leaf_value, torch.float32),
        num_leaves=t(int(tree.num_leaves), torch.int64),
        is_cat=t(is_cat, torch.bool),
        cat_words=t(cat_bitset(tree.cat_bins, count, is_cat,
                               width).view(np.int32), torch.int32))
    return forest_leaf_bins(packed, bins_t, num_steps)


def tree_output_bins(tree, bins_t: torch.Tensor, feat_num_bin, feat_missing,
                     feat_default_bin, num_steps: Optional[int] = None
                     ) -> torch.Tensor:
    """Per-row output of one tree over binned rows (its leaf values hold
    the shrinkage already)."""
    leaf = tree_leaf_bins(tree, bins_t, feat_num_bin, feat_missing,
                          feat_default_bin, num_steps=num_steps)
    return torch.as_tensor(np.asarray(tree.leaf_value), dtype=torch.float32,
                           device=bins_t.device)[leaf]


def forest_leaf_bins(tree: BinnedTreeArrays, bins_t: torch.Tensor,
                     num_steps: Optional[int] = None,
                     tid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Leaf index per row (int64) over binned rows ``bins_t`` ``[F, R]``.

    The per-feature missing routing (the NaN bin of nan-missing features,
    the default bin of zero-missing ones) is folded into two per-node
    constants computed at pack time:
    ``go_left = (b <= thr) XOR ((b == special) AND flip)``, where
    ``tree.special`` is the one bin whose routing may disagree with the
    compare (-1 when none) and ``tree.flip`` says whether it does. A
    categorical node sends left the bins its bitset holds (bit ``b % 32``
    of word ``b // 32``; bins past the words are not in it), so bin 0,
    NaN and unseen categories, goes right. ``tid``: see ``_walk``."""
    steps = _resolve_steps(num_steps, tree.max_leaves)
    W = tree.cat_words.shape[-1]
    thr, special, flip, words, is_cat = (
        a.reshape(-1) for a in (tree.threshold_bin, tree.special,
                                tree.flip, tree.cat_words, tree.is_cat))

    def go_left(b, idx):
        # u16 bins are held as int16 (ops/histogram.bin_ids): the 16 bits
        # read as unsigned
        b = (b.to(torch.int32) & 0xFFFF if b.dtype == torch.int16
             else b.to(torch.int32))
        left = (b <= thr[idx]) ^ ((b == special[idx]) & flip[idx])
        if W:
            w = b >> 5
            word = words[idx * W + w.clamp(max=W - 1)]
            in_set = (w < W) & (((word >> (b & 31)) & 1) != 0)
            left = torch.where(is_cat[idx], in_set, left)
        return left

    return _walk(tree, bins_t, steps, go_left, tid)


def fleet_leaf_bins(trees: BinnedTreeArrays, tid: torch.Tensor,
                    bins_t: torch.Tensor,
                    num_steps: Optional[int] = None) -> torch.Tensor:
    """``[W, R]`` leaves of a fleet batch (the JAX package's
    ops/predict.py:180): ``trees`` is a bucket's stacked mega-pack, and
    row r walks tree ``tid[w, r]`` in slot w, over ``bins_t`` ``[F, R]``
    laid out in each row's own tenant's used-feature order. Each row's
    leaf is ``forest_leaf_bins`` of its one tree."""
    return forest_leaf_bins(trees, bins_t, num_steps, tid)


def tree_leaf_raw(tree: RawTreeArrays, X: torch.Tensor,
                  num_steps: Optional[int] = None) -> torch.Tensor:
    """Leaf index per row (int64) over raw f32 features ``X`` ``[R, C]``
    (ORIGINAL column layout). Mirrors tree.h NumericalDecision with the
    missing type resolved per node: None treats NaN as 0, Zero routes
    |x| <= 1e-35 to the default side, NaN routes NaN there. Categorical
    nodes are not handled: the packer refuses trees that have them."""
    return _leaf_raw_t(tree, X.T.contiguous(), num_steps)


def _leaf_raw_t(tree: RawTreeArrays, x_t: torch.Tensor,
                num_steps: Optional[int] = None,
                tid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``tree_leaf_raw`` over feature-major ``x_t`` ``[C, R]``; ``tid``:
    see ``_walk``."""
    steps = _resolve_steps(num_steps, tree.max_leaves)
    zt = torch.tensor(K_ZERO_THRESHOLD_F32, dtype=torch.float32,
                      device=x_t.device)
    mtype, dflt, thr = (a.reshape(-1) for a in (
        tree.missing_type, tree.default_left, tree.threshold))

    def go_left(x, idx):
        miss = mtype[idx]
        isnan = torch.isnan(x)
        x0 = torch.where(isnan, torch.zeros_like(x), x)
        is_missing = torch.where(
            miss == MISSING_ENUM["nan"], isnan,
            (miss == MISSING_ENUM["zero"]) & (x0.abs() <= zt))
        return torch.where(is_missing, dflt[idx], x0 <= thr[idx])

    return _walk(tree, x_t, steps, go_left, tid)


def fleet_leaf_raw(trees: RawTreeArrays, tid: torch.Tensor,
                   x_t: torch.Tensor,
                   num_steps: Optional[int] = None) -> torch.Tensor:
    """The raw-route ``fleet_leaf_bins`` (the JAX package's
    ops/predict.py:294) over feature-major f32 values ``x_t`` ``[C, R]``,
    each row's columns in its own tenant's original layout."""
    return _leaf_raw_t(trees, x_t, num_steps, tid)
