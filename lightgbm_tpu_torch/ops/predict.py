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


def _walk(tree, cols: torch.Tensor, steps: int, go_left_fn) -> torch.Tensor:
    """The lockstep walk shared by both routes: ``cols`` is the
    feature-major ``[F, R]`` row matrix, ``go_left_fn(x, node, single)``
    the direction at each row's node given its value ``x`` ([T, R])."""
    single = tree.left_child.dim() == 1
    lc = tree.left_child[None] if single else tree.left_child
    rc = tree.right_child[None] if single else tree.right_child
    feat = tree.split_feature[None] if single else tree.split_feature
    n_leaves = tree.num_leaves.reshape(-1)
    T, R = lc.shape[0], cols.shape[1]
    dev = cols.device
    node = torch.zeros((T, R), dtype=torch.int64, device=dev)
    leaf = torch.zeros((T, R), dtype=torch.int64, device=dev)
    active = (n_leaves > 1)[:, None].expand(T, R).clone()
    for _ in range(steps):
        x = cols.gather(0, feat.gather(1, node))
        go_left = go_left_fn(x, node, single)
        child = torch.where(go_left, lc.gather(1, node), rc.gather(1, node))
        leaf = torch.where(active & (child < 0), -(child + 1), leaf)
        active = active & (child >= 0)
        node = torch.where(active, child.clamp(min=0), node)
    return leaf[0] if single else leaf


def _at(a: torch.Tensor, node: torch.Tensor, single: bool) -> torch.Tensor:
    return (a[None] if single else a).gather(1, node)


def forest_leaf_bins(tree: BinnedTreeArrays, bins_t: torch.Tensor,
                     num_steps: Optional[int] = None) -> torch.Tensor:
    """Leaf index per row (int64) over binned rows ``bins_t`` ``[F, R]``.

    The per-feature missing routing (the NaN bin of nan-missing features,
    the default bin of zero-missing ones) is folded into two per-node
    constants computed at pack time:
    ``go_left = (b <= thr) XOR ((b == special) AND flip)``, where
    ``tree.special`` is the one bin whose routing may disagree with the
    compare (-1 when none) and ``tree.flip`` says whether it does. A
    categorical node sends left the bins its bitset holds (bit ``b % 32``
    of word ``b // 32``; bins past the words are not in it), so bin 0,
    NaN and unseen categories, goes right."""
    steps = _resolve_steps(num_steps, tree.max_leaves)
    W = tree.cat_words.shape[-1]

    def go_left(b, node, single):
        # u16 bins are held as int16 (ops/histogram.bin_ids): the 16 bits
        # read as unsigned
        b = (b.to(torch.int32) & 0xFFFF if b.dtype == torch.int16
             else b.to(torch.int32))
        left = (b <= _at(tree.threshold_bin, node, single)) ^ (
            (b == _at(tree.special, node, single))
            & _at(tree.flip, node, single))
        if W:
            words = tree.cat_words.reshape(*tree.is_cat.shape[:-1], -1)
            w = b >> 5
            word = _at(words, node * W + w.clamp(max=W - 1), single)
            in_set = (w < W) & (((word >> (b & 31)) & 1) != 0)
            left = torch.where(_at(tree.is_cat, node, single), in_set, left)
        return left

    return _walk(tree, bins_t, steps, go_left)


def tree_leaf_raw(tree: RawTreeArrays, X: torch.Tensor,
                  num_steps: Optional[int] = None) -> torch.Tensor:
    """Leaf index per row (int64) over raw f32 features ``X`` ``[R, C]``
    (ORIGINAL column layout). Mirrors tree.h NumericalDecision with the
    missing type resolved per node: None treats NaN as 0, Zero routes
    |x| <= 1e-35 to the default side, NaN routes NaN there. Categorical
    nodes are not handled: the packer refuses trees that have them."""
    return _leaf_raw_t(tree, X.T.contiguous(), num_steps)


def _leaf_raw_t(tree: RawTreeArrays, x_t: torch.Tensor,
                num_steps: Optional[int] = None) -> torch.Tensor:
    """``tree_leaf_raw`` over feature-major ``x_t`` ``[C, R]``."""
    steps = _resolve_steps(num_steps, tree.max_leaves)
    zt = torch.tensor(K_ZERO_THRESHOLD_F32, dtype=torch.float32,
                      device=x_t.device)

    def go_left(x, node, single):
        miss = _at(tree.missing_type, node, single)
        isnan = torch.isnan(x)
        x0 = torch.where(isnan, torch.zeros_like(x), x)
        is_missing = torch.where(
            miss == MISSING_ENUM["nan"], isnan,
            (miss == MISSING_ENUM["zero"]) & (x0.abs() <= zt))
        return torch.where(is_missing, _at(tree.default_left, node, single),
                           x0 <= _at(tree.threshold, node, single))

    return _walk(tree, x_t, steps, go_left)
