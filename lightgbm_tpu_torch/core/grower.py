"""Leaf-wise (best-first) tree grower, compact row scheduling.

Port of ``lightgbm_tpu/core/grower.py`` ``make_tree_grower`` for
``row_sched="compact"`` and ``hist_pool="full"`` (ref:
src/treelearner/serial_tree_learner.cpp:183-249 main split loop, :344
smaller/larger leaf logic, :770 SplitInner; data_partition.hpp:22).

The JAX grower is one jitted ``fori_loop`` whose static shapes force
pow2 segment buckets, ``lax.switch`` over them and a latched ``done``
flag. Here the loop is eager Python over at most ``num_leaves - 1``
splits:

- rows are kept grouped by leaf in ``order`` (≡ DataPartition::indices_),
  each leaf owning a contiguous segment ``[start, start + rows)`` whose
  bounds live on the host;
- a split partitions its leaf's segment stably (left rows keep their
  order, then right rows keep theirs) and gathers exactly the smaller
  child's rows into a contiguous ``[S, F]`` block for the histogram
  kernel; the sibling is ``parent - smaller`` (the pool keeps every
  leaf's histogram). The JAX grower pads segments to a bucket with
  zero-mass rows, which add nothing, so the sums are the same;
- per-leaf statistics, best splits and histograms stay on the device as
  f32 tensors. The host reads one packed row per split (which leaf to
  split and where) and the size of the left child: those are control
  decisions. All gain and output arithmetic stays in f32 tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from ..ops.hist_cuda import hist_cuda_rm
from ..ops.split import (MISSING_ENUM, K_EPSILON, K_MIN_SCORE, FeatureMeta,
                         SplitHyperParams, best_split_for_leaf,
                         calculate_splitted_leaf_output, pack_record_rows)
from .tree import TreeArrays


@dataclasses.dataclass(frozen=True)
class GrowerConfig:
    """Knobs of the grower (the compact, full-pool subset of the JAX
    package's GrowerConfig)."""
    num_leaves: int = 31
    max_depth: int = -1
    num_bin: int = 256          # B: max bins over used features
    hparams: SplitHyperParams = SplitHyperParams()


# per-leaf stats columns (f32 [L, NS]), as in the JAX grower
S_SG, S_SH, S_CNT, S_VAL, S_LMIN, S_LMAX, S_DEPTH, S_PARENT, S_ISR, \
    S_NROW = range(10)
NS = 10
# packed SplitRecord columns (f32 [L, NB]; ops/split.pack_record_rows)
B_GAIN, B_FEAT, B_THR, B_DL, B_LG, B_LH, B_LC, B_LO, B_RG, B_RH, B_RC, \
    B_RO = range(12)
NB = 12
# tree internal-node columns (f32 [L-1, NN], host side)
N_FEAT, N_THR, N_DL, N_GAIN, N_IVAL, N_IWT, N_ICNT, N_LC, N_RC = range(9)
NN = 9


def _go_left(col: torch.Tensor, thr: int, default_left: bool, num_bin: int,
             missing_type: int, default_bin: int) -> torch.Tensor:
    """Partition direction of a bin column (ref: dense_bin.hpp:317
    SplitInner): ``bin <= threshold`` goes left, except the NaN bin
    (missing type nan) and the default bin (missing type zero), which
    follow ``default_left``."""
    go_left = col <= thr
    if missing_type == MISSING_ENUM["nan"]:
        go_left = torch.where(col == num_bin - 1, default_left, go_left)
    elif missing_type == MISSING_ENUM["zero"]:
        go_left = torch.where(col == default_bin, default_left, go_left)
    return go_left


def make_tree_grower(cfg: GrowerConfig, meta: FeatureMeta,
                     hist_fn: Callable = hist_cuda_rm):
    """Build ``grow(bins_rm, gh) -> (TreeArrays, leaf_id)``.

    ``bins_rm`` is uint8 ``[R, F]`` row-major, ``gh`` f32 ``[R, 3]`` =
    (grad, hess, 1); both on the training device. ``hist_fn(bins, gh,
    num_bin)`` builds one histogram (kernel K1 by default: the card's
    kernel for CUDA tensors, its plain version for CPU tensors).
    ``leaf_id`` (int64 ``[R]``, on the device) is each row's leaf.
    """
    hp = cfg.hparams
    L = cfg.num_leaves
    B = cfg.num_bin
    nbin_h = meta.num_bin.tolist()
    miss_h = meta.missing_type.tolist()
    dflt_h = meta.default_bin.tolist()

    def grow(bins_rm: torch.Tensor, gh: torch.Tensor
             ) -> Tuple[TreeArrays, torch.Tensor]:
        dev = gh.device
        R, F = bins_rm.shape
        f32 = dict(dtype=torch.float32, device=dev)

        # ---- root (ref: LeafSplits::Init + first FindBestSplits) --------
        sums = gh.sum(dim=0)
        root_g, root_h, root_c = sums[0], sums[1], sums[2]
        root_out = calculate_splitted_leaf_output(
            root_g, root_h + 2 * K_EPSILON, hp, root_c,
            torch.zeros((), **f32))
        hist_root = hist_fn(bins_rm, gh, B)
        best_root = best_split_for_leaf(hist_root, root_g, root_h, root_c,
                                        root_out, meta, hp)

        hist = torch.zeros((L, F, B, 3), **f32)
        hist[0] = hist_root
        stats = torch.zeros((L, NS), **f32)
        stats[:, S_LMIN] = -np.inf
        stats[:, S_LMAX] = np.inf
        stats[:, S_PARENT] = -1.0
        stats[0, S_SG:S_VAL + 1] = torch.stack([root_g, root_h, root_c,
                                                root_out])
        best = torch.zeros((L, NB), **f32)
        best[:, B_GAIN] = K_MIN_SCORE
        best[:, B_FEAT] = -1.0
        best[:, B_DL] = 1.0
        best[0] = pack_record_rows(best_root)

        node = np.zeros((max(L - 1, 0), NN), np.float32)
        order = torch.arange(R, device=dev)
        seg_start = [0] * L
        seg_rows = [0] * L
        seg_rows[0] = R
        num_leaves = 1

        for i in range(L - 1):
            # ---- pick the best leaf (ref: serial_tree_learner.cpp:229) ---
            cand = best[:num_leaves, B_GAIN]
            if cfg.max_depth > 0:
                cand = torch.where(stats[:num_leaves, S_DEPTH]
                                   < cfg.max_depth, cand, K_MIN_SCORE)
            lt = torch.argmax(cand)
            # one device->host read per split: the chosen leaf, its gain,
            # its best split and its stats
            head = torch.cat([lt.to(torch.float32)[None], cand[lt][None],
                              best[lt], stats[lt]]).cpu().numpy()
            l, gain = int(head[0]), head[1]
            if not gain > 0.0:
                break
            brow, srow = head[2:2 + NB], head[2 + NB:]
            new_leaf = i + 1

            # ---- record the split (ref: tree.cpp Tree::Split) ------------
            node[i] = [brow[B_FEAT], brow[B_THR], brow[B_DL], brow[B_GAIN],
                       srow[S_VAL], srow[S_SH], srow[S_CNT], -(l + 1.0),
                       -(new_leaf + 1.0)]
            p = int(srow[S_PARENT])
            if p >= 0:
                node[p, N_RC if srow[S_ISR] > 0.5 else N_LC] = i

            # ---- stable partition of the leaf's segment ------------------
            f = int(brow[B_FEAT])
            start, rows = seg_start[l], seg_rows[l]
            seg = order[start:start + rows]
            go_left = _go_left(bins_rm[seg, f], int(brow[B_THR]),
                               bool(brow[B_DL] > 0.5), nbin_h[f], miss_h[f],
                               dflt_h[f])
            n_left = int(go_left.sum())
            order[start:start + rows] = torch.cat([seg[go_left],
                                                   seg[~go_left]])
            n_right = rows - n_left
            seg_start[l], seg_rows[l] = start, n_left
            seg_start[new_leaf], seg_rows[new_leaf] = start + n_left, n_right

            # ---- smaller child's histogram, sibling by subtraction -------
            left_smaller = n_left <= n_right
            s_start = start if left_smaller else start + n_left
            s_rows = n_left if left_smaller else n_right
            idx = order[s_start:s_start + s_rows]
            hist_small = hist_fn(bins_rm.index_select(0, idx),
                                 gh.index_select(0, idx), B)
            hist_large = hist[l] - hist_small
            if left_smaller:
                hist[l], hist[new_leaf] = hist_small, hist_large
            else:
                hist[l], hist[new_leaf] = hist_large, hist_small

            # ---- children stats and best splits --------------------------
            depth = srow[S_DEPTH] + 1.0
            child = np.asarray(
                [[brow[B_LG], brow[B_LH], brow[B_LC], brow[B_LO],
                  srow[S_LMIN], srow[S_LMAX], depth, i, 0.0, 2 * i + 1],
                 [brow[B_RG], brow[B_RH], brow[B_RC], brow[B_RO],
                  srow[S_LMIN], srow[S_LMAX], depth, i, 1.0, 2 * i + 2]],
                np.float32)
            child = torch.from_numpy(child).to(dev)
            pair = [l, new_leaf]
            stats[pair] = child
            rec2 = best_split_for_leaf(
                hist[pair], child[:, S_SG], child[:, S_SH],
                child[:, S_CNT], child[:, S_VAL], meta, hp)
            best[pair] = pack_record_rows(rec2)
            num_leaves = new_leaf + 1

        # ---- materialize the tree ----------------------------------------
        statm = stats.cpu().numpy()
        grew = num_leaves > 1
        i32 = lambda c: node[:, c].astype(np.int32)
        tree = TreeArrays(
            split_feature=i32(N_FEAT),
            threshold_bin=i32(N_THR),
            default_left=node[:, N_DL] > 0.5,
            left_child=i32(N_LC),
            right_child=i32(N_RC),
            split_gain=node[:, N_GAIN],
            internal_value=node[:, N_IVAL],
            internal_weight=node[:, N_IWT],
            internal_count=node[:, N_ICNT],
            leaf_value=(statm[:, S_VAL] if grew else np.zeros(L, np.float32)),
            leaf_weight=(statm[:, S_SH] if grew else np.zeros(L, np.float32)),
            leaf_count=(statm[:, S_CNT] if grew else np.zeros(L, np.float32)),
            leaf_parent=statm[:, S_PARENT].astype(np.int32),
            num_leaves=num_leaves,
            shrinkage=1.0)
        # each row's leaf, from the final segments
        starts = torch.tensor(seg_start[:num_leaves], device=dev)
        counts = torch.tensor(seg_rows[:num_leaves], device=dev)
        by_pos = torch.argsort(starts)
        pos2leaf = torch.repeat_interleave(by_pos, counts[by_pos])
        leaf_id = torch.empty(R, dtype=torch.int64, device=dev)
        leaf_id[order] = pos2leaf
        return tree, leaf_id

    return grow
