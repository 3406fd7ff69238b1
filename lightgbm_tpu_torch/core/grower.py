"""Leaf-wise (best-first) tree grower, compact and full row scheduling.

Port of ``lightgbm_tpu/core/grower.py`` ``make_tree_grower`` for
``row_sched="compact"`` and ``row_sched="full"`` with ``hist_pool="full"``
(ref: src/treelearner/serial_tree_learner.cpp:183-249 main split loop,
:344 smaller/larger leaf logic, :770 SplitInner; data_partition.hpp:22),
with its quantized-gradient and bf16 histogram modes.

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

Full row scheduling (``row_sched="full"``; the engine maps ``leaf`` to
it, as the JAX package does) keeps no row order: bins are FEATURE-major
``[F, R]``, every row carries its leaf in ``leaf_id``, a split rewrites
``leaf_id`` of its leaf's right-going rows from the split feature's bin
column (one contiguous row of the bins), and the smaller child — chosen
by the split record's counts, already on the host — gets its histogram
from one pass that reads every row's leaf id and adds the child's rows,
``hist_fn(bins, gh, B, leaf_id=leaf_id, leaf=small)`` (kernel B2, with
the JAX package's mask ``gh * (leaf_id == small)`` fused into it). The
two modes share the root state, the leaf pick, the children's scan, the
sibling subtraction and the tree.

Histogram modes (``hist_inputs``), as in the JAX grower:

- quantized (``use_quantized_grad``): gh is quantized once per tree to
  int8 (``quantize_gradients``); the pool and the root sums are int32,
  sibling subtraction is exact, and every histogram and sum goes through
  ``conv`` (the per-tree scales) right before the split scan;
- bf16 (``tpu_hist_dtype=bfloat16``): gh is rounded to bf16 once per tree
  for the histograms only; root sums come from the f32 gh, and the pool
  is f32. Compact (and level) scheduling only: the JAX full grower reads
  ``hist_dtype`` on the compact path alone, so full scheduling builds f32
  histograms under it.

``grow.resume`` is the counterpart of the JAX grower's ``init=(state,
k0)`` seam: it continues the split loop at step ``k0`` from a
``GrowState`` that another phase (the hybrid grower's level phase)
committed.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..ops.hist_cuda import hist_cuda_fm, hist_cuda_rm
from ..ops.histogram import bin_ids
from ..ops.split import (MISSING_ENUM, K_EPSILON, K_MIN_SCORE, FeatureMeta,
                         SplitHyperParams, best_split_for_leaf,
                         calculate_splitted_leaf_output, column_sum,
                         pack_record_rows)
from .tree import TreeArrays


@dataclasses.dataclass(frozen=True)
class GrowerConfig:
    """Knobs of the grower (the compact/full, full-pool subset of the JAX
    package's GrowerConfig, and its histogram modes)."""
    num_leaves: int = 31
    max_depth: int = -1
    num_bin: int = 256          # B: max bins over used features
    hparams: SplitHyperParams = SplitHyperParams()
    # row scheduling: "compact" (row-major [R, F] bins, gathered leaf
    # blocks, kernel K1) | "full" (feature-major [F, R] bins, masked
    # full passes, kernel B2)
    row_sched: str = "compact"
    # histogram input dtype: float32 | bfloat16 (ignored when quantized,
    # and under full scheduling)
    hist_dtype: str = "float32"
    # quantized-gradient training (ref: gradient_discretizer.{hpp,cpp})
    quantized: bool = False
    quant_bins: int = 4          # ref: num_grad_quant_bins
    stochastic_rounding: bool = True


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


def quantize_gradients(gh: torch.Tensor, quant_bins: int, ug, uh
                       ) -> Tuple[torch.Tensor, Callable]:
    """int8 gradient discretization (ref: GradientDiscretizer::
    DiscretizeGradients, gradient_discretizer.cpp:71-162; port of the JAX
    grower's ``quantize_gradients``): grad is scaled to
    ``[-quant_bins/2, quant_bins/2]`` and hess to ``[0, quant_bins]``
    and rounded ``trunc(x / scale ± u)``; the mask channel stays exact.

    ``ug`` and ``uh`` are the uniform [0, 1) draws of stochastic rounding
    (f32 tensors [R]), or 0.5 each for round-to-nearest. Returns
    ``(gh_int8 [R, 3], conv)``; ``conv`` maps raw int32 sums back to f32
    through the per-tree scales ``(g_scale, h_scale, 1)``."""
    g, h, m = gh[:, 0], gh[:, 1], gh[:, 2]
    kq = max(quant_bins // 2, 1)
    g_scale = torch.clamp(g.abs().max(), min=1e-30) / kq
    h_scale = torch.clamp(h.max(), min=1e-30) / quant_bins
    ug = torch.as_tensor(ug, dtype=torch.float32, device=gh.device)
    uh = torch.as_tensor(uh, dtype=torch.float32, device=gh.device)
    gq = torch.trunc(g / g_scale + torch.where(g >= 0, ug, -ug))
    hq = torch.trunc(h / h_scale + uh)
    gh_q = torch.stack([gq, hq, m], dim=1).to(torch.int8)
    scale3 = torch.stack([g_scale, h_scale, torch.ones_like(g_scale)])
    return gh_q, (lambda hh: hh.to(torch.float32) * scale3)


def hist_inputs(cfg: GrowerConfig, gh: torch.Tensor, uniforms=None
                ) -> Tuple[torch.Tensor, Callable]:
    """The histogram kernels' gh for one tree and the ``conv`` that turns
    their raw sums into the split scan's f32: int8 when quantized (with
    ``uniforms = (ug, uh)``, or 0.5 each without stochastic rounding),
    bf16 in the bf16 mode, else ``gh`` itself."""
    if cfg.quantized:
        ug, uh = (uniforms if cfg.stochastic_rounding else (0.5, 0.5))
        return quantize_gradients(gh, cfg.quant_bins, ug, uh)
    if cfg.hist_dtype in ("bfloat16", "bf16") and cfg.row_sched != "full":
        return gh.to(torch.bfloat16), (lambda hh: hh)
    return gh, (lambda hh: hh)


def root_sums(cfg: GrowerConfig, gh: torch.Tensor, gh_hist: torch.Tensor,
              conv: Callable) -> torch.Tensor:
    """f32 [3] (grad, hess, count) of all rows: from the int8 rows under
    quantization (exact int32, converted), else from the f32 gh."""
    if cfg.quantized:
        return conv(gh_hist.sum(dim=0, dtype=torch.int32))
    return column_sum(gh)


@dataclasses.dataclass
class GrowState:
    """What the split loop carries between steps. Device tensors: the
    histogram pool ``hist`` [L, F, B, 3] (int32 under quantization, else
    f32), ``stats`` [L, NS], ``best`` [L, NB], and ``order`` [R] (compact)
    or ``leaf_id`` [R] (full). Host values: the internal-node rows
    ``node`` [L-1, NN], each leaf's segment ``seg_start``/``seg_rows``
    (compact), and ``num_leaves``."""
    hist: torch.Tensor
    stats: torch.Tensor
    best: torch.Tensor
    order: Optional[torch.Tensor]
    node: np.ndarray
    seg_start: List[int]
    seg_rows: List[int]
    num_leaves: int
    leaf_id: Optional[torch.Tensor] = None


def _go_left(col: torch.Tensor, thr: int, default_left: bool, num_bin: int,
             missing_type: int, default_bin: int) -> torch.Tensor:
    """Partition direction of a bin column (ref: dense_bin.hpp:317
    SplitInner): ``bin <= threshold`` goes left, except the NaN bin
    (missing type nan) and the default bin (missing type zero), which
    follow ``default_left``. u16 bins (int16) are read as unsigned
    first."""
    if col.dtype != torch.uint8:
        col = bin_ids(col)
    go_left = col <= thr
    if missing_type == MISSING_ENUM["nan"]:
        go_left = torch.where(col == num_bin - 1, default_left, go_left)
    elif missing_type == MISSING_ENUM["zero"]:
        go_left = torch.where(col == default_bin, default_left, go_left)
    return go_left


def make_tree_grower(cfg: GrowerConfig, meta: FeatureMeta,
                     hist_fn: Optional[Callable] = None):
    """Build ``grow(bins, gh, uniforms=None) -> (TreeArrays, leaf_id)``.

    ``bins`` is ``[R, F]`` row-major under compact scheduling and
    ``[F, R]`` feature-major under full scheduling, uint8 or u16 held as
    int16 (``ops/histogram.bin_ids``); ``gh`` f32 ``[R, 3]``
    = (grad, hess, 1); both on the training device. ``uniforms`` are the
    stochastic-rounding draws ``(ug, uh)`` of a quantized tree.
    ``hist_fn(bins, gh, num_bin)`` builds one histogram (by default kernel
    K1 for compact and B2 for full scheduling: the card's kernel for CUDA
    tensors, its plain version for CPU tensors); under full scheduling it
    also takes ``leaf_id=`` and ``leaf=`` keywords and adds only that
    leaf's rows (``ops/hist_cuda.hist_cuda_fm``'s contract). ``leaf_id``
    (int64 ``[R]``, on the device) is each row's leaf.

    ``grow.resume(bins, gh_hist, conv, state, k0)`` runs the split loop
    from step ``k0`` over a committed ``GrowState``.
    """
    hp = cfg.hparams
    L = cfg.num_leaves
    B = cfg.num_bin
    full = cfg.row_sched == "full"
    if hist_fn is None:
        hist_fn = hist_cuda_fm if full else hist_cuda_rm
    nbin_h = meta.num_bin.tolist()
    miss_h = meta.missing_type.tolist()
    dflt_h = meta.default_bin.tolist()

    def root_state(bins, gh, gh_hist, conv) -> GrowState:
        """ref: LeafSplits::Init + the first FindBestSplits."""
        dev = gh.device
        F, R = bins.shape if full else bins.shape[::-1]
        f32 = dict(dtype=torch.float32, device=dev)
        sums = root_sums(cfg, gh, gh_hist, conv)
        root_g, root_h, root_c = sums[0], sums[1], sums[2]
        root_out = calculate_splitted_leaf_output(
            root_g, root_h + 2 * K_EPSILON, hp, root_c,
            torch.zeros((), **f32))
        hist_root = hist_fn(bins, gh_hist, B)
        best_root = best_split_for_leaf(conv(hist_root), root_g, root_h,
                                        root_c, root_out, meta, hp)

        hist = torch.zeros((L, F, B, 3), dtype=hist_root.dtype, device=dev)
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
        seg_rows = [0] * L
        seg_rows[0] = R
        return GrowState(
            hist=hist, stats=stats, best=best,
            order=None if full else torch.arange(R, device=dev),
            node=np.zeros((max(L - 1, 0), NN), np.float32),
            seg_start=[0] * L, seg_rows=seg_rows, num_leaves=1,
            leaf_id=(torch.zeros(R, dtype=torch.int64, device=dev)
                     if full else None))

    def partition_compact(bins_rm, gh_hist, st, l, new_leaf, f, thr, dl):
        """Stable partition of leaf ``l``'s segment; the smaller child's
        histogram from its gathered rows. Returns (left_smaller,
        hist_small)."""
        order, seg_start, seg_rows = st.order, st.seg_start, st.seg_rows
        start, rows = seg_start[l], seg_rows[l]
        seg = order[start:start + rows]
        go_left = _go_left(bins_rm[seg, f], thr, dl, nbin_h[f], miss_h[f],
                           dflt_h[f])
        n_left = int(go_left.sum())
        order[start:start + rows] = torch.cat([seg[go_left],
                                               seg[~go_left]])
        n_right = rows - n_left
        seg_start[l], seg_rows[l] = start, n_left
        seg_start[new_leaf], seg_rows[new_leaf] = start + n_left, n_right
        left_smaller = n_left <= n_right
        s_start = start if left_smaller else start + n_left
        s_rows = n_left if left_smaller else n_right
        idx = order[s_start:s_start + s_rows]
        return left_smaller, hist_fn(bins_rm.index_select(0, idx),
                                     gh_hist.index_select(0, idx), B)

    def partition_full(bins_fm, gh_hist, st, l, new_leaf, f, thr, dl,
                       left_smaller):
        """Leaf ``l``'s right-going rows move to ``new_leaf`` (ref:
        core/grower.py:1045-1060); the smaller child's histogram is one
        pass over all rows that adds the child's (``leaf_hist``,
        :601-603, the mask fused into the kernel). Returns hist_small."""
        go_left = _go_left(bins_fm[f], thr, dl, nbin_h[f], miss_h[f],
                           dflt_h[f])
        st.leaf_id = torch.where((st.leaf_id == l) & ~go_left, new_leaf,
                                 st.leaf_id)
        return hist_fn(bins_fm, gh_hist, B, leaf_id=st.leaf_id,
                       leaf=l if left_smaller else new_leaf)

    def resume(bins: torch.Tensor, gh_hist: torch.Tensor, conv: Callable,
               st: GrowState, k0: int) -> Tuple[TreeArrays, torch.Tensor]:
        dev = gh_hist.device
        R = gh_hist.shape[0]
        hist, stats, best, node = st.hist, st.stats, st.best, st.node
        num_leaves = st.num_leaves

        for i in range(k0, L - 1):
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

            # ---- partition, smaller child's histogram, sibling by
            # subtraction ------------------------------------------------
            f, thr, dl = int(brow[B_FEAT]), int(brow[B_THR]), \
                bool(brow[B_DL] > 0.5)
            if full:
                # the record's counts pick the smaller child (:1242)
                left_smaller = bool(brow[B_LC] <= brow[B_RC])
                hist_small = partition_full(bins, gh_hist, st, l, new_leaf,
                                            f, thr, dl, left_smaller)
            else:
                left_smaller, hist_small = partition_compact(
                    bins, gh_hist, st, l, new_leaf, f, thr, dl)
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
                conv(hist[pair]), child[:, S_SG], child[:, S_SH],
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
        if full:
            return tree, st.leaf_id
        # each row's leaf, from the final segments
        starts = torch.tensor(st.seg_start[:num_leaves], device=dev)
        counts = torch.tensor(st.seg_rows[:num_leaves], device=dev)
        by_pos = torch.argsort(starts)
        pos2leaf = torch.repeat_interleave(by_pos, counts[by_pos])
        leaf_id = torch.empty(R, dtype=torch.int64, device=dev)
        leaf_id[st.order] = pos2leaf
        return tree, leaf_id

    def grow(bins: torch.Tensor, gh: torch.Tensor, uniforms=None
             ) -> Tuple[TreeArrays, torch.Tensor]:
        gh_hist, conv = hist_inputs(cfg, gh, uniforms)
        state = root_state(bins, gh, gh_hist, conv)
        return resume(bins, gh_hist, conv, state, 0)

    grow.resume = resume
    return grow
