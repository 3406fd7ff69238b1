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

Categorical features (ref: dense_bin.hpp SplitCategoricalInner): a
split's record carries its category set, the chosen BINS (``best_cat``
[L, MAXK] on the device, -1 padded, read with the split's row); a row
goes left when its bin is in the set, bin 0 (NaN and unseen categories)
never is. The tree keeps each node's set (``TreeArrays.cat_bins``).

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
                         max_cat_width, pack_record_rows)
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
    # the histogram pool of compact scheduling (ref: histogram_pool_size,
    # the LRU HistogramPool of feature_histogram.hpp:1368): "full" keeps
    # every leaf's histogram; "bounded" keeps pool_slots (>= 2) in LRU
    # order, subtracting from a cached parent and histogramming both
    # children from their rows on a miss; "none" keeps none and
    # histograms both children of every split from their rows
    hist_pool: str = "full"
    pool_slots: int = 0


# per-leaf stats columns (f32 [L, NS]), as in the JAX grower
S_SG, S_SH, S_CNT, S_VAL, S_LMIN, S_LMAX, S_DEPTH, S_PARENT, S_ISR, \
    S_NROW = range(10)
NS = 10
# packed SplitRecord columns (f32 [L, NB]; ops/split.pack_record_rows)
B_GAIN, B_FEAT, B_THR, B_DL, B_LG, B_LH, B_LC, B_LO, B_RG, B_RH, B_RC, \
    B_RO, B_NCAT = range(13)
NB = 13
# tree internal-node columns (f32 [L-1, NN], host side)
N_FEAT, N_THR, N_DL, N_GAIN, N_IVAL, N_IWT, N_ICNT, N_LC, N_RC, \
    N_CCNT = range(10)
NN = 10


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
    (compact), and ``num_leaves``. With categorical features, each
    leaf's best split's category set ``best_cat`` [L, MAXK] (int64,
    device) and each node's ``tree_cat`` [L-1, MAXK] (int32, host), -1
    padded."""
    hist: torch.Tensor
    stats: torch.Tensor
    best: torch.Tensor
    order: Optional[torch.Tensor]
    node: np.ndarray
    seg_start: List[int]
    seg_rows: List[int]
    num_leaves: int
    leaf_id: Optional[torch.Tensor] = None
    best_cat: Optional[torch.Tensor] = None
    tree_cat: Optional[np.ndarray] = None
    # the bounded pool's LRU bookkeeping (host): each leaf's slot (-1:
    # not cached), each slot's last-touch step (-1: free) and owner
    slot_map: Optional[List[int]] = None
    slot_stamp: Optional[List[int]] = None
    slot_owner: Optional[List[int]] = None


def cat_table(cat_bins: torch.Tensor, num_bin: int) -> torch.Tensor:
    """bool ``[..., num_bin]`` membership table of -1 padded category sets
    ``[..., MAXK]`` (one set, or one a node): ``table[..., b]`` is whether
    bin b is in the set."""
    table = torch.zeros((*cat_bins.shape[:-1], num_bin + 1), dtype=torch.bool,
                        device=cat_bins.device)
    idx = torch.where(cat_bins >= 0, cat_bins, num_bin)
    table.scatter_(-1, idx, True)
    return table[..., :num_bin]


def _go_left(col: torch.Tensor, thr: int, default_left: bool, num_bin: int,
             missing_type: int, default_bin: int,
             cat_set: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Partition direction of a bin column (ref: dense_bin.hpp:317
    SplitInner): ``bin <= threshold`` goes left, except the NaN bin
    (missing type nan) and the default bin (missing type zero), which
    follow ``default_left``. A categorical split (``cat_set``, its -1
    padded bins) sends left the rows whose bin is in the set (ref:
    SplitCategoricalInner). u16 bins (int16) are read as unsigned
    first."""
    if col.dtype != torch.int64:
        col = bin_ids(col)
    if cat_set is not None:
        return cat_table(cat_set, num_bin)[col.long()]
    go_left = col <= thr
    if missing_type == MISSING_ENUM["nan"]:
        go_left = torch.where(col == num_bin - 1, default_left, go_left)
    elif missing_type == MISSING_ENUM["zero"]:
        go_left = torch.where(col == default_bin, default_left, go_left)
    return go_left


def node_mask(feature_mask: Optional[torch.Tensor], rows: List[int]
              ) -> Optional[torch.Tensor]:
    """Column sampling's mask for the nodes of mask rows ``rows``: a
    tree's ``[F]`` mask serves every node; ``feature_fraction_bynode``'s
    ``[2L, F]`` gives each its own row (root 0, the children of split i
    2i+1 and 2i+2; ref: the JAX package's core/grower.py:825-834)."""
    if feature_mask is None or feature_mask.dim() == 1:
        return feature_mask
    last = feature_mask.shape[0] - 1
    return feature_mask[[min(r, last) for r in rows]]


def make_tree_grower(cfg: GrowerConfig, meta: FeatureMeta,
                     hist_fn: Optional[Callable] = None, layout=None):
    """Build ``grow(bins, gh, uniforms=None, feature_mask=None) ->
    (TreeArrays, leaf_id)``.

    ``bins`` is ``[R, F]`` row-major under compact scheduling and
    ``[F, R]`` feature-major under full scheduling, uint8 or u16 held as
    int16 (``ops/histogram.bin_ids``); with ``layout``
    (``core/layout.py``) it holds EFB group columns (``[R, G]`` /
    ``[G, R]``) or multi-value ``SparseBins``, and the layout expands
    each histogram to the logical features before the scan and reads a
    split feature's logical bins. ``gh`` f32 ``[R, 3]``
    = (grad, hess, 1), or under row sampling (grad·w, hess·w, bag): every
    physical row stays in the partition, so the compact grower picks the
    smaller child by raw rows and the full grower by the record's
    (bagged) counts, as the JAX package does; both on the training
    device. ``uniforms`` are the stochastic-rounding draws ``(ug, uh)``
    of a quantized tree. ``feature_mask`` is column sampling's bool mask
    on the device, ``[F]`` or ``[2L, F]`` (``node_mask``).
    ``hist_fn(bins, gh, num_bin)`` builds one histogram (by default kernel
    K1 for compact and B2 for full scheduling: the card's kernel for CUDA
    tensors, its plain version for CPU tensors); under full scheduling it
    also takes ``leaf_id=`` and ``leaf=`` keywords and adds only that
    leaf's rows (``ops/hist_cuda.hist_cuda_fm``'s contract). ``leaf_id``
    (int64 ``[R]``, on the device) is each row's leaf.

    Compact scheduling keeps the histogram pool ``cfg.hist_pool`` says
    (the JAX package's core/grower.py:1115-1135, 1272-1300); the slot
    choice of the bounded pool is the JAX package's, so the same children
    are histogrammed from their rows. ``grow.pool_counts`` counts the
    splits that subtracted from a cached parent (``hits``) and those
    that histogrammed both children from their rows (``misses``).

    ``grow.resume(bins, gh_hist, conv, state, k0, feature_mask=None)``
    runs the split loop from step ``k0`` over a committed ``GrowState``
    (full pool only).
    """
    from .layout import DenseLayout
    hp = cfg.hparams
    L = cfg.num_leaves
    B = cfg.num_bin
    full = cfg.row_sched == "full"
    if layout is None:
        layout = DenseLayout(full)
    pool = cfg.hist_pool
    if pool not in ("full", "bounded", "none"):
        raise ValueError(f"hist_pool={pool!r}: 'full', 'bounded' or 'none'")
    if pool != "full" and full:
        raise ValueError(f"hist_pool={pool!r} requires row_sched='compact'")
    P = max(int(cfg.pool_slots), 2) if pool == "bounded" else L
    has_cat = meta.has_cat
    MAXK = max_cat_width(hp, B) if has_cat else 0
    if hist_fn is None:
        hist_fn = hist_cuda_fm if full else hist_cuda_rm
    nbin_h = meta.num_bin.tolist()
    miss_h = meta.missing_type.tolist()
    dflt_h = meta.default_bin.tolist()
    counts = {"hits": 0, "misses": 0}

    def scan_hists(conv, raw, totals):
        """Raw histograms -> the logical f32 histograms the scan reads."""
        return layout.fix(conv(raw), totals)

    def root_state(bins, gh, gh_hist, conv, feature_mask) -> GrowState:
        """ref: LeafSplits::Init + the first FindBestSplits."""
        dev = gh.device
        R = gh.shape[0]
        f32 = dict(dtype=torch.float32, device=dev)
        sums = root_sums(cfg, gh, gh_hist, conv)
        root_g, root_h, root_c = sums[0], sums[1], sums[2]
        root_out = calculate_splitted_leaf_output(
            root_g, root_h + 2 * K_EPSILON, hp, root_c,
            torch.zeros((), **f32))
        hist_root = hist_fn(bins, gh_hist, B)
        best_root = best_split_for_leaf(
            scan_hists(conv, hist_root, sums), root_g, root_h, root_c,
            root_out, meta, hp, node_mask(feature_mask, [0]))

        hist = None
        if pool != "none":
            hist = torch.zeros((P, *hist_root.shape),
                               dtype=hist_root.dtype, device=dev)
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
        best_cat = tree_cat = None
        if has_cat:
            best_cat = torch.full((L, MAXK), -1, dtype=torch.int64,
                                  device=dev)
            best_cat[0] = best_root.cat_bins
            tree_cat = np.full((max(L - 1, 0), MAXK), -1, np.int32)
        seg_rows = [0] * L
        seg_rows[0] = R
        st = GrowState(
            hist=hist, stats=stats, best=best,
            order=None if full else torch.arange(R, device=dev),
            node=np.zeros((max(L - 1, 0), NN), np.float32),
            seg_start=[0] * L, seg_rows=seg_rows, num_leaves=1,
            leaf_id=(torch.zeros(R, dtype=torch.int64, device=dev)
                     if full else None),
            best_cat=best_cat, tree_cat=tree_cat)
        if pool == "bounded":
            st.slot_map = [0] + [-1] * (L - 1)
            st.slot_stamp = [0] + [-1] * (P - 1)
            st.slot_owner = [0] + [-1] * (P - 1)
        return st

    def partition_compact(bins_rm, st, l, new_leaf, f, thr, dl, cat_set):
        """Stable partition of leaf ``l``'s segment: its left rows stay
        in ``l``, its right rows go to ``new_leaf``. Returns the left and
        right row counts."""
        order, seg_start, seg_rows = st.order, st.seg_start, st.seg_rows
        start, rows = seg_start[l], seg_rows[l]
        seg = order[start:start + rows]
        go_left = _go_left(layout.column(bins_rm, seg, f), thr, dl,
                           nbin_h[f], miss_h[f], dflt_h[f], cat_set)
        n_left = int(go_left.sum())
        order[start:start + rows] = torch.cat([seg[go_left],
                                               seg[~go_left]])
        n_right = rows - n_left
        seg_start[l], seg_rows[l] = start, n_left
        seg_start[new_leaf], seg_rows[new_leaf] = start + n_left, n_right
        return n_left, n_right

    def segment_hist(bins_rm, gh_hist, st, leaf):
        """The histogram of a leaf's segment, from its gathered rows."""
        start, rows = st.seg_start[leaf], st.seg_rows[leaf]
        idx = st.order[start:start + rows]
        return hist_fn(bins_rm.index_select(0, idx),
                       gh_hist.index_select(0, idx), B)

    def children_compact(bins_rm, gh_hist, st, l, new_leaf, i):
        """The raw histograms of leaf ``l``'s two children after its
        partition, under the pool policy, and the pool's update."""
        left_smaller = st.seg_rows[l] <= st.seg_rows[new_leaf]
        sp = -1
        if pool == "full":
            sp = l
        elif pool == "bounded":
            sp = st.slot_map[l]
        if sp >= 0:
            counts["hits"] += 1
            small = segment_hist(bins_rm, gh_hist, st,
                                 l if left_smaller else new_leaf)
            large = st.hist[sp] - small
            hl, hr = (small, large) if left_smaller else (large, small)
        else:
            counts["misses"] += 1
            hl = segment_hist(bins_rm, gh_hist, st, l)
            hr = segment_hist(bins_rm, gh_hist, st, new_leaf)
        if pool == "full":
            st.hist[l], st.hist[new_leaf] = hl, hr
        elif pool == "bounded":
            # LRU (ref: the JAX package's core/grower.py:1272-1300): the
            # left child keeps the parent's slot on a hit, else takes the
            # least recent one; the right child takes the next least
            # recent; evicted owners are unmapped
            stamps, owner, smap = st.slot_stamp, st.slot_owner, st.slot_map
            sl = sp if sp >= 0 else int(np.argmin(stamps))
            stamps[sl] = i
            sr = int(np.argmin(stamps))
            own_l, own_r = owner[sl], owner[sr]
            if own_l >= 0 and own_l != l:
                smap[own_l] = -1
            if own_r >= 0 and own_r != l:
                smap[own_r] = -1
            smap[l], smap[new_leaf] = sl, sr
            stamps[sr] = i
            owner[sl], owner[sr] = l, new_leaf
            st.hist[sl], st.hist[sr] = hl, hr
        return torch.stack([hl, hr])

    def partition_full(bins_fm, gh_hist, st, l, new_leaf, f, thr, dl,
                       cat_set, left_smaller):
        """Leaf ``l``'s right-going rows move to ``new_leaf`` (ref:
        core/grower.py:1045-1060); the smaller child's histogram is one
        pass over all rows that adds the child's (``leaf_hist``,
        :601-603, the mask fused into the kernel). Returns hist_small."""
        go_left = _go_left(layout.column(bins_fm, None, f), thr, dl,
                           nbin_h[f], miss_h[f], dflt_h[f], cat_set)
        st.leaf_id = torch.where((st.leaf_id == l) & ~go_left, new_leaf,
                                 st.leaf_id)
        return hist_fn(bins_fm, gh_hist, B, leaf_id=st.leaf_id,
                       leaf=l if left_smaller else new_leaf)

    def resume(bins, gh_hist: torch.Tensor, conv: Callable,
               st: GrowState, k0: int,
               feature_mask: Optional[torch.Tensor] = None
               ) -> Tuple[TreeArrays, torch.Tensor]:
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
            # its best split and its stats (and its category set)
            parts = [lt.to(torch.float32)[None], cand[lt][None], best[lt],
                     stats[lt]]
            if has_cat:
                parts.append(st.best_cat[lt].to(torch.float32))
            head = torch.cat(parts).cpu().numpy()
            l, gain = int(head[0]), head[1]
            if not gain > 0.0:
                break
            brow = head[2:2 + NB]
            srow = head[2 + NB:2 + NB + NS]
            new_leaf = i + 1

            # ---- record the split (ref: tree.cpp Tree::Split) ------------
            node[i] = [brow[B_FEAT], brow[B_THR], brow[B_DL], brow[B_GAIN],
                       srow[S_VAL], srow[S_SH], srow[S_CNT], -(l + 1.0),
                       -(new_leaf + 1.0), brow[B_NCAT]]
            cat_set = None
            if has_cat:
                st.tree_cat[i] = head[2 + NB + NS:]
                if brow[B_NCAT] > 0:
                    cat_set = st.best_cat[l]
            p = int(srow[S_PARENT])
            if p >= 0:
                node[p, N_RC if srow[S_ISR] > 0.5 else N_LC] = i

            # ---- partition, the children's histograms ---------------------
            f, thr, dl = int(brow[B_FEAT]), int(brow[B_THR]), \
                bool(brow[B_DL] > 0.5)
            if full:
                # the record's counts pick the smaller child (:1242); the
                # sibling by subtraction
                left_smaller = bool(brow[B_LC] <= brow[B_RC])
                hist_small = partition_full(bins, gh_hist, st, l, new_leaf,
                                            f, thr, dl, cat_set, left_smaller)
                counts["hits"] += 1
                hist_large = hist[l] - hist_small
                if left_smaller:
                    hist[l], hist[new_leaf] = hist_small, hist_large
                else:
                    hist[l], hist[new_leaf] = hist_large, hist_small
                raw2 = hist[[l, new_leaf]]
            else:
                partition_compact(bins, st, l, new_leaf, f, thr, dl, cat_set)
                raw2 = children_compact(bins, gh_hist, st, l, new_leaf, i)

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
                scan_hists(conv, raw2, child[:, S_SG:S_CNT + 1]),
                child[:, S_SG], child[:, S_SH], child[:, S_CNT],
                child[:, S_VAL], meta, hp,
                node_mask(feature_mask, [2 * i + 1, 2 * i + 2]))
            best[pair] = pack_record_rows(rec2)
            if has_cat:
                st.best_cat[pair] = rec2.cat_bins
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
            shrinkage=1.0,
            cat_count=i32(N_CCNT) if has_cat else None,
            cat_bins=st.tree_cat)
        if full:
            return tree, st.leaf_id
        # each row's leaf, from the final segments
        starts = torch.tensor(st.seg_start[:num_leaves], device=dev)
        counts_t = torch.tensor(st.seg_rows[:num_leaves], device=dev)
        by_pos = torch.argsort(starts)
        pos2leaf = torch.repeat_interleave(by_pos, counts_t[by_pos])
        leaf_id = torch.empty(R, dtype=torch.int64, device=dev)
        leaf_id[st.order] = pos2leaf
        return tree, leaf_id

    def grow(bins, gh: torch.Tensor, uniforms=None,
             feature_mask: Optional[torch.Tensor] = None
             ) -> Tuple[TreeArrays, torch.Tensor]:
        gh_hist, conv = hist_inputs(cfg, gh, uniforms)
        state = root_state(bins, gh, gh_hist, conv, feature_mask)
        return resume(bins, gh_hist, conv, state, 0, feature_mask)

    grow.resume = resume
    grow.pool_counts = counts
    return grow
