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

The distributed learners (``parallel/``) run this grower on every rank
with ``GrowerHooks``: the reductions of its histograms, root sums and
quantization scales, the windowed or voted scan and the cross-rank
winner, and the partition column of a feature another rank holds.

``grow.resume`` is the counterpart of the JAX grower's ``init=(state,
k0)`` seam: it continues the split loop at step ``k0`` from a
``GrowState`` that another phase (the hybrid grower's level phase)
committed.

Constraints and tree variants (the JAX grower's core/grower.py:561-994,
:1339-1660), each decided on the host where the split's other state
already lives:

- monotone constraints: each leaf carries its output bounds (stats
  ``S_LMIN``/``S_LMAX``); the scan clamps to them, and a numerical split
  on a monotone feature bounds its children by the mid-point of their
  outputs (``mc_method="basic"``). ``"intermediate"`` bounds each child
  by its sibling's output and keeps every leaf's bin box ``[L, F]``: a
  leaf that exactly one monotone feature separates from a new child is
  tightened by the child's output and, when a bound moved, rescanned
  from the histogram pool; ``"advanced"`` also recomputes the
  children's bounds from the boxes instead of inheriting them. The
  boxes and the bounds are mirrored on the host (f32, as the JAX
  package keeps them): the one read a split makes carries every leaf's
  best gain besides the chosen row;
- interaction constraints: each leaf's path features ``[L, F]`` on the
  host; a node scans only the union of the groups that hold its path;
- CEGB: ``cegb = (const [F], per_count [F])``, subtracted per feature
  as ``const + per_count * count``;
- forced splits: ``forced = (active, slot, feature, threshold)`` numpy
  arrays; step i splits leaf ``slot[i]`` at the given bin while the
  forced prefix holds, and the first forced split whose net gain is not
  positive (or that breaks ``max_depth``) ends the prefix;
- extra_trees: ``et_key`` is the tree's threefry key
  ``fold_in(tree_key, 7919)``; the root draws one uniform a feature from
  ``fold_in(et_key, 2**20)``, the children of split i from
  ``fold_in(fold_in(et_key, i), 1)`` and ``(..., 2)`` (drawn on the host,
  ``utils/prng.py``, and uploaded).
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
                         forced_split_record, max_cat_width,
                         pack_record_rows)
from ..utils import prng
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
    # extremely randomized trees (ref: config extra_trees)
    extra_trees: bool = False
    # monotone constraint method: basic | intermediate | advanced (ref:
    # monotone_constraints.hpp BasicLeafConstraints:466,
    # IntermediateLeafConstraints:517)
    mc_method: str = "basic"
    # interaction groups over USED feature indices, or None
    interaction_groups: Optional[tuple] = None


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


def quantize_gradients(gh: torch.Tensor, quant_bins: int, ug, uh,
                       reduce_max: Optional[Callable] = None
                       ) -> Tuple[torch.Tensor, Callable]:
    """int8 gradient discretization (ref: GradientDiscretizer::
    DiscretizeGradients, gradient_discretizer.cpp:71-162; port of the JAX
    grower's ``quantize_gradients``): grad is scaled to
    ``[-quant_bins/2, quant_bins/2]`` and hess to ``[0, quant_bins]``
    and rounded ``trunc(x / scale ± u)``; the mask channel stays exact.

    ``ug`` and ``uh`` are the uniform [0, 1) draws of stochastic rounding
    (f32 tensors [R]), or 0.5 each for round-to-nearest. Returns
    ``(gh_int8 [R, 3], conv)``; ``conv`` maps raw int32 sums back to f32
    through the per-tree scales ``(g_scale, h_scale, 1)``. Under row
    sharding ``reduce_max`` makes the scales global (the max over every
    rank's rows), so the int32 histogram sums stay exact (the JAX
    package's core/grower.py:246-251)."""
    g, h, m = gh[:, 0], gh[:, 1], gh[:, 2]
    kq = max(quant_bins // 2, 1)
    if reduce_max is None:
        reduce_max = lambda x: x
    # the max of an empty shard is 0 (every gradient magnitude is >= 0)
    amax = lambda x: x.max() if x.numel() else torch.zeros(
        (), dtype=x.dtype, device=x.device)
    g_scale = torch.clamp(reduce_max(amax(g.abs())), min=1e-30) / kq
    h_scale = torch.clamp(reduce_max(amax(h)), min=1e-30) / quant_bins
    ug = torch.as_tensor(ug, dtype=torch.float32, device=gh.device)
    uh = torch.as_tensor(uh, dtype=torch.float32, device=gh.device)
    gq = torch.trunc(g / g_scale + torch.where(g >= 0, ug, -ug))
    hq = torch.trunc(h / h_scale + uh)
    gh_q = torch.stack([gq, hq, m], dim=1).to(torch.int8)
    scale3 = torch.stack([g_scale, h_scale, torch.ones_like(g_scale)])
    return gh_q, (lambda hh: hh.to(torch.float32) * scale3)


def hist_inputs(cfg: GrowerConfig, gh: torch.Tensor, uniforms=None,
                reduce_max: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, Callable]:
    """The histogram kernels' gh for one tree and the ``conv`` that turns
    their raw sums into the split scan's f32: int8 when quantized (with
    ``uniforms = (ug, uh)``, or 0.5 each without stochastic rounding),
    bf16 in the bf16 mode, else ``gh`` itself."""
    if cfg.quantized:
        ug, uh = (uniforms if cfg.stochastic_rounding else (0.5, 0.5))
        return quantize_gradients(gh, cfg.quant_bins, ug, uh, reduce_max)
    if cfg.hist_dtype in ("bfloat16", "bf16") and cfg.row_sched != "full":
        return gh.to(torch.bfloat16), (lambda hh: hh)
    return gh, (lambda hh: hh)


def local_sums(cfg: GrowerConfig, gh: torch.Tensor,
               gh_hist: torch.Tensor) -> torch.Tensor:
    """[3] (grad, hess, count) of this shard's rows, before any
    reduction: int32 sums of the int8 rows under quantization, else the
    f32 gh summed in XLA's CPU order on the CPU (``column_sum``)."""
    if cfg.quantized:
        return gh_hist.sum(dim=0, dtype=torch.int32)
    return column_sum(gh)


def root_sums(cfg: GrowerConfig, gh: torch.Tensor, gh_hist: torch.Tensor,
              conv: Callable) -> torch.Tensor:
    """f32 [3] (grad, hess, count) of all rows: from the int8 rows under
    quantization (exact int32, converted), else from the f32 gh."""
    s = local_sums(cfg, gh, gh_hist)
    return conv(s) if cfg.quantized else s


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
    # interaction constraints: each leaf's path features, bool [L, F]
    path: Optional[np.ndarray] = None
    # the forced prefix is still on track
    forced_ok: bool = True
    # refined monotone modes (host): each leaf's bin box [L, F]
    # (inclusive), its output, bounds and mask row, f32 as on the device
    leaf_flo: Optional[np.ndarray] = None
    leaf_fhi: Optional[np.ndarray] = None
    leaf_val: Optional[np.ndarray] = None
    leaf_min: Optional[np.ndarray] = None
    leaf_max: Optional[np.ndarray] = None
    leaf_nrow: Optional[np.ndarray] = None
    # the local-sums channel (voting): each leaf's local raw sums [L, 3]
    lsum: Optional[torch.Tensor] = None


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


@dataclasses.dataclass
class GrowerHooks:
    """The distributed learners' hooks (the JAX package's
    ``make_tree_grower`` contract, core/grower.py:320-390), each a plain
    call of the eager grower, made in one fixed order on every rank:

    - ``reduce_hist(h)``: applied to each freshly built raw histogram
      (the root's, the smaller child's; both children's without a pool),
      ``[G, B, 3]`` or ``[N, G, B, 3]``, before it enters the pool.
      Data-parallel all-reduces (the pool holds global sums) or
      reduce-scatters (each rank keeps a feature window); voting keeps
      it the identity (the pool stays local). With it set the smaller
      child is picked by the split record's global counts, the same on
      every rank, not by the local rows;
    - ``reduce_sums(s)``: the root's ``[3]`` local sums -> global;
    - ``reduce_max(x)``: a quantization scale's local max -> global;
    - ``prepare_split_hist(hh, ctx, fm) -> (hh', extra_mask)``: before
      the scan of N leaves' logical f32 histograms ``hh`` [N, F, B, 3]
      (voting's vote and selective all-reduce); ``ctx`` is a dict of
      [N] tensors: ``sg``, ``sh``, ``cnt``, ``out`` (global) and
      ``lsg``, ``lsh``, ``lcnt`` (the leaves' local sums, with
      ``local_pool``);
    - ``scan_window(hh, ctx, fm, gp, rand) -> (hh_w, meta_w, fids, fm_w,
      gp_w, rand_w)``: the scan of a feature window instead
      (reduce-scatter): ``fids`` [N, Fw] are the window's global feature
      ids, ``meta_w`` one FeatureMeta for every leaf or a list, one a
      leaf; the winners' ids are mapped through ``fids`` and merged by
      ``select_best``;
    - ``select_best(rows, cat) -> (rows, cat)``: the packed best rows
      [N, NB] (and category sets) merged across ranks (≡
      SyncUpGlobalBestSplit);
    - ``fetch_bin_column(bins, rows, f)``: feature f's logical bins over
      ``rows`` (compact) or every row (full, ``rows`` None), for the
      partition: feature-parallel's owner broadcast;
    - ``partition_meta``: the global FeatureMeta of the partition and the
      monotone bounds when ``meta`` is a rank's feature slice;
    - ``local_pool``: the pool holds local histograms, and each leaf's
      local sums ride beside them (voting's local-sums channel).
    """
    reduce_hist: Optional[Callable] = None
    reduce_sums: Optional[Callable] = None
    reduce_max: Optional[Callable] = None
    prepare_split_hist: Optional[Callable] = None
    scan_window: Optional[Callable] = None
    select_best: Optional[Callable] = None
    fetch_bin_column: Optional[Callable] = None
    partition_meta: Optional[FeatureMeta] = None
    local_pool: bool = False


def make_tree_grower(cfg: GrowerConfig, meta: FeatureMeta,
                     hist_fn: Optional[Callable] = None, layout=None,
                     forced: Optional[tuple] = None,
                     hooks: Optional[GrowerHooks] = None):
    """Build ``grow(bins, gh, uniforms=None, feature_mask=None, cegb=None,
    et_key=None) -> (TreeArrays, leaf_id)``.

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

    ``forced`` (a forced-split prefix), ``cegb``, ``et_key`` and the
    constraints of ``cfg`` and ``meta`` are described in the module
    docstring. Forced splits and the refined monotone modes need the
    full histogram pool.

    ``hooks`` (:class:`GrowerHooks`) make the grower one rank of a
    distributed learner (``parallel/``); ``grow`` then also takes the
    ``reduce_max`` of quantization from them.
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
    hk = hooks if hooks is not None else GrowerHooks()
    distributed = hk.reduce_hist is not None
    if pool == "bounded" and hooks is not None:
        # the LRU cap is a one-machine memory concern (ref: the JAX
        # package's core/grower.py:483-491)
        raise ValueError("hist_pool='bounded' supports the serial learner "
                         "only")
    if hk.scan_window is not None and hk.select_best is None:
        raise ValueError("scan_window needs a select_best combine (the "
                         "per-rank winners must be merged)")
    reduce_hist = hk.reduce_hist or (lambda h: h)
    local_pool = hk.local_pool
    # the global meta: partition rules, monotone bounds, category sets
    pmeta = hk.partition_meta if hk.partition_meta is not None else meta
    P = max(int(cfg.pool_slots), 2) if pool == "bounded" else L
    has_cat = pmeta.has_cat
    MAXK = max_cat_width(hp, B) if has_cat else 0
    if hist_fn is None:
        hist_fn = hist_cuda_fm if full else hist_cuda_rm
    nbin_h = pmeta.num_bin.tolist()
    miss_h = pmeta.missing_type.tolist()
    dflt_h = pmeta.default_bin.tolist()
    counts = {"hits": 0, "misses": 0}
    F = len(nbin_h)
    # the scan's features: a rank's slice under feature-parallel
    F_scan = int(meta.num_bin.shape[0])
    use_mc = pmeta.monotone is not None
    use_inter = use_mc and cfg.mc_method in ("intermediate", "advanced")
    use_adv = use_mc and cfg.mc_method == "advanced"
    mono_h = (np.asarray(pmeta.monotone.tolist(), np.int64) if use_mc
              else None)
    column = (hk.fetch_bin_column if hk.fetch_bin_column is not None
              else layout.column)
    if forced is not None and pool != "full":
        raise ValueError("forced splits need the full histogram pool; use "
                         "hist_pool='full'")
    if use_inter and pool != "full":
        raise ValueError("monotone_constraints_method=intermediate re-scans "
                         "affected leaves from the histogram pool; use "
                         "hist_pool='full'")
    if use_inter and cfg.extra_trees:
        raise ValueError("monotone_constraints_method=intermediate does not "
                         "compose with extra_trees")
    group_masks = None
    if cfg.interaction_groups is not None:
        group_masks = np.zeros((len(cfg.interaction_groups), F), bool)
        for gi, group in enumerate(cfg.interaction_groups):
            for fi in group:
                if 0 <= fi < F:
                    group_masks[gi, fi] = True

    def scan_hists(conv, raw, totals):
        """Raw histograms -> the logical f32 histograms the scan reads."""
        return layout.fix(conv(raw), totals)

    def allowed_of(paths: np.ndarray) -> np.ndarray:
        """bool [N, F]: the features of the interaction groups that hold
        each node's path features ``paths`` [N, F] (ref: col_sampler.hpp;
        the JAX package's core/grower.py:810-834)."""
        contains = np.all(group_masks[None] | ~paths[:, None, :], axis=2)
        return np.any(group_masks[None] & contains[:, :, None], axis=1)

    def masks(feature_mask, nrows: List[int], allowed):
        """The scan's mask of the nodes of mask rows ``nrows``: column
        sampling (``node_mask``) and ``allowed`` (interaction groups;
        bool [N, F] on the device, or None)."""
        fm = node_mask(feature_mask, nrows)
        if allowed is None:
            return fm
        return allowed if fm is None else fm & allowed

    def uniforms_of(keys) -> np.ndarray:
        """extra_trees: one uniform a scanned feature from each key, f32
        [N, F] on the host (a rank's slice draws its own width, as the
        JAX package's feature-parallel grower does)."""
        return np.stack([prng.uniform_host(k, F_scan) for k in keys])

    def upload(blocks, dev):
        """The host arrays a split hands the device, [N, *] each, in one
        copy (one host-to-device transfer, which waits for the queue);
        returns the device views in order."""
        widths = [b.shape[1] for b in blocks]
        buf = torch.from_numpy(np.ascontiguousarray(np.concatenate(
            blocks, axis=1))).to(dev)
        return torch.split(buf, widths, dim=1)

    def scan_leaves(raw, rows, fm, cegb, rand_u, conv, lsum=None):
        """Best splits of N leaves from their raw histograms ``raw`` (the
        pool's) and their stats rows ``rows`` [N, NS] (totals, output,
        bounds, depth): the packed rows [N, NB] and, with categorical
        features, the category sets [N, MAXK]. ``lsum`` [N, 3] are the
        leaves' local raw sums (``local_pool``): a local pool's
        histograms are fixed with them. The distributed hooks run here,
        in a fixed order: the prepare hook or the window, the scan, the
        combine."""
        cnt = rows[:, S_CNT]
        totals = rows[:, S_SG:S_CNT + 1]
        ltot = conv(lsum) if lsum is not None else totals
        hh = scan_hists(conv, raw, ltot)
        gp = None if cegb is None else cegb[0] + cegb[1] * cnt[:, None]
        lr = (rows[:, S_LMIN], rows[:, S_LMAX])
        ctx = None
        if hk.prepare_split_hist is not None or hk.scan_window is not None:
            ctx = dict(sg=rows[:, S_SG], sh=rows[:, S_SH], cnt=cnt,
                       out=rows[:, S_VAL], lsg=ltot[:, 0], lsh=ltot[:, 1],
                       lcnt=ltot[:, 2])
        if hk.scan_window is not None:
            hh_w, meta_w, fids, fm_w, gp_w, rand_w = hk.scan_window(
                hh, ctx, fm, gp, rand_u)
            metas = meta_w if isinstance(meta_w, list) else None
            if metas is None:
                rec = best_split_for_leaf(
                    hh_w, rows[:, S_SG], rows[:, S_SH], cnt, rows[:, S_VAL],
                    meta_w, hp, fm_w, leaf_range=lr,
                    leaf_depth=rows[:, S_DEPTH], gain_penalty=gp_w,
                    rand_u=rand_w)
                packed = pack_record_rows(rec)
            else:
                one = lambda a, n: None if a is None else a[n:n + 1]
                packed = torch.cat([pack_record_rows(best_split_for_leaf(
                    hh_w[n:n + 1], rows[n:n + 1, S_SG], rows[n:n + 1, S_SH],
                    cnt[n:n + 1], rows[n:n + 1, S_VAL], m, hp, one(fm_w, n),
                    leaf_range=(lr[0][n:n + 1], lr[1][n:n + 1]),
                    leaf_depth=rows[n:n + 1, S_DEPTH],
                    gain_penalty=one(gp_w, n), rand_u=one(rand_w, n)))
                    for n, m in enumerate(metas)])
            f_loc = packed[:, B_FEAT].long()
            fid = fids.gather(1, f_loc.clamp(min=0)[:, None])[:, 0]
            packed[:, B_FEAT] = torch.where(f_loc >= 0, fid,
                                            -1).to(torch.float32)
            return hk.select_best(packed, None)
        if hk.prepare_split_hist is not None:
            hh, extra = hk.prepare_split_hist(hh, ctx, fm)
            if extra is not None:
                fm = extra if fm is None else fm & extra
        rec = best_split_for_leaf(
            hh, rows[:, S_SG], rows[:, S_SH], cnt, rows[:, S_VAL], meta, hp,
            fm, leaf_range=lr, leaf_depth=rows[:, S_DEPTH], gain_penalty=gp,
            rand_u=rand_u)
        packed, cat = pack_record_rows(rec), rec.cat_bins
        if has_cat and cat is None:
            # a rank's feature slice without a categorical feature
            cat = torch.full((packed.shape[0], MAXK), -1, dtype=torch.int64,
                             device=packed.device)
        if hk.select_best is not None:
            packed, cat = hk.select_best(packed, cat)
        return packed, cat

    def child_bounds(st, l, srow, brow, num_leaves):
        """f32 (l_min, l_max, r_min, r_max) of the two children of leaf
        ``l`` (ref: monotone_constraints.hpp:488-504 and :546; the JAX
        package's core/grower.py:1339-1441): basic bounds by the outputs'
        mid-point, the refined modes by the sibling's output; advanced
        takes the base bounds from the boxes of the other leaves."""
        p_min, p_max = srow[S_LMIN], srow[S_LMAX]
        f = int(brow[B_FEAT])
        is_num = brow[B_NCAT] == 0
        mono_f = int(mono_h[f]) if f >= 0 and is_num else 0
        base = [p_min, p_max, p_min, p_max]
        if use_adv:
            ac_flo, ac_fhi = child_boxes(st, l, brow)
            exists = np.arange(L) < num_leaves
            exists[l] = False
            sel_ub, sel_lb = linked_bounds(st.leaf_flo, st.leaf_fhi, ac_flo,
                                           ac_fhi, exists)
            jout = st.leaf_val[:, None]
            geo_max = np.min(np.where(sel_ub, jout, np.float32(np.inf)), 0)
            geo_min = np.max(np.where(sel_lb, jout, np.float32(-np.inf)), 0)
            base = [geo_min[0], geo_max[0], geo_min[1], geo_max[1]]
        if use_inter:
            bl, br = brow[B_RO], brow[B_LO]
        else:
            bl = br = (brow[B_LO] + brow[B_RO]) * np.float32(0.5)
        l_min = np.maximum(base[0], bl) if mono_f < 0 else base[0]
        l_max = np.minimum(base[1], bl) if mono_f > 0 else base[1]
        r_min = np.maximum(base[2], br) if mono_f > 0 else base[2]
        r_max = np.minimum(base[3], br) if mono_f < 0 else base[3]
        return l_min, l_max, r_min, r_max

    def child_boxes(st, l, brow):
        """The bin boxes ([2, F] low, [2, F] high) of leaf ``l``'s
        children: a numerical split cuts the split feature at its
        threshold, a categorical one leaves both the parent's box."""
        flo_p, fhi_p = st.leaf_flo[l], st.leaf_fhi[l]
        left_fhi, right_flo = fhi_p.copy(), flo_p.copy()
        if brow[B_NCAT] == 0 and brow[B_FEAT] >= 0:
            f, thr = int(brow[B_FEAT]), int(brow[B_THR])
            left_fhi[f], right_flo[f] = thr, thr + 1
        return np.stack([flo_p, right_flo]), np.stack([left_fhi, fhi_p])

    def linked_bounds(flo, fhi, c_flo, c_fhi, exists):
        """``(hi_side, lo_side)``, bool [L, 2]: the existing leaves linked
        to each child (exactly one feature separates their boxes, and it
        is monotone: the leaves the reference's GoUp/GoDown walk reaches,
        monotone_constraints.hpp:625-700) on the side where their output
        must be at least the child's (they bound its max, it bounds their
        min), and on the side where it must be at most (ref: the JAX
        package's core/grower.py:1380-1423, :1573-1604)."""
        ov = ((flo[:, None, :] <= c_fhi[None]) &
              (fhi[:, None, :] >= c_flo[None]))                  # [L, 2, F]
        n_sep = (~ov).sum(2)
        sep = np.argmax(~ov, axis=2)                             # [L, 2]
        msep = mono_h[sep]
        linked = (n_sep == 1) & (msep != 0) & exists[:, None]
        j_lo = np.take_along_axis(flo, sep, axis=1)
        j_hi = np.take_along_axis(fhi, sep, axis=1)
        c_lo = c_flo[np.arange(2)[None, :], sep]
        c_hi = c_fhi[np.arange(2)[None, :], sep]
        below, above = j_hi < c_lo, j_lo > c_hi
        inc = msep > 0
        # j above an increasing child bounds the child's max (advanced's
        # reading) = the child bounds j's min (intermediate's reading)
        return (linked & np.where(inc, above, below),
                linked & np.where(inc, below, above))

    def root_state(bins, gh, gh_hist, conv, feature_mask, cegb=None,
                   et_key=None) -> GrowState:
        """ref: LeafSplits::Init + the first FindBestSplits."""
        dev = gh.device
        R = gh.shape[0]
        f32 = dict(dtype=torch.float32, device=dev)
        # each rank's sums, then their sum: the JAX package's psum of
        # per-shard sums
        lroot = local_sums(cfg, gh, gh_hist)
        sums = lroot if hk.reduce_sums is None else hk.reduce_sums(lroot)
        if cfg.quantized:
            sums = conv(sums)
        root_g, root_h, root_c = sums[0], sums[1], sums[2]
        root_out = calculate_splitted_leaf_output(
            root_g, root_h + 2 * K_EPSILON, hp, root_c,
            torch.zeros((), **f32))
        hist_root = reduce_hist(hist_fn(bins, gh_hist, B))
        root_row = torch.zeros((1, NS), **f32)
        root_row[0, S_SG:S_VAL + 1] = torch.stack([root_g, root_h, root_c,
                                                  root_out])
        root_row[0, S_LMIN], root_row[0, S_LMAX] = -np.inf, np.inf
        path0 = (np.zeros((L, F), bool) if group_masks is not None
                 else None)
        allowed0 = rand0 = None
        if path0 is not None:
            allowed0 = torch.as_tensor(allowed_of(path0[:1]), device=dev)
        if et_key is not None:
            rand0 = torch.as_tensor(uniforms_of(
                [prng.fold_in(et_key, 2 ** 20)]), device=dev)
        lsum = lroot[None] if local_pool else None
        best_root, cat_root = scan_leaves(
            hist_root[None], root_row, masks(feature_mask, [0], allowed0),
            cegb, rand0, conv, lsum)

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
        best[0] = best_root[0]
        best_cat = tree_cat = None
        if has_cat:
            best_cat = torch.full((L, MAXK), -1, dtype=torch.int64,
                                  device=dev)
            best_cat[0] = cat_root[0]
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
            best_cat=best_cat, tree_cat=tree_cat, path=path0)
        if local_pool:
            st.lsum = torch.zeros((L, 3), dtype=lroot.dtype, device=dev)
            st.lsum[0] = lroot
        if use_inter:
            st.leaf_flo = np.zeros((L, F), np.int64)
            st.leaf_fhi = np.tile(np.asarray(nbin_h, np.int64) - 1, (L, 1))
            st.leaf_val = np.zeros(L, np.float32)
            st.leaf_min = np.full(L, -np.inf, np.float32)
            st.leaf_max = np.full(L, np.inf, np.float32)
            st.leaf_nrow = np.zeros(L, np.int64)
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
        go_left = _go_left(column(bins_rm, seg, f), thr, dl,
                           nbin_h[f], miss_h[f], dflt_h[f], cat_set)
        n_left = int(go_left.sum())
        order[start:start + rows] = torch.cat([seg[go_left],
                                               seg[~go_left]])
        n_right = rows - n_left
        seg_start[l], seg_rows[l] = start, n_left
        seg_start[new_leaf], seg_rows[new_leaf] = start + n_left, n_right
        return n_left, n_right

    def segment_hist(bins_rm, gh_hist, st, leaf, sums=None):
        """The histogram of a leaf's segment, from its gathered rows (and,
        into ``sums[leaf]``, the segment's local raw sums)."""
        start, rows = st.seg_start[leaf], st.seg_rows[leaf]
        idx = st.order[start:start + rows]
        ghs = gh_hist.index_select(0, idx)
        if sums is not None:
            sums[leaf] = (ghs.sum(dim=0, dtype=torch.int32) if cfg.quantized
                          else column_sum(ghs.to(torch.float32)))
        return hist_fn(bins_rm.index_select(0, idx), ghs, B)

    def children_compact(bins_rm, gh_hist, st, l, new_leaf, i, brow):
        """The raw histograms of leaf ``l``'s two children after its
        partition, under the pool policy, and the pool's update (and the
        children's local sums under ``local_pool``). Under a distributed
        learner the smaller child is the one the split record counts
        smaller, which every rank agrees on (the JAX package's
        core/grower.py:1186-1200)."""
        left_smaller = (bool(brow[B_LC] <= brow[B_RC]) if distributed
                        else st.seg_rows[l] <= st.seg_rows[new_leaf])
        lsums = {} if local_pool else None
        sp = -1
        if pool == "full":
            sp = l
        elif pool == "bounded":
            sp = st.slot_map[l]
        if sp >= 0:
            counts["hits"] += 1
            s_leaf = l if left_smaller else new_leaf
            small = reduce_hist(segment_hist(bins_rm, gh_hist, st, s_leaf,
                                             lsums))
            large = st.hist[sp] - small
            hl, hr = (small, large) if left_smaller else (large, small)
            if local_pool:
                b_leaf = new_leaf if left_smaller else l
                lsums[b_leaf] = st.lsum[l] - lsums[s_leaf]
        else:
            counts["misses"] += 1
            hl, hr = reduce_hist(torch.stack([
                segment_hist(bins_rm, gh_hist, st, l, lsums),
                segment_hist(bins_rm, gh_hist, st, new_leaf, lsums)]))
        if local_pool:
            st.lsum[l], st.lsum[new_leaf] = lsums[l], lsums[new_leaf]
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
        go_left = _go_left(column(bins_fm, None, f), thr, dl,
                           nbin_h[f], miss_h[f], dflt_h[f], cat_set)
        st.leaf_id = torch.where((st.leaf_id == l) & ~go_left, new_leaf,
                                 st.leaf_id)
        small = hist_fn(bins_fm, gh_hist, B, leaf_id=st.leaf_id,
                        leaf=l if left_smaller else new_leaf)
        if local_pool:
            # full scheduling is dense: any feature's bins sum to the
            # child's local raw totals (the JAX package's
            # core/grower.py:1262-1265)
            s_sum = small[0].sum(dim=0)
            b_sum = st.lsum[l] - s_sum
            st.lsum[l], st.lsum[new_leaf] = ((s_sum, b_sum) if left_smaller
                                             else (b_sum, s_sum))
        return reduce_hist(small)

    def refine_bounds(st, conv, l, new_leaf, brow, gains_h, bounds,
                      feature_mask, cegb, i):
        """The refined monotone modes after leaf ``l``'s split (ref:
        IntermediateLeafConstraints::UpdateConstraintsWithOutputs,
        monotone_constraints.hpp:546-700; the JAX package's
        core/grower.py:1536-1660): the children's boxes, outputs and
        bounds enter the host mirror; every other leaf with a valid split
        (``gains_h``, read with the split's row) that a child is linked
        to is tightened by the child's output, and the leaves whose bound
        moved are rescanned from the pool with their new bounds."""
        dev = st.stats.device
        c_flo, c_fhi = child_boxes(st, l, brow)
        st.leaf_fhi[l] = c_fhi[0]
        st.leaf_flo[new_leaf], st.leaf_fhi[new_leaf] = c_flo[1], c_fhi[1]
        st.leaf_val[l], st.leaf_val[new_leaf] = brow[B_LO], brow[B_RO]
        (st.leaf_min[l], st.leaf_max[l], st.leaf_min[new_leaf],
         st.leaf_max[new_leaf]) = bounds
        st.leaf_nrow[l], st.leaf_nrow[new_leaf] = 2 * i + 1, 2 * i + 2
        updatable = np.zeros(L, bool)
        updatable[:len(gains_h)] = gains_h > K_MIN_SCORE
        updatable[[l, new_leaf]] = False
        hi_side, lo_side = linked_bounds(st.leaf_flo, st.leaf_fhi, c_flo,
                                         c_fhi, updatable)
        c_out = np.asarray([brow[B_LO], brow[B_RO]], np.float32)[None]
        cand_max = np.min(np.where(lo_side, c_out, np.float32(np.inf)), 1)
        cand_min = np.max(np.where(hi_side, c_out, np.float32(-np.inf)), 1)
        nmax = np.where(updatable, np.minimum(st.leaf_max, cand_max),
                        st.leaf_max)
        nmin = np.where(updatable, np.maximum(st.leaf_min, cand_min),
                        st.leaf_min)
        idx = np.flatnonzero((nmax < st.leaf_max) | (nmin > st.leaf_min))
        st.leaf_min, st.leaf_max = nmin, nmax
        if not len(idx):
            return
        # the leaves, their bounds (exact in f64) and their allowed
        # features in one upload
        blocks = [np.stack([idx, nmin[idx], nmax[idx]], 1)]
        if st.path is not None:
            blocks.append(allowed_of(st.path[idx]))
        parts = upload([b.astype(np.float64) for b in blocks], dev)
        idx_t = parts[0][:, 0].long()
        st.stats[idx_t, S_LMIN] = parts[0][:, 1].float()
        st.stats[idx_t, S_LMAX] = parts[0][:, 2].float()
        rows = st.stats[idx_t]
        packed, cat = scan_leaves(
            st.hist[idx_t], rows,
            masks(feature_mask, st.leaf_nrow[idx].tolist(),
                  parts[1] > 0.5 if st.path is not None else None), cegb,
            None, conv, st.lsum[idx_t] if local_pool else None)
        st.best[idx_t] = packed
        if has_cat:
            st.best_cat[idx_t] = cat

    def resume(bins, gh_hist: torch.Tensor, conv: Callable,
               st: GrowState, k0: int,
               feature_mask: Optional[torch.Tensor] = None,
               cegb: Optional[tuple] = None, et_key=None
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
            # its best split and its stats (and its category set; a forced
            # split's record and its leaf's stats; every leaf's best gain
            # under the refined monotone modes)
            parts = [lt.to(torch.float32)[None], cand[lt][None], best[lt],
                     stats[lt]]
            if has_cat:
                parts.append(st.best_cat[lt].to(torch.float32))
            want_forced = (forced is not None and st.forced_ok
                           and i < len(forced[0]) and bool(forced[0][i]))
            if want_forced:
                slot, ff, ft = (int(forced[1][i]), int(forced[2][i]),
                                int(forced[3][i]))
                srow_d = stats[slot]
                frec = forced_split_record(
                    scan_hists(conv, hist[slot], srow_d[S_SG:S_CNT + 1]),
                    ff, ft, srow_d[S_SG], srow_d[S_SH], srow_d[S_CNT],
                    srow_d[S_VAL], (nbin_h[ff], miss_h[ff], dflt_h[ff]), hp)
                parts += [pack_record_rows(frec), srow_d]
            if use_inter:
                parts.append(best[:num_leaves, B_GAIN])
            head = torch.cat(parts).cpu().numpy()
            l, gain = int(head[0]), head[1]
            brow = head[2:2 + NB]
            srow = head[2 + NB:2 + NB + NS]
            off = 2 + NB + NS
            bcat = None
            if has_cat:
                bcat = head[off:off + MAXK]
                off += MAXK
            if want_forced:
                # ForceSplits (ref: serial_tree_learner.cpp:560; the JAX
                # package's core/grower.py:956-994): a forced split whose
                # net gain is not positive, or past max_depth, ends the
                # forced prefix and this step takes the best leaf
                frow, fsrow = head[off:off + NB], head[off + NB:off + NB + NS]
                off += NB + NS
                st.forced_ok = bool(frow[B_GAIN] > 0.0 and (
                    cfg.max_depth <= 0 or fsrow[S_DEPTH] < cfg.max_depth))
                if st.forced_ok:
                    l, gain, brow, srow = slot, frow[B_GAIN], frow, fsrow
                    if has_cat:
                        bcat = np.full(MAXK, -1, np.float32)
            gains_h = head[off:off + num_leaves] if use_inter else None
            if not gain > 0.0:
                break
            new_leaf = i + 1

            # ---- record the split (ref: tree.cpp Tree::Split) ------------
            node[i] = [brow[B_FEAT], brow[B_THR], brow[B_DL], brow[B_GAIN],
                       srow[S_VAL], srow[S_SH], srow[S_CNT], -(l + 1.0),
                       -(new_leaf + 1.0), brow[B_NCAT]]
            cat_set = None
            if has_cat:
                st.tree_cat[i] = bcat
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
                raw2 = children_compact(bins, gh_hist, st, l, new_leaf, i,
                                        brow)

            # ---- children stats and best splits --------------------------
            depth = srow[S_DEPTH] + 1.0
            l_min, l_max, r_min, r_max = (
                child_bounds(st, l, srow, brow, num_leaves) if use_mc else
                (srow[S_LMIN], srow[S_LMAX], srow[S_LMIN], srow[S_LMAX]))
            child = np.asarray(
                [[brow[B_LG], brow[B_LH], brow[B_LC], brow[B_LO],
                  l_min, l_max, depth, i, 0.0, 2 * i + 1],
                 [brow[B_RG], brow[B_RH], brow[B_RC], brow[B_RO],
                  r_min, r_max, depth, i, 1.0, 2 * i + 2]],
                np.float32)
            pair = [l, new_leaf]
            # the children's stats, allowed features and extra_trees'
            # draws reach the device in one upload
            blocks = [child]
            if st.path is not None:
                if f >= 0:
                    st.path[l, f] = True
                st.path[new_leaf] = st.path[l]
                blocks.append(allowed_of(st.path[pair]).astype(np.float32))
            if et_key is not None:
                ki = prng.fold_in(et_key, i)
                blocks.append(uniforms_of([prng.fold_in(ki, 1),
                                           prng.fold_in(ki, 2)]))
            parts = list(upload(blocks, dev))
            child = parts.pop(0)
            allowed2 = parts.pop(0) > 0.5 if st.path is not None else None
            rand2 = parts.pop(0) if et_key is not None else None
            stats[pair] = child
            packed2, cat2 = scan_leaves(
                raw2, child,
                masks(feature_mask, [2 * i + 1, 2 * i + 2], allowed2),
                cegb, rand2, conv, st.lsum[pair] if local_pool else None)
            best[pair] = packed2
            if has_cat:
                st.best_cat[pair] = cat2
            num_leaves = new_leaf + 1
            if use_inter:
                refine_bounds(st, conv, l, new_leaf, brow, gains_h,
                              (l_min, l_max, r_min, r_max), feature_mask,
                              cegb, i)

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
             feature_mask: Optional[torch.Tensor] = None,
             cegb: Optional[tuple] = None, et_key=None
             ) -> Tuple[TreeArrays, torch.Tensor]:
        gh_hist, conv = hist_inputs(cfg, gh, uniforms, hk.reduce_max)
        state = root_state(bins, gh, gh_hist, conv, feature_mask, cegb,
                           et_key)
        return resume(bins, gh_hist, conv, state, 0, feature_mask, cegb,
                      et_key)

    grow.resume = resume
    grow.pool_counts = counts
    return grow
