"""Row-sharded (data-parallel) tree growing over a ``torch.distributed``
world.

Port of ``lightgbm_tpu/parallel/data_parallel.py`` (ref:
src/treelearner/data_parallel_tree_learner.cpp; SURVEY.md §3.3: local
histograms -> ReduceScatter -> best split of the owned features ->
SyncUpGlobalBestSplit -> every machine applies the same split). Every
rank runs the eager grower of ``core/grower.py`` over its contiguous
block of rows:

- each freshly built histogram (the root's, the smaller child's) is
  all-reduced, so the pool holds global sums and sibling subtraction
  needs no communication (``hist_reduce="allreduce"``), or
  reduce-scattered over feature windows, so each rank keeps the global
  sums of ``feature_tile(F, W)`` features, scans only those and the
  winners merge by :func:`make_global_best_combine`
  (``hist_reduce="reduce_scatter"``: half the bytes on the wire, the
  scan divided by W);
- the root sums are all-reduced from each rank's own sums (in XLA's CPU
  order on the CPU, so they equal the JAX package's psum of per-shard
  sums) and the quantization scales all-reduced by max;
- the split scan runs on global histograms, so every rank finds the
  same split; each partitions its own rows.

:class:`RowShards` is the engine's side of the layout: one region of
rows a rank, its rows then pad rows (the pad rows carry gh = 0, exactly
zero in the count channel), and the leaf ids all-gathered after each
tree. Without sharded ingestion the region is ``ceil(N / W)`` and rank r
holds the global rows ``[r region, (r + 1) region)``; under it rank r
holds the rows it loaded and the region is the largest shard.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.grower import (B_FEAT, B_GAIN, GrowerConfig, GrowerHooks,
                           make_tree_grower)
from ..ops.split import FeatureMeta
from ..utils import log, prng
from .mesh import (Comm, feature_tile, gather_meta, pad_rows_np,
                   padded_rows, window_ids)


def make_global_best_combine(comm: Comm):
    """``select_best`` of the feature-windowed scans (≡
    SyncUpGlobalBestSplit, parallel_tree_learner.h:210): each rank's
    packed winner rows [N, NB] (global feature ids) are all-gathered, and
    each leaf takes the row of max gain, ties to the smallest global
    feature id, by an indexed pick: the winner's row is copied, so a
    -0.0 leaf output survives the combine bit for bit (a masked sum
    would round it to +0.0). With no valid split anywhere every rank
    holds the same invalid record and rank 0's is taken."""
    W = comm.world

    def select_best(rows: torch.Tensor, cat):
        allr = comm.all_gather(rows, kind="best_combine")      # [W, N, NB]
        gain, feat = allr[..., B_GAIN], allr[..., B_FEAT]
        at_max = gain == gain.max(dim=0).values
        big = torch.tensor(float(2 ** 30), device=rows.device)
        win_f = torch.where(at_max, feat, big).min(dim=0).values
        mine = at_max & (feat == win_f)
        ranks = torch.arange(W, device=rows.device)[:, None].expand_as(mine)
        win = torch.where(mine, ranks, W).min(dim=0).values.clamp(max=W - 1)
        n = torch.arange(rows.shape[0], device=rows.device)
        if cat is not None:
            cat = comm.all_gather(cat, kind="best_combine")[win, n]
        return allr[win, n], cat
    return select_best


def make_feature_window(meta: FeatureMeta, comm: Comm):
    """``(reduce_hist, scan_window)`` of ``tpu_hist_reduce=reduce_scatter``
    over contiguous feature tiles (the JAX package's
    data_parallel.py:138-187): ``reduce_hist`` pads the features to a
    multiple of the world and reduce-scatters them, each rank keeping
    the global sums of its window ``[r Ft, (r + 1) Ft)``;
    ``scan_window`` hands the scan that window with its meta (pad slots
    one-bin, never splittable), its global ids and the per-feature
    vectors cut to it."""
    F = int(meta.num_bin.shape[0])
    W = comm.world
    Ft = feature_tile(F, W)
    pad = Ft * W - F
    start = comm.rank * Ft
    ids = window_ids(start, Ft, F, meta.num_bin.device)
    meta_w = gather_meta(meta, ids)
    in_table = ids >= 0

    def reduce_hist(h: torch.Tensor) -> torch.Tensor:
        x = h if h.dim() == 4 else h[None]
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        y = comm.reduce_scatter(x.movedim(1, 0).contiguous(),
                                kind="hist_reduce_scatter").movedim(0, 1)
        return y if h.dim() == 4 else y[0]

    def cut(a, fill):
        if a is None:
            return None
        if pad:
            a = torch.nn.functional.pad(a.to(torch.float32), (0, pad),
                                        value=float(fill)).to(a.dtype)
        return a[..., start:start + Ft]

    def scan_window(hh, ctx, fm, gp, rand_u):
        fm_w = in_table if fm is None else in_table & cut(fm, False)
        fids = ids.expand(hh.shape[0], Ft)
        return hh, meta_w, fids, fm_w, cut(gp, 0.0), cut(rand_u, 0.0)
    return reduce_hist, scan_window


def make_data_parallel_grower(cfg: GrowerConfig, meta: FeatureMeta,
                              comm: Comm, hist_fn: Optional[Callable] = None,
                              layout=None, forced=None,
                              hist_reduce: str = "allreduce"):
    """The compact or full grower as one rank of the data-parallel
    learner: ``grow(bins, gh, uniforms, feature_mask, cegb, et_key)``
    over this rank's rows (the serial grower's contract); the tree is the
    same on every rank, the leaf ids are this rank's rows'. ``hist_reduce``
    is ``allreduce`` or ``reduce_scatter`` (dense numerical only: the
    engine resolves other configurations to allreduce); the
    stochastic-rounding ``uniforms`` must be this rank's own draws."""
    if hist_reduce not in ("allreduce", "reduce_scatter"):
        raise ValueError(f"hist_reduce={hist_reduce!r}; expected "
                         "'allreduce' or 'reduce_scatter' (resolve 'auto' "
                         "upstream)")
    scan_window = select_best = None
    if hist_reduce == "reduce_scatter":
        reduce_hist, scan_window = make_feature_window(meta, comm)
        select_best = make_global_best_combine(comm)
    else:
        def reduce_hist(h):
            return comm.all_reduce_sum(h, kind="hist_allreduce")
    hooks = GrowerHooks(
        reduce_hist=reduce_hist,
        reduce_sums=lambda s: comm.all_reduce_sum(s, kind="root_sums"),
        reduce_max=lambda x: comm.all_reduce_max(x, kind="quant_scale"),
        scan_window=scan_window, select_best=select_best)
    return make_tree_grower(cfg, meta, hist_fn=hist_fn, layout=layout,
                            forced=forced, hooks=hooks)


class RowShards:
    """The row layout of the row-sharded learners (data, voting): rank r
    holds one ``region`` of ``rows`` rows, its ``count_r`` rows of the
    global order ``[lo, hi)`` first, then pad rows (the JAX package's
    parallel/mesh.py:46-74 and models/gbdt.py:1451-1521, 1563-1600).
    Rank r's rows are the global rows from the sum of the earlier ranks'
    counts on. ``row_counts`` gives each rank's count under sharded
    ingestion, where the region is the largest count; without it the
    ``num_data`` rows are cut ``ceil(num_data / W)`` a rank, the last
    taking the rest, which is the same layout with those counts.

    The leaf ids come back to the global order through the inverse of
    the row map (each padded slot's global row, -1 for a pad)."""

    def __init__(self, num_data: int, comm: Comm,
                 row_counts: Optional[np.ndarray] = None):
        self.comm = comm
        self.num_data = int(num_data)
        W = comm.world
        if row_counts is None:
            rows = padded_rows(self.num_data, W) // W
            counts = np.clip(self.num_data - rows * np.arange(W), 0, rows)
        else:
            counts = np.asarray(row_counts, np.int64)
            if int(counts.sum()) != self.num_data or len(counts) != W:
                raise ValueError(f"row counts {counts.tolist()} do not "
                                 f"cover {self.num_data} rows over {W} "
                                 "ranks")
            rows = int(counts.max())
        self.rows = int(rows)
        self.row_counts = counts
        offsets = np.concatenate([[0], np.cumsum(counts)])
        self.lo = int(offsets[comm.rank])
        self.hi = self.lo + int(counts[comm.rank])
        self.pad = self.rows - (self.hi - self.lo)
        # the leaf ids' gather: the slots of the real rows in global
        # order, or None when they are the padded order's first num_data
        # (every region full but the last)
        self._inv = None
        if np.any(counts[:-1] != self.rows):
            row_map = np.full(W * self.rows, -1, np.int64)
            for p in range(W):
                c = int(counts[p])
                row_map[p * self.rows:p * self.rows + c] = \
                    offsets[p] + np.arange(c)
            self._inv = torch.from_numpy(np.flatnonzero(row_map >= 0))

    def pad_local(self, a: np.ndarray, fill=0) -> np.ndarray:
        """This rank's rows ``[count_r, ...]`` padded to the region."""
        return pad_rows_np(a, self.rows, 0, fill)

    def host_rows(self, a: np.ndarray, fill=0) -> np.ndarray:
        """This rank's rows of a global host array ``[N, ...]``, padded."""
        return self.pad_local(a[self.lo:self.hi], fill)

    def local_gh(self, gh: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the global ``[N, 3]`` gh (its block of
        ``row_map``), the pad rows exact zeros (the count channel
        too)."""
        g = gh[self.lo:self.hi]
        if self.pad:
            g = torch.cat([g, g.new_zeros((self.pad, g.shape[1]))])
        return g

    def uniforms(self, key, device):
        """Stochastic rounding's draws of this rank's region: the JAX
        package's ``split(fold_in(tree_key, axis_index))`` over the
        shard's ``rows`` slots (core/grower.py:253-257)."""
        return tuple(prng.uniform(k, self.rows, device)
                     for k in prng.split(prng.fold_in(key, self.comm.rank)))

    def gather_leaf(self, leaf_id: torch.Tensor) -> torch.Tensor:
        """Every row's leaf ``[N]`` in the global order: the ranks'
        regions all-gathered once a tree, the pad slots dropped."""
        flat = self.comm.all_gather(leaf_id, kind="leaf_id").reshape(-1)
        if self._inv is None:
            return flat[:self.num_data]
        if self._inv.device != flat.device:
            self._inv = self._inv.to(flat.device)
        return flat[self._inv]


class RowShardedLearner:
    """The engine's data- or voting-parallel learner: ``grow(gh, key_u,
    feature_mask, cegb=None, et_key=None) -> (tree, leaf_id [N])`` from the
    global ``[N, 3]`` gh and the tree's stochastic-rounding key (or
    None)."""

    def __init__(self, grow, bins, shards: RowShards):
        self._grow = grow
        self.bins = bins
        self.shards = shards

    def grow(self, gh, key_u, feature_mask, **extras):
        sh = self.shards
        uniforms = (None if key_u is None
                    else sh.uniforms(key_u, gh.device))
        tree, leaf = self._grow(self.bins, sh.local_gh(gh), uniforms,
                                feature_mask, **extras)
        return tree, sh.gather_leaf(leaf)


def make_distributed_train_step(cfg: GrowerConfig, meta: FeatureMeta,
                                comm: Comm, grad_fn: Callable,
                                learning_rate: float,
                                tree_learner: str = "data",
                                top_k: int = 20,
                                hist_reduce: str = "allreduce"):
    """One boosting iteration of a rank over its rows (≡ GBDT::
    TrainOneIter on every machine, gbdt.cpp:353): ``grad_fn(score,
    label) -> (grad, hess)`` elementwise; ``step(bins, label, score,
    row_mask) -> (new_score, tree, leaf_id)`` on this rank's rows, where
    ``row_mask`` (f32 0/1) zeroes the pad rows (the JAX package's
    data_parallel.py:298-348). ``tree_learner="serial"`` runs the
    data-parallel grower and says so."""
    if tree_learner in ("data", "serial"):
        if tree_learner == "serial":
            # not silent: a remap nobody sees makes numbers unattributable
            log.info_once(
                "make_distributed_train_step: tree_learner='serial' over a "
                f"{comm.world}-rank world runs the row-sharded DATA-parallel "
                "grower (the serial program is not world-aware); pass "
                "tree_learner='data' to say so explicitly")
        grow = make_data_parallel_grower(cfg, meta, comm,
                                         hist_reduce=hist_reduce)
    elif tree_learner == "voting":
        from .voting_parallel import make_voting_parallel_grower
        grow = make_voting_parallel_grower(cfg, meta, comm, top_k=top_k,
                                           hist_reduce=hist_reduce)
    else:
        raise ValueError(
            f"tree_learner={tree_learner!r}; the row-sharded step supports "
            "'data' and 'voting' (feature-parallel shards features: use "
            "make_feature_parallel_grower)")

    def step(bins, label, score, row_mask):
        grad, hess = grad_fn(score, label)
        gh = torch.stack([grad * row_mask, hess * row_mask, row_mask], dim=1)
        tree, leaf_id = grow(bins, gh)
        lv = torch.as_tensor(tree.leaf_value, dtype=torch.float32,
                             device=score.device)
        rate = torch.tensor(learning_rate, dtype=torch.float32,
                            device=score.device)
        return score + lv[leaf_id] * rate, tree, leaf_id

    return step
