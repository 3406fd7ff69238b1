"""Hybrid level+tail grower.

Port of ``lightgbm_tpu/core/hybrid_grower.py``: the pure level grower's
dense level histograms cap it at ``max_depth <= MAX_LEVEL_DEPTH``, which
excludes the default configuration (255 leaves, ``max_depth=-1``). The
hybrid serves it:

1. run the level phase to a handoff depth D0, scanning levels 0..D0, so
   every candidate's gain is known at depth <= D0;
2. replay the best-first order over those candidates and COMMIT its
   prefix up to the first split of a depth-D0 node, whose children were
   not scanned (until then, every leaf the compact grower could pick was
   scanned, so the prefix is exactly its first k0 splits);
3. seed the compact grower's state from the level output (per-leaf stats
   and best rows from the level scans, histogram-pool rows from the
   kept level histograms, ``order``/segments from a stable sort on leaf
   slots, and with categorical features each leaf's and each committed
   node's category set) and resume its split loop at step k0
   (``grow.resume``).

gh is turned into the histograms' input (int8 under quantization, bf16
in the bf16 mode) once per tree, and the same rows feed both phases, so
the pool the tail inherits is exactly what the tail would have built.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops.hist_cuda import hist_cuda_rm
from ..ops.hist_level_cuda import hist_level_cuda
from ..ops.split import K_MIN_SCORE, FeatureMeta
from .grower import (B_DL, B_FEAT, B_GAIN, B_NCAT, B_THR, NB, NN, NS,
                     S_LMAX, S_LMIN, S_PARENT, GrowerConfig, GrowState,
                     hist_inputs, make_tree_grower)
from .level_grower import (H_CAT, H_CN, H_OUT, H_SG, H_SH, MAX_LEVEL_DEPTH,
                           make_level_phase, rank_and_slots)


def auto_handoff_depth(num_leaves: int) -> int:
    """Default D0: one past the balanced depth of a num_leaves tree
    (ceil(log2(L)) + 1; 255 leaves -> 9), clamped to
    [1, MAX_LEVEL_DEPTH]."""
    d = int(np.ceil(np.log2(max(int(num_leaves), 2)))) + 1
    return max(1, min(d, MAX_LEVEL_DEPTH))


def resolve_handoff_depth(num_leaves: int, requested: int) -> int:
    """The one handoff-depth resolution (<= 0 -> auto; clamp to
    [1, MAX_LEVEL_DEPTH]), shared by the grower and the engine's memory
    gate."""
    d = int(requested) if int(requested) > 0 else \
        auto_handoff_depth(num_leaves)
    return max(1, min(d, MAX_LEVEL_DEPTH))


def make_hybrid_grower(cfg: GrowerConfig, meta: FeatureMeta,
                       handoff_depth: int = 0,
                       hist_fn: Callable = hist_cuda_rm,
                       level_hist_fn: Callable = hist_level_cuda,
                       layout=None):
    """Build ``grow(bins_rm, gh, uniforms=None, feature_mask=None) ->
    (TreeArrays, leaf_id)`` for unbounded or deep ``max_depth``: the level
    phase to D0, then the compact tail, both under the one ``[F]`` column
    mask. ``handoff_depth <= 0`` means auto. With ``layout`` (EFB groups)
    both phases expand alike and the tail's pool is seeded from the
    PHYSICAL level histograms (the JAX package's hybrid_grower.py:88-109)."""
    L = int(cfg.num_leaves)
    D0 = resolve_handoff_depth(L, handoff_depth)
    if 0 < cfg.max_depth <= D0:
        raise ValueError(
            f"hybrid growth needs max_depth > handoff depth {D0} (got "
            f"{cfg.max_depth}); the pure level grower serves shallow "
            "configs")
    phase = make_level_phase(cfg, meta, depth=D0, scan_last=True,
                             collect_hists=True, hist_fn=level_hist_fn,
                             layout=layout)
    tail = make_tree_grower(cfg, meta, hist_fn=hist_fn, layout=layout)

    T = 2 ** (D0 + 1) - 1            # heap nodes, levels 0..D0
    ids = np.arange(T)
    depth_h = np.floor(np.log2(ids + 1)).astype(np.float32)
    par = np.maximum((ids - 1) // 2, 0)
    # right children have even heap ids (> 0)
    isr = ((ids % 2 == 0) & (ids > 0)).astype(np.float32)
    lc_all = np.minimum(2 * ids + 1, T - 1)
    rc_all = np.minimum(2 * ids + 2, T - 1)
    root = ids == 0

    def grow(bins_rm: torch.Tensor, gh: torch.Tensor, uniforms=None,
             feature_mask: Optional[torch.Tensor] = None):
        dev = gh.device
        gh_hist, conv = hist_inputs(cfg, gh, uniforms)
        res = phase(bins_rm, gh, gh_hist, conv, feature_mask)
        h = res["host"].cpu().numpy()

        # ---- the committed prefix and its leaf slots ---------------------
        rank, k0, committed, slot, eff = rank_and_slots(
            h[:, B_GAIN], L, D0, cut_depth=D0)
        # every row resolves to its live leaf (committed nodes hold no
        # rows: their partitions ran)
        leaf_slot = torch.from_numpy(np.maximum(eff, 0)).to(dev)[res["heap"]]

        # ---- order/segments: stable sort on leaf slots ------------------
        # (the compact order after k0 stable partitions of arange(R)
        # keeps the original row order inside every leaf)
        order = torch.sort(leaf_slot, stable=True).indices
        cnt = torch.bincount(leaf_slot, minlength=L).cpu().numpy()
        starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])

        live = (~committed) & ((committed[par] & (ids > 0)) |
                               (root & (k0 == 0)))
        lslot = np.where(live, slot, L)              # dump slot L
        live_slot = np.zeros(L + 1, bool)
        live_slot[lslot] = True
        live_slot = live_slot[:L]
        node_of_slot = np.zeros(L + 1, np.int64)
        node_of_slot[lslot] = ids
        node_of_slot = node_of_slot[:L]

        # ---- per-leaf stats rows (grower S_* columns) -------------------
        prank = rank[par].astype(np.float32)
        stat_rows = np.stack(
            [h[:, H_SG], h[:, H_SH], h[:, H_CN], h[:, H_OUT],
             np.full(T, -np.inf), np.full(T, np.inf), depth_h,
             np.where(root, -1.0, prank), isr,
             np.where(root, 0.0, 2.0 * prank + 1.0 + isr)],
            axis=1).astype(np.float32)
        stats = np.zeros((L + 1, NS), np.float32)
        stats[:, S_LMIN] = -np.inf
        stats[:, S_LMAX] = np.inf
        stats[:, S_PARENT] = -1.0
        stats[lslot] = stat_rows

        # ---- per-leaf best rows, straight from the level scans ----------
        best = np.zeros((L + 1, NB), np.float32)
        best[:, B_GAIN] = K_MIN_SCORE
        best[:, B_FEAT] = -1.0
        best[:, B_DL] = 1.0
        best[lslot] = h[:, :NB]

        # ---- committed internal-node rows (grower N_* columns) ----------
        lptr = np.where(committed[lc_all], rank[lc_all], -(slot[lc_all] + 1))
        rptr = np.where(committed[rc_all], rank[rc_all], -(slot[rc_all] + 1))
        node_rows = np.stack(
            [h[:, B_FEAT], h[:, B_THR], h[:, B_DL], h[:, B_GAIN],
             h[:, H_OUT], h[:, H_SH], h[:, H_CN], lptr, rptr,
             h[:, B_NCAT]], axis=1).astype(np.float32)
        node = np.zeros((L, NN), np.float32)     # row L - 1: dump row
        rk_nodes = np.where(committed, rank, L - 1)
        node[rk_nodes] = node_rows

        # ---- category sets: each live leaf's best, each committed node's
        best_cat = tree_cat = None
        if meta.has_cat:
            sets = h[:, H_CAT:].astype(np.int64)
            leaf_sets = np.full((L + 1, sets.shape[1]), -1, np.int64)
            leaf_sets[lslot] = sets
            best_cat = torch.from_numpy(leaf_sets[:L]).to(dev)
            tree_cat = np.full((L, sets.shape[1]), -1, np.int32)
            tree_cat[rk_nodes] = sets
            tree_cat = tree_cat[:L - 1].copy()

        # ---- histogram pool: the live leaves' level histograms ----------
        # (raw dtype; unborn slots alias the root row, which the tail
        # never reads before writing)
        pool = res["hists"][torch.from_numpy(node_of_slot).to(dev)]

        state = GrowState(
            hist=pool,
            stats=torch.from_numpy(stats[:L]).to(dev),
            best=torch.from_numpy(best[:L]).to(dev),
            order=order,
            node=node[:L - 1].copy(),
            seg_start=np.where(live_slot, starts, 0).tolist(),
            seg_rows=np.where(live_slot, cnt, 0).tolist(),
            num_leaves=k0 + 1,
            best_cat=best_cat, tree_cat=tree_cat)
        return tail.resume(bins_rm, gh_hist, conv, state, k0, feature_mask)

    return grow
