"""Level-synchronous best-first tree grower.

Port of ``lightgbm_tpu/core/level_grower.py`` for dense numerical
features: the tree grows level by level, with one histogram launch
(kernel K2, ``ops/hist_level_cuda.py``), one batched split scan and one
partition pass per DEPTH instead of per split. With every candidate's
gain known, the candidates are ranked on the host as the JAX package
ranks them (``rank_and_slots``), so the tree is the JAX level tree node
for node, with the compact tree's splits.

``make_level_phase`` is the per-level loop shared by the pure grower
(``make_level_grower``, ``1 <= max_depth <= MAX_LEVEL_DEPTH``) and the
hybrid (core/hybrid_grower.py). Its outputs stay on the device; the
growers read them to the host once per tree, and order the splits and
assemble the tree there with numpy: a tree has at most
``2^(MAX_LEVEL_DEPTH + 1) - 1`` heap nodes, and the order is a control
decision, like the compact grower's per-split read.

Numerical note (as in the JAX package): node sums, outputs and child
stats come from the same split records the compact grower uses, so the
only divergence channel is histogram accumulation order: none for dyadic
gradients (a binary objective's first tree) and for the quantized int32
path, f32 reassociation noise otherwise.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.hist_level_cuda import carry_order_cuda, hist_level_cuda
from ..ops.histogram import bin_ids
from ..ops.split import (MISSING_ENUM, K_EPSILON, FeatureMeta,
                         best_split_for_leaf, calculate_splitted_leaf_output,
                         pack_record_rows)
from .grower import (B_DL, B_FEAT, B_GAIN, B_THR, NB, GrowerConfig,
                     hist_inputs, root_sums)
from .tree import TreeArrays

# dense level histograms are [2^d, F, B, 3]: depth 10 = 1024 nodes is the
# last level the JAX package admits (ref: level_grower.py:86)
MAX_LEVEL_DEPTH = 10

# columns of the per-node host read: the packed split row, then the
# node's grad/hess/count sums and output
H_SG, H_SH, H_CN, H_OUT = range(NB, NB + 4)


def go_left_rows(col, thr, dl, meta: FeatureMeta, f_row) -> torch.Tensor:
    """Per-row partition direction (ref: dense_bin.hpp:317 SplitInner;
    the JAX package's ``_go_left_bins``): each row carries its own node's
    threshold, default direction and split feature ``f_row``."""
    go_left = col <= thr
    is_nan_bin = ((meta.missing_type[f_row] == MISSING_ENUM["nan"])
                  & (col == meta.num_bin[f_row].long() - 1))
    is_dflt_bin = ((meta.missing_type[f_row] == MISSING_ENUM["zero"])
                   & (col == meta.default_bin[f_row].long()))
    return torch.where(is_nan_bin | is_dflt_bin, dl, go_left)


def make_level_phase(cfg: GrowerConfig, meta: FeatureMeta, depth: int,
                     scan_last: bool, collect_hists: bool = False,
                     hist_fn: Callable = hist_level_cuda):
    """The level loop (ref: level_grower.py:268 make_level_phase).

    Scans levels 0..depth-1 and, with ``scan_last``, level ``depth`` too;
    partitions rows after levels 0..depth-1 only. Heap arrays cover
    levels 0..depth (``T = 2^(depth+1) - 1``); without ``scan_last`` the
    last level is a filler that never splits (gain -inf).

    The rows' node order is carried from level to level
    (``ops/hist_level_cuda.carry_order_cuda``: each parent's rows
    partitioned stably into its children's, no sort) and handed to
    ``hist_fn`` as ``order``/``seg``.

    Returns ``phase(bins_rm, gh, gh_hist, conv) -> dict``: ``heap``
    (int64 [R], each row's final heap node), ``host`` (f32 [T, NB + 4]
    on the device: the packed split row of every heap node, then its
    grad/hess/count sums and output; columns ``H_*``) and, with
    ``collect_hists``, ``hists``: the raw level histograms [T, F, B, 3]
    (int32 under quantization) for seeding the compact pool.
    """
    B = int(cfg.num_bin)
    hp = cfg.hparams
    n_scan = depth + (1 if scan_last else 0)

    def phase(bins_rm: torch.Tensor, gh: torch.Tensor,
              gh_hist: torch.Tensor, conv: Callable) -> Dict:
        dev = gh.device
        R = bins_rm.shape[0]
        sums = root_sums(cfg, gh, gh_hist, conv)
        root_out = calculate_splitted_leaf_output(
            sums[0], sums[1] + 2 * K_EPSILON, hp, sums[2],
            torch.zeros((), dtype=torch.float32, device=dev))
        heap = torch.zeros(R, dtype=torch.long, device=dev)
        # every row in the root, in row order
        order = torch.arange(R, device=dev)
        seg = torch.tensor([0, R], device=dev)
        node_d = torch.stack([sums[0], sums[1], sums[2], root_out])[None]
        rows_l, node_l, hist_l = [], [node_d], []

        for d in range(n_scan):
            n_d = 1 << d
            local = heap - (n_d - 1)
            in_lvl = (local >= 0) & (local < n_d)
            lsafe = torch.where(in_lvl, local, 0)
            # ---- every level-d node's histogram, one launch ------------
            hist_raw = hist_fn(bins_rm, gh_hist, local, in_lvl, n_d, B,
                               order=order, seg=seg)
            if collect_hists:
                hist_l.append(hist_raw)
            # ---- the split scan, batched over the level's nodes --------
            recs = best_split_for_leaf(conv(hist_raw), node_d[:, 0],
                                       node_d[:, 1], node_d[:, 2],
                                       node_d[:, 3], meta, hp)
            rows_l.append(pack_record_rows(recs))
            if d >= depth:
                break       # deepest scanned level: no descend

            # ---- children stats, heap order (left, right) --------------
            node_d = torch.stack(
                [torch.stack([recs.left_sum_gradient, recs.left_sum_hessian,
                              recs.left_count, recs.left_output], -1),
                 torch.stack([recs.right_sum_gradient,
                              recs.right_sum_hessian, recs.right_count,
                              recs.right_output], -1)], 1).reshape(-1, 4)
            node_l.append(node_d)

            # ---- partition: rows at valid nodes descend ----------------
            f_row = recs.feature.clamp(min=0)[lsafe]
            col = bin_ids(bins_rm.gather(1, f_row[:, None])[:, 0])
            go_left = go_left_rows(col, recs.threshold[lsafe],
                                   recs.default_left[lsafe], meta, f_row)
            descend = in_lvl & (recs.gain > 0.0)[lsafe]
            heap = torch.where(descend, 2 * heap + 1 + (~go_left).long(),
                               heap)
            if d + 1 < n_scan:
                order, seg = carry_order_cuda(order, seg, local, go_left,
                                              descend)

        if not scan_last:
            # depth-D nodes are never scanned: they never split
            n_leafrow = 1 << depth
            filler = torch.zeros((n_leafrow, NB), dtype=torch.float32,
                                 device=dev)
            filler[:, B_GAIN] = -np.inf
            filler[:, B_FEAT] = -1.0
            rows_l.append(filler)
        host = torch.cat([torch.cat(rows_l), torch.cat(node_l)], dim=1)
        res = dict(heap=heap, host=host)
        if collect_hists:
            res["hists"] = torch.cat(hist_l)
        return res

    return phase


def rank_and_slots(gain_h: np.ndarray, L: int, depth: int,
                   cut_depth: Optional[int] = None):
    """Rank the heap candidates and give them leaf slots, as the JAX
    package does (ref: level_grower.py:528 rank_and_slots).

    A node's ``e`` is the least gain on its root path (``-inf`` below a
    node that cannot split, or where its own gain is not positive); nodes
    are ranked by ``e``, descending, ties in heap order (a stable sort),
    and the first ``k = min(L - 1, #{e > 0})`` split. Where a split's two
    children both gain more than it does, they share its ``e`` and the
    left child goes first, where the compact grower would take the larger
    gain first: the set of splits is the compact grower's, the numbering
    can differ (ROADMAP C2: the port follows the reference here).
    ``cut_depth`` (the hybrid's D0) stops the prefix at the first rank
    held by a node of that depth, whose children were not scanned. The
    left child keeps its parent's leaf slot and the right child takes
    ``rank(parent) + 1``; ``eff[v]`` is the final leaf slot of rows whose
    node is v.

    Returns numpy ``(rank, k, selected, slot, eff)`` over the T heap
    nodes."""
    T = gain_h.shape[0]
    gain = np.asarray(gain_h, np.float32)
    e = np.where(gain > 0.0, gain, np.float32(-np.inf))
    for d in range(1, depth + 1):
        ids = (1 << d) - 1 + np.arange(1 << d)
        e[ids] = np.where(gain[ids] > 0.0,
                          np.minimum(gain[ids], e[(ids - 1) // 2]), -np.inf)
    order = np.argsort(-e, kind="stable")
    rank = np.empty(T, np.int64)
    rank[order] = np.arange(T)
    k = min(L - 1, int((e > 0.0).sum()))
    if cut_depth is not None:
        deep = np.floor(np.log2(np.arange(T) + 1)) == cut_depth
        k = min(k, int(np.argmax(deep[order])))
    selected = rank < k
    slot = np.full(T, -1, np.int64)
    slot[0] = 0
    eff = np.full(T, -1, np.int64)
    eff[0] = -1 if selected[0] else 0
    for d in range(depth):
        ids = (1 << d) - 1 + np.arange(1 << d)
        lc, rc = 2 * ids + 1, 2 * ids + 2
        ch = selected[ids]
        slot[lc] = np.where(ch, slot[ids], slot[lc])
        slot[rc] = np.where(ch, rank[ids] + 1, slot[rc])
        par_eff = eff[ids]
        eff[lc] = np.where(par_eff >= 0, par_eff,
                           np.where(ch & ~selected[lc], slot[ids], -1))
        eff[rc] = np.where(par_eff >= 0, par_eff,
                           np.where(ch & ~selected[rc], rank[ids] + 1, -1))
    return rank, k, selected, slot, eff


def make_level_grower(cfg: GrowerConfig, meta: FeatureMeta,
                      hist_fn: Callable = hist_level_cuda):
    """Build ``grow(bins_rm, gh, uniforms=None) -> (TreeArrays, leaf_id)``
    for ``1 <= max_depth <= MAX_LEVEL_DEPTH`` (ref: level_grower.py:578);
    deeper or unbounded configs go through the hybrid grower."""
    L = int(cfg.num_leaves)
    D = int(cfg.max_depth)
    if not (1 <= D <= MAX_LEVEL_DEPTH):
        raise ValueError(
            f"pure level scheduling requires 1 <= max_depth <= "
            f"{MAX_LEVEL_DEPTH}, got {cfg.max_depth} (the hybrid grower "
            "serves deeper and unbounded configs)")
    T_all = 2 ** (D + 1) - 1
    phase = make_level_phase(cfg, meta, depth=D, scan_last=False,
                             hist_fn=hist_fn)
    ids_all = np.arange(T_all)
    par_all = np.maximum((ids_all - 1) // 2, 0)
    lc_all = np.minimum(2 * ids_all + 1, T_all - 1)
    rc_all = np.minimum(2 * ids_all + 2, T_all - 1)

    def grow(bins_rm: torch.Tensor, gh: torch.Tensor, uniforms=None):
        gh_hist, conv = hist_inputs(cfg, gh, uniforms)
        res = phase(bins_rm, gh, gh_hist, conv)
        h = res["host"].cpu().numpy()
        rank, k, chosen, slot, eff = rank_and_slots(h[:, B_GAIN], L, D)
        leaf_id = torch.from_numpy(np.maximum(eff, 0)).to(gh.device)[
            res["heap"]]

        # ---- internal nodes, numbered by rank ------------------------
        li = max(L - 1, 1)
        rk = np.where(chosen, rank, li)              # dump slot li
        lptr = np.where(chosen[lc_all], rank[lc_all], -(slot[lc_all] + 1))
        rptr = np.where(chosen[rc_all], rank[rc_all], -(slot[rc_all] + 1))

        def node_scatter(vals, dtype=np.float32):
            out = np.zeros(li + 1, dtype)
            out[rk] = vals
            return out[:L - 1]

        # ---- leaves: nodes with a chosen parent that are not chosen ---
        is_leaf = (~chosen) & chosen[par_all] & (ids_all > 0)
        lslot = np.where(is_leaf, slot, L)           # dump slot L
        grew = k > 0

        def leaf_scatter(vals, fill=0.0, dtype=np.float32):
            out = np.full(L + 1, fill, dtype)
            if grew:
                out[lslot] = vals
            return out[:L]

        tree = TreeArrays(
            split_feature=node_scatter(h[:, B_FEAT], np.int32),
            threshold_bin=node_scatter(h[:, B_THR], np.int32),
            default_left=node_scatter(h[:, B_DL] > 0.5, bool),
            left_child=node_scatter(lptr, np.int32),
            right_child=node_scatter(rptr, np.int32),
            split_gain=node_scatter(h[:, B_GAIN]),
            internal_value=node_scatter(h[:, H_OUT]),
            internal_weight=node_scatter(h[:, H_SH]),
            internal_count=node_scatter(h[:, H_CN]),
            leaf_value=leaf_scatter(h[:, H_OUT]),
            leaf_weight=leaf_scatter(h[:, H_SH]),
            leaf_count=leaf_scatter(h[:, H_CN]),
            leaf_parent=leaf_scatter(rank[par_all], fill=-1, dtype=np.int32),
            num_leaves=k + 1,
            shrinkage=1.0)
        return tree, leaf_id

    return grow
