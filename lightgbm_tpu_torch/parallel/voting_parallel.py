"""Voting-parallel (PV-Tree) tree growing over a ``torch.distributed``
world.

Port of ``lightgbm_tpu/parallel/voting_parallel.py`` (ref:
src/treelearner/voting_parallel_tree_learner.cpp,
parallel_tree_learner.h:126-207): rows are sharded as under data
parallel, but the histograms stay local. Before each scan every rank
votes its top-k features by local split gain
(``ops/split.per_feature_net_gains`` on the local-sums channel), the
votes are all-reduced, the top 2k features by (votes, then the smaller
feature id) are chosen the same on every rank, and only those
features' histograms are reduced: all-reduced into a histogram that is
zero elsewhere (``hist_reduce="allreduce"``), or reduce-scattered so
each rank scans 2k / W of them and the winners merge
(``"reduce_scatter"``). Per split O(k B) bytes travel instead of
O(F B).

The local sums of each leaf (``GrowerHooks.local_pool``) fix a local EFB
or multi-value histogram before the vote, so the vote ranks true local
logical histograms.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.grower import GrowerConfig, GrowerHooks, make_tree_grower
from ..ops.split import FeatureMeta, per_feature_net_gains
from .data_parallel import make_global_best_combine
from .mesh import Comm, feature_tile, gather_meta


def make_voting_parallel_grower(cfg: GrowerConfig, meta: FeatureMeta,
                                comm: Comm, top_k: int = 20,
                                hist_fn: Optional[Callable] = None,
                                layout=None,
                                hist_reduce: str = "allreduce"):
    """One rank of the voting learner (``top_k`` ≡ config ``top_k``);
    the grower's contract is data parallel's."""
    F = int(meta.num_bin.shape[0])
    k = max(1, min(int(top_k), F))
    k2 = min(2 * k, F)
    hp = cfg.hparams
    if hist_reduce not in ("allreduce", "reduce_scatter"):
        raise ValueError(f"hist_reduce={hist_reduce!r}; expected "
                         "'allreduce' or 'reduce_scatter' (resolve 'auto' "
                         "upstream)")
    use_rs = hist_reduce == "reduce_scatter"
    dev = meta.num_bin.device
    tie = (F - 1 - torch.arange(F, device=dev))

    def vote(hh, ctx, fm):
        """[N, k2] global top-2k features of N leaves from their local
        histograms: the local top-k by local net gain (ties to the
        smaller feature id, as ``lax.top_k``), the votes all-reduced, the
        top 2k by (votes, smaller id) — the same on every rank (ref:
        voting_parallel_tree_learner.cpp:152, 373 GlobalVoting)."""
        gains = per_feature_net_gains(hh, ctx["lsg"], ctx["lsh"],
                                      ctx["lcnt"], ctx["out"], meta, hp)
        if fm is not None:
            # column sampling applies before the vote
            gains = torch.where(fm, gains, -torch.inf)
        local = torch.sort(gains, dim=-1, descending=True,
                           stable=True).indices[:, :k]
        votes = torch.zeros_like(gains).scatter_(1, local, 1.0)
        votes = comm.all_reduce_sum(votes, kind="votes")
        keyed = votes.to(torch.int64) * F + tie
        return torch.sort(keyed, dim=-1, descending=True).indices[:, :k2]

    def take(hh, sel):
        return hh.gather(1, sel[:, :, None, None].expand(
            -1, -1, *hh.shape[2:]))

    def prepare(hh, ctx, fm):
        sel = vote(hh, ctx, fm)
        idx = sel[:, :, None, None].expand(-1, -1, *hh.shape[2:])
        hsel = comm.all_reduce_sum(take(hh, sel).contiguous(),
                                   kind="hist_allreduce")
        mask = torch.zeros(hh.shape[:2], dtype=torch.bool, device=hh.device)
        return (torch.zeros_like(hh).scatter_(1, idx, hsel),
                mask.scatter_(1, sel, True))

    k2l = feature_tile(k2, comm.world)
    k2p = k2l * comm.world

    def scan_window(hh, ctx, fm, gp, rand_u):
        """The voted features' histograms reduce-scattered: rank r keeps
        the global sums of its k2 / W of them, with their ids and metas
        (one a leaf: each leaf voted its own features)."""
        sel = vote(hh, ctx, fm)
        N = sel.shape[0]
        if k2p > k2:
            sel = torch.cat([sel, sel.new_full((N, k2p - k2), F)], dim=1)
        g = take(hh, sel.clamp(max=F - 1))
        hw = comm.reduce_scatter(g.movedim(1, 0).contiguous(),
                                 kind="hist_reduce_scatter").movedim(0, 1)
        fids = sel[:, comm.rank * k2l:(comm.rank + 1) * k2l]
        valid = fids < F
        fids = torch.where(valid, fids, -1)
        fsafe = fids.clamp(min=0)
        metas = [gather_meta(meta, fids[n]) for n in range(N)]
        cut = (lambda a: None if a is None else
               (a[fsafe] if a.dim() == 1 else a.gather(1, fsafe)))
        fm_w = valid if fm is None else valid & cut(fm)
        return hw, metas, fids, fm_w, cut(gp), cut(rand_u)

    hooks = GrowerHooks(
        reduce_hist=lambda h: h,          # the pool stays local
        reduce_sums=lambda s: comm.all_reduce_sum(s, kind="root_sums"),
        reduce_max=lambda x: comm.all_reduce_max(x, kind="quant_scale"),
        prepare_split_hist=None if use_rs else prepare,
        scan_window=scan_window if use_rs else None,
        select_best=make_global_best_combine(comm) if use_rs else None,
        local_pool=True)
    return make_tree_grower(cfg, meta, hist_fn=hist_fn, layout=layout,
                            hooks=hooks)
