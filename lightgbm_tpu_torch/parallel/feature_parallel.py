"""Feature-sharded (feature-parallel) tree growing over a
``torch.distributed`` world.

Port of ``lightgbm_tpu/parallel/feature_parallel.py`` (ref:
src/treelearner/feature_parallel_tree_learner.cpp,
parallel_tree_learner.h:26-46): every rank holds ALL rows but only its
contiguous slice of the features (padded to a multiple of the world with
one-bin features that never split). A split step on every rank:

1. builds the histograms of its slice only and scans them;
2. all-gathers the W winner rows and takes the argmax in rank order, so
   an exact gain tie goes to the smaller feature id, as
   ``SplitInfo::operator>`` and the serial scan have it;
3. the owner of the winning feature broadcasts its bin column over the
   split leaf's rows, and every rank partitions its (identical) rows.

Rows are replicated, so the root sums and quantization scales need no
reduction and every rank draws the same stochastic-rounding uniforms;
extra_trees draws one uniform a feature of the slice from the tree's key,
as the JAX package does.

Over EFB groups (``bundle``) the sharded columns are the PHYSICAL groups
(``shard_bundle``): rank r stores groups ``[r Gd, (r + 1) Gd)`` and
scans the logical features that live in them, padded to a common width
with one-bin dummies; its winner's id maps through the rank's id list,
and the owner broadcasts the winner's group column, which every rank
decodes to the feature's logical bins. An exact gain tie then goes to the
lower rank, which need not hold the lower feature id (the JAX package's
note at feature_parallel.py:13-15).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.grower import B_FEAT, B_GAIN, GrowerConfig, GrowerHooks, \
    make_tree_grower
from ..io.bundling import BundleInfo, decode_logical_bin
from ..ops.histogram import bin_ids
from ..ops.split import FeatureMeta
from ..utils import prng
from .mesh import Comm, gather_meta, padded_rows, window_ids


def padded_features(num_features: int, num_shards: int) -> int:
    return padded_rows(num_features, num_shards)


def padded_groups(num_groups: int, num_shards: int) -> int:
    """The padded PHYSICAL group count of the EFB-sharded feature
    learner (``shard_bundle``)."""
    return padded_rows(num_groups, num_shards)


def pad_feature_meta(meta: FeatureMeta, target_f: int) -> FeatureMeta:
    """``meta`` padded with one-bin features that never split."""
    F = int(meta.num_bin.shape[0])
    if F == target_f:
        return meta
    return gather_meta(meta, window_ids(0, target_f, F,
                                        meta.num_bin.device))


def shard_bundle(info: BundleInfo, world: int, rank: int, num_bin: int):
    """The EFB layout of one rank of the feature learner (the JAX
    package's feature_parallel.py:88-170, for one rank): the groups
    shard contiguously, ``Gd = padded_groups(G, W) / W`` a rank; the
    rank's logical features (those in its groups, by global id) are
    padded to the widest rank's count with one-bin dummies. Returns the
    global ids of its features (int64 [Fd], -1 a dummy), its local
    ``BundleInfo`` (group indices local, its gather map built for
    ``num_bin``) and ``Gd``."""
    group = np.asarray(info.group, np.int64)
    Gd = padded_groups(int(info.num_groups), world) // world
    owned = [np.flatnonzero((group >= d * Gd) & (group < (d + 1) * Gd))
             for d in range(world)]
    Fd = max(max(len(f) for f in owned), 1)
    ids = np.full(Fd, -1, np.int64)
    ids[:len(owned[rank])] = owned[rank]
    real = ids >= 0
    pick = lambda a, fill: np.where(real, np.asarray(a)[np.maximum(ids, 0)],
                                    fill).astype(np.int32)
    gnb = np.ones(Gd, np.int32)
    mine = np.asarray(info.group_num_bin[rank * Gd:(rank + 1) * Gd])
    gnb[:len(mine)] = mine
    local = BundleInfo(group=np.where(real, group[np.maximum(ids, 0)]
                                      - rank * Gd, 0).astype(np.int32),
                       offset=pick(info.offset, 0),
                       default_bin=pick(info.default_bin, 0),
                       num_bin=pick(info.num_bin, 1),
                       group_num_bin=gnb, num_groups=Gd)
    local.build_gather_map(num_bin)
    return ids, local, Gd


def make_feature_parallel_grower(cfg: GrowerConfig, meta: FeatureMeta,
                                 comm: Comm,
                                 hist_fn: Optional[Callable] = None,
                                 layout=None,
                                 bundle: Optional[BundleInfo] = None):
    """One rank of the feature learner over the global ``meta``: ``grow``
    takes this rank's bins (every row; the features of
    :func:`feature_window`, or the groups of :func:`shard_bundle` under
    EFB) and the global gh, with the feature mask and CEGB vectors cut
    to its features (``grow.feature_ids``, -1 a pad); the tree (global
    feature ids) and the leaf ids of every row are the same on every
    rank."""
    full = cfg.row_sched == "full"
    F = int(meta.num_bin.shape[0])
    dev = meta.num_bin.device
    if bundle is None:
        lo, Fd = feature_window(F, comm)
        ids = window_ids(lo, Fd, F, dev)

        def owner_column(f):
            return f // Fd, f - (f // Fd) * Fd

        def decode(col, f):
            return col
    else:
        from ..core.layout import BundleLayout
        ids_np, local, Gd = shard_bundle(bundle, comm.world, comm.rank,
                                         cfg.num_bin)
        ids = torch.as_tensor(ids_np, device=dev)
        layout = BundleLayout(local, dev, full)
        g_h, off_h, nb_h, d_h = (np.asarray(a).tolist() for a in (
            bundle.group, bundle.offset, bundle.num_bin, bundle.default_bin))

        def owner_column(f):
            return g_h[f] // Gd, g_h[f] - (g_h[f] // Gd) * Gd

        def decode(col, f):
            return decode_logical_bin(col, off_h[f], nb_h[f], d_h[f])
    meta_local = gather_meta(meta, ids)

    def select_best(rows: torch.Tensor, cat):
        f = rows[:, B_FEAT].long()
        rows = rows.clone()
        rows[:, B_FEAT] = torch.where(f >= 0, ids[f.clamp(min=0)],
                                      -1).to(rows.dtype)
        allr = comm.all_gather(rows, kind="best_combine")      # [W, N, NB]
        win = torch.argmax(allr[..., B_GAIN], dim=0)            # first max
        n = torch.arange(rows.shape[0], device=rows.device)
        if cat is not None:
            cat = comm.all_gather(cat, kind="best_combine")[win, n]
        return allr[win, n], cat

    def fetch_bin_column(bins, rows, f: int) -> torch.Tensor:
        """Feature f's logical bins over ``rows`` (every row under full
        scheduling): its owner broadcasts the stored column (the
        feature's, or its EFB group's) in the stored width (u16 bins
        travel as byte pairs: NCCL has no 16-bit integers), and every
        rank decodes it."""
        owner, c = owner_column(f)
        if comm.rank == owner:
            raw = bins[c] if full else bins[rows, c]
        else:
            n = bins.shape[1] if full else rows.shape[0]
            raw = torch.empty(n, dtype=bins.dtype, device=bins.device)
        got = comm.broadcast_from(raw.contiguous().view(torch.uint8), owner,
                                  kind="owner_column")
        return decode(bin_ids(got.view(bins.dtype)), f)

    hooks = GrowerHooks(select_best=select_best,
                        fetch_bin_column=fetch_bin_column,
                        partition_meta=meta)
    grow = make_tree_grower(cfg, meta_local, hist_fn=hist_fn, layout=layout,
                            hooks=hooks)
    grow.feature_ids = ids
    return grow


def feature_window(num_features: int, comm: Comm):
    """``(lo, Fd)``: this rank's slice ``[lo, lo + Fd)`` of the features
    padded to a multiple of the world."""
    Fd = padded_features(num_features, comm.world) // comm.world
    return comm.rank * Fd, Fd


class FeatureShardedLearner:
    """The engine's feature-parallel learner: ``grow(gh, key_u,
    feature_mask, cegb=None, et_key=None) -> (tree, leaf_id [N])``."""

    def __init__(self, grow, bins):
        self._grow = grow
        self.bins = bins
        self.ids = grow.feature_ids

    def cut(self, a: Optional[torch.Tensor], fill):
        """A global per-feature vector (or ``[2L, F]`` mask) in this
        rank's feature order, ``fill`` at its pads."""
        if a is None:
            return None
        ok = self.ids >= 0
        return torch.where(ok, a[..., self.ids.clamp(min=0)],
                           torch.as_tensor(fill, dtype=a.dtype,
                                           device=a.device))

    def grow(self, gh, key_u, feature_mask, cegb=None, **extras):
        uniforms = (None if key_u is None else tuple(
            prng.uniform(k, gh.shape[0], gh.device)
            for k in prng.split(key_u)))
        if cegb is not None:
            extras["cegb"] = (self.cut(cegb[0], 0.0), self.cut(cegb[1], 0.0))
        return self._grow(self.bins, gh, uniforms,
                          self.cut(feature_mask, False), **extras)


def host_feature_slice(bins_rm: np.ndarray, lo: int, Fd: int) -> np.ndarray:
    """Columns ``[lo, lo + Fd)`` of host row-major bins, zero columns past
    the last feature."""
    R, F = bins_rm.shape
    out = np.zeros((R, Fd), bins_rm.dtype)
    hi = min(lo + Fd, F)
    if hi > lo:
        out[:, :hi - lo] = bins_rm[:, lo:hi]
    return out
