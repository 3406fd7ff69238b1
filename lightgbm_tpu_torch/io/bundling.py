"""Exclusive Feature Bundling (EFB).

Port of ``lightgbm_tpu/io/bundling.py`` (ref: src/io/dataset.cpp:112
FindGroups greedy graph coloring, :251 FastFeatureBundling;
include/LightGBM/feature_group.h FeatureGroup). Sparse features that are
rarely non-default on the same row share one physical column (a group):

- a group's bin 0 is "every member at its default bin", and each member
  owns a contiguous range of the group's bins for its non-default bins;
- histograms are built per GROUP (``[G, B, 3]``), then expanded to the
  LOGICAL features' ``[F, B, 3]`` before the split scan
  (``make_expand_hist``): a gather for the stored bins, and the default
  bin's row rebuilt as the leaf's totals minus the rest (ref:
  Dataset::FixHistogram, include/LightGBM/dataset.h:778);
- a row active in more than one member of a group (a conflict, at most
  ``max_conflict_rate`` of the sampled rows) keeps the later member's
  bin, and the earlier member reads its default bin there.

The JAX package holds bins feature-major ``[F, R]``; the port holds them
row-major ``[R, F]``, so ``find_bundles`` and ``most_frequent_bins`` take
``[R, F]`` and sample the same rows (every ``R // 50_000``-th and
``R // 100_000``-th), which gives the same greedy order and the same
``BundleInfo``; ``pack_bins`` and ``pack_sparse_direct`` give the
row-major ``[R, G]`` group columns, the transpose of the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..ops.split import column_sum


@dataclasses.dataclass
class BundleInfo:
    """The packing of logical features into groups (host numpy)."""
    # per logical (used) feature
    group: np.ndarray        # i32 [F] its group
    offset: np.ndarray       # i32 [F] first group bin of its stored range
    default_bin: np.ndarray  # i32 [F] the bin not stored in the group
    num_bin: np.ndarray      # i32 [F] its logical bin count
    # per group
    group_num_bin: np.ndarray  # i32 [G]
    num_groups: int = 0
    # [F, B] flat index into the [G * B] rows of a group histogram, -1
    # where the logical bin is the default bin (rebuilt) or past num_bin
    gather_map: Optional[np.ndarray] = None

    def build_gather_map(self, B: int) -> None:
        F = len(self.group)
        gmap = np.full((F, B), -1, np.int64)
        for f in range(F):
            g, off, d, nb = (int(self.group[f]), int(self.offset[f]),
                             int(self.default_bin[f]), int(self.num_bin[f]))
            stored = [b for b in range(nb) if b != d]
            gmap[f, stored] = g * B + off + np.arange(len(stored))
        self.gather_map = gmap


def most_frequent_bins(bins_rm: np.ndarray, num_bins: np.ndarray,
                       sample: int = 100_000) -> np.ndarray:
    """Each feature's most frequent bin over every ``R // sample``-th row
    of row-major ``[R, F]`` bins (ref: BinMapper GetMostFreqBin): the
    bin a group does not store."""
    R, F = bins_rm.shape
    sub = bins_rm[::max(1, R // sample)]
    out = np.zeros(F, np.int32)
    for f in range(F):
        out[f] = np.bincount(sub[:, f], minlength=int(num_bins[f])).argmax()
    return out


def find_bundles(bins_rm: np.ndarray, num_bins: np.ndarray,
                 max_conflict_rate: float = 0.0,
                 max_group_bins: int = 256,
                 sample: int = 50_000) -> Optional[BundleInfo]:
    """Greedy conflict-bounded grouping over row-major ``[R, F]`` bins
    (ref: Dataset::FindGroups; the JAX package's find_bundles line for
    line). None when bundling would not reduce the column count."""
    R, F = bins_rm.shape
    dflt = most_frequent_bins(bins_rm, num_bins)
    active = np.ascontiguousarray(
        (bins_rm[::max(1, R // sample)] != dflt[None, :]).T)   # [F, S]
    S = active.shape[1]
    budget = int(max_conflict_rate * S)
    # only features non-default on at most half the rows bundle; the
    # others take a group each (as the reference considers sparse
    # features only), and the hardest to place go first
    is_sparse = active.mean(axis=1) <= 0.5
    order = np.argsort(-active.sum(axis=1), kind="stable")

    group_masks: List[np.ndarray] = []
    group_bins: List[int] = []
    group_feats: List[List[int]] = []
    conflicts: List[int] = []
    solo_feats: List[int] = []
    for f in order:
        if not is_sparse[f]:
            solo_feats.append(int(f))
            continue
        nb_extra = int(num_bins[f]) - 1
        placed = False
        for g in range(len(group_masks)):
            if group_bins[g] + nb_extra >= max_group_bins:
                continue
            c = int(np.count_nonzero(group_masks[g] & active[f]))
            if conflicts[g] + c <= budget:
                group_masks[g] |= active[f]
                group_bins[g] += nb_extra
                group_feats[g].append(int(f))
                conflicts[g] += c
                placed = True
                break
        if not placed:
            group_masks.append(active[f].copy())
            group_bins.append(1 + nb_extra)
            group_feats.append([int(f)])
            conflicts.append(0)
    for f in solo_feats:
        group_feats.append([f])
        group_bins.append(int(num_bins[f]))

    G = len(group_feats)
    if G >= F:
        return None
    info = BundleInfo(
        group=np.zeros(F, np.int32), offset=np.zeros(F, np.int32),
        default_bin=dflt.astype(np.int32),
        num_bin=np.asarray(num_bins, np.int32),
        group_num_bin=np.asarray(group_bins, np.int32), num_groups=G)
    for g, feats in enumerate(group_feats):
        pos = 1  # group bin 0: every member at its default
        for f in feats:
            info.group[f] = g
            info.offset[f] = pos
            pos += int(num_bins[f]) - 1
    return info


def group_dtype(info: BundleInfo):
    """uint8 group columns while every group has at most 256 bins."""
    return np.uint8 if info.group_num_bin.max() <= 256 else np.uint16


def pack_bins(bins_rm: np.ndarray, info: BundleInfo) -> np.ndarray:
    """Logical row-major ``[R, F]`` bins packed into row-major ``[R, G]``
    group columns. Members are written in ascending feature order, so a
    later member overwrites an earlier one on a conflict row. The groups
    are packed feature-major and transposed once."""
    R, F = bins_rm.shape
    dtype = group_dtype(info)
    out = np.zeros((info.num_groups, R), dtype)
    for f in range(F):
        g, d = int(info.group[f]), int(info.default_bin[f])
        b = bins_rm[:, f].astype(np.int64)
        act = b != d
        # non-default bins map to a contiguous range skipping the default
        out[g, act] = (info.offset[f] + b[act] - (b[act] > d)).astype(dtype)
    return np.ascontiguousarray(out.T)


def pack_sparse_direct(csc, mappers, used_map: np.ndarray,
                       info: BundleInfo) -> np.ndarray:
    """A scipy CSC matrix quantized straight into row-major ``[R, G]``
    group columns, in O(nnz) work, never holding the ``[R, F]`` logical
    bins (56 GB at 13.2M x 4,228; ref: src/io/dataset.cpp:251
    FastFeatureBundling). Bit for bit ``pack_bins`` of the logical bins:
    the same member order, overwrite on conflict and default skip. A
    feature whose implicit zeros do not fall in its default bin is
    written as a whole column."""
    R = csc.shape[0]
    dtype = group_dtype(info)
    out = np.zeros((info.num_groups, R), dtype)
    zero1 = np.zeros(1, np.float64)
    for fi, feat in enumerate(used_map):
        m = mappers[int(feat)]
        lo, hi = csc.indptr[feat], csc.indptr[feat + 1]
        rows = csc.indices[lo:hi]
        g, d = int(info.group[fi]), int(info.default_bin[fi])
        off = int(info.offset[fi])
        b = m.value_to_bin(np.asarray(csc.data[lo:hi], np.float64)
                           ).astype(np.int64)
        zb = int(m.value_to_bin(zero1)[0])
        if zb == d:
            act = b != d
            out[g, rows[act]] = (off + b[act] - (b[act] > d)).astype(dtype)
        else:
            col = np.full(R, zb, np.int64)
            col[rows] = b
            act = col != d
            out[g, act] = (off + col[act] - (col[act] > d)).astype(dtype)
    return np.ascontiguousarray(out.T)


def decode_logical_bin(col_phys: torch.Tensor, offset, num_bin,
                       default_bin) -> torch.Tensor:
    """Group bins -> the logical bins of one feature (scalars) or of each
    row's own feature (tensors shaped like ``col_phys``): the inverse of
    the packing; int64."""
    rel = col_phys.long() - offset
    act = (rel >= 0) & (rel < num_bin - 1)
    return torch.where(act, rel + (rel >= default_bin).long(),
                       torch.as_tensor(default_bin, device=col_phys.device))


def fix_default_bin(h: torch.Tensor, totals: torch.Tensor,
                    dmask: torch.Tensor) -> torch.Tensor:
    """``h`` (f32 ``[..., F, B, 3]``) with each feature's default bin
    (bool ``dmask`` ``[F, B]``) given the leaf totals (``[..., 3]``) minus
    the mass of its other bins (ref: FixHistogram). On the CPU the sum
    over B adds in XLA's CPU reduce order (``ops/split.column_sum``), so
    near-ties fall as in the JAX package."""
    if h.device.type == "cpu":
        cols = h.movedim(-2, 0)
        rest = column_sum(cols.reshape(cols.shape[0], -1)).reshape(
            cols.shape[1:])
    else:
        rest = h.sum(dim=-2)
    return h + dmask[..., None] * (totals[..., None, None, :]
                                   - rest[..., None, :])


def make_expand_hist(info: BundleInfo, device):
    """``expand_hist(hist_g [..., G, B, 3] f32, totals [..., 3]) ->
    [..., F, B, 3]``: group histograms to logical ones, the default bin
    rebuilt from the totals; shared by the compact, full, level and
    hybrid growers (the hybrid's handoff needs both phases to expand
    alike). ``info.gather_map`` must be built for B."""
    gmap = torch.as_tensor(info.gather_map, device=device)
    take = gmap.clamp(min=0).reshape(-1)
    stored = (gmap >= 0)[..., None]
    F, B = gmap.shape
    dmask = (torch.arange(B, device=device)[None, :] ==
             torch.as_tensor(info.default_bin, device=device)[:, None])

    def expand_hist(hist_g: torch.Tensor, totals: torch.Tensor
                    ) -> torch.Tensor:
        lead = hist_g.shape[:-3]
        flat = hist_g.reshape(*lead, -1, hist_g.shape[-1])
        h = flat.index_select(-2, take).reshape(*lead, F, B, -1)
        h = torch.where(stored, h, torch.zeros((), dtype=h.dtype,
                                               device=h.device))
        return fix_default_bin(h, totals, dmask)

    return expand_hist
