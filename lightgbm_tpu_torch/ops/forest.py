"""Packed-forest prediction on the device.

Port of ``lightgbm_tpu/ops/forest.py`` (its single-model serving engine;
ref: src/treelearner/cuda/cuda_tree.cu AddPredictionToScore, where the
forest stays on the device between requests): the model list is packed
once into a stacked structure-of-arrays forest on the device and kept in
sync incrementally (new trees are appended, a destructive change of the
model list repacks), request rows are binned on the device with the
training BinMapper bounds (one batched ``torch.searchsorted``), and the
traversal runs depth-bounded (``ops/predict.py``). Each batch is scored
at its own row count: the JAX package pads batches to a small family of
row counts (``bucket_rows``) to bound the shapes it compiles, and this
eager package compiles nothing.

Exactness: the device compares in f32 against ``f32_floor`` of the f64
training bounds and thresholds, which decides exactly as the host f64
mapper and walk do for every f32-representable value (NaN and ±inf
included). Values that only f64 holds are never misrouted: the binned
route bins those COLUMNS with the host mapper, the raw route refuses
them (``DeviceRouteUnavailable``, and the Booster falls back to the host
walk).

Scores accumulate in f32 per (row, output) sequentially in iteration
order, from exact zeros (``_accumulate_iters``), so they are the JAX
package's device scores bit for bit when the leaves and leaf values are.

The serving tier (``serving/``) freezes snapshots of a window
(``ServingEngine.snapshot``), optionally copied to every device of a
serving mesh (``place_window``, a :class:`Replicas`), and scores a
batch's rows split over those devices (``snapshot_scores(place=)``).
Device TreeSHAP packs and explains through the same engine
(``snapshot_shap``, ``ops/shap_pack.py``).

The multi-tenant fleet (``serving/fleet.py``) packs each tenant's window
on the host (``pack_window_binned``/``_raw``), stacks the windows of one
shape bucket (``TenantShape``) into a mega-pack uploaded once
(``upload_window``) and scores a coalesced batch of the bucket in one
call (``_fleet_scores_binned``/``_raw``), each row over its own tenant's
window, with ``_accumulate_iters``' sequence of f32 adds.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..core.tree import HostTree
from ..robustness import faults
from .predict import (BinnedTreeArrays, RawTreeArrays, _leaf_raw_t,
                      depth_steps, fleet_leaf_bins, fleet_leaf_raw,
                      forest_leaf_bins)
from .split import MISSING_ENUM

ROW_BUCKET_MIN = 256
# trees traversed together in one lockstep walk: [T, R] int64 node, leaf
# and feature tensors of at most this many elements each
WALK_ELEMS = 1 << 24


# why a window with a linear tree takes the host walk
LINEAR_TREES_ON_HOST = ("device prediction does not cover linear trees "
                        "(their leaves' linear models read raw features on "
                        "the host)")


class DeviceRouteUnavailable(ValueError):
    """The device route cannot serve this request (an empty tree range,
    f64-only values or a categorical node on the raw route); the Booster
    answers it by the host walk. Nothing else is caught."""


def bucket_rows(r: int) -> int:
    """The JAX package's padded row count for a request batch (the next
    power of two up to 4096, then steps of 1/8 octave, at most ~12%
    padding), which bounds the shapes it compiles. This package scores
    every batch at its own row count."""
    if r <= ROW_BUCKET_MIN:
        return ROW_BUCKET_MIN
    p = 1 << int(r - 1).bit_length()          # next pow2 >= r
    if p <= 4096:
        return p
    step = (p >> 1) // 8                      # 1/8 of the floor octave
    return -(-r // step) * step


def f32_floor(vals: np.ndarray) -> np.ndarray:
    """Largest float32 <= each float64 value. For f32 ``x``:
    ``x <= f32_floor(v)  <=>  x <= v``. NaN passes through; values beyond
    the f32 range clamp to the largest finite f32 or -inf with the same
    property."""
    v = np.asarray(vals, np.float64)
    out = v.astype(np.float32)
    with np.errstate(over="ignore"):
        over = out.astype(np.float64) > v     # round-to-nearest went up
    if over.any():
        out = out.copy()
        out[over] = np.nextafter(out[over], np.float32(-np.inf))
    return out


class DeviceBinner:
    """Bins raw request columns on the device with the TRAINING
    BinMappers (ref: bin.h:613 ValueToBin — the first bin whose upper
    bound is >= the value).

    Numerical features: one batched ``searchsorted`` of the ``[F, R]``
    f32 values against the uploaded ``[F, B]`` ``f32_floor`` bounds; NaN
    maps to the reserved last bin of nan-missing features and to 0.0's
    bin otherwise, as ValueToBin does. Categorical columns, and columns
    holding a value that f32 cannot hold, are binned by the host mapper
    (the f32 value could fall on the other side of a bound)."""

    def __init__(self, mappers, used_feature_map, device):
        F = len(mappers)
        self.mappers = mappers
        self.device = torch.device(device)
        self.used = np.asarray(used_feature_map, np.int64)
        nb = np.asarray([m.num_bin for m in mappers], np.int64)
        nan_miss = np.asarray(
            [m.missing_type == "nan" for m in mappers], bool)
        self.cat_idx = [i for i, m in enumerate(mappers)
                        if m.bin_type == "categorical"]
        # bounds actually compared: bin_upper_bound[:n_numeric-1] (the
        # last numeric bound is +inf or the NaN sentinel and never decides)
        n_bounds = np.maximum(nb - nan_miss - 1, 0)
        B = max(int(n_bounds.max()) if F else 0, 1)
        bounds = np.full((F, B), np.inf, np.float32)
        for i, m in enumerate(mappers):
            if m.bin_type == "categorical":
                continue                      # all-inf row -> bin 0 (unused)
            k = int(n_bounds[i])
            if k:
                bounds[i, :k] = f32_floor(m.bin_upper_bound[:k])
        self.bounds_dev = torch.as_tensor(bounds, device=self.device)
        self.num_bin_dev = torch.as_tensor(nb, device=self.device)
        self.nan_miss_dev = torch.as_tensor(nan_miss, device=self.device)

    def bins(self, X: np.ndarray) -> torch.Tensor:
        """[R, C] raw request matrix -> [F, R] int32 device bins."""
        cols = X[:, self.used].T                  # [F, R] f64 view
        x_t = np.ascontiguousarray(cols, np.float32)
        with np.errstate(invalid="ignore"):
            f32_ok = (x_t.astype(np.float64) == cols) | np.isnan(cols)
        host_cols = sorted(set(np.nonzero(~f32_ok.all(axis=1))[0].tolist())
                           | set(self.cat_idx))
        x = torch.as_tensor(x_t, device=self.device)
        isnan = torch.isnan(x)
        x0 = torch.where(isnan, torch.zeros_like(x), x)
        out = torch.searchsorted(self.bounds_dev, x0, side="left",
                                 out_int32=True)
        out = torch.where(self.nan_miss_dev[:, None] & isnan,
                          (self.num_bin_dev[:, None] - 1).to(torch.int32),
                          out)
        if host_cols:
            hb = np.zeros((len(host_cols), X.shape[0]), np.int32)
            for j, i in enumerate(host_cols):
                hb[j] = self.mappers[i].value_to_bin(
                    np.asarray(cols[i], np.float64))
            out[torch.as_tensor(host_cols, device=self.device)] = \
                torch.as_tensor(hb, device=self.device)
        return out


# ---------------------------------------------------------------------------
# incremental forest packing
# ---------------------------------------------------------------------------

def _pad(a, n: int, dtype, fill=0) -> np.ndarray:
    out = np.full(n, fill, dtype)
    out[:len(a)] = a
    return out


def _stack(cls, per_tree: List[dict]):
    """Per-tree host arrays (``pack_binned_tree`` dicts for
    ``BinnedTreeArrays``, ``_host_tree_to_raw`` ones for
    ``RawTreeArrays``) stacked on a leading axis as a host ``cls``."""
    return cls(**{f: np.stack([t[f] for t in per_tree]) for f in cls._fields})


def to_device(tree, device):
    """A host pack (NamedTuples and tuples of numpy arrays, None kept)
    as tensors on ``device``."""
    if tree is None:
        return None
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree, device=device)
    if hasattr(tree, "_fields"):
        return type(tree)(*[to_device(x, device) for x in tree])
    return tuple(to_device(x, device) for x in tree)


def upload_trees(cls, per_tree: List[dict], device) -> NamedTuple:
    """Stack per-tree host arrays on a leading axis, one upload a field."""
    return to_device(_stack(cls, per_tree), device)


def _concat(a, b):
    if a is None:
        return b
    return type(a)(*[torch.cat([x, y]) for x, y in zip(a, b)])


def _slice(a, lo: int, hi: int):
    return type(a)(*[x[lo:hi] for x in a])


class _IncrementalPack:
    """What both packs share: the generation and count bookkeeping, the
    repack on a generation bump, the tail-only append and the cached
    window slice, in one place so the binned and raw routes cannot
    drift apart."""

    def __init__(self, max_leaves: int, device):
        self.max_leaves = max(int(max_leaves), 2)
        self.device = torch.device(device)
        self.gen = None
        self.count = 0
        self.stacked = None
        self.depths: List[int] = []
        self._win = None          # ((gen, lo, hi), window, steps)

    def _reset(self, gen) -> None:
        self.gen = gen
        self.count = 0
        self.stacked = None
        self.depths = []
        self._win = None

    def _start_sync(self, models: List[HostTree], gen) -> List[HostTree]:
        """Repack from scratch on a generation bump, a shrunk model list
        or a tree larger than the pack's width; returns the trees still
        to append."""
        cap = max([t.num_leaves for t in models] + [2])
        if gen != self.gen or self.count > len(models) or \
                cap > self.max_leaves:
            self.max_leaves = max(cap, self.max_leaves)
            self._reset(gen)
        return models[self.count:]

    def _append(self, models: List[HostTree], tail_stacked,
                tail: List[HostTree]) -> None:
        # build everything first, then assign: a failure on the way (the
        # injected publish_fail site, a real allocation failure) leaves
        # the pack as it was, so a publish that dies here rolls back
        faults.maybe_fail("publish_fail")
        stacked = _concat(self.stacked, tail_stacked)
        depths = self.depths + [min(t.max_depth, self.max_leaves - 1)
                                for t in tail]
        self.stacked = stacked
        self.depths = depths
        self.count = len(models)
        self._win = None

    def window(self, lo: int, hi: int):
        """The [hi-lo, ...] forest slice and its traversal step bound."""
        key = (self.gen, lo, hi)
        if self._win is not None and self._win[0] == key:
            return self._win[1], self._win[2]
        win = _slice(self.stacked, lo, hi)
        steps = depth_steps(max(self.depths[lo:hi]), self.max_leaves)
        self._win = (key, win, steps)
        return win, steps


def mapper_arrays(mappers):
    """Per used feature: ``(num_bin, missing type, default bin)`` as host
    int64 arrays, what ``pack_binned_tree`` folds into each node, and the
    words of a categorical node's bitset over bins: enough for the most
    bins of a categorical feature, 0 without one. Every tree packed with
    these mappers has that width, so packs stack."""
    cat_bins = [m.num_bin for m in mappers if m.bin_type == "categorical"]
    return (np.asarray([m.num_bin for m in mappers], np.int64),
            np.asarray([MISSING_ENUM[m.missing_type] for m in mappers],
                       np.int64),
            np.asarray([m.default_bin for m in mappers], np.int64),
            (max(cat_bins) + 31) // 32 if cat_bins else 0)


def pack_binned_tree(t: HostTree, max_leaves: int, feat_nbin: np.ndarray,
                     feat_miss: np.ndarray, feat_dflt: np.ndarray,
                     cat_width: int = 0) -> dict:
    """Binned serving arrays of one host tree, padded to ``max_leaves``:
    each node's missing routing folded into ``special``/``flip`` (see
    ``ops/predict.forest_leaf_bins``) from the per-feature arrays of
    ``mapper_arrays``, and each categorical node's set of bins
    (``cat_bins_inner``) as ``cat_width`` bitset words."""
    L = max_leaves
    li = L - 1
    ni = max(int(t.num_leaves) - 1, 0)
    special = np.full(li, -1, np.int32)
    flip = np.zeros(li, bool)
    is_cat = np.zeros(li, bool)
    words = np.zeros((li, cat_width), np.uint32)
    if ni and cat_width:
        is_cat[:ni] = (np.asarray(t.decision_type[:ni]) & 1) != 0
        for i in np.flatnonzero(is_cat[:ni]):
            b = t.cat_bins_inner[i, :t.cat_count_inner[i]].astype(np.int64)
            np.bitwise_or.at(words[i], b >> 5,
                             np.left_shift(np.uint32(1),
                                           (b & 31).astype(np.uint32)))
    if ni:
        f = np.asarray(t.split_feature_inner[:ni], np.int64)
        miss = feat_miss[f]
        sp = np.where(
            miss == MISSING_ENUM["nan"], feat_nbin[f] - 1,
            np.where(miss == MISSING_ENUM["zero"], feat_dflt[f], -1))
        thr = np.asarray(t.threshold_bin[:ni], np.int64)
        dl = np.asarray(t.default_left[:ni], bool)
        special[:ni] = np.where(is_cat[:ni], -1, sp)
        flip[:ni] = (special[:ni] >= 0) & (dl != (sp <= thr))
    return dict(
        split_feature=_pad(t.split_feature_inner[:ni], li, np.int64),
        threshold_bin=_pad(t.threshold_bin[:ni], li, np.int32),
        special=special, flip=flip,
        left_child=_pad(t.left_child[:ni], li, np.int64),
        right_child=_pad(t.right_child[:ni], li, np.int64),
        leaf_value=_pad(t.leaf_value[:int(t.num_leaves)], L, np.float32),
        num_leaves=np.int64(t.num_leaves),
        is_cat=is_cat, cat_words=words.view(np.int32))


class ForestPack(_IncrementalPack):
    """Stacked forest for BINNED traversal, kept in sync incrementally:
    the same generation and more trees appends only the tail; a
    generation bump (a destructive change of the model list) repacks.
    A window is a leading-axis slice of the one packed forest."""

    def __init__(self, max_leaves: int, device):
        super().__init__(max_leaves, device)
        self._mapper_src = None   # per-feature host arrays for special/flip

    def _set_mappers(self, mappers) -> None:
        if mappers is self._mapper_src:
            return
        self._mapper_src = mappers
        self._feat = mapper_arrays(mappers)

    def _pack_tree(self, t: HostTree) -> dict:
        return pack_binned_tree(t, self.max_leaves, *self._feat)

    def sync(self, models: List[HostTree], gen, mappers) -> None:
        self._set_mappers(mappers)
        tail = self._start_sync(models, gen)
        if not tail:
            return
        packed = [self._pack_tree(t) for t in tail]
        self._append(models,
                     upload_trees(BinnedTreeArrays, packed, self.device),
                     tail)


def _host_tree_to_raw(t: HostTree, max_leaves: int) -> dict:
    """Raw serving arrays of one host tree (ORIGINAL columns, the
    per-node missing type from decision_type bits 2-3, f32_floor
    thresholds)."""
    li = max_leaves - 1
    ni = max(int(t.num_leaves) - 1, 0)
    thr = np.zeros(li, np.float32)
    thr[:ni] = f32_floor(t.threshold_real[:ni])
    miss = np.zeros(li, np.int32)
    miss[:ni] = (np.asarray(t.decision_type[:ni], np.int32) >> 2) & 3
    return dict(
        split_feature=_pad(t.split_feature[:ni], li, np.int64),
        threshold=thr,
        default_left=_pad(t.default_left[:ni], li, bool),
        missing_type=miss,
        left_child=_pad(t.left_child[:ni], li, np.int64),
        right_child=_pad(t.right_child[:ni], li, np.int64),
        leaf_value=_pad(t.leaf_value[:int(t.num_leaves)], max_leaves,
                        np.float32),
        num_leaves=np.int64(t.num_leaves))


class RawForestPack(_IncrementalPack):
    """Incrementally packed stacked forest for RAW traversal (a model
    without the training bin mappers). Numerical nodes only: a tree
    loaded from text may hold categorical ones (``check_servable``)."""

    @staticmethod
    def check_servable(models: List[HostTree]) -> None:
        """``DeviceRouteUnavailable`` for an empty window or a tree with
        a categorical node: bitset membership stays on the host walk."""
        if not models:
            raise DeviceRouteUnavailable("device prediction needs a "
                                         "non-empty tree range")
        if any(t.num_cat > 0 for t in models):
            raise DeviceRouteUnavailable(
                "raw device prediction does not cover categorical splits "
                "(bitset membership stays on the host walk)")

    def sync(self, models: List[HostTree], gen) -> None:
        tail = self._start_sync(models, gen)
        if not tail:
            return
        arrs = [_host_tree_to_raw(t, self.max_leaves) for t in tail]
        self._append(models, upload_trees(RawTreeArrays, arrs, self.device),
                     tail)


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def _accumulate_iters(acc: torch.Tensor, outs: torch.Tensor,
                      t0: int) -> torch.Tensor:
    """Add the [T, R] leaf values of trees t0 .. t0+T-1 into acc [k, R]
    one tree at a time, in iteration order: ``acc[c] += outs[i]`` for
    tree i of output c. Deliberately not ``.sum(0)``, whose association
    depends on the shape: a fixed sequential order is what the JAX
    package's device scores use too."""
    k = acc.shape[0]
    for i in range(outs.shape[0]):
        c = (t0 + i) % k
        acc[c] = acc[c] + outs[i]
    return acc


def _chunks(n_trees: int, rows: int):
    step = max(1, WALK_ELEMS // max(rows, 1))
    for lo in range(0, n_trees, step):
        yield lo, min(n_trees, lo + step)


def _forest_scores_binned(num_steps: int, k_trees: int,
                          packed: BinnedTreeArrays,
                          bins_t: torch.Tensor) -> torch.Tensor:
    """[k, R] f32 raw scores of a packed window over [F, R] bins."""
    R = bins_t.shape[1]
    acc = torch.zeros((k_trees, R), dtype=torch.float32,
                      device=bins_t.device)
    for lo, hi in _chunks(packed.leaf_value.shape[0], R):
        p = _slice(packed, lo, hi)
        leaf = forest_leaf_bins(p, bins_t, num_steps=num_steps)
        _accumulate_iters(acc, p.leaf_value.gather(1, leaf), lo)
    return acc


def _forest_scores_raw(num_steps: int, k_trees: int,
                       stacked: RawTreeArrays,
                       x: torch.Tensor) -> torch.Tensor:
    """[k, R] f32 raw scores of a packed raw window over [R, C] values."""
    R = x.shape[0]
    x_t = x.T.contiguous()
    acc = torch.zeros((k_trees, R), dtype=torch.float32, device=x.device)
    for lo, hi in _chunks(stacked.leaf_value.shape[0], R):
        s = _slice(stacked, lo, hi)
        leaf = _leaf_raw_t(s, x_t, num_steps=num_steps)
        _accumulate_iters(acc, s.leaf_value.gather(1, leaf), lo)
    return acc


class Replicas(tuple):
    """One copy of a window per device of a serving mesh
    (``serving/mesh.replicate``), in the mesh's order."""


class ForestSnapshot(NamedTuple):
    """Serving state frozen for one request: the sliced device forest,
    its traversal bound and the binner, with no reference back to the
    mutable packs, so a dispatcher can keep serving one snapshot while a
    publisher builds the next (a response is attributable to exactly one
    snapshot, never a torn pack)."""
    kind: str                     # "binned" | "raw"
    win: object                   # stacked [T, ...] window, or Replicas
    steps: int                    # traversal step bound
    k: int                        # trees per iteration (output channels)
    n_trees: int                  # trees inside the window
    binner: Optional[DeviceBinner]  # binned route only
    device: torch.device


def raw_request(X: np.ndarray, what: str = "serving") -> np.ndarray:
    """A request as f32 for the raw route; ``DeviceRouteUnavailable``
    when a value only f64 holds (it could cross a split threshold under
    f32 rounding)."""
    x = X.astype(np.float32)
    with np.errstate(invalid="ignore"):
        f32_ok = (x.astype(np.float64) == X) | np.isnan(X)
    if not f32_ok.all():
        raise DeviceRouteUnavailable(
            f"raw device {what} needs float32-representable requests "
            f"({int((~f32_ok).sum())} value(s) are f64-only and could "
            "cross a split threshold under f32 rounding)")
    return x


def placed_parts(operand: torch.Tensor, rows_axis: int, win, place):
    """``[(window, operand part)]``: the whole operand against the
    window without ``place``; with it, the parts ``place(operand,
    rows_axis)`` splits the rows into, each against the window copy of
    its device (the same window for every part when it is not a
    :class:`Replicas`)."""
    if place is None:
        return [(win, operand)]
    parts = place(operand, rows_axis)
    wins = list(win) if isinstance(win, Replicas) else [win] * len(parts)
    return list(zip(wins, parts))


def snapshot_scores(snap: ForestSnapshot, X: np.ndarray,
                    place=None) -> np.ndarray:
    """[K, R] f64 raw scores (f32 sums) for one frozen snapshot.

    Touches no engine or pack state, so it is safe beside
    ``ServingEngine.snapshot`` building the next snapshot. ``place``
    (optional ``f(tensor, rows_axis) -> [tensor, ...]``, the serving
    mesh's ``shard_rows``) splits the request's rows over the devices;
    each part is scored against its device's window copy and the scores
    are concatenated in row order."""
    if snap.kind == "binned":
        operand, axis = snap.binner.bins(X), 1
        score = _forest_scores_binned
    else:
        operand = torch.as_tensor(raw_request(X), device=snap.device)
        axis, score = 0, _forest_scores_raw
    outs = [score(snap.steps, snap.k, w, part).cpu().numpy()
            for w, part in placed_parts(operand, axis, snap.win, place)]
    out = outs[0] if len(outs) == 1 else np.concatenate(outs, axis=1)
    return out.astype(np.float64)


def snapshot_leaves(snap: ForestSnapshot, X: np.ndarray) -> np.ndarray:
    """[T, R] int64 leaf index of every row in every tree of the window,
    by the same device walk as ``snapshot_scores``."""
    if snap.kind == "binned":
        bins = snap.binner.bins(X)
        leaf = forest_leaf_bins(snap.win, bins, num_steps=snap.steps)
    else:
        x_t = torch.as_tensor(np.ascontiguousarray(X.T, np.float32),
                              device=snap.device)
        leaf = _leaf_raw_t(snap.win, x_t, num_steps=snap.steps)
    return leaf.cpu().numpy()


class ServingEngine:
    """Per-model serving state: the device binner and the packed forests,
    keyed by the model-generation counter of the owning engine
    (models/gbdt.py), and the device TreeSHAP path packs, made at the
    first explanation (predict-only use never pays for them)."""

    def __init__(self, max_leaves: int, k_per_iter: int, device):
        self.k = max(int(k_per_iter), 1)
        self.device = torch.device(device)
        self.pack = ForestPack(max_leaves, self.device)
        self.raw_pack = RawForestPack(max_leaves, self.device)
        self.binner: Optional[DeviceBinner] = None
        self._binner_src = None
        self.shap_pack = None
        self.raw_shap_pack = None

    def _binner_for(self, mappers, used_feature_map) -> DeviceBinner:
        if self.binner is None or self._binner_src is not mappers:
            self.binner = DeviceBinner(mappers, used_feature_map,
                                       self.device)
            self._binner_src = mappers
        return self.binner

    def snapshot(self, models, gen, lo: int, hi: int, mappers=None,
                 used_feature_map=None,
                 place_window=None) -> ForestSnapshot:
        """Sync the right pack and freeze the [lo, hi) window: with
        ``mappers`` the binned route, without them the raw route.
        ``place_window`` (optional ``f(window) -> window``) copies the
        window to a serving mesh's devices. Callers serialize
        ``snapshot`` (it changes pack state); ``snapshot_scores`` on its
        result needs no lock."""
        if not models[lo:hi]:
            raise DeviceRouteUnavailable("serving snapshot needs a "
                                         "non-empty tree range")
        if any(t.is_linear for t in models[lo:hi]):
            # linear leaves read raw features on the host (ref: the JAX
            # package's ops/forest.py:381-383)
            raise DeviceRouteUnavailable(LINEAR_TREES_ON_HOST)
        if mappers is not None:
            self.pack.sync(models, gen, mappers)
            binner = self._binner_for(mappers, used_feature_map)
            win, steps = self.pack.window(lo, hi)
            kind = "binned"
        else:
            # a categorical node's bitset is over raw categories, which
            # the raw walk cannot test (ref: the JAX package's
            # ops/forest.py:738)
            RawForestPack.check_servable(models[lo:hi])
            self.raw_pack.sync(models, gen)
            win, steps = self.raw_pack.window(lo, hi)
            kind, binner = "raw", None
        if place_window is not None:
            win = place_window(win)
        return ForestSnapshot(kind, win, steps, self.k, hi - lo, binner,
                              self.device)

    def snapshot_shap(self, models, gen, lo: int, hi: int,
                      n_features: int, mappers=None, used_feature_map=None,
                      place_window=None):
        """Sync the right SHAP path pack and freeze an explanation
        snapshot of the [lo, hi) window (``ops/shap_pack.py``), with the
        route and thread contract of ``snapshot``. A model with linear
        trees or categorical splits raises ``DeviceRouteUnavailable``:
        its explanation is the host walk's."""
        from . import shap_pack as _sp
        if not models[lo:hi]:
            raise DeviceRouteUnavailable("explanation snapshot needs a "
                                         "non-empty tree range")
        if mappers is not None:
            pack = self.shap_pack
            if pack is None or pack.n_features != n_features:
                pack = _sp.ShapForestPack(self.pack.max_leaves, n_features,
                                          self.device)
            pack.sync(models, gen, mappers)   # may refuse (eligibility)
            self.shap_pack = pack             # ... so assign after
            binner = self._binner_for(mappers, used_feature_map)
            kind = "binned"
        else:
            pack = self.raw_shap_pack
            if pack is None or pack.n_features != n_features:
                pack = _sp.RawShapPack(self.raw_pack.max_leaves, n_features,
                                       self.device)
            pack.sync(models, gen)
            self.raw_shap_pack = pack
            kind, binner = "raw", None
        return pack.snapshot(lo, hi, kind, self.k, binner, place_window)

    def explain_binned(self, models, gen, X: np.ndarray, lo: int, hi: int,
                       mappers, used_feature_map,
                       n_features: int) -> np.ndarray:
        """[R, (F+1)*K] f64 contributions (f32 path algebra) over the
        binned route."""
        from . import shap_pack as _sp
        return _sp.shap_snapshot_scores(
            self.snapshot_shap(models, gen, lo, hi, n_features, mappers,
                               used_feature_map), X)

    def explain_raw(self, models, gen, X: np.ndarray, lo: int, hi: int,
                    n_features: int) -> np.ndarray:
        """The raw-route counterpart of ``explain_binned``, with the same
        refusal of f64-only request values as ``predict_raw``."""
        from . import shap_pack as _sp
        return _sp.shap_snapshot_scores(
            self.snapshot_shap(models, gen, lo, hi, n_features), X)

    def predict_binned(self, models, gen, X: np.ndarray, lo: int, hi: int,
                       mappers, used_feature_map) -> np.ndarray:
        """[K, R] f32-accumulated raw scores over the binned route."""
        return snapshot_scores(self.snapshot(models, gen, lo, hi, mappers,
                                             used_feature_map), X)

    def predict_raw(self, models, gen, X: np.ndarray, lo: int,
                    hi: int) -> np.ndarray:
        """[K, R] f32-accumulated raw scores over the raw-threshold route;
        f64-only request values are refused (DeviceRouteUnavailable)."""
        return snapshot_scores(self.snapshot(models, gen, lo, hi), X)


# ---------------------------------------------------------------------------
# the fleet layer (ref: the JAX package's ops/forest.py:443-694): tenants
# are grouped into shape buckets, so a hundred mixed-shape models never
# all pad to the largest one. Each bucket holds one stacked mega-pack, in
# which every tenant owns a fixed window of ``win_slots`` tree slots (the
# slots past its trees hold zero trees); a coalesced batch of one bucket
# is scored by one call, each row walking its own tenant's window.
# ---------------------------------------------------------------------------

def pow2_cap(n: int, lo: int = 1) -> int:
    """Smallest power of two >= max(n, lo): the capacity rule of leaf
    caps, feature caps and window slots."""
    m = max(int(n), int(lo), 1)
    return 1 << (m - 1).bit_length()


class TenantShape(NamedTuple):
    """The bucket key of one tenant's model: tenants with equal keys share
    one mega-pack. Every field is a capacity, so near-equal shapes
    across a fleet collapse onto a few buckets."""
    kind: str       # "binned" | "raw"
    k: int          # trees per iteration (output channels)
    steps: int      # traversal bound (depth_steps, a multiple of 4)
    leaf_cap: int   # pow2 cap of num_leaves
    feat_cap: int   # pow2 cap of the feature axis (used features for
    #                 binned, original columns for raw)
    win_slots: int  # the tenant's window in tree slots (k * pow2)


def tenant_shape(models: List[HostTree], k: int, n_features: int,
                 kind: str) -> TenantShape:
    """The bucket of one tenant's model list; ``n_features`` is the
    length of the feature axis its requests are laid out on (used
    features for the binned route, original columns for raw)."""
    leaf_cap = pow2_cap(max([int(t.num_leaves) for t in models] + [2]), 4)
    max_d = max(min(int(t.max_depth), leaf_cap - 1) for t in models)
    steps = max(depth_steps(max_d, leaf_cap), 4)
    k = max(int(k), 1)
    iters = -(-len(models) // k)
    return TenantShape(kind=kind, k=k, steps=steps, leaf_cap=leaf_cap,
                       feat_cap=pow2_cap(n_features, 4),
                       win_slots=k * pow2_cap(iters, 1))


def pad_window(stacked, win_slots: int):
    """A host-stacked ``[T, ...]`` window padded to ``win_slots`` slots
    with zero trees (0 leaves: inactive, and the fleet scorers mask the
    dead slots out of the sums anyway)."""
    t = stacked[0].shape[0]
    if t > win_slots:
        raise ValueError(f"window of {t} trees exceeds its capacity "
                         f"bucket ({win_slots} slots)")
    if t == win_slots:
        return stacked
    return type(stacked)(*[
        np.concatenate([a, np.zeros((win_slots - t,) + a.shape[1:],
                                    a.dtype)]) for a in stacked])


def _refuse_linear(models: List[HostTree]) -> None:
    if any(t.is_linear for t in models):
        raise DeviceRouteUnavailable(LINEAR_TREES_ON_HOST)


def pack_window_binned(models: List[HostTree], mappers,
                       shape: TenantShape) -> BinnedTreeArrays:
    """One tenant's binned window as a host ``BinnedTreeArrays``
    ``[win_slots, ...]`` at the bucket's leaf cap, each categorical
    node's bitset in the words its own mappers need."""
    _refuse_linear(models)
    feat = mapper_arrays(mappers)
    return pad_window(_stack(BinnedTreeArrays, [
        pack_binned_tree(t, shape.leaf_cap, *feat) for t in models]),
        shape.win_slots)


def pack_window_raw(models: List[HostTree],
                    shape: TenantShape) -> RawTreeArrays:
    """One tenant's raw window as a host ``RawTreeArrays``
    ``[win_slots, ...]``; a linear or categorical model is refused
    (``DeviceRouteUnavailable``)."""
    _refuse_linear(models)
    RawForestPack.check_servable(models)
    return pad_window(_stack(RawTreeArrays, [
        _host_tree_to_raw(t, shape.leaf_cap) for t in models]),
        shape.win_slots)


def window_cat_width(win) -> int:
    """Bitset words a categorical node of a binned window holds (0
    without a categorical feature)."""
    return int(win.cat_words.shape[2])


def widen_window(win: BinnedTreeArrays, width: int) -> BinnedTreeArrays:
    """A host binned window with its bitsets widened to ``width`` words
    (zero words: bins past a tenant's own words are in no set, as
    before), so the windows of one bucket stack (the JAX package's
    serving/fleet.py ``_widen_window_np``)."""
    have = window_cat_width(win)
    if have >= width:
        return win
    w = win.cat_words
    pad = np.zeros(w.shape[:2] + (width - have,), w.dtype)
    return win._replace(cat_words=np.concatenate([w, pad], axis=2))


def _arrays(tree):
    if tree is None:
        return
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        yield tree
        return
    for x in tree:
        yield from _arrays(x)


def pytree_nbytes(tree) -> int:
    """Bytes of every array of a pack (numpy or tensors; tuples nest):
    the replicate-or-shard decision's input and the ledger the memory
    budget (``tpu_serving_mem_budget_mb``) is held against."""
    return int(sum(a.nbytes if isinstance(a, np.ndarray)
                   else a.numel() * a.element_size() for a in _arrays(tree)))


def upload_window(host, device):
    """ONE upload of a host-assembled bucket pack: the fleet's upload
    point at publish and at the lazy rebuild of an evicted bucket. The
    ``oom`` site is consulted just before the transfer (a fired fault
    means nothing reached the device); ``bitflip:where=dev`` corrupts the
    device copy after it (the sign bits of slot 0's leaf outputs), the
    host pack staying intact, so a repair from it restores good bits."""
    faults.maybe_fail("oom")
    dev = to_device(host, device)
    if faults.check("bitflip", where="dev"):
        from ..robustness import integrity
        from ..utils import log
        dev = integrity.corrupt_pack(dev)
        log.warning("injected bitflip: device pack corrupted (slot-0 "
                    "leaf-output sign bits)")
    return dev


def _fleet_scores(walk, num_steps: int, k_trees: int, win_slots: int,
                  packed, lo: torch.Tensor, n_live: torch.Tensor,
                  cols: torch.Tensor) -> torch.Tensor:
    """[k, R] f32 scores of one coalesced batch of a bucket: row r sums
    the trees of its window ``lo[r] .. lo[r] + n_live[r]`` in slot order,
    each added as ``torch.where(slot < n_live, acc + v, acc)`` so a dead
    slot leaves the sum untouched (no ``+0.0`` that could turn -0.0).
    That is ``_accumulate_iters``' sequence of f32 adds for the tenant's
    own window, so a tenant's fleet scores are its own device scores bit
    for bit. The slots are walked together as a ``[W, R]`` node matrix,
    in chunks of at most ``WALK_ELEMS`` elements."""
    R = cols.shape[1]
    L = packed.leaf_value.shape[1]
    leaf_values = packed.leaf_value.reshape(-1)
    acc = torch.zeros((k_trees, R), dtype=torch.float32, device=cols.device)
    for s0, s1 in _chunks(win_slots, R):
        slots = torch.arange(s0, s1, device=cols.device)[:, None]
        tid = lo[None, :] + slots                             # [W, R]
        leaf = walk(packed, tid, cols, num_steps)
        v = leaf_values[tid * L + leaf]
        live = slots < n_live[None, :]
        for i in range(s1 - s0):
            c = (s0 + i) % k_trees
            acc[c] = torch.where(live[i], acc[c] + v[i], acc[c])
    return acc


def _fleet_scores_binned(num_steps: int, k_trees: int, win_slots: int,
                         packed: BinnedTreeArrays, lo: torch.Tensor,
                         n_live: torch.Tensor,
                         bins_t: torch.Tensor) -> torch.Tensor:
    """[k, R] f32 raw scores of one coalesced multi-tenant batch (the JAX
    package's ops/forest.py:455): ``packed`` the bucket's mega-pack,
    ``lo``/``n_live`` int64 [R] each row's window start and live trees,
    ``bins_t`` [F, R] bins in each row's own tenant layout."""
    return _fleet_scores(fleet_leaf_bins, num_steps, k_trees, win_slots,
                         packed, lo, n_live, bins_t)


def _fleet_scores_raw(num_steps: int, k_trees: int, win_slots: int,
                      stacked: RawTreeArrays, lo: torch.Tensor,
                      n_live: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The raw-route ``_fleet_scores_binned`` (the JAX package's
    ops/forest.py:480) over f32 values ``x`` [R, C]."""
    return _fleet_scores(fleet_leaf_raw, num_steps, k_trees, win_slots,
                         stacked, lo, n_live, x.T.contiguous())
