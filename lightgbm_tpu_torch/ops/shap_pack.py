"""Device TreeSHAP over packed path tensors.

Port of ``lightgbm_tpu/ops/shap_pack.py`` (its single-model half;
GPUTreeShap's observation, Mitchell et al., 2022): Lundberg's recursive
TreeSHAP walks one (row, tree) pair at a time, but every quantity of the
recursion except the row's hot or cold branch at each node depends only
on the TREE. So each tree's root-to-leaf paths are enumerated ONCE on the
host into padded ``[trees, leaves, depth]`` arrays — per element the phi
slot, the hot-membership compare constants (the bin interval and the
missing-fold special bin for the binned route, ``f32_floor`` threshold
intervals and the node's missing type for the raw route), the zero
(cover) fraction and the leaf value — and the device evaluates path
membership for a whole batch and accumulates each feature's phi by the
*unwound-weight* closed form. The host packing here gives the JAX
package's arrays bit for bit.

Why fixed-depth padding is exact: the EXTEND polynomial is a symmetric
function of the element multiset, and extending with a (zero=1, one=1)
"dummy" element preserves every other element's unwound path sum, while
the dummy's own contribution carries ``one - zero == 0``. Feature dedup
is resolved at pack time: the net effect of a feature repeated along a
path is one element whose zero fraction is the product of its cover
ratios and whose membership is the conjunction of its hot indicators,
stored as a merged compare interval.

The device side (``shap_snapshot_scores``) flattens a window's live
paths to ``[P, D]`` and runs the dense EXTEND/UNWIND recursion over
``[P, D, R]`` tensors for a chunk of paths and rows at once (chunks
bounded by ``SHAP_ELEMS``), not a loop over trees; D is cut to the
longest path's unique features (trailing dummies change no
contribution). Each (path, element) contribution is added into its phi
slot by a one-hot product in float64, whose order of addition is fixed,
so a replay gives the same bits (an ``index_add_`` on CUDA adds in the
order its atomics land). Contributions are f32 algebra against the host
walk's f64 recursion (``core/shap.py``): within rtol 1e-4 / atol 1e-5.

Linear trees and categorical splits are not covered
(:func:`check_explainable` raises ``DeviceRouteUnavailable``; the Booster
answers by the host walk).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..core.shap import _expected_value, _subtree_weight
from ..core.tree import HostTree
from .forest import (DeviceBinner, DeviceRouteUnavailable, _IncrementalPack,
                     f32_floor, mapper_arrays, placed_parts, raw_request)
from .predict import K_ZERO_THRESHOLD_F32, depth_steps
from .split import MISSING_ENUM

_I32_MAX = np.iinfo(np.int32).max
_MT_DUMMY = 3  # missing-type sentinel: element is always-hot padding
# elements of one [P, D, R] chunk of the recursion (about seven float32
# tensors of this size are alive at once)
SHAP_ELEMS = 1 << 24


def check_explainable(models: List[HostTree]) -> None:
    """Model-level eligibility for the device TreeSHAP routes: linear
    leaves change the value function itself and categorical splits keep
    bitset membership on the host; both raise ``DeviceRouteUnavailable``
    (a ValueError) and are explained by the host walk."""
    if any(t.is_linear for t in models):
        raise DeviceRouteUnavailable("device TreeSHAP does not cover "
                                     "linear trees")
    if any(t.num_cat > 0 for t in models):
        raise DeviceRouteUnavailable(
            "device TreeSHAP does not cover categorical splits (bitset "
            "membership stays on the host path)")


# ---------------------------------------------------------------------------
# host path enumeration + per-tree packing (the JAX package's arrays)
# ---------------------------------------------------------------------------

class ShapPathsBinned(NamedTuple):
    """Packed root->leaf paths of a BINNED-route window, [T, L, D] per
    element field. Dummy elements (path shorter than D, padded leaves,
    stump trees) are (zero=1, one=1) and go to the bias slot."""
    pfeat: object   # i32 [T, L, D] phi slot (ORIGINAL feature)
    bfeat: object   # i32 [T, L, D] bin gather index (inner feature)
    blo: object     # i32 [T, L, D] member iff blo < bin <= bhi ...
    bhi: object     # i32 [T, L, D]
    sp: object      # i32 [T, L, D] ... except bin == sp >= 0 -> spin
    spin: object    # bool [T, L, D]
    zf: object      # f32 [T, L, D] zero (cover) fraction
    leaf_v: object  # f32 [T, L]
    expv: object    # f32 [T] expected value (stump: its leaf value)
    biasi: object   # i32 [T] bias slot (= n_features)


class ShapPathsRaw(NamedTuple):
    """Raw-route counterpart: f32_floor threshold intervals on ORIGINAL
    columns, per-element missing type. Member iff flo <= v <= fhi on
    the non-missing route (flo advanced one ulp past the strict
    went-right bound, so >= is the exact f32 compare)."""
    pfeat: object   # i32 [T, L, D]
    rfeat: object   # i32 [T, L, D] raw column gather index
    flo: object     # f32 [T, L, D]
    fhi: object     # f32 [T, L, D]
    mtype: object   # i32 [T, L, D] MISSING_ENUM or _MT_DUMMY
    missin: object  # bool [T, L, D] membership when the value is missing
    zf: object      # f32 [T, L, D]
    leaf_v: object  # f32 [T, L]
    expv: object    # f32 [T]
    biasi: object   # i32 [T]


def _leaf_paths(t: HostTree):
    """Per leaf: the (internal node, went_left) pairs on its root path,
    in root->leaf order (host DFS, deterministic)."""
    out = [[] for _ in range(int(t.num_leaves))]
    if t.num_leaves <= 1:
        return out
    stack = [(0, ())]
    while stack:
        node, path = stack.pop()
        if node < 0:
            out[-(node + 1)] = list(path)
            continue
        stack.append((int(t.left_child[node]), path + ((node, True),)))
        stack.append((int(t.right_child[node]), path + ((node, False),)))
    return out


class _Elem:
    __slots__ = ("orig", "z", "member", "lo", "hi", "mt")

    def __init__(self, orig):
        self.orig = orig
        self.z = 1.0          # product of cover ratios (f64 until stored)
        self.member = True    # conjunction of missing-route hot bits
        self.lo = None        # route-specific interval, set by caller
        self.hi = None
        self.mt = None


def _merge_path(t: HostTree, path, key, new_elem, update):
    """One leaf's path merged to one element per unique ``key(node)``,
    in first-seen order: cover ratios multiplied, missing-route hot bits
    and'ed, intervals narrowed by ``update``."""
    merged, order = {}, []
    for node, went_left in path:
        kf = key(node)
        e = merged.get(kf)
        if e is None:
            e = merged[kf] = new_elem(node)
            order.append(kf)
        child = int(t.left_child[node] if went_left
                    else t.right_child[node])
        w_node = _subtree_weight(t, node)
        e.z *= (_subtree_weight(t, child) / w_node) if w_node else 0.0
        e.member &= bool(t.default_left[node]) == went_left
        update(e, node, went_left)
    return [(kf, merged[kf]) for kf in order]


def _pack_tree_shap_binned(t: HostTree, max_leaves: int, depth: int,
                           n_features: int, feat_nbin, feat_miss,
                           feat_dflt) -> ShapPathsBinned:
    L, D = max_leaves, depth
    pfeat = np.full((L, D), n_features, np.int32)
    bfeat = np.zeros((L, D), np.int32)
    blo = np.full((L, D), -1, np.int32)
    bhi = np.full((L, D), _I32_MAX, np.int32)
    sp = np.full((L, D), -1, np.int32)
    spin = np.zeros((L, D), bool)
    zf = np.ones((L, D), np.float32)
    leaf_v = np.zeros(L, np.float32)
    if t.num_leaves <= 1:
        ev = float(t.leaf_value[0]) if t.num_leaves else 0.0
        return ShapPathsBinned(pfeat, bfeat, blo, bhi, sp, spin, zf,
                               leaf_v, np.float32(ev),
                               np.int32(n_features))

    def new_elem(node):
        e = _Elem(int(t.split_feature[node]))
        e.lo, e.hi = -1, _I32_MAX
        return e

    def update(e, node, went_left):
        thr = int(t.threshold_bin[node])
        if went_left:
            e.hi = min(e.hi, thr)
        else:
            e.lo = max(e.lo, thr)

    for leaf, path in enumerate(_leaf_paths(t)):
        leaf_v[leaf] = np.float32(t.leaf_value[leaf])
        elems = _merge_path(t, path,
                            lambda n: int(t.split_feature_inner[n]),
                            new_elem, update)
        if len(elems) > D:
            raise ValueError(f"leaf path with {len(elems)} unique "
                             f"features exceeds depth cap {D}")
        for j, (fi, e) in enumerate(elems):
            pfeat[leaf, j] = e.orig
            bfeat[leaf, j] = fi
            blo[leaf, j] = e.lo
            bhi[leaf, j] = e.hi
            m = int(feat_miss[fi])
            sp[leaf, j] = (int(feat_nbin[fi]) - 1
                           if m == MISSING_ENUM["nan"]
                           else int(feat_dflt[fi])
                           if m == MISSING_ENUM["zero"] else -1)
            spin[leaf, j] = e.member
            zf[leaf, j] = np.float32(e.z)
    return ShapPathsBinned(pfeat, bfeat, blo, bhi, sp, spin, zf, leaf_v,
                           np.float32(_expected_value(t, 0)),
                           np.int32(n_features))


def _pack_tree_shap_raw(t: HostTree, max_leaves: int, depth: int,
                        n_features: int) -> ShapPathsRaw:
    L, D = max_leaves, depth
    pfeat = np.full((L, D), n_features, np.int32)
    rfeat = np.zeros((L, D), np.int32)
    flo = np.zeros((L, D), np.float32)
    fhi = np.zeros((L, D), np.float32)
    mtype = np.full((L, D), _MT_DUMMY, np.int32)
    missin = np.ones((L, D), bool)
    zf = np.ones((L, D), np.float32)
    leaf_v = np.zeros(L, np.float32)
    if t.num_leaves <= 1:
        ev = float(t.leaf_value[0]) if t.num_leaves else 0.0
        return ShapPathsRaw(pfeat, rfeat, flo, fhi, mtype, missin, zf,
                            leaf_v, np.float32(ev), np.int32(n_features))
    thr32 = f32_floor(np.asarray(t.threshold_real))
    dtv = np.asarray(t.decision_type, np.int32)

    def new_elem(node):
        e = _Elem(int(t.split_feature[node]))
        e.lo = np.float32(-np.inf)
        e.hi = np.float32(np.inf)
        return e

    def update(e, node, went_left):
        thr = np.float32(thr32[node])
        if went_left:                      # v <= thr
            e.hi = min(e.hi, thr)
        else:                              # v > thr  <=>  v >= nextafter
            e.lo = max(e.lo, np.nextafter(thr, np.float32(np.inf)))
        if e.mt is None:
            e.mt = int(dtv[node] >> 2) & 3

    for leaf, path in enumerate(_leaf_paths(t)):
        leaf_v[leaf] = np.float32(t.leaf_value[leaf])
        elems = _merge_path(t, path, lambda n: int(t.split_feature[n]),
                            new_elem, update)
        if len(elems) > D:
            raise ValueError(f"leaf path with {len(elems)} unique "
                             f"features exceeds depth cap {D}")
        for j, (f, e) in enumerate(elems):
            pfeat[leaf, j] = e.orig
            rfeat[leaf, j] = e.orig
            flo[leaf, j] = e.lo
            fhi[leaf, j] = e.hi
            mtype[leaf, j] = e.mt
            missin[leaf, j] = e.member
            zf[leaf, j] = np.float32(e.z)
    return ShapPathsRaw(pfeat, rfeat, flo, fhi, mtype, missin, zf,
                        leaf_v, np.float32(_expected_value(t, 0)),
                        np.int32(n_features))


# ---------------------------------------------------------------------------
# incremental SHAP packs: appended like ForestPack, so a publish never
# repacks the prefix. Depth grows by widening the stacked element axis
# with (1,1) dummies; window() re-slices to the WINDOW's depth_steps
# bound, which makes an incremental window equal to a full repack bit
# for bit (a window depends only on the trees inside it).
# ---------------------------------------------------------------------------

_BINNED_FILLS = {"pfeat": None, "bfeat": 0, "blo": -1, "bhi": _I32_MAX,
                 "sp": -1, "spin": False, "zf": 1.0}
_RAW_FILLS = {"pfeat": None, "rfeat": 0, "flo": 0.0, "fhi": 0.0,
              "mtype": _MT_DUMMY, "missin": True, "zf": 1.0}


def _widen_depth(stacked, new_d: int, fills, n_features: int):
    cur = stacked.zf.shape[2]
    if cur >= new_d:
        return stacked
    T, L = stacked.zf.shape[:2]

    def pad(name, a):
        fill = fills[name]
        if fill is None:       # pfeat dummies go to the bias slot
            fill = n_features
        ext = torch.full((T, L, new_d - cur), fill, dtype=a.dtype,
                         device=a.device)
        return torch.cat([a, ext], dim=2)

    return type(stacked)(*[
        pad(f, getattr(stacked, f)) if getattr(stacked, f).dim() == 3
        else getattr(stacked, f) for f in stacked._fields])


class ShapFlatPaths(NamedTuple):
    """A window's live paths, flattened for the device recursion: [P, D]
    element fields (D cut to the longest path's unique features), with
    ``col`` each element's row of the [K * (F+1), R] phi (its tree's
    class block plus its phi slot)."""
    gfeat: torch.Tensor   # int64 [P, D] gather index (bin row / column)
    a: torch.Tensor       # [P, D, 1] blo | flo
    b: torch.Tensor       # [P, D, 1] bhi | fhi
    c: torch.Tensor       # [P, D, 1] sp | mtype
    d: torch.Tensor       # bool [P, D, 1] spin | missin
    zf: torch.Tensor      # f32 [P, D, 1]
    leaf_v: torch.Tensor  # f32 [P]
    col: torch.Tensor     # int64 [P, D]


class ShapSnapshot(NamedTuple):
    """Explanation state frozen for one request, with the hot-swap
    contract of ``ForestSnapshot``: no reference back to the mutable
    packs."""
    kind: str                       # "binned" | "raw"
    win: object                     # ShapPaths* window ([T, L, D] tensors)
    paths: object                   # ShapFlatPaths, or forest.Replicas
    bias: np.ndarray                # f64 [k]: each class's expected value
    k: int                          # trees per iteration (class blocks)
    n_trees: int
    n_features: int                 # F; phi rows are F+1 (bias last)
    binner: Optional[DeviceBinner]  # binned route only
    device: torch.device


class _ShapPackBase(_IncrementalPack):
    _fills: dict = {}
    _fields: tuple = ()

    def __init__(self, max_leaves: int, n_features: int, device):
        super().__init__(max_leaves, device)
        self.n_features = int(n_features)
        self.depth_cap = 0
        self.n_leaves: List[int] = []   # per tree, host
        self.n_elems: List[int] = []    # per tree: longest path's elements

    def _reset(self, gen) -> None:
        super()._reset(gen)
        self.depth_cap = 0
        self.n_leaves = []
        self.n_elems = []

    def _pack_tail(self, models: List[HostTree],
                   tail: List[HostTree]) -> None:
        cap = depth_steps(
            max([0] + self.depths + [min(t.max_depth, self.max_leaves - 1)
                                     for t in tail]), self.max_leaves)
        prev = self.stacked
        if prev is not None and cap > self.depth_cap:
            self.stacked = _widen_depth(prev, cap, self._fills,
                                        self.n_features)
        packed = [self._pack_tree(t, max(cap, self.depth_cap))
                  for t in tail]
        cls = type(packed[0])
        tail_t = cls(*[torch.as_tensor(np.stack([getattr(p, f)
                                                 for p in packed]),
                                       device=self.device)
                       for f in cls._fields])
        try:
            self._append(models, tail_t, tail)
        except BaseException:
            self.stacked = prev       # the append commits nothing
            raise
        self.depth_cap = max(cap, self.depth_cap)
        self.n_leaves += [int(t.num_leaves) for t in tail]
        self.n_elems += [int((p.pfeat != self.n_features).sum(1).max())
                         for p in packed]

    def window(self, lo: int, hi: int):
        """The [hi-lo, L, D] window and its own depth bound: element
        arrays re-sliced to depth_steps of the window's deepest tree,
        exactly as a pack built fresh from these trees holds them."""
        key = (self.gen, lo, hi)
        if self._win is not None and self._win[0] == key:
            return self._win[1], self._win[2]
        steps = depth_steps(max(self.depths[lo:hi]), self.max_leaves)
        win = type(self.stacked)(*[
            x[lo:hi, :, :steps] if x.dim() == 3 else x[lo:hi]
            for x in self.stacked])
        self._win = (key, win, steps)
        return win, steps

    def snapshot(self, lo: int, hi: int, kind: str, k: int,
                 binner: Optional[DeviceBinner],
                 place_window=None) -> ShapSnapshot:
        win, steps = self.window(lo, hi)
        paths = _flat_paths(win, kind, k, self.n_features,
                            self.n_leaves[lo:hi],
                            min(max(self.n_elems[lo:hi] + [1]), steps))
        if place_window is not None:
            paths = place_window(paths)
        # each class's expected values, added tree by tree in f32 as the
        # JAX package's kernel adds them into the bias slot
        expv = win.expv.cpu().numpy()
        bias = np.zeros(k, np.float32)
        for i, v in enumerate(expv):
            bias[i % k] = bias[i % k] + v
        return ShapSnapshot(kind, win, paths, bias.astype(np.float64), k,
                            hi - lo, self.n_features, binner, self.device)


def _flat_paths(win, kind: str, k: int, n_features: int,
                n_leaves: List[int], depth: int) -> ShapFlatPaths:
    """The live paths of a window (leaves of trees with a split), cut to
    ``depth`` elements, as ``ShapFlatPaths`` on the window's device."""
    T, L = win.leaf_v.shape
    dev = win.leaf_v.device
    live = [t * L + leaf for t, n in enumerate(n_leaves) if n > 1
            for leaf in range(n)]
    idx = torch.as_tensor(np.asarray(live, np.int64), device=dev)

    def flat(a, cut=True):
        a = a.reshape(T * L, *a.shape[2:]).index_select(0, idx)
        return a[:, :depth] if cut else a

    if kind == "binned":
        g, a, b, c, d = win.bfeat, win.blo, win.bhi, win.sp, win.spin
    else:
        g, a, b, c, d = win.rfeat, win.flo, win.fhi, win.mtype, win.missin
    cls = torch.as_tensor(np.asarray([i // L % k for i in live], np.int64),
                          device=dev)
    return ShapFlatPaths(
        gfeat=flat(g).long(), a=flat(a)[..., None], b=flat(b)[..., None],
        c=flat(c)[..., None], d=flat(d)[..., None],
        zf=flat(win.zf)[..., None], leaf_v=flat(win.leaf_v, cut=False),
        col=cls[:, None] * (n_features + 1) + flat(win.pfeat).long())


class ShapForestPack(_ShapPackBase):
    """Binned-route SHAP paths, packed with the training BinMappers."""

    _fills = _BINNED_FILLS

    def __init__(self, max_leaves: int, n_features: int, device):
        super().__init__(max_leaves, n_features, device)
        self._mapper_src = None

    def _set_mappers(self, mappers) -> None:
        if mappers is self._mapper_src:
            return
        self._mapper_src = mappers
        self._feat = mapper_arrays(mappers)[:3]

    def _pack_tree(self, t: HostTree, depth: int) -> ShapPathsBinned:
        return _pack_tree_shap_binned(t, self.max_leaves, depth,
                                      self.n_features, *self._feat)

    def sync(self, models: List[HostTree], gen, mappers) -> None:
        check_explainable(models)
        self._set_mappers(mappers)
        tail = self._start_sync(models, gen)
        if tail:
            self._pack_tail(models, tail)


class RawShapPack(_ShapPackBase):
    """Raw-route SHAP paths (models without the training bin mappers)."""

    _fills = _RAW_FILLS

    def _pack_tree(self, t: HostTree, depth: int) -> ShapPathsRaw:
        return _pack_tree_shap_raw(t, self.max_leaves, depth,
                                   self.n_features)

    def sync(self, models: List[HostTree], gen) -> None:
        check_explainable(models)
        tail = self._start_sync(models, gen)
        if tail:
            self._pack_tail(models, tail)


# ---------------------------------------------------------------------------
# the device recursion
# ---------------------------------------------------------------------------

def _f32(x: float) -> float:
    """``x`` rounded to f32, so a scalar factor is the JAX package's."""
    return float(np.float32(x))


def _phi_paths(obool: torch.Tensor, z: torch.Tensor,
               leaf_v: torch.Tensor) -> torch.Tensor:
    """[P, D, R] f32 contribution of each element of each path: the dense
    EXTEND recursion over the D elements, then every element's unwound
    path sum, vectorized over the element axis (the JAX package's
    ``_phi_paths`` before its scatter).

    obool: [P, D, R] hot membership (the one fraction, exactly 0 or 1);
    z: [P, D, 1] zero fractions; leaf_v: [P]."""
    P, D, R = obool.shape
    o = obool.to(torch.float32)
    p = [None] * (D + 1)
    p[0] = torch.ones((P, 1), dtype=torch.float32, device=o.device)
    for e in range(1, D + 1):
        oe = o[:, e - 1]                       # [P, R]
        ze = z[:, e - 1]                       # [P, 1]
        # i = e-1 first: p[e] starts at zero, so it is the product alone
        p[e] = oe * p[e - 1] * _f32(e / (e + 1))
        p[e - 1] = ze * p[e - 1] * _f32(1 / (e + 1))
        for i in range(e - 2, -1, -1):
            p[i + 1] = torch.addcmul(p[i + 1], oe, p[i],
                                     value=_f32((i + 1) / (e + 1)))
            p[i] = ze * p[i] * _f32((e - i) / (e + 1))
    tot = torch.zeros((P, 1, 1), dtype=torch.float32, device=o.device)
    next_one = p[D][:, None, :]
    for i in range(D - 1, -1, -1):
        c1 = _f32((D + 1) / (i + 1))
        c2 = _f32((D - i) / (D + 1))
        pi = p[i][:, None, :]
        tmp = next_one * c1                    # one_fraction == 1 branch
        tot = tot + torch.where(obool, tmp, (pi / z) / c2)
        next_one = torch.where(obool, pi - tmp * z * c2, next_one)
    return tot * (o - z) * leaf_v[:, None, None]


def _member_binned(blo, bhi, sp, spin, b):
    """Hot membership from bin intervals: the binned route's decision
    rule ((bin <= thr) XOR flip on the special bin) folded to a
    conjunction; on the special bin every merged split routes
    default_left, so membership is the precomputed bit ``spin``."""
    return torch.where((sp >= 0) & (b == sp), spin, (b > blo) & (b <= bhi))


def _member_raw(flo, fhi, mtype, missin, v):
    isnan = torch.isnan(v)
    v0 = torch.where(isnan, torch.zeros_like(v), v)
    miss = (((mtype == MISSING_ENUM["zero"])
             & (v0.abs() <= K_ZERO_THRESHOLD_F32))
            | ((mtype == MISSING_ENUM["nan"]) & isnan)
            | (mtype == _MT_DUMMY))
    return torch.where(miss, missin, (v0 >= flo) & (v0 <= fhi))


def _explain_part(paths: ShapFlatPaths, kind: str, operand: torch.Tensor,
                  slots: int) -> torch.Tensor:
    """[slots, R] f64 phi of one operand part ([F, R] bins or [C, R]
    values) over every path, in chunks of paths and rows."""
    R = operand.shape[1]
    P, D = paths.gfeat.shape
    out = torch.zeros((slots, R), dtype=torch.float64, device=operand.device)
    if P == 0 or R == 0:
        return out
    member = _member_binned if kind == "binned" else _member_raw
    pc = max(1, min(P, SHAP_ELEMS // (D * R), SHAP_ELEMS // (slots * D)))
    rc = max(1, min(R, SHAP_ELEMS // (pc * D)))
    for r0 in range(0, R, rc):
        opnd = operand[:, r0:r0 + rc]
        for p0 in range(0, P, pc):
            s = slice(p0, p0 + pc)
            obool = member(paths.a[s], paths.b[s], paths.c[s], paths.d[s],
                           opnd[paths.gfeat[s]])           # [pc, D, rc]
            contrib = _phi_paths(obool, paths.zf[s], paths.leaf_v[s])
            cols = paths.col[s].reshape(-1)
            n = cols.shape[0]
            # each element into its phi row by a one-hot product: the
            # sum's order is fixed, so a replay gives the same bits
            onehot = torch.zeros((slots, n), dtype=torch.float64,
                                 device=out.device)
            onehot[cols, torch.arange(n, device=out.device)] = 1.0
            out[:, r0:r0 + rc] += onehot @ contrib.reshape(n, -1).double()
    return out


def shap_snapshot_scores(snap: ShapSnapshot, X: np.ndarray,
                         place=None) -> np.ndarray:
    """[R, (F+1)*k] f64 contributions for one frozen snapshot, in the
    reference's pred_contrib layout (per class a block of F+1, bias
    last). Touches no pack state; ``place`` splits the rows over a
    serving mesh as in ``forest.snapshot_scores``."""
    r = X.shape[0]
    F1 = snap.n_features + 1
    if snap.kind == "binned":
        operand = snap.binner.bins(X)
    else:
        operand = torch.as_tensor(
            np.ascontiguousarray(raw_request(X, "explanation").T),
            device=snap.device)
    outs = [_explain_part(paths, snap.kind, part, snap.k * F1)
            .cpu().numpy()
            for paths, part in placed_parts(operand, 1, snap.paths, place)]
    phi = outs[0] if len(outs) == 1 else np.concatenate(outs, axis=1)
    phi = phi.reshape(snap.k, F1, r)
    phi[:, F1 - 1, :] += snap.bias[:, None]
    return np.ascontiguousarray(phi.transpose(2, 0, 1)).reshape(r, -1)
