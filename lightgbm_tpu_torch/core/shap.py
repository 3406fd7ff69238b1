"""TreeSHAP feature contributions (``predict(pred_contrib=True)``).

Copy of the numpy path of ``lightgbm_tpu/core/shap.py`` (ref:
include/LightGBM/tree.h ExpectedValue/TreeSHAP, src/io/tree.cpp TreeSHAP:
Lundberg and Lee's exact polynomial-time recursion over decision paths;
c_api.cpp PredictType kPredictContrib), on the host in f64, and the
dispatch to the row-parallel C++ kernel (``native/shap.cpp``) where the
native library loads, as the JAX package's ``predict_contrib`` does
(its core/shap.py:329-410); trees the kernel declines (linear) take the
numpy walk. The device explanation is ``ops/shap_pack.py``, held to this
walk.

The recursion runs once per tree, vectorized over rows: its branch
structure, cover ratios and feature dedup depend only on the tree, while
each row contributes which child is "hot" at every node and {0, 1}
one-fraction products (ref: src/application/predictor.hpp:31, which runs
the per-row recursion under OMP instead).
"""
from __future__ import annotations

import numpy as np

from .tree import HostTree


def _expected_value(t: HostTree, node: int) -> float:
    """Weighted mean of leaf values below node (ref: Tree::ExpectedValue)."""
    if node < 0:
        return float(t.leaf_value[-(node + 1)])
    lw = _subtree_weight(t, int(t.left_child[node]))
    rw = _subtree_weight(t, int(t.right_child[node]))
    tot = lw + rw
    if tot <= 0:
        return 0.0
    return (lw * _expected_value(t, int(t.left_child[node])) +
            rw * _expected_value(t, int(t.right_child[node]))) / tot


def _subtree_weight(t: HostTree, node: int) -> float:
    if node < 0:
        return float(t.leaf_count[-(node + 1)])
    return float(t.internal_count[node])


def _decisions_all(t: HostTree, X: np.ndarray) -> np.ndarray:
    """bool [I, N]: does each row go LEFT at each internal node?
    (vectorized _decision_path; same missing/categorical rules)."""
    n_int = len(t.split_feature)
    N = X.shape[0]
    out = np.zeros((n_int, N), bool)
    for node in range(n_int):
        f = int(t.split_feature[node])
        dt = int(t.decision_type[node])
        v = X[:, f].astype(np.float64)
        isnan = np.isnan(v)
        dl = bool(dt & 2)
        mtype = (dt >> 2) & 3
        v0 = np.where(isnan, 0.0, v)
        if dt & 1:  # categorical: bitset membership on the raw value
            out[node] = t._cat_in_bitset(
                np.full(N, node, np.int64), v0, isnan)
            continue
        res = v0 <= t.threshold_real[node]
        if mtype == 1:
            res = np.where(np.abs(v0) <= 1e-35, dl, res)
        elif mtype == 2:
            res = np.where(isnan, dl, res)
        out[node] = res
    return out


def shap_one_tree(t: HostTree, x: np.ndarray, num_features: int
                  ) -> np.ndarray:
    """phi[num_features + 1] of one row ``x``; the last slot is the
    expected value (the JAX package's per-row recursion, here the row
    walk of ``shap_tree_batch``)."""
    return shap_tree_batch(t, np.asarray(x, np.float64)[None, :],
                           num_features)[0]


def shap_tree_batch(t: HostTree, X: np.ndarray,
                    num_features: int) -> np.ndarray:
    """Exact TreeSHAP for all rows of X against one tree: [N, F+1]."""
    N = X.shape[0]
    phi = np.zeros((N, num_features + 1))
    if t.num_leaves <= 1:
        phi[:, -1] += float(t.leaf_value[0])
        return phi
    phi[:, -1] += _expected_value(t, 0)
    goes_left = _decisions_all(t, X)

    def recurse(node, d, feats, zf, of, pw, pz, po, pf):
        # copy-extend the parent path (siblings must not see mutations);
        # feats/zf are per-element scalars, of/pw are [N] rows
        feats = np.concatenate([feats[:d], [pf]])
        zf = np.concatenate([zf[:d], [pz]])
        of = np.vstack([of[:d], po[None, :]])
        pw = np.vstack([pw[:d], np.full((1, N), 1.0 if d == 0 else 0.0)])
        # EXTEND (scalar _extend, pweights vectorized over rows)
        for i in range(d - 1, -1, -1):
            pw[i + 1] += po * pw[i] * ((i + 1) / (d + 1))
            pw[i] = pz * pw[i] * ((d - i) / (d + 1))

        if node < 0:  # leaf: UNWOUND path sums -> contributions
            leaf_val = float(t.leaf_value[-(node + 1)])
            for pi in range(1, d + 1):
                one = of[pi]
                zero = zf[pi]
                next_one = pw[d].copy()
                total = np.zeros(N)
                nz = one != 0
                for i in range(d - 1, -1, -1):
                    # rows with one==0 use the zero-division-free branch
                    tmp = np.where(
                        nz, next_one * ((d + 1) / ((i + 1))), 0.0)
                    tmp = np.divide(tmp, np.where(nz, one, 1.0))
                    total += np.where(
                        nz, tmp,
                        pw[i] / (zero * ((d - i) / (d + 1))))
                    next_one = np.where(
                        nz, pw[i] - tmp * zero * ((d - i) / (d + 1)),
                        next_one)
                phi[:, feats[pi]] += (total * (one - zero) * leaf_val)
            return

        w_node = _subtree_weight(t, node)
        lc = int(t.left_child[node])
        rc = int(t.right_child[node])
        z_l = _subtree_weight(t, lc) / w_node if w_node else 0.0
        z_r = _subtree_weight(t, rc) / w_node if w_node else 0.0
        inc_z = 1.0
        inc_o = np.ones(N)
        f = int(t.split_feature[node])
        # dedup: UNWIND a previous occurrence of this feature
        pi = next((i for i in range(d + 1) if feats[i] == f), d + 1)
        if pi <= d:
            inc_z = zf[pi]
            inc_o = of[pi].copy()
            # vectorized _unwind
            one = of[pi]
            zero = zf[pi]
            nz = one != 0
            next_one = pw[d].copy()
            for i in range(d - 1, -1, -1):
                tmp_pw = pw[i].copy()
                a = np.divide(next_one * ((d + 1) / (i + 1)),
                              np.where(nz, one, 1.0))
                b = tmp_pw * ((d + 1) / (zero * (d - i)))
                pw[i] = np.where(nz, a, b)
                next_one = np.where(
                    nz, tmp_pw - pw[i] * zero * ((d - i) / (d + 1)),
                    next_one)
            feats[pi:d] = feats[pi + 1:d + 1].copy()
            zf[pi:d] = zf[pi + 1:d + 1].copy()
            of[pi:d] = of[pi + 1:d + 1].copy()
            d -= 1

        left_hot = goes_left[node]
        recurse(lc, d + 1, feats, zf, of, pw,
                z_l * inc_z, inc_o * left_hot, f)
        recurse(rc, d + 1, feats, zf, of, pw,
                z_r * inc_z, inc_o * ~left_hot, f)

    # rows with one_fraction==0 evaluate (and discard) the other
    # branch's division — identical inf/0 algebra to the scalar code,
    # without the warnings
    with np.errstate(divide="ignore", invalid="ignore"):
        recurse(0, 0, np.zeros(0, np.int64), np.zeros(0),
                np.zeros((0, N)), np.zeros((0, N)), 1.0, np.ones(N), -1)
    return phi


def _native_tree_shap(t: HostTree, X64: np.ndarray, out: np.ndarray,
                      base: int, lib) -> bool:
    """Accumulate one tree's contributions via the C++ kernel
    (native/shap.cpp — the reference's OMP-predictor architecture,
    predictor.hpp:31). Returns False if the tree shape can't go native
    (caller falls back to the numpy batch)."""
    import ctypes
    n_int = len(t.split_feature)
    if n_int == 0:
        return False
    if getattr(t, "is_linear", False):
        return False  # keep whatever the python path does for linear
    c_i32 = ctypes.POINTER(ctypes.c_int32)
    c_f64 = ctypes.POINTER(ctypes.c_double)
    c_u32 = ctypes.POINTER(ctypes.c_uint32)
    as_ = lambda a, dt: np.ascontiguousarray(a, dtype=dt)
    sf = as_(t.split_feature, np.int32)
    th = as_(t.threshold_real, np.float64)
    dt_ = as_(t.decision_type, np.int32)
    lc = as_(t.left_child, np.int32)
    rc = as_(t.right_child, np.int32)
    lv = as_(t.leaf_value, np.float64)
    lcnt = as_(t.leaf_count, np.float64)
    icnt = as_(t.internal_count, np.float64)
    num_cat = int(getattr(t, "num_cat", 0) or 0)
    if num_cat > 0:
        cb = as_(t.cat_boundaries, np.int32)
        ct = as_(t.cat_threshold, np.uint32)
        n_words = len(ct)
        cb_p = cb.ctypes.data_as(c_i32)
        ct_p = ct.ctypes.data_as(c_u32)
    else:
        cb = ct = None
        n_words = 0
        cb_p = ctypes.cast(None, c_i32)
        ct_p = ctypes.cast(None, c_u32)
    # bias column excluded: out_stride walks full rows, base offsets the
    # class block; the expected value is added by the caller
    sub = out[:, base:]
    rc_code = lib.lgbm_tree_shap_batch(
        sf.ctypes.data_as(c_i32), th.ctypes.data_as(c_f64),
        dt_.ctypes.data_as(c_i32), lc.ctypes.data_as(c_i32),
        rc.ctypes.data_as(c_i32), lv.ctypes.data_as(c_f64),
        lcnt.ctypes.data_as(c_f64), icnt.ctypes.data_as(c_f64),
        np.int32(n_int), cb_p, ct_p, np.int32(num_cat),
        np.int32(n_words), X64.ctypes.data_as(c_f64),
        np.int64(X64.shape[0]), np.int32(X64.shape[1]),
        sub.ctypes.data_as(c_f64), np.int64(out.strides[0] // 8),
        np.int32(0))
    return rc_code == 0


def predict_contrib(engine, X: np.ndarray, start_iteration: int,
                    end_iteration: int, row_chunk: int = 16384
                    ) -> np.ndarray:
    """SHAP contributions ``[N, (F + 1) * K]`` of iterations
    [start, end): per class a block of F feature columns and the expected
    value (ref: PredictType kPredictContrib). The C++ row-parallel kernel
    answers where the native library loads, else the numpy walk, its rows
    in chunks (the path copies hold O(depth^2 * chunk) floats). Both
    reproduce the scalar recursion in f64."""
    K = engine.num_tree_per_iteration
    F = engine.max_feature_idx + 1
    N = X.shape[0]
    out = np.zeros((N, (F + 1) * K))
    from ..native import get_lib
    lib = get_lib()
    X64 = np.ascontiguousarray(X, dtype=np.float64) if lib is not None \
        else None
    for it in range(start_iteration, end_iteration):
        for k in range(K):
            t = engine.models[it * K + k]
            base = k * (F + 1)
            if t.num_leaves <= 1:
                out[:, base + F] += float(t.leaf_value[0])
                continue
            if lib is not None and _native_tree_shap(t, X64, out, base,
                                                     lib):
                out[:, base + F] += _expected_value(t, 0)
                continue
            for lo in range(0, N, row_chunk):
                hi = min(lo + row_chunk, N)
                out[lo:hi, base:base + F + 1] += shap_tree_batch(
                    t, np.ascontiguousarray(X[lo:hi]), F)
    return out
