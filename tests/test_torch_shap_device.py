"""Device TreeSHAP in the PyTorch port (``ops/shap_pack.py``,
``Booster.predict(pred_contrib=True, device=True)``), the port's
counterpart of ``tests/test_shap_device.py``.

Trees trained by the JAX package are carried across with
``convert.trees_from_arrays`` and its bin mappers with
``bin_mapper_from_fields``, so both packages pack the same trees: the
port's path windows (binned and raw) must equal the JAX package's array
for array. The port's contributions must be within rtol 1e-4 / atol
1e-5 (f32 path algebra against the f64 walk, the JAX tolerance) of the
host walk and of the JAX package's device explanation, on the
missing-value adversarial batch, in multiclass blocks, by the loaded
model's raw route and over iteration windows; additive to the raw score;
the same bits on a replay and after an incremental append as after a
full repack; a fleet tenant's explanation equal to its own array for
array, also after its explain pack is evicted and rebuilt. Linear and categorical models answer by the host walk, said
once.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.core.shap import predict_contrib as jpredict_contrib
from lightgbm_tpu.ops import shap_pack as jshap
from lightgbm_tpu_torch.convert import (TREE_FIELDS, bin_mapper_from_fields,
                                        trees_from_arrays)
from lightgbm_tpu_torch.core.shap import predict_contrib
from lightgbm_tpu_torch.ops import forest as tforest
from lightgbm_tpu_torch.ops import shap_pack as tshap
from lightgbm_tpu_torch.ops.forest import DeviceRouteUnavailable
from test_packed_forest import _adversarial, _train

RTOL, ATOL = 1e-4, 1e-5      # f32 EXTEND/UNWIND vs the f64 host walk
CPU = torch.device("cpu")
TPARAMS = {"objective": "regression", "num_leaves": 31, "verbose": -1,
           "min_data_in_leaf": 5, "device_type": "cpu"}


def _carry(bst):
    ts = bst._engine.train_set
    mappers = [bin_mapper_from_fields(vars(m)) for m in ts.bin_mappers]
    arrays = [{f: getattr(t, f) for f in TREE_FIELDS}
              for t in bst._engine.models]
    used = np.asarray(ts.used_feature_map)
    return trees_from_arrays(arrays, mappers, used), mappers, used


def _host_ref(eng, X, start=0, num=None):
    K = eng.num_tree_per_iteration
    n_iter = len(eng.models) // max(K, 1)
    end = n_iter if num is None else min(start + num, n_iter)
    return predict_contrib(eng, X, start, end)


def _assert_windows_equal(twin, jwin):
    assert type(twin).__name__ == type(jwin).__name__
    assert twin._fields == jwin._fields
    for name, a, b in zip(twin._fields, twin, jwin):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------------------------------------------------------------------
# the packs: the JAX package's arrays, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("missing", ["none", "zero", "nan"])
def test_pack_windows_equal_jax_binned_and_raw(rng, missing):
    bst, X = _train(rng, missing=missing, n_round=6)
    trees, mappers, used = _carry(bst)
    eng = bst._engine
    L, F = eng.config.num_leaves, eng.max_feature_idx + 1
    used_m = [mappers[i] for i in used]
    tpack = tshap.ShapForestPack(L, F, CPU)
    tpack.sync(trees, 0, used_m)
    jpack = jshap.ShapForestPack(L, F)
    jpack.sync(eng.models, 0, eng.train_set.used_bin_mappers())
    traw = tshap.RawShapPack(L, F, CPU)
    traw.sync(trees, 0)
    jraw = jshap.RawShapPack(L, F)
    jraw.sync(eng.models, 0)
    for lo, hi in ((0, len(trees)), (2, 5), (5, 6)):
        _assert_windows_equal(tpack.window(lo, hi)[0],
                              jpack.window(lo, hi)[0])
        _assert_windows_equal(traw.window(lo, hi)[0],
                              jraw.window(lo, hi)[0])


def test_incremental_append_equals_jax_full_pack(rng):
    """A pack grown a tree at a time (the depth axis widened as deeper
    trees arrive) holds the JAX package's full pack's windows."""
    bst, X = _train(rng, missing="nan", n_round=8)
    trees, mappers, used = _carry(bst)
    eng = bst._engine
    L, F = eng.config.num_leaves, eng.max_feature_idx + 1
    used_m = [mappers[i] for i in used]
    inc = tshap.ShapForestPack(L, F, CPU)
    for n in range(1, len(trees) + 1):
        inc.sync(trees[:n], 0, used_m)
    jpack = jshap.ShapForestPack(L, F)
    jpack.sync(eng.models, 0, eng.train_set.used_bin_mappers())
    _assert_windows_equal(inc.window(0, len(trees))[0],
                          jpack.window(0, len(trees))[0])


# ---------------------------------------------------------------------------
# contributions: host walk and the JAX device explanation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("missing", ["none", "zero", "nan"])
def test_parity_missing_routes_adversarial(rng, missing):
    """Each missing route's model, explained by the binned route on the
    NaN / 0 / ±inf / kZeroThreshold batch: within tolerance of the host
    walk and of the JAX device explanation, and additive per row."""
    bst, X = _train(rng, missing=missing)
    trees, mappers, used = _carry(bst)
    eng = bst._engine
    Xq = _adversarial(rng, X[:96])
    srv = tforest.ServingEngine(eng.config.num_leaves, 1, CPU)
    dev = srv.explain_binned(trees, 0, Xq, 0, len(trees),
                             [mappers[i] for i in used], used,
                             eng.max_feature_idx + 1)
    host = jpredict_contrib(eng, Xq, 0, len(trees))
    np.testing.assert_allclose(dev, host, rtol=RTOL, atol=ATOL)
    jdev = np.asarray(bst.predict(Xq, pred_contrib=True, device=True))
    np.testing.assert_allclose(dev, jdev, rtol=RTOL, atol=ATOL)
    raw = bst.predict(Xq, raw_score=True)
    np.testing.assert_allclose(dev.sum(axis=1), raw, rtol=RTOL, atol=ATOL)


def test_parity_multiclass_blocks(rng):
    X = rng.normal(size=(500, 6)).astype(np.float32).astype(np.float64)
    y = (np.abs(X[:, 0]) * 1.5).astype(int) % 3
    p = {"objective": "multiclass", "num_class": 3, "num_leaves": 15,
         "verbose": -1, "min_data_in_leaf": 5}
    bst = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, label=y),
                    num_boost_round=5)
    Xq = _adversarial(rng, X[:64])
    dev = np.asarray(bst.predict(Xq, pred_contrib=True, device=True))
    assert dev.shape == (64, 3 * 7)
    host = np.asarray(_host_ref(bst._engine, Xq))
    np.testing.assert_allclose(dev, host, rtol=RTOL, atol=ATOL)
    raw = bst.predict(Xq, raw_score=True)
    np.testing.assert_allclose(dev.reshape(64, 3, -1).sum(axis=2), raw,
                               rtol=RTOL, atol=ATOL)
    jbst = lgb.train(p, lgb.Dataset(X, label=y), num_boost_round=5)
    jdev = np.asarray(jbst.predict(Xq, pred_contrib=True, device=True))
    np.testing.assert_allclose(dev, jdev, rtol=RTOL, atol=ATOL)


def test_parity_raw_route_loaded_model(rng):
    """A model loaded from text has no bin mappers: the raw path pack
    serves (f32_floor thresholds, decision_type missing routes) and
    agrees with the host walk and the JAX loaded model's device
    explanation on the adversarial batch."""
    bst, X = _train(rng, missing="nan")
    text = bst.model_to_string()
    loaded = lgt.Booster(params={"device_type": "cpu"}, model_str=text)
    Xq = _adversarial(rng, X[:96])
    dev = loaded.predict(Xq, pred_contrib=True, device=True)
    host = _host_ref(loaded._engine, Xq)
    np.testing.assert_allclose(dev, host, rtol=RTOL, atol=ATOL)
    jdev = lgb.Booster(model_str=text).predict(Xq, pred_contrib=True,
                                               device=True)
    np.testing.assert_allclose(dev, jdev, rtol=RTOL, atol=ATOL)
    srv = loaded._engine._serving
    assert srv is not None and srv.raw_shap_pack is not None
    assert srv.raw_shap_pack.count == len(loaded._engine.models)
    # f64-only values cannot take the raw route: the host walk answers
    Xd = np.nan_to_num(X[:8]) + 1e-12
    np.testing.assert_array_equal(
        loaded.predict(Xd, pred_contrib=True, device=True),
        _host_ref(loaded._engine, Xd))


@pytest.fixture(scope="module")
def eight_rounds():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(600, 6)).astype(np.float32).astype(np.float64)
    X[rng.uniform(size=X.shape) < 0.05] = np.nan
    y = np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1])
    bst = lgt.train(TPARAMS, lgt.Dataset(X, label=y), num_boost_round=8)
    return bst, X


def test_fleet_shap_eviction_rebuild_bit_identity(eight_rounds):
    """A fleet tenant's explanation is its own device ``pred_contrib``
    array for array; evicting the resident explain pack and rebuilding
    it at the next explain gives the same bits, and the eviction and
    rebuild are counted."""
    bst, X = eight_rounds
    with lgt.serve_fleet({"t0": bst}, linger_ms=2.0) as fleet:
        before = fleet.explain("t0", X[:40], timeout=60)
        np.testing.assert_array_equal(
            before, bst.predict(X[:40], pred_contrib=True, device=True))
        with fleet._publish_lock:
            freed = fleet._evict_shap(1 << 60)
        assert freed > 0
        assert all(sb.dev is None for sb in fleet._shap_cache.values())
        assert fleet.stats()["resident_shap_bytes"] == 0
        np.testing.assert_array_equal(fleet.explain("t0", X[:40],
                                                    timeout=60), before)
        assert fleet.counters.get("evictions") >= 1
        assert fleet.counters.get("rebuilds") >= 1
        assert fleet.stats()["resident_shap_bytes"] > 0
        assert fleet.counters.get("explain_degraded") == 0


@pytest.mark.parametrize("start,num", [(0, 3), (2, 4), (5, 3)])
def test_parity_iteration_windows(eight_rounds, start, num):
    bst, X = eight_rounds
    Xq = X[:80]
    dev = bst.predict(Xq, pred_contrib=True, device=True,
                      start_iteration=start, num_iteration=num)
    host = _host_ref(bst._engine, Xq, start, num)
    np.testing.assert_allclose(dev, host, rtol=RTOL, atol=ATOL)


def test_additivity_and_replay_bits(eight_rounds, rng):
    """The sum of a row's contributions (bias included) is its raw device
    score within 1e-5, and a second call gives the same bits."""
    bst, X = eight_rounds
    Xq = _adversarial(rng, X[:128])
    dev = np.asarray(bst.predict(Xq, pred_contrib=True, device=True))
    raw = bst.predict(Xq, device=True, raw_score=True)
    np.testing.assert_allclose(dev.sum(axis=1), raw, rtol=1e-5, atol=1e-5)
    again = np.asarray(bst.predict(Xq, pred_contrib=True, device=True))
    np.testing.assert_array_equal(dev, again)


def test_chunking_changes_no_contribution(eight_rounds, monkeypatch):
    """Chunks of a few elements (paths and rows cut small) give the one
    big chunk's contributions: the f32 recursion is elementwise, only
    the f64 sums' order moves."""
    bst, X = eight_rounds
    Xq = X[:50]
    whole = bst.predict(Xq, pred_contrib=True, device=True)
    monkeypatch.setattr(tshap, "SHAP_ELEMS", 97)
    small = bst.predict(Xq, pred_contrib=True, device=True)
    np.testing.assert_allclose(small, whole, rtol=1e-12, atol=1e-12)


def test_incremental_append_matches_full_repack_bits(rng):
    X = rng.normal(size=(600, 6)).astype(np.float32).astype(np.float64)
    y = X[:, 0] + 0.5 * X[:, 1]
    bst = lgt.train(TPARAMS, lgt.Dataset(X, label=y), num_boost_round=4,
                    keep_training_booster=True)
    eng = bst._engine
    Xq = X[:64]
    outs = [bst.predict(Xq, pred_contrib=True, device=True)]
    for _ in range(3):
        bst.update()
        outs.append(bst.predict(Xq, pred_contrib=True, device=True))
    inc_pack = eng._serving.shap_pack
    assert inc_pack.count == len(eng.models)
    inc_win, _ = inc_pack.window(0, inc_pack.count)
    fresh = tforest.ServingEngine(eng.config.num_leaves, 1, CPU)
    models, gen, mappers, used = eng.serving_state()
    snap = fresh.snapshot_shap(models, gen, 0, len(models),
                               eng.max_feature_idx + 1, mappers, used)
    for a, b in zip(inc_win, snap.win):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(
        outs[-1], tshap.shap_snapshot_scores(snap, Xq))
    np.testing.assert_array_equal(
        outs[-1], bst.predict(Xq, pred_contrib=True, device=True))


def test_mesh_two_cpu_devices_equals_no_mesh(eight_rounds):
    """Explanations over a ``[cpu, cpu]`` mesh (paths copied to each
    entry, rows split) equal no mesh's bit for bit."""
    from lightgbm_tpu_torch.serving import mesh
    bst, X = eight_rounds
    eng = bst._engine
    models, gen, mappers, used = eng.serving_state()
    m = mesh.serving_mesh(devices=["cpu", "cpu"])
    srv = tforest.ServingEngine(eng.config.num_leaves, 1, CPU)
    snap = srv.snapshot_shap(models, gen, 0, len(models),
                             eng.max_feature_idx + 1, mappers, used,
                             place_window=lambda w: mesh.replicate(w, m))
    assert len(snap.paths) == 2
    got = tshap.shap_snapshot_scores(
        snap, X[:77], lambda a, ax: mesh.shard_rows(a, ax, m))
    np.testing.assert_array_equal(
        got, bst.predict(X[:77], pred_contrib=True, device=True))


# ---------------------------------------------------------------------------
# eligibility: linear and categorical models answer by the host walk
# ---------------------------------------------------------------------------

def _cat_model(rng):
    X = rng.normal(size=(600, 6)).astype(np.float32).astype(np.float64)
    X[:, 5] = rng.integers(0, 8, size=600)
    y = (X[:, 5] % 3) * 2.0 + 0.1 * X[:, 0]
    bst = lgt.train(TPARAMS, lgt.Dataset(X, label=y,
                                         categorical_feature=[5]),
                    num_boost_round=8)
    assert any(t.num_cat > 0 for t in bst._engine.models)
    return bst, X


def test_categorical_model_falls_back_to_host(rng):
    bst, X = _cat_model(rng)
    with pytest.raises(DeviceRouteUnavailable, match="categorical"):
        tshap.check_explainable(bst._engine.models)
    dev = bst.predict(X[:50], pred_contrib=True, device=True)
    np.testing.assert_array_equal(dev, _host_ref(bst._engine, X[:50]))
    srv = bst._engine._serving
    assert srv is None or srv.shap_pack is None


def test_linear_model_falls_back_to_host(rng):
    X = rng.normal(size=(400, 5)).astype(np.float32).astype(np.float64)
    y = X[:, 0] * 2.0 + X[:, 1]
    bst = lgt.train(dict(TPARAMS, num_leaves=7, linear_tree=True,
                         min_data_in_leaf=20),
                    lgt.Dataset(X, label=y, params={"linear_tree": True}),
                    num_boost_round=3)
    with pytest.raises(ValueError, match="linear"):
        tshap.check_explainable(bst._engine.models)
    dev = bst.predict(X[:30], pred_contrib=True, device=True)
    np.testing.assert_array_equal(dev, _host_ref(bst._engine, X[:30]))


def test_host_fallback_logs_once(rng):
    from lightgbm_tpu_torch.utils import log as _log
    bst, X = _cat_model(rng)
    _log.logged_once -= {m for m in _log.logged_once
                         if "device explanation unavailable" in m}
    got = []
    _log.register_logger(got.append)
    prev_level = _log._level
    _log.set_verbosity(_log.INFO)
    try:
        for _ in range(3):
            bst.predict(X[:10], pred_contrib=True, device=True)
    finally:
        _log.register_logger(None)
        _log.set_verbosity(prev_level)
    hits = [m for m in got if "device explanation unavailable" in m]
    assert len(hits) == 1, hits
    assert "[Info]" in hits[0]


def test_other_errors_are_not_swallowed(eight_rounds, monkeypatch):
    """Only ``DeviceRouteUnavailable`` takes the host walk: any other
    error of the device explanation raises."""
    bst, X = eight_rounds

    def boom(*a, **k):
        raise ValueError("a code bug")

    monkeypatch.setattr(tshap, "shap_snapshot_scores", boom)
    with pytest.raises(ValueError, match="a code bug"):
        bst.predict(X[:5], pred_contrib=True, device=True)


# ---------------------------------------------------------------------------
# the explanation route of the server
# ---------------------------------------------------------------------------

def test_server_explain_route(eight_rounds, rng):
    """``ModelServer.explain`` serves the device contributions (the
    Booster's, bit for bit, on the CPU), counts them, answers a degraded
    server by the host walk (counted ``explain_degraded``) and a
    categorical model by the host walk too."""
    bst, X = eight_rounds
    want = bst.predict(X[:40], pred_contrib=True, device=True)
    with bst.serve(linger_ms=1.0, probe_interval_s=0.0) as srv:
        futs = [srv.submit(X[i * 10:(i + 1) * 10], kind="contrib")
                for i in range(4)]
        got = np.concatenate([f.result(60) for f in futs])
        np.testing.assert_array_equal(got, want)
        assert srv.counters.get("explain_requests") == 4
        assert srv.counters.get("explain_degraded") == 0
        assert srv._shap_snap is not None
        srv.degrade("test: forced")
        np.testing.assert_array_equal(srv.explain(X[:20], timeout=60),
                                      _host_ref(bst._engine, X[:20]))
        assert srv.counters.get("explain_degraded") == 1
    cbst, CX = _cat_model(rng)
    with cbst.serve(linger_ms=1.0) as srv:
        np.testing.assert_array_equal(srv.explain(CX[:20], timeout=60),
                                      _host_ref(cbst._engine, CX[:20]))
        assert srv.counters.get("explain_degraded") == 1
