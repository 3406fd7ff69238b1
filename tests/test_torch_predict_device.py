"""Device prediction in the PyTorch port (``ops/forest.py``,
``ops/predict.py``, ``Booster.predict(device=True)``) against the host
walk and the JAX package's device route: the port's counterpart of
``tests/test_packed_forest.py``.

Trees trained by the JAX package are carried across with
``convert.trees_from_arrays`` and its bin mappers with
``bin_mapper_from_fields``, so both packages hold the same trees. Leaf
indices must then be equal bit for bit — to the host walk and to the JAX
package's ``forest_leaf_bins`` / ``tree_leaf_raw`` — for every missing
type and for requests holding NaN, zeros, ±inf and ±float32(1e-35). Both
packages add the trees' f32 leaf values one tree at a time from zero, so
their device scores are equal bit for bit too; against the f64 host walk
they agree to f32 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import forest as jforest
from lightgbm_tpu.ops import predict as jpredict
from lightgbm_tpu_torch.convert import (TREE_FIELDS, bin_mapper_from_fields,
                                        booster_from_arrays,
                                        trees_from_arrays)
from lightgbm_tpu_torch.ops import forest as tforest
from lightgbm_tpu_torch.ops import predict as tpredict
from test_packed_forest import _adversarial, _train

CPU = torch.device("cpu")


def _carry(bst):
    """The JAX model's trees, bin mappers and used-feature map as the
    port's objects."""
    ts = bst._engine.train_set
    mappers = [bin_mapper_from_fields(vars(m)) for m in ts.bin_mappers]
    arrays = [{f: getattr(t, f) for f in TREE_FIELDS}
              for t in bst._engine.models]
    used = np.asarray(ts.used_feature_map)
    return trees_from_arrays(arrays, mappers, used), mappers, used


def test_f32_floor_exact_boundary():
    v = np.asarray([1.0, 1.0 + 1e-12, -1.0 - 1e-12, np.inf, -np.inf,
                    1e300, -1e300, 0.0, 1e-35])
    out = tforest.f32_floor(v)
    assert out.dtype == np.float32
    ok = np.isfinite(v)
    assert (out[ok].astype(np.float64) <= v[ok]).all()
    nxt = np.nextafter(out[ok], np.float32(np.inf))
    assert (nxt.astype(np.float64) > v[ok]).all()
    assert out[3] == np.inf and out[4] == -np.inf
    np.testing.assert_array_equal(out, jforest.f32_floor(v))
    assert tpredict.K_ZERO_THRESHOLD_F32 == jpredict.K_ZERO_THRESHOLD_F32
    assert tpredict.K_ZERO_THRESHOLD_F32 <= 1e-35


def test_bucket_rows_and_depth_steps():
    sizes = list(range(1, 20001, 7))
    buckets = {tforest.bucket_rows(r) for r in sizes}
    assert all(tforest.bucket_rows(r) >= r for r in sizes)
    assert len(buckets) < 30
    for r in sizes:
        if r > 4096:
            assert tforest.bucket_rows(r) / r <= 1.15
        assert tforest.bucket_rows(r) == jforest.bucket_rows(r)
    for b in buckets:
        assert tforest.bucket_rows(b) == b
    for d in (None, 0, 1, 4, 13, 16, 17, 999):
        assert tpredict.depth_steps(d, 255) == jpredict.depth_steps(d, 255)
    assert tpredict._resolve_steps(7, 255) == 7
    assert tpredict._resolve_steps(999, 31) == 30
    assert tpredict._resolve_steps(None, 31) == 30


def test_device_binner_matches_host_mapper_and_jax(rng):
    """Every column bins as the host mapper bins it; a column holding a
    value one f64 ulp above a bin bound (which f32 rounds below it) is
    binned by the host mapper, the other columns on the device."""
    bst, X = _train(rng, missing="nan", n_round=2)
    _, mappers, used = _carry(bst)
    Xq = _adversarial(rng, X)
    m0 = mappers[used[0]]
    b = float(m0.bin_upper_bound[len(m0.bin_upper_bound) // 2])
    Xq[::3, used[0]] = np.nextafter(b, np.inf)
    assert np.float32(np.nextafter(b, np.inf)) <= np.float32(b)
    used_m = [mappers[i] for i in used]
    binner = tforest.DeviceBinner(used_m, used, CPU)
    dev = binner.bins(Xq).numpy()
    assert dev.dtype == np.int32 and dev.shape == (len(used), len(Xq))
    for i, (fi, m) in enumerate(zip(used, used_m)):
        np.testing.assert_array_equal(
            dev[i, :len(Xq)], m.value_to_bin(np.asarray(Xq[:, fi])),
            err_msg=f"feature {fi}")
    jbinner = jforest.DeviceBinner(bst._engine.train_set.used_bin_mappers(),
                                   used)
    np.testing.assert_array_equal(dev[:, :len(Xq)],
                                  np.asarray(jbinner.bins(Xq)))
    # the device search alone puts that column's straddling rows one bin
    # low: the per-column fallback is what keeps it exact
    x0 = torch.as_tensor(Xq[:, used[0]].astype(np.float32))
    alone = torch.searchsorted(binner.bounds_dev[0], x0, side="left")
    assert (alone.numpy() != dev[0, :len(Xq)]).any()


@pytest.mark.parametrize("missing", ["none", "zero", "nan"])
def test_leaf_parity_matrix_binned_and_raw(rng, missing):
    """Per-tree leaf indices of the binned route (device binning +
    ``forest_leaf_bins``) and of the raw route (``tree_leaf_raw``) equal
    the host walk's and the JAX package's, bit for bit."""
    bst, X = _train(rng, missing=missing, n_round=6)
    trees, mappers, used = _carry(bst)
    eng = bst._engine
    Xq = _adversarial(rng, X)
    L = eng.config.num_leaves
    used_m = [mappers[i] for i in used]
    bins_dev = tforest.DeviceBinner(used_m, used, CPU).bins(Xq)
    pack = tforest.ForestPack(L, CPU)
    pack.sync(trees, gen=0, mappers=used_m)
    raw_pack = tforest.RawForestPack(L, CPU)
    raw_pack.sync(trees, gen=0)
    jmappers = eng.train_set.used_bin_mappers()
    jbins = jforest.DeviceBinner(jmappers, used).bins(Xq)
    jpack = jforest.ForestPack(L)
    jpack.sync(eng.models, gen=0, mappers=jmappers)
    x32 = torch.as_tensor(Xq.astype(np.float32))
    for i, (t, jt) in enumerate(zip(trees, eng.models)):
        host = t.predict_leaf(Xq)
        np.testing.assert_array_equal(host, jt.predict_leaf(Xq))
        steps = tpredict.depth_steps(t.max_depth, L)
        p = tforest._slice(pack.stacked, i, i + 1)
        binned = tpredict.forest_leaf_bins(p, bins_dev,
                                           num_steps=steps)[0].numpy()
        jp = jax.tree.map(lambda a: a[i], jpack.stacked)
        jbinned = np.asarray(jpredict.forest_leaf_bins(
            jp.tree, jp.special, jp.flip, jbins, num_steps=steps))
        raw = tpredict.tree_leaf_raw(
            tforest._slice(raw_pack.stacked, i, i + 1), x32,
            num_steps=steps)[0].numpy()
        jraw = np.asarray(jpredict.tree_leaf_raw(
            jforest._host_tree_to_raw(jt, L), jnp.asarray(x32.numpy())))
        for got in (binned, jbinned, raw, jraw):
            np.testing.assert_array_equal(got, host)


def _port_binned_booster(bst, X, trees):
    """A port Booster with the training bin mappers (binned route) whose
    model list holds the carried-across trees."""
    y = np.zeros(len(X))
    pb = lgt.train({"objective": "regression", "num_leaves": 31,
                    "verbose": -1, "min_data_in_leaf": 5,
                    "device_type": "cpu"}, lgt.Dataset(X, label=y),
                   num_boost_round=1)
    eng = pb._engine
    assert [m.feature_info() for m in eng.train_set.bin_mappers] == \
        [m.feature_info() for m in bst._engine.train_set.bin_mappers]
    eng.models = list(trees)
    return pb


def test_device_scores_equal_jax_device_scores(rng):
    """raw scores of predict(device=True) are the JAX package's
    predict(device=True) bits, on the raw route (no mappers) and on the
    binned route; the host walk agrees to f32 rounding."""
    bst, X = _train(rng, missing="nan", n_round=8)
    trees, mappers, used = _carry(bst)
    Xq = _adversarial(rng, X)
    jdev = bst.predict(Xq, device=True, raw_score=True)
    raw_bst = booster_from_arrays(
        {"objective": "regression", "device_type": "cpu", "verbose": -1},
        [{f: getattr(t, f) for f in TREE_FIELDS}
         for t in bst._engine.models], mappers, used)
    raw = raw_bst.predict(Xq, device=True, raw_score=True)
    assert raw_bst._engine._serving.raw_pack.count == len(trees)
    np.testing.assert_array_equal(raw, jdev)
    binned_bst = _port_binned_booster(bst, X, trees)
    binned = binned_bst.predict(Xq, device=True, raw_score=True)
    assert binned_bst._engine._serving.pack.count == len(trees)
    np.testing.assert_array_equal(binned, jdev)
    host = raw_bst.predict(Xq, raw_score=True)
    np.testing.assert_allclose(raw, host, rtol=1e-5, atol=1e-6)
    for kw in ({"num_iteration": 3}, {"start_iteration": 2,
                                      "num_iteration": 4}):
        np.testing.assert_array_equal(
            raw_bst.predict(Xq, device=True, raw_score=True, **kw),
            bst.predict(Xq, device=True, raw_score=True, **kw))


def _port_booster(rng, n=600, rounds=3, **params):
    X = rng.normal(size=(n, 5))
    X[rng.uniform(size=n) < 0.05, 1] = np.nan
    y = X[:, 0] * 2 + np.nan_to_num(X[:, 1]) + rng.normal(scale=0.1, size=n)
    p = {"objective": "regression", "num_leaves": 15, "verbose": -1,
         "min_data_in_leaf": 5, "device_type": "cpu", **params}
    bst = lgt.Booster(p, lgt.Dataset(X, label=y))
    for _ in range(rounds):
        bst.update()
    return bst, X, y


def test_model_generation_counter_semantics(rng):
    bst, _, _ = _port_booster(rng)
    eng = bst._engine
    g0 = eng._model_gen
    eng.models.append(eng.models[0])             # tail append: no bump
    assert eng._model_gen == g0
    del eng.models[-1:]                          # destructive: bump
    assert eng._model_gen > g0
    g1 = eng._model_gen
    eng.models[0] = eng.models[0]                # replacement: bump
    assert eng._model_gen > g1
    g2 = eng._model_gen
    eng.invalidate_serving_cache()               # in-place content edit
    assert eng._model_gen > g2
    g3 = eng._model_gen
    eng.models = list(eng.models)                # wholesale assignment
    assert eng._model_gen > g3


def test_pack_appends_the_tail_and_repacks_on_a_generation_bump(
        rng, monkeypatch):
    bst, X, _ = _port_booster(rng)
    eng = bst._engine
    packed = []
    orig = tforest.ForestPack._pack_tree

    def spy(self, t):
        packed.append(t)
        return orig(self, t)

    monkeypatch.setattr(tforest.ForestPack, "_pack_tree", spy)
    bst.predict(X, device=True)
    pack = eng._serving.pack
    assert len(packed) == pack.count == 3
    gen = pack.gen
    for _ in range(2):
        bst.update()                             # appends, no gen bump
    np.testing.assert_allclose(bst.predict(X, device=True), bst.predict(X),
                               rtol=1e-5, atol=1e-6)
    assert len(packed) == pack.count == 5 and pack.gen == gen
    bst.predict(X, device=True, num_iteration=2)  # a slice, no packing
    assert len(packed) == 5
    # drop the last tree and train another in its place (its residuals
    # still hold the dropped tree): back at the same count, the
    # generation bump repacks, so the device never serves the old tree
    before = bst.predict(X, device=True)
    del eng.models[-1:]
    bst.update()
    assert bst.current_iteration() == 5
    after = bst.predict(X, device=True)
    assert len(packed) == 10 and pack.gen != gen
    np.testing.assert_allclose(after, bst.predict(X), rtol=1e-5, atol=1e-6)
    assert np.abs(after - before).max() > 1e-4


def test_fallbacks_to_the_host_walk(rng, monkeypatch):
    """An empty tree range and f64-only values on the raw route warn and
    use the host walk; tpu_predict_device turns the device route on."""
    bst, X, _ = _port_booster(rng, tpu_predict_device=True)
    calls = []
    orig = bst._engine.predict_device

    def spy(*a):
        calls.append(a[1:])
        return orig(*a)

    monkeypatch.setattr(bst._engine, "predict_device", spy)
    np.testing.assert_allclose(bst.predict(X), bst.predict(X, device=False),
                               rtol=1e-5, atol=1e-6)
    assert calls == [(0, 3)]
    np.testing.assert_array_equal(bst.predict(X, start_iteration=5),
                                  np.zeros(len(X)))
    assert calls[-1] == (5, 3)
    # the binned route bins an f64-only column on the host
    ts = bst._engine.train_set
    m = ts.used_bin_mappers()[0]
    Xq = X.copy()
    Xq[:, 0] = np.nextafter(float(m.bin_upper_bound[3]), np.inf)
    np.testing.assert_allclose(bst.predict(Xq, device=True),
                               bst.predict(Xq, device=False),
                               rtol=1e-5, atol=1e-6)
    # the raw route refuses it: the host walk answers, to the bit
    raw_bst = booster_from_arrays(
        {"objective": "regression", "device_type": "cpu", "verbose": -1},
        [{f: getattr(t, f) for f in TREE_FIELDS}
         for t in bst._engine.models], ts.bin_mappers, ts.used_feature_map)
    np.testing.assert_array_equal(raw_bst.predict(Xq, device=True),
                                  raw_bst.predict(Xq))
    # f32 values: both routes serve on the device, to the same bits
    X32 = X.astype(np.float32).astype(np.float64)
    np.testing.assert_array_equal(raw_bst.predict(X32, device=True),
                                  bst.predict(X32, device=True))
    assert raw_bst._engine._serving.raw_pack.count == 3


def test_only_an_unservable_request_falls_back(rng, monkeypatch):
    """The host walk answers only ``DeviceRouteUnavailable``; any other
    error of the device route, a ValueError included, propagates."""
    bst, X, _ = _port_booster(rng)
    assert issubclass(tforest.DeviceRouteUnavailable, ValueError)
    for exc in (ValueError("shape bug"), RuntimeError("launch failed")):
        def broken(*a, exc=exc):
            raise exc
        monkeypatch.setattr(bst._engine, "predict_device", broken)
        with pytest.raises(type(exc), match=str(exc)):
            bst.predict(X, device=True)

    def unservable(*a):
        raise tforest.DeviceRouteUnavailable("empty")
    monkeypatch.setattr(bst._engine, "predict_device", unservable)
    np.testing.assert_array_equal(bst.predict(X, device=True),
                                  bst.predict(X))


@pytest.mark.parametrize("buckets", [True, False])
def test_batches_are_scored_at_their_own_row_count(rng, buckets):
    """``tpu_predict_buckets`` is accepted and ignored: no batch is padded,
    and a row scores the same bits alone, in a ragged batch and in the
    whole request."""
    bst, X, _ = _port_booster(rng, tpu_predict_buckets=buckets)
    whole = bst.predict(X, device=True, raw_score=True)
    for n in (1, 257, 333):
        np.testing.assert_array_equal(
            bst.predict(X[:n], device=True, raw_score=True), whole[:n])
    eng = bst._engine
    binner = tforest.DeviceBinner(eng._serving_mappers,
                                  eng.train_set.used_feature_map, CPU)
    assert binner.bins(X[:257]).shape[1] == 257
    snap = eng._serving.snapshot(eng.models, eng._model_gen, 0, 3,
                                 eng._serving_mappers,
                                 eng.train_set.used_feature_map)
    assert tforest.snapshot_scores(snap, X[:257]).shape == (1, 257)
