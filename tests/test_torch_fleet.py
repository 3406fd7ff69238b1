"""The multi-tenant fleet of the PyTorch port
(``lightgbm_tpu_torch/serving/fleet.py``), case for case the port's
counterpart of ``tests/test_fleet.py``: capacity bucketing units (shapes
equal to the JAX package's), per-tenant counters, cross-tenant
coalescing bit for bit against each tenant's own
``predict(device=True)`` over mixed shapes, converted outputs, a
categorical tenant sharing a bucket with a numeric one and loaded
(raw-route) tenants; one scorer call a bucket group whatever the number
of tenants in it (the torch counterpart of the JAX flat trace budget);
per-tenant isolation (malformed, expired, ``publish_fail``, quota),
exact three-tenant accounting, degrade and recovery, both placements on
a ``[cpu, cpu]`` mesh, the memory budget's eviction and rebuild, OOM
bisection and the forced eviction of a publish; and a loaded categorical
tenant refused at ``add_tenant``, as the JAX fleet refuses it.

One module fixture trains the L2 tenants in both packages (their model
texts equal string for string) and records the JAX fleet's responses to
a fixed request per tenant, which the port's fleet must give bit for
bit. The counterpart of ``test_serve_fleet_kwarg_returns_tenant_handle``
is in ``tests/test_torch_serving.py``. Every fleet is closed in ``with``
or ``finally``; every booster a case trains further is rolled back.
"""
import pickle
import threading
import time

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import forest as jforest
from lightgbm_tpu.serving import serve_fleet as jserve_fleet
from lightgbm_tpu_torch.ops import forest
from lightgbm_tpu_torch.ops.forest import DeviceRouteUnavailable
from lightgbm_tpu_torch.robustness import faults
from lightgbm_tpu_torch.serving import (DeadlineExceeded, FleetServer,
                                        Overloaded, ServingCounters,
                                        TenantHandle, serve_fleet)

CPU = {"device_type": "cpu"}
CPU2 = ["cpu", "cpu"]


def _data(seed, n_features=6, rows=700):
    rng = np.random.default_rng(seed)
    return rng, rng.normal(size=(rows, n_features)).astype(
        np.float32).astype(np.float64)


def _params(objective="regression", leaves=15):
    p = {"objective": objective, "num_leaves": leaves, "verbose": -1,
         "min_data_in_leaf": 5, **CPU}
    if objective == "multiclass":
        p["num_class"] = 3
    return p


def _make_booster(seed, n_features=6, leaves=15, trees=5, rows=700,
                  objective="regression", scale=1.0, mod=lgt):
    """The JAX test's tenant in either package (same data, same label
    rule)."""
    _, X = _data(seed, n_features, rows)
    if objective == "multiclass":
        y = (np.abs(X[:, 0] * scale) * 1.5).astype(int) % 3
    elif objective == "binary":
        y = (X[:, 0] * scale + 0.3 * X[:, 1] ** 2 > 0.2).astype(float)
    else:
        y = X[:, 0] * scale + 0.3 * X[:, 1] ** 2
    bst = mod.train(_params(objective, leaves), mod.Dataset(X, label=y),
                    num_boost_round=trees, keep_training_booster=True)
    return bst, X


def _cat_data():
    rng = np.random.default_rng(90)
    Xc = rng.normal(size=(700, 6)).astype(np.float32).astype(np.float64)
    Xc[:, 5] = rng.integers(0, 8, size=700)
    Xc[rng.uniform(size=Xc.shape) < 0.05] = np.nan
    Xc[:, 5] = np.abs(np.nan_to_num(Xc[:, 5]))
    yc = np.nan_to_num(Xc[:, 0]) + (Xc[:, 5] % 3)
    return Xc, yc


def _cat_booster(mod):
    Xc, yc = _cat_data()
    return mod.train(_params(), mod.Dataset(Xc, label=yc,
                                            categorical_feature=[5]),
                     num_boost_round=5, keep_training_booster=True), Xc


def _dev(bst, X):
    return bst.predict(X, device=True, raw_score=True)


@pytest.fixture(scope="module")
def world():
    """The trio (three same-shape L2 tenants), an in-memory categorical
    tenant and a loaded (raw-route) tenant, in both packages; and the
    JAX fleet's raw responses to each one's request ``REQ[name]``."""
    port, jax_ = {}, {}
    for i in range(3):
        port[f"t{i}"] = _make_booster(10 + i, scale=1.0 + i)
        jax_[f"t{i}"] = _make_booster(10 + i, scale=1.0 + i, mod=lgb)
    port["cat"], jax_["cat"] = _cat_booster(lgt), _cat_booster(lgb)
    for k in port:
        assert port[k][0].model_to_string() == \
            jax_[k][0].model_to_string(), k
    text = port["t0"][0].model_to_string()
    port["raw"] = (lgt.Booster(params=CPU, model_str=text), port["t0"][1])
    jax_["raw"] = (lgb.Booster(model_str=text), jax_["t0"][1])
    req = {k: x[:40] for k, (_b, x) in port.items()}
    base = len(_dispatchers())
    with jserve_fleet({k: b for k, (b, _x) in jax_.items()},
                      raw_score=True, linger_ms=30.0) as jfleet:
        futs = {k: jfleet.submit(k, req[k]) for k in jax_}
        want = {k: f.result(300) for k, f in futs.items()}
        jthreads = len(_dispatchers()) - base
    return {"port": port, "jax": jax_, "req": req, "want": want,
            "jax_fleet_threads": jthreads}


@pytest.fixture(scope="module")
def trio(world):
    return {k: world["port"][k] for k in ("t0", "t1", "t2")}


@pytest.fixture(scope="module")
def shapes():
    """Three port tenants of three shapes (three buckets)."""
    return {f"s{i}": _make_booster(60 + i, leaves=7 + 8 * i, trees=3 + i)
            for i in range(3)}


def _dispatchers():
    return [t for t in threading.enumerate()
            if t.name == "lgbm-serving-batcher" and t.is_alive()]


def _assert_jax_parity(world, fleet, names):
    """The port fleet's answer to each tenant's fixture request is the
    JAX fleet's and the tenant's own device prediction, bit for bit."""
    futs = {k: fleet.submit(k, world["req"][k]) for k in names}
    for k, f in futs.items():
        got = f.result(60)
        np.testing.assert_array_equal(got, world["want"][k], err_msg=k)
        np.testing.assert_array_equal(
            got, _dev(world["port"][k][0], world["req"][k]), err_msg=k)


# ---------------------------------------------------------------------------
# capacity bucketing units
# ---------------------------------------------------------------------------

def test_pow2_cap():
    assert forest.pow2_cap(1) == 1
    assert forest.pow2_cap(2) == 2
    assert forest.pow2_cap(3) == 4
    assert forest.pow2_cap(5, lo=4) == 8
    assert forest.pow2_cap(2, lo=4) == 4
    assert forest.pow2_cap(0) == 1
    for n in range(0, 70):
        assert forest.pow2_cap(n, 4) == jforest.pow2_cap(n, 4)


def test_tenant_shape_buckets_not_global_max():
    """Mixed shapes land in separate buckets sized to their own pow2
    caps, same-shape tenants on one key; each key is the JAX package's
    for the same trees."""
    small, _ = _make_booster(1, leaves=7, trees=3)
    big, _ = _make_booster(2, leaves=31, trees=20)
    ss = forest.tenant_shape(small._engine.models, 1, 6, "binned")
    bs = forest.tenant_shape(big._engine.models, 1, 6, "binned")
    assert ss != bs
    assert ss.leaf_cap <= 8 and bs.leaf_cap == 32
    assert ss.win_slots == 4 and bs.win_slots >= 32
    small2, _ = _make_booster(3, leaves=7, trees=3)
    assert forest.tenant_shape(small2._engine.models, 1, 6,
                               "binned") == ss
    for b in (small, big):
        assert tuple(forest.tenant_shape(b._engine.models, 1, 6, "raw")) \
            == tuple(jforest.tenant_shape(b._engine.models, 1, 6, "raw"))


def test_pad_window_refuses_overflow(shapes):
    models = shapes["s0"][0]._engine.models
    win = forest.pack_window_raw(models,
                                 forest.tenant_shape(models, 1, 6, "raw"))
    assert win.leaf_value.shape[0] == 4
    with pytest.raises(ValueError, match="exceeds its capacity"):
        forest.pad_window(win, 2)


def test_counters_tenant_dimension():
    c = ServingCounters()
    c.inc("shed", tenant="a")
    c.inc("shed")                       # global only
    c.inc_tenant("a", "requests")
    c.inc_tenant("b", "rows", 32)
    assert c.get("shed") == 2
    t = c.tenant_snapshot()
    assert t["a"]["shed"] == 1 and t["a"]["requests"] == 1
    assert t["b"]["rows"] == 32 and t["b"]["shed"] == 0
    assert c.get_tenant("a", "expired") == 0
    with pytest.raises(KeyError):
        c.inc_tenant("a", "not_a_counter")
    with pytest.raises(KeyError):
        c.inc("not_a_counter")


# ---------------------------------------------------------------------------
# cross-tenant coalescing: bit parity and one scorer call a group
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_fleet_mixed_shapes_bit_parity():
    """Mixed (leaves, trees, F) tenants in several buckets, each bit for
    bit its own predict(device=True) through one fleet."""
    tenants = {
        "small": _make_booster(20, n_features=5, leaves=7, trees=3),
        "mid": _make_booster(21, n_features=9, leaves=15, trees=8),
        "deep": _make_booster(22, n_features=5, leaves=63, trees=12),
        "twin": _make_booster(20, n_features=5, leaves=7, trees=3),
    }
    with serve_fleet({k: b for k, (b, _x) in tenants.items()},
                     raw_score=True, linger_ms=30.0) as fleet:
        assert fleet.stats()["n_tenants"] == 4
        assert fleet.stats()["n_buckets"] == 3
        futs = {k: fleet.submit(k, x[:40]) for k, (_b, x) in
                tenants.items()}
        for k, fut in futs.items():
            b, x = tenants[k]
            np.testing.assert_array_equal(fut.result(120), _dev(b, x[:40]))
        assert fleet.stats()["batches"] < len(tenants)


def test_fleet_objective_conversion_and_multiclass():
    """Converted responses ride each tenant's OWN objective: a binary
    and a 3-class tenant in one fleet match their boosters' outputs."""
    bin_b, bin_x = _make_booster(30, objective="binary")
    mc_b, mc_x = _make_booster(31, objective="multiclass")
    with serve_fleet({"bin": bin_b, "mc": mc_b}, linger_ms=20.0) as fleet:
        got_bin = fleet.predict("bin", bin_x[:32], timeout=120)
        got_mc = fleet.predict("mc", mc_x[:32], timeout=120)
        assert fleet.tenant_stats("mc")["bucket"]["k"] == 3
    np.testing.assert_array_equal(got_bin,
                                  bin_b.predict(bin_x[:32], device=True))
    assert got_mc.shape == (32, 3)
    np.testing.assert_array_equal(got_mc, mc_b.predict(mc_x[:32],
                                                       device=True))


def test_fleet_categorical_tenant_shares_bucket_with_numeric(world):
    """A tenant with categorical splits (bitsets of words) coalesces with
    a numeric tenant of its shape: the numeric window grows empty words,
    both answer bit for bit (the JAX fleet's answers too, NaN routing
    included), and the categorical tenant's explanation is its host
    walk's."""
    port = world["port"]
    cat_b, Xc = port["cat"]
    assert any(t.num_cat > 0 for t in cat_b._engine.models)
    with serve_fleet({"cat": cat_b, "t0": port["t0"][0]}, raw_score=True,
                     linger_ms=30.0) as fleet:
        assert fleet.stats()["n_buckets"] == 1
        key = fleet._state.routes["cat"].key
        assert forest.window_cat_width(fleet._state.buckets[key].host) == 1
        _assert_jax_parity(world, fleet, ["cat", "t0"])
        np.testing.assert_array_equal(
            fleet.predict("cat", Xc[100:148], timeout=60),
            _dev(cat_b, Xc[100:148]))
        np.testing.assert_array_equal(
            fleet.explain("cat", Xc[:20], timeout=60),
            cat_b.predict(Xc[:20], pred_contrib=True, device=True))
        assert fleet.counters.get_tenant("cat", "explain_degraded") == 1


def test_fleet_raw_route_loaded_models(world):
    """Mapperless (loaded) tenants serve by the fleet's raw route, bit
    for bit their own device predict and the JAX fleet's answers; their
    explanations are their device pred_contrib array for array; f64-only
    values are refused at submit."""
    port = world["port"]
    l1, x1 = port["raw"]
    l2 = lgt.Booster(params=CPU, model_str=port["t1"][0].model_to_string())
    x2 = port["t1"][1]
    with serve_fleet({"raw": l1, "b": l2}, raw_score=True,
                     linger_ms=20.0) as fleet:
        assert fleet._state.routes["raw"].key.kind == "raw"
        _assert_jax_parity(world, fleet, ["raw"])
        np.testing.assert_array_equal(fleet.predict("b", x2[:40], timeout=60),
                                      _dev(l2, x2[:40]))
        np.testing.assert_array_equal(
            fleet.explain("b", x2[:25], timeout=60),
            l2.predict(x2[:25], pred_contrib=True, device=True))
        bad = np.asarray(x1[:4], np.float64).copy()
        bad[0, 0] = 1.0 + 1e-12
        with pytest.raises(ValueError, match="float32-representable"):
            fleet.submit("raw", bad)


def test_fleet_refuses_loaded_categorical_tenant(world):
    """A loaded model with a categorical split cannot take the raw route
    (its bitsets are over raw categories): add_tenant refuses it, as the
    JAX fleet does (ValueError there, DeviceRouteUnavailable here), and
    the fleet is left as it was."""
    text = world["port"]["cat"][0].model_to_string()
    with pytest.raises(ValueError, match="categorical"):
        jserve_fleet({"c": lgb.Booster(model_str=text)})
    with serve_fleet({"t0": world["port"]["t0"][0]}, raw_score=True) as fleet:
        with pytest.raises(DeviceRouteUnavailable, match="categorical"):
            fleet.add_tenant("c", lgt.Booster(params=CPU, model_str=text))
        assert fleet.tenants == ("t0",)
        _assert_jax_parity(world, fleet, ["t0"])


def test_fleet_one_scorer_call_per_bucket_group(world, monkeypatch):
    """The torch counterpart of the JAX fleet's flat trace budget: a
    coalesced batch of one bucket is scored by ONE scorer call, however
    many tenants it carries, also after a hot-swap within capacity."""
    port = world["port"]
    calls = []
    run = forest._fleet_scores_binned

    def counted(*a, **k):
        calls.append(a[5].shape[0])
        return run(*a, **k)

    monkeypatch.setattr(forest, "_fleet_scores_binned", counted)
    with serve_fleet({k: port[k][0] for k in ("t0", "t1", "t2")},
                     raw_score=True, linger_ms=200.0) as fleet:
        assert fleet.stats()["n_buckets"] == 1
        _assert_jax_parity(world, fleet, ["t0", "t1", "t2"])
        assert fleet.stats()["batches"] == 1
        assert calls == [120]
        b0, x0 = port["t0"]
        b0.update()
        try:
            fleet.publish("t0")
            calls.clear()
            futs = [fleet.submit(k, port[k][1][:10 + 31 * j])
                    for j, k in enumerate(("t0", "t1", "t2"))]
            for f in futs:
                f.result(60)
            assert len(calls) == fleet.stats()["batches"] - 1
            np.testing.assert_array_equal(futs[0].result(), _dev(b0, x0[:10]))
        finally:
            b0.rollback_one_iter()


# ---------------------------------------------------------------------------
# isolation: one tenant's failure never touches coalesced peers
# ---------------------------------------------------------------------------

def test_fleet_malformed_request_fails_its_submitter_only(world, trio):
    with serve_fleet({k: b for k, (b, _x) in trio.items()},
                     raw_score=True, linger_ms=20.0) as fleet:
        with pytest.raises(ValueError, match="rows, 6"):
            fleet.submit("t0", trio["t0"][1][:8, :4])
        with pytest.raises(KeyError):
            fleet.submit("nope", trio["t0"][1][:8])
        with pytest.raises(ValueError, match="unknown request kind"):
            fleet.submit("t0", trio["t0"][1][:8], kind="leaf")
        f1 = fleet.submit("t1", trio["t1"][1][:24])
        np.testing.assert_array_equal(f1.result(120),
                                      _dev(trio["t1"][0], trio["t1"][1][:24]))
        _assert_jax_parity(world, fleet, ["t0", "t1", "t2"])


def test_fleet_expired_tenant_never_poisons_peers(trio):
    """Tenant t0's expired request is dropped at pop time; the t1 rows it
    would have coalesced with stay bit for bit."""
    with serve_fleet({k: b for k, (b, _x) in trio.items()},
                     raw_score=True, linger_ms=1.0) as fleet:
        with faults.inject("slow_dispatch:sec=0.4:n=1"):
            slow = fleet.submit("t2", trio["t2"][1][:48])
            end = time.monotonic() + 5
            while fleet.stats()["queued_rows"] and time.monotonic() < end:
                time.sleep(0.005)
            time.sleep(0.05)
            dead = fleet.submit("t0", trio["t0"][1][:32], deadline_ms=40.0)
            good = fleet.submit("t1", trio["t1"][1][64:128])
            got_slow = slow.result(60)
            got_good = good.result(60)
        with pytest.raises(DeadlineExceeded):
            dead.result(60)
        np.testing.assert_array_equal(
            got_slow, _dev(trio["t2"][0], trio["t2"][1][:48]))
        np.testing.assert_array_equal(
            got_good, _dev(trio["t1"][0], trio["t1"][1][64:128]))
        t = fleet.counters.tenant_snapshot()
        assert t["t0"]["expired"] == 1
        assert t["t1"]["expired"] == 0 and t["t2"]["expired"] == 0


def test_fleet_publish_fail_isolated_per_tenant(world):
    """An injected publish_fail rolls ONE tenant back: its old generation
    keeps serving, the others' versions and answers are untouched; the
    retried publish serves the new trees."""
    port = world["port"]
    b0, x0 = port["t0"]
    with serve_fleet({k: port[k][0] for k in ("t0", "t1", "t2")},
                     raw_score=True, linger_ms=5.0) as fleet:
        _assert_jax_parity(world, fleet, ["t0", "t1"])
        before0 = fleet.predict("t0", x0[:40], timeout=120)
        v1 = fleet._state.routes["t1"].generation.version
        b0.update()
        try:
            with faults.inject("publish_fail:n=1"):
                with pytest.raises(faults.FaultInjected):
                    fleet.publish("t0")
            np.testing.assert_array_equal(
                fleet.predict("t0", x0[:40], timeout=120), before0)
            t = fleet.counters.tenant_snapshot()
            assert t["t0"]["publish_failures"] == 1
            assert t["t1"]["publish_failures"] == 0
            assert fleet._state.routes["t1"].generation.version == v1
            _assert_jax_parity(world, fleet, ["t1"])
            info = fleet.publish("t0")
            assert info.version == 2
            np.testing.assert_array_equal(
                fleet.predict("t0", x0[:40], timeout=120), _dev(b0, x0[:40]))
        finally:
            b0.rollback_one_iter()


def test_fleet_hot_swap_under_cross_tenant_load():
    """Continuous publishes of one tenant under another tenant's traffic:
    no failed or torn response on either, versions only move forward."""
    b0, x0 = _make_booster(50, trees=3)
    b1, x1 = _make_booster(51, trees=3)
    with serve_fleet({"pub": b0, "steady": b1}, raw_score=True,
                     linger_ms=2.0) as fleet:
        expected_pub = {1: _dev(b0, x0[:32])}
        steady_ref = _dev(b1, x1[:32])
        stop = threading.Event()
        errors = []

        def client(name, x, sink):
            while not stop.is_set():
                try:
                    fut = fleet.submit(name, x[:32])
                    sink.append((fut.result(120), fut.generation))
                except Exception as e:  # noqa: BLE001
                    errors.append(repr(e))
                    return

        pub_seen, steady_seen = [], []
        threads = [threading.Thread(target=client,
                                    args=("pub", x0, pub_seen), daemon=True),
                   threading.Thread(target=client,
                                    args=("steady", x1, steady_seen),
                                    daemon=True)]
        for t in threads:
            t.start()
        for _ in range(3):
            time.sleep(0.05)
            b0.update()
            info = fleet.publish("pub")
            expected_pub[info.version] = _dev(b0, x0[:32])
        time.sleep(0.1)
        stop.set()
        for t in threads:
            t.join(60)
        assert not errors and pub_seen and steady_seen, errors[:1]
        versions = [g.version for _o, g in pub_seen]
        assert versions == sorted(versions)
        for out, gen in pub_seen:
            np.testing.assert_array_equal(out, expected_pub[gen.version])
        for out, gen in steady_seen:
            assert gen.version == 1
            np.testing.assert_array_equal(out, steady_ref)


def test_fleet_degrade_host_walk_parity_and_recovery(trio):
    """Forced degradation serves every tenant by ITS host walk (its
    Booster.predict raw, bit for bit), counts degraded batches per
    tenant, and the background probe un-degrades."""
    with serve_fleet({k: b for k, (b, _x) in trio.items()},
                     raw_score=True, linger_ms=10.0,
                     probe_interval_s=0.05) as fleet:
        fleet.degrade("test drill")
        futs = {k: fleet.submit(k, trio[k][1][:24]) for k in trio}
        for k, fut in futs.items():
            np.testing.assert_array_equal(
                fut.result(120),
                trio[k][0].predict(trio[k][1][:24], raw_score=True))
        t = fleet.counters.tenant_snapshot()
        assert all(t[k]["degraded_batches"] >= 1 for k in trio)
        end = time.monotonic() + 10
        while fleet.stats()["degraded"] and time.monotonic() < end:
            time.sleep(0.01)
        assert not fleet.stats()["degraded"]
        assert fleet.counters.get("recoveries") == 1


# ---------------------------------------------------------------------------
# per-tenant admission quota and exact three-tenant accounting
# ---------------------------------------------------------------------------

def test_fleet_tenant_quota_sheds_one_tenant_only(trio):
    with serve_fleet({k: b for k, (b, _x) in trio.items()},
                     raw_score=True, linger_ms=1.0) as fleet:
        fleet._tenants["t0"].quota_rows = 64
        with faults.inject("slow_dispatch:sec=0.4:n=1"):
            wedge = fleet.submit("t1", trio["t1"][1][:16])
            end = time.monotonic() + 5
            while fleet.stats()["queued_rows"] and time.monotonic() < end:
                time.sleep(0.005)
            q0 = fleet.submit("t0", trio["t0"][1][:64])
            with pytest.raises(Overloaded, match="tenant 't0'"):
                fleet.submit("t0", trio["t0"][1][:8])
            q1 = fleet.submit("t1", trio["t1"][1][:64])
            q2 = fleet.submit("t2", trio["t2"][1][:64])
            for f in (wedge, q0, q1, q2):
                assert f.result(60) is not None
        t = fleet.counters.tenant_snapshot()
        assert t["t0"]["shed"] == 1
        assert t["t1"]["shed"] == 0 and t["t2"]["shed"] == 0


def test_fleet_exact_three_tenant_accounting(trio):
    """Every request lands in exactly one entry of its tenant's ledger,
    and the ledgers reconcile EXACTLY with what each client saw."""
    with serve_fleet({k: b for k, (b, _x) in trio.items()},
                     raw_score=True, linger_ms=2.0) as fleet:
        fleet._tenants["t2"].quota_rows = 48
        observed = {k: {"requests": 0, "rows": 0, "shed": 0,
                        "expired": 0} for k in trio}
        with faults.inject("slow_dispatch:sec=0.3:n=1"):
            wedge = fleet.submit("t0", trio["t0"][1][:16])
            observed["t0"]["requests"] += 1
            observed["t0"]["rows"] += 16
            end = time.monotonic() + 5
            while fleet.stats()["queued_rows"] and time.monotonic() < end:
                time.sleep(0.005)
            time.sleep(0.05)
            pend = []
            for k, n, dl in (("t0", 16, None), ("t0", 8, None),
                             ("t1", 24, None), ("t1", 8, 30.0),
                             ("t2", 40, None)):
                pend.append((k, n, fleet.submit(k, trio[k][1][:n],
                                                deadline_ms=dl)))
            try:
                fleet.submit("t2", trio["t2"][1][:16])
                observed["t2"]["requests"] += 1
                observed["t2"]["rows"] += 16
            except Overloaded:
                observed["t2"]["shed"] += 1
            wedge.result(60)
            for k, n, fut in pend:
                try:
                    fut.result(60)
                    observed[k]["requests"] += 1
                    observed[k]["rows"] += n
                except DeadlineExceeded:
                    observed[k]["expired"] += 1
        ledger = fleet.counters.tenant_snapshot()
        for k in trio:
            for name in ("requests", "rows", "shed", "expired"):
                assert ledger[k][name] == observed[k][name], \
                    (k, name, ledger[k], observed[k])
        assert sum(o["expired"] for o in observed.values()) == 1
        assert sum(o["shed"] for o in observed.values()) == 1


# ---------------------------------------------------------------------------
# placement on a [cpu, cpu] mesh
# ---------------------------------------------------------------------------

def test_fleet_auto_shard_by_pack_budget(world):
    """auto placement replicates under the pack budget and model-shards
    past it on a two-device mesh; the answers are the same bits either
    way (the JAX fleet's too); an unknown placement is refused."""
    port = world["port"]
    boosters = {k: port[k][0] for k in ("t0", "t1", "raw")}
    with serve_fleet(boosters, raw_score=True, devices=CPU2,
                     pack_budget_mb=1024.0) as fleet:
        assert fleet.stats()["fleet_shard"] == "replicate"
        assert fleet.stats()["mesh_devices"] == 2
        _assert_jax_parity(world, fleet, list(boosters))
    with serve_fleet(boosters, raw_score=True, devices=CPU2,
                     pack_budget_mb=1e-6) as fleet:
        assert fleet.stats()["fleet_shard"] == "model"
        assert all(b.owner is not None
                   for b in fleet._state.buckets.values())
        _assert_jax_parity(world, fleet, list(boosters))
        np.testing.assert_array_equal(
            fleet.explain("t1", port["t1"][1][:30], timeout=60),
            port["t1"][0].predict(port["t1"][1][:30], pred_contrib=True,
                                  device=True))
    with serve_fleet(boosters, raw_score=True, pack_budget_mb=1e-6) as fleet:
        assert fleet.stats()["fleet_shard"] == "replicate"   # one device
    with pytest.raises(ValueError, match="auto|replicate|model"):
        FleetServer(fleet_shard="sideways", device="cpu")


def test_fleet_shard_flip_distributes_buckets(shapes):
    """A replicate -> model flip spreads the buckets over the mesh by one
    balanced assignment, never piling the fleet onto device 0."""
    with serve_fleet({k: b for k, (b, _x) in shapes.items()},
                     raw_score=True, devices=CPU2,
                     pack_budget_mb=1024.0) as fleet:
        assert fleet.stats()["fleet_shard"] == "replicate"
        assert fleet.stats()["n_buckets"] == 3
        fleet._pack_budget = 0.0          # the next publish crosses it
        fleet.publish("s0")
        st = fleet._state
        assert st.shard == "model"
        owners = {b.owner for b in st.buckets.values()}
        assert None not in owners and owners == {0, 1}, owners
        for k, (b, x) in shapes.items():
            np.testing.assert_array_equal(
                fleet.predict(k, x[:24], timeout=60), _dev(b, x[:24]))


# ---------------------------------------------------------------------------
# tenant lifecycle and Booster.serve(fleet=)
# ---------------------------------------------------------------------------

def test_serve_fleet_autoname_survives_removal(trio):
    with serve_fleet({"t0": trio["t0"][0]}, raw_score=True) as fleet:
        h1 = trio["t1"][0].serve(fleet=fleet)                # tenant1
        h2 = trio["t2"][0].serve(fleet=fleet)                # tenant2
        assert (h1.name, h2.name) == ("tenant1", "tenant2")
        h1.close()
        h3 = trio["t1"][0].serve(fleet=fleet)               # must not raise
        assert h3.name in fleet.tenants and h3.name != h2.name


def test_served_booster_still_pickles(trio):
    """serve() keeps the live server on the booster; pickling and
    deepcopy still work (the server is process state, not model)."""
    import copy
    b, x = trio["t0"]
    srv = b.serve(linger_ms=1.0, raw_score=True)
    try:
        clone = pickle.loads(pickle.dumps(b))
        np.testing.assert_allclose(clone.predict(x[:8]), b.predict(x[:8]))
        assert getattr(clone, "_live_server", None) is None
        copy.deepcopy(b)
    finally:
        srv.close()


def test_fleet_publish_grows_window_bucket_move(trio):
    """A tenant that outgrows its window moves to a bigger bucket at
    publish; its answers stay bit for bit and its neighbour stays."""
    b, x = _make_booster(60, trees=4)    # win_slots 4
    with serve_fleet({"grow": b, "stay": trio["t0"][0]},
                     raw_score=True, linger_ms=5.0) as fleet:
        key0 = fleet._state.routes["grow"].key
        stay0 = fleet._state.routes["stay"].key
        for _ in range(5):               # 9 trees > 4 slots
            b.update()
        fleet.publish("grow")
        key1 = fleet._state.routes["grow"].key
        assert key1.win_slots > key0.win_slots
        assert fleet._state.routes["stay"].key == stay0
        np.testing.assert_array_equal(fleet.predict("grow", x[:32],
                                                    timeout=120),
                                      _dev(b, x[:32]))
        np.testing.assert_array_equal(
            fleet.predict("stay", trio["t0"][1][:32], timeout=120),
            _dev(trio["t0"][0], trio["t0"][1][:32]))


def test_fleet_level_knobs_reach_tenants(trio):
    """A fleet-level deadline reaches tenants whose boosters never set
    one; a booster's explicitly set param still wins."""
    with serve_fleet({"t0": trio["t0"][0]}, raw_score=True,
                     deadline_ms=500.0) as fleet:
        assert fleet._tenants["t0"].deadline_ms == 500.0
    explicit = lgt.Booster(params=dict(CPU, tpu_serving_deadline_ms=250.0),
                           model_str=trio["t1"][0].model_to_string())
    with serve_fleet({"t0": trio["t0"][0]}, raw_score=True,
                     deadline_ms=500.0) as fleet:
        h = explicit.serve(fleet=fleet, tenant="exp")
        assert fleet._tenants["exp"].deadline_ms == 250.0
        assert h.stats()["deadline_ms"] == 250.0


def test_fleet_remove_tenant(world, trio):
    fleet = serve_fleet({k: b for k, (b, _x) in trio.items()},
                        raw_score=True, linger_ms=5.0)
    try:
        TenantHandle(fleet, "t1").close()
        assert "t1" not in fleet.tenants
        with pytest.raises(KeyError):
            fleet.submit("t1", trio["t1"][1][:8])
        route = fleet._state.routes["t2"]
        assert route.lo == route.key.win_slots      # slot 1 of the bucket
        np.testing.assert_array_equal(
            fleet.predict("t2", trio["t2"][1][:24], timeout=120),
            _dev(trio["t2"][0], trio["t2"][1][:24]))
        _assert_jax_parity(world, fleet, ["t0", "t2"])
    finally:
        fleet.close()


def test_second_serve_returns_live_server_no_second_dispatcher(world):
    """A fleet starts as many dispatcher threads as the JAX FleetServer
    really starts (two: score and explain), a tenant added with
    serve(fleet=) starts none, and a booster's second serve() returns
    its live solo server without a third."""
    port = world["port"]
    assert world["jax_fleet_threads"] == 2
    b, x = port["t0"]
    base = len(_dispatchers())
    with serve_fleet({"t1": port["t1"][0]}, raw_score=True) as fleet:
        assert len(_dispatchers()) == base + 2
        b.serve(fleet=fleet, tenant="t0")
        assert len(_dispatchers()) == base + 2
        srv = b.serve(linger_ms=1.0, raw_score=True)
        try:
            assert b.serve() is srv
            assert len(_dispatchers()) == base + 4
            np.testing.assert_array_equal(srv.predict(x[:16], timeout=60),
                                          fleet.predict("t0", x[:16],
                                                        timeout=60))
        finally:
            srv.close()
    assert len(_dispatchers()) == base


# ---------------------------------------------------------------------------
# the memory budget and cold-tenant eviction
# ---------------------------------------------------------------------------

def test_fleet_evicted_then_rebuilt_bucket_bit_identical(shapes):
    """Under a budget too small for every pack, cold buckets are evicted
    (host pack kept) and rebuilt at the next touch: every answer stays
    bit for bit its tenant's, generations kept."""
    with serve_fleet({k: b for k, (b, _x) in shapes.items()},
                     raw_score=True, linger_ms=10.0,
                     mem_budget_mb=1e-4) as fleet:
        st = fleet.stats()
        assert st["n_buckets"] == 3
        assert st["evicted_buckets"] >= 1, st
        assert st["resident_pack_bytes"] <= st["pack_bytes"]
        for _ in range(2):
            for name, (b, x) in shapes.items():
                np.testing.assert_array_equal(
                    fleet.predict(name, x[:64], timeout=120),
                    _dev(b, x[:64]), err_msg=name)
                assert fleet.tenant_stats(name)["generation"] == 1
        st = fleet.stats()
        assert st["evictions"] >= 1 and st["rebuilds"] >= 1, st


def test_fleet_hot_swap_of_evicted_tenant_lands(shapes):
    """publish() of a tenant whose bucket is evicted builds and serves the
    NEW generation."""
    with serve_fleet({k: b for k, (b, _x) in shapes.items()},
                     raw_score=True, linger_ms=10.0,
                     mem_budget_mb=1e-4) as fleet:
        state = fleet._state
        name = next(n for n, r in state.routes.items()
                    if state.buckets[r.key].dev is None)
        b, x = shapes[name]
        b.update()
        try:
            assert fleet.publish(name).version == 2
            np.testing.assert_array_equal(fleet.predict(name, x[:48],
                                                        timeout=120),
                                          _dev(b, x[:48]))
            assert fleet.tenant_stats(name)["generation"] == 2
        finally:
            b.rollback_one_iter()


def test_fleet_eviction_never_strands_inflight_batch(shapes):
    """A dispatch wedged in flight keeps the OLD state's pack; a
    concurrent publish that evicts that bucket cannot strand it."""
    (b0, x0), (b1, _x1) = shapes["s0"], shapes["s1"]
    with serve_fleet({"s0": b0, "s1": b1}, raw_score=True, linger_ms=1.0,
                     mem_budget_mb=1e-4) as fleet:
        b1.update()
        try:
            with faults.inject("slow_dispatch:sec=0.5:n=1"):
                slow = fleet.submit("s0", x0[:48])
                time.sleep(0.1)
                fleet.publish("s1")
                got = slow.result(120)
        finally:
            b1.rollback_one_iter()
        np.testing.assert_array_equal(got, _dev(b0, x0[:48]))
        np.testing.assert_array_equal(fleet.predict("s0", x0[:48],
                                                    timeout=120),
                                      _dev(b0, x0[:48]))


def test_fleet_oom_floor_host_walks_one_request_peers_on_device(world,
                                                                trio):
    """oom:n=2 fails the 2-request group and its left half: that request
    is host-walked ALONE, its coalesced peer retries clean on the device.
    No degrade."""
    (b0, x0), (b1, x1) = trio["t0"], trio["t1"]
    with serve_fleet({"t0": b0, "t1": b1}, raw_score=True,
                     linger_ms=200.0) as fleet:
        fleet.predict("t0", x0[:32], timeout=120)
        with faults.inject("oom:p=1:n=2"):
            f0 = fleet.submit("t0", x0[:32])
            f1 = fleet.submit("t1", x1[:32])
            r0, r1 = f0.result(120), f1.result(120)
        st = fleet.stats()
        assert st["oom_bisects"] == 1
        assert not st["degraded"]
        _assert_jax_parity(world, fleet, ["t0", "t1"])
    np.testing.assert_array_equal(r0, b0.predict(x0[:32], raw_score=True))
    np.testing.assert_array_equal(r1, _dev(b1, x1[:32]))


def test_fleet_publish_forced_eviction_instead_of_failing(shapes):
    """A pack upload that OOMs at publish evicts the coldest resident pack
    and retries: the new generation lands instead of the publish
    failing, and the evicted peer rebuilds exactly."""
    (b0, x0), (b1, x1) = shapes["s0"], shapes["s1"]
    with serve_fleet({"p0": b0, "p1": b1}, raw_score=True,
                     linger_ms=10.0) as fleet:
        b0.update()
        try:
            with faults.inject("oom:n=1"):
                assert fleet.publish("p0").version == 2
            assert fleet.stats()["evictions"] >= 1
            assert fleet.counters.get("publish_failures") == 0
            np.testing.assert_array_equal(fleet.predict("p0", x0[:48],
                                                        timeout=120),
                                          _dev(b0, x0[:48]))
        finally:
            b0.rollback_one_iter()
        np.testing.assert_array_equal(fleet.predict("p1", x1[:48],
                                                    timeout=120),
                                      _dev(b1, x1[:48]))
