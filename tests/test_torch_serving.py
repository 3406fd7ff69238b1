"""The serving tier of the PyTorch port (``lightgbm_tpu_torch/serving``),
case for case the port's counterpart of ``tests/test_serving.py``: the
micro-batcher's coalescing, oversize, drain, deadline, overload, close
and late-dispatch cases; the server's answers equal to
``predict(device=True)`` bit for bit, converted outputs, hot-swap never
torn, publish after a rollback, a loaded model's raw route, knobs from
params, timeout slot reclaim; the failure path (``publish_fail``
rollback, degraded answers equal to the host walk, retry exhaustion,
transient retry, non-transient failure, the OOM bisection, the recovery
probe under ``probe_timeout``); a ``[cpu, cpu]`` mesh equal to no mesh;
and the slice against the JAX package: the same model served by the
JAX ``ModelServer`` and by the port's gives the same raw scores bit for
bit on the CPU.

Every server is closed in ``with`` or ``finally``; linger, probe and
deadline values are milliseconds and no test sleeps longer than 0.5 s.
"""
import threading
import time

import numpy as np
import pytest

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.robustness import faults
from lightgbm_tpu_torch.robustness.retry import RetryPolicy
from lightgbm_tpu_torch.serving import (DeadlineExceeded, Generation,
                                        MicroBatcher, ModelServer,
                                        Overloaded, ShutdownError,
                                        latency_summary_ms, percentile)
from lightgbm_tpu_torch.utils.log import LightGBMError

CPU = {"device_type": "cpu"}
PARAMS = {"objective": "regression", "num_leaves": 31, "verbose": -1,
          "min_data_in_leaf": 5, **CPU}


def _data(seed, n, f):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32).astype(np.float64)
    return rng, X


@pytest.fixture(scope="module")
def booster():
    rng, X = _data(7, 1500, 8)
    y = X[:, 0] + 0.5 * X[:, 1] ** 2 + 0.1 * rng.normal(size=len(X))
    bst = lgt.train(PARAMS, lgt.Dataset(X, label=y), num_boost_round=5)
    return bst, X, y


@pytest.fixture(scope="module")
def training_booster():
    """A booster that keeps its training data, for hot-swaps; each test
    that trains more restores it with ``rollback_one_iter``."""
    _, X = _data(3, 800, 6)
    y = X[:, 0] - X[:, 1]
    bst = lgt.train(dict(PARAMS, num_leaves=15), lgt.Dataset(X, label=y),
                    num_boost_round=3, keep_training_booster=True)
    return bst, X, y


# ---------------------------------------------------------------------------
# percentile math units
# ---------------------------------------------------------------------------

def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert percentile(xs, 50) == 50
    assert percentile(xs, 99) == 99
    assert percentile(xs, 99.9) == 100
    assert percentile(xs, 100) == 100
    assert percentile(xs, 0) == 1
    assert percentile([42.0], 99.9) == 42.0
    assert np.isnan(percentile([], 50))
    assert percentile([5, 1, 3, 2, 4], 50) == 3


def test_percentile_is_an_observed_sample():
    xs = [1.0, 10.0, 100.0, 1000.0]
    for q in (1, 25, 50, 75, 99, 99.9):
        assert percentile(xs, q) in xs


def test_latency_summary_keys_and_units():
    s = latency_summary_ms([0.001] * 999 + [0.5])
    assert s["n"] == 1000
    assert s["p50_ms"] == 1.0
    assert s["p99_ms"] == 1.0
    assert s["p999_ms"] == 500.0
    assert s["max_ms"] == 500.0
    assert latency_summary_ms([])["n"] == 0


# ---------------------------------------------------------------------------
# micro-batcher mechanics (spy dispatch, no device)
# ---------------------------------------------------------------------------

def test_batcher_coalesces_and_respects_max_batch():
    batches = []

    def dispatch(X):
        batches.append(X.shape[0])
        return X[:, 0], Generation(1, 0, 0)

    mb = MicroBatcher(dispatch, max_batch=100, linger_ms=200.0)
    reqs = [mb.submit(np.full((30, 2), i, float)) for i in range(5)]
    vals = [r.result(10) for r in reqs]
    mb.close()
    assert max(batches) <= 100
    assert sum(batches) == 150
    assert len(batches) >= 2
    for i, v in enumerate(vals):
        assert v.shape == (30,) and np.all(v == i)
    assert mb.n_batches == len(batches)


def test_batcher_oversize_request_is_its_own_batch():
    sizes = []

    def dispatch(X):
        sizes.append(X.shape[0])
        return X[:, 0], None

    mb = MicroBatcher(dispatch, max_batch=64, linger_ms=1.0)
    r = mb.submit(np.zeros((300, 2)))
    assert r.result(10).shape == (300,)
    mb.close()
    assert sizes == [300]


def test_batcher_queue_drains_on_shutdown():
    slow = threading.Event()

    def dispatch(X):
        slow.wait(0.01)
        return X[:, 0], None

    mb = MicroBatcher(dispatch, max_batch=8, linger_ms=0.0)
    reqs = [mb.submit(np.zeros((4, 2))) for _ in range(40)]
    mb.close(timeout=30)
    assert all(r.done() for r in reqs)
    assert all(r.result(0).shape == (4,) for r in reqs)
    with pytest.raises(RuntimeError):
        mb.submit(np.zeros((4, 2)))


def test_batcher_dispatch_error_fails_the_batch_only():
    calls = []

    def dispatch(X):
        calls.append(X.shape[0])
        if len(calls) == 1:
            raise RuntimeError("boom")
        return X[:, 0], None

    mb = MicroBatcher(dispatch, max_batch=1000, linger_ms=50.0)
    bad = mb.submit(np.zeros((3, 2)))
    with pytest.raises(RuntimeError, match="boom"):
        bad.result(10)
    ok = mb.submit(np.zeros((3, 2)))
    assert ok.result(10).shape == (3,)
    mb.close()
    assert mb.n_errors == 1


def test_batcher_rejects_empty_requests():
    mb = MicroBatcher(lambda X: (X[:, 0], None))
    try:
        with pytest.raises(ValueError):
            mb.submit(np.zeros((0, 2)))
        with pytest.raises(ValueError):
            mb.submit(np.zeros(3))
    finally:
        mb.close()


def _gated_batcher(max_batch=1000, linger_ms=5.0, **kw):
    """A batcher whose dispatch blocks on an Event: the test decides when
    the dispatcher is stuck mid-batch."""
    gate = threading.Event()
    entered = threading.Event()
    dispatched = []

    def dispatch(X):
        entered.set()
        gate.wait(30)
        dispatched.append(X.shape[0])
        return X[:, 0], None

    mb = MicroBatcher(dispatch, max_batch=max_batch, linger_ms=linger_ms,
                      **kw)
    return mb, gate, entered, dispatched


def _drain_to_dispatcher(mb, timeout=5.0):
    end = time.monotonic() + timeout
    while mb.stats()["queued_rows"] and time.monotonic() < end:
        time.sleep(0.005)
    assert mb.stats()["queued_rows"] == 0


def test_batcher_expired_request_never_coalesced():
    mb, gate, entered, dispatched = _gated_batcher()
    try:
        blocker = mb.submit(np.zeros((7, 2)))
        assert entered.wait(5)
        _drain_to_dispatcher(mb)
        bad = mb.submit(np.zeros((3, 2)), deadline_sec=0.05)
        good = mb.submit(np.zeros((5, 2)))
        time.sleep(0.15)                  # bad expires while queued
        gate.set()
        assert good.result(10).shape == (5,)
        assert blocker.result(10).shape == (7,)
        with pytest.raises(DeadlineExceeded, match="DEADLINE_EXCEEDED"):
            bad.result(10)
        assert 3 not in dispatched, dispatched
        assert mb.counters.get("expired") == 1
    finally:
        gate.set()
        mb.close()


def test_batcher_overload_fails_fast_with_queue_depth():
    mb, gate, entered, _ = _gated_batcher(max_queue_rows=16)
    try:
        blocker = mb.submit(np.zeros((4, 2)))
        assert entered.wait(5)
        _drain_to_dispatcher(mb)
        q1 = mb.submit(np.zeros((8, 2)))
        q2 = mb.submit(np.zeros((8, 2)))
        with pytest.raises(Overloaded, match="OVERLOADED.*16 rows"):
            mb.submit(np.zeros((1, 2)))
        assert mb.counters.get("shed") == 1
        gate.set()
        for r in (blocker, q1, q2):
            assert r.result(10) is not None
    finally:
        gate.set()
        mb.close()


def test_batcher_oversize_request_admitted_when_idle():
    mb = MicroBatcher(lambda X: (X[:, 0], None), max_batch=64,
                      linger_ms=1.0, max_queue_rows=32)
    try:
        big = mb.submit(np.zeros((100, 2)))
        assert big.result(10).shape == (100,)
        assert mb.counters.get("shed") == 0
    finally:
        mb.close()


def test_batcher_close_not_deadlocked_by_blocked_submitter():
    mb, gate, entered, _ = _gated_batcher(max_batch=2, linger_ms=0.0,
                                          queue_depth=2)
    try:
        first = mb.submit(np.zeros((2, 2)))
        assert entered.wait(5)
        _drain_to_dispatcher(mb)
        queued = [mb.submit(np.zeros((2, 2))) for _ in range(2)]
        late = []

        def blocked_submit():
            late.append(mb.submit(np.zeros((2, 2))))

        t = threading.Thread(target=blocked_submit, daemon=True)
        t.start()
        time.sleep(0.1)
        t0 = time.perf_counter()
        mb.close(timeout=0.3)
        assert time.perf_counter() - t0 < 10, "close() deadlocked"
        t.join(5)
        assert not t.is_alive(), "submitter still blocked after close"
        for r in [first] + queued + late:
            assert r.done()
            with pytest.raises(ShutdownError):
                r.result(0)
    finally:
        gate.set()


def test_batcher_late_dispatch_never_double_accounts_shutdown():
    mb, gate, entered, _ = _gated_batcher(max_batch=4, linger_ms=0.0)
    try:
        reqs = [mb.submit(np.zeros((2, 2))) for _ in range(4)]
        assert entered.wait(5)
        mb.close(timeout=0.2)
        assert all(r.done() for r in reqs)
        assert mb.counters.get("shutdown_failed") == 4
        gate.set()
        mb._thread.join(10)
        assert not mb._thread.is_alive()
        assert mb.n_requests == 0
        assert mb.latency.total == 0
        for r in reqs:
            with pytest.raises(ShutdownError):
                r.result(0)
    finally:
        gate.set()


def test_nontransient_dispatch_error_fails_batch_not_degrades():
    def dispatch(X):
        raise ValueError("a code bug, not a flaky device")

    mb = MicroBatcher(dispatch, max_batch=100, linger_ms=1.0)
    try:
        r = mb.submit(np.zeros((3, 2)))
        with pytest.raises(ValueError, match="code bug"):
            r.result(10)
    finally:
        mb.close()
    assert mb.n_errors == 1


def test_batcher_close_timeout_fails_pending_with_shutdown():
    mb, gate, entered, _ = _gated_batcher(max_batch=4, linger_ms=0.0)
    try:
        reqs = [mb.submit(np.zeros((2, 2))) for _ in range(6)]
        assert entered.wait(5)
        t0 = time.perf_counter()
        mb.close(timeout=0.3)
        assert time.perf_counter() - t0 < 10
        assert all(r.done() for r in reqs), "a client would block forever"
        for r in reqs:
            with pytest.raises(ShutdownError, match="SHUTDOWN"):
                r.result(0)
        assert mb.counters.get("shutdown_failed") == len(reqs)
    finally:
        gate.set()


# ---------------------------------------------------------------------------
# the server: bit identity, hot-swap, lifecycle
# ---------------------------------------------------------------------------

def test_microbatched_bit_identical_to_predict_device(booster):
    bst, X, _ = booster
    with bst.serve(linger_ms=100.0, raw_score=True) as srv:
        assert srv.device.type == "cpu" and srv.mesh is None
        reqs = [X[i * 83:(i + 1) * 83 + 7 * i] for i in range(5)]
        futs = [srv.submit(r) for r in reqs]
        for r, f in zip(reqs, futs):
            assert np.array_equal(
                f.result(60), bst.predict(r, device=True, raw_score=True))
        stats = srv.stats()
        assert stats["batches"] < len(reqs)       # coalescing happened
        assert stats["requests"] == len(reqs)
        assert stats["degraded_batches"] == stats["dispatch_failures"] == 0


def test_server_converted_output_matches_booster_predict(booster):
    bst, X, _ = booster
    with bst.serve(linger_ms=1.0) as srv:
        got = srv.predict(X[:200], timeout=60)
        assert np.array_equal(got, bst.predict(X[:200], device=True))


def test_server_hot_swap_under_load_never_torn(training_booster):
    b, Xb, _ = training_booster
    probe = Xb[:64]
    srv = b.serve(linger_ms=0.5, raw_score=True)
    expected = {srv.generation.version:
                b.predict(probe, device=True, raw_score=True)}
    stop = threading.Event()
    seen, errors = [], []

    def client():
        while not stop.is_set():
            try:
                f = srv.submit(probe)
                v = f.result(60)
                seen.append((f.generation.version, v))
            except Exception as e:     # noqa: BLE001
                errors.append(repr(e))
                return

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(3)]
    try:
        for t in threads:
            t.start()
        for _ in range(3):             # 3 new generations mid-load
            time.sleep(0.05)
            b.update()
            info = srv.publish()
            expected[info.version] = b.predict(probe, device=True,
                                               raw_score=True)
        time.sleep(0.1)
        stop.set()
        for t in threads:
            t.join(60)
        final = srv.submit(probe)
        final_out = final.result(60)
    finally:
        stop.set()
        srv.close()
        for _ in range(3):
            b.rollback_one_iter()
    assert not errors, errors
    assert seen
    versions = [v for v, _ in seen]
    for v, out in seen:
        assert v in expected
        assert np.array_equal(out, expected[v]), \
            f"response from generation {v} matches no published model"
    assert versions == sorted(versions)
    assert final.generation.version == 4
    assert np.array_equal(final_out, expected[4])


def test_server_publish_after_rollback_full_repack(training_booster):
    b, Xb, yb = training_booster
    n0 = b.num_trees()
    srv = b.serve(linger_ms=0.5, raw_score=True)
    try:
        before = srv.predict(Xb[:50], timeout=60)
        b.rollback_one_iter()          # destructive: bumps the model gen

        def fobj(preds, _):
            g = np.asarray(preds - yb * 1.5, np.float32)
            return g, np.ones_like(g)

        b.update(fobj=fobj)
        info = srv.publish()
        after = srv.predict(Xb[:50], timeout=60)
    finally:
        srv.close()
    assert info.num_trees == n0
    assert srv._srv.pack.gen == info.model_gen   # repacked, not appended
    assert np.array_equal(after, b.predict(Xb[:50], device=True,
                                           raw_score=True))
    assert not np.array_equal(before, after)


def test_server_loaded_model_raw_route(booster):
    bst, X, _ = booster
    loaded = lgt.Booster(params=CPU, model_str=bst.model_to_string())
    Xf = np.asarray(X[:128], np.float32).astype(np.float64)
    with loaded.serve(linger_ms=1.0, raw_score=True) as srv:
        assert srv._raw_route
        got = srv.predict(Xf, timeout=60)
        assert np.array_equal(
            got, loaded.predict(Xf, device=True, raw_score=True))
        with pytest.raises(ValueError, match="float32-representable"):
            srv.submit(Xf + 1e-12)


def test_server_knobs_resolve_from_params():
    _, X = _data(11, 500, 4)
    bst = lgt.train(dict(PARAMS, num_leaves=7, tpu_serving_max_batch=512,
                         tpu_serving_linger_ms=7.5),
                    lgt.Dataset(X, label=X[:, 0]), num_boost_round=2)
    with bst.serve() as srv:
        s = srv.stats()
        assert s["max_batch"] == 512
        assert s["linger_ms"] == pytest.approx(7.5)
    with bst.serve(max_batch=64, bucket=False) as srv:
        assert srv.stats()["max_batch"] == 64


def test_server_deadline_knob_resolves_from_params():
    _, X = _data(23, 400, 4)
    bst = lgt.train(dict(PARAMS, num_leaves=7,
                         tpu_serving_deadline_ms=1234.0,
                         tpu_serving_max_queue_rows=4096),
                    lgt.Dataset(X, label=X[:, 0]), num_boost_round=2)
    with bst.serve() as srv:
        s = srv.stats()
        assert s["deadline_ms"] == pytest.approx(1234.0)
        assert s["max_queue_rows"] == 4096
    with bst.serve(deadline_ms=0.0, max_queue_rows=0) as srv:
        assert srv.stats()["deadline_ms"] == 0.0
        assert srv.stats()["max_queue_rows"] == 0


def test_generation_tuple_fields(booster):
    bst, X, _ = booster
    with bst.serve(linger_ms=0.5) as srv:
        g = srv.generation
        assert isinstance(g, Generation)
        assert g.version == 1
        assert g.num_trees == bst.num_trees()
        f = srv.submit(X[:16])
        f.result(60)
        assert f.generation == g
        assert f.latency_sec is not None and f.latency_sec >= 0


def test_second_serve_returns_live_server_no_second_dispatcher(booster):
    """A second ``serve()`` returns the live server and starts no thread
    (or refuses loudly with kwargs); a closed server is replaced. A
    server runs two dispatchers, score and explain, both named
    ``lgbm-serving-batcher``: the count of them is what must not grow."""
    bst, X, _ = booster

    def dispatchers():
        return [t for t in threading.enumerate()
                if t.name == "lgbm-serving-batcher" and t.is_alive()]

    base = len(dispatchers())
    srv = bst.serve(linger_ms=1.0, raw_score=True)
    try:
        assert len(dispatchers()) == base + 2
        again = bst.serve()
        assert again is srv
        assert len(dispatchers()) == base + 2
        with pytest.raises(LightGBMError, match="live ModelServer"):
            bst.serve(linger_ms=9.0)
        assert len(dispatchers()) == base + 2
    finally:
        srv.close()
    srv2 = bst.serve(linger_ms=1.0, raw_score=True)
    try:
        assert srv2 is not srv
        assert np.array_equal(srv2.predict(X[:16], timeout=60),
                              bst.predict(X[:16], device=True,
                                          raw_score=True))
    finally:
        srv2.close()
    assert lgt.ModelServer is ModelServer


def test_serve_fleet_is_refused(booster):
    bst, _, _ = booster
    with pytest.raises(LightGBMError, match="A14b"):
        bst.serve(fleet=object())


def test_unconstructed_booster_and_bad_requests_refused(booster):
    bst, X, _ = booster
    with bst.serve(linger_ms=1.0) as srv:
        with pytest.raises(ValueError, match=r"\[rows, 8\]"):
            srv.submit(X[:4, :5])
        with pytest.raises(ValueError, match="unknown request kind"):
            srv.submit(X[:4], kind="leaf")
    empty = lgt.Booster.__new__(lgt.Booster)
    empty._engine = None
    with pytest.raises(ValueError, match="unconstructed"):
        ModelServer(empty)


# ---------------------------------------------------------------------------
# failure path: deadlines, publish rollback, degrade, retry
# ---------------------------------------------------------------------------

def _wait_dispatcher_busy(srv):
    end = time.monotonic() + 5
    while srv.stats()["queued_rows"] and time.monotonic() < end:
        time.sleep(0.005)
    time.sleep(0.05)      # outlive the linger: _gather may still coalesce


def test_server_expired_request_bit_parity_for_survivors(booster):
    bst, X, _ = booster
    with bst.serve(linger_ms=1.0, raw_score=True) as srv:
        with faults.inject("slow_dispatch:sec=0.4:n=1"):
            slow = srv.submit(X[:48])     # the dispatcher wedges on this
            _wait_dispatcher_busy(srv)
            dead = srv.submit(X[:32], deadline_ms=40.0)
            good = srv.submit(X[64:128])
            got_slow = slow.result(60)
            got_good = good.result(60)
        with pytest.raises(DeadlineExceeded):
            dead.result(60)
        assert np.array_equal(
            got_slow, bst.predict(X[:48], device=True, raw_score=True))
        assert np.array_equal(
            got_good, bst.predict(X[64:128], device=True, raw_score=True))
        assert srv.counters.get("expired") == 1


def test_predict_timeout_slot_reclaimed(booster):
    bst, X, _ = booster
    with bst.serve(linger_ms=1.0, raw_score=True) as srv:
        with faults.inject("slow_dispatch:sec=0.5:n=1"):
            slow = srv.submit(X[:32])
            _wait_dispatcher_busy(srv)
            with pytest.raises(TimeoutError):
                srv.predict(X[:16], timeout=0.05)
            slow.result(60)
        end = time.monotonic() + 5
        while srv.counters.get("expired") < 1 and time.monotonic() < end:
            time.sleep(0.005)
        assert srv.counters.get("expired") == 1
        assert srv.stats()["rows"] == 32


def test_publish_fail_rolls_back_generation_monotonic(training_booster):
    b, Xb, _ = training_booster
    srv = b.serve(linger_ms=1.0, raw_score=True)
    try:
        old = srv.predict(Xb[:40], timeout=60)
        v0 = srv.generation.version
        b.update()
        with faults.inject("publish_fail"):
            with pytest.raises(faults.FaultInjected):
                srv.publish()
        assert srv.generation.version == v0
        assert np.array_equal(srv.predict(Xb[:40], timeout=60), old)
        assert srv.counters.get("publish_failures") == 1
        # the pack-append site (the second consult) rolls back too
        with faults.inject("publish_fail:after=1:n=1"):
            with pytest.raises(faults.FaultInjected):
                srv.publish()
        assert srv.generation.version == v0
        assert srv._srv.pack.count == b.num_trees() - 1
        info = srv.publish()
        assert info.version == v0 + 1
        assert np.array_equal(
            srv.predict(Xb[:40], timeout=60),
            b.predict(Xb[:40], device=True, raw_score=True))
    finally:
        srv.close()
        b.rollback_one_iter()


def test_degraded_route_bit_identical_to_host_walk(booster):
    bst, X, _ = booster
    srv = bst.serve(linger_ms=1.0, raw_score=True, probe_interval_s=0.05)
    try:
        direct = bst.predict(X[:80], device=True, raw_score=True)
        srv.degrade("test: forced")
        got = srv.predict(X[:80], timeout=60)
        assert np.array_equal(got, bst.predict(X[:80], raw_score=True))
        assert srv.stats()["degraded"]
        assert srv.counters.get("degraded_batches") >= 1
        end = time.monotonic() + 10
        while srv.stats()["degraded"] and time.monotonic() < end:
            time.sleep(0.02)
        assert not srv.stats()["degraded"]
        assert srv.counters.get("recoveries") == 1
        assert np.array_equal(srv.predict(X[:80], timeout=60), direct)
    finally:
        srv.close()


def test_recovery_probe_consults_probe_timeout(booster):
    """The recovery probe is where ``probe_timeout`` bites: while the
    plan fires the server stays degraded; once it disarms the probe
    succeeds and the device route is back."""
    bst, X, _ = booster
    srv = bst.serve(linger_ms=1.0, raw_score=True, probe_interval_s=0.02)
    try:
        with faults.inject("probe_timeout:p=1:n=5") as plan:
            srv.degrade("test: forced")
            end = time.monotonic() + 10
            while srv.stats()["degraded"] and time.monotonic() < end:
                time.sleep(0.01)
        assert plan.faults["probe_timeout"].fired == 5
        assert not srv.stats()["degraded"]
        assert srv.counters.get("recoveries") == 1
        assert np.array_equal(srv.predict(X[:40], timeout=60),
                              bst.predict(X[:40], device=True,
                                          raw_score=True))
    finally:
        srv.close()


def test_retry_exhaustion_degrades_and_still_answers(booster):
    bst, X, _ = booster
    srv = bst.serve(linger_ms=1.0, raw_score=True, probe_interval_s=0.0,
                    retry_policy=RetryPolicy(max_attempts=2,
                                             base_delay=0.001,
                                             max_delay=0.01,
                                             deadline=2.0))
    try:
        with faults.inject("dispatch_error:p=1:n=2"):
            got = srv.predict(X[:64], timeout=60)
        assert np.array_equal(got, bst.predict(X[:64], raw_score=True))
        s = srv.stats()
        assert s["degraded"] and "exhausted" in s["degraded_reason"]
        assert srv.counters.get("dispatch_failures") == 1
        assert srv.counters.get("dispatch_retries") == 1
        assert srv.counters.get("recoveries") == 0
    finally:
        srv.close()


def test_transient_dispatch_fault_retried_bit_identical(booster):
    bst, X, _ = booster
    with bst.serve(linger_ms=1.0, raw_score=True) as srv:
        with faults.inject("dispatch_error"):
            got = srv.predict(X[:64], timeout=60)
        assert np.array_equal(
            got, bst.predict(X[:64], device=True, raw_score=True))
        assert srv.counters.get("dispatch_retries") == 1
        assert not srv.stats()["degraded"]


def test_nontransient_server_error_fails_the_batch(booster, monkeypatch):
    """A code bug on the device route fails its batch; the server is not
    degraded and the next batch is served."""
    bst, X, _ = booster
    with bst.serve(linger_ms=1.0, raw_score=True) as srv:
        real = srv._device_scores
        calls = []

        def broken(snap, Xb):
            calls.append(len(Xb))
            if len(calls) == 1:
                raise KeyError("a code bug")
            return real(snap, Xb)

        monkeypatch.setattr(srv, "_device_scores", broken)
        with pytest.raises(KeyError):
            srv.predict(X[:10], timeout=60)
        assert not srv.stats()["degraded"]
        assert srv.predict(X[:10], timeout=60).shape == (10,)


# ---------------------------------------------------------------------------
# memory pressure: OOM-classified adaptive dispatch
# ---------------------------------------------------------------------------

def test_oom_dispatch_bisects_bit_identical_not_degraded(booster):
    bst, X, _ = booster
    with bst.serve(linger_ms=1.0, raw_score=True) as srv:
        with faults.inject("oom:n=1"):
            got = srv.predict(X[:600], timeout=120)
        st = srv.stats()
        assert st["oom_bisects"] >= 1
        assert not st["degraded"]
        assert srv.counters.get("dispatch_retries") == 0
    assert np.array_equal(
        got, bst.predict(X[:600], device=True, raw_score=True))


def test_oom_bisection_floor_degrades_only_failing_rows(booster):
    """oom:n=3 fails the 600-row batch, its left 300 half and the left
    150 quarter (under the 256-row floor: host walk); every OTHER row
    stays on the device."""
    bst, X, _ = booster
    with bst.serve(linger_ms=1.0, raw_score=True) as srv:
        with faults.inject("oom:p=1:n=3"):
            got = srv.predict(X[:600], timeout=120)
        st = srv.stats()
        assert st["oom_bisects"] == 2
        assert not st["degraded"]
    ref_dev = bst.predict(X[:600], device=True, raw_score=True)
    ref_host = bst.predict(X[:600], device=False, raw_score=True)
    assert np.array_equal(got[:150], ref_host[:150])
    assert np.array_equal(got[150:], ref_dev[150:])


def test_oom_floor_everywhere_host_walks_without_degrading(booster):
    bst, X, _ = booster
    with bst.serve(linger_ms=1.0, raw_score=True) as srv:
        with faults.inject("oom:p=1:n=1000000"):
            got = srv.predict(X[:100], timeout=120)
        assert not srv.stats()["degraded"]
        clean = srv.predict(X[:100], timeout=120)
    assert np.array_equal(
        got, bst.predict(X[:100], device=False, raw_score=True))
    assert np.array_equal(
        clean, bst.predict(X[:100], device=True, raw_score=True))


# ---------------------------------------------------------------------------
# serving mesh
# ---------------------------------------------------------------------------

def test_server_mesh_two_cpu_devices_equals_no_mesh(booster):
    """A ``[cpu, cpu]`` mesh copies the pack to each entry and splits
    every batch's rows over them: the scores are no mesh's bit for bit,
    for rows that divide and rows that do not."""
    bst, X, _ = booster
    with bst.serve(linger_ms=20.0, raw_score=True,
                   devices=["cpu", "cpu"]) as srv:
        assert srv.stats()["mesh_devices"] == 2
        assert len(srv._active[0].win) == 2
        futs = [srv.submit(X[i * 100:(i + 1) * 100 + i]) for i in range(4)]
        for i, f in enumerate(futs):
            direct = bst.predict(X[i * 100:(i + 1) * 100 + i], device=True,
                                 raw_score=True)
            assert np.array_equal(f.result(60), direct)
        one = srv.predict(X[:1], timeout=60)
        assert np.array_equal(one, bst.predict(X[:1], device=True,
                                               raw_score=True))


# ---------------------------------------------------------------------------
# the slice: the port's server against the JAX package's
# ---------------------------------------------------------------------------

def test_served_raw_scores_equal_jax_model_server_bit_for_bit(booster):
    """The same model text goes to the JAX package's ``ModelServer`` and
    to the port's (loaded models: the raw route in both); their served
    raw scores are equal bit for bit on the CPU, and so are the port
    booster's own (binned route) ones."""
    import lightgbm_tpu as lgb
    bst, X, _ = booster
    text = bst.model_to_string()
    jb = lgb.Booster(model_str=text)
    tb = lgt.Booster(params=CPU, model_str=text)
    reqs = [X[:37], X[37:300], X[300:301], X[301:1500]]
    jsrv = jb.serve(linger_ms=1.0, raw_score=True)
    try:
        want = [jsrv.predict(r, timeout=120) for r in reqs]
    finally:
        jsrv.close()
    for b in (tb, bst):
        with b.serve(linger_ms=1.0, raw_score=True) as srv:
            for r, w in zip(reqs, want):
                np.testing.assert_array_equal(srv.predict(r, timeout=60), w)
    with tb.serve(linger_ms=1.0) as srv:
        np.testing.assert_array_equal(srv.predict(X[:64], timeout=60),
                                      jb.predict(X[:64], device=True))
