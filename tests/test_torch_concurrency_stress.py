"""The port's threaded tier under its lock-order tracker.

tests/test_concurrency_stress.py against the port's ``ServingCounters``:
N threads hammer ``inc`` / ``inc_tenant`` / ``tenant_snapshot`` /
``drop_tenant``; totals come out exact and the tracker stays silent.
Then scripts/concurrency_smoke.py's gates 2 and 3 on the CPU: a small
server's publish under load inside ``lockorder.tracking()`` (its locks
tracked, no violation, every answer its generation's
``predict(device=True)``), and a seeded inversion that raises at the
attempt instead of deadlocking.
"""
import threading
import time

import numpy as np
import pytest

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.analysis import lockorder
from lightgbm_tpu_torch.serving.metrics import ServingCounters

N_THREADS = 8
N_ITERS = 400
STABLE = tuple(f"tenant-{i}" for i in range(4))


def test_counters_exact_totals_under_tracker():
    with lockorder.tracking() as tracker:
        counters = ServingCounters()
        assert isinstance(counters._lock, lockorder.TrackedLock), (
            "metrics.py lock not wrapped — frame filter regressed")

        start = threading.Barrier(N_THREADS + 2)
        stop = threading.Event()
        errors = []

        def worker(tid):
            try:
                start.wait()
                tenant = STABLE[tid % len(STABLE)]
                for _ in range(N_ITERS):
                    counters.inc("shed", tenant=tenant)
                    counters.inc("expired")
                    counters.inc_tenant(tenant, "requests", 2)
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

        def churner():
            # volatile tenants appear and vanish while workers run:
            # drop_tenant must never corrupt the stable ledgers
            try:
                start.wait()
                i = 0
                while not stop.is_set():
                    name = f"volatile-{i % 3}"
                    counters.inc_tenant(name, "rows", 1)
                    counters.drop_tenant(name)
                    i += 1
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

        def snapshotter():
            # concurrent readers: snapshots must always be internally
            # consistent dicts, never half-built ledgers
            try:
                start.wait()
                while not stop.is_set():
                    snap = counters.tenant_snapshot()
                    for led in snap.values():
                        assert set(led) == set(ServingCounters.TENANT_NAMES)
                    counters.snapshot()
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

        threads = ([threading.Thread(target=worker, args=(i,), daemon=True)
                    for i in range(N_THREADS)]
                   + [threading.Thread(target=churner, daemon=True),
                      threading.Thread(target=snapshotter, daemon=True)])
        for t in threads:
            t.start()
        for t in threads[:N_THREADS]:
            t.join(60)
        stop.set()
        for t in threads[N_THREADS:]:
            t.join(30)
        assert not any(t.is_alive() for t in threads), "stress wedged"
        assert errors == []

        total = N_THREADS * N_ITERS
        assert counters.get("shed") == total
        assert counters.get("expired") == total
        per_tenant = total // len(STABLE)
        snap = counters.tenant_snapshot()
        for tenant in STABLE:
            assert snap[tenant]["shed"] == per_tenant
            assert snap[tenant]["requests"] == 2 * per_tenant
        for name in list(snap):
            if name.startswith("volatile-"):
                counters.drop_tenant(name)
        assert set(counters.tenant_snapshot()) == set(STABLE)

        assert tracker.violations == []
        assert tracker.held_names() == []


@pytest.fixture(scope="module")
def small_booster():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(400, 6))
    y = X[:, 0] + 0.25 * X[:, 1]
    bst = lgt.train({"objective": "regression", "num_leaves": 15,
                     "verbose": -1, "min_data_in_leaf": 5,
                     "device_type": "cpu"},
                    lgt.Dataset(X, label=y), num_boost_round=3,
                    keep_training_booster=True)
    return bst, X


def test_publish_under_load_green_under_tracker(small_booster):
    bst, X = small_booster
    rng = np.random.default_rng(5)
    sizes = rng.integers(1, 65, size=60)
    records, errors = [], []
    with lockorder.tracking() as t:
        srv = bst.serve(linger_ms=20.0, raw_score=True)
        expected = {srv.generation.version: bst.predict(
            X, device=True, raw_score=True)}
        assert t.n_tracked > 0, "the serving tier's locks are not tracked"
        stop = threading.Event()

        def client(seed):
            r = np.random.default_rng(seed)
            while not stop.is_set():
                n = int(sizes[r.integers(len(sizes))])
                lo = int(r.integers(0, len(X) - n))
                try:
                    f = srv.submit(X[lo:lo + n])
                    out = f.result(60)
                    records.append((lo, n, f.generation, out))
                except Exception as e:  # noqa: BLE001
                    errors.append(repr(e))
                    return

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(3)]
        try:
            for th in threads:
                th.start()
            time.sleep(0.1)
            bst.update()
            info = srv.publish()            # live publish under load
            expected[info.version] = bst.predict(X, device=True,
                                                 raw_score=True)
            time.sleep(0.1)
        finally:
            stop.set()
            for th in threads:
                th.join(30)
            srv.close(timeout=30)
            bst.rollback_one_iter()
        assert not errors and not t.violations, (errors, t.violations)
        assert t.held_names() == []
    assert records and {r[2].version for r in records} <= set(expected)
    for lo, n, gen, out in records:
        assert np.array_equal(out, expected[gen.version][lo:lo + n])
    assert not lockorder.installed()


def test_seeded_inversion_trips_the_tracker():
    priv = lockorder.LockOrderTracker()
    a = lockorder.wrap(threading.Lock(), "seed-A", priv)
    b = lockorder.wrap(threading.Lock(), "seed-B", priv)
    with a:
        with b:
            pass
    tripped = []

    def inverted():
        try:
            with b:
                with a:       # closes the cycle: must raise
                    pass
        except lockorder.LockOrderViolation as e:
            tripped.append(e)

    th = threading.Thread(target=inverted, daemon=True)
    th.start()
    th.join(10)
    assert not th.is_alive() and len(tripped) == 1
    assert {"seed-A", "seed-B"} <= set(tripped[0].cycle)
    assert not a.locked() and not b.locked()
