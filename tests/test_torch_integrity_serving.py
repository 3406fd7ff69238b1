"""The serving half of the integrity defense in the PyTorch port
(``robustness/integrity.py`` and ``serving/server.py``), the port's
counterpart of the solo cases of ``tests/test_integrity.py``: the canary
batch equal to the JAX package's bit for bit, the CRC fingerprint
catching pack rot (device tensors read back to the host), the solo
canary round trip quarantine -> repair -> un-quarantine with exact
counters, and the publish anchor refusing a corrupt pack."""
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu.robustness import integrity as jintegrity
from lightgbm_tpu_torch.ops.forest import Replicas
from lightgbm_tpu_torch.robustness import faults, integrity

PARAMS = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
          "verbose": -1, "deterministic": True, "seed": 7,
          "device_type": "cpu"}


def _data(n=500, f=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    return X, y


@pytest.fixture(scope="module")
def model():
    X, y = _data(seed=5)
    bst = lgt.train(dict(PARAMS, tpu_integrity_probe_interval_s=0.05),
                    lgt.Dataset(X, label=y), num_boost_round=5,
                    keep_training_booster=True)
    return bst, X


@pytest.mark.parametrize("f,rows,seed", [(7, 16, 0), (1, 3, 2),
                                         (28, 16, 0), (136, 64, 5)])
def test_canary_batch_equals_jax(f, rows, seed):
    a = integrity.canary_batch(f, rows=rows, seed=seed)
    np.testing.assert_array_equal(
        a, jintegrity.canary_batch(f, rows=rows, seed=seed))
    assert a.shape == (rows, f) and a.dtype == np.float64
    np.testing.assert_array_equal(a, a.astype(np.float32).astype(np.float64))
    assert not np.array_equal(a, integrity.canary_batch(f, rows=rows,
                                                        seed=seed + 1))


def test_crc_fingerprint_catches_pack_rot(model):
    bst, _ = model
    srv = bst.serve(linger_ms=1.0, raw_score=True, probe_interval_s=0.0)
    try:
        win = srv._active[0].win          # the placed device window
    finally:
        srv.close(timeout=60)
    before = integrity.crc32_fingerprint(win)
    assert before == integrity.crc32_fingerprint(win)
    # a device window reads back to the same digest as its host arrays
    assert before == integrity.crc32_fingerprint(
        type(win)(*[a.numpy() for a in win]))
    assert before == jintegrity.crc32_fingerprint(
        type(win)(*[a.numpy() for a in win]))
    rotten = integrity.corrupt_pack(win)
    assert integrity.crc32_fingerprint(rotten) != before
    assert integrity.crc32_fingerprint(win) == before   # a copy
    a, b = win.leaf_value.numpy(), rotten.leaf_value.numpy()
    assert np.all(b[0] == -a[0]) and np.any(b != a)
    np.testing.assert_array_equal(b[1:], a[1:])
    # on a mesh every replica is rotted
    reps = integrity.corrupt_pack(Replicas([win, win]))
    assert isinstance(reps, Replicas) and len(reps) == 2
    for r in reps:
        assert torch.equal(r.leaf_value[0], -win.leaf_value[0])


def test_parity_equal_is_bit_for_bit():
    a = np.array([[1.0, np.nan], [0.0, 2.0]])
    assert integrity.parity_equal(a, a.copy())
    assert not integrity.parity_equal(a, a[:1])
    b = a.copy()
    b[1, 1] = np.nextafter(2.0, 3.0)
    assert not integrity.parity_equal(a, b)
    assert integrity.parity_equal(np.array([0.0]), np.array([-0.0]))


def test_solo_canary_quarantine_repair_roundtrip(model):
    bst, X = model
    srv = bst.serve(linger_ms=1.0, raw_score=True, probe_interval_s=0.05)
    try:
        y0 = srv.predict(X[:64])
        np.testing.assert_array_equal(
            y0, bst.predict(X[:64], device=True, raw_score=True))
        assert srv.stats()["integrity_probe_interval_s"] == 0.05
        # in-residency rot: republish with the device-rot plan armed —
        # the golden records from the CLEAN snapshot, then the resident
        # pack's bits flip under it
        with faults.inject("bitflip:p=1:where=dev"):
            srv.publish()
        deadline = time.time() + 20
        while time.time() < deadline:
            if srv.counters.snapshot().get("repairs", 0) >= 1 and \
                    not srv.stats().get("degraded"):
                break
            time.sleep(0.05)
        snap = srv.counters.snapshot()
        assert snap["integrity_probes"] >= 1, snap
        assert snap["integrity_mismatches"] == 1, snap
        assert snap["quarantines"] == 1, snap
        assert snap["repairs"] == 1, snap
        assert not srv.stats().get("degraded")
        assert not srv.stats().get("integrity_quarantined")
        # the repaired device route: the pre-rot answers bit for bit
        np.testing.assert_array_equal(srv.predict(X[:64]), y0)
    finally:
        srv.close(timeout=60)


def test_publish_anchor_refuses_corrupt_pack(model):
    """A pack that is already corrupt when placed (its canary replay
    disagrees with the host walk) is refused at publish: the old
    generation keeps serving untorn, then a clean publish succeeds."""
    bst, X = model
    srv = bst.serve(linger_ms=1.0, raw_score=True, probe_interval_s=0.0)
    try:
        y0 = srv.predict(X[:64])
        gen0 = srv.generation.version
        bst.update()
        clean = srv._place_window
        srv._place_window = lambda w: integrity.corrupt_pack(clean(w))
        with pytest.raises(integrity.CanaryMismatch,
                           match="DATA_CORRUPTION"):
            srv.publish()
        assert srv.generation.version == gen0
        assert srv.counters.get("integrity_mismatches") == 1
        assert srv.counters.get("publish_failures") == 1
        np.testing.assert_array_equal(srv.predict(X[:64]), y0)
        srv._place_window = clean
        info = srv.publish()
        assert info.version == gen0 + 1
        np.testing.assert_array_equal(
            srv.predict(X[:64]),
            bst.predict(X[:64], device=True, raw_score=True))
    finally:
        srv.close(timeout=60)
        bst.rollback_one_iter()


def test_integrity_probe_survives_a_broken_check():
    calls = []

    def check():
        calls.append(1)
        raise RuntimeError("a broken prober")

    probe = integrity.IntegrityProbe(check, 0.01)
    try:
        end = time.monotonic() + 5
        while len(calls) < 3 and time.monotonic() < end:
            time.sleep(0.01)
    finally:
        probe.close()
    assert len(calls) >= 3
    assert integrity.IntegrityProbe(check, 0.0)._thread is None
