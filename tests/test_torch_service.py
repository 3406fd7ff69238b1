"""The continual service of the PyTorch port (``lightgbm_tpu_torch/
service``) against the JAX package's, case for case the port's
counterpart of ``tests/test_service.py`` and of
``tests/test_integrity.py::test_readyz_flips_503_while_tenant_quarantined``.

- The resident trainer (thread) over a stream written whole before it
  starts, L2, to 4 iterations and then resumed to 8, gives the JAX
  checkpoints' model text string for string and the same watermark
  fields bar the wall clock (the JAX side trained once, in the module
  fixture). The OOM window's shrink, grow-back and fatal floor, the
  corrupt-cycle rollback and the condemned window hold on the port.
- The front door over a port ``ModelServer`` and a two-tenant
  ``FleetServer`` on the CPU: HTTP scores are bit for bit the port's
  ``predict(device=True)``; chunked responses, wire deadlines (504),
  malformed and oversize bodies (400/413) that poison no peer, unknown
  routes and tenants (404), overload (429), staleness headers,
  ``/healthz`` against ``/readyz`` (degraded, quarantined, closed) and the
  explain routes; the same requests to the JAX door over the JAX server
  of the same model get the same status codes and bodies.
- ``ContinualService`` in thread mode: each response is bit for bit its
  generation's checkpointed model, generations monotone, ``model_gen``
  0 the whole way. ``TrainerSupervisor`` on the CPU with ``rank_kill``
  on attempt 0 relaunches once, reaches the target with the
  ``.deadletter`` contract intact, and ends on the text of an
  uninterrupted thread run over the same stream.

No JAX child process runs; the supervised child is the port's.
"""
import io
import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from test_torch_model_io import _no_params

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.service import FrontDoor as JFrontDoor
from lightgbm_tpu.service import ServerGateway as JServerGateway
from lightgbm_tpu.service import TrainerSpec as JTrainerSpec
from lightgbm_tpu.service import run_resident_trainer as j_run_trainer
from lightgbm_tpu_torch.robustness import faults, heartbeat
from lightgbm_tpu_torch.robustness.checkpoint import (
    latest_valid_checkpoint, list_checkpoints, read_checkpoint)
from lightgbm_tpu_torch.service import (ContinualService, FrontDoor,
                                        ServerGateway, TrainerSpec,
                                        run_resident_trainer)
from lightgbm_tpu_torch.service import trainer as trainer_mod
from lightgbm_tpu_torch.service.trainer import TrainerSupervisor

CPU = {"device_type": "cpu"}
PARAMS = dict(objective="binary", num_leaves=15, learning_rate=0.1,
              verbose=-1, seed=7, **CPU)
L2 = dict(objective="regression", num_leaves=15, learning_rate=0.1,
          verbose=-1, seed=7)


def _rows(n, f=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] > 0).astype(np.float32)
    return np.column_stack([y, X])


def _l2_rows(n, seed):
    block = _rows(n, seed=seed)
    block[:, 0] = block[:, 1] * 2 + block[:, 2] ** 2
    return block


def _append(path, block):
    with open(path, "a") as f:
        f.write("\n".join(",".join(repr(float(v)) for v in r)
                          for r in block) + "\n")


def _post(url, body, headers, timeout=60):
    req = urllib.request.Request(url, data=body, headers=headers)
    return urllib.request.urlopen(req, timeout=timeout)


def _npy(X):
    buf = io.BytesIO()
    np.save(buf, np.asarray(X, np.float64), allow_pickle=False)
    return buf.getvalue()


def _post_npy(url, X, extra_headers=(), timeout=60):
    r = _post(url, _npy(X),
              dict({"Content-Type": "application/x-npy"}, **dict(
                  extra_headers)), timeout)
    out = np.load(io.BytesIO(r.read()), allow_pickle=False)
    return out, r


def _spec(cls, params, stream, ck, **kw):
    base = dict(window_rows=600, min_rows=256, iters_per_cycle=2,
                publish_every_iters=2, target_iterations=4,
                poll_sec=0.05)
    base.update(kw)
    return cls(params=dict(params), stream_path=stream, ckpt_dir=ck,
               **base)


# ---------------------------------------------------------------------------
# the resident trainer against the JAX package's
# ---------------------------------------------------------------------------

def _trainer_runs(cls, run, params, tmp):
    """Checkpoints of a run to 4 iterations and of its resume to 8 over a
    stream written whole first."""
    stream = os.path.join(tmp, "s.csv")
    ck = os.path.join(tmp, "ck")
    _append(stream, _l2_rows(600, seed=31))
    spec = _spec(cls, params, stream, ck)
    assert run(spec) == 0
    st4 = latest_valid_checkpoint(ck)[1]
    spec.target_iterations = 8
    assert run(spec) == 0
    st8 = latest_valid_checkpoint(ck)[1]
    return st4, st8


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    return _trainer_runs(JTrainerSpec, j_run_trainer, L2,
                         str(tmp_path_factory.mktemp("jax_trainer")))


def test_resident_trainer_and_resume_give_the_jax_text(jax_trainer,
                                                       tmp_path):
    t4, t8 = _trainer_runs(TrainerSpec, run_resident_trainer,
                           dict(L2, **CPU), str(tmp_path))
    for t, j, it in ((t4, jax_trainer[0], 4), (t8, jax_trainer[1], 8)):
        assert t["iteration"] == j["iteration"] == it
        assert _no_params(t["model"]) == _no_params(j["model"])
        ts, js = dict(t["service"]), dict(j["service"])
        assert ts.pop("watermark_ts") > 0 and js.pop("watermark_ts") > 0
        assert ts == js
    assert t4["service"]["watermark_rows"] == 600
    b4 = lgt.Booster(params=CPU, model_str=t4["model"])
    b8 = lgt.Booster(params=CPU, model_str=t8["model"])
    assert b4.num_trees() == 4 and b8.num_trees() == 8
    for a, b in zip(b4._engine.models, b8._engine.models):
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)


def test_trainer_window_autoshrink_on_oom(tmp_path):
    stream, ck = str(tmp_path / "s.csv"), str(tmp_path / "ck")
    _append(stream, _rows(600))
    spec = _spec(TrainerSpec, PARAMS, stream, ck, window_floor_rows=128)
    with faults.inject("oom:n=2"):      # the first TWO cycles OOM
        assert run_resident_trainer(spec) == 0
    st = latest_valid_checkpoint(ck)[1]
    assert st["iteration"] == 4
    svc = st["service"]
    assert svc["window_rows_target"] == 150      # 600 -> 300 -> 150
    assert svc["window_rows"] <= 150
    assert svc["skipped_rows"] == 0


def test_trainer_window_grows_back_when_pressure_clears(tmp_path):
    stream, ck = str(tmp_path / "s.csv"), str(tmp_path / "ck")
    _append(stream, _rows(600))
    spec = _spec(TrainerSpec, PARAMS, stream, ck, window_floor_rows=128,
                 target_iterations=10)
    with faults.inject("oom:n=1"):
        assert run_resident_trainer(spec) == 0
    st = latest_valid_checkpoint(ck)[1]
    assert st["iteration"] == 10
    assert st["service"]["window_rows_target"] == 600


def test_trainer_oom_at_floor_is_fatal(tmp_path):
    stream = str(tmp_path / "s.csv")
    _append(stream, _rows(400))
    spec = _spec(TrainerSpec, PARAMS, stream, str(tmp_path / "ck"),
                 window_rows=400, window_floor_rows=400)
    with faults.inject("oom:p=1:n=100000"):
        with pytest.raises(faults.OOMInjected):
            run_resident_trainer(spec)


def _final_text(spec, fault=None):
    if fault:
        with faults.inject(fault):
            assert run_resident_trainer(spec) == 0
    else:
        assert run_resident_trainer(spec) == 0
    st = latest_valid_checkpoint(spec.ckpt_dir)[1]
    assert st["iteration"] == spec.target_iterations
    return st["model"]


def test_trainer_corrupt_cycle_rolls_back_and_replays_clean(tmp_path):
    """One poisoned iteration: the guard refuses the cycle, the trainer
    rolls back to the newest CRC-valid checkpoint and retries the SAME
    window, ending on the fault-free run's model bit for bit."""
    stream = str(tmp_path / "s.csv")
    _append(stream, _rows(600, seed=3))
    clean = _final_text(_spec(TrainerSpec, PARAMS, stream,
                              str(tmp_path / "clean"), iters_per_cycle=3,
                              publish_every_iters=3, target_iterations=6))
    for after in (1, 4):        # before and after the first commit
        poisoned = _final_text(
            _spec(TrainerSpec, PARAMS, stream,
                  str(tmp_path / f"poisoned{after}"), iters_per_cycle=3,
                  publish_every_iters=3, target_iterations=6),
            f"nan_grad:p=1:after={after}")
        assert poisoned == clean, after


def test_trainer_second_corrupt_cycle_condemns_the_window(tmp_path,
                                                          monkeypatch):
    """Two refused cycles in a row condemn the window: training resumes
    past it on fresh stream rows only, as a run over those rows alone."""
    stream = str(tmp_path / "s.csv")
    _append(stream, _rows(600, seed=3))
    fresh = _rows(400, seed=4)
    beat = heartbeat.beat
    waits = []

    def on_beat(phase, progress=0):
        # the loop waits for rows only once the window is condemned:
        # the producer writes the fresh rows then
        if phase == "waiting_for_rows":
            if not waits:
                _append(stream, fresh)
            waits.append(progress)
        beat(phase, progress)

    monkeypatch.setattr(heartbeat, "beat", on_beat)
    condemned = _final_text(
        _spec(TrainerSpec, PARAMS, stream, str(tmp_path / "ck")),
        "nan_grad:p=1:n=2")
    assert waits
    monkeypatch.setattr(heartbeat, "beat", beat)
    only_fresh = str(tmp_path / "fresh.csv")
    _append(only_fresh, fresh)
    assert condemned == _final_text(
        _spec(TrainerSpec, PARAMS, only_fresh, str(tmp_path / "ck2")))


def test_trainer_main_runs_a_spec_file(tmp_path):
    stream = str(tmp_path / "s.csv")
    _append(stream, _rows(400))
    spec = _spec(TrainerSpec, PARAMS, stream, str(tmp_path / "ck"),
                 target_iterations=2)
    path = str(tmp_path / "spec.json")
    with open(path, "w") as fh:
        fh.write(spec.to_json())
    assert TrainerSpec.from_json(spec.to_json()) == spec
    assert trainer_mod.main([]) == 2
    assert trainer_mod.main([path]) == 0
    assert latest_valid_checkpoint(spec.ckpt_dir)[1]["iteration"] == 2


# ---------------------------------------------------------------------------
# the front door over a port ModelServer
# ---------------------------------------------------------------------------

@pytest.fixture
def served_booster():
    block = _rows(500, seed=3)
    bst = lgt.train(dict(PARAMS), lgt.Dataset(block[:, 1:],
                                              label=block[:, 0]),
                    num_boost_round=4, keep_training_booster=True)
    srv = bst.serve(linger_ms=1.0, raw_score=True)
    gw = ServerGateway(srv)
    door = FrontDoor(gw, chunk_rows=64, max_body_mb=1.0)
    yield bst, srv, gw, door
    door.close()
    srv.close(timeout=60)


def test_http_scores_bit_identical_to_predict_device(served_booster):
    bst, _srv, _gw, door = served_booster
    probe = _rows(48, seed=5)[:, 1:].astype(np.float64)
    want = bst.predict(probe, device=True, raw_score=True)
    out, r = _post_npy(door.address + "/v1/predict", probe)
    np.testing.assert_array_equal(out, want)
    assert r.headers["X-Model-Generation"] == "1"
    rj = _post(door.address + "/v1/predict",
               json.dumps({"rows": probe.tolist()}).encode(),
               {"Content-Type": "application/json"})
    got = np.asarray(json.loads(rj.read())["scores"])
    np.testing.assert_array_equal(got, want)


def test_http_chunked_streaming_large_response(served_booster):
    bst, _srv, _gw, door = served_booster
    probe = _rows(200, seed=6)[:, 1:].astype(np.float64)  # > chunk_rows
    want = bst.predict(probe, device=True, raw_score=True)
    out, r = _post_npy(door.address + "/v1/predict", probe)
    assert r.headers.get("Transfer-Encoding") == "chunked"
    np.testing.assert_array_equal(out, want)
    rj = _post(door.address + "/v1/predict",
               json.dumps({"rows": probe.tolist()}).encode(),
               {"Content-Type": "application/json"})
    assert rj.headers.get("Transfer-Encoding") == "chunked"
    got = np.asarray(json.loads(rj.read())["scores"])
    np.testing.assert_array_equal(got, want)


def test_http_explain_route(served_booster):
    bst, srv, _gw, door = served_booster
    probe = _rows(80, seed=14)[:, 1:].astype(np.float64)  # > chunk_rows
    want = srv.explain(probe, timeout=60)
    out, r = _post_npy(door.address + "/v1/explain", probe)
    assert r.headers.get("Transfer-Encoding") == "chunked"
    np.testing.assert_array_equal(out, want)
    np.testing.assert_allclose(
        out, bst.predict(probe, pred_contrib=True, raw_score=True),
        rtol=1e-5, atol=1e-6)


def test_wire_deadline_expires_before_coalescing(served_booster):
    bst, srv, _gw, door = served_booster
    probe = _rows(32, seed=7)[:, 1:].astype(np.float64)
    want = bst.predict(probe, device=True, raw_score=True)
    codes = {}

    def slow_req():
        out, r = _post_npy(door.address + "/v1/predict", probe,
                           timeout=90)
        codes["slow"] = (r.status, out)

    with faults.inject("slow_dispatch:sec=0.6:n=1"):
        t = threading.Thread(target=slow_req)
        t.start()
        t_end = time.monotonic() + 5
        while srv.stats()["queued_rows"] and time.monotonic() < t_end:
            time.sleep(0.01)
        time.sleep(0.05)          # outlive the linger (pop != dispatched)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_npy(door.address + "/v1/predict", probe,
                      extra_headers=[("X-Deadline-Ms", "40")], timeout=90)
        assert ei.value.code == 504
        assert "DEADLINE_EXCEEDED" in json.loads(ei.value.read())["error"]
        t.join(90)
    st, out = codes["slow"]
    assert st == 200
    np.testing.assert_array_equal(out, want)
    assert srv.counters.get("expired") == 1


def _expect(url, code, body, headers):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url, body, headers)
    assert ei.value.code == code, (ei.value.code, ei.value.read())
    return ei.value


def test_malformed_and_oversize_rejected_without_poisoning(
        served_booster):
    bst, srv, _gw, door = served_booster
    url = door.address + "/v1/predict"
    probe = _rows(16, seed=8)[:, 1:].astype(np.float64)
    want = bst.predict(probe, device=True, raw_score=True)
    n0 = srv.stats()["requests"]
    _expect(url, 400, b"{not json", {"Content-Type": "application/json"})
    _expect(url, 400, json.dumps({"rows": [["a", "b"]]}).encode(),
            {"Content-Type": "application/json"})
    # a wrong feature width fails ITS submitter at submit() validation
    _expect(url, 400, json.dumps({"rows": [[1.0, 2.0]]}).encode(),
            {"Content-Type": "application/json"})
    _expect(url, 400, b"whatever", {"Content-Type": "text/plain"})
    _expect(url, 400, _npy(probe), {"Content-Type": "application/x-npy",
                                    "X-Deadline-Ms": "soon"})
    big = b"x" * (door.max_body_bytes + 1)
    _expect(url, 413, big, {"Content-Type": "application/x-npy",
                            "Content-Length": str(len(big))})
    # none of the rejects reached the dispatcher...
    assert srv.stats()["requests"] == n0
    # ...and a well-formed peer is served bit for bit afterwards
    out, _r = _post_npy(url, probe)
    np.testing.assert_array_equal(out, want)


def test_malformed_reject_404_route(served_booster):
    _bst, _srv, _gw, door = served_booster
    _expect(door.address + "/v1/nope", 404, b"{}",
            {"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(door.address + "/nope", timeout=30)
    assert ei.value.code == 404
    # a solo gateway has no tenants
    _expect(door.address + "/v1/tenants/a/predict", 404, b'{"rows": []}',
            {"Content-Type": "application/json"})


def test_staleness_headers_and_stats(served_booster):
    _bst, _srv, gw, door = served_booster
    mark_ts = time.time() - 1.5
    gw.set_watermark(1, rows=1234, ts=mark_ts, iteration=4)
    probe = _rows(8, seed=9)[:, 1:].astype(np.float64)
    _out, r = _post_npy(door.address + "/v1/predict", probe)
    assert r.headers["X-Watermark-Rows"] == "1234"
    assert float(r.headers["X-Watermark-Ts"]) == mark_ts
    stale = float(r.headers["X-Staleness-Ms"])
    assert 1000.0 <= stale < 120_000.0
    st = json.loads(urllib.request.urlopen(
        door.address + "/v1/stats", timeout=30).read())
    assert st["staleness_p50_ms"] >= 1000.0
    h = json.loads(urllib.request.urlopen(
        door.address + "/healthz", timeout=30).read())
    assert h["status"] == "ok"


def test_overload_maps_to_429(served_booster):
    _bst, srv, _gw, door = served_booster
    probe = _rows(8, seed=10)[:, 1:].astype(np.float64)
    orig = srv._batcher.max_queue_rows
    srv._batcher.max_queue_rows = 8
    try:
        with faults.inject("slow_dispatch:sec=0.5:n=1"):
            slow = srv.submit(probe)             # wedges the dispatcher
            t_end = time.monotonic() + 5
            while srv.stats()["queued_rows"] and \
                    time.monotonic() < t_end:
                time.sleep(0.01)
            time.sleep(0.05)
            backlog = srv.submit(probe)          # backlog: 8 rows queued
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post_npy(door.address + "/v1/predict", probe)
            assert ei.value.code == 429
            assert ei.value.headers.get("Retry-After") is not None
            slow.result(60)
            backlog.result(60)
    finally:
        srv._batcher.max_queue_rows = orig


def test_readyz_vs_healthz_liveness():
    block = _rows(400, seed=11)
    bst = lgt.train(dict(PARAMS), lgt.Dataset(block[:, 1:],
                                              label=block[:, 0]),
                    num_boost_round=2)
    srv = bst.serve(linger_ms=1.0, raw_score=True, probe_interval_s=0.0)
    door = FrontDoor(ServerGateway(srv))
    try:
        r = urllib.request.urlopen(door.address + "/readyz", timeout=30)
        assert r.status == 200
        assert json.loads(r.read()) == {"ready": True, "status": "ok"}
        srv.degrade("readiness drill")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(door.address + "/readyz", timeout=30)
        assert ei.value.code == 503
        body = json.loads(ei.value.read())
        assert body == {"ready": False, "status": "degraded"}
        r = urllib.request.urlopen(door.address + "/healthz", timeout=30)
        assert r.status == 200
        assert json.loads(r.read())["status"] == "degraded"
        probe = _rows(16, seed=13)[:, 1:].astype(np.float64)
        out, _r = _post_npy(door.address + "/v1/predict", probe)
        np.testing.assert_array_equal(out, bst.predict(probe,
                                                       raw_score=True))
    finally:
        door.close()
        srv.close(timeout=60)
    # a CLOSED server is neither live nor ready
    door2 = FrontDoor(ServerGateway(srv))
    try:
        for route in ("/readyz", "/healthz"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(door2.address + route, timeout=30)
            assert ei.value.code == 503, route
        assert json.loads(ei.value.read())["status"] == "closed"
    finally:
        door2.close()


# ---------------------------------------------------------------------------
# the front door over a two-tenant port FleetServer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tenants():
    boosters = {}
    for i, leaves in enumerate((15, 31)):
        block = _rows(400, seed=20 + i)
        boosters[f"t{i}"] = lgt.train(
            dict(PARAMS, num_leaves=leaves),
            lgt.Dataset(block[:, 1:], label=block[:, 0]),
            num_boost_round=3, keep_training_booster=True)
    return boosters


def test_frontdoor_fleet_tenant_routes(tenants):
    fleet = lgt.serve_fleet(tenants, raw_score=True, linger_ms=1.0)
    door = FrontDoor(ServerGateway(None, fleet=fleet), chunk_rows=32)
    try:
        probe = _rows(48, seed=22)[:, 1:].astype(np.float64)
        for name, bst in tenants.items():
            want = bst.predict(probe, device=True, raw_score=True)
            out, r = _post_npy(
                door.address + f"/v1/tenants/{name}/predict", probe)
            np.testing.assert_array_equal(out, want)
            assert r.headers.get("Transfer-Encoding") == "chunked"
            rj = _post(door.address + f"/v1/tenants/{name}/predict",
                       json.dumps({"rows": probe[:8].tolist()}).encode(),
                       {"Content-Type": "application/json"})
            body = json.loads(rj.read())
            assert body["meta"]["tenant"] == name
            np.testing.assert_array_equal(body["scores"], want[:8])
            ex, _r = _post_npy(
                door.address + f"/v1/tenants/{name}/explain", probe[:8])
            np.testing.assert_array_equal(
                ex, fleet.explain(name, probe[:8], timeout=60))
        _expect(door.address + "/v1/tenants/nope/predict", 404,
                _npy(probe), {"Content-Type": "application/x-npy"})
        # a fleet gateway has no solo server
        _expect(door.address + "/v1/predict", 404, _npy(probe),
                {"Content-Type": "application/x-npy"})
        st = json.loads(urllib.request.urlopen(
            door.address + "/v1/stats", timeout=30).read())
        assert st["requests"] >= 4
    finally:
        door.close()
        fleet.close()


def test_readyz_flips_503_while_tenant_quarantined(tenants):
    X = _rows(64, seed=23)[:, 1:].astype(np.float64)
    b1 = tenants["t0"]
    cfg = b1.config.copy()
    cfg.set("tpu_integrity_probe_interval_s", 600.0)
    fleet = lgt.serve_fleet({"a": b1, "b": tenants["t1"]}, config=cfg)
    door = FrontDoor(ServerGateway(None, fleet=fleet))
    try:
        r = urllib.request.urlopen(door.address + "/readyz", timeout=30)
        assert json.loads(r.read()) == {"ready": True, "status": "ok"}
        assert fleet.evict("a")
        with faults.inject("bitflip:p=1:where=dev"):
            fleet.predict("a", X[:32])
        assert fleet.tenant_stats("a")["quarantined"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(door.address + "/readyz", timeout=30)
        assert ei.value.code == 503
        body = json.loads(ei.value.read())
        assert body == {"ready": False, "status": "quarantined",
                        "quarantined": ["a"]}
        r = urllib.request.urlopen(door.address + "/healthz", timeout=30)
        assert r.status == 200
        # the quarantined tenant still answers, by the host walk
        out, _r = _post_npy(door.address + "/v1/tenants/a/predict", X)
        np.testing.assert_array_equal(out, b1.predict(X))
    finally:
        door.close()
        fleet.close()


# ---------------------------------------------------------------------------
# the same requests to the JAX door and to the port's
# ---------------------------------------------------------------------------

PARITY_REQUESTS = [
    ("/v1/predict", b"{not json", {"Content-Type": "application/json"}),
    ("/v1/predict", json.dumps({"rows": [["a", "b"]]}).encode(),
     {"Content-Type": "application/json"}),
    ("/v1/predict", json.dumps({"rows": [[1.0, 2.0]]}).encode(),
     {"Content-Type": "application/json"}),
    ("/v1/predict", json.dumps({"nope": 1}).encode(),
     {"Content-Type": "application/json"}),
    ("/v1/predict", b"whatever", {"Content-Type": "text/plain"}),
    ("/v1/predict", b"\x93NUMPY junk", {"Content-Type": "application/x-npy"}),
    ("/v1/predict", b"x" * ((1 << 20) + 1),
     {"Content-Type": "application/x-npy"}),
    ("/v1/nope", b"{}", {"Content-Type": "application/json"}),
    ("/v1/tenants/a/predict", b'{"rows": [[0, 0, 0, 0, 0, 0]]}',
     {"Content-Type": "application/json"}),
    ("/v1/predict", json.dumps({"rows": _rows(8, seed=30)[:, 1:].tolist()}
                               ).encode(),
     {"Content-Type": "application/json"}),
    ("/v1/predict", json.dumps({"rows": _rows(70, seed=31)[:, 1:].tolist()}
                               ).encode(),
     {"Content-Type": "application/json"}),
    ("/v1/predict", _npy(_rows(8, seed=32)[:, 1:]),
     {"Content-Type": "application/x-npy"}),
]


def _answers(door, gets=("/healthz", "/readyz", "/nope")):
    out = []
    for route, body, headers in PARITY_REQUESTS:
        try:
            r = _post(door.address + route, body, headers)
            out.append((r.status, r.headers.get("Content-Type"),
                        r.headers.get("Transfer-Encoding"), r.read()))
        except urllib.error.HTTPError as e:
            out.append((e.code, e.headers.get("Content-Type"), None,
                        e.read()))
    for route in gets:
        try:
            r = urllib.request.urlopen(door.address + route, timeout=30)
            body = json.loads(r.read())
            body.pop("uptime_sec", None)
            out.append((r.status, body))
        except urllib.error.HTTPError as e:
            out.append((e.code, json.loads(e.read())))
    return out


def test_same_status_codes_and_bodies_as_the_jax_door():
    """One L2 model (the same text in both packages) behind each door:
    every request above gets the same status, content type, framing and
    body bytes, scores included."""
    block = _l2_rows(500, seed=33)
    X, y = block[:, 1:].astype(np.float64), block[:, 0]
    jb = lgb.train(L2, lgb.Dataset(X, label=y), num_boost_round=3)
    tb = lgt.train(dict(L2, **CPU), lgt.Dataset(X, label=y),
                   num_boost_round=3)
    assert _no_params(tb.model_to_string()) == \
        _no_params(jb.model_to_string())
    jsrv = jb.serve(linger_ms=1.0, raw_score=True)
    tsrv = tb.serve(linger_ms=1.0, raw_score=True)
    jdoor = JFrontDoor(JServerGateway(jsrv), chunk_rows=64, max_body_mb=1.0)
    tdoor = FrontDoor(ServerGateway(tsrv), chunk_rows=64, max_body_mb=1.0)
    try:
        got, want = _answers(tdoor), _answers(jdoor)
        assert [a[0] for a in got] == \
            [400, 400, 400, 400, 400, 400, 413, 404, 404, 200, 200, 200,
             200, 200, 404]
        assert got == want
    finally:
        jdoor.close()
        tdoor.close()
        jsrv.close(timeout=60)
        tsrv.close(timeout=60)


# ---------------------------------------------------------------------------
# the continual service and the supervised trainer
# ---------------------------------------------------------------------------

def test_continual_service_publishes_and_serves(tmp_path):
    stream, ck = str(tmp_path / "s.csv"), str(tmp_path / "ck")
    _append(stream, _rows(600, seed=11))
    svc = lgt.serve_continual(
        dict(PARAMS), stream, ck, trainer_mode="thread",
        window_rows=800, min_rows=256, iters_per_cycle=2,
        publish_every_iters=2, target_iterations=6, raw_score=True,
        boot_timeout_s=300, poll_sec=0.05, keep_last=64)
    assert isinstance(svc, ContinualService)
    try:
        probe = _rows(24, seed=12)[:, 1:].astype(np.float64)
        url = svc.frontdoor.address
        seen = []
        t_end = time.time() + 120
        while time.time() < t_end:
            _append(stream, _rows(40, seed=len(seen) + 100))
            out, r = _post_npy(url + "/v1/predict", probe)
            seen.append((int(r.headers["X-Model-Generation"]), out,
                         float(r.headers["X-Staleness-Ms"])))
            if svc.stats()["service"]["served_iteration"] >= 6:
                break
            time.sleep(0.1)
        versions = [v for v, _o, _s in seen]
        assert versions == sorted(versions), "generations moved backwards"
        assert svc.generation.version >= 3, seen
        by_iter = {it: read_checkpoint(p)["model"]
                   for it, p in list_checkpoints(ck)}
        checked = 0
        for v, out, stale in seen:
            assert stale >= 0.0
            mark = svc.freshness(v)
            assert mark is not None
            ref = lgt.Booster(params=CPU, model_str=by_iter[mark["iteration"]])
            np.testing.assert_array_equal(
                out, ref.predict(probe, device=True, raw_score=True))
            checked += 1
        assert checked == len(seen)
        # incremental the whole way: never a destructive repack
        assert svc.generation.model_gen == 0
        st = svc.stats()
        assert st["service"]["publishes"] >= 3
        assert st["service"]["publish_errors"] == 0
        assert st["staleness_n"] == len(seen)
        assert svc._booster._engine.config.num_leaves == 15
    finally:
        svc.close()
    assert svc.closed


def test_supervised_relaunch_ends_on_the_uninterrupted_text(tmp_path):
    """Attempt 0 of the supervised child is killed at the iteration
    boundary after its first commit; attempt 1 resumes to the target.
    The poison rows' ``.deadletter`` lines and ``skipped_rows`` survive
    the relaunch, and the final model is the uninterrupted run's."""
    block = _rows(600)
    stream, ck = str(tmp_path / "s.csv"), str(tmp_path / "ck")
    _append(stream, block[:300])
    with open(stream, "a") as f:
        f.write("not,a,number,row,at,all,zzz\n")   # unparseable
        f.write("1.0,2.0\n")                        # ragged
    _append(stream, block[300:])
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    ref_stream = str(ref_dir / "s.csv")
    shutil.copy(stream, ref_stream)
    spec = _spec(TrainerSpec, PARAMS, stream, ck, target_iterations=6)
    sup = TrainerSupervisor(
        spec, max_relaunches=2,
        attempt_env=lambda i: (
            {"LGBM_TPU_FAULTS": "rank_kill:rank=0:after=2"}
            if i == 0 else {"LGBM_TPU_FAULTS": ""}))
    t_end = time.time() + 300
    try:
        while time.time() < t_end and sup.alive:
            time.sleep(0.25)
        assert not sup.alive, sup.describe()
        assert sup.last_rc == 0, sup.describe()
        assert sup.relaunches == 1, sup.describe()
    finally:
        sup.stop()
    st = latest_valid_checkpoint(ck)[1]
    assert int(st["iteration"]) == 6
    assert int(st["service"]["skipped_rows"]) >= 2, st["service"]
    with open(stream + ".deadletter", "rb") as f:
        dead = f.read()
    assert b"not,a,number" in dead and b"1.0,2.0" in dead
    assert os.path.exists(os.path.join(ck, "trainer.hb.1"))
    uninterrupted = _final_text(_spec(
        TrainerSpec, PARAMS, ref_stream, str(ref_dir / "ck"),
        target_iterations=6))
    assert st["model"] == uninterrupted
