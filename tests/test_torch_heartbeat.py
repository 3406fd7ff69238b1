"""Heartbeat-aware supervision in the PyTorch port.

``lightgbm_tpu_torch/robustness/heartbeat.py`` and ``supervisor.py``:
the heartbeat file's round trip, keepalive and torn reads (the JAX
package's reader parses the port's file); the stall policy's phases and
its environment overrides; the supervisor's decisions under a fake
clock and a fake process; children that import only
``lightgbm_tpu_torch.robustness`` and go silent under an injected
``hang``, recovered by the retry policy; the in-training watchdog; and
the boosting loop's phase-tagged beats. The heartbeat and watchdog are
global to a process, so every test that installs them uninstalls them.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import lightgbm_tpu_torch as lgt
from lightgbm_tpu.robustness import heartbeat as jax_heartbeat
from lightgbm_tpu_torch.robustness import faults, heartbeat
from lightgbm_tpu_torch.robustness.heartbeat import (ALIVE, SILENT, STALLED,
                                                     WAITING,
                                                     DeviceStallError,
                                                     Heartbeat, StallPolicy,
                                                     TrainingWatchdog, read)
from lightgbm_tpu_torch.robustness.retry import (RetryPolicy,
                                                 is_transient_error,
                                                 retry_call)
from lightgbm_tpu_torch.robustness.supervisor import (EXIT_STALLED,
                                                      StillAlive,
                                                      watch_child)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture
def no_global_heartbeat():
    heartbeat.uninstall()
    yield
    heartbeat.uninstall()


# ---------------------------------------------------------------------------
# the heartbeat file
# ---------------------------------------------------------------------------

def test_heartbeat_roundtrip(tmp_path):
    path = str(tmp_path / "x.hb")
    hb = Heartbeat(path)
    hb.beat(heartbeat.PHASE_COMPILING, 0)
    rec = read(path)
    assert (rec.phase, rec.progress, rec.pid, rec.seq) == \
        ("compiling", 0, os.getpid(), 1)
    hb.beat(heartbeat.PHASE_ITER, 7)
    rec2 = read(path)
    assert (rec2.phase, rec2.progress, rec2.seq) == ("iter", 7, 2)
    assert rec2.t >= rec.t and rec2.advanced_over(rec)
    assert not rec2.advanced_over(rec2)
    # one file format: the JAX package's reader parses it
    j = jax_heartbeat.read(path)
    assert (j.phase, j.progress, j.t, j.ka, j.pid, j.seq) == \
        (rec2.phase, rec2.progress, rec2.t, rec2.ka, rec2.pid, rec2.seq)


def test_heartbeat_touch_refreshes_keepalive_only(tmp_path):
    path = str(tmp_path / "x.hb")
    clock = {"t": 100.0}
    hb = Heartbeat(path, clock=lambda: clock["t"])
    hb.beat("measuring", 3)
    clock["t"] = 150.0
    hb.touch()
    rec = read(path)
    assert (rec.t, rec.ka, rec.progress) == (100.0, 150.0, 3)


def test_keepalive_thread_refreshes_the_file(tmp_path):
    path = str(tmp_path / "ka.hb")
    hb = Heartbeat(path, keepalive_interval=0.02)
    hb.beat("iter", 1)
    first = read(path)
    hb.start_keepalive()
    try:
        deadline = time.monotonic() + 5.0
        while read(path).ka == first.ka and time.monotonic() < deadline:
            time.sleep(0.02)
        later = read(path)
        assert later.ka > first.ka
        assert (later.t, later.seq) == (first.t, first.seq)
    finally:
        hb.close()


def test_heartbeat_read_tolerates_torn_and_garbage(tmp_path):
    p = tmp_path / "torn.hb"
    assert read(str(p)) is None
    for content in ("", '{"phase": "iter", "progr', '{"phase": "iter"}'):
        p.write_text(content)
        assert read(str(p)) is None
    p.write_bytes(b"\x00\xffgarbage\x01")
    assert read(str(p)) is None
    Heartbeat(str(p)).beat("iter", 1)
    assert read(str(p)).progress == 1


# ---------------------------------------------------------------------------
# the stall policy
# ---------------------------------------------------------------------------

def _rec(phase, progress, t, ka, seq=1):
    return heartbeat.HeartbeatRecord(phase=phase, progress=progress, t=t,
                                     ka=ka, pid=1, seq=seq, wall=0.0)


def test_policy_classify_phases():
    pol = StallPolicy(stall_sec={"compiling": 100.0, "iter": 10.0},
                      default_stall=10.0, silent_sec=5.0,
                      startup_grace=20.0)
    assert pol.classify(None, now=10.0, started_at=0.0) == WAITING
    assert pol.classify(None, now=25.0, started_at=0.0) == SILENT
    assert pol.classify(_rec("compiling", 0, 0.0, 79.0), 80.0, 0.0) == ALIVE
    assert pol.classify(_rec("iter", 5, 0.0, 79.0), 80.0, 0.0) == STALLED
    assert pol.classify(_rec("compiling", 0, 0.0, 0.0), 6.0, 0.0) == SILENT
    assert pol.classify(_rec("iter", 6, 78.0, 79.0), 80.0, 0.0) == ALIVE


def test_policy_from_env_overrides():
    env = {"LGBM_TPU_STALL_SEC": "50",
           "LGBM_TPU_STALL_SEC_COMPILING": "900",
           "LGBM_TPU_STALL_SEC_SILENT": "7",
           "LGBM_TPU_STALL_SEC_GRACE": "3"}
    pol = StallPolicy.from_env(env)
    assert pol.stall_for("compiling") == 900.0
    assert pol.stall_for("iter") == 50.0
    assert pol.stall_for("unknown-phase") == 50.0
    assert (pol.silent_sec, pol.startup_grace) == (7.0, 3.0)
    default = StallPolicy.from_env({})
    assert default.stall_for("compiling") == 1200.0
    assert default.stall_for("iter") == 300.0


# ---------------------------------------------------------------------------
# supervisor decisions (fake clock, fake process)
# ---------------------------------------------------------------------------

class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


class _FakeProc:
    def __init__(self):
        self.pid, self.rc, self.terminated = 4242, None, False

    def poll(self):
        return self.rc

    def terminate(self):
        self.terminated, self.rc = True, -15

    def wait(self, timeout=None):
        if self.rc is None:
            raise subprocess.TimeoutExpired("fake", timeout)
        return self.rc


def _write_rec(path, phase, progress, t, ka, seq=1):
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps({"phase": phase, "progress": progress, "t": t,
                            "ka": ka, "pid": 4242, "seq": seq,
                            "wall": 0.0}))


_POL = StallPolicy(stall_sec={"compiling": 100.0, "iter": 10.0,
                              "measuring": 10.0},
                   default_stall=10.0, silent_sec=5.0, startup_grace=10.0)


def test_supervisor_compile_long_child_survives(tmp_path):
    hb = str(tmp_path / "c.hb")
    clock, proc = _FakeClock(), _FakeProc()

    def sleep(s):
        clock.sleep(s)
        _write_rec(hb, "compiling", 0, t=0.0, ka=clock.t)
        if clock.t >= 60.0:
            proc.rc = 0

    _write_rec(hb, "compiling", 0, t=0.0, ka=0.0)
    assert watch_child(proc, hb, policy=_POL, hard_deadline=500.0, poll=1.0,
                       clock=clock, sleep=sleep) == 0
    assert not proc.terminated and clock.t >= 60.0


def test_supervisor_iterating_child_never_parked_early(tmp_path):
    hb = str(tmp_path / "i.hb")
    clock, proc = _FakeClock(), _FakeProc()

    def sleep(s):
        clock.sleep(s)
        _write_rec(hb, "iter", int(clock.t), t=clock.t, ka=clock.t,
                   seq=int(clock.t) + 1)

    _write_rec(hb, "iter", 0, t=0.0, ka=0.0)
    relay = []

    class _Relay:
        def beat(self, phase, progress):
            relay.append((phase, progress))

    with pytest.raises(StillAlive):
        watch_child(proc, hb, policy=_POL, hard_deadline=50.0, poll=1.0,
                    clock=clock, sleep=sleep, relay=_Relay())
    assert not proc.terminated and clock.t >= 50.0
    assert len(relay) >= 50 and relay[-1][0] == "iter"


def test_supervisor_silent_child_hung_within_budget(tmp_path):
    hb = str(tmp_path / "s.hb")
    clock, proc = _FakeClock(), _FakeProc()
    _write_rec(hb, "measuring", 8, t=0.0, ka=0.0)
    with pytest.raises(DeviceStallError) as ei:
        watch_child(proc, hb, policy=_POL, hard_deadline=1000.0, poll=1.0,
                    clock=clock, sleep=clock.sleep)
    assert clock.t < 15.0 and proc.terminated
    assert "DEADLINE_EXCEEDED" in str(ei.value)
    assert is_transient_error(ei.value)


def test_supervisor_phase_stall_with_live_keepalive(tmp_path):
    hb = str(tmp_path / "p.hb")
    clock, proc = _FakeClock(), _FakeProc()

    def sleep(s):
        clock.sleep(s)
        _write_rec(hb, "measuring", 8, t=0.0, ka=clock.t)

    _write_rec(hb, "measuring", 8, t=0.0, ka=0.0)
    with pytest.raises(DeviceStallError):
        watch_child(proc, hb, policy=_POL, hard_deadline=1000.0, poll=1.0,
                    clock=clock, sleep=sleep)
    assert 10.0 <= clock.t < 20.0


def test_supervisor_maps_exit_stalled_rc(tmp_path):
    proc = _FakeProc()
    proc.rc = EXIT_STALLED
    with pytest.raises(DeviceStallError):
        watch_child(proc, str(tmp_path / "none.hb"), policy=_POL)


# ---------------------------------------------------------------------------
# injected hang: in-process latch, subprocesses recovered by retry
# ---------------------------------------------------------------------------

def test_hang_fault_silences_writes_not_calls(tmp_path):
    path = str(tmp_path / "h.hb")
    hb = Heartbeat(path)
    with faults.inject("hang:after=2"):
        hb.beat("measuring", 1)
        hb.beat("measuring", 2)
        assert read(path).progress == 2
        hb.beat("measuring", 3)          # hang fires: write suppressed
        hb.beat("measuring", 4)
        hb.touch()
        assert read(path).progress == 2  # file frozen
        assert hb.last_attempt >= hb.last_beat


def test_slow_compile_stretches_the_compiling_beat_only(tmp_path):
    slept = []
    with faults.inject("slow_compile:sec=2.5"):
        assert faults.maybe_delay("slow_compile", sleep=slept.append) == 2.5
    assert slept == [2.5]
    hb = Heartbeat(str(tmp_path / "sc.hb"))
    t = time.monotonic()
    with faults.inject("slow_compile:sec=0.3"):
        hb.beat("iter", 1)               # not a compile: no delay
        assert time.monotonic() - t < 0.25
        hb.beat("compiling", 0)
    assert time.monotonic() - t >= 0.3


_CHILD_SRC = r"""
import os, sys, time
sys.path.insert(0, {repo!r})
from lightgbm_tpu_torch.robustness import faults, heartbeat
faults.install_from_env()
heartbeat.install_from_env()
for i in range(int(os.environ.get("SMOKE_ITERS", "40"))):
    heartbeat.beat("iter", i)
    time.sleep(0.05)
"""


def _child_env(hb, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LGBM_TPU_")}
    env.update(LGBM_TPU_HEARTBEAT=hb, LGBM_TPU_HEARTBEAT_KA="0.1", **extra)
    return env


def test_injected_hang_recovered_by_retry(tmp_path):
    """Attempt 1 runs under ``LGBM_TPU_FAULTS=hang:after=3``: its file
    goes silent, it is classified hung and SIGTERMed; attempt 2 (fault
    clear) completes. DeviceStallError is transient, so the shared
    retry policy relaunches."""
    # budgets a loaded machine keeps a healthy child inside: it beats
    # every 0.05 s and refreshes its keepalive every 0.1 s
    pol = StallPolicy(stall_sec={"iter": 6.0}, default_stall=6.0,
                      silent_sec=4.0, startup_grace=60.0)
    attempts = []

    def attempt():
        n = len(attempts) + 1
        attempts.append(n)
        hb = str(tmp_path / f"a{n}.hb")
        env = _child_env(hb, SMOKE_ITERS="400" if n == 1 else "5")
        if n == 1:
            env["LGBM_TPU_FAULTS"] = "hang:after=3"
        proc = subprocess.Popen(
            [sys.executable, "-c", _CHILD_SRC.format(repo=REPO)], env=env)
        try:
            assert watch_child(proc, hb, policy=pol, poll=0.2,
                               term_grace=10.0,
                               label=f"hang attempt {n}") == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        return n

    t0 = time.monotonic()
    assert retry_call(attempt, policy=RetryPolicy(
        max_attempts=3, base_delay=0.01, max_delay=0.05, deadline=120.0),
        what="hang recovery") == 2
    assert attempts == [1, 2]
    assert time.monotonic() - t0 < 100.0


# ---------------------------------------------------------------------------
# the in-training watchdog
# ---------------------------------------------------------------------------

def test_training_watchdog_arms_and_raises(tmp_path):
    hb = Heartbeat(str(tmp_path / "w.hb"))
    pol = StallPolicy(stall_sec={p: 0.15 for p in
                                 ("compiling", "warmup", "measuring",
                                  "iter")},
                      default_stall=0.15, silent_sec=10.0)
    wd = TrainingWatchdog(hb, policy=pol, poll=0.05, exit_on_stall=False)
    wd.start()
    hb.beat("iter", 1)
    wd.begin()
    try:
        try:
            time.sleep(1.0)              # "wedged": no beats while armed
        except KeyboardInterrupt:
            pass                         # the watchdog's interrupt_main
        with pytest.raises(DeviceStallError):
            wd.check()
    finally:
        wd.end()
        wd.stop()


def test_training_watchdog_quiet_when_disarmed(tmp_path):
    hb = Heartbeat(str(tmp_path / "q.hb"))
    pol = StallPolicy(default_stall=0.05, stall_sec={}, silent_sec=10.0)
    wd = TrainingWatchdog(hb, policy=pol, poll=0.02, exit_on_stall=False)
    wd.start()
    time.sleep(0.3)
    wd.check()
    wd.stop()


def test_stall_exit_defaults_to_supervision():
    assert heartbeat._stall_exit_enabled({"LGBM_TPU_HEARTBEAT": "x"})
    assert not heartbeat._stall_exit_enabled({})
    assert heartbeat._stall_exit_enabled({"LGBM_TPU_STALL_EXIT": "1"})
    assert not heartbeat._stall_exit_enabled(
        {"LGBM_TPU_HEARTBEAT": "x", "LGBM_TPU_STALL_EXIT": "0"})


# ---------------------------------------------------------------------------
# the boosting loop
# ---------------------------------------------------------------------------

def _tiny(extra, rounds=4):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(400, 5))
    y = (X[:, 0] > 0).astype(np.float64)
    params = dict(objective="binary", num_leaves=7, verbosity=-1,
                  device_type="cpu", **extra)
    return lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=rounds)


def test_gbdt_writes_phase_tagged_beats(tmp_path, no_global_heartbeat):
    hb_path = str(tmp_path / "train.hb")
    booster = _tiny({"tpu_heartbeat_file": hb_path, "tpu_stall_sec": 60.0})
    assert booster.current_iteration() == 4
    rec = read(hb_path)
    assert rec.phase == "iter" and rec.progress >= 3 and rec.seq >= 4
    wd = heartbeat.training_watchdog()
    assert wd is not None and wd.policy.stall_for("iter") == 60.0
    assert wd.policy.stall_for("compiling") == 60.0


def test_first_iteration_beats_compiling(tmp_path, no_global_heartbeat,
                                         monkeypatch):
    hb_path = str(tmp_path / "env.hb")
    monkeypatch.setenv("LGBM_TPU_HEARTBEAT", hb_path)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 4))
    b = lgt.Booster(dict(objective="binary", num_leaves=7, verbosity=-1,
                         device_type="cpu"),
                    lgt.Dataset(X, label=(X[:, 0] > 0).astype(float)))
    seen = []
    for _ in range(3):
        b.update()
        seen.append(read(hb_path))
    # the beat of iteration i is written as it starts
    assert [(r.phase, r.progress) for r in seen] == \
        [("compiling", 0), ("iter", 1), ("iter", 2)]
    assert seen[0].seq < seen[1].seq < seen[2].seq


def test_watchdog_interrupt_surfaces_as_device_stall(tmp_path,
                                                     no_global_heartbeat,
                                                     monkeypatch):
    """A KeyboardInterrupt raised inside an iteration while a stall is
    armed becomes the classified DeviceStallError; without one armed it
    is a real Ctrl-C and propagates untouched."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 4))
    b = lgt.Booster(dict(objective="binary", num_leaves=7, verbosity=-1,
                         device_type="cpu",
                         tpu_heartbeat_file=str(tmp_path / "k.hb")),
                    lgt.Dataset(X, label=(X[:, 0] > 0).astype(float)))
    eng = b._engine

    def wedged(*a, **k):
        heartbeat.training_watchdog().stalled = "injected stall"
        raise KeyboardInterrupt
    monkeypatch.setattr(eng, "_train_one_iter_body", wedged)
    with pytest.raises(DeviceStallError, match="injected stall"):
        b.update()

    def ctrl_c(*a, **k):
        raise KeyboardInterrupt
    monkeypatch.setattr(eng, "_train_one_iter_body", ctrl_c)
    with pytest.raises(KeyboardInterrupt):
        b.update()
    assert heartbeat.training_watchdog()._depth == 0
