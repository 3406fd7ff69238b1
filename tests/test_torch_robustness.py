"""The PyTorch port's training-side robustness against the JAX package.

``lightgbm_tpu_torch/robustness/``: the retry policy and its error
classifier (with torch's out-of-memory errors), the fault grammar, the
atomic CRC-footed checkpoint writer (mid-write kills, a corrupt newest
file, retention, a full disk), ``checkpoint_callback`` and
``train(resume_from=)`` — a run killed mid-checkpoint and resumed from
the newest valid checkpoint equals an uninterrupted run, the port
against itself bit for bit and, for L2, against the JAX package's own
resumed run string for string — and the numeric-health guard (its
refusal table, the ``nan_grad`` and ``loss_spike`` sites, non-finite
leaves). Both packages run on the CPU from the same numpy data.
"""
import errno
import os
import random

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.robustness import checkpoint as jax_ckpt
from lightgbm_tpu.robustness import faults as jax_faults
from lightgbm_tpu.robustness import retry as jax_retry
from lightgbm_tpu_torch.robustness import checkpoint as ckpt
from lightgbm_tpu_torch.robustness import faults, integrity, retry
from lightgbm_tpu_torch.robustness.retry import (RetryError, RetryPolicy,
                                                 classify_error,
                                                 is_transient_error,
                                                 retry_call)


# ---------------------------------------------------------------------------
# retry.py
# ---------------------------------------------------------------------------

class _Unavailable(Exception):
    pass


def test_retry_succeeds_after_transient_failures():
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise _Unavailable("UNAVAILABLE: injected")
        return "ok"

    out = retry_call(flaky, policy=RetryPolicy(max_attempts=5,
                                               base_delay=0.01,
                                               max_delay=0.05),
                     sleep=slept.append)
    assert out == "ok" and len(calls) == 3 and len(slept) == 2
    assert all(0.0 <= s <= 0.05 for s in slept)


def test_retry_bounded_attempts_then_retryerror():
    calls = []

    def always_down():
        calls.append(1)
        raise _Unavailable("UNAVAILABLE: still down")

    with pytest.raises(RetryError) as ei:
        retry_call(always_down,
                   policy=RetryPolicy(max_attempts=4, base_delay=0.001,
                                      max_delay=0.002),
                   sleep=lambda s: None)
    assert len(calls) == 4 and ei.value.attempts == 4
    assert isinstance(ei.value.last, _Unavailable)


def test_retry_nontransient_propagates_immediately():
    calls = []

    def buggy():
        calls.append(1)
        raise TypeError("code bug")

    with pytest.raises(TypeError):
        retry_call(buggy, policy=RetryPolicy(max_attempts=5),
                   sleep=lambda s: None)
    assert len(calls) == 1


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def test_retry_deadline_respected():
    """No attempt starts after the deadline; sleeps are clipped to it."""
    clock, calls = _Clock(), []

    def always_down():
        calls.append(1)
        clock.t += 3.0
        raise _Unavailable("UNAVAILABLE")

    with pytest.raises(RetryError):
        retry_call(always_down,
                   policy=RetryPolicy(max_attempts=100, base_delay=0.5,
                                      max_delay=2.0, deadline=10.0),
                   sleep=clock.sleep, clock=clock)
    assert 2 <= len(calls) <= 4 and clock.t <= 16.0


def test_retry_budget_kw_and_skipped_sleep():
    clock, budgets = _Clock(), []

    def attempt(slot_budget=None):
        budgets.append(slot_budget)
        clock.t += 40.0
        raise _Unavailable("UNAVAILABLE: nope")

    with pytest.raises(RetryError):
        retry_call(attempt,
                   policy=RetryPolicy(max_attempts=5, base_delay=10.0,
                                      max_delay=10.0, deadline=100.0),
                   clock=clock, sleep=clock.sleep, budget_kw="slot_budget")
    assert budgets[0] == pytest.approx(100.0) and len(budgets) <= 3
    assert all(b < a for a, b in zip(budgets, budgets[1:]))


def test_decorrelated_jitter_bounds():
    p = RetryPolicy(base_delay=0.5, max_delay=30.0)
    rng = random.Random(0)
    d = p.base_delay
    for _ in range(100):
        d = p.next_delay(d, rng)
        assert 0.5 <= d <= 30.0


def _oom_cases():
    return [
        MemoryError("malloc"),
        torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                    "allocate 2.00 GiB"),
        # the type alone, whatever its message says
        torch.cuda.OutOfMemoryError("allocator gave up"),
        RuntimeError("CUDA error: out of memory"),
        RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
        RuntimeError("failed to allocate 2.5G hbm"),
        # OOM text inside a transient-looking envelope: still OOM
        RuntimeError("UNAVAILABLE: failed to allocate 1G"),
    ]


CLASSIFIER_TABLE = {
    "TRANSIENT": lambda: [_Unavailable("UNAVAILABLE: socket closed"),
                          RuntimeError("ABORTED: chip reset"),
                          ConnectionResetError("peer")],
    "DEADLINE": lambda: [TimeoutError("slot wait"),
                         RuntimeError("DEADLINE_EXCEEDED: 5s")],
    "RESOURCE_EXHAUSTED": _oom_cases,
    "FATAL": lambda: [ValueError("a code bug"), KeyError("t0"),
                      RuntimeError("CUDA error: an illegal memory access "
                                   "was encountered")],
    "DATA_CORRUPTION": lambda: [
        RuntimeError("DATA_CORRUPTION: non-finite gradient sum"),
        integrity.IntegrityError("host pack CRC mismatch"),
        integrity.NumericHealthError("NaN leaf at iteration 3")],
}


@pytest.mark.parametrize("expected", sorted(CLASSIFIER_TABLE))
def test_error_classifier_table(expected):
    """Each exception files into exactly one class, as the JAX
    package's classifier files it; torch's out-of-memory errors are
    RESOURCE_EXHAUSTED (not retried)."""
    assert set(CLASSIFIER_TABLE) == set(retry.ERROR_CLASSES)
    for e in CLASSIFIER_TABLE[expected]():
        assert classify_error(e) == expected, (e, classify_error(e))
        assert retry.is_oom_error(e) == (expected == "RESOURCE_EXHAUSTED")
        assert retry.is_corruption_error(e) == (expected ==
                                                "DATA_CORRUPTION")
        assert is_transient_error(e) == (expected in ("TRANSIENT",
                                                      "DEADLINE"))
        if not isinstance(e, integrity.IntegrityError):
            assert jax_retry.classify_error(e) == classify_error(e) or \
                type(e).__name__ == "OutOfMemoryError"


def test_error_classes_documented():
    for cls in retry.ERROR_CLASSES:
        assert f"``{cls}``" in retry.__doc__, cls


def test_torch_oom_is_never_retried():
    calls = []

    def allocate():
        calls.append(1)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory.")

    with pytest.raises(torch.cuda.OutOfMemoryError):
        retry_call(allocate, policy=RetryPolicy(max_attempts=5,
                                                base_delay=0.001))
    assert len(calls) == 1


def test_probe_device_retries_then_reports():
    """``probe_device`` consults ``probe_timeout`` first; with the fault
    armed twice the retry policy rides it out, then the probe itself
    runs (on this machine, without a card, it raises)."""
    with faults.inject("probe_timeout:n=2"):
        seen = []
        with pytest.raises(RetryError) as ei:
            retry_call(retry.probe_device,
                       policy=RetryPolicy(max_attempts=3, base_delay=0.001,
                                          max_delay=0.002),
                       on_retry=lambda n, e: seen.append(str(e)))
    assert len(seen) == 2 and all("probe_timeout" in s for s in seen)
    if not torch.cuda.is_available():
        assert "is_available() is False" in str(ei.value.last)


# ---------------------------------------------------------------------------
# faults.py grammar
# ---------------------------------------------------------------------------

def test_fault_grammar_parse():
    spec = "collective:p=0.2:seed=7,probe_timeout,write_kill:n=1:after=3"
    plan = faults.FaultPlan.parse(spec)
    assert set(plan.faults) == {"collective", "probe_timeout",
                                "write_kill"}
    assert plan.faults["collective"].p == 0.2
    assert plan.faults["write_kill"].after == 3
    assert plan.faults["probe_timeout"].n == 1      # bare: one shot
    jplan = jax_faults.FaultPlan.parse(spec)
    for site, f in plan.faults.items():
        j = jplan.faults[site]
        assert (f.p, f.n, f.after, f.sec, f.rank, f.where) == \
            (j.p, j.n, j.after, j.sec, j.rank, j.where)
    for bad in ("bogus_class", "collective:p", "collective,collective",
                "hang:bogus=1"):
        with pytest.raises(ValueError):
            faults.FaultPlan.parse(bad)
        with pytest.raises(ValueError):
            jax_faults.FaultPlan.parse(bad)


def test_every_known_site_parses_with_every_option():
    assert faults.KNOWN_SITES == jax_faults.KNOWN_SITES
    for site in faults.KNOWN_SITES:
        f = faults.FaultPlan.parse(
            f"{site}:p=0.5:n=2:after=1:seed=3:sec=0.5:rank=0:where=ckpt"
        ).faults[site]
        assert (f.p, f.n, f.after, f.sec, f.rank, f.where) == \
            (0.5, 2, 1, 0.5, 0, "ckpt")


def test_fault_determinism_and_counts():
    def schedule():
        fired = []
        with faults.inject("collective:p=0.5:seed=3:n=100"):
            for _ in range(50):
                try:
                    faults.maybe_fail("collective")
                    fired.append(False)
                except faults.FaultInjected:
                    fired.append(True)
        return fired
    first = schedule()
    assert first == schedule()
    assert any(first) and not all(first)
    # the JAX package's harness fires on the same calls
    jfired = []
    with jax_faults.inject("collective:p=0.5:seed=3:n=100"):
        for _ in range(50):
            jfired.append(jax_faults.check("collective"))
    assert jfired == first
    faults.maybe_fail("collective")        # no plan: never fires


def test_fault_after_and_n():
    with faults.inject("write_kill:after=2:n=1"):
        faults.maybe_fail("write_kill")
        faults.maybe_fail("write_kill")
        with pytest.raises(faults.WriteKilled):
            faults.maybe_fail("write_kill")
        faults.maybe_fail("write_kill")     # disarmed after n=1


def test_fault_kinds_raise_their_classes():
    with faults.inject("oom,disk_full,dispatch_error"):
        with pytest.raises(faults.OOMInjected) as ei:
            faults.maybe_fail("oom")
        assert classify_error(ei.value) == "RESOURCE_EXHAUSTED"
        with pytest.raises(OSError) as ei:
            faults.maybe_fail("disk_full")
        assert ei.value.errno == errno.ENOSPC
        with pytest.raises(faults.FaultInjected) as ei:
            faults.maybe_fail("dispatch_error")
        assert is_transient_error(ei.value)


def test_where_filter_preserves_fault_budget():
    with faults.inject("bitflip:p=1:where=dev"):
        assert not faults.check("bitflip", where="ckpt")
        assert faults.check("bitflip", where="dev")
        assert not faults.check("bitflip", where="dev")


def test_maybe_kill_rank_exits_with_its_code():
    codes = []
    with faults.inject("rank_kill:rank=1:after=1"):
        faults.maybe_kill_rank(0, _exit=codes.append)     # other rank
        faults.maybe_kill_rank(1, _exit=codes.append)     # skipped
        faults.maybe_kill_rank(1, _exit=codes.append)
    assert codes == [faults.EXIT_RANK_KILLED]


def test_install_from_env():
    saved = faults.active_plan()
    try:
        assert not faults.install_from_env({"LGBM_TPU_FAULTS": "off"})
        assert faults.install_from_env({"LGBM_TPU_FAULTS": "nan_grad"})
        assert set(faults.active_plan().faults) == {"nan_grad"}
    finally:
        faults._active = saved


def test_faults_docstring_lists_every_known_site():
    for site in faults.KNOWN_SITES:
        assert f"``{site}``" in faults.__doc__, site


# ---------------------------------------------------------------------------
# checkpoint.py: atomicity, CRC, retention, a full disk
# ---------------------------------------------------------------------------

def test_atomic_write_and_crc_roundtrip(tmp_path):
    state = {"iteration": 7, "model": "tree\nstuff\n", "rng": {"a": 1},
             "best_iteration": -1, "best_score": {},
             "eval_history": {"v": {"l2": [1.0, 0.5]}}}
    path = ckpt.write_checkpoint(str(tmp_path), state)
    assert os.path.basename(path) == "ckpt_000000007.lgbmckpt"
    back = ckpt.read_checkpoint(path)
    assert back["model"] == "tree\nstuff\n" and back["iteration"] == 7
    assert back["eval_history"] == {"v": {"l2": [1.0, 0.5]}}
    assert [n for n in os.listdir(tmp_path) if ".tmp." in n] == []
    # one file format: the JAX package reads it, byte for byte the same
    assert jax_ckpt.read_checkpoint(path) == back
    with open(path, "rb") as f:
        ours = f.read()
    jpath = jax_ckpt.write_checkpoint(str(tmp_path / "jax"), state)
    with open(jpath, "rb") as f:
        assert f.read() == ours
    ckpt.atomic_write_text(str(tmp_path / "plain.txt"), "x\n")
    assert (tmp_path / "plain.txt").read_text() == "x\n"


def test_write_kill_leaves_previous_checkpoints_intact(tmp_path):
    s = {"iteration": 1, "model": "m1", "rng": {}}
    ckpt.write_checkpoint(str(tmp_path), s)
    with faults.inject("write_kill"):
        with pytest.raises(faults.WriteKilled):
            ckpt.write_checkpoint(str(tmp_path),
                                  dict(s, iteration=2, model="m2"))
    names = sorted(os.listdir(tmp_path))
    assert "ckpt_000000001.lgbmckpt" in names
    assert "ckpt_000000002.lgbmckpt" not in names
    assert ckpt.latest_valid_checkpoint(str(tmp_path))[1]["iteration"] == 1
    assert any(".tmp." in n for n in names)
    ckpt.prune_checkpoints(str(tmp_path), keep_last=5)
    assert not any(".tmp." in n for n in os.listdir(tmp_path))


def test_corrupt_newest_falls_back_to_previous(tmp_path):
    for it in (1, 2, 3):
        ckpt.write_checkpoint(str(tmp_path), {"iteration": it,
                                              "model": f"m{it}", "rng": {}})
    newest = os.path.join(tmp_path, "ckpt_000000003.lgbmckpt")
    blob = bytearray(open(newest, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(newest, "wb") as f:
        f.write(blob)
    with pytest.raises(ckpt.CheckpointError):
        ckpt.read_checkpoint(newest)
    _, state = ckpt.latest_valid_checkpoint(str(tmp_path))
    assert state["iteration"] == 2 and state["model"] == "m2"
    trunc = os.path.join(tmp_path, "ckpt_000000002.lgbmckpt")
    blob = open(trunc, "rb").read()
    with open(trunc, "wb") as f:
        f.write(blob[:len(blob) - 10])
    assert ckpt.latest_valid_checkpoint(str(tmp_path))[1]["iteration"] == 1


def test_bitflip_ckpt_site_corrupts_the_committed_file(tmp_path):
    d = str(tmp_path)
    ckpt.write_checkpoint(d, {"iteration": 1, "model": "m1" * 40})
    with faults.inject("bitflip:where=ckpt"):
        path = ckpt.write_checkpoint(d, {"iteration": 2,
                                         "model": "m2" * 40})
    with pytest.raises(ckpt.CheckpointError, match="CRC mismatch"):
        ckpt.read_checkpoint(path)
    assert ckpt.latest_valid_checkpoint(d)[1]["iteration"] == 1


def test_prune_keep_last(tmp_path):
    for it in range(1, 8):
        ckpt.write_checkpoint(str(tmp_path), {"iteration": it, "model": "m"})
    ckpt.prune_checkpoints(str(tmp_path), keep_last=3)
    assert [i for i, _ in ckpt.list_checkpoints(str(tmp_path))] == [7, 6, 5]


def _state(i):
    return {"iteration": i, "model": f"model-{i}\n" * 50}


def test_checkpoint_enospc_prunes_and_retries(tmp_path):
    d = str(tmp_path)
    for i in range(1, 6):
        ckpt.write_checkpoint(d, _state(i))
    with faults.inject("disk_full:p=1"):
        path = ckpt.write_checkpoint(d, _state(6), keep_last=2)
    assert sorted(i for i, _ in ckpt.list_checkpoints(d)) == [4, 5, 6]
    _, st = ckpt.latest_valid_checkpoint(d)
    assert st["iteration"] == 6 and st["model"] == _state(6)["model"]
    assert path.endswith(ckpt.checkpoint_name(6))
    assert not [p for p in tmp_path.iterdir() if ".tmp." in p.name]


def test_checkpoint_enospc_without_retention_is_loud(tmp_path):
    d = str(tmp_path)
    ckpt.write_checkpoint(d, _state(1))
    with faults.inject("disk_full:p=1"):
        with pytest.raises(OSError) as ei:
            ckpt.write_checkpoint(d, _state(2))
    assert ei.value.errno == errno.ENOSPC
    assert ckpt.latest_valid_checkpoint(d)[1]["iteration"] == 1


def test_checkpoint_enospc_twice_is_fatal(tmp_path):
    d = str(tmp_path)
    ckpt.write_checkpoint(d, _state(1))
    with faults.inject("disk_full:p=1:n=2"):
        with pytest.raises(OSError) as ei:
            ckpt.write_checkpoint(d, _state(2), keep_last=2)
    assert ei.value.errno == errno.ENOSPC
    assert ckpt.latest_valid_checkpoint(d)[1]["iteration"] == 1


# ---------------------------------------------------------------------------
# resume: equivalence with an uninterrupted run
# ---------------------------------------------------------------------------

def _data(n=800, f=6, seed=0, objective="binary"):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    signal = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.1 * rng.normal(size=n)
    if objective == "binary":
        return X, (signal > 0).astype(np.float64)
    return X, signal


RESUME = dict(num_leaves=15, learning_rate=0.1, verbosity=-1, seed=3,
              min_data_in_leaf=5, bagging_fraction=0.8, bagging_freq=1,
              feature_fraction=0.9, device_type="cpu")


def _structure(bst):
    return [(t.num_leaves, t.split_feature.tolist(), t.leaf_count.tolist())
            for t in bst._engine.models]


def _trees(bst):
    s = bst.model_to_string()
    return s[s.index("Tree=0"):s.index("end of trees")]


def _kill_and_resume(pkg, fault_mod, params, X, y, rounds, kill_after,
                     ckdir, **kw):
    """Train under ``write_kill:after=kill_after``, which kills the
    checkpoint write of iteration kill_after + 1, then resume."""
    with fault_mod.inject(f"write_kill:after={kill_after}:n=1"):
        with pytest.raises(fault_mod.WriteKilled):
            pkg.train(dict(params), pkg.Dataset(X, label=y),
                      num_boost_round=rounds,
                      callbacks=[pkg.checkpoint_callback(ckdir, every_n=1,
                                                         keep_last=3)], **kw)
    return pkg.train(dict(params), pkg.Dataset(X, label=y),
                     num_boost_round=rounds,
                     callbacks=[pkg.checkpoint_callback(ckdir, every_n=1,
                                                        keep_last=3)],
                     resume_from=ckdir, **kw)


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_resume_equivalence_after_write_kill(tmp_path, objective):
    """Killed mid-checkpoint at iteration 5, resumed from iteration 4:
    the port's final model equals its uninterrupted run bit for bit
    (bagging and column sampling draw from the restored RNG states)."""
    X, y = _data(objective=objective)
    params = dict(RESUME, objective=objective)
    full = lgt.train(dict(params), lgt.Dataset(X, label=y),
                     num_boost_round=8)
    ckdir = str(tmp_path / "ck")
    resumed = _kill_and_resume(lgt, faults, params, X, y, 8, 4, ckdir)
    assert resumed.current_iteration() == 8
    assert _structure(resumed) == _structure(full)
    assert _trees(resumed) == _trees(full)
    np.testing.assert_array_equal(resumed.predict(X), full.predict(X))
    assert ckpt.latest_valid_checkpoint(ckdir)[1]["iteration"] == 8


def test_resumed_l2_matches_jax_resumed_string_for_string(tmp_path):
    X, y = _data(objective="regression")
    params = dict(RESUME, objective="regression")
    runs = {}
    for pkg, fmod in ((lgb, jax_faults), (lgt, faults)):
        runs[pkg] = _kill_and_resume(pkg, fmod, params, X, y, 6, 3,
                                     str(tmp_path / pkg.__name__))
    assert _trees(runs[lgt]) == _trees(runs[lgb])
    np.testing.assert_array_equal(runs[lgt].predict(X), runs[lgb].predict(X))


def test_resume_skips_corrupt_newest(tmp_path):
    X, y = _data(n=500)
    params = dict(RESUME, objective="binary")
    full = lgt.train(dict(params), lgt.Dataset(X, label=y),
                     num_boost_round=6)
    ckdir = str(tmp_path / "ck")
    with faults.inject("write_kill:after=4:n=1"):
        with pytest.raises(faults.WriteKilled):
            lgt.train(dict(params), lgt.Dataset(X, label=y),
                      num_boost_round=6,
                      callbacks=[lgt.checkpoint_callback(ckdir, keep_last=4)])
    path4 = ckpt.latest_valid_checkpoint(ckdir)[0]
    blob = bytearray(open(path4, "rb").read())
    blob[len(blob) // 3] ^= 0x55
    with open(path4, "wb") as f:
        f.write(blob)
    assert ckpt.latest_valid_checkpoint(ckdir)[1]["iteration"] == 3
    resumed = lgt.train(dict(params), lgt.Dataset(X, label=y),
                        num_boost_round=6, resume_from=ckdir)
    assert _trees(resumed) == _trees(full)


def test_resume_from_empty_dir_starts_fresh(tmp_path):
    X, y = _data(n=300)
    b = lgt.train(dict(RESUME, objective="binary"), lgt.Dataset(X, label=y),
                  num_boost_round=3, resume_from=str(tmp_path / "nothing"))
    assert b.current_iteration() == 3


def test_resume_already_complete_returns_immediately(tmp_path):
    X, y = _data(n=300)
    params = dict(RESUME, objective="binary")
    ckdir = str(tmp_path / "ck")
    first = lgt.train(dict(params), lgt.Dataset(X, label=y),
                      num_boost_round=4,
                      callbacks=[lgt.checkpoint_callback(ckdir)])
    b = lgt.train(dict(params), lgt.Dataset(X, label=y), num_boost_round=4,
                  resume_from=ckdir, init_model=first)
    assert b.current_iteration() == 4
    assert _trees(b) == _trees(first)


def test_checkpoint_eval_history_persists(tmp_path):
    """The eval history before the kill is carried into the
    checkpoints written after the resume."""
    X, y = _data(n=500)
    Xv, yv = _data(n=200, seed=9)
    ckdir = str(tmp_path / "ck")

    def run(resume):
        ds = lgt.Dataset(X, label=y)
        kw = dict(resume_from=ckdir) if resume else {}
        return lgt.train(dict(RESUME, objective="binary"), ds,
                         num_boost_round=5,
                         valid_sets=[lgt.Dataset(Xv, label=yv, reference=ds)],
                         valid_names=["v"],
                         callbacks=[lgt.checkpoint_callback(ckdir,
                                                            keep_last=2)],
                         **kw)

    with faults.inject("write_kill:after=2:n=1"):
        with pytest.raises(faults.WriteKilled):
            run(resume=False)
    run(resume=True)
    state = ckpt.latest_valid_checkpoint(ckdir)[1]
    assert state["iteration"] == 5
    assert len(state["eval_history"]["v"]["binary_logloss"]) == 5
    assert set(state["rng"]) == {"sampler", "col"}


def test_checkpoint_callback_arguments_and_cv(tmp_path):
    with pytest.raises(ValueError):
        lgt.checkpoint_callback(str(tmp_path), every_n=0)
    with pytest.raises(ValueError):
        lgt.checkpoint_callback(str(tmp_path), keep_last=0)
    X, y = _data(n=300)
    lgt.cv(dict(RESUME, objective="binary"), lgt.Dataset(X, label=y),
           num_boost_round=2, nfold=2,
           callbacks=[lgt.checkpoint_callback(str(tmp_path / "cv"))])
    assert ckpt.list_checkpoints(str(tmp_path / "cv")) == []


# ---------------------------------------------------------------------------
# the numeric-health guard
# ---------------------------------------------------------------------------

def test_numeric_guard_refusal_table():
    g = integrity.NumericHealthGuard(window=4, spike_factor=10.0)
    g.check_gradients(1.5, 2.5, 0)
    for gs, hs in ((float("nan"), 1.0), (1.0, float("inf"))):
        with pytest.raises(integrity.NumericHealthError):
            g.check_gradients(gs, hs, 1)
    with pytest.raises(integrity.NumericHealthError):
        g.check_leaves(np.array([0.1, np.nan]), 2)
    g.check_leaves(np.array([0.1, -0.2]), 2)
    for i in range(4):
        g.observe_loss(1.0 + 0.01 * i, i)
    with pytest.raises(integrity.NumericHealthError) as ei:
        g.observe_loss(1000.0, 5)
    assert classify_error(ei.value) == "DATA_CORRUPTION"
    for i in range(6, 10):                 # the spike cleared the history
        g.observe_loss(1.0, i)
    with pytest.raises(integrity.NumericHealthError):
        g.observe_loss(float("nan"), 11)


def test_loss_spike_fault_site_trips_guard():
    g = integrity.NumericHealthGuard(window=4, spike_factor=10.0)
    for i in range(4):
        g.observe_loss(1.0, i)
    with faults.inject("loss_spike:p=1"):
        with pytest.raises(integrity.NumericHealthError, match="spiked"):
            g.observe_loss(1.0, 4)


GUARD = dict(objective="binary", num_leaves=7, verbosity=-1,
             device_type="cpu", tpu_integrity_numeric_guard=True)


def test_nan_grad_trips_the_guard_before_a_commit():
    """``nan_grad:after=1`` poisons iteration 1's gradients; the armed
    guard raises before that iteration grows a tree, so the model holds
    iteration 0's tree only."""
    X, y = _data(n=400)
    b = lgt.Booster(dict(GUARD), lgt.Dataset(X, label=y))
    with faults.inject("nan_grad:after=1"):
        b.update()
        with pytest.raises(integrity.NumericHealthError,
                           match="non-finite gradient"):
            b.update()
    assert b.num_trees() == 1 and b._engine.iter == 1


def test_nan_grad_without_the_guard_is_silent():
    """Unguarded, the poisoned iteration raises nothing: its NaN sums
    leave no valid split, and training just stops, as in the JAX
    package. The guard is what names the corruption."""
    X, y = _data(n=400)
    finished = {}
    for pkg, fmod in ((lgb, jax_faults), (lgt, faults)):
        b = pkg.Booster(dict(GUARD, tpu_integrity_numeric_guard=False),
                        pkg.Dataset(X, label=y))
        with fmod.inject("nan_grad:after=1"):
            finished[pkg] = (b.update(), b.update(), b.num_trees())
    assert finished[lgt] == finished[lgb] == (False, True, 1)


def test_loss_spike_site_trips_the_training_guard():
    X, y = _data(n=400)
    b = lgt.Booster(dict(GUARD, tpu_integrity_loss_spike_factor=10.0),
                    lgt.Dataset(X, label=y))
    for _ in range(8):
        b.update()
    with faults.inject("loss_spike"):
        with pytest.raises(integrity.NumericHealthError, match="spiked"):
            b.update()
    assert b.num_trees() == 8


def test_check_leaves_refuses_non_finite_leaves(monkeypatch):
    """A tree whose leaves turn non-finite is refused before it is
    appended to the model."""
    from lightgbm_tpu_torch.models import gbdt
    X, y = _data(n=400)
    b = lgt.Booster(dict(GUARD), lgt.Dataset(X, label=y))
    b.update()
    real = gbdt.finalize_tree

    def poisoned(host, mappers):
        real(host, mappers)
        host.leaf_value[0] = np.inf
    monkeypatch.setattr(gbdt, "finalize_tree", poisoned)
    with pytest.raises(integrity.NumericHealthError, match="leaf"):
        b.update()
    assert b.num_trees() == 1


def test_guard_sums_match_the_host():
    X, y = _data(n=400)
    b = lgt.Booster(dict(GUARD), lgt.Dataset(X, label=y))
    g = torch.linspace(-1.0, 2.0, 12).reshape(3, 4)
    h = torch.full((3, 4), 0.25)
    gs, hs, ga = b._engine._guard_sums(g, h)
    assert gs == pytest.approx(float(g.double().sum()), rel=1e-6)
    assert hs == pytest.approx(3.0)
    assert ga == pytest.approx(float(g.double().abs().mean()), rel=1e-6)
