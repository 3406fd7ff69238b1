"""The port's conlint and lock-order tracker, held to the JAX package's.

The cases of tests/test_concurrency_lint.py run against
``lightgbm_tpu_torch.analysis`` on the same fixture sources: one
positive and one negative fixture per rule (CL001-CL005), suppression by
either comment tag, the reason-carrying baseline and its gate, the
LockGraph units and the runtime tracker firing and staying silent. Each
fixture source is also linted by the JAX package's tool, and the two
give the same (rule, line) findings; the device-sync vocabulary, the one
intended difference, has its own cases (torch's syncs fire CL002, JAX's
``block_until_ready`` no longer does). Then the gate over the port's own
threaded modules, the CLI's exit codes and ``LGBM_TPU_GUARDS``.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest

from lightgbm_tpu.analysis import concurrency as jax_concurrency
from lightgbm_tpu_torch.analysis import concurrency, lockorder
from lightgbm_tpu_torch.analysis.concurrency import (
    CONCURRENCY_RULE_IDS,
    LockGraph,
    lint_source,
    load_baseline_records,
    reasonless_entries,
    run_paths,
    save_baseline,
)

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
REL = "lightgbm_tpu_torch/serving/x.py"


def rules_of(findings):
    return sorted({f.rule for f in findings})


def lint(src):
    return lint_source(textwrap.dedent(src), REL)


def rule_lines(findings):
    return sorted((f.rule, f.line) for f in findings)


# ---------------------------------------------------------------------------
# the JAX package's per-rule fixtures (tests/test_concurrency_lint.py)
# ---------------------------------------------------------------------------

FIXTURES = {
    "cl001_inversion": '''\
        import threading


        class S:
            def __init__(self):
                self.a_lock = threading.Lock()
                self.b_lock = threading.Lock()

            def one(self):
                with self.a_lock:
                    with self.b_lock:
                        pass

            def two(self):
                with self.b_lock:
                    with self.a_lock:
                        pass
        ''',
    "cl001_consistent": '''\
        import threading


        class S:
            def __init__(self):
                self.a_lock = threading.Lock()
                self.b_lock = threading.Lock()

            def one(self):
                with self.a_lock:
                    with self.b_lock:
                        pass

            def two(self):
                with self.a_lock:
                    with self.b_lock:
                        pass
        ''',
    "cl002_sleep_under_lock": '''\
        import threading
        import time


        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def hot(self):
                with self._lock:
                    time.sleep(0.1)
        ''',
    "cl002_outside_lock": '''\
        import threading
        import time


        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def hot(self):
                with self._lock:
                    x = 1
                time.sleep(0.1)
                return x
        ''',
    "cl002_transitive": '''\
        import threading
        import time


        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def _slow(self):
                time.sleep(0.1)

            def hot(self):
                with self._lock:
                    self._slow()
        ''',
    "cl003_unlocked_write": '''\
        import threading


        class W:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0
                self._t = threading.Thread(target=self._run, daemon=True)
                self._t.start()

            def _run(self):
                self.count += 1

            def stats(self):
                return self.count
        ''',
    "cl003_locked_write": '''\
        import threading


        class W:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0
                self._t = threading.Thread(target=self._run, daemon=True)
                self._t.start()

            def _run(self):
                with self._lock:
                    self.count += 1

            def stats(self):
                with self._lock:
                    return self.count
        ''',
    "cl004_wait_in_if": '''\
        import threading


        class S:
            def __init__(self):
                self._cv = threading.Condition()
                self._ready = False

            def get(self):
                with self._cv:
                    if not self._ready:
                        self._cv.wait()
        ''',
    "cl004_wait_in_while": '''\
        import threading


        class S:
            def __init__(self):
                self._cv = threading.Condition()
                self._ready = False

            def get(self):
                with self._cv:
                    while not self._ready:
                        self._cv.wait()
        ''',
    "cl005_undisciplined": '''\
        import threading


        def go():
            t = threading.Thread(target=print)
            t.start()
        ''',
    "cl005_daemon": '''\
        import threading


        def go():
            t = threading.Thread(target=print, daemon=True)
            t.start()
        ''',
}

# the JAX package's positive/negative expectations, fixture by fixture:
# (rule, fires?)
EXPECT = {
    "cl001_inversion": ("CL001", True),
    "cl001_consistent": ("CL001", False),
    "cl002_sleep_under_lock": ("CL002", True),
    "cl002_outside_lock": ("CL002", False),
    "cl002_transitive": ("CL002", True),
    "cl003_unlocked_write": ("CL003", True),
    "cl003_locked_write": ("CL003", False),
    "cl004_wait_in_if": ("CL004", True),
    "cl004_wait_in_while": ("CL004", False),
    "cl005_undisciplined": ("CL005", True),
    "cl005_daemon": ("CL005", False),
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_rule_fixture_fires_or_stays_silent(name):
    rule, fires = EXPECT[name]
    findings = lint(FIXTURES[name])
    assert (rule in rules_of(findings)) == fires, \
        [f.format() for f in findings]
    if name == "cl003_unlocked_write":
        cl3 = [f for f in findings if f.rule == "CL003"]
        assert "count" in cl3[0].line_text


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_findings_equal_the_jax_tools(name):
    src = textwrap.dedent(FIXTURES[name])
    ours = rule_lines(lint_source(src, REL))
    theirs = rule_lines(jax_concurrency.lint_source(
        src, "lightgbm_tpu/serving/x.py"))
    assert ours == theirs


def test_syntax_error_reports_cl000():
    findings = lint_source("def broken(:\n", REL)
    assert [f.rule for f in findings] == ["CL000"]


# ---------------------------------------------------------------------------
# the device-sync vocabulary: torch's, not JAX's
# ---------------------------------------------------------------------------

UNDER_LOCK = '''\
    import threading

    import numpy as np
    import torch


    class S:
        def __init__(self):
            self._lock = threading.Lock()
            self.x = None

        def hot(self, stream, dev):
            with self._lock:
                {call}
    '''

TORCH_SYNCS = ("torch.cuda.synchronize()", "stream.synchronize()",
               "self.x.item()", "self.x.cpu()", "self.x.tolist()",
               "self.x.numpy()", "self.x.to('cpu')",
               "self.x.to(torch.device('cpu'))", "self.x.to(device=dev)",
               "np.asarray(self.x)")


def _under_lock(call):
    return textwrap.dedent(UNDER_LOCK).format(call=call)


@pytest.mark.parametrize("call", TORCH_SYNCS)
def test_torch_sync_under_lock_fires_cl002(call):
    findings = lint_source(_under_lock(call), REL)
    cl2 = [f for f in findings if f.rule == "CL002"]
    assert len(cl2) == 1 and cl2[0].line == 14, \
        [f.format() for f in findings]


@pytest.mark.parametrize("call, jax_fires", [
    # the JAX tool's vocabulary: these fire there, not here
    ("self.x.block_until_ready()", True),
    ("jax.device_get(self.x)", True),
    ("jnp.asarray(self.x)", True),
    # neither tool's: a dtype cast and a reduction stay on the device
    ("self.x.to(torch.float32)", False),
    ("self.x.sum()", False),
])
def test_jax_syncs_and_casts_do_not_fire(call, jax_fires):
    src = _under_lock(call)
    assert "CL002" not in rules_of(lint_source(src, REL))
    assert ("CL002" in rules_of(jax_concurrency.lint_source(
        src, "lightgbm_tpu/serving/x.py"))) == jax_fires


def test_torch_sync_transitive_through_same_module_call():
    findings = lint('''\
        import threading


        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def _read(self, t):
                return t.cpu()

            def hot(self, t):
                with self._lock:
                    return self._read(t)
        ''')
    cl2 = [f for f in findings if f.rule == "CL002"]
    assert cl2 and "`.cpu()`" in cl2[0].message


# ---------------------------------------------------------------------------
# suppression: either comment tag silences a conlint rule
# ---------------------------------------------------------------------------

BLOCKING = FIXTURES["cl002_sleep_under_lock"].replace(
    "time.sleep(0.1)", "{comment}\n                    time.sleep(0.1)")


@pytest.mark.parametrize("comment, silenced", [
    ("# conlint: disable=CL002 — deliberate for this test", True),
    # one suppression regex serves both passes: the jaxlint spelling
    # also silences a CL rule
    ("# jaxlint: disable=CL002", True),
    ("# conlint: disable=CL001", False),
])
def test_suppression(comment, silenced):
    src = textwrap.dedent(BLOCKING).format(comment=comment)
    assert ("CL002" not in rules_of(lint_source(src, REL))) == silenced
    assert rule_lines(lint_source(src, REL)) == rule_lines(
        jax_concurrency.lint_source(src, "lightgbm_tpu/serving/x.py"))


# ---------------------------------------------------------------------------
# baseline: reason preservation + the reasonless gate
# ---------------------------------------------------------------------------

def _some_findings():
    return lint(FIXTURES["cl002_sleep_under_lock"])


def test_baseline_new_entries_get_todo_and_fail_gate(tmp_path):
    path = str(tmp_path / "b.json")
    save_baseline(path, _some_findings())
    records = load_baseline_records(path)
    assert records and all(
        e["reason"].startswith("TODO") for e in records)
    assert reasonless_entries(records) == records


def test_baseline_reasons_survive_regeneration(tmp_path):
    path = str(tmp_path / "b.json")
    findings = _some_findings()
    save_baseline(path, findings)
    records = load_baseline_records(path)
    for e in records:
        e["reason"] = "single-writer telemetry, GIL-atomic reads"
    save_baseline(path, findings, prior_records=records)
    again = load_baseline_records(path)
    assert [e["reason"] for e in again] == [
        "single-writer telemetry, GIL-atomic reads"] * len(records)
    assert reasonless_entries(again) == []


def test_repo_gate_zero_new_findings_and_reasoned_baseline():
    # the port's twelve lock-bearing modules against its own baseline:
    # no new finding, every entry reasoned, no stale entry
    targets = concurrency.default_targets(REPO_ROOT)
    assert len(targets) == len(concurrency.TARGET_MODULES) == 12
    findings = run_paths(targets, REPO_ROOT)
    records = load_baseline_records(
        concurrency.default_baseline_path(REPO_ROOT))
    known = {e["fingerprint"] for e in records}
    new = [f for f in findings if f.fingerprint not in known]
    assert new == [], [f"{f.path}:{f.line} {f.rule}" for f in new]
    assert records and reasonless_entries(records) == []
    assert known == {f.fingerprint for f in findings}
    assert all(e["file"].startswith("lightgbm_tpu_torch/")
               for e in records)


def _cli_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("LGBM_TPU_GUARDS", "LIGHTGBM_TPU_GUARDS")}
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def test_cli_exit_codes(tmp_path, monkeypatch):
    # the module entry itself, once (it imports the package), with a
    # guard token of the JAX package's that has no counterpart here
    ok = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch.analysis"],
        cwd=str(tmp_path), env=_cli_env(LGBM_TPU_GUARDS="log"),
        capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "0 new" in ok.stdout
    assert (ok.stdout + ok.stderr).count("no counterpart") == 1
    # the other exit codes through the same argument handling in-process
    from lightgbm_tpu_torch.analysis import __main__ as cli

    def rc(*argv):
        try:
            return concurrency.main(list(argv), root=cli.REPO_ROOT)
        except SystemExit as e:     # argparse's refusal
            return e.code
    monkeypatch.chdir(tmp_path)     # the targets follow the package
    assert cli.REPO_ROOT == REPO_ROOT
    assert rc("--list") == 0
    assert rc("--pass", "nonsense") == 2
    assert rc("--baseline") == 2
    assert rc("no/such/path.py") == 2
    (tmp_path / "empty").mkdir()
    assert rc(str(tmp_path / "empty")) == 2
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(FIXTURES["cl002_sleep_under_lock"]))
    assert rc(str(bad)) == 1
    assert rc(str(bad), "--no-baseline") == 1


# ---------------------------------------------------------------------------
# LockGraph units
# ---------------------------------------------------------------------------

def test_lockgraph_reports_cycle_path():
    g = LockGraph()
    assert g.add_edge("a", "b", "s1") is None
    assert g.add_edge("b", "c", "s2") is None
    cycle = g.add_edge("c", "a", "s3")
    assert cycle is not None and cycle[0] == cycle[-1] == "a"
    assert set(cycle) == {"a", "b", "c"}


def test_lockgraph_reentrant_and_duplicate_edges():
    g = LockGraph()
    assert g.add_edge("a", "a", "s") is None        # reentrant: ignored
    assert g.add_edge("a", "b", "s1") is None
    assert g.add_edge("a", "b", "s2") is None       # duplicate: no recheck
    assert g.site("a", "b") == "s1"                 # first site wins


def test_lockorder_shares_the_static_lockgraph():
    assert lockorder.LockGraph is LockGraph
    assert lockorder.TARGET_MODULES is concurrency.TARGET_MODULES


# ---------------------------------------------------------------------------
# runtime tracker fire/no-fire
# ---------------------------------------------------------------------------

def _in_thread(fn, timeout=10):
    out = {}

    def run():
        try:
            out["r"] = fn()
        except BaseException as e:  # noqa: BLE001
            out["e"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "worker wedged"
    return out


def test_tracker_consistent_order_is_silent():
    t = lockorder.LockOrderTracker()
    a = lockorder.wrap(threading.Lock(), "A", t)
    b = lockorder.wrap(threading.Lock(), "B", t)

    def ordered():
        with a:
            with b:
                pass

    ordered()
    out = _in_thread(ordered)
    assert "e" not in out and t.violations == []


def test_tracker_inversion_raises_at_attempt():
    t = lockorder.LockOrderTracker()
    a = lockorder.wrap(threading.Lock(), "A", t)
    b = lockorder.wrap(threading.Lock(), "B", t)
    with a:
        with b:
            pass

    def inverted():
        with b:
            with a:
                pass

    out = _in_thread(inverted)
    assert isinstance(out.get("e"), lockorder.LockOrderViolation)
    assert out["e"].cycle[0] == out["e"].cycle[-1]
    assert {"A", "B"} <= set(out["e"].cycle)
    assert t.violations  # recorded as well as raised


def test_tracker_reentrant_rlock_silent():
    t = lockorder.LockOrderTracker()
    r = lockorder.wrap(threading.RLock(), "R", t)
    with r:
        with r:
            pass
    assert t.violations == [] and t.held_names() == []


def test_tracker_condition_wait_roundtrip():
    t = lockorder.LockOrderTracker()
    cv = threading.Condition(
        lockorder.wrap(threading.RLock(), "CV", t))
    flag = []

    def waiter():
        with cv:
            while not flag:
                cv.wait(timeout=5)

    th = threading.Thread(target=waiter, daemon=True)
    th.start()
    with cv:
        flag.append(1)
        cv.notify_all()
    th.join(10)
    assert not th.is_alive()
    assert t.violations == [] and t.held_names() == []


def test_tracker_non_raising_mode_records_only():
    t = lockorder.LockOrderTracker(raise_on_cycle=False)
    a = lockorder.wrap(threading.Lock(), "A", t)
    b = lockorder.wrap(threading.Lock(), "B", t)
    with a:
        with b:
            pass
    out = _in_thread(lambda: b.acquire() and (a.acquire(), a.release(),
                                              b.release()))
    assert "e" not in out
    assert len(t.violations) == 1


def test_factory_patch_frame_filter():
    # locks created from an instrumented file of the port get wrapped;
    # everyone else (the JAX package's files included) keeps the primitive
    with lockorder.tracking() as t:
        files = lockorder._instrumented_files()
        assert len(files) == 12 and all(
            os.sep + "lightgbm_tpu_torch" + os.sep in f for f in files)
        ns = {}
        exec(compile("import threading\n"
                     "lk = threading.Lock()\n"
                     "cv = threading.Condition()\n", files[0], "exec"), ns)
        assert isinstance(ns["lk"], lockorder.TrackedLock)
        assert isinstance(ns["cv"]._lock, lockorder.TrackedLock)
        assert not isinstance(threading.Lock(), lockorder.TrackedLock)
        jax_file = os.path.join(REPO_ROOT, "lightgbm_tpu", "serving",
                                "server.py")
        exec(compile("import threading\nlk = threading.Lock()\n",
                     jax_file, "exec"), ns)
        assert not isinstance(ns["lk"], lockorder.TrackedLock)
        assert t.n_tracked >= 2
    assert not lockorder.installed()
    assert threading.Lock is lockorder._ORIG_LOCK


def test_install_idempotent_and_uninstall_restores():
    try:
        t1 = lockorder.install()
        assert lockorder.install() is t1          # idempotent
        assert lockorder.current_tracker() is t1
    finally:
        lockorder.uninstall()
    assert threading.Condition is lockorder._ORIG_CONDITION
    assert lockorder.current_tracker() is None


def test_rule_ids_exported():
    assert CONCURRENCY_RULE_IDS == ("CL001", "CL002", "CL003", "CL004",
                                    "CL005")


def test_baseline_file_is_valid_json_with_tool_tag():
    with open(concurrency.default_baseline_path(REPO_ROOT),
              encoding="utf-8") as fh:
        data = json.load(fh)
    assert data["tool"] == "conlint"
    assert data["findings"], "baseline unexpectedly empty"


# ---------------------------------------------------------------------------
# LGBM_TPU_GUARDS at import
# ---------------------------------------------------------------------------

def test_guards_env_installs_tracker_before_module_locks():
    # LGBM_TPU_GUARDS is read before any submodule creates its locks:
    # the native build lock, made at import, comes back tracked
    child = ("from lightgbm_tpu_torch import native\n"
             "from lightgbm_tpu_torch.analysis import lockorder\n"
             "print(lockorder.installed(), type(native._lock).__name__)\n")
    out = subprocess.run([sys.executable, "-c", child],
                         env=_cli_env(LIGHTGBM_TPU_GUARDS="lockorder"),
                         cwd=REPO_ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["True", "TrackedLock"], out.stdout


@pytest.mark.parametrize("env, tracked, said", [
    ({"LGBM_TPU_GUARDS": "lockorder"}, True, False),
    ({"LIGHTGBM_TPU_GUARDS": "Strict, lockorder"}, True, True),
    ({"LGBM_TPU_GUARDS": "1"}, False, True),
    ({"LGBM_TPU_GUARDS": "off"}, False, False),
    ({}, False, False),
])
def test_guard_tokens(env, tracked, said, monkeypatch):
    from lightgbm_tpu_torch import analysis
    from lightgbm_tpu_torch.utils import log
    said_msgs = []
    monkeypatch.setattr(log, "warning_once", said_msgs.append)
    try:
        assert analysis.install_guards_from_env(env) is tracked
        assert lockorder.installed() is tracked
    finally:
        lockorder.uninstall()
    assert bool(said_msgs) is said
    if said:
        assert "no counterpart" in said_msgs[0]
