"""Phase-tagged liveness heartbeats.

Copy of ``lightgbm_tpu/robustness/heartbeat.py`` for the PyTorch/CUDA
port, with the same file format and environment variables, so one
supervisor reads children of either package. A supervisor with a blind
wall-clock slot cannot tell a slow first iteration (the port builds its
CUDA kernels there) from a wedged device; this module gives it the
phase the child is in:

- **Writer** (:class:`Heartbeat`): instrumented children — the gbdt
  training loop, supervised scripts — write phase-tagged beats
  (``compiling`` / ``warmup`` / ``measuring`` / ``iter`` + progress
  counter, monotonic timestamp, pid) to a crash-safe single-line-rewrite
  file (tmp + ``os.replace``; a torn or half-written line is unreadable,
  never wrong). A daemon keepalive thread refreshes a separate ``ka``
  timestamp so "process alive" and "loop advancing" are independently
  observable.
- **Reader** (:func:`read`, :class:`StallPolicy`): supervisors replace
  fixed slots with phase-aware liveness deadlines. A child whose phase/
  progress advances is never parked; a child whose keepalive went
  silent, or whose phase sat unchanged past that phase's ``stall_sec``,
  is classified hung (:class:`DeviceStallError` — its message carries
  ``DEADLINE_EXCEEDED`` so the retry classifier treats it as
  transient).
- **In-child watchdog** (:class:`TrainingWatchdog`, driven from
  models/gbdt.py): monitors the *in-memory* age of the training loop's
  last beat attempt — a main thread wedged inside a device sync stops
  calling :meth:`Heartbeat.beat`, and the watchdog raises the process
  out of the hang (interrupt, then a hard exit with
  :data:`EXIT_STALLED`) instead of letting it block forever. Injected
  ``hang`` faults suppress only the *writes* (the file goes silent for
  the supervisor) while beat *calls* continue, so the harness exercises
  the supervisor path, not the self-watchdog.

Timestamps are ``time.monotonic()`` — on Linux that is CLOCK_MONOTONIC,
which is system-wide, so writer and supervisor clocks are directly
comparable across processes. ``wall`` (epoch seconds) rides along for
humans reading the file.

A supervisor needs nothing of torch or CUDA from this module: it must
never touch the device it supervises.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, Dict, Optional

from ..utils import log
from . import faults

ENV_HEARTBEAT = "LGBM_TPU_HEARTBEAT"
# default per-phase stall budget override (seconds, applies to every
# phase without a more specific env); per-phase:
# LGBM_TPU_STALL_SEC_COMPILING etc.
ENV_STALL = "LGBM_TPU_STALL_SEC"
ENV_STALL_EXIT = "LGBM_TPU_STALL_EXIT"
# keepalive refresh cadence (seconds); tests shrink it so silence is
# detectable in seconds instead of a minute
ENV_KEEPALIVE = "LGBM_TPU_HEARTBEAT_KA"

PHASE_COMPILING = "compiling"
PHASE_WARMUP = "warmup"
PHASE_MEASURING = "measuring"
PHASE_ITER = "iter"
# sharded-ingest construction (io/dataset_core._from_columns_sharded),
# beaten per protocol step (counts, summaries, mappers, binning,
# metadata), so a gang supervisor can tell a rank grinding through a big
# all-gather from one wedged on a dead peer
PHASE_INGEST = "ingest"


def rank_path(path: str, rank: int) -> str:
    """Per-rank heartbeat file for a multi-process world: the supervisor
    exports ONE base path (``LGBM_TPU_HEARTBEAT``) and every rank writes
    ``base.r<rank>``, the JAX package's convention: the engine does so
    in a ``torch.distributed`` world of more than one process."""
    return f"{path}.r{int(rank)}"

# exit code of a self-watchdogged child: the supervisor maps it to the
# same DeviceStallError classification a silent child earns
EXIT_STALLED = 86


@dataclasses.dataclass(frozen=True)
class HeartbeatRecord:
    """One parsed heartbeat line."""

    phase: str
    progress: int          # iteration / step counter within the phase
    t: float               # monotonic ts of the last SUBSTANTIVE beat
    ka: float              # monotonic ts of the last keepalive refresh
    pid: int
    seq: int               # total substantive beats written
    wall: float            # epoch seconds (for humans/logs only)

    def advanced_over(self, prev: Optional["HeartbeatRecord"]) -> bool:
        """True when this record shows loop progress over ``prev``
        (phase change, progress change, or a fresh substantive beat)."""
        if prev is None:
            return True
        return (self.phase != prev.phase or
                self.progress != prev.progress or
                self.seq != prev.seq)


def read(path: str) -> Optional[HeartbeatRecord]:
    """Parse the heartbeat file; None on missing/torn/garbage content.

    Torn-write tolerance is the reader's job: the writer's tmp+replace
    makes torn lines rare, but a reader must survive a file caught
    mid-create, truncated by a dying fs, or plain corrupted — any
    parse/shape failure reads as "no heartbeat", never as a crash."""
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            line = f.read()
    except OSError:
        return None
    line = line.strip()
    if not line:
        return None
    try:
        d = json.loads(line)
        return HeartbeatRecord(
            phase=str(d["phase"]), progress=int(d["progress"]),
            t=float(d["t"]), ka=float(d["ka"]), pid=int(d["pid"]),
            seq=int(d["seq"]), wall=float(d.get("wall", 0.0)))
    except (ValueError, KeyError, TypeError):
        return None


class Heartbeat:
    """Crash-safe single-line heartbeat writer.

    ``beat(phase, progress)`` is the substantive signal (refreshes
    ``t``); the keepalive thread refreshes only ``ka``. Both rewrite
    the whole line atomically (tmp + ``os.replace``) so a reader never
    sees a torn record — and a crash between beats loses at most the
    final beat, which is exactly the information a crash invalidates.

    The injected ``hang`` fault (faults.py) suppresses writes from the
    moment it fires — including keepalives — while leaving the
    in-memory beat bookkeeping (``last_attempt``) running, so the
    supervisor sees a silent child while the child itself keeps
    "working" (see module docstring).
    """

    def __init__(self, path: str, pid: Optional[int] = None,
                 keepalive_interval: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.path = path
        self.pid = pid if pid is not None else os.getpid()
        self.keepalive_interval = float(keepalive_interval)
        self.clock = clock
        self.phase = ""
        self.progress = 0
        self.seq = 0
        self.last_beat = clock()       # last substantive WRITE (t field)
        self.last_attempt = clock()    # last beat() CALL (in-memory only)
        self._hung = False             # injected hang fired: stop writing
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._ka_thread: Optional[threading.Thread] = None
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)

    # -- writing -------------------------------------------------------
    def _write(self, t: float, ka: float) -> None:
        if self._hung:
            return
        rec = {"phase": self.phase, "progress": self.progress,
               "t": t, "ka": ka, "pid": self.pid, "seq": self.seq,
               "wall": time.time()}
        tmp = f"{self.path}.{self.pid}.tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(json.dumps(rec))
            os.replace(tmp, self.path)
        except OSError as e:        # liveness reporting must never kill
            log.debug(f"heartbeat write failed: {e!r}")  # the workload

    def beat(self, phase: str, progress: int = 0) -> None:
        """Record a substantive liveness event (phase entry or loop
        progress). Call sites sit at the points a wedge would freeze:
        before compiles, per warmup/timed/boosting iteration, around
        device sync fetches."""
        now = self.clock()
        with self._lock:
            self.last_attempt = now
            if faults.check("hang"):
                # simulate a child whose runtime wedged so hard even the
                # keepalive thread is stuck: the FILE goes silent, the
                # process keeps going (supervisor-path harness)
                self._hung = True
                return
            if self._hung:
                return
            self.phase = str(phase)
            self.progress = int(progress)
            self.seq += 1
            self.last_beat = now
            # conlint: disable=CL002 — deliberate: the lock serializes
            # beat/touch writers so tmp+rename stays crash-consistent;
            # the write is a few hundred bytes to a local file
            self._write(t=now, ka=now)
        if phase == PHASE_COMPILING:
            # injected compile stretch: the phase sits still while the
            # keepalive thread keeps proving the process alive — the
            # exact signature a healthy slow first iteration produces
            faults.maybe_delay("slow_compile")

    def touch(self) -> None:
        """Keepalive refresh: proves the process (and this thread) are
        alive without claiming loop progress."""
        with self._lock:
            if self._hung:
                return
            # conlint: disable=CL002 — same single-writer file-I/O
            # serialization as beat(); see above
            self._write(t=self.last_beat, ka=self.clock())

    # -- keepalive thread ----------------------------------------------
    def start_keepalive(self) -> "Heartbeat":
        if self._ka_thread is None or not self._ka_thread.is_alive():
            self._stop.clear()
            self._ka_thread = threading.Thread(
                target=self._ka_loop, name="lgbm-tpu-heartbeat",
                daemon=True)
            self._ka_thread.start()
        return self

    def _ka_loop(self) -> None:
        while not self._stop.wait(self.keepalive_interval):
            self.touch()

    def close(self) -> None:
        self._stop.set()
        if self._ka_thread is not None:
            self._ka_thread.join(timeout=1.0)


# ---------------------------------------------------------------------------
# process-global instance (installed from env by supervised children)
# ---------------------------------------------------------------------------

_current: Optional[Heartbeat] = None
_watchdog = None        # process-global TrainingWatchdog (one thread)


def current() -> Optional[Heartbeat]:
    return _current


def install(path: str,
            keepalive_interval: Optional[float] = None) -> Heartbeat:
    """Install the process-global heartbeat at ``path`` (keepalive
    thread started). Idempotent per path. The keepalive cadence
    resolves explicit argument > ``LGBM_TPU_HEARTBEAT_KA`` > 5 s, so a
    supervisor that tightened its silence policy via the env reaches
    param-configured (``tpu_heartbeat_file``) workloads too."""
    global _current, _watchdog
    if keepalive_interval is None:
        ka = (os.environ.get(ENV_KEEPALIVE) or "").strip()
        keepalive_interval = float(ka) if ka else 5.0
    if _current is not None and _current.path == os.path.abspath(path):
        return _current
    if _current is not None:
        _current.close()
        if _watchdog is not None:
            _watchdog.stop()
            _watchdog = None
    _current = Heartbeat(os.path.abspath(path),
                         keepalive_interval=keepalive_interval)
    _current.start_keepalive()
    return _current


def uninstall() -> None:
    """Tear down the process-global heartbeat + watchdog (tests; a
    workload whose supervision ended)."""
    global _current, _watchdog
    if _watchdog is not None:
        _watchdog.stop()
        _watchdog = None
    if _current is not None:
        _current.close()
        _current = None


def training_watchdog(policy=None):
    """The process-global :class:`TrainingWatchdog` bound to the
    installed heartbeat (None when unsupervised). ONE daemon thread per
    process regardless of how many boosters train — each caller
    re-arms it per iteration via begin()/end(). A non-None ``policy``
    replaces the active one (last configured booster wins)."""
    global _watchdog
    hb = _current
    if hb is None:
        return None
    if _watchdog is None or _watchdog.hb is not hb:
        if _watchdog is not None:
            _watchdog.stop()
        _watchdog = TrainingWatchdog(hb, policy=policy).start()
    elif policy is not None:
        _watchdog.policy = policy
    return _watchdog


def stall_pending() -> bool:
    """True while a classified stall is armed and not yet consumed by
    ``check()``: a top-level handler tells a watchdog's KeyboardInterrupt
    from a user's Ctrl-C by it. The armed state is consumed when it
    surfaces as DeviceStallError."""
    wd = _watchdog
    return wd is not None and wd.stalled is not None


def install_from_env(env=None) -> Optional[Heartbeat]:
    """Install from ``LGBM_TPU_HEARTBEAT`` (no-op without it). Hooked by
    the instrumented entry points (the gbdt loop's training set-up, a
    supervised script), NOT at package import, as in the JAX package: a
    heartbeat claims "this process is the supervised workload", which
    only the workload itself knows, and importing starts no thread."""
    e = env if env is not None else os.environ
    path = (e.get(ENV_HEARTBEAT) or "").strip()
    if not path:
        return None
    ka = (e.get(ENV_KEEPALIVE) or "").strip()
    return install(path, keepalive_interval=float(ka) if ka else None)


def beat(phase: str, progress: int = 0) -> None:
    """Convenience: beat the process-global heartbeat (no-op when no
    supervisor asked for one)."""
    hb = _current
    if hb is not None:
        hb.beat(phase, progress)


# ---------------------------------------------------------------------------
# stall classification (the supervisor side)
# ---------------------------------------------------------------------------

class DeviceStallError(Exception):
    """A supervised child (or this process's own training loop) sat
    silent past its phase's stall budget: classified hung, not slow.

    The message carries ``DEADLINE_EXCEEDED`` so
    :func:`.retry.is_transient_error` treats a stall exactly like the
    device symptom it is — a retried attempt may well succeed."""

    def __init__(self, msg: str):
        super().__init__(f"DEADLINE_EXCEEDED: {msg}")


# verdicts returned by StallPolicy.classify
ALIVE = "alive"          # advancing, or within its phase's stall budget
STALLED = "stalled"      # file updating (keepalive) but phase sat still
SILENT = "silent"        # file not updating at all
WAITING = "waiting"      # no heartbeat yet, within startup grace


# Default per-phase stall budgets (seconds), the JAX package's: how long
# a phase may sit with NO substantive beat before it is hung. Compiling
# is generous (the first iteration builds the kernels: nvcc, one per
# source, in parallel); iterations are tight — a loop that beat per
# iteration and stopped is wedged, not thinking.
DEFAULT_STALL: Dict[str, float] = {
    PHASE_COMPILING: 1200.0,
    PHASE_WARMUP: 420.0,
    PHASE_MEASURING: 300.0,
    PHASE_ITER: 300.0,
    # one sharded-ingest protocol step (a collective round or a local
    # binning pass)
    PHASE_INGEST: 600.0,
}
DEFAULT_STALL_FALLBACK = 420.0
# keepalives come every ~5 s; 60 s of file silence means even the
# beater thread is stuck (or the process died without the supervisor's
# waitpid noticing yet) — hung at a level no phase budget excuses
DEFAULT_SILENT_SEC = 60.0
DEFAULT_STARTUP_GRACE = 120.0


@dataclasses.dataclass(frozen=True)
class StallPolicy:
    """Phase-aware liveness deadlines (the supervisor's contract).

    - ``stall_sec``: per-phase budget for a phase sitting still
      (substantive beat age). A phase/progress change resets the clock —
      a child advancing iterations is never parked.
    - ``silent_sec``: max heartbeat-file age (keepalive included)
      before the child is hung regardless of phase.
    - ``startup_grace``: time a child may run before its FIRST beat
      (interpreter + imports + backend init).
    """

    stall_sec: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_STALL))
    default_stall: float = DEFAULT_STALL_FALLBACK
    silent_sec: float = DEFAULT_SILENT_SEC
    startup_grace: float = DEFAULT_STARTUP_GRACE

    def stall_for(self, phase: str) -> float:
        return float(self.stall_sec.get(phase, self.default_stall))

    @classmethod
    def from_env(cls, env=None, **overrides) -> "StallPolicy":
        """``LGBM_TPU_STALL_SEC`` scales every phase budget (and the
        fallback); ``LGBM_TPU_STALL_SEC_<PHASE>`` pins one phase."""
        e = env if env is not None else os.environ
        kw: Dict = {}
        table = dict(DEFAULT_STALL)
        default_stall = DEFAULT_STALL_FALLBACK
        base = (e.get(ENV_STALL) or "").strip()
        if base:
            default_stall = float(base)
            table = {p: float(base) for p in table}
        for phase in list(table):
            v = (e.get(f"{ENV_STALL}_{phase.upper()}") or "").strip()
            if v:
                table[phase] = float(v)
        kw["stall_sec"] = table
        kw["default_stall"] = default_stall
        v = (e.get(f"{ENV_STALL}_SILENT") or "").strip()
        if v:
            kw["silent_sec"] = float(v)
        v = (e.get(f"{ENV_STALL}_GRACE") or "").strip()
        if v:
            kw["startup_grace"] = float(v)
        kw.update(overrides)
        return cls(**kw)

    def classify(self, rec: Optional[HeartbeatRecord], now: float,
                 started_at: float) -> str:
        """One verdict from one observation (see ALIVE/STALLED/SILENT/
        WAITING). ``started_at`` is when the child was launched (same
        monotonic clock)."""
        if rec is None:
            if now - started_at <= self.startup_grace:
                return WAITING
            return SILENT
        if now - rec.ka > self.silent_sec:
            return SILENT
        if now - rec.t > self.stall_for(rec.phase):
            return STALLED
        return ALIVE


# ---------------------------------------------------------------------------
# in-child training watchdog (driven from models/gbdt.py)
# ---------------------------------------------------------------------------

def _stall_exit_enabled(env=None) -> bool:
    """Hard-exit escalation default: ON when a supervisor asked for
    heartbeats (it will classify the exit code and relaunch), overridable
    via LGBM_TPU_STALL_EXIT=0/1."""
    e = env if env is not None else os.environ
    v = (e.get(ENV_STALL_EXIT) or "").strip().lower()
    if v:
        return v not in ("0", "false", "off", "no")
    return bool((e.get(ENV_HEARTBEAT) or "").strip())


class TrainingWatchdog:
    """Monitors the *in-memory* beat-attempt age of this process's own
    training loop and refuses to hang forever.

    The gbdt loop beats once per iteration and at the numeric guard's
    read; a main thread wedged inside a blocking runtime call (a CUDA
    synchronize) stops calling ``beat``. When the attempt age exceeds the current phase's
    stall budget the watchdog (a daemon thread):

    1. logs the stall loudly and arms ``stalled`` — the training loop
       raises :class:`DeviceStallError` at its next checkpoint;
    2. calls ``_thread.interrupt_main()`` so a Python-level wait (e.g.
       a retry sleep) unblocks;
    3. if the main thread is wedged in a native call that nothing can
       interrupt (a wedged CUDA sync), hard-exits with
       :data:`EXIT_STALLED` after one more grace period — a classified
       death the supervisor retries, which is strictly better than a
       silent forever-hang (escalation is on only under supervision or
       LGBM_TPU_STALL_EXIT=1).
    """

    def __init__(self, hb: Heartbeat, policy: Optional[StallPolicy] = None,
                 poll: float = 2.0, exit_on_stall: Optional[bool] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.hb = hb
        self.policy = policy if policy is not None else \
            StallPolicy.from_env()
        self.poll = float(poll)
        self.exit_on_stall = (_stall_exit_enabled() if exit_on_stall
                              is None else bool(exit_on_stall))
        self.clock = clock
        self.stalled: Optional[str] = None   # armed with a description
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # re-entrant arm window: the watchdog only judges beat age while
        # an iteration is actually in flight — a trained model sitting
        # idle (predict/serve) must never be "stalled"
        self._depth = 0
        self._depth_lock = threading.Lock()

    def start(self) -> "TrainingWatchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="lgbm-tpu-stall-watchdog",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def begin(self) -> None:
        """Arm the watchdog for an iteration (re-entrant: nested
        begin/end keep it armed until the outermost end)."""
        with self._depth_lock:
            self._depth += 1

    def end(self) -> None:
        with self._depth_lock:
            self._depth = max(0, self._depth - 1)

    def check(self) -> None:
        """Raise if the watchdog armed while we were blocked — the
        training loop calls this at iteration boundaries so a stall
        surfaces as a classified exception, not a hang."""
        if self.stalled is not None:
            msg, self.stalled = self.stalled, None
            raise DeviceStallError(msg)

    def _loop(self) -> None:
        interrupted_at: Optional[float] = None
        while not self._stop.wait(self.poll):
            if self._depth <= 0:
                interrupted_at = None
                continue
            now = self.clock()
            phase = self.hb.phase or PHASE_COMPILING
            budget = self.policy.stall_for(phase)
            age = now - self.hb.last_attempt
            if age <= budget:
                interrupted_at = None
                continue
            if self.stalled is None:
                self.stalled = (
                    f"training loop silent for {age:.0f}s in phase "
                    f"{phase!r} (budget {budget:.0f}s) — device sync "
                    "presumed hung")
                log.warning(f"stall watchdog: {self.stalled}; "
                            "interrupting the main thread")
                import _thread
                try:
                    _thread.interrupt_main()
                except Exception:   # noqa: BLE001
                    pass
                interrupted_at = now
            elif (self.exit_on_stall and interrupted_at is not None and
                    now - interrupted_at > max(budget * 0.25, 30.0)):
                log.warning(
                    f"stall watchdog: main thread still wedged "
                    f"{now - interrupted_at:.0f}s after interrupt; "
                    f"hard-exiting rc={EXIT_STALLED} so the supervisor "
                    "can classify and retry instead of waiting forever")
                os._exit(EXIT_STALLED)
