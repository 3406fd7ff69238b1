"""Fault-injection harness: deterministic failures on demand.

Copy of ``lightgbm_tpu/robustness/faults.py`` for the PyTorch/CUDA port,
with the same grammar and environment variable, so one
``LGBM_TPU_FAULTS`` drives both packages. The plan is read once at
package import (``install_from_env`` in ``lightgbm_tpu_torch/__init__.py``),
so any process (the CLI, tests, supervised children) runs under injected
faults without code changes; :func:`inject` is the scoped
context-manager equivalent for tests.

Grammar (comma-separated fault specs, colon-separated options)::

    LGBM_TPU_FAULTS="collective:p=0.2,probe_timeout,write_kill"
    LGBM_TPU_FAULTS="collective:p=0.2:seed=7,write_kill:n=1:after=3"

Every site of the JAX package parses. The port consults these:

- ``write_kill`` — checkpoint writes die MID-WRITE (after half the
  payload is written, before the atomic rename), simulating a kill -9
  while snapshotting; raises :class:`WriteKilled`
  (``checkpoint.atomic_write_text``).
- ``disk_full`` — the atomic checkpoint writer's payload write raises
  ``OSError(ENOSPC)`` at the same point: the disk filled mid-write.
  ``write_checkpoint`` answers by pruning beyond ``keep_last`` and
  retrying once.
- ``bitflip`` — silent data corruption, consulted via :func:`check`
  with a ``where=`` consult point. The port's point is ``where=ckpt``:
  one byte of a committed checkpoint file is flipped
  (``checkpoint.write_checkpoint``), which the CRC32 footer catches on
  the next validated read, so recovery anchors on the generation
  before. Without ``where=`` the first consulted point fires.
- ``hang`` — the heartbeat writer (``heartbeat.Heartbeat.beat``) stops
  writing from the moment the fault fires: the child keeps running but
  its liveness file goes silent, which is what a wedged runtime looks
  like to a supervisor. Consulted via :func:`check` (non-raising).
- ``slow_compile`` — stretches the ``compiling`` phase by ``sec``
  seconds (default 30) while keepalives keep flowing: a benign slow
  first iteration (the port builds its CUDA kernels there), the case
  phase-aware supervision must NOT park. Consulted via
  :func:`maybe_delay` at compile-phase entry.
- ``nan_grad`` — one boosting iteration's gradients are poisoned to NaN
  after the objective computes them (``models/gbdt.py``, via
  :func:`check`): the numeric-health guard must fail the iteration as
  ``DATA_CORRUPTION`` before a tree grows from them.
- ``loss_spike`` — the numeric-health guard's loss observation is
  inflated past its spike threshold
  (``integrity.NumericHealthGuard.observe_loss``): the finite-but-wrong
  corruption signature, distinct from NaN.
- ``rank_kill`` — one rank hard-exits (``os._exit`` with
  :data:`EXIT_RANK_KILLED`: no cleanup, no flush, a real kill -9 shape)
  at an iteration boundary, via :func:`maybe_kill_rank` at the top of
  the boosting iteration; ``rank=R`` selects the rank (default: any
  rank that consults) and ``after=N`` skips that rank's first N
  iterations. The engine consults it with its rank in the
  ``torch.distributed`` world (0 outside one).
- ``collective`` — one collective's request is lost before it is issued
  (raises :class:`FaultInjected`; retried under
  ``retry.COLLECTIVE_POLICY``), and ``collective_delay`` — a collective
  stalls ``sec`` seconds inside its deadline: consulted by every
  collective of the distributed learners (``parallel/mesh.Comm``) and
  of injected transport (``distributed.retried_collective``).

These parse and wait for the modules that consult them:
``probe_timeout`` (a device probe:
:func:`.retry.probe_device` consults it, which nothing in the training
path calls); ``dispatch_error``, ``slow_dispatch``, ``publish_fail`` and
``oom`` (the serving tier, ROADMAP A14). ``oom`` raises
:class:`OOMInjected`, whose message carries ``RESOURCE_EXHAUSTED`` so the
retry classifier files it as non-transient.

Options per spec:

- ``p=<float>``  — failure probability per call (default 1.0).
- ``n=<int>``    — at most this many injected failures, then the fault
  disarms (default: unlimited for p<1, 1 for p=1 — a bare
  ``write_kill`` kills exactly one write).
- ``after=<int>`` — skip this many calls before arming (lets a test
  kill the k-th checkpoint write precisely).
- ``seed=<int>`` — per-fault RNG seed (default 0): injections are
  deterministic and reproducible across runs and threads.
- ``sec=<float>`` — duration for delay-style faults (``slow_compile``,
  ``slow_dispatch`` and ``collective_delay``; default 30.0).
- ``rank=<int>`` — rank filter (``rank_kill``): only the matching
  rank's consults count or fire (default: every rank).
- ``where=<name>`` — consult-point filter (``bitflip``): only consults
  passing a matching ``where=`` count or fire; without it the first
  consulted point fires.

Counters are PER-PROCESS: an env-installed plan re-arms in every
subprocess (each child re-runs install_from_env with fresh counters).
"""
from __future__ import annotations

import os
import random
import threading
from typing import Dict, List, Optional

from ..utils import log

ENV_FAULTS = "LGBM_TPU_FAULTS"

KNOWN_SITES = ("collective", "probe_timeout", "write_kill", "hang",
               "slow_compile", "dispatch_error", "slow_dispatch",
               "publish_fail", "rank_kill", "collective_delay", "oom",
               "bitflip", "nan_grad", "loss_spike", "disk_full")

# exit code of an injected rank_kill (distinct from heartbeat's
# EXIT_STALLED=86, so an injected death and a self-watchdogged wedge
# stay apart)
EXIT_RANK_KILLED = 87


class FaultInjected(Exception):
    """An injected TRANSIENT failure (message carries UNAVAILABLE so the
    retry classifier treats it exactly like the real device symptom)."""


class WriteKilled(FaultInjected):
    """An injected mid-write kill: the write never completed; whatever
    bytes hit the disk are garbage that recovery must survive."""


class OOMInjected(FaultInjected):
    """An injected allocation failure — the NON-transient member of the
    family: its message carries ``RESOURCE_EXHAUSTED`` so the retry
    classifier refuses to burn budget on it and the call site must
    adapt instead."""


class _Fault:
    def __init__(self, site: str, p: float = 1.0,
                 n: Optional[int] = None, after: int = 0,
                 seed: int = 0, sec: float = 30.0,
                 rank: Optional[int] = None,
                 where: Optional[str] = None):
        self.site = site
        self.p = float(p)
        self.sec = float(sec)
        self.rank = int(rank) if rank is not None else None
        self.where = str(where) if where is not None else None
        # a bare always-on fault (p=1, no n) fires once then disarms:
        # "kill the write" means one kill, not an unrecoverable loop
        self.n = n if n is not None else (1 if self.p >= 1.0 else None)
        self.after = int(after)
        self.calls = 0
        self.fired = 0
        self.rng = random.Random(seed)
        self.lock = threading.Lock()

    def should_fire(self) -> bool:
        with self.lock:
            self.calls += 1
            if self.calls <= self.after:
                return False
            if self.n is not None and self.fired >= self.n:
                return False
            if self.rng.random() >= self.p:
                return False
            self.fired += 1
            return True

    def __repr__(self):
        return (f"_Fault({self.site}, p={self.p}, n={self.n}, "
                f"after={self.after}, fired={self.fired}/"
                f"calls={self.calls})")


# option name -> its parser
_OPTS = {"n": int, "after": int, "seed": int, "rank": int,
         "p": float, "sec": float, "where": str.strip}


class FaultPlan:
    """Parsed set of active faults, keyed by site."""

    def __init__(self, faults: Dict[str, _Fault]):
        self.faults = faults

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        faults: Dict[str, _Fault] = {}
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            parts = entry.split(":")
            site = parts[0].strip()
            if site not in KNOWN_SITES:
                raise ValueError(
                    f"unknown fault class {site!r}; expected one of "
                    f"{KNOWN_SITES}")
            kw = {}
            for opt in parts[1:]:
                if "=" not in opt:
                    raise ValueError(
                        f"malformed fault option {opt!r} in {entry!r} "
                        "(expected key=value)")
                k, _, v = opt.partition("=")
                k = k.strip()
                if k not in _OPTS:
                    raise ValueError(
                        f"unknown fault option {k!r} in {entry!r}")
                kw[k] = _OPTS[k](v)
            if site in faults:
                raise ValueError(f"duplicate fault class {site!r}")
            faults[site] = _Fault(site, **kw)
        return cls(faults)

    def __repr__(self):
        return f"FaultPlan({list(self.faults.values())})"


_active: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    return _active


def maybe_fail(site: str) -> None:
    """Raise the configured injected failure for ``site`` (no-op when no
    plan is installed or the site's fault doesn't fire this call).

    Call sites sit immediately BEFORE the real operation, so a fired
    fault means the operation did not run this attempt."""
    plan = _active
    if plan is None:
        return
    f = plan.faults.get(site)
    if f is None or not f.should_fire():
        return
    if site == "write_kill":
        raise WriteKilled(
            f"injected mid-write kill (write #{f.calls})")
    if site == "disk_full":
        # the REAL exception shape (OSError/ENOSPC), not a FaultInjected
        # wrapper: the writer's recovery path must classify by errno,
        # exactly as it would for a genuinely full disk
        import errno
        raise OSError(errno.ENOSPC,
                      f"injected disk_full fault (write #{f.calls}, "
                      f"injection #{f.fired})")
    if site == "oom":
        raise OOMInjected(
            f"RESOURCE_EXHAUSTED: injected oom fault "
            f"(call #{f.calls}, injection #{f.fired})")
    raise FaultInjected(
        f"UNAVAILABLE: injected {site} fault "
        f"(call #{f.calls}, injection #{f.fired})")


def check(site: str, where: Optional[str] = None) -> bool:
    """Non-raising consult: True when ``site``'s fault fires this call.

    For fault kinds whose effect is behavioral rather than an exception
    (``hang`` suppresses heartbeat writes, ``bitflip`` corrupts bytes)
    the call site decides what "failing" means; counters/probability/
    arming work exactly like :func:`maybe_fail`. A fault armed with
    ``where=X`` only counts or fires at consults passing ``where="X"``
    (consults elsewhere don't burn ``after=`` budget)."""
    plan = _active
    if plan is None:
        return False
    f = plan.faults.get(site)
    if f is None:
        return False
    if f.where is not None and where != f.where:
        return False
    return f.should_fire()


def maybe_delay(site: str, sleep=None) -> float:
    """Delay-style injection: sleep the fault's ``sec`` when it fires
    and return the seconds slept (0.0 otherwise). Used by
    ``slow_compile`` to stretch the compiling phase without touching
    liveness."""
    plan = _active
    if plan is None:
        return 0.0
    f = plan.faults.get(site)
    if f is None or not f.should_fire():
        return 0.0
    log.warning(f"injected {site} delay: sleeping {f.sec:.1f}s "
                f"(call #{f.calls}, injection #{f.fired})")
    import time
    (sleep if sleep is not None else time.sleep)(f.sec)
    return f.sec


def maybe_kill_rank(rank: int, _exit=os._exit) -> None:
    """``rank_kill`` consult (boosting iteration boundary): when the fault
    fires for THIS rank, hard-exit with :data:`EXIT_RANK_KILLED` — an
    ``os._exit`` so no cleanup or atexit runs. A ``rank=R`` option
    restricts both the call accounting and the kill to rank R (so
    ``after=N`` means "after N of rank R's iterations").

    ``_exit`` is injectable so tests can observe the exit code without
    dying."""
    plan = _active
    if plan is None:
        return
    f = plan.faults.get("rank_kill")
    if f is None:
        return
    if f.rank is not None and int(rank) != f.rank:
        return
    if not f.should_fire():
        return
    log.warning(f"injected rank_kill: rank {rank} hard-exiting "
                f"rc={EXIT_RANK_KILLED} (call #{f.calls}, injection "
                f"#{f.fired})")
    try:
        import sys
        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:   # noqa: BLE001 — dying anyway
        pass
    _exit(EXIT_RANK_KILLED)


class inject:
    """Scoped fault injection::

        with faults.inject("write_kill:after=2"):
            ...train...

    Restores the previous plan on exit. ``inject(None)`` suppresses an
    env-installed plan within the block.
    """

    def __init__(self, spec: Optional[str]):
        self.plan = FaultPlan.parse(spec) if spec else None
        self._saved: List[Optional[FaultPlan]] = []

    def __enter__(self) -> Optional[FaultPlan]:
        global _active
        self._saved.append(_active)
        _active = self.plan
        return self.plan

    def __exit__(self, *exc) -> None:
        global _active
        _active = self._saved.pop()


def install_from_env(env=None) -> bool:
    """Process-wide plan from ``LGBM_TPU_FAULTS`` (returns True if a
    plan was installed). Run at package import, so any importing
    process, children that inherit the variable included, runs under
    the plan."""
    global _active
    e = env if env is not None else os.environ
    spec = (e.get(ENV_FAULTS) or "").strip()
    if not spec or spec.lower() in ("0", "false", "off", "no"):
        return False
    _active = FaultPlan.parse(spec)
    log.warning(f"fault injection ACTIVE ({ENV_FAULTS}): {_active!r}")
    return True
