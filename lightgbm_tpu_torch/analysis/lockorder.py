"""Opt-in runtime lock-order tracker (``LGBM_TPU_GUARDS=lockorder``).

The port's copy of ``lightgbm_tpu/analysis/lockorder.py``. The static
side (:mod:`.concurrency`, rule CL001) proves per-module lock order from
the AST; this module proves it at runtime across *threads*, where the
AST cannot see. It monkeypatches the ``threading.Lock`` /
``threading.RLock`` / ``threading.Condition`` factories so that locks
**created by the instrumented modules** (conlint's ``TARGET_MODULES``:
the port's serving, service, heartbeat, gang, fault-injection and native
build modules) come back wrapped in a tracking proxy. Every acquisition
attempt records an edge "top-of-held-stack -> this lock" into a
process-global :class:`~.concurrency.LockGraph`; the moment an edge
closes a cycle — i.e. two threads have demonstrably acquired the same
locks in opposite orders — :class:`LockOrderViolation` is raised **at
the attempt, before blocking**, so a seeded deadlock trips the guard
instead of hanging the process.

Key properties:

- **Pure stdlib, no torch import.** Safe to install from
  ``lightgbm_tpu_torch/__init__`` before any submodule creates its locks
  (the guards are read there ahead of every submodule import, so
  module-level locks like ``native._lock`` are created post-patch and
  get wrapped).
- **Frame-filtered.** The patched factories inspect the *caller's*
  frame: only call sites inside the instrumented files get a tracked
  lock; CPython's own threading internals (Event/Timer/Thread
  machinery) and third-party code get the original primitives.
- **Cycle check precedes the blocking acquire.** Detection needs only
  inconsistent *order*, not an actual contention window: if thread 1
  ever did A->B, thread 2 merely attempting B->A raises.
- **Reentrancy-aware.** Re-acquiring a lock already on the thread's
  held stack (RLock, or Condition re-entry via ``_acquire_restore``)
  records no edge. ``Condition.wait`` is handled by giving the proxy
  ``_release_save`` / ``_acquire_restore`` / ``_is_owned``, so a plain
  ``threading.Condition`` drives the tracked lock natively.

Test/fixture surface: :func:`wrap` instruments an existing lock by
name; :func:`tracking` is a context manager that installs a private
tracker and restores everything on exit.
"""
from __future__ import annotations

import os
import sys
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from .concurrency import LockGraph, TARGET_MODULES

__all__ = [
    "LockOrderViolation", "LockOrderTracker", "TrackedLock",
    "install", "uninstall", "installed", "current_tracker",
    "wrap", "tracking",
]

# the unpatched factories, captured at import (install() may rebind the
# threading module's names; these always denote the real primitives)
_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock
_ORIG_CONDITION = threading.Condition


class LockOrderViolation(RuntimeError):
    """Two threads acquired tracked locks in incompatible orders.

    Carries ``cycle`` (the lock-name path ``[b, ..., a, b]``) and
    ``sites`` (one "thread/file:line" string per recorded edge on the
    cycle) so the failure message names both ends of the inversion.
    """

    def __init__(self, msg: str, cycle: List[str], sites: List[str]):
        super().__init__(msg)
        self.cycle = cycle
        self.sites = sites


def _call_site(depth: int) -> str:
    """thread-name@file:line of the nearest frame above ``depth`` that
    is OUTSIDE this module (skips the proxy's own acquire/__enter__)."""
    try:
        f = sys._getframe(depth)
        while f is not None and f.f_code.co_filename == __file__:
            f = f.f_back
        if f is None:
            return threading.current_thread().name
        return (f"{threading.current_thread().name}@"
                f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}")
    except Exception:
        return threading.current_thread().name


class LockOrderTracker:
    """Process-global acquisition-order graph over tracked locks."""

    def __init__(self, raise_on_cycle: bool = True):
        self.graph = LockGraph()
        self.raise_on_cycle = raise_on_cycle
        self.violations: List[LockOrderViolation] = []
        self.n_tracked = 0          # locks wrapped so far
        self._tls = threading.local()
        self._mu = _ORIG_LOCK()     # guards graph + violations
        self._names: Dict[str, int] = {}  # name -> count, for uniquing

    # -- naming ------------------------------------------------------
    def unique_name(self, base: str) -> str:
        with self._mu:
            n = self._names.get(base, 0)
            self._names[base] = n + 1
            self.n_tracked += 1
            return base if n == 0 else f"{base}#{n}"

    # -- per-thread held stack ---------------------------------------
    def _stack(self) -> List["TrackedLock"]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def held_names(self) -> List[str]:
        """Names of locks the CURRENT thread holds (innermost last)."""
        return [lk.name for lk in self._stack()]

    # -- the protocol the proxies call -------------------------------
    def note_attempt(self, lk: "TrackedLock") -> None:
        """Record the order edge BEFORE blocking; raise on a cycle."""
        st = self._stack()
        if not st or any(x is lk for x in st):
            return              # outermost, or reentrant: no new edge
        prev = st[-1]
        site = _call_site(3)    # caller of acquire()
        with self._mu:
            cycle = self.graph.add_edge(prev.name, lk.name, site)
            if cycle is None:
                return
            sites = [f"{a}->{b} at {self.graph.site(a, b)}"
                     for a, b in zip(cycle, cycle[1:])]
            v = LockOrderViolation(
                "lock-order inversion: acquiring "
                f"{lk.name!r} while holding {prev.name!r} closes the "
                f"cycle {' -> '.join(cycle)} (edges: {'; '.join(sites)})"
                " — two threads entering from different ends deadlock",
                cycle, sites)
            self.violations.append(v)
        if self.raise_on_cycle:
            raise v

    def note_acquired(self, lk: "TrackedLock") -> None:
        self._stack().append(lk)

    def note_released(self, lk: "TrackedLock") -> None:
        st = self._stack()
        # innermost matching entry: releases may be out of LIFO order
        # (contextlib.ExitStack, hand-over-hand), track whatever happens
        for i in range(len(st) - 1, -1, -1):
            if st[i] is lk:
                del st[i]
                return

    def drop_all(self, lk: "TrackedLock") -> int:
        """Remove every stack entry for ``lk`` (Condition._release_save
        on a reentrantly-held RLock); returns how many were held."""
        st = self._stack()
        n = sum(1 for x in st if x is lk)
        st[:] = [x for x in st if x is not lk]
        return n

    def restore_all(self, lk: "TrackedLock", n: int) -> None:
        self.note_attempt(lk)
        self._stack().extend([lk] * max(n, 1))


class TrackedLock:
    """Order-tracking proxy around a Lock/RLock.

    Duck-types the full lock protocol plus the three private hooks
    ``threading.Condition`` probes for (``_release_save`` /
    ``_acquire_restore`` / ``_is_owned``), so ``Condition(TrackedLock)``
    works natively — including reentrant-RLock ``wait()``.
    """

    __slots__ = ("_inner", "name", "_tracker")

    def __init__(self, inner, name: str, tracker: LockOrderTracker):
        self._inner = inner
        self.name = name
        self._tracker = tracker

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._tracker.note_attempt(self)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._tracker.note_acquired(self)
        return got

    def release(self) -> None:
        self._tracker.note_released(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<TrackedLock {self.name!r} over {self._inner!r}>"

    # -- Condition integration ---------------------------------------
    def _release_save(self):
        n = self._tracker.drop_all(self)
        inner = self._inner
        if hasattr(inner, "_release_save"):     # RLock: full release
            return (inner._release_save(), n)
        inner.release()
        return (None, n)

    def _acquire_restore(self, state) -> None:
        saved, n = state
        inner = self._inner
        if hasattr(inner, "_acquire_restore"):
            inner._acquire_restore(saved)
        else:
            inner.acquire()
        self._tracker.restore_all(self, n)

    def _is_owned(self) -> bool:
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        # primitive-lock heuristic, same as threading.Condition's
        if inner.acquire(False):
            inner.release()
            return False
        return True


# ---------------------------------------------------------------------------
# installation: factory monkeypatching, frame-filtered
# ---------------------------------------------------------------------------

_tracker: Optional[LockOrderTracker] = None


def _instrumented_files() -> Tuple[str, ...]:
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return tuple(os.path.join(pkg_root, *rel.split("/")[1:])
                 for rel in TARGET_MODULES)


def _caller_is_instrumented(files: Tuple[str, ...]) -> Tuple[bool, str]:
    """(instrumented?, name-base) for the factory's caller frame."""
    try:
        f = sys._getframe(2)    # factory wrapper -> its caller
    except Exception:
        return False, ""
    fn = f.f_code.co_filename
    if fn not in files:
        # co_filename follows however the module was imported and may
        # be non-normalized (e.g. tests/../lightgbm_tpu_torch/...): one
        # normpath on the miss path keeps the hit path allocation-free
        fn = os.path.normpath(fn)
        if fn not in files:
            return False, ""
    mod = os.path.splitext(os.path.basename(fn))[0]
    if mod == "__init__":
        mod = os.path.basename(os.path.dirname(fn))
    return True, f"{mod}:{f.f_lineno}"


def current_tracker() -> Optional[LockOrderTracker]:
    return _tracker


def installed() -> bool:
    return _tracker is not None


def wrap(lock, name: str, tracker: Optional[LockOrderTracker] = None
         ) -> TrackedLock:
    """Instrument an existing lock under ``name`` (fixtures/tests).

    Uses the installed tracker by default; with none installed a
    private one is created on the fly (edges recorded, cycles raise).
    """
    global _tracker
    t = tracker or _tracker
    if t is None:
        t = LockOrderTracker()
    return TrackedLock(lock, t.unique_name(name), t)


def install(tracker: Optional[LockOrderTracker] = None) -> LockOrderTracker:
    """Patch the threading factories; idempotent. Returns the tracker.

    Must run BEFORE the instrumented modules create their locks —
    lightgbm_tpu_torch/__init__ guarantees this by reading the guards
    ahead of every submodule import.
    """
    global _tracker
    if _tracker is not None:
        return _tracker
    t = tracker or LockOrderTracker()
    files = _instrumented_files()

    def Lock():
        hit, base = _caller_is_instrumented(files)
        if not hit:
            return _ORIG_LOCK()
        return TrackedLock(_ORIG_LOCK(), t.unique_name(f"{base}/Lock"), t)

    def RLock():
        hit, base = _caller_is_instrumented(files)
        if not hit:
            return _ORIG_RLOCK()
        return TrackedLock(_ORIG_RLOCK(), t.unique_name(f"{base}/RLock"), t)

    def Condition(lock=None):
        hit, base = _caller_is_instrumented(files)
        if not hit:
            return _ORIG_CONDITION(lock)
        if lock is None:
            lock = TrackedLock(_ORIG_RLOCK(),
                               t.unique_name(f"{base}/Condition"), t)
        elif not isinstance(lock, TrackedLock):
            lock = TrackedLock(lock, t.unique_name(f"{base}/Condition"), t)
        # a REAL threading.Condition driving the tracked lock: wait()
        # goes through _release_save/_acquire_restore on the proxy, so
        # held-stack bookkeeping survives the release-reacquire dance
        return _ORIG_CONDITION(lock)

    threading.Lock = Lock
    threading.RLock = RLock
    threading.Condition = Condition
    _tracker = t
    return t


def uninstall() -> None:
    """Restore the original factories (already-wrapped locks keep
    tracking into the now-detached tracker; they stay functional)."""
    global _tracker
    threading.Lock = _ORIG_LOCK
    threading.RLock = _ORIG_RLOCK
    threading.Condition = _ORIG_CONDITION
    _tracker = None


@contextmanager
def tracking(raise_on_cycle: bool = True):
    """Install a private tracker for the block; restore on exit.

        with lockorder.tracking() as t:
            ... spin up threads over instrumented modules ...
        assert not t.violations
    """
    prev = _tracker
    if prev is not None:
        uninstall()
    t = install(LockOrderTracker(raise_on_cycle=raise_on_cycle))
    try:
        yield t
    finally:
        uninstall()
        if prev is not None:
            install(prev)
