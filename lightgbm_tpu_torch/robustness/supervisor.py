"""Heartbeat-aware child supervision (the parent side of heartbeat.py).

Copy of ``lightgbm_tpu/robustness/supervisor.py`` for the PyTorch/CUDA
port. Phase-aware liveness deadlines over the heartbeat protocol
replace blind wall-clock slots:

- a child whose heartbeats advance (phase change, progress change, or a
  live keepalive within its phase's stall budget) is NEVER killed or
  parked before the hard deadline — a long first iteration that keeps
  beating is benign, not wedged;
- a child silent past ``silent_sec``, or sitting in one phase past that
  phase's ``stall_sec``, is classified hung: the supervisor asks it to
  exit (SIGTERM — Python cleanup still runs), waits a grace period, and
  raises :class:`DeviceStallError` (transient under the shared
  RetryPolicy, so the caller's retry loop relaunches);
- a child still alive AND advancing at the hard deadline raises
  :class:`StillAlive` — the caller parks it (leaves it running, makes
  no further device claims). SIGKILL is never sent: a caller that must
  end a child it parked or that ignored SIGTERM does so itself.

A supervisor imports nothing of torch here and must never touch the
device it supervises.
"""
from __future__ import annotations

import os
import subprocess
import time
from typing import Callable, Optional

from ..utils import log
from .heartbeat import (ALIVE, SILENT, STALLED, WAITING,  # noqa: F401
                        DeviceStallError, EXIT_STALLED, HeartbeatRecord,
                        StallPolicy, read)

__all__ = ["DeviceStallError", "StallPolicy", "StillAlive",
            "watch_child", "EXIT_STALLED", "terminate_gently"]


class StillAlive(Exception):
    """The hard deadline passed with the child alive and NOT classified
    hung. The caller must park it (leave it running, make no further
    device claims) — never kill it."""

    def __init__(self, msg: str, pid: int):
        super().__init__(msg)
        self.pid = pid


def watch_child(proc: subprocess.Popen, hb_path: str,
                policy: Optional[StallPolicy] = None,
                hard_deadline: Optional[float] = None,
                poll: float = 1.0,
                label: str = "child",
                term_grace: float = 15.0,
                clock: Callable[[], float] = time.monotonic,
                sleep: Callable[[float], None] = time.sleep,
                on_status: Optional[Callable[[str, Optional[
                    HeartbeatRecord]], None]] = None,
                relay=None) -> int:
    """Supervise ``proc`` against its heartbeat file until it exits.

    Returns the child's return code. Raises:

    - :class:`DeviceStallError` when the child is classified hung
      (silent past ``policy.silent_sec``, one phase past its
      ``stall_sec``, or it self-exited with :data:`EXIT_STALLED`). The
      child is SIGTERMed first and given ``term_grace`` seconds; if it
      refuses to die it is left running (noted in the message) — the
      caller's retry decision still stands, but no SIGKILL is ever
      sent.
    - :class:`StillAlive` when ``hard_deadline`` (monotonic, same clock)
      passes while the child is alive and NOT hung — the caller parks.

    A child that never heartbeats at all (uninstrumented) is governed by
    ``startup_grace`` then ``silent_sec`` like any wedged child — every
    supervised entry point in this repo installs the heartbeat before
    its first device touch, so "no file" past the grace means wedged
    imports/backend init, which retrying also fixes more often than
    waiting does.

    ``relay``: an optional :class:`~.heartbeat.Heartbeat` of THIS
    process; every observed child advance is re-beaten onto it, so
    supervision composes hierarchically (a supervisor of this process
    sees it alive exactly as long as its child is).
    """
    policy = policy if policy is not None else StallPolicy.from_env()
    started = clock()
    stall_started: Optional[float] = None
    last_verdict = WAITING
    last_rec: Optional[HeartbeatRecord] = None
    while True:
        rc = proc.poll()
        now = clock()
        if rc is not None:
            if rc == EXIT_STALLED:
                raise DeviceStallError(
                    f"{label} (pid={proc.pid}) self-watchdogged: its "
                    "training loop was wedged at a device sync and it "
                    f"exited rc={EXIT_STALLED}")
            return rc
        rec = read(hb_path)
        if relay is not None and rec is not None and \
                rec.advanced_over(last_rec):
            relay.beat(rec.phase, rec.progress)
        last_rec = rec
        verdict = policy.classify(rec, now, started)
        if verdict != last_verdict:
            if on_status is not None:
                on_status(verdict, rec)
            last_verdict = verdict
        if verdict in (STALLED, SILENT):
            if stall_started is None:
                stall_started = now
            # one extra poll interval of hysteresis: a beat landing
            # between our read and the verdict must not kill an attempt
            if now - stall_started >= poll:
                phase = rec.phase if rec is not None else "<no heartbeat>"
                detail = (
                    f"{label} (pid={proc.pid}) classified hung: "
                    f"{verdict} in phase {phase!r} "
                    f"(beat age {now - rec.t:.0f}s, keepalive age "
                    f"{now - rec.ka:.0f}s)" if rec is not None else
                    f"{label} (pid={proc.pid}) classified hung: no "
                    f"heartbeat {now - started:.0f}s after launch")
                terminate_gently(proc, term_grace, label)
                raise DeviceStallError(detail)
        else:
            stall_started = None
        if hard_deadline is not None and now >= hard_deadline and \
                verdict not in (STALLED, SILENT):
            # only a NOT-hung child parks; one already classified
            # SILENT/STALLED but still inside the hysteresis window
            # finishes classification on the next poll (bounded
            # deadline overrun of ~poll) and earns the SIGTERM + retry
            # instead of a false "advancing" park
            raise StillAlive(
                f"{label} (pid={proc.pid}) alive (verdict {verdict}) "
                "at the hard deadline; parking — no kill",
                pid=proc.pid)
        sleep(poll)


def terminate_gently(proc: subprocess.Popen, grace: float,
                      label: str) -> None:
    """SIGTERM + bounded wait; NEVER SIGKILL. A child that ignores
    SIGTERM is left running and noted — it was already classified hung,
    and whether to kill it is the caller's decision."""
    try:
        proc.terminate()
    except OSError:
        return
    try:
        proc.wait(timeout=max(grace, 1.0))
    except subprocess.TimeoutExpired:
        log.warning(
            f"{label} (pid={proc.pid}) ignored SIGTERM for {grace:.0f}s; "
            "leaving it running (no SIGKILL)")
