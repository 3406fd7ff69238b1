"""Reusable retry policy: bounded attempts, decorrelated-jitter backoff,
an overall deadline, and an error classifier.

Copy of ``lightgbm_tpu/robustness/retry.py`` for the PyTorch/CUDA port.
One policy answers "how long do we believe in a flaky device" for every
caller: a call is retried only while its failure classifies as
transient, with bounded attempts and a deadline.

Backoff is decorrelated jitter (Marc Brooker, "Exponential Backoff
And Jitter"): ``sleep = min(cap, uniform(base, prev_sleep * 3))`` —
spreads concurrent retriers apart instead of re-synchronizing them the
way plain exponential backoff does.

Classifier table — every failure a call site may see falls in exactly
one class, and this table is the single place the classes are defined
(tests assert the table, the docstring and the classifiers stay in
sync):

- ``TRANSIENT`` — device/network flake (UNAVAILABLE / ABORTED /
  connection errors): a later attempt of the SAME call may succeed, so
  :func:`retry_call` burns budget on it. Markers:
  :data:`TRANSIENT_MARKERS` / :data:`TRANSIENT_TYPES`.
- ``DEADLINE`` — a liveness budget expired (DEADLINE_EXCEEDED /
  timeouts; a supervisor's :class:`~.heartbeat.DeviceStallError`).
  Retried like TRANSIENT (the next attempt gets a fresh sub-slot), but
  reported distinctly by :func:`classify_error` so forensics can tell a
  flake from a wedge. Markers: :data:`DEADLINE_MARKERS` /
  ``TimeoutError``.
- ``RESOURCE_EXHAUSTED`` — an allocation failed (``MemoryError``,
  ``torch.cuda.OutOfMemoryError``, "CUDA error: out of memory", XLA's
  RESOURCE_EXHAUSTED). Retrying the SAME allocation is futile, so the
  classifier returns non-transient and :func:`retry_call` propagates
  immediately; the call site must ADAPT the request instead (the
  serving tier's batch bisection and pack eviction, ROADMAP A14).
  Markers: :data:`OOM_MARKERS` / :data:`OOM_TYPES`.
- ``DATA_CORRUPTION`` — the call RAN but produced wrong bits
  (NaN-poisoned gradients: the :mod:`.integrity` exception family).
  NOT transient: retrying the identical call re-produces the identical
  corruption, so :func:`retry_call` propagates immediately and the
  caller must RECOVER (roll back to the newest CRC-valid checkpoint).
  Markers: :data:`CORRUPTION_MARKERS`.
- ``FATAL`` — everything else (a code bug): propagates immediately,
  never retried, never adapted around.

Nothing here touches a device at import; :func:`probe_device` imports
torch when it is called.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional

from ..utils import log

# Substrings of exception text (or type name) that mark a failure as
# transient — retry may succeed. The gRPC status names are the JAX
# package's device symptoms, kept so one classifier reads both
# packages' errors (and a child's, as text); the plain words cover
# socket/timeout errors raised by launchers.
TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "connection reset",
    "connection refused",
    "timed out",
    "timeout",
)

# Exception type names treated as transient regardless of message.
TRANSIENT_TYPES = (
    "TimeoutError",
    "ConnectionError",
    "ConnectionResetError",
    "ConnectionRefusedError",
    "BrokenPipeError",
)

# The DEADLINE sub-class of the transient markers: budget expiries that
# classify_error reports distinctly (still retried by retry_call).
DEADLINE_MARKERS = (
    "DEADLINE_EXCEEDED",
    "timed out",
    "timeout",
)

# Substrings marking RESOURCE_EXHAUSTED: the allocation itself failed,
# so re-attempting the SAME call is futile — the caller must shrink,
# bisect or evict. XLA's OOM status is the gRPC name; "out of memory"
# covers torch's caching allocator ("CUDA out of memory. Tried to
# allocate ...") and the CUDA runtime ("CUDA error: out of memory"),
# and the plain phrases host MemoryError reprs.
OOM_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "out of memory",
    "failed to allocate",
)

# Exception type names treated as RESOURCE_EXHAUSTED regardless of
# message (host-side allocation failures during re-bin / pack build).
OOM_TYPES = (
    "MemoryError",
    # torch.cuda.OutOfMemoryError (torch.OutOfMemoryError)
    "OutOfMemoryError",
)

# Substrings marking DATA_CORRUPTION: the call ran and returned wrong
# bits. Every integrity.IntegrityError message carries the marker, so
# classification works across process boundaries (a child trainer's
# corruption surfaces to its supervisor as text).
CORRUPTION_MARKERS = (
    "DATA_CORRUPTION",
)

# The classifier table, machine-readable: class name -> one-line
# contract. The tests assert every class here appears in the module
# docstring.
ERROR_CLASSES = {
    "TRANSIENT": "device/network flake — retry the same call",
    "DEADLINE": "liveness budget expired — retry with a fresh slot",
    "RESOURCE_EXHAUSTED": "allocation failed — adapt, never retry",
    "DATA_CORRUPTION": "wrong bits produced — roll back, never retry",
    "FATAL": "code bug — propagate immediately",
}


def is_oom_error(exc: BaseException) -> bool:
    """True when ``exc`` is RESOURCE_EXHAUSTED-classified: the
    allocation failed, so retrying the identical call cannot succeed.
    Callers adapt instead (bisect the batch / evict a pack / shrink
    the window)."""
    for t in type(exc).__mro__:
        if t.__name__ in OOM_TYPES:
            return True
    text = f"{type(exc).__name__}: {exc}"
    upper = text.upper()
    return any(m.upper() in upper for m in OOM_MARKERS)


def is_corruption_error(exc: BaseException) -> bool:
    """True when ``exc`` is DATA_CORRUPTION-classified: the call ran
    but produced wrong bits, so retrying it re-produces the identical
    corruption. Callers roll back / quarantine / relaunch instead
    (integrity.py is the exception family; matching is on the message
    marker so child-process corruption classifies identically)."""
    text = f"{type(exc).__name__}: {exc}"
    upper = text.upper()
    return any(m.upper() in upper for m in CORRUPTION_MARKERS)


def is_transient_error(exc: BaseException) -> bool:
    """True when ``exc`` looks like a device/network failure that a
    later attempt may survive (UNAVAILABLE / DEADLINE_EXCEEDED /
    timeouts), False for anything that smells like a code bug.

    RESOURCE_EXHAUSTED is explicitly NOT transient even when the
    runtime dresses it in otherwise-transient text: retrying the same
    allocation burns the whole budget on attempts that cannot succeed
    — :func:`retry_call` propagates it so the caller can adapt.
    DATA_CORRUPTION is NOT transient for the same reason: the retried
    call would re-produce the same wrong bits; the caller must roll
    back or repair instead.

    Matching is on type names and message text, so an error read from
    a child process's output classifies the same way.
    """
    if is_oom_error(exc) or is_corruption_error(exc):
        return False
    for t in type(exc).__mro__:
        if t.__name__ in TRANSIENT_TYPES:
            return True
    text = f"{type(exc).__name__}: {exc}"
    upper = text.upper()
    return any(m.upper() in upper for m in TRANSIENT_MARKERS)


def classify_error(exc: BaseException) -> str:
    """Classify ``exc`` into one of :data:`ERROR_CLASSES`.

    Precedence: RESOURCE_EXHAUSTED beats DATA_CORRUPTION beats
    DEADLINE beats TRANSIENT (an OOM whose message also mentions a
    timeout is still an OOM); anything unrecognized is FATAL."""
    if is_oom_error(exc):
        return "RESOURCE_EXHAUSTED"
    if is_corruption_error(exc):
        return "DATA_CORRUPTION"
    if not is_transient_error(exc):
        return "FATAL"
    for t in type(exc).__mro__:
        if t.__name__ == "TimeoutError":
            return "DEADLINE"
    upper = f"{type(exc).__name__}: {exc}".upper()
    if any(m.upper() in upper for m in DEADLINE_MARKERS):
        return "DEADLINE"
    return "TRANSIENT"


class RetryError(Exception):
    """All attempts failed (or the deadline passed). ``last`` holds the
    final underlying exception; ``attempts`` how many were made."""

    def __init__(self, msg: str, last: Optional[BaseException],
                 attempts: int):
        super().__init__(msg)
        self.last = last
        self.attempts = attempts


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with decorrelated-jitter backoff and a deadline.

    - ``max_attempts``: total tries (first call included).
    - ``base_delay`` / ``max_delay``: jitter window bounds in seconds.
    - ``deadline``: wall-clock budget across ALL attempts (None = no
      deadline). No new attempt starts after it passes, and the
      pre-attempt sleep is clipped to it, so the policy can never
      outlive its budget.
    - ``classifier``: exception -> bool (True = transient, retry).
    """

    max_attempts: int = 5
    base_delay: float = 0.5
    max_delay: float = 30.0
    deadline: Optional[float] = None
    classifier: Callable[[BaseException], bool] = is_transient_error

    def next_delay(self, prev_delay: float,
                   rng: random.Random) -> float:
        """Decorrelated jitter: uniform(base, prev*3) capped."""
        hi = max(self.base_delay, prev_delay * 3.0)
        return min(self.max_delay, rng.uniform(self.base_delay, hi))

    def from_env_overrides(self, env) -> "RetryPolicy":
        """LGBM_TPU_RETRY_* env knobs override individual fields
        (ATTEMPTS / BASE_DELAY / MAX_DELAY / DEADLINE)."""
        kw = {}
        if env.get("LGBM_TPU_RETRY_ATTEMPTS"):
            kw["max_attempts"] = int(env["LGBM_TPU_RETRY_ATTEMPTS"])
        if env.get("LGBM_TPU_RETRY_BASE_DELAY"):
            kw["base_delay"] = float(env["LGBM_TPU_RETRY_BASE_DELAY"])
        if env.get("LGBM_TPU_RETRY_MAX_DELAY"):
            kw["max_delay"] = float(env["LGBM_TPU_RETRY_MAX_DELAY"])
        if env.get("LGBM_TPU_RETRY_DEADLINE"):
            kw["deadline"] = float(env["LGBM_TPU_RETRY_DEADLINE"])
        return dataclasses.replace(self, **kw) if kw else self


# Policy of the in-band training call sites (collectives, the
# distributed world's start): short sleeps, a training step waits on
# them, but enough attempts to ride out a p=0.2 injected failure rate
# (ref: the JAX package's robustness/retry.py:258-263)
COLLECTIVE_POLICY = RetryPolicy(max_attempts=5, base_delay=0.05,
                                max_delay=2.0, deadline=120.0)

# Policy of device acquisition and of joining the world: patient
DEVICE_POLICY = RetryPolicy(max_attempts=6, base_delay=2.0,
                            max_delay=60.0, deadline=900.0)


def retry_call(fn: Callable, *args,
               policy: RetryPolicy = RetryPolicy(),
               what: str = "",
               rng: Optional[random.Random] = None,
               sleep: Callable[[float], None] = time.sleep,
               clock: Callable[[], float] = time.monotonic,
               on_retry: Optional[Callable[[int, BaseException], None]]
               = None,
               budget_kw: Optional[str] = None,
               **kwargs):
    """Call ``fn(*args, **kwargs)`` under ``policy``.

    Transient failures (per ``policy.classifier``) are retried with
    decorrelated-jitter sleeps until attempts or deadline run out;
    non-transient exceptions propagate immediately (a code bug must
    never burn the retry budget). Raises :class:`RetryError` when the
    budget is exhausted.

    Window accounting:

    - no attempt STARTS at or past the deadline;
    - a backoff sleep that alone would exhaust the remaining deadline
      is skipped — the remaining window is spent on one final attempt
      instead of slept away;
    - ``budget_kw``: when set, every attempt receives the policy's
      remaining deadline (seconds, or None without a deadline) as that
      keyword argument, so callables that grant their own sub-slots
      (a child process's timeout) can clip them to the window
      that actually remains.
    """
    rng = rng if rng is not None else random.Random()
    label = what or getattr(fn, "__name__", "call")
    start = clock()
    deadline_at = (start + policy.deadline
                   if policy.deadline is not None else None)
    delay = policy.base_delay
    last: Optional[BaseException] = None
    attempts = 0
    while attempts < policy.max_attempts:
        if (deadline_at is not None and clock() >= deadline_at and
                attempts > 0):
            break
        attempts += 1
        try:
            if budget_kw is not None:
                remaining = (max(0.0, deadline_at - clock())
                             if deadline_at is not None else None)
                return fn(*args, **{budget_kw: remaining}, **kwargs)
            return fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — classifier decides
            if not policy.classifier(e):
                raise
            last = e
            if attempts >= policy.max_attempts:
                break
            if deadline_at is not None and clock() >= deadline_at:
                break
            delay = policy.next_delay(delay, rng)
            if deadline_at is not None and \
                    clock() + delay >= deadline_at:
                # the backoff alone would exhaust the window — spend
                # what remains on a final immediate attempt instead
                delay = 0.0
            if on_retry is not None:
                on_retry(attempts, e)
            log.warning(f"{label}: transient failure (attempt "
                        f"{attempts}/{policy.max_attempts}): {e!r}; "
                        f"retrying in {delay:.2f}s")
            if delay > 0.0:
                sleep(delay)
    raise RetryError(
        f"{label}: gave up after {attempts} attempt(s) over "
        f"{clock() - start:.1f}s: {last!r}", last, attempts)


# ---------------------------------------------------------------------------
# Device probe
# ---------------------------------------------------------------------------

def probe_device() -> int:
    """One device-acquisition attempt: count the CUDA devices and run a
    trivial computation on the first (forces context creation), then
    wait for it. Honors the fault harness's ``probe_timeout`` class so
    CPU tests can exercise the retry path. Returns the device count;
    raises when there is no card (the port never falls back from the
    card: ``tpu_fallback_to_cpu`` is refused)."""
    from . import faults
    faults.maybe_fail("probe_timeout")
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("UNAVAILABLE: torch.cuda.is_available() is "
                           "False")
    if float((torch.zeros(8, device="cuda") + 1).sum()) != 8.0:
        raise RuntimeError("device probe computed a wrong sum")
    return torch.cuda.device_count()
