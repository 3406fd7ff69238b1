"""Request queue + dynamic micro-batcher.

Copy of ``lightgbm_tpu/serving/batcher.py`` for the PyTorch/CUDA port.
It coalesces in-flight requests into one dispatch so many small
concurrent clients ride the serving engine's batched traversal instead
of paying a device round-trip each. The port scores every coalesced
batch at its own row count (``ops/forest.py`` pads nothing).

Policy (one knob): a batch dispatches when it reaches ``max_batch`` rows
OR when ``linger_ms`` has elapsed since the OLDEST queued request —
linger trades p50 (each request may wait up to one linger for peers) for
throughput (fuller batches). Under saturation the linger never actually
expires: the queue refills while the previous batch is on device, so
batches are full and latency is queue-bound, the classic dynamic
batching behavior.

Failure path — the three ways a request can fail WITHOUT the dispatch
itself failing, each with a typed error and a counter
(metrics.ServingCounters):

- **deadline** (:class:`DeadlineExceeded`): a request carrying a
  deadline that passes before the dispatcher reaches it is dropped at
  pop time, BEFORE coalescing — an expired request never joins (and so
  never poisons) the batch its peers form.
- **admission control** (:class:`Overloaded`): with ``max_queue_rows``
  set, ``submit()`` fails FAST once that many rows are queued, carrying
  the observed queue depth — loud load-shedding instead of accepting
  work the server cannot serve. The bound sheds BACKLOG only: a single
  request larger than it is still admitted on an idle queue (the
  ``queue_depth`` request bound still provides blocking backpressure
  underneath).
- **shutdown** (:class:`ShutdownError`): ``close(timeout=)`` drains
  everything it can, but when the dispatcher outlives the timeout every
  still-pending future is FAILED rather than abandoned — no client
  blocks forever on a server that already gave up.

Memory-pressure contract: the dispatch callable handed to the batcher
may serve a coalesced batch PIECEWISE — on an OOM-classified failure the
server bisects it and may host-walk the rows that still fail at the
floor. The batcher is agnostic to that: whatever the callable does
internally, it must return row-aligned values for the WHOLE coalesced
batch (ungrouped) or a per-request outcome per item (grouped), so
per-request slicing below stays correct under partial device failure.

Threading model: client threads only enqueue numpy arrays and wait on an
event; ONE dispatcher thread per batcher does the device work (binning,
traversal, the copy back). Response attribution is trivial: a batch is
served by exactly one snapshot.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from .metrics import LatencyRecorder, ServingCounters
from ..utils import log

_SENTINEL = object()


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before a dispatcher served it; the
    message carries ``DEADLINE_EXCEEDED`` so the shared transient
    classifier (robustness/retry.py) files it with the other
    budget-exhaustion symptoms. Dropped requests never joined a batch —
    their rows neither padded nor poisoned anyone else's dispatch."""


class Overloaded(RuntimeError):
    """Admission control shed this request at ``submit()`` time: the
    queued-row bound (``max_queue_rows``) was full. The message carries
    the observed queue depth in rows — the number a load-shedding
    client needs for backoff decisions."""


class ShutdownError(RuntimeError):
    """The server shut down before serving this request (the
    ``close(timeout=)`` drain ran out of time, or the server was
    abandoned). Message carries ``SHUTDOWN``."""


class PendingRequest:
    """Handle for one submitted request: ``result()`` blocks until the
    dispatcher fulfilled (or failed) it. ``generation`` is the publish
    version of the snapshot that served it — the hot-swap audit trail.
    ``deadline`` (absolute ``perf_counter`` seconds, None = none) is
    enforced by the dispatcher at pop time."""

    __slots__ = ("X", "n", "t_enq", "t_done", "deadline", "_event",
                 "_value", "_error", "_settle_lock", "_settled",
                 "generation", "tenant", "kind")

    def __init__(self, X: np.ndarray, deadline_sec: Optional[float] = None,
                 tenant: Optional[str] = None, kind: str = "score"):
        self.X = X
        self.n = X.shape[0]
        # fleet serving: the tenant whose model serves this
        # request; None on a single-model server. Set at construction —
        # BEFORE the request is visible to the dispatcher — so routing
        # and per-tenant accounting never race the enqueue.
        self.tenant = tenant
        # what the request asks for: "score" (raw/transformed
        # scores, [rows, K]) or "contrib" (SHAP contributions,
        # [rows, (F+1)*K]). Explanation requests ride their OWN batcher
        # instance so the two output shapes never coalesce into one
        # dispatch; the kind tag travels with the request for routing
        # and the per-tenant explain ledger.
        self.kind = kind
        self.t_enq = time.perf_counter()
        self.t_done: Optional[float] = None
        self.deadline = (None if deadline_sec is None
                         else self.t_enq + max(float(deadline_sec), 0.0))
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        # settle-once: fulfill/fail race between the dispatcher and a
        # timed-out close() — exactly ONE of them wins, so every request
        # lands in exactly one ledger counter and the client observes
        # exactly the outcome that was counted
        self._settle_lock = threading.Lock()
        self._settled = False
        self.generation = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("serving request not fulfilled in "
                               f"{timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    @property
    def latency_sec(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_enq

    # dispatcher side -------------------------------------------------
    def _fulfill(self, value, generation) -> bool:
        """Atomically settle with a value; returns False (no-op) when
        the request was already settled by a racing path."""
        with self._settle_lock:
            if self._settled:
                return False
            self._settled = True
            self._value = value
            self.generation = generation
            self.t_done = time.perf_counter()
            self._event.set()
            return True

    def _fail(self, error: BaseException) -> bool:
        """Atomically settle with a failure; returns False when already
        settled — the caller must only count the event if True."""
        with self._settle_lock:
            if self._settled:
                return False
            self._settled = True
            self._error = error
            self.t_done = time.perf_counter()
            self._event.set()
            return True


class MicroBatcher:
    """Dynamic micro-batcher over a ``dispatch`` callable.

    ``dispatch(X) -> (values, generation)`` scores one coalesced [R, C]
    batch and names the model snapshot that served it; ``values`` is
    row-aligned with X (first axis R). The batcher slices values back
    per request. Dispatch failures fail every request in that batch —
    never silently dropped.

    ``max_queue_rows`` > 0 arms admission control (fail-fast
    :class:`Overloaded` on submit); requests may carry per-request
    deadlines (dropped with :class:`DeadlineExceeded` before
    coalescing). ``counters`` shares one failure ledger with the owning
    server (a fresh one is created stand-alone).
    """

    def __init__(self, dispatch: Callable, max_batch: int = 4096,
                 linger_ms: float = 2.0, queue_depth: int = 8192,
                 max_queue_rows: int = 0,
                 counters: Optional[ServingCounters] = None,
                 grouped: bool = False):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.dispatch = dispatch
        # grouped mode (fleet serving, and the explain batcher): ``dispatch(batch)``
        # receives the coalesced REQUEST LIST (the callee groups by
        # tenant shape bucket, concatenates per group and slices back)
        # and returns one outcome per request in order — either a
        # ``(values, generation)`` pair or a BaseException. A failure
        # settles only ITS request: one tenant's bad batch never fails
        # rows it merely shared a pop with.
        self.grouped = bool(grouped)
        self.max_batch = int(max_batch)
        self.linger_sec = max(float(linger_ms), 0.0) / 1e3
        self.max_queue_rows = int(max_queue_rows)
        self.counters = counters if counters is not None \
            else ServingCounters()
        self._q: "queue.Queue" = queue.Queue(maxsize=int(queue_depth))
        self._carry: Optional[PendingRequest] = None
        self._closed = False
        # serializes the closed check against close(); held only for
        # that check — NEVER across the (possibly blocking) enqueue, or
        # close() would deadlock behind a submitter stuck on a full
        # queue while the dispatcher is wedged, defeating the very
        # drain contract it exists to enforce
        self._submit_lock = threading.Lock()
        # row/queue accounting (admission control + dispatcher);
        # _tqrows is the per-tenant backlog for fleet admission quotas
        self._rows_lock = threading.Lock()
        self._qrows = 0
        self._tqrows = {}
        # submits past the closed check but not yet enqueued: the
        # dispatcher's closed-and-empty exit ALSO waits for these, so
        # "accepted => will be answered" holds without holding the
        # submit lock across the put
        self._submitting = 0
        self._inflight: List[PendingRequest] = []
        # set by a timed-out close(): the dispatcher stops dispatching
        # and FAILS everything it subsequently pops, closing the race
        # where it wins a queued request from close()'s drain loop
        # after the one-time inflight snapshot was taken
        self._abandoned: Optional[ShutdownError] = None
        self.latency = LatencyRecorder()
        # dispatcher-thread-only counters (read racily by stats(); they
        # only ever grow, so a torn read is at worst one batch stale)
        self.n_requests = 0
        self.n_rows = 0
        self.n_batches = 0
        self.n_errors = 0
        self.max_coalesced = 0
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="lgbm-serving-batcher")
        self._thread.start()

    # client side ------------------------------------------------------
    def submit(self, X: np.ndarray,
               deadline_sec: Optional[float] = None,
               tenant: Optional[str] = None,
               max_tenant_rows: int = 0,
               kind: str = "score") -> PendingRequest:
        """Enqueue one request (blocks on a full queue — backpressure,
        not unbounded buffering). With ``max_queue_rows`` set, fails
        fast with :class:`Overloaded` instead of blocking once that
        many rows are waiting; ``max_tenant_rows`` applies the same
        backlog-only shed rule to THIS tenant's queued rows (the fleet
        per-tenant admission quota — one noisy tenant sheds against its
        own backlog while its neighbors keep submitting). Raises after
        close()."""
        if X.ndim != 2 or X.shape[0] == 0:
            raise ValueError("requests must be non-empty [rows, features] "
                             "matrices")
        req = PendingRequest(X, deadline_sec, tenant=tenant, kind=kind)
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("serving batcher is closed")
            with self._rows_lock:
                depth = self._qrows
                tdepth = self._tqrows.get(tenant, 0) \
                    if tenant is not None else 0
                # shed only on BACKLOG: a request bigger than the bound
                # is still admitted on an empty queue (it would
                # otherwise be unservable at any load level)
                if self.max_queue_rows and depth and \
                        depth + req.n > self.max_queue_rows:
                    self.counters.inc("shed", tenant=tenant)
                    raise Overloaded(
                        f"OVERLOADED: serving queue holds {depth} rows "
                        f"(max_queue_rows={self.max_queue_rows}); request "
                        f"of {req.n} rows shed — retry with backoff")
                if max_tenant_rows and tdepth and \
                        tdepth + req.n > max_tenant_rows:
                    self.counters.inc("shed", tenant=tenant)
                    raise Overloaded(
                        f"OVERLOADED: tenant {tenant!r} holds {tdepth} "
                        f"queued rows (quota {max_tenant_rows}); request "
                        f"of {req.n} rows shed — retry with backoff")
                self._qrows += req.n
                if tenant is not None:
                    self._tqrows[tenant] = tdepth + req.n
                self._submitting += 1
        enqueued = False
        try:
            # blocking put OUTSIDE the lock (backpressure on a full
            # queue must never block close()); _submitting keeps the
            # dispatcher from exiting under us
            self._q.put(req)
            enqueued = True
        finally:
            with self._rows_lock:
                self._submitting -= 1
                if not enqueued:
                    # the put itself died (async exception in the
                    # backpressure wait): the rows never reached the
                    # queue, so roll the accounting back or admission
                    # control sheds against phantom backlog forever
                    self._qrows -= req.n
                    if tenant is not None:
                        self._tqrows[tenant] -= req.n
        return req

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop accepting requests, DRAIN everything already queued
        (every accepted request gets a response), then stop the
        dispatcher thread.

        Drain contract: when the dispatcher outlives
        ``timeout`` — wedged device, stalled dispatch — every future
        still pending is FAILED with :class:`ShutdownError` instead of
        abandoned, so no client blocks forever on a server that already
        gave up."""
        with self._submit_lock:
            self._closed = True
        try:
            self._q.put_nowait(_SENTINEL)   # wake a blocked dispatcher
        except queue.Full:
            pass                            # non-empty queue: already awake
        self._thread.join(timeout)
        if not self._thread.is_alive():
            return
        err = ShutdownError(
            "SHUTDOWN: serving batcher closed before this request was "
            f"served (drain did not finish within {timeout}s)")
        # from here on the dispatcher (if it ever resumes) fails what it
        # pops instead of serving it — no request can slip between the
        # drain below and the inflight snapshot and stay pending forever
        self._abandoned = err
        failed = 0
        # drain until quiescent: freeing queue slots unblocks submitters
        # stuck mid-put, whose requests then land here and get failed
        # too — bounded grace so a wedged dispatcher can't extend this
        grace_end = time.monotonic() + 2.0
        while True:
            try:
                got = self._q.get_nowait()
            except queue.Empty:
                with self._rows_lock:
                    quiescent = self._submitting == 0
                if quiescent or time.monotonic() > grace_end:
                    break
                time.sleep(0.005)
                continue
            if got is _SENTINEL:
                continue
            self._pop_rows(got)
            if got._fail(err):
                self.counters.inc("shutdown_failed", tenant=got.tenant)
                failed += 1
        # the batch the stuck dispatcher holds (carry is dispatcher-owned
        # state; reading it here is racy only against a dispatcher that
        # is demonstrably not making progress). Settle-once arbitrates
        # against a dispatch that completes concurrently: whichever of
        # _fail/_fulfill wins is the outcome the client sees AND the one
        # that gets counted.
        with self._rows_lock:
            pending = list(self._inflight)
        carry = self._carry
        if carry is not None:
            pending.append(carry)
        for r in pending:
            if r._fail(err):
                self.counters.inc("shutdown_failed", tenant=r.tenant)
                failed += 1
        if failed:
            log.warning(f"serving shutdown abandoned by dispatcher: "
                        f"failed {failed} still-pending request(s) with "
                        "SHUTDOWN after the drain timeout")

    # dispatcher side --------------------------------------------------
    def _expire(self, req: PendingRequest) -> bool:
        """Fail ``req`` with DEADLINE_EXCEEDED when its deadline passed
        (consulted at pop time — BEFORE the request can join a batch).
        Returns True when the request was dropped."""
        if req.deadline is None or time.perf_counter() <= req.deadline:
            return False
        waited = (time.perf_counter() - req.t_enq) * 1e3
        if req._fail(DeadlineExceeded(
                f"DEADLINE_EXCEEDED: request expired in queue after "
                f"{waited:.1f} ms (deadline was "
                f"{(req.deadline - req.t_enq) * 1e3:.1f} ms); dropped "
                "before coalescing")):
            self.counters.inc("expired", tenant=req.tenant)
        return True

    def _pop_rows(self, got: PendingRequest) -> None:
        """Release one popped request's rows from the queue accounting
        (global + per-tenant quota). Drained tenants drop out of the
        dict — a churning fleet must not accumulate one zeroed entry
        per historical tenant forever."""
        with self._rows_lock:
            self._qrows -= got.n
            if got.tenant is not None:
                left = self._tqrows.get(got.tenant, 0) - got.n
                if left > 0:
                    self._tqrows[got.tenant] = left
                else:
                    self._tqrows.pop(got.tenant, None)

    def _take(self, got: PendingRequest) -> Optional[PendingRequest]:
        """Account one freshly-popped request and apply its deadline."""
        self._pop_rows(got)
        return None if self._expire(got) else got

    def _gather(self) -> Optional[List[PendingRequest]]:
        """Block for the first live request, then coalesce until
        max_batch rows or the oldest request's linger deadline. Expired
        requests are dropped as they are popped. Returns None when
        closed and fully drained."""
        first = None
        if self._carry is not None:
            c, self._carry = self._carry, None
            # the carry sat out one full dispatch; its deadline may have
            # passed in the meantime (rows were accounted at pop time)
            if not self._expire(c):
                first = c
        while first is None:
            if self._closed and self._q.empty():
                with self._rows_lock:
                    quiescent = self._submitting == 0
                if quiescent:
                    return None
            try:
                got = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if got is not _SENTINEL:
                first = self._take(got)
        batch, rows = [first], first.n
        deadline = first.t_enq + self.linger_sec
        while rows < self.max_batch:
            wait = deadline - time.perf_counter()
            if self._closed or wait <= 0:
                # linger expired (the oldest request already waited out
                # its budget — e.g. queued behind the previous batch
                # under saturation): still DRAIN everything immediately
                # available. Linger only ever waits for requests that
                # have not arrived yet; skipping this drain serves
                # 1-request batches under exactly the load coalescing
                # exists for.
                try:
                    got = self._q.get_nowait()
                except queue.Empty:
                    break
            else:
                try:
                    got = self._q.get(timeout=wait)
                except queue.Empty:
                    break
            if got is _SENTINEL:
                continue
            got = self._take(got)
            if got is None:
                continue
            if rows + got.n > self.max_batch:
                self._carry = got            # honor max_batch strictly
                break
            batch.append(got)
            rows += got.n
        return batch

    def _loop(self) -> None:
        while True:
            batch = self._gather()
            if batch is None:
                return
            abandoned = self._abandoned
            if abandoned is not None:
                # a timed-out close() gave up on the drain: anything we
                # pop from here on gets the SHUTDOWN failure, never a
                # dispatch (see close())
                for r in batch:
                    if r._fail(abandoned):
                        self.counters.inc("shutdown_failed",
                                          tenant=r.tenant)
                continue
            with self._rows_lock:
                self._inflight = batch
            if self.grouped:
                self._run_grouped(batch)
                with self._rows_lock:
                    self._inflight = []
                self.n_batches += 1
                self.max_coalesced = max(self.max_coalesced, len(batch))
                continue
            try:
                X = batch[0].X if len(batch) == 1 else \
                    np.concatenate([r.X for r in batch], axis=0)
                values, generation = self.dispatch(X)
            except BaseException as e:      # noqa: BLE001 — relayed
                for r in batch:
                    if r._fail(e):          # settle-once vs close()
                        self.n_errors += 1
                with self._rows_lock:
                    self._inflight = []
                continue
            # requests a timed-out close() already failed with SHUTDOWN
            # mid-dispatch lose the settle race here: their clients saw
            # the counted failure, so they are neither fulfilled nor
            # double-counted in the served ledger
            off = 0
            served = served_rows = 0
            for r in batch:
                if r._fulfill(values[off:off + r.n], generation):
                    served += 1
                    served_rows += r.n
                    if r.latency_sec is not None:
                        self.latency.record(r.latency_sec)
                off += r.n
            with self._rows_lock:
                self._inflight = []
            self.n_requests += served
            self.n_rows += served_rows
            self.n_batches += 1
            self.max_coalesced = max(self.max_coalesced, len(batch))

    def _run_grouped(self, batch: List[PendingRequest]) -> None:
        """Fleet-mode dispatch of one coalesced batch: the callee
        returns one outcome PER REQUEST (a ``(values, generation)``
        pair or a BaseException), so one tenant's failure settles only
        its own requests — cross-tenant isolation at the batch level.
        A dispatch that raises outright (or returns a malformed result
        list) still fails the whole batch, like the ungrouped path."""
        try:
            results = self.dispatch(batch)
            if len(results) != len(batch):
                raise RuntimeError(
                    f"grouped dispatch returned {len(results)} outcomes "
                    f"for {len(batch)} requests")
        except BaseException as e:          # noqa: BLE001 — relayed
            for r in batch:
                if r._fail(e):
                    self.n_errors += 1
            return
        for r, res in zip(batch, results):
            if isinstance(res, BaseException):
                if r._fail(res):
                    self.n_errors += 1
                continue
            values, generation = res
            if r._fulfill(values, generation):
                self.n_requests += 1
                self.n_rows += r.n
                if r.tenant is not None:
                    self.counters.inc_tenant(r.tenant, "requests")
                    self.counters.inc_tenant(r.tenant, "rows", r.n)
                if r.latency_sec is not None:
                    self.latency.record(r.latency_sec)

    def stats(self) -> dict:
        s = {"requests": self.n_requests, "rows": self.n_rows,
             "batches": self.n_batches, "errors": self.n_errors,
             "max_coalesced": self.max_coalesced,
             "queue_depth": self._q.qsize(),
             "queued_rows": self._qrows,
             "max_queue_rows": self.max_queue_rows}
        if self.n_batches:
            s["mean_requests_per_batch"] = round(
                self.n_requests / self.n_batches, 2)
            s["mean_rows_per_batch"] = round(self.n_rows / self.n_batches,
                                             1)
        s.update(self.counters.snapshot())
        s.update(self.latency.summary_ms())
        tenants = self.counters.tenant_snapshot()
        if tenants:
            s["tenants"] = tenants
        return s
