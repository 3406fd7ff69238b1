"""Latency + failure-path accounting for the serving tier.

Copy of ``lightgbm_tpu/serving/metrics.py`` for the PyTorch/CUDA port.

Percentile math is nearest-rank on the sorted sample (the convention
load-testing tools report: p99 is the smallest observed latency that at
least 99% of requests beat or meet — never an interpolated value that no
request actually experienced). p999 = 99.9th percentile, the tail the
north star cares about under "heavy traffic from millions of users".

:class:`ServingCounters` is the failure-path ledger: every
shed, expired, retried, degraded, failed-publish or shutdown-failed
event increments exactly one counter here, shared between the
micro-batcher and the server so ``stats()`` reports one consistent
account, which a load test can reconcile against the outcomes its
clients observed.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Sequence

PERCENTILES = (50.0, 99.0, 99.9)


def percentile(samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the ceil(q/100 * n)-th smallest sample.

    Exact observed values only (p100 == max, p0+ == min); NaN on an
    empty sample set. ``samples`` need not be sorted."""
    xs = sorted(samples)
    n = len(xs)
    if n == 0:
        return float("nan")
    if q <= 0.0:
        return xs[0]
    rank = int(math.ceil(q / 100.0 * n))
    return xs[min(max(rank, 1), n) - 1]


def latency_summary_ms(samples_sec: Iterable[float],
                       percentiles: Sequence[float] = PERCENTILES
                       ) -> Dict[str, float]:
    """Summary dict of latencies given in SECONDS, reported in ms with
    the p50/p99/p999 keys the bench records and the load generator
    share (p99.9 renders as ``p999_ms``)."""
    xs = sorted(samples_sec)
    out: Dict[str, float] = {"n": len(xs)}
    for q in percentiles:
        key = f"p{q:g}".replace(".", "")      # 50 -> p50, 99.9 -> p999
        out[f"{key}_ms"] = round(percentile(xs, q) * 1e3, 3) if xs \
            else float("nan")
    if xs:
        out["mean_ms"] = round(sum(xs) / len(xs) * 1e3, 3)
        out["max_ms"] = round(xs[-1] * 1e3, 3)
    return out


class ServingCounters:
    """Thread-safe monotonic event counters for the serving failure
    path. One instance is shared by a server and its micro-batcher so
    client-visible failures and internal recoveries land in the same
    ledger:

    - ``expired``: requests dropped at the dispatcher because their
      deadline passed before coalescing (DEADLINE_EXCEEDED).
    - ``shed``: requests refused at ``submit()`` by admission control
      (OVERLOADED — the queue-row bound was full).
    - ``dispatch_retries``: transient device-dispatch failures absorbed
      by the serving RetryPolicy (the batch still served).
    - ``dispatch_failures``: dispatches whose retry budget ran out
      (each one flips the server to the degraded host route).
    - ``degrade_events`` / ``recoveries``: host-route flips and
      background-probe un-degrades.
    - ``degraded_batches``: batches served by the host walk.
    - ``publish_failures``: hot-swaps rolled back (the old generation
      kept serving).
    - ``shutdown_failed``: futures failed with SHUTDOWN because
      ``close(timeout=)`` expired before the drain finished.

    Memory-pressure survival adds:

    - ``oom_bisects``: OOM-classified dispatch failures answered by
      splitting the coalesced batch in half and retrying each half
      (one increment per split event, not per half).
    - ``evictions``: resident bucket packs dropped from the device to
      fit the ``tpu_serving_mem_budget_mb`` ledger (host windows
      retained).
    - ``rebuilds``: evicted packs lazily re-uploaded on next touch
      (bit-exact, one upload, no trace).

    Integrity defense adds the silent-corruption ledger:

    - ``integrity_probes``: background canary parity probes completed
      (one increment per probe CYCLE, not per route replayed).
    - ``integrity_mismatches``: canary replays whose device scores
      differed bit-wise from the host-walk golden, or host packs whose
      CRC fingerprint failed verification — wrong bits DETECTED.
    - ``quarantines``: routes/tenants flipped to the bit-identical
      host walk because of a detected mismatch (per entry event).
    - ``repairs``: quarantined routes restored to the device after a
      successful repair (re-upload or rebuild) re-probed clean parity.

    Unknown names raise (a typo'd counter must fail loudly, not create
    a silent parallel ledger).

    Multi-tenant fleet serving adds a PER-TENANT dimension:
    ``inc(name, tenant=...)`` files the event in the tenant's own
    ledger as well as the global one, and ``inc_tenant`` covers the
    tenant-only volume counters (``requests``/``rows``, which the
    batcher tracks globally outside this class). ``tenant_snapshot()``
    returns the per-tenant ledgers."""

    NAMES = ("expired", "shed", "dispatch_retries", "dispatch_failures",
             "degrade_events", "recoveries", "degraded_batches",
             "publish_failures", "shutdown_failed", "oom_bisects",
             "evictions", "rebuilds", "integrity_probes",
             "integrity_mismatches", "quarantines", "repairs",
             "explain_requests", "explain_degraded")
    # the per-tenant ledger: request/row volume plus every failure-path
    # event that is attributable to ONE tenant (retry/degrade/recovery
    # events are fleet-wide device state, deliberately not per-tenant;
    # integrity mismatch/quarantine/repair ARE per-tenant — the whole
    # point of the canary is blaming exactly one route).
    # Explanation serving adds ``explain_requests`` (contrib
    # requests fulfilled, device or host) and ``explain_degraded``
    # (contrib requests answered by the host predict_contrib oracle).
    TENANT_NAMES = ("requests", "rows", "expired", "shed",
                    "degraded_batches", "dispatch_failures",
                    "publish_failures", "shutdown_failed",
                    "integrity_mismatches", "quarantines", "repairs",
                    "explain_requests", "explain_degraded")

    def __init__(self):
        self._lock = threading.Lock()
        self._c = {n: 0 for n in self.NAMES}
        self._t: Dict[str, Dict[str, int]] = {}

    def _tenant_ledger(self, tenant: str) -> Dict[str, int]:
        led = self._t.get(tenant)
        if led is None:
            led = self._t[tenant] = {n: 0 for n in self.TENANT_NAMES}
        return led

    def inc(self, name: str, n: int = 1, tenant: str = None) -> None:
        with self._lock:
            self._c[name] += n
            if tenant is not None and name in self.TENANT_NAMES:
                self._tenant_ledger(tenant)[name] += n

    def inc_tenant(self, tenant: str, name: str, n: int = 1) -> None:
        """Tenant-only increment for names outside the global ledger
        (``requests``/``rows``); unknown names still raise."""
        if name not in self.TENANT_NAMES:
            raise KeyError(name)
        with self._lock:
            self._tenant_ledger(tenant)[name] += n

    def get(self, name: str) -> int:
        with self._lock:
            return self._c[name]

    def get_tenant(self, tenant: str, name: str) -> int:
        with self._lock:
            return self._t.get(tenant, {}).get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c)

    def drop_tenant(self, tenant: str) -> None:
        """Forget one tenant's ledger (tenant removed from the fleet):
        bounded memory under tenant churn beats retaining dead
        history."""
        with self._lock:
            self._t.pop(tenant, None)

    def tenant_snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {t: dict(led) for t, led in self._t.items()}


class LatencyRecorder:
    """Thread-safe latency sample sink with a bounded memory footprint.

    Keeps up to ``cap`` most-recent samples (a ring); the summary is
    computed over what is retained. Sized so hours of sustained load
    cannot grow host memory unboundedly, while percentile resolution at
    p999 stays meaningful (cap 200k -> 200 samples beyond p999)."""

    def __init__(self, cap: int = 200_000):
        self.cap = int(cap)
        self._lock = threading.Lock()
        self._buf: List[float] = []
        self._next = 0
        self.total = 0            # samples ever recorded

    def record(self, latency_sec: float) -> None:
        with self._lock:
            self.total += 1
            if len(self._buf) < self.cap:
                self._buf.append(latency_sec)
            else:
                self._buf[self._next] = latency_sec
                self._next = (self._next + 1) % self.cap

    def samples(self) -> List[float]:
        with self._lock:
            return list(self._buf)

    def summary_ms(self) -> Dict[str, float]:
        out = latency_summary_ms(self.samples())
        out["n"] = self.total      # report TRUE count, not the ring size
        return out
