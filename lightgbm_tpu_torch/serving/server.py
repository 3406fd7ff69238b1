"""Concurrent model server over the packed-forest engine.

Port of ``lightgbm_tpu/serving/server.py`` (the single-model server).
``ModelServer`` turns a Booster into a serving tier on its device:

- many client threads ``submit()`` requests; the dynamic micro-batcher
  (batcher.py) coalesces them and ONE dispatcher thread drives the
  device, each batch at its own row count;
- on a serving mesh the packed forest is copied to every device and each
  coalesced batch's rows are split over them (mesh.py);
- ``publish()`` is the zero-downtime hot-swap: it freezes an immutable
  ``ForestSnapshot`` (ops/forest.py) of the booster's CURRENT model —
  incremental pack append riding the model-generation counter — and
  atomically swaps it in. In-flight batches keep the old snapshot; a
  response is attributable to exactly ONE generation, never a torn pack.

Failure path — a tier facing real traffic is defined by its failure
behavior:

- **deadlines**: requests carry a deadline (``tpu_serving_deadline_ms``
  default); expired requests are dropped before coalescing and fail
  with ``DEADLINE_EXCEEDED``. ``predict(timeout=)`` rides the same
  machinery, so a timed-out predict's queue slot is reclaimed by the
  dispatcher, never served into the void.
- **admission control**: ``tpu_serving_max_queue_rows`` bounds the
  queue; past it ``submit()`` fails fast with ``OVERLOADED`` carrying
  the queue depth.
- **retry + graceful degradation**: transient dispatch failures
  (classified by the shared RetryPolicy) are retried invisibly; once the
  policy's budget is exhausted the server flips to the HOST-WALK route
  (the per-tree walk ``Booster.predict`` owns, bit-identical to it) with
  a loud one-time warning, counts every batch it serves so
  (``degraded_batches``), and probes the device in the background
  (mesh.probe, which consults ``probe_timeout``) to un-degrade.
  Non-transient errors still fail their batch loudly — a code bug must
  never masquerade as a flaky device.
- **OOM bisection**: an out-of-memory dispatch is split in half and each
  half retried, down to ``forest.ROW_BUCKET_MIN`` rows; rows that still
  fail there are host-walked, and the server is not degraded.
- **publish rollback**: a failed ``publish()`` (injected
  ``publish_fail``, a real OOM) leaves the live snapshot serving the OLD
  generation intact and the version counter untouched.
- **integrity canaries** (``tpu_integrity_probe_interval_s`` > 0): each
  publish records the device scores of a fixed canary batch, anchored
  against the host walk; a background probe replays it and bit-compares,
  and a mismatch quarantines the server to the host walk, re-publishes
  from the host trees and un-quarantines once the replay is clean.

Explanation serving: ``submit(kind="contrib")`` / ``explain()`` coalesce
SHAP-contribution requests in their OWN micro-batcher — a [rows,
(F+1)*K] output must never share a dispatch with [rows, K] scores —
riding the same deadline, admission, retry-then-degrade and
OOM-bisection machinery. The explanation snapshot (ops/shap_pack.py) is
built at the first explain after a publish; the host fallback is the
``predict_contrib`` walk (core/shap.py), taken for a model the device
route does not cover or a degraded server, and counted
(``explain_degraded``).

The reference's serving analogue is an OMP row-parallel pointer walk per
process (src/application/predictor.hpp:31); this is the batch-coalescing
device-dispatch counterpart.
"""
from __future__ import annotations

import os
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import mesh as mesh_mod
from .batcher import MicroBatcher, PendingRequest
from .metrics import ServingCounters
from ..ops import forest, shap_pack
from ..ops.forest import DeviceRouteUnavailable
from ..robustness import faults, integrity
from ..robustness.retry import (RetryError, RetryPolicy, SERVING_POLICY,
                                is_oom_error, retry_call)
from ..utils import log


class Generation(NamedTuple):
    """Identity of one published model state: ``version`` is the
    monotonically increasing publish sequence, ``num_trees`` the window
    size it serves, ``model_gen`` the engine's destructive-mutation
    counter at publish time."""
    version: int
    num_trees: int
    model_gen: int


def host_walk_scores(models, k: int, X: np.ndarray) -> np.ndarray:
    """[R, K] f64 raw scores by the HOST per-tree walk — exactly
    ``Booster.predict``'s accumulation order, so degraded responses are
    bit-identical to the host route."""
    kk = max(int(k), 1)
    raw = np.zeros((X.shape[0], kk), np.float64)
    for i, t in enumerate(models):
        raw[:, i % kk] += t.predict(X)
    return raw


class _FrozenModels(NamedTuple):
    """Just enough engine surface for ``core.shap.predict_contrib`` over
    a FROZEN published model list (the live engine keeps training while
    the snapshot's generation serves)."""
    models: tuple
    num_tree_per_iteration: int
    max_feature_idx: int


def host_contrib_scores(models, k: int, n_features: int,
                        X: np.ndarray) -> np.ndarray:
    """[R, (F+1)*K] f64 SHAP contributions by the HOST TreeSHAP walk
    (``core.shap.predict_contrib``), bit-identical to
    ``Booster.predict(pred_contrib=True)`` on the same frozen trees."""
    from ..core.shap import predict_contrib
    kk = max(int(k), 1)
    eng = _FrozenModels(tuple(models), kk, int(n_features) - 1)
    return predict_contrib(eng, X, 0, len(models) // kk)


def finish_scores(raw: np.ndarray, k: int, n_trees: int,
                  average_output: bool, objective, raw_score: bool):
    """The output tail (average, objective conversion) exactly as
    ``Booster.predict`` has it; [R, K] raw scores in, per-request values
    out (squeezed for k == 1)."""
    n_iters = n_trees // max(int(k), 1)
    if average_output and n_iters > 0:
        raw = raw / n_iters
    if not raw_score and objective is not None:
        if k > 1:
            raw = np.asarray(objective.convert_output(raw))
        else:
            raw = np.array(raw, copy=True)
            raw[:, 0] = np.asarray(objective.convert_output(raw[:, 0]))
    return raw if k > 1 else raw[:, 0]


class DegradeControl:
    """Retry-exhaustion degradation state: a sticky ``degraded`` flag
    flipped on dispatch-budget exhaustion (or a forced drill), plus the
    background recovery loop that runs ``probe`` every
    ``probe_interval_s`` seconds and un-degrades on the first success.
    ``probe`` must raise while the device is unhealthy; it consults the
    injected fault sites so a planned outage keeps the tier degraded
    until the plan disarms."""

    def __init__(self, counters: ServingCounters, probe,
                 probe_interval_s: float, what: str = "serving"):
        self.counters = counters
        self._probe = probe
        self._interval = float(probe_interval_s)
        self._what = what
        self._evt = threading.Event()
        self._lock = threading.Lock()
        self._close_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.reason: Optional[str] = None

    @property
    def degraded(self) -> bool:
        return self._evt.is_set()

    def enter(self, reason: str) -> None:
        with self._lock:
            if self._evt.is_set():
                return
            self.reason = reason
            self._evt.set()
            self.counters.inc("degrade_events")
            log.warning(
                "=" * 60 + f"\n{self._what.upper()} DEGRADED: {reason}\n"
                "flipping to the host-walk route (bit-identical to "
                "Booster.predict, correct but slow); a background probe "
                "will restore device serving when the device answers "
                "again.\n" + "=" * 60)
            if self._interval > 0 and not self._close_evt.is_set():
                self._thread = threading.Thread(
                    target=self._probe_loop, daemon=True,
                    name=f"lgbm-{self._what}-probe")
                self._thread.start()

    def _probe_loop(self) -> None:
        while self._evt.is_set():
            if self._close_evt.wait(self._interval):
                return
            try:
                self._probe()
            except Exception as e:  # noqa: BLE001 — stay degraded
                log.debug(f"{self._what} recovery probe failed: {e!r}")
                continue
            with self._lock:
                self._evt.clear()
                self.reason = None
                self.counters.inc("recoveries")
                log.warning(f"{self._what} RECOVERED: device probe "
                            "succeeded — back on the device route")
            return

    def close(self) -> None:
        self._close_evt.set()
        t = self._thread
        if t is not None:
            t.join(1.0)


def _serving_device(eng) -> torch.device:
    dev = getattr(eng, "device", None)
    if dev is not None:
        return torch.device(dev)
    from ..models.gbdt import resolve_device
    return resolve_device(eng.config)


class ModelServer:
    """Micro-batching, hot-swappable model server on the booster's
    device (cuda unless its params say ``device_type="cpu"``).

    Knobs default from the booster's ``tpu_serving_*`` params
    (config.py) and are overridable per server:

    - ``max_batch``: coalesced-rows cap per dispatch
    - ``linger_ms``: max wait for peers since the oldest queued request
      (the p50-vs-throughput knob)
    - ``num_devices``: serving mesh width (0 = all visible cards; one
      device -> no mesh); ``devices``: the mesh's device list itself
    - ``queue_depth``: enqueue backpressure bound (blocking)
    - ``deadline_ms``: default per-request deadline (0 = none)
    - ``max_queue_rows``: admission-control row bound (0 = unbounded)
    - ``retry_policy``: RetryPolicy for transient dispatch failures
      (default robustness.retry.SERVING_POLICY, LGBM_TPU_RETRY_* env
      overrides honored)
    - ``probe_interval_s``: degraded-mode device-probe cadence
      (0 = sticky degradation)
    - ``raw_score``: serve raw margins (default False: converted
      outputs, exactly ``Booster.predict``'s tail)
    - ``bucket``: accepted and ignored, as ``tpu_predict_buckets`` is:
      every batch is scored at its own row count

    Usage::

        with booster.serve(linger_ms=2.0) as srv:
            fut = srv.submit(X)            # async
            y = fut.result()
            y2 = srv.predict(X2)           # sync sugar
            phi = srv.explain(X3)          # SHAP contributions
            booster.update(); srv.publish()  # hot-swap new trees
    """

    def __init__(self, booster, max_batch: Optional[int] = None,
                 linger_ms: Optional[float] = None,
                 num_devices: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 raw_score: bool = False,
                 bucket: Optional[bool] = None,
                 deadline_ms: Optional[float] = None,
                 max_queue_rows: Optional[int] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 probe_interval_s: Optional[float] = None,
                 devices=None):
        eng = booster._engine
        if eng is None:
            raise ValueError("cannot serve an unconstructed Booster")
        cfg = getattr(booster, "config", None)

        def knob(value, name, fallback):
            if value is not None:
                return value
            if cfg is not None and hasattr(cfg, name):
                return getattr(cfg, name)
            return fallback

        del bucket   # every batch is scored at its own row count
        self._eng = eng
        self.raw_score = bool(raw_score)
        self.k = max(int(eng.num_tree_per_iteration), 1)
        # pack width: the config's num_leaves may be below a tree's (a
        # loaded model, a continuation with larger trees)
        cap = int(getattr(getattr(eng, "config", None), "num_leaves", 0)
                  or 0)
        cap = max([cap, 2] + [int(t.num_leaves) for t in eng.models])
        # feature width served; validated per request at submit() so a
        # malformed request fails ITS submitter, not its batch
        self.n_features = int(getattr(eng, "max_feature_idx", 0)) + 1
        self._raw_route = eng.serving_state()[2] is None
        self.device = _serving_device(eng)
        # the server owns its OWN engine: foreground predict(device=True)
        # calls on the booster never share pack state with the dispatcher
        self._srv = forest.ServingEngine(cap, self.k, self.device)
        self.mesh = mesh_mod.serving_mesh(
            int(knob(num_devices, "tpu_serving_num_devices", 0)),
            self.device, devices)
        self.deadline_ms = float(knob(deadline_ms,
                                      "tpu_serving_deadline_ms", 0.0))
        self._retry_policy = (
            retry_policy if retry_policy is not None else SERVING_POLICY
        ).from_env_overrides(os.environ)
        self._probe_interval = float(knob(
            probe_interval_s, "tpu_serving_probe_interval_s", 5.0))
        self.counters = ServingCounters()
        self._degrade = DegradeControl(
            self.counters, self._recovery_probe, self._probe_interval)
        self._closed = False
        self._oom_floor_warned = False
        self._publish_lock = threading.Lock()
        self._active = None  # (ForestSnapshot, Generation, models) — ONE ref
        self._version = 0
        # silent-corruption canary: armed by
        # tpu_integrity_probe_interval_s > 0. The golden is the
        # publish-time device replay of a fixed canary batch, anchored
        # against the host f64 walk (allclose: the device adds in f32);
        # the background probe bit-compares later replays with it, and a
        # mismatch quarantines the server to the host walk (a solo
        # server has one route, so quarantine is degradation) until a
        # repair re-publish replays clean.
        self._integrity_interval = float(knob(
            None, "tpu_integrity_probe_interval_s", 0.0))
        self._canary_rows = int(knob(None, "tpu_integrity_canary_rows",
                                     16))
        self._canary_X = integrity.canary_batch(self.n_features,
                                                rows=self._canary_rows)
        self._canary = None   # (golden [rows, K], version) — ONE ref
        self._integrity_quarantined = False
        # explanation route state, all set by publish(): the bin mappers
        # frozen WITH the active generation, the explanation snapshot
        # (snapshot, version), and why the device route does not cover
        # the model (None: it does)
        self._route_maps = (None, None)
        self._shap_snap = None
        self._explain_block: Optional[str] = None
        self.publish()
        self._iprobe = None
        if self._integrity_interval > 0:
            self._iprobe = integrity.IntegrityProbe(
                self._integrity_check, self._integrity_interval,
                what="serving")
        self._batcher = MicroBatcher(
            self._dispatch,
            max_batch=int(knob(max_batch, "tpu_serving_max_batch", 4096)),
            linger_ms=float(knob(linger_ms, "tpu_serving_linger_ms", 2.0)),
            queue_depth=int(knob(queue_depth, "tpu_serving_queue_depth",
                                 8192)),
            max_queue_rows=int(knob(max_queue_rows,
                                    "tpu_serving_max_queue_rows",
                                    1_048_576)),
            counters=self.counters)
        # contrib requests coalesce in their OWN batcher, GROUPED so the
        # explain ledger counts exact per-request fulfillment; its
        # smaller max_batch reflects the recursion's [paths, depth, rows]
        # working set
        self.explain_deadline_ms = float(knob(
            None, "tpu_serving_explain_deadline_ms", 0.0))
        self._explain_refuse = str(knob(
            None, "tpu_serving_explain_fallback", "host")) == "refuse"
        self._explain_batcher = MicroBatcher(
            self._dispatch_explain,
            max_batch=int(knob(None, "tpu_serving_explain_max_batch",
                               1024)),
            linger_ms=float(knob(None, "tpu_serving_explain_linger_ms",
                                 2.0)),
            queue_depth=int(knob(queue_depth, "tpu_serving_queue_depth",
                                 8192)),
            max_queue_rows=int(knob(
                None, "tpu_serving_explain_max_queue_rows", 262_144)),
            counters=self.counters, grouped=True)

    def _place_window(self, win):
        return mesh_mod.replicate(win, self.mesh)

    def _place_rows(self):
        if self.mesh is None:
            return None
        return lambda a, axis: mesh_mod.shard_rows(a, axis, self.mesh)

    # ---- hot-swap ----------------------------------------------------
    def publish(self) -> Generation:
        """Freeze the booster's CURRENT model into a new immutable
        snapshot and atomically make it the serving state.

        Rides the incremental pack: same model generation + more trees
        appends only the tail; a destructive mutation (rollback, DART
        drop, set_leaf_output) bumps the generation and triggers a full
        repack. In-flight batches finish on the snapshot they started
        with — zero downtime, never a torn pack.

        Failure contract: a publish that dies — the injected
        ``publish_fail`` site here or inside the pack append, a real OOM,
        a canary that disagrees with the host walk — leaves the live
        snapshot serving the OLD generation and the version counter
        untouched, then re-raises. Generations stay monotonic with no
        gaps for failed attempts."""
        with self._publish_lock:
            models, gen, mappers, used_map = self._eng.serving_state()
            try:
                faults.maybe_fail("publish_fail")
                snap = self._srv.snapshot(
                    models, gen, 0, len(models), mappers, used_map,
                    place_window=self._place_window)
                golden = None
                if self._integrity_interval > 0:
                    # the golden from THIS snapshot, anchored against the
                    # host walk: a replay outside f32-accumulation
                    # tolerance means the pack corrupted at or under the
                    # upload — refuse it, the old clean generation keeps
                    # serving
                    golden = self._canary_replay(snap)
                    anchor = host_walk_scores(models, self.k,
                                              self._canary_X)
                    if not np.allclose(golden, anchor, rtol=1e-5,
                                       atol=1e-6):
                        self.counters.inc("integrity_mismatches")
                        raise integrity.CanaryMismatch(
                            "publish canary replay disagrees with the "
                            "host-walk anchor beyond f32 accumulation "
                            "tolerance — the freshly placed pack is "
                            "corrupt; refusing to publish it")
            except BaseException as e:  # noqa: BLE001 — rollback + re-raise
                self.counters.inc("publish_failures")
                if self._active is not None:
                    log.warning(
                        f"serving publish FAILED ({e!r}); still serving "
                        f"generation {self._active[1].version} — rolled "
                        "back, not torn")
                raise
            # in-residency rot: corrupt the PLACED window AFTER the golden
            # is recorded (bits that flip while the pack sits on the
            # device — what the canary probe exists to catch)
            if faults.check("bitflip", where="dev"):
                snap = snap._replace(win=integrity.corrupt_pack(snap.win))
                log.warning("injected bitflip: published device pack "
                            "corrupted (slot-0 leaf-output sign bits)")
            self._version += 1
            info = Generation(self._version, len(models), gen)
            if golden is not None:
                self._canary = (golden, self._version)  # GIL-atomic
            # the host model list rides along so the degraded host-walk
            # route serves the SAME frozen generation the snapshot does
            self._active = (snap, info, models)  # GIL-atomic ref swap
            self._route_maps = (mappers, used_map)
            prev_shap = self._shap_snap
            self._shap_snap = None
            try:
                shap_pack.check_explainable(models)
                self._explain_block = None
            except DeviceRouteUnavailable as e:
                self._explain_block = str(e)
            else:
                if prev_shap is not None:
                    # explain traffic is live: pay the path-pack append
                    # HERE, so the first explain after the swap does not.
                    # Best effort: a failure defers to the rebuild at the
                    # first explain, never fails a committed publish.
                    try:
                        snap2 = self._srv.snapshot_shap(
                            models, gen, 0, len(models), self.n_features,
                            mappers, used_map,
                            place_window=self._place_window)
                        self._shap_snap = (snap2, self._version)
                    except BaseException as e:  # noqa: BLE001
                        log.warning(
                            "publish-time explanation snapshot rebuild "
                            f"failed ({e!r}); deferring to the rebuild at "
                            "the first explain")
            return info

    @property
    def generation(self) -> Generation:
        return self._active[1]

    # ---- request path ------------------------------------------------
    def _device_scores(self, snap, X: np.ndarray) -> np.ndarray:
        """One device attempt at scoring a batch: [R, K] f64 raw scores.
        Fault sites sit BEFORE the real dispatch (a fired fault means
        the device never saw this attempt); every retry re-consults."""
        faults.maybe_delay("slow_dispatch")
        faults.maybe_fail("dispatch_error")
        faults.maybe_fail("oom")
        out = mesh_mod.locked_launch(
            self.mesh, forest.snapshot_scores, snap, X,
            place=self._place_rows())                        # [K, R]
        return out.T                                         # [R, K]

    def _host_scores(self, models, X: np.ndarray) -> np.ndarray:
        return host_walk_scores(models, self.k, X)

    def _bisect(self, attempt, host, what, snap, models, X):
        """``attempt(snap, X)`` under the serving retry policy, with the
        OOM bisection ladder. Transient failures retry; an
        OOM-classified failure is NOT retried (the same allocation
        cannot succeed): the batch is split in half and each half tried
        again. Rows that still OOM at ``forest.ROW_BUCKET_MIN`` rows are
        answered by ``host`` — a degrade of ONLY the failing rows, never
        of the server. Raises RetryError upward (transient exhaustion
        degrades the server) and any other error untouched."""
        try:
            return retry_call(
                attempt, snap, X, policy=self._retry_policy,
                what=f"{what} dispatch",
                on_retry=lambda _a, _e:
                    self.counters.inc("dispatch_retries"))
        except RetryError:
            raise
        except BaseException as e:  # noqa: BLE001 — classifier decides
            if not is_oom_error(e):
                raise
            n = int(X.shape[0])
            if n > forest.ROW_BUCKET_MIN:
                self.counters.inc("oom_bisects")
                mid = n // 2
                log.warning(
                    f"{what} dispatch OOM at {n} rows ({e!r}); "
                    f"bisecting into {mid}+{n - mid} and retrying")
                return np.concatenate(
                    [self._bisect(attempt, host, what, snap, models,
                                  X[:mid]),
                     self._bisect(attempt, host, what, snap, models,
                                  X[mid:])], axis=0)
            if what == "explain" and self._explain_refuse:
                raise
            if not self._oom_floor_warned:
                self._oom_floor_warned = True
                log.warning(
                    f"{what} dispatch OOM at the {n}-row bisection "
                    f"floor ({e!r}); host-walking ONLY these rows — "
                    "peers in the coalesced batch stay on the device "
                    "(warned once per server)")
            return host(models, X)

    def _adaptive_scores(self, snap, models, X: np.ndarray) -> np.ndarray:
        """Device scoring with the OOM bisection ladder (``_bisect``)."""
        return self._bisect(self._device_scores, self._host_scores,
                            "serving", snap, models, X)

    def _finish(self, raw: np.ndarray, info: Generation):
        vals = finish_scores(
            raw, self.k, info.num_trees,
            bool(getattr(self._eng, "average_output", False)),
            getattr(self._eng, "objective", None), self.raw_score)
        return vals, info

    def _dispatch(self, X: np.ndarray):
        """Score ONE coalesced batch against exactly one snapshot, on the
        dispatcher thread. Transient device failures retry; budget
        exhaustion degrades to the host walk and STILL answers this
        batch; OOM-classified failures bisect it; any other error fails
        the batch (a code bug is never absorbed as a flaky device)."""
        snap, info, models = self._active  # single read: atomic pairing
        if self._degrade.degraded:
            self.counters.inc("degraded_batches")
            return self._finish(self._host_scores(models, X), info)
        try:
            raw = self._adaptive_scores(snap, models, X)
        except RetryError as e:
            self.counters.inc("dispatch_failures")
            self._degrade.enter(
                f"dispatch retry budget exhausted: {e.last!r}")
            self.counters.inc("degraded_batches")
            return self._finish(self._host_scores(models, X), info)
        return self._finish(raw, info)

    # ---- explanation route -------------------------------------------
    def _shap_snapshot(self, info: Generation, models):
        """The explanation snapshot paired with generation ``info`` —
        built at the FIRST explain after a publish under the publish lock
        (the pack sync must not race a publish), then cached until the
        next publish invalidates it."""
        cached = self._shap_snap
        if cached is not None and cached[1] == info.version:
            return cached[0]
        with self._publish_lock:
            cached = self._shap_snap
            if cached is not None and cached[1] == info.version:
                return cached[0]
            mappers, used_map = self._route_maps
            snap = self._srv.snapshot_shap(
                models, info.model_gen, 0, info.num_trees,
                self.n_features, mappers, used_map,
                place_window=self._place_window)
            self._shap_snap = (snap, info.version)  # GIL-atomic
            return snap

    def _device_contrib(self, snap, X: np.ndarray) -> np.ndarray:
        """One device attempt at explaining a batch: [R, (F+1)*K] f64
        contributions, consulting the SAME fault sites as
        ``_device_scores``."""
        faults.maybe_delay("slow_dispatch")
        faults.maybe_fail("dispatch_error")
        faults.maybe_fail("oom")
        return mesh_mod.locked_launch(
            self.mesh, shap_pack.shap_snapshot_scores, snap, X,
            self._place_rows())

    def _host_contrib(self, models, X: np.ndarray) -> np.ndarray:
        return host_contrib_scores(models, self.k, self.n_features, X)

    def _explain_scores(self, info: Generation, models, X: np.ndarray):
        """([R, (F+1)*K] f64 contributions, served_by_host) for one
        coalesced explain batch. The device route unless the model is
        not covered (linear trees, categorical splits), the server is
        degraded or quarantined, or the retry budget exhausts; the
        fallback is the host ``predict_contrib`` walk, or a loud refusal
        with ``tpu_serving_explain_fallback="refuse"``."""
        if self._explain_block is not None:
            if self._explain_refuse:
                raise RuntimeError(
                    "explanation serving unavailable "
                    f"(fallback='refuse'): {self._explain_block}")
            log.info_once(
                "explanation serving: model is not device-explainable "
                f"({self._explain_block}); serving the host "
                "predict_contrib walk instead")
            return self._host_contrib(models, X), True
        if self._degrade.degraded:
            if self._explain_refuse:
                raise RuntimeError(
                    "explanation serving unavailable "
                    f"(fallback='refuse'): server degraded: "
                    f"{self._degrade.reason}")
            return self._host_contrib(models, X), True
        try:
            snap = self._shap_snapshot(info, models)
            return self._bisect(self._device_contrib, self._host_contrib,
                                "explain", snap, models, X), False
        except RetryError as e:
            self.counters.inc("dispatch_failures")
            self._degrade.enter(
                f"explain dispatch retry budget exhausted: {e.last!r}")
            if self._explain_refuse:
                raise RuntimeError(
                    "explanation serving unavailable "
                    f"(fallback='refuse'): {e.last!r}") from e
            return self._host_contrib(models, X), True

    def _dispatch_explain(self, batch):
        """Explain ONE coalesced contrib batch against exactly one
        snapshot (grouped mode: one outcome per request, exact
        ``explain_requests``/``explain_degraded`` accounting)."""
        _snap, info, models = self._active  # single read: atomic pairing
        X = batch[0].X if len(batch) == 1 else \
            np.concatenate([r.X for r in batch], axis=0)
        try:
            contrib, by_host = self._explain_scores(info, models, X)
        except BaseException as e:  # noqa: BLE001 — settle per request
            return [e] * len(batch)
        self.counters.inc("explain_requests", len(batch))
        if by_host:
            self.counters.inc("explain_degraded", len(batch))
        out, off = [], 0
        for r in batch:
            out.append((contrib[off:off + r.n], info))
            off += r.n
        return out

    # ---- integrity ---------------------------------------------------
    def _canary_replay(self, snap) -> np.ndarray:
        """[rows, K] device scores of the fixed canary batch against
        ``snap`` — NO fault-site consults (the canary detects wrong bits;
        availability faults belong to the retry/degrade path, and a probe
        must never burn a fault plan armed for client traffic)."""
        return mesh_mod.locked_launch(
            self.mesh, forest.snapshot_scores, snap, self._canary_X,
            place=self._place_rows()).T

    def _integrity_check(self) -> None:
        """One canary probe cycle: replay against the live snapshot and
        bit-compare with the publish-time golden. A mismatch means the
        resident pack's bits CHANGED since publish — quarantine the
        server to the bit-identical host walk and repair by re-publishing
        from the engine's host trees (which re-records the golden); the
        recovery probe un-quarantines only after the repaired pack
        replays bit-clean."""
        if self._closed or self._degrade.degraded:
            return
        active, canary = self._active, self._canary
        if active is None or canary is None:
            return
        snap, info, _models = active
        golden, version = canary
        if info.version != version:
            return     # raced a publish; next cycle sees the new golden
        self.counters.inc("integrity_probes")
        try:
            got = self._canary_replay(snap)
        except Exception as e:  # noqa: BLE001 — availability, not bits
            log.debug(f"integrity probe replay failed: {e!r}")
            return
        if integrity.parity_equal(got, golden):
            return
        self.counters.inc("integrity_mismatches")
        self.counters.inc("quarantines")
        self._integrity_quarantined = True
        self._degrade.enter(
            f"canary parity mismatch on generation {info.version}: the "
            "resident device pack no longer replays the publish-time "
            "golden bits — silent corruption; serving the host walk "
            "while the pack is re-published")
        try:
            self.publish()       # repair: re-place from host truth
            log.warning("integrity repair: pack re-published after the "
                        "canary mismatch; the recovery probe will "
                        "un-quarantine on clean parity")
        except Exception as e:  # noqa: BLE001 — stay quarantined
            log.warning(f"integrity repair publish failed ({e!r}); "
                        "still quarantined on the host walk")

    # ---- degradation -------------------------------------------------
    def degrade(self, reason: str = "forced") -> None:
        """Flip to the host-walk route now (chaos drills, operator
        override). The background probe un-degrades as usual."""
        self._degrade.enter(reason)

    def _recovery_probe(self) -> None:
        """One recovery attempt: every serving device must answer
        (``mesh.probe``, which consults ``probe_timeout``); the
        ``dispatch_error`` site is consulted too, so an injected
        persistent outage keeps the server degraded until the plan
        disarms. With the integrity canary armed, un-degrading ALSO
        requires the live snapshot to replay the golden bit for bit."""
        faults.maybe_fail("dispatch_error")
        mesh_mod.probe(self.mesh, self.device)
        if self._integrity_interval <= 0:
            return
        active, canary = self._active, self._canary
        if active is None or canary is None or \
                active[1].version != canary[1]:
            return
        if not integrity.parity_equal(self._canary_replay(active[0]),
                                      canary[0]):
            raise integrity.CanaryMismatch(
                "recovery probe: the device canary replay still "
                "differs bit-wise from the golden — staying on the "
                "host walk")
        if self._integrity_quarantined:
            self._integrity_quarantined = False
            self.counters.inc("repairs")

    def submit(self, X, deadline_ms: Optional[float] = None,
               kind: str = "score") -> PendingRequest:
        """Enqueue one [rows, features] request; returns a handle whose
        ``result()`` blocks and whose ``generation`` names the snapshot
        that served it. ``deadline_ms`` (default
        ``tpu_serving_deadline_ms``; 0/None = none) bounds how long the
        request may wait: past it the dispatcher drops it BEFORE
        coalescing and ``result()`` raises ``DeadlineExceeded``. A full
        queue (``max_queue_rows``) raises ``Overloaded`` here.

        ``kind="contrib"`` requests SHAP contributions ([rows, (F+1)*K],
        the reference's ``pred_contrib`` layout) on the explain batcher
        (``tpu_serving_explain_*`` knobs, default deadline
        ``tpu_serving_explain_deadline_ms``).

        Per-request validation happens HERE (shape, and the raw route's
        f32-representability) so one malformed request raises to its own
        submitter instead of failing the batch it would have joined."""
        if kind not in ("score", "contrib"):
            raise ValueError(f"unknown request kind {kind!r} "
                             "(expected 'score' or 'contrib')")
        X = np.ascontiguousarray(np.asarray(X, np.float64))
        if X.ndim != 2 or X.shape[1] != self.n_features:
            raise ValueError(
                f"request must be [rows, {self.n_features}] "
                f"(got {X.shape})")
        if self._raw_route and X.shape[0]:
            with np.errstate(invalid="ignore"):
                f32_ok = (X.astype(np.float32).astype(np.float64) == X) \
                    | np.isnan(X)
            if not f32_ok.all():
                raise ValueError(
                    "raw device serving needs float32-representable "
                    f"requests ({int((~f32_ok).sum())} value(s) are "
                    "f64-only and could cross a split threshold under "
                    "f32 rounding)")
        if kind == "contrib":
            dl = self.explain_deadline_ms if deadline_ms is None \
                else float(deadline_ms)
            return self._explain_batcher.submit(
                X, deadline_sec=(dl / 1e3 if dl and dl > 0 else None),
                kind="contrib")
        dl = self.deadline_ms if deadline_ms is None else float(deadline_ms)
        return self._batcher.submit(
            X, deadline_sec=(dl / 1e3 if dl and dl > 0 else None))

    def predict(self, X, timeout: Optional[float] = None) -> np.ndarray:
        """Sync sugar: submit + result. ``timeout`` rides the deadline
        machinery — the request itself carries the deadline, so a
        timed-out predict cannot leak its queue slot."""
        dl_ms = None if timeout is None else timeout * 1e3
        return self.submit(X, deadline_ms=dl_ms).result(timeout)

    def explain(self, X, timeout: Optional[float] = None) -> np.ndarray:
        """Sync sugar for the explanation route: SHAP contributions
        [rows, (num_features + 1) * K] in the reference ``pred_contrib``
        layout (per-class blocks of F+1, bias last). Contributions plus
        bias sum to the raw score per row."""
        dl_ms = None if timeout is None else timeout * 1e3
        return self.submit(X, deadline_ms=dl_ms,
                           kind="contrib").result(timeout)

    # ---- lifecycle / observability ----------------------------------
    def stats(self) -> dict:
        s = self._batcher.stats()
        s["generation"] = self.generation.version
        s["num_trees"] = self.generation.num_trees
        s["device"] = str(self.device)
        s["mesh_devices"] = len(self.mesh) if self.mesh is not None else 1
        s["linger_ms"] = self._batcher.linger_sec * 1e3
        s["max_batch"] = self._batcher.max_batch
        s["deadline_ms"] = self.deadline_ms
        s["degraded"] = self._degrade.degraded
        if s["degraded"] and self._degrade.reason is not None:
            s["degraded_reason"] = self._degrade.reason
        if self._integrity_interval > 0:
            s["integrity_probe_interval_s"] = self._integrity_interval
            if self._integrity_quarantined:
                s["integrity_quarantined"] = True
        eb = self._explain_batcher
        s["explain"] = {"requests": eb.n_requests, "rows": eb.n_rows,
                        "batches": eb.n_batches,
                        "max_coalesced": eb.max_coalesced,
                        **eb.latency.summary_ms()}
        return s

    @property
    def closed(self) -> bool:
        """True once ``close()`` ran — a closed server never serves
        again; ``Booster.serve()`` uses this to decide whether a prior
        server is still live."""
        return self._closed

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop accepting requests; every already-accepted request is
        still served before the dispatchers exit. Past ``timeout`` the
        drain fails still-pending futures with SHUTDOWN instead of
        abandoning them (batcher.close)."""
        self._closed = True
        if self._iprobe is not None:
            self._iprobe.close()    # before the drain: no probe replay
        self._degrade.close()       # before the drain: no new probe
        self._explain_batcher.close(timeout)
        self._batcher.close(timeout)

    def __enter__(self) -> "ModelServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
