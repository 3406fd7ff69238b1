"""Multi-tenant fleet serving: ONE server, hundreds of boosters.

Port of ``lightgbm_tpu/serving/fleet.py``. Production inference is never
one model: it is per-country, per-surface or A/B fleets. A
``ModelServer`` per model would mean a dispatcher thread, a pack and no
cross-model batching per model. ``FleetServer`` hosts a model FLEET on
one device arena:

- **tenant -> window routing over capacity-bucketed mega-packs**:
  tenants are grouped into shape buckets keyed by ``ops/forest.TenantShape``
  (kind, k, step bound, pow2 caps of leaves, features and window
  slots). Each bucket holds ONE stacked device forest, in which every
  tenant owns a fixed window of ``win_slots`` tree slots, so padding is
  bounded per bucket by the pow2 rule, never to the fleet's largest
  model.
- **cross-tenant coalescing**: the micro-batcher coalesces requests
  ACROSS tenants; the dispatcher groups a popped batch by shape bucket
  and scores each group in ONE scorer call (``ops/forest._fleet_scores_*``),
  each row walking its own tenant's window, whatever the number of
  tenants in the group.
- **bit-exactness**: a row's window is added slot by slot with the dead
  slots masked out, which is ``predict(device=True)``'s sequence of f32
  adds, so a tenant's fleet response is its own device prediction bit
  for bit. Request rows are binned on the HOST with each tenant's own
  BinMappers (``value_to_bin``), the mapping the device binner is held
  to.
- **per-tenant failure domain**: each tenant has its own deadline
  default, admission quota (``tpu_serving_fleet_quota_rows``), counters
  (``ServingCounters.tenant_snapshot``) and ATOMIC ``publish()``: a
  hot-swap builds a whole new immutable fleet state and swaps one
  reference, and a failed publish (``publish_fail``, a real OOM) leaves
  every tenant serving what it served before.
- **two placements**: small fleets REPLICATE every mega-pack over the
  serving mesh and split each batch's rows; big fleets shard the MODEL
  axis, each bucket's pack on one owner device of the mesh, its batches
  scored there (``tpu_serving_fleet_shard``; auto = by the total pack
  bytes against ``tpu_serving_fleet_pack_budget_mb``).
- **memory budget and cold-tenant eviction**: a byte ledger of RESIDENT
  packs against ``tpu_serving_mem_budget_mb``; over it, cold buckets are
  LRU-evicted (device pack dropped, host mega-pack kept) and rebuilt on
  the next touch by one upload, bit-exact, generations kept. A publish
  whose upload OOMs force-evicts the coldest pack instead of failing;
  an OOM at dispatch bisects the request group down to a per-request
  host walk, never degrading the whole fleet.
- **explanation serving**: ``submit(kind="contrib")`` /
  ``TenantHandle.explain()`` ride their OWN grouped micro-batcher over a
  per-bucket pack of each tenant's flattened SHAP paths
  (``ops/shap_pack.py``), evictable under the same budget (before the
  score packs) and dropped at a member's publish. Each request is
  explained at its own row count over its own tenant's paths, which is
  what makes the answer its ``predict(pred_contrib=True, device=True)``
  array for array. Quarantined, device-ineligible (linear, categorical)
  or degraded tenants answer by the host ``predict_contrib`` walk,
  counted per tenant (``explain_requests`` / ``explain_degraded``).
- **integrity canaries** (``tpu_integrity_probe_interval_s`` > 0): each
  publish records a tenant's device replay of a fixed canary batch,
  anchored against the host walk; a rebuilt pack is verified before it
  is installed, and a background probe replays the canaries. Device
  rot quarantines ONLY the afflicted tenants to the host walk until the
  pack is repaired from its CRC-checked host copy; host rot (the host
  copy's CRC no longer matches) rebuilds from the tenants' windows.

Entry points: ``lightgbm_tpu_torch.serve_fleet({name: booster, ...})`` and
``Booster.serve(fleet=server, tenant=name)``. The fleet serves on the
device its config names (``device_type``; cuda by default) or the
``devices`` mesh it is given; with ``device_type="cpu"`` it runs on the
CPU, and ``devices=["cpu", "cpu"]`` builds a two-entry mesh there.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import mesh as mesh_mod
from .batcher import MicroBatcher, PendingRequest
from .metrics import ServingCounters
from .server import (DegradeControl, Generation, finish_scores,
                     host_contrib_scores, host_walk_scores)
from ..ops import forest, shap_pack
from ..ops.forest import DeviceRouteUnavailable, TenantShape
from ..robustness import faults, integrity
from ..robustness.retry import (RetryError, RetryPolicy, SERVING_POLICY,
                                is_corruption_error, is_oom_error,
                                retry_call)
from ..utils import log


class TenantRoute(NamedTuple):
    """Immutable routing entry of one tenant inside one fleet state:
    where its window lives (``key``/``lo``) and everything a dispatch
    needs to serve or host-walk its rows without touching the mutable
    tenant registry."""
    name: str
    key: TenantShape
    lo: int                   # first tree slot of the window in the pack
    n_trees: int              # live trees inside the window
    k: int                    # output channels (trees per iteration)
    mappers: Optional[tuple]  # binned route: the tenant's BinMappers
    used: Optional[np.ndarray]  # binned route: original column per mapper
    n_features: int           # request width (original columns)
    models: tuple             # host trees: the degraded walk's route
    objective: object
    average_output: bool
    raw_score: bool
    generation: Generation


class _Bucket(NamedTuple):
    """One shape bucket's device state: the stacked mega-pack, capacity
    bookkeeping and the model-shard owner (an index into the mesh; None
    when replicated). ``dev is None`` marks an EVICTED bucket: ``host``,
    the exact numpy mega-pack the routes were built against, is kept, so
    the rebuild is one upload, bit-exact, generations kept. ``host_crc``
    is the pack-time CRC32 of ``host``, checked before every re-upload:
    a mismatch is HOST-side rot (rebuild from the tenants' windows), as
    opposed to DEVICE-side rot (the CRC-clean host pack repairs it)."""
    key: TenantShape
    dev: object               # device pack (or Replicas), None: evicted
    members: Tuple[str, ...]  # tenant names, slot order
    slot_cap: int
    nbytes: int
    owner: Optional[int]      # model-shard owner (mesh index) or None
    host: object              # numpy pack: the rebuild source
    host_crc: int             # pack-time CRC32 of ``host``


class _ShapBucket(NamedTuple):
    """One shape bucket's explain pack: per member its flattened SHAP
    paths (``shap_pack.TenantShapPaths``, None for a member the device
    recursion cannot explain). DERIVED state, cached outside the
    immutable fleet state and keyed by the member generations it was
    packed for (``token``): a member's publish invalidates it and the
    next explain rebuilds it, so score-only traffic never pays for path
    packing. ``dev is None`` with a ``host`` marks an eviction (the
    CRC-fingerprinted host pack is re-uploaded); ``blocked`` maps the
    members the host ``predict_contrib`` walk answers to the reason."""
    key: TenantShape
    token: tuple              # ((member, generation.version), ...)
    dev: object               # tuple of device TenantShapPaths, or None
    host: object              # tuple of host TenantShapPaths, or None
    host_crc: int
    nbytes: int
    blocked: dict             # member -> why the device cannot explain it
    index: dict               # member -> position in the tuples
    owner: Optional[int]      # model-shard owner or None


class _FleetState(NamedTuple):
    """The whole fleet's immutable serving state. ``FleetServer``
    publishes by building a NEW state and swapping one reference, so
    in-flight dispatches finish on the state they started with and one
    tenant's hot-swap can neither tear nor stall another's responses."""
    buckets: Dict[TenantShape, _Bucket]
    routes: Dict[str, TenantRoute]
    shard: str                # resolved "replicate" | "model"


class _CanaryReq(NamedTuple):
    """A minimal ``PendingRequest`` for canary replays through
    ``_group_scores``: integrity probes never enter the batcher."""
    n: int
    X: np.ndarray
    tenant: str


class _Tenant:
    """Mutable registry entry of one tenant (guarded by the publish
    lock): the engine, the knobs, the publish version and the cached
    packed window."""

    def __init__(self, name, booster, engine, deadline_ms, quota_rows,
                 raw_score):
        self.name = name
        self.booster = booster
        self.engine = engine
        self.k = max(int(engine.num_tree_per_iteration), 1)
        self.n_features = int(getattr(engine, "max_feature_idx", 0)) + 1
        self.deadline_ms = float(deadline_ms)
        self.quota_rows = int(quota_rows)
        self.raw_score = bool(raw_score)
        self.raw_route = engine.serving_state()[2] is None
        self.version = 0
        # window cache: (model_gen, n_trees, shape) -> host pack
        self._win_token = None
        self._win = None


class TenantHandle:
    """Per-tenant facade over a :class:`FleetServer`, what
    ``Booster.serve(fleet=...)`` and ``FleetServer.add_tenant`` return:
    ``submit``/``predict``/``explain``/``publish``/``stats`` act on this
    tenant; ``close()`` removes it from the fleet (the others keep
    serving)."""

    def __init__(self, fleet: "FleetServer", name: str):
        self.fleet = fleet
        self.name = name

    def submit(self, X, deadline_ms: Optional[float] = None,
               kind: str = "score") -> PendingRequest:
        return self.fleet.submit(self.name, X, deadline_ms=deadline_ms,
                                 kind=kind)

    def predict(self, X, timeout: Optional[float] = None) -> np.ndarray:
        return self.fleet.predict(self.name, X, timeout=timeout)

    def explain(self, X, timeout: Optional[float] = None) -> np.ndarray:
        """SHAP contributions [rows, (F+1)*k] for this tenant, in the
        reference ``pred_contrib`` layout."""
        return self.fleet.explain(self.name, X, timeout=timeout)

    def publish(self) -> Generation:
        return self.fleet.publish(self.name)

    @property
    def generation(self) -> Generation:
        return self.fleet._state.routes[self.name].generation

    def stats(self) -> dict:
        return self.fleet.tenant_stats(self.name)

    def close(self) -> None:
        self.fleet.remove_tenant(self.name)

    def __enter__(self) -> "TenantHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _fleet_device(device, config) -> torch.device:
    if device is not None:
        return torch.device(device)
    if config is not None and hasattr(config, "device_type"):
        from ..models.gbdt import resolve_device
        return resolve_device(config)
    return torch.device("cuda")


class FleetServer:
    """Micro-batching, capacity-bucketed, hot-swappable MULTI-TENANT
    model server: one dispatcher thread (and one for explanations) and
    one device arena for the whole fleet.

    Fleet knobs mirror ``ModelServer``'s (``max_batch``, ``linger_ms``,
    ``num_devices``, ``devices``, ``queue_depth``, ``deadline_ms``,
    ``max_queue_rows``, ``retry_policy``, ``probe_interval_s``) and
    default from ``config`` (any Booster Config) when given; ``bucket`` is
    accepted and ignored, as ``tpu_predict_buckets`` is (every batch is
    scored at its own row count). ``fleet_shard`` / ``pack_budget_mb``
    select the placement (``tpu_serving_fleet_shard`` /
    ``tpu_serving_fleet_pack_budget_mb``); ``mem_budget_mb``
    (``tpu_serving_mem_budget_mb``, 0 = unbounded) bounds the RESIDENT
    pack bytes. Per-tenant knobs (``deadline_ms``, ``quota_rows``,
    ``raw_score``) ride ``add_tenant``.

    Usage::

        fleet = lgt.serve_fleet({"us": bst_us, "eu": bst_eu})
        y = fleet.predict("us", X)
        with bst_jp.serve(fleet=fleet, tenant="jp") as jp:
            jp.predict(Xjp)
            bst_jp.update(); jp.publish()      # hot-swap ONE tenant
    """

    def __init__(self, max_batch: Optional[int] = None,
                 linger_ms: Optional[float] = None,
                 num_devices: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 max_queue_rows: Optional[int] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 probe_interval_s: Optional[float] = None,
                 bucket: Optional[bool] = None,
                 fleet_shard: Optional[str] = None,
                 pack_budget_mb: Optional[float] = None,
                 mem_budget_mb: Optional[float] = None,
                 config=None, device=None, devices=None):
        def knob(value, name, fallback):
            if value is not None:
                return value
            if config is not None and hasattr(config, name):
                return getattr(config, name)
            return fallback

        del bucket   # every batch is scored at its own row count
        self.device = _fleet_device(device, config)
        self.mesh = mesh_mod.serving_mesh(
            int(knob(num_devices, "tpu_serving_num_devices", 0)),
            self.device, devices)
        if self.mesh is not None:
            self.device = self.mesh[0]
        self.deadline_ms = float(knob(deadline_ms,
                                      "tpu_serving_deadline_ms", 0.0))
        self._default_quota = int(knob(None, "tpu_serving_fleet_quota_rows",
                                       0))
        shard = str(knob(fleet_shard, "tpu_serving_fleet_shard",
                         "auto")).lower()
        if shard not in ("auto", "replicate", "model"):
            raise ValueError(f"fleet_shard must be auto|replicate|model "
                             f"(got {shard!r})")
        self._shard_mode = shard
        self._pack_budget = float(knob(
            pack_budget_mb, "tpu_serving_fleet_pack_budget_mb", 256.0)) * 1e6
        # the budget of RESIDENT packs: 0 = unbounded. Over it, cold
        # buckets are LRU-evicted (device pack dropped, host pack kept)
        # and rebuilt at their next touch
        self._mem_budget = float(knob(
            mem_budget_mb, "tpu_serving_mem_budget_mb", 0.0)) * 1e6
        # last-touch sequence per bucket: written by the dispatcher
        # threads only (GIL-atomic dict stores), read under the publish
        # lock by the eviction pass: an approximate LRU signal
        self._touch: Dict[TenantShape, int] = {}
        self._touch_seq = 0
        self._retry_policy = (
            retry_policy if retry_policy is not None else SERVING_POLICY
        ).from_env_overrides(os.environ)
        self.counters = ServingCounters()
        self._degrade = DegradeControl(
            self.counters, self._recovery_probe,
            float(knob(probe_interval_s, "tpu_serving_probe_interval_s",
                       5.0)),
            what="fleet serving")
        self._publish_lock = threading.Lock()
        self._tenants: Dict[str, _Tenant] = {}
        self._state = _FleetState({}, {}, "replicate")
        self._closed = False
        self._oom_floor_warned = False
        self._batcher = MicroBatcher(
            self._dispatch_many, grouped=True,
            max_batch=int(knob(max_batch, "tpu_serving_max_batch", 4096)),
            linger_ms=float(knob(linger_ms, "tpu_serving_linger_ms", 2.0)),
            queue_depth=int(knob(queue_depth, "tpu_serving_queue_depth",
                                 8192)),
            max_queue_rows=int(knob(max_queue_rows,
                                    "tpu_serving_max_queue_rows",
                                    1_048_576)),
            counters=self.counters)
        # explanation serving: contrib requests ride their OWN grouped
        # batcher, so [rows, (F+1)*k] outputs never share a dispatch
        # with scores
        self.explain_deadline_ms = float(knob(
            None, "tpu_serving_explain_deadline_ms", 0.0))
        self._explain_refuse = str(knob(
            None, "tpu_serving_explain_fallback", "host")) == "refuse"
        # explain packs: derived state keyed by bucket shape and checked
        # against the member generations (entries are immutable; the
        # dict changes only under the publish lock). _shap_touch is the
        # explain LRU signal; _explain_block caches each tenant's device
        # eligibility per generation (dispatcher thread only).
        self._shap_cache: Dict[TenantShape, _ShapBucket] = {}
        self._shap_touch: Dict[TenantShape, int] = {}
        self._explain_block: Dict[str, tuple] = {}
        self._explain_batcher = MicroBatcher(
            self._dispatch_explain_many, grouped=True,
            max_batch=int(knob(None, "tpu_serving_explain_max_batch",
                               1024)),
            linger_ms=float(knob(None, "tpu_serving_explain_linger_ms",
                                 2.0)),
            queue_depth=int(knob(queue_depth, "tpu_serving_queue_depth",
                                 8192)),
            max_queue_rows=int(knob(
                None, "tpu_serving_explain_max_queue_rows", 262_144)),
            counters=self.counters)
        # silent-corruption canaries: 0 = disarmed (no probe thread, no
        # canary replay at publish). Goldens are DEVICE replays of a
        # fixed canary batch per (tenant, generation), anchored at
        # publish against the host walk; the probe bit-compares fresh
        # replays with them and quarantines ONLY the afflicted tenants
        self._integrity_interval = float(knob(
            None, "tpu_integrity_probe_interval_s", 0.0))
        self._canary_rows = int(knob(None, "tpu_integrity_canary_rows",
                                     16))
        self._goldens: Dict[str, tuple] = {}  # name->(version, X, golden)
        self._quarantined: frozenset = frozenset()  # GIL-atomic swaps
        self._qlock = threading.Lock()
        self._iprobe = None
        if self._integrity_interval > 0:
            self._iprobe = integrity.IntegrityProbe(
                self._integrity_check, self._integrity_interval,
                what="fleet serving")

    # ---- tenant lifecycle -------------------------------------------
    def add_tenant(self, name: str, booster,
                   deadline_ms: Optional[float] = None,
                   quota_rows: Optional[int] = None,
                   raw_score: bool = False) -> TenantHandle:
        """Register one booster as tenant ``name`` and publish its
        current model. A duplicate name is refused (a silent replace
        would re-route live traffic); the per-tenant knobs default from
        the booster's own explicitly set ``tpu_serving_*`` params, then
        the fleet's."""
        eng = getattr(booster, "_engine", booster)
        if eng is None:
            raise ValueError("cannot serve an unconstructed Booster")
        cfg = getattr(booster, "config", None)

        def knob(value, cname, fallback):
            # kwarg > the booster's EXPLICITLY set param > the fleet's:
            # Config answers every registered param with its default, so
            # a bare hasattr would shadow every fleet-level knob
            if value is not None:
                return value
            if cfg is not None and hasattr(cfg, cname) and \
                    not cfg.is_default(cname):
                return getattr(cfg, cname)
            return fallback

        with self._publish_lock:
            if self._closed:
                raise RuntimeError("fleet server is closed")
            if name in self._tenants:
                raise ValueError(
                    f"tenant {name!r} is already served by this fleet — "
                    "publish() updates it; pick a new name for a new "
                    "model")
            t = _Tenant(
                name, booster, eng,
                deadline_ms=float(knob(deadline_ms,
                                       "tpu_serving_deadline_ms",
                                       self.deadline_ms)),
                quota_rows=int(knob(quota_rows,
                                    "tpu_serving_fleet_quota_rows",
                                    self._default_quota)),
                raw_score=raw_score)
            self._tenants[name] = t
            try:
                self._publish_locked(t)
            except BaseException:
                del self._tenants[name]     # rollback: never half-added
                raise
        return TenantHandle(self, name)

    def remove_tenant(self, name: str) -> None:
        """Drop one tenant: its window leaves the routing table and its
        bucket is rebuilt without it; its queued requests fail at
        dispatch. The other tenants are untouched."""
        with self._publish_lock:
            t = self._tenants.pop(name, None)
            if t is None:
                return
            self.counters.drop_tenant(name)
            self._goldens.pop(name, None)
            self._explain_block.pop(name, None)
            with self._qlock:
                if name in self._quarantined:
                    self._quarantined = self._quarantined - {name}
            routes = dict(self._state.routes)
            routes.pop(name, None)
            buckets = dict(self._state.buckets)
            for key, b in list(buckets.items()):
                if name in b.members:
                    members = tuple(m for m in b.members if m != name)
                    if members:
                        buckets[key] = self._build_bucket(
                            key, members, self._state.shard, routes,
                            owner=b.owner)
                    else:
                        del buckets[key]
            self._swap_state(buckets, routes)

    # ---- publish -----------------------------------------------------
    def publish(self, name: str) -> Generation:
        """Atomically hot-swap tenant ``name`` to its booster's CURRENT
        model. Builds a new immutable fleet state (only the tenant's
        bucket is re-assembled; the others are reused by reference) and
        swaps one reference: in-flight batches finish on the old state,
        and a publish that dies anywhere (``publish_fail``, a packing
        error, a real OOM) leaves every tenant serving what it served
        before."""
        with self._publish_lock:
            t = self._tenants.get(name)
            if t is None:
                raise KeyError(f"unknown tenant {name!r}")
            return self._publish_locked(t)

    def _publish_locked(self, t: _Tenant) -> Generation:
        prev = self._state
        try:
            models, gen, mappers, used_map = t.engine.serving_state()
            if not models:
                raise ValueError(f"tenant {t.name!r} has no trees to "
                                 "serve")
            faults.maybe_fail("publish_fail")
            kind = "binned" if mappers is not None else "raw"
            t.raw_route = kind == "raw"
            n_axis = len(mappers) if kind == "binned" else t.n_features
            shape = forest.tenant_shape(models, t.k, n_axis, kind)
            token = (gen, len(models), shape)
            if t._win_token != token:
                if kind == "binned":
                    win = forest.pack_window_binned(models, mappers, shape)
                else:
                    win = forest.pack_window_raw(models, shape)
                t._win_token, t._win = token, win
            info = Generation(t.version + 1, len(models), gen)
            route = TenantRoute(
                name=t.name, key=shape, lo=0, n_trees=len(models), k=t.k,
                mappers=tuple(mappers) if mappers is not None else None,
                used=(np.asarray(used_map, np.int64)
                      if used_map is not None else None),
                n_features=t.n_features, models=tuple(models),
                objective=getattr(t.engine, "objective", None),
                average_output=bool(getattr(t.engine, "average_output",
                                            False)),
                raw_score=t.raw_score, generation=info)
            routes = dict(self._state.routes)
            old = routes.get(t.name)
            routes[t.name] = route
            buckets = dict(self._state.buckets)
            # rebuild the new bucket, and the old one when the tenant
            # moved (it outgrew its window, leaf or feature caps)
            affected = {shape}
            if old is not None and old.key != shape:
                affected.add(old.key)
            for key in affected:
                members = tuple(sorted(
                    n for n, r in routes.items() if r.key == key))
                if not members:
                    buckets.pop(key, None)
                    continue
                try:
                    buckets[key] = self._build_bucket(
                        key, members, self._state.shard, routes)
                except BaseException as e:  # noqa: BLE001 — classify
                    # an upload that OOMs evicts the coldest resident
                    # pack and retries once: a new generation displaces
                    # cold tenants instead of failing
                    if not is_oom_error(e) or not self._evict_coldest(
                            buckets, exclude={key}):
                        raise
                    log.warning(
                        f"fleet publish upload OOM for tenant "
                        f"{t.name!r} ({e!r}); retrying after evicting "
                        "the coldest resident pack")
                    buckets[key] = self._build_bucket(
                        key, members, self._state.shard, routes)
            self._swap_state(buckets, routes, keep=affected)
            if self._integrity_interval > 0:
                try:
                    self._record_golden(t.name)
                except BaseException:
                    # never serve a generation whose canary could not be
                    # anchored: fleet states are immutable, so putting
                    # the previous one back is atomic
                    self._state = prev
                    raise
        except BaseException as e:  # noqa: BLE001 — rollback + re-raise
            self.counters.inc("publish_failures", tenant=t.name)
            served = self._state.routes.get(t.name)
            if served is not None:
                log.warning(
                    f"fleet publish FAILED for tenant {t.name!r} "
                    f"({e!r}); still serving generation "
                    f"{served.generation.version} — rolled back, not "
                    "torn, other tenants unaffected")
            raise
        t.version = info.version
        return info

    def _owner_device(self, owner: Optional[int]) -> torch.device:
        return self.device if owner is None else self.mesh[owner]

    def _place(self, dev, owner: Optional[int]):
        """A pack uploaded to ``_owner_device(owner)``, placed: kept on
        its owner (model shard) or copied to every mesh device."""
        if owner is not None:
            return mesh_mod.place_on(dev, self.mesh[owner])
        return mesh_mod.replicate(dev, self.mesh)

    def _build_bucket(self, key: TenantShape, members: Tuple[str, ...],
                      shard: str, routes: Dict[str, TenantRoute],
                      owner=None) -> _Bucket:
        """Assemble one bucket's mega-pack on the HOST (the members'
        cached windows concatenated, zero-padded to the pow2 slot
        capacity) and upload it once; rewrite the members' routes with
        their slot offsets."""
        wins = [self._tenants[m]._win for m in members]
        if key.kind == "binned":
            cat_w = max(forest.window_cat_width(w) for w in wins)
            wins = [forest.widen_window(w, cat_w) for w in wins]
        slot_cap = forest.pow2_cap(len(members), 1)
        if slot_cap > len(members):
            zero = type(wins[0])(*[np.zeros_like(a) for a in wins[0]])
            wins = wins + [zero] * (slot_cap - len(members))
        host = type(wins[0])(*[np.concatenate(xs) for xs in zip(*wins)])
        host_crc = integrity.crc32_fingerprint(host)
        if faults.check("bitflip", where="host"):
            # host-side silent corruption: rot the kept mega-pack AFTER
            # its CRC was recorded; the re-upload path must catch it by
            # CRC and refuse these bytes as a rebuild source
            host = integrity.corrupt_pack(host)
            log.warning("fault injection: bit-flipped the assembled "
                        "host mega-pack after its CRC fingerprint was "
                        "recorded (host-side silent corruption)")
        nbytes = forest.pytree_nbytes(host)
        if shard == "model":
            if owner is None:
                owner = self._owner_for(key, nbytes)
        else:
            owner = None
        dev = self._place(forest.upload_window(host,
                                               self._owner_device(owner)),
                          owner)
        for slot, m in enumerate(members):
            routes[m] = routes[m]._replace(lo=slot * key.win_slots)
        return _Bucket(key, dev, members, slot_cap, nbytes, owner, host,
                       host_crc)

    def _owner_for(self, key: TenantShape, nbytes: int) -> int:
        """Model-shard owner of one bucket: its current owner when it has
        one (stable under rebuilds), else the least-loaded mesh device."""
        cur = self._state.buckets.get(key)
        if cur is not None and cur.owner is not None:
            return cur.owner
        load = [0] * len(self.mesh)
        for b in self._state.buckets.values():
            if b.owner is not None:
                load[b.owner] += b.nbytes
        return min(range(len(load)), key=lambda i: (load[i], i))

    def _swap_state(self, buckets, routes, keep=()) -> None:
        """Resolve the placement for the new total pack size, re-place
        buckets whose placement changed, hold the memory budget (``keep``
        names the buckets this very publish built, which stay resident)
        and publish the new fleet state atomically."""
        total = sum(b.nbytes for b in buckets.values())
        shard = self._resolve_shard(total)
        if shard != self._state.shard and buckets:
            log.info_once(
                f"fleet placement -> {shard} (total pack {total / 1e6:.1f}"
                f" MB vs {self._pack_budget / 1e6:.0f} MB per-device "
                "budget)")
            # a flip re-places EVERY bucket: all owners in one balanced
            # pass (the incremental _owner_for reads the pre-flip state,
            # where no bucket has an owner, and would pile the fleet
            # onto device 0)
            owners = {}
            if shard == "model":
                owners = mesh_mod.assign_owners(
                    [(key, b.nbytes) for key, b in buckets.items()],
                    self.mesh)
            buckets = {key: self._build_bucket(key, b.members, shard,
                                               routes,
                                               owner=owners.get(key))
                       for key, b in buckets.items()}
        buckets = self._enforce_budget(buckets, keep=keep)
        self._state = _FleetState(buckets, routes, shard)  # GIL-atomic
        # explain packs are DERIVED state: drop the entries whose bucket
        # went or whose member generations moved on (an in-flight
        # explain keeps its own reference); the next explain rebuilds
        for k in list(self._shap_cache):
            b = buckets.get(k)
            token = None if b is None else tuple(
                (m, routes[m].generation.version) for m in b.members)
            if self._shap_cache[k].token != token:
                del self._shap_cache[k]
                self._shap_touch.pop(k, None)

    def _resident_bytes(self, buckets) -> int:
        return (sum(b.nbytes for b in buckets.values() if b.dev is not None)
                + sum(sb.nbytes for sb in self._shap_cache.values()
                      if sb.dev is not None))

    def _enforce_budget(self, buckets, keep=(), incoming: int = 0):
        """LRU-evict cold resident packs until the resident bytes (plus
        ``incoming``, about to be uploaded) fit the memory budget (0 =
        unbounded). Changes and returns ``buckets``. An eviction drops
        ONLY the device reference: the host pack stays for the rebuild,
        and in-flight dispatches keep the old state's reference. Caller
        holds the publish lock."""
        if self._mem_budget <= 0:
            return buckets
        resident = self._resident_bytes(buckets)
        if resident + incoming <= self._mem_budget:
            return buckets
        # explain packs go FIRST: the score dispatch is the
        # latency-critical class
        resident -= self._evict_shap(
            resident + incoming - self._mem_budget)
        order = sorted(
            (k for k, b in buckets.items()
             if b.dev is not None and k not in keep),
            key=lambda k: self._touch.get(k, -1))
        for k in order:
            if resident + incoming <= self._mem_budget:
                break
            b = buckets[k]
            resident -= b.nbytes
            buckets[k] = b._replace(dev=None)
            self.counters.inc("evictions")
            log.info(f"fleet pack evicted (LRU, {b.nbytes / 1e6:.2f} MB,"
                     f" members {b.members}): resident bytes over the "
                     f"{self._mem_budget / 1e6:.1f} MB budget")
        return buckets

    def _evict_shap(self, over: int, keep=()) -> int:
        """Evict cold explain packs (LRU by explain touch) until at least
        ``over`` bytes are freed or none is resident; returns the bytes
        freed. Caller holds the publish lock."""
        freed = 0
        for k in sorted((k for k, sb in self._shap_cache.items()
                         if sb.dev is not None and k not in keep),
                        key=lambda k: self._shap_touch.get(k, -1)):
            if freed >= over:
                break
            sb = self._shap_cache[k]
            self._shap_cache[k] = sb._replace(dev=None)
            freed += sb.nbytes
            self.counters.inc("evictions")
            log.info(f"fleet SHAP pack evicted (LRU, "
                     f"{sb.nbytes / 1e6:.2f} MB, members "
                     f"{tuple(m for m, _v in sb.token)}): resident "
                     "bytes over the memory budget")
        return freed

    def _evict_coldest(self, buckets, exclude=()) -> bool:
        """Force-evict the one coldest resident pack (the recovery step
        of an upload that OOM'd): a resident explain pack first, else the
        coldest score pack in ``buckets``; False when nothing is left.
        Caller holds the publish lock."""
        if self._evict_shap(1):
            return True
        order = sorted(
            (k for k, b in buckets.items()
             if b.dev is not None and k not in exclude),
            key=lambda k: self._touch.get(k, -1))
        if not order:
            return False
        k = order[0]
        buckets[k] = buckets[k]._replace(dev=None)
        self.counters.inc("evictions")
        log.warning(f"fleet pack force-evicted (coldest, "
                    f"{buckets[k].nbytes / 1e6:.2f} MB): freeing device "
                    "memory for an upload that OOM'd")
        return True

    def _upload_pack(self, b: _Bucket):
        """Upload one bucket's kept host pack (``forest.upload_window``,
        the ``oom`` and ``bitflip:where=dev`` sites) and place it. The
        host bytes are CRC-checked against the pack-time fingerprint
        first: a mismatch means the KEPT host pack rotted, it is no
        rebuild source, and the caller re-assembles the bucket from the
        tenants' cached windows."""
        crc = integrity.crc32_fingerprint(b.host)
        if crc != b.host_crc:
            raise integrity.IntegrityError(
                f"host mega-pack CRC mismatch for bucket {b.members}: "
                f"recorded {b.host_crc:#010x}, recomputed {crc:#010x} — "
                "host-side corruption of the retained rebuild source")
        return self._place(
            forest.upload_window(b.host, self._owner_device(b.owner)),
            b.owner)

    def _ensure_resident(self, state: _FleetState,
                         key: TenantShape) -> _Bucket:
        """Rebuild an evicted bucket's device pack: ONE upload of the
        kept host mega-pack, bit-exact and generation-keeping, because
        ``host`` is the bytes the routes in ``state`` were built against.
        The resident bucket goes back into the live state only while the
        live state still serves this very bucket (after a raced publish
        the upload serves this dispatch alone). An upload that OOMs
        force-evicts the coldest other pack and retries once."""
        b = state.buckets[key]
        if b.dev is not None:
            return b
        with self._publish_lock:
            cur = self._state
            live = cur.buckets.get(key) is b
            buckets = dict(cur.buckets) if live else {}
            if live:
                # evict first, so the rebuild fits the ledger
                buckets = self._enforce_budget(
                    buckets, keep={key}, incoming=b.nbytes)
            try:
                nb = b._replace(dev=self._upload_pack(b))
            except BaseException as e:  # noqa: BLE001 — classify
                if isinstance(e, integrity.IntegrityError):
                    # the kept host pack no longer matches its pack-time
                    # CRC: host-side rot. Re-assemble from the windows.
                    self.counters.inc("integrity_mismatches")
                    log.warning(
                        f"fleet lazy rebuild refused: {e}; "
                        f"re-assembling bucket {b.members} from the "
                        "tenants' cached windows")
                    nb = self._build_bucket(key, b.members, cur.shard,
                                            dict(cur.routes),
                                            owner=b.owner)
                elif not is_oom_error(e) or not self._evict_coldest(
                        buckets, exclude={key}):
                    raise
                else:
                    nb = b._replace(dev=self._upload_pack(b))
            if self._integrity_interval > 0:
                # conlint: disable=CL002 — deliberate: the candidate
                # is canary-verified atomically with its installation (a
                # bounded 16-row replay per member); dropping the lock
                # would race a publish
                bad = self._verify_pack(cur.routes, nb,
                                        skip=self._quarantined)
                if bad:
                    # never install corrupt bits: the afflicted tenants
                    # go to the host walk, the bucket stays evicted and
                    # the probe repairs it
                    for m in bad:
                        self.counters.inc("integrity_mismatches",
                                          tenant=m)
                        self._quarantine(
                            m, "lazily rebuilt pack failed canary "
                               "parity before install")
                    raise integrity.CanaryMismatch(
                        f"rebuilt mega-pack for bucket members "
                        f"{nb.members} failed canary parity for "
                        f"{sorted(bad)} — refusing to install corrupt "
                        "bits; the probe repairs and un-quarantines")
            self.counters.inc("rebuilds")
            log.info(f"fleet pack rebuilt after eviction "
                     f"({b.nbytes / 1e6:.2f} MB, members {b.members})")
            if live:
                buckets[key] = nb
                self._state = _FleetState(buckets, cur.routes,
                                          cur.shard)  # GIL-atomic
            return nb

    def _resolve_shard(self, total_bytes: int) -> str:
        n_dev = len(self.mesh) if self.mesh is not None else 1
        mode = self._shard_mode
        if mode == "model" and n_dev <= 1:
            log.info_once("tpu_serving_fleet_shard=model needs >1 device; "
                          "replicating")
            mode = "replicate"
        if mode != "auto":
            return mode
        if n_dev <= 1 or total_bytes <= self._pack_budget:
            return "replicate"
        return "model"

    # ---- request path ------------------------------------------------
    def submit(self, tenant: str, X,
               deadline_ms: Optional[float] = None,
               kind: str = "score") -> PendingRequest:
        """Enqueue one request for ``tenant``. Validation happens HERE
        (the tenant, the shape, the raw route's f32 contract), so a
        malformed request raises to ITS submitter and never joins the
        cross-tenant batch its peers form. ``kind="contrib"`` asks for
        SHAP contributions on the explain batcher (its own
        ``tpu_serving_explain_*`` knobs)."""
        if kind not in ("score", "contrib"):
            raise ValueError(f"unknown request kind {kind!r} "
                             "(expected 'score' or 'contrib')")
        t = self._tenants.get(tenant)
        if t is None:
            raise KeyError(f"unknown tenant {tenant!r}")
        X = np.ascontiguousarray(np.asarray(X, np.float64))
        if X.ndim != 2 or X.shape[1] != t.n_features:
            raise ValueError(
                f"tenant {tenant!r} requests must be "
                f"[rows, {t.n_features}] (got {X.shape})")
        if t.raw_route and X.shape[0]:
            forest.raw_request(X)
        if kind == "contrib":
            dl = self.explain_deadline_ms if deadline_ms is None \
                else float(deadline_ms)
            return self._explain_batcher.submit(
                X, deadline_sec=(dl / 1e3 if dl and dl > 0 else None),
                tenant=tenant, max_tenant_rows=t.quota_rows,
                kind="contrib")
        dl = t.deadline_ms if deadline_ms is None else float(deadline_ms)
        return self._batcher.submit(
            X, deadline_sec=(dl / 1e3 if dl and dl > 0 else None),
            tenant=tenant, max_tenant_rows=t.quota_rows)

    def predict(self, tenant: str, X,
                timeout: Optional[float] = None) -> np.ndarray:
        """Sync sugar: submit + result, the timeout riding the deadline
        machinery as in ``ModelServer.predict``."""
        dl_ms = None if timeout is None else timeout * 1e3
        return self.submit(tenant, X, deadline_ms=dl_ms).result(timeout)

    def explain(self, tenant: str, X,
                timeout: Optional[float] = None) -> np.ndarray:
        """Sync sugar for the explanation route: SHAP contributions
        [rows, (F+1)*k] for ``tenant``, the reference ``pred_contrib``
        layout (per class a block of F+1, bias last)."""
        dl_ms = None if timeout is None else timeout * 1e3
        return self.submit(tenant, X, deadline_ms=dl_ms,
                           kind="contrib").result(timeout)

    # ---- dispatch ----------------------------------------------------
    def _dispatch_many(self, batch: List[PendingRequest]) -> list:
        """Serve one coalesced cross-tenant batch: grouped by shape
        bucket, one scorer call per group against ONE fleet state, one
        outcome per request back to the batcher. A group's transient
        failure retries and then degrades (the host walk still answers);
        any other error fails that GROUP only."""
        state = self._state            # single read: atomic pairing
        q = self._quarantined          # single read: GIL-atomic
        outcomes: list = [None] * len(batch)
        groups: Dict[TenantShape, list] = {}
        quarantined: list = []
        for i, r in enumerate(batch):
            route = state.routes.get(r.tenant)
            if route is None:
                outcomes[i] = KeyError(
                    f"tenant {r.tenant!r} was removed before dispatch")
            elif route.name in q:
                quarantined.append((i, r, route))
            else:
                groups.setdefault(route.key, []).append((i, r, route))
        if quarantined:
            # quarantined tenants take the host walk until the probe
            # repairs their pack; their coalesced peers stay on the
            # device. One global count per dispatch that carried such
            # rows, one per tenant present
            self.counters.inc("degraded_batches")
            for t in {r.tenant for _i, r, _route in quarantined}:
                self.counters.inc_tenant(t, "degraded_batches")
            for i, r, route in quarantined:
                try:
                    outcomes[i] = self._finish(
                        self._host_scores(route, r.X), route)
                except BaseException as e:  # noqa: BLE001 — per-request
                    outcomes[i] = e
        for key in groups:
            # the eviction pass's LRU signal
            self._touch_seq += 1
            self._touch[key] = self._touch_seq
        for key, items in groups.items():
            degraded = self._degrade.degraded
            raw = None
            if not degraded:
                try:
                    raw = self._adaptive_group_scores(state, key, items)
                except RetryError as e:
                    self.counters.inc("dispatch_failures")
                    self._degrade.enter(
                        f"dispatch retry budget exhausted: {e.last!r}")
                    degraded = True
                except BaseException as e:  # noqa: BLE001 — group-scoped
                    for i, _r, _route in items:
                        outcomes[i] = e
                    continue
            if degraded:
                # the global ledger counts one per degraded group, each
                # tenant's ledger one per group that carried its rows
                self.counters.inc("degraded_batches")
                for t in {r.tenant for _i, r, _route in items}:
                    self.counters.inc_tenant(t, "degraded_batches")
            off = 0
            for i, r, route in items:
                if degraded:
                    vals = self._host_scores(route, r.X)
                else:
                    vals = raw[off:off + r.n]
                outcomes[i] = self._finish(vals, route)
                off += r.n
        return outcomes

    def _adaptive_group_scores(self, state: _FleetState,
                               key: TenantShape, items) -> np.ndarray:
        """Bucket-group scoring with the OOM bisection ladder, the fleet
        counterpart of ``ModelServer._adaptive_scores``. Transient
        failures retry under the serving policy (RetryError propagates:
        the caller degrades). An OOM splits the group's REQUESTS in half
        and tries each half; a single request that still OOMs is
        host-walked alone, its coalesced peers staying on the device."""
        try:
            return retry_call(
                self._bucket_scores, state, key, items,
                policy=self._retry_policy, what="fleet dispatch",
                on_retry=lambda _a, _e:
                    self.counters.inc("dispatch_retries"))
        except RetryError:
            raise
        except BaseException as e:  # noqa: BLE001 — classifier decides
            if is_corruption_error(e):
                # a rebuilt pack failed canary parity: the afflicted
                # tenants are quarantined and the pack was NOT installed;
                # this group takes the host walk this once
                log.warning(
                    f"fleet dispatch refused a corrupt pack ({e}); "
                    f"host-walking {len(items)} coalesced request(s) "
                    "this once")
                self.counters.inc("degraded_batches")
                for t in {r.tenant for _i, r, _route in items}:
                    self.counters.inc_tenant(t, "degraded_batches")
                return np.concatenate(
                    [self._host_scores(route, r.X)
                     for _i, r, route in items], axis=0)
            if not is_oom_error(e):
                raise
            if len(items) > 1:
                self.counters.inc("oom_bisects")
                mid = len(items) // 2
                log.warning(
                    f"fleet dispatch OOM over {len(items)} requests "
                    f"({e!r}); bisecting into {mid}+{len(items) - mid}")
                return np.concatenate(
                    [self._adaptive_group_scores(state, key, items[:mid]),
                     self._adaptive_group_scores(state, key, items[mid:])],
                    axis=0)
            _i, r, route = items[0]
            if not self._oom_floor_warned:
                self._oom_floor_warned = True
                log.warning(
                    f"fleet dispatch OOM at the single-request floor "
                    f"({e!r}); host-walking ONLY tenant "
                    f"{route.name!r}'s rows — coalesced peers stay on "
                    "the device (warned once per fleet)")
            return self._host_scores(route, r.X)

    def _bucket_scores(self, state: _FleetState, key: TenantShape,
                       items) -> np.ndarray:
        """One device attempt at a bucket group: [R_total, k] f64 raw
        scores, rows in item order. The fault sites come BEFORE the real
        dispatch and every retry consults them again. An EVICTED bucket
        is made resident first (``_ensure_resident``)."""
        faults.maybe_delay("slow_dispatch")
        faults.maybe_fail("dispatch_error")
        faults.maybe_fail("oom")
        bucket = state.buckets[key]
        if bucket.dev is None:
            bucket = self._ensure_resident(state, key)
        return self._group_scores(bucket, items)

    def _group_scores(self, bucket: _Bucket, items) -> np.ndarray:
        """The device scoring of one resident bucket group, no fault
        sites and no residency management: shared by client dispatch
        and the canary replays (``_replay_route``), so a background probe
        never burns a fault plan armed for client traffic. One scorer
        call for the group (one per mesh device when the pack is
        replicated over a mesh and the rows split)."""
        key = bucket.key
        total = sum(r.n for _i, r, _route in items)
        lo = np.zeros(total, np.int64)
        nl = np.zeros(total, np.int64)
        if key.kind == "binned":
            operand = np.zeros((key.feat_cap, total), np.int32)
            axis, run = 1, forest._fleet_scores_binned
        else:
            operand = np.zeros((total, key.feat_cap), np.float32)
            axis, run = 0, forest._fleet_scores_raw
        off = 0
        for _i, r, route in items:
            n = r.n
            lo[off:off + n] = route.lo
            nl[off:off + n] = route.n_trees
            if key.kind == "binned":
                operand[:len(route.mappers), off:off + n] = \
                    _host_bins(route, r.X)
            else:
                operand[off:off + n, :r.X.shape[1]] = r.X
            off += n
        lo_t, nl_t, op_t = (torch.from_numpy(a) for a in (lo, nl, operand))
        args = (key.steps, key.k, key.win_slots)
        if bucket.owner is not None or self.mesh is None:
            dev = self._owner_device(bucket.owner)
            out = run(*args, bucket.dev, lo_t.to(dev), nl_t.to(dev),
                      op_t.to(dev)).cpu()
        else:
            def score_parts():
                return torch.cat([
                    run(*args, w, a, b, c).cpu() for w, a, b, c in zip(
                        bucket.dev, mesh_mod.shard_rows(lo_t, 0, self.mesh),
                        mesh_mod.shard_rows(nl_t, 0, self.mesh),
                        mesh_mod.shard_rows(op_t, axis, self.mesh))], dim=1)
            out = mesh_mod.locked_launch(self.mesh, score_parts)
        return out.numpy().astype(np.float64).T

    def _host_scores(self, route: TenantRoute, X: np.ndarray
                     ) -> np.ndarray:
        """[R, K] f64 raw scores by the tenant's HOST per-tree walk
        (``server.host_walk_scores``, one copy with the solo server)."""
        return host_walk_scores(route.models, route.k, X)

    def _finish(self, raw: np.ndarray, route: TenantRoute):
        """Per-tenant output tail (``server.finish_scores``)."""
        info = route.generation
        vals = finish_scores(raw, route.k, info.num_trees,
                             route.average_output, route.objective,
                             route.raw_score)
        return vals, info

    # ---- explanation route -------------------------------------------
    def _explain_blocked(self, route: TenantRoute) -> Optional[str]:
        """None when ``route``'s model is device-explainable, else why
        not (linear trees, categorical splits). Cached per (tenant,
        generation)."""
        ent = self._explain_block.get(route.name)
        if ent is not None and ent[0] == route.generation.version:
            return ent[1]
        try:
            shap_pack.check_explainable(route.models)
            reason = None
        except DeviceRouteUnavailable as e:
            reason = str(e)
        self._explain_block[route.name] = (route.generation.version,
                                           reason)
        return reason

    def _assemble_shap_host(self, key: TenantShape, b: _Bucket,
                            routes: Dict[str, TenantRoute]
                            ) -> _ShapBucket:
        """The HOST explain pack of ``key``'s bucket: each member's
        flattened paths in slot order, None for a blocked member. An
        un-uploaded (``dev=None``) entry; caller holds the publish
        lock."""
        token = tuple((m, routes[m].generation.version)
                      for m in b.members)
        wins, blocked = [], {}
        for m in b.members:
            route = routes[m]
            reason = self._explain_blocked(route)
            if reason is not None:
                blocked[m] = reason
                wins.append(None)
            elif key.kind == "binned":
                wins.append(shap_pack.pack_window_shap_binned(
                    route.models, route.mappers, key, route.n_features))
            else:
                wins.append(shap_pack.pack_window_shap_raw(
                    route.models, key, route.n_features))
        index = {m: i for i, m in enumerate(b.members)}
        if all(w is None for w in wins):   # the host walk answers all
            return _ShapBucket(key, token, None, None, 0, 0, blocked,
                               index, None)
        host = tuple(wins)
        return _ShapBucket(key, token, None, host,
                           integrity.crc32_fingerprint(host),
                           forest.pytree_nbytes(host), blocked, index,
                           b.owner)

    def _shap_bucket(self, state: _FleetState,
                     key: TenantShape) -> _ShapBucket:
        """The resident explain pack paired with ``key``'s bucket in
        ``state``: built at the FIRST explain after a publish, cached
        until a member's generation moves (``token``), and made resident
        again after an eviction by ONE re-upload of the CRC-checked kept
        host pack (a failed CRC means the host bytes rotted: it is
        re-assembled from the tenants' models). Its upload consults the
        ``oom`` site."""
        b = state.buckets[key]
        token = tuple((m, state.routes[m].generation.version)
                      for m in b.members)
        sb = self._shap_cache.get(key)
        if sb is not None and sb.token == token and \
                (sb.dev is not None or sb.host is None):
            return sb
        with self._publish_lock:
            sb = self._shap_cache.get(key)
            rebuild = sb is not None and sb.token == token
            if not rebuild:
                sb = self._assemble_shap_host(key, b, state.routes)
            elif sb.dev is not None or sb.host is None:
                return sb          # another thread built it first
            elif integrity.crc32_fingerprint(sb.host) != sb.host_crc:
                self.counters.inc("integrity_mismatches")
                log.warning(
                    f"fleet SHAP pack rebuild refused for members "
                    f"{tuple(m for m, _v in sb.token)}: retained host "
                    "pack failed its CRC fingerprint — re-assembling "
                    "from the tenants' models")
                sb = self._assemble_shap_host(key, b, state.routes)
            if sb.host is None:    # every member blocked
                self._shap_cache[key] = sb
                return sb
            if self._mem_budget > 0:
                self._evict_shap(
                    self._resident_bytes(self._state.buckets) + sb.nbytes
                    - self._mem_budget, keep={key})

            def upload():
                faults.maybe_fail("oom")
                return forest.to_device(sb.host,
                                        self._owner_device(sb.owner))
            try:
                dev = upload()
            except BaseException as e:  # noqa: BLE001 — classify
                if not is_oom_error(e) or not self._evict_shap(1,
                                                               keep={key}):
                    raise
                log.warning(
                    f"fleet SHAP pack upload OOM ({e!r}); retrying "
                    "after evicting the coldest resident SHAP pack")
                dev = upload()
            nb = sb._replace(dev=self._place(dev, sb.owner))
            self._shap_cache[key] = nb    # GIL-atomic store
            if rebuild:
                self.counters.inc("rebuilds")
                log.info(f"fleet SHAP pack rebuilt after eviction "
                         f"({nb.nbytes / 1e6:.2f} MB, members "
                         f"{tuple(m for m, _v in nb.token)})")
            return nb

    def _group_contrib(self, sb: _ShapBucket, items) -> list:
        """The device explanation of one resident explain bucket's group:
        per item its [n, (F_t+1)*k] f64 contributions, each request
        explained alone over its own tenant's paths (the sum order of
        the one-hot product depends on the row count, and a request's
        own row count is what its solo ``pred_contrib`` uses)."""
        kind = sb.key.kind
        replicated = sb.owner is None and self.mesh is not None
        dev = self._owner_device(sb.owner)
        vals = []
        for _i, r, route in items:
            i = sb.index[route.name]
            paths = (forest.Replicas(rep[i].paths for rep in sb.dev)
                     if replicated else sb.dev[i].paths)
            bias = sb.host[i].bias
            if kind == "binned":
                operand = torch.as_tensor(_host_bins(route, r.X))
            else:
                operand = torch.as_tensor(np.ascontiguousarray(
                    forest.raw_request(r.X, "explanation").T))
            if replicated:
                vals.append(mesh_mod.locked_launch(
                    self.mesh, shap_pack.contrib_rows, paths, kind,
                    operand, route.k, route.n_features, bias,
                    lambda a, axis: mesh_mod.shard_rows(a, axis,
                                                        self.mesh)))
            else:
                vals.append(shap_pack.contrib_rows(
                    paths, kind, operand.to(dev), route.k,
                    route.n_features, bias))
        return vals

    def _bucket_contrib(self, state: _FleetState, key: TenantShape,
                        items) -> list:
        """One device attempt at an explain bucket group, with the fault
        sites of ``_bucket_scores``; an evicted explain pack is made
        resident first."""
        faults.maybe_delay("slow_dispatch")
        faults.maybe_fail("dispatch_error")
        faults.maybe_fail("oom")
        return self._group_contrib(self._shap_bucket(state, key), items)

    def _host_contrib(self, route: TenantRoute, X: np.ndarray
                      ) -> np.ndarray:
        """[R, (F+1)*K] f64 contributions by the tenant's HOST TreeSHAP
        walk (``server.host_contrib_scores``), its own
        ``Booster.predict(pred_contrib=True)``."""
        return host_contrib_scores(route.models, route.k,
                                   route.n_features, X)

    def _adaptive_group_contrib(self, state: _FleetState,
                                key: TenantShape, items) -> list:
        """Explain-group dispatch with the OOM bisection ladder of
        ``_adaptive_group_scores``. A single request that still OOMs is
        answered by the host walk alone (or refused when the fallback
        knob says so); RetryError propagates to the caller's degrade."""
        try:
            return retry_call(
                self._bucket_contrib, state, key, items,
                policy=self._retry_policy, what="fleet explain dispatch",
                on_retry=lambda _a, _e:
                    self.counters.inc("dispatch_retries"))
        except RetryError:
            raise
        except BaseException as e:  # noqa: BLE001 — classifier decides
            if not is_oom_error(e):
                raise
            if len(items) > 1:
                self.counters.inc("oom_bisects")
                mid = len(items) // 2
                log.warning(
                    f"fleet explain dispatch OOM over {len(items)} "
                    f"requests ({e!r}); bisecting into "
                    f"{mid}+{len(items) - mid}")
                return (self._adaptive_group_contrib(state, key,
                                                     items[:mid])
                        + self._adaptive_group_contrib(state, key,
                                                       items[mid:]))
            if self._explain_refuse:
                raise
            _i, r, route = items[0]
            log.warning(
                f"fleet explain dispatch OOM at the single-request "
                f"floor ({e!r}); host predict_contrib for tenant "
                f"{route.name!r}'s rows only")
            return [self._host_contrib(route, r.X)]

    def _dispatch_explain_many(self, batch: List[PendingRequest]
                               ) -> list:
        """Serve one coalesced cross-tenant EXPLAIN batch: grouped by
        shape bucket against ONE fleet state. Quarantined,
        device-ineligible or fleet-degraded tenants answer by the host
        ``predict_contrib`` walk, counted per tenant as
        ``explain_degraded`` (or are refused with
        ``tpu_serving_explain_fallback="refuse"``); every answered
        contrib request counts ``explain_requests``."""
        state = self._state            # single read: atomic pairing
        q = self._quarantined          # single read: GIL-atomic
        degraded = self._degrade.degraded
        outcomes: list = [None] * len(batch)
        groups: Dict[TenantShape, list] = {}
        oracle: list = []              # (i, r, route, why)
        for i, r in enumerate(batch):
            route = state.routes.get(r.tenant)
            if route is None:
                outcomes[i] = KeyError(
                    f"tenant {r.tenant!r} was removed before dispatch")
                continue
            block = self._explain_blocked(route)
            if block is not None:
                oracle.append((i, r, route,
                               f"not device-explainable: {block}"))
            elif degraded or route.name in q:
                oracle.append((i, r, route,
                               "tenant quarantined" if route.name in q
                               else "fleet degraded"))
            else:
                groups.setdefault(route.key, []).append((i, r, route))
        for key in groups:
            # the explain LRU signal
            self._touch_seq += 1
            self._shap_touch[key] = self._touch_seq
        for key, items in groups.items():
            try:
                vals = self._adaptive_group_contrib(state, key, items)
            except RetryError as e:
                self.counters.inc("dispatch_failures")
                self._degrade.enter(
                    f"explain dispatch retry budget exhausted: "
                    f"{e.last!r}")
                for i, r, route in items:
                    oracle.append((i, r, route,
                                   "retry budget exhausted"))
                continue
            except BaseException as e:  # noqa: BLE001 — group-scoped
                for i, _r, _route in items:
                    outcomes[i] = e
                continue
            for (i, r, route), v in zip(items, vals):
                outcomes[i] = (v, route.generation)
                self.counters.inc("explain_requests", tenant=r.tenant)
        for i, r, route, why in oracle:
            if self._explain_refuse:
                outcomes[i] = RuntimeError(
                    "explanation serving unavailable "
                    f"(fallback='refuse') for tenant {route.name!r}: "
                    f"{why}")
                continue
            try:
                outcomes[i] = (self._host_contrib(route, r.X),
                               route.generation)
            except BaseException as e:  # noqa: BLE001 — per-request
                outcomes[i] = e
                continue
            self.counters.inc("explain_requests", tenant=r.tenant)
            self.counters.inc("explain_degraded", tenant=r.tenant)
        return outcomes

    # ---- degradation / lifecycle ------------------------------------
    def degrade(self, reason: str = "forced") -> None:
        """Flip the whole fleet to the host-walk route (chaos drills,
        operator override); the background probe un-degrades."""
        self._degrade.enter(reason)

    def _recovery_probe(self) -> None:
        faults.maybe_fail("dispatch_error")
        mesh_mod.probe(self.mesh, self.device)

    # ---- integrity ---------------------------------------------------
    def evict(self, tenant: str) -> bool:
        """Operator / drill API: drop ``tenant``'s bucket from the device
        (host pack kept: the next touch rebuilds it bit-exactly). The
        integrity drills pair it with an armed ``bitflip`` fault, so the
        rebuild's upload rots. True when a resident pack was evicted."""
        with self._publish_lock:
            cur = self._state
            route = cur.routes.get(tenant)
            b = None if route is None else cur.buckets.get(route.key)
            if b is None or b.dev is None:
                return False
            buckets = dict(cur.buckets)
            buckets[route.key] = b._replace(dev=None)
            self.counters.inc("evictions")
            log.warning(f"fleet pack force-evicted (operator drill) for "
                        f"tenant {tenant!r}: members {b.members}")
            self._state = _FleetState(buckets, cur.routes, cur.shard)
            return True

    def _replay_route(self, bucket: _Bucket, route: TenantRoute,
                      Xc: np.ndarray) -> np.ndarray:
        """[rows, k] f64 canary scores of one tenant through one resident
        pack, by ``_group_scores`` alone (no fault site)."""
        req = _CanaryReq(int(Xc.shape[0]), Xc, route.name)
        return self._group_scores(bucket, [(0, req, route)])

    def _record_golden(self, name: str) -> None:
        """Record tenant ``name``'s canary golden for the generation just
        published: a DEVICE replay through its live bucket, ANCHORED
        against the host walk within f32 accumulation. A pack corrupt
        before this point disagrees with the anchor by far, and the
        publish is refused (the caller un-publishes). Caller holds the
        publish lock."""
        state = self._state
        route = state.routes[name]
        b = state.buckets.get(route.key)
        if b is None or b.dev is None:
            self._goldens.pop(name, None)   # nothing resident to attest
            return
        Xc = integrity.canary_batch(route.n_features,
                                    rows=self._canary_rows)
        golden = self._replay_route(b, route, Xc)
        anchor = self._host_scores(route, Xc)
        if not np.allclose(golden, anchor, rtol=1e-5, atol=1e-6):
            self.counters.inc("integrity_mismatches", tenant=name)
            raise integrity.CanaryMismatch(
                f"tenant {name!r} publish canary replay disagrees with "
                "the host-walk anchor — the freshly built pack is "
                "corrupt; refusing to publish it")
        self._goldens[name] = (route.generation.version, Xc, golden)

    def _verify_pack(self, routes: Dict[str, TenantRoute], b: _Bucket,
                     skip=frozenset()) -> list:
        """Replay every member's current-generation canary against one
        CANDIDATE pack; the members whose replay is not their golden bit
        for bit ([] = clean). Members in ``skip`` and members without a
        current-generation golden are not replayed."""
        bad = []
        for m in b.members:
            if m in skip:
                continue
            route = routes.get(m)
            g = self._goldens.get(m)
            if route is None or g is None or \
                    g[0] != route.generation.version:
                continue
            if not integrity.parity_equal(
                    self._replay_route(b, route, g[1]), g[2]):
                bad.append(m)
        return bad

    def _quarantine(self, name: str, reason: str) -> None:
        """Route ONLY tenant ``name`` to the host walk; its coalesced
        peers stay on the device. Idempotent."""
        with self._qlock:
            if name in self._quarantined:
                return
            self._quarantined = self._quarantined | {name}
        self.counters.inc("quarantines", tenant=name)
        log.warning(
            "=" * 60 + f"\nFLEET TENANT QUARANTINED: {name!r}: {reason}\n"
            "serving this tenant by the host walk (bit-identical to "
            "Booster.predict); peers stay on the device route. The\n"
            "integrity probe repairs the pack and un-quarantines on "
            "clean canary parity.\n" + "=" * 60)

    def _unquarantine(self, name: str) -> None:
        with self._qlock:
            if name not in self._quarantined:
                return
            self._quarantined = self._quarantined - {name}
        self.counters.inc("repairs", tenant=name)
        log.warning(f"fleet tenant {name!r} un-quarantined: the "
                    "repaired pack replayed its canary bit-clean — "
                    "back on the device route")

    def _repair_bucket(self, key: TenantShape) -> None:
        """Repair one bucket's device pack under the publish lock: a
        re-upload of the kept host pack while its CRC still matches
        (device-side rot), else a rebuild from the tenants' cached
        windows (host-side rot). The candidate is canary-verified BEFORE
        it is installed; a still-corrupt pack is never installed."""
        with self._publish_lock:
            cur = self._state
            b = cur.buckets.get(key)
            if b is None:
                return
            routes = dict(cur.routes)
            try:
                try:
                    nb = b._replace(dev=self._upload_pack(b))
                    how = "re-upload of the CRC-verified host pack"
                except integrity.IntegrityError:
                    nb = self._build_bucket(key, b.members, cur.shard,
                                            routes, owner=b.owner)
                    how = ("full rebuild from the tenants' cached "
                           "windows (host pack failed its CRC)")
            except BaseException as e:  # noqa: BLE001 — stay quarantined
                log.warning(
                    f"fleet integrity repair failed for bucket "
                    f"{b.members} ({e!r}); quarantined members stay on "
                    "the host walk until the next probe cycle")
                return
            # conlint: disable=CL002 — deliberate: verify-before-install
            # must be atomic with the state swap (16-row canary replay,
            # bounded hold)
            bad = self._verify_pack(cur.routes, nb)
            if bad:
                for m in bad:
                    self._quarantine(m, "repaired pack STILL fails "
                                        "canary parity")
                log.warning(
                    f"fleet integrity repair produced a pack that still "
                    f"fails canary parity for {sorted(bad)} — not "
                    "installing it")
                return
            buckets = dict(cur.buckets)
            buckets[key] = nb
            self._state = _FleetState(buckets, routes, cur.shard)
            log.warning(f"fleet integrity repair: bucket {nb.members} "
                        f"repaired by {how}")

    def _try_unquarantine(self, key: TenantShape) -> None:
        """Un-quarantine every quarantined member of ``key``'s bucket
        whose canary replays bit-clean through the CURRENT pack (one
        ``repairs`` per tenant restored)."""
        state = self._state
        b = state.buckets.get(key)
        if b is None or b.dev is None:
            return
        for m in b.members:
            if m not in self._quarantined:
                continue
            route = state.routes.get(m)
            g = self._goldens.get(m)
            if route is None or g is None or \
                    g[0] != route.generation.version:
                continue
            if integrity.parity_equal(
                    self._replay_route(b, route, g[1]), g[2]):
                self._unquarantine(m)

    def _integrity_check(self) -> None:
        """One background canary cycle over the fleet: every resident
        bucket member's canary against its publish-time golden; on a
        mismatch quarantine ONLY the afflicted tenants, repair the pack
        and un-quarantine each tenant once its repaired pack replays
        clean. Evicted healthy buckets are skipped: no device bits to
        rot, and probing must not defeat the eviction."""
        if self._closed or self._degrade.degraded:
            return
        state = self._state
        if not state.buckets:
            return
        self.counters.inc("integrity_probes")
        for key in list(state.buckets):
            b = state.buckets.get(key)
            if b is None:
                continue
            qmembers = [m for m in b.members if m in self._quarantined]
            bad = []
            if b.dev is not None:
                bad = self._verify_pack(state.routes, b,
                                        skip=self._quarantined)
                for m in bad:
                    self.counters.inc("integrity_mismatches", tenant=m)
                    self._quarantine(
                        m, "resident pack failed canary parity")
            if bad or qmembers:
                self._repair_bucket(key)
                self._try_unquarantine(key)

    def stats(self) -> dict:
        s = self._batcher.stats()
        state = self._state
        s["n_tenants"] = len(state.routes)
        s["n_buckets"] = len(state.buckets)
        s["fleet_shard"] = state.shard
        s["pack_bytes"] = sum(b.nbytes for b in state.buckets.values())
        s["resident_pack_bytes"] = sum(
            b.nbytes for b in state.buckets.values() if b.dev is not None)
        s["evicted_buckets"] = sum(
            1 for b in state.buckets.values() if b.dev is None)
        s["resident_shap_bytes"] = sum(
            sb.nbytes for sb in self._shap_cache.values()
            if sb.dev is not None)
        s["mem_budget_mb"] = self._mem_budget / 1e6
        s["device"] = str(self.device)
        s["mesh_devices"] = len(self.mesh) if self.mesh is not None else 1
        s["linger_ms"] = self._batcher.linger_sec * 1e3
        s["max_batch"] = self._batcher.max_batch
        s["degraded"] = self._degrade.degraded
        if s["degraded"] and self._degrade.reason is not None:
            s["degraded_reason"] = self._degrade.reason
        if self._integrity_interval > 0:
            s["integrity_probe_interval_s"] = self._integrity_interval
        if self._quarantined:
            s["quarantined"] = sorted(self._quarantined)
        eb = self._explain_batcher
        s["explain"] = {"requests": eb.n_requests, "rows": eb.n_rows,
                        "batches": eb.n_batches,
                        "max_coalesced": eb.max_coalesced,
                        **eb.latency.summary_ms()}
        return s

    def tenant_stats(self, name: str) -> dict:
        """One tenant's view: its counters and its routing."""
        t = self._tenants.get(name)
        route = self._state.routes.get(name)
        s = dict(self.counters.tenant_snapshot().get(name, {}))
        if route is not None:
            s["generation"] = route.generation.version
            s["num_trees"] = route.n_trees
            s["bucket"] = route.key._asdict()
            s["window_lo"] = route.lo
        if t is not None:
            s["deadline_ms"] = t.deadline_ms
            s["quota_rows"] = t.quota_rows
        s["degraded"] = self._degrade.degraded
        s["quarantined"] = name in self._quarantined
        return s

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def tenants(self) -> Tuple[str, ...]:
        return tuple(sorted(self._state.routes))

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Drain and stop the whole fleet (``ModelServer.close``'s
        contract)."""
        self._closed = True
        if self._iprobe is not None:
            self._iprobe.close()
        self._degrade.close()
        self._explain_batcher.close(timeout)
        self._batcher.close(timeout)

    def __enter__(self) -> "FleetServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _host_bins(route: TenantRoute, X: np.ndarray) -> np.ndarray:
    """[F_used, n] int32 bins of one tenant's request rows by ITS OWN
    host BinMappers: ``value_to_bin`` is the mapping the training-time
    binning and the host walk agree on for every f64 value."""
    cols = X[:, route.used].T
    return np.stack([
        m.value_to_bin(np.ascontiguousarray(cols[j], np.float64))
        for j, m in enumerate(route.mappers)]).astype(np.int32)


def serve_fleet(boosters, **knobs) -> FleetServer:
    """A :class:`FleetServer` hosting every ``{name: booster}`` entry (a
    mapping, or an iterable of ``(name, booster)`` pairs). ``raw_score=``
    applies to every tenant; the other knobs are the fleet's (see
    :class:`FleetServer`), defaulting from the FIRST booster's config,
    whose ``device_type`` also names the fleet's device."""
    items = list(boosters.items()) if hasattr(boosters, "items") \
        else list(boosters)
    if not items:
        raise ValueError("serve_fleet needs at least one (name, booster)")
    raw_score = bool(knobs.pop("raw_score", False))
    cfg = knobs.pop("config", None)
    if cfg is None:
        cfg = getattr(items[0][1], "config", None)
    fleet = FleetServer(config=cfg, **knobs)
    try:
        for name, bst in items:
            fleet.add_tenant(name, bst, raw_score=raw_score)
    except BaseException:
        fleet.close(timeout=5.0)
        raise
    return fleet
