"""Continual service: a resident trainer and a network front door over
the live serving tier.

Port of ``lightgbm_tpu/service/__init__.py``. One deployable process
(ref: the reference's resident task loop,
src/application/application.cpp) built for a serving tier:

- a **resident trainer** boosts on a rolling window of fresh rows
  tail-followed from a stream file (``service/trainer.py``), committing
  CRC-validated atomic checkpoints, supervised with bounded
  relaunch-and-resume (``trainer_mode="process"``, the default: a child
  process on the device its params name, on the card a second CUDA
  context beside this one) or on a thread of this process
  (``trainer_mode="thread"``);
- a **publish pump** tails the checkpoint directory and hot-swaps each
  new generation into the live :class:`~..serving.ModelServer` through
  its incremental publish: only the new trees are packed, in-flight
  batches keep their snapshot, a failed publish rolls back;
- a **network front door** (``service/frontdoor.py``) serves
  ``POST /v1/predict`` and ``/v1/explain`` over HTTP with wire deadlines,
  the failure map (429/504/503/400/413/404), chunked responses and a
  **freshness ledger**: every response names its model generation and
  training watermark, and the service keeps model-staleness p50/p99.

Usage::

    svc = lightgbm_tpu_torch.serve_continual(
        {"objective": "binary", "num_leaves": 31},
        stream_path="rows.csv", ckpt_dir="ckpts", port=8080)
    ...
    svc.stats()["staleness_p99_ms"]
    svc.close()

Knobs default from the ``tpu_service_*`` params (``config.py``). The
served model lives on the device the params' ``device_type`` names
(``cuda`` unless ``"cpu"``), as the trainer's does.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

import numpy as np

from .frontdoor import FrontDoor, ServerGateway
from .trainer import (STATE_KEY, ThreadTrainer, TrainerSpec,
                      TrainerSupervisor, run_resident_trainer)
from ..config import Config
from ..serving.metrics import LatencyRecorder
from ..utils import log

__all__ = ["ContinualService", "FrontDoor", "ServerGateway",
           "ThreadTrainer", "TrainerSpec", "TrainerSupervisor",
           "run_resident_trainer", "serve_continual"]


class ContinualService:
    """The deployable train-and-serve process. See the module docstring.

    ``trainer_mode``: ``"process"`` (default — supervised child,
    crash-isolated from serving) or ``"thread"`` (in-process: tests,
    single-process deployments). ``attempt_env(i)`` forwards to the
    :class:`TrainerSupervisor` so chaos harnesses can arm faults on one
    specific launch."""

    def __init__(self, params: Dict, stream_path: str, ckpt_dir: str,
                 *, host: str = "127.0.0.1", port: Optional[int] = None,
                 trainer_mode: Optional[str] = None,
                 window_rows: Optional[int] = None,
                 window_floor_rows: Optional[int] = None,
                 min_rows: int = 256,
                 iters_per_cycle: Optional[int] = None,
                 publish_every_iters: Optional[int] = None,
                 target_iterations: int = 0,
                 label_col: int = 0,
                 raw_score: bool = False,
                 boot_timeout_s: float = 600.0,
                 poll_sec: Optional[float] = None,
                 attempt_env=None,
                 max_relaunches: Optional[int] = None,
                 keep_last: int = 3,
                 serve_kwargs: Optional[Dict] = None):
        cfg = Config({k: v for k, v in (params or {}).items()
                      if not callable(v)})

        def knob(value, name):
            return getattr(cfg, name) if value is None else value

        self.params = dict(params or {})
        self.ckpt_dir = ckpt_dir
        # resolved through Config so num_leaves ALIASES (max_leaves,
        # num_leaf, ...) reach the pack-capacity patch in _load_booster
        self._num_leaves = int(cfg.num_leaves)
        # the served model predicts on the training device
        self._device_params = {"device_type": str(cfg.device_type)}
        self.poll_sec = float(knob(poll_sec, "tpu_service_poll_sec"))
        self.raw_score = bool(raw_score)
        trainer_mode = str(knob(trainer_mode,
                                "tpu_service_trainer")).lower()
        if trainer_mode not in ("process", "thread"):
            raise ValueError(f"trainer_mode must be process|thread "
                             f"(got {trainer_mode!r})")
        self.spec = TrainerSpec(
            params=self.params, stream_path=stream_path,
            ckpt_dir=ckpt_dir, label_col=int(label_col),
            window_rows=int(knob(window_rows,
                                 "tpu_service_window_rows")),
            window_floor_rows=int(knob(window_floor_rows,
                                       "tpu_service_window_floor")),
            min_rows=int(min_rows),
            iters_per_cycle=int(knob(iters_per_cycle,
                                     "tpu_service_iters_per_cycle")),
            publish_every_iters=int(knob(
                publish_every_iters, "tpu_service_publish_iters")),
            target_iterations=int(target_iterations),
            poll_sec=self.poll_sec, keep_last=int(keep_last))
        os.makedirs(ckpt_dir, exist_ok=True)

        self._closed = False
        self._stop = threading.Event()
        self.staleness = LatencyRecorder()
        self._marks: Dict[int, dict] = {}
        self._mark_lock = threading.Lock()
        self.publishes = 0
        self.publish_errors = 0
        self._served_iteration = 0

        # 1) trainer first: its first committed checkpoint is the boot
        #    model the serving tier opens with
        if trainer_mode == "thread":
            self.trainer = ThreadTrainer(self.spec)
        else:
            self.trainer = TrainerSupervisor(
                self.spec, max_relaunches=max_relaunches,
                attempt_env=attempt_env)

        # 2) serving tier over the boot checkpoint
        state = self._wait_for_checkpoint(boot_timeout_s)
        self._booster = self._load_booster(state["model"])
        self._server = None
        from ..serving import ModelServer
        self._server = ModelServer(self._booster,
                                   raw_score=self.raw_score,
                                   **(serve_kwargs or {}))
        self._record_publish(self._server.generation, state)
        self._served_iteration = int(state["iteration"])

        # 3) publish pump: checkpoint dir -> live hot-swaps
        self._pump = threading.Thread(target=self._pump_loop,
                                      daemon=True,
                                      name="lgbm-publish-pump")
        self._pump.start()

        # 4) front door
        self.frontdoor = FrontDoor(
            self, host=host,
            port=int(knob(port, "tpu_service_port")),
            max_body_mb=float(cfg.tpu_service_max_body_mb),
            chunk_rows=int(cfg.tpu_service_chunk_rows))

    # -- boot helpers --------------------------------------------------
    def _wait_for_checkpoint(self, timeout_s: float) -> dict:
        from ..robustness.checkpoint import latest_valid_checkpoint
        t_end = time.monotonic() + timeout_s
        while True:
            found = latest_valid_checkpoint(self.ckpt_dir)
            if found is not None:
                return found[1]
            if not self.trainer.alive:
                self.close()
                raise RuntimeError(
                    "resident trainer died before committing its first "
                    f"checkpoint: {self.trainer.describe()}")
            if time.monotonic() > t_end:
                self.close()
                raise TimeoutError(
                    f"no checkpoint in {self.ckpt_dir} within "
                    f"{timeout_s:.0f}s — is the stream producing rows?")
            time.sleep(min(self.poll_sec, 0.5))

    def _load_booster(self, model_str: str):
        from ..basic import Booster
        b = Booster(params=self._device_params, model_str=model_str)
        # the server sizes its pack from the engine's num_leaves and the
        # boot trees: it must be the TRAINING num_leaves (boot trees grown
        # on a small first window have fewer leaves than later ones, and
        # a later tree with more would overflow the pack)
        b._engine.config.update({"num_leaves": self._num_leaves})
        return b

    # -- publish pump --------------------------------------------------
    def _set_mark(self, version: int, state: dict) -> None:
        """Register a generation's freshness watermark. Called BEFORE
        the generation goes live (publish()): a request scored against
        the new snapshot in the swap/record gap must still find its
        mark, or its response would ship without staleness headers."""
        svc = state.get(STATE_KEY) or {}
        with self._mark_lock:
            self._marks[int(version)] = {
                "watermark_rows": int(svc.get("watermark_rows", 0)),
                "watermark_ts": float(svc.get("watermark_ts",
                                              time.time())),
                "iteration": int(state.get("iteration", 0)),
            }
            # bounded book: generations far behind any in-flight batch
            for v in sorted(self._marks)[:-64]:
                del self._marks[v]

    def _drop_mark(self, version: int) -> None:
        with self._mark_lock:
            self._marks.pop(int(version), None)

    def _record_publish(self, generation, state: dict) -> None:
        self._set_mark(generation.version, state)
        self.publishes += 1

    def _append_increment(self, model_str: str) -> Optional[str]:
        """Graft a newer checkpoint's trees onto the serving engine.

        Tail-APPEND when the new model extends the served one (the
        common continual case — incremental pack, no repack); full
        REPLACE + cache invalidation when the prefix disagrees (e.g. a
        relaunched trainer resumed from an older checkpoint than the
        one currently served, so generations stay monotonic while the
        model content rewinds). Returns the mutation kind ("append" |
        "replace") or None when the engine already holds this model —
        the caller still publishes in that case (a previous publish may
        have failed AFTER the graft; the version must move)."""
        from ..basic import Booster
        nb = Booster(params=self._device_params, model_str=model_str)
        new = nb._engine.models
        eng = self._booster._engine
        cur = eng.models
        if len(new) > len(cur) and self._prefix_matches(cur, new):
            cur.extend(new[len(cur):])
            return "append"
        if not new or (len(new) == len(cur) and
                       self._prefix_matches(cur, new)):
            return None
        log.warning(
            "publish pump: checkpoint model does not extend the served "
            f"model ({len(cur)} -> {len(new)} trees); full replace")
        cur[:] = new
        eng.invalidate_serving_cache()
        return "replace"

    @staticmethod
    def _prefix_matches(cur, new) -> bool:
        """Cheap structural guard that ``new`` really extends ``cur``:
        compare the LAST shared tree's shape and leaf values (resume is
        bit-exact, so a legitimate extension always passes)."""
        if not cur:
            return True
        a, b = cur[len(cur) - 1], new[len(cur) - 1]
        return (int(a.num_leaves) == int(b.num_leaves) and
                np.array_equal(np.asarray(a.leaf_value),
                               np.asarray(b.leaf_value)))

    def _pump_once(self) -> bool:
        from ..robustness.checkpoint import (latest_valid_checkpoint,
                                             list_checkpoints)
        # cheap no-op gate first: the iteration is in the FILENAME, so
        # an idle tick never re-reads and CRC-hashes a multi-MB
        # checkpoint just to conclude nothing is new
        newest = list_checkpoints(self.ckpt_dir)
        if not newest or newest[0][0] <= self._served_iteration:
            return False
        found = latest_valid_checkpoint(self.ckpt_dir)
        if found is None:
            return False
        _path, state = found
        it = int(state.get("iteration", 0))
        if it <= self._served_iteration:
            return False
        eng = self._booster._engine
        prev_len = len(eng.models)
        mutated = self._append_increment(state["model"])
        if mutated is None and not eng.models:
            return False               # empty checkpoint: nothing to serve
        # the mark must exist BEFORE the generation can serve a request
        # (the pump owns publishing, so the next version is known)
        next_version = self._server.generation.version + 1
        self._set_mark(next_version, state)
        try:
            gen = self._server.publish()
        except Exception as e:     # noqa: BLE001 — rollback keeps serving
            self.publish_errors += 1
            self._drop_mark(next_version)
            # undo a tail append so the retry next tick re-grafts the
            # SAME extension instead of misreading the already-extended
            # engine as a prefix mismatch and forcing a full repack; a
            # failed full replace stays (the retry publishes it as-is)
            if mutated == "append":
                del eng.models[prev_len:]
            log.warning(f"publish pump: hot-swap failed ({e!r}); still "
                        "serving the previous generation")
            return False
        self._served_iteration = it
        self.publishes += 1
        return True

    def _pump_loop(self) -> None:
        while not self._stop.wait(self.poll_sec):
            try:
                self._pump_once()
            except Exception as e:  # noqa: BLE001 — pump must survive
                self.publish_errors += 1
                log.warning(f"publish pump error: {e!r}")

    # -- gateway surface (front door) ----------------------------------
    def submit(self, X, deadline_ms=None, tenant: Optional[str] = None,
               kind: str = "score"):
        if tenant is not None:
            raise KeyError(tenant)     # solo service has no tenants
        return self._server.submit(X, deadline_ms=deadline_ms, kind=kind)

    def predict(self, X, timeout: Optional[float] = None):
        return self._server.predict(X, timeout=timeout)

    def freshness(self, version: int) -> Optional[dict]:
        with self._mark_lock:
            return self._marks.get(int(version))

    @property
    def generation(self):
        return self._server.generation

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def degraded(self) -> bool:
        return bool(self._server.stats().get("degraded"))

    def stats(self) -> dict:
        s = self._server.stats()
        s["service"] = {
            "trainer": self.trainer.describe(),
            "served_iteration": self._served_iteration,
            "publishes": self.publishes,
            "publish_errors": self.publish_errors,
            "watermark": self.freshness(self.generation.version),
        }
        s.update({f"staleness_{k}": v
                  for k, v in self.staleness.summary_ms().items()})
        return s

    # -- lifecycle -----------------------------------------------------
    def close(self, timeout: Optional[float] = 30.0) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if getattr(self, "frontdoor", None) is not None:
            self.frontdoor.close()
        if getattr(self, "trainer", None) is not None:
            self.trainer.stop()
        if getattr(self, "_pump", None) is not None:
            self._pump.join(timeout)
        if getattr(self, "_server", None) is not None:
            self._server.close(timeout)

    def __enter__(self) -> "ContinualService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_continual(params: Dict, stream_path: str, ckpt_dir: str,
                    **kwargs) -> ContinualService:
    """Boot the full continual-learning service (resident trainer +
    publish pump + HTTP front door) and return it once serving."""
    return ContinualService(params, stream_path, ckpt_dir, **kwargs)
