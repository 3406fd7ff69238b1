"""Resident trainer loop — the training half of the continual service.

Port of ``lightgbm_tpu/service/trainer.py`` (ref: the reference's
resident task loop, src/application/application.cpp):

- :func:`run_resident_trainer` boosts forever (or to a target) on a
  ROLLING WINDOW of fresh rows tail-followed from a growing stream file
  (``io/stream_loader.StreamFollower``). Each cycle re-bins the current
  window and continues the model through its text
  (``init_model=Booster(model_str=...)``), the path a checkpoint resume
  takes, so every tree's thresholds rebind to the fresh window's bin
  space and a relaunch continues bit for bit from the same checkpoint.
- Every ``publish_every_iters`` iterations it commits a CRC-validated
  atomic checkpoint (``robustness/checkpoint.py``) carrying the model and
  the service watermark (rows ingested, the wall clock of the newest row
  the window saw). The checkpoint directory IS the publish channel: the
  serving process's publish pump tails it and hot-swaps each new
  generation into the live server. A trainer that dies mid-write leaves
  the previous checkpoints intact, so the serving side never reads a
  torn model.
- Under supervision (:class:`TrainerSupervisor`) the loop runs in a
  child process with the heartbeat installed; a crash or a classified
  stall costs one bounded relaunch-and-resume while the front door keeps
  serving the last published generation. The child runs on the device
  its spec's params name (``device_type``, ``cuda`` by default): on the
  card it owns a CUDA context of its own beside the serving process's.

The injected ``rank_kill`` fault (``robustness/faults.py``) fires at the
boosting iteration boundary inside this loop (``models/gbdt.py``
``train_one_iter``; the resident trainer is rank 0 of a one-rank gang).

Run the child by hand: ``python -m lightgbm_tpu_torch.service.trainer
SPEC`` (the spec's JSON, or the path of a file holding it).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..utils import log

STATE_KEY = "service"          # checkpoint sub-dict carrying the watermark
EXIT_TARGET_REACHED = 0


@dataclasses.dataclass
class TrainerSpec:
    """Everything the resident trainer needs — JSON-serializable so the
    supervised child can be handed the spec on argv."""

    params: Dict                  # training params (num_leaves, obj, ...)
    stream_path: str              # growing CSV of [label, features...]
    ckpt_dir: str                 # checkpoint/publish directory
    label_col: int = 0
    window_rows: int = 8192      # rolling training window
    window_floor_rows: int = 1024  # OOM auto-shrink floor
    min_rows: int = 256          # first fit waits for this many rows
    iters_per_cycle: int = 4     # boosting rounds per window refresh
    publish_every_iters: int = 4  # checkpoint/publish cadence
    target_iterations: int = 0   # 0 = run until stopped
    poll_sec: float = 0.2        # stream poll cadence
    keep_last: int = 3           # checkpoint retention
    sep: str = ","

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, blob: str) -> "TrainerSpec":
        return cls(**json.loads(blob))


def _split_window(window: np.ndarray, label_col: int):
    y = np.ascontiguousarray(window[:, label_col], np.float32)
    X = np.ascontiguousarray(
        np.delete(window, label_col, axis=1), np.float32)
    return X, y


def run_resident_trainer(spec: TrainerSpec,
                         stop: Optional[threading.Event] = None,
                         on_cycle: Optional[Callable] = None) -> int:
    """The loop body (runs in-thread or as the supervised child).

    Resume contract: the newest CRC-valid checkpoint in ``ckpt_dir``
    wins — model text, iteration count and the stream watermark all
    come from it, and the rolling window is rebuilt from the stream
    tail, so a relaunched trainer continues the SAME model (bit for bit
    through the text) on the freshest data. Returns 0 when
    ``target_iterations`` is reached or ``stop`` is set.
    """
    from ..basic import Booster, Dataset
    from ..engine import train
    from ..io.stream_loader import StreamFollower
    from ..robustness import checkpoint as ckpt
    from ..robustness import faults, heartbeat
    from ..robustness.retry import is_corruption_error, is_oom_error

    heartbeat.install_from_env()
    heartbeat.beat("boot", 0)
    follower = StreamFollower(spec.stream_path, sep=spec.sep)
    window: Optional[np.ndarray] = None
    model_str: Optional[str] = None
    iteration = 0
    # memory-pressure auto-shrink: the EFFECTIVE rolling window, halved
    # on an OOM'd cycle down to the floor and grown back after sustained
    # pressure-free cycles — a freshness regression, never a crash loop
    win_rows = int(spec.window_rows)
    win_floor = max(1, min(int(spec.window_floor_rows), win_rows))
    ok_cycles = 0
    shrink_warned = False
    # numeric-health rollback: consecutive cycles refused as
    # DATA_CORRUPTION — one refusal retries the SAME window against the
    # rolled-back model (a transient poisoning replays clean and bit for
    # bit); a second in a row condemns the window itself and training
    # resumes PAST it on fresh stream rows
    corrupt_cycles = 0
    # the resident trainer trains under the numeric-health guard unless
    # the operator disabled it: a long-lived unattended loop must refuse
    # poisoned iterations instead of committing them to the publish
    # channel
    params = dict(spec.params)
    params.setdefault("tpu_integrity_numeric_guard", True)

    found = ckpt.latest_valid_checkpoint(spec.ckpt_dir)
    if found is not None:
        _path, state = found
        model_str = state["model"]
        iteration = int(state["iteration"])
        svc = state.get(STATE_KEY) or {}
        # restore the stream cursor, rewound by about one window of bytes
        # so the rolling window refills from the tail instead of
        # re-parsing the whole stream from byte 0 or waiting for min_rows
        # of NEW rows. rows_seen stays the checkpointed value less the
        # rewind (the watermark is monitoring, not accounting).
        offset = int(svc.get("stream_offset", 0))
        rows_seen = int(svc.get("watermark_rows", 0))
        # the poison-row count survives relaunch: a relaunched trainer
        # must not report skipped_rows=0 while the .deadletter sidecar
        # holds quarantined lines
        follower.rows_skipped = int(svc.get("skipped_rows", 0))
        if offset > 0 and rows_seen > 0:
            bytes_per_row = max(offset // rows_seen, 1)
            rewind = min(offset,
                         int(spec.window_rows * bytes_per_row * 1.25))
            follower.offset = offset - rewind
            follower.rows_seen = max(rows_seen -
                                     rewind // bytes_per_row, 0)
            # re-anchor on a line boundary (the rewound offset lands
            # mid-line almost surely)
            try:
                with open(spec.stream_path, "rb") as f:
                    f.seek(follower.offset)
                    if follower.offset:
                        f.readline()          # discard the partial line
                    follower.offset = f.tell()
            except OSError:
                follower.offset = 0
        log.info(f"resident trainer resuming at iteration {iteration} "
                 f"from {_path} (stream cursor {follower.offset})")

    def drain() -> None:
        nonlocal window
        while True:
            fresh = follower.poll()
            if fresh is None or not len(fresh):
                return
            window = fresh if window is None else \
                np.concatenate([window, fresh], axis=0)
            if len(window) > win_rows:
                window = window[-win_rows:]
            # a large backlog drains in many polls: keep beating so
            # catch-up reads as alive, never as a stall
            heartbeat.beat("ingest", int(follower.rows_seen))

    def wait_for_window() -> bool:
        """Block until the rolling window holds ``min_rows`` (False =
        stop requested). Used for the first window AND to refill after
        a condemned-window rollback drops the poisoned rows."""
        while True:
            drain()
            if window is not None and len(window) >= spec.min_rows:
                return True
            if stop is not None and stop.is_set():
                return False
            heartbeat.beat("waiting_for_rows",
                           0 if window is None else len(window))
            time.sleep(spec.poll_sec)

    # first window: wait for min_rows (a resume re-reads the stream tail;
    # the window is not checkpointed — fresh rows are better training
    # data than the dead trainer's snapshot)
    if not wait_for_window():
        return 0

    def commit(booster) -> None:
        state = ckpt.booster_state(booster, iteration)
        state[STATE_KEY] = {
            "watermark_rows": int(follower.rows_seen),
            "watermark_ts": float(follower.last_row_time or time.time()),
            "stream_offset": int(follower.offset),
            "window_rows": int(len(window)),
            "window_rows_target": int(win_rows),
            "skipped_rows": int(follower.rows_skipped),
        }
        # keep_last rides into the writer for the full-disk path: it
        # prunes beyond the retention floor and retries the write once
        ckpt.write_checkpoint(spec.ckpt_dir, state,
                              keep_last=spec.keep_last)
        ckpt.prune_checkpoints(spec.ckpt_dir, spec.keep_last)

    last_commit = iteration
    while True:
        if stop is not None and stop.is_set():
            return 0
        if spec.target_iterations and iteration >= spec.target_iterations:
            log.info(f"resident trainer reached the "
                     f"{spec.target_iterations}-iteration target")
            return EXIT_TARGET_REACHED
        drain()
        heartbeat.beat("cycle", iteration)
        k = spec.iters_per_cycle
        if spec.target_iterations:
            k = min(k, spec.target_iterations - iteration)
        try:
            faults.maybe_fail("oom")       # the re-bin oom site
            X, y = _split_window(window, spec.label_col)
            init = (Booster(params=params, model_str=model_str)
                    if model_str is not None else None)
            booster = train(dict(params), Dataset(X, label=y),
                            num_boost_round=k, init_model=init)
        except BaseException as e:  # noqa: BLE001 — classifier decides
            if is_corruption_error(e):
                # the cycle was refused as DATA_CORRUPTION (NaN
                # gradients, poisoned leaves, a loss spike): roll back to
                # the newest CRC-valid checkpoint — the publish channel
                # never saw the poisoned trees — and retry; a second
                # refusal in a row condemns the window and resumes past it
                corrupt_cycles += 1
                found = ckpt.latest_valid_checkpoint(spec.ckpt_dir)
                if found is not None:
                    model_str = found[1]["model"]
                    iteration = int(found[1]["iteration"])
                else:
                    model_str, iteration = None, 0
                last_commit = iteration
                log.warning(
                    f"resident trainer cycle refused as corrupt ({e}); "
                    "rolled back to the newest CRC-valid checkpoint "
                    f"(iteration {iteration})")
                if corrupt_cycles >= 2:
                    log.warning(
                        "second consecutive corrupt cycle: condemning "
                        f"the {len(window)}-row rolling window and "
                        "resuming past it on fresh stream rows")
                    window = None
                    corrupt_cycles = 0
                    if not wait_for_window():
                        return 0
                continue
            # window auto-shrink: an OOM'd re-bin/train cycle halves the
            # rolling window down to the floor and keeps publishing; at
            # the floor a genuine exhaustion is re-raised
            if not is_oom_error(e) or win_rows <= win_floor:
                raise
            win_rows = max(win_rows // 2, win_floor)
            ok_cycles = 0
            if len(window) > win_rows:
                window = window[-win_rows:]
            if not shrink_warned:
                shrink_warned = True
                log.warning(
                    f"resident trainer cycle OOM'd ({e!r}); rolling "
                    f"window halved to {win_rows} rows (floor "
                    f"{win_floor}) — training continues on less "
                    "history; the window grows back when pressure "
                    "clears (warned once)")
            else:
                log.info(f"trainer cycle OOM'd again; window now "
                         f"{win_rows} rows")
            continue
        iteration = booster.current_iteration()
        model_str = booster.model_to_string()
        corrupt_cycles = 0
        if win_rows < spec.window_rows:
            # pressure-clear recovery: grow the window back after a few
            # clean cycles in a row
            ok_cycles += 1
            if ok_cycles >= 4:
                ok_cycles = 0
                win_rows = min(win_rows * 2, int(spec.window_rows))
                log.info(f"memory pressure cleared: rolling window "
                         f"grown back to {win_rows} rows")
        if iteration - last_commit >= spec.publish_every_iters or \
                (spec.target_iterations and
                 iteration >= spec.target_iterations):
            commit(booster)
            last_commit = iteration
        if on_cycle is not None:
            on_cycle(iteration, follower)
        # pace the loop only when the stream is dry (pending fresh rows
        # are trained on, not slept through)
        try:
            dry = os.path.getsize(spec.stream_path) <= follower.offset
        except OSError:
            dry = True
        if dry:
            if stop is not None:
                if stop.wait(spec.poll_sec):
                    return 0
            else:
                time.sleep(spec.poll_sec)


class ThreadTrainer:
    """In-process resident trainer (tests, single-process deployments).
    Its crash domain is the serving process; use
    :class:`TrainerSupervisor` when a trainer death must not take the
    front door down."""

    def __init__(self, spec: TrainerSpec):
        self.spec = spec
        self._stop = threading.Event()
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="lgbm-resident-trainer")
        self._thread.start()

    def _run(self) -> None:
        try:
            run_resident_trainer(self.spec, stop=self._stop)
        except BaseException as e:     # noqa: BLE001 — surfaced in stats
            self.error = e
            log.warning(f"resident trainer thread died: {e!r}")

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    @property
    def relaunches(self) -> int:
        return 0

    def describe(self) -> dict:
        d = {"mode": "thread", "alive": self.alive, "relaunches": 0}
        if self.error is not None:
            d["error"] = repr(self.error)
        return d

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        self._thread.join(timeout)


class TrainerSupervisor:
    """Supervised subprocess trainer with bounded auto-relaunch — the
    gang's discipline applied to one resident rank.

    The child runs :func:`run_resident_trainer` under the heartbeat; the
    supervisor watches it with ``robustness.supervisor.watch_child``
    (phase-aware stall classification, SIGTERM, never SIGKILL). Any
    death — a crash, an injected ``rank_kill``, a classified stall —
    costs one relaunch that resumes from the newest committed
    checkpoint, up to ``max_relaunches`` (``LGBM_TPU_TRAINER_RELAUNCHES``,
    default 2); the serving tier keeps answering on the last published
    generation throughout.

    ``attempt_env(i)`` (0-based) arms faults on one launch, e.g.
    ``{"LGBM_TPU_FAULTS": "rank_kill:after=2"}`` on attempt 0 only.
    """

    def __init__(self, spec: TrainerSpec,
                 max_relaunches: Optional[int] = None,
                 attempt_env: Optional[Callable[[int], Dict]] = None,
                 heartbeat_base: Optional[str] = None):
        from ..robustness.heartbeat import ENV_HEARTBEAT
        self.spec = spec
        if max_relaunches is None:
            max_relaunches = int(os.environ.get(
                "LGBM_TPU_TRAINER_RELAUNCHES", "2"))
        self.max_relaunches = int(max_relaunches)
        self._attempt_env = attempt_env
        self._hb_env = ENV_HEARTBEAT
        self._hb_base = heartbeat_base or os.path.join(
            spec.ckpt_dir, "trainer.hb")
        self.relaunches = 0
        self.attempt = 0
        self.last_rc: Optional[int] = None
        self.error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._proc: Optional[subprocess.Popen] = None
        self._lock = threading.Lock()
        os.makedirs(spec.ckpt_dir, exist_ok=True)
        self._thread = threading.Thread(
            target=self._supervise, daemon=True,
            name="lgbm-trainer-supervisor")
        self._thread.start()

    # -- child management ---------------------------------------------
    def _hb_path(self, attempt: int) -> str:
        # a fresh file per attempt: a dead attempt's stale beats must
        # never be read as this attempt's liveness
        return f"{self._hb_base}.{attempt}"

    def _launch(self) -> subprocess.Popen:
        env = dict(os.environ)
        env[self._hb_env] = self._hb_path(self.attempt)
        # the child must import the package the way this process did
        # (often a bare sys.path insert, not an install): prepend the
        # package root to PYTHONPATH, never overwrite it
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        parts = [pkg_root] + [p for p in
                              env.get("PYTHONPATH", "").split(os.pathsep)
                              if p and p != pkg_root]
        env["PYTHONPATH"] = os.pathsep.join(parts)
        if self._attempt_env is not None:
            env.update({k: str(v) for k, v in
                        (self._attempt_env(self.attempt) or {}).items()})
        cmd = [sys.executable, "-m", "lightgbm_tpu_torch.service.trainer",
               self.spec.to_json()]
        log.info(f"launching resident trainer (attempt {self.attempt})")
        # stderr lands in the checkpoint dir: a child that dies before
        # its first heartbeat must leave a diagnosable trace
        self._err_path = os.path.join(
            self.spec.ckpt_dir, f"trainer.{self.attempt}.err")
        errf = open(self._err_path, "wb")
        try:
            return subprocess.Popen(cmd, env=env,
                                    stdout=subprocess.DEVNULL,
                                    stderr=errf)
        finally:
            errf.close()          # the child holds its own fd

    def _supervise(self) -> None:
        from ..robustness.heartbeat import DeviceStallError, StallPolicy
        from ..robustness.supervisor import watch_child
        policy = StallPolicy.from_env()
        while not self._stop.is_set():
            with self._lock:
                if self._stop.is_set():
                    return
                self._proc = proc = self._launch()
            try:
                rc = watch_child(proc, self._hb_path(self.attempt),
                                 policy=policy, poll=0.5,
                                 label="resident trainer")
            except DeviceStallError as e:
                rc = None
                self.error = e
            self.last_rc = rc
            if self._stop.is_set():
                return
            if rc == 0:
                return                      # target reached: clean exit
            if self.relaunches >= self.max_relaunches:
                log.warning(
                    f"resident trainer died (rc={rc}) with no relaunch "
                    f"budget left ({self.relaunches}/"
                    f"{self.max_relaunches}); serving continues on the "
                    "last published generation")
                return
            self.relaunches += 1
            self.attempt += 1
            log.warning(f"resident trainer died (rc={rc}); relaunching "
                        f"({self.relaunches}/{self.max_relaunches}) — "
                        "resume from the newest committed checkpoint")

    @property
    def alive(self) -> bool:
        if self._thread.is_alive():
            return True
        p = self._proc
        return p is not None and p.poll() is None

    def describe(self) -> dict:
        d = {"mode": "process", "alive": self.alive,
             "relaunches": self.relaunches, "attempt": self.attempt}
        if self.last_rc is not None:
            d["last_rc"] = self.last_rc
        if self.error is not None:
            d["error"] = repr(self.error)
        err_path = getattr(self, "_err_path", None)
        if err_path and not self.alive:
            try:
                with open(err_path, "rb") as f:
                    tail = f.read()[-2048:].decode("utf-8", "replace")
                if tail.strip():
                    d["stderr_tail"] = tail.strip()[-500:]
            except OSError:
                pass
        return d

    def stop(self, timeout: float = 30.0) -> None:
        from ..robustness.supervisor import terminate_gently
        self._stop.set()
        with self._lock:
            proc = self._proc
        if proc is not None and proc.poll() is None:
            terminate_gently(proc, timeout, "resident trainer")
        self._thread.join(timeout)


def main(argv: Optional[List[str]] = None) -> int:
    """Child entry: ``python -m lightgbm_tpu_torch.service.trainer
    '<spec json>'`` (or a path to a spec file)."""
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: python -m lightgbm_tpu_torch.service.trainer "
              "<spec-json-or-path>", file=sys.stderr)
        return 2
    blob = argv[0]
    if os.path.exists(blob):
        with open(blob, encoding="utf-8") as f:
            blob = f.read()
    spec = TrainerSpec.from_json(blob)
    return run_resident_trainer(spec)


if __name__ == "__main__":
    sys.exit(main())
