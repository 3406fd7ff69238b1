"""The supervised training gang and its manifests.

Port of ``lightgbm_tpu/robustness/gang.py``, with its file formats, its
environment variables and its messages, so a gang directory written by
one package resumes in the other:

- **Per-rank supervision** (:class:`GangSupervisor`): each rank writes
  the phase-tagged heartbeats of :mod:`.heartbeat` to its own file
  (:func:`~.heartbeat.rank_path`; ``models/gbdt.py`` and the sharded
  ingest pick that path from ``LGBM_TPU_HEARTBEAT`` in a world of more
  than one). The supervisor is ``supervisor.watch_child`` for N
  children: it classifies each rank alive, stalled, silent or dead under
  the shared :class:`~.heartbeat.StallPolicy`, and on a death or a
  classified stall SIGTERMs the survivors, instead of leaving them
  blocked in a collective, and raises :class:`GangError` with each
  rank's diagnosis (last phase, beat age, exit code).
- **Gang manifests**: a sharded run commits a manifest beside each
  checkpoint (world size, each rank's rows, each rank's shard-content
  digest from ``io/dataset_core.ShardInfo``, the checkpoint it
  commits), written atomically with a CRC footer after its checkpoint.
  :func:`latest_valid_manifest` skips a manifest whose CRC fails or
  whose checkpoint is missing, corrupt or of another iteration (a torn
  commit); :func:`validate_and_select_resume` refuses a checkpoint set
  of another world size or another sharding, with each rank's
  diagnosis.
- **Relaunch** (:func:`run_supervised`, also
  ``distributed.launch_local(supervised=True)``): a failed gang is
  relaunched whole under a bounded :class:`~.retry.RetryPolicy`; each
  rank resumes from the newest valid manifest through its own
  ``resume_from=``, so a rank's death costs one resume. :class:`GangError`
  carries ``DEADLINE_EXCEEDED``, so ``retry.is_transient_error`` files
  it as transient.

A rank blocked on a dead peer's collective raises
``distributed.CollectiveTimeout`` within its deadline; a rank wedged in
a device sync is ended by the in-training watchdog (``EXIT_STALLED``),
which this supervisor classifies.

Nothing here imports torch: a supervisor never initializes the device
it supervises.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

from ..utils import log
from . import checkpoint as _ckpt
from . import faults
from .heartbeat import (ALIVE, SILENT, STALLED, WAITING,  # noqa: F401
                        EXIT_STALLED, HeartbeatRecord, StallPolicy,
                        rank_path, read)
from .retry import RetryPolicy, retry_call

__all__ = [
    "GangError", "GangTimeout", "GangSupervisor", "run_supervised",
    "rank_diagnosis", "MANIFEST_MAGIC", "manifest_name",
    "write_manifest", "read_manifest", "list_manifests",
    "latest_valid_manifest", "prune_manifests",
    "validate_and_select_resume", "ENV_GANG_RELAUNCHES",
]

# how many RELAUNCHES a supervised gang earns after its first attempt
# (total attempts = relaunches + 1); run_supervised(attempts=) overrides
ENV_GANG_RELAUNCHES = "LGBM_TPU_GANG_RELAUNCHES"
DEFAULT_GANG_RELAUNCHES = 2


class GangError(Exception):
    """The gang failed as a unit: a rank died, self-watchdogged, was
    classified hung, or the gang overran its deadline. Survivors were
    SIGTERMed. The message carries ``DEADLINE_EXCEEDED``, so
    ``retry.is_transient_error`` files it as transient and
    :func:`run_supervised` relaunches under bounded attempts.

    ``reports`` holds one ``(rank, rc, HeartbeatRecord or None)`` a rank
    (rc None: still alive when the gang was torn down)."""

    def __init__(self, msg: str,
                 reports: Sequence[Tuple[int, Optional[int],
                                         Optional[HeartbeatRecord]]] = ()):
        super().__init__(f"DEADLINE_EXCEEDED: {msg}")
        self.reports = list(reports)


class GangTimeout(subprocess.TimeoutExpired):
    """The unsupervised gang outlived its timeout; ``diagnosis`` holds
    each rank's exit state and last heartbeat. A ``TimeoutExpired``, so
    callers that catch that still catch it."""

    def __init__(self, cmd, timeout: float, diagnosis: str = ""):
        super().__init__(cmd, timeout)
        self.diagnosis = diagnosis

    def __str__(self) -> str:
        base = super().__str__()
        return f"{base}\n{self.diagnosis}" if self.diagnosis else base


# ---------------------------------------------------------------------------
# Per-rank diagnosis
# ---------------------------------------------------------------------------

def _describe_rc(rc: Optional[int]) -> str:
    if rc is None:
        return "alive"
    if rc == EXIT_STALLED:
        return f"rc={rc} (self-watchdogged: wedged at a device sync)"
    if rc == faults.EXIT_RANK_KILLED:
        return f"rc={rc} (injected rank_kill)"
    return f"rc={rc}"


def rank_diagnosis(hb_paths: Sequence[str],
                   rcs: Optional[Sequence[Optional[int]]] = None,
                   clock: Callable[[], float] = time.monotonic) -> str:
    """One line a rank: exit state, last phase and progress, beat and
    keepalive ages. Heartbeat times are CLOCK_MONOTONIC, system-wide on
    Linux, so the ages compare with the writers' clocks."""
    now = clock()
    lines = []
    for r, path in enumerate(hb_paths):
        state = _describe_rc(rcs[r] if rcs is not None else None)
        rec = read(path)
        if rec is None:
            lines.append(f"  rank {r}: {state}; no heartbeat written "
                         f"({path})")
        else:
            lines.append(
                f"  rank {r}: {state}; last phase {rec.phase!r}/"
                f"{rec.progress}, beat {now - rec.t:.1f}s ago, "
                f"keepalive {now - rec.ka:.1f}s ago (pid {rec.pid})")
    return "\n".join(lines)


def gang_hb_paths(hb_base: str, world: int) -> List[str]:
    """The heartbeat paths of a gang's ranks: the bare base for a world
    of one, ``rank_path(base, r)`` otherwise, the convention the ranks
    write by."""
    if world <= 1:
        return [hb_base]
    return [rank_path(hb_base, r) for r in range(world)]


# ---------------------------------------------------------------------------
# GangSupervisor: watch_child for N ranks
# ---------------------------------------------------------------------------

class GangSupervisor:
    """Supervise a gang of rank processes by their heartbeats.

    ``procs`` are ``subprocess.Popen``-likes in rank order (``poll``,
    ``pid``, ``terminate``, ``stdout``; tests pass fakes). Daemon threads
    drain their output, so a chatty rank never blocks on a full pipe.

    :meth:`watch` returns ``[(rc, output), ...]`` when every rank exits
    0, and raises :class:`GangError`, after SIGTERMing the survivors,
    when a rank exits non-zero, self-watchdogs (:data:`EXIT_STALLED`),
    is classified stalled or silent, or the gang's deadline passes.
    SIGKILL follows the grace period only with ``escalate_kill`` (off by
    default): a rank that outlives SIGTERM is reported, not hidden.
    """

    def __init__(self, procs: Sequence, hb_base: str,
                 hb_paths: Optional[Sequence[str]] = None,
                 policy: Optional[StallPolicy] = None,
                 poll: float = 0.5,
                 label: str = "gang",
                 term_grace: float = 15.0,
                 escalate_kill: bool = False,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 on_status: Optional[Callable] = None):
        self.procs = list(procs)
        n = len(self.procs)
        self.hb_paths = (list(hb_paths) if hb_paths is not None
                         else gang_hb_paths(hb_base, n))
        if len(self.hb_paths) != n:
            raise ValueError(
                f"{len(self.hb_paths)} heartbeat paths for {n} ranks")
        self.policy = policy if policy is not None else \
            StallPolicy.from_env()
        self.poll = float(poll)
        self.label = label
        self.term_grace = float(term_grace)
        self.escalate_kill = bool(escalate_kill)
        self.clock = clock
        self.sleep = sleep
        self.on_status = on_status
        # when the survivors were sent SIGTERM and when the last of them
        # exited (clock() seconds): the teardown's cost, read only by
        # measurement (run_supervised's ``supervisors``)
        self.terminated_at: Optional[float] = None
        self.drained_at: Optional[float] = None
        self._outputs: List[List[str]] = [[] for _ in range(n)]
        self._readers: List[Optional[threading.Thread]] = [None] * n
        for r, p in enumerate(self.procs):
            if getattr(p, "stdout", None) is not None:
                t = threading.Thread(target=self._drain, args=(r,),
                                     name=f"lgbm-gang-out-r{r}",
                                     daemon=True)
                t.start()
                self._readers[r] = t

    def _drain(self, r: int) -> None:
        try:
            for line in self.procs[r].stdout:
                self._outputs[r].append(line)
        except (OSError, ValueError):   # pipe torn down mid-read
            pass

    def output(self, r: int) -> str:
        return "".join(self._outputs[r])

    def _join_readers(self, timeout: float = 2.0) -> None:
        for t in self._readers:
            if t is not None:
                t.join(timeout=timeout)

    # -- teardown ------------------------------------------------------
    def _terminate_all(self, rcs: List[Optional[int]]) -> None:
        """SIGTERM every live rank and wait up to ``term_grace`` for the
        gang to drain; a rank still running after it is SIGKILLed under
        ``escalate_kill`` and otherwise left running, with a warning."""
        self.terminated_at = self.clock()
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        deadline = self.clock() + max(self.term_grace, 1.0)
        while self.clock() < deadline:
            if all(p.poll() is not None for p in self.procs):
                break
            self.sleep(min(self.poll, 0.2))
        self.drained_at = self.clock()
        for r, p in enumerate(self.procs):
            rcs[r] = p.poll()
            if rcs[r] is None:
                if self.escalate_kill:
                    log.warning(
                        f"{self.label}: rank {r} (pid={p.pid}) ignored "
                        f"SIGTERM for {self.term_grace:.0f}s; "
                        "escalating to SIGKILL")
                    try:
                        p.kill()
                        p.wait(timeout=5.0)
                        rcs[r] = p.poll()
                    except (OSError, subprocess.TimeoutExpired):
                        pass
                else:
                    log.warning(
                        f"{self.label}: rank {r} (pid={p.pid}) ignored "
                        f"SIGTERM for {self.term_grace:.0f}s; leaving "
                        "it running (no SIGKILL)")

    def _fail(self, reason: str, rcs: List[Optional[int]]) -> None:
        self._terminate_all(rcs)
        self._join_readers()
        diag = rank_diagnosis(self.hb_paths, rcs, clock=self.clock)
        reports = [(r, rcs[r], read(self.hb_paths[r]))
                   for r in range(len(self.procs))]
        raise GangError(
            f"{self.label}: {reason}; survivors SIGTERMed. "
            f"Per-rank diagnosis:\n{diag}", reports)

    # -- the watch loop ------------------------------------------------
    def watch(self, timeout: Optional[float] = None) -> List[Tuple[int,
                                                                   str]]:
        n = len(self.procs)
        start = self.clock()
        deadline = start + timeout if timeout else None
        rcs: List[Optional[int]] = [None] * n
        stall_since: List[Optional[float]] = [None] * n
        last_verdict = [WAITING] * n
        while True:
            for r, p in enumerate(self.procs):
                if rcs[r] is None:
                    rc = p.poll()
                    if rc is None:
                        continue
                    rcs[r] = rc
                    if rc == EXIT_STALLED:
                        self._fail(f"rank {r} self-watchdogged "
                                   f"(rc={EXIT_STALLED}: its loop was "
                                   "wedged at a device sync)", rcs)
                    if rc != 0:
                        self._fail(f"rank {r} died ({_describe_rc(rc)})",
                                   rcs)
            if all(rc is not None for rc in rcs):
                self._join_readers()
                return [(rcs[r], self.output(r)) for r in range(n)]
            now = self.clock()
            for r, p in enumerate(self.procs):
                if rcs[r] is not None:
                    continue
                rec = read(self.hb_paths[r])
                verdict = self.policy.classify(rec, now, start)
                if verdict != last_verdict[r]:
                    if self.on_status is not None:
                        self.on_status(r, verdict, rec)
                    last_verdict[r] = verdict
                if verdict in (STALLED, SILENT):
                    if stall_since[r] is None:
                        stall_since[r] = now
                    # one poll of hysteresis: a beat landing between the
                    # read and the verdict must not tear the gang down
                    elif now - stall_since[r] >= self.poll:
                        phase = rec.phase if rec is not None else \
                            "<no heartbeat>"
                        self._fail(
                            f"rank {r} (pid={p.pid}) classified hung: "
                            f"{verdict} in phase {phase!r}", rcs)
                else:
                    stall_since[r] = None
            if deadline is not None and now >= deadline:
                self._fail(f"gang exceeded its {timeout:.0f}s deadline",
                           rcs)
            self.sleep(self.poll)


# ---------------------------------------------------------------------------
# Relaunch: one rank's death costs one resume
# ---------------------------------------------------------------------------

def default_attempts(env=None) -> int:
    e = env if env is not None else os.environ
    v = (e.get(ENV_GANG_RELAUNCHES) or "").strip()
    relaunches = int(v) if v else DEFAULT_GANG_RELAUNCHES
    return max(1, relaunches + 1)


def run_supervised(argv: Sequence[str], num_processes: int, *,
                   cpu_devices_per_process: int = 0,
                   coordinator_port: Optional[int] = None,
                   timeout: float = 600.0,
                   env_extra: Optional[dict] = None,
                   attempts: Optional[int] = None,
                   stall_policy: Optional[StallPolicy] = None,
                   poll: float = 0.5,
                   label: str = "gang",
                   term_grace: float = 15.0,
                   escalate_kill: bool = False,
                   attempt_env: Optional[Callable[[int], dict]] = None,
                   on_status: Optional[Callable] = None,
                   backend: Optional[str] = None,
                   supervisors: Optional[list] = None
                   ) -> List[Tuple[int, str]]:
    """Launch ``argv`` x ``num_processes`` as one supervised gang and
    relaunch it whole on failure (``launch_local(supervised=True)``).

    Each attempt gets a fresh coordinator port (unless pinned) and a
    fresh heartbeat base exported as ``LGBM_TPU_HEARTBEAT`` (a dead
    attempt's stale file must never read as this attempt's silence);
    rank r writes ``rank_path(base, r)``. On :class:`GangError` the gang
    is relaunched under a bounded RetryPolicy (``attempts`` in all;
    default ``LGBM_TPU_GANG_RELAUNCHES`` + 1 = 3), and the workers resume
    from the newest valid gang manifest through their ``resume_from=``.

    ``attempt_env(i)`` (i from 0) merges environment into attempt i:
    a chaos harness injects a fault plan into the first launch only (a
    plan from the environment re-arms in every process). ``backend``
    names the ranks' ``torch.distributed`` backend. ``supervisors``, a
    list, receives each attempt's :class:`GangSupervisor`; it exists for
    measurement only (a harness reads the teardown's seconds from its
    ``terminated_at`` and ``drained_at``) and changes nothing. Returns
    ``[(rc, output), ...]`` in rank order; raises
    :class:`~.retry.RetryError` (last cause the final
    :class:`GangError`) when every attempt failed.
    """
    from ..distributed import spawn_local
    from .heartbeat import ENV_HEARTBEAT

    if attempts is None:
        attempts = default_attempts()
    hb_dir = tempfile.mkdtemp(prefix="lgbm_gang_hb_")
    counter = {"i": -1}

    def _attempt():
        counter["i"] += 1
        i = counter["i"]
        extra = dict(env_extra or {})
        if attempt_env is not None:
            extra.update({k: str(v)
                          for k, v in (attempt_env(i) or {}).items()})
        hb_base = os.path.join(hb_dir, f"attempt{i}.hb")
        extra[ENV_HEARTBEAT] = hb_base
        if i:
            log.warning(
                f"{label}: relaunching the whole gang (attempt "
                f"{i + 1}/{attempts}) — workers resume from the newest "
                "valid gang manifest")
        procs = spawn_local(
            argv, num_processes, coordinator_port=coordinator_port,
            cpu_devices_per_process=cpu_devices_per_process,
            env_extra=extra, backend=backend)
        sup = GangSupervisor(procs, hb_base, policy=stall_policy,
                             poll=poll,
                             label=f"{label} (attempt {i + 1})",
                             term_grace=term_grace,
                             escalate_kill=escalate_kill,
                             on_status=on_status)
        if supervisors is not None:
            supervisors.append(sup)
        return sup.watch(timeout=timeout)

    try:
        policy = RetryPolicy(max_attempts=attempts, base_delay=0.5,
                             max_delay=5.0, deadline=None)
        return retry_call(_attempt, policy=policy, what=label)
    finally:
        shutil.rmtree(hb_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# Gang manifests: coordinated checkpoints of sharded worlds
# ---------------------------------------------------------------------------

MANIFEST_MAGIC = "LGBM_TPU_GANG v1"
_MANIFEST_RE = re.compile(r"^gang_(\d{9})\.manifest$")


class ManifestError(_ckpt.CheckpointError):
    """A gang manifest failed validation (CRC, parse or fields)."""


def manifest_name(iteration: int) -> str:
    return f"gang_{int(iteration):09d}.manifest"


def write_manifest(directory: str, iteration: int,
                   checkpoint_name: str, shard) -> str:
    """Commit the gang manifest of ``checkpoint_name`` atomically: world
    size, each rank's rows, each rank's shard-content digest
    (``ShardInfo.digests``), a CRC footer. Written AFTER its checkpoint:
    the manifest is the commit marker, so a crash between the two
    leaves an uncommitted checkpoint that resume skips."""
    digests = getattr(shard, "digests", None)
    if not digests:
        raise ValueError("shard carries no content digests — gang "
                         "manifests require a sharded-ingest dataset")
    rec = {
        "magic": MANIFEST_MAGIC,
        "iteration": int(iteration),
        "world": int(shard.world),
        "row_counts": [int(c) for c in shard.row_counts],
        "digests": [f"{int(d) & 0xffffffff:08x}" for d in digests],
        "checkpoint": str(checkpoint_name),
    }
    path = os.path.join(directory, manifest_name(iteration))
    _ckpt.atomic_write_text(path, json.dumps(rec), crc_footer=True)
    return path


def read_manifest(path: str) -> dict:
    """Parse and CRC-check one manifest; :class:`ManifestError` on a
    torn, corrupt or foreign file."""
    try:
        body = _ckpt.read_validated_text(path)
    except _ckpt.CheckpointError as e:
        raise ManifestError(str(e))
    try:
        man = json.loads(body)
    except json.JSONDecodeError as e:
        raise ManifestError(f"{path}: bad manifest JSON: {e}")
    if man.get("magic") != MANIFEST_MAGIC:
        raise ManifestError(f"{path}: wrong magic {man.get('magic')!r}")
    for key in ("iteration", "world", "row_counts", "digests",
                "checkpoint"):
        if key not in man:
            raise ManifestError(f"{path}: missing field {key!r}")
    if len(man["digests"]) != int(man["world"]) or \
            len(man["row_counts"]) != int(man["world"]):
        raise ManifestError(
            f"{path}: per-rank fields disagree with world="
            f"{man['world']}")
    return man


def list_manifests(directory: str) -> List[Tuple[int, str]]:
    """(iteration, path) pairs, newest first (tmp litter ignored)."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        m = _MANIFEST_RE.match(name)
        if m:
            out.append((int(m.group(1)),
                        os.path.join(directory, name)))
    out.sort(reverse=True)
    return out


def latest_valid_manifest(directory: str
                          ) -> Optional[Tuple[dict, str]]:
    """The newest COMMITTED manifest: CRC-valid itself, its checkpoint
    present, CRC-valid and of the same iteration. A torn commit is
    skipped with a warning, never resumed from. Returns
    ``(manifest, checkpoint_path)`` or None."""
    for it, path in list_manifests(directory):
        try:
            man = read_manifest(path)
        except ManifestError as e:
            log.warning(f"skipping invalid gang manifest: {e}")
            continue
        ckpt_path = os.path.join(directory, man["checkpoint"])
        try:
            state = _ckpt.read_checkpoint(ckpt_path)
        except _ckpt.CheckpointError as e:
            log.warning(f"skipping uncommitted gang manifest "
                        f"{os.path.basename(path)}: its checkpoint "
                        f"failed validation ({e})")
            continue
        if int(state.get("iteration", -1)) != int(man["iteration"]):
            log.warning(
                f"skipping torn gang manifest {os.path.basename(path)}: "
                f"manifest says iteration {man['iteration']} but "
                f"{man['checkpoint']} holds iteration "
                f"{state.get('iteration')}")
            continue
        return man, ckpt_path
    return None


def prune_manifests(directory: str, keep_last: int) -> int:
    """Keep the newest ``keep_last`` manifests (and drop tmp litter), as
    the checkpoints they commit are kept."""
    return _ckpt.prune_numbered(directory, _MANIFEST_RE, keep_last)


def validate_and_select_resume(directory: str, shard,
                               selected_state: Optional[dict]
                               ) -> Optional[dict]:
    """The resume gate of a sharded world (``engine.train``, on every
    rank after dataset construction: the decision depends only on the
    shared directory and this world's ``ShardInfo``, so the ranks
    agree).

    - No checkpoints: None (a fresh start).
    - Checkpoints but no committed manifest: fatal (the set cannot be
      shown to belong to this sharding; ``tpu_gang_manifest=false``
      resumes a legacy set).
    - A manifest whose world, rows or digests disagree with this world:
      fatal, naming every rank that disagrees.
    - Else the loop state of the MANIFESTED checkpoint, which may be
      older than the newest raw one (``selected_state``) when the newest
      write's commit was torn: every rank and every relaunch restart at
      the same iteration.
    """
    have_ckpts = bool(_ckpt.list_checkpoints(directory))
    found = latest_valid_manifest(directory)
    if found is None:
        if have_ckpts:
            log.fatal(
                f"resume_from={directory!r}: the checkpoint set has no "
                "valid committed gang manifest, so it cannot be "
                "verified to belong to this sharded world "
                f"(world={shard.world}). Refusing to resume — a "
                "mixed-world or different-sharding resume silently "
                "trains on wrong data. Set tpu_gang_manifest=false "
                "only to resume a trusted legacy (pre-manifest) set.")
        return None
    man, ckpt_path = found
    if int(man["world"]) != int(shard.world):
        log.fatal(
            f"resume_from={directory!r}: gang manifest "
            f"{manifest_name(int(man['iteration']))} was written by a "
            f"world of {man['world']} but this gang has world="
            f"{shard.world} — refusing a mixed-world resume "
            "(relaunch with the original world size, or start fresh "
            "in a new directory)")
    live_counts = [int(c) for c in shard.row_counts]
    live_digests = [int(d) & 0xffffffff
                    for d in (getattr(shard, "digests", None) or ())]
    man_counts = [int(c) for c in man["row_counts"]]
    man_digests = [int(d, 16) for d in man["digests"]]
    bad = []
    for r in range(int(man["world"])):
        problems = []
        if man_counts[r] != live_counts[r]:
            problems.append(f"rows {man_counts[r]} != {live_counts[r]}")
        if live_digests and man_digests[r] != live_digests[r]:
            problems.append(f"shard digest {man_digests[r]:08x} != "
                            f"{live_digests[r]:08x}")
        if problems:
            bad.append(f"  rank {r}: " + ", ".join(problems))
    if bad:
        log.fatal(
            f"resume_from={directory!r}: the checkpoint set belongs to "
            "a DIFFERENT sharding of the data — refusing to resume. "
            "Per-rank diagnosis (manifest vs this run):\n"
            + "\n".join(bad))
    if selected_state is not None and \
            int(selected_state.get("iteration", -1)) == \
            int(man["iteration"]):
        # the newest checkpoint IS the manifested one: keep the state
        # the caller already read
        state = selected_state
    else:
        state = _ckpt.read_checkpoint(ckpt_path)
        if selected_state is not None:
            log.warning(
                f"newest checkpoint (iteration "
                f"{selected_state.get('iteration')}) has no committed "
                f"gang manifest (torn commit); resuming from the "
                f"manifested iteration {man['iteration']} so every "
                "rank and every relaunch agree on the restart point")
    log.info(f"gang manifest validated: world={man['world']}, "
             f"resuming at iteration {man['iteration']} "
             f"({man['checkpoint']})")
    return state
