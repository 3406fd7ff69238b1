"""Atomic checkpoints of full training state, with CRC-validated resume.

Copy of ``lightgbm_tpu/robustness/checkpoint.py`` for the PyTorch/CUDA
port, with the same file format, so a checkpoint written by either
package loads in the other. The reference treats interruption as normal
(`snapshot_freq` + `input_model` continued training,
src/application/application.cpp); this module upgrades that to
crash-safe semantics:

- WRITES are atomic: payload goes to a tmp file in the target
  directory, is fsync'd, then renamed over the final name (POSIX rename
  atomicity), and the directory is fsync'd so the entry survives a
  crash. A kill at ANY byte leaves either the previous checkpoint set
  intact or a stray ``*.tmp.*`` file that recovery ignores — never a
  torn final file.
- READS are validated: every checkpoint carries a CRC32 + length
  footer over the payload; corrupt or truncated files are detected and
  skipped (with a warning) in favor of the next-newest valid one.

Checkpoint payload = one JSON "loop state" line (iteration,
best_iteration/best_score, eval history, bagging and column RNG
snapshots from models/gbdt.py) followed by the LightGBM-format model
string (io/model_io.py), so a checkpoint doubles as a loadable model
file.

The ``write_kill`` fault class (robustness/faults.py) fires mid-write —
after half the payload bytes are written, before the rename — so the
CPU tests can prove the atomicity contract.
"""
from __future__ import annotations

import errno
import json
import os
import re
import zlib
from typing import Dict, List, Optional, Tuple

from ..utils import log
from . import faults

MAGIC = "LGBM_TPU_CKPT v1"
_FOOTER_RE = re.compile(
    rb"\n#CRC32=([0-9a-f]{8}) LEN=(\d+)\n$")
_CKPT_RE = re.compile(r"^ckpt_(\d{9})\.lgbmckpt$")


class CheckpointError(Exception):
    """A checkpoint file failed validation (CRC/length/parse)."""


def _json_default(o):
    # numpy scalars inside RNG states / eval history
    for attr in ("item",):
        if hasattr(o, attr):
            return o.item()
    raise TypeError(f"not JSON-serializable: {type(o)!r}")


# ---------------------------------------------------------------------------
# Atomic writes
# ---------------------------------------------------------------------------

def atomic_write_text(path: str, text: str, crc_footer: bool = False
                      ) -> None:
    """Write ``text`` to ``path`` atomically (tmp + fsync + rename +
    dir fsync). With ``crc_footer=True`` a CRC32+length footer line is
    appended (the checkpoint validation contract).

    Honors the ``write_kill`` injected fault: the kill fires after a
    partial flush of the tmp file, before the rename — the final path
    is never touched by a killed write. The ``disk_full`` fault fires
    at the same point as ``OSError(ENOSPC)`` — a disk that filled
    mid-payload; the stale tmp file is removed (freeing what it did
    claim) and the error propagates for the caller to classify."""
    if crc_footer:
        payload = text.encode("utf-8")
        text = text + (f"\n#CRC32={zlib.crc32(payload) & 0xffffffff:08x}"
                       f" LEN={len(payload)}\n")
    data = text.encode("utf-8")
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    closed = False
    try:
        try:
            half = len(data) // 2
            os.write(fd, data[:half])
            # injected kill-9 point: partial tmp bytes are on disk,
            # final file untouched
            faults.maybe_fail("write_kill")
            # injected/real ENOSPC point: same mid-payload spot
            faults.maybe_fail("disk_full")
            os.write(fd, data[half:])
            os.fsync(fd)
        except OSError as e:
            if e.errno == errno.ENOSPC:
                # a full disk must not also LEAK the partial tmp file:
                # reclaim it so the caller's prune-and-retry has the
                # bytes it just freed
                os.close(fd)
                closed = True
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            raise
    finally:
        if not closed:
            os.close(fd)
    os.replace(tmp, path)
    dfd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


# ---------------------------------------------------------------------------
# Checkpoint format
# ---------------------------------------------------------------------------

def checkpoint_name(iteration: int) -> str:
    return f"ckpt_{int(iteration):09d}.lgbmckpt"


def write_checkpoint(directory: str, state: Dict,
                     keep_last: Optional[int] = None) -> str:
    """Atomically persist ``state`` (must carry ``iteration`` and
    ``model``; everything else is loop state) and return the path.

    Disk-full survival: an ``ENOSPC`` from the atomic writer — the
    disk filled mid-write — prunes
    checkpoints beyond ``keep_last`` (plus tmp litter) to reclaim
    space and retries ONCE; a second ENOSPC propagates loudly. The
    committed generation set is never touched by the failure: the
    atomic writer's tmp-file discipline means a failed write leaves
    every existing checkpoint intact, and the prune keeps the newest
    ``keep_last`` — the retry can only ADD a newer generation.
    ``keep_last=None`` keeps the prior fail-fast behavior (callers
    that manage retention themselves).

    The ``bitflip:where=ckpt`` fault corrupts one byte of the COMMITTED
    file after a successful write: the CRC32 footer catches it on the
    next validated read, so recovery anchors on the previous valid
    generation (tested via ``latest_valid_checkpoint``)."""
    it = int(state["iteration"])
    model = state["model"]
    loop = {k: v for k, v in state.items() if k != "model"}
    header = json.dumps({"magic": MAGIC, **loop},
                        default=_json_default)
    path = os.path.join(directory, checkpoint_name(it))
    try:
        atomic_write_text(path, header + "\n" + model, crc_footer=True)
    except OSError as e:
        if e.errno != errno.ENOSPC or keep_last is None:
            raise
        removed = prune_checkpoints(directory, max(int(keep_last), 1))
        log.warning(
            f"checkpoint write hit ENOSPC ({e}); pruned {removed} "
            f"old checkpoint file(s) beyond keep_last={keep_last} "
            "and retrying once — a second failure is fatal")
        atomic_write_text(path, header + "\n" + model, crc_footer=True)
    if faults.check("bitflip", where="ckpt"):
        _flip_committed_byte(path)
    return path


def _flip_committed_byte(path: str) -> None:
    """``bitflip:where=ckpt`` payload: XOR one mid-payload byte of the
    committed checkpoint file in place — silent at-rest corruption the
    CRC footer must catch on the next validated read."""
    try:
        with open(path, "r+b") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            pos = size // 2
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([b[0] ^ 0x01]))
        log.warning(f"injected bitflip: corrupted one byte of {path}")
    except OSError as e:   # injection best-effort; never crash a write
        log.warning(f"bitflip injection failed on {path}: {e}")


def read_validated_text(path: str) -> str:
    """CRC-validated payload of an ``atomic_write_text(crc_footer=True)``
    file. Raises CheckpointError on a missing/invalid footer, length or
    CRC mismatch.

    Works on raw bytes — CRC validation runs BEFORE any decoding, so
    corruption that breaks UTF-8 is still reported as a checkpoint
    error, never as a codec crash."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise CheckpointError(f"unreadable checkpoint {path}: {e}")
    m = _FOOTER_RE.search(blob)
    if m is None:
        raise CheckpointError(
            f"{path}: missing CRC footer (truncated or not a "
            "checkpoint)")
    payload = blob[:m.start()]
    if len(payload) != int(m.group(2)):
        raise CheckpointError(
            f"{path}: length mismatch (footer says "
            f"{int(m.group(2))}, payload is {len(payload)})")
    crc = zlib.crc32(payload) & 0xffffffff
    if crc != int(m.group(1), 16):
        raise CheckpointError(
            f"{path}: CRC mismatch (footer "
            f"{m.group(1).decode()}, computed {crc:08x})")
    try:
        return payload.decode("utf-8")
    except UnicodeDecodeError as e:
        raise CheckpointError(f"{path}: undecodable payload: {e}")


def read_checkpoint(path: str) -> Dict:
    """Parse + validate one checkpoint file. Raises CheckpointError on
    a missing/invalid footer, CRC mismatch, or unparseable header."""
    body = read_validated_text(path)
    nl = body.find("\n")
    header_line = body if nl < 0 else body[:nl]
    try:
        loop = json.loads(header_line)
    except json.JSONDecodeError as e:
        raise CheckpointError(f"{path}: bad header JSON: {e}")
    if loop.get("magic") != MAGIC:
        raise CheckpointError(
            f"{path}: wrong magic {loop.get('magic')!r}")
    loop.pop("magic", None)
    loop["model"] = "" if nl < 0 else body[nl + 1:]
    return loop


def list_checkpoints(directory: str) -> List[Tuple[int, str]]:
    """(iteration, path) pairs, newest first. Ignores tmp litter from
    killed writes and anything not matching the checkpoint name."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)),
                        os.path.join(directory, name)))
    out.sort(reverse=True)
    return out


def latest_valid_checkpoint(directory: str
                            ) -> Optional[Tuple[str, Dict]]:
    """Newest checkpoint that passes CRC validation, or None.

    Corrupt/partial files are SKIPPED with a warning (never deleted —
    they are evidence), falling back to the next-newest valid one."""
    for it, path in list_checkpoints(directory):
        try:
            state = read_checkpoint(path)
        except CheckpointError as e:
            log.warning(f"skipping invalid checkpoint: {e}")
            continue
        return path, state
    return None


# litter from a killed atomic_write_text: <final name>.tmp.<pid>
_TMP_RE = re.compile(r"^(.*)\.tmp\.\d+$")


def prune_numbered(directory: str, pattern, keep_last: int) -> int:
    """The retention sweep of checkpoints and gang manifests: keep the
    newest ``keep_last`` files whose name matches ``pattern`` (a compiled
    regex, group 1 the ordering number), delete the older ones and any
    tmp litter of killed writes of such a name. Returns how many files
    were removed."""
    removed = 0
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    kept = []
    for name in names:
        tm = _TMP_RE.match(name)
        if tm is not None:
            if pattern.match(tm.group(1)):
                try:
                    os.remove(os.path.join(directory, name))
                    removed += 1
                except OSError:
                    pass
            continue
        m = pattern.match(name)
        if m:
            kept.append((int(m.group(1)), name))
    if keep_last >= 1:
        kept.sort(reverse=True)
        for _, name in kept[keep_last:]:
            try:
                os.remove(os.path.join(directory, name))
                removed += 1
            except OSError:
                pass
    return removed


def prune_checkpoints(directory: str, keep_last: int) -> int:
    """Delete all but the newest ``keep_last`` checkpoints, and any tmp
    litter of killed writes. Returns how many files were removed."""
    return prune_numbered(directory, _CKPT_RE, keep_last)


# ---------------------------------------------------------------------------
# Booster <-> checkpoint state
# ---------------------------------------------------------------------------

def booster_state(booster, iteration: int,
                  eval_history: Optional[Dict] = None) -> Dict:
    """Full training state of a live Booster at ``iteration``."""
    eng = booster._engine
    return {
        "iteration": int(iteration),
        "model": booster.model_to_string(),
        "best_iteration": int(getattr(booster, "best_iteration", -1)),
        "best_score": getattr(booster, "best_score", {}) or {},
        "eval_history": eval_history or {},
        "rng": (eng.rng_snapshot()
                if hasattr(eng, "rng_snapshot") else {}),
    }


def restore_into_booster(booster, state: Dict) -> None:
    """Apply the loop-state half of a checkpoint onto a freshly
    constructed Booster (the model half goes through init_model /
    init_from_model as usual)."""
    booster.best_iteration = int(state.get("best_iteration", -1))
    if state.get("best_score"):
        booster.best_score = state["best_score"]
    eng = booster._engine
    if hasattr(eng, "restore_rng"):
        eng.restore_rng(state.get("rng") or {})
