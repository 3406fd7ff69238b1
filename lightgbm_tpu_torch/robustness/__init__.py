"""Fault-tolerant training runtime of the PyTorch/CUDA port.

Port of ``lightgbm_tpu/robustness/``, training side, with the JAX
package's file formats and environment variables (``LGBM_TPU_FAULTS``,
``LGBM_TPU_HEARTBEAT``, ``LGBM_TPU_STALL_SEC*``, ``LGBM_TPU_STALL_EXIT``),
so one environment drives both packages:

- :mod:`.checkpoint` — atomic checkpoint writes (tmp + fsync + rename,
  CRC32 footer) of the full training state: model string plus loop
  state (iteration, best_iteration/best_score, eval history, bagging
  and column RNG snapshots). Resume selects the newest *valid*
  checkpoint; corrupt/partial files are detected by CRC and skipped.
- :mod:`.faults` — the fault-injection harness (``LGBM_TPU_FAULTS`` or
  a context manager): mid-write kills, a full disk, a flipped
  checkpoint byte, a silent heartbeat, a slow first iteration, NaN
  gradients and a loss spike, so the atomicity, supervision and guard
  contracts are testable on the CPU.
- :mod:`.retry` — a bounded retry policy with decorrelated jitter and a
  deadline, and the error classifier (transient, deadline, out of
  memory, data corruption, fatal) that knows torch's errors.
- :mod:`.heartbeat` / :mod:`.supervisor` — phase-tagged liveness: the
  training loop writes crash-safe heartbeats (``compiling``, then
  ``iter N``), supervisors apply phase-aware stall deadlines
  (:class:`DeviceStallError` is transient under the retry policy), and
  an in-training watchdog raises instead of waiting forever.
- :mod:`.integrity` — the numeric-health guard of the boosting loop
  (:class:`NumericHealthError`, ``DATA_CORRUPTION``).
- :mod:`.gang` — the supervised gang: per-rank heartbeat supervision,
  the whole gang relaunched on a rank's death (:func:`run_supervised`),
  and the gang manifests that commit a sharded world's checkpoints.

Nothing here imports torch at module import or touches a device.
"""
from .checkpoint import (CheckpointError, atomic_write_text,
                         latest_valid_checkpoint, list_checkpoints,
                         prune_checkpoints, read_checkpoint,
                         write_checkpoint)
from .faults import (FaultInjected, WriteKilled, active_plan, inject,
                     install_from_env, maybe_fail)
from .heartbeat import (DeviceStallError, Heartbeat, HeartbeatRecord,
                        StallPolicy, TrainingWatchdog)
from .integrity import (IntegrityError, NumericHealthError,
                        NumericHealthGuard)
from .retry import (RetryError, RetryPolicy, classify_error,
                    is_transient_error, retry_call)
from .supervisor import StillAlive, watch_child
from .gang import (GangError, GangSupervisor, GangTimeout,
                   latest_valid_manifest, run_supervised, write_manifest)

__all__ = [
    "GangError", "GangSupervisor", "GangTimeout", "run_supervised",
    "write_manifest", "latest_valid_manifest",
    "RetryPolicy", "RetryError", "retry_call", "is_transient_error",
    "classify_error",
    "CheckpointError", "atomic_write_text", "write_checkpoint",
    "read_checkpoint", "latest_valid_checkpoint", "list_checkpoints",
    "prune_checkpoints",
    "FaultInjected", "WriteKilled", "inject", "install_from_env",
    "maybe_fail", "active_plan",
    "DeviceStallError", "Heartbeat", "HeartbeatRecord", "StallPolicy",
    "TrainingWatchdog", "StillAlive", "watch_child",
    "IntegrityError", "NumericHealthError", "NumericHealthGuard",
]
