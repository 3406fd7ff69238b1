"""Concurrent serving tier of the PyTorch/CUDA port: dynamic
micro-batching into the packed-forest engine, a serving mesh that copies
the pack to every device and splits each batch's rows over them,
zero-downtime hot-swap of newly trained trees through immutable
snapshots, device TreeSHAP explanations on their own batcher — and the
failure path: request deadlines, fail-fast admission control,
retry-then-degrade dispatch with background recovery, OOM bisection,
publish rollback and integrity canaries.

Entry point: ``Booster.serve(...)`` -> :class:`ModelServer`. The
multi-tenant fleet of the JAX package (``serving/fleet.py``,
``serve_fleet``) is not ported yet (ROADMAP A14b).
"""
from .batcher import (DeadlineExceeded, MicroBatcher, Overloaded,
                      PendingRequest, ShutdownError)
from .mesh import probe, serving_mesh, shard_rows
from .metrics import (LatencyRecorder, ServingCounters,
                      latency_summary_ms, percentile)
from .server import DegradeControl, Generation, ModelServer

__all__ = [
    "DeadlineExceeded", "DegradeControl", "Generation", "LatencyRecorder",
    "MicroBatcher", "ModelServer", "Overloaded", "PendingRequest",
    "ServingCounters", "ShutdownError", "latency_summary_ms", "percentile",
    "probe", "serving_mesh", "shard_rows",
]
