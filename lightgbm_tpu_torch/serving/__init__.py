"""Concurrent serving tier of the PyTorch/CUDA port: dynamic
micro-batching into the packed-forest engine, a serving mesh that copies
the pack to every device and splits each batch's rows over them,
zero-downtime hot-swap of newly trained trees through immutable
snapshots, device TreeSHAP explanations on their own batcher — and the
failure path: request deadlines, fail-fast admission control,
retry-then-degrade dispatch with background recovery, OOM bisection,
publish rollback and integrity canaries.

Entry points: ``Booster.serve(...)`` -> :class:`ModelServer`, and the
multi-tenant fleet (``fleet.py``): ``serve_fleet({name: booster, ...})``
-> :class:`FleetServer`, ``Booster.serve(fleet=, tenant=)`` ->
:class:`TenantHandle`.
"""
from .batcher import (DeadlineExceeded, MicroBatcher, Overloaded,
                      PendingRequest, ShutdownError)
from .fleet import FleetServer, TenantHandle, serve_fleet
from .mesh import probe, serving_mesh, shard_rows
from .metrics import (LatencyRecorder, ServingCounters,
                      latency_summary_ms, percentile)
from .server import DegradeControl, Generation, ModelServer

__all__ = [
    "DeadlineExceeded", "DegradeControl", "FleetServer", "Generation",
    "LatencyRecorder", "MicroBatcher", "ModelServer", "Overloaded",
    "PendingRequest", "ServingCounters", "ShutdownError", "TenantHandle",
    "latency_summary_ms", "percentile", "probe", "serve_fleet",
    "serving_mesh", "shard_rows",
]
