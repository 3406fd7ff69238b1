"""The world of the distributed learners: one process is one rank is one
device.

Port of ``lightgbm_tpu/parallel/mesh.py``. Where the JAX package builds a
``jax.sharding.Mesh`` over the visible devices and lets XLA route
``psum``/``psum_scatter``/``all_gather`` (ref: src/network/network.cpp
Network::Init and its collectives, network.cpp:160-320), the port runs
one process per device and issues ``torch.distributed`` collectives
itself, through :class:`Comm`, in one fixed order on every rank.

``Comm`` works on tensors of the rank's training device. Under NCCL those
are device tensors end to end. Gloo (the CPU worlds of the tests, and
ranks that share one card, which NCCL refuses) works on host memory: a
CUDA tensor is staged through a pinned host buffer and copied back, a
stated property of that backend, decided when the ``Comm`` is made and
never by catching a failure.

Every call adds to ``Comm.stats[kind]`` its calls, the bytes it put on the
wire per rank (an all-reduce sends ``2 (W - 1) / W`` of its buffer, a
reduce-scatter and an all-gather ``(W - 1) / W``, a broadcast ``(W - 1) /
W`` from its root; ref: the ring algorithms of network.cpp) and its host
seconds (under gloo they include the staging copy's wait for the device
work queued before the call).

Each call consults the fault sites ``collective`` (a lost request,
retried under ``retry.COLLECTIVE_POLICY`` before the operation is issued)
and ``collective_delay`` (a slow peer, inside the process group's
deadline); the operation itself is never retried.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..robustness import faults
from ..robustness.retry import COLLECTIVE_POLICY, retry_call

def padded_rows(num_rows: int, num_shards: int) -> int:
    """Rows after padding to an even multiple of the world size."""
    return ((num_rows + num_shards - 1) // num_shards) * num_shards


def feature_tile(num_features: int, num_shards: int) -> int:
    """Per-rank feature-window width under reduce-scatter histogram
    aggregation (``tpu_hist_reduce=reduce_scatter``): the features padded
    to a multiple of the world, split evenly (ref: network.h:90-276
    PrepareBufferPos block layout)."""
    return padded_rows(num_features, num_shards) // num_shards


def pad_rows_np(arr: np.ndarray, target: int, axis: int,
                fill=0) -> np.ndarray:
    """Pad ``arr`` along ``axis`` to ``target`` with ``fill`` (host side).
    Pad rows carry gh = (0, 0, 0), so histograms, sums and counts never
    see them."""
    n = arr.shape[axis]
    if n == target:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - n)
    return np.pad(arr, widths, constant_values=fill)


def gather_meta(meta, ids: torch.Tensor):
    """The ``FeatureMeta`` of the features ``ids`` (int64 [Fw]; a
    negative id is a one-bin slot that never splits, the JAX package's
    window and slice padding)."""
    from ..ops.split import MISSING_ENUM, FeatureMeta
    ok = ids >= 0
    safe = ids.clamp(min=0)

    def pick(a, fill):
        if a is None:
            return None
        return torch.where(ok, a[safe], torch.as_tensor(
            fill, dtype=a.dtype, device=a.device))
    nb = pick(meta.num_bin, 1)
    mt = pick(meta.missing_type, 0)
    is_cat = (pick(meta.is_categorical, False)
              if meta.is_categorical is not None
              else torch.zeros(len(ids), dtype=torch.bool,
                               device=ids.device))
    cat_h, mt_h, nb_h = is_cat.tolist(), mt.tolist(), nb.tolist()
    cat_local = [j for j, c in enumerate(cat_h) if c]
    return FeatureMeta(
        num_bin=nb, missing_type=mt, default_bin=pick(meta.default_bin, 0),
        has_missing=any(m != MISSING_ENUM["none"] and not c
                        for m, c in zip(mt_h, cat_h)),
        is_categorical=is_cat,
        cat_features=(torch.tensor(cat_local, device=ids.device)
                      if cat_local else None),
        cat_num_bin=tuple(nb_h[j] for j in cat_local) or None,
        monotone=pick(meta.monotone, 0), penalty=pick(meta.penalty, 1.0))


def window_ids(start: int, width: int, num_features: int,
               device) -> torch.Tensor:
    """int64 ids of the window ``[start, start + width)``, -1 past the
    last feature."""
    ids = torch.arange(start, start + width, device=device)
    return torch.where(ids < num_features, ids, -1)


def _reduce_scatter_fn():
    """The installed torch's tensor reduce-scatter: ``reduce_scatter_single``
    where it exists (it replaced ``reduce_scatter_tensor``, which newer
    releases deprecate), else ``reduce_scatter_tensor``; ``all_gather``
    picks ``all_gather_single`` over ``all_gather_into_tensor`` alike."""
    import torch.distributed as dist
    if hasattr(dist, "reduce_scatter_single"):
        return dist.reduce_scatter_single
    return dist.reduce_scatter_tensor


class Comm:
    """One rank's collectives over the default ``torch.distributed``
    group, on tensors of ``device``."""

    def __init__(self, device):
        import torch.distributed as dist
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.device = torch.device(device)
        self.backend = str(dist.get_backend()).lower()
        # a group made without a backend name serves CUDA tensors by
        # NCCL ("cpu:gloo,cuda:nccl"); one named gloo serves host memory
        self.staged = (self.device.type == "cuda" and
                       "nccl" not in self.backend)
        self.stats: Dict[str, List[float]] = {}

    # -- accounting ------------------------------------------------------
    def reset_stats(self) -> None:
        self.stats = {}

    def _account(self, kind: str, nbytes: float, seconds: float) -> None:
        row = self.stats.setdefault(kind, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += nbytes
        row[2] += seconds

    def _run(self, kind: str, t: torch.Tensor, wire: float, op):
        if faults.active_plan() is not None:
            retry_call(faults.maybe_fail, "collective",
                       policy=COLLECTIVE_POLICY.from_env_overrides(
                           os.environ),
                       what=f"collective {kind}")
            faults.maybe_delay("collective_delay")
        t0 = time.perf_counter()
        out = op(t)
        n = t.numel() * t.element_size()
        self._account(kind, wire * n * (self.world - 1) / self.world,
                      time.perf_counter() - t0)
        return out

    # -- staging ---------------------------------------------------------
    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """The buffer the backend works on: a pinned host copy of a CUDA
        tensor under gloo (torch's host allocator caches pinned blocks),
        else a contiguous copy on the device."""
        if self.staged:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t)
            return buf
        return t.contiguous().clone()

    def _back(self, buf: torch.Tensor) -> torch.Tensor:
        return buf.to(self.device) if self.staged else buf

    def _host_empty(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self.staged,
                           device=None if self.staged else self.device)

    # -- collectives -----------------------------------------------------
    def all_reduce_sum(self, t: torch.Tensor,
                       kind: str = "all_reduce") -> torch.Tensor:
        """The sum of ``t`` over every rank (≡ ``lax.psum``)."""
        import torch.distributed as dist

        def op(x):
            buf = self._stage(x)
            dist.all_reduce(buf, op=dist.ReduceOp.SUM)
            return self._back(buf)
        return self._run(kind, t, 2.0, op)

    def all_reduce_max(self, t: torch.Tensor,
                       kind: str = "all_reduce_max") -> torch.Tensor:
        """The elementwise max of ``t`` over every rank (≡ ``lax.pmax``)."""
        import torch.distributed as dist

        def op(x):
            buf = self._stage(x)
            dist.all_reduce(buf, op=dist.ReduceOp.MAX)
            return self._back(buf)
        return self._run(kind, t, 2.0, op)

    def reduce_scatter(self, t: torch.Tensor,
                       kind: str = "reduce_scatter") -> torch.Tensor:
        """``t`` [W * k, ...] summed over every rank, this rank's block
        ``[rank * k, (rank + 1) * k)`` of it (≡ ``lax.psum_scatter(...,
        scatter_dimension=0, tiled=True)``)."""
        if t.shape[0] % self.world:
            raise ValueError(f"reduce_scatter of {t.shape[0]} rows over "
                             f"{self.world} ranks")
        rs = _reduce_scatter_fn()

        def op(x):
            buf = self._stage(x)
            out = self._host_empty((x.shape[0] // self.world,
                                    *x.shape[1:]), x.dtype)
            rs(out, buf)
            return self._back(out)
        return self._run(kind, t, 1.0, op)

    def all_gather(self, t: torch.Tensor,
                   kind: str = "all_gather") -> torch.Tensor:
        """``[W, *t.shape]``: every rank's ``t`` in rank order (≡
        ``lax.all_gather``)."""
        import torch.distributed as dist

        ag = (dist.all_gather_single if hasattr(dist, "all_gather_single")
              else dist.all_gather_into_tensor)

        def op(x):
            # the output is the ranks' inputs concatenated along dim 0
            buf = self._stage(x.reshape(-1))
            out = self._host_empty((self.world * buf.shape[0],), x.dtype)
            ag(out, buf)
            return self._back(out).reshape(self.world, *x.shape)
        return self._run(kind, t, 1.0, op)

    def broadcast_from(self, t: torch.Tensor, src: int,
                       kind: str = "broadcast") -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (the shapes and dtypes must
        agree)."""
        import torch.distributed as dist

        def op(x):
            buf = self._stage(x)
            dist.broadcast(buf, src=int(src))
            return self._back(buf)
        return self._run(kind, t, 1.0, op)


def current_comm(device) -> Optional[Comm]:
    """A ``Comm`` over the default group on ``device``, or None outside a
    ``torch.distributed`` world (a world of one process)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return Comm(device)
