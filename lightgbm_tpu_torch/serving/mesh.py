"""Serving-mesh placement: replicate the packed forest, split the rows.

Port of ``lightgbm_tpu/serving/mesh.py`` over torch devices. A mesh is
the list of serving devices, ``None`` for one device (the single-device
path then skips placement entirely). The packed forest is small and
read-only, so it is REPLICATED on every mesh device (``replicate``: one
copy a device, a ``forest.Replicas``); a request batch's rows are split
over the devices in order (``shard_rows``), each device walks its part,
and the scores are concatenated in row order. Every function takes the
device list, so a test on the CPU can build a two-entry mesh
``[cpu, cpu]``. The fleet (``fleet.py``) either replicates each shape
bucket's pack so, or shards the MODEL axis: each bucket on one owner
device (``place_on``, ``assign_owners``).

No function here selects a current device (``torch.cuda.set_device``):
every tensor is created on the device it names, so serving threads can
share the process with a trainer.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import torch

from ..ops.forest import Replicas
from ..robustness import faults

# Serializes MULTI-DEVICE launches process-wide: a dispatch over a mesh
# and a canary replay (or a publish's golden recording) from another
# thread then never interleave their parts across the devices. A
# single-device launch never takes it.
_LAUNCH_LOCK = threading.Lock()

Mesh = Optional[List[torch.device]]


def serving_mesh(num_devices: int = 0, device=None,
                 devices: Optional[Sequence] = None) -> Mesh:
    """The serving devices: ``devices`` when given, else the first
    ``num_devices`` visible devices of ``device``'s type (0 = all; a CPU
    is one device). None when only one device would serve."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    else:
        base = torch.device(device if device is not None else "cuda")
        if base.type != "cuda":
            return None
        avail = torch.cuda.device_count()
        n = avail if num_devices in (0, None) else min(int(num_devices),
                                                       avail)
        devs = [torch.device("cuda", i) for i in range(n)]
    return devs if len(devs) > 1 else None


def mesh_devices(mesh: Mesh, device) -> List[torch.device]:
    """The devices a server dispatches to: every mesh device, or
    ``device`` without a mesh."""
    return list(mesh) if mesh is not None else [torch.device(device)]


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_to(x, device) for x in tree])
    if type(tree) is tuple:
        return tuple(_to(x, device) for x in tree)
    return tree


def replicate(tree, mesh: Mesh):
    """A window (a NamedTuple of tensors) copied to every mesh device, as
    a ``forest.Replicas`` in the mesh's order. Identity without a mesh."""
    if mesh is None:
        return tree
    return Replicas(_to(tree, d) for d in mesh)


def place_on(tree, device):
    """A pack moved to ONE owner device: the fleet's model-shard
    placement (ref: the JAX package's serving/mesh.py:96). Each shape
    bucket's mega-pack lives on one device of the mesh and that bucket's
    batches are scored there, whole: fleets whose packs outgrow one
    device's budget trade the row split for fitting at all."""
    return _to(tree, device)


def assign_owners(sized_keys, devices) -> dict:
    """Balanced model-shard owners (ref: the JAX package's
    serving/mesh.py:108): buckets (``(key, nbytes)`` pairs), largest
    first, each on the least-loaded device. Owners are INDICES into
    ``devices``, so a mesh listing one device twice (``[cpu, cpu]``)
    still has two owners; ties break by the key's repr, so a rebuilt
    fleet moves buckets only when their sizes change."""
    load = [0] * len(devices)
    owners = {}
    for key, nbytes in sorted(sized_keys,
                              key=lambda kv: (-kv[1], repr(kv[0]))):
        i = min(range(len(devices)), key=lambda j: (load[j], j))
        owners[key] = i
        load[i] += nbytes
    return owners


def shard_rows(x: torch.Tensor, rows_axis: int,
               mesh: Mesh) -> List[torch.Tensor]:
    """``x``'s rows (along ``rows_axis``) split in order into one part a
    mesh device (unequal when the rows do not divide), each moved to its
    device. ``[x]`` without a mesh."""
    if mesh is None:
        return [x]
    parts = torch.tensor_split(x, len(mesh), dim=rows_axis)
    return [p.to(d) for p, d in zip(parts, mesh)]


def locked_launch(mesh: Mesh, fn, *args, **kwargs):
    """Run one launch ``fn(*args, **kwargs)``; over a multi-device mesh
    hold the process-wide launch lock until it has returned (the serving
    scorers return host arrays, so their device work is complete).
    Without a mesh, no lock."""
    if mesh is None:
        return fn(*args, **kwargs)
    with _LAUNCH_LOCK:
        return fn(*args, **kwargs)


def probe(mesh: Mesh, device) -> int:
    """One tiny synchronous round trip on EVERY serving device: the
    liveness check of the degraded server's recovery loop before it goes
    back to the device route (every device of a mesh must answer).
    Consults the ``probe_timeout`` fault site first. Raises what the
    runtime raises for a device that does not answer; returns the count
    probed."""
    faults.maybe_fail("probe_timeout")
    devs = mesh_devices(mesh, device)
    for d in devs:
        got = float((torch.zeros(8, device=d) + 1).sum().item())
        if got != 8.0:
            raise RuntimeError(f"device probe on {d} computed {got}, not 8")
    return len(devs)
