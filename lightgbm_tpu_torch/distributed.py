"""Multi-process training: the world, its launcher and injected
collectives.

Port of ``lightgbm_tpu/distributed.py`` (ref: python-package/lightgbm/
dask.py:442 _train, src/network/linkers_socket.cpp, the machines /
num_machines / local_listen_port config). The JAX package joins one
``jax.distributed`` world whose mesh spans every process's devices; the
port runs one process per device and joins a ``torch.distributed``
process group over a TCP store at the coordinator address. Every rank
runs the same boosting loop; ``tree_learner=data``, ``voting`` or
``feature`` then trains over that group (``models/gbdt.py``,
``parallel/``).

Typical launch (one process per device, the same script)::

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.distributed import init_distributed

    init_distributed(coordinator_address="host0:8476",
                     num_processes=4, process_id=RANK)
    bst = lgt.train({"tree_learner": "data", ...}, lgt.Dataset(X, y))

Each rank takes the card ``local_rank % torch.cuda.device_count()``
(``LOCAL_RANK`` or, without it, the process index). The backend is
torch's own choice unless named: NCCL for CUDA tensors, gloo for host
tensors. NCCL refuses two ranks on one device, so ranks that share a
card need ``backend="gloo"``; nothing here changes the backend after a
failure.

``inject_collectives`` (≡ LGBM_NetworkInitWithFunctions, ref:
include/LightGBM/c_api.h:1674) trains the serial learner over
user-owned transport: each worker holds its own rows, and the grower's
histogram, root-sum and quantization-scale reductions go through the
injected host callables (``make_injected_hooks``).
"""
from __future__ import annotations

import os
import subprocess
from typing import Optional, Sequence

from .utils import log

_initialized = False


def _store_address(coordinator_address: str) -> str:
    addr = str(coordinator_address)
    return addr if "://" in addr else f"tcp://{addr}"


def _local_device_index(process_id: int,
                        local_device_ids: Optional[Sequence[int]] = None
                        ) -> int:
    """The card this rank binds: the first of ``local_device_ids`` when
    given, else ``LOCAL_RANK`` (or the rank) modulo the cards here."""
    import torch
    if local_device_ids is not None and len(local_device_ids) > 0:
        return int(local_device_ids[0])
    local = int(os.environ.get("LOCAL_RANK", process_id) or 0)
    return local % max(torch.cuda.device_count(), 1)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[Sequence[int]] = None,
                     backend: Optional[str] = None) -> int:
    """Join (or start) the world; returns this process's rank.

    ``coordinator_address`` (``host:port``) replaces the reference's
    machine list: every process dials the TCP store there, rank 0 serves
    it. ``local_device_ids`` names the cards of this process (its first
    is bound; the JAX package's argument of that name); without it a rank
    binds ``LOCAL_RANK`` modulo the cards, and on a host without a card
    it is ignored. ``backend`` is ``"nccl"``, ``"gloo"`` or None (torch's default:
    NCCL for CUDA tensors, gloo for host tensors). The group's timeout is
    ``collective_timeout()``. Joining is retried under
    ``retry.DEVICE_POLICY`` (the coordinator may not be up yet), with the
    group torn down between attempts (ref: the JAX package's
    distributed.py:34-91)."""
    global _initialized
    import datetime

    import torch
    import torch.distributed as dist

    from .robustness.retry import DEVICE_POLICY, retry_call

    if _initialized:
        log.warning("init_distributed called twice; ignoring")
        return dist.get_rank()
    if coordinator_address is None or num_processes is None or \
            process_id is None:
        raise ValueError("init_distributed needs coordinator_address, "
                         "num_processes and process_id (or use "
                         "init_from_env)")
    if torch.cuda.is_available():
        torch.cuda.set_device(_local_device_index(int(process_id),
                                                  local_device_ids))
    timeout = collective_timeout()

    def _attempt():
        try:
            dist.init_process_group(
                backend=backend,
                init_method=_store_address(coordinator_address),
                world_size=int(num_processes), rank=int(process_id),
                timeout=datetime.timedelta(
                    seconds=timeout if timeout > 0 else 1800))
        except BaseException:
            # a failed join may leave a half-made default group behind;
            # tear it down so the next attempt is a real attempt
            if dist.is_initialized():
                dist.destroy_process_group()
            raise

    retry_call(_attempt,
               policy=DEVICE_POLICY.from_env_overrides(os.environ),
               what="torch.distributed.init_process_group")
    _initialized = True
    log.info(f"Distributed world initialized: process {dist.get_rank()}/"
             f"{dist.get_world_size()}, backend {dist.get_backend()}")
    return dist.get_rank()


def shutdown_distributed() -> None:
    """Leave the world (ref: Network::Dispose)."""
    global _initialized
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def num_processes() -> int:
    import torch.distributed as dist
    return (dist.get_world_size() if dist.is_available() and
            dist.is_initialized() else 1)


def process_index() -> int:
    import torch.distributed as dist
    return (dist.get_rank() if dist.is_available() and
            dist.is_initialized() else 0)


def feature_slice(num_features: int, rank: int, world: int
                  ) -> "tuple[int, int]":
    """Contiguous feature ownership ``[lo, hi)`` of distributed bin
    finding (ref: dataset_loader.cpp:1175-1185): ceil(F / world) features
    a rank, late ranks may own an empty slice."""
    if world <= 1:
        return 0, num_features
    step = max((num_features + world - 1) // world, 1)
    lo = min(rank * step, num_features)
    return lo, min(lo + step, num_features)


def row_slice(num_rows: int, rank: int, world: int) -> "tuple[int, int]":
    """Contiguous row ownership ``[lo, hi)`` of sharded ingestion: the
    slices partition the rows exactly, in rank order."""
    if world <= 1:
        return 0, num_rows
    return rank * num_rows // world, (rank + 1) * num_rows // world


# ---------------------------------------------------------------------------
# Collective liveness: a host-level collective blocked on a dead peer
# raises within a deadline instead of wedging the rank.
# ---------------------------------------------------------------------------

ENV_COLLECTIVE_TIMEOUT = "LGBM_TPU_COLLECTIVE_TIMEOUT"
DEFAULT_COLLECTIVE_TIMEOUT = 300.0

_collective_timeout_override: Optional[float] = None


class CollectiveTimeout(Exception):
    """A host-level collective exceeded its liveness deadline: a peer is
    presumed dead or wedged. The message carries ``DEADLINE_EXCEEDED``
    for outer supervision; ``retried_collective`` never retries it (a
    re-driven round would desync the gang's collective sequence)."""

    def __init__(self, msg: str):
        super().__init__(f"DEADLINE_EXCEEDED: {msg}")


def set_collective_timeout(sec: Optional[float]) -> None:
    """Pin the collective deadline of this process (seconds;
    ``tpu_gang_collective_timeout_s`` routes here from the training
    set-up). None or <= 0 clears the pin."""
    global _collective_timeout_override
    _collective_timeout_override = (
        float(sec) if sec is not None and float(sec) > 0 else None)


def collective_timeout() -> float:
    """The deadline in seconds (<= 0 disables): the pin, else
    ``LGBM_TPU_COLLECTIVE_TIMEOUT``, else 300 s."""
    if _collective_timeout_override is not None:
        return _collective_timeout_override
    v = (os.environ.get(ENV_COLLECTIVE_TIMEOUT) or "").strip()
    if v:
        return float(v)
    return DEFAULT_COLLECTIVE_TIMEOUT


def call_with_deadline(fn, timeout: float, what: str = "collective"):
    """Run ``fn()`` in a watchdog thread; raise :class:`CollectiveTimeout`
    if it has not finished within ``timeout`` seconds (<= 0 runs it
    inline). On a timeout the daemon thread is left blocked: the caller
    lets the raise propagate and the rank dies classified."""
    if not timeout or timeout <= 0:
        return fn()
    import threading

    done = threading.Event()
    box: dict = {}

    def _run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — relayed to caller
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=_run, name="lgbm-tpu-collective",
                         daemon=True)
    t.start()
    if not done.wait(timeout):
        raise CollectiveTimeout(
            f"collective {what!r} exceeded its {timeout:.0f}s liveness "
            "deadline — a peer is presumed dead or wedged; raising so "
            "this rank dies classified instead of hanging the gang")
    if "error" in box:
        raise box["error"]
    return box["value"]


def allgather_bytes(blob: bytes, what: str = "allgather_bytes") -> list:
    """Every rank's byte blob, in rank order (≡ Network::Allgather of
    size-prefixed buffers, dataset_loader.cpp:1221-1260): the lengths,
    then the padded payloads, two all-gathers over the default group on
    the host (through ``retried_collective``'s fault sites and deadline).
    A world of one returns ``[blob]``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    if num_processes() <= 1:
        return [blob]
    from .parallel.mesh import Comm
    dev = ("cuda" if "nccl" in str(dist.get_backend()).lower()
           else "cpu")
    comm = Comm(torch.device(dev, torch.cuda.current_device())
                if dev == "cuda" else torch.device("cpu"))

    def gather(a):
        return comm.all_gather(torch.as_tensor(a).to(comm.device),
                               kind=what).cpu().numpy()

    arr = np.frombuffer(blob, np.uint8)
    lens = retried_collective(gather, np.asarray([arr.size], np.int64),
                              what=f"{what} (lengths)").reshape(-1)
    buf = np.zeros(max(int(lens.max()), 1), np.uint8)
    buf[:arr.size] = arr
    got = retried_collective(gather, buf, what=f"{what} (payload)")
    return [got[r, :int(lens[r])].tobytes() for r in range(len(lens))]


# ---------------------------------------------------------------------------
# The launcher: an env contract any process launcher can satisfy (SLURM,
# k8s, mpirun) and a local spawner for one machine (ref: dask.py:300 port
# search, :442 _train).
# ---------------------------------------------------------------------------

ENV_COORDINATOR = "LGBM_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "LGBM_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "LGBM_TPU_PROCESS_ID"
ENV_CPU_DEVICES = "LGBM_TPU_CPU_DEVICES_PER_PROCESS"
ENV_BACKEND = "LGBM_TPU_DIST_BACKEND"


def _check_cpu_devices(cpu_devices_per_process: int) -> None:
    if int(cpu_devices_per_process or 0) > 1:
        raise ValueError(
            f"cpu_devices_per_process={cpu_devices_per_process}: a rank of "
            "this package is one device (one process per device), so a "
            "process cannot hold several virtual CPU devices; launch one "
            "process per device instead")


def worker_env(coordinator_address: str, num_processes: int,
               process_id: int, cpu_devices_per_process: int = 0,
               base_env: Optional[dict] = None,
               backend: Optional[str] = None) -> dict:
    """The environment of one worker under the launcher contract:
    coordinator, world size, rank and, when given, the backend.
    ``cpu_devices_per_process`` has no counterpart (a rank is one
    device): it may be 0 or 1."""
    _check_cpu_devices(cpu_devices_per_process)
    env = dict(base_env if base_env is not None else os.environ)
    env[ENV_COORDINATOR] = str(coordinator_address)
    env[ENV_NUM_PROCESSES] = str(int(num_processes))
    env[ENV_PROCESS_ID] = str(int(process_id))
    if backend:
        env[ENV_BACKEND] = str(backend)
    return env


def init_from_env(backend: Optional[str] = None) -> int:
    """``init_distributed`` from the launcher's variables; with none set,
    a world of one (nothing is joined) and rank 0. ``backend`` overrides
    ``LGBM_TPU_DIST_BACKEND``."""
    coord = os.environ.get(ENV_COORDINATOR)
    _check_cpu_devices(int(os.environ.get(ENV_CPU_DEVICES, "0") or 0))
    if coord is None:
        return 0
    return init_distributed(
        coordinator_address=coord,
        num_processes=int(os.environ[ENV_NUM_PROCESSES]),
        process_id=int(os.environ[ENV_PROCESS_ID]),
        backend=backend or os.environ.get(ENV_BACKEND) or None)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_local(argv: Sequence[str], num_processes: int,
                coordinator_port: Optional[int] = None,
                cpu_devices_per_process: int = 0,
                env_extra: Optional[dict] = None,
                backend: Optional[str] = None) -> list:
    """Start the gang on this machine; the live ``Popen`` handles in rank
    order (stdout and stderr merged, text)."""
    _check_cpu_devices(cpu_devices_per_process)
    port = coordinator_port or _free_port()
    coord = f"localhost:{port}"
    procs = []
    for rank in range(num_processes):
        env = worker_env(coord, num_processes, rank, backend=backend)
        if env_extra:
            env.update({k: str(v) for k, v in env_extra.items()})
        procs.append(subprocess.Popen(
            list(argv), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def launch_local(argv: Sequence[str], num_processes: int,
                 coordinator_port: Optional[int] = None,
                 cpu_devices_per_process: int = 0,
                 timeout: float = 600.0,
                 env_extra: Optional[dict] = None,
                 supervised: bool = False,
                 backend: Optional[str] = None,
                 **gang_kw) -> list:
    """Run ``num_processes`` copies of ``argv`` on this machine as one
    world; ``[(returncode, output), ...]`` in rank order.

    ``supervised=True`` runs the gang under
    ``robustness.gang.run_supervised`` (the extra keywords go there):
    each rank's heartbeat is watched under the shared stall policy, a
    rank's death SIGTERMs the survivors instead of leaving them blocked
    in a collective, and the whole gang is relaunched under a bounded
    retry policy, each rank resuming from the newest valid gang
    manifest. Unsupervised, each rank still writes its own heartbeat
    (``LGBM_TPU_HEARTBEAT`` is exported as a base path), so a gang that
    outlives ``timeout`` is killed and ``robustness.gang.GangTimeout``
    says where each rank was."""
    if supervised:
        from .robustness.gang import run_supervised
        return run_supervised(
            argv, num_processes, coordinator_port=coordinator_port,
            cpu_devices_per_process=cpu_devices_per_process,
            timeout=timeout, env_extra=env_extra, backend=backend,
            **gang_kw)
    if gang_kw:
        raise TypeError(f"unexpected arguments {sorted(gang_kw)} "
                        "(supervised=True options)")
    import shutil
    import tempfile

    from .robustness.gang import GangTimeout, gang_hb_paths, rank_diagnosis
    from .robustness.heartbeat import ENV_HEARTBEAT

    extra = dict(env_extra or {})
    hb_tmp = None
    hb_base = extra.get(ENV_HEARTBEAT) or os.environ.get(ENV_HEARTBEAT)
    if not hb_base:
        hb_tmp = tempfile.mkdtemp(prefix="lgbm_gang_hb_")
        hb_base = os.path.join(hb_tmp, "gang.hb")
        extra[ENV_HEARTBEAT] = hb_base
    procs = spawn_local(argv, num_processes,
                        coordinator_port=coordinator_port,
                        cpu_devices_per_process=cpu_devices_per_process,
                        env_extra=extra, backend=backend)
    try:
        results = []
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            results.append((p.returncode, out))
        return results
    except subprocess.TimeoutExpired:
        rcs = [p.poll() for p in procs]
        diag = rank_diagnosis(gang_hb_paths(hb_base, num_processes), rcs)
        raise GangTimeout(list(argv), timeout,
                          diagnosis="Per-rank diagnosis at the timeout:\n"
                          + diag)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if hb_tmp is not None:
            shutil.rmtree(hb_tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# External collective injection (≡ LGBM_NetworkInitWithFunctions, ref:
# include/LightGBM/c_api.h:1674, src/network/network.cpp:49-62).
# ---------------------------------------------------------------------------

_injected = None


def inject_collectives(reduce_sum, reduce_max=None, rank: int = 0,
                       num_machines: int = 1) -> None:
    """Register external collectives for the Boosters set up next.

    ``reduce_sum(np.ndarray) -> np.ndarray`` is an all-reduce sum across
    workers (histograms ``[F, B, 3]`` f32 or int32, root sums ``[3]``);
    ``reduce_max`` an all-reduce max for the quantization scales (only
    needed with ``use_quantized_grad``; identity by default). ``rank``
    keys each worker's stochastic rounding. Each worker holds its own
    rows with shared bin bounds (build its Dataset with ``reference=``),
    as the reference's pre_partition external-collective mode."""
    global _injected
    if not callable(reduce_sum):
        raise TypeError("reduce_sum must be callable")
    _injected = {"reduce_sum": reduce_sum, "reduce_max": reduce_max,
                 "rank": int(rank), "num_machines": int(num_machines)}
    log.info(f"external collectives injected (rank {rank}/"
             f"{num_machines})")


def clear_collectives() -> None:
    """Remove the injected collectives (≡ LGBM_NetworkFree)."""
    global _injected
    _injected = None


def injected_collectives():
    return _injected


def retried_collective(fn, arr, what: str = "injected collective"):
    """One injected-collective call: each attempt consults the
    ``collective`` fault site and then runs ``fn(arr)`` under
    :func:`call_with_deadline` (``collective_delay`` stretches it inside
    the deadline); transient failures are retried under
    ``retry.COLLECTIVE_POLICY``, a :class:`CollectiveTimeout` never is.
    A failing ``fn`` must fail before any peer observed the operation
    (ref: the JAX package's distributed.py:525-575)."""
    import dataclasses

    from .robustness import faults
    from .robustness.retry import COLLECTIVE_POLICY, retry_call

    timeout = collective_timeout()

    def op():
        faults.maybe_delay("collective_delay")
        return fn(arr)

    def attempt():
        faults.maybe_fail("collective")
        return call_with_deadline(op, timeout, what=what)

    policy = COLLECTIVE_POLICY.from_env_overrides(os.environ)
    base = policy.classifier
    policy = dataclasses.replace(
        policy, classifier=lambda e: (not isinstance(e, CollectiveTimeout)
                                      and base(e)))
    return retry_call(attempt, policy=policy, what=what)


def make_injected_hooks(inj=None):
    """The grower's reduction hooks over the injected callables (plain
    host calls from the eager grower, in program order), with this
    worker's rank; None when nothing is injected."""
    inj = _injected if inj is None else inj
    if inj is None:
        return None
    import numpy as np
    import torch

    def host(fn, what):
        def call(t: torch.Tensor) -> torch.Tensor:
            a = t.detach().cpu().numpy()
            if fn is None:
                return t
            out = retried_collective(fn, a, what=what)
            return torch.as_tensor(np.asarray(out, a.dtype).reshape(
                a.shape)).to(t.device)
        return call

    hsum = host(inj["reduce_sum"], "injected reduce_sum")
    return {"reduce_hist": hsum, "reduce_sums": hsum,
            "reduce_max": host(inj["reduce_max"], "injected reduce_max"),
            "rank": int(inj["rank"])}
