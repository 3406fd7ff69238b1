"""Time the port's histogram kernels from several source trees, in turns.

    python3 -m lightgbm_tpu_torch.kernel_ab TREE [TREE ...]

Each TREE is a directory holding a ``lightgbm_tpu_torch`` package: a
checkout, or a commit unpacked with ``git archive``. For each TREE in the
order given, a fresh process builds that tree's kernels and prints one
line of device times in ms (the median of 30 calls, each queued behind a
device sleep that outlasts the host's issuing, the L2 flushed before
each): K1 (``hist_cuda_rm``) at leaves of 1M, 65,536, 4,097 and 1 rows;
K2 (``hist_level_cuda``, the node order given) over 1M rows at 1 and 512
nodes; B2 (``hist_cuda_fm``, the leaf mask fused) over 1M rows at leaves
of 1M and 4,097 rows; f32 gh, 28 features, 255 bins, data from a fixed
seed. Run on one card, with the trees in turns (parent, change, change,
parent), two versions compare on the same card. Needs an NVIDIA GPU.
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys

F, B, R = 28, 255, 1_000_000
REPS = 30
SLEEP_CYCLES_PER_REP = 5_000_000


def _time_tree(tree: str) -> str:
    """The timing line of the package under ``tree`` (imported from it)."""
    import torch

    import lightgbm_tpu_torch
    from lightgbm_tpu_torch import _build
    from lightgbm_tpu_torch.ops.hist_cuda import hist_cuda_fm, hist_cuda_rm
    from lightgbm_tpu_torch.ops.hist_level import node_order
    from lightgbm_tpu_torch.ops.hist_level_cuda import hist_level_cuda
    if not lightgbm_tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {lightgbm_tpu_torch.__file__}, not "
                           f"the package under {tree}")
    _build.build_all(_build.kernel_names())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)

    def device_ms(fn):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES_PER_REP * REPS)
        pairs = []
        for _ in range(REPS):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    def bins_of(shape):
        return torch.randint(0, B, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.uint8)

    times = {}
    for S in (1_000_000, 65_536, 4_097, 1):
        bins, gh = bins_of((S, F)), torch.randn(S, 3, generator=gen,
                                                 device=dev)
        times[f"K1_S={S}"] = device_ms(lambda: hist_cuda_rm(bins, gh, B))
    bins, gh = bins_of((R, F)), torch.randn(R, 3, generator=gen, device=dev)
    for n in (1, 512):
        local = (torch.rand(R, generator=gen, device=dev) ** 3
                 * n).long().clamp(max=n - 1)
        in_lvl = torch.rand(R, generator=gen, device=dev) < 0.9
        order, seg = node_order(local, in_lvl, n)
        times[f"K2_n={n}"] = device_ms(lambda: hist_level_cuda(
            bins, gh, local, in_lvl, n, B, order=order, seg=seg))
    bins_fm = bins.T.contiguous()
    for S in (1_000_000, 4_097):
        ids = torch.randint(1, 9, (R,), generator=gen, device=dev)
        ids[torch.randperm(R, generator=gen, device=dev)[:S]] = 0
        times[f"B2_S={S}"] = device_ms(
            lambda: hist_cuda_fm(bins_fm, gh, B, leaf_id=ids, leaf=0))
    return f"{tree} " + " ".join(f"{k}_device_ms={v!r}"
                                 for k, v in times.items())


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        print(_time_tree(os.path.abspath(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for tree in argv:
        tree = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=tree)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        tree], env=env, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
