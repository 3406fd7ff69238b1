"""Time the port's histogram kernels from several source trees, in turns.

    python3 -m lightgbm_tpu_torch.kernel_ab TREE [TREE ...]

Each TREE is a directory holding a ``lightgbm_tpu_torch`` package: a
checkout, or a commit unpacked with ``git archive``. For each TREE in
the order given, a fresh process builds that tree's kernels and prints
one line of device times in ms (the median of 30 calls, each queued
behind a device sleep that outlasts the host's issuing, the L2 flushed
before each): K1 (``hist_cuda_rm``) at leaves of 1M, 65,536, 4,097 and 1
rows; K2 (``hist_level_cuda``, the node order given) over 1M rows at 1
and 512 nodes; B2 (``hist_cuda_fm``, the leaf mask fused) over 1M rows
at leaves of 1M, 65,536 and 4,097 rows; f32 gh, 28 features, 255 bins,
data from a fixed seed. Then skewed bins (``_skewed``: four rows in five
in one bin, and feature 0 of three values) at 255 bins, and u16 bins
(``_u16``) at each of ``U16_BINS``, uniform and skewed: K1 at leaves of
1M, 65,536 and 4,097 rows, K2 at 1 and 512 nodes, and B2 at leaves of
1M, 65,536 and 4,097 rows (over u16 bins B2's wide body), B2 with int8
gh at a 1M-row leaf, and B2's yardstick (``index_add_``: one call adding
every cell's gh into its flat slot) and bound (``_bound_us``: the bytes
it must move at 3.35 TB/s). For each bin set it also gives K1's (1M
rows), K2's (1 node), B2's (a 1M-row leaf) and the f32 chunked sum's
worst error against the exact sum (f64), as a fraction of the kernels'
tolerance (rtol 1e-5, atol 1e-4; ``_err_over_tol``, above 1 misses it).
Run on one card, with the trees in turns (parent, change, change,
parent), two versions compare on the same card. Needs an NVIDIA GPU.

    python3 -m lightgbm_tpu_torch.kernel_ab --kernels TREE [TREE ...]

prints instead, for each TREE, B2's device µs a call by kernel (the mask
pass, the histogram, the reduction, the sparse pass; ``torch.profiler``
over 10 calls, the L2 flushed before each) over 1M rows of u16 bins at
257, 1,023 and 4,095 bins and leaves of 1M, 65,536, 4,097 and 1 rows.
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys

F, B, R = 28, 255, 1_000_000
U16_BINS = (257, 511, 1023, 4095)
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
    from lightgbm_tpu_torch.ops.histogram import hist_rowmajor_chunked
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

    def bins_of(shape, nb=B, skewed=False):
        """uint8 bins below nb, or u16 bins held as int16 past 256;
        ``skewed``: four in five in bin nb // 3, feature 0 of three
        values."""
        b = torch.randint(0, nb, shape, generator=gen, device=dev,
                          dtype=torch.int32)
        if skewed:
            hot = torch.rand(shape, generator=gen, device=dev) < 0.8
            b = torch.where(hot, nb // 3, b)
            three = torch.tensor([0, nb // 2, nb - 1], device=dev,
                                 dtype=torch.int32)
            b[:, 0] = three[torch.randint(0, 3, (shape[0],), generator=gen,
                                          device=dev)]
        return b.to(torch.uint8 if nb <= 256 else torch.int16)

    def level_of(n):
        local = (torch.rand(R, generator=gen, device=dev) ** 3
                 * n).long().clamp(max=n - 1)
        in_lvl = torch.rand(R, generator=gen, device=dev) < 0.9
        return (local, in_lvl) + node_order(local, in_lvl, n)

    def exact(b, g, nb):
        """The f64 histogram [F, nb, 3] of g over row-major bins b."""
        ids = (b.long() & 0xFFFF) + torch.arange(F, device=dev) * nb
        acc = torch.zeros(F * nb, 3, dtype=torch.float64, device=dev)
        acc.index_add_(0, ids.reshape(-1),
                       g.double().repeat_interleave(F, dim=0))
        return acc.reshape(F, nb, 3)

    def err_over_tol(out, ref):
        return float(((out.double() - ref).abs()
                      / (1e-4 + 1e-5 * ref.abs())).max())

    def errors(tag, b_rm, b_fm, nb, level):
        """Worst errors of K1, K2 (1 node), B2 and the f32 chunked sum on
        bins b_rm (b_fm feature-major) of nb bins, against the exact sum."""
        ref = exact(b_rm, gh, nb)
        local, in_lvl, order, seg = level
        errs[f"K1_S={R}_{tag}"] = err_over_tol(hist_cuda_rm(b_rm, gh, nb),
                                               ref)
        errs[f"K2_n=1_{tag}"] = err_over_tol(
            hist_level_cuda(b_rm, gh, local, in_lvl, 1, nb, order=order,
                            seg=seg)[0],
            exact(b_rm[in_lvl], gh[in_lvl], nb))
        errs[f"B2_S={R}_{tag}"] = err_over_tol(
            hist_cuda_fm(b_fm, gh, nb, leaf_id=leaves[R], leaf=0), ref)
        errs[f"chunked_f32_{tag}"] = err_over_tol(
            hist_rowmajor_chunked(b_rm, gh, nb), ref)

    def index_add_ms(b, nb):
        """B2's yardstick: one ``index_add_`` of every cell's gh (f32)
        into its flat (feature, bin) slot, cells in row-major order, the
        expansion made outside the call."""
        slot = ((b.long() & 0xFFFF) + torch.arange(F, device=dev)
                * nb).reshape(-1)
        vals = gh.repeat_interleave(F, dim=0)
        acc = torch.zeros(F * nb, 3, device=dev)
        return device_ms(lambda: acc.index_add_(0, slot, vals))

    times, errs, bounds = {}, {}, {}
    for S in (1_000_000, 65_536, 4_097, 1):
        bins, gh = bins_of((S, F)), torch.randn(S, 3, generator=gen,
                                                 device=dev)
        times[f"K1_S={S}"] = device_ms(lambda: hist_cuda_rm(bins, gh, B))
    bins, gh = bins_of((R, F)), torch.randn(R, 3, generator=gen, device=dev)
    for n in (1, 512):
        local, in_lvl, order, seg = level_of(n)
        times[f"K2_n={n}"] = device_ms(lambda: hist_level_cuda(
            bins, gh, local, in_lvl, n, B, order=order, seg=seg))
    bins_fm = bins.T.contiguous()
    leaves = {}
    for S in (1_000_000, 65_536, 4_097):
        ids = torch.randint(1, 9, (R,), generator=gen, device=dev)
        ids[torch.randperm(R, generator=gen, device=dev)[:S]] = 0
        leaves[S] = ids
        times[f"B2_S={S}"] = device_ms(
            lambda: hist_cuda_fm(bins_fm, gh, B, leaf_id=ids, leaf=0))
    levels = {n: level_of(n) for n in (1, 512)}
    errors(f"B={B}", bins, bins_fm, B, levels[1])
    cases = [(B, True)] + [(nb, skewed) for nb in U16_BINS
                           for skewed in (False, True)]
    gh8 = torch.randint(-128, 128, (R, 3), generator=gen, device=dev,
                        dtype=torch.int32).to(torch.int8)
    for nb, skewed in cases:
        tag = (f"B={nb}{'_u16' if nb > 256 else ''}"
               f"{'_skewed' if skewed else ''}")
        b_rm = bins_of((R, F), nb, skewed)
        for S in (R, 65_536, 4_097):
            times[f"K1_S={S}_{tag}"] = device_ms(
                lambda: hist_cuda_rm(b_rm[:S], gh[:S], nb))
        for n, (local, in_lvl, order, seg) in levels.items():
            times[f"K2_n={n}_{tag}"] = device_ms(
                lambda: hist_level_cuda(b_rm, gh, local, in_lvl, n, nb,
                                        order=order, seg=seg))
        b_fm = b_rm.T.contiguous()
        for S, ids in leaves.items():
            times[f"B2_S={S}_{tag}"] = device_ms(
                lambda: hist_cuda_fm(b_fm, gh, nb, leaf_id=ids, leaf=0))
            # the least time: every row's leaf id, the leaf's rows (bins of
            # 1 or 2 bytes, f32 gh) and the output at 3.35 TB/s
            bounds[f"B2_S={S}_{tag}"] = (
                8 * R + S * (F * (1 if nb <= 256 else 2) + 12)
                + 12 * F * nb) / 3.35e12 * 1e6
        times[f"B2_int8_S={R}_{tag}"] = device_ms(
            lambda: hist_cuda_fm(b_fm, gh8, nb, leaf_id=leaves[R], leaf=0))
        times[f"index_add_{tag}"] = index_add_ms(b_rm, nb)
        errors(tag, b_rm, b_fm, nb, levels[1])
        del b_rm, b_fm
    return f"{tree} " + " ".join(
        [f"{k}_device_ms={v!r}" for k, v in times.items()]
        + [f"{k}_err_over_tol={v!r}" for k, v in errs.items()]
        + [f"{k}_bound_us={v!r}" for k, v in bounds.items()])


# B2's kernels by name: the short name of each in --kernels' lines
B2_KERNELS = (("masks", "batch_masks"), ("histogram", "hist_featmajor_"),
              ("reduction", "reduce_flagged"), ("sparse", "hist_sparse_"))


def _b2_kernels(tree: str) -> str:
    """``--kernels``' lines for the package under ``tree``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import lightgbm_tpu_torch
    from lightgbm_tpu_torch import _build
    from lightgbm_tpu_torch.ops.hist_cuda import hist_cuda_fm
    if not lightgbm_tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {lightgbm_tpu_torch.__file__}, not "
                           f"the package under {tree}")
    _build.build_all(_build.kernel_names())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    gh = torch.randn(R, 3, generator=gen, device=dev)
    lines = []
    for nb in (257, 1023, 4095):
        bins = torch.randint(0, nb, (F, R), generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int16)
        for S in (R, 65_536, 4_097, 1):
            ids = torch.randint(1, 9, (R,), generator=gen, device=dev)
            ids[torch.randperm(R, generator=gen, device=dev)[:S]] = 0
            for _ in range(3):
                hist_cuda_fm(bins, gh, nb, leaf_id=ids, leaf=0)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    flush.zero_()
                    hist_cuda_fm(bins, gh, nb, leaf_id=ids, leaf=0)
                torch.cuda.synchronize()
            us = {}
            for e in prof.key_averages():
                for short, key in B2_KERNELS:
                    if key in e.key:
                        us[short] = e.self_device_time_total / e.count
            lines.append(f"{tree} B2_kernels B={nb}_u16 S={S} " + " ".join(
                f"{short}_device_us={us.get(short, 0.0)!r}"
                for short, _ in B2_KERNELS))
    return "\n".join(lines)


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] in ("--one", "--one-kernels"):
        run = _time_tree if argv[0] == "--one" else _b2_kernels
        print(run(os.path.abspath(argv[1])), flush=True)
        return 0
    one = "--one"
    if argv and argv[0] == "--kernels":
        one, argv = "--one-kernels", argv[1:]
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
        subprocess.run([sys.executable, os.path.abspath(__file__), one,
                        tree], env=env, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
