"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--profile]

Phases, each reported on its own line:

1. environment: torch and CUDA versions, the card's name and power limit,
   and which torch.uint16 ops the card's torch serves (the port holds
   u16 bins as int16 and needs none of them);
2. build: every kernel under lightgbm_tpu_torch/csrc, one nvcc each, in
   parallel;
3. each kernel in each of its modes against its plain PyTorch version on
   the card, at the shapes the training paths give it, with its time
   (CUDA events around each call on an idle stream: the host's issuing of
   the call counts), its device time (every call queued behind a device
   sleep, so the host's issuing is hidden), the plain version's time, one
   PyTorch library call's time and its bound on the card, over uint8
   bins at 255 bins and uint16 bins at 257, 1,023 and 4,095 (the plain
   version is the chunked two-level sum): K1 (hist_rowmajor) in f32,
   int8 and bf16 at leaf sizes from 1M rows down to 1, its small path
   against its dense path at small leaves, and its bin windows; the
   level partition
   (the node order carried from one level to the next) against its plain
   version and the stable sort, and K2 (hist_level) in f32, int8 and bf16
   over 1M rows at 1 to 512 nodes with skewed segments, with empty nodes,
   and with every row out of the level, fed the carried order, timed per
   level (partition included) beside index_add_; B2 (hist_featmajor) in
   f32 and int8 over 1M feature-major rows, adding only the rows of
   leaves of 1M rows down to 1 (the fused form, which reads each row's
   leaf id) beside the unfused form (gh masked by torch, then a pass over
   every row), and over a ragged row count with and without the engine's
   16-element row padding. Two launches on the same input must give the
   same bits;
4. the main path at full width: ``Booster`` training of a Higgs-shaped
   binary GBDT (1,000,000 x 28, 255 leaves, 255 bins) on the compact
   grower for one warm-up and a few timed iterations, then ``predict``;
   the kernel launch counts of this run show that training went through
   K1;
5. the same configuration under each of the slice's other paths, on the
   phase-4 dataset: quantized gradients, bf16 histograms, level
   scheduling (the hybrid grower at 255 leaves and unbounded depth) and
   level with each of the two, full row scheduling and full with
   quantized gradients; each run's launch counts must show its kernel
   mode (level: K2 and the partition at every level; full: B2 once per
   leaf of every tree, and no K1 or K2), the hybrid's first tree must
   hold the compact one's splits and give its outputs (its node numbering
   follows the JAX package's e-ranking), and full+quantized's first tree
   must equal the quantized one; then the same eight paths on the same
   rows binned at max_bin=1023 (uint16 bins through K1, K2 and B2), each
   run's launch counts showing its u16 kernel mode; the quantized run
   logs the device time of one tree's threefry draws; with
   ``--profile``, two more iterations
   of the compact, level and full paths under ``torch.profiler`` show
   where an iteration's time goes (device busy share, K1's, K2's and B2's
   device time per iteration, top ops, launches and device-to-host
   reads);
6. small trainings on cuda and on the CPU (plain versions), compact,
   quantized (stochastic rounding on: both draw the same threefry bits),
   level and full, in u8 and in u16 bins, which must agree;
7. prediction on the card: ``predict(device=True)`` of the phase-4 model
   and of the phase-5 u16 compact model over 200,000 rows by the binned
   route, and by the raw route for a
   booster of the same trees without the training bin mappers, against
   the host walk (scores within 1e-5, every tree's leaf equal), with
   rows/s of each route and of the host walk; each route's answer must be
   the engine's device scores bit for bit, so no fallback went unseen.

Any failure raises and exits non-zero. The last three lines are the
card's name and power limit, one JSON object describing every kernel
mode, and ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published rates (dense): HBM bytes/s and f32 FLOP/s outside the
# tensor cores. A card set below 700 W runs slower than these.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

N_ROWS, N_FEATURES = 1_000_000, 28
NUM_LEAVES, MAX_BIN = 255, 255
# max_bin of the u16 paths (LightGBM's parameter-tuning guide advises a
# large max_bin for accuracy), and the bin counts phase 3 holds the u16
# modes at: one bin past u8, the paths' 1,023, and about where the JAX
# package's Pallas kernels stop fitting a tile (ops/hist_pallas.py:180)
U16_MAX_BIN = 1023
U16_BINS = (257, 1023, 4095)
TIMED_ITERS = 5
MODE_ITERS = 3
U16_ITERS = 2
KERNEL_SHAPES = (1_000_000, 65_536, 4_097, 1)
U16_SHAPES = (1_000_000, 4_097, 1)
LEVEL_NODES = (1, 8, 64, 512)
U16_LEVEL_NODES = (1, 512)
# K1's small path against its dense path at these leaf sizes
SMALL_SHAPES = (1, 300, 1_024, 2_048, 4_097)
# K1's bin windows compared at the u16 bin counts that need more than one
WINDOW_SIZES = (256, 512)
TIMING_REPS = 20
PLAIN_REPS = 5
# device clock cycles of sleep per timed call queued behind it (~3 ms at
# the H100's clock: longer than the host takes to issue any one call)
SLEEP_CYCLES_PER_REP = 5_000_000
GH_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
MODES = ("f32", "int8", "bf16")
FM_MODES = ("f32", "int8")       # B2: the full path builds no bf16 hists
PREDICT_ROWS = 200_000
# training paths of phase 5: name -> (params, the kernel mode it must run);
# the *_u16 paths train on the phase-4 data binned with U16_MAX_BIN
PATHS = {
    "quantized": (dict(use_quantized_grad=True), "hist_rowmajor_int8"),
    "bf16": (dict(tpu_hist_dtype="bfloat16"), "hist_rowmajor_bf16"),
    "level": (dict(tpu_row_scheduling="level"), "hist_level_f32"),
    "level_quantized": (dict(tpu_row_scheduling="level",
                             use_quantized_grad=True), "hist_level_int8"),
    "level_bf16": (dict(tpu_row_scheduling="level",
                        tpu_hist_dtype="bfloat16"), "hist_level_bf16"),
    "full": (dict(tpu_row_scheduling="full"), "hist_featmajor_f32"),
    "full_quantized": (dict(tpu_row_scheduling="full",
                            use_quantized_grad=True), "hist_featmajor_int8"),
    "compact_u16": ({}, "hist_rowmajor_f32_u16"),
    "quantized_u16": (dict(use_quantized_grad=True),
                      "hist_rowmajor_int8_u16"),
    "bf16_u16": (dict(tpu_hist_dtype="bfloat16"), "hist_rowmajor_bf16_u16"),
    "level_u16": (dict(tpu_row_scheduling="level"), "hist_level_f32_u16"),
    "level_quantized_u16": (dict(tpu_row_scheduling="level",
                                 use_quantized_grad=True),
                            "hist_level_int8_u16"),
    "level_bf16_u16": (dict(tpu_row_scheduling="level",
                            tpu_hist_dtype="bfloat16"),
                       "hist_level_bf16_u16"),
    "full_u16": (dict(tpu_row_scheduling="full"), "hist_featmajor_f32_u16"),
    "full_quantized_u16": (dict(tpu_row_scheduling="full",
                                use_quantized_grad=True),
                           "hist_featmajor_int8_u16"),
}


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def synth_higgs(n, f, seed=0):
    """Higgs-shaped synthetic data, generated as bench.py does."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    logits = (X[:, 0] - 0.5 * X[:, 1] * X[:, 2] + 0.25 * X[:, 3] ** 2
              + 0.1 * rng.normal(size=n))
    y = (logits > np.median(logits)).astype(np.float32)
    return X, y


def wrappers():
    from lightgbm_tpu_torch.ops.hist_cuda import hist_cuda_fm, hist_cuda_rm
    from lightgbm_tpu_torch.ops.hist_level_cuda import (carry_order_cuda,
                                                        hist_level_cuda)
    return {"hist_rowmajor": hist_cuda_rm, "hist_level": hist_level_cuda,
            "hist_featmajor": hist_cuda_fm,
            "level_partition": carry_order_cuda}


def reset_counts():
    for fn in wrappers().values():
        if isinstance(fn.launches, int):
            fn.launches = 0
            continue
        for mode in fn.launches:
            fn.launches[mode] = 0


def read_counts():
    """Launches per kernel mode, e.g. ``hist_level_int8`` (a kernel with
    one mode under its own name, ``level_partition``)."""
    counts = {}
    for name, fn in wrappers().items():
        if isinstance(fn.launches, int):
            counts[name] = fn.launches
            continue
        counts.update({f"{name}_{mode}": n
                       for mode, n in fn.launches.items()})
    return counts


def cuda_ms(fn, reps=TIMING_REPS, before=None):
    """Median time of ``fn()`` in ms over ``reps`` calls, each bracketed
    by CUDA events on an idle stream, so the host's time to issue the
    call's launches counts too; ``before()`` runs outside the brackets."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=TIMING_REPS, before=None):
    """Median device time of ``fn()`` in ms over ``reps`` calls, each
    bracketed by CUDA events; every call is enqueued behind a sleep on the
    device that outlasts the host's issuing of all of them, so the time
    between the events is the device's alone. ``before()`` runs outside
    the brackets."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    torch.cuda._sleep(SLEEP_CYCLES_PER_REP * reps)
    for _ in range(reps):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_ms(fn, reps=TIMING_REPS):
    """Median host time in ms to issue ``fn()``, the device held busy by a
    sleep meanwhile so that no call waits on it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES_PER_REP * reps)
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound(bytes_moved, adds):
    """Least time in ms: the bytes at the memory rate or the adds at the
    f32 rate, whichever is longer, and which one it is."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = adds / F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def make_gh(mode, shape, gen, dev, dyadic=False):
    """gh of a kernel mode: int8 over the full range; else normal values,
    or dyadic ones (k / 8, |k| <= 64) that bf16 and f32 hold exactly."""
    if mode == "int8":
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int8)
    if dyadic:
        g = torch.randint(-64, 65, shape, generator=gen, device=dev,
                          dtype=torch.int32).float() / 8
    else:
        g = torch.randn(shape, generator=gen, device=dev)
    return g.to(torch.bfloat16) if mode == "bf16" else g


def check_against_plain(mode, out, ref, what):
    """int8 bit for bit; f32 and bf16 (f32 sums) at rtol=1e-5, atol=1e-4:
    sums of up to 1M values of magnitude ~1 in another order."""
    if mode == "int8":
        assert torch.equal(out, ref), f"{what}: int8 differs from plain"
    else:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4,
                                   msg=f"{what}: differs from plain")
    return float((out.double() - ref.double()).abs().max())


def random_bins(shape, B, gen, dev):
    """Bins in [0, B): uint8 for B <= 256, else u16 bins held as int16
    (the port's storage of them)."""
    b = torch.randint(0, B, shape, generator=gen, device=dev,
                      dtype=torch.int32)
    return b.to(torch.uint8) if B <= 256 else b.to(torch.int16)


def bin_width(B):
    """(bytes of a bin, the launch-count suffix) at B bins."""
    return (1, "") if B <= 256 else (2, "_u16")


def phase_k1(dev, flush):
    """K1 in each mode against its plain version (the chunked two-level
    sum) at the leaf sizes, in u8 at MAX_BIN and in u16 at each of
    U16_BINS; then its small path against its dense path, and its bin
    windows at the u16 bin counts that need more than one."""
    from lightgbm_tpu_torch.ops import hist_cuda
    from lightgbm_tpu_torch.ops.hist_cuda import hist_cuda_rm
    from lightgbm_tpu_torch.ops.histogram import hist_rowmajor_chunked
    F = N_FEATURES
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for B, shapes in [(MAX_BIN, KERNEL_SHAPES)] + [(b, U16_SHAPES)
                                                    for b in U16_BINS]:
        width, suffix = bin_width(B)
        for mode in MODES:
            max_err = 0.0
            for S in shapes:
                what = f"K1 {mode}{suffix} B={B} S={S}"
                bins = random_bins((S, F), B, gen, dev)
                dyadic = make_gh(mode, (S, 3), gen, dev, dyadic=True)
                assert torch.equal(hist_cuda_rm(bins, dyadic, B),
                                   hist_rowmajor_chunked(bins, dyadic, B)), \
                    f"{what}: exact gh differ"
                gh = make_gh(mode, (S, 3), gen, dev)
                out = hist_cuda_rm(bins, gh, B)
                again = hist_cuda_rm(bins, gh, B)
                ref = hist_rowmajor_chunked(bins, gh, B)
                torch.cuda.synchronize()
                err = check_against_plain(mode, out, ref, what)
                max_err = max(max_err, err)
                same_bits = bool(torch.equal(out, again))
                assert same_bits, f"{what}: two launches differ"

                ms = cuda_ms(lambda: hist_cuda_rm(bins, gh, B),
                             before=flush.zero_)
                dev_ms = device_ms(lambda: hist_cuda_rm(bins, gh, B),
                                   before=flush.zero_)
                issue_ms = host_ms(lambda: hist_cuda_rm(bins, gh, B))
                plain_ms = cuda_ms(lambda: hist_rowmajor_chunked(bins, gh, B),
                                   reps=PLAIN_REPS, before=flush.zero_)
                # yardstick: one index_add_ over the flat (feature, bin)
                # slot, the per-cell expansion of gh (widened) made outside
                # the call
                ids = bins.long() & 0xFFFF
                slot = (ids + torch.arange(F, device=dev) * B).reshape(-1)
                del ids
                vals = gh.to(out.dtype).repeat_interleave(F, dim=0)
                acc = torch.zeros(F * B, 3, dtype=out.dtype, device=dev)
                library_ms = cuda_ms(lambda: acc.index_add_(0, slot, vals),
                                     before=lambda: (flush.zero_(),
                                                     acc.zero_()))
                del slot, vals, acc
                # each input byte read once, the output written once; or 3
                # adds per cell
                bound_ms, bound_by = bound(
                    S * F * width + 3 * S * GH_BYTES[gh.dtype]
                    + 12 * F * B, 3 * S * F)
                rows[(mode + suffix, B, S)] = dict(
                    ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=bound_ms,
                    bound_by=bound_by, max_abs_err=max_err)
                log(f"phase 3 hist_rowmajor mode={mode}{suffix} S={S} F={F} "
                    f"B={B} path="
                    f"{'small' if S <= hist_cuda.SMALL_LEAF_ROWS else 'dense'}"
                    f": max_abs_err={err!r} same_bits_two_launches="
                    f"{same_bits} kernel_ms={ms!r} "
                    f"kernel_device_ms={dev_ms!r} host_issue_ms={issue_ms!r} "
                    f"plain_ms={plain_ms!r} index_add_ms={library_ms!r} "
                    f"bound_us={bound_ms * 1e3!r} bound_by={bound_by}")
    # the small path against the dense path, at the same inputs
    limit = hist_cuda.SMALL_LEAF_ROWS
    for S in SMALL_SHAPES:
        bins = random_bins((S, F), MAX_BIN, gen, dev)
        gh = make_gh("f32", (S, 3), gen, dev, dyadic=True)
        ref = hist_rowmajor_chunked(bins, gh, MAX_BIN)
        times = {}
        for path, rows_max in (("small", S), ("dense", S - 1)):
            hist_cuda.SMALL_LEAF_ROWS = rows_max
            assert torch.equal(hist_cuda_rm(bins, gh, MAX_BIN), ref), \
                f"K1 {path} path S={S}: exact gh differ"
            times[path] = (cuda_ms(lambda: hist_cuda_rm(bins, gh, MAX_BIN),
                                   before=flush.zero_),
                           device_ms(lambda: hist_cuda_rm(bins, gh, MAX_BIN),
                                     before=flush.zero_))
        hist_cuda.SMALL_LEAF_ROWS = limit
        log(f"phase 3 hist_rowmajor small_vs_dense S={S} F={F} B={MAX_BIN} "
            f"f32: small_ms={times['small'][0]!r} "
            f"small_device_ms={times['small'][1]!r} "
            f"dense_ms={times['dense'][0]!r} "
            f"dense_device_ms={times['dense'][1]!r} "
            f"small_rows_max={limit}")
    # bin windows: the widest window a block takes, at 1M rows
    window = hist_cuda.WINDOW_BINS
    for B in U16_BINS:
        if B <= min(WINDOW_SIZES):
            continue
        bins = random_bins((N_ROWS, F), B, gen, dev)
        gh = make_gh("f32", (N_ROWS, 3), gen, dev, dyadic=True)
        ref = hist_rowmajor_chunked(bins, gh, B)
        for w in WINDOW_SIZES:
            hist_cuda.WINDOW_BINS = w
            assert torch.equal(hist_cuda_rm(bins, gh, B), ref), \
                f"K1 window={w} B={B}: exact gh differ"
            dev_ms = device_ms(lambda: hist_cuda_rm(bins, gh, B),
                               before=flush.zero_)
            log(f"phase 3 hist_rowmajor window_bins={w} S={N_ROWS} F={F} "
                f"B={B} f32: kernel_device_ms={dev_ms!r}")
        hist_cuda.WINDOW_BINS = window
        del bins, gh, ref
    return rows


def level_cases(gen, dev, nodes=LEVEL_NODES, extras=True):
    """(label, n_nodes, local, in_lvl, parent) over N_ROWS rows: skewed
    segments (node = floor(n * u^3), so low nodes hold most rows) at each
    node count of ``nodes``, then (with ``extras``) every odd node empty,
    then no row in the level.
    ``parent`` is the level above as the level grower holds it (``local``
    and ``in_lvl`` of the parent level, its carried ``order``/``seg``,
    and each row's ``go_left``/``descend``), from which the carried order
    of this level is made; None for the root level (every row in it, in
    row order: nothing to partition)."""
    from lightgbm_tpu_torch.ops.hist_level import node_order
    R = N_ROWS
    skew = lambda n: (torch.rand(R, generator=gen, device=dev) ** 3
                      * n).long().clamp(max=n - 1)
    part = lambda: torch.rand(R, generator=gen, device=dev) < 0.9

    def with_parent(label, n, local, in_lvl):
        if n == 1:
            return label, n, local, in_lvl, None
        n_p = n // 2
        # rows out of this level: half of them sat in the parent level at
        # a node that did not split, half were out of it already
        stay = torch.rand(R, generator=gen, device=dev) < 0.5
        p_local = torch.where(in_lvl, local // 2,
                              torch.randint(0, n_p, (R,), generator=gen,
                                            device=dev))
        p_in = in_lvl | stay
        p_order, p_seg = node_order(p_local, p_in, n_p)
        return label, n, local, in_lvl, dict(
            local=p_local, order=p_order, seg=p_seg,
            go_left=local % 2 == 0, descend=in_lvl)

    for n in nodes:
        yield with_parent(f"skewed n={n}", n, skew(n), part())
    if not extras:
        return
    yield with_parent("odd nodes empty n=64", 64, skew(64) // 2 * 2, part())
    yield with_parent("no row in the level n=8", 8, skew(8),
                      torch.zeros(R, dtype=torch.bool, device=dev))


def phase_k2(dev, flush):
    """K2 in each mode against its plain version over 1M rows, fed the
    node order that the card's partition (``carry_order_cuda``) carries
    from the parent level; the per-level time counts the partition too.
    The partition itself is held against its plain version and the
    stable sort. u8 bins at MAX_BIN over every level case, u16 bins at
    each of U16_BINS over U16_LEVEL_NODES."""
    R, F = N_ROWS, N_FEATURES
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = {}
    for B, nodes, extras in [(MAX_BIN, LEVEL_NODES, True)] + [
            (b, U16_LEVEL_NODES, False) for b in U16_BINS]:
        bins = random_bins((R, F), B, gen, dev)
        for case in level_cases(gen, dev, nodes, extras):
            phase_k2_case(dev, flush, gen, bins, B, case, rows)
        del bins
    return rows


def phase_k2_case(dev, flush, gen, bins, B, case, rows):
    """One level case of ``phase_k2`` over ``bins`` at B bins; the
    partition is checked and timed in the u8 pass only."""
    from lightgbm_tpu_torch.ops.hist_level import (carry_order, hist_level,
                                                   level_keys, node_order)
    from lightgbm_tpu_torch.ops.hist_level_cuda import (carry_order_cuda,
                                                        hist_level_cuda)
    R, F = N_ROWS, N_FEATURES
    width, suffix = bin_width(B)
    label, n, local, in_lvl, parent = case
    in_rows = int(in_lvl.sum())
    ref_order, ref_seg = node_order(local, in_lvl, n)
    if parent is None:
        level = lambda: (ref_order, ref_seg)
    else:
        args = (parent["order"], parent["seg"], parent["local"],
                parent["go_left"], parent["descend"])
        level = lambda: carry_order_cuda(*args)
    if parent is not None and B == MAX_BIN:
        order, seg = level()
        again = level()
        plain = carry_order(*args)
        assert torch.equal(order, ref_order) and \
            torch.equal(seg, ref_seg), \
            f"partition {label}: not the stable sort"
        # the largest difference from the stable sort, order or bounds
        part_err = float(max((order - ref_order).abs().max(),
                             (seg - ref_seg).abs().max()))
        assert torch.equal(order, plain[0]) and \
            torch.equal(seg, plain[1]), f"partition {label}: not plain"
        assert torch.equal(order, again[0]) and \
            torch.equal(seg, again[1]), f"partition {label}: two launches"
        part_ms = cuda_ms(level, before=flush.zero_)
        part_dev_ms = device_ms(level, before=flush.zero_)
        part_plain_ms = cuda_ms(lambda: carry_order(*args),
                                reps=PLAIN_REPS, before=flush.zero_)
        # yardstick: one stable torch.sort of the level's node keys
        # (made outside the call), the permutation the JAX package
        # computes
        keys = level_keys(local, in_lvl, n)
        sort_ms = cuda_ms(lambda: torch.sort(keys, stable=True),
                          before=flush.zero_)
        del keys
        # read once: the parent's order, each row's int64 node and
        # two bools, the parent's bounds; written once: the order and
        # the bounds. Its work is a scan and a scatter, no arithmetic
        # to speak of
        part_bound, part_by = bound(8 * R + 8 * R + 2 * R + 8 * R
                                    + 8 * (n // 2 + 1) + 8 * (n + 1), 0)
        rows[("partition", B, label)] = dict(
            ms=part_ms, device_ms=part_dev_ms, plain_ms=part_plain_ms,
            library_ms=sort_ms, bound_ms=part_bound, bound_by=part_by,
            max_abs_err=part_err)
        log(f"phase 3 level_partition {label} R={R}: equals_stable_sort"
            f"=True equals_plain=True same_bits_two_launches=True "
            f"max_abs_err={part_err!r} "
            f"kernel_ms={part_ms!r} kernel_device_ms={part_dev_ms!r} "
            f"plain_ms={part_plain_ms!r} "
            f"torch_sort_ms={sort_ms!r} bound_us={part_bound * 1e3!r} "
            f"bound_by={part_by}")
    order, seg = level()
    for mode in MODES:
        what = f"K2 {mode}{suffix} B={B} {label}"
        call = lambda g, **kw: hist_level_cuda(bins, g, local, in_lvl, n,
                                               B, order=order, seg=seg,
                                               **kw)
        dyadic = make_gh(mode, (R, 3), gen, dev, dyadic=True)
        ref = hist_level(bins, dyadic, local, in_lvl, n, B)
        assert torch.equal(call(dyadic), ref), f"{what}: exact gh differ"
        assert torch.equal(
            hist_level_cuda(bins, dyadic, local, in_lvl, n, B), ref), \
            f"{what}: exact gh differ without the carried order"
        gh = make_gh(mode, (R, 3), gen, dev)
        out = call(gh)
        again = call(gh)
        ref = hist_level(bins, gh, local, in_lvl, n, B)
        torch.cuda.synchronize()
        err = check_against_plain(mode, out, ref, what)
        same_bits = bool(torch.equal(out, again))
        assert same_bits, f"{what}: two launches differ"
        if label.startswith("odd"):
            assert not out[1::2].any(), f"{what}: empty nodes not zero"
        if in_rows == 0:
            assert not out.any(), f"{what}: no rows but nonzero sums"

        def per_level():
            o, sg = level()
            return hist_level_cuda(bins, gh, local, in_lvl, n, B,
                                   order=o, seg=sg)

        ms = cuda_ms(per_level, before=flush.zero_)
        dev_ms = device_ms(per_level, before=flush.zero_)
        issue_ms = host_ms(per_level)
        kernel_ms = cuda_ms(lambda: call(gh), before=flush.zero_)
        kernel_dev_ms = device_ms(lambda: call(gh), before=flush.zero_)
        plain_ms = cuda_ms(
            lambda: hist_level(bins, gh, local, in_lvl, n, B),
            reps=PLAIN_REPS, before=flush.zero_)
        # yardstick: one index_add_ over the flat (node, feature, bin)
        # slot, rows out of the level in a dump node
        key = torch.where(in_lvl, local, n)
        slot = ((key * F)[:, None] + torch.arange(F, device=dev)) * B \
            + (bins.long() & 0xFFFF)
        vals = gh.to(out.dtype).repeat_interleave(F, dim=0)
        acc = torch.zeros((n + 1) * F * B, 3, dtype=out.dtype,
                          device=dev)
        add = lambda: acc.index_add_(0, slot.reshape(-1), vals)
        library_ms = cuda_ms(add, before=lambda: (flush.zero_(),
                                                  acc.zero_()))
        library_dev_ms = device_ms(add, before=lambda: (flush.zero_(),
                                                        acc.zero_()))
        del key, slot, vals, acc, add
        # the per-level function's inputs read once (bins, gh, int64
        # local and the parent's int64 order, bool go_left and
        # descend; at the root int64 local and bool in_lvl) and its
        # output written once; or 3 adds per cell of the level's rows
        in_bytes = 8 * R + (8 * R + 2 * R if parent is not None else R)
        bound_ms, bound_by = bound(
            R * F * width + 3 * R * GH_BYTES[gh.dtype] + in_bytes
            + 12 * n * F * B, 3 * in_rows * F)
        rows[(mode + suffix, B, label)] = dict(ms=ms, device_ms=dev_ms,
                                   plain_ms=plain_ms,
                                   library_ms=library_ms,
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   max_abs_err=err)
        log(f"phase 3 hist_level mode={mode}{suffix} {label} R={R} "
            f"F={F} B={B} "
            f"rows_in_level={in_rows}: max_abs_err={err!r} "
            f"same_bits_two_launches={same_bits} "
            f"per_level_ms={ms!r} per_level_device_ms={dev_ms!r} "
            f"per_level_host_issue_ms={issue_ms!r} "
            f"kernel_call_ms={kernel_ms!r} "
            f"kernel_call_device_ms={kernel_dev_ms!r} "
            f"plain_ms={plain_ms!r} index_add_ms={library_ms!r} "
            f"index_add_device_ms={library_dev_ms!r} "
            f"per_level_over_index_add={ms / library_ms!r} "
            f"per_level_over_index_add_device="
            f"{dev_ms / library_dev_ms!r} "
            f"bound_us={bound_ms * 1e3!r} bound_by={bound_by}")


def phase_b2(dev, flush):
    """B2 in each mode against its plain version (the chunked two-level
    sum) over 1M feature-major rows, in u8 at MAX_BIN and in u16 at each
    of U16_BINS: the fused form (each row's leaf id read by the kernel,
    only the leaf's rows added) for leaves of each size, timed beside the
    unfused form (gh masked by two torch ops, then a pass over every row);
    then, at MAX_BIN and U16_MAX_BIN, a ragged row count, with and without
    the engine's 16-element row padding."""
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {}
    for B, shapes in [(MAX_BIN, KERNEL_SHAPES)] + [(b, U16_SHAPES)
                                                    for b in U16_BINS]:
        phase_b2_bins(dev, flush, gen, B, shapes, rows)
    return rows


def phase_b2_bins(dev, flush, gen, B, shapes, rows):
    """``phase_b2`` at B bins."""
    from lightgbm_tpu_torch.ops.hist_cuda import (feature_major_bins,
                                                  hist_cuda_fm)
    from lightgbm_tpu_torch.ops.histogram import (
        hist_featmajor_chunked as hist_featmajor)
    R, F = N_ROWS, N_FEATURES
    width, suffix = bin_width(B)
    bins = random_bins((F, R), B, gen, dev)

    def leaf_ids(n, S):
        """int64 leaf ids of n rows, S of them in leaf 0, the rest in
        leaves 1..8."""
        ids = torch.randint(1, 9, (n,), generator=gen, device=dev)
        ids[torch.randperm(n, generator=gen, device=dev)[:S]] = 0
        return ids

    def masked(gh, ids):
        return gh * (ids == 0)[:, None].to(gh.dtype)

    for mode in FM_MODES:
        for S in shapes:
            what = f"B2 {mode}{suffix} B={B} leaf rows={S}"
            ids = leaf_ids(R, S)
            fused = lambda g: hist_cuda_fm(bins, g, B, leaf_id=ids, leaf=0)
            unfused = lambda g: hist_cuda_fm(bins, masked(g, ids), B)
            dyadic = make_gh(mode, (R, 3), gen, dev, dyadic=True)
            ref = hist_featmajor(bins, masked(dyadic, ids), B)
            assert torch.equal(fused(dyadic), ref), f"{what}: exact gh differ"
            assert torch.equal(unfused(dyadic), ref), \
                f"{what}: exact gh differ, unfused"
            gh = make_gh(mode, (R, 3), gen, dev)
            out = fused(gh)
            again = fused(gh)
            ref = hist_featmajor(bins, masked(gh, ids), B)
            torch.cuda.synchronize()
            err = check_against_plain(mode, out, ref, what)
            check_against_plain(mode, unfused(gh), ref, what + " unfused")
            same_bits = bool(torch.equal(out, again))
            assert same_bits, f"{what}: two launches differ"

            ms = cuda_ms(lambda: fused(gh), before=flush.zero_)
            dev_ms = device_ms(lambda: fused(gh), before=flush.zero_)
            issue_ms = host_ms(lambda: fused(gh))
            unfused_ms = cuda_ms(lambda: unfused(gh), before=flush.zero_)
            unfused_dev_ms = device_ms(lambda: unfused(gh),
                                       before=flush.zero_)
            gh_m = masked(gh, ids)
            pass_ms = device_ms(lambda: hist_cuda_fm(bins, gh_m, B),
                                before=flush.zero_)
            plain_ms = cuda_ms(
                lambda: hist_featmajor(bins, masked(gh, ids), B),
                reps=PLAIN_REPS, before=flush.zero_)
            # yardstick: one index_add_ over the flat (feature, bin) slot
            # of every cell, the per-cell gh (masked, widened) made outside
            # the call, with the cells in feature-major and in row-major
            # order (K1's); the faster of the two is the library's time
            index_add_ms = {}
            for order in ("feature_major", "row_major"):
                cells = bins.T if order == "row_major" else bins
                off = torch.arange(F, device=dev) * B
                slot = ((cells.long() & 0xFFFF)
                        + (off if order == "row_major"
                           else off[:, None])).reshape(-1)
                vals = (gh_m.to(out.dtype).repeat_interleave(F, dim=0)
                        if order == "row_major"
                        else gh_m.to(out.dtype).repeat(F, 1))
                acc = torch.zeros(F * B, 3, dtype=out.dtype, device=dev)
                index_add_ms[order] = cuda_ms(
                    lambda: acc.index_add_(0, slot, vals),
                    before=lambda: (flush.zero_(), acc.zero_()))
                del cells, slot, vals, acc
            library_ms = min(index_add_ms.values())
            # the bytes the fused function must move: every row's int64
            # leaf id, the leaf's S rows (bins and gh) and the output; or
            # 3 adds per cell of the leaf's rows
            bound_ms, bound_by = bound(
                8 * R + S * (F * width + 3 * GH_BYTES[gh.dtype])
                + 12 * F * B, 3 * S * F)
            rows[(mode + suffix, B, S)] = dict(ms=ms, device_ms=dev_ms,
                                   plain_ms=plain_ms, library_ms=library_ms,
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   max_abs_err=err)
            log(f"phase 3 hist_featmajor mode={mode}{suffix} R={R} "
                f"leaf_rows={S} "
                f"F={F} B={B}: max_abs_err={err!r} "
                f"same_bits_two_launches={same_bits} fused_ms={ms!r} "
                f"fused_device_ms={dev_ms!r} "
                f"fused_host_issue_ms={issue_ms!r} "
                f"unfused_ms={unfused_ms!r} "
                f"unfused_device_ms={unfused_dev_ms!r} "
                f"masked_pass_device_ms={pass_ms!r} "
                f"fused_over_unfused={ms / unfused_ms!r} "
                f"fused_over_unfused_device={dev_ms / unfused_dev_ms!r} "
                f"plain_ms={plain_ms!r} "
                f"index_add_ms_feature_major={index_add_ms['feature_major']!r} "
                f"index_add_ms_row_major={index_add_ms['row_major']!r} "
                f"bound_us={bound_ms * 1e3!r} bound_by={bound_by}")
        # ragged: R' = 100,003 rows, once with the row stride R' (element
        # loads throughout) and once in the engine's padded device copy
        # (row stride 100,016: vector loads, element loads at each row's
        # tail)
        if B not in (MAX_BIN, U16_MAX_BIN):
            continue
        Rr = 100_003
        sub = bins[:, :Rr].contiguous()
        host = sub.T.cpu().numpy()
        padded = feature_major_bins(host.view(np.uint16) if width == 2
                                    else host, dev)
        assert padded.stride(0) == 100_016 and torch.equal(padded, sub)
        ids = leaf_ids(Rr, 40_000)
        for layout, b in (("unpadded", sub), ("padded", padded)):
            what = (f"B2 {mode}{suffix} B={B} ragged R={Rr} {layout} "
                    f"ld={b.stride(0)}")
            dyadic = make_gh(mode, (Rr, 3), gen, dev, dyadic=True)
            assert torch.equal(hist_cuda_fm(b, dyadic, B),
                               hist_featmajor(sub, dyadic, B)), \
                f"{what}: exact gh differ"
            assert torch.equal(
                hist_cuda_fm(b, dyadic, B, leaf_id=ids, leaf=0),
                hist_featmajor(sub, masked(dyadic, ids), B)), \
                f"{what}: exact gh differ, fused"
            gh = make_gh(mode, (Rr, 3), gen, dev)
            out = hist_cuda_fm(b, gh, B, leaf_id=ids, leaf=0)
            err = check_against_plain(
                mode, out, hist_featmajor(sub, masked(gh, ids), B), what)
            assert torch.equal(out, hist_cuda_fm(b, gh, B, leaf_id=ids,
                                                 leaf=0)), \
                f"{what}: two launches differ"
            log(f"phase 3 hist_featmajor mode={mode}{suffix} ragged R={Rr} "
                f"{layout} ld={b.stride(0)} F={F} B={B} leaf_rows=40000: "
                f"max_abs_err={err!r} exact_gh_bit_for_bit=True "
                "same_bits_two_launches=True")


def bench_params(**extra):
    p = {"objective": "binary", "num_leaves": NUM_LEAVES,
         "learning_rate": 0.1, "max_bin": MAX_BIN, "min_data_in_leaf": 20,
         "metric": ["binary_logloss", "auc"], "verbose": -1,
         "device_type": "cuda", "use_quantized_grad": False,
         "tpu_hist_dtype": "float32", "tpu_row_scheduling": "compact"}
    p.update(extra)
    return p


def train_timed(ds, params, iters):
    """Warm-up plus ``iters`` timed iterations with the launch counts
    zeroed just before and read just after; the peak device memory of
    the run is counted above what was allocated when it started (earlier
    phases' boosters stay alive)."""
    import lightgbm_tpu_torch as lgt
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    bst = lgt.Booster(params, ds)
    t = time.perf_counter()
    assert not bst.update()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    first = dict((m, v) for _, m, v, _ in bst.eval_train())
    iter_s = []
    for _ in range(iters):
        t = time.perf_counter()
        assert not bst.update()
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() - base
    last = dict((m, v) for _, m, v, _ in bst.eval_train())
    assert last["binary_logloss"] < first["binary_logloss"], (first, last)
    assert last["auc"] > 0.7, last
    return bst, dict(warm_s=warm_s, iter_s=iter_s,
                     median_iter_s=statistics.median(iter_s), counts=counts,
                     peak_bytes=peak, first=first, last=last)


def phase_main_path():
    """Full-width training through the user entry points."""
    import lightgbm_tpu_torch as lgt
    t0 = time.perf_counter()
    X, y = synth_higgs(N_ROWS, N_FEATURES)
    ds = lgt.Dataset(X, label=y).construct()
    log(f"phase 4 data+binning_s={time.perf_counter() - t0!r} "
        f"shape={X.shape}")
    bst, r = train_timed(ds, bench_params(), TIMED_ITERS)
    leaves = [t.num_leaves for t in bst._engine.models]
    log(f"phase 4 warmup_s={r['warm_s']!r} iter_s={r['iter_s']!r} "
        f"median_iter_s={r['median_iter_s']!r} launches={r['counts']} "
        f"leaves_per_tree={leaves} "
        f"peak_bytes_above_start={r['peak_bytes']} "
        f"logloss_first={r['first']} logloss_last={r['last']}")
    launches = r["counts"]["hist_rowmajor_f32"]
    assert launches > 0 and launches == sum(leaves), (launches, leaves)
    assert sum(r["counts"].values()) == launches, r["counts"]
    # predictions: finite, right shape, and equal to the training score
    Xp = X[:20000]
    raw = bst.predict(Xp, raw_score=True)
    prob = bst.predict(Xp)
    assert raw.shape == prob.shape == (len(Xp),)
    assert np.isfinite(raw).all() and ((prob > 0) & (prob < 1)).all()
    train_raw = bst._engine.score[0, :len(Xp)].cpu().numpy()
    np.testing.assert_allclose(raw, train_raw, rtol=0, atol=1e-4)
    log("phase 4 predict ok: host walk equals the training score")
    return r["counts"], bst, ds, X


TREE_FIELDS = ("split_feature", "threshold_bin", "default_left",
               "left_child", "right_child", "internal_count", "leaf_count",
               "leaf_value")


def phase_paths(ds, X, compact_first):
    """The slice's other paths on the phase-4 dataset, the *_u16 ones on
    the same rows binned with U16_MAX_BIN; returns each path's launch
    counts and its booster."""
    import lightgbm_tpu_torch as lgt
    t0 = time.perf_counter()
    y = ds.label
    ds_u16 = lgt.Dataset(X, label=y, params={"max_bin": U16_MAX_BIN,
                                             "verbose": -1}).construct()
    bins_u16 = ds_u16.binned.bins
    assert bins_u16.dtype == np.uint16, bins_u16.dtype
    log(f"phase 5 binning_u16_s={time.perf_counter() - t0!r} "
        f"max_bin={U16_MAX_BIN} bins_dtype={bins_u16.dtype} "
        f"num_bin_max={max(m.num_bin for m in ds_u16.binned.bin_mappers)}")
    out = {}
    for name, (extra, must) in PATHS.items():
        u16 = name.endswith("_u16")
        params = bench_params(**extra)
        if u16:
            params["max_bin"] = U16_MAX_BIN
        bst, r = train_timed(ds_u16 if u16 else ds, params,
                             U16_ITERS if u16 else MODE_ITERS)
        trees = bst._engine.models
        c = r["counts"]
        log(f"phase 5 path={name} warmup_s={r['warm_s']!r} "
            f"iter_s={r['iter_s']!r} median_iter_s={r['median_iter_s']!r} "
            f"launches={c} leaves_per_tree={[t.num_leaves for t in trees]} "
            f"peak_bytes_above_start={r['peak_bytes']} "
            f"logloss_first={r['first']} logloss_last={r['last']}")
        assert c[must] > 0, (name, c)
        if name.startswith("level"):
            # every split not committed by the level phase is a tail split
            # with one K1 launch (the smaller child)
            tail = sum(n for k, n in c.items()
                       if k.startswith("hist_rowmajor"))
            splits = sum(t.num_leaves - 1 for t in trees)
            log(f"phase 5 path={name} splits_per_tree={splits / len(trees)!r}"
                f" committed_by_level_phase_per_tree="
                f"{(splits - tail) / len(trees)!r}")
            # the hybrid scans depths 0..D0 (D0 = 9 at 255 leaves): one
            # level launch each per tree
            from lightgbm_tpu_torch.core.hybrid_grower import \
                auto_handoff_depth
            d0 = auto_handoff_depth(bst._engine.config.num_leaves)
            assert c[must] >= (d0 + 1) * len(trees), (name, c)
            # the node order carried from each level to the next
            assert c["level_partition"] >= d0 * len(trees), (name, c)
        if name.startswith("full"):
            # a masked full pass for the root and for the smaller child
            # of every split: one per leaf; and nothing of K1 or K2
            assert c[must] == sum(t.num_leaves for t in trees), (name, c)
            assert sum(c.values()) == c[must], (name, c)
        if name in ("level", "level_u16"):
            # the hybrid ranks its level phase's splits as the JAX package
            # does, so its node numbering may differ from the compact
            # tree's: the same splits, and the same output on every row
            if name == "level_u16":
                compact_first = out["compact_u16"][1]._engine.models[0]
            first = trees[0]
            split_set = lambda t: sorted(zip(t.split_feature.tolist(),
                                             t.threshold_real.tolist()))
            assert split_set(first) == split_set(compact_first), \
                "level first tree's splits differ from the compact one's"
            Xs = np.asarray(X[:PREDICT_ROWS], np.float64)
            np.testing.assert_array_equal(
                first.leaf_value[first.predict_leaf(Xs)],
                compact_first.leaf_value[compact_first.predict_leaf(Xs)],
                err_msg="level first tree's outputs differ")
            log(f"phase 5 level first tree holds the compact first tree's "
                f"{first.num_leaves - 1} splits and gives its output on "
                f"{len(Xs)} rows")
        if name in ("full_quantized", "full_quantized_u16"):
            ref = out[name.replace("full_", "")][1]._engine.models[0]
            first = trees[0]
            for f in TREE_FIELDS:
                np.testing.assert_array_equal(
                    getattr(first, f), getattr(ref, f),
                    err_msg=f"{name} first tree differs in {f}")
            log(f"phase 5 {name} first tree equals the quantized first "
                f"tree: {first.num_leaves} leaves, depth {first.max_depth}")
        if name == "quantized":
            draw_ms = threefry_draw_ms(bst)
            log(f"phase 5 path={name} threefry_draws_device_ms_per_tree="
                f"{draw_ms!r} rows={N_ROWS}")
        out[name] = (c, bst)
    return out, ds_u16


def threefry_draw_ms(bst):
    """Device time of one tree's stochastic-rounding draws: the key chain
    (host) and two threefry uniforms of every row on the card."""
    from lightgbm_tpu_torch.utils import prng
    eng = bst._engine
    key = eng._rng_key
    assert key is not None

    def draw():
        keys = prng.split(prng.fold_in(key, eng.current_iteration()))
        return [prng.uniform(k, eng.num_data, eng.device) for k in keys]

    return device_ms(draw)


def phase_profile(bst, label, iters=2):
    """Where an iteration's time goes: ``torch.profiler`` over ``iters``
    more boosting iterations; prints the device's busy share of the wall
    time, the ops with the most device time and the most host time, and
    the kernel launches and device-to-host copies per iteration."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(iters):
            assert not bst.update()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    events = prof.key_averages()
    dev_us = lambda e: e.self_device_time_total
    # kernels, copies and memsets, each once (the ops that launched them
    # carry the same time again); one stream, so the sum is busy time
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(dev_us(e) for e in on_device) / 1e6
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cuLaunchKernelEx", "cudaLaunchKernelExC"))
    syncs = sum(e.count for e in events
                if e.key in ("cudaStreamSynchronize", "cudaMemcpyAsync"))
    d2h = sum(e.count for e in on_device if "DtoH" in e.key)
    log(f"phase profile {label} iters={iters} wall_s={wall_s!r} "
        f"device_busy_s={busy_s!r} device_busy_share={busy_s / wall_s!r} "
        f"kernel_launches_per_iter={launches / iters!r} "
        f"memcpy_or_sync_calls_per_iter={syncs / iters!r} "
        f"device_to_host_copies_per_iter={d2h / iters!r}")
    # the histogram kernels' own device time: K1's (both paths) and K2's
    # without the reductions of their blocks' partials, B2's with its
    # mask pass and its sparse pass; then the reductions (K1's and B2's
    # reduce_flagged, K2's reduce_nodes). B2's kernels and reductions
    # start by programmatic dependent launch, so a span may include the
    # wait for the kernel before: those sums are upper bounds
    for kname, keys in (("K1", ("hist_rowmajor_kernel",
                                "hist_rowmajor_small")),
                        ("K2", ("hist_level_kernel",)),
                        ("B2", ("batch_masks", "hist_featmajor_kernel",
                                "hist_sparse_kernel")),
                        ("reductions", ("reduce_flagged", "reduce_nodes"))):
        hits = [e for e in on_device if any(k in e.key for k in keys)]
        if hits:
            log(f"phase profile {label} {kname}_device_ms_per_iter="
                f"{sum(dev_us(e) for e in hits) / 1e3 / iters!r} "
                f"launches_per_iter={sum(e.count for e in hits) / iters!r}")
    for e in sorted(on_device, key=dev_us, reverse=True)[:10]:
        log(f"phase profile {label} device {e.key[:90]!r} count={e.count} "
            f"device_ms={dev_us(e) / 1e3!r}")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        log(f"phase profile {label} host {e.key[:70]!r} count={e.count} "
            f"self_cpu_ms={e.self_cpu_time_total / 1e3!r}")


def phase_cross_check():
    """cuda against cpu on small runs of the compact, quantized (with the
    default stochastic rounding: both devices draw the same threefry
    bits), level and full paths, in u8 and in u16 bins (max_bin =
    U16_MAX_BIN)."""
    import lightgbm_tpu_torch as lgt
    # a row count that is not a multiple of 16: the full path's device
    # bins are padded (feature_major_bins)
    X, y = synth_higgs(20_003, N_FEATURES, seed=1)
    for name, extra in (("compact", {}),
                        ("quantized", {"use_quantized_grad": True}),
                        ("level", {"tpu_row_scheduling": "level",
                                   "max_depth": -1}),
                        ("full", {"tpu_row_scheduling": "full"}),
                        ("compact_u16", {"max_bin": U16_MAX_BIN}),
                        ("quantized_u16", {"max_bin": U16_MAX_BIN,
                                           "use_quantized_grad": True}),
                        ("level_u16", {"max_bin": U16_MAX_BIN,
                                       "tpu_row_scheduling": "level",
                                       "max_depth": -1}),
                        ("full_u16", {"max_bin": U16_MAX_BIN,
                                      "tpu_row_scheduling": "full"})):
        out = {}
        for dev in ("cuda", "cpu"):
            params = {"objective": "binary", "num_leaves": 31,
                      "max_bin": MAX_BIN, "verbose": -1, "device_type": dev,
                      **extra}
            ds = lgt.Dataset(X, label=y, params={"max_bin":
                                                 params["max_bin"]})
            bst = lgt.train(params, ds, num_boost_round=3, valid_sets=None)
            if name.endswith("_u16"):
                assert ds.binned.bins.dtype == np.uint16, name
            t0 = bst._engine.models[0]
            loss = dict((m, v) for _, m, v, _ in bst.eval_train())
            out[dev] = (int(t0.split_feature[0]), float(t0.threshold_real[0]),
                        int(t0.decision_type[0]), loss["binary_logloss"])
        log(f"phase 6 {name} root_split_and_logloss cuda={out['cuda']} "
            f"cpu={out['cpu']}")
        assert out["cuda"][:3] == out["cpu"][:3], name
        np.testing.assert_allclose(out["cuda"][3], out["cpu"][3], rtol=1e-4)


def phase_predict(bst, ds, X, label="u8"):
    """Device prediction of a phase-4/5 model (``label`` names its bins):
    the binned route, and the raw route of a booster over the same trees
    without the training bin mappers, against the host walk; rows/s of
    each."""
    from lightgbm_tpu_torch.convert import TREE_FIELDS as CARRY, \
        booster_from_arrays
    from lightgbm_tpu_torch.ops.forest import snapshot_leaves
    eng = bst._engine
    binned = ds.binned
    raw_bst = booster_from_arrays(
        bench_params(), [{f: getattr(t, f) for f in CARRY}
                         for t in eng.models],
        binned.bin_mappers, binned.used_feature_map)
    Xp = np.asarray(X[:PREDICT_ROWS], np.float64)
    n_trees = len(eng.models)
    timed = {}
    for name, b, dev_route in (("host_walk", bst, False),
                               ("binned", bst, True),
                               ("raw", raw_bst, True)):
        b.predict(Xp[:1000], device=dev_route, raw_score=True)   # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        timed[name] = b.predict(Xp, device=dev_route, raw_score=True)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        log(f"phase 7 predict bins={label} route={name} rows={len(Xp)} "
            f"trees={n_trees} "
            f"seconds={sec!r} rows_per_s={len(Xp) / sec!r}")
    host_leaf = np.stack([t.predict_leaf(Xp) for t in eng.models])
    for name, b in (("binned", bst), ("raw", raw_bst)):
        e = b._engine
        pack = e._serving.raw_pack if name == "raw" else e._serving.pack
        assert pack.count == n_trees, (name, pack.count)
        assert e._serving.device.type == "cuda"
        # the device route answered the Booster (it falls back to the host
        # walk only on DeviceRouteUnavailable, which the engine's own call
        # would raise here): the same bits as the engine's device scores
        np.testing.assert_array_equal(
            timed[name], e.predict_device(Xp, 0, n_trees)[:, 0],
            err_msg=f"{name}: the Booster did not use the device route")
        np.testing.assert_allclose(timed[name], timed["host_walk"], rtol=0,
                                   atol=1e-5, err_msg=name)
        mappers = (e._serving_mappers if name == "binned" else None)
        snap = e._serving.snapshot(
            e.models, e._model_gen, 0, n_trees, mappers,
            binned.used_feature_map if mappers is not None else None)
        np.testing.assert_array_equal(snapshot_leaves(snap, Xp), host_leaf,
                                      err_msg=f"{name} leaves")
        log(f"phase 7 predict bins={label} route={name}: scores within "
            f"1e-5 of the host "
            f"walk (max_abs_diff="
            f"{float(np.abs(timed[name] - timed['host_walk']).max())!r}), "
            "every leaf equal")


SOURCES = {
    "hist_rowmajor": ("lightgbm_tpu_torch/csrc/hist_rowmajor.cu",
                      "lightgbm_tpu/ops/hist_pallas.py:52"),
    "hist_level": ("lightgbm_tpu_torch/csrc/hist_level.cu",
                   "lightgbm_tpu/ops/hist_level_pallas.py:83"),
    "hist_featmajor": ("lightgbm_tpu_torch/csrc/hist_featmajor.cu",
                       "lightgbm_tpu/ops/hist_pallas.py:214"),
    # the stable sort by node that feeds the TPU kernel K2 replaces
    "level_partition": ("lightgbm_tpu_torch/csrc/hist_level.cu",
                        "lightgbm_tpu/ops/hist_level_pallas.py:242"),
}


def probe_uint16(dev):
    """Which torch.uint16 ops the card's torch serves: ok or the error."""
    a = torch.tensor([1, 300, 65535], dtype=torch.int32).to(torch.uint16)
    found = {}
    for op, fn in (("copy_to_card", lambda: a.to(dev)),
                   ("index_select", lambda: a.to(dev).index_select(
                       0, torch.tensor([2, 0], device=dev))),
                   ("to_int32", lambda: a.to(dev).to(torch.int32)),
                   ("le", lambda: a.to(dev) <= 300)):
        try:
            fn()
            found[op] = "ok"
        except Exception as e:        # noqa: BLE001 - logged, not hidden
            found[op] = f"{type(e).__name__}: {str(e)[:60]}"
    return found


def kernel_entry(name, mode, launches, row):
    source, replaces = SOURCES[name]
    return {"name": name if mode is None else f"{name}_{mode}",
            "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "device_ms": row["device_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    from lightgbm_tpu_torch import _build
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    log(f"phase 1 torch={torch.__version__} cuda={torch.version.cuda} "
        f"python={sys.version.split()[0]} card={smi}")
    log(f"phase 1 torch.uint16 on the card: {probe_uint16(dev)} (the port "
        "holds u16 bins as int16 and needs none of these)")

    t = time.perf_counter()
    names = _build.kernel_names()
    _build.build_all(names)
    log(f"phase 2 built {names} in {time.perf_counter() - t!r} s")
    for name, report in _build.build_logs.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"phase 2 {name}: {line.strip()}")

    # a buffer larger than the 50 MB L2, rewritten before each timed call
    # so that every call reads its inputs from device memory
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    k1 = phase_k1(dev, flush)
    k2 = phase_k2(dev, flush)
    b2 = phase_b2(dev, flush)
    del flush
    compact_counts, bst, ds, X = phase_main_path()
    paths, ds_u16 = phase_paths(ds, X, bst._engine.models[0])
    if "--profile" in sys.argv[1:]:
        phase_profile(bst, "compact")
        phase_profile(paths["level"][1], "level")
        phase_profile(paths["full"][1], "full")
    # each mode's launches from the run of the path that carries it
    runs = {"hist_rowmajor_f32": compact_counts}
    for name, (_, must) in PATHS.items():
        runs[must] = paths[name][0]
    bst_u16 = paths["compact_u16"][1]
    del paths
    phase_predict(bst, ds, X)
    phase_predict(bst_u16, ds_u16, X, label="u16")
    del bst, ds, X, bst_u16, ds_u16
    phase_cross_check()

    kernels = []
    level = f"skewed n={LEVEL_NODES[-1]}"
    for B in (MAX_BIN, U16_MAX_BIN):
        suffix = bin_width(B)[1]
        for mode in MODES:
            key = f"hist_rowmajor_{mode}{suffix}"
            kernels.append(kernel_entry(
                "hist_rowmajor", mode + suffix, runs[key][key],
                k1[(mode + suffix, B, N_ROWS)]))
        for mode in MODES:
            key = f"hist_level_{mode}{suffix}"
            kernels.append(kernel_entry(
                "hist_level", mode + suffix, runs[key][key],
                k2[(mode + suffix, B, level)]))
        for mode in FM_MODES:
            key = f"hist_featmajor_{mode}{suffix}"
            kernels.append(kernel_entry(
                "hist_featmajor", mode + suffix, runs[key][key],
                b2[(mode + suffix, B, N_ROWS)]))
    kernels.append(kernel_entry(
        "level_partition", None, runs["hist_level_f32"]["level_partition"],
        k2[("partition", MAX_BIN, level)]))
    assert all(k["launches"] > 0 for k in kernels), kernels
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
