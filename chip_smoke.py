"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--profile]

Phases, each reported on its own line:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: every kernel under lightgbm_tpu_torch/csrc, one nvcc each, in
   parallel;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the training path gives it, with its time, the plain version's
   time, one PyTorch library call's time and its bound on the card;
4. the main path at full width: ``Booster`` training of a Higgs-shaped
   binary GBDT (1,000,000 x 28, 255 leaves, 255 bins) for one warm-up and
   a few timed iterations, then ``predict``; the kernel launch counts of
   this run show that training went through the kernels; with
   ``--profile``, two more iterations under ``torch.profiler`` show where
   an iteration's time goes (device busy share, top ops on the device and
   on the host, launches per iteration);
5. the same small training on cuda and on the CPU (plain versions),
   which must agree.

Any failure raises and exits non-zero. The last three lines are the
card's name and power limit, one JSON object describing every kernel,
and ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
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
TIMED_ITERS = 5
KERNEL_SHAPES = (1_000_000, 65_536, 4_097, 1)
TIMING_REPS = 20


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


def cuda_ms(fn, reps=TIMING_REPS, before=None):
    """Median device time of ``fn()`` in ms over ``reps`` calls, each
    bracketed by CUDA events; ``before()`` runs outside the brackets."""
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


def phase_kernels(dev):
    """K1 against its plain version at the path's shapes; timings."""
    from lightgbm_tpu_torch.ops.hist_cuda import hist_cuda_rm
    from lightgbm_tpu_torch.ops.histogram import hist_rowmajor
    F, B = N_FEATURES, MAX_BIN
    gen = torch.Generator(device=dev).manual_seed(0)
    # a buffer larger than the 50 MB L2, rewritten before each timed call
    # so that every call reads its inputs from device memory
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    rows = {}
    max_err = 0.0
    for S in KERNEL_SHAPES:
        bins = torch.randint(0, B, (S, F), generator=gen, device=dev,
                             dtype=torch.int32).to(torch.uint8)
        dyadic = torch.randint(-64, 65, (S, 3), generator=gen, device=dev,
                               dtype=torch.int32).float() / 8
        out = hist_cuda_rm(bins, dyadic, B)
        ref = hist_rowmajor(bins, dyadic, B)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), f"S={S}: dyadic gh differs"
        gh = torch.randn((S, 3), generator=gen, device=dev)
        out = hist_cuda_rm(bins, gh, B)
        again = hist_cuda_rm(bins, gh, B)
        ref = hist_rowmajor(bins, gh, B)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)
        err = float((out - ref).abs().max())
        max_err = max(max_err, err)
        same_bits = bool(torch.equal(out, again))

        ms = cuda_ms(lambda: hist_cuda_rm(bins, gh, B), before=flush.zero_)
        plain_ms = cuda_ms(lambda: hist_rowmajor(bins, gh, B),
                           before=flush.zero_)
        # yardstick: one index_add_ over the flat (feature, bin) slot, the
        # per-cell expansion of gh made outside the timed call
        slot = (bins.long() + torch.arange(F, device=dev) * B).reshape(-1)
        vals = gh.repeat_interleave(F, dim=0)
        acc = torch.zeros(F * B, 3, device=dev)
        library_ms = cuda_ms(lambda: acc.index_add_(0, slot, vals),
                             before=lambda: (flush.zero_(), acc.zero_()))
        del slot, vals
        # least time: each input byte read once, the output written once,
        # or 3 f32 adds per cell at the f32 rate, whichever is longer
        bytes_ms = (S * F + 12 * S + 12 * F * B) / HBM_BYTES_PER_S * 1e3
        ops_ms = 3 * S * F / F32_FLOPS * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        rows[S] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, max_abs_err=err,
                       bound_by="bytes" if bytes_ms >= ops_ms
                       else "operations", same_bits=same_bits)
        log(f"phase 3 hist_rowmajor S={S} F={F} B={B}: max_abs_err={err!r} "
            f"same_bits_two_launches={same_bits} kernel_ms={ms!r} "
            f"plain_ms={plain_ms!r} index_add_ms={library_ms!r} "
            f"bound_us={bound_ms * 1e3!r}")
    return rows, max_err


def phase_main_path(dev):
    """Full-width training through the user entry points."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.hist_cuda import hist_cuda_rm
    t0 = time.perf_counter()
    X, y = synth_higgs(N_ROWS, N_FEATURES)
    params = {"objective": "binary", "num_leaves": NUM_LEAVES,
              "learning_rate": 0.1, "max_bin": MAX_BIN,
              "min_data_in_leaf": 20, "metric": ["binary_logloss", "auc"],
              "verbose": -1, "device_type": "cuda"}
    ds = lgt.Dataset(X, label=y).construct()
    log(f"phase 4 data+binning_s={time.perf_counter() - t0!r} "
        f"shape={X.shape}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist_cuda_rm.launches = 0
    bst = lgt.Booster(params, ds)
    t = time.perf_counter()
    assert not bst.update()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    first = dict((m, v) for _, m, v, _ in bst.eval_train())
    iter_s = []
    for _ in range(TIMED_ITERS):
        t = time.perf_counter()
        assert not bst.update()
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t)
    launches = hist_cuda_rm.launches
    peak = torch.cuda.max_memory_allocated()
    last = dict((m, v) for _, m, v, _ in bst.eval_train())
    leaves = [t.num_leaves for t in bst._engine.models]
    log(f"phase 4 warmup_s={warm_s!r} iter_s={iter_s!r} "
        f"median_iter_s={statistics.median(iter_s)!r} "
        f"hist_launches={launches} leaves_per_tree={leaves} "
        f"max_memory_allocated={peak} logloss_first={first} "
        f"logloss_last={last}")
    assert launches > 0 and launches == sum(leaves), (launches, leaves)
    assert last["binary_logloss"] < first["binary_logloss"]
    assert last["auc"] > 0.7, last
    # predictions: finite, right shape, and equal to the training score
    Xp = X[:20000]
    raw = bst.predict(Xp, raw_score=True)
    prob = bst.predict(Xp)
    assert raw.shape == prob.shape == (len(Xp),)
    assert np.isfinite(raw).all() and ((prob > 0) & (prob < 1)).all()
    train_raw = bst._engine.score[0, :len(Xp)].cpu().numpy()
    np.testing.assert_allclose(raw, train_raw, rtol=0, atol=1e-4)
    log("phase 4 predict ok: host walk equals the training score")
    return launches, bst


def phase_profile(bst, iters=2):
    """Where an iteration's time goes: ``torch.profiler`` over ``iters``
    more boosting iterations; prints the device's busy share of the wall
    time, the ops with the most device time and the most host time, and
    the number of kernel launches per iteration."""
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
    log(f"phase profile iters={iters} wall_s={wall_s!r} "
        f"device_busy_s={busy_s!r} device_busy_share={busy_s / wall_s!r} "
        f"kernel_launches_per_iter={launches / iters!r} "
        f"memcpy_or_sync_calls_per_iter={syncs / iters!r}")
    for e in sorted(on_device, key=dev_us, reverse=True)[:10]:
        log(f"phase profile device {e.key[:90]!r} count={e.count} "
            f"device_ms={dev_us(e) / 1e3!r}")
    ops = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA]
    for e in sorted(ops, key=dev_us, reverse=True)[:10]:
        log(f"phase profile device-by-op {e.key[:70]!r} count={e.count} "
            f"self_device_ms={dev_us(e) / 1e3!r}")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:12]:
        log(f"phase profile host {e.key[:70]!r} count={e.count} "
            f"self_cpu_ms={e.self_cpu_time_total / 1e3!r}")


def phase_cross_check():
    """cuda against cpu on a small run."""
    import lightgbm_tpu_torch as lgt
    X, y = synth_higgs(20_000, N_FEATURES, seed=1)
    out = {}
    for dev in ("cuda", "cpu"):
        params = {"objective": "binary", "num_leaves": 31,
                  "max_bin": MAX_BIN, "verbose": -1, "device_type": dev}
        bst = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=3,
                        valid_sets=None)
        t0 = bst._engine.models[0]
        loss = dict((m, v) for _, m, v, _ in bst.eval_train())
        out[dev] = (int(t0.split_feature[0]), float(t0.threshold_real[0]),
                    int(t0.decision_type[0]), loss["binary_logloss"])
    log(f"phase 5 root_split_and_logloss cuda={out['cuda']} "
        f"cpu={out['cpu']}")
    assert out["cuda"][:3] == out["cpu"][:3]
    np.testing.assert_allclose(out["cuda"][3], out["cpu"][3], rtol=1e-4)


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

    t = time.perf_counter()
    names = _build.kernel_names()
    _build.build_all(names)
    log(f"phase 2 built {names} in {time.perf_counter() - t!r} s")
    for name, report in _build.build_logs.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"phase 2 {name}: {line.strip()}")

    rows, max_err = phase_kernels(dev)
    launches, bst = phase_main_path(dev)
    if "--profile" in sys.argv[1:]:
        phase_profile(bst)
    del bst
    phase_cross_check()

    big = rows[N_ROWS]
    kernels = [{
        "name": "hist_rowmajor", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/hist_rowmajor.cu",
        "replaces": "lightgbm_tpu/ops/hist_pallas.py:52",
        "launches": launches, "max_abs_err": max_err,
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": big["library_ms"]}]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
