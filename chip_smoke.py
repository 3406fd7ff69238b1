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
   (CUDA events around each call on an idle stream: the host's issuing
   of the call counts), its device time (every call queued behind a
   device sleep, so the host's issuing is hidden), the plain version's
   time, one PyTorch library call's time and its bound on the card, over
   uint8 bins at 255 bins and uint16 bins at 257, 1,023 and 4,095 (K1's
   and K2's wide body), each uniform and skewed (four rows in five in one
   bin, one feature of three values), and u16 bins at 65,536 on a few
   rows (the sums are held against the exact sum, a chunked two-level
   sum in float64 rounded once; the plain version timed is the same sum
   in float32): K1 (hist_rowmajor) in f32, int8
   and bf16 at leaf sizes from 1M rows down to 1, its small path against
   its dense path at small leaves; the level partition (the node
   order carried from one level to the next) against its plain version
   and the stable sort, and K2 (hist_level) in f32, int8 and bf16 over
   1M rows at 1 to 512 nodes with skewed segments, with empty nodes, and
   with every row out of the level, fed the carried order, timed per
   level (partition included) beside index_add_ (on skewed and u16 bins
   at 1 and 512 nodes); B2 (hist_featmajor; the grouped body over uint8
   bins, the wide body over u16 bins) in
   f32 and int8 over 1M feature-major rows, adding only the rows of
   leaves of 1M rows down to 1 (the fused form, which reads each row's
   leaf id) beside the unfused form (gh masked by torch, then a pass
   over every row), on uniform bins and on skewed uint8 bins and u16
   bins at 1,023 and 4,095 (u16 leaves of 65,536 rows too), over a
   ragged row count with and without the engine's 16-element row
   padding, at 65,536 bins on a few rows, and at shapes with feature
   tiles and bin windows of unequal width and with 33 and 1 rows. Two
   launches on the same input must give the same bits;
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
   hold the compact one's splits and give its outputs (its node
   numbering follows the JAX package's e-ranking), and full+quantized's
   first tree must equal the quantized one; then the same eight paths on
   the same rows binned at max_bin=1023 (uint16 bins through K1, K2 and
   B2), each run's launch counts showing its u16 kernel mode, and each
   path profiled for one more iteration (K1's, K2's and B2's device
   time; the full paths must have run B2's wide kernels and not its
   grouped ones); the quantized run logs the device time of one tree's threefry
   draws; with ``--profile``, two more iterations of the compact, level
   and full paths under ``torch.profiler`` show where an iteration's
   time goes (device busy share, K1's, K2's and B2's device time per
   iteration, top ops, launches and device-to-host reads);
6. small trainings on cuda and on the CPU (plain versions), compact,
   quantized (stochastic rounding on: both draw the same threefry bits),
   level and full, in u8 and in u16 bins, which must agree;
7. prediction on the card: ``predict(device=True)`` of the phase-4 model
   and of the phase-5 u16 compact model over 200,000 rows by the binned
   route, and by the raw route for a
   booster of the same trees without the training bin mappers, against
   the host walk (scores within 1e-5, every tree's leaf equal), with
   rows/s of each route and of the host walk; each route's answer must be
   the engine's device scores bit for bit, so no fallback went unseen;
8. the training API and model loading at the phase-4 width: ``train``
   on the phase-4 dataset with a validation set of 200,000 more rows
   from another seed (``Dataset(reference=)``), ``auc`` and
   ``binary_logloss``, ``early_stopping_round=5`` and
   ``record_evaluation``, K1 launched; each iteration's validation score
   on the card within 1e-5 of the host walk of the trees so far; the
   model's text loaded back (``Booster(model_str=)``) predicting the
   trained booster's host walk bit for bit, its raw device route within
   1e-5 of that walk (rows/s), ``dump_model`` valid JSON with every tree;
   ``train(init_model=loaded)`` on the card replaying the loaded trees
   onto the training score bit for bit and keeping them, and
   ``rollback_one_iter`` restoring the training and validation scores of
   the iteration before (within one f32 rounding). It logs the seconds
   an iteration with the validation set beside phase 4's without it and,
   in turns on one booster, with and without it, the device ms of one
   validation-score update and the phase's own seconds;
9. multiclass at the shape of UCI Covertype (581,012 x 54: 10 continuous
   columns and one-hot groups of 4 and 40, 7 classes with its class
   counts) through ``Booster`` at the phase-4 width: softmax on the
   compact grower (1 warm-up and 3 timed iterations, K1 launched once per
   leaf of the 7 trees of each), then on the hybrid (K2) and the full
   (B2) paths and one-vs-all on the compact path (1 + 1 each); every
   iteration appends 7 trees, ``multi_logloss`` falls and
   ``multi_error`` ends below the prior's; the time of the softmax
   gradients over the [7, N] score; probabilities that sum to 1, the
   binned and raw device routes within 1e-5 of the host walk in every
   class column (raw scores relative to max(1, |score|) and absolute in
   the columns whose |score| stays under 1, probabilities absolute), the
   device metrics within 1e-5 of the host's, the text round trip bit for
   bit; cuda against the CPU on 20,000 rows of 3 classes on the compact,
   hybrid and full paths; then the ten pointwise objectives (L1, Huber,
   Fair, Poisson, quantile, MAPE, Gamma, Tweedie and the two
   cross-entropies) on phase 4's rows, 1 + 1 iterations each, each
   default metric falling (Gamma's deviance, its default ``gamma`` logged
   beside), with the host seconds of the percentile leaf renewal of L1,
   quantile and MAPE;
   with ``--profile``, one more softmax iteration under
   ``torch.profiler``;
10. ranking at the shape of MSLR-WEB30K Fold 1 (2,270,296 x 136 rows in
   18,919 queries of 1 to 1,251 documents, relevance 0-4) through
   ``Booster`` at the phase-4 width, with a validation set of 1,000 more
   queries: lambdarank on the compact grower (1 warm-up and 3 timed
   iterations, K1 launched once per leaf), rank_xendcg and lambdarank
   with each row's slot in its query as its position (1 + 1 each, the
   position biases finite); the validation ``ndcg@10`` rising in each
   run; the lambdarank gradient pass timed (CUDA events, and the device
   alone) beside one f32 read and write of its query pairs, with the
   pair count, the chunks and the bytes of the largest; the peak device
   bytes of each run; then cuda against the CPU on 20,000 rows in 200
   queries on the compact, hybrid and full paths (root splits equal,
   ``ndcg@10`` within rtol 1e-6);
11. the user surface on phase 4's rows and model (run after phase 9):
   ``cv`` with 5 stratified folds and 3 rounds (every fold through K1, the
   mean logloss falling every round, fold 0's ``eval`` on its held-out
   subset within 1e-6 of the host walk's logloss, the five Boosters' peak
   bytes); an ``LGBMClassifier`` (4 rounds, the stand-ins where
   scikit-learn is absent) whose first tree is phase 4's and whose
   ``predict_proba`` is its Booster's; ``pred_contrib`` of 10,000 rows
   (each row's sum within 1e-6 of max(1, |score|) of its raw score, host
   rows/s); ``refit`` on 200,000 rows of another seed (shapes kept, tree
   0's leaves equal a refit by hand, the logloss within 0.1% of before);
   ``set_leaf_output`` then ``predict(device=True)`` (repacked: the host
   walk within 1e-5, the leaf's rows moved); pickled and deep-copied
   boosters predicting on the card the Booster's raw scores bit for bit
   and leaving no device bytes once dropped; ``save_binary`` and
   ``Dataset(path)`` (save and load seconds beside phase 4's binning) and
   one iteration from the file giving phase 4's first tree; then cuda
   against the CPU on 20,000 rows: ``cv`` of lambdarank with group folds
   in 200 queries (root splits equal, fold means within 1e-6) and
   ``LGBMRegressor`` on the compact, hybrid and full paths (root splits
   equal, training l2 within rtol 1e-6).

Any failure raises and exits non-zero. The last three lines are the
card's name and power limit, one JSON object describing every kernel
mode, and ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
import gc
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
# u16 bins are held uniform and skewed (four rows in five in one bin, and
# feature 0 of three values, as Higgs's b-tag features are)
U16_DISTS = ("uniform", "skewed")
# the widest histogram u16 bins give: K1, K2 and B2 checked there on a few
# rows
WIDEST_BINS = 1 << 16
WIDEST_ROWS = 5_000
TIMED_ITERS = 5
MODE_ITERS = 3
U16_ITERS = 2
KERNEL_SHAPES = (1_000_000, 65_536, 4_097, 1)
# leaf sizes of the u16 and the skewed cases (B2's u16 leaves also at
# 65,536 rows, a mid-size leaf of a million rows)
U16_SHAPES = (1_000_000, 4_097, 1)
B2_U16_SHAPES = (1_000_000, 65_536, 4_097, 1)
# B2 over skewed u16 bins at these widths
B2_SKEWED_U16_BINS = (1023, 4095)
LEVEL_NODES = (1, 8, 64, 512)
U16_LEVEL_NODES = (1, 512)
# K1's small path against its dense path at these leaf sizes
SMALL_SHAPES = (1, 300, 1_024, 2_048, 4_097)
TIMING_REPS = 20
PLAIN_REPS = 5
# device clock cycles of sleep per timed call queued behind it (~3 ms at
# the H100's clock: longer than the host takes to issue any one call)
SLEEP_CYCLES_PER_REP = 5_000_000
GH_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
MODES = ("f32", "int8", "bf16")
FM_MODES = ("f32", "int8")       # B2: the full path builds no bf16 hists
PREDICT_ROWS = 200_000
# phase 8: validation rows (another seed), rounds with the validation set,
# and rounds of the continued training
VALID_ROWS = 200_000
API_ROUNDS = 20
CONTINUE_ROUNDS = 3
# pairs of iterations with and without the validation set, in turns
VALID_AB_PAIRS = 4
# phase 9: multiclass at the shape of UCI Covertype, the common public
# multiclass GBDT benchmark: 581,012 rows of 10 continuous columns and two
# one-hot groups of 4 and 40 binary columns, 7 classes with its class
# counts (class 4 holds under 0.5% of the rows)
COVTYPE_CLASS_ROWS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367,
                      20_510)
COVTYPE_CONTINUOUS = 10
COVTYPE_GROUPS = (4, 40)
MC_TIMED_ITERS = 3
MC_PATHS = {"hybrid": (dict(tpu_row_scheduling="level"), "hist_level_f32"),
            "full": (dict(tpu_row_scheduling="full"), "hist_featmajor_f32"),
            "ova": (dict(objective="multiclassova"), "hist_rowmajor_f32")}
MC_PREDICT_ROWS = 20_000
# the cross-check of phase 9 on cuda and on the CPU: 3 classes, 20,000
# rows, 31 leaves, 3 rounds
MC_SMALL_CLASS_ROWS = (8_000, 9_000, 3_000)
# phase 9's pointwise objectives, each trained 1 + OBJ_ITERS iterations on
# phase 4's rows with labels made valid for it
POINTWISE = ("regression_l1", "huber", "fair", "poisson", "quantile",
             "mape", "gamma", "tweedie", "cross_entropy",
             "cross_entropy_lambda")
OBJ_ITERS = 1
# the metric that must fall: the objective's default, but for gamma, whose
# default metric (as the JAX package defines it, core/metrics.py:256-264)
# is not its negative log-likelihood; phase 9 logs it beside the deviance
LEARNING_METRIC = {"gamma": "gamma_deviance"}
# phase 10: ranking at the shape of MSLR-WEB30K Fold 1's training set, the
# Microsoft learning-to-rank data behind the "MS LTR" row of LightGBM's
# docs/Experiments.rst: 2,270,296 rows of 136 features in 18,919 queries of
# 1 to 1,251 documents (mean 120), relevance 0-4 skewed towards 0
MSLR_ROWS, MSLR_FEATURES = 2_270_296, 136
MSLR_QUERIES, MSLR_MAX_QUERY = 18_919, 1_251
# query lengths: lognormal (this sigma), fitted to the row count
MSLR_LENGTH_SIGMA = 0.9
# share of each relevance grade 0-4 (MSLR's labels lean as heavily on 0)
MSLR_GRADE_SHARE = (0.52, 0.32, 0.13, 0.02, 0.01)
# a third of the columns are counts, the rest values to three decimals
MSLR_COUNT_COLUMNS = MSLR_FEATURES // 3
MSLR_VALID_QUERIES = 1_000
MSLR_EVAL_AT = [1, 3, 5, 10]
RANK_TIMED_ITERS = 3
RANK_ONE_ITERS = 1
# the cross-check of phase 10 on cuda and on the CPU: 20,000 rows in 200
# queries, 31 leaves, 3 rounds
RANK_SMALL_ROWS, RANK_SMALL_QUERIES = 20_000, 200
# phase 11: cv folds and rounds, the estimator's rounds, rows explained by
# TreeSHAP, rows of the refit (another seed), and the cross-check's rows,
# queries, leaves and rounds
CV_FOLDS, CV_ROUNDS = 5, 3
SK_ROUNDS = 4
CONTRIB_ROWS = 10_000
REFIT_ROWS = 200_000
SURFACE_SMALL_ROWS, SURFACE_SMALL_QUERIES = 20_000, 200
SURFACE_PATHS = (("compact", {}, "hist_rowmajor_f32"),
                 ("hybrid", {"tpu_row_scheduling": "level"},
                  "hist_level_f32"),
                 ("full", {"tpu_row_scheduling": "full"},
                  "hist_featmajor_f32"))
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


def device_ms(fn, reps=TIMING_REPS, before=None, sleep_per_rep=1):
    """Median device time of ``fn()`` in ms over ``reps`` calls, each
    bracketed by CUDA events; every call is enqueued behind a sleep on the
    device that outlasts the host's issuing of all of them (``fn`` of many
    launches needs ``sleep_per_rep`` times the usual sleep), so the time
    between the events is the device's alone. ``before()`` runs outside
    the brackets."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    torch.cuda._sleep(SLEEP_CYCLES_PER_REP * reps * sleep_per_rep)
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


def random_bins(shape, B, gen, dev, skewed=False):
    """Bins in [0, B): uint8 for B <= 256, else u16 bins held as int16
    (the port's storage of them); ``skewed`` (row-major ``[R, F]``): four
    rows in five in bin B // 3, and feature 0 of three values (0, B // 2,
    B - 1)."""
    b = torch.randint(0, B, shape, generator=gen, device=dev,
                      dtype=torch.int32)
    if skewed:
        hot = torch.rand(shape, generator=gen, device=dev) < 0.8
        b = torch.where(hot, B // 3, b)
        three = torch.tensor([0, B // 2, B - 1], device=dev,
                             dtype=torch.int32)
        b[:, 0] = three[torch.randint(0, 3, (shape[0],), generator=gen,
                                      device=dev)]
    return b.to(torch.uint8) if B <= 256 else b.to(torch.int16)


def bin_width(B):
    """(bytes of a bin, the launch-count suffix) at B bins."""
    return (1, "") if B <= 256 else (2, "_u16")


def phase_k1(dev, flush):
    """K1 in each mode against the exact sum at the leaf sizes, in u8 at
    MAX_BIN and in u16 at each of U16_BINS, uniform and skewed, timed
    beside its plain version (the chunked two-level f32 sum); at
    WIDEST_BINS on WIDEST_ROWS rows; then its small path against its
    dense path."""
    from lightgbm_tpu_torch.ops import hist_cuda
    from lightgbm_tpu_torch.ops.hist_cuda import hist_cuda_rm
    from lightgbm_tpu_torch.ops.histogram import (hist_rowmajor_chunked,
                                                  hist_rowmajor_exact)
    F = N_FEATURES
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    cases = [(MAX_BIN, KERNEL_SHAPES, "uniform"),
             (MAX_BIN, U16_SHAPES, "skewed")] + [
        (b, U16_SHAPES, dist) for b in U16_BINS for dist in U16_DISTS]
    for B, shapes, dist in cases:
        width, suffix = bin_width(B)
        tag = "" if dist == "uniform" else "_skewed"
        for mode in MODES:
            max_err = 0.0
            for S in shapes:
                what = f"K1 {mode}{suffix} B={B} {dist} S={S}"
                bins = random_bins((S, F), B, gen, dev, dist == "skewed")
                err = check_k1(bins, B, mode, gen, dev, what)
                max_err = max(max_err, err)
                gh = make_gh(mode, (S, 3), gen, dev)
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
                out_dtype = torch.int32 if mode == "int8" else torch.float32
                vals = gh.to(out_dtype).repeat_interleave(F, dim=0)
                acc = torch.zeros(F * B, 3, dtype=out_dtype, device=dev)
                library_ms = cuda_ms(lambda: acc.index_add_(0, slot, vals),
                                     before=lambda: (flush.zero_(),
                                                     acc.zero_()))
                library_dev_ms = device_ms(
                    lambda: acc.index_add_(0, slot, vals),
                    before=lambda: (flush.zero_(), acc.zero_()))
                del slot, vals, acc
                # each input byte read once, the output written once; or 3
                # adds per cell
                bound_ms, bound_by = bound(
                    S * F * width + 3 * S * GH_BYTES[gh.dtype]
                    + 12 * F * B, 3 * S * F)
                rows[(mode + suffix + tag, B, S)] = dict(
                    ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=bound_ms,
                    bound_by=bound_by, max_abs_err=max_err)
                path = ("small" if S <= hist_cuda.SMALL_LEAF_ROWS else
                        "wide" if width == 2 else "dense")
                log(f"phase 3 hist_rowmajor mode={mode}{suffix} bins={dist} "
                    f"S={S} F={F} B={B} path={path}: max_abs_err={err!r} "
                    f"exact_gh_bit_for_bit=True same_bits_two_launches=True "
                    f"kernel_ms={ms!r} "
                    f"kernel_device_ms={dev_ms!r} host_issue_ms={issue_ms!r} "
                    f"plain_ms={plain_ms!r} index_add_ms={library_ms!r} "
                    f"index_add_device_ms={library_dev_ms!r} "
                    f"device_over_index_add_device="
                    f"{dev_ms / library_dev_ms!r} "
                    f"bound_us={bound_ms * 1e3!r} bound_by={bound_by}")
    # the widest histogram, on a few rows (the dense path's wide body)
    for dist in U16_DISTS:
        bins = random_bins((WIDEST_ROWS, F), WIDEST_BINS, gen, dev,
                           dist == "skewed")
        for mode in MODES:
            what = f"K1 {mode}_u16 B={WIDEST_BINS} {dist} S={WIDEST_ROWS}"
            err = check_k1(bins, WIDEST_BINS, mode, gen, dev, what)
            log(f"phase 3 hist_rowmajor mode={mode}_u16 bins={dist} "
                f"S={WIDEST_ROWS} F={F} B={WIDEST_BINS}: max_abs_err={err!r}"
                f" exact_gh_bit_for_bit=True same_bits_two_launches=True")
    # the small path against the dense path, at the same inputs
    limit = hist_cuda.SMALL_LEAF_ROWS
    for S in SMALL_SHAPES:
        bins = random_bins((S, F), MAX_BIN, gen, dev)
        gh = make_gh("f32", (S, 3), gen, dev, dyadic=True)
        ref = hist_rowmajor_exact(bins, gh, MAX_BIN)
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
    return rows


def check_k1(bins, B, mode, gen, dev, what):
    """K1 on ``bins`` against the exact sum: dyadic (or int8) gh bit for
    bit, normal gh within the tolerance, two launches the same bits;
    returns the largest difference from the exact sum."""
    from lightgbm_tpu_torch.ops.hist_cuda import hist_cuda_rm
    from lightgbm_tpu_torch.ops.histogram import hist_rowmajor_exact
    S = bins.shape[0]
    dyadic = make_gh(mode, (S, 3), gen, dev, dyadic=True)
    assert torch.equal(hist_cuda_rm(bins, dyadic, B),
                       hist_rowmajor_exact(bins, dyadic, B)), \
        f"{what}: exact gh differ"
    gh = make_gh(mode, (S, 3), gen, dev)
    out = hist_cuda_rm(bins, gh, B)
    again = hist_cuda_rm(bins, gh, B)
    ref = hist_rowmajor_exact(bins, gh, B)
    torch.cuda.synchronize()
    err = check_against_plain(mode, out, ref, what)
    assert torch.equal(out, again), f"{what}: two launches differ"
    return err


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
    each of U16_BINS and u8 bins at MAX_BIN, uniform and skewed, over
    U16_LEVEL_NODES; then WIDEST_BINS over a few rows."""
    from lightgbm_tpu_torch.ops.hist_level import hist_level, node_order
    from lightgbm_tpu_torch.ops.hist_level_cuda import hist_level_cuda
    R, F = N_ROWS, N_FEATURES
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = {}
    for B, nodes, extras, dist in [
            (MAX_BIN, LEVEL_NODES, True, "uniform"),
            (MAX_BIN, U16_LEVEL_NODES, False, "skewed")] + [
            (b, U16_LEVEL_NODES, False, dist) for b in U16_BINS
            for dist in U16_DISTS]:
        bins = random_bins((R, F), B, gen, dev, dist == "skewed")
        for case in level_cases(gen, dev, nodes, extras):
            phase_k2_case(dev, flush, gen, bins, B, dist, case, rows)
        del bins
    # the widest histogram, on a few rows in four nodes, node 1 empty
    Rw, n, B = 4 * WIDEST_ROWS, 4, WIDEST_BINS
    local = torch.randint(0, n, (Rw,), generator=gen, device=dev)
    local[local == 1] = 2
    in_lvl = torch.rand(Rw, generator=gen, device=dev) < 0.9
    order, seg = node_order(local, in_lvl, n)
    for dist in U16_DISTS:
        bins = random_bins((Rw, F), B, gen, dev, dist == "skewed")
        for mode in MODES:
            what = f"K2 {mode}_u16 B={B} {dist} R={Rw} n={n}"
            call = lambda g: hist_level_cuda(bins, g, local, in_lvl, n, B,
                                             order=order, seg=seg)
            dyadic = make_gh(mode, (Rw, 3), gen, dev, dyadic=True)
            assert torch.equal(call(dyadic), hist_level(
                bins, dyadic, local, in_lvl, n, B)), f"{what}: exact gh differ"
            gh = make_gh(mode, (Rw, 3), gen, dev)
            out = call(gh)
            err = check_against_plain(
                mode, out, hist_level(bins, gh, local, in_lvl, n, B), what)
            assert torch.equal(out, call(gh)), f"{what}: two launches differ"
            assert not out[1].any(), f"{what}: the empty node is not zero"
            log(f"phase 3 hist_level mode={mode}_u16 bins={dist} R={Rw} "
                f"F={F} B={B} n={n}: max_abs_err={err!r} "
                "exact_gh_bit_for_bit=True same_bits_two_launches=True "
                "empty_node_zero=True")
    return rows


def phase_k2_case(dev, flush, gen, bins, B, dist, case, rows):
    """One level case of ``phase_k2`` over ``bins`` (``dist``: uniform or
    skewed) at B bins; the partition is checked and timed in the uniform
    u8 pass only."""
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
    if parent is not None and B == MAX_BIN and dist == "uniform":
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
    tag = "" if dist == "uniform" else "_skewed"
    for mode in MODES:
        what = f"K2 {mode}{suffix} B={B} {dist} {label}"
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
        rows[(mode + suffix + tag, B, label)] = dict(ms=ms, device_ms=dev_ms,
                                   plain_ms=plain_ms,
                                   library_ms=library_ms,
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   max_abs_err=err)
        log(f"phase 3 hist_level mode={mode}{suffix} bins={dist} {label} "
            f"R={R} "
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
    """B2 in each mode against the exact sum over 1M feature-major rows,
    in u8 at MAX_BIN (uniform and skewed) and in u16 at each of U16_BINS
    (skewed too at B2_SKEWED_U16_BINS; then WIDEST_BINS on a few rows
    and B2_ODD_SHAPES):
    the fused form (each row's leaf id read by the kernel, only the
    leaf's rows added) for leaves of each size, timed beside the unfused
    form (gh masked by two torch ops, then a pass over every row) and its
    plain version (the chunked two-level f32 sum); then, at MAX_BIN and
    U16_MAX_BIN, a ragged row count, with and without the engine's
    16-element row padding."""
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {}
    for B, shapes, dist in [(MAX_BIN, KERNEL_SHAPES, "uniform"),
                            (MAX_BIN, U16_SHAPES, "skewed")] + [
            (b, B2_U16_SHAPES, "uniform") for b in U16_BINS] + [
            (b, B2_U16_SHAPES, "skewed") for b in B2_SKEWED_U16_BINS]:
        phase_b2_bins(dev, flush, gen, B, shapes, dist, rows)
    phase_b2_widest(dev, gen)
    return rows


# B2's wide path at other shapes than the paths': (rows, features, bins)
# with tiles of unequal width, windows of unequal width, and a few rows
B2_ODD_SHAPES = ((5_000, 5, 4095), (5_000, 17, 40_000), (33, 3, 1023),
                 (1, 2, 300))


def phase_b2_widest(dev, gen):
    """B2 at WIDEST_BINS on WIDEST_ROWS feature-major rows (the wide
    body's bin windows), uniform and skewed, then at B2_ODD_SHAPES, in
    each mode, fused at leaves of every row, 1,000 rows (a third of the
    rows at the odd shapes) and 1 row, and unfused, against the exact
    sum."""
    from lightgbm_tpu_torch.ops.hist_cuda import hist_cuda_fm
    from lightgbm_tpu_torch.ops.histogram import hist_featmajor_exact
    cases = [(WIDEST_ROWS, N_FEATURES, WIDEST_BINS, dist)
             for dist in U16_DISTS] + [
        (R, F, B, "uniform") for R, F, B in B2_ODD_SHAPES]
    for R, F, B, dist in cases:
        bins = random_bins((R, F), B, gen, dev,
                           dist == "skewed").T.contiguous()
        mid = 1_000 if R == WIDEST_ROWS else R // 3
        for mode in FM_MODES:
            err = 0.0
            for S in (R, mid, 1, None):
                ids = torch.randint(1, 9, (R,), generator=gen, device=dev)
                if S is not None:
                    ids[torch.randperm(R, generator=gen, device=dev)[:S]] = 0
                kw = {} if S is None else dict(leaf_id=ids, leaf=0)
                what = f"B2 {mode}_u16 B={B} {dist} R={R} F={F} leaf rows={S}"
                keep = (torch.ones(R, dtype=torch.bool, device=dev)
                        if S is None else ids == 0)
                for dyadic in (True, False):
                    gh = make_gh(mode, (R, 3), gen, dev, dyadic=dyadic)
                    out = hist_cuda_fm(bins, gh, B, **kw)
                    again = hist_cuda_fm(bins, gh, B, **kw)
                    ref = hist_featmajor_exact(
                        bins, gh * keep[:, None].to(gh.dtype), B)
                    torch.cuda.synchronize()
                    if dyadic:
                        assert torch.equal(out, ref), \
                            f"{what}: exact gh differ"
                    else:
                        err = max(err, check_against_plain(mode, out, ref,
                                                           what))
                    assert torch.equal(out, again), \
                        f"{what}: two launches differ"
            log(f"phase 3 hist_featmajor mode={mode}_u16 bins={dist} R={R} "
                f"F={F} B={B} leaf_rows=all,{mid},1,unfused: "
                f"max_abs_err={err!r} exact_gh_bit_for_bit=True "
                f"same_bits_two_launches=True")


def phase_b2_bins(dev, flush, gen, B, shapes, dist, rows):
    """``phase_b2`` at B bins (``dist``: uniform or skewed)."""
    from lightgbm_tpu_torch.ops.hist_cuda import (feature_major_bins,
                                                  hist_cuda_fm)
    from lightgbm_tpu_torch.ops.histogram import (
        hist_featmajor_chunked, hist_featmajor_exact as hist_featmajor)
    R, F = N_ROWS, N_FEATURES
    width, suffix = bin_width(B)
    tag = "" if dist == "uniform" else "_skewed"
    bins = (random_bins((F, R), B, gen, dev) if dist == "uniform" else
            random_bins((R, F), B, gen, dev, skewed=True).T.contiguous())

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
            what = f"B2 {mode}{suffix} B={B} {dist} leaf rows={S}"
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
                lambda: hist_featmajor_chunked(bins, masked(gh, ids), B),
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
            rows[(mode + suffix + tag, B, S)] = dict(ms=ms, device_ms=dev_ms,
                                   plain_ms=plain_ms, library_ms=library_ms,
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   max_abs_err=err)
            log(f"phase 3 hist_featmajor mode={mode}{suffix} bins={dist} "
                f"path={'wide' if width == 2 else 'grouped'} "
                f"R={R} leaf_rows={S} "
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
        if B not in (MAX_BIN, U16_MAX_BIN) or dist != "uniform":
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
    data_s = time.perf_counter() - t0
    ds = lgt.Dataset(X, label=y).construct()
    binning_s = time.perf_counter() - t0 - data_s
    log(f"phase 4 data+binning_s={data_s + binning_s!r} "
        f"binning_s={binning_s!r} shape={X.shape}")
    bst, r = train_timed(ds, bench_params(), TIMED_ITERS)
    r["binning_s"] = binning_s
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
    return r, bst, ds, X


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
        tp = time.perf_counter()
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
        if u16:
            # one more iteration, profiled: K1's, K2's and B2's device
            # time on u16 bins (after the launch counts were read and the
            # trees checked)
            times, names = kernel_ms_per_iter(bst)
            log(f"phase 5 path={name} one more iteration, device ms: "
                + " ".join(f"{k}_device_ms={ms!r} {k}_launches={n!r}"
                           for k, (ms, n) in times.items()))
            if name.startswith("full"):
                # u16 bins take B2's wide body, never its grouped one
                ran = lambda k: any(k in n for n in names)
                assert ran("hist_featmajor_wide"), (name, sorted(names))
                assert not ran("hist_featmajor_kernel") and \
                    not ran("hist_sparse_kernel"), (name, sorted(names))
                b2 = sorted(n for n in names if any(
                    k in n for k in dict(KERNEL_KEYS)["B2"]))
                log(f"phase 5 path={name} B2 kernels: {b2}")
        out[name] = (c, bst)
        log(f"phase 5 path={name} seconds={time.perf_counter() - tp!r}")
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


# the histogram kernels' own device time, by kernel name: K1's (both
# paths) and K2's without the reductions of their blocks' partials, B2's
# with its mask pass and its sparse pass; then the reductions (K1's and
# B2's reduce_flagged, K2's reduce_nodes)
KERNEL_KEYS = (("K1", ("hist_rowmajor_kernel", "hist_rowmajor_wide",
                       "hist_rowmajor_small")),
               ("K2", ("hist_level_kernel", "hist_level_wide")),
               ("B2", ("batch_masks", "hist_featmajor_kernel",
                       "hist_featmajor_wide", "hist_sparse_kernel",
                       "hist_sparse_wide")),
               ("reductions", ("reduce_flagged", "reduce_nodes")))


def kernel_times(on_device, iters):
    """{name: (device ms per iteration, launches per iteration)} of the
    histogram kernels among a profile's device events."""
    found = {}
    for kname, keys in KERNEL_KEYS:
        hits = [e for e in on_device if any(k in e.key for k in keys)]
        if hits:
            found[kname] = (sum(e.self_device_time_total for e in hits)
                            / 1e3 / iters,
                            sum(e.count for e in hits) / iters)
    return found


def kernel_ms_per_iter(bst):
    """The histogram kernels' device ms in one more boosting iteration of
    ``bst``, under ``torch.profiler`` (the device's activity only), and
    the names of the device's kernels in it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert not bst.update()
        torch.cuda.synchronize()
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    return kernel_times(on_device, 1), {e.key for e in on_device}


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
    # B2's kernels and the reductions start by programmatic dependent
    # launch, so a span may include the wait for the kernel before: those
    # sums are upper bounds
    for kname, (ms, n) in kernel_times(on_device, iters).items():
        log(f"phase profile {label} {kname}_device_ms_per_iter={ms!r} "
            f"launches_per_iter={n!r}")
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
        tc = time.perf_counter()
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
            f"cpu={out['cpu']} seconds={time.perf_counter() - tc!r}")
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


def phase_training_api(ds, X, iter_s_without_valid):
    """Phase 8: ``train`` with a validation set, early stopping and
    ``record_evaluation`` at the phase-4 width, then the model's text
    loaded back, its raw device route, ``dump_model``, continued training
    from the loaded model and ``rollback_one_iter``, each checked."""
    import lightgbm_tpu_torch as lgt
    t_phase = time.perf_counter()
    Xv, yv = synth_higgs(VALID_ROWS, N_FEATURES, seed=1)
    Xv64 = np.asarray(Xv, np.float64)
    valid = lgt.Dataset(Xv, label=yv, reference=ds)
    params = bench_params(early_stopping_round=5)
    record, iter_s, eval_s, worst = {}, [], [], []
    host_sum = np.zeros(VALID_ROWS)
    started = {}

    def start(env):
        torch.cuda.synchronize()
        started["t"] = time.perf_counter()
    start.before_iteration = True

    def check(env):
        # the iteration's time (update, validation update, device metrics)
        # before anything of this check runs
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - started["t"])
        b = env.model
        t = time.perf_counter()
        again = b.eval_valid()          # the iteration's metrics, once more
        eval_s.append(time.perf_counter() - t)
        assert again == env.evaluation_result_list, again
        host_sum[:] += b.predict(Xv64, raw_score=True,
                                 start_iteration=env.iteration,
                                 num_iteration=1)
        score = b._engine.valid_sets[0].score[0].cpu().numpy()
        worst.append(float(np.abs(score - host_sum).max()))
        assert worst[-1] <= 1e-5, (env.iteration, worst[-1])
    check.order = 0               # before record_evaluation and the stop

    reset_counts()
    bst = lgt.train(params, ds, num_boost_round=API_ROUNDS,
                    valid_sets=[valid], valid_names=["valid"],
                    callbacks=[start, check, lgt.record_evaluation(record)])
    counts = read_counts()
    eng = bst._engine
    n_trees = bst.num_trees()
    assert counts["hist_rowmajor_f32"] > 0, counts
    assert len(worst) == n_trees == len(record["valid"]["auc"]), \
        (len(worst), n_trees)
    assert 0 < bst.best_iteration <= n_trees, bst.best_iteration
    auc, ll = record["valid"]["auc"], record["valid"]["binary_logloss"]
    assert auc[-1] > 0.7 and ll[-1] < ll[0], (auc, ll)
    log(f"phase 8 train rounds={n_trees} best_iteration="
        f"{bst.best_iteration} best_score={dict(bst.best_score['valid'])} "
        f"valid_auc={auc!r} valid_logloss={ll!r} launches={counts}")
    log(f"phase 8 iter_s_with_valid={iter_s!r} median_iter_s_with_valid="
        f"{statistics.median(iter_s)!r} median_iter_s_without_valid="
        f"{iter_s_without_valid!r} (phase 4) valid_rows={VALID_ROWS} "
        f"eval_valid_s={eval_s!r} (device metrics and their one read)")
    log(f"phase 8 valid score on the card within 1e-5 of the host walk "
        f"at every iteration (worst={max(worst)!r})")

    # one validation-score update: the tree packed and uploaded, the
    # traversal over the validation bins, the add; and the traversal alone
    vd = eng.valid_sets[0]
    tree = eng.models[-1]
    upd = vd.score[0].clone()
    full_ms = cuda_ms(lambda: upd.add_(eng._tree_outputs(tree, vd.bins)))
    from lightgbm_tpu_torch.ops.forest import pack_binned_tree, upload_trees
    from lightgbm_tpu_torch.ops.predict import (BinnedTreeArrays, depth_steps,
                                                forest_leaf_bins)
    L = tree.num_leaves
    packed = upload_trees(BinnedTreeArrays,
                          [pack_binned_tree(tree, L, *eng._mapper_arrays)],
                          vd.bins.device)
    steps = depth_steps(tree.max_depth, L)
    walk_ms = device_ms(lambda: upd.add_(packed.leaf_value.gather(
        1, forest_leaf_bins(packed, vd.bins, num_steps=steps))[0]),
        sleep_per_rep=10)
    log(f"phase 8 valid_score_update_ms={full_ms!r} (CUDA events, host "
        f"issue included) traversal_and_add_device_ms={walk_ms!r} "
        f"rows={VALID_ROWS} tree_depth={tree.max_depth} steps={steps}")

    # the text loaded back
    text = bst.model_to_string()
    loaded = lgt.Booster(bench_params(), model_str=text)
    assert loaded.config.device_type == "cuda"
    host = bst.predict(Xv64, raw_score=True, num_iteration=n_trees)
    host_loaded = loaded.predict(Xv64, raw_score=True)
    np.testing.assert_array_equal(host_loaded, host)
    d = json.loads(json.dumps(loaded.dump_model()))
    assert len(d["tree_info"]) == n_trees, len(d["tree_info"])
    loaded.predict(Xv64[:1000], device=True, raw_score=True)     # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    raw_dev = loaded.predict(Xv64, device=True, raw_score=True)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    le = loaded._engine
    assert le._serving is not None and le._serving.device.type == "cuda"
    assert le._serving.raw_pack.count == n_trees
    np.testing.assert_array_equal(raw_dev,
                                  le.predict_device(Xv64, 0, n_trees)[:, 0])
    np.testing.assert_allclose(raw_dev, host_loaded, rtol=0, atol=1e-5)
    log(f"phase 8 loaded model: host walk equals the trained booster's bit "
        f"for bit; raw device route rows={VALID_ROWS} trees={n_trees} "
        f"seconds={sec!r} rows_per_s={VALID_ROWS / sec!r} max_abs_diff="
        f"{float(np.abs(raw_dev - host_loaded).max())!r}; dump_model "
        f"{len(d['tree_info'])} trees")

    # continued training from the loaded model on the card
    replayed = {}

    def grab(env):
        if env.iteration == env.begin_iteration:
            replayed["score"] = env.model._engine.score.clone()
    grab.before_iteration = True

    cont = lgt.train(bench_params(), ds, num_boost_round=CONTINUE_ROUNDS,
                     init_model=loaded, valid_sets=[valid],
                     valid_names=["valid"], callbacks=[grab],
                     keep_training_booster=True)
    assert torch.equal(replayed["score"], eng.score), \
        "the replayed training score differs from the trained one"
    trees_of = lambda s: s[s.index("Tree=0"):s.index("end of trees")] \
        .split("\n\n")
    kept = trees_of(cont.model_to_string())
    assert cont.num_trees() == n_trees + CONTINUE_ROUNDS
    assert kept[:n_trees] == trees_of(text)[:n_trees]
    log(f"phase 8 init_model: {n_trees} loaded trees kept, replayed "
        f"training score equals the trained booster's bit for bit, "
        f"{CONTINUE_ROUNDS} more trees")

    # rollback_one_iter restores the scores of the iteration before
    ce = cont._engine
    before = (ce.score.clone(), ce.valid_sets[0].score.clone())
    assert not cont.update()
    cont.rollback_one_iter()
    assert cont.num_trees() == n_trees + CONTINUE_ROUNDS
    for name, was, now in (("train", before[0], ce.score),
                           ("valid", before[1], ce.valid_sets[0].score)):
        diff = float((now - was).abs().max())
        tol = 4 * 2.0 ** -23 * float(was.abs().max())
        assert diff <= tol, (name, diff, tol)
        log(f"phase 8 rollback_one_iter {name} score restored: "
            f"max_abs_diff={diff!r} (tolerance {tol!r}, one f32 rounding)")

    # iterations with and without the validation set in turns on one
    # booster (each with its metrics): the validation set's share of an
    # iteration, free of the spread between phases
    ab = {"with": [], "without": []}
    valid_sets = ce.valid_sets
    for i in range(VALID_AB_PAIRS):
        for side in (("with", "without") if i % 2 == 0
                     else ("without", "with")):
            ce.valid_sets = valid_sets if side == "with" else []
            torch.cuda.synchronize()
            t = time.perf_counter()
            assert not cont.update()
            cont.eval_valid()
            torch.cuda.synchronize()
            ab[side].append(time.perf_counter() - t)
    ce.valid_sets = valid_sets
    log(f"phase 8 in turns on one booster: iter_s_with_valid={ab['with']!r}"
        f" iter_s_without_valid={ab['without']!r} median_with="
        f"{statistics.median(ab['with'])!r} median_without="
        f"{statistics.median(ab['without'])!r}")
    log(f"phase 8 seconds={time.perf_counter() - t_phase!r}")


def synth_covtype(class_rows=COVTYPE_CLASS_ROWS, seed=0):
    """Covertype-shaped rows from a seed: each class's rows (in the given
    counts, shuffled) draw the continuous columns around the class's own
    centre and one column of each one-hot group from the class's own
    distribution over it."""
    rng = np.random.default_rng(seed)
    k = len(class_rows)
    y = np.repeat(np.arange(k), class_rows)
    rng.shuffle(y)
    n = len(y)
    centres = rng.normal(scale=0.7, size=(k, COVTYPE_CONTINUOUS))
    cols = [(centres[y] + rng.normal(size=(n, COVTYPE_CONTINUOUS)))
            .astype(np.float32)]
    for width in COVTYPE_GROUPS:
        probs = rng.dirichlet(np.full(width, 0.5), size=k)
        hot = np.empty(n, np.int64)
        for c in range(k):
            rows = np.flatnonzero(y == c)
            hot[rows] = rng.choice(width, size=len(rows), p=probs[c])
        onehot = np.zeros((n, width), np.float32)
        onehot[np.arange(n), hot] = 1.0
        cols.append(onehot)
    return np.concatenate(cols, axis=1), y.astype(np.float32)


def train_multiclass(ds, params, iters, prior_error):
    """``train_timed`` for K trees an iteration: warm-up plus ``iters``
    timed iterations, the launch counts zeroed just before and read just
    after, K trees appended by every iteration; ``multi_logloss`` must
    fall and ``multi_error`` end below the prior's."""
    import lightgbm_tpu_torch as lgt
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    bst = lgt.Booster(params, ds)
    K = bst.num_model_per_iteration()
    iter_s = []
    for i in range(1 + iters):
        t = time.perf_counter()
        assert not bst.update()
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t)
        assert bst.num_trees() == (i + 1) * K, (i, bst.num_trees())
        if i == 0:
            first = dict((m, v) for _, m, v, _ in bst.eval_train())
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() - base
    last = dict((m, v) for _, m, v, _ in bst.eval_train())
    assert last["multi_logloss"] < first["multi_logloss"], (first, last)
    assert last["multi_error"] < prior_error, (last, prior_error)
    return bst, dict(warm_s=iter_s[0], iter_s=iter_s[1:],
                     median_iter_s=statistics.median(iter_s[1:]),
                     counts=counts, peak_bytes=peak, first=first, last=last)


def phase_multiclass(X_higgs, ds_higgs):
    """Phase 9: multiclass (softmax, then one-vs-all) at the Covertype
    shape through ``Booster`` on the card, on the compact, hybrid and full
    paths; its predictions by the host walk and both device routes, its
    device metrics and its text; a small cuda/cpu cross-check; then the
    ten pointwise objectives on phase 4's rows."""
    import lightgbm_tpu_torch as lgt
    t_phase = time.perf_counter()
    X, y = synth_covtype()
    ds = lgt.Dataset(X, label=y).construct()
    K = len(COVTYPE_CLASS_ROWS)
    prior_error = 1.0 - max(COVTYPE_CLASS_ROWS) / len(y)
    log(f"phase 9 data+binning_s={time.perf_counter() - t_phase!r} "
        f"shape={X.shape} class_rows={COVTYPE_CLASS_ROWS} "
        f"prior_error={prior_error!r}")
    mc_params = bench_params(objective="multiclass", num_class=K,
                             metric=["multi_logloss", "multi_error"])
    bst, r = train_multiclass(ds, mc_params, MC_TIMED_ITERS, prior_error)
    leaves = [t.num_leaves for t in bst._engine.models]
    launches = r["counts"]["hist_rowmajor_f32"]
    log(f"phase 9 path=compact warmup_s={r['warm_s']!r} "
        f"iter_s={r['iter_s']!r} median_iter_s={r['median_iter_s']!r} "
        f"s_per_tree={r['median_iter_s'] / K!r} launches={r['counts']} "
        f"trees={len(leaves)} leaves={sum(leaves)} "
        f"peak_bytes_above_start={r['peak_bytes']} first={r['first']} "
        f"last={r['last']}")
    assert launches > 0 and launches == sum(leaves), (launches, leaves)
    assert sum(r["counts"].values()) == launches, r["counts"]
    eng = bst._engine
    grad_ms = cuda_ms(lambda: eng.objective.get_gradients(eng.score))
    grad_dev_ms = device_ms(lambda: eng.objective.get_gradients(eng.score))
    log(f"phase 9 softmax gradients [{K}, {len(y)}] ms={grad_ms!r} "
        f"device_ms={grad_dev_ms!r}")
    phase_multiclass_outputs(bst, X, K)
    if "--profile" in sys.argv[1:]:
        phase_profile(bst, "multiclass", iters=1)
    runs = {"compact": r["counts"]}
    for name, (extra, must) in MC_PATHS.items():
        params = dict(mc_params, **extra)
        b, rp = train_multiclass(ds, params, 1, prior_error)
        counts = rp["counts"]
        runs[name] = counts
        log(f"phase 9 path={name} warmup_s={rp['warm_s']!r} "
            f"iter_s={rp['iter_s']!r} s_per_tree={rp['iter_s'][0] / K!r} "
            f"launches={counts} peak_bytes_above_start={rp['peak_bytes']} "
            f"first={rp['first']} last={rp['last']}")
        assert counts[must] > 0, (name, counts)
        if name == "full":
            assert sum(counts.values()) == counts[must], counts
        if name == "ova":
            n_leaves = sum(t.num_leaves for t in b._engine.models)
            assert counts[must] == n_leaves, (counts, n_leaves)
        del b
    del bst, ds, X
    phase_multiclass_cross_check()
    phase_objectives(X_higgs, ds_higgs)
    log(f"phase 9 seconds={time.perf_counter() - t_phase!r}")
    return runs


def phase_multiclass_outputs(bst, X, K):
    """Phase 9's checks of a trained multiclass model: probabilities that
    sum to 1, the binned and raw device routes within 1e-5 of the host
    walk in every class column, the device metrics within 1e-5 of the
    host's from the score read back, and the text round trip (host walk
    bit for bit)."""
    import lightgbm_tpu_torch as lgt
    eng = bst._engine
    n_iter = bst.current_iteration()
    Xp = np.asarray(X[:MC_PREDICT_ROWS], np.float64)
    prob = bst.predict(Xp)
    assert prob.shape == (len(Xp), K), prob.shape
    np.testing.assert_allclose(prob.sum(axis=1), 1.0, rtol=0, atol=1e-5)
    host = bst.predict(Xp, raw_score=True)
    binned = bst.predict(Xp, raw_score=True, device=True)
    np.testing.assert_array_equal(binned, eng.predict_device(Xp, 0, n_iter))
    loaded = lgt.Booster({"device_type": "cuda", "verbose": -1},
                         model_str=bst.model_to_string())
    np.testing.assert_array_equal(loaded.predict(Xp, raw_score=True), host)
    raw = loaded.predict(Xp, raw_score=True, device=True)
    le = loaded._engine
    assert le._serving.device.type == "cuda"
    assert le._serving.raw_pack.count == n_iter * K
    np.testing.assert_array_equal(raw, le.predict_device(Xp, 0, n_iter))
    # raw scores are f32 sums: within 1e-5 of max(1, |score|) (the rare
    # classes' scores reach hundreds, where f32's spacing is several
    # 1e-5), so within 1e-5 absolute wherever |score| < 1, logged apart;
    # probabilities within 1e-5
    worst, worst_abs, worst_small, worst_prob = {}, {}, {}, {}
    scale = np.maximum(1.0, np.abs(host))
    small = np.abs(host) < 1.0
    for name, b, out in (("binned", bst, binned), ("raw", loaded, raw)):
        assert out.shape == host.shape
        err = np.abs(out - host)
        worst[name] = (err / scale).max(axis=0)
        worst_abs[name] = err.max(axis=0)
        worst_small[name] = float(err[small].max(initial=0.0))
        assert (worst[name] <= 1e-5).all(), (name, worst[name])
        assert worst_small[name] <= 1e-5, (name, worst_small[name])
        worst_prob[name] = float(np.abs(b.predict(Xp, device=True)
                                        - prob).max())
        assert worst_prob[name] <= 1e-5, (name, worst_prob[name])
    np.testing.assert_allclose(loaded.predict(Xp), prob, rtol=0, atol=1e-12)
    assert eng._device_eval()
    dev_vals = eng.eval_train()
    score_np = eng.score.cpu().numpy().astype(np.float64)
    diffs = {}
    for (_, name, value, _), m in zip(dev_vals, eng.train_metrics):
        (_, host_value, _), = m.eval(score_np, eng.objective)
        diffs[name] = abs(value - host_value)
        assert diffs[name] <= 1e-5, (name, value, host_value)
    log(f"phase 9 predict rows={len(Xp)} trees={n_iter * K}: probabilities "
        f"sum to 1; raw score max_abs_diff / max(1, |score|) per class "
        f"column to the host walk: binned={worst['binned'].tolist()} "
        f"raw={worst['raw'].tolist()}; absolute: "
        f"binned={worst_abs['binned'].tolist()} "
        f"raw={worst_abs['raw'].tolist()}; absolute where |score| < 1 "
        f"({int(small.sum())} of {small.size}): {worst_small} "
        f"(max |score| per class: "
        f"{np.abs(host).max(axis=0).tolist()}); probabilities max_abs_diff:"
        f" {worst_prob}; "
        f"text round trip: host walk bit for bit; device metrics against "
        f"the host's: {diffs}")


def phase_multiclass_cross_check():
    """cuda against cpu on a small multiclass set, as phase 6 does, on the
    compact, hybrid (K2) and full (B2) paths: every class's first root
    split equal, ``multi_logloss`` within rtol 1e-4."""
    import lightgbm_tpu_torch as lgt
    X, y = synth_covtype(MC_SMALL_CLASS_ROWS, seed=1)
    K = len(MC_SMALL_CLASS_ROWS)
    for name, extra in (("compact", {}),
                        ("hybrid", {"tpu_row_scheduling": "level"}),
                        ("full", {"tpu_row_scheduling": "full"})):
        out = {}
        tc = time.perf_counter()
        for dev in ("cuda", "cpu"):
            params = {"objective": "multiclass", "num_class": K,
                      "num_leaves": 31, "max_bin": MAX_BIN, "verbose": -1,
                      "device_type": dev, "metric": ["multi_logloss"],
                      **extra}
            bst = lgt.train(params, lgt.Dataset(X, label=y),
                            num_boost_round=3)
            assert bst.num_trees() == 3 * K
            roots = [(int(t.split_feature[0]), float(t.threshold_real[0]),
                      int(t.decision_type[0]))
                     for t in bst._engine.models[:K]]
            loss = dict((m, v) for _, m, v, _ in bst.eval_train())
            out[dev] = (roots, loss["multi_logloss"])
        log(f"phase 9 cross-check {name} root_splits cuda={out['cuda'][0]} "
            f"cpu={out['cpu'][0]} multi_logloss cuda={out['cuda'][1]!r} "
            f"cpu={out['cpu'][1]!r} seconds={time.perf_counter() - tc!r}")
        assert out["cuda"][0] == out["cpu"][0], (name, out)
        np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                                   err_msg=name)


def _timed_renewal(objective, spent):
    """Wrap ``objective.renew_tree_output`` to add its host seconds to
    ``spent[0]``."""
    renew = objective.renew_tree_output

    def timed(*args):
        t = time.perf_counter()
        out = renew(*args)
        spent[0] += time.perf_counter() - t
        return out
    objective.renew_tree_output = timed


def phase_objectives(X, ds):
    """The ten pointwise objectives on phase 4's rows (binned with its bin
    mappers), labels made valid for each from the rows' signal: real for
    L1, Huber, Fair, quantile and MAPE, positive for Poisson, Gamma and
    Tweedie, in [0, 1] for the cross-entropies; 1 + OBJ_ITERS iterations
    each, its ``LEARNING_METRIC`` falling and K1 launched."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.core.metrics import DEFAULT_METRIC_FOR_OBJECTIVE
    rng = np.random.default_rng(2)
    X64 = np.asarray(X, np.float64)
    t = (X64[:, 0] - 0.5 * X64[:, 1] * X64[:, 2] + 0.25 * X64[:, 3] ** 2
         + 0.3 * rng.normal(size=len(X64)))
    labels = {"real": t, "positive": np.exp(0.5 * t),
              "unit": 1.0 / (1.0 + np.exp(-t))}
    t0 = time.perf_counter()
    sets = {kind: lgt.Dataset(X, label=v, reference=ds).construct()
            for kind, v in labels.items()}
    log(f"phase 9 objectives: three label sets binned with phase 4's "
        f"mappers in {time.perf_counter() - t0!r} s")
    for name in POINTWISE:
        kind = ("positive" if name in ("poisson", "gamma", "tweedie") else
                "unit" if name.startswith("cross_entropy") else "real")
        default = DEFAULT_METRIC_FOR_OBJECTIVE[name]
        metric = LEARNING_METRIC.get(name, default)
        params = bench_params(objective=name,
                              metric=list(dict.fromkeys([metric, default])))
        reset_counts()
        bst = lgt.Booster(params, sets[kind])
        renew_s = [0.0]
        if bst._engine.objective.is_renew_tree_output():
            _timed_renewal(bst._engine.objective, renew_s)
        iter_s = []
        for i in range(1 + OBJ_ITERS):
            tt = time.perf_counter()
            assert not bst.update(), name
            torch.cuda.synchronize()
            iter_s.append(time.perf_counter() - tt)
            if i == 0:
                first = {m: v for _, m, v, _ in bst.eval_train()}
        last = {m: v for _, m, v, _ in bst.eval_train()}
        counts = read_counts()
        assert counts["hist_rowmajor_f32"] > 0, (name, counts)
        assert np.isfinite(last[metric]) and last[metric] < first[metric], \
            (name, first, last)
        readings = " ".join(f"{m} first={first[m]!r} last={last[m]!r}"
                            for m in first)
        renewal = (f" renew_tree_output_host_s_per_tree="
                   f"{renew_s[0] / (1 + OBJ_ITERS)!r}"
                   if bst._engine.objective.is_renew_tree_output() else "")
        log(f"phase 9 objective={name} labels={kind} warmup_s={iter_s[0]!r} "
            f"iter_s={iter_s[1:]!r} {readings}"
            f" K1_launches={counts['hist_rowmajor_f32']}{renewal}")
        del bst


def mslr_query_sizes(n_rows, n_queries, rng, max_len=MSLR_MAX_QUERY,
                     span=False):
    """Query lengths from a lognormal of mean ``n_rows / n_queries``,
    clipped to [1, max_len] and fitted to sum to ``n_rows``; with
    ``span`` one query has 1 document and one ``max_len``."""
    sigma = MSLR_LENGTH_SIGMA
    raw = rng.lognormal(np.log(n_rows / n_queries) - sigma ** 2 / 2, sigma,
                        size=n_queries)
    sizes = np.clip(np.round(raw * n_rows / raw.sum()), 1,
                    max_len).astype(np.int64)
    fixed = np.zeros(n_queries, bool)
    if span:
        order = np.argsort(sizes)
        sizes[order[0]], sizes[order[-1]] = 1, max_len
        fixed[[order[0], order[-1]]] = True
    while sizes.sum() != n_rows:
        d = int(n_rows - sizes.sum())
        room = (sizes < max_len) if d > 0 else (sizes > 1)
        cand = np.flatnonzero(room & ~fixed)
        pick = rng.choice(cand, size=min(abs(d), len(cand)), replace=False)
        sizes[pick] += np.sign(d)
    return sizes


def synth_mslr(n_rows=MSLR_ROWS, n_queries=MSLR_QUERIES, seed=0, span=True):
    """MSLR-shaped rows from a seed: query lengths as
    ``mslr_query_sizes``, ``MSLR_COUNT_COLUMNS`` count columns and the
    rest normal values to three decimals (f32), relevance 0-4 from a
    hidden score of a few columns plus a per-query offset and noise, cut
    at the quantiles of ``MSLR_GRADE_SHARE``. Returns X, y, sizes and each
    row's slot in its query."""
    rng = np.random.default_rng(seed)
    sizes = mslr_query_sizes(n_rows, n_queries, rng, span=span)
    X = rng.standard_normal((n_rows, MSLR_FEATURES), dtype=np.float32)
    c = MSLR_COUNT_COLUMNS
    X[:, :c] = np.floor(np.exp(X[:, :c]))
    X[:, c:] = np.round(X[:, c:], 3)
    qid = np.repeat(np.arange(n_queries), sizes)
    hidden = (X[:, c] + 0.6 * X[:, c + 1] - 0.4 * X[:, c + 2] * X[:, c + 3]
              + 0.3 * np.log1p(X[:, 0]) + 0.5 * rng.normal(size=n_queries)[qid]
              + 0.8 * rng.normal(size=n_rows))
    cuts = np.quantile(hidden, np.cumsum(MSLR_GRADE_SHARE)[:-1])
    y = np.searchsorted(cuts, hidden, side="right").astype(np.float32)
    starts = np.repeat(np.cumsum(sizes) - sizes, sizes)
    slot = np.arange(n_rows) - starts
    return X, y, sizes, slot


def rank_params(**extra):
    return bench_params(**{"objective": "lambdarank", "metric": ["ndcg"],
                           "eval_at": MSLR_EVAL_AT, **extra})


def train_ranking(ds, valid, params, iters, base):
    """Warm-up plus ``iters`` timed iterations with the launch counts
    zeroed just before and read just after; the validation ``ndcg@k``
    after every iteration (evaluated outside the timed span); the peak
    device memory of the run above ``base`` bytes."""
    import lightgbm_tpu_torch as lgt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    bst = lgt.Booster(params, ds)
    bst.add_valid(valid, "valid")
    iter_s, ndcg = [], []
    for _ in range(1 + iters):
        t = time.perf_counter()
        assert not bst.update()
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t)
        ndcg.append({m: v for _, m, v, _ in bst.eval_valid()})
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() - base
    first, last = ndcg[0]["ndcg@10"], ndcg[-1]["ndcg@10"]
    assert np.isfinite(last) and last > first, ndcg
    leaves = sum(t.num_leaves for t in bst._engine.models)
    assert counts["hist_rowmajor_f32"] == leaves, (counts, leaves)
    assert sum(counts.values()) == leaves, counts
    return bst, dict(warm_s=iter_s[0], iter_s=iter_s[1:],
                     median_iter_s=statistics.median(iter_s[1:]),
                     counts=counts, peak_bytes=peak, ndcg=ndcg)


def phase_ranking():
    """Phase 10: lambdarank (compact, then with position bias) and
    rank_xendcg at the MSLR-WEB30K shape through ``Booster`` on the card,
    with a validation set of ``MSLR_VALID_QUERIES`` more queries; the
    gradient pass timed against its bound; then a small cuda/cpu
    cross-check on the compact, hybrid and full paths."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.core import objective as objective_mod
    t_phase = time.perf_counter()
    # earlier phases' boosters freed before the phase's base is read
    gc.collect()
    torch.cuda.synchronize()
    phase_base = torch.cuda.memory_allocated()
    X, y, sizes, slot = synth_mslr()
    t_bin = time.perf_counter()
    log(f"phase 10 data_s={t_bin - t_phase!r} shape={X.shape} "
        f"queries={len(sizes)} docs_per_query min={sizes.min()} "
        f"mean={sizes.mean()!r} max={sizes.max()} grades="
        f"{np.bincount(y.astype(np.int64), minlength=5).tolist()}")
    ds = lgt.Dataset(X, label=y, group=sizes).construct()
    n_valid = int(round(MSLR_VALID_QUERIES * MSLR_ROWS / MSLR_QUERIES))
    Xv, yv, gv, _ = synth_mslr(n_valid, MSLR_VALID_QUERIES, seed=1,
                               span=False)
    valid = lgt.Dataset(Xv, label=yv, group=gv, reference=ds).construct()
    del X, Xv
    log(f"phase 10 binning_s={time.perf_counter() - t_bin!r} "
        f"valid_rows={len(yv)} valid_queries={len(gv)}")
    runs = {}
    bst, r = train_ranking(ds, valid, rank_params(), RANK_TIMED_ITERS,
                           phase_base)
    runs["lambdarank"] = r["counts"]
    obj = bst._engine.objective
    pairs = sum(bk.shape[0] * bk.shape[1] ** 2 for bk in obj.buckets)
    chunks = [(bk.shape[1], q1 - q0) for bk in obj.buckets
              for q0, q1 in obj.chunks(bk)]
    chunk_bytes = max(4 * q * m * m for m, q in chunks)
    log(f"phase 10 lambdarank compact warmup_s={r['warm_s']!r} "
        f"iter_s={r['iter_s']!r} median_iter_s={r['median_iter_s']!r} "
        f"launches={r['counts']} "
        f"peak_bytes_above_phase_start={r['peak_bytes']} "
        f"buckets={[bk.shape for bk in obj.buckets]} "
        f"sum_QM2={pairs} chunks={len(chunks)} "
        f"largest_chunk_bytes={chunk_bytes} "
        f"chunk_budget_bytes={objective_mod.PAIR_CHUNK_BYTES}")
    for i, row in enumerate(r["ndcg"]):
        log(f"phase 10 lambdarank iteration={i + 1} valid {row}")
    eng = bst._engine
    grad = lambda: obj.get_gradients(eng.score[0])
    g, h = grad()
    assert bool(torch.isfinite(g).all()) and bool(torch.isfinite(h).all())
    assert not bool(torch.signbit(g[g == 0]).any())
    grad_ms = cuda_ms(grad, reps=3)
    grad_dev_ms = device_ms(grad, reps=3)
    pass_bound = 2 * 4 * pairs / HBM_BYTES_PER_S * 1e3
    log(f"phase 10 lambdarank gradient pass ms={grad_ms!r} "
        f"device_ms={grad_dev_ms!r} one_f32_read_and_write_of_the_pairs_ms="
        f"{pass_bound!r} passes_worth={grad_dev_ms / pass_bound!r}")
    del bst, eng, obj, g, h, grad

    b, rx = train_ranking(ds, valid, rank_params(objective="rank_xendcg"),
                          RANK_ONE_ITERS, phase_base)
    runs["rank_xendcg"] = rx["counts"]
    log(f"phase 10 rank_xendcg warmup_s={rx['warm_s']!r} "
        f"iter_s={rx['iter_s']!r} launches={rx['counts']} "
        f"peak_bytes_above_phase_start={rx['peak_bytes']} valid={rx['ndcg']}")
    del b
    ds.set_position(slot)
    b, rp = train_ranking(ds, valid, rank_params(), RANK_ONE_ITERS,
                          phase_base)
    runs["lambdarank_position"] = rp["counts"]
    biases = b._engine.objective.pos_biases
    assert len(biases) == MSLR_MAX_QUERY and np.isfinite(biases).all()
    log(f"phase 10 lambdarank position bias warmup_s={rp['warm_s']!r} "
        f"iter_s={rp['iter_s']!r} launches={rp['counts']} "
        f"peak_bytes_above_phase_start={rp['peak_bytes']} valid={rp['ndcg']} "
        f"biases[:10]={biases[:10].tolist()} "
        f"biases_min={biases.min()!r} biases_max={biases.max()!r}")
    del b, ds, valid
    phase_ranking_cross_check()
    log(f"phase 10 seconds={time.perf_counter() - t_phase!r}")
    return runs


def phase_ranking_cross_check():
    """cuda against cpu on a small ranking set, as phase 6 does, on the
    compact, hybrid (K2) and full (B2) paths: the first root split equal,
    ``ndcg@10`` within rtol 1e-6."""
    import lightgbm_tpu_torch as lgt
    X, y, sizes, _ = synth_mslr(RANK_SMALL_ROWS, RANK_SMALL_QUERIES, seed=2,
                                span=False)
    for name, extra in (("compact", {}),
                        ("hybrid", {"tpu_row_scheduling": "level"}),
                        ("full", {"tpu_row_scheduling": "full"})):
        out = {}
        tc = time.perf_counter()
        for dev in ("cuda", "cpu"):
            params = {"objective": "lambdarank", "num_leaves": 31,
                      "max_bin": MAX_BIN, "verbose": -1, "device_type": dev,
                      "metric": ["ndcg"], "eval_at": [10], **extra}
            reset_counts()
            bst = lgt.train(params, lgt.Dataset(X, label=y, group=sizes),
                            num_boost_round=3, keep_training_booster=True)
            counts = read_counts()
            t0 = bst._engine.models[0]
            ndcg = dict((m, v) for _, m, v, _ in bst.eval_train())
            out[dev] = ((int(t0.split_feature[0]), float(t0.threshold_real[0]),
                         int(t0.decision_type[0])), ndcg["ndcg@10"], counts)
        log(f"phase 10 cross-check {name} root_split cuda={out['cuda'][0]} "
            f"cpu={out['cpu'][0]} ndcg@10 cuda={out['cuda'][1]!r} "
            f"cpu={out['cpu'][1]!r} cuda_launches={out['cuda'][2]} "
            f"seconds={time.perf_counter() - tc!r}")
        assert out["cuda"][0] == out["cpu"][0], (name, out)
        assert sum(out["cuda"][2].values()) > 0, (name, out)
        assert sum(out["cpu"][2].values()) == 0, (name, out)
        np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-6,
                                   err_msg=name)


def binary_logloss(y, p):
    p = np.clip(p, 1e-15, 1 - 1e-15)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def assert_same_tree(a, b, what):
    for f in TREE_FIELDS + ("threshold_real", "decision_type"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f"{what}: {f}")


def phase_user_surface(bst, ds, X, binning_s):
    """Phase 11: the user surface on phase 4's rows and model: ``cv``
    (5 stratified folds, K1), an ``LGBMClassifier`` (no scikit-learn on the
    card: the stand-ins), ``pred_contrib``, ``refit``, the packed forest
    after ``set_leaf_output``, pickled and deep-copied boosters and the
    device memory they leave, a binary dataset file, then a cuda/CPU
    cross-check of group folds and of ``LGBMRegressor`` on the compact,
    hybrid and full paths. Returns each run's launches of its kernel mode
    (K1, but K2 and B2 in the hybrid and full cross-checks)."""
    import copy
    import os
    import pickle
    import shutil
    import tempfile

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.sklearn import _SKLEARN_INSTALLED
    t_phase = time.perf_counter()
    y = ds.get_label().astype(np.float64)
    model = bst._engine.models
    launches = {}

    # -- cv: five fold Boosters in lock step, each through K1
    stamps = []

    def stamp(env):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    stamp.before_iteration = True

    def stamp_after(env):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    res = lgt.cv(bench_params(), ds, num_boost_round=CV_ROUNDS,
                 nfold=CV_FOLDS, stratified=True, seed=0,
                 return_cvbooster=True, callbacks=[stamp, stamp_after])
    torch.cuda.synchronize()
    cv_s = time.perf_counter() - t
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    cvb = res["cvbooster"]
    leaves = sum(t.num_leaves for b in cvb.boosters for t in b._engine.models)
    assert counts["hist_rowmajor_f32"] == leaves, (counts, leaves)
    assert sum(counts.values()) == leaves, counts
    launches["cv"] = counts["hist_rowmajor_f32"]
    mean = res["valid binary_logloss-mean"]
    assert len(mean) == CV_ROUNDS and all(np.diff(mean) < 0), mean
    round_s = [b - a for a, b in zip(stamps[::2], stamps[1::2])]
    log(f"phase 11 cv folds={CV_FOLDS} rounds={CV_ROUNDS} seconds={cv_s!r} "
        f"round_s={round_s!r} s_per_fold_iteration="
        f"{[r / CV_FOLDS for r in round_s]!r} (update and device metrics "
        f"of the {CV_FOLDS} folds, divided) launches={counts}")
    log(f"phase 11 cv valid binary_logloss-mean={mean!r} -stdv="
        f"{res['valid binary_logloss-stdv']!r} valid auc-mean="
        f"{res['valid auc-mean']!r}")
    log(f"phase 11 cv peak_bytes_above_start={peak} (the {CV_FOLDS} fold "
        f"Boosters together) held_bytes_after={held}")
    fold_ll = []
    for b in cvb.boosters:
        ev = dict((m, v) for _, m, v, _ in b.eval(b.valid_sets[0], "valid"))
        fold_ll.append(ev["binary_logloss"])
    np.testing.assert_allclose(np.mean(fold_ll), mean[-1], rtol=0,
                               atol=1e-6)
    b0 = cvb.boosters[0]
    rows0 = b0.valid_sets[0].used_indices
    host_ll = binary_logloss(y[rows0], b0.predict(np.asarray(X[rows0],
                                                             np.float64)))
    assert abs(fold_ll[0] - host_ll) <= 1e-6, (fold_ll[0], host_ll)
    log(f"phase 11 cv fold 0: eval on its held-out subset "
        f"({len(rows0)} rows) binary_logloss={fold_ll[0]!r}, the host "
        f"walk's {host_ll!r}; the folds' mean equals the result's")
    del res, cvb, b0, b
    gc.collect()

    # -- the sklearn estimator, through the stand-ins where sklearn is absent
    reset_counts()
    t = time.perf_counter()
    clf = lgt.LGBMClassifier(n_estimators=SK_ROUNDS, num_leaves=NUM_LEAVES,
                             learning_rate=0.1, max_bin=MAX_BIN,
                             device_type="cuda", verbose=-1).fit(X, y)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    counts = read_counts()
    sk_trees = clf.booster_._engine.models
    assert len(sk_trees) == SK_ROUNDS
    assert counts["hist_rowmajor_f32"] == sum(t.num_leaves
                                              for t in sk_trees), counts
    launches["sklearn"] = counts["hist_rowmajor_f32"]
    assert_same_tree(sk_trees[0], model[0], "LGBMClassifier tree 0")
    Xs = np.asarray(X[:PREDICT_ROWS], np.float64)
    np.testing.assert_array_equal(clf.predict_proba(Xs)[:, 1],
                                  clf.booster_.predict(Xs))
    np.testing.assert_array_equal(clf.classes_, [0.0, 1.0])
    log(f"phase 11 sklearn _SKLEARN_INSTALLED={_SKLEARN_INSTALLED} "
        f"LGBMClassifier fit_s={fit_s!r} (binning included) rounds="
        f"{SK_ROUNDS} launches={counts}; first tree equals phase 4's split "
        f"for split; predict_proba[:, 1] equals booster_.predict on "
        f"{PREDICT_ROWS} rows")
    del clf, sk_trees

    # -- pred_contrib: the host TreeSHAP over phase 4's trees
    Xc = np.asarray(X[:CONTRIB_ROWS], np.float64)
    t = time.perf_counter()
    phi = bst.predict(Xc, pred_contrib=True)
    shap_s = time.perf_counter() - t
    raw = bst.predict(Xc, raw_score=True)
    assert phi.shape == (CONTRIB_ROWS, N_FEATURES + 1), phi.shape
    gap = np.abs(phi.sum(axis=1) - raw)
    assert (gap <= 1e-6 * np.maximum(1.0, np.abs(raw))).all(), gap.max()
    log(f"phase 11 pred_contrib rows={CONTRIB_ROWS} trees={len(model)} "
        f"leaves={[t.num_leaves for t in model]} seconds={shap_s!r} "
        f"rows_per_s_host={CONTRIB_ROWS / shap_s!r} max |sum - raw|="
        f"{float(gap.max())!r}")

    # -- refit to rows of another seed
    Xr, yr = synth_higgs(REFIT_ROWS, N_FEATURES, seed=3)
    Xr = np.asarray(Xr, np.float64)
    ll_before = binary_logloss(yr, bst.predict(Xr))
    t = time.perf_counter()
    refit = bst.refit(Xr, yr, decay_rate=0.9)
    refit_s = time.perf_counter() - t
    for a, b in zip(refit._engine.models, model):
        assert a.num_leaves == b.num_leaves
        for f in ("split_feature", "threshold_real", "left_child",
                  "right_child", "decision_type"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert np.isfinite(a.leaf_value).all()
    # tree 0 by hand: at score 0 the binary gradient is 0.5 - y and the
    # hessian 0.25 (sigmoid 1), so a populated leaf becomes 0.9 * old +
    # 0.1 * rate * -G / H
    leaf0 = model[0].predict_leaf(Xr)
    G = np.bincount(leaf0, 0.5 - yr, minlength=model[0].num_leaves)
    H = np.bincount(leaf0, np.full(REFIT_ROWS, 0.25),
                    minlength=model[0].num_leaves)
    new0 = np.where(H > 0, 0.9 * model[0].leaf_value
                    + 0.1 * model[0].shrinkage * -G / np.maximum(H, 1e-300),
                    model[0].leaf_value)
    np.testing.assert_allclose(refit._engine.models[0].leaf_value, new0,
                               rtol=1e-6, atol=1e-9)
    ll_after = binary_logloss(yr, refit.predict(Xr))
    # the blend moves each shrunk leaf towards the refit rows' shrunk
    # Newton step, which is no descent step for the loss: on rows of the
    # training distribution the logloss moves by noise either way
    assert ll_after <= ll_before * (1 + 1e-3), (ll_before, ll_after)
    log(f"phase 11 refit rows={REFIT_ROWS} decay_rate=0.9 seconds="
        f"{refit_s!r} trees={len(model)} shapes unchanged, tree 0's leaves "
        f"equal the hand refit; logloss on those rows {ll_before!r} -> "
        f"{ll_after!r} (relative change "
        f"{(ll_after - ll_before) / ll_before!r})")
    del refit

    # -- the packed forest after set_leaf_output (binned route)
    Xp = np.asarray(X[:PREDICT_ROWS], np.float64)
    before = bst.predict(Xp, device=True, raw_score=True)
    leaf = int(np.argmax(model[0].leaf_count))
    old = bst.get_leaf_output(0, leaf)
    bst.set_leaf_output(0, leaf, old + 1.0)
    after = bst.predict(Xp, device=True, raw_score=True)
    host = bst.predict(Xp, raw_score=True)
    np.testing.assert_allclose(after, host, rtol=0, atol=1e-5)
    moved = model[0].predict_leaf(Xp) == leaf
    assert moved.any() and np.abs(after - before)[moved].min() > 0.99
    np.testing.assert_array_equal(after[~moved], before[~moved])
    bst.set_leaf_output(0, leaf, old)
    np.testing.assert_array_equal(bst.predict(Xp, device=True,
                                              raw_score=True), before)
    log(f"phase 11 set_leaf_output(0, {leaf}) +1: predict(device=True) "
        f"repacked, within 1e-5 of the host walk (max_abs_diff="
        f"{float(np.abs(after - host).max())!r}), {int(moved.sum())} rows "
        "moved by 1, the others unchanged; restored bit for bit")

    # -- pickled and deep-copied boosters predict on the card, then leave
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    copies = {"pickle": pickle.loads(pickle.dumps(bst)),
              "deepcopy": copy.deepcopy(bst)}
    for name, c in copies.items():
        out = c.predict(Xp, device=True, raw_score=True)
        srv = c._engine._serving
        assert srv.device.type == "cuda" and \
            srv.raw_pack.count == len(model), name
        np.testing.assert_array_equal(out, before, err_msg=name)
    torch.cuda.synchronize()
    with_copies = torch.cuda.memory_allocated() - mem0
    del copies, c, srv, out
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - mem0
    assert abs(left) <= 1 << 20, left
    log(f"phase 11 pickle and deepcopy: raw device route equals the "
        f"Booster's binned route bit for bit on {PREDICT_ROWS} rows; device "
        f"bytes held with the copies {with_copies}, after dropping them "
        f"{left} (no cyclic collection)")

    # -- a binary dataset file of phase 4's rows
    tmp = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        path = os.path.join(tmp, "phase4.bin")
        t = time.perf_counter()
        ds.save_binary(path)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        loaded = lgt.Dataset(path).construct()
        load_s = time.perf_counter() - t
        size = os.path.getsize(path)
    finally:
        shutil.rmtree(tmp)
    np.testing.assert_array_equal(loaded.binned.bins, ds.binned.bins)
    reset_counts()
    b1 = lgt.Booster(bench_params(), loaded)
    assert not b1.update()
    counts = read_counts()
    launches["binary_file"] = counts["hist_rowmajor_f32"]
    assert launches["binary_file"] == b1._engine.models[0].num_leaves
    assert_same_tree(b1._engine.models[0], model[0], "binary file tree 0")
    log(f"phase 11 save_binary_s={save_s!r} load_s={load_s!r} "
        f"(phase 4 binning_s={binning_s!r}) file_bytes={size}; one "
        f"iteration from the file: first tree equals phase 4's, "
        f"launches={counts}")
    del b1, loaded
    phase_user_surface_cross_check(launches)
    log(f"phase 11 seconds={time.perf_counter() - t_phase!r}")
    return launches


def phase_user_surface_cross_check(launches):
    """cuda against cpu on small runs: ``cv`` with group folds on ranking
    rows, and ``LGBMRegressor`` on the compact, hybrid (K2) and full (B2)
    paths: root splits equal; fold means within 1e-6, the training l2
    within rtol 1e-6."""
    import lightgbm_tpu_torch as lgt
    X, y, sizes, _ = synth_mslr(SURFACE_SMALL_ROWS, SURFACE_SMALL_QUERIES,
                                seed=3, span=False)
    out = {}
    tc = time.perf_counter()
    for dev in ("cuda", "cpu"):
        params = {"objective": "lambdarank", "num_leaves": 31,
                  "max_bin": MAX_BIN, "verbose": -1, "device_type": dev,
                  "metric": ["ndcg"], "eval_at": [10]}
        reset_counts()
        res = lgt.cv(params, lgt.Dataset(X, label=y, group=sizes),
                     num_boost_round=3, nfold=CV_FOLDS, seed=0,
                     return_cvbooster=True)
        counts = read_counts()
        bs = res["cvbooster"].boosters
        for b in bs:
            q = b.valid_sets[0].get_group()
            assert q.sum() == b.valid_sets[0].num_data()
        t0 = bs[0]._engine.models[0]
        out[dev] = ((int(t0.split_feature[0]), float(t0.threshold_real[0]),
                     int(t0.decision_type[0])),
                    res["valid ndcg@10-mean"], counts)
    log(f"phase 11 cross-check cv group folds root_split cuda="
        f"{out['cuda'][0]} cpu={out['cpu'][0]} ndcg@10-mean cuda="
        f"{out['cuda'][1]!r} cpu={out['cpu'][1]!r} cuda_launches="
        f"{out['cuda'][2]} seconds={time.perf_counter() - tc!r}")
    assert out["cuda"][0] == out["cpu"][0], out
    assert out["cuda"][2]["hist_rowmajor_f32"] > 0, out
    assert sum(out["cpu"][2].values()) == 0, out
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=0,
                               atol=1e-6)
    launches["cross_check_cv"] = out["cuda"][2]["hist_rowmajor_f32"]

    X, _ = synth_higgs(SURFACE_SMALL_ROWS, N_FEATURES, seed=4)
    yr = X[:, 0] - 0.5 * X[:, 1] * X[:, 2] + 0.25 * X[:, 3] ** 2
    for name, extra, mode in SURFACE_PATHS:
        out = {}
        tc = time.perf_counter()
        for dev in ("cuda", "cpu"):
            reset_counts()
            reg = lgt.LGBMRegressor(n_estimators=3, num_leaves=31,
                                    max_bin=MAX_BIN, device_type=dev,
                                    verbose=-1, **extra).fit(X, yr)
            counts = read_counts()
            t0 = reg.booster_._engine.models[0]
            l2 = float(np.mean((reg.predict(X) - yr) ** 2))
            out[dev] = ((int(t0.split_feature[0]),
                         float(t0.threshold_real[0]),
                         int(t0.decision_type[0])), l2, counts)
        log(f"phase 11 cross-check LGBMRegressor {name} root_split cuda="
            f"{out['cuda'][0]} cpu={out['cpu'][0]} l2 cuda="
            f"{out['cuda'][1]!r} cpu={out['cpu'][1]!r} cuda_launches="
            f"{out['cuda'][2]} seconds={time.perf_counter() - tc!r}")
        assert out["cuda"][0] == out["cpu"][0], (name, out)
        assert out["cuda"][2][mode] > 0, (name, out)
        assert sum(out["cpu"][2].values()) == 0, (name, out)
        np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-6,
                                   err_msg=name)
        launches[f"cross_check_{name}_{mode}"] = out["cuda"][2][mode]


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
    log(f"phase 3 K1 done at {time.perf_counter() - t:.1f} s")
    k2 = phase_k2(dev, flush)
    log(f"phase 3 K2 done at {time.perf_counter() - t:.1f} s")
    b2 = phase_b2(dev, flush)
    log(f"phase 3 B2 done at {time.perf_counter() - t:.1f} s")
    del flush
    main_run, bst, ds, X = phase_main_path()
    compact_counts = main_run["counts"]
    log(f"phase 4 done at {time.perf_counter() - t:.1f} s")
    paths, ds_u16 = phase_paths(ds, X, bst._engine.models[0])
    log(f"phase 5 done at {time.perf_counter() - t:.1f} s")
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
    log(f"phase 7 done at {time.perf_counter() - t:.1f} s")
    del bst_u16, ds_u16
    phase_training_api(ds, X, main_run["median_iter_s"])
    log(f"phase 8 done at {time.perf_counter() - t:.1f} s")
    mc_runs = phase_multiclass(X, ds)
    log(f"phase 9 done at {time.perf_counter() - t:.1f} s")
    surface_runs = phase_user_surface(bst, ds, X, main_run["binning_s"])
    log(f"phase 11 done at {time.perf_counter() - t:.1f} s")
    del bst, ds, X
    rank_runs = phase_ranking()
    log(f"phase 10 done at {time.perf_counter() - t:.1f} s")
    phase_cross_check()
    log(f"phase 6 done at {time.perf_counter() - t:.1f} s")

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
    log("phase 9 launches by run: " + json.dumps(mc_runs))
    log("phase 10 launches by run: " + json.dumps(rank_runs))
    log("phase 11 launches by run: " + json.dumps(surface_runs))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
