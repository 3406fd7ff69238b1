"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--profile]

(``--dist-worker PLAN`` runs one rank of phase 17's gang, and
``--gang-worker PLAN`` one rank of phase 18's supervised gang; the
phases start those themselves.)

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
   launches on the same input must give the same bits. Then K1, K2 and
   B2 in every mode, u8 and u16, fed gh as row sampling makes it (a 0/1
   bag as the count channel, g and h amplified as GOSS does) over skewed
   bins: dyadic and int8 gh bit for bit, the bagged counts exact;
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
   B2), each run's launch counts showing its u16 kernel mode, and the
   compact and full paths profiled for one more iteration (K1's and
   B2's device time; the full paths must have run B2's wide kernels and
   not its grouped ones); the quantized run logs the device time of one
   tree's threefry draws; with ``--profile``, two more iterations of the
   compact, level and full paths under ``torch.profiler`` show where an
   iteration's time goes (device busy share, K1's, K2's and B2's device
   time per iteration, top ops, launches and device-to-host reads);
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
   compact grower (1 warm-up and 1 timed iteration, K1 launched once per
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
   hybrid and full paths (all in the side process, below); and, in this
   process after phase 8, the ten pointwise objectives (L1, Huber,
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
   queries: lambdarank on the compact grower (1 warm-up and 1 timed
   iteration, K1 launched once per leaf), rank_xendcg and lambdarank
   with each row's slot in its query as its position (1 + 1 each, the
   position biases finite); the validation ``ndcg@10`` rising in each
   run; the lambdarank gradient pass timed (CUDA events, and the device
   alone) beside one f32 read and write of its query pairs, with the
   pair count, the chunks and the bytes of the largest; the peak device
   bytes of each run; then cuda against the CPU on 20,000 rows in 200
   queries on the compact, hybrid and full paths (root splits equal,
   ``ndcg@10`` within rtol 1e-6);
11. the user surface on phase 4's rows and model (run after phase 9's
   objectives):
   ``cv`` with 5 stratified folds and 2 rounds (every fold through K1, the
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
   equal, training l2 within rtol 1e-6);
12. the sampling and boosting variants on phase 4's rows (run after
   phase 11) through ``Booster``: phase 4's configuration again as the
   phase's baseline, bagging 0.5 every iteration on the compact path
   (1 + 2 iterations), on the hybrid (K2) and the full (B2) paths,
   balanced bagging (0.5 / 0.3) and ``tpu_device_bagging`` (1 + 1 each),
   column sampling 0.8 a tree and 0.8 a node (1 + 2), GOSS at rate 0.5
   drawn on the host (``tpu_async_boosting=false``; 1 + 2: it samples
   from iteration 2), DART (drop rate 0.3, no skip;
   1 + 5) and a random forest (bagging 0.632, column sampling 0.8;
   1 + 2); each run launching its kernel mode and learning (its
   training logloss falls; a forest's stays under the prior's), with its
   s/iteration beside phase 4's, the host ms of its sampling, the rows
   K1 reads an iteration, its peak bytes and its logloss after each
   iteration; DART's traversal of the training rows (a dropped tree
   costs two) over the strided and over contiguous bins; the forest's
   mean of its trees by both device routes within 1e-5 of the host
   walk, each the engine's device scores; then cuda against the CPU on
   20,000 rows, every variant (bagging also on the hybrid and full
   paths): the same bags, the trees to the binary standard of the CPU
   tests;
13. categorical features at the shape of the 2009 ASA Data Expo airline
   data (LightGBM's docs/Experiments.rst "Expo", 11,000,000 rows of the
   eight columns szilard/benchm-ml trains on: Month, DayofMonth,
   DayOfWeek, UniqueCarrier, Origin and Dest categorical, the airports
   Zipf-skewed; DepTime and Distance numerical; about one positive in
   five) through ``Booster`` with 200,000 held-out rows as a validation
   set (in the side process, after phase 9's multiclass part): the
   compact path (1 + 1
   iterations), quantized, hybrid (K2), full (B2) and compact at
   max_bin=1023 (Origin and Dest of 301 bins: K1 over u16 bins; 1 + 1
   each), and the compact path with the codes as numbers (1 + 1); each
   run launching its kernel mode and learning (the held-out logloss
   falling and under the prior's), with its s/iteration beside phase
   4's, its peak bytes, the binning seconds and how many splits a tree
   takes on a categorical feature; the held-out rows by the binned
   device route within 1e-5 of the host walk, and the model loaded from
   its text answering by the host walk; then cuda against the CPU on
   20,000 rows for every grower (the level grower at depth 4 for the
   hybrid's level phase), each leaf holding the same rows, values to
   the binary standard widened for sums over large category bins;
14. wide sparse data at the shape of the Allstate claims data (LightGBM's
   docs/Experiments.rst, the EFB benchmark: its 13,200,000 rows cut to
   8,000,000, of 4,228 one-hot features from 32 raw categorical columns,
   made as scripts/scale_proof.py makes them) through ``Dataset`` over the CSR
   rows, which the auto rule packs straight into EFB groups at
   ``max_conflict_rate=0.01`` (at 0 it finds about 300 groups, more than
   8 K_max, and stores them multi-value; ingest seconds by stage, G,
   K_max and the groups' bytes), with 200,000 held-out rows as a
   validation set (in the side process, after phase 13, its data
   freed): the compact (K1
   over the group columns), quantized, hybrid (K2 then K1), full (B2
   over [G, R]) and multi-value (``tpu_sparse_storage=multival``, its
   own Dataset: the plain torch scatter over [R, K]) runs, 1 + 1
   iterations each, each launching its kernel mode exactly (multi-value:
   none) and learning (the held-out logloss falling, and under the
   prior's), with its s/iteration beside phase 4's and its peak bytes;
   the multi-value root histogram's device ms beside K1's over the
   groups; 50,000 held-out CSR rows in row blocks by the binned device
   route within 1e-5 of the host walk (rows/s); then cuda against the
   CPU on 20,000 rows, 1 round (compact, quantized, level at depth 4, full,
   multi-value: the same BundleInfo, each leaf holding the same rows,
   logloss within rtol 1e-4). On phase 4's rows (after phase 12): a
   bounded LRU histogram pool and no pool (``histogram_pool_size`` 5 and
   0.1 MB: hits, misses, K1 launches), and the rows as a ``Sequence``
   binning to the dense Dataset's bins;
15. constraints and tree variants on phase 4's rows (after phase 14's
   runs there): monotone constraints (+1, -1, +1 on the features phase
   4's first tree ranks first, second and third by gain) by the basic
   method, with ``monotone_penalty=2``, intermediate (on the compact
   path, on the full path (B2) and with quantized gradients) and
   advanced; interaction constraints (4 groups of 7); CEGB (split 0.1,
   coupled and lazy 1.0 on every feature, ``cegb_tradeoff=0.1``); a
   3-level forced prefix on the top two features at the medians of
   their nodes' rows; ``feature_contri`` 0.5 on
   half the features; extra_trees (compact and full); level scheduling
   with monotone constraints (the JAX package's fallback reason logged,
   the compact model trained); linear trees (``linear_lambda=0.1``) on a
   Dataset rebuilt with ``linear_tree``. 1 + 1 iterations each (linear
   1 + 2); each run launching its kernel mode (K1, B2 on the full
   path) and learning, its property checked (predictions monotone along
   the constrained features over 1,000 rows, every tree inside one
   interaction group, fewer features than phase 4's trees use under
   CEGB, the forced prefix at the top of every tree), with its
   s/iteration beside phase 4's, its training logloss after each
   iteration, K1's and B2's launches and its peak bytes; then cuda
   against the CPU on 20,000 rows, 2 rounds, 31 leaves, every run: trees
   to the binary standard, training scores within 1e-5, linear trees'
   host-walk predictions within 1e-5 and their device route answered by
   the host walk, said once;
16. asynchronous boosting, checkpoints and the training-side robustness
   on phase 4's rows (after phase 15): (a) 1 + 2 iterations with
   ``tpu_async_boosting`` auto (on for the card) and false, the same
   model text; (b) GOSS at rate 0.5 drawn on the card (1 + 3), the host
   sampler never called (no ``[K, N]`` gradient read), the draw of its
   last sampled iteration equal to the plain draw on the CPU from the
   same gradients bit for bit, s/iteration against phase 12's
   host-drawn GOSS and the draw's ms; (c) bagging 0.5 and columns 0.8
   through ``train``: an uninterrupted 4-round run, one killed mid-write
   of its third checkpoint (``write_kill:after=2``), its
   ``resume_from`` giving the uninterrupted model text and predictions
   (host walk and device route) bit for bit, a bit-flipped newest
   checkpoint skipped, the ms of each checkpoint write; (d) the numeric
   guard under ``nan_grad:after=1`` refusing iteration 1 with one tree
   kept, then two armed iterations timed and the guard's device ms;
   (e) the heartbeat of (a)'s async run (``compiling`` at iteration 0,
   ``iter`` after, ``seq`` rising), then two children on 100,000 of
   phase 4's rows under ``watch_child``, started after (d) and running
   beside (c) and (f): a healthy one exits 0, one under
   ``LGBM_TPU_FAULTS=hang:after=2`` is classified STALLED and ended
   within its 5 s budget of its last beat; (f) cuda against the CPU on
   20,000 rows: GOSS drawn on the device chain on both (the same bags)
   and a run killed at its second checkpoint and resumed, trees to the
   binary standard;
17. the distributed learners at phase 4's width (after phase 16, on its
   rows): (a) two ranks share the card over gloo (NCCL refuses two ranks
   on one device), started by one ``distributed.launch_local`` of this
   script (``--dist-worker PLAN``; each rank loads phase 4's binned rows
   from a binary file the phase writes and trains every run in one
   process start): data parallel f32 by
   all-reduce (1 + 2 iterations), quantized with deterministic rounding,
   by reduce-scatter, voting (``top_k=5``), feature parallel and data
   parallel under full scheduling (1 + 1 each); both ranks' texts equal,
   the quantized text the serial quantized model's (trained here) string
   for string, the others matching phase 4's model (phase 5's full one)
   to the binary standard with the nodes paired by position (near-tied
   leaves may be split in another order), each rank's K1 (B2) launched
   once a leaf; logged: s/iteration beside phase 4's, each collective's
   ms and calls a tree by kind, the bytes of a histogram reduction, the
   ``leaf_id`` all-gather, the launches per rank and the gang's start-up
   seconds; (b) a one-rank NCCL world in this process: quantized data
   parallel by all-reduce and by reduce-scatter (NCCL's collectives on
   the card, 1 + 1 each), each text the serial quantized one;
18. sharded ingestion and the supervised gang at phase 4's width (after
   phase 17): (a) on phase 17's gang, each rank synthesizes phase 4's
   table and keeps its block only (499,001 and 500,999 rows), built with
   ``pre_partition`` (distributed bin finding over the default sample),
   then data parallel f32 by all-reduce (1 + 2) and quantized with
   deterministic rounding (1 + 1): both ranks' mappers and texts equal,
   each rank's binned table its rows only, K1 once a leaf on each rank,
   and the f32 model's logloss on 200,000 held-out rows within 1%
   (relative) of phase 17's data-parallel f32 model of the same three
   trees; logged: each rank's ingest seconds by step, the summary and
   mapper bytes on the wire, the binned table's bytes against the
   replicated table's, s/iteration beside phase 4's and phase 17's;
   (b) on the same gang, a 200,000-row table, each rank writing its rows
   (99,000 and 101,000) to its own CSV file and loading it through the
   file route (``part{rank}.csv``), quantized data parallel, 4 rounds of
   ``train``, rank 0 writing a checkpoint and its gang manifest every
   iteration: the text equals, outside its parameters, the serial
   quantized model of the 200,000 rows trained here; (c) (b) again
   through ``launch_local(supervised=True)`` (``--gang-worker PLAN``)
   with ``rank_kill:rank=1:after=2`` in its first attempt: the
   supervisor ends the attempt (SIGTERM, no SIGKILL) and relaunches the
   gang once, both ranks resume from the newest valid manifest and end
   on (b)'s text string for string; logged: the first attempt's exit
   codes and the seconds from SIGTERM to its last exit, the relaunch's
   start-up seconds and the resumed iteration;
19. the model server and device TreeSHAP on phase 4's booster and phase
   7's 200,000 rows (after phase 18): (a) ``Booster.serve(linger_ms=2,
   raw_score=True)`` under 8 closed-loop client threads sending 2,000
   requests of log-uniform sizes over 1 to 4,096 rows; (b) meanwhile,
   from the half-way point, a trainer thread's two ``update()`` +
   ``publish()`` (K1 once a leaf): every response equals the same rows
   of one ``predict(device=True, raw_score=True)`` of the generation it
   names bit for bit, versions monotonic per client, no degraded or
   failed batch; logged: requests/s, rows/s, p50/p99 ms of the steady
   window and of all, batches and the coalesced requests and rows, each
   publish's ms and the p99 during the swaps; (c)
   ``predict(pred_contrib=True, device=True)`` of 20,000 rows within
   rtol 1e-4 / atol 1e-5 of the host TreeSHAP on 2,000 of them, additive
   to the device raw scores within 1e-5, a second call equal bit for
   bit (rows/s beside the host's; the kernels and device ms of one
   2,000-row call under ``torch.profiler``), then ``ModelServer.explain``
   from 4 clients with no host fallback; (d) under ``faults.inject``:
   ``dispatch_error`` twice (retried, bit-equal), ``oom`` once (bisected,
   bit-equal, not degraded), ``publish_fail`` (the old generation serves
   on at its version), the retry budget exhausted (degraded, host-walk
   answers equal the host predict bit for bit, the recovery probe
   un-degrades: seconds), ``bitflip:where=dev`` with the canary every
   0.2 s (detection, repair and un-quarantine: seconds; the pre-rot
   answers after); (e) a ``booster_from_arrays`` copy of the trees
   served by the raw route (rows/s; its ``predict(device=True)`` bit for
   bit);
20. the multi-tenant fleet (in the side process, after phase 6) at the
   JAX package's ``scripts/serving_load.py --fleet 100``: 100 binary
   tenants over its four (leaves, trees, F) archetypes on 3,000 rows each,
   20 trained on the card and 80 more over their Datasets (cut: the
   JAX benchmark trains all 100), 4 loaded models (the raw route) and a
   categorical tenant sharing a bucket with a numeric one, served by one
   ``lgt.serve_fleet``: (a) 8 closed-loop clients send 2,000 requests of
   32 rows, each to a uniformly drawn tenant (linger 2 ms, raw scores),
   and (b) from the half-way point one tenant's two ``update()`` +
   ``publish()``: every response equals its tenant's
   ``predict(device=True, raw_score=True)`` of the generation it names
   bit for bit, versions monotonic, no other tenant's answer changed;
   logged: requests/s, rows/s, p50/p99 ms, buckets, pack bytes, and the
   device kernels and ms of one coalesced batch of one bucket under
   ``torch.profiler`` (one scorer call); (c) a fleet under a memory
   budget of half its pack bytes: evictions and rebuilds, every answer
   bit-equal; (d) ``fleet.explain`` of two tenants equal to their own
   device ``pred_contrib`` array for array; (e) ``publish_fail`` (the old
   generation serves on), ``oom`` once on a coalesced pair (bisected,
   bit-equal, not degraded), and with the canary armed
   ``bitflip:where=dev`` (only that tenant quarantined, then repaired:
   seconds), the kept host pack rotted (caught by its CRC and rebuilt)
   and ``bitflip:where=host`` at a publish (refused by the anchor); (f)
   ``tpu_serving_fleet_shard=model`` over a two-entry mesh of the one
   card: the same bits;
21. the continual service (in the side process, after phase 20) on the
   bench params at the Higgs width: (a) ``Dataset(path, params=
   {"two_round": True})`` of a 200,000-row CSV (each round's host
   seconds and rows/s; the bins equal the rows binned in memory with the
   loader's mappers), 1 + 2 iterations (logloss falls; s/iteration
   beside phase 4's), and a 20,000-row two-round file trained on the
   card and on the CPU to the same trees by the binary standard; (b) the
   JAX package's ``scripts/serving_load.py --live`` topology:
   ``serve_continual`` with a supervised child trainer on the card
   (window 8,192, 2 iterations a cycle, a publish every 2) over a stream
   of 4,096 rows that a producer grows by 400 rows every 0.15 s,
   ``rank_kill:rank=0:after=5`` on the child's attempt 0, 16 open-loop
   Poisson clients at 200 requests/s of 32 rows (npy f64) for 20 s, then
   up to 60 s for two generations after the relaunch: no torn response
   (each equals its generation's checkpointed model by the device route
   or the host walk), generations monotone per client with a watermark
   each, at most half unverifiable, a relaunch and two generations after
   it, no publish error or client error; logged: requests/s, p50/p99/
   p999 ms, staleness p50/p99/max ms, boot and relaunch seconds,
   publishes and the trainer's seconds a cycle; (c) the same service with
   its trainer on a thread here for 3 publishes under 4 closed-loop
   clients (its K1 launches counted); (d) two of phase 20's archetypes
   behind the front door's fleet routes: bit for bit each tenant's
   ``predict(device=True)``, 400, 404, 413, 429 and 504 as the tests
   expect, ``/readyz`` 503 while a tenant is quarantined by
   ``bitflip:where=dev`` and ``/healthz`` 200;
22. shell and tooling (after phase 19) on phase 4's first 200,000 rows
   written as a CSV: (a) ``cli.run(["task=train", ...])`` with a 20,000-row
   valid file, ``metric_freq=1`` and ``snapshot_freq=2``, 5 iterations
   (s/iteration beside phase 4's, K1 launches; the trees equal
   ``lgt.train``'s on the same file and params, the snapshots pruned);
   (b) ``python -m lightgbm_tpu_torch config=...`` in children that name
   no device, train then predict (the result file the parent's predict
   written ``%g``); (c) ``task=convert_model`` of (a)'s model compiled with
   ``g++`` (raw scores within 1e-12 of the host walk); (d) the native
   library loads; its C++ parser against the numpy body (equal on a
   20,000-row slice; rows/s of each, and of the two-round loader's
   rounds); (e) a C host compiled with ``gcc`` against the library, which
   embeds the interpreter and trains 100,000 x 28, 255 leaves, on the
   card, then serves the saved model through the interpreter-free ABI
   (within 1e-12 of the training handle's host walk); (f) TreeSHAP of
   (a)'s model by the C++ kernel against the device's (rtol 1e-4 / atol
   1e-5); (g) where pyarrow is installed, the Arrow ABI in this process:
   a 20,000-row record batch trained 2 iterations on the card,
   ``PredictForArrow`` equal to ``PredictForMat``. (b)'s children and
   (e)'s host run beside (a), (c), (d), (f) and (g). Plotting draws on
   the host and is held on the CPU only (no matplotlib on the card's
   machine);
23. tracing and the lock-order tracker (after phase 22): (a) ``lgt.train``
   of phase 4's params on phase 4's Dataset, 2 iterations with
   ``global_timer`` on, then 2 more with ``tpu_profile_dir`` set too:
   each run's trees equal phase 4's first two string for string, its
   section table names the JAX package's five sections (each counted
   once a tree; their shares of the loop's wall time logged), and the
   trace file names K1's kernels (at most one a counted launch); logged:
   each iteration's seconds beside phase 4's, the profiler's cost an
   iteration, the trace's export seconds and bytes; (b) a ``ModelServer``
   over phase 4's booster, 4 clients sending 100 requests of log-uniform
   1..256 rows with one ``update()`` published when half are answered,
   in turns without and under ``lockorder.tracking()``: every answer its
   generation's ``predict(device=True)`` bit for bit, versions monotone a
   client, the tracked run with its locks tracked and no violation
   (requests/s and p50/p99 ms of each); a seeded inversion raises at the
   attempt; (c) conlint over the port's threaded modules: no new
   finding, every baseline entry reasoned.

Phases 9's multiclass part, 13, 14, 10, 6, 20 and 21 (in that order) need
nothing of phase 4's rows or model: they run in a second process
(``--side-worker PLAN``), started after phase 5 and run beside phases 7
to 19, 22 and 23 of this one (the card and the host shared), which prints its
lines when it ends; each process counts its own launches. Past 1,140 s
the script prints every thread's stack and exits 3.

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
MODE_ITERS = 1
U16_ITERS = 1
# the u16 paths profiled for one more iteration (K1's and B2's device
# time; the full paths must run B2's wide kernels only). The quantized
# and bf16 variants of compact and level lost theirs to pay for phase
# 17, level itself (K2's device time) for phase 18
U16_PROFILED = ("compact_u16", "full_u16", "full_quantized_u16")
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
# past this, the script prints every thread's stack and exits (the
# driver's limit is 1,200 s)
WATCHDOG_S = 1_140
# phase 8: validation rows (another seed), rounds with the validation set,
# and rounds of the continued training
VALID_ROWS = 200_000
API_ROUNDS = 6
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
MC_TIMED_ITERS = 1
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
RANK_TIMED_ITERS = 1
RANK_ONE_ITERS = 1
# the cross-check of phase 10 on cuda and on the CPU: 20,000 rows in 200
# queries, 31 leaves, 3 rounds
RANK_SMALL_ROWS, RANK_SMALL_QUERIES = 20_000, 200
# phase 11: cv folds and rounds, the estimator's rounds, rows explained by
# TreeSHAP, rows of the refit (another seed), and the cross-check's rows,
# queries, leaves and rounds
CV_FOLDS, CV_ROUNDS = 5, 2
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


# phase 3's sampled gh: K1 at these leaf sizes (the dense, wide and
# small paths), K2 at these node counts, B2 at these leaf sizes, each in
# u8 at MAX_BIN and in u16 at U16_MAX_BIN, over skewed bins (hot bins)
SAMPLED_K1_SHAPES = (N_ROWS, 4_097, 300)
SAMPLED_K2_NODES = 64
SAMPLED_B2_SHAPES = (N_ROWS, 65_536, 1)
# the bag keeps a row with this probability; GOSS multiplies the gradient
# and hessian of a sampled small-gradient row by (1 - top_rate) /
# other_rate (4 at 0.2 / 0.2), here on this share of the rows
SAMPLED_KEEP, SAMPLED_AMP_SHARE, SAMPLED_AMP = 0.5, 0.3, 4.0


def make_sampled_gh(mode, R, gen, dev, dyadic):
    """gh as row sampling makes it: ``[g*w, h*w, bag]`` with a 0/1 bag
    and w = bag times GOSS's amplification on some kept rows; int8 gh
    quantized from such rows, its count channel the bag. Dyadic values
    (k / 8, |k| <= 64, times 0, 1 or 4) that bf16 and f32 hold exactly."""
    bag = (torch.rand(R, generator=gen, device=dev) < SAMPLED_KEEP).float()
    amp = torch.where(torch.rand(R, generator=gen, device=dev)
                      < SAMPLED_AMP_SHARE, SAMPLED_AMP, 1.0)
    w = bag * amp
    if mode == "int8":
        q = torch.randint(-31, 32, (R, 2), generator=gen, device=dev,
                          dtype=torch.int32).float()
        return torch.cat([q * w[:, None], bag[:, None]], 1).to(torch.int8)
    if dyadic:
        gh2 = torch.randint(-64, 65, (R, 2), generator=gen, device=dev,
                            dtype=torch.int32).float() / 8
    else:
        gh2 = torch.randn((R, 2), generator=gen, device=dev)
    gh = torch.cat([gh2 * w[:, None], bag[:, None]], 1)
    return gh.to(torch.bfloat16) if mode == "bf16" else gh


def phase_sampled_gh(dev):
    """K1, K2 and B2 in every mode fed gh as bagging and GOSS make it
    (``make_sampled_gh``): a 0/1 count channel and amplified g and h,
    over skewed bins, against the exact sum: dyadic gh bit for bit,
    normal gh within the tolerance, the count channel (the bagged count)
    exact either way."""
    from lightgbm_tpu_torch.ops.hist_cuda import hist_cuda_fm, hist_cuda_rm
    from lightgbm_tpu_torch.ops.hist_level import hist_level, node_order
    from lightgbm_tpu_torch.ops.hist_level_cuda import hist_level_cuda
    from lightgbm_tpu_torch.ops.histogram import (hist_featmajor_exact,
                                                  hist_rowmajor_exact)
    R, F = N_ROWS, N_FEATURES
    gen = torch.Generator(device=dev).manual_seed(3)

    def check(mode, call, plain, S, what):
        err = 0.0
        for dyadic in (True, False):
            gh = make_sampled_gh(mode, S, gen, dev, dyadic)
            out, ref = call(gh), plain(gh)
            torch.cuda.synchronize()
            if dyadic or mode == "int8":
                assert torch.equal(out, ref), f"{what}: exact gh differ"
            else:
                err = max(err, check_against_plain(mode, out, ref, what))
            assert torch.equal(out[..., 2].double(), ref[..., 2].double()), \
                f"{what}: the bagged counts differ"
        return err

    for B in (MAX_BIN, U16_MAX_BIN):
        suffix = bin_width(B)[1]
        bins = random_bins((R, F), B, gen, dev, skewed=True)
        bins_fm = bins.T.contiguous()
        local = (torch.rand(R, generator=gen, device=dev) ** 3
                 * SAMPLED_K2_NODES).long().clamp(max=SAMPLED_K2_NODES - 1)
        in_lvl = torch.rand(R, generator=gen, device=dev) < 0.9
        order, seg = node_order(local, in_lvl, SAMPLED_K2_NODES)
        for mode in MODES:
            errs = {}
            for S in SAMPLED_K1_SHAPES:
                sub = bins[:S]
                errs[f"K1_S{S}"] = check(
                    mode, lambda g: hist_cuda_rm(sub, g, B),
                    lambda g: hist_rowmajor_exact(sub, g, B), S,
                    f"K1 {mode}{suffix} sampled gh S={S}")
            errs[f"K2_n{SAMPLED_K2_NODES}"] = check(
                mode, lambda g: hist_level_cuda(
                    bins, g, local, in_lvl, SAMPLED_K2_NODES, B,
                    order=order, seg=seg),
                lambda g: hist_level(bins, g, local, in_lvl,
                                     SAMPLED_K2_NODES, B), R,
                f"K2 {mode}{suffix} sampled gh")
            if mode in FM_MODES:
                for S in SAMPLED_B2_SHAPES:
                    ids = torch.randint(1, 9, (R,), generator=gen,
                                        device=dev)
                    ids[torch.randperm(R, generator=gen,
                                       device=dev)[:S]] = 0
                    keep = (ids == 0)[:, None]
                    errs[f"B2_S{S}"] = check(
                        mode, lambda g: hist_cuda_fm(bins_fm, g, B,
                                                     leaf_id=ids, leaf=0),
                        lambda g: hist_featmajor_exact(
                            bins_fm, g * keep.to(g.dtype), B), R,
                        f"B2 {mode}{suffix} sampled gh leaf rows={S}")
            log(f"phase 3 sampled gh mode={mode}{suffix} B={B} bins=skewed "
                f"keep={SAMPLED_KEEP} amplified_share={SAMPLED_AMP_SHARE} "
                f"amp={SAMPLED_AMP}: exact_gh_bit_for_bit=True "
                f"bagged_counts_exact=True max_abs_err={errs}")
        del bins, bins_fm, local, in_lvl, order, seg


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
        if name in U16_PROFILED:
            # one more iteration, profiled: K1's and B2's device time on
            # u16 bins (after the launch counts were read and the
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


def phase_multiclass():
    """Phase 9's multiclass part (softmax, then one-vs-all) at the
    Covertype shape through ``Booster`` on the card, on the compact,
    hybrid and full paths; its predictions by the host walk and both
    device routes, its device metrics and its text; a small cuda/cpu
    cross-check. The ten pointwise objectives on phase 4's rows are
    ``phase_objectives``."""
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
    log(f"phase 9 multiclass seconds={time.perf_counter() - t_phase!r}")
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
    t0 = t_phase = time.perf_counter()
    # one Dataset binned with phase 4's mappers, its label set in turn
    data = lgt.Dataset(X, label=labels["real"], reference=ds).construct()
    log(f"phase 9 objectives: phase 4's rows binned with its mappers in "
        f"{time.perf_counter() - t0!r} s, the three label sets set in turn")
    for name in POINTWISE:
        kind = ("positive" if name in ("poisson", "gamma", "tweedie") else
                "unit" if name.startswith("cross_entropy") else "real")
        default = DEFAULT_METRIC_FOR_OBJECTIVE[name]
        metric = LEARNING_METRIC.get(name, default)
        params = bench_params(objective=name,
                              metric=list(dict.fromkeys([metric, default])))
        data.set_label(labels[kind])
        reset_counts()
        bst = lgt.Booster(params, data)
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
    log(f"phase 9 objectives seconds={time.perf_counter() - t_phase!r}")


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


# phase 12: the sampling and boosting variants on phase 4's rows and
# binning (1M x 28, 255 leaves, 255 bins, binary): name -> (params, timed
# iterations after one warm-up, the kernel mode the run must launch).
# "none" is phase 4's configuration again, for the same phase's baseline
BAG = dict(bagging_fraction=0.5, bagging_freq=1)
SAMPLING_RUNS = {
    "none": ({}, 1, "hist_rowmajor_f32"),
    "bagging": (BAG, 2, "hist_rowmajor_f32"),
    "bagging_hybrid": (dict(BAG, tpu_row_scheduling="level"), 1,
                       "hist_level_f32"),
    "bagging_full": (dict(BAG, tpu_row_scheduling="full"), 1,
                     "hist_featmajor_f32"),
    "balanced": (dict(pos_bagging_fraction=0.5, neg_bagging_fraction=0.3),
                 1, "hist_rowmajor_f32"),
    "device_bagging": (dict(BAG, tpu_device_bagging=True), 1,
                       "hist_rowmajor_f32"),
    "column_sampling": (dict(feature_fraction=0.8,
                             feature_fraction_bynode=0.8), 2,
                        "hist_rowmajor_f32"),
    # at learning rate 0.5 GOSS samples from iteration int(1 / 0.5) = 2:
    # the second of the two timed iterations; drawn on the host
    # (synchronous: auto would draw on the card, which phase 16 holds)
    "goss": (dict(data_sample_strategy="goss", learning_rate=0.5,
                  tpu_async_boosting="false"), 2, "hist_rowmajor_f32"),
    "dart": (dict(boosting="dart", drop_rate=0.3, skip_drop=0.0), 5,
             "hist_rowmajor_f32"),
    "rf": (dict(boosting="rf", bagging_fraction=0.632, bagging_freq=1,
                feature_fraction=0.8), 2, "hist_rowmajor_f32"),
}
# the cross-check of phase 12 on cuda and on the CPU: every run above
# but the baseline, 20,000 rows, 31 leaves, 3 rounds
SAMPLING_SMALL_ROWS = 20_000


def sampling_rate(params):
    """The factor every stored leaf value carries: the learning rate, 1
    for a random forest."""
    return 1.0 if params.get("boosting") == "rf" else params["learning_rate"]


def sampling_grad_max(params):
    """The largest |gradient| of a binary row under the run's sampling,
    GOSS's amplification (1 - top_rate) / other_rate included."""
    if params.get("data_sample_strategy") == "goss":
        from lightgbm_tpu_torch import Config
        cfg = Config(params)
        return (1.0 - cfg.top_rate) / cfg.other_rate
    return 1.0


def record_bags(eng):
    """Each iteration's bag (numpy bool [N]) as the engine draws it, by
    wrapping its sampling step (an iteration with no sample keeps every
    row)."""
    bags = []
    row_sample = eng._row_sample

    def recorded(grad, hess, *rest):
        pair = row_sample(grad, hess, *rest)
        bags.append(np.ones(eng.num_data, bool) if pair is None
                    else pair[0].cpu().numpy() > 0)
        return pair
    eng._row_sample = recorded
    return bags


def rows_at_nodes(t, X):
    """Boolean row mask of every internal node of a host tree (a node's
    parent always has the smaller index)."""
    masks = [None] * (t.num_leaves - 1)
    masks[0] = np.ones(len(X), bool)
    for i in range(t.num_leaves - 1):
        x = X[:, t.split_feature[i]]
        go_left = np.where(np.isnan(x), (t.decision_type[i] & 2) != 0,
                           np.nan_to_num(x) <= t.threshold_real[i])
        for child, side in ((t.left_child[i], go_left),
                            (t.right_child[i], ~go_left)):
            if child >= 0:
                masks[child] = masks[i] & side
    return masks


def assert_trees_to_binary_standard(a, b, X, bags, rate, g_max, h_max,
                                    what):
    """Two boosters' trees to the binary standard of the port's CPU tests
    (tests/test_torch_multiclass.py): the same structure and (bagged)
    counts; a threshold may differ only where no row of the node's bag
    lies between the two, ``default_left`` only at a node of no missing
    value (these rows have none); leaf hessian sums within 1e-6 N max h,
    leaf values within 1e-6 rate N max|g| / H; on the rows of every bag
    the same leaves, and each raw score within the sum of its leaves'
    value bounds (the CPU tests' 1e-5 of the largest score is for ulp
    differences of the gradients; the card also sums each histogram in
    another order)."""
    n = len(X)
    ta, tb = a._engine.models, b._engine.models
    assert len(ta) == len(tb), what
    for i, (p, q) in enumerate(zip(ta, tb)):
        nl = p.num_leaves
        assert q.num_leaves == nl, (what, i)
        ni = nl - 1
        for f, m in (("split_feature", ni), ("left_child", ni),
                     ("right_child", ni), ("internal_count", ni),
                     ("leaf_count", nl)):
            np.testing.assert_array_equal(
                np.asarray(getattr(p, f))[:m], np.asarray(getattr(q, f))[:m],
                err_msg=f"{what} tree {i} {f}")
        if nl <= 1:
            continue
        np.testing.assert_array_equal(p.decision_type[:ni] & ~2,
                                      q.decision_type[:ni] & ~2)
        node_rows = [r & bags[i] for r in rows_at_nodes(q, X)]
        for j in np.flatnonzero(p.threshold_real[:ni] !=
                                q.threshold_real[:ni]):
            x = X[node_rows[j], q.split_feature[j]]
            lo, hi = sorted((p.threshold_real[j], q.threshold_real[j]))
            assert not ((x > lo) & (x <= hi)).any(), (what, i, j, lo, hi)
        wa, wb = p.leaf_weight[:nl], q.leaf_weight[:nl]
        assert (np.abs(wa - wb) < 1e-6 * n * h_max).all(), (what, i)
        assert (np.abs(p.leaf_value[:nl] - q.leaf_value[:nl])
                < 1e-6 * rate * n * g_max / np.maximum(wa, 1e-12)).all(), \
            (what, i)
    Xb = X[np.logical_and.reduce(bags)]
    leaves = b.predict(Xb, pred_leaf=True)
    np.testing.assert_array_equal(a.predict(Xb, pred_leaf=True), leaves,
                                  err_msg=what)
    # a row's raw score within the sum of its leaves' value bounds
    tol = sum(1e-6 * rate * n * g_max
              / np.maximum(t.leaf_weight[leaves[:, i]], 1e-12)
              for i, t in enumerate(tb))
    diff = np.abs(a.predict(Xb, raw_score=True)
                  - b.predict(Xb, raw_score=True))
    assert (diff <= tol).all(), (what, float(diff.max()),
                                 float((diff / tol).max()))


def paired_nodes(p, q):
    """The internal nodes and the leaves of two host trees paired by
    walking both from the root in step; an AssertionError where their
    shapes differ."""
    nodes, leaves, stack = [], [], [(0, 0)]
    while stack:
        i, j = stack.pop()
        if i < 0 or j < 0:
            assert i < 0 and j < 0, (i, j)
            leaves.append((~i, ~j))
            continue
        nodes.append((i, j))
        stack += [(int(p.left_child[i]), int(q.left_child[j])),
                  (int(p.right_child[i]), int(q.right_child[j]))]
    ni, nj = (np.asarray(v, np.int64) for v in zip(*nodes))
    li, lj = (np.asarray(v, np.int64) for v in zip(*leaves))
    return ni, nj, li, lj


def node_rows(t, X, j):
    """Boolean mask of the rows of X at internal node ``j`` of a host
    tree, by the path from the root (``rows_at_nodes`` for one node)."""
    parent = {}
    for i in range(t.num_leaves - 1):
        for child, left in ((t.left_child[i], True),
                            (t.right_child[i], False)):
            if child >= 0:
                parent[int(child)] = (i, left)
    mask = np.ones(len(X), bool)
    while j in parent:
        i, left = parent[j]
        x = X[:, t.split_feature[i]]
        go_left = np.where(np.isnan(x), (t.decision_type[i] & 2) != 0,
                           np.nan_to_num(x) <= t.threshold_real[i])
        mask &= go_left if left else ~go_left
        j = i
    return mask


def assert_trees_in_any_order(a, b, X, rate, g_max, h_max, what,
                              check_rows=200_000):
    """``assert_trees_to_binary_standard`` (every row in the bag) with the
    nodes paired by position instead of by number: the order a tree's
    splits were taken in may differ. Best-first growth splits the leaf
    of largest gain next, and two leaves whose gains lie an ulp apart
    swap places when a histogram is summed in another order (two
    ranks' halves added, against one pass): the same splits, numbered
    otherwise. Each paired node has the same feature, count and
    direction rule, a threshold that differs only where no training row
    of the node lies between the two; each paired leaf the same count,
    its hessian sum and value within the binary standard's bounds (N the
    training rows); on the first ``check_rows`` rows each row the paired
    leaf, and its raw score within the sum of its leaves' bounds.
    Returns how many trees were numbered otherwise."""
    n = len(X)
    ta, tb = a._engine.models, b._engine.models
    assert len(ta) == len(tb), what
    Xc = X[:check_rows]
    la, lb = a.predict(Xc, pred_leaf=True), b.predict(Xc, pred_leaf=True)
    renumbered = 0
    tol = np.zeros(len(Xc))
    for t, (p, q) in enumerate(zip(ta, tb)):
        assert p.num_leaves == q.num_leaves > 1, (what, t)
        ni, nj, li, lj = paired_nodes(p, q)
        renumbered += int((ni != nj).any())
        for f in ("split_feature", "internal_count"):
            np.testing.assert_array_equal(
                np.asarray(getattr(p, f))[ni], np.asarray(getattr(q, f))[nj],
                err_msg=f"{what} tree {t} {f}")
        np.testing.assert_array_equal(p.decision_type[ni] & ~2,
                                      q.decision_type[nj] & ~2)
        for i, j in zip(ni, nj):
            if p.threshold_real[i] != q.threshold_real[j]:
                x = X[node_rows(q, X, int(j)), q.split_feature[j]]
                lo, hi = sorted((p.threshold_real[i], q.threshold_real[j]))
                assert not ((x > lo) & (x <= hi)).any(), (what, t, j, lo, hi)
        np.testing.assert_array_equal(p.leaf_count[li], q.leaf_count[lj])
        wa, wb = p.leaf_weight[li], q.leaf_weight[lj]
        assert (np.abs(wa - wb) < 1e-6 * n * h_max).all(), (what, t)
        assert (np.abs(p.leaf_value[li] - q.leaf_value[lj])
                < 1e-6 * rate * n * g_max / np.maximum(wa, 1e-12)).all(), \
            (what, t)
        image = np.full(q.num_leaves, -1, np.int64)
        image[lj] = li
        np.testing.assert_array_equal(image[lb[:, t]], la[:, t],
                                      err_msg=f"{what} tree {t} leaves")
        tol += 1e-6 * rate * n * g_max / np.maximum(
            q.leaf_weight[lb[:, t]], 1e-12)
    diff = np.abs(a.predict(Xc, raw_score=True)
                  - b.predict(Xc, raw_score=True))
    assert (diff <= tol).all(), (what, float(diff.max()),
                                 float((diff / tol).max()))
    return renumbered


def nonzero(counts):
    """The launch counts of the modes that ran."""
    return {k: v for k, v in counts.items() if v}


def train_variant(ds, params, iters):
    """Warm-up plus ``iters`` timed iterations, the launch counts zeroed
    just before and read just after; per iteration its seconds, the
    training ``binary_logloss`` and ``auc`` after it, the rows K1 read
    (counted around the compact grower's K1 calls, so the launches and
    their counts stay K1's own) and, for DART, the trees it dropped; the
    peak device bytes above the start."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.core import grower
    k1 = grower.hist_cuda_rm
    rows_read = [0]

    def counted(bins, gh, num_bin):
        rows_read[0] += bins.shape[0]
        return k1(bins, gh, num_bin)
    grower.hist_cuda_rm = counted
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        bst = lgt.Booster(params, ds)
        r = dict(iter_s=[], logloss=[], auc=[], k1_rows=[], dropped=[])
        for i in range(1 + iters):
            rows_read[0] = 0
            t = time.perf_counter()
            assert not bst.update(), "stopped early"
            torch.cuda.synchronize()
            if i:
                r["iter_s"].append(time.perf_counter() - t)
            ev = dict((m, v) for _, m, v, _ in bst.eval_train())
            r["logloss"].append(ev["binary_logloss"])
            r["auc"].append(ev["auc"])
            r["k1_rows"].append(rows_read[0])
            r["dropped"].append(len(getattr(bst._engine, "drop_index", ())))
        r["counts"] = read_counts()
        r["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    finally:
        grower.hist_cuda_rm = k1
    r["median_iter_s"] = statistics.median(r["iter_s"])
    return bst, r


def median_ms(fn, reps=3):
    """Median wall ms of ``fn()`` (the device synchronized after each)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def sampling_host_ms(eng):
    """Host ms of one sample as the engine draws it, by a fresh sampler
    of the same config: the ``[K, N]`` gradient read (GOSS), the draw
    (the bag, GOSS's partition over |g h|, or the threefry draw on the
    device) and the mask's upload; and one tree's column masks drawn by
    the engine itself."""
    from lightgbm_tpu_torch.models.sample_strategy import SampleStrategy
    cfg = eng.config
    strat = SampleStrategy.create(cfg, eng.num_data,
                                  eng.num_tree_per_iteration,
                                  metadata=eng.train_set.metadata)
    out = {}
    if cfg.feature_fraction < 1.0 or cfg.feature_fraction_bynode < 1.0:
        out["column_masks_ms"] = median_ms(eng._feature_mask)
    resample = iter(range(0, 1 << 30, max(cfg.bagging_freq, 1)))
    if not strat.needs_grad and not strat.need_bagging:
        return out
    if strat.needs_grad:
        grad, hess = eng.objective.get_gradients(eng.score[0])
        out["grad_read_ms"] = median_ms(
            lambda: (grad.cpu().numpy(), hess.cpu().numpy()))
        g, h = grad.cpu().numpy()[None], hess.cpu().numpy()[None]
        it = int(1.0 / cfg.learning_rate)
        out["draw_ms"] = median_ms(lambda: strat.sample(it, g, h))
        pair = strat.sample(it, g, h)
    elif cfg.tpu_device_bagging:
        out["device_draw_ms"] = median_ms(lambda: strat.sample_dev(
            next(resample), eng._bag_key, eng.device))
        return out
    else:
        out["draw_ms"] = median_ms(lambda: strat.sample(next(resample)))
        pair = strat.sample(next(resample))
    if pair is not None:
        out["upload_ms"] = median_ms(lambda: [
            torch.as_tensor(a, device=eng.device) for a in
            (pair[:1] if pair[1] is pair[0] else pair)])
    return out


def phase_sampling(ds, X, phase4_iter_s):
    """Phase 12: the sampling and boosting variants of SAMPLING_RUNS on
    phase 4's rows through ``Booster``: each run learns (its training
    logloss falls, a random forest's stays under the prior's), launches
    its kernel mode, and logs its s/iteration beside phase 4's, the host
    ms of its sampling, the rows K1 reads an iteration, its peak bytes
    and its logloss after each iteration; DART's traversal of the
    training rows (a dropped tree costs two) on the strided bins and on a
    contiguous copy; the random forest predicts by both device routes
    the mean of its trees that the host walk gives (within 1e-5); then
    cuda against the CPU on 20,000 rows. Returns each run's launches of
    its kernel mode and its median s/iteration."""
    import lightgbm_tpu_torch as lgt
    t_phase = time.perf_counter()
    launches, k1_rows, medians = {}, {}, {}
    prior = float(np.log(2.0))          # balanced labels
    # a Booster leaves its params in its Dataset's: each run starts from
    # the Dataset's own
    ds_params = dict(ds.params)
    for name, (extra, iters, must) in SAMPLING_RUNS.items():
        tr = time.perf_counter()
        ds.params = dict(ds_params)
        bst, r = train_variant(ds, bench_params(**extra), iters)
        eng = bst._engine
        c = r["counts"]
        log(f"phase 12 run={name} iter_s={r['iter_s']!r} "
            f"median_iter_s={r['median_iter_s']!r} "
            f"phase4_median_iter_s={phase4_iter_s!r} "
            f"over_phase4={r['median_iter_s'] / phase4_iter_s!r} "
            f"launches={nonzero(c)} k1_rows_per_iter={r['k1_rows']} "
            f"dropped_per_iter={r['dropped']} "
            f"peak_bytes_above_start={r['peak_bytes']} "
            f"logloss_per_iter={r['logloss']!r} auc_last={r['auc'][-1]!r}")
        assert c[must] > 0, (name, c)
        assert r["auc"][-1] > 0.7, (name, r["auc"])
        if name == "rf":
            assert max(r["logloss"]) < prior, (name, r["logloss"])
        else:
            assert r["logloss"][-1] < r["logloss"][0], (name, r["logloss"])
        if name not in ("none", "dart"):
            log(f"phase 12 run={name} sampling_host_ms="
                f"{sampling_host_ms(eng)}")
        if name == "dart":
            assert sum(r["dropped"]) > 0, r["dropped"]
            bins_fm = eng._train_bins_fm()
            t0 = eng.models[0]
            strided_ms = cuda_ms(lambda: eng._tree_outputs(t0, bins_fm),
                                 reps=5)
            contig = bins_fm.contiguous()
            contig_ms = cuda_ms(lambda: eng._tree_outputs(t0, contig),
                                reps=5)
            log(f"phase 12 run=dart traversal_ms_strided={strided_ms!r} "
                f"traversal_ms_contiguous={contig_ms!r} "
                f"ms_per_dropped_tree={2 * strided_ms!r} "
                f"contiguous_copy_bytes={contig.numel()} "
                f"bins_stride={tuple(bins_fm.stride())}")
            del contig
        if name == "rf":
            phase_sampling_rf_predict(bst, X)
        launches[name] = c[must]
        k1_rows[name] = r["k1_rows"]
        medians[name] = r["median_iter_s"]
        del bst, eng
        gc.collect()
        log(f"phase 12 run={name} seconds={time.perf_counter() - tr!r}")
    ds.params = ds_params
    log(f"phase 12 k1_rows_per_iter without sampling={k1_rows['none']} "
        f"with bagging 0.5={k1_rows['bagging']} (the bag keeps every "
        "physical row in the partition)")
    phase_sampling_cross_check(launches)
    log(f"phase 12 seconds={time.perf_counter() - t_phase!r}")
    return launches, medians


def phase_sampling_rf_predict(bst, X):
    """The random forest's mean of its trees by the host walk, the
    binned device route and the raw device route of its loaded text."""
    import lightgbm_tpu_torch as lgt
    eng = bst._engine
    Xp = np.asarray(X[:PREDICT_ROWS], np.float64)
    n_iter = bst.current_iteration()
    host = bst.predict(Xp, raw_score=True, device=False)
    total = sum(t.predict(Xp) for t in eng.models)
    np.testing.assert_allclose(host * n_iter, total, rtol=1e-12, atol=1e-12)
    t = time.perf_counter()
    binned = bst.predict(Xp, raw_score=True, device=True)
    binned_s = time.perf_counter() - t
    # no fallback went unseen: the answer is the engine's device scores
    assert np.array_equal(binned, eng.predict_device(Xp, 0, n_iter)[:, 0]
                          / n_iter)
    loaded = lgt.Booster({"device_type": "cuda"},
                         model_str=bst.model_to_string())
    assert loaded._engine.average_output
    t = time.perf_counter()
    raw_route = loaded.predict(Xp, raw_score=True, device=True)
    raw_s = time.perf_counter() - t
    assert np.array_equal(raw_route, loaded._engine.predict_device(
        Xp, 0, n_iter)[:, 0] / n_iter)
    err = {k: float(np.abs(v - host).max())
           for k, v in (("binned", binned), ("raw", raw_route))}
    log(f"phase 12 run=rf predict rows={len(Xp)} iterations={n_iter} "
        f"max_abs_err_vs_host_walk={err} binned_rows_per_s="
        f"{len(Xp) / binned_s!r} raw_rows_per_s={len(Xp) / raw_s!r}")
    assert max(err.values()) < 1e-5, err


def phase_sampling_cross_check(launches):
    """cuda against the CPU on SAMPLING_SMALL_ROWS rows for every run of
    SAMPLING_RUNS but the baseline (compact, and bagging on the hybrid
    and full paths): trees to the binary standard over each iteration's
    bag (the CPU run's; both draw the same bags), the CPU launching no
    kernel."""
    import lightgbm_tpu_torch as lgt
    X, y = synth_higgs(SAMPLING_SMALL_ROWS, N_FEATURES, seed=5)
    for name, (extra, _, must) in SAMPLING_RUNS.items():
        if name == "none":
            continue
        tc = time.perf_counter()
        out = {}
        for dev in ("cuda", "cpu"):
            params = bench_params(num_leaves=31, device_type=dev, **extra)
            reset_counts()
            bst = lgt.Booster(params, lgt.Dataset(X, label=y))
            bags = record_bags(bst._engine)
            for _ in range(3):
                assert not bst.update(), (name, dev)
            loss = dict((m, v) for _, m, v, _ in bst.eval_train())
            out[dev] = (bst, bags, read_counts(), loss["binary_logloss"])
        (cb, cbags, cc, closs), (pb, pbags, pc, ploss) = out["cuda"], \
            out["cpu"]
        bags_equal = all(np.array_equal(a, b) for a, b in zip(cbags, pbags))
        log(f"phase 12 cross-check run={name} logloss cuda={closs!r} "
            f"cpu={ploss!r} bags_equal={bags_equal} "
            f"cuda_launches={nonzero(cc)} "
            f"seconds={time.perf_counter() - tc!r}")
        assert bags_equal, name
        assert cc[must] > 0 and sum(pc.values()) == 0, (name, cc, pc)
        assert_trees_to_binary_standard(
            cb, pb, X.astype(np.float64), pbags, sampling_rate(params),
            sampling_grad_max(params), 0.25 * sampling_grad_max(params),
            f"phase 12 cross-check {name}")
        np.testing.assert_allclose(closs, ploss, rtol=1e-4, err_msg=name)
        launches[f"cross_check_{name}_{must}"] = cc[must]


# phase 13: categorical features at the shape of the 2009 ASA Data Expo
# airline on-time data (LightGBM's docs/Experiments.rst "Expo" row, 11M
# rows; the eight raw columns szilard/benchm-ml trains on, target
# dep_delayed_15min): name, categories, Zipf exponent of the codes (0:
# uniform). Origin and Dest are Zipf-skewed, as airports are
AIRLINE_ROWS = 11_000_000
AIRLINE_HOLDOUT = 200_000
AIRLINE_COLUMNS = ("Month", "DayofMonth", "DayOfWeek", "DepTime",
                   "UniqueCarrier", "Origin", "Dest", "Distance")
AIRLINE_CATEGORICAL = {"Month": (12, 0.0), "DayofMonth": (31, 0.0),
                       "DayOfWeek": (7, 0.0), "UniqueCarrier": (22, 0.6),
                       "Origin": (300, 1.4), "Dest": (300, 1.4)}
AIRLINE_CAT_INDEX = [AIRLINE_COLUMNS.index(c) for c in AIRLINE_CATEGORICAL]
# about one flight in five departs 15 minutes late
AIRLINE_POSITIVE_SHARE = 0.2
# name -> (params, timed iterations after one warm-up, categorical
# features or not, the kernel mode the run must launch); *_u16 runs bin
# at max_bin=1023, where Origin and Dest take 301 bins (uint16 bins)
CAT_RUNS = {
    "compact": ({}, 1, True, "hist_rowmajor_f32"),
    "quantized": (dict(use_quantized_grad=True), 1, True,
                  "hist_rowmajor_int8"),
    "hybrid": (dict(tpu_row_scheduling="level"), 1, True, "hist_level_f32"),
    "full": (dict(tpu_row_scheduling="full"), 1, True, "hist_featmajor_f32"),
    "compact_u16": (dict(max_bin=U16_MAX_BIN), 1, True,
                    "hist_rowmajor_f32_u16"),
    # the codes as numbers: the same rows with no categorical feature
    "codes_as_numbers": ({}, 1, False, "hist_rowmajor_f32"),
}
# the cross-check of phase 13 on cuda and on the CPU: 20,000 rows, 31
# leaves, 3 rounds, every grower: the level grower at max_depth=4 stands
# for the hybrid's level phase (the hybrid commits the first of the
# nodes ranked by e, and e ties exactly across a set and its complement,
# which the last bit of the f32 sums orders: a different commit, a
# different tree), the compact path for its tail
CAT_SMALL_ROWS = 20_000
CAT_CHECKS = {
    "compact": ({}, "hist_rowmajor_f32"),
    "quantized": (dict(use_quantized_grad=True), "hist_rowmajor_int8"),
    "level": (dict(tpu_row_scheduling="level", max_depth=4),
              "hist_level_f32"),
    "full": (dict(tpu_row_scheduling="full"), "hist_featmajor_f32"),
    "compact_u16": (dict(max_bin=U16_MAX_BIN), "hist_rowmajor_f32_u16"),
}


def synth_airline(n, seed=0):
    """Airline-shaped rows (float32 [n, 8], columns AIRLINE_COLUMNS) and
    labels: codes 1-based for the calendar columns and 0-based for the
    carrier and airports, DepTime as hhmm, Distance in miles (30-4,900).
    The label is a logistic function of per-category effects (drawn at
    random from the fixed seed 1, so not monotone in the code), the
    departure hour and the distance, plus noise, cut at about one
    positive in five."""
    eff_rng = np.random.default_rng(1)
    rng = np.random.default_rng(seed)
    X = np.empty((n, len(AIRLINE_COLUMNS)), np.float32)
    logit = np.zeros(n, np.float32)
    for name, (k, zipf) in AIRLINE_CATEGORICAL.items():
        p = 1.0 / np.arange(1, k + 1) ** zipf
        codes = rng.choice(k, size=n, p=p / p.sum())
        effect = eff_rng.normal(scale=0.35, size=k).astype(np.float32)
        logit += effect[codes]
        base = 1 if name in ("Month", "DayofMonth", "DayOfWeek") else 0
        X[:, AIRLINE_COLUMNS.index(name)] = codes + base
    minutes = np.clip(rng.normal(800, 280, size=n), 0, 1439).astype(np.int64)
    X[:, AIRLINE_COLUMNS.index("DepTime")] = minutes // 60 * 100 + minutes % 60
    dist = np.clip(rng.lognormal(6.4, 0.65, size=n), 30, 4900)
    X[:, AIRLINE_COLUMNS.index("Distance")] = np.round(dist)
    logit += (1.2 * minutes / 1440.0 + 0.05 * np.log(dist)).astype(np.float32)
    logit += rng.logistic(size=n).astype(np.float32)
    # the cut from the fixed-seed rows, so every sample shares it
    cut = np.quantile(logit[:min(n, 1_000_000)], 1 - AIRLINE_POSITIVE_SHARE)
    return X, (logit > cut).astype(np.float32)


def cat_split_stats(models):
    """Per tree: splits on a categorical feature, and the mean size of
    their category sets."""
    out = []
    for t in models:
        cnt = np.asarray(t.cat_count_inner)
        k = cnt[cnt > 0]
        out.append((int(len(k)), float(k.mean()) if len(k) else 0.0))
    return out


def train_categorical(ds, valid, params, iters):
    """Warm-up plus ``iters`` timed iterations of a Booster with the
    held-out rows as its validation set, the launch counts zeroed just
    before and read just after; the held-out logloss and AUC after each
    iteration; the peak device bytes above the start."""
    import lightgbm_tpu_torch as lgt
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    bst = lgt.Booster(params, ds)
    bst.add_valid(valid, "holdout")
    r = dict(iter_s=[], holdout=[])
    for i in range(1 + iters):
        t = time.perf_counter()
        assert not bst.update(), "stopped early"
        torch.cuda.synchronize()
        if i:
            r["iter_s"].append(time.perf_counter() - t)
        r["holdout"].append(dict((m, v) for _, m, v, _ in
                                 bst.eval_valid()))
        if i == 0:
            r["warm_s"] = time.perf_counter() - t
    r["counts"] = read_counts()
    r["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    r["median_iter_s"] = statistics.median(r["iter_s"])
    return bst, r


def phase_categorical(phase4_iter_s):
    """Phase 13: categorical features at the airline shape through
    ``Booster`` (CAT_RUNS), each run launching its kernel mode and
    learning on 200,000 held-out rows (logloss falling from the warm-up
    and under the prior's, AUC over 0.6), with its s/iteration beside
    phase 4's, its peak bytes and how many splits a tree takes on a
    categorical feature (their sets' mean size); the host seconds of
    binning; the held-out rows by the binned device route within 1e-5 of
    the host walk (each the engine's device scores), and a model loaded
    from its text answering by the host walk; then cuda against the CPU
    on 20,000 rows, every grower. Returns each mode's launches."""
    import lightgbm_tpu_torch as lgt
    t_phase = time.perf_counter()
    n = AIRLINE_ROWS
    X, y = synth_airline(n + AIRLINE_HOLDOUT)
    Xv, yv = X[n:], y[n:]
    X, y = X[:n], y[:n]
    log(f"phase 13 data_s={time.perf_counter() - t_phase!r} rows={n} "
        f"holdout={len(Xv)} positive_share={float(y.mean())!r} "
        f"columns={AIRLINE_COLUMNS} categorical={AIRLINE_CAT_INDEX}")
    prior_p = float(y.mean())
    prior = -(prior_p * np.log(prior_p) + (1 - prior_p) * np.log(1 - prior_p))
    datasets, launches, totals = {}, {}, {}
    for name, (extra, iters, cats, must) in CAT_RUNS.items():
        key = (extra.get("max_bin", MAX_BIN), cats)
        if key not in datasets:
            t = time.perf_counter()
            dparams = {"max_bin": key[0], "verbose": -1}
            ds = lgt.Dataset(X, label=y, params=dparams,
                             categorical_feature=(AIRLINE_CAT_INDEX if cats
                                                  else [])).construct()
            binning_s = time.perf_counter() - t
            valid = lgt.Dataset(Xv, label=yv, reference=ds).construct()
            nb = [m.num_bin for m in ds.binned.bin_mappers]
            log(f"phase 13 binning max_bin={key[0]} categorical={cats} "
                f"binning_s={binning_s!r} num_bin={nb} "
                f"bins_dtype={ds.binned.bins.dtype}")
            datasets[key] = (ds, valid, dict(ds.params))
        ds, valid, ds_params = datasets[key]
        ds.params = dict(ds_params)
        params = bench_params(**extra)
        tr = time.perf_counter()
        bst, r = train_categorical(ds, valid, params, iters)
        c = r["counts"]
        stats = cat_split_stats(bst._engine.models)
        first, last = r["holdout"][0], r["holdout"][-1]
        log(f"phase 13 run={name} warm_s={r['warm_s']!r} "
            f"iter_s={r['iter_s']!r} median_iter_s={r['median_iter_s']!r} "
            f"phase4_median_iter_s={phase4_iter_s!r} "
            f"over_phase4={r['median_iter_s'] / phase4_iter_s!r} "
            f"launches={nonzero(c)} peak_bytes_above_start="
            f"{r['peak_bytes']} cat_splits_and_mean_set_per_tree={stats} "
            f"holdout_first={first} holdout_last={last} "
            f"prior_logloss={prior!r}")
        assert c[must] > 0, (name, c)
        assert last["binary_logloss"] < first["binary_logloss"], name
        assert last["binary_logloss"] < prior and last["auc"] > 0.6, \
            (name, last)
        if cats:
            assert sum(k for k, _ in stats) > 0, (name, stats)
        else:
            assert sum(k for k, _ in stats) == 0, (name, stats)
        launches[name] = c[must]
        for k, v in c.items():
            totals[k] = totals.get(k, 0) + v
        if name == "compact":
            phase_categorical_predict(bst, Xv)
            phase_categorical_scan_cost(bst._engine)
        if name == "compact_u16":
            assert ds.binned.bins.dtype == np.uint16
        del bst
        gc.collect()
        log(f"phase 13 run={name} seconds={time.perf_counter() - tr!r}")
    del datasets, X, Xv
    gc.collect()
    phase_categorical_cross_check(launches)
    log(f"phase 13 seconds={time.perf_counter() - t_phase!r}")
    return launches, totals


def phase_categorical_scan_cost(eng):
    """The split scan of two leaves (one split's children) at the run's
    shape, with the categorical features and with every feature taken as
    numerical: host ms a call (synchronized after each) and the kernels
    one call launches (``torch.profiler``)."""
    from lightgbm_tpu_torch.ops.split import best_split_for_leaf
    meta = eng.feature_meta
    gen = torch.Generator(device="cuda").manual_seed(3)
    F, B = eng.num_used_features, eng.num_bin_max
    hist = torch.rand((2, F, B, 3), device="cuda", generator=gen) * 100
    sums = hist[:, 0].sum(dim=1)
    args = (sums[:, 0], sums[:, 1], sums[:, 2], torch.zeros(2, device="cuda"))
    out = {}
    for label, m in (("categorical", meta),
                     ("numerical", meta._replace(is_categorical=None,
                                                 cat_features=None,
                                                 cat_num_bin=None))):
        call = lambda: best_split_for_leaf(hist, *args, m,
                                           eng.grower_cfg.hparams)
        ms = median_ms(call, reps=20)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = sum(e.count for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        out[label] = (ms, kernels)
    log(f"phase 13 split scan of two leaves (ms a call, kernels): {out}")


def phase_categorical_predict(bst, Xv):
    """The held-out rows by the binned device route against the host
    walk (each the engine's device scores, so no fallback went unseen);
    a model loaded from its text: its raw route refuses the categorical
    nodes and the Booster answers by the host walk."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.forest import DeviceRouteUnavailable
    eng = bst._engine
    Xp = np.asarray(Xv, np.float64)
    n_iter = bst.current_iteration()
    t = time.perf_counter()
    host = bst.predict(Xp, raw_score=True, device=False)
    host_s = time.perf_counter() - t
    bst.predict(Xp[:1000], raw_score=True, device=True)      # warm-up
    t = time.perf_counter()
    binned = bst.predict(Xp, raw_score=True, device=True)
    binned_s = time.perf_counter() - t
    assert np.array_equal(binned, eng.predict_device(Xp, 0, n_iter)[:, 0])
    err = float(np.abs(binned - host).max())
    log(f"phase 13 predict rows={len(Xp)} binned_max_abs_err_vs_host_walk="
        f"{err!r} binned_rows_per_s={len(Xp) / binned_s!r} "
        f"host_walk_rows_per_s={len(Xp) / host_s!r}")
    assert err < 1e-5, err
    loaded = lgt.Booster({"device_type": "cuda"},
                         model_str=bst.model_to_string())
    try:
        loaded._engine.predict_device(Xp[:10], 0, n_iter)
        raise AssertionError("the raw route served categorical nodes")
    except DeviceRouteUnavailable as e:
        reason = str(e)
    Xs = Xp[:20_000]
    got = loaded.predict(Xs, raw_score=True, device=True)
    assert np.array_equal(got, bst.predict(Xs, raw_score=True)), \
        "the loaded model's answer is not the host walk"
    log(f"phase 13 loaded model: predict(device=True) took the host walk "
        f"(raw route: {reason}); equal to the trained model's host walk "
        f"on {len(Xs)} rows")


def leaf_partition_map(a, b, X):
    """Per tree, the one-to-one map from ``a``'s leaves to ``b``'s that
    the rows of X give (each leaf of either holds the same rows as its
    image), or an AssertionError; and the count of trees whose leaves
    are numbered differently."""
    la = a.predict(X, pred_leaf=True)
    lb = b.predict(X, pred_leaf=True)
    maps, renumbered = [], 0
    for i in range(la.shape[1]):
        pairs = np.unique(la[:, i].astype(np.int64) * (1 << 20) + lb[:, i])
        ua, ub = pairs >> 20, pairs & ((1 << 20) - 1)
        assert len(np.unique(ua)) == len(ua) == len(np.unique(ub)), \
            f"tree {i}: the leaves hold different rows"
        maps.append((ua, ub))
        renumbered += int((ua != ub).any())
    return maps, renumbered


def assert_same_partitions(a, b, X, rate, g_max, h_max, what):
    """The binary standard of the port's CPU tests where a categorical
    split may pick the complement of a set at an exact tie, and where a
    few category bins hold thousands of rows: each tree has as many
    leaves in both, each leaf holds the same training rows as its image
    (the numbering may differ: a tied set and its complement swap two
    children); matched leaves' hessian sums within 1e-6 N max h plus
    1e-4 of the sum, values within 1e-6 rate N max|g| / H plus 2e-4 of
    the value (the CPU's plain version adds a bin's rows one at a time
    in f32, which over a bin of m equal hessians drifts by up to m^2 u
    h: 7e-5 of a leaf's sum at 3,349 rows on the card's first check),
    and each raw score within the sum of its leaves' value bounds.
    Returns the trees renumbered and the largest relative differences."""
    n = len(X)
    ta, tb = a._engine.models, b._engine.models
    assert len(ta) == len(tb), what
    for i, (p, q) in enumerate(zip(ta, tb)):
        assert p.num_leaves == q.num_leaves, (what, i)
    maps, renumbered = leaf_partition_map(a, b, X)
    tol = np.zeros(n)
    leaves_b = b.predict(X, pred_leaf=True)
    worst = {"weight": 0.0, "value": 0.0}
    for i, ((ua, ub), p, q) in enumerate(zip(maps, ta, tb)):
        assert len(ua) == p.num_leaves, (what, i)
        wa, wb = p.leaf_weight[ua], q.leaf_weight[ub]
        va, vb = p.leaf_value[ua], q.leaf_value[ub]
        assert (np.abs(wa - wb) < 1e-6 * n * h_max + 1e-4 * wb).all(), \
            (what, i, float(np.abs(wa - wb).max()))
        bound = (1e-6 * rate * n * g_max / np.maximum(wb, 1e-12)
                 + 2e-4 * np.abs(vb))
        assert (np.abs(va - vb) < bound).all(), \
            (what, i, float(np.abs(va - vb).max()))
        worst["weight"] = max(worst["weight"], float(
            (np.abs(wa - wb) / np.maximum(wb, 1e-12)).max()))
        worst["value"] = max(worst["value"], float(
            (np.abs(va - vb) / np.maximum(np.abs(vb), 1e-12)).max()))
        lb = leaves_b[:, i]
        w_row = np.maximum(q.leaf_weight[lb], 1e-12)
        tol += (1e-6 * rate * n * g_max / w_row
                + 2e-4 * np.abs(q.leaf_value[lb]))
    diff = np.abs(a.predict(X, raw_score=True) - b.predict(X, raw_score=True))
    assert (diff <= tol).all(), (what, float(diff.max()))
    return renumbered, worst


def phase_categorical_cross_check(launches):
    """cuda against the CPU on CAT_SMALL_ROWS airline-shaped rows, 31
    leaves, 3 rounds, every grower of CAT_CHECKS: the CPU launching no
    kernel, the trees to ``assert_same_partitions``, the training logloss
    within rtol 1e-4."""
    import lightgbm_tpu_torch as lgt
    X, y = synth_airline(CAT_SMALL_ROWS, seed=7)
    Xd = X.astype(np.float64)
    for name, (extra, must) in CAT_CHECKS.items():
        tc = time.perf_counter()
        out = {}
        for dev in ("cuda", "cpu"):
            params = bench_params(num_leaves=31, device_type=dev, **extra)
            reset_counts()
            bst = lgt.Booster(params, lgt.Dataset(
                X, label=y, categorical_feature=AIRLINE_CAT_INDEX))
            for _ in range(3):
                assert not bst.update(), (name, dev)
            loss = dict((m, v) for _, m, v, _ in bst.eval_train())
            out[dev] = (bst, read_counts(), loss["binary_logloss"])
        (cb, cc, closs), (pb, pc, ploss) = out["cuda"], out["cpu"]
        assert cc[must] > 0 and sum(pc.values()) == 0, (name, cc, pc)
        renumbered, worst = assert_same_partitions(
            cb, pb, Xd, params["learning_rate"], 1.0, 0.25,
            f"phase 13 cross-check {name}")
        same_sets = all(np.array_equal(p.cat_threshold, q.cat_threshold)
                        for p, q in zip(cb._engine.models,
                                        pb._engine.models))
        log(f"phase 13 cross-check run={name} logloss cuda={closs!r} "
            f"cpu={ploss!r} trees_renumbered={renumbered} "
            f"largest_relative_diff={worst} "
            f"category_sets_equal={same_sets} cuda_launches={nonzero(cc)} "
            f"seconds={time.perf_counter() - tc!r}")
        np.testing.assert_allclose(closs, ploss, rtol=1e-4, err_msg=name)
        launches[f"cross_check_{name}_{must}"] = cc[must]



# ---------------------------------------------------------------------------
# phase 14: wide sparse data
# ---------------------------------------------------------------------------
# Allstate claims (LightGBM's docs/Experiments.rst, the EFB benchmark):
# 4,228 one-hot features, made as scripts/scale_proof.py makes them: 32
# raw categorical columns one-hot expanded, one active column per raw
# column per row, seed 1, the label from raw columns 0-2; 200,000
# held-out rows from the draws after them. Its 13.2M rows are cut to
# 8M, as far as the script's time limit forces once phase 18 runs
ALLSTATE_ROWS = 8_000_000
ALLSTATE_HOLDOUT = 200_000
# the held-out rows predicted by both routes (the binned route reads
# about 7,500-12,500 rows/s at 4,228 columns, so all 200,000 would cost
# 18-29 s more)
ALLSTATE_PREDICT_ROWS = 50_000
ALLSTATE_RAW, ALLSTATE_FEATURES = 32, 4228
# At the default max_conflict_rate=0 the auto rule's 20,000-row probe
# bundles the 4,228 features into about 300 groups: two features of
# different raw columns (each on 1/132 of the rows) meet on about one
# probe row, so the greedy bundling mixes raw columns and G passes
# 8 K_max = 256, and the rows are stored multi-value. The group runs bin
# with this conflict rate, where G is about 200 and the rows pack
# straight into groups (a row active in two members of a group keeps the
# later one's bin: LightGBM's EFB approximation).
ALLSTATE_CONFLICT_RATE = 0.01
# storage -> the Dataset's params
ALLSTATE_STORAGE = {"groups": {"max_conflict_rate": ALLSTATE_CONFLICT_RATE},
                    "multival": {"tpu_sparse_storage": "multival"}}
# name -> (params, timed iterations after one warm-up, the kernel mode
# the run must launch (None: multi-value storage, no histogram kernel),
# storage)
ALLSTATE_RUNS = {
    "compact": ({}, 1, "hist_rowmajor_f32", "groups"),
    "quantized": (dict(use_quantized_grad=True), 1, "hist_rowmajor_int8",
                  "groups"),
    "hybrid": (dict(tpu_row_scheduling="level"), 1, "hist_level_f32",
               "groups"),
    "full": (dict(tpu_row_scheduling="full"), 1, "hist_featmajor_f32",
             "groups"),
    "multival": ({}, 1, None, "multival"),
}
# histogram_pool_size (MB) of the pool runs on phase 4's rows: at
# 28 x 255 x 3 x 4 B a slot, about 61 LRU slots, and no pool
POOL_RUNS = {"bounded": 5.0, "none": 0.1}
SEQUENCE_BATCH = 65_536
# the cross-check of phase 14 on cuda and on the CPU: 20,000 rows of the
# Allstate shape, 31 leaves, 1 round (2 until PR 18)
ALLSTATE_SMALL_ROWS = 20_000
ALLSTATE_SMALL_ROUNDS = 1
_GROUPS = ALLSTATE_STORAGE["groups"]
ALLSTATE_CHECKS = {
    "compact": (dict(_GROUPS), "hist_rowmajor_f32"),
    "quantized": (dict(use_quantized_grad=True, **_GROUPS),
                  "hist_rowmajor_int8"),
    "level": (dict(tpu_row_scheduling="level", max_depth=4, **_GROUPS),
              "hist_level_f32"),
    "full": (dict(tpu_row_scheduling="full", **_GROUPS),
             "hist_featmajor_f32"),
    "multival": (dict(tpu_sparse_storage="multival"), None),
}


def synth_allstate(n, holdout=0, seed=1):
    """Allstate-shaped CSR rows (float32 ones, 4,228 columns) and labels,
    then ``holdout`` more rows from the next draws of the same generator,
    cut at the training rows' median logit (``scripts/scale_proof.py``'s
    generator)."""
    import scipy.sparse as sp
    G, F = ALLSTATE_RAW, ALLSTATE_FEATURES
    sizes = np.full(G, F // G, np.int64)
    sizes[: F % G] += 1
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    rng = np.random.default_rng(seed)

    def rows(m):
        choice = rng.integers(0, sizes[None, :], size=(m, G))
        indices = (offs[None, :] + choice).astype(np.int32)
        indptr = np.arange(m + 1, dtype=np.int64) * G
        X = sp.csr_matrix((np.ones(m * G, np.float32), indices.reshape(-1),
                           indptr), shape=(m, F))
        logits = ((choice[:, 0] % 7) * 0.3 - (choice[:, 1] % 5) * 0.4
                  + (choice[:, 2] % 3) * 0.5 + 0.5 * rng.normal(size=m))
        return X, logits

    X, logits = rows(n)
    cut = np.median(logits)
    y = (logits > cut).astype(np.float32)
    if not holdout:
        return X, y
    Xv, lv = rows(holdout)
    return X, y, Xv, (lv > cut).astype(np.float32)


class StageTimer:
    """Host seconds of the dataset stages (bin mappers, the auto rule's
    probe, the packing) while it is entered, and the group count of the
    probe's bundling: the package's functions wrapped, and restored on
    exit."""

    def __init__(self):
        from lightgbm_tpu_torch.io import bundling, dataset_core
        B = dataset_core.BinnedDataset
        self.seconds = {}
        self.probe_groups = None
        find = bundling.find_bundles

        def probe(*a, **k):
            info = find(*a, **k)
            self.probe_groups = (a[0].shape[1] if info is None
                                 else info.num_groups)
            return info
        self._sites = [(B, "_find_bin_mappers", "bin_mappers", True),
                       (B, "_auto_sparse_storage", "probe", False),
                       (bundling, "pack_sparse_direct", "packing", False),
                       (dataset_core, "_quantize_sparse", "packing", False),
                       (dataset_core, "_quantize_rowmajor", "packing",
                        False)]
        self._saved = [(bundling, "find_bundles", find)]
        bundling.find_bundles = probe

    def __enter__(self):
        for obj, name, label, static in self._sites:
            fn = obj.__dict__[name]
            self._saved.append((obj, name, fn))
            inner = fn.__func__ if static else fn

            def wrapped(*a, _inner=inner, _label=label, **k):
                t = time.perf_counter()
                try:
                    return _inner(*a, **k)
                finally:
                    self.seconds[_label] = (self.seconds.get(_label, 0.0)
                                            + time.perf_counter() - t)
            setattr(obj, name, staticmethod(wrapped) if static else wrapped)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)


def assert_sparse_launches(name, c, trees, must):
    """Each run's kernel mode, over the group columns: compact K1 only,
    once a leaf; hybrid K2 at every level of the level phase (levels
    0..D0, the order carried between them) and then K1 for the tail; full
    B2 once a leaf and nothing else; multi-value storage no histogram
    kernel."""
    leaves = sum(t.num_leaves for t in trees)
    if must is None:
        assert sum(c.values()) == 0, (name, c)
        return
    assert c[must] > 0, (name, c)
    if name in ("compact", "quantized", "full"):
        assert c[must] == leaves and sum(c.values()) == c[must], (name, c)
    if name == "hybrid":
        from lightgbm_tpu_torch.core.hybrid_grower import auto_handoff_depth
        d0 = auto_handoff_depth(NUM_LEAVES)
        assert c[must] == (d0 + 1) * len(trees), (name, c)
        assert c["level_partition"] == d0 * len(trees), (name, c)
        assert c["hist_rowmajor_f32"] > 0, (name, c)


def phase_sparse(phase4_iter_s):
    """Phase 14: wide sparse data at the Allstate shape (ALLSTATE_RUNS):
    the CSR rows through ``Dataset`` (the auto rule packs them straight
    into EFB groups: ingest seconds by stage, G, K_max and the groups'
    bytes), each run launching its kernel mode over the group columns
    (multi-value storage: none) and learning on the held-out rows, with
    its s/iteration beside phase 4's and its peak bytes; the multi-value
    root histogram's device ms beside K1's over the groups; the held-out
    CSR predicted in row blocks by the binned device route and by the
    host walk; then cuda against the CPU on 20,000 rows. Returns each
    mode's launches by run and in all."""
    import lightgbm_tpu_torch as lgt
    t_phase = time.perf_counter()
    n = ALLSTATE_ROWS
    X, y, Xv, yv = synth_allstate(n, ALLSTATE_HOLDOUT)
    gen_s = time.perf_counter() - t_phase
    t = time.perf_counter()
    csc = X.tocsc()
    del X
    gc.collect()
    csc_s = time.perf_counter() - t
    prior_p = float(y.mean())
    prior = -(prior_p * np.log(prior_p) + (1 - prior_p) * np.log(1 - prior_p))
    k_max = int(np.bincount(csc.indices, minlength=n).max())
    datasets, launches, totals = {}, {}, {}
    for name, (extra, iters, must, storage) in ALLSTATE_RUNS.items():
        dparams = ALLSTATE_STORAGE[storage]
        if storage not in datasets:
            datasets.clear()
            gc.collect()
            t = time.perf_counter()
            with StageTimer() as st:
                ds = lgt.Dataset(csc, label=y, params={
                    "verbose": -1, **dparams}).construct()
            b = ds.binned
            ingest = dict(generation=gen_s, csc=csc_s, **st.seconds,
                          construct=time.perf_counter() - t)
            t = time.perf_counter()
            valid = lgt.Dataset(Xv, label=yv, reference=ds).construct()
            valid_s = time.perf_counter() - t
            # the auto rule (tpu_sparse_storage=auto) chose the storage
            head = (f"phase 14 ingest storage={storage} dataset_params="
                    f"{dparams} rows={n} features={csc.shape[1]} "
                    f"holdout={len(yv)} seconds_by_stage={ingest} "
                    f"holdout_binning_s={valid_s!r} K_max={k_max} "
                    f"probe_G={st.probe_groups} 8_K_max={8 * k_max}")
            assert b.bins is None
            if storage == "groups":
                info = b.efb_info
                assert b.bins_grouped is not None, "no groups packed"
                log(f"{head} G={info.num_groups} group_num_bin_max="
                    f"{int(info.group_num_bin.max())} groups_bytes="
                    f"{b.bins_grouped.nbytes} logical_bytes="
                    f"{n * csc.shape[1]} positive_share={prior_p!r}")
            else:
                assert b.bins_mv is not None, "not stored multi-value"
                log(f"{head} K={b.bins_mv[0].shape[1]} pairs_bytes="
                    f"{b.bins_mv[0].nbytes + b.bins_mv[1].nbytes}")
            datasets[storage] = (ds, valid, dict(ds.params))
        ds, valid, ds_params = datasets[storage]
        ds.params = dict(ds_params)
        params = bench_params(**extra, **dparams)
        tr = time.perf_counter()
        bst, r = train_categorical(ds, valid, params, iters)
        eng = bst._engine
        c = r["counts"]
        assert (eng._bundle is not None) == (must is not None), name
        assert_sparse_launches(name, c, eng.models, must)
        first, last = r["holdout"][0], r["holdout"][-1]
        log(f"phase 14 run={name} warm_s={r['warm_s']!r} "
            f"iter_s={r['iter_s']!r} median_iter_s={r['median_iter_s']!r} "
            f"phase4_median_iter_s={phase4_iter_s!r} "
            f"over_phase4={r['median_iter_s'] / phase4_iter_s!r} "
            f"launches={nonzero(c)} leaves_per_tree="
            f"{[t.num_leaves for t in eng.models]} peak_bytes_above_start="
            f"{r['peak_bytes']} holdout_by_iteration={r['holdout']} "
            f"prior_logloss={prior!r}")
        assert last["binary_logloss"] < first["binary_logloss"], name
        assert last["binary_logloss"] < prior and last["auc"] > 0.6, \
            (name, last)
        if must is not None:
            launches[name] = c[must]
        for k, v in c.items():
            totals[k] = totals.get(k, 0) + v
        if name == "compact":
            compact = bst
            phase_sparse_predict(bst, Xv[:ALLSTATE_PREDICT_ROWS])
        if name == "multival":
            phase_sparse_root_hist(compact._engine, eng)
        del bst
        gc.collect()
        log(f"phase 14 run={name} seconds={time.perf_counter() - tr!r}")
    del datasets, csc, Xv, compact
    gc.collect()
    phase_sparse_cross_check(launches)
    log(f"phase 14 seconds={time.perf_counter() - t_phase!r}")
    return launches, totals


def phase_sparse_root_hist(eng_groups, eng_mv):
    """Device ms of one root histogram: K1 over the G group columns, and
    the multi-value scatter over the [R, K] pairs (one index_add_ per
    column), with the scatter's bound (each id, bin and gh byte read
    once at the memory rate)."""
    from lightgbm_tpu_torch.ops.hist_cuda import hist_cuda_rm
    from lightgbm_tpu_torch.ops.hist_multival import hist_multival
    gen = torch.Generator(device="cuda").manual_seed(4)
    bins, sb = eng_groups.bins, eng_mv.bins
    R, G = bins.shape
    gh = torch.randn((R, 3), device="cuda", generator=gen)
    B = eng_groups.num_bin_max
    k1_ms = device_ms(lambda: hist_cuda_rm(bins, gh, B), reps=5)
    mv_ms = device_ms(lambda: hist_multival(sb, gh, eng_mv.num_bin_max),
                      reps=5, sleep_per_rep=4)
    K = sb.idx.shape[1]
    mv_bound, mv_by = bound(R * K * 8 + R * 12, R * K * 3)
    k1_bound, k1_by = bound(R * G + R * 12, R * G * 3)
    log(f"phase 14 root histogram rows={R}: K1 over G={G} group columns "
        f"device_ms={k1_ms!r} bound_ms={k1_bound!r} ({k1_by}); multi-value "
        f"scatter over K={K} pairs of {sb.num_features} features x "
        f"{eng_mv.num_bin_max} bins device_ms={mv_ms!r} bound_ms="
        f"{mv_bound!r} ({mv_by}) over_K1={mv_ms / k1_ms!r}")


def phase_sparse_predict(bst, Xv):
    """The held-out CSR rows in row blocks by the binned device route and
    by the host walk: within 1e-5, with rows/s of each."""
    eng = bst._engine
    n_iter = bst.current_iteration()
    t = time.perf_counter()
    host = bst.predict(Xv, raw_score=True, device=False)
    host_s = time.perf_counter() - t
    bst.predict(Xv[:1000], raw_score=True, device=True)      # warm-up
    t = time.perf_counter()
    binned = bst.predict(Xv, raw_score=True, device=True)
    binned_s = time.perf_counter() - t
    first = Xv[:5000].toarray().astype(np.float64)
    assert np.array_equal(binned[:5000],
                          eng.predict_device(first, 0, n_iter)[:, 0])
    err = float(np.abs(binned - host).max())
    log(f"phase 14 predict rows={Xv.shape[0]} cols={Xv.shape[1]} "
        f"binned_max_abs_err_vs_host_walk={err!r} binned_rows_per_s="
        f"{Xv.shape[0] / binned_s!r} host_walk_rows_per_s="
        f"{Xv.shape[0] / host_s!r}")
    assert err < 1e-5, err


def phase_sparse_on_phase4_rows(ds, X, phase4_iter_s):
    """Phase 14 on phase 4's rows and model: the histogram-pool policy
    (POOL_RUNS: a bounded LRU pool and no pool; K1 launched once a root,
    once a split that subtracts from a cached parent and twice a split
    that misses), and the rows as a ``Sequence`` binning to the dense
    Dataset's bins. Returns the pool runs' K1 launches."""
    import lightgbm_tpu_torch as lgt
    launches = {}
    # a Booster leaves its params in its Dataset's: the pool runs' budget
    # must not follow the Dataset into later phases
    ds_params = dict(ds.params)
    for name, mb in POOL_RUNS.items():
        bst, r = train_timed(ds, bench_params(histogram_pool_size=mb),
                             MODE_ITERS)
        eng = bst._engine
        pc = eng._grow.pool_counts
        c = r["counts"]
        k1 = c["hist_rowmajor_f32"]
        log(f"phase 14 pool run={name} histogram_pool_size={mb} "
            f"hist_pool={eng.grower_cfg.hist_pool} slots="
            f"{eng.grower_cfg.pool_slots} hits={pc['hits']} misses="
            f"{pc['misses']} children_recomputed={2 * pc['misses']} "
            f"K1_launches={k1} median_iter_s={r['median_iter_s']!r} "
            f"phase4_median_iter_s={phase4_iter_s!r} over_phase4="
            f"{r['median_iter_s'] / phase4_iter_s!r} "
            f"peak_bytes_above_start={r['peak_bytes']}")
        assert eng.grower_cfg.hist_pool == name, name
        assert pc["misses"] > 0, (name, pc)
        assert k1 == len(eng.models) + pc["hits"] + 2 * pc["misses"], \
            (name, k1, pc)
        launches[f"pool_{name}_hist_rowmajor_f32"] = k1
        del bst
        gc.collect()
    ds.params = ds_params

    class Rows(lgt.Sequence):
        batch_size = SEQUENCE_BATCH

        def __getitem__(self, idx):
            return X[idx]

        def __len__(self):
            return len(X)

    t = time.perf_counter()
    seq = lgt.Dataset(Rows(), label=ds.label).construct()
    seq_s = time.perf_counter() - t
    np.testing.assert_array_equal(seq.binned.bins, ds.binned.bins)
    log(f"phase 14 Sequence of phase 4's rows (batch {SEQUENCE_BATCH}): "
        f"bins equal the dense Dataset's; binning_s={seq_s!r} rows_per_s="
        f"{len(X) / seq_s!r}")
    return launches


def phase_sparse_cross_check(launches):
    """cuda against the CPU on ALLSTATE_SMALL_ROWS Allstate-shaped rows,
    31 leaves, ALLSTATE_SMALL_ROUNDS rounds, every path of
    ALLSTATE_CHECKS: the same
    BundleInfo (or none, multi-value), the CPU launching no kernel, the
    trees to ``assert_same_partitions``, the training logloss within rtol
    1e-4."""
    import lightgbm_tpu_torch as lgt
    X, y = synth_allstate(ALLSTATE_SMALL_ROWS, seed=7)
    Xd = X.toarray().astype(np.float64)
    # one Dataset (host bins) a storage, for both devices and every run
    # of it
    datasets = {}
    for name, (extra, must) in ALLSTATE_CHECKS.items():
        tc = time.perf_counter()
        out = {}
        storage = {k: v for k, v in extra.items()
                   if k in ("max_conflict_rate", "tpu_sparse_storage")}
        key = json.dumps(storage, sort_keys=True)
        if key not in datasets:
            ds = lgt.Dataset(X, label=y, params=bench_params(**storage))
            datasets[key] = (ds.construct(), dict(ds.params))
        ds, ds_params = datasets[key]
        for dev in ("cuda", "cpu"):
            params = bench_params(num_leaves=31, device_type=dev, **extra)
            reset_counts()
            ds.params = dict(ds_params)
            bst = lgt.Booster(params, ds)
            for _ in range(ALLSTATE_SMALL_ROUNDS):
                assert not bst.update(), (name, dev)
            loss = dict((m, v) for _, m, v, _ in bst.eval_train())
            out[dev] = (bst, read_counts(), loss["binary_logloss"])
        (cb, cc, closs), (pb, pc, ploss) = out["cuda"], out["cpu"]
        ci, pi = cb._engine._bundle, pb._engine._bundle
        assert (ci is None) == (pi is None) == (must is None), name
        if ci is not None:
            for k in ("group", "offset", "default_bin", "num_bin",
                      "group_num_bin"):
                assert np.array_equal(getattr(ci, k), getattr(pi, k)), k
        assert sum(pc.values()) == 0, (name, pc)
        assert (cc[must] > 0) if must else sum(cc.values()) == 0, (name, cc)
        renumbered, worst = assert_same_partitions(
            cb, pb, Xd, params["learning_rate"], 1.0, 0.25,
            f"phase 14 cross-check {name}")
        log(f"phase 14 cross-check run={name} logloss cuda={closs!r} "
            f"cpu={ploss!r} groups={None if ci is None else ci.num_groups} "
            f"trees_renumbered={renumbered} largest_relative_diff={worst} "
            f"cuda_launches={nonzero(cc)} "
            f"seconds={time.perf_counter() - tc!r}")
        np.testing.assert_allclose(closs, ploss, rtol=1e-4, err_msg=name)
        if must:
            launches[f"cross_check_{name}_{must}"] = cc[must]

# phase 15: constraints and tree variants on phase 4's rows and binning
# (1M x 28, 255 leaves, 255 bins, binary, rate 0.1), one warm-up and one
# timed iteration each (linear trees: two, so that one tree is fitted);
# the monotone directions fall on the features phase 4's first tree
# ranks first, second and third by gain
CONSTRAINT_ITERS = 1
LINEAR_ITERS = 2
CONSTRAINT_SMALL_ROWS = 20_000
CONSTRAINT_SMALL_ROUNDS = 2
INTERACTION_GROUPS = 4


def ranked_features(bst):
    """Features of the booster's first tree, by their summed split gain."""
    t = bst._engine.models[0]
    gain = np.zeros(bst._engine.max_feature_idx + 1)
    np.add.at(gain, t.split_feature[:t.num_leaves - 1],
              t.split_gain[:t.num_leaves - 1])
    return [int(f) for f in np.argsort(-gain, kind="stable")]


def constraint_runs(top, X, tmpdir):
    """name -> (params, timed iterations, the kernel mode the run must
    launch, its property): the runs of phase 15 over rows like ``X``
    (the forced thresholds are the features' medians there)."""
    F = X.shape[1]
    mono = [0] * F
    for f, sign in zip(top[:3], (1, -1, 1)):
        mono[f] = sign
    size = F // INTERACTION_GROUPS
    groups = ",".join("[" + ",".join(str(i) for i in range(g * size,
                                                           (g + 1) * size))
                      + "]" for g in range(INTERACTION_GROUPS))
    # each forced split at the median of its node's rows: the first
    # feature, then the second, then the first again in each quarter (a
    # weak feature's split can have no gain, which ends the prefix)
    med = lambda f, rows=slice(None): float(np.median(X[rows, f]))
    t0, t1 = med(top[0]), med(top[1])

    def level2(left):
        side = X[:, top[0]] <= t0 if left else X[:, top[0]] > t0
        cells = [side & (X[:, top[1]] <= t1), side & (X[:, top[1]] > t1)]
        return {"feature": top[1], "threshold": t1,
                "left": {"feature": top[0], "threshold": med(top[0],
                                                             cells[0])},
                "right": {"feature": top[0], "threshold": med(top[0],
                                                              cells[1])}}
    forced = {"feature": top[0], "threshold": t0, "left": level2(True),
              "right": level2(False)}
    path = f"{tmpdir}/forced_{len(X)}.json"
    with open(path, "w") as fh:
        json.dump(forced, fh)
    inter = dict(monotone_constraints=mono,
                 monotone_constraints_method="intermediate")
    K1, B2 = "hist_rowmajor_f32", "hist_featmajor_f32"
    it = CONSTRAINT_ITERS
    return {
        "monotone": (dict(monotone_constraints=mono), it, K1, "monotone"),
        "monotone_penalty": (dict(monotone_constraints=mono,
                                  monotone_penalty=2.0), it, K1, "monotone"),
        "intermediate": (inter, it, K1, "monotone"),
        "advanced": (dict(inter, monotone_constraints_method="advanced"), it,
                     K1, "monotone"),
        "intermediate_full": (dict(inter, tpu_row_scheduling="full"), it, B2,
                              "monotone"),
        "intermediate_quantized": (dict(inter, use_quantized_grad=True), it,
                                   "hist_rowmajor_int8", "monotone"),
        "interaction": (dict(interaction_constraints=groups), it, K1,
                        "interaction"),
        # at tradeoff 1 the penalties, 1.1 a row, exceed every split's
        # gain on these rows (about 0.5 a row at the root): 0.1 keeps
        # their ratios and lets the strongest splits through
        "cegb": (dict(cegb_penalty_split=0.1,
                      cegb_penalty_feature_coupled=[1.0] * F,
                      cegb_penalty_feature_lazy=[1.0] * F,
                      cegb_tradeoff=0.1), it, K1, "cegb"),
        "forced": (dict(forcedsplits_filename=path), it, K1, "forced"),
        "feature_contri": (dict(feature_contri=[1.0 if i % 2 else 0.5
                                                for i in range(F)]), it, K1,
                           "learns"),
        "extra_trees": (dict(extra_trees=True), it, K1, "extra_trees"),
        "extra_trees_full": (dict(extra_trees=True,
                                  tpu_row_scheduling="full"), it, B2,
                             "extra_trees"),
        "level_monotone": (dict(monotone_constraints=mono,
                                tpu_row_scheduling="level", verbose=0), it,
                           K1, "level_fallback"),
        "linear": (dict(linear_tree=True, linear_lambda=0.1), LINEAR_ITERS,
                   K1, "linear"),
    }


def tree_features(t):
    """The split features of a host tree."""
    return set(int(f) for f in t.split_feature[:t.num_leaves - 1])


def monotone_holds(bst, X, mono):
    """Raw predictions over 1,000 rows (ten base rows, each swept over
    100 values from the 1st to the 99th percentile of a constrained
    feature) move in each constrained feature's direction."""
    for f in np.flatnonzero(mono):
        grid = np.linspace(*np.percentile(X[:, f], [1, 99]), 100)
        probe = np.repeat(np.asarray(X[:10], np.float64), len(grid), axis=0)
        probe[:, f] = np.tile(grid, 10)
        d = np.diff(bst.predict(probe, raw_score=True).reshape(10, -1), 1)
        if not (mono[f] * d >= -1e-12).all():
            return False
    return True


def check_constraint_property(kind, bst, X, params, base_bst, forced_top):
    """Each run's property (tests/test_torch_constraints.py's on both
    packages): returns what was checked, asserting it."""
    eng = bst._engine
    if kind == "monotone":
        assert monotone_holds(bst, X, params["monotone_constraints"])
        return "monotone along each constrained feature"
    if kind == "interaction":
        size = X.shape[1] // INTERACTION_GROUPS
        for t in eng.models:
            assert len({f // size for f in tree_features(t)}) <= 1
        return "every tree inside one interaction group"
    if kind == "cegb":
        n = len(eng.models)
        used = set().union(*(tree_features(t) for t in eng.models))
        base = set().union(*(tree_features(t)
                             for t in base_bst._engine.models[:n]))
        assert len(used) < len(base), (used, base)
        return f"features used {len(used)} < {len(base)} without CEGB"
    if kind == "forced":
        for t in eng.models:
            # the prefix (breadth first: node 0, then 1 and 2, then 3-6)
            feats = [int(f) for f in t.split_feature[:7]]
            assert feats == ([forced_top[0]] + [forced_top[1]] * 2
                             + [forced_top[0]] * 4), feats
        return "the 3-level forced prefix at the top of every tree"
    if kind == "extra_trees":
        base = base_bst._engine.models[0]
        assert not np.array_equal(eng.models[0].threshold_bin,
                                  base.threshold_bin)
        return "first tree's thresholds differ from phase 4's"
    if kind == "linear":
        lin = eng.models[-1]
        assert lin.is_linear and any(len(c) for c in lin.leaf_coeff)
        Xp = np.asarray(X[:20000], np.float64)
        train = eng.score[0, :20000].cpu().numpy()
        err = float(np.abs(bst.predict(Xp, raw_score=True) - train).max())
        assert err < 1e-4, err
        return (f"leaves fitted; host walk within {err!r} of the training "
                "score")
    return "learns"


def phase_constraints(base_bst, ds, X, phase4_iter_s):
    """Phase 15: constraints and tree variants on phase 4's rows through
    ``Booster`` (CONSTRAINT_RUNS): each run launching its kernel mode and
    learning, its property checked, with its s/iteration beside phase
    4's, its training logloss after each iteration, K1's and B2's
    launches and its peak bytes; ``tpu_row_scheduling=level`` with
    monotone constraints logging the JAX package's reason and training
    the compact model; linear trees on a Dataset rebuilt with
    ``linear_tree``; then cuda against the CPU on CONSTRAINT_SMALL_ROWS
    rows. Returns each run's launches of its kernel mode and the
    phase's launches by mode."""
    import tempfile
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.utils import log as plog
    t_phase = time.perf_counter()
    top = ranked_features(base_bst)
    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_")
    runs = constraint_runs(top, X, tmpdir)
    launches, totals = {}, {}
    ds_params = dict(ds.params)
    ds_linear = None
    for name, (extra, iters, must, kind) in runs.items():
        tr = time.perf_counter()
        data = ds
        if kind == "linear":
            t = time.perf_counter()
            # binned with phase 4's mappers
            ds_linear = lgt.Dataset(X, label=ds.label, reference=ds,
                                    params={"linear_tree": True}).construct()
            log(f"phase 15 run=linear Dataset rebuilt with linear_tree and "
                f"phase 4's mappers "
                f"binning_s={time.perf_counter() - t!r} raw_bytes="
                f"{ds_linear.binned.raw.nbytes}")
            data = ds_linear
        else:
            ds.params = dict(ds_params)
        msgs = []
        plog.register_logger(msgs.append)
        try:
            bst, r = train_variant(data, bench_params(**extra), iters)
        finally:
            plog.register_logger(None)
        eng = bst._engine
        c = r["counts"]
        prop = check_constraint_property(kind, bst, X, extra, base_bst, top)
        if kind == "level_fallback":
            said = [m for m in msgs if "tpu_row_scheduling='level' does "
                    "not support" in m]
            assert len(said) == 1 and "monotone constraints" in said[0], msgs
            assert eng.row_sched == "compact"
            prop = "level fell back to compact: " + said[0].split(
                "[Warning] ", 1)[-1]
        log(f"phase 15 run={name} iter_s={r['iter_s']!r} "
            f"median_iter_s={r['median_iter_s']!r} "
            f"phase4_median_iter_s={phase4_iter_s!r} "
            f"over_phase4={r['median_iter_s'] / phase4_iter_s!r} "
            f"logloss_per_iter={r['logloss']!r} K1_launches="
            f"{c['hist_rowmajor_f32'] + c['hist_rowmajor_int8']} "
            f"B2_launches={c['hist_featmajor_f32']} "
            f"launches={nonzero(c)} peak_bytes_above_start="
            f"{r['peak_bytes']} property={prop} "
            f"seconds={time.perf_counter() - tr!r}")
        assert c[must] > 0, (name, c)
        assert r["logloss"][-1] < r["logloss"][0], (name, r["logloss"])
        assert eng.grower_cfg.hist_pool == "full", (name, eng.grower_cfg)
        launches[name] = c[must]
        for k, v in c.items():
            totals[k] = totals.get(k, 0) + v
        del bst, eng
        gc.collect()
    ds.params = ds_params
    del ds_linear
    gc.collect()
    cross = phase_constraints_cross_check(top, tmpdir)
    for k, v in cross.items():
        totals[k] = totals.get(k, 0) + v
    log(f"phase 15 seconds={time.perf_counter() - t_phase!r}")
    return launches, totals


def phase_constraints_cross_check(top, tmpdir):
    """cuda against the CPU on CONSTRAINT_SMALL_ROWS rows, 31 leaves,
    CONSTRAINT_SMALL_ROUNDS rounds, every run of phase 15: the CPU
    launching no kernel, the trees to the binary standard, the training
    scores within 1e-5; linear trees by their host-walk predictions
    within 1e-5, ``predict(device=True)`` saying once that the host walk
    answers and giving its scores. Returns the cuda runs' launches."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.forest import LINEAR_TREES_ON_HOST
    from lightgbm_tpu_torch.utils import log as plog
    X, y = synth_higgs(CONSTRAINT_SMALL_ROWS, N_FEATURES, seed=11)
    Xd = X.astype(np.float64)
    totals = {}
    for name, (extra, _, must, kind) in constraint_runs(top, X,
                                                        tmpdir).items():
        tc = time.perf_counter()
        out = {}
        for dev in ("cuda", "cpu"):
            params = bench_params(num_leaves=31, device_type=dev, **extra)
            reset_counts()
            bst = lgt.Booster(params, lgt.Dataset(X, label=y,
                                                  params=params))
            for _ in range(CONSTRAINT_SMALL_ROUNDS):
                assert not bst.update(), (name, dev)
            out[dev] = (bst, read_counts())
        (cb, cc), (pb, pc) = out["cuda"], out["cpu"]
        assert cc[must] > 0 and sum(pc.values()) == 0, (name, cc, pc)
        n_trees = len(pb._engine.models)
        score_err = float(np.abs(cb._engine.score.cpu().numpy()
                                 - pb._engine.score.numpy()).max())
        if kind == "linear":
            pc_raw = pb.predict(Xd, raw_score=True)
            err = float(np.abs(cb.predict(Xd, raw_score=True)
                               - pc_raw).max())
            msgs = []
            plog.register_logger(msgs.append)
            plog.logged_once.clear()
            plog.set_verbosity(0)
            try:
                dev_raw = [cb.predict(Xd, raw_score=True, device=True)
                           for _ in range(2)]
            finally:
                plog.register_logger(None)
                plog.set_verbosity(-1)
            said = [m for m in msgs if LINEAR_TREES_ON_HOST in m]
            assert len(said) == 1, msgs
            assert all(np.array_equal(d, cb.predict(Xd, raw_score=True))
                       for d in dev_raw)
            assert err < 1e-5, (name, err)
            detail = (f"host_walk_max_abs_err={err!r} device_route="
                      f"host walk, said once")
        else:
            assert_trees_to_binary_standard(
                cb, pb, Xd, [np.ones(len(X), bool)] * n_trees, 0.1, 1.0,
                0.25, f"phase 15 cross-check {name}")
            detail = "trees to the binary standard"
        assert score_err < 1e-5, (name, score_err)
        log(f"phase 15 cross-check run={name} {detail} "
            f"training_score_max_abs_err={score_err!r} "
            f"cuda_launches={nonzero(cc)} "
            f"seconds={time.perf_counter() - tc!r}")
        for k, v in cc.items():
            totals[k] = totals.get(k, 0) + v
    return totals


# phase 16: asynchronous boosting, checkpoints and training-side
# robustness on phase 4's rows. (a) 1 + ROBUST_ITERS iterations with
# tpu_async_boosting auto and false; (b) GOSS at rate 0.5 (it samples
# from iteration 2) drawn on the card, 1 + ROBUST_GOSS_ITERS; (c) an
# uninterrupted ROBUST_CKPT_ROUNDS-round run, one killed at checkpoint
# write ROBUST_KILL_AFTER + 1, and its resume; (d) the numeric guard
ROBUST_ITERS = 2
ROBUST_GOSS = dict(data_sample_strategy="goss", learning_rate=0.5)
ROBUST_GOSS_ITERS = 3
ROBUST_CKPT = dict(bagging_fraction=0.5, bagging_freq=1,
                   feature_fraction=0.8)
ROBUST_CKPT_ROUNDS = 4
ROBUST_KILL_AFTER = 2
# (e) two supervised children on this many of phase 4's rows: one healthy
# (CHILD_ITERS iterations), one under hang:after=2 (it would train
# CHILD_HANG_ITERS) whose iter phase may sit still CHILD_STALL_SEC
CHILD_ROWS = 100_000
CHILD_ITERS = 3
CHILD_HANG_ITERS = 10_000
CHILD_STALL_SEC = 5.0
CHILD_POLL_SEC = 0.25
CHILD_DEVICE = "cuda"
# (f) cuda against the CPU on this many rows, 31 leaves
ROBUST_SMALL_ROWS = 20_000
ROBUST_SMALL_ROUNDS = 3

_CHILD_SRC = r"""
import sys
import numpy as np
import lightgbm_tpu_torch as lgt
X, y = np.load(sys.argv[1]), np.load(sys.argv[2])
params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
          "min_data_in_leaf": 20, "verbose": -1, "device_type": sys.argv[4]}
bst = lgt.Booster(params, lgt.Dataset(X, label=y))
for _ in range(int(sys.argv[3])):
    bst.update()
"""


def tree_text(bst):
    s = bst.model_to_string()
    return s[s.index("Tree=0"):s.index("end of trees")]


def first_trees(bst, n):
    """The text of ``bst``'s first ``n`` trees, as ``tree_text`` gives a
    booster of ``n`` trees."""
    s = bst.model_to_string(num_iteration=n)
    return s[s.index("Tree=0"):s.index("end of trees")]


def run_updates(ds, params, iters, prepare=None, each=None):
    """A Booster on ``ds`` with ``params``: ``prepare(bst)`` first, then
    1 + ``iters`` updates (the launch counts zeroed just before and read
    just after), ``each(i, bst)`` after each; the seconds of the timed
    ones, the training logloss after each, the counts."""
    import lightgbm_tpu_torch as lgt
    reset_counts()
    bst = lgt.Booster(params, ds)
    if prepare is not None:
        prepare(bst)
    iter_s, logloss = [], []
    for i in range(1 + iters):
        t = time.perf_counter()
        assert not bst.update(), "stopped early"
        torch.cuda.synchronize()
        if i:
            iter_s.append(time.perf_counter() - t)
        logloss.append(dict((m, v) for _, m, v, _ in
                            bst.eval_train())["binary_logloss"])
        if each is not None:
            each(i, bst)
    counts = read_counts()
    assert logloss[-1] < logloss[0], logloss
    return bst, dict(iter_s=iter_s, median_iter_s=statistics.median(iter_s),
                     logloss=logloss, counts=counts)


def phase_robustness(ds, X, phase4_iter_s, goss12_iter_s):
    """Phase 16: asynchronous boosting, checkpoints and the training-side
    robustness on phase 4's rows through ``Booster`` and ``train``, then
    cuda against the CPU on 20,000 rows. Returns each run's K1 launches
    and their totals by mode."""
    import os
    import tempfile
    from lightgbm_tpu_torch.robustness import heartbeat
    t_phase = time.perf_counter()
    ds_params = dict(ds.params)
    launches, totals = {}, {}

    def counted(name, counts):
        launches[name] = counts["hist_rowmajor_f32"]
        assert launches[name] > 0, (name, counts)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    with tempfile.TemporaryDirectory() as tmp:
        # (a) async (auto: on for the card) and sync; (e) the heartbeat
        # of the async run
        hb_path = os.path.join(tmp, "train.hb")
        beats = []
        ds.params = dict(ds_params)
        try:
            b_auto, r_auto = run_updates(
                ds, bench_params(tpu_heartbeat_file=hb_path), ROBUST_ITERS,
                each=lambda i, b: beats.append(heartbeat.read(hb_path)))
        finally:
            heartbeat.uninstall()
        ds.params = dict(ds_params)
        b_sync, r_sync = run_updates(
            ds, bench_params(tpu_async_boosting="false"), ROBUST_ITERS)
        assert b_auto._engine._async_mode is True
        assert b_sync._engine._async_mode is False
        assert tree_text(b_auto) == tree_text(b_sync)
        counted("async", r_auto["counts"])
        counted("sync", r_sync["counts"])
        log(f"phase 16 (a) async auto iter_s={r_auto['iter_s']!r} "
            f"sync iter_s={r_sync['iter_s']!r} "
            f"async_over_sync={r_auto['median_iter_s'] / r_sync['median_iter_s']!r} "
            f"phase4_median_iter_s={phase4_iter_s!r} model text equal")
        assert beats[0].phase == "compiling" and beats[0].progress == 0
        assert beats[-1].phase == "iter" and beats[-1].progress >= 1
        assert all(a.seq < b.seq for a, b in zip(beats, beats[1:]))
        log("phase 16 (e) heartbeat " + " ".join(
            f"[{b.phase} progress={b.progress} seq={b.seq}]" for b in beats))
        del b_auto, b_sync
        gc.collect()

        robust_goss(ds, ds_params, goss12_iter_s, counted)
        robust_guard(ds, ds_params, r_sync["median_iter_s"], counted)
        # the children start up (torch, CUDA, binning) while (c) and (f),
        # which time nothing but the checkpoint writes, run
        children = start_children(ds, X, tmp)
        try:
            robust_checkpoints(ds, ds_params, X, tmp, counted)
            ds.params = ds_params
            cross = phase_robustness_cross_check()
        finally:
            children = finish_children(children)
        check_children(*children)
        for name, counts in cross.items():
            counted(name, counts)
    ds.params = ds_params
    log(f"phase 16 seconds={time.perf_counter() - t_phase!r}")
    return launches, totals


def robust_goss(ds, ds_params, goss12_iter_s, counted):
    """(b) GOSS drawn on the card: the host sampler never called (no
    [K, N] gradient read), the draw at the last sampled iteration equal
    to the plain draw on the CPU from the same gradients, bit for bit;
    s/iteration against phase 12's host-drawn GOSS."""
    from lightgbm_tpu_torch.utils import prng
    seen = {}

    def prepare(bst):
        strat = bst._engine.sample_strategy

        def host_draw(*a, **k):
            raise AssertionError("host GOSS draw under async boosting")
        draw = strat.sample_dev

        def recorded(it, grad, hess, key):
            seen.update(it=it, grad=grad.clone(), hess=hess.clone(),
                        key=key)
            return draw(it, grad, hess, key)
        strat.sample = host_draw
        strat.sample_dev = recorded

    ds.params = dict(ds_params)
    bst, r = run_updates(ds, bench_params(**ROBUST_GOSS), ROBUST_GOSS_ITERS,
                         prepare=prepare)
    eng = bst._engine
    assert eng._async_mode and eng._goss_dev_used and seen["it"] >= 2
    counted("goss_async", r["counts"])
    strat = type(eng.sample_strategy)(eng.config, eng.num_data, 1)
    it, g, h, key = seen["it"], seen["grad"], seen["hess"], seen["key"]
    assert key == prng.fold_in(eng._bag_key, it)
    on_card = strat.sample_dev(it, g, h, key)
    on_cpu = strat.sample_dev(it, g.cpu(), h.cpu(), key)
    for a, b in zip(on_card, on_cpu):
        assert a.device == g.device and torch.equal(a.cpu(), b), \
            "device GOSS draw"
    draw_ms = cuda_ms(lambda: strat.sample_dev(it, g, h, key), reps=5)
    log(f"phase 16 (b) goss async iter_s={r['iter_s']!r} "
        f"median_iter_s={r['median_iter_s']!r} "
        f"phase12_host_goss_median_iter_s={goss12_iter_s!r} "
        f"over_phase12={r['median_iter_s'] / goss12_iter_s!r} "
        f"device_draw_ms={draw_ms!r} host_draw={sampling_host_ms(eng)} "
        f"draw at iteration {it}: {int(on_cpu[0].sum())} rows kept, "
        f"equal to the CPU draw bit for bit; logloss={r['logloss']!r}")
    del bst, eng, seen
    gc.collect()


def robust_checkpoints(ds, ds_params, X, tmp, counted):
    """(c) An uninterrupted run; one killed mid-write of checkpoint
    ROBUST_KILL_AFTER + 1; its resume from the newest valid checkpoint
    giving the uninterrupted model text and predictions bit for bit; a
    bit-flipped newest checkpoint skipped; the ms of a checkpoint
    write."""
    import os
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.robustness import checkpoint as ckpt
    from lightgbm_tpu_torch.robustness import faults
    params = bench_params(**ROBUST_CKPT)
    ck = os.path.join(tmp, "ck")
    write_ms, state_ms = [], []
    write = ckpt.write_checkpoint

    def timed_write(directory, state, keep_last=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = write(directory, state, keep_last=keep_last)
        write_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def run(name, **kw):
        ds.params = dict(ds_params)
        reset_counts()
        t = time.perf_counter()
        try:
            bst = lgt.train(dict(params), ds,
                            num_boost_round=ROBUST_CKPT_ROUNDS, **kw)
        finally:
            counted(name, read_counts())
            log(f"phase 16 (c) run={name} seconds="
                f"{time.perf_counter() - t!r}")
        return bst

    ref = run("ckpt_reference")
    ckpt.write_checkpoint = timed_write
    try:
        with faults.inject(f"write_kill:after={ROBUST_KILL_AFTER}:n=1"):
            try:
                run("ckpt_killed",
                    callbacks=[lgt.checkpoint_callback(ck, every_n=1)])
                raise AssertionError("write_kill did not fire")
            except faults.WriteKilled:
                pass
        got = ckpt.latest_valid_checkpoint(ck)
        assert got[1]["iteration"] == ROBUST_KILL_AFTER, got[1]["iteration"]
        resumed = run("ckpt_resumed", resume_from=ck,
                      callbacks=[lgt.checkpoint_callback(ck, every_n=1)])
    finally:
        ckpt.write_checkpoint = write
    assert resumed.model_to_string() == ref.model_to_string()
    Xp = np.asarray(X[:PREDICT_ROWS], np.float64)
    for device in (False, True):
        assert np.array_equal(resumed.predict(Xp, device=device),
                              ref.predict(Xp, device=device)), device
    t = time.perf_counter()
    state = ckpt.booster_state(resumed, ROBUST_CKPT_ROUNDS + 1)
    state_ms.append((time.perf_counter() - t) * 1e3)
    with faults.inject("bitflip:where=ckpt"):
        flipped = ckpt.write_checkpoint(ck, state)
    path, back = ckpt.latest_valid_checkpoint(ck)
    assert path != flipped and back["iteration"] == ROBUST_CKPT_ROUNDS
    log(f"phase 16 (c) resumed from iteration {ROBUST_KILL_AFTER} to "
        f"{ROBUST_CKPT_ROUNDS}: model text and predictions ({len(Xp)} rows, "
        f"host walk and device route) equal to the uninterrupted run bit "
        f"for bit; bit-flipped newest skipped for iteration "
        f"{back['iteration']}; checkpoint_write_ms={write_ms!r} "
        f"booster_state_ms={state_ms!r} checkpoint_bytes="
        f"{os.path.getsize(path)}")


def robust_guard(ds, ds_params, sync_iter_s, counted):
    """(d) The numeric guard under nan_grad:after=1: NumericHealthError
    before iteration 1's tree commits, one tree kept; then two armed
    iterations with no fault, timed, and the guard's own device ms."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.robustness import faults
    from lightgbm_tpu_torch.robustness.integrity import NumericHealthError
    ds.params = dict(ds_params)
    reset_counts()
    bst = lgt.Booster(bench_params(tpu_integrity_numeric_guard=True), ds)
    with faults.inject("nan_grad:after=1"):
        bst.update()
        try:
            bst.update()
            raise AssertionError("the guard let a NaN iteration through")
        except NumericHealthError as e:
            refused = str(e)
    assert bst.num_trees() == 1 and bst._engine.iter == 1
    iter_s = []
    for _ in range(2):
        t = time.perf_counter()
        assert not bst.update()
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t)
    counted("guard", read_counts())
    eng = bst._engine
    g, h = eng.objective.get_gradients(eng.score[0])
    guard_ms = cuda_ms(lambda: eng._guard_sums(g[None], h[None]), reps=10)
    log(f"phase 16 (d) guard refused iteration 1 ({refused[:80]}...), "
        f"trees kept={bst.num_trees() - 2} before the armed iterations; "
        f"armed iter_s={iter_s!r} sync_median_iter_s={sync_iter_s!r} "
        f"guard_sums_ms={guard_ms!r}")
    del bst, eng
    gc.collect()


def start_children(ds, X, tmp):
    """(e) Two children on CHILD_ROWS of phase 4's rows, each under
    ``watch_child`` in a thread of its own: a healthy one, and one under
    ``LGBM_TPU_FAULTS=hang:after=2`` that goes silent from its third
    beat. Returns what ``finish_children`` joins."""
    import os
    import subprocess
    import threading
    from lightgbm_tpu_torch.robustness import heartbeat
    from lightgbm_tpu_torch.robustness.supervisor import (DeviceStallError,
                                                          watch_child)
    x_path, y_path = os.path.join(tmp, "X.npy"), os.path.join(tmp, "y.npy")
    np.save(x_path, np.ascontiguousarray(X[:CHILD_ROWS]))
    np.save(y_path, np.asarray(ds.get_label()[:CHILD_ROWS], np.float32))
    policy = heartbeat.StallPolicy(
        stall_sec={"compiling": 300.0, "iter": CHILD_STALL_SEC},
        default_stall=CHILD_STALL_SEC, silent_sec=60.0, startup_grace=120.0)
    runs = {"healthy": ({}, CHILD_ITERS),
            "hang": ({"LGBM_TPU_FAULTS": "hang:after=2"}, CHILD_HANG_ITERS)}
    procs, out, threads = {}, {}, []

    def supervise(name, proc, hb):
        verdicts = []
        try:
            rc = watch_child(proc, hb, policy=policy, poll=CHILD_POLL_SEC,
                             term_grace=10.0, label=f"child {name}",
                             on_status=lambda v, r: verdicts.append(
                                 (v, time.monotonic())))
            out[name] = ("exit", rc, verdicts, time.monotonic())
        except DeviceStallError as e:
            out[name] = ("stalled", str(e), verdicts, time.monotonic())

    t0 = time.perf_counter()
    for name, (extra, iters) in runs.items():
        hb = os.path.join(tmp, f"child_{name}.hb")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("LGBM_TPU_")}
        env.update(LGBM_TPU_HEARTBEAT=hb, LGBM_TPU_HEARTBEAT_KA="0.5",
                   LGBM_TPU_STALL_SEC_ITER=str(CHILD_STALL_SEC), **extra)
        procs[name] = (subprocess.Popen(
            [sys.executable, "-c", _CHILD_SRC, x_path, y_path, str(iters),
             CHILD_DEVICE], env=env,
            cwd=os.path.dirname(os.path.abspath(__file__))), hb)
        th = threading.Thread(target=supervise, args=(name, *procs[name]))
        th.start()
        threads.append(th)
    return procs, out, threads, t0


def finish_children(children):
    """Join the supervisors, then end every child still running."""
    procs, out, threads, t0 = children
    try:
        for th in threads:
            th.join(timeout=240)
            assert not th.is_alive(), "a supervisor did not return"
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)
    return procs, out, time.perf_counter() - t0


def check_children(procs, out, seconds):
    """The healthy child exited 0 after CHILD_ITERS iterations; the hung
    one was classified STALLED within CHILD_STALL_SEC of its last beat
    (plus the poll) and ended."""
    from lightgbm_tpu_torch.robustness import heartbeat
    kind, rc, verdicts, _ = out["healthy"]
    assert kind == "exit" and rc == 0, out["healthy"]
    last = heartbeat.read(procs["healthy"][1])
    assert (last.phase, last.progress) == ("iter", CHILD_ITERS - 1), last
    kind, detail, verdicts, ended = out["hang"]
    stalled_at = [t for v, t in verdicts if v == heartbeat.STALLED]
    assert kind == "stalled" and stalled_at, out["hang"]
    frozen = heartbeat.read(procs["hang"][1])
    assert (frozen.phase, frozen.progress) == ("iter", 1), frozen
    classified_s, ended_s = stalled_at[0] - frozen.t, ended - frozen.t
    # the verdict comes one poll after the budget runs out, the
    # SIGTERM one poll after that (hysteresis), then the child's exit
    assert classified_s <= CHILD_STALL_SEC + 2 * CHILD_POLL_SEC, \
        classified_s
    assert ended_s <= CHILD_STALL_SEC + 3.0, ended_s
    log(f"phase 16 (e) children on {CHILD_ROWS} rows: healthy rc=0 after "
        f"{CHILD_ITERS} iterations (last beat {last.phase} "
        f"{last.progress}); hang child verdicts="
        f"{[v for v, _ in verdicts]} classified {classified_s!r} s and "
        f"ended {ended_s!r} s after its last beat (budget "
        f"{CHILD_STALL_SEC} s, poll {CHILD_POLL_SEC} s), exit code "
        f"{procs['hang'][0].returncode}; seconds={seconds!r} (beside (c) "
        "and (f))")


def phase_robustness_cross_check():
    """(f) cuda against the CPU on ROBUST_SMALL_ROWS rows, 31 leaves:
    GOSS drawn on the device chain (auto on the card, true on the CPU:
    the same bags), and a run killed at its second checkpoint write and
    resumed to ROBUST_SMALL_ROUNDS (the bags its restored sampler draws);
    the CPU launching no kernel, the trees to the binary standard.
    Returns the cuda runs' launches."""
    import os
    import tempfile
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.models.sample_strategy import BaggingStrategy
    from lightgbm_tpu_torch.robustness import faults
    X, y = synth_higgs(ROBUST_SMALL_ROWS, N_FEATURES, seed=16)
    Xd = X.astype(np.float64)
    counts = {}
    tc = time.perf_counter()
    out = {}
    for dev in ("cuda", "cpu"):
        params = bench_params(num_leaves=31, device_type=dev,
                              **ROBUST_GOSS)
        if dev == "cpu":
            params["tpu_async_boosting"] = "true"
        reset_counts()
        bst = lgt.Booster(params, lgt.Dataset(X, label=y))
        bags = record_bags(bst._engine)
        for _ in range(ROBUST_SMALL_ROUNDS):
            assert not bst.update(), dev
        assert bst._engine._goss_dev_used, dev
        out[dev] = (bst, bags, read_counts())
    (cb, cbags, cc), (pb, pbags, pc) = out["cuda"], out["cpu"]
    assert all(np.array_equal(a, b) for a, b in zip(cbags, pbags))
    assert cc["hist_rowmajor_f32"] > 0 and sum(pc.values()) == 0, (cc, pc)
    amp = sampling_grad_max(ROBUST_GOSS)
    assert_trees_to_binary_standard(cb, pb, Xd, pbags, 0.5, amp, 0.25 * amp,
                                    "phase 16 cross-check goss async")
    counts["cross_check_goss_async"] = cc
    log(f"phase 16 (f) cross-check goss async: bags equal, trees to the "
        f"binary standard, cuda_launches={nonzero(cc)} "
        f"seconds={time.perf_counter() - tc!r}")

    tc = time.perf_counter()
    resumed = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cuda", "cpu"):
            params = bench_params(num_leaves=31, device_type=dev,
                                  **ROBUST_CKPT)
            ck = os.path.join(tmp, dev)
            reset_counts()
            with faults.inject("write_kill:after=1:n=1"):
                try:
                    lgt.train(dict(params), lgt.Dataset(X, label=y),
                              num_boost_round=ROBUST_SMALL_ROUNDS,
                              callbacks=[lgt.checkpoint_callback(ck)])
                    raise AssertionError("write_kill did not fire")
                except faults.WriteKilled:
                    pass
            resumed[dev] = (lgt.train(dict(params), lgt.Dataset(X, label=y),
                                      num_boost_round=ROBUST_SMALL_ROUNDS,
                                      resume_from=ck), read_counts())
    (cb, cc), (pb, pc) = resumed["cuda"], resumed["cpu"]
    assert cc["hist_rowmajor_f32"] > 0 and sum(pc.values()) == 0, (cc, pc)
    strat = BaggingStrategy(lgt.Config(bench_params(**ROBUST_CKPT)),
                            ROBUST_SMALL_ROWS, 1)
    bags = [strat.sample(i)[0] > 0 for i in range(ROBUST_SMALL_ROUNDS)]
    assert_trees_to_binary_standard(cb, pb, Xd, bags, 0.1, 1.0, 0.25,
                                    "phase 16 cross-check resumed")
    counts["cross_check_resumed"] = cc
    log(f"phase 16 (f) cross-check resumed (killed at write 2, resumed to "
        f"{ROBUST_SMALL_ROUNDS}): trees to the binary standard, "
        f"cuda_launches={nonzero(cc)} seconds={time.perf_counter() - tc!r}")
    return counts



# ---------------------------------------------------------------------------
# phase 17: the distributed learners on the card
# ---------------------------------------------------------------------------

DIST_WORLD = 2
DIST_TIMEOUT_S = 600
# name -> (params, timed iterations after one warm-up); every run trains
# phase 4's configuration on phase 4's rows
DIST_RUNS = {
    "data": (dict(tree_learner="data"), 2),
    "data_quantized": (dict(tree_learner="data", use_quantized_grad=True,
                            stochastic_rounding=False), 1),
    "data_reduce_scatter": (dict(tree_learner="data",
                                 tpu_hist_reduce="reduce_scatter"), 1),
    "voting": (dict(tree_learner="voting", top_k=5), 1),
    "feature": (dict(tree_learner="feature"), 1),
    "data_full": (dict(tree_learner="data", tpu_row_scheduling="full"), 1),
}
# the one-rank NCCL world in this process: its all-reduce and its
# reduce-scatter on the card
NCCL_RUNS = {
    "data_quantized": DIST_RUNS["data_quantized"],
    "data_quantized_reduce_scatter": (
        dict(DIST_RUNS["data_quantized"][0],
             tpu_hist_reduce="reduce_scatter"), 1),
}
# the serial reference of each gang run's standard (phase 4's model cut
# to the run's rounds, phase 5's full model, the serial quantized text)
DIST_SERIAL = {"data": "f32", "data_reduce_scatter": "f32", "voting": "f32",
               "feature": "f32", "data_full": "full"}


def no_params(text):
    return text[:text.index("\nparameters:")]


def dist_run(ds, ds_params, params, iters):
    """One run of a distributed learner through ``Booster``: a warm-up and
    ``iters`` timed iterations, the launch counts zeroed before and read
    after, the world's collectives counted over the timed iterations
    only: each call's host seconds, which under gloo include the staging
    copy's wait for the device work queued before it and the wait for
    the peer rank. The Dataset's parameters are ``ds_params`` again
    first (a Booster merges its own into them)."""
    import lightgbm_tpu_torch as lgt
    ds.params = dict(ds_params)
    reset_counts()
    bst = lgt.Booster(params, ds)
    eng = bst._engine
    comm = eng._comm
    t = time.perf_counter()
    assert not bst.update()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    first = dict((m, v) for _, m, v, _ in bst.eval_train())
    comm.reset_stats()
    iter_s = []
    for _ in range(iters):
        t = time.perf_counter()
        assert not bst.update()
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t)
    stats = {k: list(v) for k, v in comm.stats.items()}
    last = dict((m, v) for _, m, v, _ in bst.eval_train())
    return dict(text=bst.model_to_string(), warm_s=warm_s, iter_s=iter_s,
                stats=stats, timed_trees=iters, counts=nonzero(read_counts()),
                leaves=[t.num_leaves for t in eng.models],
                learner=eng._tree_learner, hist_reduce=eng._hist_reduce,
                backend=comm.backend, first=first, last=last)


def dist_worker(plan_path):
    """One rank of phase 17's gang (``--dist-worker PLAN``): joins the
    world from the launcher's variables, loads phase 4's binned rows
    from the binary file ``PLAN["data"]`` and trains every DIST_RUNS
    configuration in this one process start, writing its results to
    ``PLAN["out"]/rank<r>.json``; then phase 18's (a) and (b)
    (``sharded_worker_runs``)."""
    import os
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import distributed
    with open(plan_path) as fh:
        plan = json.load(fh)
    rank = distributed.init_from_env()
    ds = lgt.Dataset(plan["data"]).construct()
    ds_params = dict(ds.params)
    res = {"rank": rank, "ready_wall": time.time(), "runs": {},
           "device": str(torch.cuda.current_device())}
    for name, (extra, iters) in DIST_RUNS.items():
        res["runs"][name] = dist_run(ds, ds_params, bench_params(**extra),
                                     iters)
    del ds
    gc.collect()
    res["sharded"] = sharded_worker_runs(plan, rank)
    with open(os.path.join(plan["out"], f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    distributed.shutdown_distributed()


def dist_summary(run, phase4_iter_s):
    """The logged numbers of one run: s/iteration beside phase 4's,
    collective ms and calls a tree by kind, bytes a histogram reduction,
    the kernels' launches."""
    trees = run["timed_trees"]
    med = statistics.median(run["iter_s"])
    per_tree = {k: {"ms": v[2] * 1e3 / trees, "calls": v[0] / trees}
                for k, v in run["stats"].items()}
    hist_bytes = {k: v[1] / v[0] for k, v in run["stats"].items()
                  if k.startswith("hist_") and v[0]}
    return {"learner": run["learner"], "hist_reduce": run["hist_reduce"],
            "backend": run["backend"], "median_iter_s": med,
            "vs_phase4": med / phase4_iter_s, "warm_s": run["warm_s"],
            "collective_ms_per_tree": per_tree,
            "bytes_per_hist_reduction": hist_bytes,
            "collective_ms_per_tree_total": sum(
                v["ms"] for v in per_tree.values()),
            "launches": run["counts"], "leaves": run["leaves"],
            "logloss": [run["first"]["binary_logloss"],
                        run["last"]["binary_logloss"]]}


def check_dist_launches(run, params, what):
    """K1 once a leaf of every tree on a compact run, B2 on a full one,
    and nothing else: the rank's histograms went through its kernel."""
    key = ("hist_featmajor_f32"
           if params.get("tpu_row_scheduling") == "full" else
           "hist_rowmajor_int8" if params.get("use_quantized_grad") else
           "hist_rowmajor_f32")
    n = run["counts"].get(key, 0)
    assert n > 0 and n == sum(run["leaves"]), (what, run["counts"],
                                              run["leaves"])
    assert sum(run["counts"].values()) == n, (what, run["counts"])


def phase_distributed(base_bst, ds, X, full_text, phase4_iter_s):
    """Phase 17: the distributed learners at phase 4's width.

    (a) Two ranks share the card over gloo (NCCL refuses two ranks on one
    device), started by one ``launch_local`` of this script: each trains
    DIST_RUNS; both ranks' texts must be equal, the quantized
    data-parallel text must equal the serial quantized text trained here
    string for string (exact int32 sums), and the f32 runs must match
    the serial model (phase 4's cut to their rounds; phase 5's full
    model for ``data_full``) to the binary standard; each rank's K1 (B2)
    launches are one a leaf. (b) A world of one rank over NCCL in this
    process: quantized data parallel by all-reduce and by reduce-scatter
    (NCCL's collectives on the card), each text equal to the serial
    quantized one. Returns (launches by run, this process's launch
    totals, the gang's rank results and its directory, which phase 18
    reads and removes)."""
    import os
    import socket
    import tempfile
    import threading
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import distributed
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    plan_path = os.path.join(tmp, "plan.json")
    data_path = os.path.join(tmp, "phase4.bin")
    ds.save_binary(data_path)
    with open(plan_path, "w") as fh:
        json.dump({"out": tmp, "data": data_path}, fh)
    box = {}

    def gang():
        try:
            box["runs"] = distributed.launch_local(
                [sys.executable, os.path.abspath(__file__), "--dist-worker",
                 plan_path], DIST_WORLD, timeout=DIST_TIMEOUT_S,
                backend="gloo")
        except BaseException as e:   # noqa: BLE001 - re-raised below
            box["error"] = e
    launched = time.time()
    th = threading.Thread(target=gang)
    th.start()
    # the serial quantized reference, trained while the ranks start
    ds_params = dict(ds.params)
    q_params = bench_params(**{k: v for k, v in
                               DIST_RUNS["data_quantized"][0].items()
                               if k != "tree_learner"})
    ref_q = no_params(lgt.train(q_params, ds,
                                num_boost_round=2).model_to_string())
    th.join()
    if "error" in box:
        raise box["error"]
    for r, (rc, out) in enumerate(box["runs"]):
        assert rc == 0, (r, out[-6000:])
    ranks = []
    for r in range(DIST_WORLD):
        with open(os.path.join(tmp, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    gang_s = time.perf_counter() - t0
    startup = [rk["ready_wall"] - launched for rk in ranks]
    sharded_s = max(rk["sharded"]["sharded_s"] for rk in ranks)
    log(f"phase 17 (a) gang of {DIST_WORLD} gloo ranks on one card: "
        f"start-up_s (launch to phase 4's binned rows loaded, by rank)="
        f"{startup!r} gang_s={gang_s!r} (of it phase 18 (a) and (b): "
        f"{sharded_s!r}) devices={[rk['device'] for rk in ranks]}")
    launches = {}
    for name in DIST_RUNS:
        r0, r1 = (rk["runs"][name] for rk in ranks)
        assert r0["text"] == r1["text"], name
        assert r0["learner"] == DIST_RUNS[name][0]["tree_learner"], r0
        for r, run in enumerate((r0, r1)):
            check_dist_launches(run, DIST_RUNS[name][0], name)
            assert run["last"]["binary_logloss"] < \
                run["first"]["binary_logloss"], (name, r)
        launches[name] = [r0["counts"], r1["counts"]]
        log(f"phase 17 (a) {name}: " + json.dumps(
            {"rank0": dist_summary(r0, phase4_iter_s),
             "rank1_median_iter_s": statistics.median(r1["iter_s"]),
             "rank1_launches": r1["counts"]}))
    assert ranks[0]["runs"]["data_reduce_scatter"]["hist_reduce"] == \
        "reduce_scatter"
    assert no_params(ranks[0]["runs"]["data_quantized"]["text"]) == ref_q
    log("phase 17 (a) quantized data parallel equals the serial quantized "
        "model string for string")
    tb = time.perf_counter()
    renumbered = {}
    for name, ref_kind in DIST_SERIAL.items():
        run = ranks[0]["runs"][name]
        rounds = 1 + DIST_RUNS[name][1]
        ref_text = (full_text if ref_kind == "full" else
                    base_bst.model_to_string(num_iteration=rounds))
        ref = lgt.Booster(model_str=ref_text, params={"device_type": "cuda"})
        got = lgt.Booster(model_str=run["text"],
                          params={"device_type": "cuda"})
        renumbered[name] = assert_trees_in_any_order(
            ref, got, X, 0.1, 1.0, 0.25, f"phase 17 {name}")
    log(f"phase 17 (a) f32, reduce_scatter, voting, feature and full runs "
        f"match the serial models to the binary standard, nodes paired by "
        f"position (trees whose split order differs: {renumbered}; "
        f"check_s={time.perf_counter() - tb!r})")
    # (b) NCCL, one rank, in this process
    tn = time.perf_counter()
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    distributed.init_distributed(f"localhost:{port}", 1, 0, backend="nccl")
    totals = {}
    try:
        for name, (extra, iters) in NCCL_RUNS.items():
            run = dist_run(ds, ds_params, bench_params(**extra), iters)
            check_dist_launches(run, extra, name)
            assert run["backend"] == "nccl", run["backend"]
            kind = ("hist_reduce_scatter" if "reduce_scatter" in name
                    else "hist_allreduce")
            assert run["stats"][kind][0] > 0, run["stats"]
            assert no_params(run["text"]) == ref_q, name
            for k, v in run["counts"].items():
                totals[k] = totals.get(k, 0) + v
            launches[f"nccl_{name}"] = run["counts"]
            log(f"phase 17 (b) nccl world of 1 {name}: "
                + json.dumps(dist_summary(run, phase4_iter_s)))
    finally:
        distributed.shutdown_distributed()
        ds.params = ds_params
    log(f"phase 17 (b) NCCL all-reduce and reduce-scatter runs equal the "
        f"serial quantized model string for string "
        f"(nccl_s={time.perf_counter() - tn!r}); phase 17 "
        f"{time.perf_counter() - t0 - sharded_s!r} s without phase 18's "
        "share of the gang")
    return launches, totals, ranks, tmp


# ---------------------------------------------------------------------------
# phase 18: sharded ingestion and the supervised gang on the card
# ---------------------------------------------------------------------------

# (a) phase 4's table cut over the two ranks of phase 17's gang, each
# rank holding its block only (uneven, so the regions carry pad rows);
# name -> (params, timed iterations after one warm-up)
SHARD_ROWS = (499_001, 500_999)
SHARD_RUNS = {
    "data": (dict(tree_learner="data"), 2),
    "data_quantized": (dict(tree_learner="data", use_quantized_grad=True,
                            stochastic_rounding=False), 1),
}
# the held-out rows the sharded f32 model and phase 17's data-parallel f32
# model of the same three trees are held to, relative logloss
HOLDOUT_SEED = 3
LOGLOSS_RTOL = 0.01
# (b) and (c): a 200,000-row table, each rank's rows in its own CSV file
# (the default bin_construct_sample_cnt covers every row), quantized data
# parallel with deterministic rounding, a checkpoint and its gang
# manifest every iteration on rank 0
FILE_ROWS = (99_000, 101_000)
FILE_SEED = 2
FILE_ROUNDS = 4
GANG_KILL = "rank_kill:rank=1:after=2"
GANG_TIMEOUT_S = 300
# the survivor's grace after SIGTERM; no SIGKILL follows it
GANG_TERM_GRACE_S = 30.0


def file_params():
    return bench_params(tree_learner="data", use_quantized_grad=True,
                        stochastic_rounding=False, pre_partition=True)


def shard_block(a, sizes, rank):
    lo = sum(sizes[:rank])
    return a[lo:lo + sizes[rank]]


def file_table():
    X, y = synth_higgs(sum(FILE_ROWS), N_FEATURES, seed=FILE_SEED)
    return X.astype(np.float64), y.astype(np.float64)


def train_file_shard(path, ckpt, rank, resume):
    """(b)/(c) on one rank: its CSV through the file route, FILE_ROUNDS
    rounds of ``train``, rank 0 checkpointing each iteration; the launch
    counts of this call and the leaves of the trees it trained."""
    import lightgbm_tpu_torch as lgt
    t = time.perf_counter()
    ds = lgt.Dataset(path, params=file_params()).construct()
    load_s = time.perf_counter() - t
    cbs = ([lgt.checkpoint_callback(ckpt, every_n=1, keep_last=FILE_ROUNDS)]
           if rank == 0 else [])
    reset_counts()
    t = time.perf_counter()
    bst = lgt.train(file_params(), ds, num_boost_round=FILE_ROUNDS,
                    callbacks=cbs, resume_from=ckpt if resume else None)
    torch.cuda.synchronize()
    eng = bst._engine
    return {"text": bst.model_to_string(), "load_s": load_s,
            "train_s": time.perf_counter() - t,
            "counts": nonzero(read_counts()),
            "resumed_from": eng.num_init_iteration,
            "leaves": [t.num_leaves for t in
                       eng.models[eng.num_init_iteration:]],
            "bins_shape": list(eng.train_set.bins.shape),
            "row_counts": eng.train_set.shard.row_counts.tolist()}


def sharded_worker_runs(plan, rank):
    """Phase 18 (a) and (b) on one rank of phase 17's gang (after its
    DIST_RUNS, the world already joined)."""
    import os
    import zlib
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import distributed
    from lightgbm_tpu_torch.io.binning import serialize_bin_mappers
    t0 = time.perf_counter()
    out = {}
    X, y = synth_higgs(N_ROWS, N_FEATURES)
    Xs = shard_block(X, SHARD_ROWS, rank).copy()
    ys = shard_block(y, SHARD_ROWS, rank).copy()
    del X, y
    synth_s = time.perf_counter() - t0
    t = time.perf_counter()
    ds = lgt.Dataset(Xs, label=ys,
                     params=bench_params(pre_partition=True)).construct()
    b = ds._binned
    out["ingest"] = {
        "synth_s": synth_s, "construct_s": time.perf_counter() - t,
        "stages": b.ingest_stats, "bins_shape": list(b.bins.shape),
        "bins_bytes": int(b.bins.nbytes),
        "row_counts": b.shard.row_counts.tolist(),
        "mappers_crc": zlib.crc32(serialize_bin_mappers(b.bin_mappers))}
    del Xs
    ds_params = dict(ds.params)
    out["runs"] = {
        name: dist_run(ds, ds_params, bench_params(pre_partition=True,
                                                   **extra), iters)
        for name, (extra, iters) in SHARD_RUNS.items()}
    del ds, b
    gc.collect()
    # (b): this rank's rows of the 200,000-row table as its CSV file
    t = time.perf_counter()
    Xf, yf = file_table()
    rows = np.column_stack([shard_block(yf, FILE_ROWS, rank),
                            shard_block(Xf, FILE_ROWS, rank)])
    np.savetxt(os.path.join(plan["out"], f"part{rank}.csv"), rows,
               delimiter=",", fmt="%.17g")
    write_s = time.perf_counter() - t
    ckpt = os.path.join(plan["out"], "ckpt_b")
    out["file"] = train_file_shard(
        os.path.join(plan["out"], "part{rank}.csv"), ckpt, rank, False)
    out["file"]["write_s"] = write_s
    distributed.allgather_bytes(b"")        # rank 0's last commit landed
    from lightgbm_tpu_torch.robustness.gang import list_manifests
    out["file"]["manifests"] = [it for it, _ in list_manifests(ckpt)]
    out["sharded_s"] = time.perf_counter() - t0
    return out


def gang_worker(plan_path):
    """One rank of phase 18 (c)'s supervised gang (``--gang-worker
    PLAN``): run (b) again, resuming from the newest valid gang
    manifest of ``PLAN["ckpt"]``."""
    import os
    from lightgbm_tpu_torch import distributed
    with open(plan_path) as fh:
        plan = json.load(fh)
    rank = distributed.init_from_env()
    ready = time.time()
    res = train_file_shard(os.path.join(plan["dir"], "part{rank}.csv"),
                           plan["ckpt"], rank, True)
    res["ready_wall"] = ready
    with open(os.path.join(plan["dir"], f"gang{rank}.json"), "w") as fh:
        json.dump(res, fh)
    distributed.shutdown_distributed()


def phase_sharded(ranks, tmp, phase4_iter_s):
    """Phase 18: sharded ingestion and the supervised gang at phase 4's
    width. (a) and (b) ran on phase 17's gang (``sharded_worker_runs``);
    (c) launches (b) again under ``launch_local(supervised=True)`` with
    rank 1 killed in its first attempt. Returns (launches by run, the
    launch totals over both ranks)."""
    import os
    import shutil
    import threading
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import distributed
    from lightgbm_tpu_torch.robustness.gang import list_manifests
    t0 = time.perf_counter()
    sh = [rk["sharded"] for rk in ranks]
    phase17_iter_s = statistics.median(ranks[0]["runs"]["data"]["iter_s"])
    launches, totals = {}, {}

    def count(name, runs):
        launches[name] = [r["counts"] for r in runs]
        for r in runs:
            for k, v in r["counts"].items():
                totals[k] = totals.get(k, 0) + v

    # (a) the ingest, the runs and their gates
    for r, s in enumerate(sh):
        ing = s["ingest"]
        assert ing["row_counts"] == list(SHARD_ROWS), ing["row_counts"]
        assert ing["bins_shape"] == [SHARD_ROWS[r], N_FEATURES], ing
        log(f"phase 18 (a) rank {r} ingest of its {SHARD_ROWS[r]} rows: "
            f"synth_s={ing['synth_s']!r} construct_s="
            f"{ing['construct_s']!r} stages={json.dumps(ing['stages'])} "
            f"binned table bytes={ing['bins_bytes']} (replicated "
            f"{N_ROWS * N_FEATURES}) sharded_s={s['sharded_s']!r}")
    assert sh[0]["ingest"]["mappers_crc"] == sh[1]["ingest"]["mappers_crc"]
    for name in SHARD_RUNS:
        r0, r1 = (s["runs"][name] for s in sh)
        assert r0["text"] == r1["text"], name
        for r, run in enumerate((r0, r1)):
            check_dist_launches(run, SHARD_RUNS[name][0],
                                f"phase 18 (a) {name} rank {r}")
            assert run["last"]["binary_logloss"] < \
                run["first"]["binary_logloss"], (name, r)
        count(f"sharded_{name}", (r0, r1))
        med = statistics.median(r0["iter_s"])
        log(f"phase 18 (a) {name}: " + json.dumps(
            {"rank0": dist_summary(r0, phase4_iter_s),
             "vs_phase17_data": med / phase17_iter_s,
             "rank1_median_iter_s": statistics.median(r1["iter_s"]),
             "rank1_launches": r1["counts"]}))
    Xh, yh = synth_higgs(VALID_ROWS, N_FEATURES, seed=HOLDOUT_SEED)
    losses = {}
    for key, text in (("sharded", sh[0]["runs"]["data"]["text"]),
                      ("phase17", ranks[0]["runs"]["data"]["text"])):
        bst = lgt.Booster(model_str=text, params={"device_type": "cuda"})
        assert bst.num_trees() == 1 + SHARD_RUNS["data"][1]
        losses[key] = binary_logloss(yh, bst.predict(Xh))
    gap = abs(losses["sharded"] - losses["phase17"]) / losses["phase17"]
    log(f"phase 18 (a) held-out logloss on {VALID_ROWS} rows, 3 trees: "
        f"sharded={losses['sharded']!r} phase17_data={losses['phase17']!r}"
        f" relative_gap={gap!r} (limit {LOGLOSS_RTOL})")
    assert gap <= LOGLOSS_RTOL, losses

    # (b) the file route, bit for bit: the serial quantized reference of
    # the whole table is trained here while (c)'s gang runs
    fb = [s["file"] for s in sh]
    assert fb[0]["text"] == fb[1]["text"]
    assert fb[0]["manifests"] == list(range(FILE_ROUNDS, 0, -1)), \
        fb[0]["manifests"]
    for r, f in enumerate(fb):
        assert f["row_counts"] == list(FILE_ROWS), f
        assert f["bins_shape"] == [FILE_ROWS[r], N_FEATURES], f
        check_dist_launches(f, file_params(), f"phase 18 (b) rank {r}")
    count("file_route", fb)
    log(f"phase 18 (b) file route {FILE_ROWS} rows, {FILE_ROUNDS} rounds: "
        + json.dumps([{k: f[k] for k in ("write_s", "load_s", "train_s",
                                         "counts")} for f in fb]))

    # (c) the chaos round trip
    ckpt = os.path.join(tmp, "ckpt_c")
    plan_path = os.path.join(tmp, "gang_plan.json")
    with open(plan_path, "w") as fh:
        json.dump({"dir": tmp, "ckpt": ckpt}, fh)
    seen, sups, box = [], [], {}

    def attempt_env(i):
        newest = [it for it, _ in list_manifests(ckpt)]
        seen.append({"attempt": i, "wall": time.time(),
                     "newest_manifest": newest[0] if newest else None})
        return {"LGBM_TPU_FAULTS": GANG_KILL if i == 0 else "off"}

    def gang():
        try:
            box["runs"] = distributed.launch_local(
                [sys.executable, os.path.abspath(__file__), "--gang-worker",
                 plan_path], DIST_WORLD, timeout=GANG_TIMEOUT_S,
                supervised=True, backend="gloo", attempts=2,
                attempt_env=attempt_env, poll=0.1,
                term_grace=GANG_TERM_GRACE_S, escalate_kill=False,
                supervisors=sups, label="phase 18 gang")
        except BaseException as e:   # noqa: BLE001 - re-raised below
            box["error"] = e
    tc = time.perf_counter()
    th = threading.Thread(target=gang)
    th.start()
    Xf, yf = file_table()
    serial = {k: v for k, v in file_params().items()
              if k not in ("tree_learner", "pre_partition")}
    ref = no_params(lgt.train(serial, lgt.Dataset(Xf, label=yf),
                              num_boost_round=FILE_ROUNDS).model_to_string())
    th.join()
    chaos_s = time.perf_counter() - tc
    # every process of the killed attempt ended: none outlived SIGTERM
    first = sups[0]
    left = [p.pid for p in first.procs if p.poll() is None]
    for p in first.procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert not left, f"phase 18 (c) ranks {left} outlived SIGTERM"
    if "error" in box:
        raise box["error"]
    assert no_params(fb[0]["text"]) == ref
    log("phase 18 (b) the file route's sharded quantized text equals the "
        f"serial quantized model of the {sum(FILE_ROWS)} rows string for "
        "string")
    gangs = []
    for r in range(DIST_WORLD):
        with open(os.path.join(tmp, f"gang{r}.json")) as fh:
            gangs.append(json.load(fh))
    assert [rc for rc, _ in box["runs"]] == [0, 0]
    assert len(seen) == 2 and len(sups) == 2, seen
    resumed = seen[1]["newest_manifest"]
    assert resumed is not None and 1 <= resumed < FILE_ROUNDS, seen
    for r, g in enumerate(gangs):
        assert g["text"] == fb[0]["text"], r
        assert g["resumed_from"] == resumed, (r, g["resumed_from"])
        check_dist_launches(g, file_params(), f"phase 18 (c) rank {r}")
    count("chaos_relaunch", gangs)
    rcs = [p.returncode for p in first.procs]
    assert rcs[1] == 87, rcs            # faults.EXIT_RANK_KILLED
    log(f"phase 18 (c) supervised gang: attempts={len(seen)} first attempt "
        f"exit codes={rcs} (rank 0 ended by "
        f"{'SIGTERM' if rcs[0] == -15 else 'itself'}) "
        f"SIGTERM_to_all_exited_s="
        f"{first.drained_at - first.terminated_at!r} (poll 0.1 s, grace "
        f"{GANG_TERM_GRACE_S}) relaunch_start_up_s="
        f"{[g['ready_wall'] - seen[1]['wall'] for g in gangs]!r} "
        f"resumed_iteration={resumed} relaunch_launches="
        f"{[g['counts'] for g in gangs]} replay_bytes_per_tree="
        f"{sum(FILE_ROWS) * 4} chaos_s={chaos_s!r}; the final text equals "
        "(b)'s string for string")
    shutil.rmtree(tmp)
    log(f"phase 18 seconds in this process={time.perf_counter() - t0!r} "
        f"(a)+(b) on the gang={max(s['sharded_s'] for s in sh)!r}")
    return launches, totals


SERVE_CLIENTS = 8
SERVE_REQUESTS = 2_000          # (a): at least this many requests in all
SERVE_MAX_ROWS = 4_096
SERVE_LINGER_MS = 2.0
SERVE_SWAPS = 2                 # (b): update() + publish() under load
SERVE_TAIL = 3                  # requests a client sends after the swaps
SHAP_ROWS = 20_000
SHAP_HOST_ROWS = 2_000
SHAP_PROFILE_ROWS = 2_000
SHAP_RTOL, SHAP_ATOL = 1e-4, 1e-5
EXPLAIN_CLIENTS = 4
EXPLAIN_REQUESTS = 8            # each client's
EXPLAIN_ROWS = 256
FAULT_ROWS = 1_000
INTEGRITY_INTERVAL_S = 0.2
SERVE_PROBE_S = 0.05


def serve_threads(fn, n):
    """Run ``fn(i)`` on ``n`` threads; re-raise the first failure."""
    import threading
    errors = []

    def run(i):
        try:
            fn(i)
        except BaseException as e:    # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    assert not any(th.is_alive() for th in threads), "a client hung"
    if errors:
        raise errors[0]


def assert_clean(srv, what):
    st = srv.stats()
    assert st["degraded_batches"] == st["dispatch_failures"] == 0, (what,
                                                                    st)
    assert not st["degraded"], (what, st)
    return st


def serving_traffic(bst, Xp):
    """(a) and (b): ``SERVE_CLIENTS`` closed-loop clients send requests of
    log-uniform sizes over 1..``SERVE_MAX_ROWS`` rows (each a random slice
    of ``Xp``) while a trainer thread runs ``SERVE_SWAPS`` update() +
    publish(). Every response must equal the same rows of one
    ``predict(device=True, raw_score=True)`` of the generation it names."""
    import threading
    from lightgbm_tpu_torch.serving import latency_summary_ms
    k = max(bst._engine.num_tree_per_iteration, 1)
    refs = {}
    srv = bst.serve(linger_ms=SERVE_LINGER_MS, raw_score=True)
    try:
        refs[srv.generation.version] = bst.predict(Xp, device=True,
                                                   raw_score=True)
        sizes = []
        dispatch = srv._batcher.dispatch

        def counted(Xb):
            sizes.append(len(Xb))
            return dispatch(Xb)

        srv._batcher.dispatch = counted
        swapped = threading.Event()
        steady = threading.Event()
        swaps = []
        records = [[] for _ in range(SERVE_CLIENTS)]
        n_each = -(-SERVE_REQUESTS // SERVE_CLIENTS)

        def trainer():
            # half the traffic first, unswapped: (a)'s steady window
            steady.wait(300)
            for _ in range(SERVE_SWAPS):
                t = time.perf_counter()
                assert not bst.update()
                tp = time.perf_counter()
                info = srv.publish()
                swaps.append(dict(start=t, end=time.perf_counter(),
                                  update_s=tp - t,
                                  publish_ms=(time.perf_counter() - tp)
                                  * 1e3, version=info.version,
                                  num_trees=info.num_trees))
            swapped.set()

        def client(ci):
            rng = np.random.default_rng(1900 + ci)
            done = tail = 0
            while done < n_each or tail < SERVE_TAIL:
                n = int(np.exp(rng.uniform(0, np.log(SERVE_MAX_ROWS))))
                s = int(rng.integers(0, len(Xp) - n + 1))
                after = swapped.is_set()
                f = srv.submit(Xp[s:s + n])
                v = f.result(300)
                records[ci].append((s, n, f.generation, v, f.t_enq,
                                    f.t_done))
                done += 1
                tail += after
                if sum(map(len, records)) >= SERVE_REQUESTS // 2:
                    steady.set()
                assert done < 50 * n_each, "the swaps never finished"

        tr = threading.Thread(target=trainer, daemon=True)
        t = time.perf_counter()
        tr.start()
        serve_threads(client, SERVE_CLIENTS)
        tr.join(600)
        wall_s = time.perf_counter() - t
        assert swapped.is_set() and len(swaps) == SERVE_SWAPS, swaps
        st = assert_clean(srv, "traffic")
    finally:
        srv.close()
    gens = {}
    for recs in records:
        versions = [g.version for _, _, g, _, _, _ in recs]
        assert versions == sorted(versions), versions
        for _, _, g, _, _, _ in recs:
            gens[g.version] = g
    assert max(gens) == 1 + SERVE_SWAPS, sorted(gens)
    for v, g in sorted(gens.items()):
        if v not in refs:
            refs[v] = bst.predict(Xp, device=True, raw_score=True,
                                  num_iteration=g.num_trees // k)
    n_req = sum(len(r) for r in records)
    n_rows = sum(n for recs in records for _, n, _, _, _, _ in recs)
    by_gen = {v: 0 for v in gens}
    for recs in records:
        for s, n, g, v, _, _ in recs:
            by_gen[g.version] += 1
            np.testing.assert_array_equal(
                v, refs[g.version][s:s + n],
                err_msg=f"a response of generation {g.version} is not its "
                "predict(device=True) bit for bit")
    lat = [td - te for recs in records for *_, te, td in recs]
    during = [td - te for recs in records for *_, te, td in recs
              if any(te < w["end"] and td > w["start"] for w in swaps)]
    # the steady window: from the first request to the first swap
    t_first = min(te for recs in records for *_, te, _ in recs)
    calm = [(n, td - te) for recs in records for _, n, _, _, te, td in recs
            if td < swaps[0]["start"]]
    calm_s = swaps[0]["start"] - t_first
    calm_lat = latency_summary_ms([x for _, x in calm])
    log(f"phase 19 (a) steady traffic (before the first swap): requests="
        f"{len(calm)} rows={sum(n for n, _ in calm)} wall_s={calm_s!r} "
        f"requests_per_s={len(calm) / calm_s!r} rows_per_s="
        f"{sum(n for n, _ in calm) / calm_s!r} p50_ms="
        f"{calm_lat['p50_ms']!r} p99_ms={calm_lat['p99_ms']!r}")
    summ = latency_summary_ms(lat)
    log(f"phase 19 (a) traffic: clients={SERVE_CLIENTS} requests={n_req} "
        f"rows={n_rows} wall_s={wall_s!r} requests_per_s={n_req / wall_s!r} "
        f"rows_per_s={n_rows / wall_s!r} p50_ms={summ['p50_ms']!r} "
        f"p99_ms={summ['p99_ms']!r} max_ms={summ['max_ms']!r} "
        f"batches={st['batches']} mean_rows_per_batch="
        f"{st.get('mean_rows_per_batch')!r} mean_requests_per_batch="
        f"{st.get('mean_requests_per_batch')!r} max_coalesced_requests="
        f"{st['max_coalesced']} max_coalesced_rows={max(sizes)} "
        f"linger_ms={SERVE_LINGER_MS}; every response equals its "
        f"generation's predict(device=True) bit for bit; degraded_batches="
        f"dispatch_failures=0")
    log(f"phase 19 (b) hot-swap: {SERVE_SWAPS} update()+publish() under "
        f"load: swaps={[{k2: v2 for k2, v2 in w.items() if k2 not in ('start', 'end')} for w in swaps]} "
        f"responses_by_generation={by_gen} "
        f"p99_ms_during_swaps={latency_summary_ms(during)['p99_ms']!r} "
        f"(of {len(during)} requests); versions monotonic per client")
    return refs


def shap_profile(bst, Xs):
    """Device kernels and their device ms in one explanation of ``Xs``,
    under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bst.predict(Xs, pred_contrib=True, device=True)
        torch.cuda.synchronize()
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in on_device),
            sum(e.self_device_time_total for e in on_device) / 1e3)


def shap_bound(paths, depth, F1, rows):
    """The least time of one explanation of ``rows`` rows over ``paths``
    live paths of ``depth`` elements, F1 - 1 features, one class: the
    bytes (int32 bins, each path element's 33 bytes of fields, the leaf
    values, f64 phi) or the f32 operations of the recursion, 2D(D+1)
    a path and row to extend, 8D^2 to unwind, 3D for the products."""
    D = depth
    flops = paths * rows * (2 * D * (D + 1) + 8 * D * D + 3 * D)
    nbytes = ((F1 - 1) * rows * 4 + paths * D * 33 + paths * 4
              + F1 * rows * 8)
    return bound(nbytes, flops)


def serving_shap(bst, Xp):
    """(c): ``predict(pred_contrib=True, device=True)`` against the host
    walk, additivity, a replay, then ``ModelServer.explain`` from
    ``EXPLAIN_CLIENTS`` clients."""
    from lightgbm_tpu_torch.ops import shap_pack
    eng = bst._engine
    F1 = eng.max_feature_idx + 2
    Xs = Xp[:SHAP_ROWS]
    bst.predict(Xs[:100], pred_contrib=True, device=True)     # packs
    torch.cuda.synchronize()
    t = time.perf_counter()
    phi = bst.predict(Xs, pred_contrib=True, device=True)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t
    pack = eng._serving.shap_pack
    assert pack is not None and pack.count == len(eng.models), \
        "the device route did not explain"
    assert phi.shape == (SHAP_ROWS, F1) and np.isfinite(phi).all()
    t = time.perf_counter()
    host = bst.predict(Xs[:SHAP_HOST_ROWS], pred_contrib=True)
    host_s = time.perf_counter() - t
    err = np.abs(phi[:SHAP_HOST_ROWS] - host)
    np.testing.assert_allclose(phi[:SHAP_HOST_ROWS], host, rtol=SHAP_RTOL,
                               atol=SHAP_ATOL)
    raw = bst.predict(Xs, device=True, raw_score=True)
    add = np.abs(phi.sum(axis=1) - raw)
    np.testing.assert_allclose(phi.sum(axis=1), raw, rtol=1e-5, atol=1e-5)
    again = bst.predict(Xs, pred_contrib=True, device=True)
    np.testing.assert_array_equal(again, phi, err_msg="explanation replay")
    launches, dev_ms = shap_profile(bst, Xs[:SHAP_PROFILE_ROWS])
    win = pack.window(0, pack.count)[0]
    paths = sum(min(t.num_leaves, pack.max_leaves) for t in eng.models
                if t.num_leaves > 1)
    bound_ms, bound_by = shap_bound(paths, max(pack.n_elems), F1,
                                    SHAP_PROFILE_ROWS)
    log(f"phase 19 (c) device TreeSHAP: rows={SHAP_ROWS} trees="
        f"{pack.count} paths={paths} depth_cap={win.zf.shape[2]} "
        f"elements={max(pack.n_elems)} seconds={dev_s!r} rows_per_s="
        f"{SHAP_ROWS / dev_s!r}; host TreeSHAP rows={SHAP_HOST_ROWS} "
        f"seconds={host_s!r} rows_per_s={SHAP_HOST_ROWS / host_s!r}; "
        f"max_abs_diff_vs_host={float(err.max())!r} (rtol {SHAP_RTOL} / "
        f"atol {SHAP_ATOL}), additivity max_abs_diff={float(add.max())!r} "
        f"(within 1e-5), a replay equal bit for bit; profiled "
        f"{SHAP_PROFILE_ROWS} rows: device_kernels={launches} "
        f"device_ms={dev_ms!r} bound_ms={bound_ms!r} ({bound_by}) "
        f"SHAP_ELEMS={shap_pack.SHAP_ELEMS}")
    with bst.serve(linger_ms=SERVE_LINGER_MS) as srv:
        def client(ci):
            rng = np.random.default_rng(1950 + ci)
            for _ in range(EXPLAIN_REQUESTS):
                s = int(rng.integers(0, SHAP_ROWS - EXPLAIN_ROWS + 1))
                got = srv.explain(Xs[s:s + EXPLAIN_ROWS], timeout=300)
                np.testing.assert_allclose(got, phi[s:s + EXPLAIN_ROWS],
                                           rtol=SHAP_RTOL, atol=SHAP_ATOL)

        t = time.perf_counter()
        serve_threads(client, EXPLAIN_CLIENTS)
        wall_s = time.perf_counter() - t
        st = assert_clean(srv, "explain")
        n = EXPLAIN_CLIENTS * EXPLAIN_REQUESTS
        assert srv.counters.get("explain_requests") == n, st
        assert srv.counters.get("explain_degraded") == 0, st
        log(f"phase 19 (c) ModelServer.explain: clients={EXPLAIN_CLIENTS} "
            f"requests={n} rows={n * EXPLAIN_ROWS} wall_s={wall_s!r} "
            f"explained_rows_per_s={n * EXPLAIN_ROWS / wall_s!r} "
            f"batches={st['explain']['batches']} p50_ms="
            f"{st['explain']['p50_ms']!r} p99_ms={st['explain']['p99_ms']!r}"
            "; explain_degraded=0, answers within tolerance of predict")


def wait_for(cond, limit_s, what):
    t = time.perf_counter()
    while not cond():
        assert time.perf_counter() - t < limit_s, f"{what}: timed out"
        time.sleep(0.005)
    return time.perf_counter() - t


def serving_faults(bst, Xp):
    """(d): the failure path under ``faults.inject`` on the card."""
    from lightgbm_tpu_torch.robustness import faults
    from lightgbm_tpu_torch.robustness.retry import RetryPolicy
    rows = Xp[:FAULT_ROWS]
    want = bst.predict(rows, device=True, raw_score=True)
    host = bst.predict(rows, raw_score=True)
    out = {}
    with bst.serve(linger_ms=1.0, raw_score=True,
                   probe_interval_s=SERVE_PROBE_S) as srv:
        with faults.inject("dispatch_error:p=1:n=2"):
            np.testing.assert_array_equal(srv.predict(rows, timeout=60),
                                          want)
        assert srv.counters.get("dispatch_retries") == 2
        with faults.inject("oom:n=1"):
            np.testing.assert_array_equal(srv.predict(rows, timeout=60),
                                          want)
        out["oom_bisects"] = srv.counters.get("oom_bisects")
        assert out["oom_bisects"] >= 1
        v0 = srv.generation.version
        with faults.inject("publish_fail"):
            try:
                srv.publish()
                raise AssertionError("publish_fail did not fail the publish")
            except faults.FaultInjected:
                pass
        assert srv.generation.version == v0
        assert srv.counters.get("publish_failures") == 1
        np.testing.assert_array_equal(srv.predict(rows, timeout=60), want)
        assert_clean(srv, "dispatch_error, oom and publish_fail")
    policy = RetryPolicy(max_attempts=2, base_delay=0.001, max_delay=0.01,
                         deadline=2.0)
    with bst.serve(linger_ms=1.0, raw_score=True, retry_policy=policy,
                   probe_interval_s=SERVE_PROBE_S) as srv:
        t = time.perf_counter()
        with faults.inject("dispatch_error:p=1:n=2"):
            got = srv.predict(rows, timeout=60)
        np.testing.assert_array_equal(got, host)
        assert srv.counters.get("dispatch_failures") == 1
        assert srv.counters.get("degraded_batches") == 1
        wait_for(lambda: srv.counters.get("recoveries") == 1, 30,
                 "recovery")
        out["recover_s"] = time.perf_counter() - t
        np.testing.assert_array_equal(srv.predict(rows, timeout=60), want)
    bst.config.set("tpu_integrity_probe_interval_s", INTEGRITY_INTERVAL_S)
    try:
        with bst.serve(linger_ms=1.0, raw_score=True,
                       probe_interval_s=SERVE_PROBE_S) as srv:
            y0 = srv.predict(rows, timeout=60)
            np.testing.assert_array_equal(y0, want)
            t = time.perf_counter()
            with faults.inject("bitflip:p=1:where=dev"):
                v1 = srv.publish().version
            out["detect_s"] = wait_for(
                lambda: srv.counters.get("integrity_mismatches") >= 1, 30,
                "detection")
            out["repair_s"] = out["detect_s"] + wait_for(
                lambda: srv.generation.version > v1, 30, "repair")
            wait_for(lambda: srv.counters.get("repairs") >= 1
                     and not srv.stats()["degraded"], 30, "un-quarantine")
            out["unquarantine_s"] = time.perf_counter() - t
            snap = srv.counters.snapshot()
            assert snap["integrity_mismatches"] == 1, snap
            assert snap["quarantines"] == 1 and snap["repairs"] == 1, snap
            np.testing.assert_array_equal(srv.predict(rows, timeout=60), y0)
    finally:
        bst.config.set("tpu_integrity_probe_interval_s", 0.0)
    log(f"phase 19 (d) failure path: dispatch_error x2 retried (answers "
        f"bit-equal); oom x1 bisected (oom_bisects={out['oom_bisects']}, "
        "bit-equal, not degraded); publish_fail: the old generation kept "
        "serving at the same version; retry budget exhausted: degraded, "
        f"host-walk answers equal the host predict bit for bit, recovered "
        f"after recover_s={out['recover_s']!r} (probe every "
        f"{SERVE_PROBE_S} s); bitflip:where=dev with the canary every "
        f"{INTEGRITY_INTERVAL_S} s: detect_s={out['detect_s']!r} "
        f"repair_s={out['repair_s']!r} "
        f"unquarantine_s={out['unquarantine_s']!r}, then the pre-rot "
        "answers bit for bit")


def serving_raw_route(bst, ds, Xp):
    """(e): a ``booster_from_arrays`` copy of the same trees (no bin
    mappers: the raw route), served."""
    from lightgbm_tpu_torch.convert import TREE_FIELDS as CARRY, \
        booster_from_arrays
    raw_bst = booster_from_arrays(
        bench_params(), [{f: getattr(t, f) for f in CARRY}
                         for t in bst._engine.models],
        ds.binned.bin_mappers, ds.binned.used_feature_map)
    want = raw_bst.predict(Xp, device=True, raw_score=True)
    assert raw_bst._engine._serving.raw_pack.count == len(
        raw_bst._engine.models)
    with raw_bst.serve(linger_ms=SERVE_LINGER_MS, raw_score=True) as srv:
        assert srv._raw_route
        srv.predict(Xp[:SERVE_MAX_ROWS], timeout=60)          # warm
        starts = list(range(0, len(Xp), SERVE_MAX_ROWS))
        t = time.perf_counter()
        futs = [srv.submit(Xp[s:s + SERVE_MAX_ROWS]) for s in starts]
        got = [f.result(300) for f in futs]
        wall_s = time.perf_counter() - t
        for s, g in zip(starts, got):
            np.testing.assert_array_equal(g, want[s:s + SERVE_MAX_ROWS])
        st = assert_clean(srv, "raw route")
    log(f"phase 19 (e) raw route: rows={len(Xp)} requests={len(starts)} "
        f"wall_s={wall_s!r} rows_per_s={len(Xp) / wall_s!r} "
        f"batches={st['batches']}; answers equal its predict(device=True) "
        "bit for bit")


def phase_serving(bst, ds, X):
    """Phase 19: the model server and device TreeSHAP on phase 4's booster
    and phase 7's rows. Returns the launch counts of the run (K1 from the
    hot-swap's updates)."""
    t0 = time.perf_counter()
    Xp = np.asarray(X[:PREDICT_ROWS], np.float64)
    n_trees = len(bst._engine.models)
    reset_counts()
    serving_traffic(bst, Xp)
    counts = read_counts()
    new = bst._engine.models[n_trees:]
    assert len(new) == SERVE_SWAPS, len(new)
    assert counts["hist_rowmajor_f32"] == sum(t.num_leaves for t in new), \
        counts
    assert sum(counts.values()) == counts["hist_rowmajor_f32"], counts
    log(f"phase 19 (a)+(b) done at {time.perf_counter() - t0:.1f} s; "
        f"launches={nonzero(counts)}")
    serving_shap(bst, Xp)
    log(f"phase 19 (c) done at {time.perf_counter() - t0:.1f} s")
    serving_faults(bst, Xp)
    log(f"phase 19 (d) done at {time.perf_counter() - t0:.1f} s")
    serving_raw_route(bst, ds, Xp)
    log(f"phase 19 seconds={time.perf_counter() - t0!r}")
    return counts


# phase 20: the multi-tenant fleet at the JAX package's own fleet
# benchmark (scripts/serving_load.py --fleet 100): binary tenants over four
# (leaves, trees, F) archetypes, each trained on 3,000 rows by the label
# rule of serving_load.py:530-533. FLEET_TRAINED of them are trained on the
# card; the others are boosters of their own over a trained tenant's
# Dataset (its bin mappers) and a copy of its tree list.
FLEET_TENANTS = 100
FLEET_ARCHETYPES = ((31, 20, 28), (15, 12, 12), (63, 16, 20), (15, 24, 12))
FLEET_ROWS = 3_000
FLEET_TRAINED = 20
FLEET_CLIENTS = 8
FLEET_REQUESTS = 2_000          # (a): requests in all
FLEET_REQ_ROWS = 32             # serving_load.py's rows_per_request
FLEET_LINGER_MS = 2.0
FLEET_SWAPS = 2                 # (b): update() + publish() of one tenant
FLEET_SWAP_TENANT = "t001"
FLEET_BUDGET_SHARE = 0.5        # (c): the memory budget / the pack bytes
FLEET_BUDGET_REQUESTS = 400
FLEET_PROFILE_REQUESTS = 8      # one coalesced batch of one bucket
FLEET_PROBE_S = 0.1             # (e): the canary's interval


def fleet_params(leaves=None, **extra):
    """A tenant's params (a loaded tenant's: its device alone)."""
    p = {"device_type": bench_params()["device_type"]}
    if leaves is not None:
        p.update(objective="binary", num_leaves=leaves, verbose=-1)
    return dict(p, **extra)


def fleet_label(X, i):
    """serving_load.py:530-533's label of tenant ``i``."""
    return (X[:, 0] * (1 + 0.1 * (i % 7)) + 0.5 * X[:, 1] ** 2
            > 0.4).astype(np.float32)


def fleet_tenants():
    """``(tenants, pools)``: every tenant's booster and its request pool
    (its training rows): FLEET_TRAINED trained, the rest of the
    FLEET_TENANTS over their Datasets, one loaded model a archetype
    (``raw<a>``, the raw route), and an in-memory categorical tenant
    (``cat``) beside the numeric one it shares a bucket with (``num``):
    archetype 1 at ``max_depth=4`` on the same rows, column 11 read as
    categories by ``cat`` only."""
    import lightgbm_tpu_torch as lgt
    rng = np.random.default_rng(0)
    by_f = {f: np.ascontiguousarray(rng.normal(size=(FLEET_ROWS, f))
                                    .astype(np.float32).astype(np.float64))
            for f in sorted({a[2] for a in FLEET_ARCHETYPES})}
    tenants, pools = {}, {}
    t = time.perf_counter()
    for i in range(FLEET_TRAINED):
        leaves, trees, f = FLEET_ARCHETYPES[i % len(FLEET_ARCHETYPES)]
        tenants[f"t{i:03d}"] = lgt.train(
            fleet_params(leaves),
            lgt.Dataset(by_f[f], label=fleet_label(by_f[f], i)),
            num_boost_round=trees, keep_training_booster=True)
        pools[f"t{i:03d}"] = by_f[f]
    train_s = time.perf_counter() - t
    t = time.perf_counter()
    for i in range(FLEET_TRAINED, FLEET_TENANTS):
        src = f"t{i % FLEET_TRAINED:03d}"
        leaves = FLEET_ARCHETYPES[i % len(FLEET_ARCHETYPES)][0]
        c = lgt.Booster(fleet_params(leaves), tenants[src].train_set)
        c._engine.models = list(tenants[src]._engine.models)
        tenants[f"t{i:03d}"], pools[f"t{i:03d}"] = c, pools[src]
    copy_s = time.perf_counter() - t
    for a in range(len(FLEET_ARCHETYPES)):
        tenants[f"raw{a}"] = lgt.Booster(
            fleet_params(), model_str=tenants[f"t{a:03d}"].model_to_string())
        pools[f"raw{a}"] = pools[f"t{a:03d}"]
    leaves, trees, f = FLEET_ARCHETYPES[1]
    Xc = by_f[f].copy()
    Xc[:, f - 1] = rng.integers(0, 8, size=FLEET_ROWS)
    y = fleet_label(Xc, 1) + (Xc[:, f - 1] % 3 == 1)
    y = (y > 0).astype(np.float32)
    for name, cat in (("cat", [f - 1]), ("num", "auto")):
        tenants[name] = lgt.train(
            fleet_params(leaves, max_depth=4),
            lgt.Dataset(Xc, label=y, categorical_feature=cat),
            num_boost_round=trees, keep_training_booster=True)
        pools[name] = Xc
    assert any(t.num_cat > 0 for t in tenants["cat"]._engine.models)
    log(f"phase 20 tenants: {len(tenants)} ({FLEET_TRAINED} trained on the "
        f"card in {train_s!r} s, {FLEET_TENANTS - FLEET_TRAINED} over their "
        f"Datasets in {copy_s!r} s (cut: the JAX benchmark trains all "
        f"{FLEET_TENANTS}), {len(FLEET_ARCHETYPES)} loaded (raw route), one "
        "categorical and its numeric bucket-mate)")
    return tenants, pools


def fleet_refs(tenants, pools):
    """Each tenant's ``predict(device=True, raw_score=True)`` of its
    whole pool (generation 1)."""
    return {k: b.predict(pools[k], device=True, raw_score=True)
            for k, b in tenants.items()}


def fleet_clients(fleet, pools, names, n_requests, seed, on_half=None):
    """``FLEET_CLIENTS`` closed-loop clients sending ``n_requests`` of
    ``FLEET_REQ_ROWS`` rows in all, each to a uniformly drawn tenant of
    ``names``; returns each client's ``(name, start, generation, values,
    t_enq, t_done)`` records. ``on_half`` is set once half of them are
    answered."""
    records = [[] for _ in range(FLEET_CLIENTS)]
    n_each = -(-n_requests // FLEET_CLIENTS)

    def client(ci):
        rng = np.random.default_rng(seed + ci)
        for _ in range(n_each):
            name = names[int(rng.integers(len(names)))]
            s = int(rng.integers(0, FLEET_ROWS - FLEET_REQ_ROWS + 1))
            f = fleet.submit(name, pools[name][s:s + FLEET_REQ_ROWS])
            v = f.result(300)
            records[ci].append((name, s, f.generation, v, f.t_enq,
                                f.t_done))
            if on_half is not None and \
                    sum(map(len, records)) >= n_requests // 2:
                on_half.set()

    serve_threads(client, FLEET_CLIENTS)
    return records


def check_fleet_records(records, refs, swap_refs=None, swap=None):
    """Every response equals its tenant's ``predict(device=True)`` of the
    generation it names, bit for bit; versions monotonic per client."""
    for recs in records:
        versions = [g.version for name, _, g, _, _, _ in recs
                    if name == swap]
        assert versions == sorted(versions), versions
        for name, s, g, v, _, _ in recs:
            if name == swap:
                ref = swap_refs[g.version]
            else:
                assert g.version == 1, (name, g)
                ref = refs[name]
            np.testing.assert_array_equal(
                v, ref[s:s + FLEET_REQ_ROWS],
                err_msg=f"tenant {name} generation {g.version}")


def fleet_profile(fleet, pools):
    """Device kernels and device ms of one coalesced batch of one bucket
    (the bucket with the most tenants, FLEET_PROFILE_REQUESTS requests of
    as many of its tenants) under ``torch.profiler``, and the host ms of
    the call; one scorer call serves it."""
    from torch.profiler import ProfilerActivity, profile
    from lightgbm_tpu_torch.ops import forest
    from lightgbm_tpu_torch.serving.fleet import _CanaryReq
    state = fleet._state
    b = max(state.buckets.values(), key=lambda x: len(x.members))
    items = []
    for j in range(FLEET_PROFILE_REQUESTS):
        m = b.members[j % len(b.members)]
        X = pools[m][j * FLEET_REQ_ROWS:(j + 1) * FLEET_REQ_ROWS]
        items.append((j, _CanaryReq(len(X), X, m), state.routes[m]))
    fleet._group_scores(b, items)                      # warm
    calls = []
    run = {"binned": "_fleet_scores_binned", "raw": "_fleet_scores_raw"}[
        b.key.kind]
    scorer = getattr(forest, run)

    def counted(*a):
        calls.append(1)
        return scorer(*a)
    setattr(forest, run, counted)
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fleet._group_scores(b, items)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fleet._group_scores(b, items)
            torch.cuda.synchronize()
    finally:
        setattr(forest, run, scorer)
    assert len(calls) == 2, calls
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    # the bytes: each requested tenant's window read once, the operand
    # (int32 bins or f32 values), lo and n_live, the f32 scores written
    windows = {r.tenant for _, r, _ in items}
    per_slot = forest.pytree_nbytes(b.host) // (b.slot_cap * b.key.win_slots)
    R = sum(r.n for _, r, _ in items)
    nbytes = (len(windows) * b.key.win_slots * per_slot
              + R * (b.key.feat_cap * 4 + 16 + b.key.k * 4))
    bound_ms, bound_by = bound(nbytes, R * b.key.win_slots * b.key.steps)
    return dict(members=len(b.members),
                tenants=len({r.tenant for _, r, _ in items}),
                kind=b.key.kind, win_slots=b.key.win_slots,
                steps=b.key.steps, host_ms=host_ms,
                kernels=sum(e.count for e in on_device),
                device_ms=sum(e.self_device_time_total
                              for e in on_device) / 1e3,
                bound_ms=bound_ms, bound_by=bound_by)


def fleet_traffic(fleet, tenants, pools, refs):
    """(a) and (b): the traffic, with FLEET_SWAPS update() + publish() of
    FLEET_SWAP_TENANT from the half-way point."""
    import threading
    from lightgbm_tpu_torch.serving import latency_summary_ms
    half, swapped = threading.Event(), threading.Event()
    swaps = []
    bst = tenants[FLEET_SWAP_TENANT]

    def trainer():
        half.wait(300)
        for _ in range(FLEET_SWAPS):
            t = time.perf_counter()
            assert not bst.update()
            tp = time.perf_counter()
            info = fleet.publish(FLEET_SWAP_TENANT)
            swaps.append(dict(start=t, end=time.perf_counter(),
                              update_s=tp - t,
                              publish_ms=(time.perf_counter() - tp) * 1e3,
                              version=info.version,
                              num_trees=info.num_trees))
        swapped.set()

    tr = threading.Thread(target=trainer, daemon=True)
    tr.start()
    t = time.perf_counter()
    records = fleet_clients(fleet, pools, sorted(tenants), FLEET_REQUESTS,
                            2000, on_half=half)
    wall_s = time.perf_counter() - t
    tr.join(300)
    assert swapped.is_set() and len(swaps) == FLEET_SWAPS, swaps
    st = assert_clean(fleet, "fleet traffic")
    gens = {g.version: g for recs in records
            for name, _, g, _, _, _ in recs if name == FLEET_SWAP_TENANT}
    swap_refs = {v: bst.predict(pools[FLEET_SWAP_TENANT], device=True,
                                raw_score=True, num_iteration=g.num_trees)
                 for v, g in gens.items()}
    check_fleet_records(records, refs, swap_refs, FLEET_SWAP_TENANT)
    lat = [td - te for recs in records for *_, te, td in recs]
    during = [td - te for recs in records for *_, te, td in recs
              if any(te < w["end"] and td > w["start"] for w in swaps)]
    calm = [td - te for recs in records for *_, te, td in recs
            if td < swaps[0]["start"]]
    t_first = min(te for recs in records for *_, te, _ in recs)
    calm_s = swaps[0]["start"] - t_first
    n_req = sum(len(r) for r in records)
    summ, calm_lat = latency_summary_ms(lat), latency_summary_ms(calm)
    log(f"phase 20 (a) fleet traffic: tenants={st['n_tenants']} buckets="
        f"{st['n_buckets']} pack_bytes={st['pack_bytes']} clients="
        f"{FLEET_CLIENTS} requests={n_req} rows={n_req * FLEET_REQ_ROWS} "
        f"wall_s={wall_s!r} requests_per_s={n_req / wall_s!r} rows_per_s="
        f"{n_req * FLEET_REQ_ROWS / wall_s!r} p50_ms={summ['p50_ms']!r} "
        f"p99_ms={summ['p99_ms']!r} max_ms={summ['max_ms']!r}; steady "
        f"(before the first swap): requests={len(calm)} requests_per_s="
        f"{len(calm) / calm_s!r} p50_ms={calm_lat['p50_ms']!r} p99_ms="
        f"{calm_lat['p99_ms']!r}; batches={st['batches']} "
        f"mean_requests_per_batch={st.get('mean_requests_per_batch')!r} "
        f"max_coalesced={st['max_coalesced']} linger_ms={FLEET_LINGER_MS}; "
        "every response equals its tenant's predict(device=True) of its "
        "generation bit for bit")
    log(f"phase 20 (b) hot-swap of {FLEET_SWAP_TENANT}: swaps="
        f"{[{k: v for k, v in w.items() if k not in ('start', 'end')} for w in swaps]} "
        f"p99_ms_during_swaps={latency_summary_ms(during)['p99_ms']!r} (of "
        f"{len(during)}); versions monotonic, every other tenant at "
        "generation 1 with its answers unchanged")


def fleet_budget(tenants, pools, refs, pack_bytes):
    """(c): the same tenants under a memory budget of FLEET_BUDGET_SHARE
    of their pack bytes: evictions and rebuilds, every answer bit-equal."""
    import lightgbm_tpu_torch as lgt
    budget_mb = pack_bytes * FLEET_BUDGET_SHARE / 1e6
    names = sorted(tenants)
    with lgt.serve_fleet(tenants, raw_score=True, linger_ms=FLEET_LINGER_MS,
                         mem_budget_mb=budget_mb) as fleet:
        t = time.perf_counter()
        records = fleet_clients(fleet, pools, names, FLEET_BUDGET_REQUESTS,
                                2100)
        wall_s = time.perf_counter() - t
        check_fleet_records(records, refs)
        st = assert_clean(fleet, "memory budget")
        assert st["evictions"] >= 1 and st["rebuilds"] >= 1, st
        assert st["resident_pack_bytes"] <= budget_mb * 1e6, st
    log(f"phase 20 (c) memory budget {budget_mb!r} MB ({FLEET_BUDGET_SHARE} "
        f"of {pack_bytes} pack bytes): requests={FLEET_BUDGET_REQUESTS} "
        f"requests_per_s={FLEET_BUDGET_REQUESTS / wall_s!r} evictions="
        f"{st['evictions']} rebuilds={st['rebuilds']} resident_pack_bytes="
        f"{st['resident_pack_bytes']} p99_ms={st['p99_ms']!r}; every answer "
        "bit-equal")


def fleet_explain(fleet, tenants, pools, names):
    """(d): ``fleet.explain`` of two tenants against their own device
    ``pred_contrib``: the first explain of a bucket packs every member's
    paths, a second one finds them packed."""
    out = {}
    for name in names:
        X = pools[name][:4 * FLEET_REQ_ROWS]
        want = tenants[name].predict(X, pred_contrib=True, device=True)
        for call in ("first_ms", "packed_ms"):
            t = time.perf_counter()
            got = fleet.explain(name, X, timeout=300)
            out[(name, call)] = (time.perf_counter() - t) * 1e3
            np.testing.assert_array_equal(
                got, want, err_msg=f"fleet explain of {name}")
    assert fleet.counters.get("explain_degraded") == 0
    # the bound of one explain of len(X) rows over the bucket's paths
    # (every member's, packed together), as shap_bound counts them
    bounds = {}
    for name in names:
        packed = [m.paths for m in
                  fleet._shap_cache[fleet._state.routes[name].key].host
                  if m is not None]
        paths = sum(int(p.gfeat.shape[0]) for p in packed)
        depth = max(int(p.gfeat.shape[1]) for p in packed)
        bounds[name] = (paths, depth) + shap_bound(
            paths, depth, fleet._tenants[name].n_features + 1, len(X))
    log(f"phase 20 (d) explain: {len(X)} rows of {names} (members of "
        f"their buckets: {[len(fleet._state.buckets[fleet._state.routes[n].key].members) for n in names]}), "
        f"ms={ {f'{n} {c}': v for (n, c), v in out.items()} }; each equals "
        "its own predict(pred_contrib=True, device=True) array for array; "
        f"(bucket paths, depth, bound_ms, bound_by)={bounds}")


def fleet_faults(fleet, tenants, pools, refs):
    """(e): ``publish_fail`` and ``oom`` on the traffic's fleet, then the
    canaries on a fleet of two tenants of one bucket."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.robustness import faults, integrity
    name = "t005"
    X = pools[name][:FLEET_REQ_ROWS]
    v0 = fleet.tenant_stats(name)["generation"]
    with faults.inject("publish_fail"):
        try:
            fleet.publish(name)
            raise AssertionError("publish_fail did not fail the publish")
        except faults.FaultInjected:
            pass
    assert fleet.tenant_stats(name)["generation"] == v0
    np.testing.assert_array_equal(fleet.predict(name, X, timeout=60),
                                  refs[name][:FLEET_REQ_ROWS])
    # oom once on a coalesced pair of one bucket (a tenant and its copy),
    # queued behind a wedged dispatch
    a, b = "t006", f"t{6 + FLEET_TRAINED:03d}"
    assert fleet._state.routes[a].key == fleet._state.routes[b].key
    bisects = fleet.counters.get("oom_bisects")
    with faults.inject("slow_dispatch:sec=0.3:n=1,oom:after=1:n=1"):
        wedge = fleet.submit("t007", pools["t007"][:FLEET_REQ_ROWS])
        wait_for(lambda: fleet.stats()["queued_rows"] == 0, 30, "wedge")
        time.sleep(0.05)
        fa = fleet.submit(a, pools[a][:FLEET_REQ_ROWS])
        fb = fleet.submit(b, pools[b][FLEET_REQ_ROWS:2 * FLEET_REQ_ROWS])
        wedge.result(60)
        np.testing.assert_array_equal(fa.result(60),
                                      refs[a][:FLEET_REQ_ROWS])
        np.testing.assert_array_equal(
            fb.result(60), refs[b][FLEET_REQ_ROWS:2 * FLEET_REQ_ROWS])
    assert fleet.counters.get("oom_bisects") == bisects + 1
    assert_clean(fleet, "publish_fail and oom")
    out = {}
    # the canaries: "a" is the bucket's slot 0, where bitflip rots
    a, b = "t004", f"t{4 + FLEET_TRAINED:03d}"
    cfg = tenants[a].config.copy()
    cfg.set("tpu_integrity_probe_interval_s", FLEET_PROBE_S)
    Xa, Xb = pools[a][:FLEET_REQ_ROWS], pools[b][:FLEET_REQ_ROWS]
    with lgt.serve_fleet({"a": tenants[a], "b": tenants[b]}, raw_score=True,
                         config=cfg, linger_ms=1.0) as ifleet:
        ya0 = ifleet.predict("a", Xa, timeout=60)
        np.testing.assert_array_equal(ya0, refs[a][:FLEET_REQ_ROWS])
        assert ifleet.evict("a")
        t = time.perf_counter()
        with faults.inject("bitflip:p=1:where=dev"):
            np.testing.assert_allclose(ifleet.predict("a", Xa, timeout=60),
                                       ya0, rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(ifleet.predict("b", Xb,
                                                         timeout=60),
                                          refs[b][:FLEET_REQ_ROWS])
        # the counts only grow, so the probe's repair cannot race them
        assert ifleet.counters.get_tenant("a", "quarantines") == 1
        assert ifleet.counters.get("quarantines") == 1
        wait_for(lambda: ifleet.counters.get("repairs") >= 1
                 and "quarantined" not in ifleet.stats(), 30, "repair")
        out["dev_repair_s"] = time.perf_counter() - t
        np.testing.assert_array_equal(ifleet.predict("a", Xa, timeout=60),
                                      ya0)
        assert ifleet.counters.get_tenant("b", "quarantines") == 0
        # host rot: the kept host pack rots in place; the rebuild after an
        # eviction finds its CRC changed and rebuilds from the windows
        bucket = ifleet._state.buckets[ifleet._state.routes["a"].key]
        bucket.host.leaf_value[0] = -bucket.host.leaf_value[0]
        mism = ifleet.counters.get("integrity_mismatches")
        assert ifleet.evict("a")
        t = time.perf_counter()
        np.testing.assert_array_equal(ifleet.predict("a", Xa, timeout=60),
                                      ya0)
        out["host_rebuild_s"] = time.perf_counter() - t
        assert ifleet.counters.get("integrity_mismatches") == mism + 1
        assert ifleet.counters.get("quarantines") == 1
        # bitflip:where=host at a publish: the anchor refuses the pack
        tenants[a].update()
        with faults.inject("bitflip:p=1:where=host"):
            try:
                ifleet.publish("a")
                raise AssertionError("a corrupt publish was not refused")
            except integrity.CanaryMismatch:
                pass
        assert ifleet.tenant_stats("a")["generation"] == 1
        np.testing.assert_array_equal(ifleet.predict("a", Xa, timeout=60),
                                      ya0)
        assert ifleet.publish("a").version == 2
        np.testing.assert_array_equal(
            ifleet.predict("a", Xa, timeout=60),
            tenants[a].predict(Xa, device=True, raw_score=True))
        snap = ifleet.counters.snapshot()
    log(f"phase 20 (e) faults: publish_fail on {name}: still generation "
        f"{v0}, answers bit-equal; oom once on a coalesced pair: bisected, "
        "bit-equal, not degraded; bitflip:where=dev with the canary every "
        f"{FLEET_PROBE_S} s: only tenant a quarantined, repaired and "
        f"un-quarantined after dev_repair_s={out['dev_repair_s']!r}; host "
        f"rot caught by the host pack's CRC and rebuilt in host_rebuild_s="
        f"{out['host_rebuild_s']!r}; bitflip:where=host at a publish refused "
        f"by the anchor, generation 1 served on; counters={snap}")


def fleet_model_shard(tenants, pools, refs):
    """(f): ``tpu_serving_fleet_shard=model`` over a two-entry mesh of the
    one card: every bucket on one owner, the same bits."""
    import lightgbm_tpu_torch as lgt
    dev = torch.device(bench_params()["device_type"])
    names = [f"t{i:03d}" for i in range(FLEET_TRAINED)] + \
        ["raw0", "cat", "num"]
    with lgt.serve_fleet({k: tenants[k] for k in names}, raw_score=True,
                         devices=[dev, dev], fleet_shard="model",
                         linger_ms=FLEET_LINGER_MS) as fleet:
        st = fleet.stats()
        assert st["fleet_shard"] == "model", st
        owners = {b.owner for b in fleet._state.buckets.values()}
        assert owners == {0, 1}, owners
        futs = {k: fleet.submit(k, pools[k][:FLEET_REQ_ROWS]) for k in names}
        for k, f in futs.items():
            np.testing.assert_array_equal(f.result(60),
                                          refs[k][:FLEET_REQ_ROWS])
    log(f"phase 20 (f) model shard: {len(names)} tenants in "
        f"{st['n_buckets']} buckets over owners {sorted(owners)} of a "
        "two-entry mesh of the one card; every answer bit-equal")


def phase_fleet():
    """Phase 20: the multi-tenant fleet (``lgt.serve_fleet``). Returns the
    launch counts of the phase (K1: the tenants' training and the
    hot-swap's updates)."""
    import lightgbm_tpu_torch as lgt
    t0 = time.perf_counter()
    reset_counts()
    tenants, pools = fleet_tenants()
    refs = fleet_refs(tenants, pools)
    log(f"phase 20 tenants and references ready at "
        f"{time.perf_counter() - t0:.1f} s")
    t = time.perf_counter()
    fleet = lgt.serve_fleet(tenants, raw_score=True,
                            linger_ms=FLEET_LINGER_MS)
    try:
        build_s = time.perf_counter() - t
        routes = fleet._state.routes
        assert routes["cat"].key == routes["num"].key, \
            (routes["cat"].key, routes["num"].key)
        assert routes["raw0"].key.kind == "raw"
        prof = fleet_profile(fleet, pools)
        log(f"phase 20 fleet built in {build_s!r} s; one coalesced batch of "
            f"one bucket: {prof} (one scorer call)")
        fleet_traffic(fleet, tenants, pools, refs)
        fleet_explain(fleet, tenants, pools, ["t000", "t002"])
        fleet_faults(fleet, tenants, pools, refs)
        pack_bytes = fleet.stats()["pack_bytes"]
    finally:
        fleet.close()
    # (b) and (e) trained these two further
    refs.update(fleet_refs({k: tenants[k] for k in (FLEET_SWAP_TENANT,
                                                     "t004")}, pools))
    log(f"phase 20 (a)-(b), (d)-(e) done at {time.perf_counter() - t0:.1f} s")
    fleet_budget(tenants, pools, refs, pack_bytes)
    fleet_model_shard(tenants, pools, refs)
    counts = read_counts()
    assert counts["hist_rowmajor_f32"] > 0, counts
    log(f"phase 20 seconds={time.perf_counter() - t0!r}; launches="
        f"{nonzero(counts)}")
    return counts


# phase 21: the continual service at the Higgs width, on the bench params.
# (a) two-round loading: LIVE_FILE_ROWS rows to a CSV; LIVE_CROSS_ROWS
# rows to another for the cuda-against-cpu cross-check
LIVE_FILE_ROWS = 200_000
LIVE_CROSS_ROWS = 20_000
LIVE_DECIMALS = 4               # the stream's text: exact doubles back
LIVE_TWO_ROUND_ITERS = 2        # timed, after one warm-up
# (b) the JAX package's scripts/serving_load.py --live topology: a
# supervised child trainer on a growing stream, one injected crash
LIVE_STREAM_ROWS = 4_096
LIVE_WINDOW = 8_192             # tpu_service_window_rows' default
LIVE_MIN_ROWS = 2_048
LIVE_ITERS_PER_CYCLE = 2
LIVE_PUBLISH_EVERY = 2
LIVE_KEEP_LAST = 256            # nothing a response names is pruned
LIVE_POLL_S = 0.1
LIVE_APPEND_ROWS = 400          # the producer: this many rows ...
LIVE_APPEND_EVERY_S = 0.15      # ... this often
LIVE_KILL = "rank_kill:rank=0:after=5"
LIVE_CLIENTS = 16               # open-loop Poisson clients ...
LIVE_RATE = 200.0               # ... at this many requests/s in all
LIVE_REQ_ROWS = 32              # rows a request, npy f64 on the wire
LIVE_DURATION_S = 20.0
LIVE_AFTER_RELAUNCH_S = 60.0    # the wait for 2 generations after it
LIVE_BOOT_S = 600.0
# (c) the same service, its trainer on a thread of this process
LIVE_THREAD_PUBLISHES = 3
LIVE_THREAD_CLIENTS = 4
LIVE_THREAD_LIMIT_S = 120.0


def live_rows(n, seed):
    """``[n, 1 + N_FEATURES]`` rows ``label, features`` of synth_higgs's
    distribution, rounded to LIVE_DECIMALS places: the text written with
    as many decimals parses back to the same doubles."""
    X, y = synth_higgs(n, N_FEATURES, seed=seed)
    return np.round(np.column_stack([y, X]).astype(np.float64),
                    LIVE_DECIMALS)


def live_probe(seed):
    """A request's LIVE_REQ_ROWS rows: f32 values held as f64, as the
    raw route of a loaded model takes them."""
    return synth_higgs(LIVE_REQ_ROWS, N_FEATURES, seed=seed)[0].astype(
        np.float64)


def write_rows(path, block, mode="a"):
    """Whole lines in one write (the stream follower's contract)."""
    import io
    buf = io.StringIO()
    np.savetxt(buf, block, delimiter=",", fmt=f"%.{LIVE_DECIMALS}f")
    with open(path, mode) as fh:
        fh.write(buf.getvalue())


def live_two_round(tmp, phase4_iter_s):
    """(a): ``Dataset(path, params={"two_round": True})`` of a
    LIVE_FILE_ROWS-row CSV: each round's host seconds; the bins equal the
    rows binned in memory with the loader's mappers; 1 + 2 iterations
    (logloss falls); a LIVE_CROSS_ROWS-row two-round file trained on the
    card and on the CPU gives the same trees to the binary standard."""
    import os
    import lightgbm_tpu_torch as lgt
    block = live_rows(LIVE_FILE_ROWS, seed=21)
    path = os.path.join(tmp, "higgs.csv")
    t = time.perf_counter()
    write_rows(path, block, "w")
    write_s = time.perf_counter() - t
    params = bench_params(two_round=True)
    t = time.perf_counter()
    ds = lgt.Dataset(path, params=params).construct()
    load_s = time.perf_counter() - t
    b, st = ds.binned, ds.binned.ingest_stats
    n = LIVE_FILE_ROWS
    log(f"phase 21 (a) two-round load of {n} x {N_FEATURES} "
        f"({os.path.getsize(path)} bytes, written in {write_s!r} s): "
        f"{load_s!r} s in all; round 1 {st['round1_s']!r} s "
        f"({n / st['round1_s']!r} rows/s), bin finding "
        f"{st['find_bins_s']!r} s, round 2 {st['round2_s']!r} s "
        f"({n / st['round2_s']!r} rows/s)")
    X = block[:, 1:]
    assert b.num_data == n and b.bins.shape == (n, len(b.used_feature_map))
    for i, f in enumerate(b.used_feature_map):
        np.testing.assert_array_equal(
            b.bins[:, i], b.bin_mappers[f].value_to_bin(X[:, f]),
            err_msg=f"phase 21 (a) feature {f}")
    np.testing.assert_array_equal(b.metadata.label,
                                  block[:, 0].astype(np.float32))
    bst = lgt.Booster(params, ds)
    assert not bst.update()
    first = dict((m, v) for _, m, v, _ in bst.eval_train())
    iter_s = []
    for _ in range(LIVE_TWO_ROUND_ITERS):
        t = time.perf_counter()
        assert not bst.update()
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t)
    last = dict((m, v) for _, m, v, _ in bst.eval_train())
    assert last["binary_logloss"] < first["binary_logloss"], (first, last)
    log(f"phase 21 (a) bins equal the in-memory rows binned with the "
        f"loader's mappers; iter_s={iter_s!r} (phase 4: "
        f"{phase4_iter_s!r} s at {N_ROWS} rows) logloss "
        f"{first['binary_logloss']!r} -> {last['binary_logloss']!r}")
    del bst, ds, b
    small = live_rows(LIVE_CROSS_ROWS, seed=22)
    spath = os.path.join(tmp, "higgs_small.csv")
    write_rows(spath, small, "w")
    out = {}
    t = time.perf_counter()
    for dev in ("cuda", "cpu"):
        p = bench_params(two_round=True, device_type=dev)
        out[dev] = lgt.train(p, lgt.Dataset(spath, params=p),
                             num_boost_round=2)
    assert_trees_to_binary_standard(
        out["cuda"], out["cpu"], small[:, 1:],
        [np.ones(LIVE_CROSS_ROWS, bool)] * 2, 0.1, 1.0, 0.25,
        "phase 21 (a) two-round cross-check")
    log(f"phase 21 (a) {LIVE_CROSS_ROWS}-row two-round file: cuda and cpu "
        f"trees to the binary standard ({time.perf_counter() - t!r} s)")


class LiveProducer:
    """Appends LIVE_APPEND_ROWS rows to the stream every
    LIVE_APPEND_EVERY_S seconds on a thread, from a pool made up front."""

    def __init__(self, path, seed):
        import threading
        self.path = path
        self.pool = live_rows(LIVE_APPEND_ROWS * 64, seed=seed)
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        i = 0
        while not self.stop.wait(LIVE_APPEND_EVERY_S):
            lo = (i % 64) * LIVE_APPEND_ROWS
            write_rows(self.path, self.pool[lo:lo + LIVE_APPEND_ROWS])
            i += 1

    def close(self):
        self.stop.set()
        self.thread.join(10)


def live_post(url, payload):
    """One npy request: ``(generation, scores, staleness_ms)``; the
    staleness is None where the gateway knows no watermark."""
    import io
    import urllib.request
    req = urllib.request.Request(
        url, data=payload, headers={"Content-Type": "application/x-npy"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        out = np.load(io.BytesIO(resp.read()), allow_pickle=False)
        stale = resp.headers.get("X-Staleness-Ms")
        return (int(resp.headers["X-Model-Generation"]), out,
                None if stale is None else float(stale))


def server_side(stats):
    """The server's own view of a run: its batches, the requests a batch
    coalesced and its latency from ``submit`` to the answer (the HTTP
    layer's time is outside it)."""
    return (f"server side: batches={stats['batches']} "
            f"mean_requests_per_batch={stats.get('mean_requests_per_batch')}"
            f" max_coalesced={stats['max_coalesced']} "
            f"p50_ms={stats.get('p50_ms')!r} p99_ms={stats.get('p99_ms')!r}")


def live_verify(svc, probe, responses, failures):
    """The JAX package's scripts/_service_gate.verify_responses on the
    port: every ``(client, generation, scores, staleness_ms)`` response
    equals its generation's checkpointed model by ``predict(device=True,
    raw_score=True)`` or by the host walk, generations monotone per
    client, staleness not negative; a response whose checkpoint is gone
    is unverifiable. Returns ``(torn, unverifiable)``."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.robustness.checkpoint import (list_checkpoints,
                                                          read_checkpoint)
    by_iter = {it: read_checkpoint(p)["model"]
               for it, p in list_checkpoints(svc.ckpt_dir)}
    expected, last = {}, {}
    torn = unverifiable = 0
    for ci, v, out, stale in responses:
        if v < last.get(ci, 0):
            failures.append(f"client {ci} saw generations move backwards")
        last[ci] = max(last.get(ci, 0), v)
        if stale is None or stale < 0:
            failures.append(f"a response's staleness is {stale}")
        mark = svc.freshness(v)
        model = by_iter.get(mark["iteration"]) if mark else None
        if model is None:
            unverifiable += 1
            continue
        if v not in expected:
            # loaded on the bench device
            b = lgt.Booster(params=fleet_params(), model_str=model)
            expected[v] = (b.predict(probe, device=True, raw_score=True),
                           b.predict(probe, raw_score=True))
        dev, host = expected[v]
        if not (np.array_equal(out, dev) or np.array_equal(out, host)):
            torn += 1
    if torn:
        failures.append(f"{torn} torn response(s)")
    return torn, unverifiable


def checkpoint_gaps(ckpt_dir):
    """Seconds between consecutive checkpoints (one a cycle), by their
    files' times."""
    import os
    from lightgbm_tpu_torch.robustness.checkpoint import list_checkpoints
    times = sorted(os.path.getmtime(p) for _, p in
                   list_checkpoints(ckpt_dir))
    return [b - a for a, b in zip(times, times[1:])]


def live_service(tmp, stream, mode, **kw):
    import os
    import lightgbm_tpu_torch as lgt
    write_rows(stream, live_rows(LIVE_STREAM_ROWS, seed=23), "w")
    return lgt.serve_continual(
        bench_params(), stream, os.path.join(tmp, f"ck_{mode}"),
        trainer_mode=mode, window_rows=LIVE_WINDOW, min_rows=LIVE_MIN_ROWS,
        iters_per_cycle=LIVE_ITERS_PER_CYCLE,
        publish_every_iters=LIVE_PUBLISH_EVERY, target_iterations=0,
        raw_score=True, boot_timeout_s=LIVE_BOOT_S, poll_sec=LIVE_POLL_S,
        keep_last=LIVE_KEEP_LAST, **kw)


def live_supervised(tmp, smi):
    """(b): serve_continual with a supervised child trainer on the card,
    LIVE_KILL on its attempt 0, a producer and LIVE_CLIENTS open-loop
    Poisson clients for LIVE_DURATION_S; then up to LIVE_AFTER_RELAUNCH_S
    for two generations after the relaunch. Returns the latencies' p99
    ms."""
    import io
    import os
    import random
    import threading
    from lightgbm_tpu_torch.serving.metrics import (latency_summary_ms,
                                                    percentile)
    stream = os.path.join(tmp, "stream_b.csv")
    t = time.perf_counter()
    svc = live_service(tmp, stream, "process", attempt_env=lambda i: (
        {"LGBM_TPU_FAULTS": LIVE_KILL} if i == 0
        else {"LGBM_TPU_FAULTS": ""}))
    boot_s = time.perf_counter() - t
    producer = LiveProducer(stream, seed=24)
    try:
        url = svc.frontdoor.address + "/v1/predict"
        probe = live_probe(seed=25)
        buf = io.BytesIO()
        np.save(buf, probe, allow_pickle=False)
        payload = buf.getvalue()
        lock = threading.Lock()
        responses, hard = [], []

        def client(ci):
            r = random.Random(500 + ci)
            rate = LIVE_RATE / LIVE_CLIENTS
            t0 = next_t = time.perf_counter()
            while True:
                next_t += r.expovariate(rate)
                if next_t - t0 > LIVE_DURATION_S:
                    return
                now = time.perf_counter()
                if next_t > now:
                    time.sleep(next_t - now)
                try:
                    v, out, stale = live_post(url, payload)
                    with lock:
                        responses.append((ci, v, out, stale,
                                          time.perf_counter() - next_t))
                except Exception as e:   # noqa: BLE001 - a gate below
                    with lock:
                        hard.append(repr(e))

        clients = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(LIVE_CLIENTS)]
        seen_at = seen_gen = first_after = None
        t_wall = time.perf_counter()
        for c in clients:
            c.start()

        def watch():
            nonlocal seen_at, seen_gen, first_after
            v = svc.generation.version
            if seen_at is None and svc.trainer.relaunches:
                seen_at, seen_gen = time.perf_counter(), v
            if seen_at is not None and first_after is None and \
                    v > seen_gen:
                first_after = time.perf_counter()
        while any(c.is_alive() for c in clients):
            watch()
            time.sleep(0.05)
        wall = time.perf_counter() - t_wall
        t_end = time.perf_counter() + LIVE_AFTER_RELAUNCH_S
        while time.perf_counter() < t_end:
            watch()
            if seen_gen is not None and \
                    svc.generation.version >= seen_gen + 2:
                break
            time.sleep(0.05)
        stats = svc.stats()
        final_gen = svc.generation.version
        trainer = svc.trainer.describe()
        failures = []
        torn, unverifiable = live_verify(
            svc, probe, [r[:4] for r in responses], failures)
        served = sorted({r[1] for r in responses})
        if hard:
            failures.append(f"{len(hard)} hard client error(s): "
                            f"{hard[:2]}")
        if not responses:
            failures.append("no responses")
        if unverifiable > len(responses) // 2:
            failures.append(f"{unverifiable}/{len(responses)} "
                            "unverifiable")
        if not all(1 <= v <= final_gen and svc.freshness(v) is not None
                   for v in served):
            failures.append(f"served versions {served} outside "
                            f"1..{final_gen} or without a watermark")
        if trainer.get("relaunches", 0) < 1:
            failures.append(f"the injected crash never relaunched: "
                            f"{trainer}")
        if seen_gen is None or final_gen < seen_gen + 2:
            failures.append(f"fewer than 2 generations after the "
                            f"relaunch (at it v{seen_gen}, final "
                            f"v{final_gen})")
        if stats["service"]["publish_errors"]:
            failures.append(f"{stats['service']['publish_errors']} "
                            "publish error(s)")
        lat = latency_summary_ms([r[4] for r in responses])
        stale = [r[3] for r in responses if r[3] is not None]
        gaps = checkpoint_gaps(svc.ckpt_dir)
        relaunch_s = None if first_after is None else first_after - seen_at
        cycle_s = statistics.median(gaps) if gaps else None
        log(f"phase 21 (b) supervised child trainer on the card: "
            f"boot_s={boot_s!r} requests={len(responses)} "
            f"requests_per_s={len(responses) / wall!r} "
            f"p50_ms={lat['p50_ms']!r} p99_ms={lat['p99_ms']!r} "
            f"p999_ms={lat['p999_ms']!r} "
            f"staleness_p50_ms={percentile(stale, 50)!r} "
            f"staleness_p99_ms={percentile(stale, 99)!r} "
            f"staleness_max_ms={max(stale, default=float('nan'))!r} "
            f"relaunch_s={relaunch_s!r} "
            f"(the supervisor's sight of the death to the first publish "
            f"after it) publishes={stats['service']['publishes']} "
            f"generations_served={served[:1]}..{served[-1:]} "
            f"final_generation={final_gen} "
            f"served_iteration={stats['service']['served_iteration']} "
            f"trainer_s_per_cycle={cycle_s!r} "
            f"(median of {len(gaps)} checkpoint gaps) torn={torn} "
            f"unverifiable={unverifiable} trainer={trainer}; "
            f"{server_side(stats)} card={smi}")
        assert not failures, failures
        return lat["p99_ms"]
    finally:
        producer.close()
        svc.close()


def live_thread(tmp, p99_b, smi):
    """(c): the same service with its trainer on a thread of this
    process, for LIVE_THREAD_PUBLISHES publishes after the boot, under
    LIVE_THREAD_CLIENTS closed-loop clients; every response verified."""
    import io
    import os
    import threading
    from lightgbm_tpu_torch.serving.metrics import latency_summary_ms
    stream = os.path.join(tmp, "stream_c.csv")
    t = time.perf_counter()
    svc = live_service(tmp, stream, "thread")
    boot_s = time.perf_counter() - t
    producer = LiveProducer(stream, seed=26)
    try:
        url = svc.frontdoor.address + "/v1/predict"
        probe = live_probe(seed=27)
        buf = io.BytesIO()
        np.save(buf, probe, allow_pickle=False)
        payload = buf.getvalue()
        target = svc.stats()["service"]["publishes"] + LIVE_THREAD_PUBLISHES
        done = threading.Event()
        lock = threading.Lock()
        responses, lat, hard = [], [], []

        def client(ci):
            try:
                while not done.is_set():
                    t0 = time.perf_counter()
                    v, out, stale = live_post(url, payload)
                    with lock:
                        lat.append(time.perf_counter() - t0)
                        responses.append((ci, v, out, stale))
            except Exception as e:      # noqa: BLE001 - a gate below
                hard.append(repr(e))
        clients = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(LIVE_THREAD_CLIENTS)]
        t_wall = time.perf_counter()
        for c in clients:
            c.start()
        wait_for(lambda: svc.stats()["service"]["publishes"] >= target
                 or svc.trainer.error is not None or bool(hard),
                 LIVE_THREAD_LIMIT_S, "phase 21 (c) publishes")
        done.set()
        for c in clients:
            c.join(60)
        wall = time.perf_counter() - t_wall
        assert svc.trainer.error is None, svc.trainer.describe()
        assert not hard, hard
        failures = []
        torn, unverifiable = live_verify(svc, probe, responses, failures)
        s = latency_summary_ms(lat)
        log(f"phase 21 (c) thread trainer: boot_s={boot_s!r} "
            f"requests={len(responses)} "
            f"requests_per_s={len(responses) / wall!r} "
            f"p50_ms={s['p50_ms']!r} p99_ms={s['p99_ms']!r} (closed "
            f"loop; (b)'s open-loop p99 {p99_b!r} ms: the trainer shares "
            f"this process's GIL here) "
            f"publishes={svc.stats()['service']['publishes']} "
            f"served_iteration={svc.stats()['service']['served_iteration']}"
            f" torn={torn} unverifiable={unverifiable}; "
            f"{server_side(svc.stats())} card={smi}")
        assert not failures and unverifiable == 0, failures
        assert svc.generation.model_gen == 0, svc.generation
    finally:
        producer.close()
        svc.close()


def live_expect(url, code, body, headers, what, seen):
    """POST ``body``; the answer must be HTTP ``code`` (added to
    ``seen``). Returns the error response."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=body, headers=headers)
    try:
        urllib.request.urlopen(req, timeout=60)
    except urllib.error.HTTPError as e:
        assert e.code == code, (what, e.code, e.read())
        seen.append(code)
        return e
    raise AssertionError(f"phase 21 (d) {what}: expected HTTP {code}")


def live_frontdoor(smi):
    """(d): two of phase 20's archetypes, trained small, behind
    ``ServerGateway(None, fleet=...)``: tenant routes bit for bit each
    tenant's ``predict(device=True)``; 400, 404, 413, 429 and 504 as the
    tests expect; ``/readyz`` 503 while a tenant is quarantined by
    ``bitflip:p=1:where=dev``, ``/healthz`` 200."""
    import io
    import json
    import urllib.error
    import urllib.request
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.robustness import faults
    from lightgbm_tpu_torch.service import FrontDoor, ServerGateway
    rng = np.random.default_rng(28)
    tenants, pools = {}, {}
    for a in (0, 1):
        leaves, trees, f = FLEET_ARCHETYPES[a]
        X = rng.normal(size=(FLEET_ROWS, f)).astype(np.float32).astype(
            np.float64)
        tenants[f"a{a}"] = lgt.train(
            fleet_params(leaves), lgt.Dataset(X, label=fleet_label(X, a)),
            num_boost_round=trees)
        pools[f"a{a}"] = X
    cfg = tenants["a0"].config.copy()
    cfg.set("tpu_integrity_probe_interval_s", 600.0)
    fleet = lgt.serve_fleet(tenants, raw_score=True, config=cfg,
                            linger_ms=FLEET_LINGER_MS)
    door = FrontDoor(ServerGateway(None, fleet=fleet), chunk_rows=64,
                     max_body_mb=1.0)
    codes = []

    def npy(X):
        buf = io.BytesIO()
        np.save(buf, X, allow_pickle=False)
        return buf.getvalue()
    try:
        base = door.address + "/v1/tenants/"
        for name, bst in tenants.items():
            X = pools[name][:200]                  # chunked: > 64 rows
            _, out, _ = live_post(base + f"{name}/predict", npy(X))
            np.testing.assert_array_equal(
                out, bst.predict(X, device=True, raw_score=True),
                err_msg=f"phase 21 (d) tenant {name}")
        X8 = pools["a0"][:8]
        npy_h = {"Content-Type": "application/x-npy"}
        live_expect(base + "a0/predict", 400, b"{not json",
                    {"Content-Type": "application/json"}, "bad JSON", codes)
        live_expect(base + "a0/predict", 400, npy(pools["a1"][:4]), npy_h,
                    "wrong width", codes)
        live_expect(base + "nope/predict", 404, npy(X8), npy_h,
                    "unknown tenant", codes)
        live_expect(door.address + "/v1/predict", 404, npy(X8), npy_h,
                    "no solo server", codes)
        big = b"x" * (door.max_body_bytes + 1)
        live_expect(base + "a0/predict", 413, big, npy_h, "oversize", codes)
        # 504: the dispatcher wedged, the deadline passes in the queue
        with faults.inject("slow_dispatch:sec=0.6:n=1"):
            slow = fleet.submit("a0", X8)
            wait_for(lambda: not fleet.stats()["queued_rows"], 5,
                     "phase 21 (d) wedge")
            time.sleep(0.05)
            e = live_expect(base + "a0/predict", 504, npy(X8),
                            dict(npy_h, **{"X-Deadline-Ms": "40"}),
                            "deadline", codes)
            assert "DEADLINE_EXCEEDED" in json.loads(e.read())["error"]
            slow.result(60)
        # 429: the dispatcher wedged and the queue full
        orig = fleet._batcher.max_queue_rows
        fleet._batcher.max_queue_rows = len(X8)
        try:
            with faults.inject("slow_dispatch:sec=0.5:n=1"):
                slow = fleet.submit("a0", X8)
                wait_for(lambda: not fleet.stats()["queued_rows"], 5,
                         "phase 21 (d) wedge")
                time.sleep(0.05)
                backlog = fleet.submit("a0", X8)
                e = live_expect(base + "a0/predict", 429, npy(X8), npy_h,
                                "overload", codes)
                assert e.headers.get("Retry-After") is not None
                slow.result(60)
                backlog.result(60)
        finally:
            fleet._batcher.max_queue_rows = orig
        r = urllib.request.urlopen(door.address + "/readyz", timeout=30)
        assert json.loads(r.read()) == {"ready": True, "status": "ok"}
        assert fleet.evict("a0")
        with faults.inject("bitflip:p=1:where=dev"):
            fleet.predict("a0", pools["a0"][:32])
        assert fleet.tenant_stats("a0")["quarantined"]
        e = None
        try:
            urllib.request.urlopen(door.address + "/readyz", timeout=30)
        except urllib.error.HTTPError as err:
            e = err
        assert e is not None and e.code == 503, "phase 21 (d) readyz"
        assert json.loads(e.read()) == {"ready": False,
                                        "status": "quarantined",
                                        "quarantined": ["a0"]}
        r = urllib.request.urlopen(door.address + "/healthz", timeout=30)
        assert r.status == 200
        log(f"phase 21 (d) front door over a two-tenant fleet on the card: "
            f"tenant routes bit for bit predict(device=True); failure map "
            f"{sorted(codes)}; /readyz 503 while a0 is quarantined, "
            f"/healthz 200; card={smi}")
    finally:
        door.close()
        fleet.close()


def phase_live(phase4_iter_s):
    """Phase 21: the continual service (``lgt.serve_continual``), (a)-(d).
    Returns the launch counts of the phases run in this process ((a)'s
    training, (c)'s thread trainer and (d)'s tenants); (b)'s child
    trainer launches K1 in its own process (logged, not counted)."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_live_")
    totals = {}

    def add(counts, what):
        log(f"phase 21 {what} launches={nonzero(counts)} at "
            f"{time.perf_counter() - t0:.1f} s")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    try:
        reset_counts()
        live_two_round(tmp, phase4_iter_s)
        add(read_counts(), "(a)")
        reset_counts()
        p99_b = live_supervised(tmp, smi)
        add(read_counts(), "(b) (this process: serving only)")
        reset_counts()
        live_thread(tmp, p99_b, smi)
        c = read_counts()
        assert c["hist_rowmajor_f32"] > 0, c
        add(c, "(c)")
        reset_counts()
        live_frontdoor(smi)
        add(read_counts(), "(d)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 21 seconds={time.perf_counter() - t0!r}")
    return totals


SHELL_ROWS = 200_000            # phase 4's first rows, at its 28 features
SHELL_VALID_ROWS = 20_000       # (a)'s valid file: the rows after them
SHELL_ITERS = 5
SHELL_CHILD_ITERS = 2
SHELL_CODEGEN_ROWS = 20_000
SHELL_NUMPY_ROWS = 20_000
SHELL_C_ROWS = 100_000
SHELL_C_ITERS = 3
SHELL_SHAP_ROWS = 2_000
SHELL_ARROW_ROWS = 20_000
# phase 21 (a)'s numpy parser, round 2 and round 1 (PR 22's runs), and PR
# 12's numpy TreeSHAP: what (d) and (f) print beside their own
PR22_NUMPY_ROWS_S = (84_096, 115_669)
PR12_SHAP_ROWS_S = (2_300, 2_550)
# where every entry point of phase 22 trains without being told: the card
SHELL_DEVICE = "cuda"

# (e): a C host of the training ABI. It builds a SHELL_C_ROWS x
# N_FEATURES matrix, trains on the device its parameters name (none: the
# card), saves the model, and holds the training handle's scores (the
# host walk, f64) against the serving ABI's over the saved file
_C_HOST_SRC = r"""
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <time.h>
#include "lgbm_c_api.h"

#define CHECK(call) do { if ((call) != 0) { \
  fprintf(stderr, "FAIL %s: %s\n", #call, LGBM_GetLastError()); \
  return 1; } } while (0)

static double now(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec + 1e-9 * t.tv_nsec;
}

static uint64_t state = 88172645463325252ULL;
static double uniform(void) {
  state ^= state << 13; state ^= state >> 7; state ^= state << 17;
  return (state >> 11) * (1.0 / 9007199254740992.0);
}

int main(int argc, char** argv) {
  const int n = atoi(argv[1]), f = atoi(argv[2]), iters = atoi(argv[3]);
  const char* model = argv[4];
  double* X = malloc(sizeof(double) * (size_t)n * f);
  float* y = malloc(sizeof(float) * n);
  for (int i = 0; i < n; ++i) {
    double* row = X + (size_t)i * f;
    for (int j = 0; j < f; ++j)
      row[j] = uniform() + uniform() + uniform() - 1.5;
    y[i] = row[0] - 0.5 * row[1] * row[2] + 0.25 * row[3] * row[3] +
           0.1 * (uniform() - 0.5) > 0.05 ? 1.0f : 0.0f;
  }
  void* ds = NULL;
  CHECK(LGBM_DatasetCreateFromMat(X, 1, n, f, 1, "max_bin=255", NULL, &ds));
  CHECK(LGBM_DatasetSetField(ds, "label", y, n, 0));
  void* bst = NULL;
  CHECK(LGBM_BoosterCreate(ds, "objective=binary num_leaves=255 "
                           "learning_rate=0.1 min_data_in_leaf=20 "
                           "verbosity=-1", &bst));
  int finished = 0;
  for (int it = 0; it < iters; ++it) {
    double t = now();
    CHECK(LGBM_BoosterUpdateOneIter(bst, &finished));
    printf("C-HOST iter %d s=%.6f\n", it, now() - t);
  }
  CHECK(LGBM_BoosterSaveModel(bst, 0, -1, 0, model));
  int64_t len = 0;
  double* p_train = malloc(sizeof(double) * n);
  double* p_serve = malloc(sizeof(double) * n);
  CHECK(LGBM_BoosterPredictForMat(bst, X, 1, n, f, 1, 1, 0, -1, "", &len,
                                  p_train));
  void* srv = NULL;
  int n_iter = 0;
  CHECK(LGBM_BoosterCreateFromModelfile(model, &n_iter, &srv));
  CHECK(LGBM_BoosterPredictForMat(srv, X, 1, n, f, 1, 1, 0, -1, "", &len,
                                  p_serve));
  double worst = 0.0, spread = 0.0;
  for (int i = 0; i < n; ++i) {
    double d = fabs(p_train[i] - p_serve[i]) / (1.0 + fabs(p_serve[i]));
    if (d > worst) worst = d;
    spread += fabs(p_serve[i]);
  }
  printf("C-HOST iterations=%d rows=%lld max_rel_diff=%.3g "
         "mean_abs_score=%.6f\n", n_iter, (long long)len, worst,
         spread / n);
  if (n_iter != iters || len != n || worst > 1e-12 || !(spread > 0)) {
    fprintf(stderr, "FAIL serving scores\n");
    return 1;
  }
  CHECK(LGBM_BoosterFree(srv));
  CHECK(LGBM_BoosterFree(bst));
  CHECK(LGBM_DatasetFree(ds));
  printf("C-HOST-OK\n");
  fflush(stdout);
  return 0;
}
"""


def shell_params():
    """Phase 4's bench parameters as CLI ``key=value`` arguments, with no
    ``device_type``: the CLI's default, the card."""
    return ["objective=binary", f"num_leaves={NUM_LEAVES}",
            f"max_bin={MAX_BIN}", "learning_rate=0.1", "min_data_in_leaf=20",
            "metric=binary_logloss,auc"]


def shell_cli_train(path, vpath, tmp, phase4_iter_s):
    """(a): ``cli.run`` trains SHELL_ITERS iterations on the file with a
    valid file, ``metric_freq=1`` and ``snapshot_freq=2``; ``lgt.train``
    on the same file and params gives the same trees."""
    import os
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import cli
    model = os.path.join(tmp, "model.txt")
    stamps = []
    lgt.register_logger(lambda m: stamps.append((time.perf_counter(), m)))
    t = time.perf_counter()
    try:
        rc = cli.run(["task=train", f"data={path}", f"valid={vpath}",
                      *shell_params(), f"num_iterations={SHELL_ITERS}",
                      "metric_freq=1", "snapshot_freq=2",
                      "snapshot_keep_last=1", "verbosity=1",
                      f"output_model={model}"])
        torch.cuda.synchronize()
    finally:
        lgt.register_logger(None)
    cli_s = time.perf_counter() - t
    counts = read_counts()
    assert rc == 0, [m for _, m in stamps][-5:]
    ends = [s for s, m in stamps if m.split("\t", 1)[0].endswith("]")
            and "valid_1's binary_logloss" in m]
    assert len(ends) == SHELL_ITERS, [m for _, m in stamps]
    iter_s = [float(d) for d in np.diff(ends)]
    snaps = sorted(f for f in os.listdir(tmp) if ".snapshot_iter_" in f)
    assert snaps == [f"model.txt.snapshot_iter_{SHELL_ITERS - 1}"], snaps
    launches = counts["hist_rowmajor_f32"]
    assert launches > 0 and sum(counts.values()) == launches, counts

    # the same file and params through the Python API, in this process
    params = {"objective": "binary", "num_leaves": NUM_LEAVES,
              "max_bin": MAX_BIN, "learning_rate": 0.1,
              "min_data_in_leaf": 20, "verbose": -1}
    t = time.perf_counter()
    ds = lgt.Dataset(path, params=params).construct()
    load_bin_s = time.perf_counter() - t
    ref = lgt.train(params, ds, num_boost_round=SHELL_ITERS)
    got = lgt.Booster(model_file=model)
    want = lgt.Booster(model_str=ref.model_to_string())
    assert len(got._engine.models) == len(want._engine.models) == \
        SHELL_ITERS
    for i, (a, b) in enumerate(zip(got._engine.models,
                                   want._engine.models)):
        np.testing.assert_array_equal(a.split_feature, b.split_feature,
                                      err_msg=f"phase 22 (a) tree {i}")
        np.testing.assert_array_equal(a.threshold_real, b.threshold_real,
                                      err_msg=f"phase 22 (a) tree {i}")
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   err_msg=f"phase 22 (a) tree {i}")
    with open(model) as fh:
        assert f"[device_type: {SHELL_DEVICE}]" in fh.read()
    log(f"phase 22 (a) cli.run task=train {SHELL_ROWS} x {N_FEATURES} "
        f"with a {SHELL_VALID_ROWS}-row valid file: {cli_s!r} s in all; "
        f"iter_s={iter_s!r} (median "
        f"{statistics.median(iter_s)!r}; phase 4: {phase4_iter_s!r} s at "
        f"{N_ROWS} rows, no valid set); file load + binning "
        f"{load_bin_s!r} s; K1 launches {launches}; snapshots {snaps} "
        "(pruned to the last); trees equal lgt.train's on the same file "
        "(splits and thresholds exactly, leaf values within rtol 1e-5)")
    return model, ref


def spawn(argv, tmp, name, **kw):
    """Start a child with its output in files under ``tmp``."""
    import os
    files = [open(os.path.join(tmp, f"{name}.{s}"), "w")
             for s in ("out", "err")]
    return {"proc": subprocess.Popen(argv, stdout=files[0],
                                     stderr=files[1], **kw),
            "t0": time.perf_counter(), "files": files}


def reap(child, timeout=300):
    """Wait for a child: ``(returncode, stdout, stderr, wall seconds)``
    from its start."""
    rc = child["proc"].wait(timeout)
    wall = time.perf_counter() - child["t0"]
    texts = []
    for fh in child["files"]:
        fh.close()
        with open(fh.name) as r:
            texts.append(r.read())
    return rc, texts[0], texts[1], wall


def shell_conf(tmp, task, lines):
    """A conf file of ``key = value`` lines, as the R shim writes them."""
    import os
    conf = os.path.join(tmp, f"{task}.conf")
    with open(conf, "w") as fh:
        fh.write("".join(ln.replace("=", " = ", 1) + "\n"
                         for ln in [f"task={task}", *lines, "verbosity=1"]))
    return conf


def shell_module_child(tmp, conf, name):
    """``python -m lightgbm_tpu_torch config=...``: no ``device_type``."""
    import os
    return spawn([sys.executable, "-m", "lightgbm_tpu_torch",
                  f"config={conf}"], tmp, name,
                 cwd=os.path.dirname(os.path.abspath(__file__)))


def shell_module_check(walls, warnings, model, result, X_file):
    """(b)'s gates: the child's model names the card and has its trees;
    the result file is the parent's ``Booster.predict`` written ``%g``,
    line for line."""
    import lightgbm_tpu_torch as lgt
    with open(model) as fh:
        assert f"[device_type: {SHELL_DEVICE}]" in fh.read()
    bst = lgt.Booster(model_file=model)
    assert bst.num_trees() == SHELL_CHILD_ITERS
    pred = bst.predict(X_file)
    with open(result) as fh:
        assert fh.read() == "".join(f"{v:g}\n" for v in pred), \
            "phase 22 (b) result file"
    log(f"phase 22 (b) python -m lightgbm_tpu_torch config=...: train "
        f"({SHELL_CHILD_ITERS} iterations, no device_type: the model says "
        f"[device_type: {SHELL_DEVICE}]) {walls['train']!r} s wall, "
        f"predict {walls['predict']!r} s wall (each beside (a) and the "
        f"other children); the result file is the parent's predict "
        f"written %g, line for line ({len(pred)} lines); the children's "
        f"warnings: {warnings[:3]}")


def shell_convert_model(model, tmp, X_file):
    """(c): ``task=convert_model`` of (a)'s model compiles with ``g++``
    and gives the host walk's raw scores within 1e-12."""
    import os
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import cli
    src = os.path.join(tmp, "model.cpp")
    assert cli.run(["task=convert_model", f"input_model={model}",
                    f"convert_model={src}", "verbosity=-1"]) == 0
    main_src = os.path.join(tmp, "model_main.cpp")
    with open(main_src, "w") as fh:
        fh.write('#include <cstdio>\n#include "model.cpp"\n'
                 "int main() {\n"
                 f"  double row[{N_FEATURES}], out[1];\n"
                 f"  while (fread(row, sizeof(double), {N_FEATURES}, "
                 f"stdin) == {N_FEATURES}) {{\n"
                 "    lightgbm_tpu_model::PredictRaw(row, out);\n"
                 "    fwrite(out, sizeof(double), 1, stdout);\n"
                 "  }\n  return 0;\n}\n")
    exe = os.path.join(tmp, "model_exe")
    t = time.perf_counter()
    subprocess.run(["g++", "-O1", "-o", exe, main_src], check=True,
                   capture_output=True, timeout=300, cwd=tmp)
    compile_s = time.perf_counter() - t
    Xc = np.ascontiguousarray(X_file[:SHELL_CODEGEN_ROWS], np.float64)
    t = time.perf_counter()
    out = subprocess.run([exe], input=Xc.tobytes(), capture_output=True,
                         timeout=300, check=True).stdout
    run_s = time.perf_counter() - t
    got = np.frombuffer(out, np.float64)
    want = lgt.Booster(model_file=model).predict(Xc, raw_score=True,
                                                 device=False)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    log(f"phase 22 (c) convert_model: {os.path.getsize(src)} bytes of C++ "
        f"for {SHELL_ITERS} trees, g++ -O1 {compile_s!r} s; "
        f"{SHELL_CODEGEN_ROWS} rows in {run_s!r} s; raw scores equal the "
        "host walk within 1e-12")


def shell_parser(path):
    """(d): the C++ parser over the whole file, the numpy body over a
    slice (equal arrays there), then the two-round loader's rounds.
    Returns the file's features as parsed."""
    from lightgbm_tpu_torch import native
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.stream_loader import load_binned_two_round
    with open(path, "rb") as fh:
        data = fh.read()
    n_cols = native.count_cols(data, ",")
    assert n_cols == 1 + N_FEATURES, n_cols
    t = time.perf_counter()
    full = native.parse_dense_chunk(data, ",", n_cols)
    cpp_s = time.perf_counter() - t
    assert full.shape == (SHELL_ROWS, n_cols)
    cut = 0
    for _ in range(SHELL_NUMPY_ROWS):
        cut = data.index(b"\n", cut) + 1
    t = time.perf_counter()
    part = native.parse_dense_numpy(data[:cut], ",", n_cols)
    np_s = time.perf_counter() - t
    np.testing.assert_array_equal(
        native.parse_dense_chunk(data[:cut], ",", n_cols), part)
    np.testing.assert_array_equal(full[:SHELL_NUMPY_ROWS], part)
    params = bench_params(two_round=True)
    t = time.perf_counter()
    b = load_binned_two_round(path, Config(params))
    load_s = time.perf_counter() - t
    st = b.ingest_stats
    assert b.num_data == SHELL_ROWS
    r1, r2 = SHELL_ROWS / st["round1_s"], SHELL_ROWS / st["round2_s"]
    log(f"phase 22 (d) native parser ({len(data)} bytes): C++ "
        f"{SHELL_ROWS / cpp_s!r} rows/s, numpy {SHELL_NUMPY_ROWS / np_s!r} "
        f"rows/s on a {SHELL_NUMPY_ROWS}-row slice (equal arrays, NaNs in "
        f"the same places); two-round load {load_s!r} s: round 1 {r1!r} "
        f"rows/s, bin finding {st['find_bins_s']!r} s, round 2 {r2!r} "
        f"rows/s (phase 21 (a) with the numpy parser, PR 22: "
        f"{PR22_NUMPY_ROWS_S[0]:,}-{PR22_NUMPY_ROWS_S[1]:,})")
    return full[:, 1:]


def shell_c_host_start(tmp):
    """(e): the C host above, compiled with ``gcc`` against the port's
    library and started; it embeds the interpreter and trains on the
    card."""
    import os
    import sysconfig
    from lightgbm_tpu_torch import native
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(tmp, "c_host.c")
    with open(src, "w") as fh:
        fh.write(_C_HOST_SRC)
    exe = os.path.join(tmp, "c_host")
    subprocess.run(["gcc", "-O1", "-I",
                    os.path.join(here, "lightgbm_tpu_torch", "native"), src,
                    native.library_path(), "-lm", "-o", exe], check=True,
                   capture_output=True, timeout=120)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (sysconfig.get_paths()["purelib"],
                    env.get("PYTHONPATH", "")) if p)
    env["LGBM_TPU_LIBPYTHON"] = os.path.join(
        sysconfig.get_config_var("LIBDIR") or "",
        sysconfig.get_config_var("LDLIBRARY") or "")
    model = os.path.join(tmp, "c_host_model.txt")
    return spawn([exe, str(SHELL_C_ROWS), str(N_FEATURES),
                  str(SHELL_C_ITERS), model], tmp, "c_host", env=env), \
        model, env["LGBM_TPU_LIBPYTHON"]


def shell_c_host_check(child, model, libpython):
    rc, out, err, wall = reap(child)
    assert rc == 0 and "C-HOST-OK" in out, (rc, out[-2000:], err[-3000:])
    iter_s = [float(ln.split("s=")[1]) for ln in out.splitlines()
              if ln.startswith("C-HOST iter ")]
    with open(model) as fh:
        assert f"[device_type: {SHELL_DEVICE}]" in fh.read()
    summary = [ln for ln in out.splitlines()
               if ln.startswith("C-HOST iterations")][0]
    log(f"phase 22 (e) a C host (gcc, LGBM_TPU_LIBPYTHON={libpython}) "
        f"trained {SHELL_C_ROWS} x {N_FEATURES}, {NUM_LEAVES} leaves on "
        f"the card: iter_s={iter_s!r} (the first builds the booster's "
        f"state), {wall!r} s wall (beside the in-process parts); the "
        f"training handle's "
        f"host walk against the serving ABI over the saved file: "
        f"{summary[len('C-HOST '):]} (its K1 launches are its own "
        "process's, not counted)")


def shell_tree_shap(model, ref, X_file):
    """(f): ``pred_contrib`` of (a)'s model through the C++ kernel against
    the device TreeSHAP of the same trees."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import native
    Xs = np.ascontiguousarray(X_file[:SHELL_SHAP_ROWS], np.float64)
    bst = lgt.Booster(model_file=model)
    bst.predict(Xs[:10], pred_contrib=True)
    t = time.perf_counter()
    cpp = bst.predict(Xs, pred_contrib=True)
    cpp_s = time.perf_counter() - t
    assert native.get_lib() is not None
    ref.predict(Xs[:10], pred_contrib=True, device=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    dev = ref.predict(Xs, pred_contrib=True, device=True)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t
    assert ref._engine._serving.shap_pack is not None, "no device TreeSHAP"
    np.testing.assert_allclose(cpp, dev, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cpp.sum(axis=1),
                               bst.predict(Xs, raw_score=True), rtol=1e-9,
                               atol=1e-9)
    log(f"phase 22 (f) TreeSHAP of {SHELL_SHAP_ROWS} rows, {SHELL_ITERS} "
        f"trees: the C++ kernel {SHELL_SHAP_ROWS / cpp_s!r} rows/s, the "
        f"device {SHELL_SHAP_ROWS / dev_s!r} rows/s (PR 12's numpy walk "
        f"{PR12_SHAP_ROWS_S[0]:,}-{PR12_SHAP_ROWS_S[1]:,}); within rtol "
        "1e-4 / atol 1e-5 of each other")


def shell_arrow(X_file, y):
    """(g): the Arrow ABI in this process: a table of SHELL_ARROW_ROWS
    rows through ``LGBM_DatasetCreateFromArrow`` and
    ``LGBM_DatasetSetFieldFromArrow``, 2 iterations on the card (no
    ``device_type``), ``LGBM_BoosterPredictForArrow`` against
    ``LGBM_BoosterPredictForMat`` on the same handle."""
    import ctypes
    import pyarrow as pa
    from lightgbm_tpu_torch import native
    lib = native.get_lib()
    n = SHELL_ARROW_ROWS
    Xa = np.ascontiguousarray(X_file[:n])

    def export(batch):
        # ArrowArray 88 B, ArrowSchema 72 B on LP64; pyarrow fills them
        arr, sch = (ctypes.create_string_buffer(k) for k in (88, 72))
        batch._export_to_c(ctypes.addressof(arr), ctypes.addressof(sch))
        return arr, sch

    lib.LGBM_GetLastError.restype = ctypes.c_char_p

    def ok(rc, what):
        assert rc == 0, (what, lib.LGBM_GetLastError())
    t = time.perf_counter()
    arr, sch = export(pa.record_batch(
        [pa.array(Xa[:, j]) for j in range(Xa.shape[1])],
        names=[f"f{j}" for j in range(Xa.shape[1])]))
    ds, bst = ctypes.c_void_p(), ctypes.c_void_p()
    ok(lib.LGBM_DatasetCreateFromArrow(
        ctypes.c_int64(1), ctypes.c_void_p(ctypes.addressof(arr)),
        ctypes.c_void_p(ctypes.addressof(sch)), f"max_bin={MAX_BIN}".encode(),
        None, ctypes.byref(ds)), "DatasetCreateFromArrow")
    la, ls = export(pa.record_batch([pa.array(y[:n].astype(np.float32))],
                                    names=["y"]))
    ok(lib.LGBM_DatasetSetFieldFromArrow(
        ds, b"label", ctypes.c_int64(1), ctypes.c_void_p(ctypes.addressof(la)),
        ctypes.c_void_p(ctypes.addressof(ls))), "SetFieldFromArrow")
    ok(lib.LGBM_BoosterCreate(
        ds, " ".join([p for p in shell_params() if "metric" not in p]
                     + ["verbosity=-1"]).encode(),
        ctypes.byref(bst)), "BoosterCreate")
    fin = ctypes.c_int(0)
    for _ in range(SHELL_CHILD_ITERS):
        ok(lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)), "Update")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    out_len = ctypes.c_int64(0)
    by_mat, by_arrow = np.zeros(n), np.zeros(n)
    ok(lib.LGBM_BoosterPredictForMat(
        bst, Xa.ctypes.data_as(ctypes.c_void_p), 1, n, Xa.shape[1], 1, 1, 0,
        -1, b"", ctypes.byref(out_len),
        by_mat.ctypes.data_as(ctypes.POINTER(ctypes.c_double))), "ForMat")
    ok(lib.LGBM_BoosterPredictForArrow(
        bst, ctypes.c_int64(1), ctypes.c_void_p(ctypes.addressof(arr)),
        ctypes.c_void_p(ctypes.addressof(sch)), 1, 0, -1, b"",
        ctypes.byref(out_len),
        by_arrow.ctypes.data_as(ctypes.POINTER(ctypes.c_double))),
        "ForArrow")
    np.testing.assert_array_equal(by_arrow, by_mat)
    assert np.isfinite(by_mat).all() and by_mat.std() > 0
    buf_len = ctypes.c_int64(0)
    text = ctypes.create_string_buffer(1 << 22)
    ok(lib.LGBM_BoosterSaveModelToString(
        bst, 0, -1, 0, ctypes.c_int64(len(text)), ctypes.byref(buf_len),
        text), "SaveModelToString")
    assert f"[device_type: {SHELL_DEVICE}]" in text.value.decode()
    ok(lib.LGBM_BoosterFree(bst), "BoosterFree")
    ok(lib.LGBM_DatasetFree(ds), "DatasetFree")
    log(f"phase 22 (g) the Arrow ABI in this process: {n} x "
        f"{Xa.shape[1]} from a record batch, {SHELL_CHILD_ITERS} "
        f"iterations on the card (no device_type) in {train_s!r} s; "
        "PredictForArrow equals PredictForMat on the same handle")


def phase_shell(X, y, phase4_iter_s):
    """Phase 22: the CLI, ``python -m lightgbm_tpu_torch``, convert_model,
    the native parser, a C host of the training ABI, native TreeSHAP and
    the Arrow ABI,
    at phase 4's width on its first SHELL_ROWS rows written as a CSV.
    (b)'s children and (e)'s C host run beside the in-process parts.
    Returns the K1 launches of this process."""
    import importlib.util
    import os
    import shutil
    import tempfile
    from lightgbm_tpu_torch import native
    t0 = time.perf_counter()
    assert native.get_lib() is not None, \
        f"phase 22: the native library did not load: {native.build_error}"
    log(f"phase 22 built or found the native library in "
        f"{time.perf_counter() - t0!r} s: {native.library_path()}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_shell_")
    children = []
    try:
        path = os.path.join(tmp, "higgs.csv")
        vpath = os.path.join(tmp, "higgs_valid.csv")
        n, nv = SHELL_ROWS, SHELL_VALID_ROWS
        write_rows(path, np.column_stack([y[:n], X[:n]]), "w")
        write_rows(vpath, np.column_stack([y[n:n + nv], X[n:n + nv]]), "w")
        log(f"phase 22 wrote {n} + {nv} rows as CSV in "
            f"{time.perf_counter() - t0!r} s")
        child_model = os.path.join(tmp, "child_model.txt")
        result = os.path.join(tmp, "child_pred.txt")
        train_conf = shell_conf(tmp, "train", [
            f"data={path}", *shell_params(),
            f"num_iterations={SHELL_CHILD_ITERS}",
            f"output_model={child_model}"])
        predict_conf = shell_conf(tmp, "predict", [
            f"data={path}", f"input_model={child_model}",
            f"output_result={result}"])
        children.append(shell_module_child(tmp, train_conf, "train"))
        c_host, c_model, libpython = shell_c_host_start(tmp)
        children.append(c_host)
        reset_counts()
        model, ref = shell_cli_train(path, vpath, tmp, phase4_iter_s)
        walls, warnings = {}, []

        def reap_ok(child, task):
            rc, _, err, walls[task] = reap(child)
            assert rc == 0, (task, err[-3000:])
            warnings.extend(ln for ln in err.splitlines()
                            if "[Warning]" in ln)
        reap_ok(children[0], "train")
        children.append(shell_module_child(tmp, predict_conf, "predict"))
        X_file = shell_parser(path)
        shell_convert_model(model, tmp, X_file)
        shell_tree_shap(model, ref, X_file)
        if importlib.util.find_spec("pyarrow") is not None:
            shell_arrow(X_file, y)
        else:
            log("phase 22 (g) skips the Arrow ABI: pyarrow is not "
                "installed on this machine (held on the CPU by "
                "tests/test_torch_native.py)")
        reap_ok(children[-1], "predict")
        shell_module_check(walls, warnings, child_model, result, X_file)
        shell_c_host_check(c_host, c_model, libpython)
        log("phase 22 skips plotting: it draws on the host, held on the "
            "CPU by tests/test_torch_codegen_plotting.py (matplotlib is "
            + ("not " if importlib.util.find_spec("matplotlib") is None
               else "") + "installed on this machine)")
        counts = read_counts()
    finally:
        for child in children:
            child["proc"].kill()
            child["proc"].wait()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 22 took {time.perf_counter() - t0!r} s")
    return counts


TRACE_ITERS = 2                 # (a): lgt.train iterations, each run
TRACE_CLIENTS = 4               # (b): closed-loop clients ...
TRACE_REQUESTS = 100            # ... sending this many requests in all
TRACE_MAX_ROWS = 256            # ... of log-uniform 1..this many rows
TRACE_POOL_ROWS = 20_000        # the rows a request slices
K1_KERNELS = dict(KERNEL_KEYS)["K1"]


def traced_train(ds, profile_dir):
    """``lgt.train`` of phase 4's params on phase 4's Dataset for
    TRACE_ITERS iterations with ``global_timer`` on (and the profiler
    when ``profile_dir``): the booster, each iteration's seconds (card
    synced), the seconds from the last iteration to ``train``'s return
    (the trace's export), the section table and its totals, and the K1
    launches."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.utils.timer import global_timer
    stamps = []

    def before(env):
        torch.cuda.synchronize()
        stamps.append(("start", time.perf_counter()))
    before.before_iteration = True

    def after(env):
        torch.cuda.synchronize()
        stamps.append(("end", time.perf_counter()))
    params = dict(ds.params)
    global_timer.reset()
    global_timer.enabled = True
    reset_counts()
    try:
        extra = {"tpu_profile_dir": profile_dir} if profile_dir else {}
        bst = lgt.train(bench_params(**extra), ds,
                        num_boost_round=TRACE_ITERS,
                        callbacks=[before, after],
                        keep_training_booster=True)
        torch.cuda.synchronize()
        done = time.perf_counter()
    finally:
        global_timer.enabled = False
        ds.params = params
    counts = read_counts()
    starts = [t for k, t in stamps if k == "start"]
    ends = [t for k, t in stamps if k == "end"]
    iter_s = [e - b for b, e in zip(starts, ends)]
    assert len(iter_s) == TRACE_ITERS, stamps
    table, totals = global_timer.table(), global_timer.totals()
    global_timer.reset()
    return dict(bst=bst, iter_s=iter_s, tail_s=done - ends[-1],
                loop_s=ends[-1] - starts[0], table=table, totals=totals,
                counts=counts)


def tracing_sections(r, label):
    """Log a run's section table and each section's share of the
    loop's wall time; gate the names and counts."""
    for line in r["table"].splitlines():
        log(f"phase 23 (a) {label} | {line}")
    shares = {k: t / r["loop_s"] for k, (t, _) in r["totals"].items()}
    log(f"phase 23 (a) {label} share of the loop's {r['loop_s']!r} s: "
        + json.dumps(shares))
    names = {"GBDT::Boosting", "TreeLearner::Train", "Tree::ToHost",
             "GBDT::UpdateScore", "GBDT::UpdateValidScore"}
    assert set(r["totals"]) == names, r["totals"]
    assert all(c == TRACE_ITERS for _, c in r["totals"].values()), \
        r["totals"]


def tracing_trace(profile_dir):
    """The trace file (a): exists, and names K1's kernels; returns its
    path, bytes, the K1 kernel events by name and the seconds to parse
    it."""
    import os
    files = [os.path.join(profile_dir, f) for f in os.listdir(profile_dir)
             if f.endswith(".pt.trace.json")]
    assert len(files) == 1, files
    t = time.perf_counter()
    with open(files[0], encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    parse_s = time.perf_counter() - t
    k1 = {}
    kernels = 0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        kernels += 1
        for key in K1_KERNELS:
            if key in e.get("name", ""):
                k1[key] = k1.get(key, 0) + 1
    return files[0], os.path.getsize(files[0]), kernels, k1, parse_s


def tracing_serve(bst, Xp, seed, tracked):
    """(b): a ModelServer over ``bst`` (update() first, published when
    half the requests are answered), TRACE_CLIENTS clients sending
    TRACE_REQUESTS requests of log-uniform 1..TRACE_MAX_ROWS rows; under
    ``lockorder.tracking()`` when ``tracked``. Every answer must be its
    generation's ``predict(device=True)``, versions monotone a client."""
    import contextlib
    import threading
    from lightgbm_tpu_torch.analysis import lockorder
    guard = lockorder.tracking() if tracked else contextlib.nullcontext()
    records = [[] for _ in range(TRACE_CLIENTS)]
    with guard as tracker:
        srv = bst.serve(linger_ms=SERVE_LINGER_MS, raw_score=True)
        try:
            expected = {srv.generation.version: bst.predict(
                Xp, device=True, raw_score=True)}
            assert not bst.update()
            nxt = bst.predict(Xp, device=True, raw_score=True)
            answered = [0]
            half = threading.Event()
            lock = threading.Lock()
            per_client = TRACE_REQUESTS // TRACE_CLIENTS

            def client(ci):
                rng = np.random.default_rng(seed + ci)
                for _ in range(per_client):
                    n = int(np.exp(rng.uniform(0, np.log(TRACE_MAX_ROWS))))
                    lo = int(rng.integers(0, len(Xp) - n + 1))
                    t = time.perf_counter()
                    f = srv.submit(Xp[lo:lo + n])
                    out = f.result(120)
                    records[ci].append((lo, n, f.generation.version, out,
                                        time.perf_counter() - t))
                    with lock:
                        answered[0] += 1
                        if answered[0] >= TRACE_REQUESTS // 2:
                            half.set()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(i,),
                                        daemon=True)
                       for i in range(TRACE_CLIENTS)]
            for th in threads:
                th.start()
            assert half.wait(120), "phase 23 (b): traffic stalled"
            tp = time.perf_counter()
            info = srv.publish()
            publish_ms = (time.perf_counter() - tp) * 1e3
            expected[info.version] = nxt
            for th in threads:
                th.join(300)
            assert not any(th.is_alive() for th in threads), "client hung"
            wall = time.perf_counter() - t0
            st = assert_clean(srv, "phase 23 (b)")
        finally:
            srv.close(timeout=60)
        n_tracked = tracker.n_tracked if tracked else 0
        violations = list(tracker.violations) if tracked else []
    flat = [r for rs in records for r in rs]
    assert len(flat) == per_client * TRACE_CLIENTS, len(flat)
    for rs in records:
        vs = [r[2] for r in rs]
        assert vs == sorted(vs), vs
    for lo, n, v, out, _ in flat:
        assert v in expected, (v, list(expected))
        assert np.array_equal(out, expected[v][lo:lo + n]), \
            f"phase 23 (b): a response of generation {v} is not its model"
    lat = np.array([r[4] for r in flat]) * 1e3
    return dict(req_s=len(flat) / wall, rows_s=sum(r[1] for r in flat)
                / wall, p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)), wall_s=wall,
                publish_ms=publish_ms, batches=st["batches"],
                versions=sorted({r[2] for r in flat}), n_tracked=n_tracked,
                violations=violations)


def tracing_seeded_inversion():
    """A seeded lock-order inversion raises at the attempt."""
    import threading
    from lightgbm_tpu_torch.analysis import lockorder
    priv = lockorder.LockOrderTracker()
    a = lockorder.wrap(threading.Lock(), "seed-A", priv)
    b = lockorder.wrap(threading.Lock(), "seed-B", priv)
    with a:
        with b:
            pass
    tripped = []

    def inverted():
        try:
            with b:
                with a:
                    pass
        except lockorder.LockOrderViolation as e:
            tripped.append(e)
    th = threading.Thread(target=inverted, daemon=True)
    th.start()
    th.join(30)
    assert not th.is_alive() and len(tripped) == 1, tripped
    assert {"seed-A", "seed-B"} <= set(tripped[0].cycle), tripped[0].cycle
    return tripped[0].cycle


def phase_tracing(bst, ds, X, phase4_trees, phase4_iter_s):
    """Phase 23: (a) the section timer and ``tpu_profile_dir`` over
    TRACE_ITERS iterations of phase 4's configuration on its Dataset
    (the trees phase 4's first ones, string for string; the trace names
    K1's kernels), beside the same run with the timer alone; (b) a
    ModelServer over phase 4's booster with a publish under load, in
    turns without and with the lock-order tracker; (c) conlint over the
    port's threaded modules. Returns the K1 launches of (a) and of (b)'s
    updates."""
    import os
    import shutil
    import tempfile
    from lightgbm_tpu_torch.analysis import concurrency
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        plain = traced_train(ds, None)
        traced = traced_train(ds, os.path.join(tmp, "trace"))
        for r, label in ((plain, "timer"), (traced, "timer+profiler")):
            tracing_sections(r, label)
            got = tree_text(r.pop("bst"))
            assert got == phase4_trees, \
                f"phase 23 (a) {label}: trees differ from phase 4's"
            k1 = r["counts"]["hist_rowmajor_f32"]
            assert k1 > 0 and sum(r["counts"].values()) == k1, r["counts"]
        path, nbytes, kernels, k1_events, parse_s = tracing_trace(
            os.path.join(tmp, "trace"))
        launches = traced["counts"]["hist_rowmajor_f32"]
        # one of K1's kernels a counted launch; CUPTI may drop an event
        # from a trace of ~70,000 kernels, so the trace holds at most that
        assert 0 < sum(k1_events.values()) <= launches, (k1_events,
                                                         launches)
        log(f"phase 23 (a) {TRACE_ITERS} iterations of phase 4's params: "
            f"timer iter_s={plain['iter_s']!r}, timer+profiler "
            f"iter_s={traced['iter_s']!r} (phase 4 median, timer off: "
            f"{phase4_iter_s!r}); profiler overhead per iteration "
            f"{(sum(traced['iter_s']) - sum(plain['iter_s'])) / TRACE_ITERS!r}"
            f" s; the trace's export {traced['tail_s']!r} s (timer alone: "
            f"{plain['tail_s']!r}); trace {nbytes} bytes, {kernels} device "
            f"kernels, K1 {k1_events} against {launches} K1 launches "
            f"counted, parsed in {parse_s!r} s; trees equal phase 4's "
            "first two string for string in both runs")
        counts = {"hist_rowmajor_f32": plain["counts"]["hist_rowmajor_f32"]
                  + launches}
        Xp = np.ascontiguousarray(X[:TRACE_POOL_ROWS])
        reset_counts()
        free = tracing_serve(bst, Xp, 2300, tracked=False)
        guarded = tracing_serve(bst, Xp, 2300, tracked=True)
        served = read_counts()
        assert guarded["n_tracked"] > 0, guarded
        assert not guarded["violations"], guarded["violations"]
        cycle = tracing_seeded_inversion()
        for r, label in ((free, "untracked"), (guarded, "tracked")):
            log(f"phase 23 (b) {label}: {TRACE_CLIENTS} clients, "
                f"{TRACE_REQUESTS} requests of 1..{TRACE_MAX_ROWS} rows, "
                f"one publish under load: req_s={r['req_s']!r} "
                f"rows_s={r['rows_s']!r} p50_ms={r['p50_ms']!r} "
                f"p99_ms={r['p99_ms']!r} wall_s={r['wall_s']!r} "
                f"publish_ms={r['publish_ms']!r} batches={r['batches']} "
                f"generations={r['versions']} tracked_locks="
                f"{r['n_tracked']} violations={len(r['violations'])}")
        log(f"phase 23 (b) every answer its generation's "
            "predict(device=True) bit for bit, versions monotone per "
            f"client; tracked/untracked req_s "
            f"{guarded['req_s'] / free['req_s']!r}; the seeded inversion "
            f"raised at the attempt: {' -> '.join(cycle)}")
        counts["hist_rowmajor_f32"] += served.get("hist_rowmajor_f32", 0)
        root = os.path.dirname(os.path.abspath(__file__))
        t = time.perf_counter()
        rc = concurrency.main([], root=root)
        records = concurrency.load_baseline_records(
            concurrency.default_baseline_path(root))
        assert rc == 0 and records and \
            not concurrency.reasonless_entries(records), rc
        log(f"phase 23 (c) conlint over {len(concurrency.TARGET_MODULES)} "
            f"modules: no new finding, {len(records)} reasoned baseline "
            f"entries, {time.perf_counter() - t!r} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 23 took {time.perf_counter() - t0!r} s")
    return counts


def side_worker(plan_path):
    """The side process (``--side-worker PLAN``): the phases that need
    nothing of phase 4's rows or model (9's multiclass part, 13, 14, 10,
    6, 20 and 21), run in turn; their launch counts go to ``PLAN["out"]``. Each
    resets and reads this process's own counts, so the launches of the
    two processes never mix."""
    with open(plan_path) as fh:
        plan = json.load(fh)

    def done(label):
        log(f"{label} done at {time.time() - plan['t0_wall']:.1f} s "
            "(side process)")
    iter_s = plan["phase4_iter_s"]
    res = {"mc_runs": phase_multiclass()}
    done("phase 9 multiclass")
    res["cat_runs"], res["cat_totals"] = phase_categorical(iter_s)
    done("phase 13")
    res["sparse_runs"], res["sparse_totals"] = phase_sparse(iter_s)
    done("phase 14")
    res["rank_runs"] = phase_ranking()
    done("phase 10")
    phase_cross_check()
    done("phase 6")
    res["fleet_totals"] = phase_fleet()
    done("phase 20")
    res["live_totals"] = phase_live(iter_s)
    done("phase 21")
    with open(plan["out"], "w") as fh:
        json.dump(res, fh)


def start_side(phase4_iter_s, t0_wall):
    """Start the side process; its output goes to a file that
    ``finish_side`` prints."""
    import os
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_side_")
    plan = {"out": os.path.join(tmp, "side.json"),
            "phase4_iter_s": phase4_iter_s, "t0_wall": t0_wall}
    plan_path = os.path.join(tmp, "plan.json")
    with open(plan_path, "w") as fh:
        json.dump(plan, fh)
    with open(os.path.join(tmp, "side.log"), "w") as out:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--side-worker",
             plan_path] + [a for a in sys.argv[1:] if a == "--profile"],
            stdout=out, stderr=subprocess.STDOUT)
    return proc, plan, tmp


def finish_side(side):
    """Wait for the side process (the watchdog bounds the wait), print
    its lines, and return its results; fail if it failed."""
    import os
    import shutil
    proc, plan, tmp = side
    rc = proc.wait()
    try:
        with open(os.path.join(tmp, "side.log")) as fh:
            for line in fh:
                log(line.rstrip("\n"))
        assert rc == 0, f"the side process exited {rc}"
        with open(plan["out"]) as fh:
            return json.load(fh)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def arm_watchdog(limit_s, procs):
    """Past ``limit_s`` seconds, print every thread's stack, kill the
    side process and exit 3, so that a run that would be cut says
    where it was."""
    import faulthandler
    import os
    import threading

    def fire():
        print(f"chip_smoke: still running after {limit_s} s; every "
              "thread's stack follows", file=sys.stderr, flush=True)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        for p in procs:
            p.kill()
        os._exit(3)
    timer = threading.Timer(limit_s, fire)
    timer.daemon = True
    timer.start()


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
    if "--dist-worker" in sys.argv[1:]:
        dist_worker(sys.argv[sys.argv.index("--dist-worker") + 1])
        return
    if "--gang-worker" in sys.argv[1:]:
        gang_worker(sys.argv[sys.argv.index("--gang-worker") + 1])
        return
    if "--side-worker" in sys.argv[1:]:
        side_worker(sys.argv[sys.argv.index("--side-worker") + 1])
        return
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
    t0_wall = time.time()
    side_procs = []
    arm_watchdog(WATCHDOG_S, side_procs)
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
    phase_sampled_gh(dev)
    log(f"phase 3 sampled gh done at {time.perf_counter() - t:.1f} s")
    del flush
    main_run, bst, ds, X = phase_main_path()
    compact_counts = main_run["counts"]
    # phase 4's first trees, which phase 23 trains again under the tracer
    phase4_trees = first_trees(bst, TRACE_ITERS)
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
    full_text = paths["full"][1].model_to_string()
    del paths
    # phases 9 (multiclass), 13, 14, 10, 6, 20 and 21 in the side process,
    # beside phases 7 to 19 here
    side = start_side(main_run["median_iter_s"], t0_wall)
    side_procs.append(side[0])
    try:
        phase_predict(bst, ds, X)
        phase_predict(bst_u16, ds_u16, X, label="u16")
        log(f"phase 7 done at {time.perf_counter() - t:.1f} s")
        del bst_u16, ds_u16
        phase_training_api(ds, X, main_run["median_iter_s"])
        log(f"phase 8 done at {time.perf_counter() - t:.1f} s")
        phase_objectives(X, ds)
        log(f"phase 9 objectives done at {time.perf_counter() - t:.1f} s")
        surface_runs = phase_user_surface(bst, ds, X, main_run["binning_s"])
        log(f"phase 11 done at {time.perf_counter() - t:.1f} s")
        sampling_runs, sampling_medians = phase_sampling(
            ds, X, main_run["median_iter_s"])
        log(f"phase 12 done at {time.perf_counter() - t:.1f} s")
        pool_runs = phase_sparse_on_phase4_rows(ds, X,
                                                main_run["median_iter_s"])
        log(f"phase 14 on phase 4's rows done at "
            f"{time.perf_counter() - t:.1f} s")
        constraint_launches, constraint_totals = phase_constraints(
            bst, ds, X, main_run["median_iter_s"])
        log(f"phase 15 done at {time.perf_counter() - t:.1f} s")
        robust_launches, robust_totals = phase_robustness(
            ds, X, main_run["median_iter_s"], sampling_medians["goss"])
        log(f"phase 16 done at {time.perf_counter() - t:.1f} s")
        dist_launches, dist_totals, gang_ranks, gang_tmp = \
            phase_distributed(bst, ds, X, full_text,
                              main_run["median_iter_s"])
        log(f"phase 17 done at {time.perf_counter() - t:.1f} s")
        shard_launches, shard_totals = phase_sharded(
            gang_ranks, gang_tmp, main_run["median_iter_s"])
        del gang_ranks
        log(f"phase 18 done at {time.perf_counter() - t:.1f} s")
        serve_totals = phase_serving(bst, ds, X)
        log(f"phase 19 done at {time.perf_counter() - t:.1f} s")
        shell_totals = phase_shell(X, ds.get_label(),
                                   main_run["median_iter_s"])
        log(f"phase 22 done at {time.perf_counter() - t:.1f} s")
        trace_totals = phase_tracing(bst, ds, X, phase4_trees,
                                     main_run["median_iter_s"])
        log(f"phase 23 done at {time.perf_counter() - t:.1f} s")
        del bst, ds, X
        gc.collect()
        res = finish_side(side)
    finally:
        side[0].kill()
        side[0].wait()
    log(f"side process joined at {time.perf_counter() - t:.1f} s")
    mc_runs, rank_runs = res["mc_runs"], res["rank_runs"]
    cat_runs, cat_totals = res["cat_runs"], res["cat_totals"]
    sparse_runs, sparse_totals = res["sparse_runs"], res["sparse_totals"]
    fleet_totals = res["fleet_totals"]
    live_totals = res["live_totals"]
    for k, v in pool_runs.items():
        key = k.split("_", 2)[2]
        sparse_totals[key] = sparse_totals.get(key, 0) + v
    later = {k: cat_totals.get(k, 0) + sparse_totals.get(k, 0)
             + constraint_totals.get(k, 0) + robust_totals.get(k, 0)
             + dist_totals.get(k, 0) + shard_totals.get(k, 0)
             + serve_totals.get(k, 0) + fleet_totals.get(k, 0)
             + live_totals.get(k, 0) + shell_totals.get(k, 0)
             + trace_totals.get(k, 0)
             for k in set(cat_totals) | set(sparse_totals)
             | set(constraint_totals) | set(robust_totals)
             | set(dist_totals) | set(shard_totals) | set(serve_totals)
             | set(fleet_totals) | set(live_totals) | set(shell_totals)
             | set(trace_totals)}

    kernels = []
    level = f"skewed n={LEVEL_NODES[-1]}"
    for B in (MAX_BIN, U16_MAX_BIN):
        suffix = bin_width(B)[1]
        for mode in MODES:
            key = f"hist_rowmajor_{mode}{suffix}"
            kernels.append(kernel_entry(
                "hist_rowmajor", mode + suffix,
                runs[key][key] + later.get(key, 0),
                k1[(mode + suffix, B, N_ROWS)]))
        for mode in MODES:
            key = f"hist_level_{mode}{suffix}"
            kernels.append(kernel_entry(
                "hist_level", mode + suffix,
                runs[key][key] + later.get(key, 0),
                k2[(mode + suffix, B, level)]))
        for mode in FM_MODES:
            key = f"hist_featmajor_{mode}{suffix}"
            kernels.append(kernel_entry(
                "hist_featmajor", mode + suffix,
                runs[key][key] + later.get(key, 0),
                b2[(mode + suffix, B, N_ROWS)]))
    kernels.append(kernel_entry(
        "level_partition", None,
        runs["hist_level_f32"]["level_partition"]
        + later.get("level_partition", 0),
        k2[("partition", MAX_BIN, level)]))
    assert all(k["launches"] > 0 for k in kernels), kernels
    log("phase 9 launches by run: " + json.dumps(mc_runs))
    log("phase 10 launches by run: " + json.dumps(rank_runs))
    log("phase 11 launches by run: " + json.dumps(surface_runs))
    log("phase 12 launches by run: " + json.dumps(sampling_runs))
    log("phase 13 launches by run: " + json.dumps(cat_runs)
        + " by mode: " + json.dumps(nonzero(cat_totals)))
    log("phase 14 launches by run: " + json.dumps({**sparse_runs,
                                                    **pool_runs})
        + " by mode: " + json.dumps(nonzero(sparse_totals)))
    log("phase 15 launches by run: " + json.dumps(constraint_launches)
        + " by mode: " + json.dumps(nonzero(constraint_totals)))
    log("phase 16 launches by run: " + json.dumps(robust_launches)
        + " by mode: " + json.dumps(nonzero(robust_totals)))
    log("phase 17 launches by run (gang: rank 0, rank 1): "
        + json.dumps(dist_launches))
    log("phase 18 launches by run (rank 0, rank 1; chaos: the relaunch): "
        + json.dumps(shard_launches))
    log("phase 19 launches (the hot-swap's updates): "
        + json.dumps(nonzero(serve_totals)))
    log("phase 20 launches (the tenants' training and the updates of (b) "
        "and (e)): " + json.dumps(nonzero(fleet_totals)))
    log("phase 21 launches ((a)'s training, (c)'s thread trainer and (d)'s "
        "tenants; (b)'s child trainer runs K1 in its own process): "
        + json.dumps(nonzero(live_totals)))
    log("phase 22 launches ((a)'s CLI and its lgt.train reference; the "
        "children of (b) and (e) run K1 in their own processes): "
        + json.dumps(nonzero(shell_totals)))
    log("phase 23 launches ((a)'s two traced trainings and (b)'s two "
        "updates): " + json.dumps(nonzero(trace_totals)))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
