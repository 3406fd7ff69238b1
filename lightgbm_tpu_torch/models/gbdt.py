"""Gradient boosting engine, serial path.

Port of ``lightgbm_tpu/models/gbdt.py`` ``GBDT`` (ref:
src/boosting/gbdt.h:28, gbdt.cpp:353 TrainOneIter), serial. An
iteration grows K trees, one per class (K = 1 but for the multiclass
objectives and a custom objective with ``num_class`` > 1), each through
the same grower, from gradients
computed once over the whole ``[K, N]`` score before any of them is
added; the L1, quantile and MAPE objectives then refit each tree's leaves
on the host. The grower is the compact leaf-wise one
(``tpu_row_scheduling=compact``, bins row-major on the device), the
full-pass leaf-wise one (``full`` or ``leaf``, bins feature-major only)
or, for ``tpu_row_scheduling=level``, the pure level grower
(``1 <= max_depth <= MAX_LEVEL_DEPTH``) or the hybrid level+tail grower
(deeper or unbounded). Quantized gradients (``use_quantized_grad``) run
in all of them, bf16 histograms (``tpu_hist_dtype``) in all but full,
which builds f32 histograms under it as the JAX package does.

The stored columns may be physical (``core/layout.py``): EFB groups
(``enable_bundle``: dense bins bundled here by ``io/bundling.find_bundles``,
or the groups a sparse source was packed into), whose histograms the
growers expand to the logical features before each scan, or multi-value
``[R, K]`` pairs (``tpu_sparse_storage``), whose plain torch scatter is
the histogram on every device. The compact grower's histogram pool
follows ``histogram_pool_size`` (``_pool_policy``: full, a bounded LRU
pool, or none), budgeted over the stored columns (``_hist_budget``).

Row sampling (``models/sample_strategy.py``: bagging, balanced and by
query, ``tpu_device_bagging``, GOSS) gives each iteration a 0/1 bag and a
row weight: every tree of it grows from ``[g·w, h·w, bag]`` over all
physical rows. Column sampling (``feature_fraction``, per tree, and
``feature_fraction_bynode``, per node) masks features out of the split
scan. ``models/dart.py`` and ``models/rf.py`` subclass the engine;
``models/__init__.create_boosting`` picks one by ``boosting``.

``tpu_async_boosting`` (``_async_on``; auto is on for the card) draws
GOSS on the device from a stateless threefry chain, so no ``[K, N]``
gradient reaches the host; the grower returns host trees either way, so
nothing else differs from the synchronous path. Each iteration runs in
a liveness shell (``robustness/``): the ``rank_kill`` site, a heartbeat
(``tpu_heartbeat_file`` or ``LGBM_TPU_HEARTBEAT``; phase ``compiling``
until the first iteration, which builds the kernels, ends) and the stall
watchdog (``tpu_stall_sec``). Under ``tpu_integrity_numeric_guard`` the
gradients' sums are checked before any tree grows (the ``nan_grad``
site poisons them) and each tree's leaves before it is appended.
``rng_snapshot`` / ``restore_rng`` carry the host samplers' states
through a checkpoint.

Prediction on the device (``predict_device``) goes through the
packed-forest engine of ``ops/forest.py``; the model list bumps a
generation counter on every destructive change, which tells the packed
forest to repack.

The score lives on the training device as f32 ``[K, N]``. Each tree's
contribution is added in two roundings, ``delta = f32(lv[leaf]) *
f32(rate)`` and then ``score += delta`` (ref: the JAX package's
``_leaf_delta`` / ``_score_add``, models/gbdt.py:1905-1937): the stored
leaf value after ``HostTree.shrink`` is exactly that product, so a model
replayed from its text gives the same scores. PyTorch runs each op
eagerly, so nothing fuses the two into an FMA.

Validation sets (``add_valid_data``) keep their feature-major bins and
their f32 score on the training device; each tree adds its stored f32
leaf value at every row's leaf, found by the device traversal of
``ops/predict.forest_leaf_bins`` (``_tree_outputs``). Continued training
(``init_from_model``) rebinds the trees of a loaded model to this
dataset's bins and replays them, in model order, onto every score. On
the card the metrics are computed on the device and only their values
are read back (``_eval``).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..core.grower import GrowerConfig, GrowerHooks, make_tree_grower
from ..core.hybrid_grower import make_hybrid_grower, resolve_handoff_depth
from ..core.level_grower import MAX_LEVEL_DEPTH, make_level_grower
from ..core.metrics import Metric
from ..core.objective import ObjectiveFunction
from ..core.tree import HostTree
from ..distributed import make_injected_hooks
from ..io.dataset_core import BinnedDataset
from ..ops.forest import (BinnedTreeArrays, DeviceRouteUnavailable,
                          ServingEngine, mapper_arrays, pack_binned_tree,
                          upload_trees)
from ..ops.hist_cuda import device_bins, feature_major_bins
from ..ops.predict import depth_steps, forest_leaf_bins
from ..ops.split import K_EPSILON, FeatureMeta, SplitHyperParams
from ..robustness import faults, heartbeat, integrity
from ..utils import log, prng
from ..utils.timer import global_timer
from .sample_strategy import SampleStrategy


def _orig_to_used(used_feature_map) -> dict:
    """Original feature index -> used (inner) index (ref: Dataset::
    InnerFeatureIndex)."""
    return {int(o): u for u, o in enumerate(used_feature_map)}


def _parse_interaction_constraints(spec) -> list:
    """Parse "[0,1,2],[2,3]" (or a list of lists) into a list of int lists
    (ref: config.h interaction_constraints string format; the JAX
    package's models/gbdt.py:150-157)."""
    if isinstance(spec, (list, tuple)):
        return [list(map(int, grp)) for grp in spec]
    import re
    return [[int(v) for v in grp.split(",") if v.strip() != ""]
            for grp in re.findall(r"\[([^\[\]]*)\]", str(spec))]


def resolve_device(config: Config) -> torch.device:
    """The training device named by ``device_type``: ``cuda`` (the
    default) or ``cpu``. Asking for ``cuda`` without a card raises."""
    dev = str(config.device_type).lower()
    if dev == "cuda" and not torch.cuda.is_available():
        log.fatal("device_type='cuda' but torch.cuda.is_available() is "
                  "False; pass device_type='cpu' to run on the CPU")
    return torch.device(dev)


def resolve_hist_reduce(requested: str) -> str:
    """``tpu_hist_reduce`` for the row-sharded learners (ref: the JAX
    package's models/gbdt.py:220-241): explicit values pass through (the
    learner gates eligibility, attributably); ``auto`` is ``allreduce``,
    the JAX package's incumbent (it flips only by a TPU-tuned cache,
    which has no counterpart here)."""
    requested = str(requested).lower()
    return "allreduce" if requested == "auto" else requested


class _ValidData:
    """One validation set on the training device: its feature-major bins,
    its f32 score ``[K, N]`` and its metrics (ref: valid_score_updater_ /
    valid_metrics_ in gbdt.h; the JAX package's models/gbdt.py:160)."""

    def __init__(self, dataset: BinnedDataset, metrics: List[Metric],
                 num_class: int, name: str, device: torch.device):
        self.dataset = dataset
        self.metrics = metrics
        self.name = name
        self.bins = feature_major_bins(dataset.ensure_logical_bins(),
                                       device)
        self.score = torch.zeros((num_class, dataset.num_data),
                                 dtype=torch.float32, device=device)
        if dataset.metadata.init_score is not None:
            self.score = torch.as_tensor(
                dataset.metadata.init_score.reshape(
                    -1, dataset.num_data).astype(np.float32), device=device)


class _ModelList(list):
    """Model list that bumps its engine's model generation on every
    change but an append at the tail (``del``, item replacement,
    reordering), so prediction never replays a stale packed forest while
    appends keep it incrementally packable (ref: the JAX package's
    models/gbdt.py _ModelList)."""

    __slots__ = ("_bump",)

    def __init__(self, iterable=(), bump=None):
        super().__init__(iterable)
        # the engine's bound method, held weakly: the engine owns this
        # list, so a strong reference would make a cycle that keeps a
        # dropped engine, and its device tensors, alive until the cyclic
        # collector runs
        self._bump = weakref.WeakMethod(bump) if bump is not None else None


def _bumping(name):
    def method(self, *args, **kwargs):
        out = getattr(list, name)(self, *args, **kwargs)
        bump = self._bump() if self._bump is not None else None
        if bump is not None:
            bump()
        return out
    return method


for _name in ("insert", "pop", "remove", "clear", "reverse", "sort",
              "__setitem__", "__delitem__"):
    setattr(_ModelList, _name, _bumping(_name))


class GBDT:
    """Gradient Boosting Decision Tree engine (ref: gbdt.h:28)."""

    NAME = "gbdt"

    def __init__(self, config: Config, train_set: Optional[BinnedDataset],
                 objective: Optional[ObjectiveFunction]):
        self.config = config
        self.train_set = train_set
        self.objective = objective
        # the generation advances on every DESTRUCTIVE change of the model
        # list (and on invalidate_serving_cache); tail appends leave it,
        # so the packed forest grows incrementally (ref: gbdt.py:294)
        self._model_gen = 0
        self._serving: Optional[ServingEngine] = None
        self._serving_mappers = None  # stable identity for binner caching
        self.models = []
        self.shrinkage_rate = float(config.learning_rate)
        self.train_metrics: List[Metric] = []
        self.valid_sets: List[_ValidData] = []
        # iterations trained in this session (ref: gbdt.h iter_): what
        # rollback_one_iter may undo; an init model's trees are not
        self.iter = 0
        # iterations of an init model (ref: gbdt.h num_init_iteration_):
        # DART and RF index this run's trees past them
        self.num_init_iteration = 0
        self.max_feature_idx = 0
        self.label_idx = 0
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        self.average_output = False
        self.num_tree_per_iteration = (objective.num_model_per_iteration
                                       if objective is not None
                                       else int(config.num_class))
        self.device: Optional[torch.device] = None
        # tpu_async_boosting, resolved at the first iteration
        # (_async_on), and whether a GOSS draw came from the device chain
        self._async_mode: Optional[bool] = None
        self._goss_dev_used = False
        # liveness: the first iteration is the compiling phase (the
        # kernels build at their first launch); the stall policy and the
        # numeric guard are set up with the training data
        self._hb_warm = False
        self._hb_policy = None
        self._nguard: Optional[integrity.NumericHealthGuard] = None
        # the learner and its world (_select_learner), serial by default;
        # _hist_reduce attributes the histogram collective
        self._tree_learner = "serial"
        self._comm = self._dist = self._inj = None
        self._hist_reduce = "n/a"
        self._process_rank = 0
        if train_set is not None:
            self._setup_train(train_set)

    @property
    def models(self) -> List[HostTree]:
        return self._models

    @models.setter
    def models(self, value: List[HostTree]) -> None:
        self.invalidate_serving_cache()
        self._models = _ModelList(value, bump=self.invalidate_serving_cache)

    def invalidate_serving_cache(self) -> None:
        """Advance the model generation: the next device prediction
        repacks. The model list calls it on each destructive change; call
        it after editing a tree's content in place, which the list cannot
        observe."""
        self._model_gen += 1

    def _setup_train(self, train: BinnedDataset) -> None:
        cfg = self.config
        from ..distributed import num_processes
        bad = cfg.unsupported_settings() + cfg.distributed_refusals(
            num_processes())
        if bad:
            log.fatal("the port does not implement these settings yet: "
                      + ", ".join(bad))
        dev = self.device = resolve_device(cfg)
        self._setup_liveness()
        self.num_data = train.num_data
        self.max_feature_idx = train.num_total_features - 1
        self.feature_names = list(train.feature_names)
        self.feature_infos = train.feature_infos()
        md = train.metadata
        if self.objective is not None:
            self.objective.init(md, train.num_data, dev)

        mappers = train.used_bin_mappers()
        self.num_used_features = len(mappers)
        # per used feature: num_bin, missing type, default bin (host
        # arrays for packing trees for the device traversal)
        self._mapper_arrays = mapper_arrays(mappers)
        monotone, mc_method, contri = self._constraint_meta(train)
        self.feature_meta = (FeatureMeta.from_mappers(
            mappers, dev, monotone=monotone, penalty=contri)
            if mappers else None)
        self.num_bin_max = int(max((m.num_bin for m in mappers), default=2))
        self.row_sched = str(cfg.tpu_row_scheduling).lower()
        if self.row_sched == "leaf":
            # the same program as full (ref: config.py:35-37)
            self.row_sched = "full"
        self._multival = train.bins_mv is not None
        if self._multival and self.row_sched == "level":
            # ref: gbdt.py:1764-1765
            log.warning("tpu_row_scheduling='level' does not support "
                        "multi-value sparse storage — falling back to "
                        "'compact'")
            self.row_sched = "compact"
        self._linear = bool(cfg.linear_tree)
        if self._linear:
            self._check_linear(train)
        # sharded ingestion: train.bins holds this rank's rows only, never
        # the whole table (ref: gbdt.py:743-747)
        self._sharded_ingest = train.shard is not None
        self._select_learner()
        self._forced = self._load_forced_splits(train)
        if self._forced is not None and self._tree_learner in ("voting",
                                                               "feature"):
            log.warning("forcedsplits_filename is not supported with "
                        f"tree_learner={self._tree_learner}; ignoring "
                        "forced splits")
            self._forced = None
        bins_host = self._setup_bundles(train)
        # the logical feature-major bins of the traversal replays, made
        # on first use when the stored columns are physical
        self._logical_fm = None
        # full scheduling holds the bins feature-major only, the other
        # growers row-major only (ref: gbdt.py:942, 1033-1072); u16 bins
        # are held as int16 with the same bits (ops/histogram.bin_ids);
        # multi-value storage is its [R, K] pairs
        if self._tree_learner != "serial":
            self.bins = self._learner_bins(train, bins_host)
        elif self._multival:
            from ..ops.hist_multival import SparseBins
            self.bins = SparseBins(torch.from_numpy(train.bins_mv[0]).to(dev),
                                   torch.from_numpy(train.bins_mv[1]).to(dev),
                                   len(mappers))
        elif self.row_sched == "full":
            self.bins = feature_major_bins(bins_host, dev)
        else:
            self.bins = device_bins(bins_host, dev)

        K = self.num_tree_per_iteration
        self.score = torch.zeros((K, self.num_data), dtype=torch.float32,
                                 device=dev)
        self.has_init_score = md.init_score is not None
        if self.has_init_score:
            self.score = torch.as_tensor(
                md.init_score.reshape(-1, self.num_data).astype(np.float32),
                device=dev)
        self.class_need_train = [
            self.objective.class_need_train(k) if self.objective else True
            for k in range(K)]
        self.sample_strategy = SampleStrategy.create(cfg, self.num_data, K,
                                                     metadata=md)
        # the threefry key of tpu_device_bagging's draws (ref: gbdt.py:767)
        self._bag_key = prng.prng_key(int(cfg.bagging_seed))
        # column sampling's generator (ref: gbdt.py:1213, col_sampler.hpp)
        self._col_rng = np.random.default_rng(cfg.feature_fraction_seed)
        self._bynode = cfg.feature_fraction_bynode < 1.0

        hp = SplitHyperParams(
            lambda_l1=cfg.lambda_l1, lambda_l2=cfg.lambda_l2,
            min_data_in_leaf=cfg.min_data_in_leaf,
            min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
            min_gain_to_split=cfg.min_gain_to_split,
            max_delta_step=cfg.max_delta_step,
            path_smooth=cfg.path_smooth,
            monotone_penalty=cfg.monotone_penalty,
            max_cat_threshold=int(cfg.max_cat_threshold),
            cat_l2=float(cfg.cat_l2), cat_smooth=float(cfg.cat_smooth),
            max_cat_to_onehot=int(cfg.max_cat_to_onehot),
            min_data_per_group=int(cfg.min_data_per_group))
        self.grower_cfg = GrowerConfig(
            num_leaves=cfg.num_leaves, max_depth=cfg.max_depth,
            num_bin=self.num_bin_max, hparams=hp,
            hist_dtype=str(cfg.tpu_hist_dtype).lower(),
            quantized=bool(cfg.use_quantized_grad),
            quant_bins=int(cfg.num_grad_quant_bins),
            stochastic_rounding=bool(cfg.stochastic_rounding),
            row_sched="full" if self.row_sched == "full" else "compact",
            extra_trees=bool(cfg.extra_trees), mc_method=mc_method,
            interaction_groups=self._interaction_groups(train))
        self._layout = self._make_layout()
        # each tree's threefry key, the JAX package's chain
        # fold_in(PRNGKey(seed'), iteration * K + k): split into the keys
        # of stochastic rounding's grad and hess draws, and folded with
        # 7919 into extra_trees' key. seed' is extra_seed under
        # extra_trees, else seed (ref: models/gbdt.py 835-842,
        # 2303-2309; core/grower.py 252-258, 836-840)
        self._rng_key = None
        if ((self.grower_cfg.quantized and
             self.grower_cfg.stochastic_rounding) or
                self.grower_cfg.extra_trees):
            rng_seed = (cfg.extra_seed if cfg.extra_trees and
                        cfg.extra_seed is not None
                        else (cfg.seed if cfg.seed is not None else 0))
            self._rng_key = prng.prng_key(int(rng_seed))
        where = ("hand-written for CUDA" if dev.type == "cuda" else
                 "as their plain PyTorch versions on the CPU")
        log.info_once(
            f"tpu_hist_kernel={cfg.tpu_hist_kernel}: compact histograms "
            "run kernel K1 (hist_rowmajor) and level histograms kernel K2 "
            f"(hist_level), {where}; the einsum, scatter and blocks "
            "formulations are TPU/CPU formulations with no counterpart in "
            "this package")
        if self.row_sched == "full":
            log.info_once(
                f"tpu_use_pallas={cfg.tpu_use_pallas}, tpu_rows_per_block="
                f"{cfg.tpu_rows_per_block}: full/leaf histograms run kernel "
                f"B2 (hist_featmajor), {where}, whatever these say; the XLA "
                "formulation and the Pallas row tile have no counterpart "
                "in this package")
            if self.grower_cfg.hist_dtype in ("bfloat16", "bf16") and \
                    not self.grower_cfg.quantized:
                log.info_once("tpu_hist_dtype=bfloat16 is read on the "
                              "compact and level paths only; full/leaf "
                              "scheduling builds f32 histograms, as the "
                              "JAX package does")
        if self.row_sched == "level":
            reasons = self._level_ineligibility()
            if reasons:
                log.warning("tpu_row_scheduling='level' does not support "
                            f"{'; '.join(reasons)} — falling back to "
                            "'compact'")
                self.row_sched = "compact"
        if self.row_sched == "compact":
            self._pool_policy()
        self._setup_cegb(train)
        self._grow = (self._make_grower()
                      if self.feature_meta is not None else None)

    def _setup_liveness(self) -> None:
        """The process heartbeat from ``tpu_heartbeat_file`` or, without
        it, ``LGBM_TPU_HEARTBEAT``, and the stall policy from the
        environment with ``tpu_stall_sec`` over every phase (ref: the
        JAX package's models/gbdt.py:664-696). In a world of more than
        one process each rank writes its own file
        (``heartbeat.rank_path``, the gang's read convention), and the
        ``rank_kill`` site knows the rank; ``tpu_gang_collective_timeout_s``
        pins the collective deadline."""
        import os

        from ..distributed import (num_processes, process_index,
                                   set_collective_timeout)
        cfg = self.config
        self._process_rank = process_index()
        hb_path = str(cfg.tpu_heartbeat_file) or \
            (os.environ.get(heartbeat.ENV_HEARTBEAT) or "").strip()
        if hb_path:
            if num_processes() > 1:
                hb_path = heartbeat.rank_path(hb_path, self._process_rank)
            heartbeat.install(hb_path)
        if float(cfg.tpu_gang_collective_timeout_s or 0.0) > 0.0:
            set_collective_timeout(float(cfg.tpu_gang_collective_timeout_s))
        policy = heartbeat.StallPolicy.from_env()
        if float(cfg.tpu_stall_sec or 0.0) > 0.0:
            s = float(cfg.tpu_stall_sec)
            policy = dataclasses.replace(
                policy, stall_sec={p: s for p in policy.stall_sec},
                default_stall=s)
        self._hb_policy = policy

    def _select_learner(self) -> None:
        """``tree_learner`` (ref: tree_learner.cpp:17; the JAX package's
        models/gbdt.py:844-935, 1137-1162): ``data``, ``voting`` and
        ``feature`` train over the ``torch.distributed`` world this
        process joined (``distributed.init_distributed``), one rank a
        process, with the whole boosting loop around them; outside a
        world they run serial, with the JAX package's warning. Linear
        trees are serial; multi-value storage serves the serial, data
        and voting learners. The serial learner takes the injected
        collectives, if any, snapshotted here so several workers can be
        set up one after another in one process."""
        from ..distributed import injected_collectives
        from ..parallel.mesh import current_comm
        cfg = self.config
        tl = str(cfg.tree_learner).lower()
        if self._linear and tl != "serial":
            log.warning("Linear tree learner must be serial")
            tl = "serial"
        if tl in ("data", "voting", "feature"):
            comm = current_comm(self.device)
            if comm is not None:
                self._tree_learner, self._comm = tl, comm
            else:
                log.warning(f"tree_learner={tl} requested but only 1 "
                            "device(s) visible; running serial")
        if self._multival and self._tree_learner == "feature":
            log.warning("multi-value sparse storage supports the serial, "
                        "data and voting learners (consider "
                        "tree_learner=data); overriding: "
                        "tree_learner=feature")
            self._tree_learner, self._comm = "serial", None
        if (self._tree_learner not in ("data", "voting") and
                str(cfg.tpu_hist_reduce).lower() == "reduce_scatter"):
            log.info("tpu_hist_reduce=reduce_scatter applies to the "
                     "row-sharded learners (tree_learner=data/voting); "
                     f"tree_learner={self._tree_learner!r} keeps its "
                     "existing collective contract")
        if self._sharded_ingest and self._tree_learner not in ("data",
                                                               "voting"):
            n_dev = self._comm.world if self._comm is not None else 1
            log.fatal(
                "sharded ingestion (pre_partition/tpu_ingest='sharded') "
                "requires the row-sharded learners: set "
                "tree_learner=data (or voting) with more than one "
                f"device — got tree_learner={self._tree_learner!r} over "
                f"{n_dev} device(s)")
        if self._tree_learner == "serial":
            self._inj = injected_collectives()
            return
        if (self._tree_learner == "voting" and self._multival and
                self.row_sched == "full"):
            # a full pass's local sums come from a feature's bins, which
            # miss the default-bin mass multi-value storage does not store
            log.fatal("tree_learner=voting with multi-value sparse storage "
                      "requires tpu_row_scheduling='compact'")
        if self._tree_learner == "feature" and cfg.interaction_constraints:
            log.fatal("interaction_constraints are not supported with "
                      "tree_learner=feature")

    def _resolve_hist_reduce_mode(self) -> str:
        """The histogram collective of the row-sharded learners, with the
        JAX package's eligibility ladder and its attribution string in
        ``self._hist_reduce`` (ref: models/gbdt.py:1288-1333): the
        reduce-scatter windows scan dense numerical features only, so EFB,
        multi-value storage, forced splits (data), categorical and
        monotone features resolve to allreduce, logged with the
        reason."""
        cfg = self.config
        tl = self._tree_learner
        mode = resolve_hist_reduce(cfg.tpu_hist_reduce)
        if tl not in ("data", "voting"):
            self._hist_reduce = "n/a"
            return "allreduce"
        if mode != "reduce_scatter":
            self._hist_reduce = "allreduce"
            return "allreduce"
        reasons = []
        if self._bundle is not None:
            reasons.append("efb")
        if self._multival:
            reasons.append("multival")
        if self._forced is not None and tl == "data":
            reasons.append("forced-splits")
        if self.feature_meta.has_cat:
            reasons.append("categorical")
        if self.feature_meta.monotone is not None:
            reasons.append("monotone")
        if reasons:
            why = "+".join(reasons)
            log.info(f"tpu_hist_reduce={cfg.tpu_hist_reduce} resolves to "
                     "allreduce: reduce_scatter is not yet eligible with "
                     f"{why} (feature windows carry dense numerical scan "
                     "state only)")
            self._hist_reduce = f"allreduce(fallback:{why})"
            return "allreduce"
        self._hist_reduce = "reduce_scatter"
        return "reduce_scatter"

    def _learner_bins(self, train: BinnedDataset, bins_host):
        """This rank's stored columns on the device (ref: the JAX
        package's models/gbdt.py:1336-1560): under data and voting its
        block of rows (``RowShards``; pad rows are zero bins, multi-value
        pad rows hold no entry), under sharded ingestion the rows it
        loaded, padded to the world's region; under feature every row
        of its feature slice, or of its EFB groups' slice (pad columns
        zero bins)."""
        from ..parallel.data_parallel import RowShards
        from ..parallel.feature_parallel import (feature_window,
                                                 host_feature_slice)
        dev = self.device
        full = self.row_sched == "full"
        if self._tree_learner == "feature":
            # the features' slice, or under EFB the groups' (shard_bundle)
            n = (self.num_used_features if self._bundle is None
                 else self._bundle.num_groups)
            lo, Fd = feature_window(n, self._comm)
            local = host_feature_slice(bins_host, lo, Fd)
        elif self._sharded_ingest:
            self._shards = RowShards(self.num_data, self._comm,
                                     row_counts=train.shard.row_counts)
            local = self._shards.pad_local(bins_host)
        else:
            self._shards = RowShards(self.num_data, self._comm)
            if self._multival:
                from ..ops.hist_multival import SparseBins
                idx, binv = train.bins_mv
                return SparseBins(
                    torch.from_numpy(self._shards.host_rows(idx, -1)).to(dev),
                    torch.from_numpy(self._shards.host_rows(binv)).to(dev),
                    self.num_used_features)
            local = self._shards.host_rows(bins_host)
        return (feature_major_bins(local, dev) if full
                else device_bins(local, dev))

    def _make_learner(self, hist_fn):
        """The grower of this rank of the distributed learner, and the
        engine's wrapper around it (``self._dist``)."""
        from ..parallel import (FeatureShardedLearner, RowShardedLearner,
                                make_data_parallel_grower,
                                make_feature_parallel_grower,
                                make_voting_parallel_grower)
        gcfg, meta, layout = self.grower_cfg, self.feature_meta, self._layout
        tl, comm = self._tree_learner, self._comm
        mode = self._resolve_hist_reduce_mode()
        if tl == "feature":
            if (self._bundle is not None and meta.monotone is not None and
                    gcfg.mc_method in ("intermediate", "advanced")):
                # the JAX package's refusal (core/grower.py:634-647): its
                # box geometry cannot follow the group layout
                log.fatal("refined monotone constraints do not compose with "
                          "tree_learner=feature + EFB bundling; use "
                          "monotone_constraints_method='basic'")
            grow = make_feature_parallel_grower(gcfg, meta, comm,
                                                hist_fn=hist_fn, layout=layout,
                                                bundle=self._bundle)
            self._dist = FeatureShardedLearner(grow, self.bins)
            return grow
        if tl == "data":
            grow = make_data_parallel_grower(gcfg, meta, comm, hist_fn=hist_fn,
                                             layout=layout,
                                             forced=self._forced,
                                             hist_reduce=mode)
        else:
            grow = make_voting_parallel_grower(
                gcfg, meta, comm, top_k=int(self.config.top_k),
                hist_fn=hist_fn, layout=layout, hist_reduce=mode)
        self._dist = RowShardedLearner(grow, self.bins, self._shards)
        return grow

    def _constraint_meta(self, train: BinnedDataset):
        """``(monotone, mc_method, feature_contri)``: the monotone
        directions and the contri multipliers per USED feature, or None
        when none is set (ref: the JAX package's models/gbdt.py:704-737;
        both are given per ORIGINAL feature), and the monotone method,
        basic under extra_trees."""
        cfg = self.config
        F = train.num_total_features
        used = train.used_feature_map
        monotone = contri = None
        if cfg.monotone_constraints:
            mc_in = np.asarray(cfg.monotone_constraints, np.int32)
            if len(mc_in) != F:
                log.fatal(f"monotone_constraints has {len(mc_in)} entries "
                          f"but the dataset has {F} features")
            if np.any(mc_in != 0):
                monotone = mc_in[used]
        mc_method = str(cfg.monotone_constraints_method).lower()
        if monotone is not None and mc_method in ("intermediate",
                                                  "advanced") \
                and cfg.extra_trees:
            log.warning(f"monotone_constraints_method={mc_method} does not "
                        "compose with extra_trees; using 'basic'")
            mc_method = "basic"
        if cfg.feature_contri:
            fc_in = np.asarray(cfg.feature_contri, np.float64)
            if len(fc_in) != F:
                log.fatal(f"feature_contri has {len(fc_in)} entries but the "
                          f"dataset has {F} features")
            if np.any(fc_in != 1.0):
                contri = fc_in[used]
        return monotone, mc_method, contri

    def _interaction_groups(self, train: BinnedDataset) -> Optional[tuple]:
        """``interaction_constraints`` over ORIGINAL feature indices ->
        a tuple of tuples of USED indices (ref: col_sampler.hpp; the JAX
        package's models/gbdt.py:786-800)."""
        spec = self.config.interaction_constraints
        if not spec:
            return None
        parsed = _parse_interaction_constraints(spec)
        if not parsed:
            log.fatal(f"could not parse interaction_constraints={spec!r}; "
                      "expected e.g. \"[0,1,2],[2,3]\"")
        orig2used = _orig_to_used(train.used_feature_map)
        return tuple(tuple(orig2used[f] for f in grp if f in orig2used)
                     for grp in parsed)

    def _check_linear(self, train: BinnedDataset) -> None:
        """Linear trees need the raw features and no L1 objective (ref:
        config.cpp:426 CheckParamConflict; the JAX package's
        models/gbdt.py:863-881)."""
        cfg = self.config
        if train.raw is None:
            log.fatal("linear_tree requires the training Dataset to be "
                      "constructed with linear_tree=true in its params "
                      "(raw feature values are needed; datasets loaded "
                      "from binary files do not carry them)")
        if cfg.zero_as_missing:
            log.fatal("zero_as_missing must be false when fitting linear "
                      "trees")
        if self.objective is not None and \
                getattr(self.objective, "NAME", "") == "regression_l1":
            log.fatal("Cannot use regression_l1 objective when fitting "
                      "linear trees")

    def _load_forced_splits(self, train: BinnedDataset) -> Optional[tuple]:
        """Parse ``forcedsplits_filename``'s JSON into the grower's forced
        prefix ``(active, slot, feature, threshold_bin)`` [L - 1] (ref:
        gbdt.cpp:91-97, serial_tree_learner ForceSplits; the JAX
        package's models/gbdt.py:1638-1692). Slots follow the grower:
        splitting slot s at step i keeps the left child in s and puts the
        right child in slot i + 1. A forced split on an unused or a
        categorical feature ends the prefix there."""
        cfg = self.config
        if not cfg.forcedsplits_filename:
            return None
        import json
        from collections import deque
        with open(cfg.forcedsplits_filename) as f:
            root = json.load(f)
        if not root or "feature" not in root:
            return None
        orig2used = _orig_to_used(train.used_feature_map)
        L = cfg.num_leaves
        active = np.zeros(L - 1, bool)
        slot = np.zeros(L - 1, np.int32)
        feat = np.zeros(L - 1, np.int32)
        thr = np.zeros(L - 1, np.int32)
        q = deque([(root, 0)])
        step = 0
        while q and step < L - 1:
            node, s = q.popleft()
            f_orig = int(node["feature"])
            if f_orig not in orig2used:
                log.warning(f"forced split on unused feature {f_orig}; "
                            "stopping forced prefix here")
                break
            mapper = train.bin_mappers[f_orig]
            if mapper.bin_type == "categorical":
                log.warning(f"forced split on categorical feature {f_orig} "
                            "is not supported; stopping forced prefix here")
                break
            # the left side is value <= threshold: bin(threshold) (ref:
            # Dataset::BinThreshold)
            active[step] = True
            slot[step] = s
            feat[step] = orig2used[f_orig]
            thr[step] = int(mapper.value_to_bin(
                np.asarray([float(node["threshold"])]))[0])
            for key, child_slot in (("left", s), ("right", step + 1)):
                child = node.get(key)
                if isinstance(child, dict) and "feature" in child and \
                        "threshold" in child:
                    q.append((child, child_slot))
            step += 1
        return (active, slot, feat, thr) if active.any() else None

    def _setup_cegb(self, train: BinnedDataset) -> None:
        """Cost-effective gradient boosting's state (ref:
        cost_effective_gradient_boosting.hpp; the JAX package's
        models/gbdt.py:1694-1727): each feature's penalty is ``const +
        per_count * num_data_in_leaf``, from ``cegb_penalty_split``, the
        coupled penalty of a feature no tree has used yet and the lazy
        penalty scaled by the share of rows not yet charged for the
        feature, all tree-granular as in the JAX package. The used set
        ``[F]`` and the charged rows ``[F, N]`` (lazy only) live on the
        host in f64 arithmetic."""
        cfg = self.config
        F = self.num_used_features
        coupled = cfg.cegb_penalty_feature_coupled
        lazy = cfg.cegb_penalty_feature_lazy
        self._cegb_enabled = bool(cfg.cegb_penalty_split > 0.0 or coupled
                                  or lazy)
        if not self._cegb_enabled:
            return
        for name, pen in (("coupled", coupled), ("lazy", lazy)):
            if pen and len(pen) != train.num_total_features:
                log.fatal(f"cegb_penalty_feature_{name} should be the same "
                          "size as feature number")
        ufm = train.used_feature_map
        self._cegb_coupled = (np.asarray(coupled, np.float64)[ufm]
                              if coupled else np.zeros(F))
        self._cegb_lazy = (np.asarray(lazy, np.float64)[ufm]
                           if lazy else np.zeros(F))
        self._cegb_feature_used = np.zeros(F, bool)
        self._cegb_row_charged = (np.zeros((F, self.num_data), bool)
                                  if lazy else None)

    def _cegb_penalty(self) -> Optional[tuple]:
        """``(const [F], per_count [F])`` f32 on the training device for
        the next tree, or None (ref: the JAX package's
        models/gbdt.py:1812-1825)."""
        if not getattr(self, "_cegb_enabled", False):
            return None
        cfg = self.config
        tradeoff = cfg.cegb_tradeoff
        const = tradeoff * self._cegb_coupled * (~self._cegb_feature_used)
        per_count = np.full(self.num_used_features,
                            tradeoff * cfg.cegb_penalty_split)
        if self._cegb_row_charged is not None:
            frac_uncharged = 1.0 - self._cegb_row_charged.mean(axis=1)
            per_count = per_count + tradeoff * self._cegb_lazy * frac_uncharged
        as32 = lambda a: torch.as_tensor(a.astype(np.float32),
                                         device=self.device)
        return as32(const), as32(per_count)

    def _cegb_after_tree(self, host: HostTree, leaf_id: torch.Tensor,
                         selected: Optional[torch.Tensor]) -> None:
        """The forest's used features, and under the lazy penalty each
        in-bag row charged for the features on its leaf's path (ref: the
        JAX package's models/gbdt.py:1827-1860)."""
        if not getattr(self, "_cegb_enabled", False):
            return
        n_int = host.num_leaves - 1
        for i in range(n_int):
            self._cegb_feature_used[int(host.split_feature_inner[i])] = True
        if self._cegb_row_charged is None or n_int <= 0:
            return
        # each feature's leaves (those with it on their path), then one
        # pass over the rows a feature
        leaves_of = {}
        stack = [(0, frozenset())]
        while stack:
            node, feats = stack.pop()
            if node < 0:
                for f in feats:
                    leaves_of.setdefault(f, []).append(~node)
                continue
            f = int(host.split_feature_inner[node])
            stack.append((int(host.left_child[node]), feats | {f}))
            stack.append((int(host.right_child[node]), feats | {f}))
        leaf_np = leaf_id.cpu().numpy()
        in_bag = (None if selected is None
                  else selected.cpu().numpy() > 0)
        for f, leaves in leaves_of.items():
            rows = np.isin(leaf_np, leaves)
            if in_bag is not None:
                rows &= in_bag
            self._cegb_row_charged[f] |= rows

    def _setup_bundles(self, train: BinnedDataset) -> Optional[np.ndarray]:
        """EFB (ref: dataset.cpp:112 FindGroups; the JAX package's
        models/gbdt.py:944-1017): with ``enable_bundle`` and more than one
        used feature, bundle dense bins (``find_bundles``) or take the
        groups a sparse source was packed into. The groups' bin count
        widens ``num_bin_max``, the growers' B. Returns the host bins the
        growers read (row-major): the groups, the logical bins, or None
        under multi-value storage."""
        from ..io.bundling import find_bundles, pack_bins
        cfg = self.config
        self._bundle = None
        if self._forced is not None and cfg.enable_bundle:
            # forced splits read per-feature columns (ref: gbdt.py:948-952)
            log.warning("forced splits with EFB bundling are untested; "
                        "disabling bundling")
        if self._multival:
            if self._forced is not None:
                log.warning("forced splits are not supported with "
                            "multi-value sparse storage; ignoring")
                self._forced = None
            return None
        if cfg.enable_bundle and self._forced is None and \
                self._sharded_ingest:
            # a conflict scan over one rank's rows would bundle
            # differently on each rank (ref: gbdt.py:954-959)
            log.info("EFB bundling is disabled under sharded ingestion "
                     "(conflict scans need the global table)")
            return train.bins
        if (cfg.enable_bundle and self._forced is None and
                self.num_used_features > 1 and
                (train.bins is not None or train.bins_grouped is not None)):
            nb_used = np.asarray([train.bin_mappers[i].num_bin
                                  for i in train.used_feature_map], np.int64)
            info = (train.efb_info if train.bins_grouped is not None else
                    find_bundles(train.bins, nb_used,
                                 max_conflict_rate=cfg.max_conflict_rate))
            if info is not None:
                self.num_bin_max = int(max(self.num_bin_max,
                                           info.group_num_bin.max()))
                info.build_gather_map(self.num_bin_max)
                self._bundle = info
                log.info(f"EFB bundled {self.num_used_features} features "
                         f"into {info.num_groups} groups")
                return (train.bins_grouped if train.bins_grouped is not None
                        else pack_bins(train.bins, info))
        # a sparse source packed into groups, trained unbundled
        return train.ensure_logical_bins()

    def _make_layout(self):
        """How the growers read the stored columns (core/layout.py)."""
        from ..core.layout import BundleLayout, DenseLayout, MultivalLayout
        full = self.row_sched == "full"
        if self._bundle is not None:
            return BundleLayout(self._bundle, self.device, full)
        if self._multival:
            dflt = np.asarray([m.default_bin for m in
                               self.train_set.used_bin_mappers()], np.int32)
            return MultivalLayout(dflt, self.num_bin_max, self.device, full)
        return DenseLayout(full)

    def _make_grower(self):
        """The grower for ``row_sched`` (ref: gbdt.py:1164-1190): level
        scheduling routes pure level for ``1 <= max_depth <=
        MAX_LEVEL_DEPTH`` and hybrid otherwise."""
        gcfg, meta, layout = self.grower_cfg, self.feature_meta, self._layout
        if self.row_sched != "level":
            # compact or full, by gcfg.row_sched
            hist_fn = None
            if self._multival:
                from ..core.layout import multival_hist
                hist_fn = multival_hist
            if self._tree_learner != "serial":
                return self._make_learner(hist_fn)
            hooks = None
            inj = make_injected_hooks(self._inj)
            if inj is not None:
                hooks = GrowerHooks(reduce_hist=inj["reduce_hist"],
                                    reduce_sums=inj["reduce_sums"],
                                    reduce_max=inj["reduce_max"])
            return make_tree_grower(gcfg, meta, hist_fn=hist_fn,
                                    layout=layout, forced=self._forced,
                                    hooks=hooks)
        if 1 <= gcfg.max_depth <= MAX_LEVEL_DEPTH:
            return make_level_grower(gcfg, meta, layout=layout)
        d0 = int(self.config.tpu_level_handoff_depth)
        if d0 > MAX_LEVEL_DEPTH:
            log.warning(f"tpu_level_handoff_depth={d0} exceeds "
                        f"MAX_LEVEL_DEPTH={MAX_LEVEL_DEPTH}; clamping")
        return make_hybrid_grower(gcfg, meta, handoff_depth=d0, layout=layout)

    def _hist_budget(self) -> Tuple[int, int]:
        """(bytes of one [G, B, 3] histogram, the budget in bytes): the one
        histogram memory rule, shared by the compact pool policy and the
        hybrid's eligibility (ref: the JAX package's models/gbdt.py
        1730-1745). G is the stored (physical) column count: the EFB
        groups, else the used features; the budget is
        ``histogram_pool_size`` MB, 4 GiB when unset."""
        cfg = self.config
        n_phys = (self._bundle.num_groups if self._bundle is not None
                  else self.num_used_features)
        row_bytes = n_phys * self.num_bin_max * 3 * 4
        limit_bytes = (int(cfg.histogram_pool_size * (1 << 20))
                       if cfg.histogram_pool_size >= 0 else 4 << 30)
        return row_bytes, limit_bytes

    def _pool_policy(self) -> None:
        """The compact grower's histogram pool (ref: histogram_pool_size,
        the LRU HistogramPool of feature_histogram.hpp:1368; the JAX
        package's models/gbdt.py:1080-1126): the full ``[L, G, B, 3]``
        pool within the budget; past it, a bounded LRU pool of as many
        slots as fit, at least 2 (not under multi-value storage), else
        no pool."""
        slot_bytes, limit_bytes = self._hist_budget()
        pool_bytes = self.config.num_leaves * slot_bytes
        if pool_bytes <= limit_bytes:
            return
        n_slots = int(limit_bytes // max(slot_bytes, 1))
        if self._forced is not None:
            log.warning("histogram pool exceeds the budget but forced "
                        "splits need it; keeping the full pool")
        elif (self.grower_cfg.mc_method in ("intermediate", "advanced")
              and self.feature_meta is not None
              and self.feature_meta.monotone is not None):
            log.warning("histogram pool exceeds the budget but "
                        "monotone_constraints_method=intermediate re-scans "
                        "from it; keeping the full pool")
        elif (n_slots >= 2 and not self._multival and
              self._tree_learner == "serial" and self._inj is None):
            self.grower_cfg = dataclasses.replace(
                self.grower_cfg, hist_pool="bounded", pool_slots=n_slots)
            log.info(f"histogram pool ({pool_bytes >> 20} MB) exceeds the "
                     f"budget; bounded LRU pool with {n_slots} slots "
                     "(recompute on miss)")
        else:
            self.grower_cfg = dataclasses.replace(self.grower_cfg,
                                                  hist_pool="none")
            log.info(f"histogram pool ({pool_bytes >> 20} MB) exceeds the "
                     "budget; computing per-split child histograms "
                     "without a pool")

    def _level_ineligibility(self) -> List[str]:
        """Reasons level scheduling cannot serve this config, in the JAX
        package's words (ref: gbdt.py:1747-1810), for what the port
        accepts: a distributed learner or injected collectives (another
        learner's layout), the settings whose sequential, step-by-step
        state feeds
        later split decisions (monotone and interaction constraints,
        CEGB, forced splits, extra_trees' per-split draws, linear trees),
        per-node column sampling (one mask a level there), and memory:
        the hybrid keeps the full [L, G, B, 3] pool for its tail and
        every level histogram [T, G, B, 3] (T = 2^(D0+1) - 1) for seeding
        it, and both together must fit the histogram budget
        (``_hist_budget``, over the stored columns: EFB groups, not
        logical features)."""
        cfg = self.config
        reasons = []
        if self._tree_learner != "serial":
            reasons.append(f"tree_learner={self._tree_learner!r}")
        if self._inj is not None:
            reasons.append("injected collectives")
        if self.grower_cfg.hparams.monotone_penalty > 0 or (
                self.feature_meta is not None and
                self.feature_meta.monotone is not None):
            reasons.append("monotone constraints")
        if self.grower_cfg.interaction_groups is not None:
            reasons.append("interaction constraints")
        if (cfg.cegb_penalty_split > 0.0 or
                cfg.cegb_penalty_feature_coupled or
                cfg.cegb_penalty_feature_lazy):
            reasons.append("CEGB penalties")
        if self._forced is not None:
            reasons.append("forced splits")
        if self.grower_cfg.extra_trees:
            reasons.append("extra_trees")
        # the level scan gives every node of a level one mask
        if self._bynode:
            reasons.append("feature_fraction_bynode")
        if cfg.linear_tree:
            reasons.append("linear trees")
        if 1 <= cfg.max_depth <= MAX_LEVEL_DEPTH or self.feature_meta is None:
            return reasons
        d0 = resolve_handoff_depth(cfg.num_leaves,
                                   cfg.tpu_level_handoff_depth)
        row_bytes, limit_bytes = self._hist_budget()
        need_bytes = (cfg.num_leaves + 2 ** (d0 + 1) - 1) * row_bytes
        if need_bytes > limit_bytes:
            reasons.append(f"histogram memory over budget ({need_bytes >> 20}"
                           " MB for the hybrid's full pool + level-phase "
                           "hists)")
        return reasons

    def add_train_metrics(self, metrics: List[Metric]) -> None:
        for m in metrics:
            m.init(self.train_set.metadata, self.num_data)
        self.train_metrics = list(metrics)

    def _boost_from_average(self, k: int) -> float:
        """ref: gbdt.cpp:328 BoostFromAverage."""
        if (len(self.models) == 0 and not self.has_init_score and
                self.objective is not None and
                (self.config.boost_from_average or
                 self.num_used_features == 0)):
            init_score = float(self.objective.boost_from_score(k))
            inj = self._inj
            if inj is not None and inj["num_machines"] > 1:
                # each worker's rows give its own score: the mean over
                # machines (ref: gbdt.cpp:322 GlobalSyncUpByMean; the JAX
                # package's models/gbdt.py:1890-1903)
                from ..distributed import retried_collective
                tot = retried_collective(
                    inj["reduce_sum"], np.asarray([init_score], np.float64),
                    what="init-score sync")
                init_score = float(tot[0]) / inj["num_machines"]
            if abs(init_score) > K_EPSILON:
                self.score[k] += init_score
                for vd in self.valid_sets:
                    vd.score[k] += init_score
                log.info(f"Start training from score {init_score:.6f}")
                return init_score
        return 0.0

    def _gradients(self, gradients, hessians
                   ) -> Tuple[List[float], torch.Tensor, torch.Tensor]:
        """This iteration's init scores and f32 ``[K, N]`` gradients and
        hessians (ref: the JAX package's models/gbdt.py:2211-2233): from
        the objective over the whole score before any tree of the
        iteration is added (``[N]`` for K == 1, ``[K, N]`` otherwise),
        after boosting from the average; or the caller's class-major
        ``[K * N]`` arrays, with no boost from the average. Lambdarank
        with positions adds its f32 position biases to the score before
        the pairwise pass, then updates them on the host in f64 from the
        lambdas and hessians (ref: gbdt.py:1199-1206, 2216-2223)."""
        K, N = self.num_tree_per_iteration, self.num_data
        if gradients is not None and hessians is not None:
            as_kn = lambda a: torch.as_tensor(
                np.asarray(a, np.float32).reshape(K, N), device=self.device)
            return [0.0] * K, as_kn(gradients), as_kn(hessians)
        init_scores = [self._boost_from_average(k) for k in range(K)]
        obj = self.objective
        if getattr(obj, "uses_position_bias", False):
            biases = torch.as_tensor(obj.pos_biases, dtype=torch.float32,
                                     device=self.device)
            grad, hess = obj.get_gradients(self.score[0], biases)
            obj.update_position_bias(grad.cpu().numpy().astype(np.float64),
                                     hess.cpu().numpy().astype(np.float64))
            return init_scores, grad[None, :], hess[None, :]
        if K == 1:
            grad, hess = obj.get_gradients(self.score[0])
            return init_scores, grad[None, :], hess[None, :]
        grad, hess = obj.get_gradients(self.score)
        return init_scores, grad, hess

    def _async_on(self) -> bool:
        """Whether ``tpu_async_boosting`` applies, resolved once with the
        JAX package's conditions word for word (ref: models/gbdt.py
        357-396): plain GBDT with an objective, no linear leaves, no
        CEGB, no quantized or objective leaf renewal, no position bias,
        a sampler that reads no gradients or draws on the device (GOSS's
        ``sample_dev``), and every class trained. ``auto`` is on when the
        training device is CUDA.

        The JAX package's asynchronous loop keeps grown trees on the
        device and materializes them later; the port's grower already
        returns host trees, so asynchronous here means what changes the
        model and what saves a read: GOSS draws on the device from the
        stateless chain ``fold_in(PRNGKey(bagging_seed), iter)``, and no
        ``[K, N]`` gradient reaches the host. Every other result is the
        synchronous path's."""
        if self._async_mode is None:
            mode = str(self.config.tpu_async_boosting).lower()
            want = (self.device is not None and self.device.type == "cuda"
                    if mode == "auto"
                    else mode in ("true", "1", "yes", "on"))
            obj = self.objective
            self._async_mode = bool(
                want and self.NAME == "gbdt"
                and self._grow is not None
                and obj is not None
                and not self._linear
                and not self._cegb_enabled
                and not (self.grower_cfg.quantized and
                         self.config.quant_train_renew_leaf)
                and not obj.is_renew_tree_output()
                and not getattr(obj, "uses_position_bias", False)
                and (not self.sample_strategy.needs_grad or
                     hasattr(self.sample_strategy, "sample_dev"))
                and all(self.class_need_train))
            if want and not self._async_mode:
                log.info("tpu_async_boosting: falling back to the "
                         "synchronous path (a per-iteration host step is "
                         "required by the active features)")
        return self._async_mode

    def _row_sample(self, grad: torch.Tensor, hess: torch.Tensor,
                    on_device: bool = False
                    ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """This iteration's ``(bag, weight)`` as f32 ``[N]`` on the
        training device, or None (ref: the JAX package's models/gbdt.py
        2251-2290 and 589-611). GOSS draws on the device under
        asynchronous boosting (``on_device``), and so does every later
        iteration once it has (a synchronous iteration re-derives the
        same stateless draw); else it reads the ``[K, N]`` gradients to
        the host once. ``tpu_device_bagging`` draws on the device; the
        other samplers draw on the host and the mask is uploaded once
        (bagging returns one array as both)."""
        strat = self.sample_strategy
        if strat.needs_grad and (on_device or self._goss_dev_used):
            pair = strat.sample_dev(
                self.iter, grad, hess, prng.fold_in(self._bag_key,
                                                    self.iter))
            if pair is not None:
                self._goss_dev_used = True
            return pair
        if strat.needs_grad:
            pair = strat.sample(self.iter, grad.cpu().numpy(),
                                hess.cpu().numpy())
        else:
            pair = strat.sample_dev(self.iter, self._bag_key, self.device)
            if pair is None:
                pair = strat.sample(self.iter)
        if pair is None:
            return None
        sel, weight = pair
        sel_dev = torch.as_tensor(sel, device=self.device)
        w_dev = (sel_dev if weight is sel
                 else torch.as_tensor(weight, device=self.device))
        return sel_dev, w_dev

    def _feature_mask(self) -> Optional[torch.Tensor]:
        """Column sampling (ref: col_sampler.hpp; the JAX package's
        models/gbdt.py:1862-1888): ``feature_fraction`` draws one ``[F]``
        mask a tree; ``feature_fraction_bynode`` then draws ``[2L, F]``,
        one row a node (root 0, the children of split i 2i+1 and 2i+2)
        within the tree's subset. None when no column is sampled."""
        cfg = self.config
        frac = cfg.feature_fraction
        F = self.num_used_features
        tree_mask = np.ones(F, bool)
        if frac < 1.0 and F > 1:
            n_take = max(1, min(F, int(round(F * frac))))
            tree_mask = np.zeros(F, bool)
            tree_mask[self._col_rng.choice(F, size=n_take,
                                           replace=False)] = True
        if not self._bynode:
            if frac >= 1.0 or F <= 1:
                return None
            return torch.as_tensor(tree_mask, device=self.device)
        L = cfg.num_leaves
        base_idx = np.flatnonzero(tree_mask)
        n_node = max(1, int(round(len(base_idx) *
                                  cfg.feature_fraction_bynode)))
        masks = np.zeros((2 * L, F), bool)
        for i in range(2 * L):
            masks[i, self._col_rng.choice(base_idx, size=n_node,
                                          replace=False)] = True
        return torch.as_tensor(masks, device=self.device)

    def _grow_tree(self, k: int, gh: torch.Tensor
                   ) -> Tuple[object, torch.Tensor]:
        """Class k's tree of this iteration from its ``[N, 3]`` gh, with
        the tree's column sample, CEGB penalties and threefry draws: the
        JAX package's chain ``fold_in(key, iteration * K + k)``, keyed by
        iterations trained here, not an init model's (ref:
        gradient_discretizer.cpp random_values_use_start), split into
        stochastic rounding's two draws and folded with 7919 into
        extra_trees' key."""
        uniforms = et_key = key_u = None
        if self._rng_key is not None:
            tree_key = prng.fold_in(
                self._rng_key, self.iter * self.num_tree_per_iteration + k)
            gcfg = self.grower_cfg
            if gcfg.quantized and gcfg.stochastic_rounding:
                key_u = tree_key
            if gcfg.extra_trees:
                et_key = prng.fold_in(tree_key, 7919)
        # the level growers take neither: those settings leave them
        extras = {k: v for k, v in (("cegb", self._cegb_penalty()),
                                    ("et_key", et_key)) if v is not None}
        if self._dist is not None:
            # the learner draws each rank's own uniforms from key_u
            return self._dist.grow(gh, key_u, self._feature_mask(), **extras)
        if key_u is not None:
            if self._inj is not None:
                # each worker rounds its own rows with its own noise (the
                # JAX package's localize_key, distributed.py:614-617)
                key_u = prng.fold_in(key_u, self._inj["rank"])
            uniforms = tuple(prng.uniform(key, self.num_data, self.device)
                             for key in prng.split(key_u))
        return self._grow(self.bins, gh, uniforms, self._feature_mask(),
                          **extras)

    def train_one_iter(self, gradients: Optional[np.ndarray] = None,
                       hessians: Optional[np.ndarray] = None) -> bool:
        """One boosting iteration (ref: gbdt.cpp:353 TrainOneIter).
        Returns True when training should stop (no more valid splits).

        The liveness shell around the body (ref: the JAX package's
        models/gbdt.py:2164-2200): the ``rank_kill`` site, a beat, and
        the stall watchdog armed while the iteration is in flight, so a
        Python-level wait that never ends surfaces as
        ``DeviceStallError`` (the watchdog's interrupt arrives as a
        ``KeyboardInterrupt``, which is mapped to it; a real Ctrl-C with
        no stall armed propagates untouched)."""
        faults.maybe_kill_rank(self._process_rank)
        wd = self._hb_iter_begin()
        try:
            done = self._train_one_iter_body(
                gradients, hessians,
                gradients is None and hessians is None and self._async_on())
            self._hb_warm = True
            if not done:
                self._gang_digest_check()
            return done
        except KeyboardInterrupt:
            if wd is not None:
                wd.check()
            raise
        finally:
            if wd is not None:
                wd.end()

    def _gang_digest_check(self) -> None:
        """The gang's agreement check (ref: the JAX package's
        models/gbdt.py:2136-2165): every ``tpu_integrity_digest_every``
        iterations the ranks all-reduce a CRC digest of the iteration's
        trees, encoded so the sum alone decides agreement
        (``integrity.check_digest_reduction``), over the injected
        ``reduce_sum`` or the learner's world; a disagreement raises
        ``GangDivergence`` on every rank. ``bitflip:where=digest`` makes
        this rank's digest lie. A no-op in a world of one."""
        every = int(self.config.tpu_integrity_digest_every or 0)
        inj, comm = self._inj, self._comm
        world = (int(inj["num_machines"]) if inj is not None
                 else comm.world if comm is not None else 1)
        if every <= 0 or world <= 1 or self.iter % every != 0:
            return
        from ..distributed import retried_collective
        K = self.num_tree_per_iteration
        digest = integrity.iteration_digest(self.models[-K:])
        if faults.check("bitflip", where="digest"):
            log.warning("fault injection: bit-flipped this rank's tree "
                        "digest before the gang agreement sync")
            digest ^= 0x1
        enc = integrity.digest_reduction(digest)
        if inj is not None:
            rank = int(inj["rank"])
            total = np.asarray(retried_collective(
                inj["reduce_sum"], enc, what="integrity tree-digest sync"))
        else:
            rank = comm.rank
            total = comm.all_reduce_sum(
                torch.as_tensor(enc, device=comm.device),
                kind="digest").cpu().numpy()
        integrity.check_digest_reduction(total, world, digest, self.iter,
                                         rank=rank, what="gang")

    def _hb_iter_begin(self):
        """Beat the process heartbeat and arm the stall watchdog for one
        iteration (ref: the JAX package's models/gbdt.py:2067-2082). The
        phase is ``compiling`` until the first iteration completed (the
        kernels build at their first launch, inside it), then ``iter``
        with the iteration counter. Returns the armed watchdog, None
        when unsupervised."""
        hb = heartbeat.current()
        if hb is None:
            return None
        wd = heartbeat.training_watchdog(self._hb_policy)
        wd.check()                  # a stall armed while we were away
        wd.begin()
        self._hb_sync_beat()
        return wd

    def _hb_sync_beat(self) -> None:
        """Beat right before a blocking device read, so the beat age a
        watchdog or supervisor measures starts at the read."""
        hb = heartbeat.current()
        if hb is not None:
            hb.beat(heartbeat.PHASE_ITER if self._hb_warm
                    else heartbeat.PHASE_COMPILING, self.iter)

    def _numeric_guard(self) -> Optional[integrity.NumericHealthGuard]:
        """The numeric-health guard under ``tpu_integrity_numeric_guard``
        (off by default), built at first use with
        ``tpu_integrity_loss_spike_factor`` (ref: the JAX package's
        models/gbdt.py:2094-2113)."""
        if not self.config.tpu_integrity_numeric_guard:
            return None
        if self._nguard is None:
            self._nguard = integrity.NumericHealthGuard(
                spike_factor=float(
                    self.config.tpu_integrity_loss_spike_factor),
                what="training")
        return self._nguard

    def _guard_sums(self, grad: torch.Tensor, hess: torch.Tensor
                    ) -> Tuple[float, float, float]:
        """(sum g, sum h, mean |g|) over ``[K, N]``: one reduction over
        the three stacked and one copy of three f32 scalars to the host,
        the guard's whole device cost (ref: the JAX package's
        models/gbdt.py:2115-2125). mean |g| is the loss proxy the spike
        check watches."""
        sums = torch.stack((grad, hess, grad.abs())).sum(dim=(1, 2))
        gs, hs, ga = sums.cpu().tolist()
        return gs, hs, ga / grad.numel()

    def _check_gradients(self, grad: torch.Tensor, hess: torch.Tensor
                         ) -> torch.Tensor:
        """The ``nan_grad`` site and the guard, before any tree grows
        (ref: the JAX package's models/gbdt.py:2229-2245): the site
        poisons one gradient with NaN; the armed guard refuses
        non-finite sums and a spike of the loss proxy."""
        if faults.check("nan_grad"):
            log.warning("fault injection: poisoning this iteration's "
                        "gradient stream with NaN (silent data "
                        "corruption)")
            grad = grad.clone()
            grad[0, 0] = float("nan")
        guard = self._numeric_guard()
        if guard is not None:
            self._hb_sync_beat()
            gsum, hsum, gabs = self._guard_sums(grad, hess)
            guard.check_gradients(gsum, hsum, self.iter)
            guard.observe_loss(gabs, self.iter, what="loss proxy")
        return grad

    def _train_one_iter_body(self, gradients: Optional[np.ndarray],
                             hessians: Optional[np.ndarray],
                             on_device: bool) -> bool:
        """The boosting iteration: K trees, one per class, each through
        the same grower, from one row sample (GOSS drawn on the device
        when ``on_device``)."""
        K = self.num_tree_per_iteration
        # the section table of LIGHTGBM_TPU_TIMETAG under the JAX
        # package's names (ref: its models/gbdt.py:2214-2405); sync= waits
        # for the card only while the timer is on
        with global_timer.section("GBDT::Boosting", sync=lambda: grad):
            init_scores, grad, hess = self._gradients(gradients, hessians)
        grad = self._check_gradients(grad, hess)
        sample = self._row_sample(grad, hess, on_device)
        guard = self._numeric_guard()
        should_continue = False
        for k in range(K):
            if not self.class_need_train[k] or self._grow is None:
                self.models.append(HostTree.constant(init_scores[k]))
                continue
            g, h = grad[k], hess[k]
            with global_timer.section("TreeLearner::Train",
                                      sync=lambda: leaf_id):
                tree, leaf_id = self._grow_tree(k, sampled_gh(g, h, sample))
            # the grower already returns host arrays, so this section
            # holds only their conversion into a HostTree (the JAX
            # package's also holds the device-to-host fetch)
            with global_timer.section("Tree::ToHost"):
                host = HostTree(tree, self.train_set.used_feature_map)
            if host.num_leaves <= 1:
                # no valid split for this class this iteration
                if len(self.models) < K:
                    if (self.objective is not None and
                            not self.config.boost_from_average and
                            not self.has_init_score):
                        init_scores[k] = float(
                            self.objective.boost_from_score(k))
                        self.score[k] += init_scores[k]
                        for vd in self.valid_sets:
                            vd.score[k] += init_scores[k]
                    self.models.append(HostTree.constant(init_scores[k]))
                else:
                    self.models.append(HostTree.constant(0.0))
                continue
            should_continue = True
            finalize_tree(host, self.train_set.bin_mappers)
            self._cegb_after_tree(host, leaf_id,
                                  None if sample is None else sample[0])
            renew_quant = (self.grower_cfg.quantized and
                           self.config.quant_train_renew_leaf)
            renew_objective = (self.objective is not None and
                               self.objective.is_renew_tree_output())
            if renew_quant or renew_objective or self._linear:
                leaf_np = leaf_id.cpu().numpy()
            if self._linear:
                # ref: LinearTreeLearner::CalculateLinear; the first tree
                # of a run stays constant (gbdt.py:2340-2346)
                w_np = (None if sample is None else
                        (sample[1] * sample[0]).cpu().numpy())
                self._fit_linear_leaves(
                    host, leaf_np, g.cpu().numpy(), h.cpu().numpy(), w_np,
                    is_first_tree=(len(self.models) < K and
                                   self.num_init_iteration == 0))
            if renew_quant:
                # the full row weight, amplification included, as the
                # tree was grown with
                w_np = (None if sample is None else
                        (sample[1] * sample[0]).cpu().numpy())
                self._renew_quant_leaves(host, leaf_np, g.cpu().numpy(),
                                         h.cpu().numpy(), w_np)
            if renew_objective:
                if sample is not None:
                    # the percentiles over the bag's rows only
                    leaf_np = np.where(sample[0].cpu().numpy() > 0,
                                       leaf_np, -1)
                self._renew_tree_output(host, k, leaf_np)
            with global_timer.section("GBDT::UpdateScore",
                                      sync=lambda: self.score):
                if host.is_linear:
                    # a linear tree shrinks first and adds its f64 linear
                    # outputs rounded to f32 (ref: gbdt.py:2387-2394)
                    host.shrink(self.shrinkage_rate)
                    self.score[k] += torch.as_tensor(
                        host.linear_output(self.train_set.raw, leaf_np).astype(
                            np.float32), device=self.device)
                else:
                    # two roundings: the product, then the accumulate
                    lv = torch.as_tensor(
                        host.leaf_value[:host.num_leaves].astype(np.float32),
                        device=self.device)
                    delta = lv[leaf_id] * torch.tensor(
                        self.shrinkage_rate, dtype=torch.float32,
                        device=self.device)
                    self.score[k] += delta
                    host.shrink(self.shrinkage_rate)
            # the shrunk leaf value is the f32 product added above: the
            # valid sets get it before the bias is folded in, as the
            # training score did (ref: gbdt.py:2406-2418)
            with global_timer.section(
                    "GBDT::UpdateValidScore",
                    sync=lambda: [vd.score for vd in self.valid_sets]):
                for vd in self.valid_sets:
                    vd.score[k] += self._tree_outputs(host, vd.bins,
                                                      vd.dataset.raw)
            if abs(init_scores[k]) > K_EPSILON:
                host.add_bias(init_scores[k])
            if guard is not None:
                guard.check_leaves(host.leaf_value[:host.num_leaves],
                                   self.iter)
            self.models.append(host)

        if not should_continue:
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if len(self.models) > K:
                del self.models[-K:]
            return True
        self.iter += 1
        return False

    def _fit_linear_leaves(self, host: HostTree, leaf_np: np.ndarray,
                           grad: np.ndarray, hess: np.ndarray,
                           weight: Optional[np.ndarray],
                           is_first_tree: bool) -> None:
        """A ridge fit in every leaf over the NUMERICAL features on its
        path, on the host in f64 (ref: linear_tree_learner.cpp
        CalculateLinear, coeffs = -(X'HX + lambda I)^-1 X'g, Eq 3 of
        arXiv:1802.05640; the JAX package's models/gbdt.py:2439-2510):
        rows with a NaN among the leaf's features are left out, a leaf
        with too few usable rows stays constant, and coefficients with
        ``|coef| <= 1e-35`` are dropped."""
        host.is_linear = True
        host._init_linear_fields()
        n = host.num_leaves
        host.leaf_const[:] = host.leaf_value[:n]
        if is_first_tree:
            return
        raw = self.train_set.raw
        lam = float(self.config.linear_lambda)
        mappers = self.train_set.bin_mappers
        # each leaf's sorted numerical ORIGINAL path features
        path_feats = {}
        stack = [(0, [])]
        while stack:
            node, feats = stack.pop()
            if node < 0:
                path_feats[~node] = sorted(set(feats))
                continue
            f = int(host.split_feature[node])
            nxt = feats + [f] if mappers[f].bin_type == "numerical" else feats
            stack.append((int(host.left_child[node]), nxt))
            stack.append((int(host.right_child[node]), nxt))
        order = np.argsort(leaf_np, kind="stable")
        counts = np.bincount(leaf_np, minlength=n)
        starts = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        g = grad.astype(np.float64)
        h = hess.astype(np.float64)
        if weight is not None:
            g = g * weight
            h = h * weight
        for leaf, feats in path_feats.items():
            if not feats:
                continue
            rows = order[starts[leaf]:starts[leaf + 1]]
            if weight is not None:
                rows = rows[weight[rows] > 0]
            Xl = raw[np.ix_(rows, feats)].astype(np.float64)
            ok = ~np.isnan(Xl).any(axis=1)
            rows, Xl = rows[ok], Xl[ok]
            if len(rows) < len(feats) + 1:
                continue
            X1 = np.concatenate([Xl, np.ones((len(rows), 1))], axis=1)
            XTHX = (X1 * h[rows][:, None]).T @ X1
            XTHX[np.arange(len(feats)), np.arange(len(feats))] += lam
            XTg = X1.T @ g[rows]
            try:
                coeffs = -np.linalg.solve(XTHX, XTg)
            except np.linalg.LinAlgError:
                continue
            if not np.isfinite(coeffs).all():
                continue
            keep = np.abs(coeffs[:-1]) > 1e-35
            host.leaf_features[leaf] = [feats[j] for j in np.flatnonzero(keep)]
            host.leaf_coeff[leaf] = coeffs[:-1][keep]
            host.leaf_const[leaf] = coeffs[-1]

    def _renew_tree_output(self, host: HostTree, k: int,
                           leaf_np: np.ndarray) -> None:
        """The objective's leaf refit (L1, quantile, MAPE percentiles),
        on the host in f64 from class k's score before this tree is added;
        only finite values replace the grower's (ref: gbdt.cpp:418
        RenewTreeOutput; the JAX package's models/gbdt.py:2363-2382)."""
        score_k = self.score[k].cpu().numpy().astype(np.float64)
        label = self.train_set.metadata.label
        new_vals = self.objective.renew_tree_output(
            score_k, lambda: label.astype(np.float64) - score_k, leaf_np,
            host.num_leaves)
        if new_vals is not None:
            old = host.leaf_value[:host.num_leaves]
            host.leaf_value[:host.num_leaves] = np.where(
                np.isfinite(new_vals), new_vals, old)

    def _renew_quant_leaves(self, host: HostTree, leaf_np: np.ndarray,
                            grad: np.ndarray, hess: np.ndarray,
                            weight: Optional[np.ndarray]) -> None:
        """Refit leaf outputs from the true f32 gradient sums after
        quantized growth, in f64 (ref: gradient_discretizer.cpp
        RenewIntGradTreeOutput; the JAX package's _renew_quant_leaves,
        models/gbdt.py:2512-2531). ``weight`` is the row sample's full
        weight (bag times GOSS's amplification), or None."""
        cfg = self.config
        n = host.num_leaves
        w = (weight.astype(np.float64) if weight is not None
             else np.ones_like(grad, np.float64))
        sg = np.bincount(leaf_np, weights=grad * w, minlength=n)[:n]
        sh = np.bincount(leaf_np, weights=hess * w, minlength=n)[:n]
        l1, l2 = cfg.lambda_l1, cfg.lambda_l2
        tg = np.sign(sg) * np.maximum(np.abs(sg) - l1, 0.0) if l1 > 0 else sg
        out = -tg / (sh + l2 + K_EPSILON)
        if cfg.max_delta_step > 0:
            out = np.clip(out, -cfg.max_delta_step, cfg.max_delta_step)
        host.leaf_value[:n] = np.where(np.isfinite(out), out,
                                       host.leaf_value[:n])

    def predict_device(self, X: np.ndarray, start_iteration: int,
                       end_iteration: int) -> np.ndarray:
        """[R, K] raw scores of iterations [start, end) through the
        packed-forest engine (ops/forest.py; ref: the JAX package's
        GBDT.predict_device, models/gbdt.py:1968-2014). With the training
        bin mappers the rows are binned on the device and the walk
        compares integer bins (exact: a split's real threshold is its
        left bin's upper bound); without them (trees carried across from
        another model) the raw-threshold route serves. Scores are f32
        sums; ``DeviceRouteUnavailable`` for what the device route cannot
        serve."""
        K = self.num_tree_per_iteration
        models = self.models
        lo, hi = start_iteration * K, end_iteration * K
        window = models[lo:hi]
        if not window:
            raise DeviceRouteUnavailable("device prediction needs a "
                                         "non-empty tree range")
        log.info_once(
            f"tpu_predict_buckets={self.config.tpu_predict_buckets}: device "
            "prediction scores each batch at its own row count whatever it "
            "says; row buckets bound the shapes the JAX package compiles, "
            "and this package compiles nothing")
        srv = self._serving_engine()
        _, gen, mappers, used = self.serving_state()
        if mappers is not None:
            out = srv.predict_binned(models, gen, X, lo, hi, mappers, used)
        else:
            out = srv.predict_raw(models, gen, X, lo, hi)
        return out.T

    def _serving_engine(self) -> ServingEngine:
        """The engine's own packed-forest engine on its device."""
        if self._serving is None:
            dev = self.device if self.device is not None else \
                resolve_device(self.config)
            self._serving = ServingEngine(self.config.num_leaves,
                                          self.num_tree_per_iteration, dev)
        return self._serving

    def explain_device(self, X: np.ndarray, start_iteration: int,
                       end_iteration: int) -> np.ndarray:
        """[R, (F+1)*K] f64 SHAP contributions of iterations [start,
        end) through the packed path tensors (ops/shap_pack.py; ref: the
        JAX package's GBDT.explain_device, models/gbdt.py:2016-2044), in
        ``core.shap.predict_contrib``'s layout (per class a block of F+1,
        bias last). The route is ``predict_device``'s; the SHAP pack rides
        the same serving engine, so it grows with training. Linear trees
        and categorical splits raise ``DeviceRouteUnavailable``."""
        K = self.num_tree_per_iteration
        lo, hi = start_iteration * K, end_iteration * K
        models, gen, mappers, used = self.serving_state()
        srv = self._serving_engine()
        n_features = self.max_feature_idx + 1
        if mappers is not None:
            return srv.explain_binned(models, gen, X, lo, hi, mappers,
                                      used, n_features)
        return srv.explain_raw(models, gen, X, lo, hi, n_features)

    def serving_state(self):
        """``(models, generation, mappers, used_feature_map)`` for a model
        server (serving/server.py): a COPY of the model list, so trees the
        training loop appends afterwards reach the server only at its next
        publish, and the one pinned mapper list (the binner and pack
        caches key on its identity); mappers None for the raw route."""
        models = list(self.models)
        if self.train_set is not None and self.train_set.bin_mappers:
            if self._serving_mappers is None:
                # pin one list so the binner and pack caches hold
                self._serving_mappers = self.train_set.used_bin_mappers()
            return (models, self._model_gen, self._serving_mappers,
                    self.train_set.used_feature_map)
        return models, self._model_gen, None, None

    # -- validation sets, rollback, continued training ------------------
    def add_valid_data(self, valid: BinnedDataset, metrics: List[Metric],
                       name: str) -> None:
        """Register a validation set binned with the training mappers and
        replay the existing trees onto its score (ref: the JAX package's
        models/gbdt.py:1604 add_valid_data)."""
        if valid.shard is not None:
            log.fatal("validation sets must be replicated: construct them "
                      "with reference=<train Dataset> (sharded ingestion "
                      "applies to the training table only)")
        if valid.bin_mappers is not self.train_set.bin_mappers:
            log.fatal(f"validation set {name!r} must be binned with the "
                      "training set's bin mappers: construct it with "
                      "reference=<the training Dataset>")
        if self._linear and valid.raw is None:
            log.fatal("linear_tree validation data was constructed without "
                      "raw features; pass the same params (incl. "
                      "linear_tree) to the valid Dataset")
        for m in metrics:
            m.init(valid.metadata, valid.num_data)
        vd = _ValidData(valid, metrics, self.num_tree_per_iteration, name,
                        self.device)
        K = self.num_tree_per_iteration
        for i, t in enumerate(self.models):
            vd.score[i % K] += self._tree_outputs(t, vd.bins, valid.raw)
        self.valid_sets.append(vd)

    def _train_bins_fm(self) -> torch.Tensor:
        """The training bins as a feature-major logical ``[F, N]`` view.
        Over EFB groups or multi-value pairs the logical bins are decoded
        once (``ensure_logical_bins``; ref: gbdt.py:1256-1264). A
        sharded-ingest train set has no such table on any rank: its
        consumers (rollback, DART) are refused (ref: gbdt.py:1248-1253)."""
        if self._sharded_ingest:
            log.fatal(
                "this operation needs the full [F, N] training table, "
                "which sharded ingestion never materializes on one host "
                "— rollback/DART/refit over a sharded train set are not "
                "supported (use tpu_ingest='replicated' for them)")
        if (self._bundle is None and not self._multival and
                self._tree_learner == "serial"):
            return self.bins if self.row_sched == "full" else self.bins.T
        if self._logical_fm is None:
            if self.train_set.bins is None:
                log.warning("densifying EFB-bundled or multi-value sparse "
                            "bins for a traversal path (rollback/DART/"
                            "continued training) — this costs the logical "
                            "bin footprint")
            self._logical_fm = feature_major_bins(
                self.train_set.ensure_logical_bins(), self.device)
        return self._logical_fm

    def _tree_outputs(self, t: HostTree, bins_fm: torch.Tensor,
                      raw: Optional[np.ndarray] = None) -> torch.Tensor:
        """f32 ``[R]``: the stored leaf value of tree ``t`` at each row's
        leaf, by the device traversal over feature-major bins ``[F, R]``
        on the training device (ref: the JAX package's models/gbdt.py:1953
        _tree_outputs). The tree's inner feature indices and bin
        thresholds must be this dataset's. A linear tree adds its f64
        linear terms over the rows' raw features ``raw`` on the host,
        rounded to f32."""
        L = max(int(t.num_leaves), 2)
        packed = upload_trees(BinnedTreeArrays,
                              [pack_binned_tree(t, L, *self._mapper_arrays)],
                              bins_fm.device)
        leaf = forest_leaf_bins(packed, bins_fm,
                                num_steps=depth_steps(t.max_depth, L))
        if t.is_linear and raw is not None:
            return torch.as_tensor(
                t.linear_output(raw, leaf[0].cpu().numpy()).astype(
                    np.float32), device=bins_fm.device)
        return packed.leaf_value.gather(1, leaf)[0]

    def rollback_one_iter(self) -> None:
        """Drop the last iteration's trees and subtract their outputs
        from the training and validation scores (ref: gbdt.cpp:463
        RollbackOneIter). Trees of an init model are not rolled back."""
        if self.iter <= 0:
            return
        K = self.num_tree_per_iteration
        bins_fm = self._train_bins_fm()
        for k in range(K):
            t = self.models[len(self.models) - K + k]
            self.score[k] -= self._tree_outputs(t, bins_fm,
                                                self.train_set.raw)
            for vd in self.valid_sets:
                vd.score[k] -= self._tree_outputs(t, vd.bins, vd.dataset.raw)
        del self.models[-K:]
        self.iter -= 1

    def init_from_model(self, other) -> None:
        """Continued training from another engine's trees (ref: CLI
        input_model; the JAX package's models/gbdt.py:2635). Trees parsed
        from text carry ORIGINAL feature indices and real thresholds:
        they are rebound to this dataset's inner indices and bins, then
        every tree's output is added to the training and validation
        scores in model order, so a model replayed from its text gives
        the score it trained with. A categorical node's bitset of raw
        categories is decoded back to this dataset's bins (ref: the JAX
        package's models/gbdt.py:2660-2676); categories this dataset
        never saw drop out of the set, as they fall in bin 0."""
        if other.num_tree_per_iteration != self.num_tree_per_iteration:
            log.fatal("Cannot continue training: num_tree_per_iteration "
                      "differs between the init model and this config")
        K = self.num_tree_per_iteration
        models = [t.copy() for t in other.models]
        self.num_init_iteration = len(models) // max(K, 1)
        inner_of = {int(orig): i for i, orig in
                    enumerate(self.train_set.used_feature_map)}
        mappers = self.train_set.bin_mappers
        for t in models:
            if not t.from_text:
                continue
            ni = t.num_leaves - 1
            cat_sets = {}
            for i in range(ni):
                f = int(t.split_feature[i])
                if f not in inner_of:
                    log.fatal(f"init model splits on feature {f} which is "
                              "trivial/absent in the new training data")
                t.split_feature_inner[i] = inner_of[f]
                m = mappers[f]
                if m.bin_type == "numerical":
                    t.threshold_bin[i] = int(m.value_to_bin(
                        np.asarray([t.threshold_real[i]]))[0])
                elif (t.decision_type[i] & 1) and t.num_cat > 0:
                    cat_sets[i] = [m.categorical_2_bin[v]
                                   for v in t.cat_values(
                                       int(t.threshold_real[i]))
                                   if v in m.categorical_2_bin]
            width = max([len(v) for v in cat_sets.values()], default=0)
            t.cat_bins_inner = np.full((ni, width), -1, np.int32)
            t.cat_count_inner = np.zeros(ni, np.int32)
            for i, bins in cat_sets.items():
                t.cat_bins_inner[i, :len(bins)] = bins
                t.cat_count_inner[i] = len(bins)
            t.from_text = False
        self.models = models
        if self._sharded_ingest:
            # each rank replays a tree over its own rows and the per-row
            # outputs are all-gathered into the global order, one
            # all-gather a tree, each added to the score as the
            # replicated replay adds it: the same score bit for bit
            # (ref: gbdt.py:2679-2703)
            from ..distributed import allgather_bytes
            bins_fm = feature_major_bins(self.train_set.bins, self.device)
        else:
            bins_fm = self._train_bins_fm()
        for i, t in enumerate(self.models):
            k = i % K
            if self._sharded_ingest:
                local = self._tree_outputs(t, bins_fm).cpu().numpy()
                parts = allgather_bytes(
                    local.tobytes(),
                    what="sharded ingest: continued-training replay")
                self.score[k] += torch.as_tensor(np.concatenate(
                    [np.frombuffer(p, np.float32) for p in parts]),
                    device=self.device)
            else:
                self.score[k] += self._tree_outputs(t, bins_fm,
                                                    self.train_set.raw)
            for vd in self.valid_sets:
                vd.score[k] += self._tree_outputs(t, vd.bins, vd.dataset.raw)

    # -- evaluation -----------------------------------------------------
    def _device_eval(self) -> bool:
        """Metrics on the score's device (``tpu_device_eval``: auto is on
        for the card), else on the host in f64 from the score read back."""
        mode = str(self.config.tpu_device_eval).lower()
        if mode == "auto":
            return self.device is not None and self.device.type == "cuda"
        return mode in ("true", "1", "yes")

    def _eval(self, metrics: List[Metric], score: torch.Tensor,
              data_name: str) -> List[Tuple[str, str, float, bool]]:
        """``(data_name, metric, value, is_higher_better)`` of each metric
        over a ``[K, N]`` score, in metric order (ref: the JAX package's
        models/gbdt.py:2711). On the device every value of the metrics
        with a device form comes back in one read; the others are
        evaluated on the host from one read of the score."""
        view = score[0] if self.num_tree_per_iteration == 1 else score
        on_device = self._device_eval()
        results = [m.eval_device(view, self.objective) if on_device
                   else None for m in metrics]
        scalars = [v for dev in results if dev is not None
                   for _, v, _ in dev]
        fetched = iter(torch.stack(scalars).cpu().tolist() if scalars
                       else [])
        view_np = None
        out = []
        for m, dev in zip(metrics, results):
            if dev is None:
                if view_np is None:
                    view_np = view.cpu().numpy().astype(np.float64)
                dev = m.eval(view_np, self.objective)
            else:
                dev = [(name, next(fetched), hib) for name, _, hib in dev]
            out.extend((data_name, name, float(value), hib)
                       for name, value, hib in dev)
        return out

    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        return self._eval(self.train_metrics, self.score, "training")

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        return [r for vd in self.valid_sets
                for r in self._eval(vd.metrics, vd.score, vd.name)]

    def current_iteration(self) -> int:
        return len(self.models) // max(self.num_tree_per_iteration, 1)

    def rng_snapshot(self) -> dict:
        """JSON-serializable states of the host generators that advance
        per iteration or tree, the row sampler's and the column
        sampler's (ref: the JAX package's models/gbdt.py:2609-2622).
        Restored before the next iteration (``restore_rng``), a resumed
        run draws the masks an uninterrupted run would have; the device
        draws (GOSS under asynchronous boosting, ``tpu_device_bagging``)
        are stateless ``fold_in(key, iter)`` chains and need none."""
        samp = getattr(self.sample_strategy, "rng", None)
        col = getattr(self, "_col_rng", None)
        return {
            "sampler": samp.bit_generator.state if samp is not None
            else None,
            "col": col.bit_generator.state if col is not None else None,
        }

    def restore_rng(self, snapshot: dict) -> None:
        """Inverse of ``rng_snapshot``; missing entries are left alone."""
        if not snapshot:
            return
        samp = getattr(self.sample_strategy, "rng", None)
        if samp is not None and snapshot.get("sampler"):
            samp.bit_generator.state = snapshot["sampler"]
        if snapshot.get("col") and getattr(self, "_col_rng", None) \
                is not None:
            self._col_rng.bit_generator.state = snapshot["col"]


def sampled_gh(g: torch.Tensor, h: torch.Tensor,
               sample: Optional[Tuple[torch.Tensor, torch.Tensor]]
               ) -> torch.Tensor:
    """A tree's ``[N, 3]`` histogram input: ``[g, h, 1]``, or under the
    row sample ``(bag, weight)`` ``[g·w, h·w, bag]`` (ref: the JAX
    package's models/gbdt.py:2296-2300)."""
    if sample is None:
        return torch.stack([g, h, torch.ones_like(g)], dim=1)
    bag, w = sample
    return torch.stack([g * w, h * w, bag], dim=1)


_MISSING_BITS = {"none": 0, "zero": 1, "nan": 2}


def finalize_tree(host: HostTree, bin_mappers) -> None:
    """Resolve a host tree's bin thresholds to real values and pack its
    decision_type bits, from the bin mappers of its ORIGINAL features
    (ref: tree.h kCategoricalMask=1, kDefaultLeftMask=2, missing type in
    bits 2-3; Tree::Split stores RealThreshold = bin upper bound). A
    categorical node's set of bins becomes a bitset over its RAW
    category values (ref: Tree::SplitCategorical cat_threshold_ /
    cat_boundaries_, Common::ConstructBitset), and its threshold the
    index of that bitset; the JAX package's models/gbdt.py:2538-2582."""
    n_int = host.num_leaves - 1
    thr_real = np.zeros(n_int, np.float64)
    dtype_bits = np.zeros(n_int, np.int32)
    cat_boundaries = [0]
    cat_words: List[np.ndarray] = []
    for i in range(n_int):
        m = bin_mappers[host.split_feature[i]]
        tb = int(host.threshold_bin[i])
        if m.bin_type == "categorical":
            k = int(host.cat_count_inner[i])
            cats = [m.bin_2_categorical[b]
                    for b in host.cat_bins_inner[i][:k]
                    if 0 < b < len(m.bin_2_categorical)
                    and m.bin_2_categorical[b] >= 0]
            words = np.zeros((max(cats) // 32 + 1) if cats else 1,
                             np.uint32)
            for v in cats:
                words[v // 32] |= np.uint32(1) << np.uint32(v % 32)
            thr_real[i] = float(len(cat_boundaries) - 1)
            cat_boundaries.append(cat_boundaries[-1] + len(words))
            cat_words.append(words)
            dtype_bits[i] |= 1
        else:
            thr_real[i] = m.bin_upper_bound[min(tb,
                                                len(m.bin_upper_bound) - 1)]
        if host.default_left[i]:
            dtype_bits[i] |= 2
        dtype_bits[i] |= _MISSING_BITS[m.missing_type] << 2
    host.threshold_real = thr_real
    host.decision_type = dtype_bits
    host.num_cat = len(cat_words)
    host.cat_boundaries = np.asarray(cat_boundaries, np.int64)
    host.cat_threshold = (np.concatenate(cat_words) if cat_words
                          else np.zeros(0, np.uint32))
