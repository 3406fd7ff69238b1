"""Gradient boosting engine, serial path.

Port of ``lightgbm_tpu/models/gbdt.py`` ``GBDT`` (ref:
src/boosting/gbdt.h:28, gbdt.cpp:353 TrainOneIter): a serial,
synchronous run, no guards or fault sites. An iteration grows K trees, one per
class (K = 1 but for the multiclass objectives and a custom objective
with ``num_class`` > 1), each through the same grower, from gradients
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
from ..core.grower import GrowerConfig, make_tree_grower
from ..core.hybrid_grower import make_hybrid_grower, resolve_handoff_depth
from ..core.level_grower import MAX_LEVEL_DEPTH, make_level_grower
from ..core.metrics import Metric
from ..core.objective import ObjectiveFunction
from ..core.tree import HostTree
from ..io.dataset_core import BinnedDataset
from ..ops.forest import (BinnedTreeArrays, DeviceRouteUnavailable,
                          ServingEngine, mapper_arrays, pack_binned_tree,
                          upload_trees)
from ..ops.hist_cuda import device_bins, feature_major_bins
from ..ops.predict import depth_steps, forest_leaf_bins
from ..ops.split import K_EPSILON, FeatureMeta, SplitHyperParams
from ..utils import log, prng
from .sample_strategy import SampleStrategy


def resolve_device(config: Config) -> torch.device:
    """The training device named by ``device_type``: ``cuda`` (the
    default) or ``cpu``. Asking for ``cuda`` without a card raises."""
    dev = str(config.device_type).lower()
    if dev == "cuda" and not torch.cuda.is_available():
        log.fatal("device_type='cuda' but torch.cuda.is_available() is "
                  "False; pass device_type='cpu' to run on the CPU")
    return torch.device(dev)


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
        bad = cfg.unsupported_settings()
        if bad:
            log.fatal("the port does not implement these settings yet: "
                      + ", ".join(bad))
        dev = self.device = resolve_device(cfg)
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
        self.feature_meta = (FeatureMeta.from_mappers(mappers, dev)
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
        bins_host = self._setup_bundles(train)
        # the logical feature-major bins of the traversal replays, made
        # on first use when the stored columns are physical
        self._logical_fm = None
        # full scheduling holds the bins feature-major only, the other
        # growers row-major only (ref: gbdt.py:942, 1033-1072); u16 bins
        # are held as int16 with the same bits (ops/histogram.bin_ids);
        # multi-value storage is its [R, K] pairs
        if self._multival:
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
            row_sched="full" if self.row_sched == "full" else "compact")
        self._layout = self._make_layout()
        # per-tree uniforms of stochastic rounding: the JAX package's
        # threefry chain, fold_in(PRNGKey(seed), iteration * K + k), split
        # into the keys of the grad and hess draws (ref: models/gbdt.py
        # 835-842, 2303-2309; core/grower.py 252-258), drawn on the
        # training device
        self._rng_key = None
        if self.grower_cfg.quantized and self.grower_cfg.stochastic_rounding:
            self._rng_key = prng.prng_key(
                int(cfg.seed) if cfg.seed is not None else 0)
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
        self._grow = (self._make_grower()
                      if self.feature_meta is not None else None)

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
        if self._multival:
            return None
        if (cfg.enable_bundle and self.num_used_features > 1 and
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
            return make_tree_grower(gcfg, meta, hist_fn=hist_fn, layout=layout)
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
        if n_slots >= 2 and not self._multival:
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
        """Reasons level scheduling cannot serve this config (ref:
        gbdt.py:1747-1810), for what the port accepts: per-node column
        sampling (one mask a level there), and memory: the hybrid keeps
        the full [L, G, B, 3] pool for its tail and every level
        histogram [T, G, B, 3] (T = 2^(D0+1) - 1) for seeding it, and
        both together must fit the histogram budget (``_hist_budget``,
        over the stored columns: EFB groups, not logical features)."""
        cfg = self.config
        # the level scan gives every node of a level one mask
        reasons = ["feature_fraction_bynode"] if self._bynode else []
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

    def _row_sample(self, grad: torch.Tensor, hess: torch.Tensor
                    ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """This iteration's ``(bag, weight)`` as f32 ``[N]`` on the
        training device, or None (ref: the JAX package's models/gbdt.py
        2251-2290, its sync path). Only GOSS reads the gradients (one
        ``[K, N]`` read to the host); ``tpu_device_bagging`` draws on the
        device; the other samplers draw on the host and the mask is
        uploaded once (bagging returns one array as both)."""
        strat = self.sample_strategy
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

    def _tree_uniforms(self, k: int):
        """The stochastic-rounding draws of class k's tree this iteration,
        or None: the JAX package's threefry chain, keyed by iterations
        trained here, not an init model's (ref: gradient_discretizer.cpp
        random_values_use_start)."""
        if self._rng_key is None:
            return None
        keys = prng.split(prng.fold_in(
            self._rng_key, self.iter * self.num_tree_per_iteration + k))
        return tuple(prng.uniform(key, self.num_data, self.device)
                     for key in keys)

    def train_one_iter(self, gradients: Optional[np.ndarray] = None,
                       hessians: Optional[np.ndarray] = None) -> bool:
        """One boosting iteration (ref: gbdt.cpp:353 TrainOneIter): K
        trees, one per class, each through the same grower, from one row
        sample. Returns True when training should stop (no more valid
        splits)."""
        K = self.num_tree_per_iteration
        init_scores, grad, hess = self._gradients(gradients, hessians)
        sample = self._row_sample(grad, hess)
        should_continue = False
        for k in range(K):
            if not self.class_need_train[k] or self._grow is None:
                self.models.append(HostTree.constant(init_scores[k]))
                continue
            g, h = grad[k], hess[k]
            tree, leaf_id = self._grow(self.bins, sampled_gh(g, h, sample),
                                       self._tree_uniforms(k),
                                       self._feature_mask())
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
            renew_quant = (self.grower_cfg.quantized and
                           self.config.quant_train_renew_leaf)
            renew_objective = (self.objective is not None and
                               self.objective.is_renew_tree_output())
            if renew_quant or renew_objective:
                leaf_np = leaf_id.cpu().numpy()
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
            # two roundings: the product, then the accumulate
            lv = torch.as_tensor(
                host.leaf_value[:host.num_leaves].astype(np.float32),
                device=self.device)
            delta = lv[leaf_id] * torch.tensor(
                self.shrinkage_rate, dtype=torch.float32, device=self.device)
            self.score[k] += delta
            host.shrink(self.shrinkage_rate)
            # the shrunk leaf value is the f32 product added above: the
            # valid sets get it before the bias is folded in, as the
            # training score did (ref: gbdt.py:2406-2418)
            for vd in self.valid_sets:
                vd.score[k] += self._tree_outputs(host, vd.bins)
            if abs(init_scores[k]) > K_EPSILON:
                host.add_bias(init_scores[k])
            self.models.append(host)

        if not should_continue:
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if len(self.models) > K:
                del self.models[-K:]
            return True
        self.iter += 1
        return False

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
        srv = self._serving
        if srv is None:
            dev = self.device if self.device is not None else \
                resolve_device(self.config)
            srv = self._serving = ServingEngine(self.config.num_leaves, K,
                                                dev)
        if self.train_set is not None and self.train_set.bin_mappers:
            if self._serving_mappers is None:
                # pin one list so the binner and pack caches hold
                self._serving_mappers = self.train_set.used_bin_mappers()
            out = srv.predict_binned(
                models, self._model_gen, X, lo, hi,
                self._serving_mappers, self.train_set.used_feature_map)
        else:
            out = srv.predict_raw(models, self._model_gen, X, lo, hi)
        return out.T

    # -- validation sets, rollback, continued training ------------------
    def add_valid_data(self, valid: BinnedDataset, metrics: List[Metric],
                       name: str) -> None:
        """Register a validation set binned with the training mappers and
        replay the existing trees onto its score (ref: the JAX package's
        models/gbdt.py:1604 add_valid_data)."""
        if valid.bin_mappers is not self.train_set.bin_mappers:
            log.fatal(f"validation set {name!r} must be binned with the "
                      "training set's bin mappers: construct it with "
                      "reference=<the training Dataset>")
        for m in metrics:
            m.init(valid.metadata, valid.num_data)
        vd = _ValidData(valid, metrics, self.num_tree_per_iteration, name,
                        self.device)
        K = self.num_tree_per_iteration
        for i, t in enumerate(self.models):
            vd.score[i % K] += self._tree_outputs(t, vd.bins)
        self.valid_sets.append(vd)

    def _train_bins_fm(self) -> torch.Tensor:
        """The training bins as a feature-major logical ``[F, N]`` view.
        Over EFB groups or multi-value pairs the logical bins are decoded
        once (``ensure_logical_bins``; ref: gbdt.py:1256-1264)."""
        if self._bundle is None and not self._multival:
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

    def _tree_outputs(self, t: HostTree, bins_fm: torch.Tensor
                      ) -> torch.Tensor:
        """f32 ``[R]``: the stored leaf value of tree ``t`` at each row's
        leaf, by the device traversal over feature-major bins ``[F, R]``
        on the training device (ref: the JAX package's models/gbdt.py:1953
        _tree_outputs). The tree's inner feature indices and bin
        thresholds must be this dataset's."""
        L = max(int(t.num_leaves), 2)
        packed = upload_trees(BinnedTreeArrays,
                              [pack_binned_tree(t, L, *self._mapper_arrays)],
                              bins_fm.device)
        leaf = forest_leaf_bins(packed, bins_fm,
                                num_steps=depth_steps(t.max_depth, L))
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
            self.score[k] -= self._tree_outputs(t, bins_fm)
            for vd in self.valid_sets:
                vd.score[k] -= self._tree_outputs(t, vd.bins)
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
        bins_fm = self._train_bins_fm()
        for i, t in enumerate(self.models):
            k = i % K
            self.score[k] += self._tree_outputs(t, bins_fm)
            for vd in self.valid_sets:
                vd.score[k] += self._tree_outputs(t, vd.bins)

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
