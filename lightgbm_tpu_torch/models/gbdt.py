"""Gradient boosting engine, serial path.

Port of ``lightgbm_tpu/models/gbdt.py`` ``GBDT`` (ref:
src/boosting/gbdt.h:28, gbdt.cpp:353 TrainOneIter): a serial run, no
sampling, no guards or fault sites, one tree per iteration (binary and L2
objectives). The grower is the compact leaf-wise one
(``tpu_row_scheduling=compact``, bins row-major on the device), the
full-pass leaf-wise one (``full`` or ``leaf``, bins feature-major only)
or, for ``tpu_row_scheduling=level``, the pure level grower
(``1 <= max_depth <= MAX_LEVEL_DEPTH``) or the hybrid level+tail grower
(deeper or unbounded). Quantized gradients (``use_quantized_grad``) run
in all of them, bf16 histograms (``tpu_hist_dtype``) in all but full,
which builds f32 histograms under it as the JAX package does.

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
"""
from __future__ import annotations

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
from ..ops.forest import DeviceRouteUnavailable, ServingEngine
from ..ops.hist_cuda import device_bins, feature_major_bins
from ..ops.split import K_EPSILON, FeatureMeta, SplitHyperParams
from ..utils import log, prng


def resolve_device(config: Config) -> torch.device:
    """The training device named by ``device_type``: ``cuda`` (the
    default) or ``cpu``. Asking for ``cuda`` without a card raises."""
    dev = str(config.device_type).lower()
    if dev == "cuda" and not torch.cuda.is_available():
        log.fatal("device_type='cuda' but torch.cuda.is_available() is "
                  "False; pass device_type='cpu' to run on the CPU")
    return torch.device(dev)


class _ModelList(list):
    """Model list that bumps its engine's model generation on every
    change but an append at the tail (``del``, item replacement,
    reordering), so prediction never replays a stale packed forest while
    appends keep it incrementally packable (ref: the JAX package's
    models/gbdt.py _ModelList)."""

    __slots__ = ("_bump",)

    def __init__(self, iterable=(), bump=None):
        super().__init__(iterable)
        self._bump = bump if bump is not None else lambda: None


def _bumping(name):
    def method(self, *args, **kwargs):
        out = getattr(list, name)(self, *args, **kwargs)
        self._bump()
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
        if self.num_tree_per_iteration != 1:
            log.fatal("the port trains one tree per iteration "
                      "(binary and regression objectives)")
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
        self.feature_meta = (FeatureMeta.from_mappers(mappers, dev)
                             if mappers else None)
        self.num_bin_max = int(max((m.num_bin for m in mappers), default=2))
        self.row_sched = str(cfg.tpu_row_scheduling).lower()
        if self.row_sched == "leaf":
            # the same program as full (ref: config.py:35-37)
            self.row_sched = "full"
        # full scheduling holds the bins feature-major only, the other
        # growers row-major only (ref: gbdt.py:942, 1033-1072); u16 bins
        # are held as int16 with the same bits (ops/histogram.bin_ids)
        self.bins = (feature_major_bins(train.bins, dev)
                     if self.row_sched == "full"
                     else device_bins(train.bins, dev))

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

        hp = SplitHyperParams(
            lambda_l1=cfg.lambda_l1, lambda_l2=cfg.lambda_l2,
            min_data_in_leaf=cfg.min_data_in_leaf,
            min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
            min_gain_to_split=cfg.min_gain_to_split,
            max_delta_step=cfg.max_delta_step,
            path_smooth=cfg.path_smooth)
        self.grower_cfg = GrowerConfig(
            num_leaves=cfg.num_leaves, max_depth=cfg.max_depth,
            num_bin=self.num_bin_max, hparams=hp,
            hist_dtype=str(cfg.tpu_hist_dtype).lower(),
            quantized=bool(cfg.use_quantized_grad),
            quant_bins=int(cfg.num_grad_quant_bins),
            stochastic_rounding=bool(cfg.stochastic_rounding),
            row_sched="full" if self.row_sched == "full" else "compact")
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
        self._grow = (self._make_grower()
                      if self.feature_meta is not None else None)

    def _make_grower(self):
        """The grower for ``row_sched`` (ref: gbdt.py:1164-1190): level
        scheduling routes pure level for ``1 <= max_depth <=
        MAX_LEVEL_DEPTH`` and hybrid otherwise."""
        gcfg, meta = self.grower_cfg, self.feature_meta
        if self.row_sched != "level":
            # compact or full, by gcfg.row_sched
            return make_tree_grower(gcfg, meta)
        if 1 <= gcfg.max_depth <= MAX_LEVEL_DEPTH:
            return make_level_grower(gcfg, meta)
        d0 = int(self.config.tpu_level_handoff_depth)
        if d0 > MAX_LEVEL_DEPTH:
            log.warning(f"tpu_level_handoff_depth={d0} exceeds "
                        f"MAX_LEVEL_DEPTH={MAX_LEVEL_DEPTH}; clamping")
        return make_hybrid_grower(gcfg, meta, handoff_depth=d0)

    def _level_ineligibility(self) -> List[str]:
        """Reasons level scheduling cannot serve this config (ref:
        gbdt.py:1747-1810), for what the port accepts: the hybrid keeps
        the full [L, F, B, 3] pool for its tail and every level
        histogram [T, F, B, 3] (T = 2^(D0+1) - 1) for seeding it, and
        both together must fit the histogram budget
        (``histogram_pool_size`` MB, 4 GiB when unset)."""
        cfg = self.config
        if 1 <= cfg.max_depth <= MAX_LEVEL_DEPTH or self.feature_meta is None:
            return []
        d0 = resolve_handoff_depth(cfg.num_leaves,
                                   cfg.tpu_level_handoff_depth)
        row_bytes = self.num_used_features * self.num_bin_max * 3 * 4
        limit_bytes = (cfg.histogram_pool_size * (1 << 20)
                       if cfg.histogram_pool_size >= 0 else 4 << 30)
        need_bytes = (cfg.num_leaves + 2 ** (d0 + 1) - 1) * row_bytes
        if need_bytes > limit_bytes:
            return [f"histogram memory over budget ({need_bytes >> 20} MB "
                    "for the hybrid's full pool + level-phase hists)"]
        return []

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
                log.info(f"Start training from score {init_score:.6f}")
                return init_score
        return 0.0

    def train_one_iter(self) -> bool:
        """One boosting iteration (ref: gbdt.cpp:353 TrainOneIter).
        Returns True when training should stop (no more valid splits)."""
        K = self.num_tree_per_iteration
        it = self.current_iteration()
        init_scores = [self._boost_from_average(k) for k in range(K)]
        should_continue = False
        for k in range(K):
            if not self.class_need_train[k] or self._grow is None:
                self.models.append(HostTree.constant(init_scores[k]))
                continue
            grad, hess = self.objective.get_gradients(self.score[k])
            gh = torch.stack([grad, hess, torch.ones_like(grad)], dim=1)
            uniforms = None
            if self._rng_key is not None:
                # fresh per-tree noise (ref: gradient_discretizer.cpp
                # random_values_use_start)
                keys = prng.split(prng.fold_in(self._rng_key, it * K + k))
                uniforms = tuple(prng.uniform(key, self.num_data,
                                              self.device) for key in keys)
            tree, leaf_id = self._grow(self.bins, gh, uniforms)
            host = HostTree(tree, self.train_set.used_feature_map)
            if host.num_leaves <= 1:
                # no valid split for this class this iteration
                self.models.append(HostTree.constant(
                    init_scores[k] if len(self.models) < K else 0.0))
                continue
            should_continue = True
            finalize_tree(host, self.train_set.bin_mappers)
            if (self.grower_cfg.quantized and
                    self.config.quant_train_renew_leaf):
                self._renew_quant_leaves(host, leaf_id.cpu().numpy(),
                                         grad.cpu().numpy(),
                                         hess.cpu().numpy())
            # two roundings: the product, then the accumulate
            lv = torch.as_tensor(
                host.leaf_value[:host.num_leaves].astype(np.float32),
                device=self.device)
            delta = lv[leaf_id] * torch.tensor(
                self.shrinkage_rate, dtype=torch.float32, device=self.device)
            self.score[k] += delta
            host.shrink(self.shrinkage_rate)
            if abs(init_scores[k]) > K_EPSILON:
                host.add_bias(init_scores[k])
            self.models.append(host)

        if not should_continue:
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if len(self.models) > K:
                del self.models[-K:]
            return True
        return False

    def _renew_quant_leaves(self, host: HostTree, leaf_np: np.ndarray,
                            grad: np.ndarray, hess: np.ndarray) -> None:
        """Refit leaf outputs from the true f32 gradient sums after
        quantized growth, in f64 (ref: gradient_discretizer.cpp
        RenewIntGradTreeOutput; the JAX package's _renew_quant_leaves,
        models/gbdt.py:2512-2531)."""
        cfg = self.config
        n = host.num_leaves
        sg = np.bincount(leaf_np, weights=grad.astype(np.float64),
                         minlength=n)[:n]
        sh = np.bincount(leaf_np, weights=hess.astype(np.float64),
                         minlength=n)[:n]
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

    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        score = self.score.cpu().numpy().astype(np.float64)
        view = score[0] if self.num_tree_per_iteration == 1 else score
        return [("training", name, value, hib)
                for m in self.train_metrics
                for name, value, hib in m.eval(view, self.objective)]

    def current_iteration(self) -> int:
        return len(self.models) // max(self.num_tree_per_iteration, 1)


_MISSING_BITS = {"none": 0, "zero": 1, "nan": 2}


def finalize_tree(host: HostTree, bin_mappers) -> None:
    """Resolve a numerical host tree's bin thresholds to real values and
    pack its decision_type bits, from the bin mappers of its ORIGINAL
    features (ref: tree.h kDefaultLeftMask=2, missing type in bits 2-3;
    Tree::Split stores RealThreshold = bin upper bound)."""
    n_int = host.num_leaves - 1
    thr_real = np.zeros(n_int, np.float64)
    dtype_bits = np.zeros(n_int, np.int32)
    for i in range(n_int):
        m = bin_mappers[host.split_feature[i]]
        tb = int(host.threshold_bin[i])
        thr_real[i] = m.bin_upper_bound[min(tb, len(m.bin_upper_bound) - 1)]
        if host.default_left[i]:
            dtype_bits[i] |= 2
        dtype_bits[i] |= _MISSING_BITS[m.missing_type] << 2
    host.threshold_real = thr_real
    host.decision_type = dtype_bits
