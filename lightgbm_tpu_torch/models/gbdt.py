"""Gradient boosting engine, serial compact path.

Port of ``lightgbm_tpu/models/gbdt.py`` ``GBDT`` for the first slice
(ref: src/boosting/gbdt.h:28, gbdt.cpp:353 TrainOneIter): a serial run
with the compact grower, no sampling, no guards or fault sites, one tree
per iteration (binary and L2 objectives).

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
from ..core.metrics import Metric
from ..core.objective import ObjectiveFunction
from ..core.tree import HostTree
from ..io.dataset_core import BinnedDataset
from ..ops.split import K_EPSILON, FeatureMeta, SplitHyperParams
from ..utils import log


def resolve_device(config: Config) -> torch.device:
    """The training device named by ``device_type``: ``cuda`` (the
    default) or ``cpu``. Asking for ``cuda`` without a card raises."""
    dev = str(config.device_type).lower()
    if dev == "cuda" and not torch.cuda.is_available():
        log.fatal("device_type='cuda' but torch.cuda.is_available() is "
                  "False; pass device_type='cpu' to run on the CPU")
    return torch.device(dev)


class GBDT:
    """Gradient Boosting Decision Tree engine (ref: gbdt.h:28)."""

    NAME = "gbdt"

    def __init__(self, config: Config, train_set: Optional[BinnedDataset],
                 objective: Optional[ObjectiveFunction]):
        self.config = config
        self.train_set = train_set
        self.objective = objective
        self.models: List[HostTree] = []
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
        self.bins = torch.as_tensor(train.bins, device=dev)

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
            num_bin=self.num_bin_max, hparams=hp)
        self._grow = (make_tree_grower(self.grower_cfg, self.feature_meta)
                      if self.feature_meta is not None else None)

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
        init_scores = [self._boost_from_average(k) for k in range(K)]
        should_continue = False
        for k in range(K):
            if not self.class_need_train[k] or self._grow is None:
                self.models.append(HostTree.constant(init_scores[k]))
                continue
            grad, hess = self.objective.get_gradients(self.score[k])
            gh = torch.stack([grad, hess, torch.ones_like(grad)], dim=1)
            tree, leaf_id = self._grow(self.bins, gh)
            host = HostTree(tree, self.train_set.used_feature_map)
            if host.num_leaves <= 1:
                # no valid split for this class this iteration
                self.models.append(HostTree.constant(
                    init_scores[k] if len(self.models) < K else 0.0))
                continue
            should_continue = True
            finalize_tree(host, self.train_set.bin_mappers)
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
