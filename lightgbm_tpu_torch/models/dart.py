"""DART boosting (Dropouts meet Multiple Additive Regression Trees).

Port of ``lightgbm_tpu/models/dart.py`` (ref: src/boosting/dart.hpp):
before each iteration some earlier trees are dropped (their outputs
taken off the training score), the new trees are fitted to what is
left, and the dropped trees are then scaled down so that the ensemble
keeps its magnitude (ref: dart.hpp:98 DroppingTrees, :159 Normalize and
the three-step shrinkage scheme documented there). The drops draw from
numpy's ``default_rng(drop_seed)`` in the JAX package's order: the skip
draw, then one draw a tree.

A dropped tree's outputs are added to and taken from the scores by the
device traversal of ``GBDT._tree_outputs`` over the training bins and
every validation set's. ``HostTree.shrink`` edits leaf values in place,
which the model list cannot see, so each change invalidates the packed
forest of device prediction.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..utils import log
from .gbdt import GBDT


class DART(GBDT):
    NAME = "dart"

    def __init__(self, config, train_set, objective):
        super().__init__(config, train_set, objective)
        self.rng = np.random.default_rng(config.drop_seed)
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0
        self.drop_index: List[int] = []
        log.info("Using DART")

    def _add_tree_score(self, tree_idx: int, k: int) -> None:
        """The training score += the tree's current outputs."""
        self.score[k] += self._tree_outputs(self.models[tree_idx],
                                            self._train_bins_fm(),
                                            self.train_set.raw)

    def _add_tree_score_valid(self, tree_idx: int, k: int) -> None:
        t = self.models[tree_idx]
        for vd in self.valid_sets:
            vd.score[k] += self._tree_outputs(t, vd.bins, vd.dataset.raw)

    def _negate_dropped(self) -> None:
        """Each dropped tree negated and added to the training score
        (ref: Shrinkage(-1) + AddScore): its outputs leave the score."""
        K = self.num_tree_per_iteration
        for i in self.drop_index:
            for k in range(K):
                self.models[i * K + k].shrink(-1.0)
                self._add_tree_score(i * K + k, k)
        if self.drop_index:
            self.invalidate_serving_cache()

    def _dropping_trees(self) -> None:
        """ref: dart.hpp:98 DroppingTrees."""
        cfg = self.config
        self.drop_index = []
        if self.rng.random() >= cfg.skip_drop:
            drop_rate = cfg.drop_rate
            n_tree = self.iter
            if cfg.uniform_drop:
                if cfg.max_drop > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / max(n_tree, 1))
                for i in range(n_tree):
                    if self.rng.random() < drop_rate:
                        self.drop_index.append(self.num_init_iteration + i)
                        if len(self.drop_index) >= cfg.max_drop > 0:
                            break
            else:
                inv_avg = len(self.tree_weight) / max(self.sum_weight, 1e-300)
                if cfg.max_drop > 0:
                    drop_rate = min(
                        drop_rate,
                        cfg.max_drop * inv_avg / max(self.sum_weight, 1e-300))
                for i in range(n_tree):
                    if self.rng.random() < \
                            drop_rate * self.tree_weight[i] * inv_avg:
                        self.drop_index.append(self.num_init_iteration + i)
                        if len(self.drop_index) >= cfg.max_drop > 0:
                            break
        self._negate_dropped()
        n_drop = len(self.drop_index)
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + n_drop)
        elif n_drop == 0:
            self.shrinkage_rate = cfg.learning_rate
        else:
            self.shrinkage_rate = cfg.learning_rate / (
                cfg.learning_rate + n_drop)

    def _normalize(self) -> None:
        """ref: dart.hpp:159 Normalize (three-step shrinkage scheme)."""
        cfg = self.config
        k_drop = float(len(self.drop_index))
        K = self.num_tree_per_iteration
        for i in self.drop_index:
            for k in range(K):
                ti = i * K + k
                if not cfg.xgboost_dart_mode:
                    self.models[ti].shrink(1.0 / (k_drop + 1.0))
                    self._add_tree_score_valid(ti, k)
                    self.models[ti].shrink(-k_drop)
                else:
                    self.models[ti].shrink(self.shrinkage_rate)
                    self._add_tree_score_valid(ti, k)
                    self.models[ti].shrink(-k_drop / cfg.learning_rate)
                self._add_tree_score(ti, k)
            wi = i - self.num_init_iteration
            if not cfg.uniform_drop:
                div = k_drop + (cfg.learning_rate if cfg.xgboost_dart_mode
                                else 1.0)
                self.sum_weight -= self.tree_weight[wi] / div
                self.tree_weight[wi] *= k_drop / div
        if self.drop_index:
            self.invalidate_serving_cache()

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        self._dropping_trees()
        finished = super().train_one_iter(gradients, hessians)
        if finished:
            # training ends here: the dropped trees go back as they were
            self._negate_dropped()
            self.drop_index = []
        else:
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
            self._normalize()
        return finished
