"""Random forest mode.

Port of ``lightgbm_tpu/models/rf.py`` (ref: src/boosting/rf.hpp:26): no
shrinkage; row or column sampling required; the gradients computed once
from the constant init score; the training score kept as the running
average of the trees' outputs, ``(score * n_prev + lv[leaf]) /
(n_prev + 1)`` in f32 and in that order (ref: rf.hpp TrainOneIter's
MultiplyScore), so it is the JAX package's bit for bit; prediction
averages the trees (``average_output``). The rows are sampled by the
engine's sampler as gbdt's are, so ``tpu_device_bagging`` serves a
forest too; the JAX package's RF draws on the host whatever it says.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tree import HostTree
from ..ops.split import K_EPSILON
from ..utils import log
from .gbdt import GBDT, finalize_tree, sampled_gh


class RF(GBDT):
    NAME = "rf"

    def __init__(self, config, train_set, objective):
        if str(config.data_sample_strategy).lower() == "bagging":
            ok = ((config.bagging_freq > 0 and
                   0.0 < config.bagging_fraction < 1.0) or
                  0.0 < config.feature_fraction < 1.0)
            if not ok:
                log.fatal("RF mode requires bagging "
                          "(bagging_freq>0 and bagging_fraction in (0,1)) "
                          "or feature_fraction in (0,1)")
        super().__init__(config, train_set, objective)
        self.average_output = True
        self.shrinkage_rate = 1.0
        self._grad_const = self._hess_const = None
        if (train_set is None or self.objective is None or
                self.objective.NAME == "custom"):
            return
        # gradients from the constant init score, computed once (ref:
        # rf.hpp Boosting())
        K = self.num_tree_per_iteration
        self.init_scores = [
            float(self.objective.boost_from_score(k))
            if config.boost_from_average else 0.0 for k in range(K)]
        const = torch.tensor(self.init_scores, dtype=torch.float32,
                             device=self.device)[:, None].expand(
                                 K, self.num_data).contiguous()
        obj = self.objective
        if getattr(obj, "uses_position_bias", False):
            biases = torch.as_tensor(obj.pos_biases, dtype=torch.float32,
                                     device=self.device)
            grad, hess = obj.get_gradients(const[0], biases)
        else:
            grad, hess = obj.get_gradients(const[0] if K == 1 else const)
        self._grad_const = grad.reshape(K, self.num_data)
        self._hess_const = hess.reshape(K, self.num_data)
        log.info("Using RF (random forest) mode")

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """ref: rf.hpp TrainOneIter: the running-average score."""
        if (gradients is not None or hessians is not None or
                self._grad_const is None):
            log.fatal("RF mode does not support custom objective functions")
        K = self.num_tree_per_iteration
        grad, hess = self._grad_const, self._hess_const
        sample = self._row_sample(grad, hess)
        should_continue = False
        for k in range(K):
            if not self.class_need_train[k] or self._grow is None:
                self.models.append(HostTree.constant(self.init_scores[k]))
                continue
            tree, leaf_id = self._grow(
                self.bins, sampled_gh(grad[k], hess[k], sample),
                self._tree_uniforms(k), self._feature_mask())
            host = HostTree(tree, self.train_set.used_feature_map)
            if host.num_leaves <= 1:
                self.models.append(HostTree.constant(
                    self.init_scores[k] if len(self.models) < K else 0.0))
                continue
            should_continue = True
            finalize_tree(host, self.train_set.bin_mappers)
            if self.objective.is_renew_tree_output():
                init = self.init_scores[k]
                label = self.train_set.metadata.label
                leaf_np = leaf_id.cpu().numpy()
                if sample is not None:
                    leaf_np = np.where(sample[0].cpu().numpy() > 0, leaf_np,
                                       -1)
                new_vals = self.objective.renew_tree_output(
                    None, lambda: label.astype(np.float64) - init, leaf_np,
                    host.num_leaves)
                if new_vals is not None:
                    old = host.leaf_value[:host.num_leaves]
                    host.leaf_value[:host.num_leaves] = np.where(
                        np.isfinite(new_vals), new_vals, old)
            if abs(self.init_scores[k]) > K_EPSILON:
                host.add_bias(self.init_scores[k])
            # the running average, in f32 and in this order
            n_prev = self.iter + self.num_init_iteration
            lv = torch.as_tensor(
                host.leaf_value[:host.num_leaves].astype(np.float32),
                device=self.device)
            self.score[k] = (self.score[k] * n_prev + lv[leaf_id]) / (
                n_prev + 1)
            for vd in self.valid_sets:
                vd.score[k] = (vd.score[k] * n_prev + self._tree_outputs(
                    host, vd.bins)) / (n_prev + 1)
            self.models.append(host)

        if not should_continue:
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if len(self.models) > K:
                del self.models[-K:]
            return True
        self.iter += 1
        return False
