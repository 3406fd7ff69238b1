"""Distributed training over a ``torch.distributed`` world, one process a
device.

Port of ``lightgbm_tpu/parallel/`` (ref: src/treelearner/
parallel_tree_learner.h, src/network/ — SURVEY.md §2.3, §2.4): the JAX
package's mesh becomes a process group, XLA's collectives become
``torch.distributed`` calls (``mesh.Comm``), and each learner is the eager
grower of ``core/grower.py`` with its hooks.
"""
from .data_parallel import (RowShardedLearner, RowShards,
                            make_data_parallel_grower,
                            make_distributed_train_step,
                            make_feature_window, make_global_best_combine)
from .feature_parallel import (FeatureShardedLearner,
                               make_feature_parallel_grower,
                               pad_feature_meta, padded_features,
                               padded_groups)
from .mesh import (Comm, current_comm, feature_tile, pad_rows_np,
                   padded_rows)
from .voting_parallel import make_voting_parallel_grower

__all__ = [
    "Comm", "FeatureShardedLearner",
    "RowShardedLearner", "RowShards", "current_comm", "feature_tile",
    "make_data_parallel_grower", "make_distributed_train_step",
    "make_feature_parallel_grower", "make_feature_window",
    "make_global_best_combine", "make_voting_parallel_grower",
    "pad_feature_meta", "pad_rows_np", "padded_features", "padded_groups",
    "padded_rows",
]
