"""Parameter schema, alias resolution and Config object.

Copy of ``lightgbm_tpu/config.py`` for the PyTorch/CUDA port (the port
imports nothing of the JAX package). One declarative registry drives
defaults, alias resolution, type coercion, constraint checks and
``Config.to_string()`` (the ``parameters:`` block of the model text
format); ref: include/LightGBM/config.h:41 struct Config,
src/io/config.cpp, python-package lightgbm/basic.py:513 _ConfigAliases.

Differences from the JAX package's copy: ``device_type`` defaults to
``"cuda"`` (``"cpu"`` when ``LIGHTGBM_TPU_PLATFORM=cpu`` is set at
import) and accepts ``"cuda"`` or ``"cpu"``; the ``tpu_*`` names stay
registered so one params dict drives both packages. The port reads
``tpu_row_scheduling`` (compact, full, leaf or level), ``tpu_hist_dtype``,
``tpu_level_handoff_depth``, ``tpu_device_bagging``,
``tpu_predict_device``, ``tpu_async_boosting`` (auto, on for the card:
GOSS draws on the device, the JAX package's asynchronous draw, so a GOSS
model under it differs from the synchronous one, as in the JAX package;
every other model is the synchronous one), ``tpu_heartbeat_file``,
``tpu_stall_sec``, ``tpu_integrity_numeric_guard``,
``tpu_integrity_loss_spike_factor``, and for the distributed learners
``tree_learner``, ``top_k``, ``tpu_hist_reduce`` (auto is allreduce),
``tpu_num_devices`` (0 or the world size: one process is one device),
``tpu_gang_collective_timeout_s`` and ``tpu_integrity_digest_every``,
sharded ingestion's ``pre_partition`` and ``tpu_ingest`` and the gang's
``tpu_gang_manifest``; it accepts and
ignores ``tpu_hist_kernel``, ``tpu_use_pallas`` and ``tpu_rows_per_block``
(every value runs the port's hand kernels) and ``tpu_predict_buckets``
(it pads no request; see models/gbdt.py), and refuses the settings it cannot honour yet (see
``unsupported_settings``).

These knobs are accepted and ignored without changing the model: they
tune how the JAX package lays out or schedules work on a TPU, and the
port's kernels and loop have no counterpart of them:
``tpu_packed_bins``, ``tpu_partition_mode`` and ``tpu_min_bucket`` (bin
packing, the segment partition and its pow2 buckets),
``tpu_donate_state`` and ``tpu_stop_check_interval`` (buffer donation
and the batched stop check of the JAX package's queue of device trees,
which the port's grower, returning host trees, has no need of),
``tpu_compile_cache_dir`` (XLA's compile cache). ``tpu_profile_dir``
records a ``torch.profiler`` trace of ``train``'s boosting loop
(engine.py).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

from .utils import log

# ---------------------------------------------------------------------------
# Registry: name -> (type, default, aliases, check)
#   type: one of bool, int, float, str, "list_int", "list_float", "list_str"
#   check: optional (lo, hi, lo_inclusive, hi_inclusive) for numerics
# ---------------------------------------------------------------------------

_P: Dict[str, Tuple[Any, Any, Tuple[str, ...]]] = {}

# enumerated string params: name -> accepted values
_CHOICES: Dict[str, Tuple[str, ...]] = {
    "device_type": ("cuda", "cpu"),
    "tpu_hist_kernel": ("auto", "einsum", "scatter", "pallas",
                        "pallas_level"),
    "tpu_hist_dtype": ("float32", "bfloat16", "bf16"),
    "tpu_row_scheduling": ("compact", "full", "leaf", "level"),
    "tpu_sparse_storage": ("auto", "dense", "multival", "none"),
    "tpu_partition_mode": ("auto", "scatter", "sort"),
    "tpu_packed_bins": ("auto", "true", "false", "1", "0", "yes", "no",
                        "on", "off"),
    "tpu_ingest": ("auto", "replicated", "sharded"),
    "tpu_hist_reduce": ("auto", "allreduce", "reduce_scatter"),
    "tpu_serving_fleet_shard": ("auto", "replicate", "model"),
    "tpu_service_trainer": ("process", "thread"),
    "tpu_serving_explain_fallback": ("host", "refuse"),
}


def _reg(name, typ, default, aliases=(), check=None):
    _P[name] = (typ, default, tuple(aliases), check)


# --- Core parameters (ref: config.h pragma region Core) ---
_reg("config", str, "", ("config_file",))
_reg("task", str, "train", ("task_type",))
_reg("objective", str, "regression",
     ("objective_type", "app", "application", "loss"))
_reg("boosting", str, "gbdt", ("boosting_type", "boost"))
_reg("data_sample_strategy", str, "bagging", ())
_reg("data", str, "", ("train", "train_data", "train_data_file", "data_filename"))
_reg("valid", "list_str", [], ("test", "valid_data", "valid_data_file",
                               "test_data", "test_data_file", "valid_filenames"))
_reg("num_iterations", int, 100,
     ("num_iteration", "n_iter", "num_tree", "num_trees", "num_round",
      "num_rounds", "nrounds", "num_boost_round", "n_estimators", "max_iter"),
     (0, None, True, False))
_reg("learning_rate", float, 0.1, ("shrinkage_rate", "eta"), (0.0, None, False, False))
_reg("num_leaves", int, 31, ("num_leaf", "max_leaves", "max_leaf", "max_leaf_nodes"),
     (1, 131072, False, True))
_reg("tree_learner", str, "serial", ("tree", "tree_type", "tree_learner_type"))
_reg("num_threads", int, 0, ("num_thread", "nthread", "nthreads", "n_jobs"))
# LIGHTGBM_TPU_PLATFORM=cpu, read once at import, makes the CPU the
# default device: the JAX package's pin of its backend (its __init__.py
# :1-5), the way a C host or the R shim asks for the CPU without naming
# device_type in every parameter string
_reg("device_type", str,
     "cpu" if os.environ.get("LIGHTGBM_TPU_PLATFORM", "").lower() == "cpu"
     else "cuda", ("device",))
_reg("seed", int, None, ("random_seed", "random_state"))
_reg("deterministic", bool, False, ())

# --- Learning control (ref: config.h pragma region Learning Control) ---
_reg("force_col_wise", bool, False, ())
_reg("force_row_wise", bool, False, ())
_reg("histogram_pool_size", float, -1.0, ("hist_pool_size",))
_reg("max_depth", int, -1, ())
_reg("min_data_in_leaf", int, 20,
     ("min_data_per_leaf", "min_data", "min_child_samples", "min_samples_leaf"),
     (0, None, True, False))
_reg("min_sum_hessian_in_leaf", float, 1e-3,
     ("min_sum_hessian_per_leaf", "min_sum_hessian", "min_hessian", "min_child_weight"),
     (0.0, None, True, False))
_reg("bagging_fraction", float, 1.0, ("sub_row", "subsample", "bagging"),
     (0.0, 1.0, False, True))
_reg("pos_bagging_fraction", float, 1.0,
     ("pos_sub_row", "pos_subsample", "pos_bagging"), (0.0, 1.0, False, True))
_reg("neg_bagging_fraction", float, 1.0,
     ("neg_sub_row", "neg_subsample", "neg_bagging"), (0.0, 1.0, False, True))
_reg("bagging_freq", int, 0, ("subsample_freq",))
_reg("bagging_seed", int, 3, ("bagging_fraction_seed",))
_reg("bagging_by_query", bool, False, ())
_reg("feature_fraction", float, 1.0, ("sub_feature", "colsample_bytree"),
     (0.0, 1.0, False, True))
_reg("feature_fraction_bynode", float, 1.0,
     ("sub_feature_bynode", "colsample_bynode"), (0.0, 1.0, False, True))
_reg("feature_fraction_seed", int, 2, ())
_reg("extra_trees", bool, False, ("extra_tree",))
_reg("extra_seed", int, 6, ())
_reg("early_stopping_round", int, 0,
     ("early_stopping_rounds", "early_stopping", "n_iter_no_change"))
_reg("early_stopping_min_delta", float, 0.0, (), (0.0, None, True, False))
_reg("first_metric_only", bool, False, ())
_reg("max_delta_step", float, 0.0, ("max_tree_output", "max_leaf_output"))
_reg("lambda_l1", float, 0.0, ("reg_alpha", "l1_regularization"), (0.0, None, True, False))
_reg("lambda_l2", float, 0.0, ("reg_lambda", "lambda", "l2_regularization"),
     (0.0, None, True, False))
_reg("linear_lambda", float, 0.0, (), (0.0, None, True, False))
_reg("min_gain_to_split", float, 0.0, ("min_split_gain",), (0.0, None, True, False))
_reg("drop_rate", float, 0.1, ("rate_drop",), (0.0, 1.0, True, True))
_reg("max_drop", int, 50, ())
_reg("skip_drop", float, 0.5, (), (0.0, 1.0, True, True))
_reg("xgboost_dart_mode", bool, False, ())
_reg("uniform_drop", bool, False, ())
_reg("drop_seed", int, 4, ())
_reg("top_rate", float, 0.2, (), (0.0, 1.0, True, True))
_reg("other_rate", float, 0.1, (), (0.0, 1.0, True, True))
_reg("min_data_per_group", int, 100, (), (0, None, False, False))
_reg("max_cat_threshold", int, 32, (), (0, None, False, False))
_reg("cat_l2", float, 10.0, (), (0.0, None, True, False))
_reg("cat_smooth", float, 10.0, (), (0.0, None, True, False))
_reg("max_cat_to_onehot", int, 4, (), (0, None, False, False))
_reg("top_k", int, 20, ("topk",), (0, None, False, False))
_reg("monotone_constraints", "list_int", [], ("mc", "monotone_constraint", "monotonic_cst"))
_reg("monotone_constraints_method", str, "basic",
     ("monotone_constraining_method", "mc_method"))
_reg("monotone_penalty", float, 0.0, ("monotone_splits_penalty", "ms_penalty", "mc_penalty"),
     (0.0, None, True, False))
_reg("feature_contri", "list_float", [],
     ("feature_contrib", "fc", "fp", "feature_penalty"))
_reg("forcedsplits_filename", str, "",
     ("fs", "forced_splits_filename", "forced_splits_file", "forced_splits"))
_reg("refit_decay_rate", float, 0.9, (), (0.0, 1.0, True, True))
_reg("cegb_tradeoff", float, 1.0, (), (0.0, None, True, False))
_reg("cegb_penalty_split", float, 0.0, (), (0.0, None, True, False))
_reg("cegb_penalty_feature_lazy", "list_float", [], ())
_reg("cegb_penalty_feature_coupled", "list_float", [], ())
_reg("path_smooth", float, 0.0, (), (0.0, None, True, False))
_reg("interaction_constraints", str, "", ())
_reg("verbosity", int, 1, ("verbose",))
_reg("input_model", str, "", ("model_input", "model_in"))
_reg("output_model", str, "LightGBM_model.txt", ("model_output", "model_out"))
_reg("saved_feature_importance_type", int, 0, ())
_reg("snapshot_freq", int, -1, ("save_period",))
# how many snapshot_freq snapshots the CLI keeps on disk (oldest are
# pruned; the reference accumulates forever)
_reg("snapshot_keep_last", int, 5, (), (1, None, True, False))
_reg("use_quantized_grad", bool, False, ())
_reg("num_grad_quant_bins", int, 4, ())
_reg("quant_train_renew_leaf", bool, False, ())
_reg("stochastic_rounding", bool, True, ())

# --- IO / Dataset (ref: config.h pragma region IO) ---
_reg("linear_tree", bool, False, ("linear_trees",))
_reg("max_bin", int, 255, ("max_bins",), (1, None, False, False))
_reg("max_bin_by_feature", "list_int", [], ())
_reg("min_data_in_bin", int, 3, (), (0, None, False, False))
_reg("bin_construct_sample_cnt", int, 200000, ("subsample_for_bin",),
     (0, None, False, False))
_reg("data_random_seed", int, 1, ("data_seed",))
_reg("is_enable_sparse", bool, True, ("is_sparse", "enable_sparse", "sparse"))
_reg("enable_bundle", bool, True, ("is_enable_bundle", "bundle"))
_reg("max_conflict_rate", float, 0.0, (), (0.0, 1.0, True, False))
_reg("use_missing", bool, True, ())
_reg("zero_as_missing", bool, False, ())
_reg("feature_pre_filter", bool, True, ())
_reg("pre_partition", bool, False, ("is_pre_partition",))
_reg("two_round", bool, False, ("two_round_loading", "use_two_round_loading"))
_reg("header", bool, False, ("has_header",))
_reg("label_column", str, "", ("label",))
_reg("weight_column", str, "", ("weight",))
_reg("group_column", str, "",
     ("group", "group_id", "query_column", "query", "query_id"))
_reg("ignore_column", str, "", ("ignore_feature", "blacklist"))
_reg("categorical_feature", str, "",
     ("cat_feature", "categorical_column", "cat_column", "categorical_features"))
_reg("forcedbins_filename", str, "", ())
_reg("save_binary", bool, False, ("is_save_binary", "is_save_binary_file"))
_reg("precise_float_parser", bool, False, ())
_reg("parser_config_file", str, "", ())

# --- Predict (ref: config.h pragma region Predict) ---
_reg("start_iteration_predict", int, 0, ())
_reg("num_iteration_predict", int, -1, ())
_reg("predict_raw_score", bool, False,
     ("is_predict_raw_score", "predict_rawscore", "raw_score"))
_reg("predict_leaf_index", bool, False, ("is_predict_leaf_index", "leaf_index"))
_reg("predict_contrib", bool, False, ("is_predict_contrib", "contrib"))
_reg("predict_disable_shape_check", bool, False, ())
_reg("pred_early_stop", bool, False, ())
_reg("pred_early_stop_freq", int, 10, ())
_reg("pred_early_stop_margin", float, 10.0, ())
_reg("output_result", str, "LightGBM_predict_result.txt",
     ("predict_result", "prediction_result", "predict_name", "prediction_name",
      "pred_name", "name_pred"))

# --- Convert (ref: config.h pragma region Convert) ---
_reg("convert_model_language", str, "", ())
_reg("convert_model", str, "gbdt_prediction.cpp", ("convert_model_file",))

# --- Objective (ref: config.h pragma region Objective) ---
_reg("objective_seed", int, 5, ())
_reg("num_class", int, 1, ("num_classes",), (0, None, False, False))
_reg("is_unbalance", bool, False, ("unbalance", "unbalanced_sets"))
_reg("scale_pos_weight", float, 1.0, (), (0.0, None, False, False))
_reg("sigmoid", float, 1.0, (), (0.0, None, False, False))
_reg("boost_from_average", bool, True, ())
_reg("reg_sqrt", bool, False, ())
_reg("alpha", float, 0.9, (), (0.0, None, False, False))
_reg("fair_c", float, 1.0, (), (0.0, None, False, False))
_reg("poisson_max_delta_step", float, 0.7, (), (0.0, None, False, False))
_reg("tweedie_variance_power", float, 1.5, (), (1.0, 2.0, True, False))
_reg("lambdarank_truncation_level", int, 30, (), (0, None, False, False))
_reg("lambdarank_norm", bool, True, ())
_reg("label_gain", "list_float", [], ())
_reg("lambdarank_position_bias_regularization", float, 0.0, (), (0.0, None, True, False))

# --- Metric (ref: config.h pragma region Metric) ---
_reg("metric", "list_str", [], ("metrics", "metric_types"))
_reg("metric_freq", int, 1, ("output_freq",), (0, None, False, False))
_reg("is_provide_training_metric", bool, False,
     ("training_metric", "is_training_metric", "train_metric"))
_reg("eval_at", "list_int", [1, 2, 3, 4, 5],
     ("ndcg_eval_at", "ndcg_at", "map_eval_at", "map_at"))
_reg("multi_error_top_k", int, 1, (), (0, None, False, False))
_reg("auc_mu_weights", "list_float", [], ())

# --- Network (ref: config.h pragma region Network Parameters) ---
_reg("num_machines", int, 1, ("num_machine",), (0, None, False, False))
_reg("local_listen_port", int, 12400, ("local_port", "port"), (0, None, False, False))
_reg("time_out", int, 120, (), (0, None, False, False))
_reg("machine_list_filename", str, "", ("machine_list_file", "machine_list", "mlist"))
_reg("machines", str, "", ("workers", "nodes"))

# --- Device-specific: the JAX package's names, accepted and ignored ---
_reg("gpu_platform_id", int, -1, ())
_reg("gpu_device_id", int, -1, ())
_reg("gpu_use_dp", bool, False, ())
_reg("num_gpu", int, 1, (), (0, None, False, False))
_reg("tpu_num_devices", int, 0, ())
_reg("tpu_hist_dtype", str, "float32", ())
_reg("tpu_hist_kernel", str, "auto", ())
_reg("tpu_row_scheduling", str, "compact", ())
_reg("tpu_hist_reduce", str, "auto", ())
_reg("tpu_level_handoff_depth", int, 0, (), (0, None, True, False))
_reg("tpu_sparse_storage", str, "auto", ())
_reg("tpu_partition_mode", str, "auto", ())
_reg("tpu_min_bucket", int, 2048, ())
_reg("tpu_use_pallas", bool, False, ())
_reg("tpu_rows_per_block", int, 1024, ())
_reg("tpu_device_bagging", bool, False, ())
_reg("tpu_packed_bins", str, "auto", ())
_reg("tpu_donate_state", bool, True, ())
_reg("tpu_async_boosting", str, "auto", ())
_reg("tpu_device_eval", str, "auto", ())
_reg("tpu_stop_check_interval", int, 16, ())
_reg("tpu_predict_device", bool, False, ())
_reg("tpu_predict_buckets", bool, True, ())
_reg("tpu_serving_max_batch", int, 4096, (), (1, None, True, False))
_reg("tpu_serving_linger_ms", float, 2.0, (), (0.0, None, True, False))
_reg("tpu_serving_num_devices", int, 0, (), (0, None, True, False))
_reg("tpu_serving_queue_depth", int, 8192, (), (1, None, True, False))
_reg("tpu_serving_deadline_ms", float, 0.0, (), (0.0, None, True, False))
_reg("tpu_serving_max_queue_rows", int, 1_048_576, (),
     (0, None, True, False))
_reg("tpu_serving_probe_interval_s", float, 5.0, (),
     (0.0, None, True, False))
_reg("tpu_serving_fleet_shard", str, "auto", ())
_reg("tpu_serving_fleet_pack_budget_mb", float, 256.0, (),
     (0.0, None, False, False))
_reg("tpu_serving_fleet_quota_rows", int, 0, (), (0, None, True, False))
_reg("tpu_serving_mem_budget_mb", float, 0.0, (),
     (0.0, None, True, False))
_reg("tpu_serving_explain_max_batch", int, 1024, (),
     (1, None, True, False))
_reg("tpu_serving_explain_linger_ms", float, 2.0, (),
     (0.0, None, True, False))
_reg("tpu_serving_explain_deadline_ms", float, 0.0, (),
     (0.0, None, True, False))
_reg("tpu_serving_explain_max_queue_rows", int, 262_144, (),
     (0, None, True, False))
_reg("tpu_serving_explain_fallback", str, "host", ())
_reg("tpu_service_port", int, 0, (), (0, 65535, True, True))
_reg("tpu_service_window_rows", int, 8192, (), (1, None, True, False))
_reg("tpu_service_window_floor", int, 1024, (), (1, None, True, False))
_reg("tpu_service_iters_per_cycle", int, 4, (), (1, None, True, False))
_reg("tpu_service_publish_iters", int, 4, (), (1, None, True, False))
_reg("tpu_service_poll_sec", float, 0.2, (), (0.0, None, False, False))
_reg("tpu_service_trainer", str, "process", ())
_reg("tpu_service_max_body_mb", float, 64.0, (), (0.0, None, False,
                                                  False))
_reg("tpu_service_chunk_rows", int, 4096, (), (1, None, True, False))
_reg("tpu_profile_dir", str, "", ())
_reg("tpu_fallback_to_cpu", bool, False, ())
_reg("tpu_compile_cache_dir", str, "", ())
_reg("tpu_ingest", str, "auto", ())
_reg("tpu_heartbeat_file", str, "", ())
_reg("tpu_gang_collective_timeout_s", float, 0.0, (),
     (0, None, True, False))
_reg("tpu_gang_manifest", bool, True, ())
_reg("tpu_stall_sec", float, 0.0, (), (0, None, True, False))
_reg("tpu_integrity_probe_interval_s", float, 0.0, (),
     (0.0, None, True, False))
_reg("tpu_integrity_canary_rows", int, 16, (), (1, 4096, True, True))
_reg("tpu_integrity_numeric_guard", bool, False, ())
_reg("tpu_integrity_loss_spike_factor", float, 100.0, (),
     (1.0, None, False, False))
_reg("tpu_integrity_digest_every", int, 0, (), (0, None, True, False))
# objective alias names accepted for each canonical objective
OBJECTIVE_ALIASES = {
    "regression": ("regression", "regression_l2", "l2", "mean_squared_error",
                   "mse", "l2_root", "root_mean_squared_error", "rmse"),
    "regression_l1": ("regression_l1", "l1", "mean_absolute_error", "mae"),
    "huber": ("huber",),
    "fair": ("fair",),
    "poisson": ("poisson",),
    "quantile": ("quantile",),
    "mape": ("mape", "mean_absolute_percentage_error"),
    "gamma": ("gamma",),
    "tweedie": ("tweedie",),
    "binary": ("binary",),
    "multiclass": ("multiclass", "softmax"),
    "multiclassova": ("multiclassova", "multiclass_ova", "ova", "ovr"),
    "cross_entropy": ("cross_entropy", "xentropy"),
    "cross_entropy_lambda": ("cross_entropy_lambda", "xentlambda"),
    "lambdarank": ("lambdarank",),
    "rank_xendcg": ("rank_xendcg", "xendcg", "xe_ndcg", "xe_ndcg_mart", "xendcg_mart"),
    "custom": ("custom", "none", "null", "na"),
}

METRIC_ALIASES = {
    "l1": ("l1", "mean_absolute_error", "mae", "regression_l1"),
    "l2": ("l2", "mean_squared_error", "mse", "regression", "regression_l2"),
    "rmse": ("rmse", "root_mean_squared_error", "l2_root"),
    "quantile": ("quantile",),
    "mape": ("mape", "mean_absolute_percentage_error"),
    "huber": ("huber",),
    "fair": ("fair",),
    "poisson": ("poisson",),
    "gamma": ("gamma",),
    "gamma_deviance": ("gamma_deviance", "gamma-deviance"),
    "tweedie": ("tweedie",),
    "ndcg": ("ndcg", "lambdarank", "rank_xendcg", "xendcg", "xe_ndcg",
             "xe_ndcg_mart", "xendcg_mart"),
    "map": ("map", "mean_average_precision"),
    "auc": ("auc",),
    "average_precision": ("average_precision",),
    "binary_logloss": ("binary_logloss", "binary"),
    "binary_error": ("binary_error",),
    "auc_mu": ("auc_mu",),
    "multi_logloss": ("multi_logloss", "multiclass", "softmax", "multiclassova",
                      "multiclass_ova", "ova", "ovr"),
    "multi_error": ("multi_error",),
    "cross_entropy": ("cross_entropy", "xentropy"),
    "cross_entropy_lambda": ("cross_entropy_lambda", "xentlambda"),
    "kullback_leibler": ("kullback_leibler", "kldiv"),
    "r2": ("r2",),
    "none": ("none", "null", "custom", "na"),
}

# Build flat alias->canonical maps
_ALIAS_TO_NAME: Dict[str, str] = {}
for _name, (_t, _d, _aliases, _c) in _P.items():
    _ALIAS_TO_NAME[_name] = _name
    for _a in _aliases:
        _ALIAS_TO_NAME[_a] = _name

_OBJ_ALIAS: Dict[str, str] = {}
for _name, _aliases in OBJECTIVE_ALIASES.items():
    for _a in _aliases:
        _OBJ_ALIAS[_a] = _name

_METRIC_ALIAS: Dict[str, str] = {}
for _name, _aliases in METRIC_ALIASES.items():
    for _a in _aliases:
        _METRIC_ALIAS[_a] = _name


class _ConfigAliases:
    """Alias lookup helper mirroring python-package basic.py:513."""

    @staticmethod
    def get(*args: str) -> set:
        out = set()
        for name in args:
            canonical = _ALIAS_TO_NAME.get(name, name)
            out.add(canonical)
            for n, (_t, _d, aliases, _c) in _P.items():
                if n == canonical:
                    out.update(aliases)
        return out

    @staticmethod
    def canonical(name: str) -> str:
        return _ALIAS_TO_NAME.get(name, name)


def _coerce(name: str, typ: Any, value: Any) -> Any:
    if typ is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)):
            return bool(value)
        if isinstance(value, str):
            v = value.strip().lower()
            if v in ("true", "1", "+", "yes"):
                return True
            if v in ("false", "0", "-", "no"):
                return False
            raise ValueError(f"bad bool value for {name}: {value!r}")
        raise ValueError(f"bad bool value for {name}: {value!r}")
    if typ is int:
        if isinstance(value, str):
            return int(float(value)) if "." in value or "e" in value.lower() else int(value)
        return int(value)
    if typ is float:
        return float(value)
    if typ is str:
        return str(value).strip()
    if typ == "list_int":
        return _parse_list(value, int)
    if typ == "list_float":
        return _parse_list(value, float)
    if typ == "list_str":
        return _parse_list(value, str)
    raise AssertionError(f"unknown type for {name}")


def _parse_list(value: Any, elem_type: Any) -> List[Any]:
    if value is None:
        return []
    if isinstance(value, str):
        value = [v for v in value.replace(";", ",").split(",") if v.strip() != ""]
    if not isinstance(value, (list, tuple)):
        value = [value]
    return [elem_type(v) for v in value]


# What the port implements is training on dense, scipy sparse and
# ``Sequence`` input, numerical and categorical features, with the
# compact, full/leaf, level and hybrid growers: EFB bundles
# (``enable_bundle``, ``max_conflict_rate``), multi-value sparse storage
# (``tpu_sparse_storage``), the histogram-pool policy
# (``histogram_pool_size``), ``gbdt``, ``dart`` and ``rf`` boosting,
# bagging (uniform, balanced, by query, ``tpu_device_bagging``) and GOSS
# row sampling, per-tree and per-node column sampling, monotone
# constraints (``monotone_constraints_method`` basic, intermediate and
# advanced, ``monotone_penalty``), interaction constraints, CEGB,
# forced splits and forced bins, ``feature_contri``, extra_trees,
# linear trees, two-round file loading (``two_round``,
# io/stream_loader.py), and the data, voting and feature learners over a
# ``torch.distributed`` world (``distributed_refusals`` lists what those
# refuse). A setting that needs anything else maps to a predicate that
# is True for the unsupported value and to the ROADMAP item that ports
# it; training refuses it instead of ignoring it. None is left.
_UNSUPPORTED_WHEN: Dict[str, Tuple[Any, str]] = {}


class Config:
    """Resolved parameter set with attribute access.

    ``Config(params_dict)`` resolves aliases (first-one-wins like the
    reference's KV2Map warning-and-ignore policy), coerces types, checks
    ranges, and exposes every canonical parameter as an attribute.
    """

    def __init__(self, params: Optional[Dict[str, Any]] = None):
        self._values: Dict[str, Any] = {n: (list(d) if isinstance(d, list) else d)
                                        for n, (t, d, a, c) in _P.items()}
        self._explicit: Dict[str, Any] = {}
        if params:
            self.update(params)
        self._post_process()

    # -- public ----------------------------------------------------------
    def update(self, params: Dict[str, Any]) -> None:
        resolved: Dict[str, Any] = {}
        for key, value in params.items():
            if value is None:
                continue
            canonical = _ALIAS_TO_NAME.get(key)
            if canonical is None:
                # unknown key: keep verbatim (forward/unknown params pass through)
                self._values[key] = value
                self._explicit[key] = value
                continue
            if canonical in resolved and resolved[canonical][0] != key:
                log.warning(f"{key} is set with {resolved[canonical][0]}, "
                            f"ignoring {key}={value}")
                continue
            resolved[canonical] = (key, value)
        for canonical, (_key, value) in resolved.items():
            typ, _default, _aliases, check = _P[canonical]
            coerced = _coerce(canonical, typ, value)
            if check is not None and coerced is not None:
                lo, hi, lo_inc, hi_inc = check
                if lo is not None and (coerced < lo or (not lo_inc and coerced == lo)):
                    raise ValueError(f"{canonical}={coerced} out of range")
                if hi is not None and (coerced > hi or (not hi_inc and coerced == hi)):
                    raise ValueError(f"{canonical}={coerced} out of range")
            if canonical in _CHOICES and coerced is not None:
                coerced = str(coerced).lower()   # case-normalize enums
                if coerced not in _CHOICES[canonical]:
                    # fail LOUDLY at parse time: a typo'd enum (e.g.
                    # tpu_hist_kernel="palas") would otherwise train
                    # silently on some fallback path — the
                    # invisible-remap class the r05 postmortem is about
                    raise ValueError(
                        f"{canonical}={coerced!r} is not one of "
                        f"{'/'.join(_CHOICES[canonical])}")
            self._values[canonical] = coerced
            self._explicit[canonical] = coerced
        self._post_process()

    def __getattr__(self, name: str) -> Any:
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError(name)

    def __contains__(self, name: str) -> bool:
        return _ALIAS_TO_NAME.get(name, name) in self._values

    def get(self, name: str, default: Any = None) -> Any:
        return self._values.get(_ALIAS_TO_NAME.get(name, name), default)

    def set(self, name: str, value: Any) -> None:
        self.update({name: value})

    def is_default(self, name: str) -> bool:
        return _ALIAS_TO_NAME.get(name, name) not in self._explicit

    def copy(self) -> "Config":
        c = Config()
        c._values = dict(self._values)
        c._explicit = dict(self._explicit)
        return c

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._values)

    def explicit_params(self) -> Dict[str, Any]:
        return dict(self._explicit)

    def to_string(self) -> str:
        """The ``parameters:`` block written into saved models
        (ref: Config::ToString via gbdt_model_text.cpp:399-403)."""
        lines = []
        for name in _P:
            v = self._values[name]
            if v is None:
                continue
            if isinstance(v, bool):
                v = int(v)
            elif isinstance(v, list):
                v = ",".join(str(x) for x in v)
            lines.append(f"[{name}: {v}]")
        return "\n".join(lines)

    def distributed_refusals(self, world: int) -> List[str]:
        """What training refuses in a ``torch.distributed`` world of
        ``world`` processes: a ``tpu_num_devices`` other than the world
        size (0 or less: every rank; one process is one device)."""
        n = int(self._values["tpu_num_devices"])
        if n > 0 and n != world:
            return [f"tpu_num_devices={n} in a world of {world} "
                    "processes (one process is one device: set it to "
                    "the world size or 0)"]
        return []

    def unsupported_settings(self) -> List[str]:
        """``name=value (ROADMAP item)`` for every setting the port cannot
        honour yet."""
        return [f"{name}={self._values[name]!r} (ROADMAP {item})"
                for name, (bad, item) in _UNSUPPORTED_WHEN.items()
                if bad(self._values[name])]

    # -- internals -------------------------------------------------------
    def _post_process(self) -> None:
        v = self._values
        # objective alias canonicalization
        obj = str(v["objective"]).lower()
        if obj in _OBJ_ALIAS:
            canonical_obj = _OBJ_ALIAS[obj]
            if obj in ("l2_root", "root_mean_squared_error", "rmse"):
                # rmse is trained as l2 (ref: regression objective handles sqrt
                # only through reg_sqrt; LightGBM maps rmse->regression)
                canonical_obj = "regression"
            v["objective"] = canonical_obj
        # metric canonicalization; default metric = objective's metric
        metrics = []
        for m in v["metric"]:
            ml = str(m).lower()
            # keep ndcg@k / map@k suffixes
            base, at = (ml.split("@", 1) + [None])[:2]
            canonical_m = _METRIC_ALIAS.get(base, base)
            metrics.append(f"{canonical_m}@{at}" if at else canonical_m)
        v["metric"] = metrics
        # seed cascading (ref: config.cpp: seed overrides derived seeds
        # unless they were set explicitly)
        if v.get("seed") is not None:
            seed = v["seed"]
            for derived, offset_name in (
                    ("data_random_seed", 1), ("feature_fraction_seed", 2),
                    ("bagging_seed", 3), ("drop_seed", 4), ("objective_seed", 5),
                    ("extra_seed", 6)):
                if derived not in self._explicit:
                    v[derived] = seed + offset_name
        # num_class sanity
        if v["objective"] in ("multiclass", "multiclassova") and v["num_class"] <= 1:
            raise ValueError("num_class must be >1 for multiclass objectives")
        if v["objective"] not in ("multiclass", "multiclassova", "custom") \
                and v["num_class"] != 1 and v["objective"] != "binary":
            # non-multiclass objectives require num_class == 1
            if v["num_class"] > 1:
                raise ValueError(
                    f"num_class must be 1 for objective {v['objective']}")
        # bagging implied by goss strategy
        if str(v["boosting"]).lower() == "goss":
            # legacy spelling: boosting=goss == gbdt + data_sample_strategy=goss
            v["boosting"] = "gbdt"
            v["data_sample_strategy"] = "goss"
        log.set_verbosity(v["verbosity"])


def canonical_objective(name: str) -> str:
    return _OBJ_ALIAS.get(str(name).lower(), str(name).lower())


def canonical_metric(name: str) -> str:
    ml = str(name).lower()
    base, at = (ml.split("@", 1) + [None])[:2]
    canonical_m = _METRIC_ALIAS.get(base, base)
    return f"{canonical_m}@{at}" if at else canonical_m


def param_registry() -> Dict[str, Tuple[Any, Any, Tuple[str, ...], Any]]:
    return dict(_P)
