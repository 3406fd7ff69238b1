"""Command-line application.

Port of ``lightgbm_tpu/cli.py`` (ref: src/main.cpp:15,
src/application/application.cpp — LoadParameters :54, tasks kTrain/
kPredict/kConvertModel/kRefitTree/kSaveBinary, InitTrain :176,
Train :217, Predict :229).

Usage matches the reference:

    python -m lightgbm_tpu_torch config=train.conf [key=value ...]
    python -m lightgbm_tpu_torch task=train data=train.csv objective=binary

Config files are `key = value` lines; `#` starts a comment
(ref: application.cpp LoadParameters config-file branch).

Every task runs on the card unless ``device_type=cpu`` is given (or
``LIGHTGBM_TPU_PLATFORM=cpu`` was set when the package was imported); a
model file is loaded onto that device too. ``tpu_fallback_to_cpu=true``
is refused: the port does not fall back from the card.
"""
from __future__ import annotations

import os
import re
import sys
from typing import Dict, List, Tuple

import numpy as np

from .basic import Booster, Dataset
from .config import Config
from .engine import _refuse_unported
from .engine import train as train_fn
from .utils import log
from .utils.log import LightGBMError

__all__ = ["main", "run"]


def parse_config_file(path: str) -> Dict[str, str]:
    """ref: application.cpp:77-90 (config= file parsing)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, value = line.split("=", 1)
            out[key.strip()] = value.strip()
    return out


def parse_args(argv: List[str]) -> Dict[str, str]:
    """argv `key=value` pairs; `config=` pulls in a file, with command-line
    values taking precedence (ref: application.cpp:54-75 LoadParameters)."""
    cli: Dict[str, str] = {}
    for arg in argv:
        if "=" not in arg:
            raise LightGBMError(f"Unknown argument format: {arg!r} "
                                "(expected key=value)")
        key, value = arg.split("=", 1)
        cli[key.strip()] = value.strip()
    params: Dict[str, str] = {}
    config_path = cli.get("config") or cli.get("config_file")
    if config_path:
        params.update(parse_config_file(config_path))
    params.update(cli)  # CLI wins over file
    params.pop("config", None)
    params.pop("config_file", None)
    return params


def _load_booster(cfg: Config) -> Booster:
    """The model of ``input_model`` on the device ``device_type`` names."""
    return Booster(params={"device_type": cfg.device_type},
                   model_file=cfg.input_model)


def _load_train_data(cfg: Config, params: Dict) -> Tuple[Dataset,
                                                         List[Dataset],
                                                         List[str]]:
    if not cfg.data:
        raise LightGBMError("No training data: set data=<file>")
    train_set = Dataset(cfg.data, params=dict(params))
    valid_sets: List[Dataset] = []
    valid_names: List[str] = []
    for i, vpath in enumerate(cfg.valid):
        valid_sets.append(train_set.create_valid(vpath))
        valid_names.append(f"valid_{i + 1}" if len(cfg.valid) > 1
                           else "valid_1")
    return train_set, valid_sets, valid_names


def _prune_snapshots(out_model: str, keep_last: int) -> None:
    """Keep only the newest ``keep_last`` snapshot_iter files (config
    snapshot_keep_last bounds the disk footprint); tmp litter from killed
    atomic writes goes in the same sweep (robustness.checkpoint)."""
    from .robustness.checkpoint import prune_numbered
    prune_numbered(
        os.path.dirname(os.path.abspath(out_model)),
        re.compile(re.escape(os.path.basename(out_model)) +
                   r"\.snapshot_iter_(\d+)$"),
        keep_last)


def task_train(cfg: Config, params: Dict) -> None:
    """ref: application.cpp InitTrain/Train."""
    train_set, valid_sets, valid_names = _load_train_data(cfg, params)
    if cfg.save_binary:
        # persist the freshly-binned dataset next to the text file
        # (ref: config save_binary, dataset_loader.cpp SaveBinaryFile)
        train_set.save_binary(str(cfg.data) + ".bin")
    callbacks = []
    if cfg.metric_freq > 0 and (valid_sets or
                                cfg.is_provide_training_metric):
        # per-iteration metric printing every metric_freq rounds
        # (ref: application.cpp OutputMetric cadence, gbdt.cpp:486)
        from .callback import log_evaluation
        callbacks.append(log_evaluation(period=int(cfg.metric_freq)))
    if cfg.snapshot_freq > 0:
        out_model = cfg.output_model
        keep_last = max(int(cfg.snapshot_keep_last), 1)

        def _snapshot(env):
            it = env.iteration + 1
            if it % cfg.snapshot_freq == 0:
                # atomic write: a kill mid-write leaves the previous
                # snapshot whole
                env.model.save_model(f"{out_model}.snapshot_iter_{it}",
                                     atomic=True)
                _prune_snapshots(out_model, keep_last)
        _snapshot.order = 100
        callbacks.append(_snapshot)

    booster = train_fn(
        dict(params), train_set,
        valid_sets=valid_sets or None, valid_names=valid_names or None,
        init_model=cfg.input_model or None,
        callbacks=callbacks or None)
    # 0 = split counts, 1 = total gains (ref: config
    # saved_feature_importance_type; gbdt_model_text.cpp FeatureImportance)
    imp_type = "gain" if cfg.saved_feature_importance_type == 1 else "split"
    booster.save_model(cfg.output_model, importance_type=imp_type)
    log.info(f"Finished training; model saved to {cfg.output_model}")


def task_predict(cfg: Config, params: Dict) -> None:
    """ref: application.cpp:229 Predict -> Predictor over file."""
    if not cfg.input_model:
        raise LightGBMError("task=predict needs input_model=<model file>")
    if not cfg.data:
        raise LightGBMError("task=predict needs data=<file>")
    booster = _load_booster(cfg)
    from .io.file_loader import load_svm_or_csv
    X, _, _, _ = load_svm_or_csv(cfg.data, cfg)
    result = booster.predict(
        X,
        start_iteration=max(int(cfg.start_iteration_predict), 0),
        num_iteration=cfg.num_iteration_predict
        if cfg.num_iteration_predict > 0 else None,
        raw_score=cfg.predict_raw_score,
        pred_leaf=cfg.predict_leaf_index,
        pred_contrib=cfg.predict_contrib)
    result = np.asarray(result)
    if result.ndim == 1:
        result = result[:, None]   # one prediction per output line
    with open(cfg.output_result, "w") as f:
        for row in result:
            f.write("\t".join(f"{v:g}" for v in row) + "\n")
    log.info(f"Finished prediction; results saved to {cfg.output_result}")


def task_convert_model(cfg: Config, params: Dict) -> None:
    """Generate standalone if-else prediction source from a model
    (ref: application.cpp ConvertModel -> GBDT::SaveModelToIfElse,
    src/boosting/gbdt_model_text.cpp ModelToIfElse)."""
    if not cfg.input_model:
        raise LightGBMError("task=convert_model needs input_model=<file>")
    if cfg.convert_model_language not in ("", "cpp"):
        log.warning(f"convert_model_language="
                    f"{cfg.convert_model_language!r} is not supported; "
                    "only 'cpp' codegen exists — emitting cpp")
    booster = _load_booster(cfg)
    from .io.codegen import model_to_cpp_ifelse
    src = model_to_cpp_ifelse(booster._engine, booster.config)
    with open(cfg.convert_model, "w") as f:
        f.write(src)
    log.info(f"Converted model saved to {cfg.convert_model}")


def task_refit(cfg: Config, params: Dict) -> None:
    """ref: application.cpp KRefitTree."""
    if not cfg.input_model:
        raise LightGBMError("task=refit needs input_model=<model file>")
    if not cfg.data:
        raise LightGBMError("task=refit needs data=<file>")
    booster = _load_booster(cfg)
    from .io.file_loader import load_svm_or_csv
    X, y, w, grp = load_svm_or_csv(cfg.data, cfg)
    if y is None:
        raise LightGBMError("refit data must contain labels")
    refitted = booster.refit(X, y, decay_rate=cfg.refit_decay_rate,
                             weight=w, group=grp)
    refitted.save_model(cfg.output_model)
    log.info(f"Refitted model saved to {cfg.output_model}")


def task_save_binary(cfg: Config, params: Dict) -> None:
    """ref: application.cpp kSaveBinary -> Dataset::SaveBinaryFile."""
    if not cfg.data:
        raise LightGBMError("task=save_binary needs data=<file>")
    out = cfg.data + ".bin"
    Dataset(cfg.data, params=dict(params)).save_binary(out)
    log.info(f"Binary dataset saved to {out}")


_TASKS = {
    "train": task_train,
    "refit": task_refit,
    "refit_tree": task_refit,
    "predict": task_predict,
    "prediction": task_predict,
    "test": task_predict,
    "convert_model": task_convert_model,
    "save_binary": task_save_binary,
}


def run(argv: List[str]) -> int:
    """Run one task; 0 on success, 1 (with ``Met Exceptions: ...``
    logged) on a framework error or a missing file."""
    try:
        params = parse_args(argv)
        cfg = Config(dict(params))
        # the device is the Config's (device_type, cuda by default); the
        # JAX package's probe-and-degrade has no counterpart here
        _refuse_unported(params)
        task = _TASKS.get(cfg.task)
        if task is None:
            raise LightGBMError(
                f"Unknown task {cfg.task!r}; expected one of "
                f"{sorted(set(_TASKS))}")
        task(cfg, params)
        return 0
    except (LightGBMError, FileNotFoundError) as e:
        log.warning(f"Met Exceptions: {e}")
        return 1


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
