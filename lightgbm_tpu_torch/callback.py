"""Training callbacks.

Copy of ``lightgbm_tpu/callback.py`` (ref: python-package/lightgbm/
callback.py: CallbackEnv :65, EarlyStopException :40, log_evaluation
:109, record_evaluation :183, reset_parameter :254, early_stopping
:462) and ``checkpoint_callback`` (the JAX package's callback.py:126,
over ``robustness/checkpoint.py``). Under ``cv`` the model is the
``CVBooster``, which passes ``reset_parameter`` on to every fold's
Booster.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Tuple, Union

from .utils import log

__all__ = ["EarlyStopException", "CallbackEnv", "log_evaluation",
           "record_evaluation", "reset_parameter", "early_stopping",
           "checkpoint_callback"]


class EarlyStopException(Exception):
    """Raised by callbacks to stop training (ref: callback.py:40)."""

    def __init__(self, best_iteration: int,
                 best_score: List[Tuple[str, str, float, bool]]):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def _format_eval_result(value: Tuple, show_stdv: bool = True) -> str:
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    if len(value) == 5:  # cv result with stdv
        if show_stdv:
            return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    raise ValueError("Wrong metric value")


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """Log evaluation results every ``period`` iterations
    (ref: callback.py:109)."""

    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list and \
                (env.iteration + 1) % period == 0:
            result = "\t".join(
                _format_eval_result(x, show_stdv)
                for x in env.evaluation_result_list)
            log.info(f"[{env.iteration + 1}]\t{result}")

    _callback.order = 10  # type: ignore
    return _callback


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]
                      ) -> Callable:
    """Record eval history into ``eval_result`` (ref: callback.py:183)."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _init(env: CallbackEnv) -> None:
        eval_result.clear()
        for item in env.evaluation_result_list or []:
            data_name, eval_name = item[0], item[1]
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])

    def _callback(env: CallbackEnv) -> None:
        if env.iteration == env.begin_iteration:
            _init(env)
        for item in env.evaluation_result_list or []:
            data_name, eval_name, result = item[0], item[1], item[2]
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])
            eval_result[data_name][eval_name].append(result)

    _callback.order = 20  # type: ignore
    return _callback


def reset_parameter(**kwargs: Union[list, Callable]) -> Callable:
    """Reset parameters on a schedule (ref: callback.py:254).
    Values are lists (per-iteration) or callables iteration -> value."""

    def _callback(env: CallbackEnv) -> None:
        new_parameters = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(
                        f"Length of list {key!r} has to equal to "
                        "'num_boost_round'")
                new_param = value[env.iteration - env.begin_iteration]
            elif callable(value):
                new_param = value(env.iteration - env.begin_iteration)
            else:
                raise ValueError("Only list and callable values are "
                                 "supported as a mapping from boosting round "
                                 "index to new parameter value")
            if new_param != env.params.get(key, None):
                new_parameters[key] = new_param
        if new_parameters:
            env.model.reset_parameter(new_parameters)
            env.params.update(new_parameters)

    _callback.before_iteration = True  # type: ignore
    _callback.order = 10  # type: ignore
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True,
                   min_delta: Union[float, List[float]] = 0.0) -> Callable:
    """Early stopping on validation metrics (ref: callback.py:462
    _EarlyStoppingCallback)."""
    if not isinstance(stopping_rounds, int) or stopping_rounds <= 0:
        raise ValueError("stopping_rounds should be greater than zero.")

    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List[list] = []
    cmp_op: List[Callable] = []
    enabled = [True]
    first_metric = [""]

    def _is_train_set(ds_name: str, env: CallbackEnv) -> bool:
        return ds_name == getattr(env.model, "train_data_name", "training")

    def _init(env: CallbackEnv) -> None:
        enabled[0] = not any(
            env.params.get(alias, "") == "dart"
            for alias in ("boosting", "boosting_type", "boost"))
        if not enabled[0]:
            log.warning("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric "
                "is required for evaluation")
        if verbose:
            log.info(f"Training until validation scores don't improve for "
                     f"{stopping_rounds} rounds")

        n_metrics = len({m[1] for m in env.evaluation_result_list})
        n_datasets = len({m[0] for m in env.evaluation_result_list})
        deltas = (min_delta if isinstance(min_delta, list)
                  else [min_delta] * n_datasets * n_metrics)
        if isinstance(min_delta, list):
            if not all(t >= 0 for t in min_delta):
                raise ValueError(
                    "Values for early stopping min_delta must be "
                    "non-negative.")
            if len(min_delta) == 0:
                deltas = [0.0] * n_datasets * n_metrics
            elif len(min_delta) == 1:
                deltas = min_delta * n_datasets * n_metrics
            elif len(min_delta) != n_metrics:
                raise ValueError(
                    "Must provide a single value for min_delta or as many "
                    "as metrics.")
            elif first_metric_only:
                deltas = min_delta[:1] * n_datasets
            else:
                deltas = min_delta * n_datasets
        else:
            if min_delta < 0:
                raise ValueError(
                    "Early stopping min_delta must be non-negative.")

        first_metric[0] = env.evaluation_result_list[0][1].split(" ")[-1]
        for eval_ret, delta in zip(env.evaluation_result_list, deltas):
            best_iter.append(0)
            best_score_list.append(None)
            if eval_ret[3]:  # higher is better
                best_score.append(float("-inf"))
                cmp_op.append(
                    lambda curr, best, d=delta: curr > best + d)
            else:
                best_score.append(float("inf"))
                cmp_op.append(
                    lambda curr, best, d=delta: curr < best - d)

    def _final_iteration_check(env: CallbackEnv, eval_name_splitted,
                               i: int) -> None:
        if env.iteration == env.end_iteration - 1:
            if verbose:
                best = "\t".join(
                    _format_eval_result(x) for x in best_score_list[i])
                log.info("Did not meet early stopping. Best iteration is:\n"
                         f"[{best_iter[i] + 1}]\t{best}")
                if first_metric_only:
                    log.info(f"Evaluated only: {eval_name_splitted[-1]}")
            raise EarlyStopException(best_iter[i], best_score_list[i])

    def _callback(env: CallbackEnv) -> None:
        if env.iteration == env.begin_iteration:
            _init(env)
        if not enabled[0]:
            return
        for i in range(len(env.evaluation_result_list)):
            score = env.evaluation_result_list[i][2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            eval_name_splitted = env.evaluation_result_list[i][1].split(" ")
            if first_metric_only and first_metric[0] != \
                    eval_name_splitted[-1]:
                continue
            if _is_train_set(env.evaluation_result_list[i][0], env):
                continue
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    best = "\t".join(
                        _format_eval_result(x) for x in best_score_list[i])
                    log.info("Early stopping, best iteration is:\n"
                             f"[{best_iter[i] + 1}]\t{best}")
                    if first_metric_only:
                        log.info(f"Evaluated only: "
                                 f"{eval_name_splitted[-1]}")
                raise EarlyStopException(best_iter[i], best_score_list[i])
            _final_iteration_check(env, eval_name_splitted, i)

    _callback.order = 30  # type: ignore
    return _callback


def checkpoint_callback(directory: str, every_n: int = 1,
                        keep_last: int = 3) -> Callable:
    """Atomically checkpoint the FULL training state every ``every_n``
    iterations (and at the last), keeping the newest ``keep_last``
    checkpoints (ref: the JAX package's callback.py:126).

    Each checkpoint (robustness/checkpoint.py) carries the model string
    plus loop state — iteration, best_iteration/best_score, the eval
    history accumulated so far, and the bagging/column RNG snapshots —
    and is written atomically (tmp + fsync + rename, CRC32 footer), so
    a kill at any byte leaves the previous checkpoints intact. Resume
    with ``train(..., resume_from=directory)``: the newest CRC-valid
    checkpoint is selected and training continues bit-identically to an
    uninterrupted run.

    Early-stopping state is NOT part of the contract: the
    early_stopping callback re-initializes at the resume point, so a
    resumed run may stop later than the uninterrupted one when a crash
    lands inside the patience window. ``cv`` folds are not checkpointed.
    Over a sharded-ingest train set a gang manifest commits each
    checkpoint (``robustness/gang.py``); in a gang one rank writes, the
    training state being the same on every rank.
    """
    if every_n <= 0:
        raise ValueError("every_n must be greater than zero")
    if keep_last <= 0:
        raise ValueError("keep_last must be greater than zero")
    from .robustness import checkpoint as _ckpt

    eval_history: Dict[str, Dict[str, List[float]]] = {}
    warned_cv = [False]

    def _callback(env: CallbackEnv) -> None:
        for item in env.evaluation_result_list or []:
            eval_history.setdefault(item[0], collections.OrderedDict()) \
                .setdefault(item[1], []).append(item[2])
        it = env.iteration + 1
        if it % every_n != 0 and env.iteration != env.end_iteration - 1:
            return
        if hasattr(env.model, "boosters"):      # a cv() CVBooster
            if not warned_cv[0]:
                warned_cv[0] = True
                log.warning("checkpoint_callback only supports "
                            "train() Boosters; skipping (cv() folds "
                            "are not checkpointed)")
            return
        state = _ckpt.booster_state(env.model, it, eval_history)
        # keep_last lets a full disk prune and retry once, as the
        # retention below would prune anyway
        path = _ckpt.write_checkpoint(directory, state, keep_last=keep_last)
        # in a sharded world the gang manifest, written after its
        # checkpoint, commits it (world size, each rank's shard digest):
        # a resume refuses another sharding and restarts at the newest
        # committed iteration (the JAX package's callback.py:172-195)
        eng = getattr(env.model, "_engine", None)
        shard = getattr(getattr(eng, "train_set", None), "shard", None)
        if shard is not None and getattr(shard, "digests", None) and \
                bool(getattr(getattr(eng, "config", None),
                             "tpu_gang_manifest", True)):
            from .robustness import gang
            gang.write_manifest(directory, it, _ckpt.checkpoint_name(it),
                                shard)
            gang.prune_manifests(directory, keep_last)
        _ckpt.prune_checkpoints(directory, keep_last)
        log.debug(f"checkpoint written: {path}")

    def _seed(state: Dict) -> None:
        eval_history.clear()
        eval_history.update(state.get("eval_history") or {})

    _callback.order = 100  # type: ignore
    _callback._ckpt_seed_state = _seed  # type: ignore
    return _callback
