"""``train``: the training entry point.

Port of ``lightgbm_tpu/engine.py`` ``train`` (ref:
python-package/lightgbm/engine.py:109): boosting rounds over a training
``Dataset`` with validation sets, custom evaluation functions
(``feval``), callbacks ordered by ``before_iteration`` / ``order``, early
stopping from the params (``early_stopping_round``, ``first_metric_only``,
``early_stopping_min_delta``) or from a callback, and continued training
from ``init_model`` (a model file path or a Booster). A callable
``params["objective"]`` is the custom objective: it gives each
iteration's gradients (``Booster.update(fobj=)``). Refused, each naming
its ROADMAP item: ``resume_from`` (A12.7) and ``tpu_fallback_to_cpu``,
which the port never honours: it does not fall back from the card.
"""
from __future__ import annotations

import collections
import copy
from typing import Any, Callable, Dict, List, Optional, Union

from . import callback as callback_module
from .basic import Booster, Dataset
from .callback import CallbackEnv, EarlyStopException
from .config import _ConfigAliases
from .utils import log


def _pop_callable_objective(params: Dict[str, Any]) -> Optional[Callable]:
    """A callable ``objective`` (under any alias) becomes ``fobj``, and the
    params train the ``custom`` objective (ref: engine.py:74-80)."""
    obj = params.get("objective")
    for alias in _ConfigAliases.get("objective"):
        if alias in params:
            obj = params[alias]
    if not callable(obj):
        return None
    for alias in _ConfigAliases.get("objective"):
        params.pop(alias, None)
    params["objective"] = "custom"
    return obj


def _refuse_unported(params: Dict[str, Any], resume_from) -> None:
    if resume_from is not None:
        log.fatal("resume_from (checkpoint resume) is not ported yet "
                  "(ROADMAP A12.7)")
    if str(params.get("tpu_fallback_to_cpu", "")).lower() in \
            ("1", "true", "yes", "on"):
        log.fatal("tpu_fallback_to_cpu: the port does not fall back from "
                  "the card; pass device_type='cpu' to run on the CPU")


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          feval=None, init_model: Optional[Union[str, Booster]] = None,
          keep_training_booster: bool = False,
          callbacks: Optional[List[Callable]] = None,
          resume_from: Optional[str] = None) -> Booster:
    """Train one model; returns the Booster (ref: engine.py:109)."""
    params = copy.deepcopy(params) if params else {}
    fobj = _pop_callable_objective(params)
    _refuse_unported(params, resume_from)
    for alias in _ConfigAliases.get("num_iterations"):
        if alias in params:
            num_boost_round = int(params.pop(alias))
    early_stopping_round = None
    for alias in _ConfigAliases.get("early_stopping_round"):
        if params.get(alias) is not None:
            early_stopping_round = int(params[alias])
    first_metric_only = bool(params.get("first_metric_only", False))
    if num_boost_round <= 0:
        raise ValueError("num_boost_round must be greater than 0")
    if not isinstance(train_set, Dataset):
        raise TypeError("train() only accepts Dataset object")

    train_set._update_params(params).construct()
    if isinstance(init_model, str):
        predictor = Booster(params=params, model_file=init_model)
    else:
        predictor = init_model
    booster = Booster(params=params, train_set=train_set)
    if predictor is not None:
        booster._engine.init_from_model(predictor._engine)

    eval_train_name = None
    if valid_sets is not None:
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        if valid_names is None:
            valid_names = [f"valid_{i}" for i in range(len(valid_sets))]
        for vs, name in zip(valid_sets, valid_names):
            if vs is train_set:
                eval_train_name = name
            else:
                booster.add_valid(vs, name)

    cbs = set(callbacks or [])
    if early_stopping_round is not None and early_stopping_round > 0:
        verbosity = 1
        for alias in _ConfigAliases.get("verbosity"):
            if params.get(alias) is not None:
                verbosity = int(params[alias])
        min_delta = params.get("early_stopping_min_delta")
        cbs.add(callback_module.early_stopping(
            early_stopping_round, first_metric_only,
            verbose=verbosity >= 1,
            min_delta=float(min_delta) if min_delta is not None else 0.0))
    callbacks_before = sorted(
        (cb for cb in cbs if getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))
    callbacks_after = sorted(
        (cb for cb in cbs if not getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))

    if eval_train_name is not None:
        booster.train_data_name = eval_train_name
    init_iteration = booster.current_iteration()
    end_iteration = init_iteration + num_boost_round
    evaluation_result_list: List = []
    for i in range(init_iteration, end_iteration):
        for cb in callbacks_before:
            cb(CallbackEnv(model=booster, params=params, iteration=i,
                           begin_iteration=init_iteration,
                           end_iteration=end_iteration,
                           evaluation_result_list=None))
        finished = booster.update(fobj=fobj)

        evaluation_result_list = []
        if eval_train_name is not None or \
                booster.config.is_provide_training_metric:
            name = eval_train_name or "training"
            evaluation_result_list.extend(
                (name, n, v, h) for _, n, v, h in booster.eval_train(feval))
        if booster.valid_sets:
            evaluation_result_list.extend(booster.eval_valid(feval))
        try:
            for cb in callbacks_after:
                cb(CallbackEnv(model=booster, params=params, iteration=i,
                               begin_iteration=init_iteration,
                               end_iteration=end_iteration,
                               evaluation_result_list=evaluation_result_list))
        except EarlyStopException as stop:
            booster.best_iteration = stop.best_iteration + 1
            evaluation_result_list = stop.best_score
            break
        if finished:
            break

    booster.best_score = collections.defaultdict(collections.OrderedDict)
    for data_name, metric, value, _ in evaluation_result_list:
        booster.best_score[data_name][metric] = value
    if not keep_training_booster:
        booster.free_dataset()
    return booster
