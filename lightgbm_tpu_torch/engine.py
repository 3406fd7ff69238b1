"""``train`` and ``cv``: the training entry points.

Port of ``lightgbm_tpu/engine.py`` (ref: python-package/lightgbm/
engine.py: train :109, cv and CVBooster :356+). ``train`` runs boosting
rounds over a training ``Dataset`` with validation sets, custom
evaluation functions (``feval``), callbacks ordered by
``before_iteration`` / ``order``, early stopping from the params
(``early_stopping_round``, ``first_metric_only``,
``early_stopping_min_delta``) or from a callback, and continued training
from ``init_model`` (a model file path or a Booster). ``cv`` trains one
Booster a fold, each on a ``Dataset.subset`` of the rows with the rest as
its validation set, in lock step, and aggregates each metric's mean and
standard deviation over the folds each round. A callable
``params["objective"]`` is the custom objective: it gives each
iteration's gradients (``Booster.update(fobj=)``). ``resume_from``
continues from the newest CRC-valid checkpoint that
``callback.checkpoint_callback`` wrote (the JAX package's
engine.py:97-180); over a sharded-ingest train set it continues from
the newest checkpoint a gang manifest commits, refusing a checkpoint set
of another world or sharding (``tpu_gang_manifest``,
``robustness/gang.py``). ``tpu_fallback_to_cpu`` is refused: the port
does not fall back from the card.
"""
from __future__ import annotations

import collections
import copy
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from . import callback as callback_module
from .basic import Booster, Dataset
from .callback import CallbackEnv, EarlyStopException
from .config import Config, _ConfigAliases
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


def _refuse_unported(params: Dict[str, Any]) -> None:
    if str(params.get("tpu_fallback_to_cpu", "")).lower() in \
            ("1", "true", "yes", "on"):
        log.fatal("tpu_fallback_to_cpu: the port does not fall back from "
                  "the card; pass device_type='cpu' to run on the CPU")


def _sorted_callbacks(callbacks: Optional[List[Callable]],
                      early_stopping_round: Optional[int],
                      params: Dict[str, Any], verbose: bool):
    """The callbacks run before and after each iteration, each list in
    ``order``, with the params' early stopping added."""
    cbs = set(callbacks or [])
    if early_stopping_round is not None and early_stopping_round > 0:
        min_delta = params.get("early_stopping_min_delta")
        cbs.add(callback_module.early_stopping(
            early_stopping_round,
            bool(params.get("first_metric_only", False)), verbose=verbose,
            min_delta=float(min_delta) if min_delta is not None else 0.0))
    order = lambda cb: getattr(cb, "order", 0)
    return (sorted((cb for cb in cbs
                    if getattr(cb, "before_iteration", False)), key=order),
            sorted((cb for cb in cbs
                    if not getattr(cb, "before_iteration", False)),
                   key=order))


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          feval=None, init_model: Optional[Union[str, Booster]] = None,
          keep_training_booster: bool = False,
          callbacks: Optional[List[Callable]] = None,
          resume_from: Optional[str] = None) -> Booster:
    """Train one model; returns the Booster (ref: engine.py:109).

    ``resume_from``: a directory of checkpoints written by
    ``callback.checkpoint_callback``. The newest CRC-valid checkpoint is
    loaded (corrupt or partial files are skipped with a warning) and
    wins over ``init_model``; training continues from its iteration,
    with its samplers' RNG states, so the run equals an uninterrupted
    one. ``num_boost_round`` is the TOTAL round target, so the same
    call can be re-run verbatim after a crash; a checkpoint already at
    it returns at once. With no valid checkpoint, training starts
    fresh."""
    params = copy.deepcopy(params) if params else {}
    fobj = _pop_callable_objective(params)
    _refuse_unported(params)
    for alias in _ConfigAliases.get("num_iterations"):
        if alias in params:
            num_boost_round = int(params.pop(alias))
    early_stopping_round = None
    for alias in _ConfigAliases.get("early_stopping_round"):
        if params.get(alias) is not None:
            early_stopping_round = int(params[alias])
    if num_boost_round <= 0:
        raise ValueError("num_boost_round must be greater than 0")
    if not isinstance(train_set, Dataset):
        raise TypeError("train() only accepts Dataset object")

    resumed_state = None
    if resume_from:
        from .robustness.checkpoint import latest_valid_checkpoint
        found = latest_valid_checkpoint(resume_from)
        if found is not None:
            ckpt_path, resumed_state = found
            if init_model is not None:
                log.warning("resume_from checkpoint found; ignoring "
                            "init_model")
            init_model = Booster(params=params,
                                 model_str=resumed_state["model"])
            log.info(f"Resuming from checkpoint {ckpt_path} "
                     f"(iteration {resumed_state['iteration']})")
        else:
            log.info(f"resume_from={resume_from!r}: no valid "
                     "checkpoint; starting fresh")

    train_set._update_params(params).construct()
    # gang-coordinated resume (the JAX package's engine.py:117-135): in a
    # sharded world the checkpoint set must belong to this sharding, and
    # the restart is the newest COMMITTED (manifested) iteration, the
    # same on every rank and every relaunch
    if resume_from and Config(params).tpu_gang_manifest:
        shard = train_set.binned.shard
        if shard is not None:
            from .robustness.gang import validate_and_select_resume
            anchored = validate_and_select_resume(resume_from, shard,
                                                  resumed_state)
            if anchored is not resumed_state:
                resumed_state = anchored
                init_model = (Booster(params=params,
                                      model_str=anchored["model"])
                              if anchored is not None else None)
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

    verbosity = 1
    for alias in _ConfigAliases.get("verbosity"):
        if params.get(alias) is not None:
            verbosity = int(params[alias])
    if resumed_state is not None:
        from .robustness.checkpoint import restore_into_booster
        restore_into_booster(booster, resumed_state)
        done = int(resumed_state.get("iteration",
                                     booster.current_iteration()))
        # hand the persisted eval history back to the checkpoint
        # callback, so later checkpoints carry the whole run's history
        for cb in callbacks or []:
            seed = getattr(cb, "_ckpt_seed_state", None)
            if seed is not None:
                seed(resumed_state)
        if num_boost_round - done <= 0:
            log.info(f"checkpoint already at iteration {done} >= "
                     f"num_boost_round={num_boost_round}; nothing to "
                     "train")
            if not keep_training_booster:
                booster.free_dataset()
            return booster
        num_boost_round -= done
    callbacks_before, callbacks_after = _sorted_callbacks(
        callbacks, early_stopping_round, params, verbose=verbosity >= 1)

    if eval_train_name is not None:
        booster.train_data_name = eval_train_name
    init_iteration = booster.current_iteration()
    end_iteration = init_iteration + num_boost_round
    evaluation_result_list: List = []
    profile_dir = str(booster.config.tpu_profile_dir or "")
    # a trace of the whole boosting loop (ref: the JAX package's
    # engine.py:211-250, jax.profiler there)
    prof = _profile_start(booster) if profile_dir else None
    try:
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
                    (name, n, v, h)
                    for _, n, v, h in booster.eval_train(feval))
            if booster.valid_sets:
                evaluation_result_list.extend(booster.eval_valid(feval))
            try:
                for cb in callbacks_after:
                    cb(CallbackEnv(
                        model=booster, params=params, iteration=i,
                        begin_iteration=init_iteration,
                        end_iteration=end_iteration,
                        evaluation_result_list=evaluation_result_list))
            except EarlyStopException as stop:
                booster.best_iteration = stop.best_iteration + 1
                evaluation_result_list = stop.best_score
                break
            if finished:
                break
    finally:
        if prof is not None:
            trace_path = _profile_stop(prof, profile_dir)
    if prof is not None:
        _check_trace(trace_path, booster)

    booster.best_score = collections.defaultdict(collections.OrderedDict)
    for data_name, metric, value, _ in evaluation_result_list:
        booster.best_score[data_name][metric] = value
    if not keep_training_booster:
        booster.free_dataset()
    return booster


def _on_card(booster: Booster) -> bool:
    dev = getattr(booster._engine, "device", None)
    return getattr(dev, "type", None) == "cuda"


def _profile_start(booster: Booster):
    """Start ``torch.profiler`` over the host's activity, and the
    card's when the booster trains on one. Refuses, before any
    iteration, a torch that cannot trace the card (no CUPTI): a trace
    of host activity alone would pass for one of the card."""
    from torch.profiler import ProfilerActivity, profile, supported_activities
    activities = [ProfilerActivity.CPU]
    if _on_card(booster):
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(
                "tpu_profile_dir: this torch cannot trace CUDA activity "
                "(no CUPTI); refusing to record the host's activity alone")
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _profile_stop(prof, profile_dir: str) -> str:
    """Stop the profiler and export its Chrome trace into
    ``profile_dir``; returns the file's path."""
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(
        profile_dir, f"lightgbm_tpu_torch.{os.getpid()}."
        f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    log.info(f"boosting-loop trace written to {path}")
    return path


def _check_trace(path: str, booster: Booster) -> None:
    """On the card the trace must hold the card's kernels: CUPTI can
    be built in yet fail at run time, and the profiler then records the
    host alone with only a warning."""
    if not _on_card(booster):
        return
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    if '"cat": "kernel"' not in text and '"cat":"kernel"' not in text:
        raise RuntimeError(
            f"tpu_profile_dir: the trace {path} holds no CUDA kernel; "
            "the profiler could not trace the card (CUPTI)")


class CVBooster:
    """The fold Boosters of ``cv`` (ref: engine.py:356 CVBooster). An
    attribute it lacks is called on every fold Booster: ``predict(X)``
    gives one answer a fold."""

    def __init__(self, model_file=None):
        self.boosters: List[Booster] = []
        self.best_iteration = -1
        if model_file is not None:
            with open(str(model_file)) as f:
                self._from_dict(json.load(f))

    def _from_dict(self, models: Dict[str, Any]) -> None:
        self.best_iteration = models.get("best_iteration", -1)
        self.boosters = [Booster(model_str=s)
                         for s in models.get("boosters", [])]

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        """Every fold's model text in one JSON string."""
        return json.dumps({
            "boosters": [b.model_to_string(num_iteration=num_iteration,
                                           start_iteration=start_iteration,
                                           importance_type=importance_type)
                         for b in self.boosters],
            "best_iteration": self.best_iteration})

    def model_from_string(self, model_str: str) -> "CVBooster":
        self._from_dict(json.loads(model_str))
        return self

    def save_model(self, filename, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> "CVBooster":
        with open(str(filename), "w") as f:
            f.write(self.model_to_string(num_iteration, start_iteration,
                                         importance_type))
        return self

    def __getattr__(self, name: str):
        if name.startswith("__"):   # keep copy, pickle and introspection
            raise AttributeError(name)

        def handler_function(*args: Any, **kwargs: Any) -> List[Any]:
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler_function


def _make_n_folds(full_data: Dataset, folds, nfold: int, seed: int,
                  stratified: bool, shuffle: bool) -> List:
    """``(train_rows, test_rows)`` of each fold (ref: engine.py
    _make_n_folds): the given ``folds`` (an iterable of pairs, or a
    splitter whose ``split(X, y, groups)`` gets each row's query index),
    else whole queries when the data has them, else folds stratified by
    label, else plain ones; shuffled from ``seed``."""
    num_data = full_data.construct().num_data()
    if folds is not None:
        if not hasattr(folds, "__iter__") and not hasattr(folds, "split"):
            raise AttributeError(
                "folds should be a generator or iterator of (train_idx, "
                "test_idx) tuples or scikit-learn splitter object")
        if hasattr(folds, "split"):
            group = full_data.get_group()
            flat_group = (np.repeat(np.arange(len(group)), group)
                          if group is not None
                          else np.zeros(num_data, np.int64))
            folds = folds.split(X=np.empty(num_data),
                                y=full_data.get_label(), groups=flat_group)
        return list(folds)
    rng = np.random.default_rng(seed)
    group = full_data.get_group()
    if group is not None:
        gidx = np.arange(len(group))
        if shuffle:
            rng.shuffle(gidx)
        bounds = np.concatenate([[0], np.cumsum(group)])
        out = []
        for gf in np.array_split(gidx, nfold):
            test = (np.concatenate([np.arange(bounds[g], bounds[g + 1])
                                    for g in gf]) if len(gf)
                    else np.zeros(0, np.int64))
            out.append((np.setdiff1d(np.arange(num_data), test), test))
        return out
    if stratified:
        # within each class an (optionally shuffled) round-robin deal, so
        # every fold gets the same class proportions
        label = np.asarray(full_data.get_label())
        assignment = np.zeros(num_data, np.int64)
        for cls in np.unique(label):
            rows = np.flatnonzero(label == cls)
            if shuffle:
                rng.shuffle(rows)
            assignment[rows] = np.arange(len(rows)) % nfold
        return [(np.flatnonzero(assignment != f),
                 np.flatnonzero(assignment == f)) for f in range(nfold)]
    idx = np.arange(num_data)
    if shuffle:
        rng.shuffle(idx)
    return [(np.setdiff1d(np.arange(num_data), p), p)
            for p in np.array_split(idx, nfold)]


def _agg_cv_result(raw_results: List[List]) -> List:
    """``("cv_agg", "<data> <metric>", mean, higher_better, stdv)`` over
    the folds (ref: engine.py _agg_cv_result)."""
    cvmap: Dict[str, List[float]] = collections.OrderedDict()
    metric_type = {}
    for one_result in raw_results:
        for data_name, metric, value, hib in one_result:
            key = f"{data_name} {metric}"
            metric_type[key] = hib
            cvmap.setdefault(key, []).append(value)
    return [("cv_agg", k, float(np.mean(v)), metric_type[k],
             float(np.std(v))) for k, v in cvmap.items()]


def cv(params: Dict[str, Any], train_set: Dataset,
       num_boost_round: int = 100, folds=None, nfold: int = 5,
       stratified: bool = True, shuffle: bool = True, metrics=None,
       feval=None, init_model: Optional[Union[str, Booster]] = None,
       fpreproc=None, seed: int = 0,
       callbacks: Optional[List[Callable]] = None,
       eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, Any]:
    """Cross-validation (ref: engine.py:356 cv): ``{"<data> <metric>-mean":
    [...], "<data> <metric>-stdv": [...]}`` a round, and with
    ``return_cvbooster`` the ``CVBooster`` under ``"cvbooster"``.
    Stratified folds apply to the classification objectives only.
    ``fpreproc(train, test, params)`` may rewrite each fold. With
    ``init_model`` each fold Booster starts from its trees, as ``train``
    does (the JAX package's ``cv`` ignores it). Early stopping truncates
    the results at the best round and sets each fold's
    ``best_iteration``."""
    params = copy.deepcopy(params) if params else {}
    if not isinstance(train_set, Dataset):
        raise TypeError("cv() only accepts Dataset object")
    fobj = _pop_callable_objective(params)
    _refuse_unported(params)
    for alias in _ConfigAliases.get("num_iterations"):
        if alias in params:
            num_boost_round = int(params.pop(alias))
    early_stopping_round = None
    for alias in _ConfigAliases.get("early_stopping_round"):
        if params.get(alias) is not None:
            early_stopping_round = int(params[alias])
    if metrics is not None:
        params["metric"] = metrics
    if Config(params).objective not in ("binary", "multiclass",
                                        "multiclassova"):
        stratified = False

    train_set._update_params(params).construct()
    folds = _make_n_folds(train_set, folds, nfold, seed, stratified, shuffle)
    predictor = (Booster(params=params, model_file=init_model)
                 if isinstance(init_model, str) else init_model)
    cvbooster = CVBooster()
    for train_idx, test_idx in folds:
        tr, te = train_set.subset(train_idx), train_set.subset(test_idx)
        fold_params = params
        if fpreproc is not None:
            tr, te, fold_params = fpreproc(tr, te, params.copy())
        b = Booster(params=fold_params, train_set=tr)
        if predictor is not None:
            b._engine.init_from_model(predictor._engine)
        b.add_valid(te, "valid")
        cvbooster.boosters.append(b)

    callbacks_before, callbacks_after = _sorted_callbacks(
        callbacks, early_stopping_round, params, verbose=False)
    results: Dict[str, List[float]] = collections.defaultdict(list)
    for i in range(num_boost_round):
        for cb in callbacks_before:
            cb(CallbackEnv(model=cvbooster, params=params, iteration=i,
                           begin_iteration=0, end_iteration=num_boost_round,
                           evaluation_result_list=None))
        for b in cvbooster.boosters:
            b.update(fobj=fobj)
        res = _agg_cv_result(
            [(b.eval_train(feval) if eval_train_metric else [])
             + b.eval_valid(feval) for b in cvbooster.boosters])
        for _, key, mean, _, std in res:
            results[f"{key}-mean"].append(mean)
            results[f"{key}-stdv"].append(std)
        try:
            for cb in callbacks_after:
                cb(CallbackEnv(model=cvbooster, params=params, iteration=i,
                               begin_iteration=0,
                               end_iteration=num_boost_round,
                               evaluation_result_list=res))
        except EarlyStopException as e:
            cvbooster.best_iteration = e.best_iteration + 1
            for b in cvbooster.boosters:
                b.best_iteration = cvbooster.best_iteration
            for k in results:
                results[k] = results[k][:cvbooster.best_iteration]
            break

    out: Dict[str, Any] = dict(results)
    if return_cvbooster:
        out["cvbooster"] = cvbooster
    return out
