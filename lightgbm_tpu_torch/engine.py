"""``train``: the training entry point.

Port of the first slice of ``lightgbm_tpu/engine.py`` ``train`` (ref:
python-package/lightgbm/engine.py:109): boosting rounds over one
training ``Dataset``, with its metrics evaluated when the training set
is passed among ``valid_sets`` or ``is_provide_training_metric`` is on.
Separate validation sets, callbacks, early stopping and ``init_model``
are not ported yet.
"""
from __future__ import annotations

import collections
import copy
from typing import Any, Dict, List, Optional

from .basic import Booster, Dataset
from .config import _ConfigAliases
from .utils import log


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None) -> Booster:
    """Train one model; returns the Booster."""
    params = copy.deepcopy(params) if params else {}
    for alias in _ConfigAliases.get("num_iterations"):
        if alias in params:
            num_boost_round = int(params.pop(alias))
    if num_boost_round <= 0:
        raise ValueError("num_boost_round must be greater than 0")
    if not isinstance(train_set, Dataset):
        raise TypeError("train() only accepts Dataset object")
    for alias in _ConfigAliases.get("early_stopping_round"):
        if int(params.get(alias) or 0) > 0:
            log.fatal("early stopping is not ported yet")

    eval_name = None
    if valid_sets is not None:
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        names = valid_names or [f"valid_{i}" for i in range(len(valid_sets))]
        for vs, name in zip(valid_sets, names):
            if vs is not train_set:
                log.fatal("validation sets other than the training set "
                          "are not ported yet")
            eval_name = name

    train_set._update_params(params).construct()
    booster = Booster(params=params, train_set=train_set)
    if booster.config.is_provide_training_metric and eval_name is None:
        eval_name = "training"
    results = []
    for _ in range(num_boost_round):
        finished = booster.update()
        if eval_name is not None:
            results = [(eval_name, n, v, h)
                       for _, n, v, h in booster.eval_train()]
        if finished:
            break
    booster.best_score = collections.defaultdict(collections.OrderedDict)
    for data_name, metric, value, _ in results:
        booster.best_score[data_name][metric] = value
    return booster
