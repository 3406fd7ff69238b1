"""User-facing ``Dataset`` and ``Booster``.

Port of the first slice of ``lightgbm_tpu/basic.py`` (ref:
python-package/lightgbm/basic.py Dataset / Booster): a ``Dataset`` over
a dense numeric matrix, and a ``Booster`` that trains (``update``),
evaluates on its training rows, predicts by the host walk or on the
device (``predict(..., device=True)``, the packed forest of
``ops/forest.py``) and writes the model text.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .config import Config
from .core.metrics import metrics_for_config
from .core.objective import create_objective
from .io.dataset_core import BinnedDataset
from .models.gbdt import GBDT
from .ops.forest import DeviceRouteUnavailable
from .utils import log
from .utils.log import LightGBMError


def _to_2d_numpy(data) -> np.ndarray:
    X = np.asarray(data)
    if X.ndim != 2:
        raise LightGBMError(f"data must be 2-dimensional, got shape "
                            f"{X.shape}")
    return X


class Dataset:
    """Training data: a dense numeric matrix and its label, binned at
    ``construct`` (ref: basic.py Dataset)."""

    def __init__(self, data, label=None, weight=None, init_score=None,
                 feature_name: Optional[Sequence[str]] = None,
                 params: Optional[Dict[str, Any]] = None):
        self.data = _to_2d_numpy(data)
        self.label = label
        self.weight = weight
        self.init_score = init_score
        self.feature_name = list(feature_name) if feature_name else None
        self.params = copy.deepcopy(params) if params else {}
        self._binned: Optional[BinnedDataset] = None

    def _update_params(self, params: Optional[Dict[str, Any]]) -> "Dataset":
        if params:
            self.params.update(params)
        return self

    def construct(self) -> "Dataset":
        if self._binned is None:
            self._binned = BinnedDataset.from_matrix(
                self.data, Config(self.params), label=self.label,
                weight=self.weight, init_score=self.init_score,
                feature_names=self.feature_name)
        return self

    @property
    def binned(self) -> BinnedDataset:
        return self.construct()._binned

    def num_data(self) -> int:
        return self.data.shape[0]

    def num_feature(self) -> int:
        return self.data.shape[1]


class Booster:
    """The trained model handle (ref: basic.py Booster)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None):
        self.params = copy.deepcopy(params) if params else {}
        self.train_set = train_set
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self.config = Config(self.params)
        self._engine: Optional[GBDT] = None
        if train_set is not None:
            merged = dict(train_set.params)
            merged.update(self.params)
            self.config = Config(merged)
            train_set._update_params(self.params)
            objective = create_objective(self.config.objective, self.config)
            self._engine = GBDT(self.config, train_set.binned, objective)
            self._engine.add_train_metrics(
                metrics_for_config(self.config, objective.NAME))

    @classmethod
    def from_engine(cls, params: Optional[Dict[str, Any]],
                    engine: GBDT) -> "Booster":
        """A Booster around an engine that already holds its trees."""
        self = cls(params)
        self._engine = engine
        return self

    # -- training -------------------------------------------------------
    def update(self) -> bool:
        """One boosting round; True when no further split was possible."""
        if self.train_set is None:
            raise LightGBMError("Booster has no training data")
        return self._engine.train_one_iter()

    def eval_train(self) -> List:
        return self._engine.eval_train()

    def current_iteration(self) -> int:
        return self._engine.current_iteration()

    def num_trees(self) -> int:
        return len(self._engine.models)

    # -- prediction -----------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                device: Optional[bool] = None) -> np.ndarray:
        """Prediction over raw feature values: the host walk (ref:
        predictor.hpp), or with ``device`` (default: the
        ``tpu_predict_device`` parameter) the packed-forest engine on the
        training device, whose scores are f32 sums. Where the device
        route cannot serve (an empty tree range, f64-only values on the
        raw route) it warns and the host walk answers; any other error
        propagates."""
        X = _to_2d_numpy(data).astype(np.float64, copy=False)
        eng = self._engine
        n_feat = eng.max_feature_idx + 1
        if X.shape[1] != n_feat:
            raise LightGBMError(
                f"The number of features in data ({X.shape[1]}) is not "
                f"the same as it was in training data ({n_feat}).")
        K = eng.num_tree_per_iteration
        n_total_iter = len(eng.models) // max(K, 1)
        if num_iteration is None or num_iteration < 0:
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else n_total_iter)
        end_iteration = min(start_iteration + num_iteration, n_total_iter)
        trees = [eng.models[it * K + k]
                 for it in range(start_iteration, end_iteration)
                 for k in range(K)]
        if pred_leaf:
            return np.stack([t.predict_leaf(X) for t in trees], axis=1) \
                if trees else np.zeros((X.shape[0], 0), np.int64)
        raw = None
        use_device = (self.config.tpu_predict_device if device is None
                      else device)
        if use_device:
            try:
                raw = eng.predict_device(X, start_iteration, end_iteration)
            except DeviceRouteUnavailable as e:
                log.warning(f"device prediction unavailable ({e}); "
                            "using the host path")
        if raw is None:
            raw = np.zeros((X.shape[0], K), dtype=np.float64)
            for i, t in enumerate(trees):
                raw[:, i % K] += t.predict(X)
        if not raw_score and eng.objective is not None:
            raw[:, 0] = np.asarray(eng.objective.convert_output(raw[:, 0]))
        return raw[:, 0] if K == 1 else raw

    # -- model IO -------------------------------------------------------
    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        from .io.model_io import model_to_string
        return model_to_string(self._engine, self.config,
                               num_iteration=num_iteration,
                               start_iteration=start_iteration,
                               importance_type=importance_type)

    def save_model(self, filename, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> "Booster":
        from .io.model_io import save_model_file
        save_model_file(self._engine, self.config, str(filename),
                        num_iteration=num_iteration,
                        start_iteration=start_iteration,
                        importance_type=importance_type)
        return self
