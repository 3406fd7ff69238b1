"""User-facing ``Dataset`` and ``Booster``.

Port of ``lightgbm_tpu/basic.py`` (ref: python-package/lightgbm/basic.py
Dataset / Booster) for dense numeric data: a ``Dataset`` over a matrix or
a CSV/TSV/LibSVM file, binned on its own or, with ``reference=``, with
another Dataset's bin mappers (a validation set); a ``Booster`` that
trains (``update``), keeps validation sets on the training device,
evaluates, rolls back, predicts by the host walk or on the device
(``predict(..., device=True)``, the packed forest of ``ops/forest.py``),
and writes, loads and dumps the model text. A Booster loaded from a model
(``model_file=`` / ``model_str=``) predicts on the device its ``params``
name, ``cuda`` unless ``device_type="cpu"``.
"""
from __future__ import annotations

import copy
from pathlib import Path
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
    """Training or validation data: a dense numeric matrix, or the path
    of a CSV/TSV/LibSVM file, and its label, binned at ``construct`` (ref:
    basic.py Dataset). With ``reference`` the rows are binned with the
    reference's bin mappers. ``group`` holds the query sizes of a ranking
    task (rows of a query adjacent), ``position`` each row's position id
    (lambdarank's position bias); a file's group column and its
    ``.query``/``.group`` and ``.position`` sidecars fill them when not
    given."""

    def __init__(self, data, label=None,
                 reference: Optional["Dataset"] = None, weight=None,
                 group=None, init_score=None,
                 feature_name: Optional[Sequence[str]] = None,
                 params: Optional[Dict[str, Any]] = None, position=None):
        self.data = (data if isinstance(data, (str, Path))
                     else _to_2d_numpy(data))
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.position = position
        self.init_score = init_score
        self.feature_name = list(feature_name) if feature_name else None
        self.params = copy.deepcopy(params) if params else {}
        self._binned: Optional[BinnedDataset] = None

    def _update_params(self, params: Optional[Dict[str, Any]]) -> "Dataset":
        if params:
            self.params.update(params)
        return self

    def construct(self) -> "Dataset":
        if self._binned is not None:
            return self
        ref = (self.reference.construct()._binned
               if self.reference is not None else None)
        cfg = Config(self.params)
        if isinstance(self.data, (str, Path)):
            from .io.file_loader import load_position_file, load_svm_or_csv
            path = str(self.data)
            X, y, w, group = load_svm_or_csv(path, cfg)
            self.data = X
            if self.label is None:
                self.label = y
            if self.weight is None:
                self.weight = w
            if self.group is None:
                self.group = group
            if self.position is None:
                self.position = load_position_file(path)
        self._binned = BinnedDataset.from_matrix(
            self.data, cfg, label=self.label, weight=self.weight,
            init_score=self.init_score, feature_names=self.feature_name,
            reference=ref, group=self.group, position=self.position)
        return self

    @property
    def binned(self) -> BinnedDataset:
        return self.construct()._binned

    def num_data(self) -> int:
        return self.binned.num_data

    def num_feature(self) -> int:
        return self.binned.num_total_features

    def set_reference(self, reference: "Dataset") -> "Dataset":
        """Bin this dataset with ``reference``'s bin mappers (ref:
        basic.py set_reference: merges the reference's params, no-ops on
        the same reference, refuses after construction)."""
        self._update_params(reference.params)
        if self.reference is reference:
            return self
        if self._binned is not None:
            raise LightGBMError(
                "Cannot set reference after the dataset was constructed")
        self.reference = reference
        return self

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None,
                     params: Optional[Dict[str, Any]] = None,
                     position=None) -> "Dataset":
        """A validation Dataset binned with this one's bin mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params, position=position)

    def set_group(self, group) -> "Dataset":
        """Query sizes; applied to the binned metadata once constructed."""
        self.group = group
        if self._binned is not None:
            self._binned.metadata.set_query(group)
        return self

    def get_group(self):
        """Query sizes: from the binned metadata once constructed."""
        if self._binned is not None and \
                self._binned.metadata.query_boundaries is not None:
            return np.diff(self._binned.metadata.query_boundaries)
        return self.group

    def set_position(self, position) -> "Dataset":
        self.position = position
        if self._binned is not None:
            self._binned.metadata.set_position(position)
        return self

    def get_position(self):
        if self._binned is not None:
            return self._binned.metadata.position
        return self.position


class Booster:
    """The model handle (ref: basic.py Booster): built from a training
    Dataset, from a model file or from a model string."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file=None, model_str: Optional[str] = None):
        self._init_state(params)
        if train_set is not None:
            self._init_from_train_set(train_set)
        elif model_file is not None:
            from .io.model_io import load_model_file
            self._engine, self.config = load_model_file(str(model_file),
                                                        self.params)
        elif model_str is not None:
            self.model_from_string(model_str)
        else:
            raise LightGBMError(
                "need at least one of train_set, model_file, model_str")

    def _init_state(self, params: Optional[Dict[str, Any]]) -> None:
        self.params = copy.deepcopy(params) if params else {}
        self.train_set: Optional[Dataset] = None
        self.valid_sets: List[Dataset] = []
        self.name_valid_sets: List[str] = []
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self.train_data_name = "training"
        self.config = Config(self.params)
        self._engine = None

    def _init_from_train_set(self, train_set: Dataset) -> None:
        if not isinstance(train_set, Dataset):
            raise LightGBMError("train_set must be a Dataset")
        self.train_set = train_set
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
        self = cls.__new__(cls)
        self._init_state(params)
        self._engine = engine
        return self

    def model_from_string(self, model_str: str) -> "Booster":
        """Replace this handle's model with one parsed from a string; it
        predicts on the device this Booster's params name."""
        from .io.model_io import load_model_string
        self._engine, self.config = load_model_string(model_str,
                                                      self.params)
        return self

    # -- training -------------------------------------------------------
    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting round; True when no further split was possible
        (ref: basic.py Booster.update). With ``fobj``, the gradients are
        ``fobj(raw_score, train_set)``: the raw training score (``[N]``, or
        ``[K, N]``) in, class-major ``(grad, hess)`` of ``K * N`` values
        out."""
        if self.train_set is None:
            raise LightGBMError("Booster has no training data")
        if train_set is not None and train_set is not self.train_set:
            raise LightGBMError("Replacing train_set is not supported yet")
        if fobj is None:
            return self._engine.train_one_iter()
        grad, hess = fobj(self._raw_train_score(), self.train_set)
        return self._engine.train_one_iter(np.asarray(grad, np.float32),
                                           np.asarray(hess, np.float32))

    def _raw_train_score(self) -> np.ndarray:
        """The training score read back as f64: ``[N]`` for one model per
        iteration, else ``[K, N]``."""
        return self._score_np(self._engine.score)

    @staticmethod
    def _score_np(score) -> np.ndarray:
        s = score.cpu().numpy().astype(np.float64)
        return s[0] if s.shape[0] == 1 else s

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Register a validation set (built with ``reference=`` the
        training Dataset); its bins and score live on the training
        device."""
        if self.train_set is None:
            raise LightGBMError("Booster has no training data")
        if not isinstance(data, Dataset):
            raise TypeError("validation data must be a Dataset")
        data._update_params(self.params).construct()
        self.valid_sets.append(data)
        self.name_valid_sets.append(name)
        metrics = metrics_for_config(self.config,
                                     self._engine.objective.NAME)
        self._engine.add_valid_data(data.binned, metrics, name)
        return self

    def rollback_one_iter(self) -> "Booster":
        self._engine.rollback_one_iter()
        return self

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Change parameters between iterations (ref: Booster::ResetConfig,
        c_api.cpp): ``learning_rate`` is read by the next iteration.
        Settings the port does not implement yet are refused."""
        trial = self.config.copy()
        trial.update(params)
        bad = trial.unsupported_settings()
        if bad and self.train_set is not None:
            log.fatal("the port does not implement these settings yet: "
                      + ", ".join(bad))
        self.params.update(params)
        self.config = trial
        self._engine.config = trial
        self._engine.shrinkage_rate = float(trial.learning_rate)
        return self

    def free_dataset(self) -> "Booster":
        self.train_set = None
        self.valid_sets = []
        return self

    # -- evaluation -----------------------------------------------------
    def eval(self, data: Dataset, name: str, feval=None) -> List:
        """Evaluate on the training set or a set added with ``add_valid``
        (ref: basic.py Booster.eval)."""
        if data is self.train_set:
            return [(name, n, v, h)
                    for _d, n, v, h in self.eval_train(feval)]
        for vs, vname in zip(self.valid_sets, self.name_valid_sets):
            if data is vs:
                return [(name, n, v, h)
                        for d, n, v, h in self.eval_valid(feval)
                        if d == vname]
        raise LightGBMError(
            "Data for eval must be the training set or have been added "
            "with add_valid")

    def eval_train(self, feval=None) -> List:
        out = list(self._engine.eval_train())
        if feval is not None:
            out.extend(self._run_feval(feval, "training", self.train_set,
                                       self._raw_train_score()))
        return out

    def eval_valid(self, feval=None) -> List:
        out = list(self._engine.eval_valid())
        if feval is not None:
            for vd, vs in zip(self._engine.valid_sets, self.valid_sets):
                out.extend(self._run_feval(feval, vd.name, vs,
                                           self._score_np(vd.score)))
        return out

    @staticmethod
    def _run_feval(feval, data_name: str, dataset: Dataset,
                   raw: np.ndarray) -> List:
        """``feval(raw_score, dataset)`` for each custom metric, over the
        f32 score read back as f64 numpy (``[N]``, or ``[K, N]``)."""
        out = []
        for f in (feval if isinstance(feval, (list, tuple)) else [feval]):
            ret = f(raw, dataset)
            for name, value, hib in (ret if isinstance(ret, list)
                                     else [ret]):
                out.append((data_name, name, value, hib))
        return out

    def current_iteration(self) -> int:
        return self._engine.current_iteration()

    def num_trees(self) -> int:
        return len(self._engine.models)

    def num_model_per_iteration(self) -> int:
        return self._engine.num_tree_per_iteration

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        """Splits per feature (int64) or their summed gain (ref: gbdt.cpp
        FeatureImportance)."""
        eng = self._engine
        out = np.zeros(eng.max_feature_idx + 1, np.float64)
        K = eng.num_tree_per_iteration
        limit = (len(eng.models) if iteration is None
                 else min(iteration * K, len(eng.models)))
        for t in eng.models[:limit]:
            for i in range(t.num_leaves - 1):
                f = int(t.split_feature[i])
                if importance_type == "split":
                    if t.split_gain[i] > 0:
                        out[f] += 1.0
                else:
                    out[f] += max(t.split_gain[i], 0.0)
        return out.astype(np.int64) if importance_type == "split" else out

    # -- prediction -----------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                device: Optional[bool] = None) -> np.ndarray:
        """Prediction over raw feature values: the host walk (ref:
        predictor.hpp), or with ``device`` (default: the
        ``tpu_predict_device`` parameter) the packed-forest engine on the
        training device (a loaded model: the device its params name),
        whose scores are f32 sums. Where the device route cannot serve
        (an empty tree range, f64-only values or a categorical node on
        the raw route) it warns and the host walk answers; any other
        error propagates, a missing card included."""
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
            if K > 1:
                # [R, K]: softmax over the classes, or each class's sigmoid
                raw = np.asarray(eng.objective.convert_output(raw))
            else:
                raw[:, 0] = np.asarray(
                    eng.objective.convert_output(raw[:, 0]))
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

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> Dict[str, Any]:
        """The model as a JSON-ready dict (ref: GBDT::DumpModel)."""
        from .io.model_io import dump_model_dict
        return dump_model_dict(self._engine, num_iteration=num_iteration,
                               start_iteration=start_iteration)

    def save_model(self, filename, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> "Booster":
        from .io.model_io import save_model_file
        save_model_file(self._engine, self.config, str(filename),
                        num_iteration=num_iteration,
                        start_iteration=start_iteration,
                        importance_type=importance_type)
        return self
