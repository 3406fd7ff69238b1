"""scikit-learn estimators.

Port of ``lightgbm_tpu/sklearn.py`` (ref: python-package/lightgbm/
sklearn.py: LGBMModel :535, LGBMRegressor :1409, LGBMClassifier :1524,
LGBMRanker :1832): the estimators wrap ``train``, translating the
sklearn-style constructor arguments to parameter names as the
reference's ``_process_params`` does. Without scikit-learn (the card's
machine has none) the estimators still fit and predict: stand-ins give
``BaseEstimator``'s ``get_params`` / ``set_params`` by the constructor's
signature, the mixins nothing and ``LabelEncoder`` the sorted classes.
Input is dense (numpy or a frame's values), with categorical features by
index or by a frame's column name; sparse input waits for ROADMAP
A12.5b.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

try:
    from sklearn.base import (BaseEstimator as _SKBase,
                              ClassifierMixin as _SKClassifier,
                              RegressorMixin as _SKRegressor)
    from sklearn.preprocessing import LabelEncoder as _SKLabelEncoder
    _SKLEARN_INSTALLED = True
except ImportError:
    _SKLEARN_INSTALLED = False

    class _SKBase:
        """``BaseEstimator``'s parameter access, by the constructor's
        signature."""

        @classmethod
        def _get_param_names(cls) -> List[str]:
            sig = inspect.signature(cls.__init__)
            return sorted(p.name for p in sig.parameters.values()
                          if p.name != "self" and p.kind not in
                          (p.VAR_KEYWORD, p.VAR_POSITIONAL))

        def get_params(self, deep: bool = True) -> Dict[str, Any]:
            return {k: getattr(self, k) for k in self._get_param_names()}

    class _SKClassifier:
        pass

    class _SKRegressor:
        pass

    class _SKLabelEncoder:
        def fit(self, y):
            self.classes_ = np.unique(np.asarray(y))
            return self

        def transform(self, y):
            return np.searchsorted(self.classes_, np.asarray(y))

from .basic import Booster, Dataset
from .callback import record_evaluation
from .config import _ConfigAliases
from .engine import train
from .utils.log import LightGBMError

__all__ = ["LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker"]

# sklearn-style ctor arg -> native parameter name (ref: sklearn.py fit():
# "min_split_gain" -> "min_gain_to_split" etc. via the alias machinery)
_SK_TO_NATIVE = {
    "min_split_gain": "min_gain_to_split",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "subsample": "bagging_fraction",
    "subsample_freq": "bagging_freq",
    "colsample_bytree": "feature_fraction",
    "reg_alpha": "lambda_l1",
    "reg_lambda": "lambda_l2",
    "random_state": "seed",
    "boosting_type": "boosting",
    "subsample_for_bin": "bin_construct_sample_cnt",
}


class _ObjectiveFunctionWrapper:
    """Adapt sklearn-style fobj(y_true, y_pred[, weight|group]) to the
    engine's fobj(raw_score, dataset) (ref: sklearn.py:72)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            grad, hess = self.func(labels, preds)
        elif argc == 3:
            grad, hess = self.func(labels, preds, dataset.get_weight())
        elif argc == 4:
            grad, hess = self.func(labels, preds, dataset.get_weight(),
                                   dataset.get_group())
        else:
            raise TypeError(
                f"Self-defined objective should have 2-4 arguments, "
                f"got {argc}")
        return grad, hess


class _EvalFunctionWrapper:
    """Adapt sklearn-style feval(y_true, y_pred[, weight|group]) to the
    engine's feval(raw_score, dataset) (ref: sklearn.py:155)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            return self.func(labels, preds)
        if argc == 3:
            return self.func(labels, preds, dataset.get_weight())
        if argc == 4:
            return self.func(labels, preds, dataset.get_weight(),
                             dataset.get_group())
        raise TypeError(
            f"Self-defined eval function should have 2-4 arguments, "
            f"got {argc}")


class LGBMModel(_SKBase):
    """Base sklearn estimator (ref: sklearn.py:535 LGBMModel)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[Union[str, Callable]] = None,
                 class_weight: Optional[Union[Dict, str]] = None,
                 min_split_gain: float = 0.0,
                 min_child_weight: float = 1e-3,
                 min_child_samples: int = 20, subsample: float = 1.0,
                 subsample_freq: int = 0, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 random_state: Optional[int] = None,
                 n_jobs: Optional[int] = None,
                 importance_type: str = "split", **kwargs: Any):
        self.boosting_type = boosting_type
        self.objective = objective
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.importance_type = importance_type
        self.class_weight = class_weight
        self._Booster: Optional[Booster] = None
        self._evals_result: Dict = {}
        self._best_score: Dict = {}
        self._best_iteration: int = -1
        self._other_params: Dict[str, Any] = {}
        self._objective = objective
        self._fobj = None
        self._n_features: int = -1
        self._n_features_in: int = -1
        self._n_classes: int = -1
        self.set_params(**kwargs)

    # -- sklearn plumbing ------------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = super().get_params(deep=deep)
        params.update(self._other_params)
        return params

    def set_params(self, **params: Any) -> "LGBMModel":
        for key, value in params.items():
            setattr(self, key, value)
            if hasattr(self, f"_{key}"):
                setattr(self, f"_{key}", value)
            self._other_params[key] = value
        return self

    def _more_tags(self):
        return {"allow_nan": True, "X_types": ["2darray", "sparse",
                                                "1dlabels"],
                "non_deterministic": False}

    def __sklearn_tags__(self):  # sklearn >= 1.6 tag protocol
        tags = super().__sklearn_tags__()
        tags.input_tags.allow_nan = True
        tags.input_tags.sparse = True
        return tags

    # -- param translation (ref: sklearn.py _process_params) -------------
    def _process_params(self, stage: str) -> Dict[str, Any]:
        params = self.get_params()
        params.pop("objective", None)
        for sk_name in ("n_estimators", "class_weight", "importance_type",
                        "silent"):
            params.pop(sk_name, None)
        n_jobs = params.pop("n_jobs", None)
        if n_jobs is not None:
            params["num_threads"] = n_jobs
        for sk_name, native in _SK_TO_NATIVE.items():
            if sk_name in params:
                params[native] = params.pop(sk_name)
        if callable(self._objective):
            self._fobj = _ObjectiveFunctionWrapper(self._objective)
            params["objective"] = self._fobj  # train() detects the callable
        else:
            self._fobj = None
            if self._objective is not None:
                params["objective"] = self._objective
        if self._n_classes > 2 and not callable(self._objective):
            for alias in _ConfigAliases.get("num_class"):
                params.pop(alias, None)
            params["num_class"] = self._n_classes
        return {k: v for k, v in params.items() if v is not None}

    # -- fit --------------------------------------------------------------
    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_class_weight=None, eval_init_score=None, eval_group=None,
            eval_metric=None, feature_name="auto",
            categorical_feature="auto", callbacks=None,
            init_model=None) -> "LGBMModel":
        """ref: sklearn.py LGBMModel.fit (:895)."""
        params = self._process_params(stage="fit")
        if callable(eval_metric):
            feval = _EvalFunctionWrapper(eval_metric)
            eval_metric_name = None
        elif isinstance(eval_metric, list) and any(
                callable(m) for m in eval_metric):
            feval = [_EvalFunctionWrapper(m) for m in eval_metric
                     if callable(m)]
            eval_metric_name = [m for m in eval_metric if not callable(m)]
        else:
            feval = None
            eval_metric_name = eval_metric
        if eval_metric_name:
            params["metric"] = eval_metric_name

        if self.class_weight is not None and sample_weight is None:
            sample_weight = self._class_weights_to_sample_weight(y)

        X_arr = _as_matrix(X)
        self._n_features = X_arr.shape[1]
        self._n_features_in = X_arr.shape[1]
        if hasattr(X, "columns"):
            self.feature_names_in_ = np.asarray(
                [str(c) for c in X.columns], dtype=object)
            if feature_name == "auto":
                feature_name = [str(c) for c in X.columns]

        train_set = Dataset(X_arr, label=y, weight=sample_weight,
                            group=group, init_score=init_score,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature,
                            params=params)
        valid_sets: List[Dataset] = []
        valid_names: List[str] = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                vname = (eval_names[i] if eval_names is not None
                         else f"valid_{i}")

                def _pick(arrs, idx):
                    if arrs is None:
                        return None
                    return arrs[idx] if isinstance(arrs, (list, tuple)) \
                        else arrs
                if _is_same_data(vx, X) and _is_same_data(vy, y):
                    valid_sets.append(train_set)
                else:
                    vw = _pick(eval_sample_weight, i)
                    if _pick(eval_class_weight, i) is not None and vw is None:
                        vw = self._class_weights_to_sample_weight(
                            vy, _pick(eval_class_weight, i))
                    valid_sets.append(train_set.create_valid(
                        _as_matrix(vx), label=vy, weight=vw,
                        group=_pick(eval_group, i),
                        init_score=_pick(eval_init_score, i)))
                valid_names.append(vname)

        evals_result: Dict = {}
        cbs = list(callbacks) if callbacks else []
        cbs.append(record_evaluation(evals_result))

        self._Booster = train(
            params=params, train_set=train_set,
            num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None,
            valid_names=valid_names or None,
            feval=feval, init_model=init_model, callbacks=cbs)
        self._evals_result = evals_result
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        self._objective_str = self._Booster.config.objective
        self._Booster.free_dataset()
        return self

    def _class_weights_to_sample_weight(self, y, class_weight=None):
        cw = class_weight if class_weight is not None else self.class_weight
        y_arr = np.asarray(y)
        if cw == "balanced":
            classes, counts = np.unique(y_arr, return_counts=True)
            weights = {c: len(y_arr) / (len(classes) * n)
                       for c, n in zip(classes, counts)}
        elif isinstance(cw, dict):
            weights = cw
        else:
            return None
        return np.asarray([weights.get(v, 1.0) for v in y_arr], np.float64)

    # -- predict ----------------------------------------------------------
    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, validate_features: bool = False,
                device: Optional[bool] = None, **kwargs):
        """ref: sklearn.py LGBMModel.predict (:1073). ``device=True``
        scores through the packed forest on the device (``None``: the
        ``tpu_predict_device`` parameter), as ``Booster.predict`` does;
        ``pred_contrib`` is the host TreeSHAP and refuses the device."""
        if self._Booster is None:
            raise LightGBMError(
                "Estimator not fitted, call fit before predict")
        X_arr = _as_matrix(X)
        if X_arr.shape[1] != self._n_features:
            raise ValueError(
                f"Number of features of the model must match the input. "
                f"Model n_features_ is {self._n_features} and input "
                f"n_features is {X_arr.shape[1]}")
        if device is not None:
            kwargs = dict(kwargs, device=device)
        return self._Booster.predict(
            X_arr, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib, validate_features=validate_features,
            **kwargs)

    # -- fitted attributes (ref: sklearn.py properties) -------------------
    @property
    def n_features_(self) -> int:
        self._check_fitted()
        return self._n_features

    @property
    def n_features_in_(self) -> int:
        self._check_fitted()
        return self._n_features_in

    @property
    def best_score_(self) -> Dict:
        self._check_fitted()
        return self._best_score

    @property
    def best_iteration_(self) -> int:
        self._check_fitted()
        return self._best_iteration

    @property
    def objective_(self):
        self._check_fitted()
        return self._objective if callable(self._objective) \
            else self._objective_str

    @property
    def booster_(self) -> Booster:
        self._check_fitted()
        return self._Booster

    @property
    def evals_result_(self) -> Dict:
        self._check_fitted()
        return self._evals_result

    @property
    def feature_importances_(self) -> np.ndarray:
        self._check_fitted()
        return self._Booster.feature_importance(
            importance_type=self.importance_type)

    @property
    def feature_name_(self) -> List[str]:
        self._check_fitted()
        return self._Booster.feature_name()

    @property
    def feature_names_in_(self) -> np.ndarray:
        """sklearn-compatible feature names (ref: sklearn.py:1368);
        raises AttributeError when unfitted or for anonymous (Column_N)
        features so sklearn's hasattr-based checks behave like the
        reference."""
        if self._Booster is None:
            raise AttributeError(
                "No feature_names_in_ found. Need to call fit beforehand.")
        names = self._Booster.feature_name()
        if all(n.startswith("Column_") for n in names):
            raise AttributeError(
                "feature_names_in_ is only available when training data "
                "had feature names")
        return np.asarray(names, dtype=object)

    @feature_names_in_.setter
    def feature_names_in_(self, value) -> None:
        # sklearn's validate_data assigns this on fit; the canonical
        # names live in the Booster (ref: sklearn.py:1380 opt-out)
        pass

    @feature_names_in_.deleter
    def feature_names_in_(self) -> None:
        # sklearn deletes it for name-less refits; same opt-out
        pass

    @property
    def n_estimators_(self) -> int:
        self._check_fitted()
        return self._Booster.num_trees() // max(
            self._Booster.num_model_per_iteration(), 1)

    @property
    def n_iter_(self) -> int:
        return self.n_estimators_

    def _check_fitted(self) -> None:
        if self._Booster is None:
            raise LightGBMError("No booster found. Need to call fit first.")

    def __sklearn_is_fitted__(self) -> bool:
        return self._Booster is not None


class LGBMRegressor(_SKRegressor, LGBMModel):
    """ref: sklearn.py:1409 LGBMRegressor."""

    def fit(self, X, y, sample_weight=None, init_score=None, eval_set=None,
            eval_names=None, eval_sample_weight=None, eval_init_score=None,
            eval_metric=None, feature_name="auto",
            categorical_feature="auto", callbacks=None, init_model=None):
        if self._objective is None and not callable(self.objective):
            self._objective = self.objective or "regression"
        return super().fit(
            X, y, sample_weight=sample_weight, init_score=init_score,
            eval_set=eval_set, eval_names=eval_names,
            eval_sample_weight=eval_sample_weight,
            eval_init_score=eval_init_score, eval_metric=eval_metric,
            feature_name=feature_name,
            categorical_feature=categorical_feature, callbacks=callbacks,
            init_model=init_model)


class LGBMClassifier(_SKClassifier, LGBMModel):
    """ref: sklearn.py:1524 LGBMClassifier."""

    def fit(self, X, y, sample_weight=None, init_score=None, eval_set=None,
            eval_names=None, eval_sample_weight=None, eval_class_weight=None,
            eval_init_score=None, eval_metric=None, feature_name="auto",
            categorical_feature="auto", callbacks=None, init_model=None):
        self._le = _SKLabelEncoder().fit(y)
        self._classes = self._le.classes_
        self._n_classes = len(self._classes)
        # class weights must be resolved against ORIGINAL labels, before
        # label encoding (dict keys are in user label space)
        if self.class_weight is not None and sample_weight is None:
            sample_weight = self._class_weights_to_sample_weight(y)
        if eval_set is not None and eval_class_weight is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            ecw = (eval_class_weight if isinstance(eval_class_weight,
                                                   (list, tuple))
                   else [eval_class_weight] * len(eval_set))
            esw = list(eval_sample_weight) if eval_sample_weight is not None \
                else [None] * len(eval_set)
            for i, (vx, vy) in enumerate(eval_set):
                if ecw[i] is not None and esw[i] is None:
                    esw[i] = self._class_weights_to_sample_weight(vy, ecw[i])
            eval_sample_weight = esw
            eval_class_weight = None
        y_enc = self._le.transform(y)
        if not callable(self.objective):
            if self.objective is None:
                self._objective = ("binary" if self._n_classes <= 2
                                   else "multiclass")
            else:
                self._objective = self.objective
        else:
            self._objective = self.objective
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            eval_set = [(vx, self._le.transform(vy)) for vx, vy in eval_set]
        return super().fit(
            X, y_enc, sample_weight=sample_weight, init_score=init_score,
            eval_set=eval_set, eval_names=eval_names,
            eval_sample_weight=eval_sample_weight,
            eval_class_weight=eval_class_weight,
            eval_init_score=eval_init_score, eval_metric=eval_metric,
            feature_name=feature_name,
            categorical_feature=categorical_feature, callbacks=callbacks,
            init_model=init_model)

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, validate_features: bool = False,
                device: Optional[bool] = None, **kwargs):
        result = self.predict_proba(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib, validate_features=validate_features,
            device=device, **kwargs)
        if callable(self._objective) or raw_score or pred_leaf or \
                pred_contrib:
            return result
        if result.ndim == 2:
            class_index = np.argmax(result, axis=1)
        else:
            class_index = (result > 0.5).astype(np.int64)
        return self._classes[class_index]

    def decision_function(self, X, *, start_iteration: int = 0,
                          num_iteration: Optional[int] = None,
                          validate_features: bool = False, **kwargs):
        """Raw margin score per sample (ref: sklearn.py:1769
        decision_function — sklearn's standard margin accessor)."""
        return self.predict_proba(
            X, raw_score=True, start_iteration=start_iteration,
            num_iteration=num_iteration,
            validate_features=validate_features, **kwargs)

    def predict_proba(self, X, raw_score: bool = False,
                      start_iteration: int = 0,
                      num_iteration: Optional[int] = None,
                      pred_leaf: bool = False, pred_contrib: bool = False,
                      validate_features: bool = False,
                      device: Optional[bool] = None, **kwargs):
        """ref: sklearn.py LGBMClassifier.predict_proba (:1738)."""
        result = super().predict(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib, validate_features=validate_features,
            device=device, **kwargs)
        if callable(self._objective) or raw_score or pred_leaf or \
                pred_contrib:
            return result
        if self._n_classes <= 2 and result.ndim == 1:
            return np.vstack((1.0 - result, result)).transpose()
        return result

    @property
    def classes_(self) -> np.ndarray:
        self._check_fitted()
        return self._classes

    @property
    def n_classes_(self) -> int:
        self._check_fitted()
        return self._n_classes


class LGBMRanker(LGBMModel):
    """ref: sklearn.py:1832 LGBMRanker."""

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            eval_at=(1, 2, 3, 4, 5), feature_name="auto",
            categorical_feature="auto", callbacks=None, init_model=None):
        if group is None:
            raise ValueError("Should set group for ranking task")
        if eval_set is not None and eval_group is None:
            raise ValueError("Eval_group cannot be None when eval_set is not "
                             "None")
        if not callable(self.objective):
            self._objective = self.objective or "lambdarank"
        self._eval_at = eval_at  # -> ndcg@k metrics via _process_params
        booster = super().fit(
            X, y, sample_weight=sample_weight, init_score=init_score,
            group=group, eval_set=eval_set, eval_names=eval_names,
            eval_sample_weight=eval_sample_weight,
            eval_init_score=eval_init_score, eval_group=eval_group,
            eval_metric=eval_metric, feature_name=feature_name,
            categorical_feature=categorical_feature, callbacks=callbacks,
            init_model=init_model)
        return booster

    def _process_params(self, stage: str) -> Dict[str, Any]:
        params = super()._process_params(stage)
        params.pop("eval_at", None)
        if getattr(self, "_eval_at", None) is not None:
            ea = self._eval_at
            params["eval_at"] = ([ea] if isinstance(ea, int)
                                 else list(ea))
        return params


def _as_matrix(X):
    """A scipy sparse matrix as CSR (``Dataset`` bins it without
    densifying it; ``predict`` takes it in row blocks), else a dense 2-D
    float64 array of numpy input or a frame's values."""
    if hasattr(X, "tocsr"):
        return X.tocsr()
    if hasattr(X, "values") and hasattr(X, "columns"):
        X = X.values
    arr = np.asarray(X)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    return np.ascontiguousarray(arr, dtype=np.float64)


def _is_same_data(a, b) -> bool:
    if a is b:
        return True
    try:
        return (np.asarray(a).shape == np.asarray(b).shape and
                np.shares_memory(np.asarray(a), np.asarray(b)))
    except Exception:
        return False
