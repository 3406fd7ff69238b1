"""User-facing ``Dataset`` and ``Booster``.

Port of ``lightgbm_tpu/basic.py`` (ref: python-package/lightgbm/basic.py
Dataset / Booster): a ``Dataset`` over a matrix, a scipy sparse matrix
(stored dense, in EFB groups or multi-value, ``tpu_sparse_storage``), a
pandas DataFrame (its column names the feature names), an Arrow table or
any ``__arrow_c_stream__`` producer (pyarrow needed then), a
``Sequence`` or a list of them (``io/sequence.py``), a CSV/TSV/LibSVM
file or a binary dataset file (``save_binary``), with categorical
features by index or name (``categorical_feature``), binned on
its own or, with ``reference=``, with another Dataset's bin mappers (a
validation set, a ``subset``); a ``Booster`` that trains (``update``),
keeps validation sets on the training device, evaluates, rolls back,
predicts by the host walk or on the device (``predict(..., device=True)``,
the packed forest of ``ops/forest.py``), explains by the host TreeSHAP
(``pred_contrib``), refits its leaves to new data, pickles and copies as
its model text, and writes, loads and dumps the model text. A Booster
loaded from a model (``model_file=`` / ``model_str=``, or unpickled)
predicts on the device its ``params`` name, ``cuda`` unless
``device_type="cpu"``.
"""
from __future__ import annotations

import copy
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .config import Config
from .core.metrics import metrics_for_config
from .core.objective import create_objective
from .io.dataset_core import BinnedDataset, categorical_indices
from .models import create_boosting
from .models.gbdt import GBDT
from .ops.forest import LINEAR_TREES_ON_HOST, DeviceRouteUnavailable
from .utils import log
from .utils.log import LightGBMError


def _is_frame(data) -> bool:
    """A pandas DataFrame, recognized as the JAX package does (basic.py:33)
    without importing pandas."""
    return hasattr(data, "values") and hasattr(data, "columns")


def _is_arrow_table(data) -> bool:
    # an object of pyarrow's means pyarrow is imported already
    pa = sys.modules.get("pyarrow")
    return pa is not None and isinstance(data, (pa.Table, pa.RecordBatch))


def _has_arrow_c_stream(data) -> bool:
    """Another producer of the Arrow C stream (a polars DataFrame, ...)."""
    return (hasattr(data, "__arrow_c_stream__") and not _is_frame(data)
            and not isinstance(data, np.ndarray)
            and not _is_arrow_table(data))


def _arrow_table(data):
    """An Arrow table of a table, a record batch or a C-stream producer."""
    if _is_arrow_table(data):
        return data
    try:
        import pyarrow as pa
    except ImportError as e:
        raise LightGBMError("this input implements the Arrow C-stream "
                            "protocol; reading it needs pyarrow") from e
    return pa.table(data)


def _is_sparse(data) -> bool:
    # a scipy matrix means scipy is imported already
    sp = sys.modules.get("scipy.sparse")
    return sp is not None and sp.issparse(data)


def _is_sequence_input(data) -> bool:
    """A ``Sequence``, or a non-empty list or tuple of them."""
    from .io.sequence import Sequence
    return isinstance(data, Sequence) or (
        isinstance(data, (list, tuple)) and len(data) > 0
        and all(isinstance(s, Sequence) for s in data))


def _to_2d_numpy(data) -> np.ndarray:
    """A dense 2-D array of a matrix, a scipy sparse matrix (densified),
    a DataFrame (its values, as float64 unless numeric, as the JAX
    package's basic.py:31-43) or an Arrow table (float64, nulls as
    NaN)."""
    if _is_sparse(data):
        return data.toarray()
    if _is_arrow_table(data) or _has_arrow_c_stream(data):
        from .io.dataset_core import ArrowColumns
        src = ArrowColumns(_arrow_table(data))
        return np.stack([src.get_col(f) for f in range(src.num_features)],
                        axis=1)
    X = np.asarray(data.values if _is_frame(data) else data)
    if X.ndim != 2:
        raise LightGBMError(f"data must be 2-dimensional, got shape "
                            f"{X.shape}")
    if X.dtype.kind not in "fiub":
        X = X.astype(np.float64)
    return X


def _hstack_any(a, b):
    """The column concatenation of two raw-data containers (dense, list,
    pandas, scipy); None when no sensible merge exists (the JAX package's
    basic.py:55)."""
    if _is_sparse(a) or _is_sparse(b):
        if _is_sparse(a) and _is_sparse(b):
            import scipy.sparse as sp
            return sp.hstack([a, b], format="csr")
        return None
    if _is_frame(a) and _is_frame(b):
        import pandas as pd
        return pd.concat([a.reset_index(drop=True),
                          b.reset_index(drop=True)], axis=1)
    try:
        aa, bb = np.asarray(a), np.asarray(b)
    except (TypeError, ValueError):
        return None
    if aa.ndim == 2 and bb.ndim == 2 and aa.shape[0] == bb.shape[0]:
        return np.hstack([aa, bb])
    return None


def _node_index(tree_idx: int, child: int) -> str:
    return (f"{tree_idx}-S{child}" if child >= 0
            else f"{tree_idx}-L{~child}")


def _node_row(t, tree_idx: int, names: List[str], parent, depth: int,
              is_leaf: bool, idx: int) -> Dict[str, Any]:
    """One node of ``trees_to_dataframe`` (ref: basic.py
    Booster.trees_to_dataframe's columns)."""
    if is_leaf:
        return {"tree_index": tree_idx, "node_depth": depth,
                "node_index": f"{tree_idx}-L{idx}", "left_child": None,
                "right_child": None, "parent_index": parent,
                "split_feature": None, "split_gain": None,
                "threshold": None, "decision_type": None,
                "missing_direction": None, "missing_type": None,
                "value": float(t.leaf_value[idx]),
                "weight": float(t.leaf_weight[idx]),
                "count": int(t.leaf_count[idx])}
    f = int(t.split_feature[idx])
    dtype = int(t.decision_type[idx])
    is_cat = bool(dtype & 1)
    # a categorical node's threshold_real indexes its bitset
    thr = ("||".join(str(v) for v in t.cat_values(int(t.threshold_real[idx])))
           if is_cat else float(t.threshold_real[idx]))
    return {"tree_index": tree_idx, "node_depth": depth,
            "node_index": f"{tree_idx}-S{idx}", "left_child": None,
            "right_child": None, "parent_index": parent,
            "split_feature": names[f] if f < len(names) else f,
            "split_gain": float(t.split_gain[idx]), "threshold": thr,
            "decision_type": "==" if is_cat else "<=",
            "missing_direction": "left" if dtype & 2 else "right",
            "missing_type": ["None", "Zero", "NaN"][(dtype >> 2) & 3],
            "value": float(t.internal_value[idx]),
            "weight": float(t.internal_weight[idx]),
            "count": int(t.internal_count[idx])}


class Dataset:
    """Training or validation data: a dense numeric matrix, a pandas
    DataFrame, an Arrow table (or C-stream producer), or the path of a
    CSV/TSV/LibSVM file or of a binary dataset file, and its label,
    binned at ``construct`` (ref: basic.py Dataset). With ``reference``
    the rows are binned with the reference's bin mappers. ``group`` holds
    the query sizes of a ranking task (rows of a query adjacent),
    ``position`` each row's position id (lambdarank's position bias); a
    file's group column and its ``.query``/``.group`` and ``.position``
    sidecars fill them when not given. ``categorical_feature`` lists the
    features binned as categories, by index or by name ("auto": the
    params' ``categorical_feature``). scipy sparse input is refused
    (ROADMAP A12.5b)."""

    # generic field access (ref: basic.py Dataset.set_field/get_field)
    _FIELDS = {"label": ("set_label", "get_label"),
               "weight": ("set_weight", "get_weight"),
               "group": ("set_group", "get_group"),
               "init_score": ("set_init_score", "get_init_score"),
               "position": ("set_position", "get_position")}

    def __init__(self, data, label=None,
                 reference: Optional["Dataset"] = None, weight=None,
                 group=None, init_score=None,
                 feature_name: Optional[Sequence[str]] = None,
                 categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True, position=None):
        # the caller's object, as given, until construct
        self.data = data
        self.free_raw_data = free_raw_data
        self.categorical_feature = categorical_feature
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.position = position
        self.init_score = init_score
        self.feature_name = (None if feature_name is None or
                             isinstance(feature_name, str)
                             else [str(f) for f in feature_name])
        self.params = copy.deepcopy(params) if params else {}
        # the rows of ``reference`` this Dataset holds (``subset``)
        self.used_indices: Optional[np.ndarray] = None
        self._binned: Optional[BinnedDataset] = None

    def _update_params(self, params: Optional[Dict[str, Any]]) -> "Dataset":
        if params:
            self.params.update(params)
        return self

    def construct(self) -> "Dataset":
        """Bin the data; with ``free_raw_data`` (the default) the raw data
        is dropped then (the JAX package's basic.py:195, :368)."""
        if self._binned is None:
            self._construct()
            if self.free_raw_data:
                self.data = None
        return self

    def _construct(self) -> "Dataset":
        if self.used_indices is not None:
            self._binned = self.reference.construct()._binned.subset(
                self.used_indices)
            return self._apply_fields()
        ref = (self.reference.construct()._binned
               if self.reference is not None else None)
        cfg = Config(self.params)
        if isinstance(self.data, (str, Path)):
            from .io.binary_io import is_binary_dataset_file, load_binary
            from .io.dataset_core import _resolve_shard_world
            from .io.file_loader import load_svm_or_csv
            path = str(self.data)
            # only the training table is sharded: a set built with
            # reference= (a validation set) loads replicated on every rank
            sw = _resolve_shard_world(cfg) if ref is None else None
            if is_binary_dataset_file(path):
                if sw is not None:
                    log.fatal(
                        "binary dataset files cannot be shard-ingested "
                        "(pre_partition=true / tpu_ingest='sharded'): a "
                        ".bin file is already binned with its own global "
                        "mappers, so distributed bin finding cannot run "
                        "and per-host .bin files at the same path would "
                        "desync the SPMD program — load the raw data "
                        "with per-rank files ('...{rank}...'), or set "
                        "tpu_ingest='replicated'")
                # already binned, with its own bin mappers
                self._binned = load_binary(path)
                return self._apply_fields()
            if cfg.two_round:
                if sw is not None:
                    log.fatal(
                        "two_round=true is incompatible with sharded "
                        "ingestion (pre_partition=true / "
                        "tpu_ingest='sharded'): the two-pass streaming "
                        "loader reads the GLOBAL file on every rank, so "
                        "the O(rows/world) host-memory contract would "
                        "not hold — use per-rank files "
                        "('...{rank}...') without two_round, or set "
                        "tpu_ingest='replicated'")
                # streaming two-pass load: bounded memory, binned in
                # place (ref: dataset_loader.cpp:266 two_round branch)
                from .io.stream_loader import load_binned_two_round
                self._binned = load_binned_two_round(
                    path, cfg, categorical_feature=self.categorical_feature,
                    reference=ref)
                return self._apply_fields()
            rank, world = sw if sw is not None else (None, None)
            X, y, w, group = load_svm_or_csv(path, cfg, rank=rank,
                                             world=world)
            self.data = X
            if self.label is None:
                self.label = y
            if self.weight is None:
                self.weight = w
            if self.group is None:
                self.group = group
            if self.position is None:
                self.position = self._load_position(path, rank, world,
                                                    len(X))
        if _is_sequence_input(self.data):
            return self._construct_from_sequences(cfg, ref)
        from .io.dataset_core import ArrowColumns, DenseColumns, SparseColumns
        if _is_arrow_table(self.data) or _has_arrow_c_stream(self.data):
            source = ArrowColumns(_arrow_table(self.data))
        elif _is_sparse(self.data):
            source = SparseColumns(self.data)
        else:
            source = DenseColumns(_to_2d_numpy(self.data))
        names = self.feature_name
        if names is None and _is_frame(self.data):
            names = [str(c) for c in self.data.columns]
        elif names is None:
            names = source.column_names()
        self._binned = BinnedDataset.from_columns(
            source, cfg, label=self.label, weight=self.weight,
            init_score=self.init_score, feature_names=names,
            reference=ref, group=self.group, position=self.position,
            categorical_features=categorical_indices(
                self.categorical_feature, cfg, names))
        return self

    @staticmethod
    def _load_position(path: str, rank: Optional[int],
                       world: Optional[int], n_rows: int
                       ) -> Optional[np.ndarray]:
        """The ``.position`` sidecar of a data file (of this rank's file
        under a ``{rank}`` placeholder). Row-slicing a shared file, a
        full-length sidecar gives this rank's slice, cut as the rows are;
        any other length is fatal (the JAX package's basic.py:266-303)."""
        from .distributed import row_slice
        from .io.file_loader import load_position_file, resolve_rank_path
        ppath, per_rank = resolve_rank_path(path, rank)
        position = load_position_file(ppath)
        if (position is None or world is None or per_rank
                or len(position) == n_rows):
            return position
        lo, hi = row_slice(len(position), rank, world)
        if hi - lo != n_rows:
            log.fatal(f"{ppath}: position sidecar has {len(position)} "
                      f"entries but the data file's rank {rank}/{world} "
                      f"row slice holds {n_rows} rows — the sidecar must "
                      "have exactly one entry per data-file row")
        return position[lo:hi]

    def _construct_from_sequences(self, cfg: Config,
                                  ref: Optional[BinnedDataset]) -> "Dataset":
        """Bin ``Sequence`` input by random-access sampling and batched
        range reads (the JAX package's basic.py __init_from_seqs)."""
        from .io.dataset_core import _resolve_shard_world
        from .io.sequence import build_from_sequences
        if ref is None and _resolve_shard_world(cfg) is not None:
            # no silent replicated load where sharding was asked for
            log.fatal("Sequence input cannot be shard-ingested "
                      "(pre_partition=true / tpu_ingest='sharded'); pass "
                      "each rank's rows as a matrix or a '...{rank}...' "
                      "file, or set tpu_ingest='replicated'")
        seqs = (list(self.data) if isinstance(self.data, (list, tuple))
                else [self.data])
        self._binned = build_from_sequences(
            seqs, cfg, categorical_indices(self.categorical_feature, cfg,
                                           self.feature_name),
            reference=ref, feature_names=self.feature_name)
        return self._apply_fields()

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """Change the categorical features (ref: basic.py
        Dataset.set_categorical_feature; the JAX package's basic.py:373):
        nothing happens when they are unchanged; a constructed Dataset is
        binned again at its next ``construct``, from its raw data."""
        if self.categorical_feature == categorical_feature:
            return self
        if self._binned is not None:
            if self.data is None:
                raise LightGBMError(
                    "Cannot set categorical feature after freeing raw "
                    "data; set free_raw_data=False when constructing "
                    "the Dataset")
            log.warning("categorical_feature changed after construction; "
                        "the dataset will be re-binned")
            self._binned = None
        self.categorical_feature = categorical_feature
        return self

    def _apply_fields(self) -> "Dataset":
        """The fields given to a Dataset whose bins came ready (a subset,
        a binary file) replace the ones it came with."""
        md = self._binned.metadata
        if self.label is not None:
            md.set_label(self.label)
        if self.weight is not None:
            md.set_weight(self.weight)
        if self.group is not None:
            md.set_query(self.group)
        if self.init_score is not None:
            md.set_init_score(self.init_score)
        if self.position is not None:
            md.set_position(self.position)
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

    def get_ref_chain(self, ref_limit: int = 100) -> set:
        """This Dataset and the chain of its references (ref: basic.py
        get_ref_chain)."""
        chain: set = set()
        head = self
        while head is not None and head not in chain and \
                len(chain) < ref_limit:
            chain.add(head)
            head = head.reference
        return chain

    def get_params(self) -> Dict[str, Any]:
        return copy.deepcopy(self.params)

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None,
                     params: Optional[Dict[str, Any]] = None,
                     position=None) -> "Dataset":
        """A validation Dataset binned with this one's bin mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params, position=position)

    def subset(self, used_indices: Sequence[int],
               params: Optional[Dict[str, Any]] = None) -> "Dataset":
        """The rows ``used_indices`` (sorted) of this Dataset, sharing its
        bin mappers (ref: basic.py Dataset.subset, Dataset::CopySubrow):
        its bins and metadata are gathered at ``construct``; query
        boundaries are rebuilt from the rows' queries, positions dropped
        (as in the JAX package)."""
        ret = Dataset(None, reference=self, params=params or self.params,
                      free_raw_data=self.free_raw_data)
        ret.used_indices = np.sort(np.asarray(used_indices, np.int64))
        return ret

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Append ``other``'s features to this Dataset in place (ref:
        basic.py add_features_from, Dataset::AddFeaturesFrom): both are
        constructed, with the same row count; this one keeps its
        metadata. Colliding names take a ``D<index>_`` prefix."""
        a, b = self.binned, other.binned
        if a.num_data != b.num_data:
            raise LightGBMError(
                f"Cannot add features from a dataset with {b.num_data} "
                f"rows to one with {a.num_data} rows")
        off = a.num_total_features
        a.ensure_logical_bins()
        b.ensure_logical_bins()
        a.bins_grouped = a.efb_info = a.bins_mv = None
        a.bin_mappers = list(a.bin_mappers) + list(b.bin_mappers)
        a.used_feature_map = np.concatenate(
            [a.used_feature_map, b.used_feature_map + off]).astype(np.int32)
        dtype = (np.uint16 if np.uint16 in (a.bins.dtype, b.bins.dtype)
                 else np.uint8)
        a.bins = np.concatenate([a.bins.astype(dtype), b.bins.astype(dtype)],
                                axis=1)
        a.num_total_features += b.num_total_features
        merged = list(a.feature_names) + list(b.feature_names)
        if len(set(merged)) != len(merged):
            merged = (list(a.feature_names) +
                      [f"D{off + i}_{n}" for i, n in
                       enumerate(b.feature_names)])
        a.feature_names = merged
        a.max_bin = max(a.max_bin, b.max_bin)
        # the raw data merges too, or is dropped with a warning (the JAX
        # package's basic.py:595-613)
        if self.data is not None and other.data is not None:
            self.data = _hstack_any(self.data, other.data)
            if self.data is None:
                log.warning("Cannot merge raw data of these input types "
                            "after add_features_from; raw data dropped")
            elif (_is_frame(self.data) and
                  len(a.feature_names) == self.data.shape[1]):
                self.data.columns = list(a.feature_names)
        elif self.data is not None:
            log.warning("Cannot keep raw data after add_features_from "
                        "(the other dataset was constructed with "
                        "free_raw_data=True)")
            self.data = None
        self.feature_name = list(a.feature_names)
        return self

    def save_binary(self, filename) -> "Dataset":
        """Write the binned Dataset to a binary file that ``Dataset(path)``
        of either package loads (ref: Dataset::SaveBinaryFile)."""
        from .io.binary_io import save_binary
        if self.binned.shard is not None:
            log.fatal("a sharded-ingest Dataset holds one rank's rows; it "
                      "cannot be saved as a binary dataset file (save each "
                      "rank's raw rows, '...{rank}...', instead)")
        self.binned.ensure_logical_bins()
        save_binary(self.binned, str(filename))
        return self

    # -- fields (ref: basic.py set_field / get_field) --------------------
    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._binned is not None:
            if label is None:
                self._binned.metadata.label = None
            else:
                self._binned.metadata.set_label(label)
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._binned is not None:
            self._binned.metadata.set_weight(weight)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._binned is not None:
            self._binned.metadata.set_init_score(init_score)
        return self

    def set_group(self, group) -> "Dataset":
        """Query sizes; applied to the binned metadata once constructed."""
        self.group = group
        if self._binned is not None:
            self._binned.metadata.set_query(group)
        return self

    def set_position(self, position) -> "Dataset":
        self.position = position
        if self._binned is not None:
            self._binned.metadata.set_position(position)
        return self

    def get_label(self):
        if self._binned is not None:
            return self._binned.metadata.label
        return self.label

    def get_weight(self):
        if self._binned is not None:
            return self._binned.metadata.weight
        return self.weight

    def get_init_score(self):
        if self._binned is not None:
            return self._binned.metadata.init_score
        return self.init_score

    def get_group(self):
        """Query sizes: from the binned metadata once constructed."""
        if self._binned is not None and \
                self._binned.metadata.query_boundaries is not None:
            return np.diff(self._binned.metadata.query_boundaries)
        return self.group

    def get_position(self):
        if self._binned is not None:
            return self._binned.metadata.position
        return self.position

    def set_field(self, field_name: str, data) -> "Dataset":
        if field_name not in self._FIELDS:
            raise LightGBMError(f"Unknown field name: {field_name}")
        getattr(self, self._FIELDS[field_name][0])(data)
        return self

    def get_field(self, field_name: str):
        """A field of the constructed Dataset; ``group`` is the query
        boundaries ``[0, n1, n1 + n2, ...]`` (``get_group`` gives the
        sizes)."""
        if field_name not in self._FIELDS:
            raise LightGBMError(f"Unknown field name: {field_name}")
        if self._binned is None:
            raise LightGBMError("Cannot get fields before construct Dataset")
        if field_name == "group":
            return self._binned.metadata.query_boundaries
        return getattr(self, self._FIELDS[field_name][1])()

    def get_data(self):
        """The data this Dataset was built from: the matrix (a file's,
        once parsed), the path of a binary file, or None for a subset."""
        return self.data

    def get_feature_name(self) -> List[str]:
        return list(self.binned.feature_names)

    def set_feature_name(self, feature_name) -> "Dataset":
        if feature_name is not None and feature_name != "auto":
            names = [str(f) for f in feature_name]
            if self._binned is not None:
                if len(names) != self._binned.num_total_features:
                    raise LightGBMError(
                        f"Length of feature names ({len(names)}) does not "
                        "equal the number of features "
                        f"({self._binned.num_total_features})")
                self._binned.feature_names = names
            self.feature_name = names
        return self

    def feature_num_bin(self, feature) -> int:
        """Number of bins of one feature, by index or name (ref: basic.py
        feature_num_bin)."""
        binned = self.binned
        if isinstance(feature, str):
            if feature not in binned.feature_names:
                raise LightGBMError(f"Unknown feature name: {feature!r}")
            feature = binned.feature_names.index(feature)
        return int(binned.bin_mappers[int(feature)].num_bin)


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
        self._engine = create_boosting(self.config, train_set.binned,
                                       objective)
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

    def serve(self, fleet=None, tenant=None, **kwargs):
        """Start a concurrent model server over this booster on its
        device (``serving/server.py``): a dynamic micro-batcher coalesces
        concurrent ``submit()`` requests into the packed-forest engine,
        ``ModelServer.publish()`` hot-swaps newly trained trees into the
        live server with zero downtime, and ``explain()`` serves device
        TreeSHAP contributions. The failure path is built in: per-request
        deadlines, fail-fast admission control (``OVERLOADED``),
        retry-then-degrade dispatch that falls back to the host walk and
        probes the device in the background, OOM bisection, publish
        rollback and (``tpu_integrity_probe_interval_s`` > 0) canary
        probes. Knobs default from the ``tpu_serving_*`` params; kwargs
        (``max_batch``, ``linger_ms``, ``num_devices``, ``devices``,
        ``queue_depth``, ``raw_score``, ``bucket``, ``deadline_ms``,
        ``max_queue_rows``, ``retry_policy``, ``probe_interval_s``)
        override (ref: the JAX package's basic.py:822-876).

        ``serve(fleet=server)`` instead registers this booster as one
        TENANT of an existing multi-tenant ``FleetServer``
        (``serving/fleet.py``; ``tenant=`` names it, by default the first
        free ``tenant<N>``) and returns its ``TenantHandle``: one
        dispatcher and one device arena for the whole fleet. Per-tenant
        kwargs there: ``deadline_ms``, ``quota_rows``, ``raw_score``
        (ref: the JAX package's basic.py:836-861).

        A booster has at most ONE live solo server: calling ``serve()``
        again while one is open returns it (no kwargs) or refuses loudly
        (a kwarg'd call cannot be honored without a second dispatcher
        over the same pack). A closed server is replaced."""
        if fleet is not None:
            if tenant is None:
                # probe for a free name: len() alone collides once any
                # tenant was removed
                i = len(fleet.tenants)
                while f"tenant{i}" in fleet.tenants:
                    i += 1
                tenant = f"tenant{i}"
            return fleet.add_tenant(tenant, self, **kwargs)
        live = getattr(self, "_live_server", None)
        if live is not None and not live.closed:
            if kwargs:
                raise LightGBMError(
                    "this Booster already has a live ModelServer; a "
                    "second serve() with different knobs would spawn a "
                    "second dispatcher thread over the same pack. Use "
                    "the existing server (serve() with no kwargs "
                    "returns it) or close() it first.")
            log.warning("serve(): returning this Booster's live "
                        "ModelServer (one dispatcher per booster)")
            return live
        from .serving import ModelServer
        srv = ModelServer(self, **kwargs)
        self._live_server = srv
        return srv

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Change parameters between iterations (ref: Booster::ResetConfig,
        c_api.cpp): ``learning_rate`` and the row sampler's settings are
        read by the next iteration. Settings the port does not implement
        yet, or that the world it trains in refuses, are refused."""
        from .distributed import num_processes
        trial = self.config.copy()
        trial.update(params)
        bad = trial.unsupported_settings() + trial.distributed_refusals(
            num_processes())
        if bad and self.train_set is not None:
            log.fatal("the port does not implement these settings yet: "
                      + ", ".join(bad))
        self.params.update(params)
        self.config = trial
        self._engine.config = trial
        self._engine.shrinkage_rate = float(trial.learning_rate)
        if hasattr(self._engine, "sample_strategy"):
            self._engine.sample_strategy.reset_config(trial)
        return self

    def free_dataset(self) -> "Booster":
        self.train_set = None
        self.valid_sets = []
        return self

    def set_network(self, machines, local_listen_port: int = 12400,
                    listen_time_out: int = 120,
                    num_machines: int = 1) -> "Booster":
        """The reference's socket network (basic.py set_network) has no
        counterpart: a world is joined through torch.distributed, whose
        rank a machine list alone does not give. Logs where to go
        instead and configures nothing (the JAX package's
        basic.py:1353-1372)."""
        if num_machines <= 1:
            log.warning("set_network with num_machines<=1 is a no-op")
            return self
        log.warning(
            "set_network: use lightgbm_tpu_torch.distributed."
            "init_distributed(coordinator_address=..., num_processes="
            f"{num_machines}, process_id=<rank>) (torch.distributed, "
            "gloo or NCCL) — the machine list alone cannot determine "
            "this process' rank; no network was configured")
        return self

    def free_network(self) -> "Booster":
        """Nothing to free: ``set_network`` configures no network."""
        return self

    def refit(self, data, label, decay_rate: float = 0.9, weight=None,
              group=None, init_score=None, **kwargs) -> "Booster":
        """A new Booster with these trees' shapes and thresholds and leaf
        values refitted to ``data`` (ref: basic.py Booster.refit ->
        LGBM_BoosterRefit; gbdt.cpp GBDT::RefitTree with
        refit_decay_rate): iteration by iteration, the objective's
        gradients over the refitted score so far, on the device the
        params name, are summed per leaf on the host, and each populated
        leaf becomes ``decay_rate * old + (1 - decay_rate) * new``; a
        leaf no row reaches keeps its value. ``kwargs`` update the
        config (the leaf output's ``lambda_l1``, ``lambda_l2``,
        ``max_delta_step``)."""
        from .io.dataset_core import Metadata
        from .io.model_io import load_model_string
        from .models.gbdt import resolve_device
        from .ops.split import SplitHyperParams, \
            calculate_splitted_leaf_output
        X = _to_2d_numpy(data).astype(np.float64, copy=False)
        n = X.shape[0]
        engine, cfg = load_model_string(self.model_to_string(), self.params)
        cfg.update(kwargs)
        md = Metadata(n)
        md.set_label(label)
        md.set_weight(weight)
        md.set_query(group)
        objective = create_objective(cfg.objective, cfg)
        device = resolve_device(cfg)
        objective.init(md, n, device)
        hp = SplitHyperParams(
            lambda_l1=cfg.lambda_l1, lambda_l2=cfg.lambda_l2,
            min_data_in_leaf=cfg.min_data_in_leaf,
            min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
            min_gain_to_split=cfg.min_gain_to_split,
            max_delta_step=cfg.max_delta_step)
        K = engine.num_tree_per_iteration
        score = np.zeros((K, n), np.float64)
        if init_score is not None:
            score += np.asarray(init_score, np.float64).reshape(-1, n)
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
        for it in range(len(engine.models) // max(K, 1)):
            s_dev = torch.as_tensor(score, dtype=torch.float32,
                                    device=device)
            g, h = objective.get_gradients(s_dev[0] if K == 1 else s_dev)
            g = g.cpu().numpy().astype(np.float64).reshape(K, n)
            h = h.cpu().numpy().astype(np.float64).reshape(K, n)
            for k in range(K):
                t = engine.models[it * K + k]
                if t.num_leaves <= 1:
                    score[k] += t.leaf_value[0]
                    continue
                leaf = t.predict_leaf(X)
                sum_g = np.bincount(leaf, weights=g[k],
                                    minlength=t.num_leaves)
                sum_h = np.bincount(leaf, weights=h[k],
                                    minlength=t.num_leaves)
                # the leaf output in f32, as the JAX package computes it
                new_val = calculate_splitted_leaf_output(
                    f32(sum_g), f32(sum_h), hp).numpy().astype(np.float64)
                new_val *= t.shrinkage
                t.leaf_value = np.where(
                    sum_h > 0,
                    decay_rate * t.leaf_value + (1.0 - decay_rate) * new_val,
                    t.leaf_value)
                score[k] += t.leaf_value[leaf]
        out = Booster.from_engine(self.params, engine)
        out.config = cfg
        return out

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

    # -- introspection and editing --------------------------------------
    @property
    def num_class_(self) -> int:
        return self._engine.num_tree_per_iteration

    def feature_name(self) -> List[str]:
        return list(self._engine.feature_names)

    def num_feature(self) -> int:
        return self._engine.max_feature_idx + 1

    def set_train_data_name(self, name: str) -> "Booster":
        self.train_data_name = name
        return self

    def lower_bound(self) -> float:
        """The sum of every tree's smallest leaf value."""
        return float(sum(t.leaf_value.min() for t in self._engine.models))

    def upper_bound(self) -> float:
        """The sum of every tree's largest leaf value."""
        return float(sum(t.leaf_value.max() for t in self._engine.models))

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        return float(self._engine.models[tree_id].leaf_value[leaf_id])

    def set_leaf_output(self, tree_id: int, leaf_id: int,
                        value: float) -> "Booster":
        """ref: Booster.set_leaf_output / Tree::SetLeafOutput. The next
        device prediction repacks the forest."""
        t = self._engine.models[tree_id]
        t.leaf_value = np.asarray(t.leaf_value, np.float64).copy()
        t.leaf_value[leaf_id] = float(value)
        self._engine.invalidate_serving_cache()
        return self

    def shuffle_models(self, start_iteration: int = 0,
                       end_iteration: int = -1) -> "Booster":
        """Permute the iterations in [start, end) with numpy's global
        generator (ref: basic.py shuffle_models); the next device
        prediction repacks the forest."""
        eng = self._engine
        K = max(eng.num_tree_per_iteration, 1)
        n_iter = len(eng.models) // K
        end = n_iter if end_iteration <= 0 else min(end_iteration, n_iter)
        idx = np.arange(start_iteration, end)
        if len(idx) > 1:
            perm = np.random.permutation(idx)
            blocks = [eng.models[i * K:(i + 1) * K] for i in range(n_iter)]
            reordered = list(blocks)
            for dst, src in zip(idx, perm):
                reordered[dst] = blocks[src]
            eng.models = [t for b in reordered for t in b]
        eng.invalidate_serving_cache()
        return self

    def get_split_value_histogram(self, feature, bins=None,
                                  xgboost_style: bool = False):
        """Histogram of the real thresholds of ``feature`` (index or name)
        over every numerical split (ref: basic.py
        get_split_value_histogram)."""
        eng = self._engine
        if isinstance(feature, str):
            if feature not in eng.feature_names:
                raise LightGBMError(f"Unknown feature name {feature!r}")
            feature = eng.feature_names.index(feature)
        values = np.asarray(
            [float(t.threshold_real[i]) for t in eng.models
             for i in range(t.num_leaves - 1)
             if int(t.split_feature[i]) == feature
             and not t.decision_type[i] & 1], np.float64)
        if bins is None or (isinstance(bins, str) and bins == "auto"):
            bins = max(min(len(np.unique(values)), 10), 1) \
                if len(values) else 1
        hist, edges = np.histogram(values, bins=bins)
        if xgboost_style:
            ret = np.column_stack((edges[1:], hist))
            return ret[ret[:, 1] > 0]
        return hist, edges

    def trees_to_dataframe(self):
        """One row per node of every tree, in the reference's columns
        (ref: basic.py Booster.trees_to_dataframe); needs pandas."""
        try:
            import pandas as pd
        except ImportError as e:
            raise LightGBMError("trees_to_dataframe needs pandas") from e
        names = self.feature_name()
        rows = []
        for tree_idx, t in enumerate(self._engine.models):
            if t.num_leaves <= 1:
                rows.append(_node_row(t, tree_idx, names, None, 1, True, 0))
                continue
            # an explicit stack: leaf-wise trees can be num_leaves deep
            stack = [(0, None, 1)]
            while stack:
                node, parent, depth = stack.pop()
                if node < 0:
                    rows.append(_node_row(t, tree_idx, names, parent, depth,
                                          True, ~node))
                    continue
                row = _node_row(t, tree_idx, names, parent, depth, False,
                                node)
                rows.append(row)
                lc, rc = int(t.left_child[node]), int(t.right_child[node])
                row["left_child"] = _node_index(tree_idx, lc)
                row["right_child"] = _node_index(tree_idx, rc)
                # right first, so that the left subtree comes out first
                stack.append((rc, row["node_index"], depth + 1))
                stack.append((lc, row["node_index"], depth + 1))
        return pd.DataFrame(rows)

    # -- prediction -----------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, validate_features: bool = False,
                device: Optional[bool] = None, **kwargs) -> np.ndarray:
        """Prediction over raw feature values: the host walk (ref:
        predictor.hpp), or with ``device`` (default: the
        ``tpu_predict_device`` parameter) the packed-forest engine on the
        training device (a loaded model: the device its params name),
        whose scores are f32 sums. Where the device route cannot serve
        (an empty tree range, f64-only values or a categorical node on
        the raw route) it warns and the host walk answers; any other
        error propagates, a missing card included.

        ``data`` may be the path of a CSV/TSV/LibSVM file, parsed with
        the training schema (``data_has_header=True`` skips a header) and
        padded with zero columns to the model's features.
        ``pred_contrib`` gives TreeSHAP ``[N, (F + 1) * K]``: the host
        walk, or with ``device=True`` the packed path tensors on the
        device (``ops/shap_pack.py``; linear and categorical models take
        the host walk, said once).
        A scipy sparse matrix is predicted in row blocks, each densified
        and predicted by the route asked for; its ``pred_contrib`` is a
        CSR matrix.
        A random forest (``average_output``) predicts the mean of its
        iterations on every route; its ``pred_contrib`` is the sum, not
        the mean, as the JAX package gives it.
        ``predict_disable_shape_check`` (here or in the params) lets a
        matrix of another width through: absent trailing features read
        0. With ``validate_features``, a frame's column names must be
        the model's."""
        eng = self._engine
        n_feat = eng.max_feature_idx + 1
        if _is_sparse(data):
            return self._predict_sparse(
                data, start_iteration=start_iteration,
                num_iteration=num_iteration, raw_score=raw_score,
                pred_leaf=pred_leaf, pred_contrib=pred_contrib,
                validate_features=validate_features, device=device,
                **kwargs)
        if isinstance(data, (str, Path)):
            from .io.file_loader import load_svm_or_csv
            cfg = self.config.copy()
            cfg.update({"header": bool(kwargs.get("data_has_header",
                                                  False))})
            X = load_svm_or_csv(str(data), cfg)[0]
            if X.shape[1] < n_feat:
                # LibSVM rows may leave out trailing zero features
                X = np.pad(X, ((0, 0), (0, n_feat - X.shape[1])))
        else:
            if validate_features and hasattr(data, "columns"):
                names = [str(c) for c in data.columns]
                if names != self.feature_name():
                    raise LightGBMError(
                        f"The data's feature names {names} are not the "
                        f"model's {self.feature_name()}")
            X = _to_2d_numpy(data).astype(np.float64, copy=False)
        disable_check = bool(kwargs.get(
            "predict_disable_shape_check",
            self.config.predict_disable_shape_check))
        if X.shape[1] != n_feat and not disable_check:
            raise LightGBMError(
                f"The number of features in data ({X.shape[1]}) is not "
                f"the same as it was in training data ({n_feat}).\nYou "
                "can set predict_disable_shape_check=true to discard this "
                "error, but please be aware what you are doing.")
        if X.shape[1] < n_feat:
            # as the reference's zero-initialized row buffer (predictor.hpp)
            X = np.pad(X, ((0, 0), (0, n_feat - X.shape[1])))
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
        use_device = (self.config.tpu_predict_device if device is None
                      else device)
        if pred_contrib:
            if use_device:
                # the packed SHAP path tensors (ops/shap_pack.py): f32
                # path algebra on the device, within f32 accumulation of
                # the f64 host walk. A model it does not cover (linear
                # trees, categorical splits) and f64-only values on the
                # raw route raise DeviceRouteUnavailable and take the
                # host walk, said once; anything else raises
                try:
                    return eng.explain_device(X, start_iteration,
                                              end_iteration)
                except DeviceRouteUnavailable as e:
                    log.info_once(f"device explanation unavailable ({e}); "
                                  "using the host predict_contrib walk")
            from .core.shap import predict_contrib
            return predict_contrib(eng, X, start_iteration, end_iteration)
        raw = None
        if use_device:
            try:
                raw = eng.predict_device(X, start_iteration, end_iteration)
            except DeviceRouteUnavailable as e:
                # a linear model's route is the host walk, as the
                # reference's: said once, not at every call
                (log.warning_once if str(e) == LINEAR_TREES_ON_HOST
                 else log.warning)(f"device prediction unavailable ({e}); "
                                   "using the host path")
        if raw is None:
            raw = np.zeros((X.shape[0], K), dtype=np.float64)
            for i, t in enumerate(trees):
                raw[:, i % K] += t.predict(X)
        if eng.average_output and end_iteration > start_iteration:
            # a random forest predicts the mean of its trees (ref: the JAX
            # package's basic.py:1125-1126)
            raw /= end_iteration - start_iteration
        if not raw_score and eng.objective is not None:
            if K > 1:
                # [R, K]: softmax over the classes, or each class's sigmoid
                raw = np.asarray(eng.objective.convert_output(raw))
            else:
                raw[:, 0] = np.asarray(
                    eng.objective.convert_output(raw[:, 0]))
        return raw[:, 0] if K == 1 else raw

    def _predict_sparse(self, data, pred_contrib: bool, **kw):
        """Sparse rows in blocks of ``max(1024, 2**25 // n_cols)`` rows
        (``predict_sparse_block_rows`` overrides it), each densified to
        at most 256 MB of float64 and predicted as a matrix, never the
        whole matrix at once (ref: c_api.cpp PredictForCSR; the JAX
        package's basic.py:967-995). ``pred_contrib`` gives CSR."""
        import scipy.sparse as sp
        csr = data.tocsr()
        n_rows = csr.shape[0]
        block = int(kw.pop("predict_sparse_block_rows",
                           max(1024, (1 << 25) // max(csr.shape[1], 1))))
        outs = [self.predict(csr[i:i + block].toarray().astype(np.float64),
                             pred_contrib=pred_contrib, **kw)
                for i in range(0, max(n_rows, 1), block)]
        if pred_contrib:
            return sp.vstack([sp.csr_matrix(o) for o in outs], format="csr")
        return np.concatenate(outs, axis=0)

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
                   start_iteration: int = 0,
                   importance_type: str = "split") -> Dict[str, Any]:
        """The model as a JSON-ready dict (ref: GBDT::DumpModel)."""
        from .io.model_io import dump_model_dict
        return dump_model_dict(self._engine, self.config,
                               num_iteration=num_iteration,
                               start_iteration=start_iteration,
                               importance_type=importance_type)

    def save_model(self, filename, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split",
                   atomic: bool = False) -> "Booster":
        """``atomic=True`` writes through the crash-safe writer (tmp +
        fsync + rename)."""
        from .io.model_io import save_model_file
        save_model_file(self._engine, self.config, str(filename),
                        num_iteration=num_iteration,
                        start_iteration=start_iteration,
                        importance_type=importance_type, atomic=atomic)
        return self

    # -- copies (ref: basic.py Booster.__getstate__ / __setstate__) --------
    # The engine holds device tensors and the training data: a pickle or a
    # copy carries the model text instead, and comes back as a loaded
    # model, without training data, predicting on the device its params
    # name.
    def __getstate__(self):
        state = self.__dict__.copy()
        for heavy in ("_engine", "train_set", "valid_sets", "_live_server"):
            state.pop(heavy, None)
        state["_model_str"] = (self.model_to_string()
                               if self._engine is not None else None)
        return state

    def __setstate__(self, state):
        model_str = state.pop("_model_str", None)
        self.__dict__.update(state)
        self.train_set = None
        self.valid_sets = []
        self._engine = None
        if model_str is not None:
            self.model_from_string(model_str)

    def __copy__(self):
        return self.__deepcopy__(None)

    def __deepcopy__(self, memo):
        out = type(self).__new__(type(self))
        if memo is not None:
            memo[id(self)] = out
        out.__setstate__(copy.deepcopy(self.__getstate__(), memo or {}))
        return out
