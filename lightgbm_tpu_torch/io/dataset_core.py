"""Binned dataset: row-major bin matrix + metadata.

Port of the dense path of ``lightgbm_tpu/io/dataset_core.py`` (ref:
include/LightGBM/dataset.h:492 Dataset, dataset.h:49 Metadata,
src/io/dataset_loader.cpp:601 ConstructFromSampleData).

The JAX package stores ``bins`` feature-major ``[F, R]``; the port stores
the ROW-major ``[R, F]`` matrix, the layout the compact grower gathers
leaf rows from and the histogram kernel reads. Bin finding (row sampling,
per-feature ``BinMapper.find_bin``) follows the JAX package line for line
so the boundaries and the binned values are bit-identical.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..config import Config
from ..utils import log
from .binning import BIN_NUMERICAL, BinMapper

# the most bins a feature may have: bins are stored in at most 16 bits
MAX_NUM_BIN = 1 << 16


class Metadata:
    """label / weight / init_score / query / position storage (ref:
    dataset.h:49)."""

    def __init__(self, num_data: int):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None          # f32 [N]
        self.weight: Optional[np.ndarray] = None         # f32 [N]
        self.init_score: Optional[np.ndarray] = None     # f64 [N * num_class]
        self.query_boundaries: Optional[np.ndarray] = None  # i32 [Q + 1]
        self.position: Optional[np.ndarray] = None       # i32 [N]

    def set_label(self, label: Sequence[float]) -> None:
        label = np.ascontiguousarray(label, dtype=np.float32).reshape(-1)
        if len(label) != self.num_data:
            log.fatal(f"Length of label ({len(label)}) != num_data "
                      f"({self.num_data})")
        self.label = label

    def set_weight(self, weight: Optional[Sequence[float]]) -> None:
        if weight is None:
            self.weight = None
            return
        weight = np.ascontiguousarray(weight, dtype=np.float32).reshape(-1)
        if len(weight) != self.num_data:
            log.fatal(f"Length of weight ({len(weight)}) != num_data "
                      f"({self.num_data})")
        self.weight = weight

    def set_init_score(self, init_score: Optional[Sequence[float]]) -> None:
        """K * num_data values, class-major (the engine reshapes them to
        ``[K, N]``)."""
        if init_score is None:
            self.init_score = None
            return
        init_score = np.ascontiguousarray(init_score,
                                          dtype=np.float64).reshape(-1)
        if len(init_score) % self.num_data != 0:
            log.fatal("Length of init_score must be a multiple of num_data")
        self.init_score = init_score

    def set_query(self, group: Optional[Sequence[int]]) -> None:
        """Query sizes, stored as i32 boundaries ``[Q + 1]`` (ref:
        metadata.cpp SetQuery)."""
        if group is None:
            self.query_boundaries = None
            return
        group = np.ascontiguousarray(group, dtype=np.int64).reshape(-1)
        boundaries = np.zeros(len(group) + 1, dtype=np.int64)
        np.cumsum(group, out=boundaries[1:])
        if boundaries[-1] != self.num_data:
            log.fatal(f"Sum of query counts ({boundaries[-1]}) != num_data "
                      f"({self.num_data})")
        self.query_boundaries = boundaries.astype(np.int32)

    def set_position(self, position: Optional[Sequence[int]]) -> None:
        """Each row's position id, for lambdarank's position bias."""
        if position is None:
            self.position = None
            return
        position = np.ascontiguousarray(position, dtype=np.int32).reshape(-1)
        if len(position) != self.num_data:
            log.fatal("Length of position != num_data")
        self.position = position

    @property
    def num_queries(self) -> int:
        return (0 if self.query_boundaries is None
                else len(self.query_boundaries) - 1)


class BinnedDataset:
    """Quantized training data.

    Attributes
    ----------
    bins : np.ndarray uint8 or uint16 [num_data, num_used_features]
        Row-major bin indices (uint16 once a used feature has more than
        256 bins); trivial (constant / pre-filtered) features are
        excluded.
    bin_mappers : per ORIGINAL feature BinMapper (len == num_total_features).
    used_feature_map : original feature index for each column of ``bins``.
    """

    def __init__(self) -> None:
        self.bins: Optional[np.ndarray] = None
        self.bin_mappers: List[BinMapper] = []
        self.used_feature_map: np.ndarray = np.zeros(0, dtype=np.int32)
        self.num_data: int = 0
        self.num_total_features: int = 0
        self.metadata: Optional[Metadata] = None
        self.feature_names: List[str] = []
        self.max_bin: int = 0

    @classmethod
    def from_matrix(cls, data: np.ndarray, config: Config,
                    label: Optional[Sequence[float]] = None,
                    weight: Optional[Sequence[float]] = None,
                    init_score: Optional[Sequence[float]] = None,
                    feature_names: Optional[List[str]] = None,
                    reference: Optional["BinnedDataset"] = None,
                    group: Optional[Sequence[int]] = None,
                    position: Optional[Sequence[int]] = None,
                    ) -> "BinnedDataset":
        """Build from a dense [N, F] float matrix (ref:
        DatasetLoader::ConstructFromSampleData dataset_loader.cpp:601).
        With ``reference`` (a validation set) the rows are binned with
        the reference's bin mappers, used features, ``max_bin`` and
        feature names (ref: the JAX package's io/dataset_core.py:458).
        ``group`` holds query sizes and ``position`` each row's position
        id (ranking)."""
        data = np.asarray(data)
        if data.ndim != 2:
            log.fatal("data must be 2-dimensional")
        num_data, num_features = data.shape
        self = cls()
        self.num_data = num_data
        self.num_total_features = num_features
        if reference is not None:
            if num_features != reference.num_total_features:
                log.fatal(f"data has {num_features} features but its "
                          f"reference has {reference.num_total_features}")
            self.bin_mappers = reference.bin_mappers
            self.used_feature_map = reference.used_feature_map
            self.max_bin = reference.max_bin
            self.feature_names = reference.feature_names
        else:
            self.max_bin = int(config.max_bin)
            self.feature_names = (
                list(feature_names) if feature_names else
                [f"Column_{i}" for i in range(num_features)])
            self.bin_mappers = cls._find_bin_mappers(data, config)
            self.used_feature_map = np.asarray(
                [i for i, m in enumerate(self.bin_mappers)
                 if not m.is_trivial], dtype=np.int32)
        self.bins = _quantize_rowmajor(data, self.bin_mappers,
                                       self.used_feature_map)
        meta = Metadata(num_data)
        if label is not None:
            meta.set_label(label)
        meta.set_weight(weight)
        meta.set_query(group)
        meta.set_init_score(init_score)
        meta.set_position(position)
        self.metadata = meta
        return self

    @staticmethod
    def _find_bin_mappers(data: np.ndarray,
                          config: Config) -> List[BinMapper]:
        """Sample rows and find per-feature bin boundaries (ref:
        dataset_loader.cpp:1080 ConstructBinMappersFromTextData)."""
        num_data, num_features = data.shape
        sample_cnt = min(config.bin_construct_sample_cnt, num_data)
        if sample_cnt < num_data:
            rng = np.random.default_rng(config.data_random_seed)
            sample_indices = np.sort(rng.choice(num_data, size=sample_cnt,
                                                replace=False))
        else:
            sample_indices = np.arange(num_data)
        # pre-filter needs the split constraint (ref: dataset_loader.cpp
        # filter_cnt computation)
        filter_cnt = int(max(
            config.min_data_in_leaf * len(sample_indices)
            / max(num_data, 1), config.min_data_in_bin))
        max_bin_by_feature = config.max_bin_by_feature
        mappers = []
        for f in range(num_features):
            col = np.asarray(data[sample_indices, f], dtype=np.float64)
            mb = (max_bin_by_feature[f] if f < len(max_bin_by_feature)
                  else config.max_bin)
            mappers.append(BinMapper.find_bin(
                col, len(sample_indices), mb, config.min_data_in_bin,
                filter_cnt, pre_filter=config.feature_pre_filter,
                bin_type=BIN_NUMERICAL, use_missing=config.use_missing,
                zero_as_missing=config.zero_as_missing))
        n_trivial = sum(m.is_trivial for m in mappers)
        if n_trivial:
            log.info(f"{n_trivial} trivial feature(s) removed")
        return mappers

    def used_bin_mappers(self) -> List[BinMapper]:
        return [self.bin_mappers[i] for i in self.used_feature_map]

    def subset(self, row_indices: np.ndarray) -> "BinnedDataset":
        """Row-subset copy sharing the bin mappers (ref: Dataset::CopySubrow;
        the JAX package's io/dataset_core.py:944): a row gather of the
        bins, label, weight and class-major ``init_score``; query
        boundaries are rebuilt from the rows' query ids. ``position`` is
        not carried, as in the JAX package."""
        row_indices = np.asarray(row_indices, dtype=np.int64)
        out = BinnedDataset()
        out.bins = self.bins[row_indices]
        out.bin_mappers = self.bin_mappers
        out.used_feature_map = self.used_feature_map
        out.num_data = len(row_indices)
        out.num_total_features = self.num_total_features
        out.feature_names = self.feature_names
        out.max_bin = self.max_bin
        meta = Metadata(out.num_data)
        src = self.metadata
        if src.label is not None:
            meta.label = src.label[row_indices]
        if src.weight is not None:
            meta.weight = src.weight[row_indices]
        if src.init_score is not None:
            ncol = len(src.init_score) // src.num_data
            meta.init_score = src.init_score.reshape(
                ncol, src.num_data)[:, row_indices].reshape(-1)
        if src.query_boundaries is not None:
            qid = np.searchsorted(src.query_boundaries,
                                  np.arange(src.num_data), side="right") - 1
            # the rows of one query stay adjacent for ranking
            _, counts = np.unique(qid[row_indices], return_counts=True)
            meta.set_query(counts)
        out.metadata = meta
        return out

    def feature_infos(self) -> List[str]:
        return [m.feature_info() for m in self.bin_mappers]


def _quantize_rowmajor(data: np.ndarray, bin_mappers: List[BinMapper],
                       used_feature_map: np.ndarray) -> np.ndarray:
    """Per-feature ``value_to_bin`` into the row-major matrix: uint8 when
    every used feature has at most 256 bins, uint16 otherwise (the JAX
    package's rule, ``io/dataset_core.py:168``)."""
    max_num_bin = max((bin_mappers[i].num_bin for i in used_feature_map),
                      default=2)
    if max_num_bin > MAX_NUM_BIN:
        log.fatal(f"max_bin gives {max_num_bin} bins; bins are stored in "
                  f"16 bits, at most {MAX_NUM_BIN} per feature")
    dtype = np.uint8 if max_num_bin <= 256 else np.uint16
    bins = np.empty((data.shape[0], len(used_feature_map)), dtype)
    for out_i, feat_i in enumerate(used_feature_map):
        bins[:, out_i] = bin_mappers[feat_i].value_to_bin(
            np.asarray(data[:, feat_i], dtype=np.float64))
    return bins
