"""Binned dataset: row-major bin matrix + metadata.

Port of the dense path of ``lightgbm_tpu/io/dataset_core.py`` (ref:
include/LightGBM/dataset.h:492 Dataset, dataset.h:49 Metadata,
src/io/dataset_loader.cpp:601 ConstructFromSampleData).

The JAX package stores ``bins`` feature-major ``[F, R]``; the port stores
the ROW-major ``[R, F]`` matrix, the layout the compact grower gathers
leaf rows from and the histogram kernel reads. Bin finding (row sampling,
per-feature ``BinMapper.find_bin``, categorical features by index)
follows the JAX package line for line so the boundaries and the binned
values are bit-identical.

Input reaches binning through a ``ColumnSource`` (the JAX package's
io/dataset_core.py:195-300): a dense matrix (``DenseColumns``), a scipy
sparse matrix (``SparseColumns``) or an Arrow table (``ArrowColumns``,
pyarrow imported only when one is given), one float64 column at a time.

A sparse source may be stored in one of two other ways, as the JAX
package stores it (``tpu_sparse_storage``, io/dataset_core.py:476-533):
straight into EFB group columns (``bins_grouped`` ``[R, G]`` and
``efb_info``; ``io/bundling.pack_sparse_direct``), or as multi-value
``[R, K]`` feature ids and bins (``bins_mv``;
``ops/hist_multival.py``). ``bins`` is None then, until a consumer that
needs the logical bins calls ``ensure_logical_bins``.

Sharded ingestion (``pre_partition=true`` or ``tpu_ingest=sharded`` in a
``torch.distributed`` world of more than one; the JAX package's
io/dataset_core.py:31-200, 564-818): each rank passes only its own rows,
the ranks agree on the bin mappers through mergeable sample summaries
all-gathered over ``distributed.allgather_bytes``, and each rank bins
its rows only, so ``bins`` is ``[local_rows, F_used]`` while
``num_data`` and the metadata describe the global table, the rank-order
concatenation of the shards (``ShardInfo``). Without it, in a world,
each rank finds the bins of its feature slice only and the mappers are
all-gathered (the reference's distributed bin finding).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from ..utils import log
from .binning import (BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper,
                      FeatureSampleSummary, deserialize_bin_mappers,
                      deserialize_summaries, serialize_bin_mappers,
                      serialize_summaries)

# the most bins a feature may have: bins are stored in at most 16 bits
MAX_NUM_BIN = 1 << 16


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """Row-shard topology of a sharded-ingest BinnedDataset (the JAX
    package's io/dataset_core.py:31-56): ``row_counts[r]`` rows on rank
    r; the global table is the rank-order concatenation of the shards.
    ``digests`` holds every rank's shard-content digest, all-gathered at
    construction: the gang manifest's fingerprint
    (``robustness/gang.py``), so a resume refuses a different sharding
    of the data."""

    rank: int
    world: int
    row_counts: np.ndarray        # int64 [world]
    digests: Optional[Tuple[int, ...]] = None

    @property
    def local_num_data(self) -> int:
        return int(self.row_counts[self.rank])

    @property
    def row_offset(self) -> int:
        """Global index of this shard's first row."""
        return int(self.row_counts[:self.rank].sum())


def _shard_content_digest(bins: np.ndarray) -> int:
    """Sampled CRC32 of one rank's binned shard, the JAX package's
    ``_shard_content_digest`` (io/dataset_core.py:59-72) over the same
    bytes: it hashes the shape and dtype of the feature-major ``[F, R]``
    matrix and ~64 evenly spaced columns of it, and a column of that
    matrix is a row of the port's row-major ``[R, F]`` bins. A
    different cut, permuted rows or different data change it."""
    rows, feats = int(bins.shape[0]), int(bins.shape[1])
    h = zlib.crc32(f"{bins.dtype}:{(feats, rows)}".encode())
    step = max(1, rows // 64)
    for i in range(0, rows, step):
        h = zlib.crc32(np.ascontiguousarray(bins[i]).tobytes(), h)
    return h & 0xffffffff


_SHARD_RESOLVE_LOGGED: set = set()


def _log_once(key: str, emit) -> None:
    """The file route resolves the shard world in ``basic.py`` and again
    in ``from_columns``: the same answer, logged once a process."""
    if key not in _SHARD_RESOLVE_LOGGED:
        _SHARD_RESOLVE_LOGGED.add(key)
        emit()


def _resolve_shard_world(config: Config) -> Optional[Tuple[int, int]]:
    """(rank, world) when sharded ingestion engages, else None (the JAX
    package's io/dataset_core.py:85-125 over the ``torch.distributed``
    world): ``tpu_ingest=sharded``, or ``pre_partition=true`` under the
    default ``auto``, in a world of more than one process. Asked for in
    a world of one it loads replicated, with an info log."""
    from ..distributed import num_processes, process_index
    ingest = str(config.tpu_ingest).lower()
    if ingest == "replicated":
        return None
    if ingest == "auto" and not config.pre_partition:
        return None
    world = num_processes()
    if world <= 1:
        if ingest == "sharded":
            _log_once("sharded-world1", lambda: log.info(
                "tpu_ingest='sharded' requested but the process "
                "world has size 1; loading replicated"))
        return None
    if ingest == "auto":
        _log_once("auto-engaged", lambda: log.warning(
            "pre_partition=true now engages SHARDED ingestion: each "
            "process must pass ONLY ITS OWN row shard (the training "
            "table is the rank-order concatenation). If every rank "
            "still loads the global table, set pre_partition=false "
            "(or tpu_ingest='replicated') — otherwise rows would be "
            f"duplicated {world}x"))
    return process_index(), world


def _allgather_rows(arr: Optional[np.ndarray], dtype,
                    what: str) -> Optional[np.ndarray]:
    """An optional per-row array of every rank, concatenated in rank
    order (a collective: every rank calls it). None everywhere stays
    None; present on some ranks only is fatal."""
    from ..distributed import allgather_bytes
    blob = (np.ascontiguousarray(arr, dtype).tobytes()
            if arr is not None else b"")
    parts = allgather_bytes(blob, what=what)
    present = [len(p) > 0 for p in parts]
    if not any(present):
        return None
    if not all(present):
        log.fatal(f"{what}: some ranks passed this metadata and some "
                  "did not — sharded ingestion needs it on every rank "
                  "(and every shard must be non-empty)")
    return np.concatenate([np.frombuffer(p, dtype) for p in parts])


class ColumnSource:
    """Column-addressable view of a 2-D feature container: every input
    format gives float64 columns on demand, so binning never holds a
    dense float copy of columnar data (ref: the reference's Parser /
    ArrowChunkedArray adapters)."""

    num_data: int
    num_features: int

    def get_col(self, f: int) -> np.ndarray:      # f64 [N]
        raise NotImplementedError

    def get_col_sample(self, f: int, rows: np.ndarray) -> np.ndarray:
        """f64 [len(rows)]; override when sampling beats a whole column."""
        return self.get_col(f)[rows]

    def column_names(self) -> Optional[List[str]]:
        return None

    def to_dense_f32(self) -> Optional[np.ndarray]:
        """The dense ``[N, F]`` f32 values where a source has them
        cheaply (linear trees), else None."""
        return None


class DenseColumns(ColumnSource):
    """A dense ``[N, F]`` matrix."""

    def __init__(self, data: np.ndarray):
        self.data = np.asarray(data)
        self.num_data, self.num_features = self.data.shape

    def get_col(self, f: int) -> np.ndarray:
        return np.ascontiguousarray(self.data[:, f], dtype=np.float64)

    def get_col_sample(self, f: int, rows: np.ndarray) -> np.ndarray:
        return np.asarray(self.data[rows, f], dtype=np.float64)

    def to_dense_f32(self) -> np.ndarray:
        return np.asarray(self.data, np.float32)


class SparseColumns(ColumnSource):
    """A scipy CSR, CSC or COO matrix, held as CSC and densified one
    column at a time."""

    def __init__(self, mat):
        self.csc = mat.tocsc()
        self.num_data, self.num_features = self.csc.shape
        self._buf = np.zeros(self.num_data, np.float64)
        self._sample = (None, None)   # (rows, each row's position or -1)

    def get_col(self, f: int) -> np.ndarray:
        lo, hi = self.csc.indptr[f], self.csc.indptr[f + 1]
        self._buf[:] = 0.0
        self._buf[self.csc.indices[lo:hi]] = self.csc.data[lo:hi]
        return self._buf

    def get_col_sample(self, f: int, rows: np.ndarray) -> np.ndarray:
        # O(nnz_f): the column's stored rows looked up in a map of the
        # sample's rows (built once for the sample every feature shares),
        # no densified column
        if self._sample[0] is not rows:
            pos = np.full(self.num_data, -1, np.int64)
            pos[rows] = np.arange(len(rows))
            self._sample = (rows, pos)
        lo, hi = self.csc.indptr[f], self.csc.indptr[f + 1]
        at = self._sample[1][self.csc.indices[lo:hi]]
        hit = at >= 0
        out = np.zeros(len(rows), np.float64)
        out[at[hit]] = self.csc.data[lo:hi][hit]
        return out


class ArrowColumns(ColumnSource):
    """A pyarrow Table or RecordBatch, converted a column at a time;
    nulls become NaN, as the reference maps Arrow nulls (ref:
    include/LightGBM/arrow.h)."""

    def __init__(self, table):
        import pyarrow as pa
        if isinstance(table, pa.RecordBatch):
            table = pa.Table.from_batches([table])
        self.table = table
        self.num_data = table.num_rows
        self.num_features = table.num_columns

    def get_col(self, f: int) -> np.ndarray:
        col = self.table.column(int(f))
        return np.asarray(col.to_numpy(zero_copy_only=False),
                          dtype=np.float64)

    def column_names(self) -> List[str]:
        return [str(n) for n in self.table.column_names]

    def to_dense_f32(self) -> np.ndarray:
        out = np.empty((self.num_data, self.num_features), np.float32)
        for f in range(self.num_features):
            out[:, f] = self.get_col(f)
        return out


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
        excluded. None while a sparse source is stored otherwise:
    bins_grouped, efb_info : [num_data, G] EFB group columns and the
        ``io/bundling.BundleInfo`` that packed them, or None;
    bins_mv : the multi-value ``(idx, binv)`` int32 [num_data, K] pair
        over used features, or None.
    bin_mappers : per ORIGINAL feature BinMapper (len == num_total_features).
    used_feature_map : original feature index for each column of ``bins``.
    raw : np.ndarray f32 [num_data, num_total_features] or None
        The raw features, kept only under ``linear_tree`` (ref: Dataset
        raw_data_, dataset.h; the JAX package's io/dataset_core.py:401).
    """

    def __init__(self) -> None:
        self.bins: Optional[np.ndarray] = None
        self.shard: Optional[ShardInfo] = None
        # sharded ingestion's host seconds by step and bytes on the wire
        self.ingest_stats: Optional[Dict[str, float]] = None
        self.bins_grouped: Optional[np.ndarray] = None
        self.efb_info = None
        self.bins_mv: Optional[tuple] = None
        self.bin_mappers: List[BinMapper] = []
        self.used_feature_map: np.ndarray = np.zeros(0, dtype=np.int32)
        self.num_data: int = 0
        self.num_total_features: int = 0
        self.metadata: Optional[Metadata] = None
        self.feature_names: List[str] = []
        self.max_bin: int = 0
        self.raw: Optional[np.ndarray] = None

    @classmethod
    def from_matrix(cls, data: np.ndarray, config: Config,
                    **kwargs) -> "BinnedDataset":
        """Build from a dense [N, F] float matrix (``from_columns``)."""
        data = np.asarray(data)
        if data.ndim != 2:
            log.fatal("data must be 2-dimensional")
        return cls.from_columns(DenseColumns(data), config, **kwargs)

    @classmethod
    def from_columns(cls, source: ColumnSource, config: Config,
                     label: Optional[Sequence[float]] = None,
                     weight: Optional[Sequence[float]] = None,
                     init_score: Optional[Sequence[float]] = None,
                     feature_names: Optional[List[str]] = None,
                     reference: Optional["BinnedDataset"] = None,
                     group: Optional[Sequence[int]] = None,
                     position: Optional[Sequence[int]] = None,
                     categorical_features: Sequence[int] = (),
                     ) -> "BinnedDataset":
        """Build from a column source (ref:
        DatasetLoader::ConstructFromSampleData dataset_loader.cpp:601).
        With ``reference`` (a validation set) the rows are binned with
        the reference's bin mappers, used features, ``max_bin`` and
        feature names (ref: the JAX package's io/dataset_core.py:458).
        ``group`` holds query sizes and ``position`` each row's position
        id (ranking); ``categorical_features`` the indices of the
        features binned as categories. Names come from ``feature_names``,
        else the source's columns, else ``Column_i``. Sharded ingestion
        takes ``_from_columns_sharded``; a set with a ``reference``
        always loads replicated."""
        if reference is None:
            shard_world = _resolve_shard_world(config)
            if shard_world is not None:
                return cls._from_columns_sharded(
                    source, config, *shard_world, label=label,
                    weight=weight, group=group, init_score=init_score,
                    position=position, feature_names=feature_names,
                    categorical_features=categorical_features)
        num_data, num_features = source.num_data, source.num_features
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
            src_names = source.column_names()
            self.feature_names = (
                list(feature_names) if feature_names else
                src_names if src_names else
                [f"Column_{i}" for i in range(num_features)])
            self.bin_mappers = cls._find_bin_mappers(source, config,
                                                     categorical_features)
            self.used_feature_map = np.asarray(
                [i for i, m in enumerate(self.bin_mappers)
                 if not m.is_trivial], dtype=np.int32)
        self._store(source, config, reference is None)
        if config.linear_tree:
            self.raw = source.to_dense_f32()
            if self.raw is None:
                log.fatal("linear_tree requires raw feature values; "
                          "sparse inputs are not supported with "
                          "linear_tree=true")
        meta = Metadata(num_data)
        if label is not None:
            meta.set_label(label)
        meta.set_weight(weight)
        meta.set_query(group)
        meta.set_init_score(init_score)
        meta.set_position(position)
        self.metadata = meta
        return self

    @classmethod
    def _from_columns_sharded(cls, source: ColumnSource, config: Config,
                              rank: int, world: int, label=None,
                              weight=None, group=None, init_score=None,
                              position=None,
                              feature_names: Optional[List[str]] = None,
                              categorical_features: Sequence[int] = (),
                              ) -> "BinnedDataset":
        """Sharded ingestion: ``source`` holds only this rank's rows (the
        reference's pre_partition, dataset_loader.cpp:1175-1260; the JAX
        package's io/dataset_core.py:564-707). Every step is a
        collective, beaten under ``heartbeat.PHASE_INGEST``:

        0. all-gather the ranks' row and feature counts: the global
           layout;
        1. sample the local rows, summarize each feature, all-gather the
           summaries, find the bins of this rank's feature slice over
           the merged summaries, all-gather the mappers;
        2. bin this rank's rows only: ``bins`` is ``[local_rows,
           F_used]``, dense;
        3. all-gather the shards' content digests;
        4. all-gather the per-row metadata (O(rows) scalars).

        Host memory for the table is O(rows / world x features).
        ``ingest_stats`` keeps each step's host seconds and the bytes
        the summaries and the mappers took on the wire (every rank's
        blob, as each rank receives them)."""
        import os
        import time

        from .. import distributed
        from ..distributed import allgather_bytes
        from ..robustness import heartbeat

        num_data, num_features = source.num_data, source.num_features
        if float(config.tpu_gang_collective_timeout_s or 0.0) > 0.0:
            distributed.set_collective_timeout(
                float(config.tpu_gang_collective_timeout_s))
        # liveness from the first collective: a gang supervisor sees
        # beats during ingestion, not only once training starts
        hb_env = (os.environ.get(heartbeat.ENV_HEARTBEAT) or "").strip()
        if hb_env:
            heartbeat.install(heartbeat.rank_path(hb_env, rank))

        def beat(step: int) -> None:
            heartbeat.beat(heartbeat.PHASE_INGEST, step)

        beat(0)
        counts = allgather_bytes(
            np.asarray([num_data, num_features], np.int64).tobytes(),
            what="sharded ingest: row counts")
        pairs = np.stack([np.frombuffer(b, np.int64) for b in counts])
        row_counts = np.ascontiguousarray(pairs[:, 0])
        if not np.all(pairs[:, 1] == num_features):
            log.fatal(
                "sharded ingest: feature counts disagree across ranks "
                f"({pairs[:, 1].tolist()}) — every shard must carry the "
                "same columns")
        if np.any(row_counts <= 0):
            log.fatal("sharded ingest: every process must hold at least "
                      f"one row (row counts: {row_counts.tolist()})")
        self = cls()
        self.shard = ShardInfo(rank=rank, world=world,
                               row_counts=row_counts)
        self.num_data = int(row_counts.sum())
        self.num_total_features = num_features
        self.max_bin = int(config.max_bin)
        src_names = source.column_names()
        self.feature_names = (
            list(feature_names) if feature_names else
            src_names if src_names else
            [f"Column_{i}" for i in range(num_features)])
        log.info(f"sharded ingest: rank {rank}/{world} holds "
                 f"{num_data}/{self.num_data} rows")
        if config.linear_tree:
            log.fatal("linear_tree requires the full raw feature table "
                      "on every host; it is not supported with sharded "
                      "ingestion (tpu_ingest='sharded'/pre_partition)")

        stats: Dict[str, float] = {}
        beat(1)
        self.bin_mappers = cls._find_bin_mappers_sharded(
            source, config, categorical_features, rank, world, row_counts,
            stats)
        self.used_feature_map = np.asarray(
            [i for i, m in enumerate(self.bin_mappers)
             if not m.is_trivial], dtype=np.int32)
        n_trivial = num_features - len(self.used_feature_map)
        if n_trivial:
            log.info(f"{n_trivial} trivial feature(s) removed")

        beat(2)
        t = time.perf_counter()
        self.bins = _quantize_rowmajor(source, self.bin_mappers,
                                       self.used_feature_map)
        stats["quantize_s"] = time.perf_counter() - t

        beat(3)
        t = time.perf_counter()
        got = allgather_bytes(
            int(_shard_content_digest(self.bins)).to_bytes(4, "big"),
            what="sharded ingest: shard digests")
        self.shard = dataclasses.replace(
            self.shard,
            digests=tuple(int.from_bytes(b, "big") for b in got))

        stats["digest_s"] = time.perf_counter() - t

        beat(4)
        t = time.perf_counter()
        meta = Metadata(self.num_data)
        lab = _allgather_rows(label, np.float32, "sharded ingest: label")
        if lab is not None:
            meta.set_label(lab)
        meta.set_weight(_allgather_rows(weight, np.float32,
                                        "sharded ingest: weight"))
        meta.set_position(_allgather_rows(position, np.int32,
                                          "sharded ingest: position"))
        # queries are local to a shard (never span two), as the
        # reference's pre-partitioned query files
        meta.set_query(_allgather_rows(group, np.int64,
                                       "sharded ingest: group"))
        isc_local = None
        if init_score is not None:
            isc_local = np.ascontiguousarray(init_score,
                                             np.float64).reshape(-1)
            if num_data and len(isc_local) % num_data != 0:
                log.fatal("Length of init_score must be a multiple of "
                          "the local shard's num_data")
        flat = _allgather_rows(isc_local, np.float64,
                               "sharded ingest: init_score")
        isc = None
        if flat is not None:
            # each rank's block is class-major over its rows: restitch to
            # class-major over the global table
            k = len(flat) // max(self.num_data, 1)
            offs = np.concatenate([[0], np.cumsum(row_counts * k)])
            isc = np.concatenate(
                [flat[offs[r]:offs[r + 1]].reshape(k, -1)
                 for r in range(world)], axis=1).reshape(-1)
        meta.set_init_score(isc)
        self.metadata = meta
        stats["metadata_s"] = time.perf_counter() - t
        self.ingest_stats = stats
        beat(5)
        return self

    @staticmethod
    def _find_bin_mappers_sharded(source: ColumnSource, config: Config,
                                  categorical_features: Sequence[int],
                                  rank: int, world: int,
                                  row_counts: np.ndarray,
                                  stats: Optional[Dict[str, float]] = None
                                  ) -> List[BinMapper]:
        """Distributed bin finding over row shards (ref:
        dataset_loader.cpp:1175-1260; the JAX package's
        io/dataset_core.py:742-818, draw for draw): each rank samples
        its share of ``bin_construct_sample_cnt``, proportional to its
        rows, from ``default_rng(data_random_seed + rank)``; the world's
        summaries are all-gathered; each rank finds the bins of its
        feature slice over the merged summaries; the mappers are
        all-gathered. When the sample covers every row the mappers are
        serial binning's bit for bit. ``stats`` receives each step's
        host seconds and the wire bytes."""
        import time

        from ..distributed import allgather_bytes, feature_slice
        stats = {} if stats is None else stats
        t = time.perf_counter()
        num_data, num_features = source.num_data, source.num_features
        total_rows = int(row_counts.sum())
        want = min(config.bin_construct_sample_cnt, total_rows)
        if want >= total_rows:
            sample_indices = np.arange(num_data)
        else:
            cnt_r = min(num_data,
                        max(1, int(round(want * num_data
                                         / max(total_rows, 1)))))
            rng = np.random.default_rng(config.data_random_seed + rank)
            sample_indices = np.sort(rng.choice(
                num_data, size=cnt_r, replace=False))
        summaries = [FeatureSampleSummary.from_sample(
            source.get_col_sample(f, sample_indices))
            for f in range(num_features)]
        blob = serialize_summaries(summaries)
        stats["sample_s"] = time.perf_counter() - t
        t = time.perf_counter()
        world_blobs = allgather_bytes(
            blob, what="sharded bin finding: sample summaries")
        stats["summary_gather_s"] = time.perf_counter() - t
        stats["summary_bytes"] = sum(len(b) for b in world_blobs)
        t = time.perf_counter()
        world_summaries = [deserialize_summaries(b) for b in world_blobs]
        total_sample = (sum(ws[0].n_rows for ws in world_summaries)
                        if num_features else len(sample_indices))
        cat_set = set(int(c) for c in categorical_features)
        forced_bounds = _load_forced_bounds(config)
        filter_cnt = int(max(
            config.min_data_in_leaf * total_sample / max(total_rows, 1),
            config.min_data_in_bin))
        max_bin_by_feature = config.max_bin_by_feature
        f_lo, f_hi = feature_slice(num_features, rank, world)
        local = []
        for f in range(f_lo, f_hi):
            merged = FeatureSampleSummary.merge(
                [ws[f] for ws in world_summaries])
            mb = (max_bin_by_feature[f] if f < len(max_bin_by_feature)
                  else config.max_bin)
            local.append(BinMapper.find_bin_from_summary(
                merged, total_sample, mb, config.min_data_in_bin,
                filter_cnt, pre_filter=config.feature_pre_filter,
                bin_type=(BIN_CATEGORICAL if f in cat_set
                          else BIN_NUMERICAL),
                use_missing=config.use_missing,
                zero_as_missing=config.zero_as_missing,
                forced_upper_bounds=forced_bounds.get(f, ())))
        blob = serialize_bin_mappers(local)
        stats["find_bin_s"] = time.perf_counter() - t
        t = time.perf_counter()
        blobs = allgather_bytes(
            blob, what="sharded bin finding: BinMapper allgather")
        stats["mapper_gather_s"] = time.perf_counter() - t
        stats["mapper_bytes"] = sum(len(b) for b in blobs)
        mappers = [m for b in blobs for m in deserialize_bin_mappers(b)]
        assert len(mappers) == num_features
        return mappers

    def _store(self, source: ColumnSource, config: Config,
               own_mappers: bool) -> None:
        """Quantize the source (ref: the JAX package's
        io/dataset_core.py:476-533): a sparse source binned with its own
        mappers is stored multi-value under ``tpu_sparse_storage=
        multival``; under ``auto``, when it is sparse (density < 0.25)
        and 32 to 8,192 features wide, a 20,000-row probe is bundled and
        the source goes multi-value where the ``[R, K]`` pairs (8 K bytes
        a row) beat the groups (G bytes a row), else straight into the
        probe's groups. Everything else is the dense row-major matrix."""
        n_used = len(self.used_feature_map)
        mode = str(config.tpu_sparse_storage).lower()
        use_mv, info = False, None
        if isinstance(source, SparseColumns) and own_mappers and n_used >= 2:
            if mode == "multival":
                use_mv = True
            elif mode == "auto":
                use_mv, info = self._auto_sparse_storage(source, config)
        if info is not None:
            from .bundling import pack_sparse_direct
            self.efb_info = info
            self.bins_grouped = pack_sparse_direct(
                source.csc, self.bin_mappers, self.used_feature_map, info)
            log.info(f"sparse source packed directly into {info.num_groups} "
                     f"EFB groups ({n_used} features, [R, G] storage "
                     f"{self.bins_grouped.nbytes >> 20} MB)")
        elif use_mv:
            self.bins_mv = _quantize_sparse(source, self.bin_mappers,
                                            self.used_feature_map)
            log.info(f"multi-value sparse bin storage: {n_used} features, "
                     f"K={self.bins_mv[0].shape[1]} max nonzeros/row")
        else:
            self.bins = _quantize_rowmajor(source, self.bin_mappers,
                                           self.used_feature_map)

    def _auto_sparse_storage(self, source: "SparseColumns", config: Config):
        """(multi-value or not, the probe's BundleInfo to pack into or
        None) of ``tpu_sparse_storage=auto``. K_max, the most stored
        entries of a row, is counted from the CSC's row indices (the
        JAX package converts the whole matrix to CSR for it)."""
        from .bundling import find_bundles
        num_data, csc = self.num_data, source.csc
        n_used = len(self.used_feature_map)
        density = csc.nnz / max(num_data * n_used, 1)
        if not (density < 0.25 and 32 <= n_used <= 8192):
            return False, None
        k_max = 1
        if csc.nnz:
            k_max = int(np.bincount(csc.indices, minlength=num_data).max())
        rs = np.unique(np.linspace(0, num_data - 1, min(num_data, 20_000)
                                   ).astype(np.int64))
        # feature-major, handed over as its row-major [S, F] view
        probe_bins = np.empty((n_used, len(rs)), np.int32)
        for out_i, feat_i in enumerate(self.used_feature_map):
            probe_bins[out_i] = self.bin_mappers[feat_i].value_to_bin(
                source.get_col_sample(feat_i, rs))
        nb_used = np.asarray([self.bin_mappers[i].num_bin
                              for i in self.used_feature_map], np.int64)
        probe = (find_bundles(probe_bins.T, nb_used,
                              config.max_conflict_rate)
                 if config.enable_bundle else None)
        G = probe.num_groups if probe is not None else n_used
        use_mv = 8 * max(k_max, 1) < G
        return use_mv, None if use_mv else probe

    def ensure_logical_bins(self) -> Optional[np.ndarray]:
        """The logical row-major ``[R, F]`` bins, decoded from the group
        columns or the multi-value pairs when the source was stored so
        (ref: the JAX package's io/dataset_core.py:916-942): exact but on
        EFB conflict rows, where the overwritten feature reads its
        default bin, as training saw it. For the rare consumers (the
        traversal replays, dataset merging, binary export); training
        reads the stored layout."""
        if self.bins is not None:
            return self.bins
        F = len(self.used_feature_map)
        nb = [self.bin_mappers[i].num_bin for i in self.used_feature_map]
        dtype = np.uint8 if max(nb, default=2) <= 256 else np.uint16
        if self.bins_grouped is not None:
            info = self.efb_info
            out = np.empty((self.num_data, F), dtype)
            for fi in range(F):
                off, d = int(info.offset[fi]), int(info.default_bin[fi])
                rel = (self.bins_grouped[:, int(info.group[fi])]
                       .astype(np.int64) - off)
                act = (rel >= 0) & (rel < int(info.num_bin[fi]) - 1)
                out[:, fi] = np.where(act, rel + (rel >= d), d)
            self.bins = out
        elif self.bins_mv is not None:
            from ..ops.hist_multival import densify
            dflt = [self.bin_mappers[i].default_bin
                    for i in self.used_feature_map]
            self.bins = densify(*self.bins_mv, np.asarray(dflt), dtype)
        return self.bins

    @staticmethod
    def _find_bin_mappers(source: ColumnSource, config: Config,
                          categorical_features: Sequence[int] = (),
                          total_rows: Optional[int] = None
                          ) -> List[BinMapper]:
        """Sample rows and find per-feature bin boundaries (ref:
        dataset_loader.cpp:1080 ConstructBinMappersFromTextData).
        ``total_rows`` is the population's size when ``source`` holds a
        sample drawn from more rows (``io/sequence.py``)."""
        num_data, num_features = source.num_data, source.num_features
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
            / max(num_data if total_rows is None else total_rows, 1),
            config.min_data_in_bin))
        max_bin_by_feature = config.max_bin_by_feature
        cat_set = set(int(c) for c in categorical_features)
        forced_bounds = _load_forced_bounds(config)
        # distributed bin finding (ref: dataset_loader.cpp:1175-1219; the
        # JAX package's io/dataset_core.py:850-870): in a world, without
        # pre_partition, each rank bins its feature slice of the same
        # sample and the mappers are all-gathered, so each feature is
        # binned once in the world and the mappers are serial binning's
        from ..distributed import (allgather_bytes, feature_slice,
                                   num_processes, process_index)
        rank, world = 0, 1
        if not config.pre_partition:
            rank, world = process_index(), num_processes()
        f_lo, f_hi = feature_slice(num_features, rank, world)
        mappers = []
        for f in range(f_lo, f_hi):
            col = source.get_col_sample(f, sample_indices)
            mb = (max_bin_by_feature[f] if f < len(max_bin_by_feature)
                  else config.max_bin)
            mappers.append(BinMapper.find_bin(
                col, len(sample_indices), mb, config.min_data_in_bin,
                filter_cnt, pre_filter=config.feature_pre_filter,
                bin_type=BIN_CATEGORICAL if f in cat_set else BIN_NUMERICAL,
                use_missing=config.use_missing,
                zero_as_missing=config.zero_as_missing,
                forced_upper_bounds=forced_bounds.get(f, ())))
        if world > 1:
            blobs = allgather_bytes(
                serialize_bin_mappers(mappers),
                what="distributed bin finding: BinMapper allgather")
            mappers = [m for b in blobs for m in deserialize_bin_mappers(b)]
            assert len(mappers) == num_features
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
        if self.shard is not None:
            log.fatal("subsets (Dataset.subset, cv folds) of a "
                      "sharded-ingest dataset are not supported: it holds "
                      "one rank's rows of the table")
        row_indices = np.asarray(row_indices, dtype=np.int64)
        out = BinnedDataset()
        if self.bins is not None:
            out.bins = self.bins[row_indices]
        if self.bins_grouped is not None:
            out.bins_grouped = self.bins_grouped[row_indices]
            out.efb_info = self.efb_info
        if self.bins_mv is not None:
            out.bins_mv = tuple(a[row_indices] for a in self.bins_mv)
        out.bin_mappers = self.bin_mappers
        out.used_feature_map = self.used_feature_map
        out.num_data = len(row_indices)
        out.num_total_features = self.num_total_features
        out.feature_names = self.feature_names
        out.max_bin = self.max_bin
        out.raw = self.raw[row_indices] if self.raw is not None else None
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


def _load_forced_bounds(config: Config) -> Dict[int, List[float]]:
    """User-forced bin upper bounds by ORIGINAL feature (ref: config
    forcedbins_filename, dataset_loader.cpp GetForcedBins; the JAX
    package's io/dataset_core.py:128-144): the JSON list
    ``[{"feature": i, "bin_upper_bound": [...]}, ...]``."""
    forced_bounds: Dict[int, List[float]] = {}
    if config.forcedbins_filename:
        import json
        try:
            with open(config.forcedbins_filename) as fh:
                for entry in json.load(fh):
                    forced_bounds[int(entry["feature"])] = [
                        float(v) for v in entry["bin_upper_bound"]]
        except (OSError, ValueError, KeyError, TypeError,
                IndexError) as e:
            log.fatal(f"could not read forcedbins_filename="
                      f"{config.forcedbins_filename}: {e}")
    return forced_bounds


def _quantize_sparse(source: SparseColumns, bin_mappers: List[BinMapper],
                     used_feature_map: np.ndarray) -> tuple:
    """Bin only the stored entries of a sparse source into the host
    multi-value ``(idx, binv)`` int32 ``[R, K]`` pair over used features
    (ref: sparse_bin.hpp Push, multi_val_sparse_bin.hpp; the JAX
    package's io/dataset_core.py:709-739): an absent entry is its
    feature's default bin, rebuilt at scan time. The used columns' bins
    (+1, so that a zero bin stays stored) become a CSC matrix whose
    conversion to CSR puts each row's entries in ascending feature
    order, the order of the JAX package's COO -> CSR -> pack."""
    import scipy.sparse as sp
    from ..ops.hist_multival import pack_csr_bins
    csc = source.csc
    used = np.asarray(used_feature_map)
    if len(used) != csc.shape[1] or not np.array_equal(
            used, np.arange(len(used))):
        csc = csc[:, used]
    data = np.empty(csc.nnz, np.int32)
    for out_i, feat_i in enumerate(used):
        lo, hi = csc.indptr[out_i], csc.indptr[out_i + 1]
        data[lo:hi] = bin_mappers[feat_i].value_to_bin(
            np.asarray(csc.data[lo:hi], np.float64)) + 1
    csr = sp.csc_matrix((data, csc.indices, csc.indptr),
                        shape=csc.shape).tocsr()
    csr.data -= 1
    return pack_csr_bins(csr)


def _quantize_rowmajor(source: ColumnSource, bin_mappers: List[BinMapper],
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
    if isinstance(source, SparseColumns):
        # feature-major, each column its zero bin with the stored entries
        # binned over it, then one transpose
        csc, zero = source.csc, np.zeros(1)
        bins = np.empty((len(used_feature_map), source.num_data), dtype)
        for out_i, feat_i in enumerate(used_feature_map):
            m = bin_mappers[feat_i]
            lo, hi = csc.indptr[feat_i], csc.indptr[feat_i + 1]
            bins[out_i] = m.value_to_bin(zero)[0]
            bins[out_i, csc.indices[lo:hi]] = m.value_to_bin(
                np.asarray(csc.data[lo:hi], np.float64))
        return np.ascontiguousarray(bins.T)
    bins = np.empty((source.num_data, len(used_feature_map)), dtype)
    for out_i, feat_i in enumerate(used_feature_map):
        bins[:, out_i] = bin_mappers[feat_i].value_to_bin(
            source.get_col(feat_i))
    return bins
