"""Sequence: batched random-access row input for Dataset building.

Port of ``lightgbm_tpu/io/sequence.py`` (ref:
python-package/lightgbm/basic.py:841 ``lightgbm.Sequence``): a
user-defined row source (an HDF5 file, a memory-mapped store, a sharded
array) feeds Dataset construction without the whole matrix in memory:

- bin finding samples rows by RANDOM ACCESS (``seq[idx]``), so the
  sample never touches most of the data;
- quantization streams RANGE reads (``seq[a:b]``) of ``batch_size`` rows
  into the bin matrix, built feature-major and transposed once to the
  port's row-major ``[R, F]``.

Peak memory is the sample, one batch and the bins.
"""
from __future__ import annotations

import abc
from typing import List, Optional, Sequence as _Seq, Union

import numpy as np

from ..config import Config
from ..utils import log
from .dataset_core import BinnedDataset, DenseColumns, Metadata


class Sequence(abc.ABC):
    """Generic row access (subclass it, implement ``__getitem__`` and
    ``__len__``, and optionally set ``batch_size``)."""

    batch_size = 4096

    @abc.abstractmethod
    def __getitem__(self, idx: Union[int, slice, List[int]]) -> np.ndarray:
        """Row(s) for an int index, a slice or a list of indices."""

    @abc.abstractmethod
    def __len__(self) -> int:
        """Total row count."""


def _seq_rows(seq: Sequence, idx: np.ndarray) -> np.ndarray:
    """Random-access rows as a ``[len(idx), F]`` float64 matrix."""
    try:
        block = seq[list(int(i) for i in idx)]
    except (TypeError, IndexError, KeyError):
        block = np.stack([np.asarray(seq[int(i)]) for i in idx])
    block = np.asarray(block, np.float64)
    return block[None, :] if block.ndim == 1 else block


def build_from_sequences(seqs: _Seq[Sequence], config: Config,
                         categorical_features=(),
                         reference: Optional[BinnedDataset] = None,
                         feature_names=None) -> BinnedDataset:
    """A binned dataset of one or more Sequences, their rows concatenated
    in order (ref: basic.py __init_from_seqs). With ``reference`` the
    rows are binned with its mappers (a validation set)."""
    if config.linear_tree:
        log.fatal("linear_tree requires in-memory data; Sequences are "
                  "streamed")
    counts = [len(s) for s in seqs]
    n_rows = int(sum(counts))
    if n_rows == 0:
        log.fatal("Cannot build a Dataset from empty Sequences")
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    first = next(s for s, c in zip(seqs, counts) if c > 0)
    F = int(np.asarray(first[0]).reshape(-1).shape[0])

    # ---- bin finding from a random-access row sample --------------------
    if reference is not None:
        mappers = reference.bin_mappers
        used = reference.used_feature_map
    else:
        sample_cnt = min(int(config.bin_construct_sample_cnt), n_rows)
        rng = np.random.default_rng(int(config.data_random_seed))
        sample_idx = (np.sort(rng.choice(n_rows, size=sample_cnt,
                                         replace=False))
                      if sample_cnt < n_rows else np.arange(n_rows))
        parts = []
        for si, seq in enumerate(seqs):
            lo, hi = starts[si], starts[si + 1]
            local = sample_idx[(sample_idx >= lo) & (sample_idx < hi)] - lo
            if len(local):
                parts.append(_seq_rows(seq, local))
        sample = (np.concatenate(parts) if parts
                  else np.zeros((0, F), np.float64))
        mappers = BinnedDataset._find_bin_mappers(
            DenseColumns(sample), config, categorical_features,
            total_rows=n_rows)
        used = np.asarray([i for i, m in enumerate(mappers)
                           if not m.is_trivial], np.int32)

    max_num_bin = max((mappers[i].num_bin for i in used), default=2)
    dtype = np.uint8 if max_num_bin <= 256 else np.uint16
    bins = np.empty((len(used), n_rows), dtype)

    # ---- quantize: range reads, batch by batch --------------------------
    for si, seq in enumerate(seqs):
        base = int(starts[si])
        bs = max(int(getattr(seq, "batch_size", 4096) or 4096), 1)
        for lo in range(0, len(seq), bs):
            hi = min(lo + bs, len(seq))
            block = np.asarray(seq[lo:hi], np.float64)
            if block.ndim == 1:
                block = block[None, :]
            for out_i, fi in enumerate(used):
                bins[out_i, base + lo:base + hi] = mappers[fi].value_to_bin(
                    np.ascontiguousarray(block[:, fi]))

    ds = BinnedDataset()
    ds.num_data = n_rows
    ds.num_total_features = F
    ds.max_bin = config.max_bin if reference is None else reference.max_bin
    ds.bin_mappers = mappers
    ds.used_feature_map = used
    ds.bins = np.ascontiguousarray(bins.T)
    if reference is not None:
        ds.feature_names = list(reference.feature_names)
    elif feature_names:
        if len(feature_names) != F:
            log.fatal(f"Length of feature names ({len(feature_names)}) "
                      f"does not equal the number of features ({F})")
        ds.feature_names = list(feature_names)
    else:
        ds.feature_names = [f"Column_{i}" for i in range(F)]
    ds.metadata = Metadata(n_rows)
    return ds
