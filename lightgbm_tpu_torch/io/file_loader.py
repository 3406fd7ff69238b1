"""Text data file loading: CSV / TSV / LibSVM with format auto-detection.

Copy of the dense path of ``lightgbm_tpu/io/file_loader.py`` (ref:
src/io/parser.cpp:319 CSVParser/TSVParser/LibSVMParser with GetDataType
auto-detection; label/weight/group columns as config.h label_column
etc.; side files as metadata.cpp Metadata::Init), with its parser
plugins (``register_parser``) and the rank slices of sharded ingestion:
a ``{rank}`` placeholder names each rank's own file, else each rank
parses its contiguous slice of one shared file (the JAX package's
io/file_loader.py:44-233).
"""
from __future__ import annotations

import os
import zlib
from typing import List, Optional, Tuple

import numpy as np

from ..config import Config
from ..utils import log


def _detect_format(sample_lines: List[str]) -> str:
    """ref: parser.cpp GetDataType auto-detection."""
    for ln in sample_lines:
        if not ln.strip():
            continue
        tokens = ln.replace("\t", " ").split()
        if any(":" in t for t in tokens[1:]):
            return "libsvm"
        if "\t" in ln:
            return "tsv"
        if "," in ln:
            return "csv"
    return "csv"


def _parse_column_spec(spec: str, header_names: Optional[List[str]]) -> int:
    """Parse 'name:...' or integer column spec (ref: config.h label_column)."""
    if spec.startswith("name:"):
        name = spec[5:]
        if header_names is None or name not in header_names:
            log.fatal(f"Column name {name} not found in header")
        return header_names.index(name)
    return int(spec)


# Custom parser plugins (≡ ParserReflector, ref:
# include/LightGBM/dataset.h:468): a plugin claims a file by its path or
# first lines and parses it itself. register_parser(detect, parse) with
# detect(path, sample_lines) -> bool and parse(lines) -> (X [n, f]
# float, label [n] or None).
_PARSER_PLUGINS: List[Tuple] = []


def register_parser(detect, parse) -> None:
    _PARSER_PLUGINS.append((detect, parse))


def resolve_rank_path(path: str, rank: Optional[int]
                      ) -> Tuple[str, bool]:
    """Per-rank files of sharded ingestion: a ``{rank}`` placeholder in
    the path names each process's own shard file (≡ the reference's
    pre-partitioned per-machine files, docs/Parallel-Learning-Guide.rst).
    Returns the resolved path and whether it was substituted."""
    if rank is not None and "{rank}" in path:
        return path.replace("{rank}", str(rank)), True
    return path, False


def _agree_shared_file(path: str, lines: List[str], start: int) -> None:
    """Row-slicing needs one identical file on every rank: the ranks
    all-gather a sampled CRC32 of its data lines (the JAX package's
    io/file_loader.py:120-145, the same digest) and die loudly when they
    differ, as per-machine files at one path would."""
    from ..distributed import allgather_bytes
    n_all_rows = len(lines) - start
    digest = zlib.crc32(str(n_all_rows).encode())
    step = max(1, n_all_rows // 64)
    for i in range(0, n_all_rows, step):
        digest = zlib.crc32(lines[start + i].encode(), digest)
    got = allgather_bytes(digest.to_bytes(4, "big"),
                          what="shared-file content agreement")
    if any(b != got[0] for b in got):
        log.fatal(
            f"{path}: file contents differ across ranks — this looks "
            "like per-machine pre-partitioned files at the same path. "
            "Row-slice sharding requires one IDENTICAL shared file on "
            "every rank; for per-host files use the '{rank}' placeholder "
            "('data_{rank}.csv') so each process loads its own shard "
            "whole")


def load_svm_or_csv(path: str, config: Config,
                    rank: Optional[int] = None,
                    world: Optional[int] = None,
                    ) -> Tuple[np.ndarray, Optional[np.ndarray],
                               Optional[np.ndarray], Optional[np.ndarray]]:
    """Load a data file -> (X, label, weight, group).

    Also reads LightGBM-convention side files: ``<file>.weight`` and
    ``<file>.query`` / ``<file>.group`` (ref: metadata.cpp
    Metadata::Init).

    Sharded ingestion (``rank`` and ``world`` given): with a ``{rank}``
    placeholder in ``path`` each rank loads its own file; without one
    each rank parses its contiguous slice of the shared file's data
    rows, after the ranks agree on its contents; the column count is
    agreed over the whole file, and a ``.weight`` sidecar must hold one
    entry a data-file row (this rank's are taken). LibSVM files, query
    metadata and parser plugins cannot be row-sliced."""
    path, per_rank_file = resolve_rank_path(path, rank)
    slice_shard = (not per_rank_file and rank is not None
                   and world is not None and world > 1)
    if not os.path.exists(path):
        log.fatal(f"Data file {path} does not exist")
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    lines = [ln for ln in lines if ln.strip() != ""]
    if not lines:
        log.fatal(f"Data file {path} is empty")

    for detect, parse in _PARSER_PLUGINS:
        if detect(path, lines[:20]):
            if slice_shard:
                log.fatal("parser plugins do not support row-slice "
                          "sharding; use per-rank files "
                          "('...{rank}...') instead")
            X, y = parse(lines)
            X = np.asarray(X, np.float64)
            y = None if y is None else np.asarray(y, np.float64)
            weight, group = load_side_files(path, None, None)
            return X, y, weight, group

    fmt = _detect_format(lines[:20])
    header_names: Optional[List[str]] = None
    start = 0
    if config.header and fmt in ("csv", "tsv"):
        sep = "," if fmt == "csv" else "\t"
        header_names = [t.strip() for t in lines[0].split(sep)]
        start = 1

    slice_rows: Optional[Tuple[int, int]] = None
    ncol_floor = 0
    n_all_rows = len(lines) - start
    if slice_shard:
        from ..distributed import row_slice
        _agree_shared_file(path, lines, start)
        lo, hi = row_slice(n_all_rows, rank, world)
        slice_rows = (lo, hi)
        if fmt == "libsvm":
            # a slice's largest feature index is not the file's
            log.fatal("LibSVM files cannot be row-slice sharded (the "
                      "feature count is inferred per slice); use "
                      "per-rank files ('...{rank}...') or CSV/TSV")
        # ragged rows: the column count is agreed over the whole file,
        # not the slice, so the ranks agree on num_features
        sep = "," if fmt == "csv" else "\t"
        ncol_floor = max(ln.count(sep) for ln in lines[start:]) + 1
        lines = lines[:start] + lines[start + lo:start + hi]

    label_spec = config.label_column or "0"
    weight_col = (_parse_column_spec(config.weight_column, header_names)
                  if config.weight_column else -1)
    group_col = (_parse_column_spec(config.group_column, header_names)
                 if config.group_column else -1)
    ignore_cols = set()
    if config.ignore_column:
        for c in str(config.ignore_column).split(","):
            c = c.strip()
            if c:
                ignore_cols.add(_parse_column_spec(c, header_names))

    if fmt == "libsvm":
        X, y = _parse_libsvm(lines[start:])
        weight = None
        group_raw = None
    else:
        sep = "," if fmt == "csv" else "\t"
        rows = [ln.split(sep) for ln in lines[start:]]
        ncol = max([ncol_floor] + [len(r) for r in rows])
        mat = _parse_rows(rows, ncol)
        label_col = _parse_column_spec(label_spec, header_names)
        y = mat[:, label_col].copy()
        drop = {label_col} | ignore_cols
        weight = mat[:, weight_col].copy() if weight_col >= 0 else None
        group_raw = mat[:, group_col].copy() if group_col >= 0 else None
        if weight_col >= 0:
            drop.add(weight_col)
        if group_col >= 0:
            drop.add(group_col)
        keep = [j for j in range(ncol) if j not in drop]
        X = mat[:, keep]

    inline_weight = weight is not None
    weight, group = load_side_files(path, weight, group_raw)
    if slice_rows is not None:
        lo, hi = slice_rows
        if weight is not None and not inline_weight:
            # a full-length sidecar gives this shard's rows; any other
            # length would hand every rank the same weights for other rows
            if len(weight) != n_all_rows:
                log.fatal(
                    f"{path}.weight: sidecar has {len(weight)} entries "
                    f"but the shared data file has {n_all_rows} rows — "
                    "in row-slice sharded mode the sidecar must hold "
                    "exactly one entry per data-file row; for per-shard "
                    "sidecars use per-rank files ('...{rank}...')")
            weight = weight[lo:hi]
        if group is not None:
            log.fatal("query/group metadata cannot be row-slice sharded "
                      "(queries would straddle shard boundaries); use "
                      "per-rank files ('...{rank}...') with per-rank "
                      ".query sidecars")
    return X, y, weight, group


def _parse_rows(rows: List[List[str]], ncol: int) -> np.ndarray:
    """The float matrix of split text rows: an empty, ``na``, ``nan`` or
    ``null`` field, an unparseable one and a missing trailing one are
    NaN. When every row is full and every field a number, one ``float``
    call a field in C gives the same values."""
    if all(len(r) == ncol for r in rows):
        try:
            return np.array(list(map(float, [t for r in rows for t in r])),
                            np.float64).reshape(len(rows), ncol)
        except ValueError:
            pass
    mat = np.full((len(rows), ncol), np.nan)
    for i, r in enumerate(rows):
        for j, tok in enumerate(r):
            tok = tok.strip()
            if tok == "" or tok.lower() in ("na", "nan", "null"):
                continue
            try:
                mat[i, j] = float(tok)
            except ValueError:
                mat[i, j] = np.nan
    return mat


def load_position_file(path: str) -> Optional[np.ndarray]:
    """<data>.position sidecar (ref: metadata.cpp Metadata::Init —
    per-row position ids for lambdarank position bias)."""
    if os.path.exists(path + ".position"):
        return np.loadtxt(path + ".position", dtype=np.int64).reshape(-1)
    return None


def load_side_files(path: str, weight: Optional[np.ndarray],
                    group_raw: Optional[np.ndarray]
                    ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Sidecar metadata files and group-column conversion (ref:
    metadata.cpp Metadata::Init: <data>.weight, <data>.query/.group)."""
    if weight is None and os.path.exists(path + ".weight"):
        weight = np.loadtxt(path + ".weight", dtype=np.float64).reshape(-1)
    group = None
    for ext in (".query", ".group"):
        if os.path.exists(path + ext):
            group = np.loadtxt(path + ext, dtype=np.int64).reshape(-1)
            break
    if group is None and group_raw is not None:
        # group column holds per-row query ids -> run-length counts in ROW
        # order (qids must be contiguous; ref: Metadata::SetQueryId)
        change = np.flatnonzero(group_raw[1:] != group_raw[:-1]) + 1
        starts = np.concatenate([[0], change, [len(group_raw)]])
        group = np.diff(starts)
        if len(np.unique(group_raw)) != len(group):
            log.fatal("Query ids in the group column must be contiguous")
    return weight, group


def _parse_libsvm(lines: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    """ref: parser.cpp LibSVMParser (1-based or 0-based indices accepted)."""
    labels = np.zeros(len(lines))
    pairs: List[List[Tuple[int, float]]] = []
    max_idx = -1
    for i, ln in enumerate(lines):
        toks = ln.split()
        labels[i] = float(toks[0])
        row = []
        for t in toks[1:]:
            if ":" not in t:
                continue
            k, _, v = t.partition(":")
            idx = int(k)
            row.append((idx, float(v)))
            max_idx = max(max_idx, idx)
        pairs.append(row)
    X = np.zeros((len(lines), max_idx + 1))
    for i, row in enumerate(pairs):
        for idx, v in row:
            X[i, idx] = v
    return X, labels
