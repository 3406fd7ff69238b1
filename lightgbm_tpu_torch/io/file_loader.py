"""Text data file loading: CSV / TSV / LibSVM with format auto-detection.

Copy of the dense path of ``lightgbm_tpu/io/file_loader.py`` (ref:
src/io/parser.cpp:319 CSVParser/TSVParser/LibSVMParser with GetDataType
auto-detection; label/weight/group columns as config.h label_column
etc.; side files as metadata.cpp Metadata::Init). One process reads the
whole file: sharded ingestion and parser plugins are not ported.
"""
from __future__ import annotations

import os
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


def load_svm_or_csv(path: str, config: Config
                    ) -> Tuple[np.ndarray, Optional[np.ndarray],
                               Optional[np.ndarray], Optional[np.ndarray]]:
    """Load a data file -> (X, label, weight, group).

    Also reads LightGBM-convention side files: ``<file>.weight`` and
    ``<file>.query`` / ``<file>.group`` (ref: metadata.cpp
    Metadata::Init)."""
    if not os.path.exists(path):
        log.fatal(f"Data file {path} does not exist")
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    lines = [ln for ln in lines if ln.strip() != ""]
    if not lines:
        log.fatal(f"Data file {path} is empty")

    fmt = _detect_format(lines[:20])
    header_names: Optional[List[str]] = None
    start = 0
    if config.header and fmt in ("csv", "tsv"):
        sep = "," if fmt == "csv" else "\t"
        header_names = [t.strip() for t in lines[0].split(sep)]
        start = 1

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
        ncol = max(len(r) for r in rows)
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

    weight, group = load_side_files(path, weight, group_raw)
    return X, y, weight, group


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
