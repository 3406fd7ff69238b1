"""Two-round streaming dataset loading with bounded memory, and the
stream follower of the continual service.

Port of ``lightgbm_tpu/io/stream_loader.py`` (ref:
src/io/dataset_loader.cpp:266 LoadFromFile two_round branch, config
``two_round``): round one streams the file to count rows and collect the
label/weight/group columns plus a row sample for bin finding; round two
streams again and quantizes each chunk straight into the port's
row-major ``[R, F_used]`` bin matrix. Peak memory is O(chunk + sample +
bins): the raw float matrix is never materialized, and the LibSVM path
works from (row, col, value) triplets without densifying a chunk to full
feature width. The chunks parse through ``native/`` (numpy).

``StreamFollower`` tail-follows a growing CSV for the resident trainer
(``service/trainer.py``).
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from ..config import Config
from ..native import iter_file_chunks, parse_dense_chunk, parse_libsvm_chunk
from ..utils import log
from .dataset_core import (BinnedDataset, DenseColumns, Metadata,
                           SparseColumns, categorical_indices)
from .file_loader import (_detect_format, _parse_column_spec,
                          load_position_file, load_side_files)


def _read_head(path: str, n_lines: int = 20) -> List[str]:
    out = []
    with open(path, "rb") as f:
        for _ in range(n_lines):
            ln = f.readline()
            if not ln:
                break
            out.append(ln.decode("utf-8", "replace").rstrip("\n"))
    return out


class _Reservoir:
    """Vectorized Algorithm-R row reservoir (bin-finding sample)."""

    def __init__(self, k: int, n_cols: int, seed: int):
        self.k = k
        self.buf = np.empty((k, n_cols), np.float64)
        self.seen = 0
        self.rng = np.random.default_rng(seed)

    def offer(self, chunk: np.ndarray) -> None:
        m = len(chunk)
        if m == 0:
            return
        take = min(max(self.k - self.seen, 0), m)
        if take:
            self.buf[self.seen:self.seen + take] = chunk[:take]
        if take < m:
            rest = chunk[take:]
            idx = self.seen + take + np.arange(len(rest))
            draws = self.rng.integers(0, idx + 1)
            sel = np.flatnonzero(draws < self.k)
            # sequential overwrite semantics: later rows win
            self.buf[draws[sel]] = rest[sel]
        self.seen += m

    def sample(self) -> np.ndarray:
        return self.buf[:min(self.seen, self.k)]


def _quantize_sparse_chunk(bins: np.ndarray, lo: int, n_chunk_rows: int,
                           r: np.ndarray, c: np.ndarray, v: np.ndarray,
                           used: np.ndarray, mappers,
                           zero_bins: np.ndarray) -> None:
    """Quantize a LibSVM chunk from triplets into rows ``lo..`` of the
    row-major bins: implicit zeros take each feature's precomputed zero
    bin; explicit values are binned per feature (grouped by column —
    O(nnz log nnz), no dense [rows, F] buffer)."""
    bins[lo:lo + n_chunk_rows] = zero_bins[None, :]
    if len(c) == 0:
        return
    order = np.argsort(c, kind="stable")
    cs, rs, vs = c[order], r[order], v[order]
    # used[i] is the original feature id of output column i
    starts = np.searchsorted(cs, used, side="left")
    ends = np.searchsorted(cs, used, side="right")
    for out_i, (fi, s, e) in enumerate(zip(used, starts, ends)):
        if e > s:
            bins[lo + rs[s:e], out_i] = mappers[fi].value_to_bin(
                np.ascontiguousarray(vs[s:e]))


class StreamFollower:
    """Tail-follow a GROWING numeric CSV/TSV file (the continual
    service's ingest cursor, ``service/trainer.py``).

    ``poll()`` reads only the bytes appended since the last call,
    consumes up to the last complete line (a torn trailing line — a
    producer mid-write — is left for the next poll; the producer's own
    append must be a single ``write`` of whole lines), and parses them
    with the chunk parser the two-round path uses. The column count is
    locked from the first complete line.

    Poison rows: a bad complete line (wrong separator count, or parsing
    to an all-NaN row) is quarantined verbatim to a ``<path>.deadletter``
    sidecar, counted in ``rows_skipped`` (the trainer carries the count
    in its freshness watermark), warned about once, and the good rows
    around it still train. Past the skip budget ``max_skips`` the
    follower raises: a stream that is MOSTLY garbage is a config error
    (wrong separator, wrong file), not a few torn writes.

    The cursor state is three numbers — byte ``offset``, ``rows_seen``
    and ``last_row_time`` (host wall clock of the newest ingested row,
    the freshness watermark) — small enough to ride inside a training
    checkpoint.
    """

    def __init__(self, path: str, sep: str = ",",
                 n_cols: Optional[int] = None, max_skips: int = 64):
        self.path = path
        self.sep = sep
        self.n_cols = n_cols
        self.offset = 0
        self.rows_seen = 0
        self.last_row_time: Optional[float] = None
        self.max_skips = int(max_skips)
        self.rows_skipped = 0
        self.deadletter_path = path + ".deadletter"
        self._skip_warned = False

    def _quarantine(self, lines: List[bytes], why: str) -> None:
        """Append poison lines verbatim to the deadletter sidecar and
        charge them to the skip budget (fatal only past budget)."""
        with open(self.deadletter_path, "ab") as f:
            for ln in lines:
                f.write(ln + b"\n")
        self.rows_skipped += len(lines)
        if not self._skip_warned:
            self._skip_warned = True
            log.warning(
                f"stream {self.path}: quarantined {len(lines)} {why} "
                f"line(s) to {self.deadletter_path} (column count "
                f"locked at {self.n_cols}); further skips logged at "
                "info level")
        else:
            log.info(f"stream {self.path}: quarantined {len(lines)} "
                     f"{why} line(s) ({self.rows_skipped} total)")
        if self.rows_skipped > self.max_skips:
            raise ValueError(
                f"stream {self.path}: {self.rows_skipped} poison rows "
                f"exceed the skip budget ({self.max_skips}) — the "
                "stream is malformed (wrong separator or column "
                f"count?); see {self.deadletter_path}")

    def poll(self, max_bytes: int = 64 << 20) -> Optional[np.ndarray]:
        """New complete rows as an [n, n_cols] f64 matrix (None when
        nothing new). Bounded by ``max_bytes`` per call so a huge
        backlog cannot stall the caller's loop indefinitely."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return None
        if size <= self.offset:
            return None
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            blob = f.read(min(size - self.offset, max_bytes))
        nl = blob.rfind(b"\n")
        if nl < 0:
            return None                    # only a torn partial line yet
        blob = blob[:nl + 1]
        if self.n_cols is None:
            first = blob.split(b"\n", 1)[0]
            self.n_cols = first.decode("utf-8", "replace").count(
                self.sep) + 1
        # structural guard before parsing: every complete line must carry
        # exactly n_cols-1 separators. The aggregate count catches a
        # ragged line (a non-atomic producer write) that would otherwise
        # parse with NaN tail columns and train as missing values; only
        # then is each line scanned to quarantine the offenders.
        n_lines = blob.count(b"\n")
        want = self.n_cols - 1
        sep_b = self.sep.encode()
        if blob.count(sep_b) != n_lines * want:
            lines = blob.split(b"\n")[:n_lines]
            good = [ln for ln in lines if ln.count(sep_b) == want]
            self._quarantine(
                [ln for ln in lines if ln.count(sep_b) != want],
                "ragged")
            if not good:
                self.offset += nl + 1
                return None
            blob = b"\n".join(good) + b"\n"
        mat = parse_dense_chunk(blob, self.sep, self.n_cols)
        bad = np.isnan(mat).all(axis=1)
        if bad.any():
            lines = blob.split(b"\n")
            self._quarantine(
                [lines[i] for i in np.flatnonzero(bad)], "unparseable")
            mat = mat[~bad]
        self.offset += nl + 1
        self.rows_seen += len(mat)
        if len(mat) == 0:
            return None
        self.last_row_time = time.time()
        return mat


def load_binned_two_round(path: str, config: Config,
                          categorical_feature=None,
                          reference: Optional[BinnedDataset] = None,
                          chunk_bytes: int = 32 << 20) -> BinnedDataset:
    """Stream ``path`` and return a fully binned dataset.

    ``reference`` reuses an existing dataset's bin mappers (validation
    data must live in the training set's bin space, ref:
    Dataset::CreateValid). ``ingest_stats`` holds each round's host
    seconds (``round1_s``, ``find_bins_s``, ``round2_s``).
    """
    if not os.path.exists(path):
        log.fatal(f"Data file {path} does not exist")
    head = _read_head(path)
    if not head:
        log.fatal(f"Data file {path} is empty")
    fmt = _detect_format(head)
    header_names: Optional[List[str]] = None
    skip = 0
    sep = "," if fmt == "csv" else "\t"
    if config.header and fmt in ("csv", "tsv"):
        header_names = [t.strip() for t in head[0].split(sep)]
        skip = 1
    if fmt in ("csv", "tsv") and len(head) <= skip:
        log.fatal(f"Data file {path} has no data rows")

    label_col = _parse_column_spec(config.label_column or "0", header_names)
    weight_col = (_parse_column_spec(config.weight_column, header_names)
                  if config.weight_column else -1)
    group_col = (_parse_column_spec(config.group_column, header_names)
                 if config.group_column else -1)
    ignore_cols = set()
    if config.ignore_column:
        for c in str(config.ignore_column).split(","):
            if c.strip():
                ignore_cols.add(_parse_column_spec(c.strip(), header_names))

    sample_cnt = int(config.bin_construct_sample_cnt)
    seed = int(config.data_random_seed)
    if config.linear_tree:
        log.fatal("linear_tree requires in-memory loading; "
                  "set two_round=false")
    t_start = time.perf_counter()

    if fmt == "libsvm":
        # LibSVM's width is data-dependent: one extra streaming pass
        # resolves (labels, row count, max feature id); the sample is then
        # collected as TRIPLETS of pre-drawn rows — never densified
        y_parts = []
        max_col = -1
        n_rows = 0
        for chunk in iter_file_chunks(path, skip, chunk_bytes):
            lab, _r, _c, _v, mc = parse_libsvm_chunk(chunk)
            max_col = max(max_col, mc)
            y_parts.append(lab)
            n_rows += len(lab)
        if n_rows == 0:
            log.fatal(f"Data file {path} has no data rows")
        F = max_col + 1
        y = np.concatenate(y_parts)
        k = min(sample_cnt, n_rows)
        rng = np.random.default_rng(seed)
        sample_rows = (np.sort(rng.choice(n_rows, size=k, replace=False))
                       if k < n_rows else np.arange(n_rows))
        s_r, s_c, s_v = [], [], []
        base = 0
        for chunk in iter_file_chunks(path, skip, chunk_bytes):
            lab, r, c, v, _ = parse_libsvm_chunk(chunk)
            g = base + r.astype(np.int64)           # global row ids
            pos = np.searchsorted(sample_rows, g)
            ok = pos < len(sample_rows)
            hit = ok & (sample_rows[np.minimum(pos, len(sample_rows) - 1)]
                        == g)
            s_r.append(pos[hit])
            s_c.append(c[hit])
            s_v.append(v[hit])
            base += len(lab)
        import scipy.sparse as sp
        sample_mat = sp.csc_matrix(
            (np.concatenate(s_v) if s_v else np.zeros(0),
             (np.concatenate(s_r) if s_r else np.zeros(0, np.int64),
              np.concatenate(s_c) if s_c else np.zeros(0, np.int64))),
            shape=(len(sample_rows), F))
        sample_source = SparseColumns(sample_mat)
        feat_cols = list(range(F))
        weight = None
        group_raw = None
        n_cols = 0
    else:
        n_cols = len(head[skip].split(sep))
        drop = {label_col} | ignore_cols
        if weight_col >= 0:
            drop.add(weight_col)
        if group_col >= 0:
            drop.add(group_col)
        feat_cols = [j for j in range(n_cols) if j not in drop]
        F = len(feat_cols)
        # ---- round 1: count/labels/metadata + reservoir sample ---------
        y_parts, w_parts, g_parts = [], [], []
        n_rows = 0
        res = _Reservoir(sample_cnt, F, seed)
        for chunk in iter_file_chunks(path, skip, chunk_bytes):
            mat = parse_dense_chunk(chunk, sep, n_cols)
            n_rows += len(mat)
            y_parts.append(mat[:, label_col].copy())
            if weight_col >= 0:
                w_parts.append(mat[:, weight_col].copy())
            if group_col >= 0:
                g_parts.append(mat[:, group_col].copy())
            res.offer(mat[:, feat_cols])
        if n_rows == 0:
            log.fatal(f"Data file {path} has no data rows")
        y = np.concatenate(y_parts)
        weight = np.concatenate(w_parts) if w_parts else None
        group_raw = np.concatenate(g_parts) if g_parts else None
        sample_source = DenseColumns(res.sample())

    feature_names = None
    if header_names is not None:
        feature_names = [header_names[j] for j in feat_cols]

    # ---- bin mappers (fresh from the sample, or the reference's) -------
    t_round1 = time.perf_counter()
    if reference is not None:
        mappers = reference.bin_mappers
        used = reference.used_feature_map
        feature_names = reference.feature_names
        if len(mappers) != F:
            log.fatal(f"Validation file {path} has {F} features but the "
                      f"reference dataset has {len(mappers)}")
    else:
        cats = categorical_indices(categorical_feature, config,
                                   feature_names)
        mappers = BinnedDataset._find_bin_mappers(
            sample_source, config, cats, total_rows=n_rows)
        used = np.asarray(
            [i for i, m in enumerate(mappers) if not m.is_trivial],
            np.int32)

    max_num_bin = max((mappers[i].num_bin for i in used), default=2)
    dtype = np.uint8 if max_num_bin <= 256 else np.uint16
    # multi-value sparse storage straight from the stream (explicit
    # tpu_sparse_storage=multival): only stored nonzeros are binned and
    # kept as triplets — the dense [R, F] bin matrix is never allocated
    use_mv = (fmt == "libsvm" and reference is None and
              str(config.tpu_sparse_storage).lower() == "multival" and
              len(used) >= 2)
    bins = None if use_mv else np.empty((n_rows, len(used)), dtype)

    # ---- round 2: quantize chunk-by-chunk ------------------------------
    t_bins = time.perf_counter()
    lo = 0
    if use_mv:
        bins_mv = _stream_multival(path, skip, chunk_bytes, F, used,
                                   mappers, n_rows)
    elif fmt == "libsvm":
        zero_bins = np.asarray(
            [mappers[fi].value_to_bin(np.zeros(1))[0] for fi in used],
            dtype)
        for chunk in iter_file_chunks(path, skip, chunk_bytes):
            lab, r, c, v, _ = parse_libsvm_chunk(chunk)
            keep = c < F
            _quantize_sparse_chunk(bins, lo, len(lab), r[keep], c[keep],
                                   v[keep], used, mappers, zero_bins)
            lo += len(lab)
    else:
        for chunk in iter_file_chunks(path, skip, chunk_bytes):
            mat = parse_dense_chunk(chunk, sep, n_cols)
            feat = mat[:, feat_cols]
            hi = lo + len(feat)
            for out_i, fi in enumerate(used):
                bins[lo:hi, out_i] = mappers[fi].value_to_bin(
                    np.ascontiguousarray(feat[:, fi], np.float64))
            lo = hi

    ds = BinnedDataset()
    t_end = time.perf_counter()
    ds.ingest_stats = {"round1_s": t_round1 - t_start,
                       "find_bins_s": t_bins - t_round1,
                       "round2_s": t_end - t_bins}
    ds.num_data = n_rows
    ds.num_total_features = F
    ds.max_bin = config.max_bin if reference is None else reference.max_bin
    ds.bin_mappers = mappers
    ds.used_feature_map = used
    ds.bins = bins
    if use_mv:
        ds.bins_mv = bins_mv
    ds.feature_names = (feature_names if feature_names
                        else [f"Column_{i}" for i in range(F)])

    # ---- metadata + side files (shared helper) -------------------------
    meta = Metadata(n_rows)
    meta.set_label(y.astype(np.float32))
    weight, group = load_side_files(path, weight, group_raw)
    if weight is not None:
        meta.set_weight(weight)
    if group is not None:
        meta.set_query(group)
    pos = load_position_file(path)
    if pos is not None:
        meta.set_position(pos)
    ds.metadata = meta
    return ds


def _stream_multival(path: str, skip: int, chunk_bytes: int, F: int,
                     used: np.ndarray, mappers, n_rows: int) -> tuple:
    """Round two of a LibSVM file under ``tpu_sparse_storage=multival``:
    the stored entries of each chunk binned per used feature, then packed
    into the multi-value ``(idx, binv)`` int32 ``[R, K]`` pair."""
    import scipy.sparse as sp
    from ..ops.hist_multival import pack_csr_bins
    inv = np.full(F, -1, np.int64)
    inv[used] = np.arange(len(used))
    mv_r, mv_c, mv_b = [], [], []
    lo = 0
    for chunk in iter_file_chunks(path, skip, chunk_bytes):
        lab, r, c, v, _ = parse_libsvm_chunk(chunk)
        keep = c < F
        r, c, v = r[keep], c[keep], v[keep]
        cu = inv[c]
        keep2 = cu >= 0
        r, cu, v = r[keep2], cu[keep2], v[keep2]
        if len(cu):
            order = np.argsort(cu, kind="stable")
            cs, rs, vs = cu[order], r[order], v[order]
            b = np.empty(len(cs), np.int32)
            starts = np.searchsorted(cs, np.arange(len(used)), "left")
            ends = np.searchsorted(cs, np.arange(len(used)), "right")
            for out_i, (s, e) in enumerate(zip(starts, ends)):
                if e > s:
                    b[s:e] = mappers[used[out_i]].value_to_bin(
                        np.ascontiguousarray(vs[s:e]))
            mv_r.append(lo + rs.astype(np.int64))
            mv_c.append(cs)
            mv_b.append(b)
        lo += len(lab)
    rr = np.concatenate(mv_r) if mv_r else np.zeros(0, np.int64)
    cc = np.concatenate(mv_c) if mv_c else np.zeros(0, np.int64)
    bb = np.concatenate(mv_b) if mv_b else np.zeros(0, np.int32)
    if len(rr):
        # duplicate feature ids on one LibSVM line: keep the LAST value,
        # matching the dense path's overwrite (coo.tocsr() would SUM them
        # into out-of-range bins)
        key = rr * len(used) + cc
        _, first_rev = np.unique(key[::-1], return_index=True)
        keep = len(key) - 1 - first_rev
        rr, cc, bb = rr[keep], cc[keep], bb[keep]
    coo = sp.coo_matrix((bb + 1, (rr, cc)), shape=(n_rows, len(used)))
    csr = coo.tocsr()
    csr.data -= 1          # undo the keep-explicit-zero offset
    bins_mv = pack_csr_bins(csr)
    log.info(f"multi-value sparse bin storage from stream: {len(used)} "
             f"features, K={bins_mv[0].shape[1]} max nonzeros/row")
    return bins_mv
