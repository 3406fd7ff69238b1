"""Text chunk parsers of the file loaders, in numpy.

Copy of the numpy halves of ``lightgbm_tpu/native/__init__.py``
(``parse_dense_chunk`` :112, ``parse_libsvm_chunk`` :139,
``iter_file_chunks`` :192) for the two-round loader and the stream
follower (``io/stream_loader.py``). The JAX package runs a C++ parser
behind the same names when it can build one; here the numpy body is the
only one (ROADMAP A16 adds the C++ parser). The token rules are the JAX
package's: ``na``, ``nan``, ``null``, ``?`` and blanks parse to NaN, a
token that is not a number gives NaN, blank lines are skipped, and in
LibSVM ``qid:`` and other tokens that are not ``index:value`` are
skipped.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

_NAN_TOKENS = ("na", "nan", "null", "?")


def _parse_token(tok: str) -> float:
    tok = tok.strip()
    if tok == "" or tok.lower() in _NAN_TOKENS:
        return np.nan
    try:
        return float(tok)
    except ValueError:
        return np.nan


def parse_dense_chunk(chunk: bytes, sep: str, n_cols: int) -> np.ndarray:
    """Parse a newline-aligned CSV/TSV byte chunk -> float64 [rows, n_cols]
    (a short line's missing columns are NaN, a long line's extra ones
    dropped)."""
    rows = [ln for ln in chunk.decode("utf-8", "replace").split("\n")
            if ln.strip()]
    out = np.full((len(rows), n_cols), np.nan)
    for i, ln in enumerate(rows):
        toks = ln.split(sep)[:n_cols]
        try:
            # every token a number: float() strips blanks and reads
            # "nan" as NaN, so this is the token rule's own answer
            vals = [float(t) for t in toks]
        except ValueError:
            vals = [_parse_token(t) for t in toks]
        out[i, :len(vals)] = vals
    return out


def parse_libsvm_chunk(chunk: bytes) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray, np.ndarray, int]:
    """Parse a LibSVM byte chunk -> (labels, rows, cols, vals, max_col)."""
    lines = [ln for ln in chunk.decode("utf-8", "replace").split("\n")
             if ln.strip()]
    labels = np.zeros(len(lines))
    r_l, c_l, v_l = [], [], []
    max_col = -1
    for i, ln in enumerate(lines):
        toks = ln.split()
        if toks:
            try:
                labels[i] = float(toks[0])
            except ValueError:
                labels[i] = np.nan
        for t in toks[1:]:
            if ":" not in t:
                continue
            k, _, v = t.partition(":")
            try:
                idx = int(k)
                val = float(v)
            except ValueError:
                continue
            r_l.append(i)
            c_l.append(idx)
            v_l.append(val)
            max_col = max(max_col, idx)
    return (labels, np.asarray(r_l, np.int32), np.asarray(c_l, np.int32),
            np.asarray(v_l, np.float64), max_col)


def iter_file_chunks(path: str, skip_lines: int = 0,
                     chunk_bytes: int = 32 << 20) -> Iterator[bytes]:
    """Yield newline-aligned byte chunks of a text file."""
    with open(path, "rb") as f:
        for _ in range(skip_lines):
            f.readline()
        carry = b""
        while True:
            block = f.read(chunk_bytes)
            if not block:
                if carry.strip():
                    yield carry
                return
            block = carry + block
            cut = block.rfind(b"\n")
            if cut < 0:
                carry = block
                continue
            yield block[:cut + 1]
            carry = block[cut + 1:]
