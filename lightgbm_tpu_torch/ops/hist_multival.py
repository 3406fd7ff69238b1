"""Multi-value sparse bin storage and its histogram.

Port of ``lightgbm_tpu/ops/hist_multival.py`` (ref:
src/io/multi_val_sparse_bin.hpp:449, src/io/sparse_bin.hpp:858,
src/treelearner/multi_val_bin_wrapper.cpp): a CSR matrix of bins packs
without loss into two ``[R, K]`` int32 arrays (K = the most stored
entries of a row) of used-feature ids (-1 padding) and bins. An absent
entry is its feature's default bin (the bin of 0.0), never stored: its
histogram row is rebuilt from the leaf totals before the split scan
(``make_default_bin_fix``, the same algebra as EFB's expansion).

The JAX package's histogram is an XLA scatter (``.at[].add``), not a
Pallas kernel, so there is no TPU kernel to port: ``hist_multival`` is
plain torch on both devices. On the CPU it adds every slot's entries in
``[R, K]`` row-major order, the order of XLA's CPU scatter, so the
port's multival trees are the JAX package's bit for bit. On the card it
is the multival route's histogram itself, one ``index_add_`` per stored
column of the ``[R, K]`` arrays (K launches, int32 for int8 gh): a single
``index_add_`` over all ``R * K`` entries would need an ``[R * K, 3]``
copy of gh, 5 GB at 13.2M rows and K = 32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SparseBins(NamedTuple):
    """``idx`` [R, K] used-feature ids (-1 padding) and ``binv`` [R, K]
    bins, int32 tensors; ``num_features`` the used features. The
    compact grower gathers a leaf's rows with ``index_select`` (the JAX
    package's ``take_rows``)."""
    idx: torch.Tensor
    binv: torch.Tensor
    num_features: int

    def index_select(self, dim: int, rows: torch.Tensor) -> "SparseBins":
        assert dim == 0
        return SparseBins(self.idx.index_select(0, rows),
                          self.binv.index_select(0, rows), self.num_features)


def pack_csr_bins(csr_bins):
    """A scipy CSR matrix of BINS (column = used feature) packed into host
    ``(idx, binv)`` int32 ``[R, K]`` arrays, each row's entries in its
    column order."""
    indptr = np.asarray(csr_bins.indptr, np.int64)
    counts = np.diff(indptr)
    K = max(int(counts.max()) if counts.size else 1, 1)
    R = csr_bins.shape[0]
    indices = np.asarray(csr_bins.indices, np.int32)
    data = np.asarray(csr_bins.data, np.int32)
    if (counts == K).all():
        # every row full (one-hot rows): the arrays are the CSR's own
        return indices.reshape(R, K).copy(), data.reshape(R, K).copy()
    idx = np.full((R, K), -1, np.int32)
    binv = np.zeros((R, K), np.int32)
    # each stored entry's flat slot: its row's first slot plus its place
    dest = np.arange(len(indices)) + np.repeat(
        np.arange(R, dtype=np.int64) * K - indptr[:-1], counts)
    idx.reshape(-1)[dest] = indices
    binv.reshape(-1)[dest] = data
    return idx, binv


def hist_multival(sb: SparseBins, gh: torch.Tensor,
                  num_bin: int) -> torch.Tensor:
    """``[F, num_bin, 3]`` histogram of the STORED entries: int32 for int8
    gh (exact), else f32. The default bins' mass is missing here and
    rebuilt from the leaf totals (``make_default_bin_fix``)."""
    F = sb.num_features
    dump = F * num_bin
    acc = torch.int32 if gh.dtype == torch.int8 else torch.float32
    out = torch.zeros(dump + 1, gh.shape[1], dtype=acc, device=gh.device)
    src = gh.to(acc)
    if gh.device.type == "cpu":
        # one scatter over the [R * K] entries in row-major order
        slot = torch.where(sb.idx >= 0, sb.idx * num_bin + sb.binv,
                           dump).long().reshape(-1)
        K = sb.idx.shape[1]
        vals = src.repeat_interleave(K, dim=0)
        out.scatter_add_(0, slot[:, None].expand(-1, gh.shape[1]), vals)
    else:
        for k in range(sb.idx.shape[1]):
            ik = sb.idx[:, k]
            slot = torch.where(ik >= 0, ik * num_bin + sb.binv[:, k], dump)
            out.index_add_(0, slot, src)
    return out[:-1].reshape(F, num_bin, gh.shape[1])


def fetch_bin_column(sb: SparseBins, f: int, default_bin: int
                     ) -> torch.Tensor:
    """Feature ``f``'s int64 bin on every row of ``sb``; a row with no
    stored entry of ``f`` reads ``default_bin`` (ref: SparseBin::
    SplitInner's default routing)."""
    hit = sb.idx == f
    val = torch.where(hit, sb.binv, 0).sum(dim=1)   # at most one hit a row
    return torch.where(hit.any(dim=1), val, default_bin).long()


def make_default_bin_fix(default_bin: np.ndarray, num_bin: int, device):
    """``fix(hist [..., F, B, 3] f32, totals [..., 3])``: each feature's
    default bin given the totals minus the stored mass (ref:
    FixHistogram)."""
    from ..io.bundling import fix_default_bin
    dmask = torch.as_tensor(np.arange(num_bin)[None, :] ==
                            np.asarray(default_bin)[:, None], device=device)
    return lambda hist, totals: fix_default_bin(hist, totals, dmask)


def densify(idx: np.ndarray, binv: np.ndarray, default_bin: np.ndarray,
            dtype) -> np.ndarray:
    """Row-major ``[R, F]`` bins (``dtype``) of the ``[R, K]`` packing:
    the traversal paths' bins, at the dense footprint."""
    R, K = idx.shape
    dense = np.broadcast_to(np.asarray(default_bin, dtype)[None, :],
                            (R, len(default_bin))).copy()
    valid = idx >= 0
    rr = np.repeat(np.arange(R), K)[valid.reshape(-1)]
    dense[rr, idx[valid]] = binv[valid]
    return dense
