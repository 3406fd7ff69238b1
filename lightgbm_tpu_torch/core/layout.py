"""How the growers read the stored bin columns.

The split scan, ``FeatureMeta``, ``TreeArrays`` and the model text are
LOGICAL (one column per used feature); what the histogram kernels read
may be physical:

- ``DenseLayout``: one stored column per logical feature;
- ``BundleLayout``: EFB groups (``io/bundling.py``): histograms are
  ``[G, B, 3]`` over the group columns, expanded to ``[F, B, 3]`` with
  the node's totals before the scan, and a partition decodes the split
  feature's group column (ref: the JAX package's core/grower.py:504-540,
  719-738; core/level_grower.py:416-421, 462-468);
- ``MultivalLayout``: multi-value ``[R, K]`` pairs
  (``ops/hist_multival.py``): histograms hold the stored entries only,
  each default bin rebuilt from the totals, and a partition reads the
  split feature's bin of each row (the JAX package's models/gbdt.py
  922-941, 1259-1270).

Each gives ``fix(hist [..., Fp, B, 3] f32, totals [..., 3]) -> [..., F,
B, 3]`` (applied after ``conv``, as the JAX growers apply it), and the
logical int64 bin column of one feature over a leaf's rows
(``column``), or of each row's own feature (``rows_column``, the level
grower's partition).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..io.bundling import BundleInfo, decode_logical_bin, make_expand_hist
from ..ops.hist_multival import (SparseBins, fetch_bin_column,
                                 hist_multival, make_default_bin_fix)
from ..ops.histogram import bin_ids


class DenseLayout:
    """Bins ``[R, F]`` (compact, level) or ``[F, R]`` (full)."""

    def __init__(self, full: bool = False):
        self.full = full

    def fix(self, hist: torch.Tensor, totals: torch.Tensor) -> torch.Tensor:
        return hist

    def column(self, bins, rows: Optional[torch.Tensor], f: int
               ) -> torch.Tensor:
        """Feature f's bins over ``rows`` (compact), or over every row
        (full, ``rows`` None)."""
        return bin_ids(bins[f] if self.full else bins[rows, f])

    def rows_column(self, bins_rm: torch.Tensor, f_row: torch.Tensor
                    ) -> torch.Tensor:
        return bin_ids(bins_rm.gather(1, f_row[:, None])[:, 0])


class BundleLayout(DenseLayout):
    """EFB group columns ``[R, G]`` or ``[G, R]``; ``info.gather_map``
    built for the growers' B."""

    def __init__(self, info: BundleInfo, device, full: bool = False):
        super().__init__(full)
        self.expand = make_expand_hist(info, device)
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                         device=device)
        self.group, self.offset, self.num_bin, self.default_bin = (
            as_t(info.group), as_t(info.offset), as_t(info.num_bin),
            as_t(info.default_bin))
        self._host = [np.asarray(a).tolist() for a in (
            info.group, info.offset, info.num_bin, info.default_bin)]

    def fix(self, hist, totals):
        return self.expand(hist, totals)

    def column(self, bins, rows, f):
        g, off, nb, d = (a[f] for a in self._host)
        col = bin_ids(bins[g] if self.full else bins[rows, g])
        return decode_logical_bin(col, off, nb, d)

    def rows_column(self, bins_rm, f_row):
        col = bin_ids(bins_rm.gather(1, self.group[f_row][:, None])[:, 0])
        return decode_logical_bin(col, self.offset[f_row],
                                  self.num_bin[f_row],
                                  self.default_bin[f_row])


class MultivalLayout(DenseLayout):
    """Multi-value ``SparseBins``; ``default_bin`` per used feature."""

    def __init__(self, default_bin: np.ndarray, num_bin: int, device,
                 full: bool = False):
        super().__init__(full)
        self._fix = make_default_bin_fix(default_bin, num_bin, device)
        self._default = np.asarray(default_bin).tolist()

    def fix(self, hist, totals):
        return self._fix(hist, totals)

    def column(self, sb: SparseBins, rows, f):
        if rows is not None:
            sb = sb.index_select(0, rows)
        return fetch_bin_column(sb, f, self._default[f])

    def rows_column(self, bins_rm, f_row):
        raise ValueError("level scheduling does not read multi-value "
                         "storage; the engine trains it compact")


def multival_hist(sb: SparseBins, gh: torch.Tensor, num_bin: int, *,
                  leaf_id=None, leaf=None) -> torch.Tensor:
    """The growers' ``hist_fn`` over multi-value storage: the stored
    entries' histogram, over a leaf's rows when ``leaf_id`` and ``leaf``
    are given (full scheduling). The JAX package masks gh to the leaf and
    adds every row; the rows out of the leaf add zeros, so adding the
    leaf's rows alone, in row order, gives the same sums."""
    if leaf_id is not None:
        rows = torch.nonzero(leaf_id == int(leaf)).squeeze(1)
        sb, gh = sb.index_select(0, rows), gh.index_select(0, rows)
    return hist_multival(sb, gh, num_bin)
