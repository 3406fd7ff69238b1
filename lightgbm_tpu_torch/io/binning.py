"""Feature quantization: value -> bin mapping.

Copy of ``lightgbm_tpu/io/binning.py`` for the PyTorch/CUDA port (numpy
only; bin boundaries must stay bit-identical to the JAX package's). The
reference BinMapper
(ref: include/LightGBM/bin.h:86 BinMapper, src/io/bin.cpp:82 GreedyFindBin,
src/io/bin.cpp:247 FindBinWithZeroAsOneBin, src/io/bin.cpp:313 FindBin).

All bin-finding runs host-side in numpy/f64 (it touches only a sample of the
data once); the hot path consumes the resulting uint8/uint16 binned matrix on
the device. Semantics follow the reference:

- zero always separates into its own bin ((-kZeroThreshold, kZeroThreshold]),
- missing handling None / Zero / NaN; NaN gets the last bin,
- greedy equal-count binning with "big count" values pinned to their own bin,
- categorical bins sorted by count descending, bin 0 reserved for NaN/unseen,
- trivial-feature pre-filtering (NeedFilter).
"""
from __future__ import annotations

import math
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ref: include/LightGBM/meta.h:57
kZeroThreshold = 1e-35
# ref: include/LightGBM/bin.h (kSparseThreshold)
kSparseThreshold = 0.8

MISSING_NONE = "none"
MISSING_ZERO = "zero"
MISSING_NAN = "nan"

BIN_NUMERICAL = "numerical"
BIN_CATEGORICAL = "categorical"


def _next_after_up(a: float) -> float:
    return float(np.nextafter(a, np.inf))


def _double_equal_ordered(a: float, b: float) -> bool:
    """a <= b known; true if b is within one ulp above a
    (ref: common.h:852 CheckDoubleEqualOrdered)."""
    return b <= np.nextafter(a, np.inf)


def merge_distinct(sorted_vals: np.ndarray, zero_cnt: int,
                   counts: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Distinct-value groups over an ascending f64 sample, vectorized.

    Semantics match the reference's sequential scan (ref: bin.cpp:360-390)
    exactly: an element merges into the running group when it is within
    one ulp of its immediate PREDECESSOR (chain merging, not
    representative merging), the group's representative is its largest
    member, a zero group carrying ``zero_cnt`` (the values absent from a
    sparse sample) is spliced at the negative->positive crossing, and a
    leading/trailing zero group is added when the whole sample is
    positive/negative. The scalar form was O(sample) Python per feature
    — minutes per Dataset at 4228 features; this is three numpy passes.
    With ``counts`` the values are distinct, each standing for ``counts``
    equal sample values: equal neighbours always merge, so the groups and
    their counts are those of the expanded sample.

    Returns (distinct_values f64, counts i64), both length >= 1.
    """
    n_sorted = len(sorted_vals)
    if n_sorted == 0:
        return (np.asarray([0.0], dtype=np.float64),
                np.asarray([max(zero_cnt, 0)], dtype=np.int64))
    brk = sorted_vals[1:] > np.nextafter(sorted_vals[:-1], np.inf)
    gid = np.empty(n_sorted, np.int64)
    gid[0] = 0
    np.cumsum(brk, out=gid[1:])
    members = np.bincount(gid)
    last_idx = np.cumsum(members) - 1
    reps = sorted_vals[last_idx].astype(np.float64)
    firsts = sorted_vals[last_idx - members + 1]
    ct = (members if counts is None
          else np.bincount(gid, weights=counts)).astype(np.int64)
    zpos = np.flatnonzero((reps[:-1] < 0.0) & (firsts[1:] > 0.0))
    if len(zpos):
        reps = np.insert(reps, zpos + 1, 0.0)
        ct = np.insert(ct, zpos + 1, zero_cnt)
    if sorted_vals[0] > 0.0 and zero_cnt > 0:
        reps = np.concatenate([[0.0], reps])
        ct = np.concatenate([[zero_cnt], ct])
    elif sorted_vals[-1] < 0.0 and zero_cnt > 0:
        reps = np.concatenate([reps, [0.0]])
        ct = np.concatenate([ct, [zero_cnt]])
    return reps, ct


class FeatureSampleSummary:
    """Compact, mergeable summary of one feature's sampled values.

    Stores the sorted NONZERO non-NaN values plus counts of exact zeros
    and NaNs. ``distinct_non_na()`` gives the exact ascending array
    ``np.sort`` of the raw sample would give, as distinct values and
    their counts (zeros re-inserted between the negative and positive
    runs; −0.0 normalizes to +0.0, which every downstream comparison
    treats identically), so bin finding over a summary is bit-identical
    to bin finding over the raw sample.
    """

    __slots__ = ("values", "zero_cnt", "na_cnt", "n_rows")

    def __init__(self, values: np.ndarray, zero_cnt: int, na_cnt: int,
                 n_rows: int):
        self.values = np.asarray(values, np.float64)
        self.zero_cnt = int(zero_cnt)
        self.na_cnt = int(na_cnt)
        self.n_rows = int(n_rows)

    @classmethod
    def from_sample(cls, sample_values: np.ndarray
                    ) -> "FeatureSampleSummary":
        vals = np.asarray(sample_values, np.float64).reshape(-1)
        nan_mask = np.isnan(vals)
        non_na = vals[~nan_mask]
        nz = non_na[non_na != 0.0]
        return cls(np.sort(nz, kind="stable"),
                   zero_cnt=len(non_na) - len(nz),
                   na_cnt=int(nan_mask.sum()), n_rows=len(vals))

    @classmethod
    def merge(cls, summaries: Sequence["FeatureSampleSummary"]
              ) -> "FeatureSampleSummary":
        """Exact multiset union (the JAX package's io/binning.py:136-148):
        merging per-shard summaries gives the summary of the
        concatenated sample, so bin finding over it is bin finding over
        the world's sample."""
        if not summaries:
            return cls(np.zeros(0, np.float64), 0, 0, 0)
        vals = np.sort(np.concatenate([s.values for s in summaries]),
                       kind="stable")
        return cls(vals,
                   zero_cnt=sum(s.zero_cnt for s in summaries),
                   na_cnt=sum(s.na_cnt for s in summaries),
                   n_rows=sum(s.n_rows for s in summaries))

    def sorted_non_na(self) -> np.ndarray:
        """Ascending non-NaN sample values with the zero run restored."""
        if not self.zero_cnt:
            return self.values
        cut = int(np.searchsorted(self.values, 0.0, side="left"))
        return np.concatenate([self.values[:cut],
                               np.zeros(self.zero_cnt, np.float64),
                               self.values[cut:]])

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, FeatureSampleSummary):
            return NotImplemented
        return (self.zero_cnt == other.zero_cnt and
                self.na_cnt == other.na_cnt and
                self.n_rows == other.n_rows and
                np.array_equal(self.values, other.values))

    def distinct_non_na(self) -> Tuple[np.ndarray, np.ndarray]:
        """The distinct ascending non-NaN sample values, the zero run
        restored, and how many times each occurs: the run-length form of
        the sorted sample (a sparse column's 200,000-row sample is mostly
        its zero run)."""
        v = self.values
        starts = np.flatnonzero(
            np.concatenate([[len(v) > 0], v[1:] != v[:-1]]))
        vals = v[starts]
        cnts = np.diff(np.append(starts, len(v)))
        if self.zero_cnt:
            cut = int(np.searchsorted(vals, 0.0, side="left"))
            vals = np.insert(vals, cut, 0.0)
            cnts = np.insert(cnts, cut, self.zero_cnt)
        return vals, cnts


_SUMMARY_MAGIC = b"LGSS"     # + u16 version


def serialize_summaries(summaries: Sequence[FeatureSampleSummary]
                        ) -> bytes:
    """A rank's per-feature summaries on the wire of distributed bin
    finding: the JAX package's bytes (io/binning.py:167-179), explicit
    little-endian binary, f64-exact, so a blob written by one package
    reads in the other."""
    parts = [_SUMMARY_MAGIC, struct.pack("<HI", 1, len(summaries))]
    for s in summaries:
        parts.append(struct.pack("<qqqq", len(s.values), s.zero_cnt,
                                 s.na_cnt, s.n_rows))
        parts.append(np.ascontiguousarray(s.values, np.float64)
                     .tobytes())
    return b"".join(parts)


def deserialize_summaries(blob: bytes) -> List[FeatureSampleSummary]:
    if blob[:4] != _SUMMARY_MAGIC:
        raise ValueError("bad sample-summary wire blob (magic mismatch)")
    ver, n = struct.unpack_from("<HI", blob, 4)
    if ver != 1:
        raise ValueError(f"unsupported sample-summary wire version {ver}")
    off = 10
    out = []
    for _ in range(n):
        n_vals, zero_cnt, na_cnt, n_rows = struct.unpack_from(
            "<qqqq", blob, off)
        off += 32
        vals = np.frombuffer(blob, np.float64, count=n_vals,
                             offset=off).copy()
        off += 8 * n_vals
        out.append(FeatureSampleSummary(vals, zero_cnt, na_cnt, n_rows))
    return out


def greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                    max_bin: int, total_cnt: int,
                    min_data_in_bin: int) -> List[float]:
    """Greedy equal-count bin boundary search (ref: bin.cpp:82)."""
    num_distinct = len(distinct_values)
    bin_upper_bound: List[float] = []
    assert max_bin > 0
    if num_distinct <= max_bin:
        cur_cnt_inbin = 0
        for i in range(num_distinct - 1):
            cur_cnt_inbin += int(counts[i])
            if cur_cnt_inbin >= min_data_in_bin:
                val = _next_after_up((float(distinct_values[i]) +
                                      float(distinct_values[i + 1])) / 2.0)
                if not bin_upper_bound or not _double_equal_ordered(
                        bin_upper_bound[-1], val):
                    bin_upper_bound.append(val)
                    cur_cnt_inbin = 0
        bin_upper_bound.append(math.inf)
    else:
        if min_data_in_bin > 0:
            max_bin = min(max_bin, max(1, total_cnt // min_data_in_bin))
        mean_bin_size = total_cnt / max_bin
        rest_bin_cnt = max_bin
        rest_sample_cnt = total_cnt
        is_big = counts >= mean_bin_size
        rest_bin_cnt -= int(is_big.sum())
        rest_sample_cnt -= int(counts[is_big].sum())
        mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
        upper_bounds = [math.inf] * max_bin
        lower_bounds = [math.inf] * max_bin
        bin_cnt = 0
        lower_bounds[bin_cnt] = float(distinct_values[0])
        cur_cnt_inbin = 0
        for i in range(num_distinct - 1):
            if not is_big[i]:
                rest_sample_cnt -= int(counts[i])
            cur_cnt_inbin += int(counts[i])
            # need a new bin: big value gets its own, or bin is full, or next
            # value is big and current bin is at least half full
            if is_big[i] or cur_cnt_inbin >= mean_bin_size or \
                    (is_big[i + 1] and
                     cur_cnt_inbin >= max(1.0, mean_bin_size * 0.5)):
                upper_bounds[bin_cnt] = float(distinct_values[i])
                bin_cnt += 1
                lower_bounds[bin_cnt] = float(distinct_values[i + 1])
                if bin_cnt >= max_bin - 1:
                    break
                cur_cnt_inbin = 0
                if not is_big[i]:
                    rest_bin_cnt -= 1
                    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
        bin_cnt += 1
        for i in range(bin_cnt - 1):
            val = _next_after_up((upper_bounds[i] + lower_bounds[i + 1]) / 2.0)
            if not bin_upper_bound or not _double_equal_ordered(
                    bin_upper_bound[-1], val):
                bin_upper_bound.append(val)
        bin_upper_bound.append(math.inf)
    return bin_upper_bound


def _find_bin_zero_as_one_bin(distinct_values: np.ndarray, counts: np.ndarray,
                              max_bin: int, total_sample_cnt: int,
                              min_data_in_bin: int) -> List[float]:
    """Split around zero so it occupies its own bin (ref: bin.cpp:247)."""
    neg_mask = distinct_values <= -kZeroThreshold
    pos_mask = distinct_values > kZeroThreshold
    left_cnt_data = int(counts[neg_mask].sum())
    right_cnt_data = int(counts[pos_mask].sum())
    cnt_zero = total_sample_cnt - left_cnt_data - right_cnt_data

    left_idx = np.flatnonzero(~neg_mask)
    left_cnt = int(left_idx[0]) if len(left_idx) else len(distinct_values)

    bin_upper_bound: List[float] = []
    if left_cnt > 0 and max_bin > 1:
        denom = max(total_sample_cnt - cnt_zero, 1)
        left_max_bin = max(1, int(left_cnt_data / denom * (max_bin - 1)))
        bin_upper_bound = greedy_find_bin(
            distinct_values[:left_cnt], counts[:left_cnt], left_max_bin,
            left_cnt_data, min_data_in_bin)
        if bin_upper_bound:
            bin_upper_bound[-1] = -kZeroThreshold

    right_idx = np.flatnonzero(pos_mask)
    right_start = int(right_idx[0]) if len(right_idx) else -1
    right_max_bin = max_bin - 1 - len(bin_upper_bound)
    if right_start >= 0 and right_max_bin > 0:
        right_bounds = greedy_find_bin(
            distinct_values[right_start:], counts[right_start:],
            right_max_bin, right_cnt_data, min_data_in_bin)
        bin_upper_bound.append(kZeroThreshold)
        bin_upper_bound.extend(right_bounds)
    else:
        bin_upper_bound.append(math.inf)
    assert len(bin_upper_bound) <= max_bin
    return bin_upper_bound


def _find_bin_with_predefined(distinct_values: np.ndarray, counts: np.ndarray,
                              max_bin: int, total_sample_cnt: int,
                              min_data_in_bin: int,
                              forced_upper_bounds: Sequence[float]) -> List[float]:
    """Binning constrained by user-forced bounds (ref: bin.cpp:163)."""
    num_distinct = len(distinct_values)
    neg_mask = distinct_values <= -kZeroThreshold
    pos_mask = distinct_values > kZeroThreshold
    left_idx = np.flatnonzero(~neg_mask)
    left_cnt = int(left_idx[0]) if len(left_idx) else num_distinct
    right_idx = np.flatnonzero(pos_mask)
    right_start = int(right_idx[0]) if len(right_idx) else -1

    bin_upper_bound: List[float] = []
    if max_bin == 2:
        bin_upper_bound.append(kZeroThreshold if left_cnt == 0 else -kZeroThreshold)
    elif max_bin >= 3:
        if left_cnt > 0:
            bin_upper_bound.append(-kZeroThreshold)
        if right_start >= 0:
            bin_upper_bound.append(kZeroThreshold)
    bin_upper_bound.append(math.inf)

    max_to_insert = max_bin - len(bin_upper_bound)
    num_inserted = 0
    for b in forced_upper_bounds:
        if num_inserted >= max_to_insert:
            break
        if abs(b) > kZeroThreshold:
            bin_upper_bound.append(float(b))
            num_inserted += 1
    bin_upper_bound.sort()

    free_bins = max_bin - len(bin_upper_bound)
    bounds_to_add: List[float] = []
    value_ind = 0
    n_bounds = len(bin_upper_bound)
    for i in range(n_bounds):
        cnt_in_bin = 0
        distinct_cnt_in_bin = 0
        bin_start = value_ind
        while value_ind < num_distinct and \
                distinct_values[value_ind] < bin_upper_bound[i]:
            cnt_in_bin += int(counts[value_ind])
            distinct_cnt_in_bin += 1
            value_ind += 1
        bins_remaining = max_bin - n_bounds - len(bounds_to_add)
        num_sub_bins = int(round(cnt_in_bin * free_bins / total_sample_cnt))
        num_sub_bins = min(num_sub_bins, bins_remaining) + 1
        if i == n_bounds - 1:
            num_sub_bins = bins_remaining + 1
        if distinct_cnt_in_bin > 0 and num_sub_bins > 0:
            new_bounds = greedy_find_bin(
                distinct_values[bin_start:bin_start + distinct_cnt_in_bin],
                counts[bin_start:bin_start + distinct_cnt_in_bin],
                num_sub_bins, cnt_in_bin, min_data_in_bin)
            bounds_to_add.extend(new_bounds[:-1])  # last bound is infinity
    bin_upper_bound.extend(bounds_to_add)
    bin_upper_bound.sort()
    assert len(bin_upper_bound) <= max_bin
    return bin_upper_bound


def _need_filter(cnt_in_bin: List[int], total_cnt: int, filter_cnt: int,
                 bin_type: str) -> bool:
    """True if no split on this feature could satisfy min_data constraints
    (ref: bin.cpp:57 NeedFilter)."""
    if bin_type == BIN_NUMERICAL:
        sum_left = 0
        for i in range(len(cnt_in_bin) - 1):
            sum_left += cnt_in_bin[i]
            if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                return False
    else:
        if len(cnt_in_bin) <= 2:
            for i in range(len(cnt_in_bin) - 1):
                sum_left = cnt_in_bin[i]
                if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                    return False
        else:
            return False
    return True


class BinMapper:
    """Per-feature value->bin quantizer (ref: bin.h:86)."""

    def __init__(self) -> None:
        self.num_bin: int = 1
        self.missing_type: str = MISSING_NONE
        self.is_trivial: bool = True
        self.sparse_rate: float = 1.0
        self.bin_type: str = BIN_NUMERICAL
        self.bin_upper_bound: np.ndarray = np.array([math.inf])
        self.bin_2_categorical: List[int] = []
        self.categorical_2_bin: Dict[int, int] = {}
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0
        self.most_freq_bin: int = 0

    # ------------------------------------------------------------------
    @classmethod
    def find_bin(cls, sample_values: np.ndarray, total_sample_cnt: int,
                 max_bin: int, min_data_in_bin: int, min_split_data: int,
                 pre_filter: bool = True, bin_type: str = BIN_NUMERICAL,
                 use_missing: bool = True, zero_as_missing: bool = False,
                 forced_upper_bounds: Sequence[float] = ()) -> "BinMapper":
        """Find bin boundaries from a sample of values (ref: bin.cpp:313).

        ``sample_values`` may contain NaN; values absent from the sample but
        present in the full data are assumed zero (sparse convention), which
        is why ``total_sample_cnt`` can exceed ``len(sample_values)``.
        """
        return cls.find_bin_from_summary(
            FeatureSampleSummary.from_sample(sample_values),
            total_sample_cnt, max_bin, min_data_in_bin, min_split_data,
            pre_filter=pre_filter, bin_type=bin_type,
            use_missing=use_missing, zero_as_missing=zero_as_missing,
            forced_upper_bounds=forced_upper_bounds)

    @classmethod
    def find_bin_from_summary(cls, summary: FeatureSampleSummary,
                              total_sample_cnt: int,
                              max_bin: int, min_data_in_bin: int,
                              min_split_data: int,
                              pre_filter: bool = True,
                              bin_type: str = BIN_NUMERICAL,
                              use_missing: bool = True,
                              zero_as_missing: bool = False,
                              forced_upper_bounds: Sequence[float] = ()
                              ) -> "BinMapper":
        """find_bin over a sample summary; bit-identical to ``find_bin``
        on the raw sample the summary came from."""
        self = cls()
        vals, cnts = summary.distinct_non_na()
        non_na_cnt = int(cnts.sum())
        na_cnt = 0
        if not use_missing:
            self.missing_type = MISSING_NONE
        elif zero_as_missing:
            self.missing_type = MISSING_ZERO
        else:
            if summary.na_cnt == 0:
                self.missing_type = MISSING_NONE
            else:
                self.missing_type = MISSING_NAN
                na_cnt = summary.na_cnt

        self.bin_type = bin_type
        self.default_bin = 0
        zero_cnt = int(total_sample_cnt - non_na_cnt - na_cnt)

        # distinct values with zero merged at |v| <= kZeroThreshold,
        # ulp-adjacent values merged (ref: bin.cpp:360-390)
        dv, ct = merge_distinct(vals, zero_cnt, cnts)
        self.min_val = float(dv[0])
        self.max_val = float(dv[-1])
        num_distinct = len(dv)
        cnt_in_bin: List[int] = []

        if bin_type == BIN_NUMERICAL:
            if self.missing_type in (MISSING_ZERO, MISSING_NONE):
                if forced_upper_bounds:
                    bounds = _find_bin_with_predefined(
                        dv, ct, max_bin, total_sample_cnt, min_data_in_bin,
                        forced_upper_bounds)
                else:
                    bounds = _find_bin_zero_as_one_bin(
                        dv, ct, max_bin, total_sample_cnt, min_data_in_bin)
                if self.missing_type == MISSING_ZERO and len(bounds) == 2:
                    self.missing_type = MISSING_NONE
            else:  # NaN missing: reserve last bin
                if forced_upper_bounds:
                    bounds = _find_bin_with_predefined(
                        dv, ct, max_bin - 1, total_sample_cnt - na_cnt,
                        min_data_in_bin, forced_upper_bounds)
                else:
                    bounds = _find_bin_zero_as_one_bin(
                        dv, ct, max_bin - 1, total_sample_cnt - na_cnt,
                        min_data_in_bin)
                bounds = bounds + [math.nan]
            self.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
            self.num_bin = len(bounds)
            # per-bin counts
            cnt_in_bin = [0] * self.num_bin
            i_bin = 0
            for i in range(num_distinct):
                while i_bin < self.num_bin - 1 and dv[i] > self.bin_upper_bound[i_bin]:
                    i_bin += 1
                cnt_in_bin[i_bin] += int(ct[i])
            if self.missing_type == MISSING_NAN:
                cnt_in_bin[self.num_bin - 1] = na_cnt
            assert self.num_bin <= max_bin
        else:
            # categorical: ints sorted by count desc; bin 0 = NaN/unseen
            dv_int = []
            ct_int = []
            for v, c in zip(dv.tolist(), ct.tolist()):
                iv = int(v)
                if iv < 0:
                    na_cnt += c
                else:
                    if dv_int and iv == dv_int[-1]:
                        ct_int[-1] += c
                    else:
                        dv_int.append(iv)
                        ct_int.append(c)
            rest_cnt = total_sample_cnt - na_cnt
            if rest_cnt > 0:
                order = sorted(range(len(dv_int)),
                               key=lambda i: (-ct_int[i], i))
                cut_cnt = int(round((total_sample_cnt - na_cnt) * 0.99))
                distinct_cnt = len(dv_int) + (1 if na_cnt > 0 else 0)
                eff_max_bin = min(distinct_cnt, max_bin)
                self.bin_2_categorical = [-1]
                self.categorical_2_bin = {-1: 0}
                cnt_in_bin = [0]
                self.num_bin = 1
                used_cnt = 0
                for rank, oi in enumerate(order):
                    if not (used_cnt < cut_cnt or self.num_bin < eff_max_bin):
                        break
                    if ct_int[oi] < min_data_in_bin and rank > 1:
                        break
                    self.bin_2_categorical.append(dv_int[oi])
                    self.categorical_2_bin[dv_int[oi]] = self.num_bin
                    used_cnt += ct_int[oi]
                    cnt_in_bin.append(ct_int[oi])
                    self.num_bin += 1
                if self.num_bin - 1 == len(dv_int) and na_cnt == 0:
                    self.missing_type = MISSING_NONE
                else:
                    self.missing_type = MISSING_NAN
                cnt_in_bin[0] = int(total_sample_cnt - used_cnt)

        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and pre_filter and _need_filter(
                cnt_in_bin, int(total_sample_cnt), min_split_data, bin_type):
            self.is_trivial = True

        if not self.is_trivial:
            self.default_bin = int(self.value_to_bin(np.array([0.0]))[0])
            self.most_freq_bin = int(np.argmax(cnt_in_bin))
            max_sparse_rate = cnt_in_bin[self.most_freq_bin] / total_sample_cnt
            if self.most_freq_bin != self.default_bin and \
                    max_sparse_rate < kSparseThreshold:
                self.most_freq_bin = self.default_bin
            self.sparse_rate = cnt_in_bin[self.most_freq_bin] / total_sample_cnt
        else:
            self.sparse_rate = 1.0
        return self

    # ------------------------------------------------------------------
    def value_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value->bin (ref: bin.h:613 ValueToBin)."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_CATEGORICAL:
            # one lookup over the sorted category keys: NaN, negative and
            # unseen values fall in bin 0 (the JAX package loops over
            # the categories with a full-length mask each)
            nan_mask = np.isnan(values)
            iv = np.where(nan_mask, -1, values).astype(np.int64)
            keys = np.fromiter(self.categorical_2_bin, np.int64)
            if not len(keys):
                return np.zeros(values.shape, dtype=np.int32)
            by_key = np.argsort(keys)
            keys = keys[by_key]
            bins = np.fromiter(self.categorical_2_bin.values(),
                               np.int32)[by_key]
            pos = np.minimum(np.searchsorted(keys, iv), len(keys) - 1)
            return np.where(keys[pos] == iv, bins[pos], 0).astype(np.int32)
        nan_mask = np.isnan(values)
        vals = np.where(nan_mask, 0.0, values)
        n_numeric = self.num_bin - (1 if self.missing_type == MISSING_NAN else 0)
        ub = self.bin_upper_bound[:n_numeric]
        # first bin whose upper bound >= value
        out = np.searchsorted(ub[:-1], vals, side="left").astype(np.int32)
        if self.missing_type == MISSING_NAN:
            out[nan_mask] = self.num_bin - 1
        return out

    def feature_info(self) -> str:
        """String for the model header's feature_infos field
        (ref: dataset.cpp Dataset::GetFeatureInfos)."""
        if self.is_trivial:
            return "none"
        if self.bin_type == BIN_CATEGORICAL:
            cats = sorted(c for c in self.bin_2_categorical if c >= 0)
            return "[" + ":".join(str(c) for c in cats) + "]"
        return f"[{self.min_val:g}:{self.max_val:g}]"

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, BinMapper):
            return NotImplemented
        return (self.num_bin == other.num_bin and
                self.missing_type == other.missing_type and
                self.bin_type == other.bin_type and
                np.array_equal(self.bin_upper_bound, other.bin_upper_bound,
                               equal_nan=True) and
                self.bin_2_categorical == other.bin_2_categorical)

    # the payload of distributed bin finding's mapper all-gather
    # (≡ BinMapper::CopyTo/CopyFrom over Network::Allgather, ref:
    # dataset_loader.cpp:1221-1260): the JAX package's explicit versioned
    # binary (io/binning.py:624-666), f64-exact, never pickle
    _WIRE_HEAD = "<iBBBiidddqq"

    def to_wire(self) -> bytes:
        bub = np.ascontiguousarray(self.bin_upper_bound, np.float64)
        cats = np.asarray(self.bin_2_categorical, np.int64)
        head = struct.pack(
            self._WIRE_HEAD, self.num_bin, _MISSING_CODE[self.missing_type],
            _BIN_TYPE_CODE[self.bin_type], int(self.is_trivial),
            self.default_bin, self.most_freq_bin, float(self.sparse_rate),
            float(self.min_val), float(self.max_val), len(bub), len(cats))
        return head + bub.tobytes() + cats.tobytes()

    @classmethod
    def from_wire(cls, blob: bytes, offset: int = 0
                  ) -> Tuple["BinMapper", int]:
        """One mapper decoded from ``offset``: (mapper, offset past it)."""
        (num_bin, miss, btype, trivial, default_bin, most_freq,
         sparse_rate, min_val, max_val, n_bub, n_cat) = \
            struct.unpack_from(cls._WIRE_HEAD, blob, offset)
        offset += struct.calcsize(cls._WIRE_HEAD)
        self = cls()
        self.num_bin = num_bin
        self.missing_type = _MISSING_FROM_CODE[miss]
        self.bin_type = _BIN_TYPE_FROM_CODE[btype]
        self.is_trivial = bool(trivial)
        self.default_bin = default_bin
        self.most_freq_bin = most_freq
        self.sparse_rate = sparse_rate
        self.min_val = min_val
        self.max_val = max_val
        self.bin_upper_bound = np.frombuffer(
            blob, np.float64, count=n_bub, offset=offset).copy()
        offset += 8 * n_bub
        cats = np.frombuffer(blob, np.int64, count=n_cat, offset=offset)
        offset += 8 * n_cat
        self.bin_2_categorical = [int(c) for c in cats]
        self.categorical_2_bin = {c: b for b, c in
                                  enumerate(self.bin_2_categorical)}
        return self, offset


_MISSING_CODE = {MISSING_NONE: 0, MISSING_ZERO: 1, MISSING_NAN: 2}
_MISSING_FROM_CODE = {v: k for k, v in _MISSING_CODE.items()}
_BIN_TYPE_CODE = {BIN_NUMERICAL: 0, BIN_CATEGORICAL: 1}
_BIN_TYPE_FROM_CODE = {v: k for k, v in _BIN_TYPE_CODE.items()}

_MAPPER_MAGIC = b"LGBM"      # + u16 version


def serialize_bin_mappers(mappers: Sequence[BinMapper]) -> bytes:
    """One rank's feature-slice mappers as a wire blob."""
    parts = [_MAPPER_MAGIC, struct.pack("<HI", 1, len(mappers))]
    parts.extend(m.to_wire() for m in mappers)
    return b"".join(parts)


def deserialize_bin_mappers(blob: bytes) -> List[BinMapper]:
    if blob[:4] != _MAPPER_MAGIC:
        raise ValueError("bad BinMapper wire blob (magic mismatch)")
    ver, n = struct.unpack_from("<HI", blob, 4)
    if ver != 1:
        raise ValueError(f"unsupported BinMapper wire version {ver}")
    off = 10
    out = []
    for _ in range(n):
        m, off = BinMapper.from_wire(blob, off)
        out.append(m)
    return out
