"""Bin finding and the binned matrix of the PyTorch port against the JAX
package: the same float matrix must give bit-identical bin boundaries,
the same used features and the same bins (the JAX package stores them
feature-major ``[F, R]``, the port row-major ``[R, F]``)."""
import numpy as np
import pytest

from conftest import load_golden_csv
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset_core import BinnedDataset as JBinned
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset_core import BinnedDataset as TBinned

MAPPER_FIELDS = ("num_bin", "missing_type", "is_trivial", "bin_type",
                 "default_bin", "most_freq_bin", "min_val", "max_val",
                 "sparse_rate")


def _assert_same_binning(X, y, params):
    jd = JBinned.from_matrix(X, JConfig(params), label=y)
    td = TBinned.from_matrix(X, TConfig(params), label=y)
    assert len(jd.bin_mappers) == len(td.bin_mappers)
    for jm, tm in zip(jd.bin_mappers, td.bin_mappers):
        np.testing.assert_array_equal(tm.bin_upper_bound, jm.bin_upper_bound)
        for f in MAPPER_FIELDS:
            assert getattr(tm, f) == getattr(jm, f), f
        assert tm.feature_info() == jm.feature_info()
    np.testing.assert_array_equal(td.used_feature_map, jd.used_feature_map)
    # uint8, or uint16 once a used feature has more than 256 bins, as the
    # JAX package stores them
    assert td.bins.dtype == jd.bins.dtype and td.bins.flags.c_contiguous
    assert td.bins.dtype == (np.uint8 if max(
        m.num_bin for m in td.used_bin_mappers()) <= 256 else np.uint16)
    np.testing.assert_array_equal(td.bins, jd.bins.T)
    np.testing.assert_array_equal(td.metadata.label, jd.metadata.label)
    return td


def test_golden_train_csv():
    y, X = load_golden_csv("train.csv")
    td = _assert_same_binning(X, y, {"verbosity": -1})
    assert td.num_data == len(y)


@pytest.mark.parametrize("max_bin", [15, 63, 255, 511, 1023])
def test_random_with_missing_and_zeros(rng, max_bin):
    """Gaussian, integer-valued, zero-heavy, NaN-holding and constant
    columns: every missing type and the trivial-feature filter; past 256
    bins the matrix is uint16."""
    n = 3000
    X = np.stack([
        rng.normal(size=n),
        rng.integers(0, 7, size=n).astype(float),
        np.where(rng.uniform(size=n) < 0.7, 0.0, rng.normal(size=n)),
        np.where(rng.uniform(size=n) < 0.2, np.nan, rng.exponential(size=n)),
        np.full(n, 3.0),
        rng.standard_t(2, size=n),
    ], axis=1)
    y = rng.normal(size=n)
    td = _assert_same_binning(X, y, {"max_bin": max_bin, "verbosity": -1})
    assert td.bins.dtype == (np.uint16 if max_bin > 256 else np.uint8)


def test_row_sampling_for_bin_finding(rng):
    """More rows than bin_construct_sample_cnt: both draw the same
    sample with the same seed."""
    X = rng.normal(size=(5000, 3))
    _assert_same_binning(X, rng.normal(size=5000),
                         {"bin_construct_sample_cnt": 1000,
                          "data_random_seed": 7, "verbosity": -1})


def test_more_bins_than_16_bits_hold_is_refused(rng):
    """max_bin past 65,536 bins is refused loudly (the JAX package would
    wrap the bins in uint16)."""
    from lightgbm_tpu_torch.utils.log import LightGBMError
    X = rng.normal(size=(70000, 1))
    with pytest.raises(LightGBMError, match="16 bits"):
        TBinned.from_matrix(X, TConfig({"max_bin": 70000,
                                        "min_data_in_bin": 1,
                                        "verbosity": -1}))
