"""The launch geometry of kernel B2's wide path (u16 bins) in the PyTorch
port.

The kernel (``lightgbm_tpu_torch/csrc/hist_featmajor.cu``,
``hist_featmajor_wide``) runs only on the card, where chip_smoke.py holds
it against the exact sum; its columns, computed in Python by
``fm_wide_geometry``, are checked here for every bin count u16 bins give
past 256 and every feature count up to 64: each (feature, bin) in exactly
one warp's run, whole 32-row stages, and a block's shared memory (the
kernel's own formula, ``fm_wide_shared_bytes``) within the 232,448 bytes
an H100 block can opt in to. No JAX is needed: the geometry has no
counterpart in the JAX package.
"""
import numpy as np
import pytest

from lightgbm_tpu_torch.ops import hist_cuda
from lightgbm_tpu_torch.ops.hist_cuda import fm_wide_geometry

SHARED_OPTIN = 232_448


def _ceil16(x):
    return -(-x // 16) * 16


def _kernel_shared_bytes(g, gh_bytes):
    """``fm_wide_shared_bytes`` of csrc/hist_featmajor.cu: the histograms
    (12 bytes a bin and feature), the tags (a byte), then two stages of
    feature-major bins, gh, the leaf rows' list and a 16-byte header."""
    rows = g.stage_rows
    stage = rows * (2 * g.ft + 3 * gh_bytes + 2) + 16
    return 12 * g.ft * g.win + _ceil16(g.ft * g.win) + 2 * stage


def _check(g, num_bin, F, gh_bytes):
    assert 1 <= g.ft <= min(F, hist_cuda.WIDE_MAX_WARPS)
    assert g.n_ftiles == -(-F // g.ft) and g.ft * (g.n_ftiles - 1) < F
    assert g.win % (4 * g.wpf) == 0 and g.n_win == -(-num_bin // g.win)
    assert g.win * (g.n_win - 1) < num_bin      # no empty window
    assert 1 <= g.ft * g.wpf <= hist_cuda.WIDE_MAX_WARPS
    assert g.stage_rows % 32 == 0
    assert 32 <= g.stage_rows <= hist_cuda.WIDE_STAGE_ROWS
    assert g.shared_bytes == _kernel_shared_bytes(g, gh_bytes) \
        <= SHARED_OPTIN
    # all of a feature's bins in one window up to about 17,000 bins
    assert g.n_win == 1 or num_bin > 17_000


@pytest.mark.parametrize("F", range(1, 65))
def test_fm_wide_geometry_fits_every_bin_count(F):
    """Every num_bin from 257 to 65,536 at F features, f32 gh; int8 gh
    (one byte a channel, so more rows a stage) at every 7th."""
    for num_bin in range(257, (1 << 16) + 1):
        _check(fm_wide_geometry(num_bin, F, 4, SHARED_OPTIN), num_bin, F, 4)
    for num_bin in list(range(257, 1 << 16, 7)) + [1 << 16]:
        _check(fm_wide_geometry(num_bin, F, 1, SHARED_OPTIN), num_bin, F, 1)


def test_fm_wide_runs_cover_each_bin_once():
    """The runs of the warps of each window at 4,095 and 65,536 bins,
    bin by bin."""
    for num_bin in (4095, 1 << 16):
        g = fm_wide_geometry(num_bin, 28, 4, SHARED_OPTIN)
        sub = g.win // g.wpf
        owners = np.zeros(num_bin, np.int64)
        for w in range(g.n_win):
            for s in range(g.wpf):
                lo = w * g.win + s * sub
                owners[lo:min(lo + sub, num_bin)] += 1
        assert (owners == 1).all()
