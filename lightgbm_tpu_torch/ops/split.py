"""Vectorized best-split search over feature histograms.

Port of ``lightgbm_tpu/ops/split.py`` (ref:
src/treelearner/feature_histogram.hpp:166 FindBestThreshold, :838
FindBestThresholdSequentially, :712-830 gain/output formulas;
feature_histogram.cpp:459 FindBestThresholdCategoricalInner for
categorical features, ``_categorical_scan``).

Both scan directions for all features are evaluated at once as cumulative
sums over the ``[F, B]`` histogram:

- REVERSE scan (missing goes left, default_left=True): suffix sums.
- FORWARD scan (missing goes right, default_left=False): prefix sums.
- MissingType::None -> reverse scan only; Zero -> both scans, default bin
  skipped; NaN -> both scans, NaN bin (last) pinned to the default side.

Tie-breaking matches the reference and the JAX package exactly: within
the reverse scan ties pick the LARGER threshold, within forward the
SMALLER; forward replaces reverse only on strictly greater gain; across
features the smaller feature index wins (``torch.argmax`` returns the
first maximum, as ``jnp.argmax`` does).

All gain and output arithmetic stays in f32 tensors — the JAX grower
computes it in f32 on the device, and a Python-float (f64) detour would
round differently and flip near-tie splits. Every function takes an
optional leading batch of leaves: ``hist`` ``[N, F, B, 3]`` with per-leaf
sums ``[N]`` scans N leaves in one pass (the grower scans both children
of a split together, as the JAX grower's ``vmap`` does).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

# ref: include/LightGBM/meta.h:51-57
K_EPSILON = 1e-15
K_MIN_SCORE = -math.inf

MISSING_ENUM = {"none": 0, "zero": 1, "nan": 2}


@dataclasses.dataclass(frozen=True)
class SplitHyperParams:
    """Split-quality knobs (the subset of Config that the scan reads)."""
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_delta_step: float = 0.0
    path_smooth: float = 0.0
    # the split-gain penalty of monotone features by depth (ref:
    # monotone_constraints.hpp:358 ComputeMonotoneSplitGainPenalty)
    monotone_penalty: float = 0.0
    # categorical optimal split (ref: config.h cat_* params)
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    min_data_per_group: int = 100

    @property
    def use_l1(self) -> bool:
        return self.lambda_l1 > 0.0

    @property
    def use_smoothing(self) -> bool:
        return self.path_smooth > K_EPSILON


class FeatureMeta(NamedTuple):
    """Per-used-feature metadata as device tensors [F] (int32), plus
    what the host knows without reading the device: whether any
    numerical feature has a missing type (without one the scan drops the
    forward direction: a categorical feature's numerical scan is never
    used) and
    the categorical features (``cat_features``, int64 indices, None when
    there are none; ``is_categorical`` is the bool [F] mask;
    ``cat_num_bin`` their bin counts on the host, which tell the scan
    which of its branches a feature takes)."""
    num_bin: torch.Tensor
    missing_type: torch.Tensor
    default_bin: torch.Tensor
    has_missing: bool = True
    is_categorical: Optional[torch.Tensor] = None
    cat_features: Optional[torch.Tensor] = None
    cat_num_bin: Optional[Tuple[int, ...]] = None
    # int32 [F] in {-1, 0, +1}, or None without any monotone constraint
    # (ref: config monotone_constraints; the JAX package's
    # ops/split.py FeatureMeta.monotone)
    monotone: Optional[torch.Tensor] = None
    # f32 [F] split-gain multiplier (feature_contri), or None when all 1
    penalty: Optional[torch.Tensor] = None

    @property
    def has_cat(self) -> bool:
        return self.cat_features is not None

    @staticmethod
    def from_mappers(mappers, device="cpu", monotone=None,
                     penalty=None) -> "FeatureMeta":
        """``monotone`` and ``penalty`` are per USED feature (host
        sequences), or None."""
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
        miss = [MISSING_ENUM[m.missing_type] for m in mappers]
        is_cat = [m.bin_type == "categorical" for m in mappers]
        return FeatureMeta(
            num_bin=i32([m.num_bin for m in mappers]),
            missing_type=i32(miss),
            default_bin=i32([m.default_bin for m in mappers]),
            has_missing=any(v != MISSING_ENUM["none"] and not c
                            for v, c in zip(miss, is_cat)),
            is_categorical=torch.tensor(is_cat, device=device),
            cat_features=(torch.tensor(
                [i for i, c in enumerate(is_cat) if c], device=device)
                if any(is_cat) else None),
            cat_num_bin=tuple(m.num_bin for m in mappers
                              if m.bin_type == "categorical") or None,
            monotone=None if monotone is None else i32(
                [int(v) for v in monotone]),
            penalty=None if penalty is None else torch.tensor(
                [float(v) for v in penalty], dtype=torch.float32,
                device=device))


class SplitRecord(NamedTuple):
    """Best split candidate (ref: split_info.hpp:22 SplitInfo); every
    field carries the leading batch shape of the scan (scalar per leaf)."""
    gain: torch.Tensor          # f32; K_MIN_SCORE when invalid (net gain)
    feature: torch.Tensor       # int64 used-feature index; -1 invalid
    threshold: torch.Tensor     # int64 bin threshold (left: bin <= thr)
    default_left: torch.Tensor  # bool
    left_sum_gradient: torch.Tensor
    left_sum_hessian: torch.Tensor
    left_count: torch.Tensor    # f32 (exact counts accumulated as floats)
    left_output: torch.Tensor
    right_sum_gradient: torch.Tensor
    right_sum_hessian: torch.Tensor
    right_count: torch.Tensor
    right_output: torch.Tensor
    # categorical split set (ref: SplitInfo::cat_threshold, the chosen
    # category BINS): int64, present only when a feature is categorical
    num_cat: Optional[torch.Tensor] = None   # 0 = numerical split
    cat_bins: Optional[torch.Tensor] = None  # [..., MAXK], -1 padded


def pack_record_rows(rec: SplitRecord) -> torch.Tensor:
    """SplitRecord -> packed f32 [..., 13] rows in the grower's column
    layout: [gain, feature, threshold, default_left, left (g, h, count,
    output), right (g, h, count, output), num_cat] (num_cat 0 without
    categorical features). Bin thresholds, feature ids and set sizes are
    < 2^24, exact in f32. The set itself travels beside the row."""
    num_cat = (rec.num_cat if rec.num_cat is not None
               else torch.zeros_like(rec.feature))
    return torch.stack([v.to(torch.float32) for v in rec[:12]]
                       + [num_cat.to(torch.float32)], dim=-1)


def max_cat_width(hp: "SplitHyperParams", num_bin: int) -> int:
    """MAXK, the width of a split's padded category set (ref: the JAX
    package's core/grower.py:455)."""
    return min(int(hp.max_cat_threshold), int(num_bin))


# ---------------------------------------------------------------------------
# Gain math (ref: feature_histogram.hpp:712-830)
# ---------------------------------------------------------------------------

def threshold_l1(s, l1):
    """ref: feature_histogram.hpp:712 ThresholdL1."""
    return torch.sign(s) * torch.clamp(torch.abs(s) - l1, min=0.0)


def calculate_splitted_leaf_output(sum_g, sum_h, hp: SplitHyperParams,
                                   num_data=None, parent_output=None):
    """ref: feature_histogram.hpp:718 CalculateSplittedLeafOutput."""
    if hp.use_l1:
        ret = -threshold_l1(sum_g, hp.lambda_l1) / (sum_h + hp.lambda_l2)
    else:
        ret = -sum_g / (sum_h + hp.lambda_l2)
    if hp.max_delta_step > 0.0:
        ret = torch.clamp(ret, -hp.max_delta_step, hp.max_delta_step)
    if hp.use_smoothing:
        n_over_s = num_data / hp.path_smooth
        ret = (ret * n_over_s / (n_over_s + 1.0)
               + parent_output / (n_over_s + 1.0))
    return ret


def leaf_gain_given_output(sum_g, sum_h, hp: SplitHyperParams, output):
    """ref: feature_histogram.hpp:819 GetLeafGainGivenOutput."""
    sg = threshold_l1(sum_g, hp.lambda_l1) if hp.use_l1 else sum_g
    return -(2.0 * sg * output + (sum_h + hp.lambda_l2) * output * output)


def leaf_gain_at_clamped_output(sum_g, sum_h, hp: SplitHyperParams,
                                output):
    """``leaf_gain_given_output`` as the JAX package's monotone path
    rounds it on the CPU, where XLA contracts ``2 sg * out + t`` into one
    fused multiply-add (``t = (sum_h + l2) * out * out`` rounded twice):
    the product and the sum round once, emulated in f64 (the product of
    two f32 values is exact there) on every device."""
    sg = threshold_l1(sum_g, hp.lambda_l1) if hp.use_l1 else sum_g
    t = (sum_h + hp.lambda_l2) * output * output
    fused = ((2.0 * sg).double() * output.double() + t.double()).float()
    return -fused


def leaf_gain(sum_g, sum_h, hp: SplitHyperParams, num_data=None,
              parent_output=None):
    """ref: feature_histogram.hpp:801 GetLeafGain."""
    if hp.max_delta_step <= 0.0 and not hp.use_smoothing:
        sg = threshold_l1(sum_g, hp.lambda_l1) if hp.use_l1 else sum_g
        return (sg * sg) / (sum_h + hp.lambda_l2)
    output = calculate_splitted_leaf_output(sum_g, sum_h, hp, num_data,
                                            parent_output)
    return leaf_gain_given_output(sum_g, sum_h, hp, output)


def split_gain(lg, lh, rg, rh, hp: SplitHyperParams, lcnt=None, rcnt=None,
               parent_output=None):
    """ref: feature_histogram.hpp:760 GetSplitGains (no monotone)."""
    return (leaf_gain(lg, lh, hp, lcnt, parent_output) +
            leaf_gain(rg, rh, hp, rcnt, parent_output))


# ---------------------------------------------------------------------------
# The vectorized two-direction scan
# ---------------------------------------------------------------------------

# XLA on the CPU evaluates a cumulative sum as a scan over tiles of this
# many elements (its ReduceWindowRewriter): each tile summed left to
# right, the tiles' totals scanned the same way, then each tile's
# exclusive prefix added to its elements.
XLA_SCAN_TILE = 16


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    out = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., k])
    return torch.stack(out, dim=-1)


def _xla_cpu_cumsum(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if n <= XLA_SCAN_TILE:
        return _sequential_cumsum(x)
    xp = torch.nn.functional.pad(x, (0, -n % XLA_SCAN_TILE))
    inner = _sequential_cumsum(xp.reshape(*x.shape[:-1], -1, XLA_SCAN_TILE))
    outer = _xla_cpu_cumsum(inner[..., -1])
    excl = torch.nn.functional.pad(outer[..., :-1], (1, 0))
    return (inner + excl[..., None]).reshape(xp.shape)[..., :n]


# ... and a sum over a long axis as a tree of windows of this many
# elements (its TreeReductionRewriter): the axis is padded with zeros to a
# multiple of the window, half the padding (rounded down) in front, each
# window summed left to right, and the windows' totals reduced the same
# way until at most one window is left, which is summed left to right.
XLA_REDUCE_WINDOW = 32


def _sequential_sum0(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros_like(x[0])        # XLA's init value, +0.0
    for k in range(x.shape[0]):
        acc = acc + x[k]
    return acc


def column_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the first (row) axis of a float32 ``[R, C]`` tensor. On
    the CPU it adds in the order the JAX package's ``jnp.sum(axis=0)``
    adds there, so root sums (and the outputs and gains that follow from
    them) equal the reference's bit for bit; on the card it is
    ``torch.sum``, one launch."""
    if x.device.type != "cpu":
        return x.sum(dim=0)
    w = XLA_REDUCE_WINDOW
    while x.shape[0] > w:
        pad = -x.shape[0] % w
        xp = torch.nn.functional.pad(x.T, (pad // 2, pad - pad // 2)).T
        x = _sequential_sum0(xp.reshape(-1, w, *x.shape[1:]).transpose(0, 1))
    return _sequential_sum0(x)


def bin_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over the last (bin) axis. On the CPU it
    adds in the order the JAX package's ``jnp.cumsum`` adds there (XLA's
    tiled scan), so the CPU port reproduces the reference's f32 side sums
    bit for bit wherever the histograms agree bit for bit (quantized and
    dyadic gradients); on the card it is ``torch.cumsum``, one launch."""
    if x.device.type == "cpu":
        return _xla_cpu_cumsum(x)
    return torch.cumsum(x, dim=-1)


def best_split_for_leaf(hist: torch.Tensor, sum_gradient, sum_hessian,
                        num_data, parent_output, meta: FeatureMeta,
                        hp: SplitHyperParams,
                        feature_mask: Optional[torch.Tensor] = None,
                        leaf_range=None, leaf_depth=None,
                        gain_penalty: Optional[torch.Tensor] = None,
                        rand_u: Optional[torch.Tensor] = None
                        ) -> SplitRecord:
    """Best split over all features for one leaf, or for a batch of them.

    Parameters
    ----------
    hist : f32 [F, B, 3] (sum_grad, sum_hess, count) per feature per bin,
        or [N, F, B, 3] for N leaves.
    sum_gradient, sum_hessian, num_data, parent_output : f32 leaf totals,
        scalars (or [N]); the count is a float.
    feature_mask : bool [F] (every leaf) or [N, F] (one row a leaf), or
        None: column sampling and interaction constraints; a masked
        feature cannot win (ref: the JAX package's ops/split.py:702-703).
    leaf_range : ``(min, max)`` f32 output bounds of each leaf ([N] or
        scalars), or None for unbounded; read only with
        ``meta.monotone`` (ref: monotone_constraints.hpp BasicConstraint).
    leaf_depth : each leaf's depth ([N] or a scalar), for
        ``monotone_penalty``.
    gain_penalty : f32 [F] or [N, F] subtracted from each feature's net
        gain (CEGB's DeltaGain, cost_effective_gradient_boosting.hpp).
    rand_u : f32 [F] or [N, F] uniforms in [0, 1), extremely randomized
        trees: one random threshold competes for a numerical feature (bin
        ``floor(u * (num_bin - 2))``), one random category or one random
        prefix length for a categorical one (ref: feature_histogram.hpp
        USE_RAND; the JAX package's ops/split.py:273-285, :556-622).

    Each feature's net gain passes, in this order, the column mask, the
    categorical scan's swap, ``feature_contri`` (``meta.penalty``),
    ``gain_penalty`` and the monotone penalty: the order the JAX package
    applies them in, which decides the f32 bits.

    The arithmetic mirrors FindBestThresholdSequentially with the
    kEpsilon seeding: the accumulating side starts at kEpsilon and the
    parent hessian carries +2 kEpsilon (ref: feature_histogram.hpp:172).
    Categorical features (``meta.cat_features``) take the categorical
    scan's result instead of the numerical scan over their bins.
    """
    batched = hist.dim() == 4
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                    device=hist.device).reshape(-1)
    hist4 = hist if batched else hist[None]
    N = hist4.shape[0]
    sums = [f32(v) for v in (sum_gradient, sum_hessian, num_data,
                             parent_output)]
    out_range = None
    if meta.monotone is not None:
        lo, hi = ((-math.inf, math.inf) if leaf_range is None
                  else leaf_range)
        out_range = tuple(f32(v).expand(N) for v in (lo, hi))
    rows = lambda v: None if v is None else (
        v.reshape(-1, v.shape[-1]).expand(N, -1))
    if rand_u is not None and rand_u.shape[-1] != hist4.shape[1]:
        raise ValueError(f"rand_u holds one uniform a feature: "
                         f"{hist4.shape[1]} features, {rand_u.shape[-1]} "
                         "draws")
    rand_u = rows(rand_u)
    scan = _per_feature_scan(hist4, *sums, meta, hp, out_range, rand_u)
    cat = (_categorical_scan_of(hist4, sums, meta, hp, out_range, rand_u)
           if meta.has_cat else None)
    depth = None if leaf_depth is None else f32(leaf_depth).expand(N)
    rec = _select_across_features(scan, hp, feature_mask, meta, cat,
                                  depth, rows(gain_penalty))
    return rec if batched else SplitRecord(
        *(None if v is None else v[0] for v in rec))


def _per_feature_scan(hist, sum_gradient, sum_hessian, num_data,
                      parent_output, meta: FeatureMeta,
                      hp: SplitHyperParams, out_range=None,
                      rand_u=None) -> dict:
    """The two-direction cumulative scan over hist [N, F, B, 3] with leaf
    totals [N]; returns per-feature best arrays [N, F] and what the
    selection needs. ``out_range`` (min, max [N]) turns on the monotone
    path: both children's outputs are clamped to it, a candidate whose
    outputs break its feature's direction is invalid, and the gain is
    taken at the clamped outputs (ref: GetSplitGains USE_MC,
    feature_histogram.hpp:781-797). ``rand_u`` [N, F]: extra_trees."""
    N, F, B, _ = hist.shape
    dev = hist.device
    col = lambda v: v[:, None, None]              # [N] -> [N, 1, 1]
    ghc = hist.movedim(-1, 0)                     # [3, N, F, B]

    sum_hessian = sum_hessian + 2 * K_EPSILON
    bin_idx = torch.arange(B, device=dev)[None, :]             # [1, B]
    nbin = meta.num_bin[:, None]                               # [F, 1]
    miss = meta.missing_type[:, None]
    dflt = meta.default_bin[:, None]

    multi_bin = nbin > 2
    run_forward = multi_bin & (miss != MISSING_ENUM["none"])
    skip_default = multi_bin & (miss == MISSING_ENUM["zero"])
    na_as_missing = multi_bin & (miss == MISSING_ENUM["nan"])
    # num_bin<=2 && missing==nan: the reverse-only scan reports
    # default_left=False (ref: feature_histogram.hpp:431-441)
    dl_false = (~multi_bin) & (miss == MISSING_ENUM["nan"])

    in_range = bin_idx < nbin
    acc_mask = in_range & ~(skip_default & (bin_idx == dflt))
    rand_bins = None
    if rand_u is not None:
        # extra_trees: the one threshold bin of each feature that competes
        # (ref: feature_histogram.hpp:205 rand.NextInt(0, num_bin - 2))
        span = torch.clamp(meta.num_bin - 2, min=1).to(torch.float32)
        rand_bins = torch.minimum((rand_u * span).to(torch.int32),
                                  meta.num_bin - 2)[..., None]  # [N, F, 1]

    min_gain_shift = (leaf_gain(sum_gradient, sum_hessian, hp, num_data,
                                parent_output) + hp.min_gain_to_split)

    def side_stats(acc_g, acc_h, acc_c):
        """Complement side via subtraction from the parent totals."""
        return (col(sum_gradient) - acc_g, col(sum_hessian) - acc_h,
                col(num_data) - acc_c)

    def gains_and_validity(lg, lh, lc, rg, rh, rc):
        valid = ((lc >= hp.min_data_in_leaf) &
                 (rc >= hp.min_data_in_leaf) &
                 (lh >= hp.min_sum_hessian_in_leaf) &
                 (rh >= hp.min_sum_hessian_in_leaf))
        if out_range is not None:
            po = col(parent_output)
            lo = _clamp_range(calculate_splitted_leaf_output(
                lg, lh, hp, lc, po), out_range, col)
            ro = _clamp_range(calculate_splitted_leaf_output(
                rg, rh, hp, rc, po), out_range, col)
            mono = meta.monotone[:, None]
            viol = ((mono > 0) & (lo > ro)) | ((mono < 0) & (lo < ro))
            gains = (leaf_gain_at_clamped_output(lg, lh, hp, lo) +
                     leaf_gain_at_clamped_output(rg, rh, hp, ro))
            valid = valid & ~viol
        else:
            gains = split_gain(lg, lh, rg, rh, hp, lc, rc,
                               col(parent_output))
        gains = torch.where(torch.isnan(gains), K_MIN_SCORE, gains)
        valid = valid & (gains > col(min_gain_shift))
        return gains, valid

    # ---------------- REVERSE scan: right side accumulates hi..t -----------
    # hi = num_bin-1 - (1 if na_as_missing): NaN bin excluded => goes left.
    hi = nbin - 1 - na_as_missing.to(nbin.dtype)
    rev_mask = (acc_mask & (bin_idx <= hi)).to(hist.dtype)
    # right side at threshold t accumulates bins t+1..hi: a SUFFIX sum in
    # the reference's high-to-low order, evaluated in iteration index
    # space u = t + 1 (right side = sfx[u])
    sfx = bin_cumsum((ghc * rev_mask).flip(-1)).flip(-1)
    rg_u = sfx[0]
    rh_u = sfx[1] + K_EPSILON
    rc_u = sfx[2]
    lg_rev, lh_rev, lc_rev = side_stats(rg_u, rh_u, rc_u)
    gains_rev_u, valid_rev = gains_and_validity(lg_rev, lh_rev, lc_rev,
                                                rg_u, rh_u, rc_u)
    # iterations of the reverse loop: u = t+1 in [1, hi]; skip-default
    # applies to the iteration t = thr + 1
    thr_ok_u = ((bin_idx >= 1) & (bin_idx <= hi) & in_range
                & ~(skip_default & (bin_idx == dflt)))
    if rand_bins is not None:
        thr_ok_u = thr_ok_u & (bin_idx == rand_bins + 1)
    gains_rev_u = torch.where(valid_rev & thr_ok_u, gains_rev_u,
                              K_MIN_SCORE)
    # reverse ties -> larger threshold (first seen high-to-low)
    rev_best_u = (B - 1) - torch.argmax(gains_rev_u.flip(-1), dim=-1)
    rev_best_gain = torch.gather(gains_rev_u, -1, rev_best_u[..., None])[..., 0]
    rev_best_t = rev_best_u - 1
    out = dict(min_gain_shift=min_gain_shift, sfx=sfx, pfx=None,
               use_fwd=None, sum_gradient=sum_gradient,
               sum_hessian2=sum_hessian, num_data=num_data,
               parent_output=parent_output, out_range=out_range)

    if not meta.has_missing:
        # with no missing values anywhere the forward scan cannot win
        # (the reference's run_forward gate, feature_histogram.hpp:304)
        out.update(best_t=rev_best_t, best_gain=rev_best_gain,
                   best_dl=(~dl_false[:, 0]).expand(N, F))
        return out

    # ---------------- FORWARD scan: left side accumulates 0..t -------------
    fwd_mask = (acc_mask & (bin_idx <= nbin - 2)).to(hist.dtype)
    pfx = bin_cumsum(ghc * fwd_mask)
    lg_acc = pfx[0]
    lh_acc = pfx[1] + K_EPSILON
    lc_acc = pfx[2]
    rg_fwd, rh_fwd, rc_fwd = side_stats(lg_acc, lh_acc, lc_acc)
    gains_fwd, valid_fwd = gains_and_validity(lg_acc, lh_acc, lc_acc,
                                              rg_fwd, rh_fwd, rc_fwd)
    thr_ok_fwd = ((bin_idx <= nbin - 2) & in_range & run_forward
                  & ~(skip_default & (bin_idx == dflt)))
    if rand_bins is not None:
        thr_ok_fwd = thr_ok_fwd & (bin_idx == rand_bins)
    gains_fwd = torch.where(valid_fwd & thr_ok_fwd, gains_fwd, K_MIN_SCORE)
    # forward ties -> smaller threshold; forward replaces reverse only on
    # strictly greater gain
    fwd_best_t = torch.argmax(gains_fwd, dim=-1)
    fwd_best_gain = torch.gather(gains_fwd, -1, fwd_best_t[..., None])[..., 0]
    use_fwd = fwd_best_gain > rev_best_gain
    out.update(best_t=torch.where(use_fwd, fwd_best_t, rev_best_t),
               best_gain=torch.where(use_fwd, fwd_best_gain, rev_best_gain),
               best_dl=torch.where(use_fwd, False, ~dl_false[:, 0]),
               pfx=pfx, use_fwd=use_fwd)
    return out


def _clamp_range(x, out_range, col):
    """``clip(x, min, max)`` with the leaf bounds ``out_range`` ([N] each)
    broadcast by ``col``: max first, then min, as ``jnp.clip``."""
    return torch.minimum(torch.maximum(x, col(out_range[0])),
                         col(out_range[1]))


def _greedy_groups(eligible: torch.Tensor, counts: torch.Tensor,
                   min_data_per_group: float) -> torch.Tensor:
    """The reference's ``min_data_per_group`` thinning of a prefix scan
    (feature_histogram.cpp cnt_cur_group; the JAX package's sequential
    ``lax.scan``, ops/split.py:596-616) without a loop over the slots.

    Walking slots 0..K-1, a running group count adds each slot's count;
    slot i is a candidate when ``eligible[i]`` and the group holds at
    least ``min_data_per_group`` rows, and a candidate starts a new
    group. So the next candidate after slot j is the first eligible slot
    i > j whose prefix count exceeds j's by at least the minimum: a
    successor map over the slots (start = one slot before the first),
    whose chain from the start is followed by pointer doubling. Counts
    are whole numbers, summed here in f64 (exact); the JAX package's f32
    group sum is exact below 2^24 rows, where the two agree.

    eligible : bool [..., K]; counts : [..., K] per slot. Returns the
    candidate mask, bool [..., K]."""
    K = eligible.shape[-1]
    dev = eligible.device
    pfx = torch.cumsum(counts.to(torch.float64), dim=-1)
    p_ext = torch.nn.functional.pad(pfx, (1, 0))               # [..., K+1]
    slot = torch.arange(K, device=dev)
    # succ[j, i]: slot i may follow node j (node 0 = start, node j >= 1
    # = slot j - 1)
    after = slot[None, :] >= torch.arange(K + 1, device=dev)[:, None]
    succ = (after & eligible[..., None, :]
            & (pfx[..., None, :] - p_ext[..., :, None] >= min_data_per_group))
    # a last column that always holds: "no successor" is node K + 1,
    # which is its own successor
    succ = torch.nn.functional.pad(succ, (0, 1), value=True)
    nxt = torch.argmax(succ.to(torch.uint8), -1) + 1            # [..., K+1]
    nxt = torch.nn.functional.pad(nxt, (0, 1), value=K + 1)
    node = torch.arange(K + 2, device=dev)
    on = (node == 0).expand(nxt.shape)                          # the start
    span = 1
    while span <= K:
        # every node reached within `span` more steps joins the chain
        on = on | ((nxt[..., :, None] == node) & on[..., :, None]).any(-2)
        nxt = torch.gather(nxt, -1, nxt)
        span *= 2
    return on[..., 1:K + 1]


# the per-feature values a categorical scan returns, in this order
CAT_VALUES = ("lg", "lh", "lc", "rg", "rh", "rc", "lo", "ro")


def _categorical_scan_of(hist4, sums, meta: FeatureMeta,
                         hp: SplitHyperParams, out_range=None,
                         rand_u=None) -> dict:
    """The categorical scan of ``meta``'s categorical features, from the
    leaf totals ``sums`` (grad, hess, count, parent output; [N] each)."""
    onehot = (None if meta.cat_num_bin is None else
              [nb - 1 <= hp.max_cat_to_onehot for nb in meta.cat_num_bin])
    cf = meta.cat_features
    return _categorical_scan(
        hist4[:, cf], sums[0], sums[1] + 2 * K_EPSILON, sums[2], sums[3],
        meta.num_bin[cf], hp, onehot,
        mono=None if out_range is None else meta.monotone[cf],
        out_range=out_range,
        rand_u=None if rand_u is None else rand_u[:, cf])


def _categorical_scan(hist, sum_gradient, sum_hessian, num_data,
                      parent_output, num_bin: torch.Tensor,
                      hp: SplitHyperParams, onehot=None, mono=None,
                      out_range=None, rand_u=None) -> dict:
    """Best categorical split of each feature of ``hist`` [N, Fc, B, 3]
    (the categorical features' histograms; ``num_bin`` [Fc]), leaf totals
    [N] with ``sum_hessian`` carrying +2 kEpsilon (ref:
    feature_histogram.cpp:459 FindBestThresholdCategoricalInner; port of
    the JAX package's ops/split.py ``_categorical_scan``).

    Features of at most ``max_cat_to_onehot`` categories scan each
    category alone (one-hot); the others stable-sort their bins by
    ``sum_grad / (sum_hess + cat_smooth)`` and scan prefixes of the
    sorted order from both ends, at most ``max_cat_threshold`` long and
    thinned by ``min_data_per_group``, with ``cat_l2`` added to the l2
    term. Bin 0 (NaN and unseen categories) is never in a set: those
    rows go right (default_left=False). ``onehot`` (host bools [Fc],
    which features scan one-hot; None: unknown) lets the scan skip a
    branch no feature takes.

    With ``out_range`` (monotone constraints; ``mono`` the features'
    directions [Fc]) both sides' outputs are clamped to the leaf's
    bounds, the gain is taken at them and a set whose outputs break the
    direction is invalid. ``rand_u`` [N, Fc] (extra_trees) lets one
    random category, or one random prefix length, compete (ref:
    feature_histogram.cpp:191, :272).

    Divergence kept from the JAX package: the reference approximates a
    bin's count as RoundInt(hess * num_data / sum_hessian), having no
    count channel in its categorical histograms; here the histogram's
    exact count is used (the same when hessians are constant).

    Returns per feature, [N, Fc]: the net gain and the set size; the
    sets [N, Fc, MAXK] (bins, -1 padded); and ``vals`` [N, Fc, 8], the
    two sides' sums and outputs in ``CAT_VALUES`` order. Every value is
    the JAX package's bit for bit: each channel's operations are the
    same elementwise f32 operations, only batched."""
    N, Fc, B, _ = hist.shape
    dev = hist.device
    col3 = lambda v: v[:, None, None]
    col4 = lambda v: v[:, None, None, None]
    bin_idx = torch.arange(B, device=dev)
    nbin = num_bin.long()
    in_range = (bin_idx >= 1) & (bin_idx < nbin[:, None])       # [Fc, B]
    do1 = onehot is None or any(onehot)
    do2 = onehot is None or not all(onehot)

    hp_ns = dataclasses.replace(hp, path_smooth=0.0)
    hp_cat = dataclasses.replace(hp, lambda_l2=hp.lambda_l2 + hp.cat_l2)
    if hp.use_smoothing:
        # smoothing on: the shift is the gain at the PARENT's output
        shift = leaf_gain_given_output(sum_gradient, sum_hessian, hp,
                                       parent_output)
    else:
        shift = leaf_gain(sum_gradient, sum_hessian, hp_ns, num_data,
                          torch.zeros_like(sum_gradient))
    min_gain_shift = shift + hp.min_gain_to_split              # [N]

    def gain(lg, lh, lc, rg, rh, rc, hp_use, parent, colx, mono_b):
        """Split gain, the chosen set on the left; NaN is no split. With
        monotone constraints: the gain at the clamped outputs, and
        whether the outputs keep the direction."""
        if out_range is None:
            g = (leaf_gain(lg, lh, hp_use, lc, parent) +
                 leaf_gain(rg, rh, hp_use, rc, parent))
            ok = None
        else:
            lo = _clamp_range(calculate_splitted_leaf_output(
                lg, lh, hp_use, lc, parent), out_range, colx)
            ro = _clamp_range(calculate_splitted_leaf_output(
                rg, rh, hp_use, rc, parent), out_range, colx)
            ok = ~(((mono_b > 0) & (lo > ro)) | ((mono_b < 0) & (lo < ro)))
            g = (leaf_gain_at_clamped_output(lg, lh, hp_use, lo) +
                 leaf_gain_at_clamped_output(rg, rh, hp_use, ro))
        return torch.where(torch.isnan(g), K_MIN_SCORE, g), ok

    def with_outputs(sides, hp_use):
        """[N, Fc, 6] side sums -> [N, Fc, 8] with both outputs."""
        po = parent_output[:, None]
        outs = [calculate_splitted_leaf_output(sides[..., 3 * s],
                                               sides[..., 3 * s + 1], hp_use,
                                               sides[..., 3 * s + 2], po)
                for s in (0, 1)]
        if out_range is not None:
            outs = [_clamp_range(o, out_range, lambda v: v[:, None])
                    for o in outs]
        return torch.cat([sides, torch.stack(outs, -1)], -1)

    g, h, c = hist[..., 0], hist[..., 1], hist[..., 2]          # [N, Fc, B]
    KK = max_cat_width(hp, B)
    slots = torch.arange(KK, device=dev)
    net1 = net2 = None
    if do1:
        # ---- one-hot: left = a single category ---------------------------
        lh1 = h + K_EPSILON
        rg1 = col3(sum_gradient) - g
        rh1 = col3(sum_hessian) - h - K_EPSILON
        rc1 = col3(num_data) - c
        gain1, ok1 = gain(g, lh1, c, rg1, rh1, rc1, hp, col3(parent_output),
                          col3, None if mono is None else mono[:, None])
        valid1 = (in_range & (c >= hp.min_data_in_leaf) &
                  (h >= hp.min_sum_hessian_in_leaf) &
                  (rc1 >= hp.min_data_in_leaf) &
                  (rh1 >= hp.min_sum_hessian_in_leaf) &
                  (gain1 > col3(min_gain_shift)))
        if ok1 is not None:
            valid1 = valid1 & ok1
        if rand_u is not None:
            # one random category bin of each feature competes
            span1 = torch.clamp(nbin - 1, min=1).to(torch.float32)
            rand1 = 1 + torch.minimum((rand_u * span1).to(torch.int64),
                                      nbin - 2)
            valid1 = valid1 & (bin_idx == rand1[..., None])
        gain1 = torch.where(valid1, gain1, K_MIN_SCORE)
        t1 = torch.argmax(gain1, dim=-1)              # ties -> smaller bin
        net1 = torch.gather(gain1, -1, t1[..., None])[..., 0]
        sides = torch.stack([g, lh1, c, rg1, rh1, rc1], -1)
        vals1 = with_outputs(torch.gather(
            sides, 2, t1[..., None, None].expand(N, Fc, 1, 6))[:, :, 0], hp)
        set1 = torch.where(slots == 0, t1[..., None], -1)
        ncat1 = torch.ones_like(t1)
    if do2:
        # ---- sorted subset: prefixes of the bins ordered by grad/hess ----
        used = in_range & (c >= hp.cat_smooth)
        ratio = torch.where(used, g / (h + hp.cat_smooth), math.inf)
        order_asc = torch.argsort(ratio, dim=-1, stable=True)
        used_bin = used.sum(-1)                                 # [N, Fc]
        rev_pos = (used_bin[..., None] - 1 - bin_idx).clamp(0, B - 1)
        order_desc = torch.gather(order_asc, -1, rev_pos)
        orders = torch.stack([order_asc[..., :KK], order_desc[..., :KK]],
                             dim=2)                             # [N, Fc, 2, KK]
        # the three channels gathered into sorted order and summed in one
        # pass each: [3, N, Fc, 2, KK]
        ghc = torch.gather(hist[:, :, None].expand(N, Fc, 2, B, 3), 3,
                           orders[..., None].expand(N, Fc, 2, KK, 3))
        L = bin_cumsum(ghc.movedim(-1, 0))
        Lg, Lh, Lc = L[0], L[1] + K_EPSILON, L[2]
        Rg = col4(sum_gradient) - Lg
        Rh = col4(sum_hessian) - Lh
        Rc = col4(num_data) - Lc
        max_num_cat = torch.clamp((used_bin + 1) // 2,
                                  max=hp.max_cat_threshold)
        limit = torch.minimum(max_num_cat, used_bin)[..., None, None]
        # a slot whose left side is too small is skipped; one whose right
        # side is too small ends its direction's scan (ref: the `break`)
        left_bad = ((Lc < hp.min_data_in_leaf) |
                    (Lh < hp.min_sum_hessian_in_leaf))
        brk = ~left_bad & ((Rc < hp.min_data_in_leaf) |
                           (Rc < hp.min_data_per_group) |
                           (Rh < hp.min_sum_hessian_in_leaf))
        alive = torch.cumsum(brk.to(torch.int32), dim=-1) == 0
        cand = _greedy_groups(alive & ~left_bad, ghc[..., 2],
                              hp.min_data_per_group)
        gain2, ok2 = gain(Lg, Lh, Lc, Rg, Rh, Rc, hp_cat,
                          col4(parent_output), col4,
                          None if mono is None else mono[:, None, None])
        cand = cand & (slots < limit)
        if ok2 is not None:
            cand = cand & ok2
        if rand_u is not None:
            # one random prefix length, shared by both directions
            max_thr = torch.clamp(torch.minimum(max_num_cat, used_bin) - 1,
                                  min=0)
            rand_p = torch.minimum(
                (rand_u * torch.clamp(max_thr, min=1).to(torch.float32)
                 ).to(torch.int64), torch.clamp(max_thr - 1, min=0))
            cand = cand & (slots == rand_p[..., None, None])
        gain2 = torch.where(cand & (gain2 > col4(min_gain_shift)),
                            gain2, K_MIN_SCORE)
        # the reference scans direction +1 fully, then -1, the first strict
        # maximum winning: the row-major flatten keeps that order
        bf2 = torch.argmax(gain2.reshape(N, Fc, 2 * KK), dim=-1)
        bdir, bk = bf2 // KK, bf2 % KK
        net2 = torch.gather(gain2.reshape(N, Fc, 2 * KK), -1,
                            bf2[..., None])[..., 0]
        sides = torch.stack([Lg, Lh, Lc, Rg, Rh, Rc], -1).reshape(
            N, Fc, 2 * KK, 6)
        vals2 = with_outputs(torch.gather(
            sides, 2, bf2[..., None, None].expand(N, Fc, 1, 6))[:, :, 0],
            hp_cat)
        best_order = torch.gather(
            orders, 2, bdir[..., None, None].expand(N, Fc, 1, KK))[:, :, 0]
        set2 = torch.where(slots <= bk[..., None], best_order, -1)
        ncat2 = bk + 1

    if do1 and do2:
        # num_bin counts the reserved bin 0: the categories are num_bin - 1
        use1 = (nbin - 1) <= hp.max_cat_to_onehot                # [Fc]
        pick = lambda a1, a2: torch.where(
            use1.reshape(-1, *([1] * (a1.dim() - 2))), a1, a2)
        bgain, vals = pick(net1, net2), pick(vals1, vals2)
        cat_bins, num_cat = pick(set1, set2), pick(ncat1, ncat2)
    elif do1:
        bgain, vals, cat_bins, num_cat = net1, vals1, set1, ncat1
    else:
        bgain, vals, cat_bins, num_cat = net2, vals2, set2, ncat2
    return dict(
        net_gain=torch.where(bgain > K_MIN_SCORE,
                             bgain - min_gain_shift[:, None], K_MIN_SCORE),
        num_cat=num_cat, cat_bins=cat_bins, vals=vals)


def _select_across_features(scan: dict, hp: SplitHyperParams,
                            feature_mask: Optional[torch.Tensor] = None,
                            meta: Optional[FeatureMeta] = None,
                            cat: Optional[dict] = None,
                            leaf_depth: Optional[torch.Tensor] = None,
                            gain_penalty: Optional[torch.Tensor] = None
                            ) -> SplitRecord:
    """Cross-feature selection over _per_feature_scan output: the winner
    by (max net gain, smaller feature index), and its side sums fetched
    from the scan's cumulative sums at (feature, iteration) with the same
    f32 operations the scan used. With ``cat`` (the categorical scan of
    ``meta.cat_features``) a categorical feature competes with its
    categorical result, and a categorical winner takes its sums, outputs
    and set from there (threshold 0, default_left False). Before the
    argmax each net gain takes ``feature_contri``, ``gain_penalty`` and
    the monotone penalty at ``leaf_depth`` [N], in that order (ref:
    serial_tree_learner.cpp:996-1005; the JAX package's
    ops/split.py:704-726)."""
    best_gain = scan["best_gain"]                              # [N, F]
    if feature_mask is not None:
        best_gain = torch.where(feature_mask, best_gain, K_MIN_SCORE)
    best_t = scan["best_t"]
    N = best_gain.shape[0]
    dev = best_gain.device
    valid_any = best_gain > K_MIN_SCORE
    net_gain = torch.where(valid_any,
                           best_gain - scan["min_gain_shift"][:, None],
                           K_MIN_SCORE)
    if cat is not None:
        # categorical features take their subset-scan result instead of
        # the (meaningless) numerical scan over their bins
        cat_net = torch.full_like(net_gain, K_MIN_SCORE)
        cat_net[:, meta.cat_features] = cat["net_gain"]
        if feature_mask is not None:
            cat_net = torch.where(feature_mask, cat_net, K_MIN_SCORE)
        net_gain = torch.where(meta.is_categorical, cat_net, net_gain)
        valid_any = torch.where(meta.is_categorical, cat_net > K_MIN_SCORE,
                                valid_any)
    if meta is not None and meta.penalty is not None:
        # feature_contri multiplies the feature's best gain (ref:
        # feature_histogram.hpp:175); a gain no longer positive is void
        net_gain = torch.where(valid_any, net_gain * meta.penalty, net_gain)
        valid_any = valid_any & (net_gain > 0.0)
        net_gain = torch.where(valid_any, net_gain, K_MIN_SCORE)
    if gain_penalty is not None:
        net_gain = torch.where(valid_any, net_gain - gain_penalty, net_gain)
    out_range = scan["out_range"]
    if out_range is not None and hp.monotone_penalty > 0.0:
        # ref: monotone_constraints.hpp:358 ComputeMonotoneSplitGainPenalty
        depth = (torch.zeros_like(net_gain[:, 0]) if leaf_depth is None
                 else leaf_depth)[:, None]
        pen = hp.monotone_penalty
        if pen <= 1.0:
            penalty = 1.0 - pen / torch.exp2(depth) + K_EPSILON
        else:
            penalty = 1.0 - torch.exp2((pen - 1.0) - depth) + K_EPSILON
        penalty = torch.where(pen >= depth + 1.0, K_EPSILON, penalty)
        net_gain = torch.where(valid_any & (meta.monotone != 0),
                               net_gain * penalty, net_gain)
    best_f = torch.argmax(net_gain, dim=-1)                    # [N]
    sel = lambda a: torch.gather(a, -1, best_f[:, None])[:, 0]
    gain_out = sel(net_gain)
    has_valid = sel(valid_any)
    best_t_w = sel(best_t)
    best_dl = sel(scan["best_dl"])

    n = torch.arange(N, device=dev)
    eps_h = torch.tensor([0.0, K_EPSILON, 0.0], dtype=torch.float32,
                         device=dev)
    svec = torch.stack([scan["sum_gradient"], scan["sum_hessian2"],
                        scan["num_data"]], dim=-1)             # [N, 3]
    # right side at threshold t = sfx[:, f, t + 1]
    sfx = scan["sfx"].movedim(0, -1)                           # [N, F, B, 3]
    rvec_r = sfx[n, best_f, best_t_w + 1] + eps_h
    lvec_r = svec - rvec_r
    if scan["use_fwd"] is None:
        lvec, rvec = lvec_r, rvec_r
    else:
        pfx = scan["pfx"].movedim(0, -1)
        lvec_f = pfx[n, best_f, best_t_w.clamp(min=0)] + eps_h
        rvec_f = svec - lvec_f
        uf = sel(scan["use_fwd"])[:, None]
        lvec = torch.where(uf, lvec_f, lvec_r)
        rvec = torch.where(uf, rvec_f, rvec_r)
    # both children's outputs as one [N, 2] computation (same elementwise
    # formula, so each lane rounds as a scalar call would)
    outs = calculate_splitted_leaf_output(
        torch.stack([lvec[:, 0], rvec[:, 0]], dim=-1),
        torch.stack([lvec[:, 1], rvec[:, 1]], dim=-1), hp,
        torch.stack([lvec[:, 2], rvec[:, 2]], dim=-1),
        scan["parent_output"][:, None])
    if out_range is not None:
        outs = _clamp_range(outs, out_range, lambda v: v[:, None])
    num_cat = cat_bins = None
    if cat is not None:
        is_cat_win = meta.is_categorical[best_f]               # [N]
        # the winner's position among the categorical features
        cpos = torch.cumsum(meta.is_categorical.long(), 0)[best_f] - 1
        cpos = cpos.clamp(min=0)
        win = is_cat_win[:, None]
        vals = cat["vals"][n, cpos]                            # [N, 8]
        lvec = torch.where(win, vals[:, 0:3], lvec)
        rvec = torch.where(win, vals[:, 3:6], rvec)
        outs = torch.where(win, vals[:, 6:8], outs)
        best_t_w = torch.where(is_cat_win, 0, best_t_w)
        best_dl = torch.where(is_cat_win, False, best_dl)
        num_cat = torch.where(has_valid & is_cat_win,
                              cat["num_cat"][n, cpos], 0)
        cat_bins = torch.where(win, cat["cat_bins"][n, cpos], -1)
    lrec = lvec - eps_h
    rrec = rvec - eps_h
    return SplitRecord(
        gain=torch.where(has_valid, gain_out, K_MIN_SCORE),
        feature=torch.where(has_valid, best_f, -1),
        threshold=best_t_w,
        default_left=best_dl,
        left_sum_gradient=lrec[:, 0],
        left_sum_hessian=lrec[:, 1],
        left_count=lrec[:, 2],
        left_output=outs[:, 0],
        right_sum_gradient=rrec[:, 0],
        right_sum_hessian=rrec[:, 1],
        right_count=rrec[:, 2],
        right_output=outs[:, 1],
        num_cat=num_cat, cat_bins=cat_bins)


def per_feature_net_gains(hist, sum_gradient, sum_hessian, num_data,
                          parent_output, meta: FeatureMeta,
                          hp: SplitHyperParams) -> torch.Tensor:
    """Best NET split gain of each feature, [F] (or [N, F] for a batch of
    leaves), K_MIN_SCORE where a feature has no valid split: what the
    voting-parallel learner's local vote ranks features by (ref:
    voting_parallel_tree_learner.cpp; the JAX package's
    ops/split.py:888-912)."""
    batched = hist.dim() == 4
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                    device=hist.device).reshape(-1)
    hist4 = hist if batched else hist[None]
    sums = [f32(v) for v in (sum_gradient, sum_hessian, num_data,
                             parent_output)]
    scan = _per_feature_scan(hist4, *sums, meta, hp)
    net = torch.where(scan["best_gain"] > K_MIN_SCORE,
                      scan["best_gain"] - scan["min_gain_shift"][:, None],
                      K_MIN_SCORE)
    if meta.has_cat:
        net[:, meta.cat_features] = _categorical_scan_of(
            hist4, sums, meta, hp)["net_gain"]
    if meta.penalty is not None:
        # feature_contri applies before the vote (ref: the JAX package's
        # ops/split.py:578-582)
        net = torch.where((net > K_MIN_SCORE) & (net * meta.penalty > 0.0),
                          net * meta.penalty, K_MIN_SCORE)
    return net if batched else net[0]


def forced_split_record(hist: torch.Tensor, feature: int,
                        threshold_bin: int, sum_gradient, sum_hessian,
                        num_data, parent_output,
                        feature_meta: Tuple[int, int, int],
                        hp: SplitHyperParams) -> SplitRecord:
    """The split record of a FORCED numerical split of one leaf at
    (``feature``, ``threshold_bin``), from its f32 histogram [F, B, 3]
    and its totals; ``feature_meta`` is the feature's (num_bin, missing
    type, default bin) on the host (ref: FeatureHistogram::
    GatherInfoForThresholdNumerical, feature_histogram.hpp:487-589; the
    JAX package's ops/split.py:915-974): the right side sums the bins in
    ``(threshold, hi]``, the zero-missing default bin skipped and the NaN
    bin left; ``default_left`` is always True; the gain is K_MIN_SCORE
    (an invalid split) when the net gain is not positive. The sums add
    in XLA's CPU order on the CPU (``column_sum``)."""
    dev = hist.device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    B = hist.shape[1]
    sum_gradient, num_data, parent_output = (
        f32(sum_gradient), f32(num_data), f32(parent_output))
    sum_hessian = f32(sum_hessian) + 2 * K_EPSILON
    nbin_f, miss_f, dflt_f = feature_meta
    bin_idx = torch.arange(B, device=dev)
    hi = nbin_f - 1 - (miss_f == MISSING_ENUM["nan"])
    right_mask = (bin_idx > threshold_bin) & (bin_idx <= hi)
    if miss_f == MISSING_ENUM["zero"]:
        right_mask = right_mask & (bin_idx != dflt_f)
    r = column_sum(hist[feature] * right_mask.to(hist.dtype)[:, None])
    rg, rh, rc = r[0], r[1] + K_EPSILON, r[2]
    lg, lh, lc = sum_gradient - rg, sum_hessian - rh, num_data - rc
    min_gain_shift = (leaf_gain(sum_gradient, sum_hessian, hp, num_data,
                                parent_output) + hp.min_gain_to_split)
    gain = (leaf_gain(lg, lh, hp, lc, parent_output) +
            leaf_gain(rg, rh, hp, rc, parent_output))
    valid = torch.isfinite(gain) & (gain > min_gain_shift)
    i64 = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
    return SplitRecord(
        gain=torch.where(valid, gain - min_gain_shift, K_MIN_SCORE),
        feature=torch.where(valid, i64(feature), -1),
        threshold=i64(threshold_bin),
        default_left=torch.tensor(True, device=dev),
        left_sum_gradient=lg, left_sum_hessian=lh - K_EPSILON,
        left_count=lc,
        left_output=calculate_splitted_leaf_output(lg, lh, hp, lc,
                                                   parent_output),
        right_sum_gradient=rg, right_sum_hessian=rh - K_EPSILON,
        right_count=rc,
        right_output=calculate_splitted_leaf_output(rg, rh, hp, rc,
                                                    parent_output))
