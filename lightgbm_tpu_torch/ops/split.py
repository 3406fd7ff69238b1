"""Vectorized best-split search over feature histograms, numerical features.

Port of ``lightgbm_tpu/ops/split.py`` (ref:
src/treelearner/feature_histogram.hpp:166 FindBestThreshold, :838
FindBestThresholdSequentially, :712-830 gain/output formulas).

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
from typing import NamedTuple

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

    @property
    def use_l1(self) -> bool:
        return self.lambda_l1 > 0.0

    @property
    def use_smoothing(self) -> bool:
        return self.path_smooth > K_EPSILON


class FeatureMeta(NamedTuple):
    """Per-used-feature metadata as device tensors [F] (int32), plus
    whether any feature has a missing type (known on the host, so the
    scan can drop the forward direction without reading the device)."""
    num_bin: torch.Tensor
    missing_type: torch.Tensor
    default_bin: torch.Tensor
    has_missing: bool = True

    @staticmethod
    def from_mappers(mappers, device="cpu") -> "FeatureMeta":
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
        miss = [MISSING_ENUM[m.missing_type] for m in mappers]
        return FeatureMeta(
            num_bin=i32([m.num_bin for m in mappers]),
            missing_type=i32(miss),
            default_bin=i32([m.default_bin for m in mappers]),
            has_missing=any(v != MISSING_ENUM["none"] for v in miss))


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


def pack_record_rows(rec: SplitRecord) -> torch.Tensor:
    """SplitRecord -> packed f32 [..., 12] rows in the grower's column
    layout: [gain, feature, threshold, default_left, left (g, h, count,
    output), right (g, h, count, output)]. Bin thresholds and feature ids
    are < 2^24, exact in f32."""
    return torch.stack([v.to(torch.float32) for v in rec], dim=-1)


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

def best_split_for_leaf(hist: torch.Tensor, sum_gradient, sum_hessian,
                        num_data, parent_output, meta: FeatureMeta,
                        hp: SplitHyperParams) -> SplitRecord:
    """Best split over all features for one leaf, or for a batch of them.

    Parameters
    ----------
    hist : f32 [F, B, 3] (sum_grad, sum_hess, count) per feature per bin,
        or [N, F, B, 3] for N leaves.
    sum_gradient, sum_hessian, num_data, parent_output : f32 leaf totals,
        scalars (or [N]); the count is a float.

    The arithmetic mirrors FindBestThresholdSequentially with the
    kEpsilon seeding: the accumulating side starts at kEpsilon and the
    parent hessian carries +2 kEpsilon (ref: feature_histogram.hpp:172).
    """
    batched = hist.dim() == 4
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                    device=hist.device).reshape(-1)
    hist4 = hist if batched else hist[None]
    rec = _select_across_features(
        _per_feature_scan(hist4, f32(sum_gradient), f32(sum_hessian),
                          f32(num_data), f32(parent_output), meta, hp),
        hp)
    return rec if batched else SplitRecord(*(v[0] for v in rec))


def _per_feature_scan(hist, sum_gradient, sum_hessian, num_data,
                      parent_output, meta: FeatureMeta,
                      hp: SplitHyperParams) -> dict:
    """The two-direction cumulative scan over hist [N, F, B, 3] with leaf
    totals [N]; returns per-feature best arrays [N, F] and what the
    selection needs."""
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
        gains = split_gain(lg, lh, rg, rh, hp, lc, rc, col(parent_output))
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
    sfx = torch.cumsum((ghc * rev_mask).flip(-1), dim=-1).flip(-1)
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
    gains_rev_u = torch.where(valid_rev & thr_ok_u, gains_rev_u,
                              K_MIN_SCORE)
    # reverse ties -> larger threshold (first seen high-to-low)
    rev_best_u = (B - 1) - torch.argmax(gains_rev_u.flip(-1), dim=-1)
    rev_best_gain = torch.gather(gains_rev_u, -1, rev_best_u[..., None])[..., 0]
    rev_best_t = rev_best_u - 1
    out = dict(min_gain_shift=min_gain_shift, sfx=sfx, pfx=None,
               use_fwd=None, sum_gradient=sum_gradient,
               sum_hessian2=sum_hessian, num_data=num_data,
               parent_output=parent_output)

    if not meta.has_missing:
        # with no missing values anywhere the forward scan cannot win
        # (the reference's run_forward gate, feature_histogram.hpp:304)
        out.update(best_t=rev_best_t, best_gain=rev_best_gain,
                   best_dl=(~dl_false[:, 0]).expand(N, F))
        return out

    # ---------------- FORWARD scan: left side accumulates 0..t -------------
    fwd_mask = (acc_mask & (bin_idx <= nbin - 2)).to(hist.dtype)
    pfx = torch.cumsum(ghc * fwd_mask, dim=-1)
    lg_acc = pfx[0]
    lh_acc = pfx[1] + K_EPSILON
    lc_acc = pfx[2]
    rg_fwd, rh_fwd, rc_fwd = side_stats(lg_acc, lh_acc, lc_acc)
    gains_fwd, valid_fwd = gains_and_validity(lg_acc, lh_acc, lc_acc,
                                              rg_fwd, rh_fwd, rc_fwd)
    thr_ok_fwd = ((bin_idx <= nbin - 2) & in_range & run_forward
                  & ~(skip_default & (bin_idx == dflt)))
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


def _select_across_features(scan: dict, hp: SplitHyperParams) -> SplitRecord:
    """Cross-feature selection over _per_feature_scan output: the winner
    by (max net gain, smaller feature index), and its side sums fetched
    from the scan's cumulative sums at (feature, iteration) with the same
    f32 operations the scan used."""
    best_gain = scan["best_gain"]                              # [N, F]
    best_t = scan["best_t"]
    N = best_gain.shape[0]
    dev = best_gain.device
    valid_any = best_gain > K_MIN_SCORE
    net_gain = torch.where(valid_any,
                           best_gain - scan["min_gain_shift"][:, None],
                           K_MIN_SCORE)
    best_f = torch.argmax(net_gain, dim=-1)                    # [N]
    sel = lambda a: torch.gather(a, -1, best_f[:, None])[:, 0]
    gain_out = sel(net_gain)
    has_valid = sel(valid_any)
    best_t_w = sel(best_t)

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
    lrec = lvec - eps_h
    rrec = rvec - eps_h
    return SplitRecord(
        gain=torch.where(has_valid, gain_out, K_MIN_SCORE),
        feature=torch.where(has_valid, best_f, -1),
        threshold=best_t_w,
        default_left=sel(scan["best_dl"]),
        left_sum_gradient=lrec[:, 0],
        left_sum_hessian=lrec[:, 1],
        left_count=lrec[:, 2],
        left_output=outs[:, 0],
        right_sum_gradient=rrec[:, 0],
        right_sum_hessian=rrec[:, 1],
        right_count=rrec[:, 2],
        right_output=outs[:, 1])
