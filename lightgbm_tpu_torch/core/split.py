"""Best-split search over histograms.

The port of ``lightgbm_tpu/core/split.py`` for numerical features
(FeatureHistogram::FindBestThreshold*, feature_histogram.hpp:83-271,
443-643 of the reference). Every (feature, bin) candidate is evaluated at
once as prefix sums over the bin axis; the two missing-value directions are
two masked cumulative sums. The semantics are the JAX package's, line for
line:

- gain math with L1 soft-threshold, L2 and max_delta_step;
- missing-left (dir=-1) scan first; missing-right (dir=+1) replaces it only
  on strictly greater gain;
- MissingType::Zero skips the default bin in both scans; MissingType::NaN
  keeps the NaN bin (the last) with the defaulted side;
- ties: dir=-1 keeps the highest threshold, dir=+1 the lowest, and across
  features the lowest feature index;
- validity: min_data_in_leaf and min_sum_hessian_in_leaf on both sides, gain
  strictly above the parent's gain plus min_gain_to_split.

Every function takes leading batch dimensions: histograms ``[..., F, B, 3]``
with leaf totals ``[...]``, so the two children of a split are searched in
one call.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

K_EPSILON = 1e-15
K_MIN_SCORE = float("-inf")

# MissingType codes (bin.h:22-26)
MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2


class FeatureMeta(NamedTuple):
    """Per-feature metadata on the device (FeatureMetainfo analog)."""
    num_bin: torch.Tensor       # [F] int64 (includes the NaN bin)
    missing_type: torch.Tensor  # [F] int64
    default_bin: torch.Tensor   # [F] int64
    penalty: torch.Tensor       # [F] float32 feature_contri multiplier
    # stored layout (io/dataset.py feature_layout; feature_group.h:35-50):
    # the feature's stored column and bin offset there (EFB); None is the
    # identity layout, which the growers read when GrowParams.with_efb is
    # off
    col: Optional[torch.Tensor] = None        # [F] int64
    offset: Optional[torch.Tensor] = None     # [F] int64
    bundled: Optional[torch.Tensor] = None    # [F] bool
    # joint-coded pairs: feature bin = (stored // pack_div) % pack_mod;
    # pack_partner = the pair-mate's bin count (the marginalisation
    # width); div 1 / mod 0 = unpacked
    pack_div: Optional[torch.Tensor] = None      # [F] int64
    pack_mod: Optional[torch.Tensor] = None      # [F] int64
    pack_partner: Optional[torch.Tensor] = None  # [F] int64


class SplitParams(NamedTuple):
    """Split hyper-parameters used by the gain math."""
    lambda_l1: float
    lambda_l2: float
    max_delta_step: float
    min_data_in_leaf: int
    min_sum_hessian_in_leaf: float
    min_gain_to_split: float


class BestSplit(NamedTuple):
    """SplitInfo analog (split_info.hpp:48-130), fields over batch dims."""
    gain: torch.Tensor          # float32; -inf when unsplittable
    feature: torch.Tensor       # int64 inner feature index
    threshold: torch.Tensor     # int64 bin threshold (left: bin <= thr)
    default_left: torch.Tensor  # bool
    left_sum_grad: torch.Tensor
    left_sum_hess: torch.Tensor
    left_count: torch.Tensor    # float32 (histogram count channel)
    right_sum_grad: torch.Tensor
    right_sum_hess: torch.Tensor
    right_count: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor


def threshold_l1(s, l1: float):
    """ThresholdL1 (feature_histogram.hpp:449-452)."""
    return torch.sign(s) * torch.clamp(torch.abs(s) - l1, min=0.0)


def calculate_leaf_output(sum_grad, sum_hess, l1: float, l2: float,
                          max_delta_step: float):
    """CalculateSplittedLeafOutput (feature_histogram.hpp:454-462)."""
    ret = -threshold_l1(sum_grad, l1) / (sum_hess + l2)
    if max_delta_step > 0.0:
        ret = torch.clamp(ret, -max_delta_step, max_delta_step)
    return ret


def leaf_split_gain_given_output(sum_grad, sum_hess, l1: float, l2: float,
                                 output):
    """GetLeafSplitGainGivenOutput (feature_histogram.hpp:494-497)."""
    sg_l1 = threshold_l1(sum_grad, l1)
    return -(2.0 * sg_l1 * output + (sum_hess + l2) * output * output)


def leaf_split_gain(sum_grad, sum_hess, l1: float, l2: float,
                    max_delta_step: float):
    """GetLeafSplitGain (feature_histogram.hpp:487-491)."""
    out = calculate_leaf_output(sum_grad, sum_hess, l1, l2, max_delta_step)
    return leaf_split_gain_given_output(sum_grad, sum_hess, l1, l2, out)


def _split_gains(lg, lh, rg, rh, p: SplitParams):
    """GetSplitGains without monotone constraints
    (feature_histogram.hpp:465-478): (gain, left_output, right_output)."""
    lo = calculate_leaf_output(lg, lh, p.lambda_l1, p.lambda_l2,
                               p.max_delta_step)
    ro = calculate_leaf_output(rg, rh, p.lambda_l1, p.lambda_l2,
                               p.max_delta_step)
    gain = (leaf_split_gain_given_output(lg, lh, p.lambda_l1, p.lambda_l2, lo)
            + leaf_split_gain_given_output(rg, rh, p.lambda_l1, p.lambda_l2,
                                           ro))
    return gain, lo, ro


class PerFeatureSplit(NamedTuple):
    """Best numerical split of every feature (before the argmax), [..., F]."""
    gain: torch.Tensor          # shifted, penalty-scaled; -inf unusable
    threshold: torch.Tensor     # int64
    default_left: torch.Tensor  # bool
    left_sum_grad: torch.Tensor
    left_sum_hess: torch.Tensor
    left_count: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[..., idx[...]] (a gather: take_along_dim would also wrap negative
    indices, a copy and a kernel more per call)."""
    return torch.gather(a, -1, idx.unsqueeze(-1)).squeeze(-1)


def per_feature_split_numerical(hist: torch.Tensor, meta: FeatureMeta,
                                params: SplitParams, sum_grad: torch.Tensor,
                                sum_hess: torch.Tensor,
                                num_data: torch.Tensor,
                                feature_mask: torch.Tensor
                                ) -> PerFeatureSplit:
    """FindBestThresholdNumerical for every feature at once.

    hist [..., F, B, 3]; sum_grad, sum_hess, num_data [...] leaf totals;
    feature_mask [F] bool. Threshold t means left = bins <= t.
    """
    b = hist.shape[-2]
    dev = hist.device
    sp = params
    # leaf totals broadcast against [..., F, B]
    sg = sum_grad[..., None, None]
    sh = sum_hess[..., None, None] + 2 * K_EPSILON
    nd = num_data[..., None, None]

    bins = torch.arange(b, device=dev)[None, :]                  # [1, B]
    num_bin = meta.num_bin[:, None]                              # [F, 1]
    has_nan_bin = meta.missing_type[:, None] == MISSING_NAN
    nb_numeric = num_bin - has_nan_bin.to(num_bin.dtype)
    is_zero_type = meta.missing_type[:, None] == MISSING_ZERO
    keep = (bins < nb_numeric) & ~(is_zero_type
                                   & (bins == meta.default_bin[:, None]))

    zero = hist.new_zeros(())
    g = torch.where(keep, hist[..., 0], zero)
    h = torch.where(keep, hist[..., 1], zero)
    c = torch.where(keep, hist[..., 2], zero)
    pg = torch.cumsum(g, dim=-1)     # prefix over bins: left of threshold t
    ph = torch.cumsum(h, dim=-1)
    pc = torch.cumsum(c, dim=-1)
    tg, th, tc = pg[..., -1:], ph[..., -1:], pc[..., -1:]

    gain_shift = leaf_split_gain(sg, sh, sp.lambda_l1, sp.lambda_l2,
                                 sp.max_delta_step)
    min_gain_shift = gain_shift + sp.min_gain_to_split

    def eval_candidates(lg, lh, lc):
        rg_ = sg - lg
        rh_ = sh - lh
        rc_ = nd - lc
        ok = ((lc >= sp.min_data_in_leaf) & (rc_ >= sp.min_data_in_leaf)
              & (lh >= sp.min_sum_hessian_in_leaf)
              & (rh_ >= sp.min_sum_hessian_in_leaf))
        gain, lo, ro = _split_gains(lg, lh, rg_, rh_, sp)
        ok = ok & (gain > min_gain_shift)
        return torch.where(ok, gain, K_MIN_SCORE), lo, ro

    # ---- missing-left scan (reference dir=-1, runs first) ---------------
    # the right side accumulates from the top numeric bin; the default and
    # NaN bins fall left by subtraction
    rgL = tg - pg
    rhL = (th - ph) + K_EPSILON
    rcL = tc - pc
    lgL = sg - rgL
    lhL = sh - rhL
    lcL = nd - rcL
    gainL, loL, roL = eval_candidates(lgL, lhL, lcL)
    validL = (bins <= nb_numeric - 2) & ~(
        is_zero_type & (bins == meta.default_bin[:, None] - 1))
    gainL = torch.where(validL, gainL, K_MIN_SCORE)
    # tie-break: the highest threshold wins -> argmax over reversed bins
    idxL = (b - 1) - torch.argmax(torch.flip(gainL, dims=[-1]), dim=-1)
    bestL = _take(gainL, idxL)

    # ---- missing-right scan (reference dir=+1) --------------------------
    lgR = pg + 0.0
    lhR = ph + K_EPSILON
    lcR = pc
    gainR, loR, roR = eval_candidates(lgR, lhR, lcR)
    validR = (bins <= nb_numeric - 2 + has_nan_bin.to(num_bin.dtype)) & ~(
        is_zero_type & (bins == meta.default_bin[:, None]))
    # only two-direction features run this scan (missing type != None and
    # num_bin > 2, feature_histogram.hpp:88-99)
    two_dir = (meta.missing_type[:, None] != MISSING_NONE) & (num_bin > 2)
    gainR = torch.where(validR & two_dir, gainR, K_MIN_SCORE)
    idxR = torch.argmax(gainR, dim=-1)
    bestR = _take(gainR, idxR)

    use_right = bestR > bestL
    per_feat_gain = torch.where(use_right, bestR, bestL)
    per_feat_thr = torch.where(use_right, idxR, idxL)
    # "fix direction error" for 2-bin NaN features (feature_histogram.hpp:
    # 101-104)
    fix2bin = (meta.missing_type == MISSING_NAN) & (meta.num_bin <= 2)
    default_left = ~use_right & ~fix2bin

    def pick(right, left):
        return torch.where(use_right, _take(right, idxR), _take(left, idxL))

    usable = feature_mask & (meta.num_bin > 1)
    per_feat_gain = torch.where(usable, per_feat_gain, K_MIN_SCORE)
    # the feature penalty multiplies the shifted gain (FindBestThreshold :81)
    out_gain = (per_feat_gain - min_gain_shift[..., 0]) * meta.penalty
    return PerFeatureSplit(
        gain=out_gain,
        threshold=per_feat_thr,
        default_left=default_left,
        left_sum_grad=pick(lgR, lgL),
        left_sum_hess=pick(lhR, lhL) - K_EPSILON,  # strip the safety pad
        left_count=pick(lcR, lcL),
        left_output=pick(loR, loL),
        right_output=pick(roR, roL),
    )


def find_best_split(hist: torch.Tensor, meta: FeatureMeta,
                    params: SplitParams, sum_grad: torch.Tensor,
                    sum_hess: torch.Tensor, num_data: torch.Tensor,
                    feature_mask: torch.Tensor) -> BestSplit:
    """Best split over all features: the per-leaf SplitInfo argmax
    (serial_tree_learner.cpp:506-591), over leading batch dims."""
    pf = per_feature_split_numerical(hist, meta, params, sum_grad, sum_hess,
                                     num_data, feature_mask)
    best_f = torch.argmax(pf.gain, dim=-1)
    gain = _take(pf.gain, best_f)
    lg = _take(pf.left_sum_grad, best_f)
    lh = _take(pf.left_sum_hess, best_f)
    lc = _take(pf.left_count, best_f)
    return BestSplit(
        gain=torch.where(torch.isfinite(gain), gain, K_MIN_SCORE),
        feature=best_f,
        threshold=_take(pf.threshold, best_f),
        default_left=_take(pf.default_left, best_f),
        left_sum_grad=lg, left_sum_hess=lh, left_count=lc,
        right_sum_grad=sum_grad - lg,
        right_sum_hess=sum_hess - lh,
        right_count=num_data - lc,
        left_output=_take(pf.left_output, best_f),
        right_output=_take(pf.right_output, best_f),
    )
