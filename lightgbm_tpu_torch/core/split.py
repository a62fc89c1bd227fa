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

Categorical features (FindBestThresholdCategorical, :110-271) take their own
finder, ``per_feature_split_categorical``, run over the categorical
features' histograms alone: one-vs-rest below ``max_cat_to_onehot`` bins,
otherwise the sorted-subset scan in both directions. Its result is a
bin-space bitset of the categories going left, eight 32-bit words in int64
(PyTorch has no shifts or ORs on uint32 on CUDA).

Every function takes leading batch dimensions: histograms ``[..., F, B, 3]``
with leaf totals ``[...]``, so the two children of a split are searched in
one call.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

K_EPSILON = 1e-15
K_MIN_SCORE = float("-inf")

# MissingType codes (bin.h:22-26)
MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

# a bin-space categorical bitset: 8 words of 32 bits, one bit per bin
CAT_WORDS = 8


@functools.lru_cache(maxsize=64)
def device_index(values: tuple, device: torch.device) -> torch.Tensor:
    """A static tuple of indices as an int64 tensor on ``device``, copied
    once: a copy from the host on every search would wait for the
    stream."""
    return torch.as_tensor(values, dtype=torch.int64, device=device)


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
    # categorical features (BinType.CATEGORICAL); None when the data has
    # none, and the numerical finder then skips the mask
    is_categorical: Optional[torch.Tensor] = None  # [F] bool


class SplitParams(NamedTuple):
    """Split hyper-parameters used by the gain math."""
    lambda_l1: float
    lambda_l2: float
    max_delta_step: float
    min_data_in_leaf: int
    min_sum_hessian_in_leaf: float
    min_gain_to_split: float
    # categorical (the reference's defaults)
    max_cat_threshold: int = 32
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_to_onehot: int = 4
    min_data_per_group: int = 100
    # the inner indices of the categorical features, which the categorical
    # finder runs over; () = none, and the search is numerical only
    cat_features: tuple = ()


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
    # categorical: the bins going left, as a bitset (see CAT_WORDS); a
    # numerical split built by hand may leave them out, and routes
    # numerically (``with_cat`` off)
    is_categorical: Optional[torch.Tensor] = None  # bool
    cat_bitset: Optional[torch.Tensor] = None      # [..., 8] int64


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
    if meta.is_categorical is not None:
        usable = usable & ~meta.is_categorical
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


def _split_gains_l2(lg, lh, rg, rh, p: SplitParams, l2: float):
    """GetSplitGains with an explicit l2 (the categorical finder adds
    cat_l2, feature_histogram.hpp:171): (gain, left_output,
    right_output)."""
    lo = calculate_leaf_output(lg, lh, p.lambda_l1, l2, p.max_delta_step)
    ro = calculate_leaf_output(rg, rh, p.lambda_l1, l2, p.max_delta_step)
    gain = (leaf_split_gain_given_output(lg, lh, p.lambda_l1, l2, lo)
            + leaf_split_gain_given_output(rg, rh, p.lambda_l1, l2, ro))
    return gain, lo, ro


def bin_membership_bitset(member: torch.Tensor) -> torch.Tensor:
    """[..., B] bool (B <= 256) -> [..., 8] int64 bitset over bin indices,
    32 bits a word (SplitInfo cat_threshold as a fixed 256-bit set)."""
    b = member.shape[-1]
    width = 32 * CAT_WORDS
    bits = member.to(torch.int64) << (torch.arange(b, device=member.device)
                                      & 31)
    bits = torch.nn.functional.pad(bits, (0, width - b))
    return bits.reshape(tuple(member.shape[:-1]) + (CAT_WORDS, 32)).sum(-1)


def per_feature_split_categorical(hist: torch.Tensor, meta: FeatureMeta,
                                  params: SplitParams,
                                  sum_grad: torch.Tensor,
                                  sum_hess: torch.Tensor,
                                  num_data: torch.Tensor,
                                  feature_mask: torch.Tensor
                                  ) -> Tuple[PerFeatureSplit, torch.Tensor]:
    """FindBestThresholdCategorical (feature_histogram.hpp:110-271) for the
    categorical features ``params.cat_features`` at once (the JAX
    package's ``per_feature_split_categorical``, core/split.py:345-477).

    hist [..., F, B, 3] over every feature; returns the best split of each
    categorical feature, fields [..., Fc], and its bin-space bitset of the
    categories going left [..., Fc, 8] int64. Bin 0 is the catch-all of
    unseen, negative and NaN values and always goes right.

    - one-vs-rest when ``num_bin <= max_cat_to_onehot``: each real bin
      alone on the left;
    - otherwise the sorted-subset scan: the bins with at least
      ``cat_smooth`` rows, sorted (stably) by g / (h + cat_smooth) in both
      directions, each prefix of at most min(max_cat_threshold, (eligible +
      1) / 2) bins a candidate, evaluated only where the rows gathered
      since the last evaluation reach ``min_data_per_group``, with l2 +=
      cat_l2. That group count is a sequential scan: a loop of at most
      ``max_cat_threshold`` steps, each over every leaf, feature and
      direction at once.
    """
    dev = hist.device
    sp = params
    cf = device_index(sp.cat_features, dev)
    h3 = hist.index_select(-3, cf)                           # [..., Fc, B, 3]
    b = h3.shape[-2]
    num_bin = meta.num_bin.index_select(0, cf)[:, None]      # [Fc, 1]
    sg = sum_grad[..., None, None]
    sh = sum_hess[..., None, None] + 2 * K_EPSILON
    nd = num_data[..., None, None]
    bins = torch.arange(b, device=dev)
    is_real = (bins >= 1) & (bins < num_bin)                 # [Fc, B]
    zero = hist.new_zeros(())
    g = torch.where(is_real, h3[..., 0], zero)
    h = torch.where(is_real, h3[..., 1], zero)
    c = torch.where(is_real, h3[..., 2], zero)

    gain_shift = leaf_split_gain(sg, sh, sp.lambda_l1, sp.lambda_l2,
                                 sp.max_delta_step)
    min_gain_shift = gain_shift + sp.min_gain_to_split       # [..., 1, 1]

    # ---- one-vs-rest (use_onehot, :130-161) ------------------------------
    oh_g = sg - g
    oh_h = sh - h - K_EPSILON
    oh_c = nd - c
    ok1 = (is_real & (c >= sp.min_data_in_leaf)
           & (h >= sp.min_sum_hessian_in_leaf)
           & (oh_c >= sp.min_data_in_leaf)
           & (oh_h >= sp.min_sum_hessian_in_leaf))
    gain1, lo1, ro1 = _split_gains_l2(g, h + K_EPSILON, oh_g, oh_h, sp,
                                      sp.lambda_l2)
    gain1 = torch.where(ok1 & (gain1 > min_gain_shift), gain1, K_MIN_SCORE)
    t1 = torch.argmax(gain1, dim=-1)                         # [..., Fc]
    onehot = (_take(gain1, t1), _take(g, t1), _take(h, t1), _take(c, t1),
              _take(lo1, t1), _take(ro1, t1))
    member1 = bins == t1[..., None]

    # ---- sorted-subset scan (:162-235), both directions at once ---------
    # a direction axis of 2 before the bins: ascending, then descending
    # g / (h + cat_smooth); the descending key is -ctr, with ineligible
    # bins last in both (a stable sort, as jnp.argsort is)
    elig = is_real & (c >= sp.cat_smooth)                    # [..., Fc, B]
    n_elig = elig.sum(dim=-1, keepdim=True)[..., None]       # [..., Fc, 1, 1]
    ctr = g / (h + sp.cat_smooth)
    inf = torch.full((), float("inf"), device=dev)
    key = torch.stack([torch.where(elig, ctr, inf),
                       torch.where(elig, -ctr, inf)], dim=-2)  # [.., 2, B]
    order = torch.argsort(key, dim=-1, stable=True)
    # only the first min(max_cat_threshold, B) positions can be evaluated
    t = max(1, min(sp.max_cat_threshold, b))
    order_t = order[..., :t]
    gs, hs, cs = (torch.gather(v.unsqueeze(-2).expand(key.shape), -1,
                               order_t) for v in (g, h, c))
    pg = torch.cumsum(gs, dim=-1)
    ph = torch.cumsum(hs, dim=-1) + K_EPSILON
    pc = torch.cumsum(cs, dim=-1)
    i = torch.arange(t, device=dev)
    max_num_cat = torch.clamp(torch.div(n_elig + 1, 2, rounding_mode="floor"),
                              max=sp.max_cat_threshold)
    in_range = (i < max_num_cat) & (i < n_elig)
    left_ok = (pc >= sp.min_data_in_leaf) & (ph >= sp.min_sum_hessian_in_leaf)
    sg2, sh2, nd2 = sg[..., None], sh[..., None], nd[..., None]
    rc = nd2 - pc
    rh = sh2 - ph
    stop = ((rc < sp.min_data_in_leaf) | (rc < sp.min_data_per_group)
            | (rh < sp.min_sum_hessian_in_leaf))
    # the scan's `break` fires only where reached (left_ok), ending that
    # position and every later one (:204-210)
    alive = torch.cumsum((left_ok & stop).to(torch.int32), dim=-1) == 0
    can = in_range & alive & left_ok
    # the group count: rows gathered since the last evaluation, reset by
    # each one; a position evaluates when it may and the count reaches
    # min_data_per_group (folded into a threshold of inf where it may not)
    need = torch.where(can, torch.full((), float(sp.min_data_per_group),
                                       device=dev), inf)
    cnt = torch.zeros_like(cs[..., 0])
    do_eval = []
    for step in range(t):
        cnt = cnt + cs[..., step]
        hit = cnt >= need[..., step]
        cnt = torch.where(hit, zero, cnt)
        do_eval.append(hit)
    do_eval = torch.stack(do_eval, dim=-1)
    gain2, lo2, ro2 = _split_gains_l2(pg, ph, sg2 - pg, sh2 - ph, sp,
                                      sp.lambda_l2 + sp.cat_l2)
    gain2 = torch.where(do_eval & (gain2 > min_gain_shift[..., None]), gain2,
                        K_MIN_SCORE)
    ib = torch.argmax(gain2, dim=-1)                         # [..., Fc, 2]
    sub = (_take(gain2, ib), _take(pg, ib), _take(ph, ib) - K_EPSILON,
           _take(pc, ib), _take(lo2, ib), _take(ro2, ib))
    # the bins at sorted positions 0..ib go left: the inverse permutation's
    # rank test, as a scatter of the first t positions
    left_sorted = i <= ib[..., None]
    member2 = torch.zeros(key.shape, dtype=torch.bool, device=dev).scatter_(
        -1, order_t, left_sorted) & elig.unsqueeze(-2)
    # ascending wins ties (jnp.where(asc >= desc))
    use_desc = sub[0][..., 1] > sub[0][..., 0]                # [..., Fc]
    dsel = use_desc.to(torch.int64)[..., None]
    sub = tuple(torch.gather(v, -1, dsel)[..., 0] for v in sub)
    member2 = torch.where(use_desc[..., None], member2[..., 1, :],
                          member2[..., 0, :])

    use_onehot = (num_bin <= sp.max_cat_to_onehot)[:, 0]     # [Fc]
    gain, lg, lh, lc, lo, ro = (torch.where(use_onehot, o, v)
                                for o, v in zip(onehot, sub))
    member = torch.where(use_onehot[:, None], member1, member2)
    usable = (feature_mask.index_select(0, cf)
              & (meta.num_bin.index_select(0, cf) > 1))
    out_gain = torch.where(
        usable & torch.isfinite(gain),
        (gain - min_gain_shift[..., 0]) * meta.penalty.index_select(0, cf),
        K_MIN_SCORE)
    zeros = torch.zeros_like(lg)
    pf = PerFeatureSplit(
        gain=out_gain, threshold=zeros.to(torch.int64),
        default_left=zeros.to(torch.bool), left_sum_grad=lg,
        left_sum_hess=lh, left_count=lc, left_output=lo, right_output=ro)
    return pf, bin_membership_bitset(member)


def find_best_split(hist: torch.Tensor, meta: FeatureMeta,
                    params: SplitParams, sum_grad: torch.Tensor,
                    sum_hess: torch.Tensor, num_data: torch.Tensor,
                    feature_mask: torch.Tensor) -> BestSplit:
    """Best split over all features, numerical and (where
    ``params.cat_features`` lists any) categorical, each feature by its own
    finder (feature_histogram.hpp:68-108): the per-leaf SplitInfo argmax
    (serial_tree_learner.cpp:506-591), over leading batch dims."""
    pf = per_feature_split_numerical(hist, meta, params, sum_grad, sum_hess,
                                     num_data, feature_mask)
    cat = params.cat_features
    if cat:
        pfc, bitsets = per_feature_split_categorical(
            hist, meta, params, sum_grad, sum_hess, num_data, feature_mask)
        cf = device_index(cat, hist.device)
        pf = PerFeatureSplit(*[nv.index_copy(-1, cf, cv)
                               for nv, cv in zip(pf, pfc)])
    best_f = torch.argmax(pf.gain, dim=-1)
    gain = _take(pf.gain, best_f)
    lg = _take(pf.left_sum_grad, best_f)
    lh = _take(pf.left_sum_hess, best_f)
    lc = _take(pf.left_count, best_f)
    if cat:
        is_cat = meta.is_categorical.index_select(0, best_f.reshape(-1)) \
            .reshape(best_f.shape)
        # the winner's place among the categorical features (0 where it is
        # numerical, whose bitset is then cleared)
        place = device_index(tuple(cat.index(f) if f in cat else 0
                                   for f in range(pf.gain.shape[-1])),
                             hist.device)
        at = place.index_select(0, best_f.reshape(-1)).reshape(best_f.shape)
        cat_bitset = torch.gather(
            bitsets, -2, at[..., None, None].expand(
                tuple(at.shape) + (1, CAT_WORDS)))[..., 0, :]
        cat_bitset = torch.where(is_cat[..., None], cat_bitset, 0)
    else:
        is_cat = torch.zeros_like(best_f, dtype=torch.bool)
        cat_bitset = torch.zeros(tuple(best_f.shape) + (CAT_WORDS,),
                                 dtype=torch.int64, device=hist.device)
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
        is_categorical=is_cat, cat_bitset=cat_bitset,
    )
