"""Parallel tree learners: the collective seams of the growers.

The port of ``lightgbm_tpu/parallel/learners.py`` (the reference's
parallel_tree_learner.h), for a rank group of ``parallel/network.py``.
A grower asks its learner three things: the leaf totals summed over the
ranks (``sums``), a histogram reduced over the ranks (``reduce``), and
the best splits of a batch of leaves from their (reduced) histograms and
global totals (``best``). ``make_learner`` picks one by ``tree_learner``
and the grower:

- **serial** (``SerialLearner``): no group; ``best`` is
  ``find_best_split`` on the per-feature views, the port's one-device
  search, unchanged.
- **psum** (``PsumLearner``): the data-parallel all-reduce of every
  histogram (the exact, batched and partitioned batched growers under
  ``tree_learner=data``; the frontier one with ``tpu_frontier_rs=false``
  or float64).
- **data_rs** (``DataRSLearner``, data_parallel_tree_learner.cpp:
  146-161): the frontier wave's histograms reduce-scattered over the
  feature axis, rank d keeping the summed block ``[d*fs, (d+1)*fs)``;
  each rank searches its block and one all-gather of packed best records
  elects the winners (SyncUpGlobalBestSplit, parallel_tree_learner.h:
  186-230). Its histogram pool holds the rank's block.
- **voting** (``VotingLearner``, PV-Tree, voting_parallel_tree_learner.
  cpp:166-360): histograms stay local; each rank nominates its local top
  ``top_k`` features a leaf from local gains, an all-gather of the
  nominations elects up to ``2 top_k`` by vote, and only their columns are
  all-reduced. The search runs on them with the global totals, so an
  elected gain is exact and only the choice of candidates approximates;
  ``top_k >= F`` elects every feature.
- **feature** (``FeatureLearner``, feature_parallel_tree_learner.cpp:
  30-60): every rank holds every row and histograms only its columns (a
  bin-balanced assignment, ``mesh.assign_columns``); the best splits are
  the ranks' local ones elected by the same all-gather.

Ties keep ``find_best_split``'s rule, the first maximum, the lowest
feature index: each rank's search takes its lowest feature among equal
gains, and the election the lowest feature among the ranks' (the lowest
rank, as the JAX package's argmax, where the blocks of data_rs are
contiguous in rank order). Feature-parallel keeps each rank's columns in
index order, so its trees are the serial ones; the JAX package's keep the
assignment's order and may take another feature of equal gain.

A best record is ``RECORD_LANES`` lanes in the histograms' dtype: gain,
feature, threshold, default_left, the six child sums, the two outputs,
is_categorical and the eight bitset words. Integer fields are bitcast
(int32 into float32, int64 into float64) and the words kept whole, so
packing and unpacking are lossless; a float32 record has the JAX
package's bits.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from ..core.split import (BestSplit, FeatureMeta, SplitParams,
                          find_best_split, per_feature_split_categorical,
                          per_feature_split_numerical, device_index)

RECORD_LANES = 21


# ------------------------------------------------------------- records
def _int_lanes(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 values as lanes of ``dtype``: float32 lanes hold their int32
    bits (32-bit words wrap to int32 first), float64 lanes their int64
    bits."""
    if dtype == torch.float64:
        return v.to(torch.int64).view(torch.float64)
    w = v.to(torch.int64) & 0xFFFFFFFF
    w = torch.where(w >= 2 ** 31, w - 2 ** 32, w)
    return w.to(torch.int32).view(torch.float32)


def _lanes_int(lanes: torch.Tensor, words: bool = False) -> torch.Tensor:
    """The inverse of ``_int_lanes``, as int64 (32-bit words unsigned)."""
    if lanes.dtype == torch.float64:
        return lanes.contiguous().view(torch.int64)
    v = lanes.contiguous().view(torch.int32).to(torch.int64)
    return v & 0xFFFFFFFF if words else v


def pack_best_record(bs: BestSplit) -> torch.Tensor:
    """A batched BestSplit (fields ``[K]``, bitsets ``[K, 8]``) as one
    ``[K, RECORD_LANES]`` tensor in the gain's dtype, so the election
    needs one all-gather."""
    dt = bs.gain.dtype
    k = bs.gain.shape[0]

    def col(v):
        return v.reshape(k, 1).to(dt)

    rec = torch.cat(
        [col(bs.gain), _int_lanes(bs.feature, dt).reshape(k, 1),
         _int_lanes(bs.threshold, dt).reshape(k, 1), col(bs.default_left)]
        + [col(getattr(bs, f)) for f in BestSplit._fields[4:12]]
        + [col(bs.is_categorical),
           _int_lanes(bs.cat_bitset, dt).reshape(k, -1)], dim=1)
    assert rec.shape[1] == RECORD_LANES, rec.shape
    return rec


def unpack_best_record(rec: torch.Tensor) -> BestSplit:
    """The inverse of ``pack_best_record``."""
    return BestSplit(
        gain=rec[:, 0], feature=_lanes_int(rec[:, 1]),
        threshold=_lanes_int(rec[:, 2]), default_left=rec[:, 3] > 0.5,
        **{f: rec[:, 4 + i] for i, f in enumerate(BestSplit._fields[4:12])},
        is_categorical=rec[:, 12] > 0.5,
        cat_bitset=_lanes_int(rec[:, 13:21], words=True))


def elect_best_records(bs: BestSplit, comm) -> BestSplit:
    """Per-leaf global best split: one all-gather of the packed ``[K, R]``
    records, then, among the ranks whose gain is the largest, the one with
    the lowest feature index, the lowest rank where they tie too (the JAX
    package's argmax, whose first maximum is the lowest rank, is the same
    choice where the ranks hold contiguous blocks of features)."""
    allrec = comm.all_gather(pack_best_record(bs))            # [P, K, R]
    gain = allrec[:, :, 0]
    feature = _lanes_int(allrec[:, :, 1])
    top = gain == gain.max(dim=0, keepdim=True).values
    winner = torch.argmin(torch.where(top, feature, 2 ** 62), dim=0)  # [K]
    sel = torch.gather(allrec, 0, winner[None, :, None].expand(
        1, allrec.shape[1], allrec.shape[2]))[0]
    return unpack_best_record(sel)


# sync_best_split (grow.py:420-441 of the JAX package) is the same election
sync_best_split = elect_best_records


# ------------------------------------------------------------- helpers
def slice_meta(meta: FeatureMeta, idx: torch.Tensor) -> FeatureMeta:
    """The metadata of features ``idx`` (a local view), with an identity
    stored layout."""
    out = {}
    for name, v in zip(FeatureMeta._fields, meta):
        out[name] = None if v is None else v.index_select(0, idx)
    out["col"] = torch.arange(idx.shape[0], device=idx.device)
    if meta.offset is not None:
        out["offset"] = torch.zeros_like(out["offset"])
    return FeatureMeta(**out)


def local_split_params(sp: SplitParams, global_ids: List[int]
                       ) -> SplitParams:
    """``sp`` over the features ``global_ids``: the categorical features
    renumbered to their local places."""
    cats = set(sp.cat_features)
    return sp._replace(cat_features=tuple(
        i for i, g in enumerate(global_ids) if g in cats))


def per_feature_gains(hist, meta, sp: SplitParams, sg, sh, cnt,
                      feature_mask) -> torch.Tensor:
    """``[..., F]`` best gain of every feature, numerical and categorical
    each by its finder (the JAX package's ``per_feature_split_merged``)."""
    gain = per_feature_split_numerical(hist, meta, sp, sg, sh, cnt,
                                       feature_mask).gain
    if sp.cat_features:
        pfc, _ = per_feature_split_categorical(hist, meta, sp, sg, sh, cnt,
                                               feature_mask)
        gain = gain.index_copy(-1, device_index(sp.cat_features,
                                                hist.device), pfc.gain)
    return gain


def _top(values: torch.Tensor, k: int):
    """``lax.top_k``'s order over the last axis: descending, equal values
    lower index first."""
    s = torch.sort(values, dim=-1, descending=True, stable=True)
    return s.values[..., :k], s.indices[..., :k]


# ------------------------------------------------------------- learners
class SerialLearner:
    """One device: ``search`` (the grower's own) and nothing to reduce."""
    kind = "serial"

    def __init__(self, search):
        self._search = search

    def sums(self, t):
        return t

    def reduce(self, hist):
        return hist

    def best(self, hist, sg, sh, cnt, mn=None, mx=None, pen=None):
        return self._search(hist, sg, sh, cnt, mn, mx, pen)


class PsumLearner(SerialLearner):
    """Data-parallel: every histogram and total all-reduced, every rank
    searching every feature."""
    kind = "psum"

    def __init__(self, search, comm):
        super().__init__(search)
        self.comm = comm

    def sums(self, t):
        return self.comm.all_reduce_sum_(t)

    def reduce(self, hist):
        return self.comm.all_reduce_sum_(hist)


class DataRSLearner(PsumLearner):
    """Data-parallel with reduce-scattered histograms and the packed
    best-record election. The feature axis divides by the ranks (gbdt.py
    pads it)."""
    kind = "data_rs"

    def __init__(self, comm, meta: FeatureMeta, sp: SplitParams,
                 feature_mask: torch.Tensor):
        super().__init__(None, comm)
        self.meta, self.sp, self.feature_mask = meta, sp, feature_mask
        self._local = {}

    def reduce(self, hist):
        return self.comm.reduce_scatter_sum(hist, hist.dim() - 3)

    def _block(self, fs: int):
        if fs not in self._local:
            base = self.comm.rank * fs
            ids = list(range(base, base + fs))
            idx = torch.arange(base, base + fs,
                               device=self.feature_mask.device)
            self._local[fs] = (base, slice_meta(self.meta, idx),
                               local_split_params(self.sp, ids),
                               self.feature_mask.index_select(0, idx))
        return self._local[fs]

    def best(self, hist, sg, sh, cnt, mn=None, mx=None, pen=None):
        assert pen is None, "CEGB does not ride the reduce-scatter learner"
        base, meta_l, sp_l, fmask_l = self._block(hist.shape[-3])
        bs = find_best_split(hist, meta_l, sp_l, sg, sh, cnt, fmask_l,
                             mn, mx)
        return elect_best_records(bs._replace(feature=bs.feature + base),
                                  self.comm)


class VotingLearner(PsumLearner):
    """PV-Tree: local histograms, a top-k vote, and the elected columns
    all-reduced."""
    kind = "voting"

    def __init__(self, comm, meta: FeatureMeta, sp: SplitParams,
                 feature_mask: torch.Tensor, top_k: int):
        super().__init__(None, comm)
        self.meta, self.sp, self.feature_mask = meta, sp, feature_mask
        f = int(feature_mask.shape[0])
        self.k = min(top_k, f)
        self.k2 = min(2 * top_k, f)

    def reduce(self, hist):
        return hist          # histograms stay local; the vote reduces

    def best(self, hist, sg, sh, cnt, mn=None, mx=None, pen=None):
        """Hist ``[K, F, B, 3]`` local, totals ``[K]`` global."""
        assert pen is None, "CEGB does not ride the voting learner"
        comm, f = self.comm, self.feature_mask.shape[0]
        kk = hist.shape[0]
        # local leaf totals from the local histogram: every local row lands
        # in exactly one bin of feature 0
        local = hist[:, 0].sum(dim=1)                             # [K, 3]
        gains = per_feature_gains(hist, self.meta, self.sp, local[:, 0],
                                  local[:, 1], local[:, 2],
                                  self.feature_mask)              # [K, F]
        top_gain, top_idx = _top(gains, self.k)                   # [K, k]
        w = torch.isfinite(top_gain).to(torch.int64)  # real proposals only
        all_idx = comm.all_gather(top_idx).movedim(0, 1).reshape(kk, -1)
        all_w = comm.all_gather(w).movedim(0, 1).reshape(kk, -1)
        votes = torch.zeros((kk, f), dtype=torch.int64, device=hist.device)
        votes.scatter_add_(1, all_idx, all_w)
        elected = _top(votes, self.k2)[1]                         # [K, k2]
        # the exchange: only the elected columns cross the ranks
        sel = elected[:, :, None, None].expand(-1, -1, hist.shape[2],
                                               hist.shape[3])
        cand = comm.all_reduce_sum_(torch.gather(hist, 1, sel).contiguous())
        gh = torch.zeros_like(hist).scatter_(1, sel, cand)
        cand_mask = torch.zeros((kk, f), dtype=torch.bool,
                                device=hist.device).scatter_(1, elected,
                                                             True)
        # the vote and the candidates are the same on every rank and the
        # totals global, so the result is too
        return find_best_split(gh, self.meta, self.sp, sg, sh, cnt,
                               self.feature_mask & cand_mask, mn, mx)


class FeatureContext(NamedTuple):
    """A rank's columns under feature-parallel: ``xb_local`` [N, Cd] its
    stored columns, ``meta_local`` their metadata, ``global_of_local``
    [Cd] their global indices (-1: padding), ``sp_local`` the split
    parameters over them."""
    xb_local: torch.Tensor
    meta_local: FeatureMeta
    global_of_local: torch.Tensor
    sp_local: SplitParams


class FeatureLearner(SerialLearner):
    """Feature-parallel: rows replicated, each rank histograms and searches
    its columns, the best splits elected across the ranks."""
    kind = "feature"

    def __init__(self, comm, ctx: FeatureContext,
                 feature_mask: torch.Tensor):
        super().__init__(None)
        self.comm, self.ctx = comm, ctx
        g = ctx.global_of_local
        self.fmask_local = torch.where(
            g >= 0, feature_mask.index_select(0, g.clamp(min=0)), False)

    def best(self, hist, sg, sh, cnt, mn=None, mx=None, pen=None):
        assert pen is None, "CEGB does not ride the feature learner"
        ctx = self.ctx
        bs = find_best_split(hist, ctx.meta_local, ctx.sp_local, sg, sh,
                             cnt, self.fmask_local, mn, mx)
        feat = ctx.global_of_local.index_select(
            0, bs.feature.reshape(-1)).reshape(bs.feature.shape).clamp(min=0)
        return elect_best_records(bs._replace(feature=feat), self.comm)


class Distributed(NamedTuple):
    """What a rank's grower needs to learn in parallel: its group endpoint,
    the learner's name (``psum``, ``data_rs``, ``voting``, ``feature``),
    ``top_k`` and, under feature-parallel, the rank's columns."""
    comm: object
    kind: str
    top_k: int = 20
    feature: Optional[FeatureContext] = None


def make_learner(dist: Optional[Distributed], search, meta: FeatureMeta,
                 sp: SplitParams, feature_mask: torch.Tensor):
    """The learner of one tree: ``search(hist, sg, sh, cnt, mn, mx, pen)``
    is the grower's serial search, which serial and psum keep verbatim."""
    if dist is None:
        return SerialLearner(search)
    if dist.kind == "psum":
        return PsumLearner(search, dist.comm)
    if dist.kind == "data_rs":
        return DataRSLearner(dist.comm, meta, sp, feature_mask)
    if dist.kind == "voting":
        return VotingLearner(dist.comm, meta, sp, feature_mask, dist.top_k)
    if dist.kind == "feature":
        return FeatureLearner(dist.comm, dist.feature, feature_mask)
    raise ValueError("unknown learner %r" % dist.kind)
