"""Frontier growth over streamed chunks, driven from the host.

The port of ``lightgbm_tpu/stream/grow_stream.py`` for one device. The
in-memory frontier grower (``core/grow_frontier.py``) sweeps the whole
[N, C] bin matrix once a wave; here the matrix never lies on the card
whole, so each wave's sweep is a sum of sweeps over the chunks that
``pipeline.ChunkPipeline`` copies there. Histograms add over any partition
of the rows, so the trees are the in-memory grower's at the same bin
boundaries, up to the order of the float32 additions.

Everything per row but the bins (the stacked (g, h, mask) values and the
leaf ids) stays on the card at the pipeline's padded length, ``num_chunks *
chunk_rows``; padding rows carry mask 0, so they add nothing to any
histogram channel, and their leaf ids are never read.

- root: one sweep, ``acc + build_histogram(chunk)`` in chunk order
  (histogram.cu, on packed words where the chunks are words), then the
  root's split search (``core/grow.py`` ``root_from_hist``);
- each wave: its width from one read of the device, ``k = min(live, L -
  nl)``, once a wave (the JAX package fixes the width at the largest wave
  instead, ``frontier_max_width``, with the extra lanes masked: the same
  splits); then one sweep that routes each chunk's rows through their
  leaves' splits (``wave_route``, codes gathered from the words) and adds
  the chunk's smaller-children histogram partial (hist_slots.cu) to the
  wave's accumulator, in chunk order; after the last chunk the sibling
  subtraction and the commit (``wave_commit``), as in memory.

The JAX package's ``shard_map`` wrappers (chunks across a device mesh) are
ROADMAP Queue 1 #13 slice b.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.grow import (GrowParams, TreeArrays, root_from_hist, tree_learner,
                         tree_to_host)
from ..core.grow_batched import wave_plan, wave_route
from ..core.grow_frontier import (GrowerHealth, frontier_state, wave_commit,
                                  wave_slots)
from ..core.histogram import hist_slots, hist_tile_vals, stack_vals
from ..core.split import FeatureMeta
from .pipeline import ChunkPipeline


class StreamFrontierGrower:
    """Grows one tree a call by sweeping a ``ChunkPipeline``, with the
    signature of the in-memory growers (``boosting/gbdt.py`` ``GROWERS``):
    the bin matrix argument is ignored (the pipeline holds the chunks);
    grad, hess and sample_mask are [N] at the real row count."""

    def __init__(self, pipeline: ChunkPipeline):
        self.pipeline = pipeline
        self.trees_grown = 0
        self.waves = 0

    def __call__(self, xb, grad: torch.Tensor, hess: torch.Tensor,
                 sample_mask: torch.Tensor, meta: FeatureMeta,
                 feature_mask: torch.Tensor, params: GrowParams,
                 health: Optional[GrowerHealth] = None, trace_span=None
                 ) -> Tuple[TreeArrays, torch.Tensor]:
        """Grow one tree. ``health`` (``core/grow_frontier.py``
        ``GrowerHealth``, optional) counts the waves and the non-finite
        committed gains; ``trace_span`` (``obs/reqtrace.py``, optional)
        gets one child a sweep over the chunks: the root's, then each
        wave's, as the JAX package's streamed grower gives them. Both are
        host bookkeeping: the launches are the same with them or
        without."""
        pipe = self.pipeline
        r = pipe.chunk_rows
        n = grad.shape[0]
        l = params.num_leaves
        packed = params.word_packed_cols
        vals = stack_vals(grad, hess, sample_mask)
        root = vals.sum(dim=0)                  # as the in-memory root's
        if pipe.num_padded > n:
            vals = torch.cat([vals, vals.new_zeros((pipe.num_padded - n,
                                                    3))])
        tspan = trace_span if trace_span else None
        if tspan is not None:
            rspan = tspan.child("root_sweep", chunks=pipe.num_chunks)
        # the root's histogram, summed over the chunks
        hist_root = None
        for i, xc in pipe.sweep():
            part = hist_tile_vals(xc, vals[i * r:(i + 1) * r],
                                  params.num_bins, params.hist_impl,
                                  params.plain_sums, packed)
            hist_root = part if hist_root is None else hist_root + part
        lrn = tree_learner(None, meta, feature_mask, params)
        tree, best = root_from_hist(hist_root, root, params, lrn)
        if tspan is not None:
            rspan.end()
        s = frontier_state(tree, best, hist_root, pipe.num_padded, params)
        with_cat = bool(params.split.cat_features)
        nl = 1
        while nl < l:
            live = int((s.best.gain > 0.0).sum())   # the wave's one read
            if live == 0:
                break
            k = min(live, l - nl)
            plan = wave_plan(s.best, nl, k)
            if tspan is not None:
                wspan = tspan.child("wave", wave=self.waves,
                                    chunks=pipe.num_chunks)
            hist_small = None
            for i, xc in pipe.sweep():
                rows = slice(i * r, (i + 1) * r)
                leaf_id, active, rs, go_left = wave_route(
                    xc, s.leaf_id[rows], plan, meta, params.with_efb,
                    with_cat, packed)
                left_small, slot = wave_slots(plan.cur, active, go_left, rs)
                part = hist_slots(xc, slot, vals[rows], params.num_bins, k,
                                  params.hist_impl, params.plain_sums,
                                  packed)
                hist_small = part if hist_small is None \
                    else hist_small + part
                s.leaf_id[rows] = leaf_id
            wave_commit(s, plan, nl, left_small, hist_small, meta, params,
                        lrn)
            if health is not None:
                health.commit(plan.cur.gain)
            if tspan is not None:
                wspan.end()
            nl += k
            self.waves += 1
        self.trees_grown += 1
        return tree_to_host(s.tree, nl), s.leaf_id[:n]
