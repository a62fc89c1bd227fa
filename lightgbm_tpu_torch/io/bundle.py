"""EFB — Exclusive Feature Bundling (host-side grouping).

The port's own copy of ``lightgbm_tpu/io/bundle.py``, a re-design of the
reference's bundling (src/io/dataset.cpp:67-177
FindGroups/FastFeatureBundling, include/LightGBM/feature_group.h:35-50).
Mutually-exclusive sparse features share one stored uint8 column; each
sub-feature owns a bin range inside the column (``bundle_offsets``).
``io/dataset.py`` builds the stored columns from the bundles, and the
growers decode and expand them (``core/grow.py`` ``decode_bundle_value``,
``expand_hist``).

Encoding per bundled column (bin_offsets_ analog):
  value 0                      -> every sub-feature at its default bin
  value in [off_k, off_k+nb_k) -> sub-feature k at bin (value - off_k),
                                   everyone else at their default bin
Offsets start at 1 and each range is the sub-feature's full bin count, so
decode is one subtract + range check and histogram expansion is a static
gather. A sub-feature's default-bin histogram entry is rebuilt from the
leaf totals, the Dataset::FixHistogram idea (dataset.h:411-412).

The grouping itself is greedy conflict-bounded graph coloring like the
reference: features are processed in descending nonzero count; a feature
joins the first bundle whose accumulated conflict count (rows where both the
bundle and the feature are non-default, measured on a row sample) stays
within max_conflict_rate, and whose total bin count stays <= 256 (uint8).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

MAX_BUNDLE_BINS = 256  # uint8 storage


def find_bundles(nz_sample_rows: Sequence[np.ndarray], sample_n: int,
                 num_bins: Sequence[int], max_conflict_rate: float,
                 sparse_threshold: float = 0.8,
                 max_search_groups: int = 100) -> List[List[int]]:
    """Group features into exclusive bundles.

    Args:
      nz_sample_rows: per feature, sorted sampled-row indices where the
        feature is non-default (nonzero).
      sample_n: number of sampled rows the indices refer to.
      num_bins: per feature bin count (bundle capacity accounting).
      max_conflict_rate: allowed fraction of sampled rows where two bundled
        features collide (0 = strictly exclusive).
      sparse_threshold: a feature is a bundle candidate only when its
        zero-rate is >= sparse_threshold (the reference's sparse feature
        criterion); denser features stay un-bundled — they gain nothing and
        conflict everywhere.
      max_search_groups: cap on bundles probed per feature (keeps grouping
        O(F * max_search_groups * sample)).

    Returns: list of bundles (each a list of original feature indices) in
      stored-column order; singletons included.
    """
    f = len(nz_sample_rows)
    nz_counts = np.array([len(r) for r in nz_sample_rows], dtype=np.int64)
    budget = int(max_conflict_rate * sample_n)

    dense = [j for j in range(f)
             if sample_n > 0
             and nz_counts[j] > (1.0 - sparse_threshold) * sample_n]
    dense_set = set(dense)
    sparse_feats = [j for j in range(f) if j not in dense_set]
    # densest first: big features anchor bundles, tiny ones fill gaps
    sparse_feats.sort(key=lambda j: -nz_counts[j])

    bundles: List[List[int]] = []
    occupancy: List[np.ndarray] = []      # bool[sample_n] per bundle
    conflicts: List[int] = []             # accumulated conflicts per bundle
    bins_used: List[int] = []             # 1 (shared zero) + sum of nb

    for j in sparse_feats:
        rows = nz_sample_rows[j]
        mine = np.zeros(sample_n, dtype=bool)
        mine[rows] = True
        placed = False
        for gi in range(min(len(bundles), max_search_groups)):
            if bins_used[gi] + num_bins[j] > MAX_BUNDLE_BINS:
                continue
            clash = int(np.count_nonzero(occupancy[gi] & mine))
            if conflicts[gi] + clash <= budget:
                bundles[gi].append(j)
                occupancy[gi] |= mine
                conflicts[gi] += clash
                bins_used[gi] += int(num_bins[j])
                placed = True
                break
        if not placed:
            bundles.append([j])
            occupancy.append(mine)
            conflicts.append(0)
            bins_used.append(1 + int(num_bins[j]))

    # drop the bundle machinery for bundles that stayed singletons: they are
    # stored raw (offset 0, identity encoding), as are dense features
    out = [b for b in bundles if len(b) > 1]
    singles = sorted(dense + [b[0] for b in bundles if len(b) == 1])
    out.extend([j] for j in singles)
    return out



def bundle_offsets(bundle: List[int],
                   num_bins: Sequence[int]) -> Tuple[List[int], int]:
    """Per-sub-feature bin offsets inside a bundled column and the column's
    total encoded bin count. Singletons use identity encoding (offset 0)."""
    if len(bundle) == 1:
        return [0], int(num_bins[bundle[0]])
    offsets = []
    pos = 1                                # bin 0 = shared all-defaults
    for j in bundle:
        offsets.append(pos)
        pos += int(num_bins[j])
    return offsets, pos
