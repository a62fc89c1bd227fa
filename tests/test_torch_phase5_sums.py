"""chip_smoke.py phase 5's float32 reference: blocked sums.

Phase 5 holds the kernels' f32 paths to a plain path whose histograms sum
each cell's rows in runs of ``BLOCK_ROWS`` rows landing in that cell, the
runs' sums added in order (``GrowParams.plain_sums`` "blocked"). On
chip_smoke's bundled data at phase 5's 200,000 rows:

- the root histogram of binary's first gradients: blocked f32 sums lie
  closer to the float64 sums than one running f32 sum a cell (the default
  plain path, the JAX package's CPU scatter), by the largest and by the
  total absolute difference;
- the bundled frontier row (255 leaves, phase 5's tie rule for frontier
  rows, ``WAVE_PARTING``): a forest grown on one running f32 sum a cell,
  standing for the kernel, holds the rule against the blocked plain path,
  and one whose histograms drop every 4,096th row of what they sum (a
  kernel that loses rows) fails it.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest
import torch

import chip_smoke
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.core import histogram

_DATA = {}


def _bundled():
    """(rows, labels, Dataset) of the bundled data at phase 5's size."""
    if not _DATA:
        x, y = chip_smoke.bundled_data(chip_smoke.COMPARE_ROWS)
        params = dict(chip_smoke.PARAMS,
                      **chip_smoke.GROWTH_PARAMS["frontier"])
        _DATA.update(x=x, y=y, params=params, ds=tlgb.Dataset(
            x, label=y, params=params, device="cpu").construct())
    return _DATA


def test_blocked_sums_drift_less_than_one_running_sum():
    d = _bundled()
    binned = d["ds"]._binned
    xb = torch.as_tensor(binned.X_binned)
    p = float(np.mean(d["y"]))
    prob = np.float32(p)          # the first iteration's sigmoid
    grad = torch.as_tensor((prob - d["y"]).astype(np.float32))
    hess = torch.full_like(grad, float(prob * (1 - prob)))
    vals = histogram.stack_vals(grad, hess, torch.ones_like(grad))
    b = binned.max_col_bins()
    exact = histogram.hist_plain(xb, vals.double(), b)
    drift = {}
    for name in ("running", "blocked"):
        hist = histogram.hist_plain(xb, vals, b, sums=name)
        assert hist.dtype == torch.float32
        diff = (hist.double() - exact)[..., :2].abs()
        drift[name] = (float(diff.max()), float(diff.sum()))
    assert drift["blocked"][0] < drift["running"][0] / 4, drift
    assert drift["blocked"][1] < drift["running"][1] / 3, drift
    # the count channel is exact either way
    blocked = histogram.hist_plain(xb, vals, b, sums="blocked")
    np.testing.assert_array_equal(blocked[..., 2].double(), exact[..., 2])


def test_phase5_bundled_frontier_rule_fails_a_fault(monkeypatch):
    d = _bundled()
    rows = torch.as_tensor(d["x"], dtype=torch.float64)

    def forest(sums):
        bst = tlgb.Booster(params=d["params"], train_set=d["ds"],
                           device="cpu")
        bst._impl.grow_params = bst._impl.grow_params._replace(
            plain_sums=sums)
        bst.update()
        return bst.models

    # the frontier rows may part at a tie located by the rows split
    limits = chip_smoke.tie_limits(d["params"], False)
    assert limits == (chip_smoke.WAVE_PARTING, None)
    blocked = forest("blocked")
    assert chip_smoke.PLAIN_PATHS[False] == "plain_blocked"
    chip_smoke.trees_match(forest("running"), blocked, [], *limits, rows)
    sums = histogram._sums

    def dropping_sums(vals, mode):
        vals = vals.clone()
        vals[::4096] = 0
        return sums(vals, mode)

    monkeypatch.setattr(histogram, "_sums", dropping_sums)
    faulty = forest("running")
    with pytest.raises(AssertionError, match="tie rule"):
        chip_smoke.trees_match(faulty, blocked, [], *limits, rows)
