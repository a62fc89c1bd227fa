"""The port's row partition against the JAX package's on the same rows.

Two successive splits (the second on a range that does not start at 0) go
through ``partition_and_hist`` of both packages; the JAX side builds its
child histograms with the Pallas kernel in interpret mode over 512-row
tiles, the port with one pass over the whole range. leaf_begin and
leaf_count must be equal, each child must hold the same rows (in the same
order: both use the scatter placement), and the child histograms agree
within the bf16 budget of the Pallas kernel, 1e-5 * sum_bin|v| + 1e-7.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.core import partition as jp
from lightgbm_tpu_torch.core import partition as tp
from lightgbm_tpu_torch.core.histogram import hist_plain

N, F, B, L, CHUNK = 3000, 5, 64, 4, 512
SPLITS = [(0, 1, 2, 30), (1, 2, 0, 10)]   # (leaf, right_leaf, feature, thr)


def _data():
    r = np.random.RandomState(9)
    xb = r.randint(0, B, (N, F)).astype(np.uint8)
    grad = r.randn(N).astype(np.float32)
    hess = (r.rand(N) + 0.5).astype(np.float32)
    mask = (r.rand(N) > 0.2).astype(np.float32)
    vals = np.stack([grad * mask, hess * mask, mask], 1)
    return xb, vals


def _run_jax(xb, vals):
    part = jp.init_partition(N, L, CHUNK)
    gather = jp.make_row_gather(jnp.asarray(xb), jnp.asarray(vals))
    lid = jnp.zeros((N,), jnp.int32)
    hists = []
    for leaf, right, feat, thr in SPLITS:
        part, lid, hl, hr = jp.partition_and_hist(
            part, lid, leaf, right, lambda rows: rows[:, feat] <= thr,
            jnp.asarray(True), CHUNK, gather, F, B, "pallas_interpret",
            use_sort=False)
        hists.append((np.asarray(hl), np.asarray(hr)))
    return part, hists


def _run_torch(xb, vals):
    part = tp.init_partition(N, L, torch.device("cpu"))
    x, v = torch.as_tensor(xb), torch.as_tensor(vals)
    hists = []
    for leaf, right, feat, thr in SPLITS:
        begin, count = int(part.leaf_begin[leaf]), int(part.leaf_count[leaf])
        part, hl, hr = tp.partition_and_hist(
            part, leaf, right, begin, count, x, v,
            lambda rows: rows[:, feat] <= thr, B, "auto")
        hists.append((hl.numpy(), hr.numpy()))
    return part, hists


@pytest.fixture(scope="module")
def both():
    xb, vals = _data()
    return xb, vals, _run_jax(xb, vals), _run_torch(xb, vals)


def test_ranges_equal(both):
    _, _, (jpart, _), (tpart, _) = both
    np.testing.assert_array_equal(tpart.leaf_begin.numpy(),
                                  np.asarray(jpart.leaf_begin))
    np.testing.assert_array_equal(tpart.leaf_count.numpy(),
                                  np.asarray(jpart.leaf_count))


def test_children_hold_the_same_rows_in_the_same_order(both):
    _, _, (jpart, _), (tpart, _) = both
    np.testing.assert_array_equal(tpart.order.numpy(),
                                  np.asarray(jpart.order)[:N])
    lid_j = np.asarray(jp.leaf_id_from_partition(jpart, N, L))
    lid_t = tp.leaf_id_from_partition(tpart, N, L).numpy()
    np.testing.assert_array_equal(lid_t, lid_j)


@pytest.mark.parametrize("step", range(len(SPLITS)))
def test_child_histograms_match(both, step):
    xb, vals, (jpart, jh), (tpart, th) = both
    order = tpart.order.numpy()
    for side in range(2):
        leaf = SPLITS[step][side]
        begin = int(tpart.leaf_begin[leaf])
        # the rows of this child at this step: later steps only move rows
        # of leaf 1, so step 0's leaf-1 child is the union of 1 and 2
        rows = order[begin:begin + int(tpart.leaf_count[leaf])]
        if step == 0 and side == 1:
            b2 = int(tpart.leaf_begin[2])
            rows = np.concatenate([rows, order[b2:b2 + int(
                tpart.leaf_count[2])]])
        absum = hist_plain(torch.as_tensor(xb[rows]),
                           torch.as_tensor(np.abs(vals[rows])), B).numpy()
        assert (np.abs(th[step][side] - jh[step][side])
                <= 1e-5 * absum + 1e-7).all()
