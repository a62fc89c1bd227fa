"""The port's per-slot histograms against the JAX package's.

``hist_slots_plain`` and ``hist_slots6_plain`` (the plain versions beside
the CUDA slot kernels of ``core/csrc/hist_slots.cu``) run on CPU tensors;
the JAX side runs the Pallas slot kernels (``build_histogram_slots``,
``build_histogram_slots6``) in interpret mode. Their digit contraction
splits the values into two bf16 terms, worth ~3e-6 of the cell's sum of
|v|, so the bound is 1e-5 * sum|v| + 1e-7. Against the JAX scatter path of
``build_histogram_frontier``, which adds in f32 like the port, it is
1e-6 * sum|v| + 1e-7. Every case has inactive rows (slot -1), a slot no
row carries, and rows whose slot is past the last one (folded into it).

The CUDA kernels run only on a card: tests/test_torch_kernels_cuda.py
holds them against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.core.histogram import \
    build_histogram_frontier as jax_frontier
from lightgbm_tpu.core.histogram_pallas import (build_histogram_slots,
                                                build_histogram_slots6)
from lightgbm_tpu_torch.core import histogram as th
from lightgbm_tpu_torch.core import kernels


def _inputs(n, f, b, s, seed):
    r = np.random.RandomState(seed)
    xb = r.randint(0, b, (n, f)).astype(np.uint8)
    slot = r.randint(0, s, n).astype(np.int32)
    slot[slot == s // 2] = 0                         # slot s // 2 is absent
    slot[r.rand(n) < 0.4] = -1                       # inactive rows
    slot[:5] = s + 3                                 # past the last slot
    vals = r.randn(n, 3).astype(np.float32)
    sel = (r.rand(n) < 0.45).astype(np.float32)
    return xb, slot, vals, sel


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


CASES = [(1000, 5, 16, 4), (4097, 10, 63, 7), (2048, 3, 64, 16),
         (300, 8, 40, 1)]


@pytest.mark.parametrize("n,f,b,s", CASES)
def test_plain_slots_match_pallas_interpret(n, f, b, s):
    xb, slot, vals, _ = _inputs(n, f, b, s, seed=n + s)
    ours = th.hist_slots(*_t(xb, slot, vals), b, s, "auto").numpy()
    ref = np.asarray(build_histogram_slots(
        jnp.asarray(xb), jnp.asarray(slot), jnp.asarray(vals.T), b, s,
        interpret=True))
    assert ours.shape == ref.shape == (s, f, b, 3)
    absum = th.hist_slots_plain(*_t(xb, slot, np.abs(vals)), b, s).numpy()
    assert (np.abs(ours - ref) <= 1e-5 * absum + 1e-7).all()
    if s > 2:
        assert not ours[s // 2].any()
    # with unit values each feature's bins count the active rows of each
    # slot exactly, clamp included
    ones = np.ones_like(vals)
    counts = th.hist_slots(*_t(xb, slot, ones), b, s, "auto").numpy()
    folded = np.minimum(slot, s - 1)
    for k in range(s):
        assert (counts[k, :, :, 2].sum(axis=1) == (folded == k).sum()).all()


@pytest.mark.parametrize("n,f,b,s", CASES)
def test_plain_slots6_match_pallas_interpret(n, f, b, s):
    xb, slot, vals, sel = _inputs(n, f, b, s, seed=2 * n + s)
    ours = th.hist_slots6(*_t(xb, slot, sel, vals), b, s, "auto").numpy()
    ref = np.asarray(build_histogram_slots6(
        jnp.asarray(xb), jnp.asarray(slot), jnp.asarray(sel),
        jnp.asarray(vals.T), b, s, interpret=True))
    assert ours.shape == ref.shape == (s, f, b, 6)
    absum = th.hist_slots6_plain(*_t(xb, slot, sel, np.abs(vals)),
                                 b, s).numpy()
    assert (np.abs(ours - ref) <= 1e-5 * absum + 1e-7).all()
    # the two channel triples are the two children of each parent slot
    both = ours[..., :3] + ours[..., 3:]
    whole = th.hist_slots_plain(*_t(xb, slot, vals), b, s).numpy()
    np.testing.assert_allclose(both, whole, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,f,b,s", CASES)
def test_frontier_build_matches_jax_scatter(n, f, b, s):
    xb, slot, vals, sel = _inputs(n, f, b, s, seed=3 * n + s)
    # the frontier's contract is slot in [0, S) or -1: the JAX scatter path
    # drops a slot past the end where the slot kernels fold it into S - 1
    slot[slot >= s] = -1
    g, h, m = vals[:, 0], np.abs(vals[:, 1]), sel
    ours = th.build_histogram_frontier(*_t(xb, slot, g, h, m), b, s).numpy()
    ref = np.asarray(jax_frontier(
        *(jnp.asarray(a) for a in (xb, slot, g, h, m)), num_bins=b,
        num_slots=s, impl="scatter"))
    stacked = np.stack([g * m, h * m, m], axis=1)
    absum = th.hist_slots_plain(*_t(xb, slot, np.abs(stacked)), b, s).numpy()
    assert (np.abs(ours - ref) <= 1e-6 * absum + 1e-7).all()


def test_slot_dispatch_never_falls_back():
    """The kernels' wrappers raise on CPU tensors instead of running the
    plain version; ``plain`` runs anywhere; unknown spellings raise."""
    xb, slot, vals, sel = _inputs(64, 3, 8, 4, seed=1)
    x, s, v, se = _t(xb, slot, vals, sel)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.build_histogram_slots_cuda(x, s, v, 8, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.build_histogram_slots6_cuda(x, s, se, v, 8, 4)
    with pytest.raises(ValueError, match="impl"):
        th.hist_slots(x, s, v, 8, 4, "pallas")
    np.testing.assert_array_equal(th.hist_slots(x, s, v, 8, 4, "plain"),
                                  th.hist_slots(x, s, v, 8, 4, "auto"))
    np.testing.assert_array_equal(
        th.hist_slots6(x, s, se, v, 8, 4, "plain"),
        th.hist_slots6(x, s, se, v, 8, 4, "auto"))


@pytest.mark.parametrize("n,s,k", [(1_000_000, 254, 3), (1_000_000, 128, 3),
                                   (1_000_000, 16, 6), (1_000_000, 32, 3),
                                   (1_000_000, 1, 3), (17, 5, 6)])
def test_slot_launch_plan_fits_and_covers(n, s, k):
    """Each block's [Ft, B, K] f32 sub-histogram fits the shared-memory
    budget, the grid covers every feature and every sorted row, and the
    [C + S - 1, F, B, K] partial scratch stays within the output plus
    SLOT_MAX_CHUNKS pieces."""
    f, b = 28, 255
    ft, c, rows = kernels.slot_hist_launch_plan(n, f, b, k, sm_count=132)
    assert ft * b * k * 4 <= kernels.HIST_SMEM_BUDGET
    assert 1 <= ft <= f and -(-f // ft) * ft - f < ft
    assert c * rows >= n and (c - 1) * rows < n
    assert 1 <= c <= kernels.SLOT_MAX_CHUNKS
    assert c + s - 1 <= s + kernels.SLOT_MAX_CHUNKS


def test_slot_bytes_count_the_active_rows():
    """The bound's bytes: every slot id, each active row's bins and
    values (and its selector for K=6), and the output once."""
    assert kernels.slot_hist_bytes(10, 4, 2, 8, 3, 5) == \
        40 + 4 * (2 + 12) + 4 * 5 * 2 * 8 * 3
    assert kernels.slot_hist_bytes(10, 4, 2, 8, 6, 5) == \
        40 + 4 * (2 + 12) + 4 * 4 + 4 * 5 * 2 * 8 * 6
