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


@pytest.mark.parametrize("k", [3, 6])
@pytest.mark.parametrize("n,f,s", [
    (1_000_000, 28, 1), (1_000_000, 28, 2), (1_000_000, 28, 16),
    (1_000_000, 28, 128), (1_000_000, 28, 254), (1_000_000, 28, 4095),
    (17, 28, 5), (20_001, 100, 9_000)])
def test_slot_launch_plan_fits_and_covers(n, f, s, k):
    """The hist pass's replicas of a slot's [Ft, B, K] f32 histogram fit
    the 227 KB a block may opt in to (all 28 features in one tile at K=3
    and K=6), its grid fills the card, and the count and scatter grid
    covers every row and every slot; the plan does not depend on S
    otherwise."""
    b, sm = 255, 132
    p = kernels.slot_hist_launch_plan(n, f, b, k, s, sm_count=sm)
    assert p.smem_bytes == p.replicas * 4 * ((p.feature_tile * b * k + 6)
                                             // 4 * 4)
    assert p.smem_bytes <= kernels.HIST_SMEM_OPT_IN == 232_448
    assert 1 <= p.replicas <= kernels.SLOT_MAX_REPLICAS
    assert p.tiles * p.feature_tile >= f > (p.tiles - 1) * p.feature_tile
    if f == 28:
        assert p.tiles == 1 and p.replicas == (2 if k == 3 else 1)
    assert p.hist_blocks * p.tiles >= min(sm, n)
    assert p.sort_blocks * p.rows_per_sort_block >= n
    assert (p.sort_blocks - 1) * p.rows_per_sort_block < n
    assert p.rows_per_sort_block <= kernels.SLOT_SORT_ROWS
    assert p.slot_windows * kernels.SLOT_SORT_SLOTS >= s
    assert (p.slot_windows - 1) * kernels.SLOT_SORT_SLOTS < s
    assert p._replace(slot_windows=1) == kernels.slot_hist_launch_plan(
        n, f, b, k, 1, sm_count=sm)


def test_part_launch_plan_is_unchanged():
    """hist_part.cu's plan at the main path's layout of 745 tiles: one
    block an SM, one feature tile of all 28 features in 199,936 bytes of
    opted-in shared memory (the histogram and its counts), and the list's
    1 + 2 * 745 ints."""
    assert kernels.part_hist_launch_plan(745, 28, 255, 132) == \
        kernels.PartPlan(132, 1, 28, 199_936, 1_491)


def test_sort_window_matches_the_kernel():
    """The plan's slot windows are the count and scatter blocks' shared
    counters: SLOT_SORT_SLOTS must be hist_slots.cu's kSortSlots."""
    import re
    from pathlib import Path
    src = (Path(__file__).resolve().parent.parent / "lightgbm_tpu_torch" /
           "core" / "csrc" / "hist_slots.cu").read_text()
    assert int(re.search(r"kSortSlots = (\d+);", src).group(1)) == \
        kernels.SLOT_SORT_SLOTS


def test_profile_script_names_every_slot_kernel():
    """scripts/profile_main_path.py sums the port's kernels by name, so it
    must know every __global__ function of core/csrc/hist_slots.cu."""
    import re
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    src = (root / "lightgbm_tpu_torch" / "core" / "csrc" /
           "hist_slots.cu").read_text()
    names = re.findall(r"__global__\s+void\s+"
                       r"(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)
    assert sorted(names) == ["count_kernel", "scan_kernel", "scatter_kernel",
                             "slot_hist_kernel"]
    script = (root / "scripts" / "profile_main_path.py").read_text()
    own = re.search(r"OWN_KERNELS = \((.*?)\)", script, re.S).group(1)
    for name in names:
        assert '"%s"' % name in own


def test_slot_bytes_count_the_active_rows():
    """The bound's bytes: every slot id, each active row's bins and
    values (and its selector for K=6), and the output once."""
    assert kernels.slot_hist_bytes(10, 4, 2, 8, 3, 5) == \
        40 + 4 * (2 + 12) + 4 * 5 * 2 * 8 * 3
    assert kernels.slot_hist_bytes(10, 4, 2, 8, 6, 5) == \
        40 + 4 * (2 + 12) + 4 * 4 + 4 * 5 * 2 * 8 * 6
