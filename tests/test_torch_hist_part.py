"""The port's partitioned-layout histogram against the JAX package's.

``hist_part_tiles`` on CPU tensors (the plain version beside the CUDA
kernel of ``core/csrc/hist_part.cu``) against the Pallas kernel
``build_histogram_part_tiles`` in interpret mode, on feature-major layouts
whose rows are grouped into tile-aligned slot runs: runs that cross tiles,
inactive tiles (slot -1) whose rows carry values that must not count,
segment padding with zero values, and a slot that owns no tile. The digit
contraction of the Pallas kernel splits the values into two bf16 terms,
worth ~3e-6 of the cell's sum of |v|, so the bound is 1e-5 * sum|v| + 1e-7.
Interpret mode leaves the block of a slot without tiles NaN, so only slots
that own a tile are compared; the port writes zeros there.

The CUDA kernel runs only on a card: tests/test_torch_kernels_cuda.py holds
it against this plain version there.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.core.histogram_pallas import build_histogram_part_tiles
from lightgbm_tpu_torch.core import histogram as th
from lightgbm_tpu_torch.core import kernels


def part_layout(row_tile, n_tiles, f, b, n_slots, seed):
    """A partitioned layout made with numpy: every slot but one owns a run
    of consecutive tiles (some runs longer than a tile, each ending in
    zero-valued padding), with inactive tiles between and after the runs.
    Returns (xb_fm [F, Np], sel [Np], vals3 [3, Np], tile_slot [T],
    tile_first [T])."""
    r = np.random.RandomState(seed)
    np_ = row_tile * n_tiles
    xb_fm = r.randint(0, b, (f, np_)).astype(np.uint8)
    sel = (r.rand(np_) < 0.45).astype(np.float32)
    vals3 = r.randn(3, np_).astype(np.float32)
    tile_slot = np.full(n_tiles, -1, np.int32)
    absent = n_slots // 2 if n_slots > 1 else -1
    slots = [s for s in r.permutation(n_slots) if s != absent]
    t = 0
    for s in slots:
        t += r.randint(0, 2)                          # an inactive gap
        length = 1 + r.randint(0, 3)
        if t + length > n_tiles:
            break
        tile_slot[t:t + length] = s
        rows = (length - 1) * row_tile + 1 + r.randint(0, row_tile)
        pad = slice(t * row_tile + rows, (t + length) * row_tile)
        vals3[:, pad] = 0.0                           # segment padding
        t += length
    prev = np.concatenate([[-2], tile_slot[:-1]])
    first = ((tile_slot >= 0) & (tile_slot != prev)).astype(np.int32)
    return xb_fm, sel, vals3, tile_slot, first


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


# (row_tile, tiles, F, B, S)
CASES = [(128, 4, 3, 16, 1), (256, 8, 6, 63, 4), (128, 12, 10, 32, 7),
         (256, 6, 5, 40, 3)]


@pytest.mark.parametrize("row_tile,n_tiles,f,b,s", CASES)
def test_plain_part_tiles_match_pallas_interpret(row_tile, n_tiles, f, b, s):
    xb_fm, sel, vals3, tile_slot, first = part_layout(
        row_tile, n_tiles, f, b, s, seed=row_tile + 7 * n_tiles + s)
    ours = th.hist_part_tiles(*_t(xb_fm, sel, vals3, tile_slot, first), b, s,
                              row_tile, "auto").numpy()
    ref = np.asarray(build_histogram_part_tiles(
        *(jnp.asarray(a) for a in (xb_fm, sel, vals3, tile_slot, first)),
        num_bins=b, n_slots=s, row_tile=row_tile, interpret=True))
    assert ours.shape == ref.shape == (s, f, b, 6)
    absum = th.hist_part_tiles_plain(
        *_t(xb_fm, sel, np.abs(vals3), tile_slot, first), b, s,
        row_tile).numpy()
    owned = sorted(set(tile_slot[tile_slot >= 0].tolist()))
    assert owned, "the layout must give some slot a tile"
    err = np.abs(ours[owned] - ref[owned])
    assert (err <= 1e-5 * absum[owned] + 1e-7).all()
    tileless = [k for k in range(s) if k not in owned]
    assert not ours[tileless].any()
    if s > 2:
        assert tileless, "slot S // 2 owns no tile"


@pytest.mark.parametrize("row_tile,n_tiles,f,b,s", CASES)
def test_part_channels_are_the_two_children(row_tile, n_tiles, f, b, s):
    """The two channel triples add up to the K=3 histogram of the same
    rows, and with unit values the counts are the rows of each slot's
    tiles, inactive tiles left out."""
    xb_fm, sel, vals3, tile_slot, first = part_layout(
        row_tile, n_tiles, f, b, s, seed=3 * row_tile + n_tiles + s)
    ours = th.hist_part_tiles(*_t(xb_fm, sel, vals3, tile_slot, first), b, s,
                              row_tile).numpy()
    row_slot = np.repeat(tile_slot, row_tile)
    whole = th.hist_slots_plain(*_t(xb_fm.T, row_slot, vals3.T), b,
                                s).numpy()
    np.testing.assert_allclose(ours[..., :3] + ours[..., 3:], whole, rtol=0,
                               atol=1e-5)
    counts = th.hist_part_tiles(
        *_t(xb_fm, sel, np.ones_like(vals3), tile_slot, first), b, s,
        row_tile).numpy()
    for k in range(s):
        per_feature = counts[k, :, :, 2].sum(axis=1) + counts[k, :, :, 5].sum(
            axis=1)
        assert (per_feature == (row_slot == k).sum()).all()


def test_part_dispatch_never_falls_back():
    """The kernel's wrapper raises on CPU tensors instead of running the
    plain version; ``plain`` runs anywhere; unknown spellings raise."""
    xb_fm, sel, vals3, tile_slot, first = part_layout(128, 4, 3, 16, 2, 1)
    args = _t(xb_fm, sel, vals3, tile_slot, first)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.build_histogram_part_tiles_cuda(*args, 16, 2, 128)
    with pytest.raises(ValueError, match="impl"):
        th.hist_part_tiles(*args, 16, 2, 128, "pallas")
    np.testing.assert_array_equal(th.hist_part_tiles(*args, 16, 2, 128,
                                                     "plain"),
                                  th.hist_part_tiles(*args, 16, 2, 128,
                                                     "auto"))


@pytest.mark.parametrize("n_tiles,s", [(745, 16), (745, 1), (50, 16),
                                       (1, 1), (4000, 254)])
def test_part_launch_plan_fits_and_covers(n_tiles, s):
    """The block's [Ft, B, 6] histogram (after a lead of up to 3 floats,
    padded to 16 bytes) and its [Ft, B] counts fit the 227 KB opt-in, the
    equal feature tiles cover F
    once, the grid is one block an SM for each feature tile whatever S
    and the active tiles are, and the list holds A and each tile's entry
    and slot."""
    f, b, sm = 28, 255, 132
    plan = kernels.part_hist_launch_plan(n_tiles, f, b, sm_count=sm)
    assert plan.smem_bytes <= 232_448
    assert plan.smem_bytes >= 4 * (plan.feature_tile * b * 7 + 3)
    assert plan.smem_bytes % 16 == 0
    assert plan.tiles == 1 and plan.feature_tile == f
    assert plan.hist_blocks * plan.tiles == sm
    assert plan.scratch_ints == 1 + 2 * n_tiles
    for wide in (64, 100, 1000):
        p = kernels.part_hist_launch_plan(n_tiles, wide, b, sm_count=sm)
        assert p.smem_bytes <= 232_448
        assert p.tiles * p.feature_tile >= wide
        assert (p.tiles - 1) * p.feature_tile < wide
        assert p.hist_blocks == sm


def test_profile_script_names_every_part_kernel():
    """scripts/profile_main_path.py sums the port's kernels by name, so it
    must know every __global__ function of core/csrc/hist_part.cu: one
    list launch and one histogram launch a call."""
    import re
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    src = (root / "lightgbm_tpu_torch" / "core" / "csrc" /
           "hist_part.cu").read_text()
    names = re.findall(r"__global__\s+void\s+"
                       r"(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)
    assert sorted(names) == ["part_list_kernel", "part_run_hist_kernel"]
    script = (root / "scripts" / "profile_main_path.py").read_text()
    own = re.search(r"OWN_KERNELS = \((.*?)\)", script, re.S).group(1)
    for name in names:
        assert '"%s"' % name in own


def test_part_plan_matches_the_kernel():
    """The plan's shared-memory bytes are what hist_part.cu's launcher
    takes: hist_floats (the feature tile's F * B * 6 floats after a lead of
    up to 3, rounded up to 4 floats) and one uint32 count a (feature,
    bin)."""
    import re
    from pathlib import Path
    src = (Path(__file__).resolve().parent.parent / "lightgbm_tpu_torch" /
           "core" / "csrc" / "hist_part.cu").read_text()
    assert re.search(r"return \(feature_tile \* num_bins \* kChannels \+ 3"
                     r" \+ 3\) & ~3;", src)
    assert re.search(r"smem_bytes != 4ll \* \(hist_floats\(feature_tile, "
                     r"num_bins\) \+\s+feature_tile \* num_bins\)", src)
    for f, b in ((28, 255), (3, 63), (64, 255), (1, 1), (5, 256),
                 (1000, 255)):
        p = kernels.part_hist_launch_plan(10, f, b, sm_count=7)
        floats = (p.feature_tile * b * 6 + 3 + 3) & ~3
        assert p.smem_bytes == 4 * (floats + p.feature_tile * b) <= 232_448


def test_part_bytes_count_the_active_tiles():
    """The bound's bytes: each active tile's bins, selector and values,
    both tile maps, and the output once."""
    assert kernels.part_hist_bytes(3, 10, 16, 2, 8, 5) == \
        3 * 16 * (2 + 4 + 12) + 8 * 10 + 4 * 5 * 2 * 8 * 6
