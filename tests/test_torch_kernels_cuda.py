"""The port's CUDA kernels on a card, against their plain PyTorch versions:
the histogram kernel (``histogram.cu``), the two slot kernels
(``hist_slots.cu``), the partitioned-layout kernel (``hist_part.cu``) and
the in-tile partition (``repack.cu``), alone and on the training paths
that launch them (binary, bundled, categorical and multiclass training);
and the regression slice's device work on the card against the same calls
on the CPU: leaf renewal (``core/renew.py``) and the binned replay that
keeps the valid-set scores (``core/tree.py``); and row sampling: a
1,000,000-row threefry draw (``random.py``) bit-equal to the CPU's, and
bagging, GOSS, DART and RF training through the kernels.

These tests need a CUDA device and ``nvcc``: a hand-written CUDA kernel has
no CPU or interpret mode, so they are marked ``cuda`` and skip without one.
The file imports neither JAX nor the JAX package, so it also runs on a GPU
machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
"""
import os
import shutil

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.core import histogram as th
from lightgbm_tpu_torch.core import kernels


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available() or (
            shutil.which("nvcc") is None
            and not os.path.exists("/usr/local/cuda/bin/nvcc")):
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU "
                    "or interpret mode")
    return torch.device("cuda")


def _inputs(n, f, b, k, seed):
    r = np.random.RandomState(seed)
    xb = r.randint(0, b, (n, f)).astype(np.uint8)
    vals = r.randn(n, k).astype(np.float32)
    if k == 6:
        # a row feeds one child only, as in the fused partition pass
        left = r.rand(n) < 0.4
        vals[:, :3] *= left[:, None]
        vals[:, 3:] *= ~left[:, None]
    return xb, vals


def _edge_inputs(case, n, f, b, seed):
    """K=6 values with an edge in the rows' sides: every row left, every
    row right, a third of the rows masked out (all six values zero), or
    some rows feeding both triples (outside the partition's contract)."""
    xb, vals = _inputs(n, f, b, 6, seed)
    if case == "all_left":
        vals[:, 3:] = 0
        vals[:, :3] = np.abs(vals[:, :3]) + 1
    elif case == "all_right":
        vals[:, :3] = 0
        vals[:, 3:] = np.abs(vals[:, 3:]) + 1
    elif case == "masked":
        vals[np.random.RandomState(seed).rand(n) < 0.3] = 0
    elif case == "both":
        vals[::7] = np.random.RandomState(seed).randn(len(vals[::7]), 6)
    return xb, vals


def _count_channels(vals):
    """Make channel 2 (and 5) a 0/1 count, as the main path stacks it."""
    k = vals.shape[1]
    for c in range(2, k, 3):
        vals[:, c] = (vals[:, c] != 0)
    return vals


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,b,k,case", [
    (100_003, 28, 255, 3, None), (100_003, 28, 255, 6, None),
    (17, 5, 16, 3, None), (4096, 3, 256, 6, None),
    (1, 28, 255, 6, None), (512, 28, 255, 6, None),
    (7434, 28, 255, 6, None), (65_536, 28, 255, 6, None),
    (7434, 28, 255, 6, "all_left"), (7434, 28, 255, 6, "all_right"),
    (7434, 28, 255, 6, "masked"), (100_003, 28, 255, 6, "masked"),
    (7434, 28, 255, 6, "both"), (100_003, 28, 255, 6, "both"),
    (7434, 28, 256, 6, None), (100_003, 28, 256, 6, None),
    (7434, 1, 255, 6, None), (100_003, 1, 255, 3, None)])
def test_cuda_kernel_matches_plain(cuda_device, n, f, b, k, case):
    """|kernel - plain| <= 1e-5 * sum_bin|v| + 1e-6 in every cell, the
    count channel exact, and the dispatch counts one launch."""
    if case is None:
        xb, vals = _inputs(n, f, b, k, seed=n + k)
    else:
        xb, vals = _edge_inputs(case, n, f, b, seed=n + k)
    vals = _count_channels(vals)
    x = torch.as_tensor(xb, device=cuda_device)
    v = torch.as_tensor(vals, device=cuda_device)
    before = kernels.build_histogram_cuda.launches
    got = th.hist_tile_vals(x, v, b, "auto").cpu().numpy()
    assert kernels.build_histogram_cuda.launches == before + 1
    want = th.hist_plain(torch.as_tensor(xb), torch.as_tensor(vals), b).numpy()
    absum = th.hist_plain(torch.as_tensor(xb),
                          torch.as_tensor(np.abs(vals)), b).numpy()
    assert got.shape == (f, b, k)
    assert (np.abs(got - want) <= 1e-5 * absum + 1e-6).all()
    np.testing.assert_array_equal(got[..., 2::3], want[..., 2::3])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["direct", "block"])
@pytest.mark.parametrize("n,f,b,k,offset", [
    (1, 28, 255, 6, 0), (4096, 28, 255, 6, 1), (100_003, 28, 255, 3, 3),
    (20_001, 64, 255, 6, 0), (20_001, 100, 255, 3, 2), (3001, 5, 16, 3, 1)])
def test_cuda_kernel_variants_match_plain(cuda_device, variant, n, f, b, k,
                                          offset):
    """Each variant of histogram.cu, forced, at any n: bins that start
    ``offset`` bytes past an aligned address (a misaligned first word),
    and features that need more than one tile of the block variant's
    shared memory (F = 64 at K=6, F = 100 at K=3)."""
    xb, vals = _inputs(n, f, b, k, seed=n + f + k)
    vals = _count_channels(vals)
    buf = torch.empty(n * f + offset, dtype=torch.uint8, device=cuda_device)
    x = buf[offset:].view(n, f)
    x.copy_(torch.as_tensor(xb))
    assert x.is_contiguous() and x.data_ptr() % 4 == offset % 4
    v = torch.as_tensor(vals, device=cuda_device)
    got = kernels.build_histogram_cuda(x, v, b, variant).cpu().numpy()
    want = th.hist_plain(torch.as_tensor(xb), torch.as_tensor(vals), b).numpy()
    absum = th.hist_plain(torch.as_tensor(xb),
                          torch.as_tensor(np.abs(vals)), b).numpy()
    assert (np.abs(got - want) <= 1e-5 * absum + 1e-6).all()
    np.testing.assert_array_equal(got[..., 2::3], want[..., 2::3])


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((8, 3), dtype=torch.uint8, device=cuda_device)
    v = torch.zeros((8, 3), dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.build_histogram_cuda(x.cpu(), v, 4)
    with pytest.raises(ValueError, match="float32"):
        kernels.build_histogram_cuda(x, v.double(), 4)
    with pytest.raises(ValueError, match="float32"):
        kernels.build_histogram_cuda(x, v[:, :2].contiguous(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.build_histogram_cuda(x.t().contiguous().t(), v, 4)
    with pytest.raises(ValueError, match="num_bins"):
        kernels.build_histogram_cuda(x, v, 300)


@pytest.mark.cuda
def test_cuda_training_goes_through_the_kernel(cuda_device):
    """Training on the card launches the kernel once per histogram pass
    (the root and every split) and builds the plain path's first tree."""
    r = np.random.RandomState(4)
    x = r.randn(20_000, 8)
    y = (x[:, 0] + 0.5 * x[:, 1] * x[:, 2] + 0.3 * r.randn(len(x)) > 0)
    params = {"objective": "binary", "num_leaves": 31, "verbosity": -1}
    before = kernels.build_histogram_cuda.launches
    bst = tlgb.train(params, tlgb.Dataset(x, label=y), num_boost_round=2)
    splits = sum(t.num_leaves_actual - 1 for t in bst.models)
    assert kernels.build_histogram_cuda.launches - before == \
        splits + len(bst.models)
    plain = tlgb.train(dict(params, tpu_hist_impl="plain"),
                       tlgb.Dataset(x, label=y), num_boost_round=1)
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child"):
        np.testing.assert_array_equal(getattr(bst.models[0], name),
                                      getattr(plain.models[0], name))
    # a leaf's output is its parent's total minus a prefix sum over bins, so
    # the two f32 summation orders differ by a few ulps of the parent's
    # gradient sum (8.5e-6 seen on an H100 at this size)
    np.testing.assert_allclose(bst.models[0].leaf_value,
                               plain.models[0].leaf_value, rtol=0, atol=5e-5)
    np.testing.assert_allclose(bst.predict(x, num_iteration=1,
                                           raw_score=True),
                               plain.predict(x, raw_score=True), rtol=0,
                               atol=1e-5)


def _slot_inputs(n, f, b, n_slots, seed, active=0.5):
    """Bins, slots (about ``active`` of the rows in a slot, slot S // 2
    left absent where S > 2, a few rows past the last slot), values with a
    count channel of ones, and a 0/1 selector."""
    r = np.random.RandomState(seed)
    xb = r.randint(0, b, (n, f)).astype(np.uint8)
    slot = r.randint(0, n_slots, n).astype(np.int32)
    if n_slots > 2:
        slot[slot == n_slots // 2] = n_slots - 1      # an absent slot
    slot[r.rand(n) >= active] = -1
    slot[:3] = n_slots + 5                            # folds into S - 1
    vals = r.randn(n, 3).astype(np.float32)
    vals[:, 2] = 1.0
    sel = (r.rand(n) < 0.5).astype(np.float32)
    return xb, slot, vals, sel


def _to(dev, *arrays):
    return [torch.as_tensor(a, device=dev) for a in arrays]


def _bins_at(dev, xb, offset):
    """xb on the card as a contiguous view ``offset`` bytes past an aligned
    address (rows that do not start on a 4-byte word)."""
    n, f = xb.shape
    buf = torch.empty(n * f + offset, dtype=torch.uint8, device=dev)
    x = buf[offset:].view(n, f)
    x.copy_(torch.as_tensor(xb))
    assert x.is_contiguous() and x.data_ptr() % 4 == offset % 4
    return x


def _check_slots(got, want, absum, s):
    """|kernel - plain| <= 1e-5 * sum|v| + 1e-6 in every cell, the count
    channels exact, the absent slot zero."""
    assert (np.abs(got - want) <= 1e-5 * absum + 1e-6).all()
    np.testing.assert_array_equal(got[..., 2::3], want[..., 2::3])
    if s > 2:
        assert not got[s // 2].any()


# (n, F, B, S, share of rows active, byte offset of the bins): S = 1 and 2
# are the first waves (one segment spread over every block), 254 the last
# of a 255-leaf tree, 1,023 and 5,000 past it (5,000 takes two windows of
# the sort's 4,096 slots), 0.99 active the tpu_batched_pack step
SLOT_CASES = [(100_003, 28, 255, 254, 0.5, 0), (100_003, 28, 255, 16, 0.5, 0),
              (200_003, 28, 255, 1, 0.5, 0), (200_003, 28, 255, 2, 0.5, 0),
              (100_003, 28, 255, 1023, 0.5, 0),
              (100_003, 28, 255, 32, 0.99, 0), (20_001, 5, 16, 5000, 0.9, 0),
              (30_001, 28, 255, 16, 0.5, 1), (30_001, 13, 256, 7, 0.5, 3),
              (4096, 5, 64, 1, 0.5, 0), (17, 3, 16, 7, 0.5, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,b,s,active,offset", SLOT_CASES)
def test_slot_kernel_matches_plain(cuda_device, n, f, b, s, active, offset):
    """The K=3 kernel against its plain version (``_check_slots``); slots
    past the last fold into S - 1; the dispatch counts one launch."""
    xb, slot, vals, sel = _slot_inputs(n, f, b, s, seed=n + s, active=active)
    x = _bins_at(cuda_device, xb, offset)
    sl, v = _to(cuda_device, slot, vals)
    before = kernels.build_histogram_slots_cuda.launches
    got = th.hist_slots(x, sl, v, b, s, "auto").cpu().numpy()
    assert kernels.build_histogram_slots_cuda.launches == before + 1
    cpu = [torch.as_tensor(a) for a in (xb, slot, vals)]
    want = th.hist_slots_plain(*cpu, b, s).numpy()
    absum = th.hist_slots_plain(cpu[0], cpu[1], cpu[2].abs(), b, s).numpy()
    assert got.shape == (s, f, b, 3)
    _check_slots(got, want, absum, s)


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,b,s,active,sel_kind", [
    (100_003, 28, 255, 16, 0.5, "0/1"), (200_003, 28, 255, 1, 0.5, "0/1"),
    (100_003, 28, 255, 16, 0.99, "0/1"), (100_003, 28, 255, 254, 0.5, "0/1"),
    (30_001, 28, 255, 16, 0.5, "fractional"), (4096, 5, 64, 3, 0.5, "0/1")])
def test_slot6_kernel_matches_plain(cuda_device, n, f, b, s, active,
                                    sel_kind):
    """The K=6 kernel against its plain version (``_check_slots``), with a
    0/1 selector (one child's triple a row) or a fractional one (both)."""
    xb, slot, vals, sel = _slot_inputs(n, f, b, s, seed=n + 6 * s,
                                       active=active)
    if sel_kind == "fractional":
        sel = np.random.RandomState(s).rand(n).astype(np.float32)
        sel[::3] = np.round(sel[::3])
        vals[:, 2] = 0.0       # no count channel: its halves are not 0/1
    x, sl, v, se = _to(cuda_device, xb, slot, vals, sel)
    before = kernels.build_histogram_slots6_cuda.launches
    got = th.hist_slots6(x, sl, se, v, b, s, "auto").cpu().numpy()
    assert kernels.build_histogram_slots6_cuda.launches == before + 1
    cpu = [torch.as_tensor(a) for a in (xb, slot, sel, vals)]
    want = th.hist_slots6_plain(*cpu, b, s).numpy()
    absum = th.hist_slots6_plain(*cpu[:3], cpu[3].abs(), b, s).numpy()
    assert got.shape == (s, f, b, 6)
    _check_slots(got, want, absum, s)


@pytest.mark.cuda
def test_slot_kernels_reject_what_they_do_not_take(cuda_device):
    x = torch.zeros((8, 3), dtype=torch.uint8, device=cuda_device)
    s = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    v = torch.zeros((8, 3), dtype=torch.float32, device=cuda_device)
    sel = torch.zeros(8, dtype=torch.float32, device=cuda_device)
    slots = kernels.build_histogram_slots_cuda
    with pytest.raises(ValueError, match="CUDA tensors"):
        slots(x, s.cpu(), v, 4, 2)
    with pytest.raises(ValueError, match="int32"):
        slots(x, s.long(), v, 4, 2)
    with pytest.raises(ValueError, match="float32"):
        slots(x, s, v[:, :2].contiguous(), 4, 2)
    with pytest.raises(ValueError, match="contiguous"):
        slots(x.t().contiguous().t(), s, v, 4, 2)
    with pytest.raises(ValueError, match="num_bins"):
        slots(x, s, v, 257, 2)
    with pytest.raises(ValueError, match="n_slots"):
        slots(x, s, v, 4, 0)
    with pytest.raises(ValueError, match="sel"):
        kernels.build_histogram_slots6_cuda(x, s, sel[:4], v, 4, 2)
    with pytest.raises(ValueError, match="sel"):
        kernels.build_histogram_slots6_cuda(x, s, sel.double(), v, 4, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("growth,counter", [
    ({"tree_growth": "frontier"}, "build_histogram_slots_cuda"),
    ({"tree_growth": "batched"}, "build_histogram_slots6_cuda"),
    ({"tree_growth": "batched", "tpu_batched_pack": True},
     "build_histogram_slots_cuda")])
def test_cuda_wave_training_goes_through_the_slot_kernels(cuda_device, growth,
                                                          counter):
    """Frontier and batched training on the card launch their slot kernel
    (one launch per wave or step) and build the plain path's trees up to
    f32 ties; raw predictions agree with the plain path's."""
    r = np.random.RandomState(4)
    x = r.randn(20_000, 8)
    y = (x[:, 0] + 0.5 * x[:, 1] * x[:, 2] + 0.3 * r.randn(len(x)) > 0)
    params = dict({"objective": "binary", "num_leaves": 31,
                   "verbosity": -1}, **growth)
    wrapper = getattr(kernels, counter)
    before = wrapper.launches
    bst = tlgb.train(params, tlgb.Dataset(x, label=y), num_boost_round=2)
    assert wrapper.launches - before >= 2 * 4      # >= 4 waves a tree
    plain = tlgb.train(dict(params, tpu_hist_impl="plain"),
                       tlgb.Dataset(x, label=y), num_boost_round=2)
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child"):
        np.testing.assert_array_equal(getattr(bst.models[0], name),
                                      getattr(plain.models[0], name))
    np.testing.assert_allclose(bst.predict(x, raw_score=True),
                               plain.predict(x, raw_score=True), rtol=0,
                               atol=1e-4)


def _part_layout(n_rows, num_leaves, f, b, n_slots, seed, share=0.5):
    """chip_smoke.py's partitioned layout of ``n_rows`` rows at
    ``num_leaves`` leaves with ``share`` of the row-holding tiles active:
    numpy (xb_fm, sel, vals3, tile_slot, tile_first) and the row tile. The
    file runs from the root of the checkout, where chip_smoke.py lies."""
    import chip_smoke
    arrays, tile = chip_smoke.part_layout(np.random.RandomState(seed),
                                          n_rows, num_leaves, f, b, n_slots,
                                          share)
    return (*arrays, tile)


# (case, F, B, S, share of the row-holding tiles active) at 100,003 rows:
# chip_smoke.py's shapes A-D of a 255-leaf tree's steps, a selector
# strictly between 0 and 1, F = 64 (two feature tiles), B = 63 and F = 3
# (a slot stride of 1,134 floats, not a multiple of 4), S = 254 with tiles
# past the last slot, skewed bins (80-98% of each feature's rows at bin 0)
# held to a float64 reference, and count values of 1 and 2 (integer and
# float counting in one cell)
PART_CASES = [("A", 28, 255, 1, 1.0), ("B", 28, 255, 16, 1.0),
              ("C", 28, 255, 16, 0.5), ("D", 28, 255, 16, 0.125),
              ("fractional", 28, 255, 16, 0.5), ("wide", 64, 255, 16, 0.5),
              ("stride", 3, 63, 16, 0.5), ("many", 28, 255, 254, 0.5),
              ("skewed", 28, 255, 2, 0.5), ("counts12", 28, 255, 16, 0.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,f,b,s,share", PART_CASES)
def test_part_kernel_matches_plain(cuda_device, case, f, b, s, share):
    """|kernel - plain| <= 1e-5 * sum|v| + 1e-6 on the layout of 100,003
    rows at 255 leaves, the count channels exact, a slot without a tile
    zero; one launch."""
    xb_fm, sel, vals3, ts, first, row_tile = _part_layout(
        100_003, 255, f, b, s, seed=s + f, share=share)
    r = np.random.RandomState(s)
    if case == "fractional":
        sel = r.rand(sel.size).astype(np.float32)
        sel[::3] = np.round(sel[::3])
        vals3[2] = 0.0         # no count channel: its halves are not 0/1
    elif case == "many":
        live = np.flatnonzero(ts >= 0)
        ts[live[-3:]] = s + 5                          # folds into S - 1
    elif case == "skewed":
        for k in range(f):
            xb_fm[k, r.rand(xb_fm.shape[1]) < 0.8 + 0.18 * k / f] = 0
    elif case == "counts12":
        vals3[2, (vals3[2] != 0) & (r.rand(sel.size) < 0.3)] = 2.0
    arrays = (xb_fm, sel, vals3, ts, first)
    before = kernels.build_histogram_part_tiles_cuda.launches
    got = th.hist_part_tiles(*_to(cuda_device, *arrays), b, s, row_tile,
                             "auto").cpu().numpy()
    assert kernels.build_histogram_part_tiles_cuda.launches == before + 1
    cpu = [torch.as_tensor(a) for a in arrays]
    want = th.hist_part_tiles_plain(*cpu, b, s, row_tile).numpy()
    absum = th.hist_part_tiles_plain(cpu[0], cpu[1], cpu[2].abs(), *cpu[3:],
                                     b, s, row_tile).numpy()
    assert got.shape == (s, f, b, 6)
    if case == "skewed":
        # ~80,000 terms a cell: the plain f32 sum is no reference there
        want = th.hist_part_tiles_plain(cpu[0], cpu[1].double(),
                                        cpu[2].double(), *cpu[3:], b, s,
                                        row_tile).numpy()
    _check_slots(got, want, absum, s)
    owned = np.zeros(s, bool)
    owned[np.minimum(ts[ts >= 0], s - 1)] = True
    assert not got[~owned].any()


@pytest.mark.cuda
def test_part_kernel_caps_its_pieces(cuda_device):
    """A block's share of 9M rows over the card's SMs passes 65,532 rows,
    where the kernel's 16-bit counts would wrap: with every row of feature
    0 in bin 0, the count channels stay exact. Held to a float64
    reference: a cell sums ~4.5M terms, past what a plain f32 sum keeps
    within 1e-5 * sum|v|."""
    b, s = 16, 1
    xb_fm, sel, vals3, ts, first, row_tile = _part_layout(
        9_000_003, 3, 2, b, s, seed=9, share=1.0)
    xb_fm[0] = 0
    arrays = (xb_fm, sel, vals3, ts, first)
    got = th.hist_part_tiles(*_to(cuda_device, *arrays), b, s, row_tile,
                             "auto").cpu().numpy()
    cpu = [torch.as_tensor(a) for a in arrays]
    want = th.hist_part_tiles_plain(cpu[0], cpu[1].double(), cpu[2].double(),
                                    *cpu[3:], b, s, row_tile).numpy()
    absum = th.hist_part_tiles_plain(cpu[0], cpu[1].double(),
                                     cpu[2].double().abs(), *cpu[3:], b, s,
                                     row_tile).numpy()
    live = (np.repeat(ts, row_tile) >= 0) & (vals3[2] != 0)
    assert want[0, 0, 0, 2] + want[0, 0, 0, 5] == live.sum() > 8_990_000
    _check_slots(got, want, absum, s)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [128, 256])
def test_partition_kernel_is_byte_exact(cuda_device, c):
    from lightgbm_tpu_torch.core.repack import (partition_tiles,
                                                partition_tiles_plain)
    r = np.random.RandomState(c)
    n, tile = 64 * 512, 512
    rows = r.randint(0, 256, (n, c)).astype(np.uint8)
    gl = r.rand(n) < 0.3
    gl[:tile] = False                                 # a tile with no left
    gl[tile:2 * tile] = True                          # a tile of lefts only
    before = kernels.partition_tiles_cuda.launches
    out, cnt = partition_tiles(*_to(cuda_device, rows, gl), row_tile=tile)
    assert kernels.partition_tiles_cuda.launches == before + 1
    want, want_cnt = partition_tiles_plain(torch.as_tensor(rows),
                                           torch.as_tensor(gl), tile)
    np.testing.assert_array_equal(out.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(cnt.cpu().numpy(), want_cnt.numpy())


@pytest.mark.cuda
def test_part_and_partition_kernels_reject_what_they_do_not_take(
        cuda_device):
    *arrays, row_tile = _part_layout(20_000, 3, 4, 16, 2, seed=0)
    xb_fm, sel, vals3, ts, first = _to(cuda_device, *arrays)
    part = kernels.build_histogram_part_tiles_cuda
    with pytest.raises(ValueError, match="CUDA tensors"):
        part(xb_fm, sel.cpu(), vals3, ts, first, 16, 2, row_tile)
    with pytest.raises(ValueError, match="row_tile"):
        part(xb_fm, sel, vals3, ts, first, 16, 2, 1000)
    with pytest.raises(ValueError, match="vals3"):
        part(xb_fm, sel, vals3[:2].contiguous(), ts, first, 16, 2, row_tile)
    with pytest.raises(ValueError, match="tile_slot"):
        part(xb_fm, sel, vals3, ts.long(), first, 16, 2, row_tile)
    with pytest.raises(ValueError, match="contiguous"):
        part(xb_fm.t().contiguous().t(), sel, vals3, ts, first, 16, 2,
             row_tile)
    with pytest.raises(ValueError, match="num_bins"):
        part(xb_fm, sel, vals3, ts, first, 257, 2, row_tile)
    with pytest.raises(ValueError, match="n_slots"):
        part(xb_fm, sel, vals3, ts, first, 16, 0, row_tile)
    rows = torch.zeros((1024, 128), dtype=torch.uint8, device=cuda_device)
    gl = torch.zeros(1024, dtype=torch.bool, device=cuda_device)
    repack = kernels.partition_tiles_cuda
    with pytest.raises(ValueError, match="CUDA tensors"):
        repack(rows, gl.cpu(), 512)
    with pytest.raises(ValueError, match="go_left"):
        repack(rows, gl.to(torch.uint8), 512)
    with pytest.raises(ValueError, match="row_tile"):
        repack(rows, gl, 300)
    with pytest.raises(ValueError, match="multiple of 16"):
        repack(rows[:, :40].contiguous(), gl, 512)


@pytest.mark.cuda
def test_cuda_part_training_launches_the_part_kernel_once_a_step(
        cuda_device, monkeypatch):
    """``tpu_batched_part=true`` training on the card launches the part
    kernel once for each step of the grower and builds the plain path's
    first tree up to f32 ties; raw predictions agree with the plain
    path's."""
    from lightgbm_tpu_torch.core import grow_batched_part as tgp
    steps = []
    real = tgp.hist_part_tiles

    def counted(*args):
        steps.append(1)
        return real(*args)

    monkeypatch.setattr(tgp, "hist_part_tiles", counted)
    r = np.random.RandomState(4)
    x = r.randn(20_000, 8)
    y = (x[:, 0] + 0.5 * x[:, 1] * x[:, 2] + 0.3 * r.randn(len(x)) > 0)
    params = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
              "tree_growth": "batched", "tpu_batched_part": "true"}
    before = kernels.build_histogram_part_tiles_cuda.launches
    bst = tlgb.train(params, tlgb.Dataset(x, label=y), num_boost_round=2)
    assert kernels.build_histogram_part_tiles_cuda.launches - before == \
        len(steps) >= 2 * 2
    plain = tlgb.train(dict(params, tpu_hist_impl="plain"),
                       tlgb.Dataset(x, label=y), num_boost_round=2)
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child"):
        np.testing.assert_array_equal(getattr(bst.models[0], name),
                                      getattr(plain.models[0], name))
    np.testing.assert_allclose(bst.predict(x, raw_score=True),
                               plain.predict(x, raw_score=True), rtol=0,
                               atol=1e-4)


def _renew_inputs(n, leaves, seed, weights):
    r = np.random.RandomState(seed)
    resid = np.round(r.randn(n), 3).astype(np.float32)
    leaf_id = r.randint(0, leaves - 1, n)
    mask = (r.rand(n) < 0.9).astype(np.float32)
    w = (r.randint(1, 4, n) if weights == "int" else r.rand(n) * 2) \
        .astype(np.float32)
    return resid, w, leaf_id, mask, r.randn(leaves).astype(np.float32)


# float32 weights: how far apart, in the leaf's float64 cumulative weight,
# the card's and the CPU's picks may lie. Near the end of 1M rows the
# running f32 sum is ~9e5, where one add rounds by up to 0.031; across a
# leaf's ~3,500 rows the two summation orders drift apart by ~2 units.
RENEW_F32_SLACK = 8.0


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["int", "f32"])
@pytest.mark.parametrize("alpha", [0.5, 0.9])
def test_renewal_on_the_card_matches_the_cpu(cuda_device, alpha, weights):
    """One segmented weighted percentile over 1M rows and 255 leaves.
    Integer weights sum exactly, so the card picks the CPU's residual in
    every leaf. With float32 weights the card's parallel cumsum rounds
    otherwise than the CPU's sequential one, so each pick is held to lie
    within RENEW_F32_SLACK of the other in the leaf's exact cumulative
    weight."""
    from lightgbm_tpu_torch.core.renew import renew_leaf_values
    resid, w, leaf_id, mask, orig = _renew_inputs(1_000_000, 255, 3, weights)
    args = [torch.as_tensor(a) for a in (resid, w, leaf_id, mask)]
    want = renew_leaf_values(*args, 255, alpha, torch.as_tensor(orig))
    got = renew_leaf_values(*[a.to(cuda_device) for a in args], 255, alpha,
                            torch.as_tensor(orig, device=cuda_device)).cpu()
    if weights == "int":
        assert torch.equal(got, want)
        return
    assert got[-1] == want[-1] == orig[-1]          # the empty leaf
    for leaf in range(254):
        rows = (leaf_id == leaf) & (mask > 0)
        order = np.argsort(resid[rows], kind="stable")
        vals = resid[rows][order]
        cum = np.concatenate([[0.0], np.cumsum(w[rows][order],
                                               dtype=np.float64)])

        def span(v):
            """[cumulative weight before, through] the value's ties."""
            return (cum[np.searchsorted(vals, v, "left")],
                    cum[np.searchsorted(vals, v, "right")])
        (a_lo, a_hi), (b_lo, b_hi) = span(float(got[leaf])), \
            span(float(want[leaf]))
        assert a_hi > a_lo and b_hi > b_lo, leaf    # both are the leaf's
        assert max(a_lo - b_hi, b_lo - a_hi) <= RENEW_F32_SLACK, leaf


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["regression", "regression_l1",
                                       "quantile"])
def test_valid_scores_and_renewal_on_the_card(cuda_device, objective):
    """Training with a validation set on the card: its device scores are
    the model's raw predictions on the validation rows, the binned replay
    finds the CPU's leaves, and the trees and metrics are the CPU's."""
    from lightgbm_tpu_torch.core import tree as ttree
    r = np.random.RandomState(6)
    x, xv = r.randn(50_000, 8), r.randn(20_000, 8)
    y = x[:, 0] + x[:, 1] * x[:, 2] + 0.3 * r.randn(len(x))
    yv = xv[:, 0] + xv[:, 1] * xv[:, 2] + 0.3 * r.randn(len(xv))
    params = {"objective": objective, "num_leaves": 63, "verbosity": -1}
    out = {}
    for dev in ("cuda", "cpu"):
        ds = tlgb.Dataset(x, y, device=dev)
        ev = {}
        bst = tlgb.train(params, ds, num_boost_round=3,
                         valid_sets=[ds.create_valid(xv, yv)],
                         evals_result=ev, verbose_eval=False, device=dev)
        out[dev] = (bst, ev)
    (gb, gev), (cb, cev) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(gb._impl.scores_of(1),
                               gb.predict(xv, raw_score=True), rtol=0,
                               atol=1e-5)
    xb = gb._impl._valid[0]["xb"]
    for ht in gb.models:
        bt = gb._impl._binned_tree(ht)
        on_cpu = ttree.replay_leaves_binned(bt._replace(nodes=bt.nodes.cpu()),
                                            xb.cpu())
        assert torch.equal(ttree.replay_leaves_binned(bt, xb).cpu(), on_cpu)
    np.testing.assert_array_equal(gb.models[0].split_feature,
                                  cb.models[0].split_feature)
    np.testing.assert_allclose(gb.models[0].leaf_value,
                               cb.models[0].leaf_value, rtol=0, atol=5e-5)
    metric = list(cev["valid_0"])[0]
    np.testing.assert_allclose(gev["valid_0"][metric],
                               cev["valid_0"][metric], rtol=1e-3)


def _bundled_stored(n, seed):
    """A stored matrix of the bundled workload's shape (chip_smoke.py
    ``bundled_data``): C = 34 columns of B = 255 bins, the first 8 of them
    EFB bundle columns of 65 codes with half their rows at bin 0 (no member
    of the bundle non-zero)."""
    r = np.random.RandomState(seed)
    xb = r.randint(0, 255, (n, 34)).astype(np.uint8)
    for c in range(8):
        col = r.randint(1, 65, n).astype(np.uint8)
        col[r.rand(n) < 0.5] = 0
        xb[:, c] = col
    return xb


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["histogram", "slots", "slots6", "part"])
def test_kernels_at_the_bundled_shape(cuda_device, kernel):
    """Each histogram kernel on the skewed stored matrix of the bundled
    workload, held to its plain version computed in float64 (a bin-0 cell
    of a bundle sums ~50,000 terms): |d| <= 1e-5 * sum|v| + 1e-6, count
    channels exact, one launch. At C = 34, B = 255 the part kernel's plan
    takes two feature tiles."""
    n, b, s = 100_003, 255, 16
    xb = _bundled_stored(n, seed=5)
    c = xb.shape[1]
    if kernel == "histogram":
        _, vals = _inputs(n, c, b, 3, seed=7)
        vals = _count_channels(vals)
        wrapper = kernels.build_histogram_cuda
        before = wrapper.launches
        got = th.hist_tile_vals(*_to(cuda_device, xb, vals), b, "auto")
        cpu = [torch.as_tensor(a) for a in (xb, vals)]
        want = th.hist_plain(cpu[0], cpu[1].double(), b).numpy()
        absum = th.hist_plain(cpu[0], cpu[1].double().abs(), b).numpy()
    elif kernel in ("slots", "slots6"):
        _, slot, vals, sel = _slot_inputs(n, c, b, s, seed=8)
        cpu = [torch.as_tensor(a) for a in (xb, slot, vals, sel)]
        dev = _to(cuda_device, xb, slot, vals, sel)
        if kernel == "slots":
            wrapper = kernels.build_histogram_slots_cuda
            before = wrapper.launches
            got = th.hist_slots(dev[0], dev[1], dev[2], b, s, "auto")
            want = th.hist_slots_plain(cpu[0], cpu[1], cpu[2].double(), b,
                                       s).numpy()
            absum = th.hist_slots_plain(cpu[0], cpu[1], cpu[2].double().abs(),
                                        b, s).numpy()
        else:
            wrapper = kernels.build_histogram_slots6_cuda
            before = wrapper.launches
            got = th.hist_slots6(dev[0], dev[1], dev[3], dev[2], b, s,
                                 "auto")
            want = th.hist_slots6_plain(cpu[0], cpu[1], cpu[3],
                                        cpu[2].double(), b, s).numpy()
            absum = th.hist_slots6_plain(cpu[0], cpu[1], cpu[3],
                                         cpu[2].double().abs(), b, s).numpy()
    else:
        xb_fm, sel, vals3, ts, first, row_tile = _part_layout(
            n, 255, c, b, s, seed=9, share=1.0)
        xb_fm = np.ascontiguousarray(xb[np.arange(xb_fm.shape[1]) % n].T)
        plan = kernels.part_hist_launch_plan(len(ts), c, b, 132)
        assert (plan.tiles, plan.feature_tile) == (2, 17)
        arrays = (xb_fm, sel, vals3, ts, first)
        wrapper = kernels.build_histogram_part_tiles_cuda
        before = wrapper.launches
        got = th.hist_part_tiles(*_to(cuda_device, *arrays), b, s, row_tile,
                                 "auto")
        cpu = [torch.as_tensor(a) for a in arrays]
        want = th.hist_part_tiles_plain(cpu[0], cpu[1].double(),
                                        cpu[2].double(), *cpu[3:], b, s,
                                        row_tile).numpy()
        absum = th.hist_part_tiles_plain(cpu[0], cpu[1].double(),
                                         cpu[2].double().abs(), *cpu[3:], b,
                                         s, row_tile).numpy()
    assert wrapper.launches == before + 1
    got = got.cpu().numpy()
    assert got.shape == want.shape
    assert (np.abs(got - want) <= 1e-5 * absum + 1e-6).all()
    np.testing.assert_array_equal(got[..., 2::3], want[..., 2::3])


@pytest.mark.cuda
@pytest.mark.parametrize("growth,counter", [
    ({}, "build_histogram_cuda"),
    ({"tree_growth": "frontier"}, "build_histogram_slots_cuda"),
    ({"tree_growth": "batched"}, "build_histogram_slots6_cuda"),
    ({"tree_growth": "batched", "tpu_batched_part": "true"},
     "build_histogram_part_tiles_cuda")])
def test_bundled_training_on_the_card(cuda_device, growth, counter):
    """Training on the bundled workload (chip_smoke.py ``bundled_data`` at
    20,000 rows, 3 one-hot blocks of 8) on the card: EFB bundles and
    packed b-tag pairs on, the grower's kernel launched, and the trees of
    the same run on the CPU up to f32 gain ties (chip_smoke.py's rule);
    raw predictions within 1e-4 where the trees are identical."""
    import chip_smoke
    x, y = chip_smoke.bundled_data(20_000, groups=3, width=8)
    params = dict({"objective": "binary", "num_leaves": 31,
                   "min_data_in_leaf": 40, "verbosity": -1}, **growth)
    wrapper = getattr(kernels, counter)
    before = wrapper.launches
    bst = tlgb.train(params, tlgb.Dataset(x, label=y), num_boost_round=3)
    assert wrapper.launches > before
    ds = bst._impl.train_data
    assert ds.has_bundles and ds.has_packed
    assert bst._impl.grow_params.with_efb
    cpu = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                     num_boost_round=3, device="cpu")
    if chip_smoke.trees_match(bst.models, cpu.models):
        np.testing.assert_allclose(bst.predict(x, raw_score=True),
                                   cpu.predict(x, raw_score=True), rtol=0,
                                   atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("growth,counter", [
    ({}, "build_histogram_cuda"),
    ({"tree_growth": "frontier"}, "build_histogram_slots_cuda"),
    ({"tree_growth": "batched"}, "build_histogram_slots6_cuda"),
    ({"tree_growth": "batched", "tpu_batched_pack": True},
     "build_histogram_slots_cuda"),
    ({"tree_growth": "batched", "tpu_batched_part": "true"},
     "build_histogram_part_tiles_cuda")])
def test_categorical_training_on_the_card(cuda_device, growth, counter):
    """Training on the categorical workload (chip_smoke.py
    ``categorical_data`` at 20,000 rows, four id columns) on the card: the
    grower's kernel launched, categorical splits made, and the trees of
    the same run on the CPU up to f32 gain ties (chip_smoke.py's rule, the
    bin bitsets included); raw predictions within 1e-5 where the trees are
    identical, and the valid scores on the card the model's
    predictions."""
    import chip_smoke
    x, y = chip_smoke.categorical_data(20_000)
    xv, yv = chip_smoke.categorical_data(5_000, seed=1)
    params = dict({"objective": "binary", "num_leaves": 31,
                   "min_data_in_leaf": 40, "verbosity": -1}, **growth)
    cat = chip_smoke.CATEGORICAL_FEATURES
    wrapper = getattr(kernels, counter)
    before = wrapper.launches
    tr = tlgb.Dataset(x, label=y, categorical_feature=cat)
    bst = tlgb.train(params, tr, num_boost_round=3,
                     valid_sets=[tr.create_valid(xv, label=yv)],
                     verbose_eval=False)
    assert wrapper.launches > before
    assert chip_smoke.categorical_splits(bst.models)["categorical"] > 0
    np.testing.assert_allclose(bst._impl.scores_of(1),
                               bst.predict(xv, raw_score=True), rtol=0,
                               atol=1e-5)
    cpu = tlgb.train(params, tlgb.Dataset(x, label=y, categorical_feature=cat,
                                          device="cpu"),
                     num_boost_round=3, device="cpu")
    if chip_smoke.trees_match(bst.models, cpu.models, categorical=True):
        np.testing.assert_allclose(bst.predict(x, raw_score=True),
                                   cpu.predict(x, raw_score=True), rtol=0,
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("objective,growth,counter", [
    ("multiclass", {}, "build_histogram_cuda"),
    ("multiclassova", {"tree_growth": "frontier"},
     "build_histogram_slots_cuda"),
    ("multiclass", {"tree_growth": "batched"}, "build_histogram_slots6_cuda"),
    ("multiclass", {"tree_growth": "batched", "tpu_batched_part": "true"},
     "build_histogram_part_tiles_cuda")])
def test_multiclass_training_on_the_card(cuda_device, objective, growth,
                                         counter):
    """Multiclass on the card (chip_smoke.py ``multiclass_data`` at 20,000
    rows, 5 classes): 5 trees an iteration, each launching the grower's
    kernel; the valid scores on the card the model's [N, 5] predictions;
    the model text reloaded predicts the same; the trees of the same run
    on the CPU up to f32 gain ties (chip_smoke.py's rule), and raw
    predictions within 1e-4 where the trees are identical, as on the
    bundled data: the kernels and the CPU's plain version sum in other
    orders, and a small leaf's value carries an ulp of its ancestors'
    sums (chip_smoke.py ``F64_RAW_TOL``; measured 2.3e-5 for one-vs-all
    under frontier growth)."""
    import chip_smoke
    x, y = chip_smoke.multiclass_data(20_000)
    xv, yv = chip_smoke.multiclass_data(5_000, seed=1)
    params = dict({"objective": objective, "num_leaves": 31,
                   "min_data_in_leaf": 40, "verbosity": -1},
                  **chip_smoke.objective_params(objective), **growth)
    k = chip_smoke.NUM_CLASS
    wrapper = getattr(kernels, counter)
    before = wrapper.launches
    tr = tlgb.Dataset(x, label=y)
    bst = tlgb.train(params, tr, num_boost_round=3,
                     valid_sets=[tr.create_valid(xv, label=yv)],
                     verbose_eval=False)
    assert wrapper.launches - before >= 3 * k
    assert len(bst.models) == 3 * k
    raw = bst.predict(xv, raw_score=True)
    assert raw.shape == (len(xv), k)
    np.testing.assert_allclose(bst._impl.scores_of(1), raw, rtol=0,
                               atol=1e-5)
    loaded = tlgb.Booster(model_str=bst.model_to_string())
    np.testing.assert_allclose(loaded.predict(xv, raw_score=True), raw,
                               rtol=0, atol=1e-6)
    cpu = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                     num_boost_round=3, device="cpu")
    if chip_smoke.trees_match(bst.models, cpu.models):
        np.testing.assert_allclose(bst.predict(x, raw_score=True),
                                   cpu.predict(x, raw_score=True), rtol=0,
                                   atol=1e-4)


@pytest.mark.cuda
def test_raw_bitsets_past_255_predict_on_the_card(cuda_device):
    """Category ids past 255 route through the raw bitset on the card as on
    the CPU: ids in the bitset, ids out of it, a truncated id, NaN, a
    negative id and an id past the bitset's width."""
    r = np.random.RandomState(4)
    n = 6_000
    x = r.randn(n, 4)
    k = r.randint(0, 12, n)
    x[:, 3] = 300 + 977 * k
    y = (x[:, 0] + np.random.RandomState(9).randn(12)[k] > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
    bst = tlgb.train(params, tlgb.Dataset(x, label=y, categorical_feature=[3],
                                          device="cpu"),
                     num_boost_round=3, device="cpu")
    import chip_smoke
    assert chip_smoke.categorical_splits(bst.models)["max_category"] >= 256
    card = tlgb.Booster(model_str=bst.model_to_string())
    xt = x.copy()
    xt[::6, 3] = np.nan
    xt[1::6, 3] = -300.0
    xt[2::6, 3] = 300.5
    xt[3::6, 3] = 1e9
    xt[4::6, 3] = 301.0
    np.testing.assert_allclose(card.predict(xt, raw_score=True),
                               bst.predict(xt, raw_score=True), rtol=0,
                               atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("scores", ["random", "leaf_tied"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unw", "w"])
def test_lambdarank_gradient_on_the_card_matches_the_cpu(cuda_device,
                                                         weighted, scores):
    """The lambdarank gradient (plain torch ops, chunked by query length)
    on the card against the same call on the CPU: queries of 1-400 docs in
    chunks of a 1 MiB cap, each element within 1e-6 of its query's sum of
    |g| (or |h|): the card's exp and its sums over a query's pairs may
    round otherwise than the CPU's."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.objectives import LambdarankNDCG
    r = np.random.RandomState(8)
    sizes = np.concatenate([[1, 400], r.randint(1, 200, 120)])
    n = int(sizes.sum())
    meta = Metadata(n)
    meta.set_label(r.choice(5, n, p=[0.5, 0.3, 0.15, 0.04, 0.01]))
    meta.set_weight(r.rand(n) + 0.5 if weighted else None)
    meta.set_query(sizes)
    s = (r.randn(n) if scores == "random"
         else r.choice([-0.2, 0.0, 0.3], n)).astype(np.float32)
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        obj = LambdarankNDCG(Config({"objective": "lambdarank"}),
                             pair_bytes_cap=1 << 20)
        obj.init(meta, dev)
        assert len(obj.chunks) > 3
        out[dev.type] = [a.cpu().numpy() for a in
                         obj.get_gradients(torch.as_tensor(s, device=dev))]
    qid = np.repeat(np.arange(len(sizes)), sizes)
    for got, want in zip(out["cuda"], out["cpu"]):
        qsum = np.bincount(qid, weights=np.abs(want))
        assert (np.abs(got - want) <= 1e-6 * qsum[qid]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("objective,growth,counter", [
    ("lambdarank", {}, "build_histogram_cuda"),
    ("lambdarank", {"tree_growth": "frontier"}, "build_histogram_slots_cuda"),
    ("lambdarank", {"tree_growth": "batched"}, "build_histogram_slots6_cuda"),
    ("lambdarank", {"tree_growth": "batched", "tpu_batched_part": "true"},
     "build_histogram_part_tiles_cuda"),
    ("xentropy", {"tree_growth": "frontier"}, "build_histogram_slots_cuda"),
    ("xentlambda", {"tree_growth": "batched"},
     "build_histogram_slots6_cuda")])
def test_ranking_and_cross_entropy_training_on_the_card(cuda_device,
                                                        objective, growth,
                                                        counter):
    """Lambdarank on chip_smoke.py ``ranking_data`` (20,000 rows in ~200
    queries, a valid set with its own groups) and the cross-entropy
    objectives on ``xentropy_data`` (xentlambda weighted) on the card: each
    tree launches the grower's kernel, the valid scores on the card are the
    model's predictions, the model text reloaded predicts the same, and the
    trees of the same run on the CPU agree up to f32 gain ties
    (chip_smoke.py's rule), with raw predictions within 1e-4 where the
    trees are identical (chip_smoke.py ``F64_RAW_TOL``'s reason)."""
    import chip_smoke
    if objective == "lambdarank":
        x, y, group = chip_smoke.ranking_data(20_000)
        xv, yv, group_v = chip_smoke.ranking_data(5_000, seed=1)
        w = wv = None
        params = dict(chip_smoke.RANKING_PARAMS)
    else:
        x, y, w = chip_smoke.xentropy_data(20_000)
        xv, yv, wv = chip_smoke.xentropy_data(5_000, seed=1)
        group = group_v = None
        if objective == "xentropy":
            w = wv = None
        params = {"objective": objective}
    params.update(num_leaves=31, min_data_in_leaf=40, verbosity=-1,
                  **growth)
    wrapper = getattr(kernels, counter)
    before = wrapper.launches
    tr = tlgb.Dataset(x, label=y, weight=w, group=group)
    bst = tlgb.train(params, tr, num_boost_round=3,
                     valid_sets=[tr.create_valid(xv, label=yv, weight=wv,
                                                 group=group_v)],
                     verbose_eval=False)
    assert wrapper.launches - before >= 3
    assert len(bst.models) == 3
    assert all(t.num_leaves_actual > 1 for t in bst.models)
    raw = bst.predict(xv, raw_score=True)
    np.testing.assert_allclose(bst._impl.scores_of(1), raw, rtol=0,
                               atol=1e-5)
    loaded = tlgb.Booster(model_str=bst.model_to_string())
    np.testing.assert_allclose(loaded.predict(xv, raw_score=True), raw,
                               rtol=0, atol=1e-6)
    cpu = tlgb.train(params, tlgb.Dataset(x, label=y, weight=w, group=group,
                                          device="cpu"),
                     num_boost_round=3, device="cpu")
    if chip_smoke.trees_match(bst.models, cpu.models):
        np.testing.assert_allclose(bst.predict(x, raw_score=True),
                                   cpu.predict(x, raw_score=True), rtol=0,
                                   atol=1e-4)


@pytest.mark.cuda
def test_mask_draw_on_the_card_matches_the_cpu(cuda_device):
    """A 1,000,000-row threefry draw (a bagging mask's uniforms, int64
    torch ops) on the card is bit-equal to the same draw on the CPU."""
    from lightgbm_tpu_torch import random as threefry
    key = threefry.split(threefry.prng_key(3))[1]
    got = threefry.uniform(key, 1_000_000, cuda_device)
    assert got.device.type == "cuda"
    want = threefry.uniform(key, 1_000_000, "cpu")
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,growth,counter", [
    ({"bagging_fraction": 0.5, "bagging_freq": 1}, {},
     "build_histogram_cuda"),
    ({"boosting": "goss", "learning_rate": 0.5},
     {"tree_growth": "frontier"}, "build_histogram_slots_cuda"),
    ({"boosting": "dart", "skip_drop": 0.0}, {"tree_growth": "batched"},
     "build_histogram_slots6_cuda"),
    ({"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1},
     {"tree_growth": "batched", "tpu_batched_part": "true"},
     "build_histogram_part_tiles_cuda")],
    ids=["bagging-exact", "goss-frontier", "dart-batched", "rf-part"])
def test_sampled_training_on_the_card(cuda_device, mode, growth, counter):
    """Bagging, GOSS, DART and RF on the card (bench.py's data at 20,000
    rows, 4 rounds, a valid set): each launches its grower's kernel on
    masks with zeros (and GOSS's amplified gradients); the valid scores
    are the model's predictions; the model text reloads; the trees of the
    same run on the CPU, which draws the same masks, up to f32 gain ties,
    and raw predictions within 1e-4 where they are identical (as
    test_multiclass_training_on_the_card)."""
    import chip_smoke
    x, y = chip_smoke.bench_data(20_000)
    xv, yv = chip_smoke.bench_data(5_000, seed=1)
    params = dict({"objective": "binary", "num_leaves": 31,
                   "min_data_in_leaf": 40, "verbosity": -1}, **mode,
                  **growth)
    wrapper = getattr(kernels, counter)
    before = wrapper.launches
    tr = tlgb.Dataset(x, label=y)
    bst = tlgb.train(params, tr, num_boost_round=4,
                     valid_sets=[tr.create_valid(xv, label=yv)],
                     verbose_eval=False)
    assert wrapper.launches - before >= 4
    assert len(bst.models) == 4
    raw = bst.predict(xv, raw_score=True)
    np.testing.assert_allclose(bst._impl.scores_of(1), raw, rtol=0,
                               atol=1e-5)
    loaded = tlgb.Booster(model_str=bst.model_to_string())
    np.testing.assert_allclose(loaded.predict(xv, raw_score=True), raw,
                               rtol=0, atol=1e-6)
    cpu_tr = tlgb.Dataset(x, label=y, device="cpu")
    cpu = tlgb.train(params, cpu_tr, num_boost_round=4, device="cpu",
                     valid_sets=[cpu_tr.create_valid(xv, label=yv)],
                     verbose_eval=False)
    # sampled rows tie more often, and later trees follow the tie
    # (chip_smoke.trees_match)
    sampled = (mode.get("boosting") == "goss"
               or mode.get("bagging_freq", 0) > 0)
    if chip_smoke.trees_match(bst.models, cpu.models, sampled=sampled):
        np.testing.assert_allclose(bst.predict(x, raw_score=True),
                                   cpu.predict(x, raw_score=True), rtol=0,
                                   atol=1e-4)
