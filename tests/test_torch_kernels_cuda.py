"""The port's CUDA kernels on a card, against their plain PyTorch versions:
the histogram kernel (``histogram.cu``), the two slot kernels
(``hist_slots.cu``), the partitioned-layout kernel (``hist_part.cu``) and
the in-tile partition (``repack.cu``), alone and on the training paths
that launch them.

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
