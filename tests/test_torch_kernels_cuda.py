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


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,b,k", [(100_003, 28, 255, 3),
                                     (100_003, 28, 255, 6),
                                     (17, 5, 16, 3), (4096, 3, 256, 6)])
def test_cuda_kernel_matches_plain(cuda_device, n, f, b, k):
    """|kernel - plain| <= 1e-5 * sum_bin|v| + 1e-6 in every cell, and the
    dispatch counts one launch."""
    xb, vals = _inputs(n, f, b, k, seed=n + k)
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
    """Bins, slots (about ``active`` of the rows in a slot, one slot left
    absent, a few rows past the last slot), values and a selector."""
    r = np.random.RandomState(seed)
    xb = r.randint(0, b, (n, f)).astype(np.uint8)
    slot = r.randint(0, n_slots, n).astype(np.int32)
    slot[slot == n_slots // 2] = n_slots - 1          # an absent slot
    slot[r.rand(n) >= active] = -1
    slot[:3] = n_slots + 5                            # folds into S - 1
    vals = r.randn(n, 3).astype(np.float32)
    sel = (r.rand(n) < 0.5).astype(np.float32)
    return xb, slot, vals, sel


def _to(dev, *arrays):
    return [torch.as_tensor(a, device=dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,b,s", [(100_003, 28, 255, 254),
                                     (100_003, 28, 255, 16),
                                     (4096, 5, 64, 1), (17, 3, 16, 7)])
def test_slot_kernel_matches_plain(cuda_device, n, f, b, s):
    """|kernel - plain| <= 1e-5 * sum|v| + 1e-6 in every cell, the absent
    slot comes out zero, and the dispatch counts one launch."""
    xb, slot, vals, sel = _slot_inputs(n, f, b, s, seed=n + s)
    x, sl, v = _to(cuda_device, xb, slot, vals)
    before = kernels.build_histogram_slots_cuda.launches
    got = th.hist_slots(x, sl, v, b, s, "auto").cpu().numpy()
    assert kernels.build_histogram_slots_cuda.launches == before + 1
    cpu = [torch.as_tensor(a) for a in (xb, slot, vals)]
    want = th.hist_slots_plain(*cpu, b, s).numpy()
    absum = th.hist_slots_plain(cpu[0], cpu[1], cpu[2].abs(), b, s).numpy()
    assert got.shape == (s, f, b, 3)
    assert (np.abs(got - want) <= 1e-5 * absum + 1e-6).all()
    if s > 2:
        assert not got[s // 2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,b,s", [(100_003, 28, 255, 16),
                                     (4096, 5, 64, 3)])
def test_slot6_kernel_matches_plain(cuda_device, n, f, b, s):
    xb, slot, vals, sel = _slot_inputs(n, f, b, s, seed=n + 6 * s)
    x, sl, v, se = _to(cuda_device, xb, slot, vals, sel)
    before = kernels.build_histogram_slots6_cuda.launches
    got = th.hist_slots6(x, sl, se, v, b, s, "auto").cpu().numpy()
    assert kernels.build_histogram_slots6_cuda.launches == before + 1
    cpu = [torch.as_tensor(a) for a in (xb, slot, sel, vals)]
    want = th.hist_slots6_plain(*cpu, b, s).numpy()
    absum = th.hist_slots6_plain(*cpu[:3], cpu[3].abs(), b, s).numpy()
    assert got.shape == (s, f, b, 6)
    assert (np.abs(got - want) <= 1e-5 * absum + 1e-6).all()
    if s > 2:
        assert not got[s // 2].any()


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


def _part_layout(n_rows, num_leaves, f, b, n_slots, seed):
    """chip_smoke.py's partitioned layout of ``n_rows`` rows at
    ``num_leaves`` leaves: numpy (xb_fm, sel, vals3, tile_slot,
    tile_first) and the row tile. The file runs from the root of the
    checkout, where chip_smoke.py lies."""
    import chip_smoke
    arrays, tile = chip_smoke.part_layout(np.random.RandomState(seed),
                                          n_rows, num_leaves, f, b, n_slots)
    return (*arrays, tile)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [16, 1])
def test_part_kernel_matches_plain(cuda_device, s):
    """|kernel - plain| <= 1e-5 * sum|v| + 1e-6 on the layout of 100,003
    rows at 255 leaves; a slot without a tile comes out zero; one launch."""
    b = 255
    *arrays, row_tile = _part_layout(100_003, 255, 28, b, s, seed=s)
    before = kernels.build_histogram_part_tiles_cuda.launches
    got = th.hist_part_tiles(*_to(cuda_device, *arrays), b, s, row_tile,
                             "auto").cpu().numpy()
    assert kernels.build_histogram_part_tiles_cuda.launches == before + 1
    cpu = [torch.as_tensor(a) for a in arrays]
    want = th.hist_part_tiles_plain(*cpu, b, s, row_tile).numpy()
    absum = th.hist_part_tiles_plain(cpu[0], cpu[1], cpu[2].abs(), *cpu[3:],
                                     b, s, row_tile).numpy()
    assert got.shape == (s, 28, b, 6)
    assert (np.abs(got - want) <= 1e-5 * absum + 1e-6).all()
    if s > 2:
        assert not got[s // 2].any()


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
