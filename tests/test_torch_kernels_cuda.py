"""The port's CUDA kernels on a card, against their plain PyTorch versions.

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
