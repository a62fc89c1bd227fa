"""The port's histograms against the JAX package's on the same inputs.

``lightgbm_tpu_torch.core.histogram`` runs its plain PyTorch version on CPU
tensors; the JAX side runs the Pallas kernel in interpret mode. The Pallas
kernel contracts with a two-term bf16 split worth ~3e-6 of the bin's sum of
|v| (histogram_pallas.py:18-26), so the bound is 1e-5 * sum_bin|v| + 1e-7.
Against the JAX scatter path, which adds in f32 like the port, the bound is
1e-6 * sum_bin|v| + 1e-7.

The CUDA kernel itself runs only on a card: tests/test_torch_kernels_cuda.py
holds it against the plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.core.histogram import _hist_scatter
from lightgbm_tpu.core.histogram_pallas import build_histogram_pallas_vals
from lightgbm_tpu_torch.core import histogram as th
from lightgbm_tpu_torch.core import kernels


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


def _abs_sum(xb, vals, b):
    """sum over each (f, b) cell of |v|, the scale of its rounding error."""
    return th.hist_plain(torch.as_tensor(xb),
                         torch.as_tensor(np.abs(vals)), b).numpy()


@pytest.mark.parametrize("b", [16, 63, 255])
@pytest.mark.parametrize("f", [5, 28])
@pytest.mark.parametrize("n", [1000, 4097])
@pytest.mark.parametrize("k", [3, 6])
def test_plain_histogram_matches_pallas_interpret(k, n, f, b):
    xb, vals = _inputs(n, f, b, k, seed=n + f + b + k)
    ours = th.hist_tile_vals(torch.as_tensor(xb), torch.as_tensor(vals), b,
                             "auto").numpy()
    ref = np.asarray(build_histogram_pallas_vals(
        jnp.asarray(xb), jnp.asarray(vals.T), b, interpret=True))
    assert ours.shape == ref.shape == (f, b, k)
    bound = 1e-5 * _abs_sum(xb, vals, b) + 1e-7
    assert (np.abs(ours - ref) <= bound).all()
    scat = np.asarray(_hist_scatter(jnp.asarray(xb), jnp.asarray(vals), b))
    assert (np.abs(ours - scat) <= 1e-6 * _abs_sum(xb, vals, b) + 1e-7).all()


def test_build_histogram_stacks_grad_hess_mask():
    """K=3 root histogram: channels (grad*mask, hess*mask, mask), as
    build_histogram_pallas stacks them."""
    from lightgbm_tpu.core.histogram_pallas import build_histogram_pallas
    r = np.random.RandomState(5)
    n, f, b = 1500, 7, 40
    xb = r.randint(0, b, (n, f)).astype(np.uint8)
    g = r.randn(n).astype(np.float32)
    h = r.rand(n).astype(np.float32)
    m = (r.rand(n) > 0.3).astype(np.float32)
    ours = th.build_histogram(*(torch.as_tensor(a) for a in (xb, g, h, m)),
                              num_bins=b).numpy()
    ref = np.asarray(build_histogram_pallas(
        *(jnp.asarray(a) for a in (xb, g, h, m)), num_bins=b,
        interpret=True))
    vals = np.stack([g * m, h * m, m], axis=1)
    assert (np.abs(ours - ref) <= 1e-5 * _abs_sum(xb, vals, b) + 1e-7).all()
    # the count channel is exact
    np.testing.assert_array_equal(ours[..., 2], ref[..., 2])


def test_dispatch_never_falls_back():
    """The kernel's wrapper raises on a CPU tensor instead of running the
    plain version; ``plain`` runs anywhere; unknown spellings raise."""
    xb, vals = _inputs(64, 3, 8, 3, seed=1)
    xt, vt = torch.as_tensor(xb), torch.as_tensor(vals)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.build_histogram_cuda(xt, vt, 8)
    with pytest.raises(ValueError, match="impl"):
        th.hist_tile_vals(xt, vt, 8, "pallas")
    np.testing.assert_array_equal(th.hist_tile_vals(xt, vt, 8, "plain"),
                                  th.hist_tile_vals(xt, vt, 8, "auto"))


def test_launch_plan_fits_shared_memory():
    """The wrapper's plan keeps each block's [Ft, B, K] f32 sub-histogram
    within the 48 KB budget and covers every row and feature."""
    for n, f, b, k in [(1_000_000, 28, 255, 3), (4096, 28, 255, 6),
                       (262_144, 28, 255, 6), (17, 5, 16, 3)]:
        ft, r, rows = kernels.hist_launch_plan(n, f, b, k, sm_count=132)
        assert ft * b * k * 4 <= kernels.HIST_SMEM_BUDGET
        assert r * rows >= n and (r - 1) * rows < n
        assert 1 <= r <= kernels.HIST_MAX_ROW_BLOCKS
