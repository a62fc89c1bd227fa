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


PLAN_ROWS = (1, 17, 512, 4096, 7434, 65_536, 262_144, 1_000_000)


def test_launch_plan_fits_shared_memory():
    """For every variant the plan picks at exact growth's shapes (and a
    forced other one), the grid covers every row and feature, shared
    memory stays within what the variant requests and the card allows,
    the grid fills 132 SMs from 4,096 rows on, and no variant keeps
    device-memory scratch (a partial would have to stay under 10% of the
    function's bytes at n >= 262,144)."""
    sms = 132
    for f, b, k in [(28, 255, 3), (28, 255, 6), (28, 256, 6), (5, 16, 3),
                    (1, 255, 6), (64, 255, 6)]:
        for n in PLAN_ROWS:
            picked = kernels.hist_launch_plan(n, f, b, k, sm_count=sms)
            assert picked.variant == ("direct" if n <= kernels.
                                      HIST_DIRECT_MAX_ROWS else "block")
            for plan in (picked, *(kernels.hist_launch_plan(
                    n, f, b, k, sm_count=sms, variant=v)
                    for v in kernels.HIST_VARIANTS)):
                if plan.variant == "direct":
                    assert plan.smem_bytes == 0
                    assert plan.threads == kernels.HIST_DIRECT_THREADS
                    # one thread a 4-byte word, plus one for a misaligned
                    # start
                    assert plan.grid_x * plan.threads * 4 >= n * f + 3
                    blocks = plan.grid_x
                else:
                    assert plan.threads == kernels.HIST_BLOCK_THREADS
                    # replicas of 16-byte-aligned [Ft, B, K] f32
                    # histograms
                    replica = -(-plan.feature_tile * b * k * 4 // 16) * 16
                    assert plan.smem_bytes == plan.replicas * replica
                    assert plan.smem_bytes <= kernels.HIST_SMEM_OPT_IN
                    assert 1 <= plan.replicas <= kernels.HIST_MAX_REPLICAS
                    assert plan.grid_x * plan.feature_tile >= f > \
                        (plan.grid_x - 1) * plan.feature_tile
                    assert plan.grid_y * plan.rows_per_block >= n > \
                        (plan.grid_y - 1) * plan.rows_per_block
                    blocks = plan.grid_x * plan.grid_y
                if n >= 4096 and f == 28 and plan is picked:
                    assert blocks >= sms
            # whole rows in one tile whenever the histogram fits a block
            if picked.variant == "block" and f * b * k * 4 <= \
                    kernels.HIST_SMEM_OPT_IN:
                assert picked.grid_x == 1 and picked.feature_tile == f
    with pytest.raises(ValueError, match="variant"):
        kernels.hist_launch_plan(10, 3, 8, 3, sm_count=sms, variant="tiled")


def test_profile_script_names_every_histogram_kernel():
    """scripts/profile_main_path.py sums the port's kernels by name, so it
    must know every __global__ function of core/csrc/histogram.cu."""
    import re
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    src = (root / "lightgbm_tpu_torch" / "core" / "csrc" /
           "histogram.cu").read_text()
    names = re.findall(r"__global__\s+void\s+"
                       r"(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)
    assert names
    script = (root / "scripts" / "profile_main_path.py").read_text()
    own = re.search(r"OWN_KERNELS = \((.*?)\)", script, re.S).group(1)
    for name in names:
        assert '"%s"' % name in own


def test_plain_f64_sums_do_not_drift():
    """One cell of 1,000,000 equal float32 values (0.23784, a binary tree
    0's hessian): the default plain version's single running float32 sum
    drifts by about 1e-2 relative, as the JAX package's CPU scatter path
    does; ``f64_sums`` comes within 1e-6 of the float64 sum, on every
    plain version, and keeps the values' dtype."""
    n = 1_000_000
    xb = torch.zeros((n, 1), dtype=torch.uint8)
    vals = torch.full((n, 3), 0.23784, dtype=torch.float32)
    vals[:, 2] = 1.0                              # the count channel
    want = n * float(np.float32(0.23784))
    f32 = float(th.hist_plain(xb, vals, 4)[0, 0, 0])
    assert abs(f32 - want) / want > 5e-3
    slot = torch.zeros(n, dtype=torch.int32)
    sel = torch.ones(n)
    got = [th.hist_plain(xb, vals, 4, f64_sums=True)[0, 0],
           th.hist_tile_vals(xb, vals, 4, "plain", True)[0, 0],
           th.hist_slots(xb, slot, vals, 4, 1, "plain", True)[0, 0, 0],
           th.hist_slots6(xb, slot, sel, vals, 4, 1, "plain", True)[0, 0, 0],
           th.hist_part_tiles(xb.t().contiguous(), sel, vals.t(),
                              torch.zeros(1, dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32), 4, 1, n,
                              "plain", True)[0, 0, 0]]
    for h in got:
        assert h.dtype == torch.float32
        assert abs(float(h[0]) - want) / want < 1e-6
        assert float(h[2]) == n
