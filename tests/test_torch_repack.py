"""The port's in-tile row partition against the JAX package's.

``partition_tiles`` on CPU tensors (the plain version beside the CUDA
kernel of ``core/csrc/repack.cu``) against the Pallas kernel in interpret
mode, on tests/test_repack_pallas.py's cases: the rows must come back
byte-equal and the per-tile left counts equal, with no go-left row, some,
and all of them.

The CUDA kernel runs only on a card: tests/test_torch_kernels_cuda.py holds
it against this plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.core.repack_pallas import partition_tiles as jax_partition
from lightgbm_tpu_torch.core import kernels
from lightgbm_tpu_torch.core.repack import partition_tiles


@pytest.mark.parametrize("p_left", [0.0, 0.3, 1.0])
def test_plain_partition_matches_pallas_interpret(p_left):
    r = np.random.RandomState(5)
    n, c, tile = 2048, 128, 256
    rows = r.randint(0, 256, (n, c)).astype(np.uint8)
    gl = r.rand(n) < p_left
    out, cnt = partition_tiles(torch.as_tensor(rows), torch.as_tensor(gl),
                               row_tile=tile)
    ref_out, ref_cnt = jax_partition(jnp.asarray(rows), jnp.asarray(gl),
                                     row_tile=tile, interpret=True)
    assert out.dtype == torch.uint8 and cnt.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref_cnt))
    for t in range(n // tile):
        sl = slice(t * tile, (t + 1) * tile)
        g = gl[sl]
        np.testing.assert_array_equal(
            out.numpy()[sl], np.concatenate([rows[sl][g], rows[sl][~g]]))


def test_numeric_go_left_counts_positive_as_left():
    """A float go_left is read as the JAX function reads it: > 0 is left."""
    r = np.random.RandomState(2)
    rows = r.randint(0, 256, (512, 128)).astype(np.uint8)
    gl = r.choice([0.0, 1.0, -1.0, 0.5], 512).astype(np.float32)
    out, cnt = partition_tiles(torch.as_tensor(rows), torch.as_tensor(gl),
                               row_tile=128)
    ref_out, ref_cnt = partition_tiles(torch.as_tensor(rows),
                                       torch.as_tensor(gl > 0), row_tile=128)
    np.testing.assert_array_equal(out.numpy(), ref_out.numpy())
    np.testing.assert_array_equal(cnt.numpy(), ref_cnt.numpy())


def test_partition_rejects_what_the_jax_function_rejects():
    rows = torch.zeros((512, 128), dtype=torch.uint8)
    gl = torch.zeros(512, dtype=torch.bool)
    with pytest.raises(ValueError, match="multiple of row_tile"):
        partition_tiles(rows, gl, row_tile=300)
    with pytest.raises(ValueError, match="multiple of 128"):
        partition_tiles(torch.zeros((512, 64), dtype=torch.uint8), gl)
    with pytest.raises(ValueError, match="impl"):
        partition_tiles(rows, gl, impl="pallas")


def test_partition_kernel_wrapper_raises_on_cpu_tensors():
    """The CUDA wrapper never runs the plain version: on CPU tensors it
    raises, and ``plain`` gives the same answer as ``auto`` on the CPU."""
    r = np.random.RandomState(3)
    rows = torch.as_tensor(r.randint(0, 256, (1024, 128)).astype(np.uint8))
    gl = torch.as_tensor(r.rand(1024) < 0.5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.partition_tiles_cuda(rows, gl, 512)
    for a, b in zip(partition_tiles(rows, gl, impl="plain"),
                    partition_tiles(rows, gl, impl="auto")):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_partition_bytes():
    """The bound's bytes: every row read and written once, its go-left
    byte, one count a tile."""
    assert kernels.partition_bytes(1024, 128, 512) == \
        2 * 1024 * 128 + 1024 + 4 * 2
