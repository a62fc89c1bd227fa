"""JAX's threefry2x32 random numbers, bit for bit, in torch.

The JAX package draws its bagging masks and GOSS's Bernoulli rest from
``jax.random`` (gbdt.py:787, :1031-1046, :1135 there): ``PRNGKey(seed)``,
``split(key, num)`` and ``uniform(key, (n,))`` for float32. The port may not
import JAX, so this module computes the same bits: the Threefry-2x32 hash
of Salmon et al. (20 rounds, JAX's ``_threefry2x32_lowering``) on int64
tensors masked to 32 bits (torch's ``uint32`` lacks the arithmetic).

The layout is JAX's ``jax_threefry_partitionable=True`` (the default from
JAX 0.5 on, and the setting of the JAX package's tests):

- ``split(key, num)``: the hash of the counter pairs (0, i), i < num, under
  ``key``; key i is the pair of the two output words
  (``_threefry_split_foldlike``);
- ``uniform(key, n)``: the same hash of (0, i), i < n, whose two words are
  XORed into the 32 random bits of value i
  (``_threefry_random_bits_partitionable``), of which the top 23 become
  the mantissa of a float in [1, 2), less 1 (``random.py _uniform``);
- ``uniform(key, n, dtype=torch.float64)``: what ``uniform`` gives under
  ``jax_enable_x64``, which the JAX package turns on for f64 histograms
  (``gpu_use_dp``), so its bagging and GOSS draws become float64 there:
  the two words of value i are its 64 random bits (high word first), of
  which the top 52 become the mantissa.

A key is two Python ints (k0, k1) or a [2] tensor. Keys stay on the host:
``split`` runs on the CPU, and ``uniform`` takes the key as two scalars into
its ops on ``device``, so a draw never waits on the device.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

Key = Tuple[int, int]
KeyLike = Union[Key, Sequence[int], torch.Tensor]

MASK32 = 0xFFFFFFFF
# the key schedule's parity constant (Threefish's C240)
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _as_key(key: KeyLike) -> Key:
    if isinstance(key, torch.Tensor):
        key = key.tolist()
    k0, k1 = (int(v) & MASK32 for v in key)
    return k0, k1


def prng_key(seed: int, x64: bool = False) -> Key:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the seed as an
    int32, its high word 0 and its low word the seed's 32 bits
    (``prng.threefry_seed``). With ``x64`` (64-bit types on) the seed is
    an int64 split into its high and low words."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError("seed %d does not fit in int32" % seed)
    return ((seed >> 32) & MASK32 if x64 else 0), seed & MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key: KeyLike, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two output words of Threefry-2x32 under ``key`` for counter words
    ``x0`` and ``x1`` (int64 tensors of values below 2**32)."""
    k0, k1 = _as_key(key)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def _counter_bits(key: KeyLike, n: int, device) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """The hash of the counters (0, i), i < n: the 64-bit iota split into
    its high and low words (``prng.iota_2x32_shape``)."""
    lo = torch.arange(n, dtype=torch.int64, device=device)
    return threefry2x32(key, torch.zeros_like(lo), lo)


def split(key: KeyLike, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)``: ``num`` new keys."""
    b0, b1 = _counter_bits(key, num, "cpu")
    return list(zip(b0.tolist(), b1.tolist()))


def random_bits(key: KeyLike, n: int, device=None) -> torch.Tensor:
    """[n] int64 tensor of the 32 random bits of each value, as
    ``jax.random.bits(key, (n,), uint32)`` gives them."""
    b0, b1 = _counter_bits(key, n, device)
    return b0 ^ b1


def uniform(key: KeyLike, n: int, device=None,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), dtype)``: [n] values in [0, 1) on
    ``device``, float32 or float64."""
    if dtype == torch.float64:
        hi, lo = _counter_bits(key, n, device)
        # the top 52 of the 64 bits hi:lo over 2^52: exact in float64
        return ((hi << 20) | (lo >> 12)).to(torch.float64) * 2.0 ** -52
    bits = (random_bits(key, n, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
