"""Bin codes packed four to an int32 word (``tpu_bin_packing``).

The port of ``lightgbm_tpu/core/binpack.py``. Two layers share the name:

- pair coding (``io/dataset.py`` ``_pack_small_pairs``): two features of at
  most 16 bins share one stored 8-bit column, ``code = bin_a * nb_b +
  bin_b``. ``tpu_bin_packing=nibble`` raises the joint code's cap from the
  widest column to 256, so pairs form dataset-wide and the stored columns
  halve where every feature is small;
- word packing (this module): the stored 8-bit columns lie on the device
  as int32 words of four codes each, little-endian lanes
  (``word = c0 | c1 << 8 | c2 << 16 | c3 << 24``), the tail lanes of a
  row's last word zero. Byte for byte that is a uint8 [N, 4 W] matrix
  whose first C columns are the codes, so ``histogram.cu`` and
  ``hist_slots.cu`` read a packed row at a stride of 4 W bytes and skip
  the tail lanes (``core/kernels.py`` ``*_words_cuda``): no second,
  unpacked copy exists on the card. Routing gathers one code a row
  straight from the words (``gather_code_columns``).

``byte`` and ``nibble`` share the one word format; they differ only in
the dataset's pair coding. Every helper is layout-pure: pack then unpack
gives back the codes bit for bit for any column count.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# an int32 word holds 4 eight-bit codes, little-endian lanes
CODES_PER_WORD = 4
_LANE_BITS = 8
_LANE_MASK = 0xFF


def words_per_row(num_cols: int) -> int:
    """Words a packed row takes for ``num_cols`` 8-bit code columns."""
    return (int(num_cols) + CODES_PER_WORD - 1) // CODES_PER_WORD


def pack_words_np(xb: np.ndarray) -> np.ndarray:
    """uint8 [N, C] -> int32 [N, ceil(C / 4)] words, on the host; the tail
    lanes of the last word are zero (bin 0 is a valid code, and nothing
    reads columns >= C)."""
    xb = np.ascontiguousarray(xb, dtype=np.uint8)
    if xb.ndim != 2:
        raise ValueError("pack_words_np expects [N, C], got %s" % (xb.shape,))
    n, c = xb.shape
    w = words_per_row(c)
    padded = np.zeros((n, w * CODES_PER_WORD), dtype=np.uint8)
    padded[:, :c] = xb
    # little-endian uint8 lanes are the int32 word layout
    return padded.reshape(n, w, CODES_PER_WORD).view(np.uint32)[
        :, :, 0].astype(np.int32)


def unpack_words_np(xw: np.ndarray, num_cols: int) -> np.ndarray:
    """The inverse of ``pack_words_np``: int32 [N, W] -> uint8 [N, C]."""
    xw = np.ascontiguousarray(xw, dtype=np.int32)
    lanes = xw.view(np.uint8).reshape(xw.shape[0], -1)
    return lanes[:, :num_cols].copy()


def word_bytes(xw: torch.Tensor) -> torch.Tensor:
    """int32 [N, W] words -> their uint8 [N, 4 W] view (no copy): the codes
    in columns [0, C), zero tail lanes after them."""
    if xw.dtype != torch.int32 or xw.dim() != 2:
        raise ValueError("packed words must be a 2-D int32 tensor, got %s %s"
                         % (xw.dtype, tuple(xw.shape)))
    return xw.view(torch.uint8)


def unpack_words(xw: torch.Tensor, num_cols: int) -> torch.Tensor:
    """int32 [N, W] words -> uint8 [N, num_cols] codes, a contiguous copy
    (the plain versions' input; the kernels read the words in place)."""
    return word_bytes(xw)[:, :num_cols].contiguous()


def gather_code_columns(xw: torch.Tensor, cols: torch.Tensor
                        ) -> torch.Tensor:
    """The code of column ``cols[n]`` of each row n, int64 [N], gathered
    straight from the words: one word a row, then a shift and a mask (JAX
    ``binpack.py`` ``gather_code_columns`` for a per-row column)."""
    cols = cols.to(torch.int64)
    word = torch.gather(xw, 1, (cols // CODES_PER_WORD)[:, None])[:, 0]
    shift = (cols % CODES_PER_WORD) * _LANE_BITS
    return (word.to(torch.int64) >> shift) & _LANE_MASK


def resolve_bin_packing(mode: str, *, streamed: bool, tpu_shaped: bool,
                        col_num_bin: Sequence[int]) -> str:
    """``tpu_bin_packing=auto`` made concrete, as the JAX package resolves
    it: ``nibble`` on a TPU-shaped backend when every column has at most
    16 bins, else ``byte`` there; off one, ``byte`` for streamed ingest
    (host chunks in the kernels' word layout) and ``none`` in memory. The
    card is not TPU-shaped, so the port passes ``tpu_shaped=False``."""
    mode = str(mode).strip().lower()
    if mode != "auto":
        return mode
    all_small = all(int(b) <= 16 for b in col_num_bin) if col_num_bin \
        else False
    if tpu_shaped:
        return "nibble" if all_small else "byte"
    return "byte" if streamed else "none"
