"""lightgbm_tpu_torch: the PyTorch and CUDA port of lightgbm_tpu.

A second package beside ``lightgbm_tpu`` with the same public surface
(``Dataset``, ``Booster``, ``train``) for the slices it covers: binary
objective, dense numerical features, training on one device with leaf-wise
exact, frontier-wave or top-K batched growth (``tree_growth``, batched
also over rows kept grouped by leaf with ``tpu_batched_part=true``), and
prediction. The histogram passes run as CUDA kernels written for Hopper
(``core/csrc/histogram.cu``, ``hist_slots.cu`` and ``hist_part.cu``), as
does the in-tile row partition (``core/csrc/repack.cu``); everything else
is PyTorch. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
from .basic import Booster, Dataset
from .engine import train
from .log import LightGBMError

__all__ = ["Booster", "Dataset", "LightGBMError", "train"]
