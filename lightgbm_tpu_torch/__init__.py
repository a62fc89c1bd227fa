"""lightgbm_tpu_torch: the PyTorch and CUDA port of lightgbm_tpu.

A second package beside ``lightgbm_tpu`` with the same public surface
(``Dataset``, ``Booster``, ``train``) for the slice it covers: binary
objective, dense numerical features, leaf-wise exact growth and prediction
on one device. The histogram pass runs as a CUDA kernel written for
Hopper (``core/csrc/histogram.cu``); everything else is PyTorch. Entry
points run on CUDA unless the caller passes ``device="cpu"``.
"""
from .basic import Booster, Dataset
from .engine import train
from .log import LightGBMError

__all__ = ["Booster", "Dataset", "LightGBMError", "train"]
