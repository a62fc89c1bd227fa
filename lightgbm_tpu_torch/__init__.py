"""lightgbm_tpu_torch: the PyTorch and CUDA port of lightgbm_tpu.

A second package beside ``lightgbm_tpu`` with the same public surface
(``Dataset``, ``Booster``, ``train`` and the training callbacks) for the
slices it covers: the regression family (L2, L1, Huber, Fair, Poisson,
quantile, MAPE, gamma, Tweedie, with leaf renewal for L1, quantile and
MAPE) and binary objectives, dense numerical features, training on one
device with leaf-wise exact, frontier-wave or top-K batched growth
(``tree_growth``, batched also over rows kept grouped by leaf with
``tpu_batched_part=true``), validation sets, early stopping, learning-rate
schedules, continued training, and prediction. The histogram passes run
as CUDA kernels written for Hopper (``core/csrc/histogram.cu``,
``hist_slots.cu`` and ``hist_part.cu``), as does the in-tile row partition
(``core/csrc/repack.cu``); everything else is PyTorch. Entry points run on
CUDA unless the caller passes ``device="cpu"``.
"""
from . import callback
from .basic import Booster, Dataset
from .callback import (early_stopping, print_evaluation, record_evaluation,
                       reset_parameter)
from .engine import train
from .log import LightGBMError

__all__ = ["Booster", "Dataset", "LightGBMError", "callback",
           "early_stopping", "print_evaluation", "record_evaluation",
           "reset_parameter", "train"]
