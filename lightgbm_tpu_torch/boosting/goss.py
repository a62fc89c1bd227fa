"""GOSS boosting (Gradient-based One-Side Sampling).

The port of ``lightgbm_tpu/boosting/goss.py`` and of the GOSS branch of its
training step (gbdt.py:1085-1143 there; goss.hpp BaggingHelper :87-135 of
the reference): the rows whose ``|g h|``, summed over the classes, reaches
the ``top_rate`` share's threshold are kept, every one of them, so rows
tied at the threshold can make more than ``top_rate`` of them; each of the
rest is kept where its threefry uniform (the iteration's GOSS key) is
below ``other_cnt / (n - top_cnt)`` and its gradient and hessian are
amplified by ``(n - top_cnt) / other_cnt``. The trees and renewal grow on
the bagging mask times the kept rows. For the first ``1 / learning_rate``
iterations GOSS does not sample (goss.hpp Bagging :137-140).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import random as threefry
from ..log import LightGBMError
from .gbdt import GBDT, as_f32


def goss_counts(n: int, top_rate: float, other_rate: float
                ) -> Tuple[int, int]:
    """(top_cnt, other_cnt) of ``n`` rows (goss.hpp:92-93)."""
    return max(1, int(n * top_rate)), max(1, int(n * other_rate))


def goss_multipliers(grad: torch.Tensor, hess: torch.Tensor, key,
                     top_rate: float, other_rate: float) -> torch.Tensor:
    """[N] float32 multipliers of GOSS for [K, N] ``grad`` and ``hess``: 1
    for the top rows, the amplification for the sampled rest, 0 for the
    rows left out."""
    n = grad.shape[1]
    top_cnt, other_cnt = goss_counts(n, top_rate, other_rate)
    gh = (grad * hess).abs().sum(dim=0)
    thr = torch.topk(gh, top_cnt).values[-1]
    is_top = gh >= thr
    u = threefry.uniform(key, n, grad.device)
    keep_other = ~is_top & (u < as_f32(other_cnt / max(n - top_cnt, 1)))
    amplify = as_f32((n - top_cnt) / other_cnt)
    return torch.where(is_top, 1.0,
                       torch.where(keep_other, amplify, 0.0)).to(
                           torch.float32)


class GOSS(GBDT):
    """GBDT on GOSS's rows (goss.hpp)."""

    boosting_type = "goss"

    def __init__(self, config, train_data, objective, metrics=None,
                 device: torch.device = torch.device("cpu")):
        if config.bagging_freq > 0 and config.bagging_fraction != 1.0:
            raise LightGBMError("Cannot use bagging in GOSS")
        if not (config.top_rate > 0.0 and config.other_rate > 0.0):
            raise LightGBMError("GOSS needs top_rate > 0 and other_rate > 0")
        super().__init__(config, train_data, objective, metrics,
                         device)

    def goss_active(self, iter_idx: int) -> bool:
        """Whether iteration ``iter_idx`` samples: not in the first
        ``int(1 / learning_rate)`` (goss.py:28-30 of the JAX package)."""
        return iter_idx >= int(1.0 / max(self.config.learning_rate, 1e-12))

    def _row_sample(self, grad, hess, sample_mask, goss_key):
        if not self.goss_active(self.iter_):
            return grad, hess, sample_mask
        mult = goss_multipliers(grad, hess, goss_key, self.config.top_rate,
                                self.config.other_rate)
        return (grad * mult, hess * mult,
                sample_mask * (mult > 0).to(torch.float32))
