"""Objective functions: gradients and hessians as tensor expressions.

The port of ``lightgbm_tpu/objectives.py`` for the binary objective
(binary_objective.hpp:20-190 of the reference). The per-row arrays live on
the booster's device; ``get_gradients`` is a handful of elementwise ops in
float32, the same arithmetic in the same order as the JAX package.
Every other objective raises ``NotImplementedError`` naming the slice of the
port that brings it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config
from .io.dataset import Metadata
from .log import Log, LightGBMError, check, outside_slice


class ObjectiveFunction:
    """Interface mirror of objective_function.h:15-69."""

    name = "custom"
    num_model_per_iteration = 1
    need_accurate_prediction = True

    def __init__(self, config: Config):
        self.config = config
        self.weights: Optional[torch.Tensor] = None
        self._label_np: Optional[np.ndarray] = None
        self._weight_np: Optional[np.ndarray] = None

    def init(self, metadata: Metadata, device: torch.device) -> None:
        check(metadata.label is not None,
              "label is required for objective %s" % self.name)
        self._label_np = np.asarray(metadata.label, np.float32)
        self._weight_np = (None if metadata.weight is None
                           else np.asarray(metadata.weight, np.float32))
        self.weights = (None if self._weight_np is None
                        else torch.as_tensor(self._weight_np, device=device))

    def _apply_weights(self, grad: torch.Tensor, hess: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.weights is not None:
            return grad * self.weights, hess * self.weights
        return grad, hess

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def convert_output(self, score):
        return score


class BinaryLogloss(ObjectiveFunction):
    """binary_objective.hpp:20-190."""
    need_accurate_prediction = False
    name = "binary"

    def init(self, metadata, device):
        super().init(metadata, device)
        lab = self._label_np
        uniq = np.unique(lab)
        if not np.all(np.isin(uniq, [0, 1])):
            # the reference accepts {-1, 1} too (binary_objective.hpp:40-70)
            if np.all(np.isin(uniq, [-1, 1])):
                lab = (lab > 0).astype(np.float32)
            else:
                raise LightGBMError("[binary]: label must be 0/1 (or -1/+1)")
        cnt_pos = float(lab.sum())
        cnt_neg = float(len(lab) - lab.sum())
        if cnt_pos == 0 or cnt_neg == 0:
            Log.warning("Contains only one class")
        w_pos, w_neg = 1.0, 1.0
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.config.scale_pos_weight
        self._label01_np = lab.astype(np.float32)
        self.y_signed = torch.as_tensor(2 * self._label01_np - 1, device=device)
        self.label_weight = torch.as_tensor(
            np.where(lab > 0, w_pos, w_neg).astype(np.float32), device=device)

    def get_gradients(self, score):
        sig = self.config.sigmoid
        response = -self.y_signed * sig / (
            1.0 + torch.exp(self.y_signed * sig * score))
        abs_r = torch.abs(response)
        grad = response * self.label_weight
        hess = abs_r * (sig - abs_r) * self.label_weight
        return self._apply_weights(grad, hess)

    def boost_from_score(self, class_id=0):
        pavg = float(np.average(self._label01_np, weights=self._weight_np))
        pavg = min(max(pavg, 1e-15), 1 - 1e-15)
        init = math.log(pavg / (1 - pavg)) / self.config.sigmoid
        Log.info("[binary:BoostFromScore]: pavg=%.6f -> initscore=%.6f",
                 pavg, init)
        return init

    def convert_output(self, score):
        """Probabilities from raw scores (numpy, on the host)."""
        return 1.0 / (1.0 + np.exp(-self.config.sigmoid * np.asarray(score)))


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """Factory (objective_function.cpp:11-42), binary only in this slice."""
    name = config.objective
    if name in ("none", "", None):
        raise outside_slice("custom objectives (fobj)")
    if name != "binary":
        raise outside_slice("objective=%s" % name, "ROADMAP Queue 1 #2")
    return BinaryLogloss(config)
