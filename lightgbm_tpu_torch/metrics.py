"""Evaluation metrics on the host.

The port's own copy of ``binary_logloss`` and ``auc`` from
``lightgbm_tpu/metrics.py`` (binary_metric.hpp of the reference). Metrics
run in NumPy on scores pulled from the device once per evaluation, off the
training hot path. Other metrics raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .config import Config
from .io.dataset import Metadata
from .log import outside_slice


class Metric:
    """metric.h interface analog."""

    names: List[str] = []
    factor_to_bigger_better = 1.0

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata: Metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = np.asarray(metadata.label)
        self.weights = (None if metadata.weight is None
                        else np.asarray(metadata.weight))
        self.sum_weights = (float(num_data) if self.weights is None
                            else float(self.weights.sum()))

    def eval(self, score: np.ndarray, convert_output=None) -> List[float]:
        raise NotImplementedError


class BinaryLoglossMetric(Metric):
    """binary_metric.hpp BinaryLoglossMetric (probabilities via the
    objective's ConvertOutput)."""
    names = ["binary_logloss"]
    factor_to_bigger_better = -1.0

    def eval(self, score, convert_output=None) -> List[float]:
        p = np.asarray(score, np.float64).reshape(-1)
        if convert_output is not None:
            p = np.asarray(convert_output(p))
        p = np.clip(p, 1e-15, 1 - 1e-15)
        y = self.label.astype(np.float64)
        losses = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        if self.weights is not None:
            return [float(np.sum(losses * self.weights) / self.sum_weights)]
        return [float(np.mean(losses))]


def auc(score: np.ndarray, label: np.ndarray,
        weight: Optional[np.ndarray] = None) -> float:
    """Weighted AUC with tied scores grouped (binary_metric.hpp:150-263):
    the sorted scan of the JAX package's AUCMetric, vectorized."""
    score = np.asarray(score, np.float64).reshape(-1)
    w = np.ones_like(score) if weight is None else np.asarray(weight,
                                                              np.float64)
    order = np.argsort(-score, kind="stable")
    s, y, w = score[order], np.asarray(label)[order] > 0, w[order]
    start = np.concatenate([[True], s[1:] != s[:-1]])
    gid = np.cumsum(start) - 1
    pos = np.bincount(gid, weights=w * y)
    neg = np.bincount(gid, weights=w * ~y)
    before = np.cumsum(pos) - pos
    sum_pos, sum_neg = pos.sum(), neg.sum()
    if sum_pos <= 0 or sum_neg <= 0:
        return 1.0
    return float(np.sum(neg * (pos * 0.5 + before)) / (sum_pos * sum_neg))


class AUCMetric(Metric):
    """binary_metric.hpp:150-263 (rank-based: raw scores are fine)."""
    names = ["auc"]
    factor_to_bigger_better = 1.0

    def eval(self, score, convert_output=None) -> List[float]:
        return [auc(score, self.label, self.weights)]


_METRICS = {"binary_logloss": BinaryLoglossMetric,
            "binary": BinaryLoglossMetric, "auc": AUCMetric}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    """Factory (metric.cpp:15-59) for the slice's metrics."""
    base = name.split("@")[0].strip().lower()
    if base in ("none", "null", "na", ""):
        return None
    if base not in _METRICS:
        raise outside_slice("metric %s" % name,
                            "the slice has binary_logloss and auc")
    return _METRICS[base](config)
