"""Evaluation metrics on the host.

The port's own copy of ``lightgbm_tpu/metrics.py`` (regression_metric.hpp,
binary_metric.hpp, multiclass_metric.hpp, xentropy_metric.hpp,
rank_metric.hpp and map_metric.hpp of the reference, and the fork's
topavg_metric.hpp and topavgdiff_metric.hpp): the regression family,
``binary_logloss``, ``binary_error``, ``auc``, ``multi_logloss``,
``multi_error``, ``xentropy``, ``xentlambda``, ``kldiv``, and the query
metrics ``ndcg``, ``map``, ``topavg`` and ``topavgdiff`` at each of
``eval_at`` (or the ``k`` of a ``name@k:k`` metric). Metrics run in NumPy
in float64 on scores pulled from the device once per evaluation, off the
training hot path; a multiclass metric takes [N, K] scores, a query
metric the query boundaries and query weights of the data set it
evaluates.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from .config import Config
from .io.dataset import Metadata
from .log import LightGBMError, check
from .objectives import default_label_gain


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


class _PointwiseMetric(Metric):
    """regression_metric.hpp RegressionMetric<PointWiseLossCalculator>: the
    (weighted) mean of a per-row loss of the converted scores."""
    metric_name = ""
    bigger_better = False

    def __init__(self, config):
        super().__init__(config)
        self.names = [self.metric_name]
        self.factor_to_bigger_better = 1.0 if self.bigger_better else -1.0

    def point_loss(self, label: np.ndarray, score: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform(self, avg: float) -> float:
        return avg

    def eval(self, score, convert_output=None) -> List[float]:
        score = np.asarray(score, np.float64).reshape(-1)
        if convert_output is not None:
            score = np.asarray(convert_output(score))
        losses = self.point_loss(self.label.astype(np.float64), score)
        if self.weights is not None:
            avg = float(np.sum(losses * self.weights) / self.sum_weights)
        else:
            avg = float(np.mean(losses))
        return [self.transform(avg)]


class L2Metric(_PointwiseMetric):
    metric_name = "l2"

    def point_loss(self, y, s):
        return (s - y) ** 2


class RMSEMetric(_PointwiseMetric):
    metric_name = "rmse"

    def point_loss(self, y, s):
        return (s - y) ** 2

    def transform(self, avg):
        return math.sqrt(avg)


class L1Metric(_PointwiseMetric):
    metric_name = "l1"

    def point_loss(self, y, s):
        return np.abs(s - y)


class QuantileMetric(_PointwiseMetric):
    metric_name = "quantile"

    def point_loss(self, y, s):
        a = self.config.alpha
        d = y - s
        return np.where(d >= 0, a * d, (a - 1.0) * d)


class HuberMetric(_PointwiseMetric):
    metric_name = "huber"

    def point_loss(self, y, s):
        a = self.config.alpha
        d = np.abs(s - y)
        return np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))


class FairMetric(_PointwiseMetric):
    metric_name = "fair"

    def point_loss(self, y, s):
        c = self.config.fair_c
        x = np.abs(s - y)
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_PointwiseMetric):
    metric_name = "poisson"

    def point_loss(self, y, s):
        s = np.maximum(s, 1e-10)
        return s - y * np.log(s)


class MAPEMetric(_PointwiseMetric):
    metric_name = "mape"

    def point_loss(self, y, s):
        return np.abs(y - s) / np.maximum(1.0, np.abs(y))


class GammaMetric(_PointwiseMetric):
    metric_name = "gamma"

    def point_loss(self, y, s):
        # negative gamma log-likelihood with psi=1 (regression_metric.hpp)
        s = np.maximum(s, 1e-10)
        return y / s + np.log(s)


class GammaDevianceMetric(_PointwiseMetric):
    metric_name = "gamma_deviance"

    def point_loss(self, y, s):
        frac = y / np.maximum(s, 1e-10)
        return 2.0 * (-np.log(frac) + frac - 1.0)


class TweedieMetric(_PointwiseMetric):
    metric_name = "tweedie"

    def point_loss(self, y, s):
        rho = self.config.tweedie_variance_power
        s = np.maximum(s, 1e-10)
        a = y * np.power(s, 1.0 - rho) / (1.0 - rho)
        b = np.power(s, 2.0 - rho) / (2.0 - rho)
        return -a + b


class BinaryLoglossMetric(_PointwiseMetric):
    """binary_metric.hpp BinaryLoglossMetric (probabilities via the
    objective's ConvertOutput)."""
    metric_name = "binary_logloss"

    def point_loss(self, y, p):
        p = np.clip(p, 1e-15, 1 - 1e-15)
        return -(y * np.log(p) + (1 - y) * np.log(1 - p))


class BinaryErrorMetric(_PointwiseMetric):
    """binary_metric.hpp BinaryErrorMetric."""
    metric_name = "binary_error"

    def point_loss(self, y, p):
        return np.where(p > 0.5, 1.0 - y, y).astype(np.float64)


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


class MultiLoglossMetric(Metric):
    """multiclass_metric.hpp multi_logloss: the (weighted) mean of -log of
    the true class's converted score, clipped at 1e-15."""

    def __init__(self, config):
        super().__init__(config)
        self.names = ["multi_logloss"]
        self.factor_to_bigger_better = -1.0
        self.num_class = config.num_class

    def eval(self, score, convert_output=None) -> List[float]:
        p = np.asarray(score, np.float64).reshape(-1, self.num_class)
        if convert_output is not None:
            p = np.asarray(convert_output(p))
        idx = self.label.astype(np.int64)
        pt = np.clip(p[np.arange(len(idx)), idx], 1e-15, None)
        losses = -np.log(pt)
        if self.weights is not None:
            return [float(np.sum(losses * self.weights) / self.sum_weights)]
        return [float(np.mean(losses))]


class MultiErrorMetric(Metric):
    """multiclass_metric.hpp multi_error: the (weighted) share of rows
    whose highest raw score is not their class (the first highest on a
    tie)."""

    def __init__(self, config):
        super().__init__(config)
        self.names = ["multi_error"]
        self.factor_to_bigger_better = -1.0
        self.num_class = config.num_class

    def eval(self, score, convert_output=None) -> List[float]:
        p = np.asarray(score, np.float64).reshape(-1, self.num_class)
        pred = np.argmax(p, axis=1)
        err = (pred != self.label.astype(np.int64)).astype(np.float64)
        if self.weights is not None:
            return [float(np.sum(err * self.weights) / self.sum_weights)]
        return [float(np.mean(err))]


# ----------------------------------------------------------------- xentropy
class CrossEntropyMetric(_PointwiseMetric):
    """xentropy_metric.hpp: the cross-entropy of probabilities."""
    metric_name = "xentropy"

    def point_loss(self, y, p):
        p = np.clip(p, 1e-15, 1 - 1e-15)
        return -(y * np.log(p) + (1 - y) * np.log(1 - p))


class CrossEntropyLambdaMetric(_PointwiseMetric):
    """xentropy_metric.hpp xentlambda: the cross-entropy of
    1 - exp(-hhat), hhat = log1p(exp(score)) from ConvertOutput."""
    metric_name = "xentlambda"

    def point_loss(self, y, hhat):
        hhat = np.maximum(hhat, 1e-15)
        z = 1.0 - np.exp(-hhat)
        z = np.clip(z, 1e-15, 1 - 1e-15)
        return -(y * np.log(z) + (1 - y) * np.log(1 - z))


class KLDivMetric(_PointwiseMetric):
    """xentropy_metric.hpp kldiv: the Kullback-Leibler divergence of the
    labels from the probabilities."""
    metric_name = "kldiv"

    def point_loss(self, y, p):
        p = np.clip(p, 1e-15, 1 - 1e-15)
        yc = np.clip(y, 1e-15, 1 - 1e-15)
        return (yc * np.log(yc / p) + (1 - yc) * np.log((1 - yc) / (1 - p)))


# ------------------------------------------------------------------ ranking
class _QueryMetric(Metric):
    """A metric a query at each k of ``eval_at``, averaged over the
    queries with their query weights (rank_metric.hpp, map_metric.hpp)."""

    def __init__(self, config):
        super().__init__(config)
        self.eval_at = [int(k) for k in (config.eval_at or [1, 2, 3, 4, 5])]
        self.factor_to_bigger_better = 1.0

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        check(metadata.query_boundaries is not None,
              "query information required for ranking metric")
        self.qb = np.asarray(metadata.query_boundaries, np.int64)
        self.num_queries = len(self.qb) - 1
        # a query's weight is the mean of its docs' weights (metadata.cpp
        # LoadQueryWeights), as rank_metric.hpp accumulates them
        qw = metadata.query_weights
        self.query_weights = (None if qw is None
                              else np.asarray(qw, np.float64))
        self.sum_query_weights = (float(self.num_queries)
                                  if self.query_weights is None
                                  else float(self.query_weights.sum()))

    def per_query(self, y: np.ndarray, s: np.ndarray) -> List[float]:
        raise NotImplementedError

    def eval(self, score, convert_output=None) -> List[float]:
        score = np.asarray(score, np.float64).reshape(-1)
        totals = np.zeros(len(self.eval_at))
        for q in range(self.num_queries):
            lo, hi = self.qb[q], self.qb[q + 1]
            pq = np.asarray(self.per_query(self.label[lo:hi], score[lo:hi]))
            totals += pq if self.query_weights is None \
                else self.query_weights[q] * pq
        return list(totals / self.sum_query_weights)


class NDCGMetric(_QueryMetric):
    """rank_metric.hpp NDCG@k with the label gains; a query whose labels
    are all 0 counts as perfect."""

    def __init__(self, config):
        super().__init__(config)
        self.names = ["ndcg@%d" % k for k in self.eval_at]
        gains = config.label_gain
        self.label_gain = (np.asarray(gains, np.float64) if gains
                           else default_label_gain())

    def per_query(self, y, s):
        n = len(y)
        disc = 1.0 / np.log2(2.0 + np.arange(n))
        yi = y.astype(np.int64)
        order = np.argsort(-s, kind="stable")
        out = []
        for k in self.eval_at:
            kk = min(k, n)
            ideal = np.sort(self.label_gain[yi])[::-1]
            max_dcg = float(np.sum(ideal[:kk] * disc[:kk]))
            if max_dcg <= 0:
                out.append(1.0)
            else:
                dcg = float(np.sum(self.label_gain[yi[order[:kk]]]
                                   * disc[:kk]))
                out.append(dcg / max_dcg)
        return out


class MAPMetric(_QueryMetric):
    """map_metric.hpp MAP@k (a doc is relevant when its label is above
    0)."""

    def __init__(self, config):
        super().__init__(config)
        self.names = ["map@%d" % k for k in self.eval_at]

    def per_query(self, y, s):
        order = np.argsort(-s, kind="stable")
        rel = (y[order] > 0).astype(np.float64)
        cum = np.cumsum(rel)
        prec = cum / (1.0 + np.arange(len(rel)))
        out = []
        for k in self.eval_at:
            kk = min(k, len(rel))
            npos = rel[:kk].sum()
            out.append(float(np.sum(prec[:kk] * rel[:kk]) / npos)
                       if npos > 0 else 0.0)
        return out


class TopavgMetric(_QueryMetric):
    """The fork's topavg (topavg_metric.hpp:65-92): the mean label of the
    |k| lowest-scored docs of a query (a negative k takes the
    highest-scored); the running sum carries across ``eval_at`` in order,
    as the reference's ``cur_left`` walk does."""

    def __init__(self, config):
        super().__init__(config)
        self.names = ["topavg@%d" % k for k in self.eval_at]

    def per_query(self, y, s):
        n = len(y)
        sorted_idx = np.argsort(s, kind="stable")      # ascending
        out = []
        sum_label = 0.0
        cur_left = 0
        for k in self.eval_at:
            is_reverse = k < 0
            a = abs(k)
            cur_k = min(a, n)
            for j in range(cur_left, cur_k):
                rank_idx = n - j - 1 if is_reverse else j
                sum_label += float(y[sorted_idx[rank_idx]])
            out.append(sum_label / a)
            cur_left = cur_k
        return out


class TopavgdiffMetric(_QueryMetric):
    """The fork's topavgdiff (topavgdiff_metric.hpp:64-88): the mean over
    the top k positions of (the label there - the label as far from the
    bottom), scores sorted descending."""

    def __init__(self, config):
        super().__init__(config)
        self.names = ["topavgdiff@%d" % k for k in self.eval_at]

    def per_query(self, y, s):
        n = len(y)
        sorted_idx = np.argsort(-s, kind="stable")     # descending
        out = []
        sum_label = 0.0
        cur_left = 0
        for k in self.eval_at:
            cur_k = min(int(k), n)
            for j in range(cur_left, cur_k):
                sum_label += float(y[sorted_idx[j]] - y[sorted_idx[n - j - 1]])
            out.append(sum_label / (cur_k * 2) if cur_k else 0.0)
            cur_left = cur_k
        return out


_METRIC_ALIASES = {
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1",
    "regression_l1": "l1",
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2", "regression": "l2",
    "l2_root": "rmse", "root_mean_squared_error": "rmse", "rmse": "rmse",
    "quantile": "quantile", "huber": "huber", "fair": "fair",
    "poisson": "poisson", "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "gamma_deviance": "gamma_deviance", "tweedie": "tweedie",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "auc": "auc",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multi_error": "multi_error",
    "xentropy": "xentropy", "cross_entropy": "xentropy",
    "xentlambda": "xentlambda", "cross_entropy_lambda": "xentlambda",
    "kldiv": "kldiv", "kullback_leibler": "kldiv",
    "ndcg": "ndcg", "lambdarank": "ndcg",
    "map": "map", "mean_average_precision": "map",
    "topavg": "topavg", "topavgdiff": "topavgdiff",
}

_METRICS = {
    "l1": L1Metric, "l2": L2Metric, "rmse": RMSEMetric,
    "quantile": QuantileMetric, "huber": HuberMetric, "fair": FairMetric,
    "poisson": PoissonMetric, "mape": MAPEMetric, "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric, "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "multi_logloss": MultiLoglossMetric, "multi_error": MultiErrorMetric,
    "xentropy": CrossEntropyMetric, "xentlambda": CrossEntropyLambdaMetric,
    "kldiv": KLDivMetric,
    "ndcg": NDCGMetric, "map": MAPMetric,
    "topavg": TopavgMetric, "topavgdiff": TopavgdiffMetric,
}


def default_metric_for_objective(objective: str) -> Optional[str]:
    """metric.cpp: an empty metric list means the objective's own metric."""
    mapping = {
        "regression": "l2", "regression_l1": "l1", "huber": "huber",
        "fair": "fair", "poisson": "poisson", "quantile": "quantile",
        "mape": "mape", "gamma": "gamma", "tweedie": "tweedie",
        "binary": "binary_logloss", "multiclass": "multi_logloss",
        "multiclassova": "multi_logloss", "xentropy": "xentropy",
        "xentlambda": "xentlambda", "lambdarank": "ndcg",
    }
    return mapping.get(objective)


def create_metric(name: str, config: Config) -> Optional[Metric]:
    """Factory (metric.cpp:15-59); None for 'none'. ``name@k:k`` evaluates
    at those k in place of ``eval_at`` (metrics.py:477-481 of the JAX
    package)."""
    base = name.split("@")[0].strip().lower()
    if base in ("none", "null", "custom", "na", ""):
        return None
    canon = _METRIC_ALIASES.get(base)
    if canon is None:
        raise LightGBMError("Unknown metric type name: %s" % name)
    cfg = config
    if "@" in name:
        cfg = config.copy()
        cfg.eval_at = [int(v) for v in name.split("@")[1].split(":")]
    return _METRICS[canon](cfg)
