"""Objective functions: gradients and hessians as tensor expressions.

The port of ``lightgbm_tpu/objectives.py``: the regression family
(regression_objective.hpp of the reference), the binary objective
(binary_objective.hpp:20-190), the two multiclass objectives
(multiclass_objective.hpp: softmax and one-vs-all), the two cross-entropy
objectives (xentropy_objective.hpp) and lambdarank (rank_objective.hpp),
whose pairwise pass runs over chunks of queries bucketed by length
(``LambdarankNDCG``). The per-row arrays live
on the booster's device; ``get_gradients`` is a handful of elementwise ops
in float32, the same arithmetic in the same order as the JAX package: [N]
scores to [N] gradients, or [N, K] to [N, K] for the multiclass
objectives, whose ``num_model_per_iteration`` is K. The host parts stay
numpy as they are there: ``boost_from_score`` reads host copies of the
per-row arrays, and ``convert_output`` maps raw scores on the host.

L1, quantile and MAPE refit their leaf values after growth
(``renew_percentile``; ``core/renew.py``).
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import Config
from .io.dataset import Metadata
from .log import Log, LightGBMError, check


class ObjectiveFunction:
    """Interface mirror of objective_function.h:15-69."""

    name = "custom"
    num_model_per_iteration = 1
    need_accurate_prediction = True

    def __init__(self, config: Config):
        self.config = config
        self.label: Optional[torch.Tensor] = None
        self.weights: Optional[torch.Tensor] = None
        self._label_np: Optional[np.ndarray] = None
        self._weight_np: Optional[np.ndarray] = None

    def init(self, metadata: Metadata, device: torch.device) -> None:
        check(metadata.label is not None,
              "label is required for objective %s" % self.name)
        self._label_np = np.asarray(metadata.label, np.float32)
        self._weight_np = (None if metadata.weight is None
                           else np.asarray(metadata.weight, np.float32))
        self.label = torch.as_tensor(self._label_np, device=device)
        self.weights = (None if self._weight_np is None
                        else torch.as_tensor(self._weight_np, device=device))

    def _apply_weights(self, grad: torch.Tensor, hess: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.weights is not None:
            return grad * self.weights, hess * self.weights
        return grad, hess

    def _wmean(self, values: np.ndarray) -> float:
        return float(np.average(values, weights=self._weight_np))

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def convert_output(self, score):
        return score


def _f32(score) -> np.ndarray:
    """Raw scores as the JAX package's float32 device arrays hold them."""
    return np.asarray(score, np.float32)


# ---------------------------------------------------------------- regression
class RegressionL2Loss(ObjectiveFunction):
    """regression_objective.hpp:60-170 (optionally sqrt-transformed
    labels)."""
    name = "regression"

    def init(self, metadata, device):
        super().init(metadata, device)
        if self.config.reg_sqrt:
            lab = np.asarray(metadata.label, np.float64)
            self._trans_label_np = (np.sign(lab) * np.sqrt(np.abs(lab))
                                    ).astype(np.float32)
            self.trans_label = torch.as_tensor(self._trans_label_np,
                                               device=device)
        else:
            self._trans_label_np = self._label_np
            self.trans_label = self.label

    def get_gradients(self, score):
        grad = score - self.trans_label
        hess = torch.ones_like(score)
        return self._apply_weights(grad, hess)

    def boost_from_score(self, class_id=0):
        return self._wmean(self._trans_label_np)

    def convert_output(self, score):
        if self.config.reg_sqrt:
            s = _f32(score)
            return np.sign(s) * s * s
        return score


class RegressionL1Loss(RegressionL2Loss):
    """regression_objective.hpp:173-260; leaf values renewed to the weighted
    median of the residuals (RenewTreeOutput)."""
    name = "regression_l1"

    def get_gradients(self, score):
        grad = torch.sign(score - self.trans_label)
        hess = torch.ones_like(score)
        return self._apply_weights(grad, hess)

    def boost_from_score(self, class_id=0):
        lab = self._trans_label_np
        if self._weight_np is not None:
            return _weighted_percentile(lab, self._weight_np, 0.5)
        return (float(np.percentile(lab, 50, method="lower"))
                if len(lab) else 0.0)

    def renew_percentile(self) -> float:
        return 0.5


class RegressionHuberLoss(RegressionL2Loss):
    """regression_objective.hpp:263-350."""
    name = "huber"

    def get_gradients(self, score):
        diff = score - self.trans_label
        alpha = self.config.alpha
        grad = torch.where(torch.abs(diff) <= alpha, diff,
                           torch.sign(diff) * alpha)
        hess = torch.ones_like(score)
        return self._apply_weights(grad, hess)


class RegressionFairLoss(RegressionL2Loss):
    """regression_objective.hpp:353-420."""
    name = "fair"

    def get_gradients(self, score):
        c = self.config.fair_c
        x = score - self.trans_label
        grad = c * x / (torch.abs(x) + c)
        hess = c * c / ((torch.abs(x) + c) ** 2)
        return self._apply_weights(grad, hess)

    def boost_from_score(self, class_id=0):
        return 0.0


class RegressionPoissonLoss(ObjectiveFunction):
    """regression_objective.hpp:423-490: log-link Poisson."""
    name = "poisson"

    def init(self, metadata, device):
        super().init(metadata, device)
        if float(np.min(self._label_np)) < 0:
            raise LightGBMError("[%s]: at least one target label is "
                                "negative" % self.name)

    def get_gradients(self, score):
        grad = torch.exp(score) - self.label
        hess = torch.exp(score + self.config.poisson_max_delta_step)
        return self._apply_weights(grad, hess)

    def boost_from_score(self, class_id=0):
        return math.log(max(self._wmean(self._label_np), 1e-20))

    def convert_output(self, score):
        return np.exp(_f32(score))


class RegressionQuantileLoss(RegressionL2Loss):
    """regression_objective.hpp:493-560."""
    name = "quantile"

    def get_gradients(self, score):
        alpha = self.config.alpha
        delta = score - self.trans_label
        grad = torch.where(delta >= 0, 1.0 - alpha, -alpha)
        hess = torch.ones_like(score)
        return self._apply_weights(grad, hess)

    def boost_from_score(self, class_id=0):
        lab = self._trans_label_np
        if self._weight_np is not None:
            return _weighted_percentile(lab, self._weight_np,
                                        self.config.alpha)
        return float(np.percentile(lab, self.config.alpha * 100,
                                   method="lower"))

    def renew_percentile(self) -> float:
        return self.config.alpha


class RegressionMAPELoss(ObjectiveFunction):
    """regression_objective.hpp:600-680: |1 - score/label| through label
    weights."""
    name = "mape"

    def init(self, metadata, device):
        super().init(metadata, device)
        lab = np.asarray(self._label_np, np.float64)
        w = (self._weight_np if self._weight_np is not None
             else np.ones_like(lab))
        self._label_weight_np = (w / np.maximum(1.0, np.abs(lab))
                                 ).astype(np.float32)
        self.label_weight = torch.as_tensor(self._label_weight_np,
                                            device=device)

    def get_gradients(self, score):
        grad = torch.sign(score - self.label) * self.label_weight
        hess = (torch.ones_like(score) if self.weights is None
                else self.weights)
        return grad, hess

    def boost_from_score(self, class_id=0):
        return _weighted_percentile(self._label_np, self._label_weight_np,
                                    0.5)

    def renew_percentile(self) -> float:
        return 0.5


class RegressionGammaLoss(RegressionPoissonLoss):
    """regression_objective.hpp:740-770."""
    name = "gamma"

    def get_gradients(self, score):
        exp_s = torch.exp(score)
        grad = 1.0 - self.label / exp_s
        hess = self.label / exp_s
        return self._apply_weights(grad, hess)


class RegressionTweedieLoss(RegressionPoissonLoss):
    """regression_objective.hpp:773-814."""
    name = "tweedie"

    def get_gradients(self, score):
        rho = self.config.tweedie_variance_power
        exp_1 = torch.exp((1 - rho) * score)
        exp_2 = torch.exp((2 - rho) * score)
        grad = -self.label * exp_1 + exp_2
        hess = -self.label * (1 - rho) * exp_1 + (2 - rho) * exp_2
        return self._apply_weights(grad, hess)


# -------------------------------------------------------------------- binary
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


# ---------------------------------------------------------------- multiclass
def _class_onehot(label: np.ndarray, num_class: int,
                  device: torch.device) -> torch.Tensor:
    """[N, K] float32 one-hot of the integer-truncated labels; a label
    outside [0, K) has no hot class (jax.nn.one_hot)."""
    lab = torch.as_tensor(label.astype(np.int32), device=device)
    return (lab[:, None] == torch.arange(num_class, dtype=torch.int32,
                                         device=device)).to(torch.float32)


class MulticlassSoftmax(ObjectiveFunction):
    """multiclass_objective.hpp:20-160: K trees an iteration, softmax."""
    need_accurate_prediction = False
    name = "multiclass"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = config.num_class
        self.num_model_per_iteration = config.num_class

    def init(self, metadata, device):
        super().init(metadata, device)
        lab = self._label_np.astype(np.int32)
        if lab.min() < 0 or lab.max() >= self.num_class:
            raise LightGBMError(
                "[multiclass]: label must be in [0, %d)" % self.num_class)
        self.onehot = _class_onehot(self._label_np, self.num_class, device)

    def get_gradients(self, score):
        """[N, K] scores -> [N, K] gradients and hessians."""
        p = torch.softmax(score, dim=-1)
        grad = p - self.onehot
        hess = 2.0 * p * (1.0 - p)
        if self.weights is not None:
            return grad * self.weights[:, None], hess * self.weights[:, None]
        return grad, hess

    def boost_from_score(self, class_id=0):
        return 0.0

    def convert_output(self, score):
        """Class probabilities from [N, K] raw scores (float32, on the
        host)."""
        s = _f32(score)
        e = np.exp(s - s.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)


class MulticlassOVA(ObjectiveFunction):
    """multiclass_objective.hpp:170-259: K independent binary objectives,
    one a class, each of which seeds its class's scores
    (``boost_from_score(class_id)``)."""
    need_accurate_prediction = False
    name = "multiclassova"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = config.num_class
        self.num_model_per_iteration = config.num_class

    def init(self, metadata, device):
        super().init(metadata, device)
        onehot = _class_onehot(self._label_np, self.num_class, device)
        self.y_signed = 2 * onehot - 1
        lab = self._label_np.astype(np.int32)
        # host-only: a class's binary objective serves boost_from_score
        self._binary_inits = []
        for k in range(self.num_class):
            m = Metadata(len(lab))
            m.set_label((lab == k).astype(np.float32))
            m.set_weight(self._weight_np)
            b = BinaryLogloss(self.config)
            b.init(m, torch.device("cpu"))
            self._binary_inits.append(b)

    def get_gradients(self, score):
        """[N, K] scores -> [N, K] gradients and hessians."""
        sig = self.config.sigmoid
        response = -self.y_signed * sig / (
            1.0 + torch.exp(self.y_signed * sig * score))
        abs_r = torch.abs(response)
        grad, hess = response, abs_r * (sig - abs_r)
        if self.weights is not None:
            return grad * self.weights[:, None], hess * self.weights[:, None]
        return grad, hess

    def boost_from_score(self, class_id=0):
        return self._binary_inits[class_id].boost_from_score(0)

    def convert_output(self, score):
        """Each class's own sigmoid of [N, K] raw scores (float32, on the
        host)."""
        return 1.0 / (1.0 + np.exp(-self.config.sigmoid * _f32(score)))


# ------------------------------------------------------------------ xentropy
class CrossEntropy(ObjectiveFunction):
    """xentropy_objective.hpp:30-130: labels in [0, 1], the sigmoid link."""
    name = "xentropy"

    def init(self, metadata, device):
        super().init(metadata, device)
        if self._label_np.min() < 0 or self._label_np.max() > 1:
            raise LightGBMError("[%s]: label must be in [0, 1]" % self.name)

    def get_gradients(self, score):
        p = 1.0 / (1.0 + torch.exp(-score))
        if self.weights is None:
            return p - self.label, p * (1.0 - p)
        return ((p - self.label) * self.weights,
                p * (1.0 - p) * self.weights)

    def boost_from_score(self, class_id=0):
        pavg = min(max(self._wmean(self._label_np), 1e-15), 1 - 1e-15)
        return math.log(pavg / (1 - pavg))

    def convert_output(self, score):
        """Probabilities (float32, on the host)."""
        return 1.0 / (1.0 + np.exp(-_f32(score)))


class CrossEntropyLambda(CrossEntropy):
    """xentropy_objective.hpp:140-250: the weighted cross-entropy with the
    log1p(exp) link."""
    name = "xentlambda"

    def get_gradients(self, score):
        w = self.weights if self.weights is not None \
            else torch.ones_like(score)
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = torch.exp(-score)
        grad = (1.0 - self.label / z) * w / (1.0 + enf)
        c = 1.0 / (1.0 - z)
        d = 1.0 + epf
        a = w * epf / (z * d)
        b = (d - 1.0) / d
        hess = self.label * a * (c * b * w - (a - b)) + (
            1.0 - self.label) * w * b / d * (1.0 + w * epf / d)
        # the JAX package's guards against blow-ups of the float32 math
        hess = torch.where(torch.isfinite(hess) & (hess > 0), hess, 1e-6)
        grad = torch.where(torch.isfinite(grad), grad, 0.0)
        return grad, hess

    def boost_from_score(self, class_id=0):
        pavg = min(max(self._wmean(self._label_np), 1e-15), 1 - 1e-15)
        return math.log(math.expm1(pavg)) if pavg > 0 else -50.0

    def convert_output(self, score):
        """log1p(exp(score)) (float32, on the host)."""
        return np.log1p(np.exp(_f32(score)))


# -------------------------------------------------------------------- ranking
def default_label_gain(max_label: int = 31) -> np.ndarray:
    """2^i - 1 (dcg_calculator.cpp:30-38)."""
    return np.array([0.0] + [float((1 << i) - 1) for i in range(1, max_label)])


# the most bytes one [queries, M, M] float32 array of lambdarank's pairwise
# pass may take; the pass holds at most PAIR_PEAK_ARRAYS such arrays (or
# their bool masks) at once
PAIR_BYTES_CAP = 64 << 20
PAIR_PEAK_ARRAYS = 8


class QueryChunk(NamedTuple):
    """Queries of similar length padded to the longest of them: ``rows``
    [c, M] their docs' rows (0 in padding), ``mask`` [c, M] the real docs,
    ``label`` [c, M] int32 labels and ``gain`` [c, M] label gains (0 in
    padding), ``inv_max_dcg`` [c], and ``flat`` / ``dest``: where the real
    docs sit in the flattened [c * M] results and the rows they go to."""
    rows: torch.Tensor
    mask: torch.Tensor
    label: torch.Tensor
    gain: torch.Tensor
    inv_max_dcg: torch.Tensor
    flat: torch.Tensor
    dest: torch.Tensor


def query_chunks(sizes: np.ndarray, cap_bytes: int = PAIR_BYTES_CAP
                 ) -> List[np.ndarray]:
    """The queries bucketed by length: their indices in order of size, cut
    into runs whose [run, M, M] float32 array (M the run's longest query)
    stays within ``cap_bytes``; a query longer than the cap allows is a
    run of its own."""
    order = np.argsort(sizes, kind="stable")
    runs, start = [], 0
    for i in range(1, len(order) + 1):
        if i == len(order) or (i - start + 1) * 4 * int(
                sizes[order[i]]) ** 2 > cap_bytes:
            runs.append(order[start:i])
            start = i
    return runs


class LambdarankNDCG(ObjectiveFunction):
    """rank_objective.hpp:19-240 with the JAX package's formulas
    (objectives.py:498-589 there): per query, docs ranked by score (a
    stable sort, so that tied docs keep their order: every score ties at
    the first iteration, and a leaf's docs tie after each tree), position
    discounts 1/log2(2 + rank), and pairwise |ΔNDCG|-weighted sigmoid
    lambdas regularised by /(0.01 + |Δscore|) where the query's scores
    differ; the weights apply last.

    The JAX package pads every query to the longest one and computes
    [Q, M, M] pairs at once; at MSLR-WEB30K's shape (31,531 queries, up to
    1,251 docs) one such array would take ~197 GB. Here the queries are
    bucketed by length (``query_chunks``): each chunk pads to its own
    longest query, keeps one [chunk, M, M] float32 array within
    ``pair_bytes_cap`` and at most PAIR_PEAK_ARRAYS of them alive, and
    its results go back to their rows of the [N] gradients and hessians.
    Per query the arithmetic, its order and its float32 constants (the
    discounts and inverse max DCGs computed in float64, cast once) are the
    JAX package's."""
    name = "lambdarank"

    def __init__(self, config, pair_bytes_cap: int = PAIR_BYTES_CAP):
        super().__init__(config)
        self.pair_bytes_cap = pair_bytes_cap

    def init(self, metadata, device):
        super().init(metadata, device)
        if metadata.query_boundaries is None:
            raise LightGBMError("Lambdarank tasks require query information")
        qb = np.asarray(metadata.query_boundaries, np.int64)
        sizes = np.diff(qb)
        gains = self.config.label_gain
        lg = (np.asarray(gains, np.float64) if gains
              else default_label_gain())
        lab = self._label_np.astype(np.int32)
        check(lab.max() < len(lg), "label excels label_gain size")
        # inverse max DCG at k a query (rank_objective.hpp:55-65)
        k = self.config.max_position
        disc = 1.0 / np.log2(2.0 + np.arange(int(sizes.max())))
        inv = np.zeros(len(sizes), np.float64)
        for i in range(len(sizes)):
            ql = np.sort(lab[qb[i]:qb[i + 1]])[::-1][:k]
            mx = float(np.sum(lg[ql] * disc[:len(ql)]))
            inv[i] = 1.0 / mx if mx > 0 else 0.0
        self.discount = torch.as_tensor(disc.astype(np.float32),
                                        device=device)
        gain_rows = lg.astype(np.float32)[lab]

        def dev(a):
            return torch.as_tensor(a, device=device)
        self.chunks = []
        for run in query_chunks(sizes, self.pair_bytes_cap):
            pos = np.arange(int(sizes[run].max()))
            mask = pos[None, :] < sizes[run][:, None]
            rows = np.where(mask, qb[run][:, None] + pos[None, :], 0)
            self.chunks.append(QueryChunk(
                rows=dev(rows), mask=dev(mask),
                label=dev(np.where(mask, lab[rows], 0).astype(np.int32)),
                gain=dev(np.where(mask, gain_rows[rows], 0)
                         .astype(np.float32)),
                inv_max_dcg=dev(inv[run].astype(np.float32)),
                flat=dev(np.flatnonzero(mask)), dest=dev(rows[mask])))

    def _chunk_gradients(self, score: torch.Tensor, ch: QueryChunk
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[c, M] gradients and hessians of one chunk's queries, 0 in
        padding."""
        sig = self.config.sigmoid
        s = torch.where(ch.mask, score[ch.rows], -1e30)
        m = s.shape[1]
        # rank of each doc (0 = best): a stable sort by -score, padding last
        order = torch.argsort(-s, dim=1, stable=True)
        rank_of = torch.empty_like(order).scatter_(
            1, order, torch.arange(m, device=s.device).expand_as(order))
        disc = self.discount[rank_of] * ch.mask.to(torch.float32)
        best = s.max(dim=1).values
        worst = torch.where(ch.mask, s, 1e30).min(dim=1).values
        norm = (best != worst)[:, None, None]
        ds = s[:, :, None] - s[:, None, :]
        delta = ((ch.gain[:, :, None] - ch.gain[:, None, :])
                 * torch.abs(disc[:, :, None] - disc[:, None, :])
                 * ch.inv_max_dcg[:, None, None])
        delta = torch.where(norm, delta / (0.01 + torch.abs(ds)), delta)
        p_lambda = 2.0 / (1.0 + torch.exp(2.0 * sig * ds))
        del ds
        # pairs (i, j) with label_i > label_j, both docs real
        hi = ((ch.label[:, :, None] > ch.label[:, None, :])
              & ch.mask[:, :, None] & ch.mask[:, None, :])
        lam = torch.where(hi, -p_lambda * delta, 0.0)
        hes = torch.where(hi, 2.0 * (p_lambda * (2.0 - p_lambda)) * delta,
                          0.0)
        return (lam.sum(dim=2) - lam.sum(dim=1),
                hes.sum(dim=2) + hes.sum(dim=1))

    def get_gradients(self, score):
        grad = torch.zeros_like(score)
        hess = torch.zeros_like(score)
        for ch in self.chunks:
            g, h = self._chunk_gradients(score, ch)
            grad[ch.dest] = g.reshape(-1)[ch.flat]
            hess[ch.dest] = h.reshape(-1)[ch.flat]
        return self._apply_weights(grad, hess)


# ------------------------------------------------------------------- factory
_OBJECTIVES = {
    "regression": RegressionL2Loss,
    "regression_l1": RegressionL1Loss,
    "huber": RegressionHuberLoss,
    "fair": RegressionFairLoss,
    "poisson": RegressionPoissonLoss,
    "quantile": RegressionQuantileLoss,
    "mape": RegressionMAPELoss,
    "gamma": RegressionGammaLoss,
    "tweedie": RegressionTweedieLoss,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "xentropy": CrossEntropy,
    "xentlambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG,
}


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """Factory (objective_function.cpp:11-42) for the regression family,
    binary and multiclass; None for ``objective="none"`` (a custom
    objective's gradients come from ``fobj``)."""
    name = config.objective
    if name in ("none", "", None):
        return None
    if name not in _OBJECTIVES:
        raise LightGBMError("Unknown objective type name: %s" % name)
    return _OBJECTIVES[name](config)


def _weighted_percentile(values: np.ndarray, weights: np.ndarray,
                         alpha: float) -> float:
    """PercentileFun/WeightedPercentileFun analog
    (regression_objective.hpp:20-55): the first sorted value whose
    cumulative weight reaches ``alpha`` of the total."""
    if len(values) == 0:
        return 0.0
    order = np.argsort(values)
    v, w = values[order], weights[order]
    cum = np.cumsum(w)
    target = alpha * cum[-1]
    idx = int(np.searchsorted(cum, target, side="left"))
    return float(v[min(idx, len(v) - 1)])
