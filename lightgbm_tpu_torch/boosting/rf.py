"""Random forest mode.

The port of ``lightgbm_tpu/boosting/rf.py`` (rf.hpp of the reference):
bagging is required, every tree is fit with shrinkage 1 to the gradients
of the objective's init score (``boost_from_score``), computed once, so
the trees depend on each other only through their bagging masks; each new
tree takes the init score into its leaves (AddBias, rf.hpp:118-121), the
scores are not boosted from the average, and the training and valid
scores are the running sums of the trees' outputs divided by the
iterations (the model is ``average_output``: ``predict`` divides too).
RF takes the per-iteration key stream and never renews leaves.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..log import LightGBMError, Log
from .gbdt import GBDT


class RF(GBDT):
    """Averaged forest of trees fit to fixed gradients (rf.hpp)."""

    boosting_type = "rf"
    average_output = True

    def __init__(self, config, train_data, objective, metrics=None,
                 device: torch.device = torch.device("cpu"), comm=None):
        if not (config.bagging_freq > 0
                and 0.0 < config.bagging_fraction < 1.0):
            raise LightGBMError("Random forest needs bagging_freq > 0 and "
                                "bagging_fraction in (0, 1)")
        super().__init__(config, train_data, objective, metrics,
                         device, comm)
        self.shrinkage_rate = 1.0
        # the gradients are the objective's at its init score: no renewal
        # (the JAX package renews only on its objective's own gradients)
        self._renew_alpha = None
        self._fixed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._init_scores_rf = np.zeros(self.num_tree_per_iteration,
                                        np.float32)
        # the running sums; ``scores`` and each valid set's hold them
        # divided by the iterations between iterations
        self._score_sum = getattr(self, "scores", None)
        self._valid_sum: Dict[int, torch.Tensor] = {}

    def training_state(self):
        """GBDT's state and RF's running sums, the training set's and each
        valid set's: ``scores`` holds only their averages, and dividing
        back does not give the sums bit for bit."""
        meta, arrays = super().training_state()
        if self._score_sum is not None:
            arrays["rf_score_sum"] = self._host_copy(self._score_sum)
        for vi, total in self._valid_sum.items():
            arrays["rf_valid%d_sum" % vi] = self._host_copy(total)
        return meta, arrays

    def _row_tensors(self):
        return super()._row_tensors() + (
            [("rf_score_sum", self._score_sum, 0)]
            if self._score_sum is not None else [])

    def load_training_state(self, meta, arrays) -> None:
        super().load_training_state(meta, arrays)
        if "rf_score_sum" not in arrays:
            # the JAX package's snapshots carry no sums (its rf.py keeps
            # them outside its training state)
            Log.warning("checkpoint has no random-forest sums; taking the "
                        "averaged scores times the iterations, which may "
                        "differ in the last ulp")
            it = float(max(self.current_iteration, 1))
            self._score_sum = self.scores * it
            self._valid_sum = {vi: cache["scores"] * it
                               for vi, cache in enumerate(self._valid)}
            return
        self._score_sum = self._device_copy(arrays["rf_score_sum"],
                                            np.float32)
        self._valid_sum = {
            vi: self._device_copy(arrays["rf_valid%d_sum" % vi], np.float32)
            for vi in range(len(self._valid))
            if "rf_valid%d_sum" % vi in arrays}

    def _boost_from_average(self) -> None:
        # the init score goes into each tree (AddBias), not the scores
        self.boost_from_average_done = True
        self.init_score_offsets = np.zeros(self.num_tree_per_iteration,
                                           np.float32)

    def _objective_gradients(self):
        """Gradients at the constant init score, computed once (rf.hpp
        Boosting :76-95)."""
        if self._fixed is None:
            k, n = self.num_tree_per_iteration, self.num_data
            if self.config.boost_from_average and self.objective is not None:
                self._init_scores_rf = np.array(
                    [self.objective.boost_from_score(c) for c in range(k)],
                    np.float32)
            base = torch.as_tensor(self._init_scores_rf,
                                   device=self.device).expand(n, k)
            if self.objective is None:
                self._fixed = super()._objective_gradients()
            elif k == 1:
                self._fixed = tuple(
                    a.unsqueeze(0) for a in self.objective.get_gradients(
                        base[:, 0].contiguous()))
            else:
                self._fixed = tuple(
                    a.t().contiguous() for a in
                    self.objective.get_gradients(base.contiguous()))
        return self._fixed

    def _averaged(self, it: float) -> None:
        """Keep the sums and put their averages in the scores."""
        self._score_sum = self.scores
        self.scores = self._score_sum / it
        for vi, cache in enumerate(self._valid):
            self._valid_sum[vi] = cache["scores"]
            cache["scores"] = cache["scores"] / it

    def _train_iteration(self, grad, hess, sample_mask, goss_key) -> bool:
        self.scores = self._score_sum
        for vi, cache in enumerate(self._valid):
            cache["scores"] = self._valid_sum.get(vi, cache["scores"])
        n_before = len(self.models)
        stopped = super()._train_iteration(grad, hess, sample_mask, goss_key)
        if stopped:
            self._averaged(float(max(self.current_iteration, 1)))
            return True
        for c, ht in enumerate(self.models[n_before:]):
            bias = float(self._init_scores_rf[c])
            if abs(bias) > 1e-15:
                # AddBias (rf.hpp:118-121): the tree and its outputs
                ht.leaf_value += bias
                ht.internal_value += bias
                self.scores[:, c] += bias
                for cache in self._valid:
                    cache["scores"][:, c] += bias
        self._averaged(float(self.current_iteration))
        return False
