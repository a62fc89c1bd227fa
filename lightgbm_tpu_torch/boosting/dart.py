"""DART boosting (Dropouts meet Multiple Additive Regression Trees).

The port of ``lightgbm_tpu/boosting/dart.py`` (dart.hpp:40-205 of the
reference). Each iteration draws its drop set from
``np.random.RandomState(drop_seed)`` as the JAX package does: none with
probability ``skip_drop``, else each earlier iteration with probability
``drop_rate`` (weighted by its trees' weights unless ``uniform_drop``),
at most ``max_drop`` of them. The dropped iterations' trees are replayed
on the binned training and valid matrices and their outputs taken out of
the scores; the new trees are shrunk by ``lr / (1 + k)`` (``lr / (lr +
k)`` in ``xgboost_dart_mode``) for k dropped; then each dropped tree is
shrunk by ``k / (k + 1)`` (``k / (lr + k)``) and its shrunk output put back
(Normalize, dart.hpp:141-186). Tree 0 carries the init score folded into
it, so a drop of it takes the init score out of the scores and the
normalisation scales it, as in the JAX package; the scores stay the
model's predictions. DART takes the per-iteration key stream.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..log import LightGBMError
from .gbdt import GBDT


class DART(GBDT):
    """GBDT with dropped trees (dart.hpp)."""

    boosting_type = "dart"

    def __init__(self, config, train_data, objective, metrics=None,
                 device: torch.device = torch.device("cpu")):
        super().__init__(config, train_data, objective, metrics, device)
        self._drop_rng = np.random.RandomState(config.drop_seed)
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0

    def training_state(self):
        """GBDT's state and DART's own: the drop RandomState and the tree
        weights (dart.py:36-57 of the JAX package; JSON keeps each float's
        shortest repr, so the weights come back bit for bit)."""
        from ..checkpoint import snapshot as snap_mod
        meta, arrays = super().training_state()
        drop_meta, arrays["dart_rng_keys"] = snap_mod.rng_state_split(
            self._drop_rng)
        meta["dart"] = {"rng": drop_meta,
                        "tree_weight": [float(w) for w in self.tree_weight],
                        "sum_weight": float(self.sum_weight)}
        return meta, arrays

    def load_training_state(self, meta, arrays) -> None:
        from ..checkpoint import snapshot as snap_mod
        super().load_training_state(meta, arrays)
        d = meta.get("dart")
        if d is not None and "dart_rng_keys" in arrays:
            self._drop_rng.set_state(
                snap_mod.rng_state_join(d["rng"], arrays["dart_rng_keys"]))
            self.tree_weight = [float(w) for w in d["tree_weight"]]
            self.sum_weight = float(d["sum_weight"])

    def _dropping_trees(self) -> List[int]:
        """The iterations to drop (dart.hpp DroppingTrees:88-139, the JAX
        package's draws)."""
        cfg = self.config
        drop_index: List[int] = []
        if self._drop_rng.rand() < cfg.skip_drop:
            return drop_index
        drop_rate = cfg.drop_rate
        n_iter = self.iter_
        if not cfg.uniform_drop and self.sum_weight > 0:
            inv_avg = len(self.tree_weight) / self.sum_weight
            if cfg.max_drop > 0:
                drop_rate = min(drop_rate,
                                cfg.max_drop * inv_avg / self.sum_weight)
            for i in range(n_iter):
                if i >= len(self.tree_weight):
                    # a reset of the training data starts the weights over
                    # while the iterations go on; the JAX package indexes
                    # past its list here (IndexError, ROADMAP Queue 3)
                    raise LightGBMError(
                        "DART with uniform_drop=false has no weight for "
                        "iteration %d: its tree weights were lost when the "
                        "training data were reset" % i)
                if self._drop_rng.rand() < (drop_rate * self.tree_weight[i]
                                            * inv_avg):
                    drop_index.append(i)
                    if len(drop_index) >= cfg.max_drop > 0:
                        break
        else:
            if cfg.max_drop > 0 and n_iter > 0:
                drop_rate = min(drop_rate, cfg.max_drop / float(n_iter))
            for i in range(n_iter):
                if self._drop_rng.rand() < drop_rate:
                    drop_index.append(i)
                    if len(drop_index) >= cfg.max_drop > 0:
                        break
        return drop_index

    def _drop(self, drop_index: List[int]) -> Dict[Tuple, torch.Tensor]:
        """Take the dropped iterations' trees out of the training and valid
        scores; returns each one's output, keyed (-1 for the training set,
        else the valid set's index; iteration; class)."""
        k_cls = self.num_tree_per_iteration
        outputs = {}
        for i in drop_index:
            for c in range(k_cls):
                ht = self.models[i * k_cls + c]
                binned = self._binned_tree(ht)
                for vi, scores, xb in self._score_sets():
                    d = self._tree_output(ht, binned, xb)
                    outputs[(vi, i, c)] = d
                    scores[:, c] -= d
        return outputs

    def _score_sets(self):
        """(key, scores, binned matrix) of the training set and each valid
        set."""
        yield -1, self.scores, self.training_rows("DART's drops")
        for vi, cache in enumerate(self._valid):
            yield vi, cache["scores"], cache["xb"]

    def _put_back(self, outputs: Dict[Tuple, torch.Tensor],
                  factor: float) -> None:
        for vi, scores, _ in self._score_sets():
            for (key, i, c), d in outputs.items():
                if key == vi:
                    scores[:, c] += d * factor

    def _train_iteration(self, grad, hess, sample_mask, goss_key) -> bool:
        cfg = self.config
        drop_index = self._dropping_trees()
        k = float(len(drop_index))
        outputs = self._drop(drop_index)
        # the new trees' shrinkage (dart.hpp:133-139)
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + k)
        else:
            self.shrinkage_rate = (cfg.learning_rate if not drop_index
                                   else cfg.learning_rate
                                   / (cfg.learning_rate + k))
        if super()._train_iteration(grad, hess, sample_mask, goss_key):
            # put the dropped trees' outputs back before stopping
            self._put_back(outputs, 1.0)
            return True
        # Normalize (dart.hpp:141-186)
        k_cls = self.num_tree_per_iteration
        if drop_index:
            factor = (k / (k + 1.0) if not cfg.xgboost_dart_mode
                      else k / (cfg.learning_rate + k))
            for i in drop_index:
                for c in range(k_cls):
                    self.models[i * k_cls + c].shrink(factor)
                if not cfg.uniform_drop:
                    self.sum_weight -= self.tree_weight[i] * (
                        1.0 / (k + 1.0) if not cfg.xgboost_dart_mode
                        else 1.0 / (k + cfg.learning_rate))
                    self.tree_weight[i] *= factor
            self._put_back(outputs, factor)
        if not cfg.uniform_drop:
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
        return False
