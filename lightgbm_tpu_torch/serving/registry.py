"""Model registry: trained boosters and model files -> immutable bundles.

The port of ``lightgbm_tpu/serving/registry.py``. A model is loaded once
and every request thereafter only reads its bundle. Bundles are
immutable: capping ``num_iteration`` packs nothing new, it slices the
packed arrays (cached), so concurrent request threads need no locking past
the registry dict and each bundle's cache.

A bundle lives on one device (its booster's, or the registry's for a
model file) and keeps the host trees; from them it builds, on first use,
the flat forest the traversal serves (``flat_for``) and the replay trees
of ``predict`` (``trees_for``, the ``serving_backend=replay`` path).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from ..core import tree as tree_mod
from ..device import DeviceLike, resolve_device
from ..log import LightGBMError, check, outside_slice


def _sibling_profile(model_path: str):
    """The training data profile of a model-text file from the checkpoint
    meta.json written next to it (``snap_N.model.txt`` ->
    ``snap_N.meta.json``). Returns None for bare model files, pre-profile
    snapshots and unreadable metas (always legal)."""
    import json
    import os
    if not model_path.endswith(".model.txt"):
        return None
    meta_path = model_path[:-len(".model.txt")] + ".meta.json"
    if not os.path.exists(meta_path):
        return None
    try:
        with open(meta_path, "r") as fh:
            meta = json.load(fh)
        from ..obs.drift import DataProfile
        return DataProfile.from_json_dict(meta.get("data_profile"))
    except (OSError, ValueError, KeyError, TypeError):
        # a corrupt sibling never blocks a load
        return None


class ModelBundle:
    """One loaded model, ready to serve.

    ``host_models`` are the trees (``HostTree``/``LoadedTree``),
    iteration-major, ``k`` a boosting iteration; ``objective`` supplies
    ``convert_output`` for non-raw scores (None for custom-objective
    models, which serve raw only); ``device`` is where the bundle's tensors
    live.
    """

    def __init__(self, model_id: str, host_models, num_class: int, k: int,
                 num_features: int, device: DeviceLike = None,
                 objective=None, average_output: bool = False,
                 feature_names: Optional[List[str]] = None, profile=None):
        check(len(host_models) > 0, "cannot serve an empty model")
        self.model_id = model_id
        self.host_models = list(host_models)
        self.num_class = num_class
        self.num_tree_per_iteration = k
        self.num_features = num_features
        self.device = resolve_device(device)
        self.objective = objective
        self.average_output = average_output
        self.feature_names = list(feature_names or [])
        self.total_iterations = len(self.host_models) // k
        self.generation = 0       # bumped by ModelRegistry.register
        # training data profile (obs.drift.DataProfile) or None: the
        # reference distribution drift monitoring scores against; a model
        # from a bare text file or a booster of the port carries none
        self.profile = profile
        self._trees: Dict[int, list] = {}
        self._flat: Dict[bool, tuple] = {}       # quantize -> (forest, depth)
        self._flat_capped: Dict[tuple, object] = {}
        self._lock = threading.Lock()

    @classmethod
    def from_impl(cls, model_id: str, impl,
                  feature_names: Optional[List[str]] = None,
                  num_iteration: Optional[int] = None) -> "ModelBundle":
        """Bundle a boosting driver (``Booster._impl``) on its device: its
        first ``num_iteration`` iterations (every one by default)."""
        models = impl.models
        check(len(models) > 0, "cannot serve an empty model")
        k = max(impl.num_tree_per_iteration, 1)
        total = len(models) // k         # drop a partial trailing iteration
        if num_iteration is not None and num_iteration > 0:
            total = min(total, int(num_iteration))
        total *= k
        if feature_names is None and impl.train_data is not None:
            feature_names = list(impl.train_data.feature_names)
        nf = len(feature_names) if feature_names else int(max(
            (int(np.max(t.split_feature, initial=0)) for t in models),
            default=0)) + 1
        return cls(model_id, models[:total], num_class=impl.num_class, k=k,
                   num_features=nf, device=impl.device,
                   objective=impl.objective,
                   average_output=impl.average_output,
                   feature_names=feature_names)

    @classmethod
    def from_booster(cls, model_id: str, booster) -> "ModelBundle":
        """Bundle the iterations ``booster.predict`` uses by default: up
        to its ``best_iteration`` where it has one, as ``save_model``
        writes them (the JAX package bundles every tree; the two differ
        only on a booster trained past its best iteration)."""
        return cls.from_impl(model_id, booster._impl,
                             feature_names=booster._feature_names(),
                             num_iteration=booster.best_iteration)

    def effective_iterations(self, num_iteration: Optional[int]) -> int:
        if num_iteration is None or num_iteration <= 0:
            return self.total_iterations
        return min(int(num_iteration), self.total_iterations)

    def trees_for(self, num_iteration: Optional[int]) -> list:
        """The replay trees of ``predict`` over the first
        ``num_iteration`` iterations: one stacked ``PredictTree`` a class,
        built once a cap and cached."""
        iters = self.effective_iterations(num_iteration)
        k = self.num_tree_per_iteration
        with self._lock:
            if iters not in self._trees:
                self._trees[iters] = [
                    tree_mod.stack_predict_trees(
                        self.host_models[c:iters * k:k], self.device)
                    for c in range(k)]
            return self._trees[iters]

    def flat_for(self, num_iteration: Optional[int] = None,
                 quantize: bool = False):
        """``(FlatForest, depth)`` for the traversal backend: packed once
        per bundle (== per model generation: a hot roll swaps the whole
        bundle, so stale tables die with it), moved to the bundle's device,
        and sliced per ``num_iteration`` cap. The full forest's depth
        bounds every capped slice too."""
        from .traversal import pack_flat_forest, slice_trees, to_device
        t = self.effective_iterations(num_iteration) \
            * self.num_tree_per_iteration
        q = bool(quantize)
        with self._lock:
            if q not in self._flat:
                host, depth = pack_flat_forest(self.host_models, quantize=q)
                self._flat[q] = (to_device(host, self.device), depth)
            full, depth = self._flat[q]
            if t == len(self.host_models):
                return full, depth
            key = (t, q)
            if key not in self._flat_capped:
                self._flat_capped[key] = slice_trees(full, 0, t)
            return self._flat_capped[key], depth


class ModelRegistry:
    """Named, immutable model bundles on one device.

    Bundles never mutate; re-registration with ``replace=True`` swaps the
    whole bundle atomically under the registry lock and bumps that model's
    generation counter. Replace listeners (ServingEngine's predictor-cache
    purge) fire after the swap, outside the lock.
    """

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._bundles: Dict[str, ModelBundle] = {}
        self._generation: Dict[str, int] = {}
        self._replace_listeners: List = []
        self._lock = threading.Lock()

    def load_file(self, model_id: str, path: str,
                  replace: bool = False) -> ModelBundle:
        """Load a LightGBM model-text file (io/model_text.py format)."""
        return self.register(self.stage_file(model_id, path), replace=replace)

    def stage_file(self, model_id: str, path: str) -> ModelBundle:
        """Build a bundle from a model file WITHOUT registering it, its
        generation pre-set to the value ``register`` will assign. Lets a
        hot-roller capture the next generation's predictors off the
        request path (ServingEngine.prewarm_bundle) before the atomic
        ``register(..., replace=True)`` swap."""
        from ..basic import Booster
        from ..io.model_text import parse_model_file
        parse_model_file(path)   # fail fast with a format error, not mid-serve
        booster = Booster(model_file=path, device=self.device)
        bundle = ModelBundle.from_booster(model_id, booster)
        bundle.profile = _sibling_profile(path)
        with self._lock:
            bundle.generation = self._generation.get(model_id, 0) + 1
        return bundle

    def register(self, bundle: ModelBundle,
                 replace: bool = False) -> ModelBundle:
        if bundle.device != self.device:
            raise LightGBMError("model %r lives on %s but the registry "
                                "serves on %s" % (bundle.model_id,
                                                  bundle.device, self.device))
        with self._lock:
            if bundle.model_id in self._bundles and not replace:
                raise LightGBMError("model id %r already registered "
                                    "(pass replace=True to swap it)"
                                    % bundle.model_id)
            replaced = bundle.model_id in self._bundles
            gen = self._generation.get(bundle.model_id, 0) + 1
            self._generation[bundle.model_id] = gen
            bundle.generation = gen
            self._bundles[bundle.model_id] = bundle
            listeners = list(self._replace_listeners)
        if replaced:
            # outside the lock: listeners may take their own locks
            # (ServingEngine purges its predictor cache here)
            for fn in listeners:
                fn(bundle.model_id)
        return bundle

    def generation(self, model_id: str) -> int:
        with self._lock:
            return self._generation.get(model_id, 0)

    def add_replace_listener(self, fn) -> None:
        """``fn(model_id)`` is called after an existing model is replaced."""
        with self._lock:
            self._replace_listeners.append(fn)

    def get(self, model_id: str) -> ModelBundle:
        with self._lock:
            b = self._bundles.get(model_id)
        if b is None:
            raise LightGBMError("unknown model id %r (registered: %s)"
                                % (model_id, sorted(self._bundles)))
        return b

    def ids(self) -> List[str]:
        with self._lock:
            return sorted(self._bundles)

    def watch_dir(self, model_id: str, checkpoint_dir: str,
                  poll_interval: float = 10.0, start: bool = False,
                  engine=None) -> "CheckpointWatcher":
        """Hot-roll the newest snapshot of a checkpoint directory: not
        ported yet (checkpoints are ROADMAP Queue 1 #12)."""
        return CheckpointWatcher(self, model_id, checkpoint_dir,
                                 poll_interval, engine=engine)


class CheckpointWatcher:
    """Polls a checkpoint directory for newer snapshots: not ported yet."""

    def __init__(self, registry: ModelRegistry, model_id: str,
                 checkpoint_dir: str, poll_interval: float = 10.0,
                 engine=None):
        raise outside_slice("the checkpoint watcher (CheckpointWatcher, "
                            "ModelRegistry.watch_dir)", "ROADMAP Queue 1 #12")
