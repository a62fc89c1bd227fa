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

``watch_dir`` hot-rolls a checkpoint directory's newest valid snapshot
(``CheckpointWatcher``); a bundle of a snapshot carries the training data
profile of the ``.meta.json`` beside its model text.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from ..core import tree as tree_mod
from ..device import DeviceLike, resolve_device
from ..log import LightGBMError, Log, check


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
        """Hot-roll the newest valid snapshot of a checkpoint directory
        into this registry under ``model_id`` (registry.py:263-285 of the
        JAX package). Returns a watcher: ``poll()`` checks once (the first
        poll registers the current snapshot), ``start=True`` polls every
        ``poll_interval`` seconds on a daemon thread. The swap is atomic and
        the replace listeners drop the old generation's predictors.

        With ``engine`` (a ServingEngine) a poll that finds a newer snapshot
        stages and prewarms it first (``stage_and_prewarm``: on the card
        its CUDA graphs are captured on the watcher's thread, each under
        ``capture_error_mode="thread_local"``, and credited to the warm-up
        floor) and runs the guarded roll's canary checks before the swap
        commits: live traffic never captures, and a refused snapshot leaves
        the prior generation serving."""
        w = CheckpointWatcher(self, model_id, checkpoint_dir, poll_interval,
                              engine=engine)
        if start:
            w.start()
        return w


class CheckpointWatcher:
    """Polls a checkpoint directory's manifest and rolls newer snapshots in
    (registry.py:288-395 of the JAX package). A request in flight while a
    roll commits keeps the bundle it looked up and the predictor entries of
    that bundle's generation: the cache is keyed by generation, so no
    request replays an old generation's graph against the new bundle."""

    def __init__(self, registry: ModelRegistry, model_id: str,
                 checkpoint_dir: str, poll_interval: float = 10.0,
                 engine=None):
        self.registry = registry
        self.model_id = model_id
        self.checkpoint_dir = checkpoint_dir
        self.poll_interval = float(poll_interval)
        self.engine = engine
        self._last_id = -1
        self._rejected_ids: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if engine is not None and hasattr(engine, "add_drift_hook"):
            # the refit trigger: a drift warn on ANY model this engine
            # serves polls the directory at once, off the request thread
            # (arm_drift_refit)
            engine.add_drift_hook(self._drift_poll)

    def poll(self) -> bool:
        """One check: register the newest valid snapshot if it is newer
        than the last one rolled in. Returns True when it rolled one.
        Verification falls back as resume does (the manifest's checksums,
        newest to oldest). With an engine the staged bundle is prewarmed
        before the swap, and a bundle its guarded roll refuses (canary
        validation) is remembered and skipped on later polls, the prior
        generation left serving."""
        from ..checkpoint.manager import CheckpointManager
        latest = CheckpointManager(self.checkpoint_dir).latest_model()
        if latest is None:
            return False
        snap_id, model_path = latest
        if snap_id <= self._last_id or snap_id in self._rejected_ids:
            return False
        if self.engine is not None:
            try:
                bundle = self.engine.stage_and_prewarm(self.model_id,
                                                       model_path)
            except LightGBMError as e:
                self._rejected_ids.add(snap_id)
                live = self.model_id in self.registry.ids()
                Log.warning("serving: snapshot %d REJECTED for model %r "
                            "(%s); %s", snap_id, self.model_id, e,
                            "prior generation stays live" if live
                            else "no prior generation registered")
                return False
        else:
            bundle = self.registry.stage_file(self.model_id, model_path)
        self.registry.register(bundle, replace=True)
        self._last_id = snap_id
        Log.info("serving: hot-rolled snapshot %d from %s into model %r",
                 snap_id, self.checkpoint_dir, self.model_id)
        return True

    def arm_drift_refit(self, monitor) -> None:
        """Subscribe this watcher to a DriftMonitor (obs/drift.py): when
        serving traffic drifts past the warn threshold, poll the checkpoint
        directory at once, so a snapshot the refit loop has published rolls
        in without waiting out the poll interval. The hook trains nothing
        itself. Watchers built with ``engine=`` arm themselves through
        ``ServingEngine.add_drift_hook``; this is the seam for monitors
        made outside an engine."""
        monitor.on_drift(self._drift_poll)

    def _drift_poll(self, report) -> None:
        """Drift hooks fire on the request thread that crossed the
        threshold: the poll, which may capture a staged bundle's graphs,
        runs on its own daemon thread so that request never waits."""
        t = threading.Thread(target=self._safe_poll, daemon=True,
                             name="ckpt-drift-poll-%s" % self.model_id)
        t.start()

    def _safe_poll(self) -> None:
        try:
            self.poll()
        except Exception as e:  # noqa: BLE001 - keep serving alive
            Log.warning("drift-triggered checkpoint poll %r: %s",
                        self.model_id, e)

    def start(self) -> "CheckpointWatcher":
        if self._thread is not None:
            return self

        def loop():
            while not self._stop.wait(self.poll_interval):
                try:
                    self.poll()
                except Exception as e:  # noqa: BLE001 - keep serving alive
                    Log.warning("checkpoint watcher %r: %s",
                                self.model_id, e)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="ckpt-watch-%s" % self.model_id)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
