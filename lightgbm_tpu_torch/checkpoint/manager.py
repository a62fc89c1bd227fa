"""CheckpointManager: the save/load driver over manifest and snapshot.

The port's own copy of ``lightgbm_tpu/checkpoint/manager.py``. It owns
one checkpoint directory. ``save`` captures a booster's (or a bare boosting
driver's) training state into an immutable snapshot, publishes it in the
manifest and applies retention (the ``keep_last_n`` newest plus the best
so far by validation metric). ``load_latest`` returns the newest snapshot
that passes checksum verification, falling back past truncated or corrupt
tails, or raises when a manifest exists but nothing in it loads (silent
data loss is never an option). ``save_refit`` publishes the fleet's
trees-only snapshot of a refitted model.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Tuple

from ..log import Log, LightGBMError
from .manifest import Manifest
from . import snapshot as snap_mod


class SnapshotHandle:
    """One loaded snapshot: its state's meta and arrays and the servable
    model's path."""

    def __init__(self, directory: str, entry: Dict[str, Any],
                 meta: Dict[str, Any], arrays: Dict[str, Any],
                 model_path: str):
        self.directory = directory
        self.entry = entry
        self.meta = meta
        self.arrays = arrays
        self.model_path = model_path

    @property
    def iteration(self) -> int:
        return int(self.meta.get("iteration", self.entry.get("iteration", 0)))


def _impl_of(target):
    """A basic.Booster or a bare boosting driver."""
    return target._impl if hasattr(target, "_impl") else target


def _model_text(target, impl) -> str:
    if hasattr(target, "model_to_string"):
        return target.model_to_string()
    from ..io import model_text as mt
    ds = impl.train_data
    return mt.model_to_string(impl, list(ds.feature_names),
                              list(ds.get_feature_infos()))


class CheckpointManager:

    def __init__(self, directory: str, keep_last_n: int = 3):
        if not directory:
            raise LightGBMError("checkpoint directory must be non-empty")
        self.directory = directory
        self.keep_last_n = int(keep_last_n)
        # seconds of the last save: the state's copy to the host
        # (``capture_s``) and the files written, hashed, fsynced and
        # renamed with the manifest (``write_s``)
        self.last_timing: Dict[str, float] = {}

    def save(self, target, train_loop: Optional[Dict[str, Any]] = None,
             eval_entry: Optional[Tuple] = None) -> Dict[str, Any]:
        """Snapshot ``target`` (a Booster or a driver) at its iteration.

        ``train_loop`` carries the loop's state that the driver does not
        own (the eval history, the early-stopping slots); ``eval_entry`` is
        one ``(data, metric, value, bigger_better)`` tuple, read for the
        best-so-far retention flag.
        """
        impl = _impl_of(target)
        t0 = time.perf_counter()
        meta, arrays = impl.global_training_state()
        t1 = time.perf_counter()
        os.makedirs(self.directory, exist_ok=True)
        manifest = Manifest.load(self.directory) or Manifest(self.directory)
        meta["snapshot_version"] = snap_mod.SNAPSHOT_VERSION
        meta["config_hash"] = snap_mod.config_hash(impl.config)
        if impl.train_data is not None:
            meta["dataset_fingerprint"] = snap_mod.dataset_fingerprint(
                impl.train_data)
        meta["unix_time"] = time.time()
        if train_loop:
            meta["train_loop"] = train_loop

        snap_id = int(meta["iteration"])
        entry = snap_mod.write_snapshot(self.directory, snap_id, meta,
                                        arrays, _model_text(target, impl))
        entry["unix_time"] = meta["unix_time"]
        if eval_entry is not None:
            entry["eval"] = {"data": str(eval_entry[0]),
                             "metric": str(eval_entry[1]),
                             "value": float(eval_entry[2]),
                             "bigger_better": bool(eval_entry[3])}

        manifest.entries = [e for e in manifest.entries
                            if int(e["id"]) != snap_id]
        manifest.add_entry(entry)
        self._flag_best(manifest, entry)
        manifest.config_hash = meta["config_hash"]
        manifest.dataset_fingerprint = meta.get("dataset_fingerprint", "")
        manifest.prune(self.keep_last_n)
        manifest.save()
        self.last_timing = {"capture_s": t1 - t0,
                            "write_s": time.perf_counter() - t1}
        return entry

    def save_refit(self, target, data_profile=None) -> Dict[str, Any]:
        """Publish a REFIT snapshot (manager.py:114-158 of the JAX
        package): trees only (structure and re-estimated leaf values), no
        resumable training state.

        This is how the continuous-training loop ships a refitted model to
        the serving fleet: the snapshot takes the next free id, so
        ``latest_model`` (the CheckpointWatcher's poll target) hot-rolls
        it, while training resume (``load_latest``) SKIPS it and keeps
        resuming from the last full training snapshot.

        ``data_profile`` (``obs.drift.DataProfile``, typically of the refit
        window) rides in the snapshot's meta; the serving side reads it
        with the model (serving/registry.py), which is what makes the
        drift scores recover after a refit."""
        impl = _impl_of(target)
        if not getattr(impl, "models", None):
            raise LightGBMError("save_refit: target has no trees")
        os.makedirs(self.directory, exist_ok=True)
        manifest = Manifest.load(self.directory) or Manifest(self.directory)

        tree_meta, arrays = snap_mod.trees_to_arrays(impl.models)
        k = max(int(getattr(impl, "num_tree_per_iteration", 1)), 1)
        meta: Dict[str, Any] = {
            "snapshot_version": snap_mod.SNAPSHOT_VERSION,
            "refit": True,
            "iteration": len(impl.models) // k,
            "config_hash": snap_mod.config_hash(impl.config),
            "unix_time": time.time(),
            "trees": tree_meta,
        }
        if data_profile is not None:
            meta["data_profile"] = data_profile.to_json_dict()

        snap_id = 1 + max((int(e["id"]) for e in manifest.entries),
                          default=int(meta["iteration"]) - 1)
        entry = snap_mod.write_snapshot(self.directory, snap_id, meta,
                                        arrays, _model_text(target, impl))
        entry["refit"] = True
        entry["unix_time"] = meta["unix_time"]
        manifest.entries = [e for e in manifest.entries
                            if int(e["id"]) != snap_id]
        manifest.add_entry(entry)
        manifest.prune(self.keep_last_n)
        manifest.save()
        return entry

    @staticmethod
    def _flag_best(manifest: Manifest, entry: Dict[str, Any]) -> None:
        ev = entry.get("eval")
        if not ev:
            return
        best = None
        for e in manifest.entries:
            if e.get("best") and e.get("eval") and e is not entry:
                best = e
                break
        if best is None:
            entry["best"] = True
            return
        bigger = bool(ev["bigger_better"])
        improved = (ev["value"] > best["eval"]["value"] if bigger
                    else ev["value"] < best["eval"]["value"])
        if improved:
            best["best"] = False
            entry["best"] = True

    def load_latest(self) -> Optional[SnapshotHandle]:
        """The newest snapshot that verifies, or None when the directory has
        no readable manifest (a fresh start: a preemption-safe launch
        script's first run). Raises when a manifest lists snapshots but
        none of them verifies. Refit snapshots (the JAX package's
        ``save_refit``) hold no training state and are passed over."""
        manifest = Manifest.load(self.directory)
        if manifest is None or not manifest.entries:
            return None
        train_entries = [e for e in manifest.entries if not e.get("refit")]
        if not train_entries:
            return None
        entry = manifest.latest_valid_entry(skip=lambda e: e.get("refit"))
        if entry is None:
            raise LightGBMError(
                "checkpoint directory %s has a manifest with %d snapshot(s) "
                "but none passed verification; refusing to silently start "
                "over" % (self.directory, len(train_entries)))
        if int(entry["id"]) != max(int(e["id"]) for e in train_entries):
            Log.warning("checkpoint: resuming from snapshot %s (newer "
                        "snapshots failed verification)", entry["id"])
        meta, arrays, model_path = snap_mod.read_snapshot(self.directory,
                                                          entry)
        return SnapshotHandle(self.directory, entry, meta, arrays, model_path)

    def latest_model(self) -> Optional[Tuple[int, str]]:
        """(snapshot id, model-text path) of the newest snapshot that
        verifies: the serving watcher's cheap poll target."""
        manifest = Manifest.load(self.directory)
        if manifest is None or not manifest.entries:
            return None
        entry = manifest.latest_valid_entry()
        if entry is None:
            return None
        return (int(entry["id"]),
                os.path.join(self.directory, entry["files"]["model"]))
