"""CheckpointManager: the save/load driver over manifest and snapshot.

The port's own copy of ``lightgbm_tpu/checkpoint/manager.py``. It owns
one checkpoint directory. ``save`` captures a booster's (or a bare boosting
driver's) training state into an immutable snapshot, publishes it in the
manifest and applies retention (the ``keep_last_n`` newest plus the best
so far by validation metric). ``load_latest`` returns the newest snapshot
that passes checksum verification, falling back past truncated or corrupt
tails, or raises when a manifest exists but nothing in it loads (silent
data loss is never an option). ``save_refit``, the fleet's trees-only
snapshot, is ROADMAP Queue 1 #15.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Tuple

from ..log import Log, LightGBMError, outside_slice
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
        meta, arrays = impl.training_state()
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
        """The JAX package's refit snapshot (trees only, shipped by the
        continuous-training loop to the serving fleet): not ported."""
        raise outside_slice("CheckpointManager.save_refit (the fleet's "
                            "refit snapshots)", "ROADMAP Queue 1 #15")

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
