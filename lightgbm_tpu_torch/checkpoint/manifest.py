"""Versioned checkpoint manifest: the directory's source of truth.

The port's own copy of ``lightgbm_tpu/checkpoint/manifest.py``. A
checkpoint directory holds immutable snapshot files plus ONE mutable
object, ``MANIFEST.json``, listing every snapshot with per-file sha256
checksums. All writes are atomic (a temporary file, fsync, then
``os.replace``), and the previous manifest survives as
``MANIFEST.json.bak`` so even a crash between the two renames leaves a
loadable directory. Readers never trust a snapshot the manifest does not
vouch for: loading walks entries newest -> oldest and the first entry
whose files all exist and hash clean wins; anything else is skipped with a
warning (the preemption-mid-write case the subsystem exists for). The
layout and key names are the JAX package's, so each package reads the
other's directories.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional

from ..log import Log, LightGBMError

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_BAK = "MANIFEST.json.bak"
FORMAT_VERSION = 1


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def atomic_write_bytes(path: str, data: bytes) -> None:
    """A temporary file and a rename in the same directory, fsynced before
    the rename so the rename never publishes a partially flushed file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


class Manifest:
    """In-memory view of MANIFEST.json with atomic persistence."""

    def __init__(self, directory: str):
        self.directory = directory
        self.format_version = FORMAT_VERSION
        self.config_hash: str = ""
        self.dataset_fingerprint: str = ""
        self.entries: List[Dict[str, Any]] = []

    @property
    def path(self) -> str:
        return os.path.join(self.directory, MANIFEST_NAME)

    @classmethod
    def load(cls, directory: str) -> Optional["Manifest"]:
        """Read the manifest, falling back to the .bak copy when the primary
        is missing or corrupt. Returns None when neither exists."""
        primary = os.path.join(directory, MANIFEST_NAME)
        backup = os.path.join(directory, MANIFEST_BAK)
        for path in (primary, backup):
            if not os.path.exists(path):
                continue
            try:
                with open(path, "r") as fh:
                    raw = json.load(fh)
            except (ValueError, OSError) as e:
                Log.warning("checkpoint manifest %s unreadable (%s); trying "
                            "fallback", path, e)
                continue
            if raw.get("format_version", 0) > FORMAT_VERSION:
                raise LightGBMError(
                    "checkpoint manifest %s has format_version %s, newer "
                    "than this build understands (%d)"
                    % (path, raw.get("format_version"), FORMAT_VERSION))
            m = cls(directory)
            m.format_version = int(raw.get("format_version", FORMAT_VERSION))
            m.config_hash = str(raw.get("config_hash", ""))
            m.dataset_fingerprint = str(raw.get("dataset_fingerprint", ""))
            m.entries = list(raw.get("entries", []))
            if path == backup:
                Log.warning("checkpoint manifest restored from %s",
                            MANIFEST_BAK)
            return m
        return None

    def save(self) -> None:
        """Atomically publish the manifest, demoting the previous one to
        .bak first (so a crash mid-save still leaves a valid manifest)."""
        payload = json.dumps({
            "format_version": self.format_version,
            "config_hash": self.config_hash,
            "dataset_fingerprint": self.dataset_fingerprint,
            "entries": self.entries,
        }, indent=1, sort_keys=True).encode()
        if os.path.exists(self.path):
            try:
                os.replace(self.path, os.path.join(self.directory,
                                                   MANIFEST_BAK))
            except OSError:
                pass
        atomic_write_bytes(self.path, payload)

    def add_entry(self, entry: Dict[str, Any]) -> None:
        self.entries.append(entry)
        self.entries.sort(key=lambda e: int(e["id"]))

    def verify_entry(self, entry: Dict[str, Any]) -> bool:
        """True when every file the entry lists exists and hashes clean."""
        for fname, digest in entry.get("sha256", {}).items():
            path = os.path.join(self.directory, fname)
            if not os.path.exists(path):
                Log.warning("checkpoint snapshot %s missing file %s",
                            entry.get("id"), fname)
                return False
            if sha256_file(path) != digest:
                Log.warning("checkpoint snapshot %s failed checksum on %s "
                            "(truncated or corrupt write)",
                            entry.get("id"), fname)
                return False
        return True

    def latest_valid_entry(self, skip=None) -> Optional[Dict[str, Any]]:
        """Newest entry that verifies; corrupt tails are skipped loudly.
        ``skip(entry) -> bool`` filters entries out silently first: how
        training resume passes over refit snapshots (trees only, no
        resumable state) that serving hot-rolls."""
        for entry in sorted(self.entries, key=lambda e: -int(e["id"])):
            if skip is not None and skip(entry):
                continue
            if self.verify_entry(entry):
                return entry
            Log.warning("checkpoint: falling back past corrupt snapshot %s",
                        entry.get("id"))
        return None

    def prune(self, keep_last_n: int) -> None:
        """Retention: keep the newest ``keep_last_n`` entries plus any entry
        flagged best so far plus the newest full training snapshot (a run
        of refit snapshots must never prune away the only resumable state);
        delete the files of everything else."""
        if keep_last_n <= 0 or len(self.entries) <= keep_last_n:
            return
        ordered = sorted(self.entries, key=lambda e: -int(e["id"]))
        keep = list(ordered[:keep_last_n])
        keep_ids = {int(e["id"]) for e in keep}
        for e in ordered[keep_last_n:]:
            if e.get("best"):
                keep.append(e)
                keep_ids.add(int(e["id"]))
        if not any(not e.get("refit") for e in keep):
            for e in ordered[keep_last_n:]:
                if not e.get("refit"):
                    keep.append(e)
                    keep_ids.add(int(e["id"]))
                    break
        for e in ordered:
            if int(e["id"]) in keep_ids:
                continue
            for fname in e.get("sha256", {}):
                try:
                    os.remove(os.path.join(self.directory, fname))
                except OSError:
                    pass
        self.entries = sorted(keep, key=lambda e: int(e["id"]))
