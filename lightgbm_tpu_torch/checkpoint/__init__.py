"""Preemption-safe training checkpoints, the port of
``lightgbm_tpu/checkpoint/``.

A snapshot captures the complete training state: the trees as raw arrays,
the float32 score matrix, every RNG cursor (the bagging and GOSS threefry
key and mask, the feature-fraction and DART ``RandomState``, DART's tree
weights, RF's running sums), each valid set's scores, CEGB's state, the
eval history and the early-stopping slots, under a checksummed, atomically
written manifest with retention. A run killed at iteration *k* and resumed
with ``engine.train(..., resume_from=dir)`` (or ``checkpoint_dir`` and
``resume`` in the parameters) produces the model file of the
uninterrupted run byte for byte wherever the kernels repeat themselves
(the CPU; float64 histograms on the card); corrupt or truncated snapshots
are detected and skipped for the previous valid one. The directory layout
is the JAX package's, so each package resumes from the other's snapshots.
"""
from .callback import checkpoint
from .manager import CheckpointManager, SnapshotHandle
from .manifest import Manifest
from .resume import load_latest, restore
from .snapshot import (check_compatibility, config_hash,
                       dataset_fingerprint)

__all__ = [
    "checkpoint", "CheckpointManager", "SnapshotHandle", "Manifest",
    "load_latest", "restore", "check_compatibility", "config_hash",
    "dataset_fingerprint",
]
