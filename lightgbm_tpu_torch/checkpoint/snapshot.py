"""Snapshot serialization: the complete training state <-> files on disk.

The port's own copy of ``lightgbm_tpu/checkpoint/snapshot.py``, in the JAX
package's file layout and key names, so each package reads the other's
snapshots. One snapshot is three files, all content-addressed by the
manifest:

- ``snap_NNNNNNNN.state.npz``: every array the boosting driver needs to
  continue bit for bit: the raw ``HostTree`` fields (not a text round
  trip: the doubles that go back into training are the doubles that came
  out, with each split's bins, from which the replay tables are rebuilt),
  the float32 score matrix, each valid set's scores, the bagging key and
  mask, the Mersenne-Twister key vectors of the feature-fraction (and DART
  drop) ``RandomState``, and the CEGB state. Device tensors reach it
  through one synchronized copy to the host each.
- ``snap_NNNNNNNN.meta.json``: JSON-safe scalars: iteration counters,
  config hash, dataset fingerprint, RNG cursors, DART tree weights, the
  training data profile, the train-loop state (eval history and the early
  stopping slots).
- ``snap_NNNNNNNN.model.txt``: ordinary model text, so a snapshot doubles
  as a servable model (``serving.ModelRegistry.watch_dir`` hot-rolls it).

Determinism contract: restoring arrays verbatim (instead of replaying trees
into the scores) is what makes a resumed run's scores, and so every later
split, the uninterrupted run's bit for bit wherever the kernels repeat
themselves (the CPU, float64 histograms on the card).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np

from ..log import LightGBMError, Log
from .manifest import atomic_write_bytes, sha256_file

SNAPSHOT_VERSION = 1

# HostTree array fields persisted verbatim (boosting/gbdt.py HostTree);
# absent fields keep the constructor's defaults
TREE_FIELDS = (
    "split_feature", "split_gain", "threshold", "threshold_bin",
    "default_left", "missing_type", "is_categorical", "cat_bitset",
    "cat_bitset_bin", "left_child", "right_child", "split_leaf",
    "internal_value", "internal_weight", "internal_count",
    "leaf_value", "leaf_weight", "leaf_count")

# parameters that do not change what a resumed run computes: left out of
# the config hash so that retargeting num_iterations or moving output
# paths does not flag a mismatch
_NON_SEMANTIC_PARAMS = frozenset({
    "config", "task", "data", "valid", "num_iterations", "num_threads",
    "verbosity", "output_model", "snapshot_freq", "input_model",
    "output_result", "convert_model", "convert_model_language",
    "early_stopping_round", "first_metric_only", "metric_freq",
    "checkpoint_dir", "checkpoint_period", "checkpoint_keep", "resume",
})


def snapshot_basename(snap_id: int) -> str:
    return "snap_%08d" % snap_id


def config_hash(config) -> str:
    """Stable hash of the parameters that change what training computes."""
    d = config.to_dict()
    items = sorted((k, repr(v)) for k, v in d.items()
                   if k not in _NON_SEMANTIC_PARAMS)
    return hashlib.sha256(repr(items).encode()).hexdigest()[:16]


def dataset_fingerprint(binned) -> str:
    """Hash of the stored bin matrix and the label: a resumed run must see
    the training data the snapshot was built from. Cached on the dataset.

    In memory it hashes ``X_binned`` (the JAX package's bytes, byte for
    byte) and its shape. A streamed dataset has no single matrix: it
    hashes the bin layout (each mapper's dict) and the ordered uint8 code
    chunks, the bytes the JAX package hashes, never the int32 words the
    pipeline packs for the card; chunking itself is not hashed beyond the
    order, so the same rows in the same order with another chunk size
    still match. Equal data give the JAX package's fingerprint."""
    cached = getattr(binned, "_ckpt_fingerprint", None)
    if cached is not None:
        return cached
    h = hashlib.sha256()
    xb = binned.X_binned
    if xb is not None:
        h.update(np.ascontiguousarray(xb).tobytes())
        h.update(repr(xb.shape).encode())
    elif getattr(binned, "is_streamed", False):
        for m in binned.bin_mappers:
            h.update(repr(sorted(m.to_dict().items())).encode())
        for c in binned.chunks:
            h.update(np.ascontiguousarray(c).tobytes())
        h.update(repr((binned.num_data,
                       binned.chunks[0].shape[1] if binned.chunks
                       else 0)).encode())
    label = getattr(binned.metadata, "label", None)
    if label is not None:
        h.update(np.ascontiguousarray(np.asarray(label)).tobytes())
    fp = h.hexdigest()[:16]
    try:
        binned._ckpt_fingerprint = fp
    except AttributeError:
        pass
    return fp


def rng_state_split(rng: np.random.RandomState) -> Tuple[Dict, np.ndarray]:
    """RandomState -> (JSON-safe cursor, uint32 key vector)."""
    alg, keys, pos, has_gauss, cached = rng.get_state()
    return ({"alg": alg, "pos": int(pos), "has_gauss": int(has_gauss),
             "cached_gaussian": float(cached)},
            np.asarray(keys, np.uint32))


def rng_state_join(meta: Dict, keys: np.ndarray) -> Tuple:
    return (str(meta.get("alg", "MT19937")), np.asarray(keys, np.uint32),
            int(meta["pos"]), int(meta["has_gauss"]),
            float(meta["cached_gaussian"]))


def trees_to_arrays(models: List) -> Tuple[Dict[str, Any],
                                           Dict[str, np.ndarray]]:
    """HostTree list -> (meta, arrays) with per-tree prefixed keys."""
    meta = {"num_trees": len(models),
            "num_leaves": [int(t.num_leaves) for t in models],
            "num_leaves_actual": [int(getattr(t, "num_leaves_actual",
                                              t.num_leaves))
                                  for t in models],
            "shrinkage": [float(getattr(t, "shrinkage", 1.0))
                          for t in models]}
    arrays: Dict[str, np.ndarray] = {}
    for i, t in enumerate(models):
        for f in TREE_FIELDS:
            v = getattr(t, f, None)
            if v is not None:
                arrays["t%d_%s" % (i, f)] = np.asarray(v)
    return meta, arrays


def trees_from_arrays(meta: Dict[str, Any],
                      arrays: Dict[str, np.ndarray]) -> List:
    from ..boosting.gbdt import HostTree
    models = []
    for i in range(int(meta["num_trees"])):
        ht = HostTree(int(meta["num_leaves"][i]))
        ht.num_leaves_actual = int(meta["num_leaves_actual"][i])
        ht.shrinkage = float(meta["shrinkage"][i])
        for f in TREE_FIELDS:
            key = "t%d_%s" % (i, f)
            if key in arrays:
                setattr(ht, f, np.array(arrays[key]))
        models.append(ht)
    return models


def write_snapshot(directory: str, snap_id: int, meta: Dict[str, Any],
                   arrays: Dict[str, np.ndarray],
                   model_text: str) -> Dict[str, Any]:
    """Write the three snapshot files atomically; returns the manifest
    entry ({id, iteration, files, sha256})."""
    base = snapshot_basename(snap_id)
    state_name = base + ".state.npz"
    meta_name = base + ".meta.json"
    model_name = base + ".model.txt"

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    atomic_write_bytes(os.path.join(directory, state_name), buf.getvalue())
    atomic_write_bytes(os.path.join(directory, meta_name),
                       json.dumps(meta, sort_keys=True).encode())
    atomic_write_bytes(os.path.join(directory, model_name),
                       model_text.encode())

    sha = {name: sha256_file(os.path.join(directory, name))
           for name in (state_name, meta_name, model_name)}
    # the ckpt_write seam: a ckpt_torn fault truncates the state file after
    # its sha was taken, exactly a torn write, so the manifest check
    # catches it and resume falls back a snapshot
    from ..resilience import faults
    faults.inject("ckpt_write", snapshot=int(snap_id),
                  path=os.path.join(directory, state_name))
    return {"id": int(snap_id),
            "iteration": int(meta.get("iteration", snap_id)),
            "files": {"state": state_name, "meta": meta_name,
                      "model": model_name},
            "sha256": sha}


def read_snapshot(directory: str,
                  entry: Dict[str, Any]) -> Tuple[Dict, Dict, str]:
    """Manifest entry -> (meta, arrays, model_path). The caller verified
    the checksums (``Manifest.verify_entry``/``latest_valid_entry``)."""
    files = entry["files"]
    with open(os.path.join(directory, files["meta"]), "r") as fh:
        meta = json.load(fh)
    if int(meta.get("snapshot_version", 0)) > SNAPSHOT_VERSION:
        raise LightGBMError(
            "snapshot %s written by a newer snapshot_version (%s > %d)"
            % (entry.get("id"), meta.get("snapshot_version"),
               SNAPSHOT_VERSION))
    with np.load(os.path.join(directory, files["state"])) as z:
        arrays = {k: z[k] for k in z.files}
    return meta, arrays, os.path.join(directory, files["model"])


def check_compatibility(meta: Dict[str, Any], config, binned) -> None:
    """A config mismatch warns (changing hyper-parameters on resume is a
    legitimate, sharp tool); a dataset mismatch raises (resuming the RNG
    and scores against other rows is silent corruption)."""
    want_fp = meta.get("dataset_fingerprint", "")
    have_fp = dataset_fingerprint(binned) if binned is not None else ""
    if want_fp and have_fp and want_fp != have_fp:
        raise LightGBMError(
            "checkpoint was written for a different dataset (fingerprint "
            "%s != %s); resume requires the identical training data"
            % (want_fp, have_fp))
    want_ch = meta.get("config_hash", "")
    have_ch = config_hash(config)
    if want_ch and want_ch != have_ch:
        Log.warning(
            "checkpoint config hash %s != current %s: parameters changed "
            "since the snapshot; the resumed run will NOT be byte-identical "
            "to an uninterrupted one", want_ch, have_ch)
