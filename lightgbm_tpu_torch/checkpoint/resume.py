"""Engine-side resume: load a snapshot and put the whole run back.

The port's own copy of ``lightgbm_tpu/checkpoint/resume.py``. ``restore``
puts back everything ``engine.train`` assembled before the boosting loop:
the driver's device and RNG state (``GBDT.load_training_state``), the
validation scores, and the loop's callback state (the eval history into
``record_evaluation`` and the checkpoint callback's own record, the early
stopping slots). After it returns the loop continues at the iteration the
snapshot captured, on the same key stream.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterable, Optional

from ..log import Log, LightGBMError
from . import snapshot as snap_mod
from .manager import CheckpointManager, SnapshotHandle


def load_latest(directory: str,
                keep_last_n: int = 3) -> Optional[SnapshotHandle]:
    """The newest snapshot in ``directory`` that verifies (None: start
    fresh)."""
    return CheckpointManager(directory, keep_last_n=keep_last_n).load_latest()


def _fill_store(store: Dict, history: Dict[str, Dict[str, list]]) -> None:
    for data_name, per in (history or {}).items():
        dst = store.setdefault(data_name, collections.OrderedDict())
        for metric_name, values in per.items():
            dst.setdefault(metric_name, []).extend(values)


def restore(booster, handle: SnapshotHandle,
            callbacks: Optional[Iterable] = None) -> int:
    """Restore ``booster`` and the loop's ``callbacks`` from ``handle``.

    Returns the boosting iterations the checkpointed run had completed (on
    top of any init model), so that the caller can shrink its remaining
    budget."""
    from .. import callback as callback_mod

    impl = booster._impl
    meta = handle.meta
    if meta.get("boosting_type", impl.boosting_type) != impl.boosting_type:
        raise LightGBMError(
            "checkpoint was written by boosting=%s but this run uses "
            "boosting=%s" % (meta.get("boosting_type"), impl.boosting_type))
    snap_mod.check_compatibility(meta, booster.config, impl.train_data)
    impl.load_training_state(meta, handle.arrays)

    loop = meta.get("train_loop") or {}
    history = loop.get("eval_history") or {}
    es_state = loop.get("early_stopping")
    for cb in callbacks or []:
        if getattr(cb, "is_checkpoint", False):
            cb.seed_history(history)
        elif isinstance(cb, callback_mod._RecordEvaluation):
            _fill_store(cb.store, history)
        elif isinstance(cb, callback_mod._EarlyStopping) and es_state:
            cb.set_state(es_state)

    completed = int(meta["iteration"]) - int(meta.get("num_init_iteration",
                                                      0))
    Log.info("checkpoint: restored snapshot %s from %s (%d iteration(s) "
             "already trained)", handle.entry.get("id"), handle.directory,
             completed)
    return completed
