"""The rank layout of distributed training.

The port of ``lightgbm_tpu/parallel/mesh.py`` (``build_mesh``, :46-88)
and of the mesh layout of the JAX package's ``_setup_train``
(``lightgbm_tpu/boosting/gbdt.py:432-468``, the bin-balanced column
assignment of feature-parallel at :928-975). A JAX mesh position is a
rank here (``parallel/network.py``):

- ``mesh_shape=[P]`` in one process: P thread ranks (``ThreadGroup``),
  all on the CPU, or on CUDA one card each;
- ``num_machines > 1`` (or a group that ``network.init`` or
  ``Booster.set_network`` made): one rank a process (``DistGroup``);
- a parallel ``tree_learner`` with neither, where one device is visible:
  serial training, announced once (the JAX package's fallback, which is
  not a device fallback: the model is the serial one).

The axis is ``feature`` under ``tree_learner=feature`` and ``data``
otherwise. On the data axis the rows are padded to a multiple of P and
rank r keeps the r-th contiguous block, the padding's mask 0; on the
feature axis every rank keeps every row. Columns are padded to a multiple
of ``col_multiple`` (P under the reduce-scatter schedule) with features
of one bin, which the split search never takes. A 2-D ``mesh_shape``
(data x feature) is ROADMAP Queue 1 #13 slice b.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..log import LightGBMError, Log, outside_slice

DATA_AXIS = "data"
FEATURE_AXIS = "feature"

_warned_fallback = False


def _warn_serial_fallback(reason: str) -> None:
    """One loud notice that a parallel tree_learner runs serially."""
    global _warned_fallback
    if not _warned_fallback:
        _warned_fallback = True
        Log.warning("tree_learner falls back to serial: " + reason)


class MeshPlan(NamedTuple):
    """Who the ranks are: ``world`` of them on ``axis``, as threads of this
    process (``kind`` "threads", rank r on ``devices[r]``) or one a process
    (``kind`` "processes", this process's group in ``network``)."""
    world: int
    axis: str
    kind: str
    devices: tuple


def axis_of(tree_learner: str) -> str:
    return FEATURE_AXIS if tree_learner == "feature" else DATA_AXIS


def visible_devices(device: torch.device) -> List[torch.device]:
    """The devices a one-process mesh may take: every card on CUDA, the one
    CPU device otherwise."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def build_mesh(config, device: torch.device, group=None
               ) -> Optional[MeshPlan]:
    """The ranks of a training (``build_mesh`` of the JAX package): None
    for serial training. ``group`` is this process's ``DistGroup``, if
    any (``network.group()``)."""
    shape = [int(s) for s in (config.mesh_shape or [])]
    axis = axis_of(config.tree_learner)
    if len(shape) > 1:
        raise outside_slice("a 2-D mesh_shape %s (data x feature)" % shape,
                            "ROADMAP Queue 1 #13 slice b")
    if group is not None or config.num_machines > 1:
        world = group.world if group is not None else config.num_machines
        if shape and shape[0] != world:
            raise LightGBMError("mesh_shape %s does not match the %d "
                                "processes of the group" % (shape, world))
        if group is not None and world != config.num_machines \
                and config.num_machines > 1:
            raise LightGBMError("num_machines=%d but the group has %d "
                                "ranks" % (config.num_machines, world))
        return MeshPlan(world, axis, "processes",
                        (group.device,) if group is not None else ())
    if shape:
        devs = visible_devices(device)
        if device.type == "cpu":
            devs = devs * shape[0]
        if shape[0] > len(devs):
            raise LightGBMError(
                "mesh_shape %s needs %d devices, only %d available (thread "
                "ranks on CUDA take a card each)"
                % (shape, shape[0], len(devs)))
        return MeshPlan(shape[0], axis, "threads", tuple(devs[:shape[0]]))
    if config.tree_learner != "serial":
        devs = visible_devices(device)
        if len(devs) > 1:
            return MeshPlan(len(devs), axis, "threads", tuple(devs))
        _warn_serial_fallback(
            "tree_learner=%s requested but only %d device is visible and "
            "no mesh_shape was given (one process needs mesh_shape=[P], "
            "several processes num_machines>1 with machines)"
            % (config.tree_learner, len(devs)))
    return None


class RowLayout(NamedTuple):
    """Rank ``rank``'s rows of ``num_data`` real rows: padded rows
    ``[begin, end)`` of ``num_padded`` (on the feature axis every rank
    holds all of them, unpadded)."""
    num_data: int
    num_padded: int
    begin: int
    end: int

    @property
    def num_local(self) -> int:
        return self.end - self.begin


def row_layout(num_data: int, world: int, rank: int, axis: str) -> RowLayout:
    """The distributed loader's row partition without its loss of
    remainder rows (dataset_loader.cpp:469-495; gbdt.py:437-447 of the JAX
    package)."""
    if axis == FEATURE_AXIS:
        return RowLayout(num_data, num_data, 0, num_data)
    padded = num_data + (-num_data) % world
    blk = padded // world
    return RowLayout(num_data, padded, rank * blk, (rank + 1) * blk)


def col_pad(num_cols: int, multiple: int) -> int:
    return (-num_cols) % max(multiple, 1)


def rows_of(a: np.ndarray, layout: RowLayout) -> np.ndarray:
    """The rank's block of a per-row host array (padding rows zero)."""
    a = np.asarray(a)
    pad = layout.num_padded - a.shape[0]
    if pad > 0:
        a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
    return a[layout.begin:layout.end]


def assign_columns(num_bin: Sequence[int], world: int) -> List[List[int]]:
    """Bin-balanced column assignment of feature-parallel
    (feature_parallel_tree_learner.cpp:30-60): the features by descending
    bin count, each to the least loaded rank so far."""
    num_bin = np.asarray(num_bin, np.int64)
    order = np.argsort(-num_bin, kind="stable")
    loads = np.zeros(world, np.int64)
    assign: List[List[int]] = [[] for _ in range(world)]
    for j in order:
        r = int(np.argmin(loads))
        assign[r].append(int(j))
        loads[r] += max(int(num_bin[j]), 1)
    return assign
