"""lightgbm_tpu_torch.fleet: the continuous-training serving fleet.

The port of ``lightgbm_tpu/fleet/``: what keeps a SERVING model current
without a full retrain.

- **refit** (refit.py): structure-preserving leaf re-estimation on fresh
  data (the reference's ``GBDT::RefitTree``) on the booster's device: one
  flat-forest routing of every row through every tree, then one loop over
  iterations of gradient refresh and per-leaf sums in a fixed order,
  published as a checkpoint snapshot (``CheckpointManager.save_refit``)
  so that the result rides the hot-roll path.
- **QoS** (qos.py): per-model admission quotas and weighted-fair
  scheduling when several models share one engine, and closed-loop
  cascade-margin autotuning against a latency budget.
- **replicas** (replica.py): N serving processes kept converged through
  a shared checkpoint directory and file-KV generation announcements,
  rolled one at a time behind the canary-guarded ``stage_and_prewarm``
  refusal, with fleet-wide state on ``/metrics/cluster``.
- **the loop**: a drift warn polls the checkpoint directory at once
  (``CheckpointWatcher``), a refit worker publishes the refit window's
  snapshot with its data profile, and the fleet rolls it in.
"""
from .refit import Refitter, refit_booster
from .qos import CascadeAutotuner, QosPolicy
from .replica import (FileKvClient, FleetClusterProvider, ReplicaAnnouncer,
                      RollingDeployCoordinator)

__all__ = [
    "Refitter", "refit_booster", "QosPolicy", "CascadeAutotuner",
    "FileKvClient", "ReplicaAnnouncer", "RollingDeployCoordinator",
    "FleetClusterProvider",
]
