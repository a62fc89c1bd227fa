"""Replicated serving: KV-announced generations and rolling hot-rolls.

The port's own copy of ``lightgbm_tpu/fleet/replica.py`` (which imports
no JAX). A serving fleet is N independent ``task=serve`` processes
watching the SAME checkpoint directory (serving/registry.py
``CheckpointWatcher``). Left alone they would all stage and prewarm a new
snapshot at once: every replica capturing its CUDA graphs together is a
fleet-wide latency cliff, and a bad snapshot would hit every replica's
canary in parallel. This module coordinates them:

- :class:`FileKvClient`: an atomic-file key/value store with the client
  interface of the JAX package's ``KvHostComm`` (``key_value_set`` /
  ``blocking_key_value_get`` / ``key_value_delete``; timeouts raise with
  ``DEADLINE_EXCEEDED`` in the message, the transient-vs-fatal marker).
  Plain OS processes share a namespace through any common directory.
- :class:`ReplicaAnnouncer`: each replica periodically publishes one JSON
  document (generation per model, last hot-rolled snapshot id, rejected
  snapshot ids, a metrics digest, drift status) under
  ``fleet/<replica>``. Announcements carry a wall-clock stamp; readers
  treat documents older than the lease as a dead replica.
- :class:`RollingDeployCoordinator`: turn-taking WITHOUT a lock service:
  replicas roll a new snapshot in sorted-name order, each waiting until
  every alphabetically-earlier LIVE replica announces the target snapshot
  (or rejects it). The first replica is the fleet's canary: its
  ``stage_and_prewarm`` refusal is announced as a rejection and every
  successor then SKIPS the snapshot. Dead predecessors age out of the wait
  via the lease; a stuck-but-alive one is bounded by
  ``predecessor_timeout_s`` (availability beats strict ordering).
- :class:`FleetClusterProvider`: merges the announced documents into the
  ``/metrics/cluster`` + ``/stats/cluster`` federation surface, served by
  the serving HTTP front-end when a fleet KV directory is configured.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional
from urllib.parse import quote, unquote

from ..log import Log, check


class FileKvClient:
    """Directory-backed KV satisfying the ``KvHostComm`` client seam.

    One key is one file (name = URL-quoted key) written atomically via a
    same-directory temp file + ``os.replace`` — readers see either the
    old value or the new one, never a torn write.  ``blocking_key_value_get``
    polls; on deadline it raises with ``DEADLINE_EXCEEDED`` in the
    message so ``KvHostComm`` treats it exactly like the real
    coordination-service timeout (a poll-slice expiry, not a fatality).
    """

    def __init__(self, directory: str, poll_interval_s: float = 0.02):
        check(bool(directory), "FileKvClient needs a directory")
        self.directory = directory
        self.poll_interval_s = float(poll_interval_s)
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, quote(key, safe=""))

    # ------------------------------------------------ KvHostComm contract
    def key_value_set(self, key: str, value: str) -> None:
        path = self._path(key)
        # one temp file a writing thread: the announcer's loop and the
        # coordinator both announce a replica's document, and two writers
        # sharing a temp name race on its rename
        tmp = path + ".tmp.%d.%d" % (os.getpid(), threading.get_ident())
        with open(tmp, "w") as fh:
            fh.write(value)
        os.replace(tmp, path)

    def blocking_key_value_get(self, key: str, timeout_ms: int) -> str:
        deadline = time.monotonic() + max(int(timeout_ms), 0) / 1000.0
        path = self._path(key)
        while True:
            val = self.try_get(key)
            if val is not None:
                return val
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    "DEADLINE_EXCEEDED: key %r not set within %d ms (%s)"
                    % (key, timeout_ms, path))
            time.sleep(self.poll_interval_s)

    def key_value_delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    # ------------------------------------------------ fleet extras
    def try_get(self, key: str) -> Optional[str]:
        """Non-blocking read; None when unset (or mid-replace)."""
        try:
            with open(self._path(key), "r") as fh:
                return fh.read()
        except FileNotFoundError:
            return None

    def keys(self, prefix: str = "") -> List[str]:
        """Every stored key starting with ``prefix`` (sorted)."""
        out = []
        for name in os.listdir(self.directory):
            if name.endswith((".tmp", ".lock")) or ".tmp." in name:
                continue
            key = unquote(name)
            if key.startswith(prefix):
                out.append(key)
        return sorted(out)


def _fleet_key(replica: str) -> str:
    return "fleet/" + replica


class ReplicaAnnouncer:
    """Publish one replica's serving state into the fleet KV namespace.

    The document is the fleet's ONLY coordination currency — generations
    per model, the last hot-rolled snapshot id, rejected snapshot ids,
    and a metrics digest — stamped with wall-clock time so readers can
    lease out dead replicas (``lease_s``).  ``announce_once`` is cheap
    (one metrics snapshot + one atomic file write); the daemon loop runs
    it every ``period_s``.
    """

    def __init__(self, client, replica: str, engine=None, watcher=None,
                 period_s: float = 1.0, lease_s: float = 10.0):
        check(bool(replica), "ReplicaAnnouncer needs a replica name")
        self.client = client
        self.replica = replica
        self.engine = engine
        self.watcher = watcher
        self.period_s = float(period_s)
        self.lease_s = float(lease_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ publish
    def state(self) -> Dict:
        doc: Dict = {"replica": self.replica, "pid": os.getpid(),
                     "time": round(time.time(), 3)}
        if self.engine is not None:
            reg = self.engine.registry
            doc["generations"] = {mid: reg.generation(mid)
                                  for mid in reg.ids()}
            m = self.engine.metrics.snapshot()
            doc["metrics"] = {k: m.get(k) for k in (
                "requests", "rows", "errors", "shed",
                "recompiles_after_warmup", "rollbacks")}
            doc["p99_ms"] = m.get("latency_ms", {}).get("p99_ms")
            doc["drift"] = self.engine.drift_status().get("status")
        if self.watcher is not None:
            doc["snap_id"] = int(self.watcher._last_id)
            doc["rejected"] = sorted(int(i)
                                     for i in self.watcher._rejected_ids)
        return doc

    def announce_once(self) -> Dict:
        doc = self.state()
        self.client.key_value_set(_fleet_key(self.replica),
                                  json.dumps(doc, sort_keys=True))
        return doc

    def retract(self) -> None:
        """Remove this replica's document (clean shutdown — readers stop
        counting it immediately instead of waiting out the lease)."""
        self.client.key_value_delete(_fleet_key(self.replica))

    # ------------------------------------------------------------ read side
    @staticmethod
    def read_fleet(client, lease_s: float = 10.0) -> Dict[str, Dict]:
        """Every announced replica document, keyed by replica name, each
        annotated ``"live"`` by the lease test.  Unparseable documents
        (a reader racing a writer on a non-atomic store) are skipped."""
        fleet: Dict[str, Dict] = {}
        now = time.time()
        for key in client.keys("fleet/"):
            raw = client.try_get(key)
            if raw is None:
                continue
            try:
                doc = json.loads(raw)
            except ValueError:
                continue
            name = doc.get("replica") or key[len("fleet/"):]
            doc["live"] = bool(now - float(doc.get("time", 0)) <= lease_s)
            fleet[name] = doc
        return fleet

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ReplicaAnnouncer":
        if self._thread is not None:
            return self
        self._stop.clear()
        self.announce_once()

        def loop():
            while not self._stop.wait(self.period_s):
                try:
                    self.announce_once()
                except Exception as e:  # noqa: BLE001 - announcer must not die
                    Log.warning("fleet announcer %r: %s", self.replica, e)

        self._thread = threading.Thread(
            target=loop, name="lgbm-fleet-announce-%s" % self.replica,
            daemon=True)
        self._thread.start()
        return self

    def stop(self, retract: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if retract:
            try:
                self.retract()
            except Exception:  # noqa: BLE001 - shutdown best-effort
                pass


class RollingDeployCoordinator:
    """One-replica-at-a-time hot-rolls, ordered by replica name.

    ``step()`` is one coordination decision: if the watched checkpoint
    directory holds a snapshot newer than what this replica serves, wait
    until every alphabetically-earlier live replica has either rolled to
    it (announced ``snap_id >= target``) or rejected it, then run the
    normal canary-guarded ``CheckpointWatcher.poll``.  A predecessor's
    announced rejection short-circuits the whole fleet: the snapshot is
    added to the local watcher's rejected set without ever being staged —
    the first replica's canary ate the bad snapshot for everyone.
    """

    def __init__(self, client, announcer: ReplicaAnnouncer, watcher,
                 poll_interval_s: float = 0.5,
                 predecessor_timeout_s: float = 30.0):
        self.client = client
        self.announcer = announcer
        self.watcher = watcher
        self.replica = announcer.replica
        self.poll_interval_s = float(poll_interval_s)
        self.predecessor_timeout_s = float(predecessor_timeout_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ decisions
    def _pending_snapshot(self):
        """(snap_id, path) newer than what we serve, or None."""
        from ..checkpoint.manager import CheckpointManager
        latest = CheckpointManager(self.watcher.checkpoint_dir).latest_model()
        if latest is None:
            return None
        snap_id, path = latest
        if snap_id <= self.watcher._last_id \
                or snap_id in self.watcher._rejected_ids:
            return None
        return snap_id, path

    def _predecessors_ready(self, snap_id: int):
        """(ready, rejected_by): ready when every live replica sorting
        before us has announced ``snap_id >= target`` or rejected it;
        ``rejected_by`` names a predecessor whose canary refused it."""
        fleet = ReplicaAnnouncer.read_fleet(self.client,
                                            self.announcer.lease_s)
        for name in sorted(fleet):
            if name >= self.replica:
                break
            doc = fleet[name]
            if not doc.get("live", False):
                continue                      # leased out: dead can't block
            if snap_id in doc.get("rejected", []):
                return False, name
            if int(doc.get("snap_id", -1)) < snap_id:
                return False, None
        return True, None

    def step(self) -> bool:
        """Returns True when this call hot-rolled a new snapshot."""
        pending = self._pending_snapshot()
        if pending is None:
            return False
        snap_id, _ = pending
        deadline = time.monotonic() + self.predecessor_timeout_s
        while not self._stop.is_set():
            ready, rejected_by = self._predecessors_ready(snap_id)
            if rejected_by is not None:
                # fleet-wide canary: the first replica's guarded roll
                # refused this snapshot — never stage it here
                self.watcher._rejected_ids.add(snap_id)
                Log.warning("fleet %r: snapshot %d rejected by canary "
                            "replica %r; skipping fleet-wide",
                            self.replica, snap_id, rejected_by)
                self.announcer.announce_once()
                return False
            if ready:
                break
            if time.monotonic() >= deadline:
                Log.warning("fleet %r: predecessors silent on snapshot %d "
                            "for %.0fs; rolling anyway", self.replica,
                            snap_id, self.predecessor_timeout_s)
                break
            self._stop.wait(self.poll_interval_s)
        rolled = bool(self.watcher.poll())
        # announce immediately either way: a successful roll unblocks the
        # next replica's wait, a rejection warns it off
        self.announcer.announce_once()
        return rolled

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "RollingDeployCoordinator":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.poll_interval_s):
                try:
                    self.step()
                except Exception as e:  # noqa: BLE001 - keep serving alive
                    Log.warning("fleet coordinator %r: %s", self.replica, e)

        self._thread = threading.Thread(
            target=loop, name="lgbm-fleet-roll-%s" % self.replica,
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class FleetClusterProvider:
    """Fleet-wide state for ``/metrics/cluster`` + ``/stats/cluster``.

    The provider contract of the JAX package's ``StatsServer.set_cluster``:
    ``cluster_stats()`` returns the merged replica
    documents plus a fleet summary (replica/live counts, snapshot id
    spread — a non-zero spread is a rolling deploy in flight), and
    ``cluster_prometheus()`` renders them as per-replica labeled gauges
    federation-style scrapers can aggregate."""

    def __init__(self, client, lease_s: float = 10.0):
        self.client = client
        self.lease_s = float(lease_s)

    def cluster_stats(self) -> Dict:
        fleet = ReplicaAnnouncer.read_fleet(self.client, self.lease_s)
        live = [d for d in fleet.values() if d.get("live")]
        snaps = [int(d["snap_id"]) for d in live if "snap_id" in d]
        summary = {
            "replicas": len(fleet),
            "live": len(live),
            "requests": sum(int(d.get("metrics", {}).get("requests") or 0)
                            for d in live),
            "shed": sum(int(d.get("metrics", {}).get("shed") or 0)
                        for d in live),
            "snap_id_min": min(snaps) if snaps else -1,
            "snap_id_max": max(snaps) if snaps else -1,
            "rolling": bool(snaps) and min(snaps) != max(snaps),
        }
        return {"fleet": summary, "replicas": fleet}

    def cluster_prometheus(self) -> str:
        # replica names come from config/CLI, so label VALUES must be
        # escaped per exposition 0.0.4 (backslash, quote, newline) — a
        # replica named `a"b` used to emit an unparseable line here
        from ..obs.registry import escape_label_value
        snap = self.cluster_stats()
        lines = [
            "# HELP lgbm_fleet_replica_up Replica announced within lease.",
            "# TYPE lgbm_fleet_replica_up gauge",
        ]
        gauges = [
            ("lgbm_fleet_replica_snap_id", "snap_id",
             "Last hot-rolled snapshot id."),
            ("lgbm_fleet_replica_requests_total", ("metrics", "requests"),
             "Requests served."),
            ("lgbm_fleet_replica_shed_total", ("metrics", "shed"),
             "Requests shed."),
            ("lgbm_fleet_replica_recompiles_after_warmup",
             ("metrics", "recompiles_after_warmup"),
             "Serving recompiles past the warmup floor."),
        ]
        for name in sorted(snap["replicas"]):
            doc = snap["replicas"][name]
            lines.append('lgbm_fleet_replica_up{replica="%s"} %d'
                         % (escape_label_value(name),
                            1 if doc.get("live") else 0))
        for metric, path, help_text in gauges:
            lines.append("# HELP %s %s" % (metric, help_text))
            lines.append("# TYPE %s gauge" % metric)
            for name in sorted(snap["replicas"]):
                doc = snap["replicas"][name]
                val = (doc.get(path) if isinstance(path, str)
                       else doc.get(path[0], {}).get(path[1]))
                if val is None:
                    continue
                lines.append('%s{replica="%s"} %s'
                             % (metric, escape_label_value(name), val))
        s = snap["fleet"]
        lines += [
            "# HELP lgbm_fleet_live_replicas Live replicas in the fleet.",
            "# TYPE lgbm_fleet_live_replicas gauge",
            "lgbm_fleet_live_replicas %d" % s["live"],
            "# HELP lgbm_fleet_rolling A rolling deploy is in flight.",
            "# TYPE lgbm_fleet_rolling gauge",
            "lgbm_fleet_rolling %d" % (1 if s["rolling"] else 0),
        ]
        return "\n".join(lines) + "\n"
