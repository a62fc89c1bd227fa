"""Process telemetry: identity, straggler skew, metric merging and the
flight recorder.

The single-process part of ``lightgbm_tpu/obs/distributed.py``, host code
only:

- ``process_env()``: ``(process_index, process_count, hostname)``. The
  port trains on one process, so it is ``(0, 1, hostname)``.
- ``straggler_skew`` and ``merge_prometheus_texts``: the pure helpers of
  the JAX package's cross-process federation, kept equal to it.
- **Flight recorder.** A bounded ring of the most recent events and spans
  that dumps to ``<obs_event_file>.<process>.crash.jsonl`` on a
  HealthMonitor abort or raise, SIGTERM, or an unhandled exception: the
  post-mortem for "what was the run doing when it died".

The JAX package's ``DistributedObs`` (the once-per-block allgather, the
per-wave stall attribution and the cluster cache) needs several processes
and comes with ROADMAP Queue 1 #13; ``obs_distributed=on`` refuses.
"""
from __future__ import annotations

import collections
import json
import os
import signal
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..log import Log


def process_env() -> Tuple[int, int, str]:
    """(process_index, process_count, hostname): one process, as the port
    trains on one device."""
    import socket
    return 0, 1, socket.gethostname()


def straggler_skew(walls: Sequence[float]) -> Tuple[float, int]:
    """``(max/median, argmax)`` over per-process wall times.  The
    max/median ratio is robust to one slow outlier inflating the mean
    (the straggler itself must not drag the denominator); a degenerate
    median (all ~zero) reports 1.0, never inf/NaN."""
    vals = [max(float(w), 0.0) for w in walls]
    if not vals:
        return 1.0, -1
    s = sorted(vals)
    n = len(s)
    med = s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
    mx = max(vals)
    arg = vals.index(mx)
    if med <= 1e-12:
        return 1.0, arg
    return mx / med, arg


def merge_prometheus_texts(texts: Sequence[str]) -> str:
    """Merge per-process Prometheus expositions into one: HELP/TYPE
    headers deduplicated (first process wins), sample lines grouped per
    family with every process's series kept — the per-process
    ``process=".."`` global labels make them distinct series, so no
    value-level merging is needed or wanted."""
    fams: Dict[str, Dict[str, List[str]]] = {}

    def fam(name: str) -> Dict[str, List[str]]:
        return fams.setdefault(name, {"help": [], "type": [], "samples": []})

    for text in texts:
        cur: Optional[str] = None
        for line in (text or "").splitlines():
            if line.startswith("# HELP "):
                cur = line.split()[2]
                f = fam(cur)
                if not f["help"]:
                    f["help"].append(line)
            elif line.startswith("# TYPE "):
                cur = line.split()[2]
                f = fam(cur)
                if not f["type"]:
                    f["type"].append(line)
            elif line.strip():
                if cur is None:        # headerless stray: key by base name
                    cur = line.split("{")[0].split(" ")[0]
                fam(cur)["samples"].append(line)
    lines: List[str] = []
    for name in sorted(fams):
        f = fams[name]
        lines += f["help"] + f["type"] + f["samples"]
    return "\n".join(lines) + ("\n" if lines else "")


class FlightRecorder:
    """Bounded in-memory ring of recent telemetry records that dumps to
    ``<base_path>.<process>.crash.jsonl`` when the run dies.

    Fed by the EventStream (every written record lands here too) and by
    direct ``record()`` calls; ``install()`` hooks SIGTERM and
    ``sys.excepthook`` so the dump happens on kills and unhandled
    exceptions, and the HealthMonitor's fatal path calls ``dump``
    explicitly.  The SIGTERM hook chains: it dumps, restores the previous
    handler, and re-delivers the signal — composing with the checkpoint
    callback's latch-then-resign protocol (checkpoint/callback.py), which
    restores THIS handler before re-raising, so a checkpointed run dumps
    after its final snapshot and still exits like a SIGTERM'd process.
    Only the first dump wins (``dump`` latches), so abort-then-SIGTERM
    never truncates an earlier, more complete dump.
    """

    def __init__(self, base_path: str, process_index: int = 0,
                 size: int = 512, on_dump=None):
        self.process_index = int(process_index)
        self.dump_path = "%s.%d.crash.jsonl" % (base_path,
                                                self.process_index)
        self._ring = collections.deque(maxlen=max(int(size), 1))
        self._lock = threading.Lock()
        self._dumped = False
        self._on_dump = on_dump
        self._installed = False
        self._prev_sigterm = None
        self._prev_hook = None

    # ------------------------------------------------------------ feed
    def append(self, rec: Dict) -> None:
        with self._lock:
            self._ring.append(dict(rec))

    def record(self, event: str, **fields) -> None:
        rec = {"ts": round(time.time(), 6), "event": event}
        rec.update(fields)
        self.append(rec)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # ------------------------------------------------------------ dump
    def dump(self, reason: str) -> Optional[str]:
        with self._lock:
            if self._dumped:
                return self.dump_path
            self._dumped = True
            recs = list(self._ring)
        if self._on_dump is not None:
            try:
                self._on_dump(reason)
            except Exception:
                pass
        header = {"ts": round(time.time(), 6),
                  "event": "flight_recorder_dump", "reason": str(reason),
                  "process": self.process_index, "entries": len(recs)}
        try:
            with open(self.dump_path, "w") as fh:
                fh.write(json.dumps(header, sort_keys=True) + "\n")
                for rec in recs:
                    fh.write(json.dumps(rec, sort_keys=True,
                                        default=str) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
        except OSError as e:
            Log.warning("obs: flight recorder dump to %s failed: %s"
                        % (self.dump_path, e))
            return None
        return self.dump_path

    # ------------------------------------------------------------ hooks
    def install(self) -> None:
        """Arm the SIGTERM + excepthook crash paths (idempotent)."""
        if self._installed:
            return
        self._installed = True
        self._prev_hook = sys.excepthook
        sys.excepthook = self._excepthook
        if threading.current_thread() is threading.main_thread():
            try:
                self._prev_sigterm = signal.signal(signal.SIGTERM,
                                                   self._on_sigterm)
            except ValueError:
                self._prev_sigterm = None

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        # == not `is`: attribute access mints a fresh bound method, so an
        # identity check never matches the one install() stored
        if sys.excepthook == self._excepthook:
            sys.excepthook = self._prev_hook or sys.__excepthook__
        try:
            if signal.getsignal(signal.SIGTERM) == self._on_sigterm:
                signal.signal(signal.SIGTERM,
                              self._prev_sigterm
                              if self._prev_sigterm is not None
                              else signal.SIG_DFL)
        except ValueError:
            pass

    def _on_sigterm(self, signum, frame) -> None:
        self.dump("sigterm")
        prev = self._prev_sigterm
        self._installed = False
        try:
            signal.signal(signal.SIGTERM,
                          prev if prev is not None else signal.SIG_DFL)
        except ValueError:
            pass
        if callable(prev):
            prev(signum, frame)
        else:
            signal.raise_signal(signal.SIGTERM)

    def _excepthook(self, etype, value, tb) -> None:
        try:
            self.dump("exception:%s" % getattr(etype, "__name__", etype))
        except Exception:
            pass
        (self._prev_hook or sys.__excepthook__)(etype, value, tb)
