"""Process-wide metrics registry: counters, gauges, summaries, histograms.

The port's own copy of ``lightgbm_tpu/obs/registry.py``, plain Python.
One registry serves the whole process: the serving metrics
(``serving/metrics.py``), the drift monitors and the health monitor all
register here, so one Prometheus scrape (serving ``/metrics/prometheus``)
sees everything. Metrics are keyed by ``(name, labels)`` and get-or-create
is idempotent: calling ``counter("x")`` twice returns the same object.

Thread safety: the registry map has its own lock and every metric guards
its state with one; all mutators are O(1) (summaries append to a bounded
deque), so hot paths never contend on a global lock. The module imports
neither torch nor numpy.
"""
from __future__ import annotations

import bisect
import collections
import json
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

_QUANTILES = (0.5, 0.9, 0.99)


def _fmt_value(v: float) -> str:
    """Prometheus sample value: integral floats print as integers so the
    exposition (and the golden test pinning it) stays stable."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def escape_label_value(v: str) -> str:
    """Prometheus label-value escaping (backslash, newline, quote) for
    exposition emitted OUTSIDE this module — e.g. the fleet's hand-built
    per-replica rows, where a hostile replica/model name must not be able
    to smuggle extra labels or break a scrape."""
    return _escape_label(v)


def _escape_help(v: str) -> str:
    # HELP escaping per the 0.0.4 text format: backslash then line feed
    # (label-value quoting does NOT apply here)
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _label_suffix(labels: Tuple[Tuple[str, str], ...],
                  extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    items = tuple(labels) + tuple(extra)
    if not items:
        return ""
    return "{%s}" % ",".join('%s="%s"' % (k, _escape_label(v))
                             for k, v in items)


class _Metric:
    """Shared plumbing: identity, lock, label set."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.help = help
        self.labels = labels
        self._lock = threading.Lock()

    @property
    def label_dict(self) -> Dict[str, str]:
        return dict(self.labels)


class Counter(_Metric):
    """Monotonic counter.  ``inc`` only; negative increments are clamped."""

    kind = "counter"

    def __init__(self, name, help, labels):
        super().__init__(name, help, labels)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            return
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def samples(self):
        return [(self.name, self.labels, self.value)]


class Gauge(_Metric):
    """Settable instantaneous value."""

    kind = "gauge"

    def __init__(self, name, help, labels):
        super().__init__(name, help, labels)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def samples(self):
        return [(self.name, self.labels, self.value)]


class Summary(_Metric):
    """Bounded-window distribution exposed as a Prometheus summary:
    ``{quantile="..."}`` series over the last ``window`` observations plus
    lifetime ``_sum`` / ``_count``.  A windowed summary is the right tool
    for serving latency (and span durations) — it answers "p99 lately",
    not "p99 since process start"."""

    kind = "summary"

    def __init__(self, name, help, labels, window: int = 4096):
        super().__init__(name, help, labels)
        self._window = collections.deque(maxlen=window)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        with self._lock:
            v = float(value)
            self._window.append(v)
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def values(self) -> List[float]:
        """Copy of the current observation window (oldest first)."""
        with self._lock:
            return list(self._window)

    @property
    def total(self) -> float:
        """Lifetime sum of observations (the ``_sum`` series)."""
        with self._lock:
            return self._sum

    def quantiles(self) -> Dict[float, float]:
        # copy under the lock, sort OUTSIDE it: the O(n log n) sort over
        # the 4096-sample window must not stall hot-path observe() calls
        # while a scrape serializes (tests/test_obs_export.py hammers
        # this exact interleaving)
        with self._lock:
            data = list(self._window)
        data.sort()
        if not data:
            return {q: 0.0 for q in _QUANTILES}
        out = {}
        for q in _QUANTILES:
            # nearest-rank on the sorted window; matches latency_summary's
            # numpy percentile to within one sample
            idx = min(len(data) - 1, max(0, int(round(q * (len(data) - 1)))))
            out[q] = data[idx]
        return out

    def samples(self):
        qs = self.quantiles()
        with self._lock:
            s, c = self._sum, self._count
        rows = [(self.name, self.labels + (("quantile", "%g" % q),), qs[q])
                for q in _QUANTILES]
        rows.append((self.name + "_sum", self.labels, s))
        rows.append((self.name + "_count", self.labels, c))
        return rows


class Histogram(_Metric):
    """Prometheus histogram: cumulative ``_bucket{le="..."}`` counts over
    fixed bounds plus lifetime ``_sum`` / ``_count``.  Unlike Summary's
    windowed quantiles — which cannot be aggregated after the fact —
    bucket counts sum across processes and scrape intervals, which is
    what serving request latency needs once more than one serving
    process feeds a dashboard.  Bounds are configurable per metric and
    fixed at registration (the first caller wins, like ``help``)."""

    kind = "histogram"

    # seconds-scale defaults (Prometheus client convention); latency-in-ms
    # callers pass their own bounds
    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                       1.0, 2.5, 5.0, 10.0)

    def __init__(self, name, help, labels,
                 buckets: Optional[Iterable[float]] = None):
        super().__init__(name, help, labels)
        bounds = tuple(sorted(float(b) for b in
                              (buckets if buckets is not None
                               else self.DEFAULT_BUCKETS)))
        if not bounds:
            raise ValueError("histogram %r needs at least one bucket bound"
                             % name)
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)   # trailing +Inf bucket
        self._sum = 0.0

    @property
    def bounds(self) -> Tuple[float, ...]:
        return self._bounds

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            # le is inclusive: the first bound >= v owns the observation
            self._counts[bisect.bisect_left(self._bounds, v)] += 1
            self._sum += v

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self._counts)

    @property
    def total(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Estimate the ``q``-quantile from the bucket counts — the same
        linear-interpolation-within-the-owning-bucket estimate Prometheus'
        ``histogram_quantile`` makes (lower edge 0 for the first bucket;
        observations in the +Inf bucket clamp to the last finite bound).
        Coarse by construction, but aggregatable — unlike a windowed
        quantile — which is why serving's per-bucket latency view rides
        it (docs/Serving.md).

        Hardened edge cases (the serving p99 SLO gate in
        tools/load_test.py consumes this and must never see NaN/None):
        an empty histogram returns 0.0; a non-finite ``q`` raises instead
        of propagating NaN through the comparisons; observations that
        only ever landed in the first bucket interpolate within
        ``[0, bounds[0]]``; everything in the +Inf overflow bucket clamps
        to the last finite bound; a non-finite bucket bound clamps to the
        bucket's lower edge."""
        qf = float(q)
        if qf != qf or qf in (float("inf"), float("-inf")):
            raise ValueError("histogram quantile q must be finite, got %r"
                             % q)
        qf = min(max(qf, 0.0), 1.0)
        with self._lock:
            counts = list(self._counts)
        total = sum(counts)
        if total == 0:
            return 0.0
        rank = qf * total
        cum = 0.0
        lo = 0.0
        for bound, c in zip(self._bounds, counts):
            if c > 0 and cum + c >= rank:
                frac = min(max((rank - cum) / c, 0.0), 1.0)
                if bound - lo != bound - lo or bound == float("inf"):
                    return lo          # non-finite bound: clamp, not NaN
                return lo + (bound - lo) * frac
            cum += c
            lo = bound
        # every observation sits in the +Inf overflow bucket: the last
        # finite bound is the best (and only finite) answer
        return self._bounds[-1]

    def bucket_counts(self) -> Tuple[Tuple[float, ...], Tuple[int, ...]]:
        """``(bounds, per-bucket counts)`` copy — counts are NON-cumulative
        and the trailing entry is the +Inf overflow bucket.  The SLO
        engine reads bad-fractions from this."""
        with self._lock:
            return self._bounds, tuple(self._counts)

    def samples(self):
        with self._lock:
            counts = list(self._counts)
            s = self._sum
        rows = []
        cum = 0
        for bound, c in zip(self._bounds, counts):
            cum += c
            rows.append((self.name + "_bucket",
                         self.labels + (("le", "%g" % bound),), cum))
        cum += counts[-1]
        rows.append((self.name + "_bucket",
                     self.labels + (("le", "+Inf"),), cum))
        rows.append((self.name + "_sum", self.labels, s))
        rows.append((self.name + "_count", self.labels, cum))
        return rows


class MetricsRegistry:
    """Get-or-create registry over ``(name, labels)`` keyed metrics."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "summary": Summary,
              "histogram": Histogram}

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple, _Metric] = {}
        self._help: Dict[str, str] = {}
        # constant labels appended to EVERY exported sample (exposition
        # time only — call sites and stored metric keys never see them).
        # Distributed training sets process=<index>/host=<name> here so
        # per-process scrapes federate without relabeling; empty by
        # default, which keeps the exposition byte-stable.
        self._global_labels: Tuple[Tuple[str, str], ...] = ()

    def set_global_labels(self, labels: Optional[Dict[str, str]]) -> None:
        """Install constant labels injected into every exported sample
        (``prometheus_text`` and ``snapshot``).  Pass None/{} to clear."""
        with self._lock:
            self._global_labels = tuple(sorted(
                (str(k), str(v)) for k, v in (labels or {}).items()))

    def global_labels(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._global_labels)

    def _get(self, kind: str, name: str, help: str,
             labels: Optional[Dict[str, str]], **kw) -> _Metric:
        lbl = tuple(sorted((str(k), str(v))
                           for k, v in (labels or {}).items()))
        key = (name, lbl)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._KINDS[kind](name, help, lbl, **kw)
                self._metrics[key] = m
                self._help.setdefault(name, help)
            elif m.kind != kind:
                raise ValueError("metric %r already registered as %s, "
                                 "requested %s" % (name, m.kind, kind))
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get("gauge", name, help, labels)

    def summary(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None,
                window: int = 4096) -> Summary:
        return self._get("summary", name, help, labels, window=window)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        return self._get("histogram", name, help, labels, buckets=buckets)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    # ------------------------------------------------------------ export
    def collect(self):
        """Point-in-time sample gather: ``(global_labels, [(name, kind,
        help, [(sample_name, labels, value), ...]), ...])`` sorted by
        family name then label set.  Every lock (registry map, each
        metric's state) is released before this returns — serialization
        (Prometheus text, JSON) happens on the caller's time, never while
        a hot path waits to observe.  Both exposition routes and the
        StatsServer build their bodies from this."""
        with self._lock:
            extra = self._global_labels
        families: Dict[str, List[_Metric]] = {}
        for m in self.metrics():
            families.setdefault(m.name, []).append(m)
        out = []
        for name in sorted(families):
            group = families[name]
            rows = []
            for m in sorted(group, key=lambda m: m.labels):
                rows.extend(m.samples())
            out.append((name, group[0].kind, self._help.get(name, ""), rows))
        return extra, out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4.  Families sorted by
        name, series by label string — the output is deterministic for a
        given registry state (the golden test pins it)."""
        extra, families = self.collect()
        lines = []
        for name, kind, help_txt, rows in families:
            if help_txt:
                lines.append("# HELP %s %s" % (name, _escape_help(help_txt)))
            lines.append("# TYPE %s %s" % (name, kind))
            for sample_name, labels, value in rows:
                lines.append("%s%s %s"
                             % (sample_name, _label_suffix(labels, extra),
                                _fmt_value(value)))
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict:
        """Flat JSON view: ``name{k="v"}`` -> value (summaries expand to
        quantile/sum/count keys)."""
        extra, families = self.collect()
        out: Dict[str, float] = {}
        for _, _, _, rows in families:
            for sample_name, labels, value in rows:
                out[sample_name + _label_suffix(labels, extra)] = value
        return {"ts": round(time.time(), 3), "metrics": out}

    def write_jsonl(self, path_or_fh) -> Dict:
        """Append one snapshot as a JSON line; returns the snapshot."""
        snap = self.snapshot()
        line = json.dumps(snap, sort_keys=True) + "\n"
        if hasattr(path_or_fh, "write"):
            path_or_fh.write(line)
            path_or_fh.flush()
        else:
            with open(path_or_fh, "a") as fh:
                fh.write(line)
        return snap


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem shares."""
    return _REGISTRY
