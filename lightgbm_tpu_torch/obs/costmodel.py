"""Kernel cost accounting and roofline attribution against the card's peaks.

The port of ``lightgbm_tpu/obs/costmodel.py``. The JAX package reads each
compiled entry point's FLOPs and bytes from XLA's ``cost_analysis``. The
port's work on the card is its hand-written kernels, so each entry of
``CostModel`` is one kernel wrapper of ``core/kernels.py``, holding the
bytes and additions of its launches from the kernels' own counts:
``hist_bytes``, ``slot_hist_bytes`` and ``part_hist_bytes``, the counts
that the bounds of ``PERF.md`` and ``chip_smoke.py`` use. A launch adds
``n * F * K`` additions (each row's K values into its bin of each of F
columns). The slot and part kernels' active rows live on the card, so a
launch is charged every row it may read (all ``n`` rows, every tile):
their bytes per call are an upper bound, their utilization too.

Accounting discipline (the JAX package's pull-only rule):

- ``observability=none`` does no cost-model work at all: the kernel
  wrappers run exactly as without this module. ``TrainingObs`` turns
  accounting on under ``basic``/``full`` through
  ``core/kernels.py`` ``account_launches``, which swaps the libraries'
  loaders for ones that count each launch from its arguments.
- Nothing in the training loop reads the model: ``GET /roofline``,
  ``GBDT.extract_cost_model`` and the perf tools pull it.

The roofline joins these entries with span wall times: the training
loop's spans (``train_iter`` under ``full``, ``train_block`` under
``basic``) get an entry with the kernels' bytes and additions over the
span count, so their row says what share of the card's bandwidth the
iteration's kernels reach over its whole wall time.

The JAX package persists its extracted costs in ``costmodel_cache.json``
beside XLA's compile cache, to skip AOT compiles in a warm process. The
port compiles nothing per call and counts from launch arguments, so it
keeps no such file.

On the CPU there is no meaningful peak to normalize by, so rooflines
report achieved rates without a utilization ratio (``detect_peaks`` ->
None). This module imports torch only inside functions.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .registry import MetricsRegistry, get_registry

# ------------------------------------------------------------ card peaks
# Published peaks of NVIDIA's data sheets (dense rates, no sparsity, at the
# card's full power limit), not measurements. ``flops_per_s`` keeps the JAX
# package's meaning, the dense BF16 tensor-core peak; the float32 and
# float64 rates outside the tensor cores, which the port's histogram
# kernels' additions run at, have keys of their own.
CHIP_PEAKS: Dict[str, Dict[str, float]] = {
    "h100 80gb hbm3": {"flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12,
                       "f32_flops_per_s": 67e12, "f64_flops_per_s": 34e12},
    "h100 pcie": {"flops_per_s": 756e12, "hbm_bytes_per_s": 2.0e12,
                  "f32_flops_per_s": 51e12, "f64_flops_per_s": 26e12},
}


def normalize_device_kind(kind: str) -> str:
    """Lower-case a device name for matching against ``CHIP_PEAKS``
    ('NVIDIA H100 80GB HBM3' -> 'nvidia h100 80gb hbm3')."""
    return " ".join(str(kind or "").lower().split())


def detect_peaks(device_kind: Optional[str] = None
                 ) -> Optional[Dict[str, float]]:
    """Peaks of the card running this process (``torch.cuda.
    get_device_name``) or of an explicit ``device_kind`` name. None on the
    CPU and on an unknown card: a roofline there reports achieved rates
    only, never a utilization ratio against another card's peak."""
    if device_kind is None:
        try:
            import torch
            if not torch.cuda.is_available():
                return None
            device_kind = torch.cuda.get_device_name(0)
        except Exception:  # noqa: BLE001 - diagnostics must not raise
            return None
    kind = normalize_device_kind(device_kind)
    for key, peaks in CHIP_PEAKS.items():
        if key in kind:
            return dict(peaks)
    return None


class CostModel:
    """Per-process store of per-entry costs.

    ``record_launch(name, bytes, additions)`` adds one kernel launch to
    entry ``name`` (``core/kernels.py`` ``account_launches`` calls it);
    ``record(name, costs)`` sets an entry's per-call costs outright. Each
    entry's per-call costs are published as ``lgbm_costmodel_*{entry=}``
    gauges when it is read (``entries``), never on a launch."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        self._launches: Dict[str, List[float]] = {}  # [calls, bytes, adds]
        self._entries: Dict[str, Dict[str, float]] = {}

    def record_launch(self, name: str, nbytes: float,
                      additions: float) -> None:
        with self._lock:
            acc = self._launches.setdefault(name, [0.0, 0.0, 0.0])
            acc[0] += 1.0
            acc[1] += float(nbytes)
            acc[2] += float(additions)

    def record(self, name: str, costs: Dict[str, float]) -> None:
        """Register externally computed per-call costs under ``name``."""
        with self._lock:
            self._entries[name] = {k: float(v) for k, v in costs.items()}

    def launch_totals(self) -> Dict[str, Tuple[float, float, float]]:
        """{kernel: (launches, bytes, additions)} summed over every
        accounted launch."""
        with self._lock:
            return {k: tuple(v) for k, v in self._launches.items()}

    def entries(self) -> Dict[str, Dict[str, float]]:
        """Every entry's per-call ``flops`` (additions) and
        ``bytes_accessed``, plus ``calls`` for kernel entries."""
        with self._lock:
            out = {k: dict(v) for k, v in self._entries.items()}
            for name, (calls, nbytes, adds) in self._launches.items():
                out[name] = {"flops": adds / calls,
                             "bytes_accessed": nbytes / calls,
                             "calls": calls}
        for name, costs in out.items():
            self._publish(name, costs)
        return out

    def get(self, name: str) -> Optional[Dict[str, float]]:
        return self.entries().get(name)

    def _publish(self, name: str, costs: Dict[str, float]) -> None:
        lbl = {"entry": name}
        for field, metric, help_txt in (
                ("flops", "lgbm_costmodel_flops",
                 "Additions per call of this kernel (or per span of the "
                 "training loop)."),
                ("bytes_accessed", "lgbm_costmodel_bytes_accessed",
                 "Bytes a call must move: each input read once, each "
                 "output written once.")):
            if field in costs:
                self.registry.gauge(metric, help_txt,
                                    labels=lbl).set(costs[field])

    def clear(self) -> None:
        with self._lock:
            self._launches.clear()
            self._entries.clear()


_COSTMODEL = CostModel()


def get_cost_model() -> CostModel:
    """The process-wide cost model (as obs.registry's get_registry): the
    kernel accounting and every booster publish here, so one
    ``/roofline`` scrape sees every entry."""
    return _COSTMODEL


# ------------------------------------------------------------ roofline
def roofline_row(name: str, costs: Dict[str, float], seconds: float,
                 calls: float,
                 peaks: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """One per-phase attribution row: per-call costs x measured wall time
    -> achieved rates (+ utilization when peaks are known). ``seconds`` is
    total wall time over ``calls`` dispatches; rows with no timing
    (calls == 0) carry per-call costs only."""
    flops = float(costs.get("flops", 0.0))
    byts = float(costs.get("bytes_accessed", 0.0))
    row: Dict[str, Any] = {
        "phase": name,
        "calls": float(calls),
        "seconds": round(float(seconds), 6),
        "flops_per_call": flops,
        "bytes_per_call": byts,
    }
    if byts > 0:
        row["arithmetic_intensity"] = round(flops / byts, 6)
    if "peak_bytes" in costs:
        row["peak_bytes"] = float(costs["peak_bytes"])
    if seconds > 0 and calls > 0:
        row["flops_per_s"] = round(flops * calls / seconds, 3)
        row["bytes_per_s"] = round(byts * calls / seconds, 3)
        if peaks:
            pf = float(peaks.get("flops_per_s", 0.0))
            pb = float(peaks.get("hbm_bytes_per_s", 0.0))
            if pf > 0:
                row["mfu"] = round(row["flops_per_s"] / pf, 8)
            if pb > 0:
                row["membw_util"] = round(row["bytes_per_s"] / pb, 8)
            if pf > 0 and pb > 0 and byts > 0:
                # below the ridge point the phase cannot saturate the
                # arithmetic units no matter how well it is scheduled
                ridge = pf / pb
                row["bound"] = ("memory" if flops / byts < ridge
                                else "compute")
    return row


def roofline_table(wall_times: Dict[str, Tuple[float, float]],
                   cost_model: Optional[CostModel] = None,
                   peaks: Optional[Dict[str, float]] = None,
                   include_static_only: bool = True) -> List[Dict[str, Any]]:
    """Join the model's entries with ``{name: (seconds, calls)}`` wall
    times. Entries without a timing still appear (per-call costs only)
    unless ``include_static_only`` is False."""
    cm = cost_model if cost_model is not None else get_cost_model()
    rows = []
    for name, costs in sorted(cm.entries().items()):
        seconds, calls = wall_times.get(name, (0.0, 0.0))
        if calls <= 0 and not include_static_only:
            continue
        rows.append(roofline_row(name, costs, seconds, calls, peaks))
    return rows


def span_wall_times(registry: Optional[MetricsRegistry] = None,
                    metric: str = "lgbm_train_span_seconds"
                    ) -> Dict[str, Tuple[float, float]]:
    """Lifetime (sum_seconds, count) per span name from the tracer's
    summary series: the wall-time side of the roofline join for phases
    that run inside real training (train_iter, train_block)."""
    reg = registry if registry is not None else get_registry()
    out: Dict[str, Tuple[float, float]] = {}
    for m in reg.metrics():
        if m.name != metric or m.kind != "summary":
            continue
        span = m.label_dict.get("span")
        if not span:
            continue
        out[span] = (float(m.total), float(m.count))
    return out


# the training loop's spans that the kernels' launches run inside
TRAINING_SPANS = ("train_iter", "train_block")


def attribute_spans(wall: Dict[str, Tuple[float, float]],
                    cost_model: Optional[CostModel] = None) -> None:
    """Give each training span in ``wall`` an entry: every accounted
    kernel launch's bytes and additions over that span's count. Under one
    observability level only one of the spans runs, so the launches are
    those of its iterations."""
    cm = cost_model if cost_model is not None else get_cost_model()
    totals = cm.launch_totals()
    nbytes = sum(v[1] for v in totals.values())
    adds = sum(v[2] for v in totals.values())
    for name in TRAINING_SPANS:
        _, count = wall.get(name, (0.0, 0.0))
        if count > 0 and nbytes > 0:
            cm.record(name, {"flops": adds / count,
                             "bytes_accessed": nbytes / count})


def roofline_snapshot(registry: Optional[MetricsRegistry] = None,
                      cost_model: Optional[CostModel] = None,
                      extra_wall_times: Optional[
                          Dict[str, Tuple[float, float]]] = None
                      ) -> Dict[str, Any]:
    """The ``GET /roofline`` payload: detected peaks + one attribution
    row per entry, joined with whatever span wall-times the registry
    holds. Kernel entries have no wall time of their own (their per-call
    costs only) unless the caller supplies it through
    ``extra_wall_times`` (``{name: (seconds, calls)}``)."""
    peaks = detect_peaks()
    kind, backend = "", "cpu"
    try:
        import torch
        if torch.cuda.is_available():
            kind, backend = torch.cuda.get_device_name(0), "cuda"
    except Exception:  # noqa: BLE001 - scrape must answer regardless
        pass
    wall = span_wall_times(registry)
    attribute_spans(wall, cost_model)
    if extra_wall_times:
        wall.update(extra_wall_times)
    rows = roofline_table(wall, cost_model=cost_model, peaks=peaks)
    return {
        "ts": round(time.time(), 3),
        "backend": backend,
        "device_kind": kind,
        "peaks": peaks,      # None on the CPU: achieved rates only
        "rows": rows,
    }


def roofline_markdown(snapshot: Dict[str, Any]) -> str:
    """Render a roofline snapshot as a markdown table."""
    lines = ["| phase | calls | seconds | GFLOP/call | MB/call | "
             "GFLOP/s | GB/s | intensity | mfu | membw_util |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for r in snapshot.get("rows", []):
        def _g(key, scale, fmt="%.3f"):
            v = r.get(key)
            return (fmt % (v / scale)) if isinstance(v, (int, float)) else "-"
        lines.append("| %s | %d | %s | %s | %s | %s | %s | %s | %s | %s |" % (
            r.get("phase", "?"), int(r.get("calls", 0)),
            ("%.4f" % r["seconds"]) if r.get("seconds") else "-",
            _g("flops_per_call", 1e9), _g("bytes_per_call", 1e6),
            _g("flops_per_s", 1e9), _g("bytes_per_s", 1e9),
            ("%.4f" % r["arithmetic_intensity"])
            if "arithmetic_intensity" in r else "-",
            ("%.6f" % r["mfu"]) if "mfu" in r else "-",
            ("%.6f" % r["membw_util"]) if "membw_util" in r else "-"))
    if snapshot.get("peaks") is None:
        lines.append("")
        lines.append("_CPU backend: achieved rates only — no utilization "
                     "ratio is reported against a TPU peak._")
    return "\n".join(lines) + "\n"
