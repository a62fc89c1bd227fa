"""Train/serve drift detection: data profiles, PSI/JS, DriftMonitor.

The port's own copy of ``lightgbm_tpu/obs/drift.py`` (numpy and threading
code), the part serving needs:

- ``DataProfile``: per-feature bin-occupancy histograms of the training
  data. Each profiled feature carries its full ``BinMapper`` dict, so the
  serving side bins raw request values through the exact training
  quantization (``values_to_bins``). JSON-serializable; a bundle reads it
  from the ``snap_N.meta.json`` beside a ``snap_N.model.txt``
  (``serving/registry.py`` ``_sibling_profile``). ``from_binned_dataset``
  builds it from a stored matrix and ``from_binned_chunks`` from a
  streamed dataset's chunks, the same counts; a checkpoint's meta carries
  it, so a bundle served from a snapshot has one, while a bundle of a bare
  model file or a booster carries none and reports ``no_profile``, as in
  the JAX package.
- ``psi`` / ``js_divergence``: the two distribution-shift scores over
  matched bin counts, epsilon-smoothed so empty bins never produce
  infinities.
- ``DecayedSketch``: an exponentially-decayed histogram of the model's
  score stream (edges anchored on the first observation window).
- ``DriftMonitor``: the serving-side accumulator. ``observe`` bins each
  predict batch's raw rows against the profile, ``evaluate`` exports
  ``lgbm_drift_*`` gauges, routes warn-only reports through
  ``HealthMonitor.note_drift`` past the ``obs_drift_warn_psi`` threshold,
  and fires ``on_drift`` hooks on every ok->warn transition.

No profile is always a legal state: every status surface returns an
explicit ``"no_profile"`` rather than warning or refusing.
"""
from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from ..log import Log
from .registry import MetricsRegistry, get_registry

PROFILE_VERSION = 1

# epsilon-smoothing for proportions: empty bins must not blow PSI/JS up
# to inf — the conventional small-floor treatment
_EPS = 1e-4


# --------------------------------------------------------------------------
# distribution-shift scores
# --------------------------------------------------------------------------
def _proportions(counts) -> np.ndarray:
    c = np.asarray(counts, np.float64).clip(min=0.0)
    p = c + _EPS
    return p / p.sum()


def psi(expected_counts, actual_counts) -> float:
    """Population Stability Index over matched bin counts.

    0 for identical distributions; conventional reading: < 0.1 stable,
    0.1-0.25 moderate shift, > 0.25 major shift (docs/Observability.md)."""
    p = _proportions(expected_counts)
    q = _proportions(actual_counts)
    return float(np.sum((q - p) * np.log(q / p)))


def js_divergence(expected_counts, actual_counts) -> float:
    """Jensen-Shannon divergence (natural log; bounded by ln 2)."""
    p = _proportions(expected_counts)
    q = _proportions(actual_counts)
    m = 0.5 * (p + q)
    kl = lambda a, b: float(np.sum(a * np.log(a / b)))  # noqa: E731
    return 0.5 * kl(p, m) + 0.5 * kl(q, m)


def psi_buckets(train_counts, k: int = 10) -> np.ndarray:
    """Fine-bin -> equal-mass-bucket aggregation map for PSI scoring.

    PSI over raw fine bins is dominated by sampling noise — for
    identical distributions its expectation is ~``(B-1) * (1/N_e +
    1/N_a)``, which at 255 bins swamps any real threshold.  The
    conventional remedy (and the industry convention for PSI) is ~10
    equal-population buckets of the REFERENCE distribution; this returns
    ``agg[fine_bin] -> bucket`` built from cumulative training mass.
    Features with <= k bins keep their bins 1:1."""
    c = np.asarray(train_counts, np.float64).clip(min=0.0)
    tot = c.sum()
    if tot <= 0 or len(c) <= k:
        return np.arange(len(c), dtype=np.int64)
    cum = np.cumsum(c) - c                     # train mass before each bin
    agg = np.minimum(np.floor(cum * k / tot).astype(np.int64), k - 1)
    _, agg = np.unique(agg, return_inverse=True)  # consecutive bucket ids
    return agg.astype(np.int64)


# --------------------------------------------------------------------------
# training data profile
# --------------------------------------------------------------------------
class DataProfile:
    """Per-feature bin-occupancy histograms of the training data.

    ``features`` is a list of dicts: ``index`` (ORIGINAL feature index),
    ``name``, ``mapper`` (the feature's ``BinMapper.to_dict()``) and
    ``counts`` (length ``num_bin`` occupancy of the training rows)."""

    def __init__(self, features: List[Dict], num_data: int = 0):
        self.features = features
        self.num_data = int(num_data)

    def __len__(self) -> int:
        return len(self.features)

    @staticmethod
    def _feature_entry(ds, i: int, mapper, counts) -> Dict:
        j = ds.real_feature_index(i)
        return {"index": int(j),
                "name": (ds.feature_names[j] if j < len(ds.feature_names)
                         else "Column_%d" % j),
                "mapper": mapper.to_dict(),
                "counts": [int(c) for c in counts]}

    @staticmethod
    def _feature_bins(ds, xb: np.ndarray, layout, i: int, mapper
                      ) -> np.ndarray:
        """Feature ``i``'s own bins in the stored matrix ``xb``: the EFB
        bundle offset and the joint-coded pair unpacked, anything outside
        the feature's range its default bin (``decode_bundle_value`` of
        the growers), so the counts are the histogram the grower sees."""
        feat_col, feat_offset, _bundled, pack_div, pack_mod, _ = layout
        v = xb[:, int(feat_col[i])].astype(np.int64)
        if int(pack_mod[i]) > 0:
            v = (v // max(int(pack_div[i]), 1)) % int(pack_mod[i])
        v = v - int(feat_offset[i])
        return np.where((v >= 0) & (v < mapper.num_bin), v,
                        mapper.default_bin)

    @classmethod
    def from_binned_dataset(cls, ds) -> "DataProfile":
        """Profile a ``BinnedDataset`` from its stored matrix, one bincount
        a feature (drift.py:118-142 of the JAX package)."""
        layout = ds.feature_layout()
        xb = np.asarray(ds.X_binned)
        feats = []
        for i in range(ds.num_features):
            m = ds.bin_mappers[ds.real_feature_index(i)]
            counts = np.bincount(cls._feature_bins(ds, xb, layout, i, m),
                                 minlength=m.num_bin)
            feats.append(cls._feature_entry(ds, i, m, counts))
        return cls(feats, num_data=int(ds.num_data))

    @classmethod
    def from_binned_chunks(cls, ds) -> "DataProfile":
        """Profile a ``StreamedDataset`` chunk by chunk. Bin counts add up
        over a partition of the rows, so the counts are those of
        ``from_binned_dataset`` on the concatenated matrix (drift.py:
        144-186 of the JAX package, one process)."""
        layout = ds.feature_layout()
        mappers = [ds.bin_mappers[ds.real_feature_index(i)]
                   for i in range(ds.num_features)]
        counts = [np.zeros(m.num_bin, np.int64) for m in mappers]
        for xb in ds.chunks:
            xb = np.asarray(xb)
            for i, m in enumerate(mappers):
                counts[i] += np.bincount(
                    cls._feature_bins(ds, xb, layout, i, m),
                    minlength=m.num_bin)
        return cls([cls._feature_entry(ds, i, m, c)
                    for i, (m, c) in enumerate(zip(mappers, counts))],
                   num_data=int(ds.num_data))

    # ----------------------------------------------------- serialization
    def to_json_dict(self) -> Dict:
        return {"version": PROFILE_VERSION, "num_data": self.num_data,
                "features": self.features}

    @classmethod
    def from_json_dict(cls, d: Optional[Dict]) -> Optional["DataProfile"]:
        """Tolerant inverse: None/malformed input -> None (pre-profile
        snapshots and model files must keep loading unchanged)."""
        if not isinstance(d, dict) or "features" not in d:
            return None
        try:
            feats = [dict(f) for f in d["features"]]
            return cls(feats, num_data=int(d.get("num_data", 0)))
        except Exception as e:  # noqa: BLE001 - corrupt profile != fatal
            Log.warning("drift: ignoring unreadable data profile (%s)" % e)
            return None


# --------------------------------------------------------------------------
# decayed score sketch
# --------------------------------------------------------------------------
class DecayedSketch:
    """Exponentially-decayed histogram + moments of a scalar stream.

    Edges anchor on the first ``anchor`` observations (serving score
    ranges are unknown until traffic arrives); after anchoring, each
    batch decays all prior mass by ``decay ** batch_rows`` so the sketch
    tracks the RECENT distribution."""

    def __init__(self, num_bins: int = 32, decay: float = 0.999,
                 anchor: int = 256):
        self.num_bins = int(num_bins)
        self.decay = float(decay)
        self._anchor = max(int(anchor), 2)
        self._seed: List[float] = []
        self.edges: Optional[np.ndarray] = None    # interior edges [B-1]
        self.counts: Optional[np.ndarray] = None   # decayed mass [B]
        self._sum = 0.0
        self._sumsq = 0.0
        self._weight = 0.0
        self.rows = 0

    def _anchor_edges(self) -> None:
        vals = np.asarray(self._seed, np.float64)
        lo, hi = float(vals.min()), float(vals.max())
        if hi <= lo:
            hi = lo + 1.0
        span = hi - lo
        # 10% margin: scores drifting slightly past the seed range should
        # land in edge bins, not all pile into the overflow slots
        self.edges = np.linspace(lo - 0.1 * span, hi + 0.1 * span,
                                 self.num_bins - 1)
        self.counts = np.zeros(self.num_bins, np.float64)
        self._seed = []
        self._add(vals)

    def _add(self, vals: np.ndarray) -> None:
        idx = np.searchsorted(self.edges, vals)
        np.add.at(self.counts, idx, 1.0)
        self._sum += float(vals.sum())
        self._sumsq += float((vals * vals).sum())
        self._weight += len(vals)

    def observe(self, values) -> None:
        vals = np.asarray(values, np.float64).ravel()
        vals = vals[np.isfinite(vals)]
        if not len(vals):
            return
        self.rows += len(vals)
        if self.edges is None:
            self._seed.extend(float(v) for v in vals)
            if len(self._seed) >= self._anchor:
                self._anchor_edges()
            return
        d = self.decay ** len(vals)
        self.counts *= d
        self._sum *= d
        self._sumsq *= d
        self._weight *= d
        self._add(vals)

    def summary(self) -> Dict:
        if self.edges is None:
            vals = np.asarray(self._seed, np.float64)
            mean = float(vals.mean()) if len(vals) else 0.0
            std = float(vals.std()) if len(vals) else 0.0
            return {"rows": self.rows, "anchored": False,
                    "mean": mean, "std": std}
        w = max(self._weight, 1e-12)
        mean = self._sum / w
        var = max(self._sumsq / w - mean * mean, 0.0)
        return {"rows": self.rows, "anchored": True,
                "mean": mean, "std": math.sqrt(var),
                "counts": [round(float(c), 3) for c in self.counts],
                "edges": [float(e) for e in self.edges]}


# --------------------------------------------------------------------------
# serving-side monitor
# --------------------------------------------------------------------------
class DriftMonitor:
    """Online train/serve drift scorer for one served model.

    ``observe(X)`` bins each predict batch's raw rows through the stored
    training quantization and accumulates per-feature occupancy;
    ``evaluate()`` (called automatically every ``eval_every`` observed
    rows) computes PSI/JS per feature against the training profile and
    exports ``lgbm_drift_*`` gauges.  Crossing ``warn_psi`` routes a
    warn-only report through ``HealthMonitor.note_drift`` and fires every
    ``on_drift`` subscriber once per ok->warn transition."""

    def __init__(self, profile: Optional[DataProfile], model_id: str = "",
                 warn_psi: float = 0.25, min_rows: int = 256,
                 decay: float = 0.999, eval_every: int = 256,
                 buckets: int = 10,
                 registry: Optional[MetricsRegistry] = None,
                 monitor=None, events=None):
        from ..io.binning import BinMapper
        self.profile = profile
        self.model_id = str(model_id)
        self.warn_psi = float(warn_psi)
        self.min_rows = int(min_rows)
        self.eval_every = max(int(eval_every), 1)
        self._lock = threading.Lock()
        self._reg = registry if registry is not None else get_registry()
        self._monitor = monitor
        self._events = events
        self._hooks: List[Callable] = []
        self._warned = False
        self.rows = 0
        self._rows_at_eval = 0
        self.scores = DecayedSketch(decay=decay)
        self._feats: List[Dict] = []
        if profile is not None:
            for f in profile.features:
                counts = np.asarray(f["counts"], np.float64)
                # PSI/JS score over equal-mass buckets of the TRAINING
                # distribution (see psi_buckets) — fine bins stay only as
                # the digitization alphabet
                agg = psi_buckets(counts, int(buckets))
                nb = int(agg.max()) + 1 if len(agg) else 1
                self._feats.append({
                    "index": int(f["index"]),
                    "name": str(f.get("name", "Column_%d" % f["index"])),
                    "mapper": BinMapper.from_dict(f["mapper"]),
                    "agg": agg,
                    "train": np.bincount(agg, weights=counts,
                                         minlength=nb),
                    "serve": np.zeros(nb, np.float64),
                    "psi": 0.0, "js": 0.0,
                })
        mlbl = {"model": self.model_id}
        self._g_rows = self._reg.gauge(
            "lgbm_drift_rows", "Rows observed by the drift monitor.", mlbl)
        self._g_psi_max = self._reg.gauge(
            "lgbm_drift_psi_max",
            "Largest per-feature PSI vs the training profile.", mlbl)
        self._g_score_mean = self._reg.gauge(
            "lgbm_drift_score_mean",
            "Decayed mean of the served score stream.", mlbl)
        self._feat_gauges: Dict[str, tuple] = {}

    # ------------------------------------------------------------ wiring
    @property
    def has_profile(self) -> bool:
        return self.profile is not None and len(self._feats) > 0

    def on_drift(self, hook: Callable) -> None:
        """Subscribe ``hook(report_dict)`` to ok->warn transitions — the
        refit-trigger seam (CheckpointWatcher.arm_drift_refit)."""
        self._hooks.append(hook)

    # ------------------------------------------------------------ ingest
    def observe(self, X, scores=None) -> None:
        """Fold one predict batch: ``X`` raw float rows [n, num_features]
        (the serving hot path's input), ``scores`` the model outputs."""
        if scores is not None:
            self.scores.observe(np.asarray(scores, np.float64))
        if not self.has_profile:
            return
        X = np.asarray(X)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        with self._lock:
            self.rows += X.shape[0]
            for f in self._feats:
                j = f["index"]
                if j >= X.shape[1]:
                    continue
                bins = f["mapper"].values_to_bins(
                    np.asarray(X[:, j], np.float64))
                bidx = f["agg"][np.clip(bins, 0, len(f["agg"]) - 1)]
                np.add.at(f["serve"], bidx, 1.0)
            due = self.rows - self._rows_at_eval >= self.eval_every
        if due:
            self.evaluate()

    # ------------------------------------------------------------ scoring
    def _feat_gauge(self, name: str):
        g = self._feat_gauges.get(name)
        if g is None:
            lbl = {"model": self.model_id, "feature": name}
            g = (self._reg.gauge(
                    "lgbm_drift_psi",
                    "Per-feature PSI of serving traffic vs the training "
                    "profile.", lbl),
                 self._reg.gauge(
                    "lgbm_drift_js",
                    "Per-feature Jensen-Shannon divergence vs the "
                    "training profile.", lbl))
            self._feat_gauges[name] = g
        return g

    def evaluate(self) -> Dict:
        """Score the accumulated occupancy, export gauges, route warns.
        Returns the status dict (same shape as ``status()``)."""
        if not self.has_profile:
            return self.status()
        with self._lock:
            self._rows_at_eval = self.rows
            enough = self.rows >= self.min_rows
            for f in self._feats:
                if f["serve"].sum() <= 0:
                    continue
                f["psi"] = psi(f["train"], f["serve"])
                f["js"] = js_divergence(f["train"], f["serve"])
            worst = max((f["psi"] for f in self._feats), default=0.0)
            feats = [(f["name"], f["psi"], f["js"]) for f in self._feats]
        self._g_rows.set(self.rows)
        self._g_psi_max.set(worst)
        sc = self.scores.summary()
        self._g_score_mean.set(sc.get("mean", 0.0))
        for name, p, j in feats:
            gp, gj = self._feat_gauge(name)
            gp.set(p)
            gj.set(j)
        if enough and worst >= self.warn_psi and not self._warned:
            self._warned = True
            self._fire(worst)
        elif self._warned and worst < 0.5 * self.warn_psi:
            # re-arm after clear recovery so a later second shift still
            # warns (half-threshold hysteresis avoids flapping)
            self._warned = False
        return self.status()

    def _fire(self, worst_psi: float) -> None:
        with self._lock:
            top = sorted(self._feats, key=lambda f: -f["psi"])[:3]
            names = ", ".join("%s=%.3f" % (f["name"], f["psi"])
                              for f in top)
        report = {"model": self.model_id, "max_psi": float(worst_psi),
                  "threshold": self.warn_psi, "rows": self.rows,
                  "top_features": names}
        if self._monitor is not None:
            try:
                self._monitor.note_drift(self.model_id, names,
                                         float(worst_psi), self.warn_psi,
                                         rows=self.rows)
            except Exception as e:  # noqa: BLE001
                Log.warning("drift: health routing failed: %s" % e)
        else:
            Log.warning(
                "drift: model %s serving traffic drifted from its training "
                "profile (max PSI %.3f >= %.3f over %d rows; %s)"
                % (self.model_id, worst_psi, self.warn_psi, self.rows,
                   names))
        if self._events is not None:
            try:
                self._events.write("drift", **report)
            except Exception:  # noqa: BLE001
                pass
        for hook in list(self._hooks):
            try:
                hook(report)
            except Exception as e:  # noqa: BLE001
                Log.warning("drift: on_drift hook failed: %s" % e)

    # ------------------------------------------------------------ export
    def status(self) -> Dict:
        """JSON view for the ``/drift`` routes and ``/healthz`` field."""
        if not self.has_profile:
            return {"status": "no_profile", "model": self.model_id,
                    "rows": self.rows,
                    "score_sketch": self.scores.summary()}
        with self._lock:
            worst = max((f["psi"] for f in self._feats), default=0.0)
            feats = {f["name"]: {"psi": round(f["psi"], 6),
                                 "js": round(f["js"], 6),
                                 "rows": int(f["serve"].sum())}
                     for f in self._feats}
        warn = self.rows >= self.min_rows and worst >= self.warn_psi
        return {"status": "warn" if warn else "ok",
                "model": self.model_id, "rows": self.rows,
                "max_psi": round(worst, 6), "warn_psi": self.warn_psi,
                "features": feats,
                "score_sketch": self.scores.summary()}


# --------------------------------------------------------------------------
# process-wide monitor registry (the /drift route's data source)
# --------------------------------------------------------------------------
_MONITORS: Dict[str, DriftMonitor] = {}
_MON_LOCK = threading.Lock()


def register_monitor(mon: DriftMonitor) -> DriftMonitor:
    """Publish a monitor under its model id so every stats surface
    (training StatsServer ``/drift``, serving ``/drift``) sees it."""
    with _MON_LOCK:
        _MONITORS[mon.model_id] = mon
    return mon


def unregister_monitor(model_id: str) -> None:
    with _MON_LOCK:
        _MONITORS.pop(str(model_id), None)


def get_monitor(model_id: str) -> Optional[DriftMonitor]:
    with _MON_LOCK:
        return _MONITORS.get(str(model_id))


def drift_snapshot() -> Dict:
    """Aggregate ``/drift`` body: every registered monitor's status plus
    the worst overall verdict (``warn`` > ``ok`` > ``no_profile``)."""
    with _MON_LOCK:
        mons = list(_MONITORS.values())
    models = {m.model_id: m.status() for m in mons}
    statuses = [s["status"] for s in models.values()]
    if "warn" in statuses:
        overall = "warn"
    elif "ok" in statuses:
        overall = "ok"
    else:
        overall = "no_profile"
    return {"status": overall, "models": models}
