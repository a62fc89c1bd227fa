"""The port's training observability (``lightgbm_tpu_torch/obs/``) against
the JAX package's, on the CPU, each case on the same seeded inputs:

- the eval-metric export: after the same training, each registry holds the
  same ``lgbm_eval_metric`` series (the JAX engine attaches the export to
  every run; the port's did not);
- the health vector's semantics, NaN gradients from a custom objective
  under ``warn`` and ``raise`` (the reports' kinds and iterations, and the
  objective's calls), a stump that never escalates;
- the event files at ``basic`` and ``full``: each event kind's sequence of
  ``(event, iteration, count)`` and its field names, timings ignored (the
  JAX package's ``materialize`` span has no counterpart: the port's trees
  reach the host once each, and its ``model_iter`` records follow their
  iterations instead of the flush);
- the Prometheus exposition after the same training: the same families,
  types, HELP texts and label sets, equal iteration, row and stump counts;
- model statistics: gauges within 1e-5 of the JAX package's where the
  trees are equal (frontier, batched), ``importance`` equal to
  ``feature_importance``;
- the roofline functions on the same inputs, ``detect_peaks``; trace ids,
  headers and ``keep_decision``; ``SloEngine`` verdicts on one synthetic
  history; the flight recorder's ring and dump, read back by
  ``tools/merge_events.py``; the stats server's routes;
- the port's own seams: kernel launch accounting, the Perfetto window on
  the CPU, the crash path's dump on the exception, ``abort``'s snapshot,
  the checkpoint span and the streamed iteration's trace.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import importlib.util
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu import callback as jcallback
from lightgbm_tpu.obs import costmodel as jcost
from lightgbm_tpu.obs import health as jhealth
from lightgbm_tpu.obs import registry as jreg
from lightgbm_tpu.obs import reqtrace as jtrace
from lightgbm_tpu.obs import runtime as jrt
from lightgbm_tpu.obs import slo as jslo
from lightgbm_tpu.obs import server as jserver

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import callback as tcallback
from lightgbm_tpu_torch.core import kernels
from lightgbm_tpu_torch.obs import costmodel as tcost
from lightgbm_tpu_torch.obs import health as thealth
from lightgbm_tpu_torch.obs import registry as treg
from lightgbm_tpu_torch.obs import reqtrace as ttrace
from lightgbm_tpu_torch.obs import runtime as trt
from lightgbm_tpu_torch.obs import slo as tslo
from lightgbm_tpu_torch.obs import server as tserver
from lightgbm_tpu_torch.obs.distributed import FlightRecorder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = {"objective": "binary", "verbosity": -1, "num_leaves": 7,
        "min_data_in_leaf": 40}


def _data(n=1000, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(n, 5)
    return x, (x[:, 0] + 0.5 * r.randn(n) > 0).astype(np.float64)


@pytest.fixture
def registries(monkeypatch):
    """A fresh process registry for each package, so each holds only this
    test's series."""
    from lightgbm_tpu_torch.obs import modelstats as tms  # noqa: F401
    j, t = jreg.MetricsRegistry(), treg.MetricsRegistry()
    for mod, r in ((jreg, j), (jrt, j), (treg, t), (trt, t),
                   (tserver, t)):
        monkeypatch.setattr(mod, "get_registry", lambda r=r: r)
    return j, t


def _train_both(params, rounds, x, y, valid=None, jax_kw=None,
                port_kw=None):
    """(JAX booster, port booster) trained on the same data."""
    out = []
    for lgb, kw, extra in ((jlgb, {}, jax_kw), (tlgb, {"device": "cpu"},
                                                port_kw)):
        ds = lgb.Dataset(x, label=y, free_raw_data=False, **kw)
        args = dict(extra or {})
        if valid is not None:
            args["valid_sets"] = [ds.create_valid(valid[0], label=valid[1])]
        out.append(lgb.train(dict(params), ds, rounds, **args, **kw))
    return out


def _series(registry, name):
    """{labels: value} of the family ``name`` in the Prometheus text."""
    out = {}
    for line in registry.prometheus_text().splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


# ------------------------------------------------------------ step 0
def test_eval_metrics_are_exported_as_the_jax_package_does(registries):
    """The JAX engine attaches ``export_eval_metrics`` to every run
    (engine.py:174-178): after the same training both registries hold
    ``lgbm_eval_metric{dataset="valid_0",metric="auc"}`` at the last
    iteration's value."""
    jr, tr = registries
    x, y = _data(500)
    xv, yv = _data(300, seed=1)
    _train_both(dict(BASE, metric="auc"), 3, x, y, valid=(xv, yv))
    want = _series(jr, "lgbm_eval_metric")
    got = _series(tr, "lgbm_eval_metric")
    assert list(want) == ['lgbm_eval_metric{dataset="valid_0",'
                          'metric="auc"}']
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=0, atol=1e-9)
    assert isinstance(tcallback.export_eval_metrics(tr),
                      tcallback._ExportEvalMetrics)
    assert tcallback._ExportEvalMetrics.order == \
        jcallback._ExportEvalMetrics.order == 15
    assert tcallback._ExportEvalMetrics.only_consumes_evals


# ------------------------------------------------------------ health
def test_health_vec_semantics_equal_the_jax_package():
    import jax.numpy as jnp
    g = np.ones(16, np.float32)
    h = np.ones(16, np.float32)
    bad = g.copy()
    bad[3] = np.nan
    grower = np.asarray([[5.0, 0.0], [3.0, 1.0]], np.float32)
    for args in ((g, h, True, None), (bad, h, True, None),
                 (g, h, False, grower), (g, bad, True, grower)):
        want = np.asarray(jhealth.health_vec(
            jnp.asarray(args[0]), jnp.asarray(args[1]), jnp.bool_(args[2]),
            None if args[3] is None else jnp.asarray(args[3])))
        got = thealth.health_vec(
            torch.as_tensor(args[0]), torch.as_tensor(args[1]), args[2],
            None if args[3] is None else torch.as_tensor(args[3]))
        assert got.dtype == torch.float32 and got.shape == (4,)
        np.testing.assert_array_equal(got.numpy(), want)
    # a bool tensor works as the host bool does
    np.testing.assert_array_equal(
        thealth.health_vec(torch.as_tensor(g), torch.as_tensor(h),
                           torch.tensor(False)).numpy(), [0, 1, 0, 0])


def _nan_fobj(bad_iters, calls):
    """Logistic gradients, poisoned with NaN on ``bad_iters``; each call's
    index goes into ``calls`` (tests/test_obs.py's ``_nan_fobj``)."""
    def fobj(preds, dataset):
        it = len(calls)
        calls.append(it)
        y = dataset.get_label()
        p = 1.0 / (1.0 + np.exp(-preds))
        grad = (p - y).astype(np.float32)
        hess = np.maximum(p * (1 - p), 1e-3).astype(np.float32)
        if it in bad_iters:
            grad[::7] = np.nan
        return grad, hess
    return fobj


def _nan_run(lgb, kw, params, rounds, bad, callbacks=None):
    """(calls, (iteration, kind) of each report, the error or None)."""
    x, y = _data(400)
    calls, err, bst = [], None, None
    try:
        bst = lgb.train(dict(params), lgb.Dataset(x, label=y, **kw), rounds,
                        fobj=_nan_fobj(bad, calls), callbacks=callbacks,
                        **kw)
    except Exception as e:  # noqa: BLE001 - the raise case's result
        err = e
    reports = None
    if bst is not None:
        reports = [(r.iteration, r.kind) for r in bst._impl.obs.monitor.reports]
    return calls, reports, err, bst


def test_nan_gradients_raise_at_their_iteration(registries):
    """``raise`` under basic, config-driven (tests/test_obs.py:78): the
    poisoned iteration raises, the next never calls the objective."""
    params = dict(BASE, observability="basic", health_monitor="raise")
    out = [_nan_run(jlgb, {}, params, 6, {1}),
           _nan_run(tlgb, {"device": "cpu"}, params, 6, {1})]
    for calls, _, err, _ in out:
        assert calls == [0, 1]
        assert "training aborted by health monitor: non-finite " \
               "gradient/hessian at iteration 1" in str(err)
    assert type(out[1][2]).__name__ == type(out[0][2]).__name__


def test_nan_gradients_warn_and_the_run_goes_on(registries):
    """``warn`` from the callback: the poisoned iteration reports a stump
    and a non-finite gradient in both packages, training is not aborted,
    and both models keep the clean iterations before it. The JAX package
    keeps calling the objective after the stump (its stop is found on the
    device at the next flush, so its loop runs on, 4 calls, and reports
    the later iterations too); the port stops at the stump as LightGBM
    does (2 calls). With the poison at the last iteration the calls and
    the reports are the same."""
    runs = {}
    for lgb, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        for bad in ({1}, {3}):
            cb = (jcallback if lgb is jlgb else tcallback).health_monitor
            runs[lgb.__name__, min(bad)] = _nan_run(
                lgb, kw, BASE, 4, bad, callbacks=[cb("warn")])
    for bad in (1, 3):
        (jcalls, jrep, jerr, jbst), (tcalls, trep, terr, tbst) = (
            runs["lightgbm_tpu", bad], runs["lightgbm_tpu_torch", bad])
        assert jerr is None and terr is None
        assert trep == [r for r in jrep if r[0] <= bad] == [
            (bad, "zero_gain_wave"), (bad, "nonfinite_gradient")]
        assert tbst.current_iteration() == jbst.current_iteration == bad
    assert runs["lightgbm_tpu", 3][1] == runs["lightgbm_tpu_torch", 3][1]
    assert runs["lightgbm_tpu", 3][0] == runs["lightgbm_tpu_torch", 3][0] \
        == [0, 1, 2, 3]
    assert runs["lightgbm_tpu", 1][0] == [0, 1, 2, 3]
    assert runs["lightgbm_tpu_torch", 1][0] == [0, 1]


@pytest.mark.parametrize("action", ["raise", "abort", "warn"])
def test_a_stump_never_escalates(action):
    rows = np.asarray([[0.0, 1.0, 0.0, 2.0]])
    out = []
    for mod, reg in ((jhealth, jreg), (thealth, treg)):
        mon = mod.HealthMonitor(action=action, registry=reg.MetricsRegistry())
        out.append(([(r.iteration, r.kind)
                     for r in mon.check(rows, start_iter=7)],
                    mon.anomaly_count()))
    assert out[0] == out[1] == ([(7, "zero_gain_wave")], 0)


def test_the_monitors_notes_equal_the_jax_package(tmp_path):
    out = []
    for mod, reg, name in ((jhealth, jreg, "j"), (thealth, treg, "t")):
        r = reg.MetricsRegistry()
        mon = mod.HealthMonitor(action="raise", registry=r)
        notes = [mon.note_straggler(3, 1, 2.5, 2.0),
                 mon.note_drift("m", "f0", 0.4, 0.25, rows=300),
                 mon.note_slo_burn("serve_p99", 3.0, 2.5, 0.2, 0.99,
                                   kind="latency")]
        fams = {line.split()[2]: line for line in
                r.prometheus_text().splitlines()
                if line.startswith("# HELP")}
        out.append(([(n.iteration, n.kind, n.message) for n in notes],
                    fams))
    assert out[0] == out[1]


# ------------------------------------------------------------ events
def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _by_kind(records):
    """{event kind: [(iteration, count, sorted field names)]}, timing
    values ignored, the JAX package's ``materialize`` span left out."""
    out = {}
    for r in records:
        kind = r["event"] if r["event"] != "span" else "span:" + r["span"]
        if kind == "span:materialize":
            continue
        out.setdefault(kind, []).append(
            (r.get("iteration", r.get("start_iter")), r.get("count"),
             tuple(sorted(k for k in r if k not in ("ts", "seq")))))
    return out


@pytest.fixture(scope="module")
def observed_runs(tmp_path_factory):
    """Both packages trained at basic and full with an event file and
    model statistics (frontier growth), each in fresh registries:
    {level: (JAX booster, port booster, JAX records, port records, JAX
    registry, port registry)}."""
    x, y = _data(1000)
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for level in ("basic", "full"):
            regs = jreg.MetricsRegistry(), treg.MetricsRegistry()
            for mod, r in ((jreg, regs[0]), (jrt, regs[0]),
                           (treg, regs[1]), (trt, regs[1])):
                mp.setattr(mod, "get_registry", lambda r=r: r)
            paths = [str(tmp_path_factory.mktemp(level) / ("%s.jsonl" % p))
                     for p in ("jax", "port")]
            bsts = []
            for lgb, kw, path in ((jlgb, {}, paths[0]),
                                  (tlgb, {"device": "cpu"}, paths[1])):
                params = dict(BASE, tree_growth="frontier",
                              observability=level, obs_event_file=path,
                              obs_modelstats=True)
                bsts.append(lgb.train(params, lgb.Dataset(x, label=y, **kw),
                                      4, **kw))
            out[level] = (bsts[0], bsts[1], _records(paths[0]),
                          _records(paths[1]), regs[0], regs[1])
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("level", ["basic", "full"])
def test_event_files_match_the_jax_package(observed_runs, level):
    _, _, jrec, trec, _, _ = observed_runs[level]
    want, got = _by_kind(jrec), _by_kind(trec)
    assert set(got) == set(want)
    for kind in want:
        if kind == "train_done":   # the process-wide iteration counter
            assert [r[2] for r in got[kind]] == [r[2] for r in want[kind]]
            continue
        assert got[kind] == want[kind], kind
    dispatch = "block" if level == "basic" else "iteration"
    assert [r[:2] for r in got[dispatch]] == (
        [(0, 4)] if level == "basic" else [(i, 1) for i in range(4)])
    assert [r["iteration"] for r in trec if r["event"] == "model_iter"] == \
        [0, 1, 2, 3]


def _families(registry, prefixes=("lgbm_train_", "lgbm_model_")):
    """{family: (type, help, sorted label-key sets)} of the exposition."""
    fams = {}
    for line in registry.prometheus_text().splitlines():
        if line.startswith("# HELP "):
            name, help_text = line[7:].split(" ", 1)
            fams.setdefault(name, [None, help_text, set()])[1] = help_text
        elif line.startswith("# TYPE "):
            name, kind = line[7:].split(" ", 1)
            fams.setdefault(name, [None, None, set()])[0] = kind
        elif line and not line.startswith("#"):
            head = line.rsplit(" ", 1)[0]
            name = head.split("{")[0]
            keys = ()
            if "{" in head:
                keys = tuple(sorted(kv.split("=")[0] for kv in
                                    head[head.index("{") + 1:-1].split(",")
                                    if kv.split("=")[0] != "quantile"))
            for suffix in ("_sum", "_count"):
                if name.endswith(suffix) and name[:-len(suffix)] in fams:
                    name = name[:-len(suffix)]
            if name in fams:
                fams[name][2].add(keys)
    return {k: (v[0], v[1], sorted(v[2])) for k, v in fams.items()
            if k.startswith(prefixes)}


@pytest.mark.parametrize("level", ["basic", "full"])
def test_prometheus_exposition_matches_the_jax_package(observed_runs,
                                                       level):
    _, _, _, _, jr, tr = observed_runs[level]
    assert _families(tr) == _families(jr)
    for name in ("lgbm_train_iterations_total", "lgbm_train_rows_total",
                 "lgbm_train_stump_iterations_total",
                 "lgbm_train_health_anomalies_total",
                 "lgbm_train_frontier_waves_last", "lgbm_model_trees"):
        assert _series(tr, name) == _series(jr, name), name


def _model_gauges(registry):
    out = {}
    for name in ("lgbm_model_split_count", "lgbm_model_gain_total",
                 "lgbm_model_gain_max", "lgbm_model_gain_mass",
                 "lgbm_model_trees", "lgbm_model_new_leaves_last",
                 "lgbm_model_leaf_depth_sum", "lgbm_model_leaf_value_sum"):
        out.update(_series(registry, name))
    return out


def _same_trees(jbst, tbst):
    for jt, tt in zip(jbst._impl.models, tbst._impl.models):
        n = tt.num_leaves_actual - 1
        assert int(jt.num_leaves_actual) == n + 1
        np.testing.assert_array_equal(np.asarray(jt.split_feature)[:n],
                                      tt.split_feature[:n])


@pytest.mark.parametrize("growth", ["frontier", "batched"])
def test_model_statistics_match_the_jax_package(observed_runs, growth,
                                                registries):
    if growth == "frontier":
        jbst, tbst, _, _, jr, tr = observed_runs["basic"]
    else:
        jr, tr = registries
        x, y = _data(1000)
        jbst, tbst = _train_both(dict(BASE, tree_growth="batched",
                                      observability="basic",
                                      obs_modelstats=True), 4, x, y)
    _same_trees(jbst, tbst)
    want, got = _model_gauges(jr), _model_gauges(tr)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    stats = tbst._impl._modelstats
    for kind in ("split", "gain"):
        np.testing.assert_array_equal(stats.importance(kind),
                                      tbst.feature_importance(kind))


# ------------------------------------------------------------ cost model
ROOFLINE_COSTS = {"train_block": {"flops": 2.5e9, "bytes_accessed": 3.1e8,
                                  "peak_bytes": 1.2e9},
                  "hist": {"flops": 4e6, "bytes_accessed": 8e7},
                  "static": {"bytes_accessed": 5e5}}
ROOFLINE_WALL = {"train_block": (1.75, 7.0), "hist": (0.01, 40.0)}


@pytest.mark.parametrize("peaks", [None, "h100"])
def test_roofline_functions_equal_the_jax_package(peaks):
    pk = tcost.CHIP_PEAKS["h100 80gb hbm3"] if peaks else None
    rows = {}
    for mod in (jcost, tcost):
        cm = mod.CostModel(registry=(jreg if mod is jcost else treg)
                           .MetricsRegistry())
        for name, costs in ROOFLINE_COSTS.items():
            cm.record(name, costs)
        table = mod.roofline_table(ROOFLINE_WALL, cost_model=cm, peaks=pk)
        snap = {"rows": table, "peaks": pk}
        rows[mod.__name__] = (
            [mod.roofline_row(n, c, *ROOFLINE_WALL.get(n, (0.0, 0.0)),
                              peaks=pk) for n, c in ROOFLINE_COSTS.items()],
            table, mod.roofline_markdown(snap))
    assert rows["lightgbm_tpu_torch.obs.costmodel"] == \
        rows["lightgbm_tpu.obs.costmodel"]


def test_detect_peaks_knows_the_h100():
    sxm = tcost.detect_peaks("NVIDIA H100 80GB HBM3")
    assert sxm == {"flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12,
                   "f32_flops_per_s": 67e12, "f64_flops_per_s": 34e12}
    assert tcost.detect_peaks("NVIDIA H100 PCIe")["hbm_bytes_per_s"] == 2e12
    assert tcost.detect_peaks("cpu") is None
    assert tcost.detect_peaks() is None        # no card here


class _FakeLib:
    """Stands in for a loaded kernel library: records launch arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("lgbt_") and name.endswith("_launch"):
            return lambda *args: self.calls.append((name, args)) or 0
        raise AttributeError(name)


def test_launch_accounting_counts_the_kernels_own_bytes(monkeypatch):
    """``account_launches`` swaps the loaders for counting ones and puts
    them back; each launch is charged the kernels' own byte counts."""
    fakes = {name: _FakeLib() for name in kernels._ACCOUNTED}
    for name, fake in fakes.items():
        monkeypatch.setattr(kernels, name, lambda fake=fake: fake)
    originals = {name: getattr(kernels, name) for name in kernels._ACCOUNTED}
    cm = tcost.CostModel(registry=treg.MetricsRegistry())
    stop = kernels.account_launches(cm)
    assert kernels.account_launches(cm)() is None      # nested: a no-op
    # histogram.cu at 1,000 rows, 28 columns, 255 bins, K=3, f32
    kernels._hist_lib().lgbt_hist_launch(0, 0, 0, 1000, 28, 28, 255, 3, 0)
    kernels._hist_lib().lgbt_hist_launch(0, 0, 0, 1000, 28, 28, 255, 3, 1)
    kernels._slots_lib().lgbt_hist_slots_launch(0, 0, 0, 0, 0, 0, 1000, 28,
                                                28, 255, 4, 3)
    kernels._part_lib().lgbt_hist_part_launch(0, 0, 0, 0, 0, 0, 4096, 28,
                                              255, 2, 2048, 2)
    stop()
    assert {n: getattr(kernels, n) for n in kernels._ACCOUNTED} == originals
    kernels._hist_lib().lgbt_hist_launch(0, 0, 0, 1, 1, 1, 1, 3, 0)
    totals = cm.launch_totals()
    assert totals == {
        "histogram.cu": (2.0, float(kernels.hist_bytes(1000, 28, 255, 3, 4)
                                    + kernels.hist_bytes(1000, 28, 255, 3,
                                                         8)),
                         2.0 * 1000 * 28 * 3),
        "hist_slots.cu": (1.0, float(kernels.slot_hist_bytes(
            1000, 1000, 28, 255, 3, 4, 28)), 1000.0 * 28 * 3),
        "hist_part.cu": (1.0, float(kernels.part_hist_bytes(
            2, 2, 2048, 28, 255, 2)), 4096.0 * 28 * 6)}
    assert len(fakes["_hist_lib"].calls) == 3
    entries = cm.entries()
    assert entries["histogram.cu"]["calls"] == 2.0
    wall = {"train_iter": (0.5, 4.0)}
    tcost.attribute_spans(wall, cm)
    assert cm.get("train_iter")["bytes_accessed"] == \
        sum(v[1] for v in totals.values()) / 4.0


def test_observability_off_does_no_cost_work():
    before = {n: getattr(kernels, n) for n in kernels._ACCOUNTED}
    x, y = _data(400)
    bst = tlgb.train(dict(BASE), tlgb.Dataset(x, label=y, device="cpu"), 2,
                     device="cpu")
    assert bst._impl.obs.level == 0 and bst._impl.obs.monitor is None
    assert bst._impl.extract_cost_model() == {}
    assert {n: getattr(kernels, n) for n in kernels._ACCOUNTED} == before


# ------------------------------------------------------------ tracing
def test_trace_ids_and_headers_agree_with_the_jax_package():
    ids = ["%016x" % (i * 0x9E3779B97F4A7C15 & 0xFFFFFFFFFFFFFFFF)
           for i in range(1000)]
    for sample in (0.0, 0.01, 0.3, 1.0):
        for seed in (0, 7):
            assert [ttrace.keep_decision(t, sample, seed) for t in ids] == \
                [jtrace.keep_decision(t, sample, seed) for t in ids]
    for value in ("00ab12", "00AB12-ff01", "abc-", "zz", "", None,
                  "a" * 33, "a-" + "b" * 33):
        assert ttrace.parse_trace_header(value) == \
            jtrace.parse_trace_header(value)
    jspan = jtrace.RequestTracer(registry=jreg.MetricsRegistry()) \
        .start_trace("request")
    tspan = ttrace.RequestTracer(registry=treg.MetricsRegistry()) \
        .start_trace("request")
    assert ttrace.parse_trace_header(jtrace.format_trace_header(jspan)) == \
        (jspan.trace_id, jspan.span_id)
    assert jtrace.parse_trace_header(ttrace.format_trace_header(tspan)) == \
        (tspan.trace_id, tspan.span_id)
    assert ttrace.TRACE_HEADER == jtrace.TRACE_HEADER


def test_slo_verdicts_equal_the_jax_package():
    """The same synthetic history through both engines: latency,
    availability and throughput SLOs, ticked at explicit times."""
    out = []
    for slo_mod, reg_mod in ((jslo, jreg), (tslo, treg)):
        reg = reg_mod.MetricsRegistry()
        hist = reg.histogram("lat_ms", "Latency.")
        good = reg.counter("req_total", "Requests.")
        bad = reg.counter("err_total", "Errors.")
        rows = reg.counter("rows_total", "Rows.")
        eng = slo_mod.SloEngine(registry=reg, fast_window_s=10.0,
                                slow_window_s=60.0, burn_warn=2.0,
                                time_fn=lambda: 0.0)
        eng.add_latency_slo("p99", "lat_ms", threshold_ms=5.0,
                            objective=0.99)
        eng.add_availability_slo("avail", "req_total", ["err_total"],
                                 objective=0.999)
        eng.add_throughput_slo("tput", "rows_total", 1000.0)
        verdicts = []
        for t in range(0, 40, 2):
            for i in range(20):
                hist.observe(1.0 if t < 20 or i % 3 else 50.0)
            good.inc(20)
            if t >= 24:
                bad.inc(1)
            rows.inc(5000 if t < 6 else 100)
            eng.tick(now=float(t))
            status = eng.evaluate(now=float(t))
            verdicts.append({k: (v["burning"], v["fast_burn"],
                                 v["slow_burn"], v["observed"])
                             for k, v in status["slos"].items()})
        out.append(verdicts)
    assert out[0] == out[1]
    assert any(v["p99"][0] for v in out[1]) and any(v["tput"][0]
                                                    for v in out[1])


def _merge_events():
    spec = importlib.util.spec_from_file_location(
        "merge_events", os.path.join(ROOT, "tools", "merge_events.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flight_recorder_ring_and_dump(tmp_path):
    """The ring keeps the newest ``size`` records; the dump's header and
    records read back through the JAX package's ``tools/merge_events.py``;
    only the first dump wins."""
    from lightgbm_tpu.obs.distributed import FlightRecorder as JFlight
    dumps = []
    for cls, name in ((JFlight, "jax"), (FlightRecorder, "port")):
        rec = cls(str(tmp_path / name), size=4)
        for i in range(10):
            rec.record("iteration", iteration=i)
        assert len(rec) == 4
        path = rec.dump("health:nonfinite_gradient")
        assert path == str(tmp_path / name) + ".0.crash.jsonl"
        rec.record("iteration", iteration=10)
        assert rec.dump("sigterm") == path      # latched
        dumps.append([{k: v for k, v in r.items() if k not in ("ts",
                                                               "stream")}
                      for r in _merge_events().merge([path])])
    assert dumps[0] == dumps[1]
    assert dumps[1][0] == {"event": "flight_recorder_dump",
                           "reason": "health:nonfinite_gradient",
                           "process": 0, "entries": 4}
    assert [r["iteration"] for r in dumps[1][1:]] == [6, 7, 8, 9]


def test_a_crash_in_training_carries_the_flight_dump(tmp_path):
    """The engine's crash path: a fault at iteration 2 fsyncs the event
    stream and dumps the recorder, whose path rides the exception."""
    x, y = _data(400)
    ev = str(tmp_path / "ev.jsonl")
    with pytest.raises(Exception) as err:
        tlgb.train(dict(BASE, observability="full", obs_event_file=ev,
                        obs_flight_recorder=8, fault_inject="crash@iter:2"),
                   tlgb.Dataset(x, label=y, device="cpu"), 4, device="cpu")
    dump = err.value.flight_dump_path
    assert dump == ev + ".0.crash.jsonl"
    recs = _records(dump)
    assert recs[0]["reason"].startswith("train-exception")
    assert [r["iteration"] for r in recs
            if r["event"] == "iteration"] == [0, 1]
    from lightgbm_tpu_torch.resilience import faults
    faults.clear_plan()


def test_abort_saves_a_snapshot_then_raises(tmp_path):
    x, y = _data(400)
    calls = []
    ckpt = str(tmp_path / "ckpt")
    ev = str(tmp_path / "ev.jsonl")
    with pytest.raises(tlgb.basic.LightGBMError, match="health monitor"):
        tlgb.train(dict(BASE, observability="full", health_monitor="abort",
                        obs_event_file=ev, checkpoint_dir=ckpt,
                        checkpoint_period=100),
                   tlgb.Dataset(x, label=y, device="cpu"), 4,
                   fobj=_nan_fobj({2}, calls), device="cpu")
    assert calls == [0, 1, 2]
    from lightgbm_tpu_torch.checkpoint import load_latest
    assert load_latest(ckpt) is not None
    dump = _records(ev + ".0.crash.jsonl")
    assert dump[0]["reason"] == "health:nonfinite_gradient"
    assert any(r["event"] == "health" for r in dump)


def test_perfetto_window_writes_a_chrome_trace(tmp_path):
    x, y = _data(400)
    out = tmp_path / "perfetto"
    tlgb.train(dict(BASE, observability="full", obs_perfetto_dir=str(out),
                    obs_perfetto_start=1, obs_perfetto_iters=2),
               tlgb.Dataset(x, label=y, device="cpu"), 4, device="cpu")
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(out / files[0]) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("train_iter") == 2


def test_checkpoint_saves_run_in_a_span(tmp_path, registries):
    _, tr = registries
    x, y = _data(400)
    tlgb.train(dict(BASE, observability="basic",
                    checkpoint_dir=str(tmp_path / "ck")),
               tlgb.Dataset(x, label=y, device="cpu"), 3, device="cpu")
    spans = _series(tr, "lgbm_train_span_seconds_count")
    assert spans['lgbm_train_span_seconds_count{span="checkpoint_save"}'] \
        == 3
    assert spans['lgbm_train_span_seconds_count{span="train_iter"}'] == 3


def test_a_streamed_iteration_is_traced(tmp_path):
    """The streamed path's trace: one root an iteration, a ``tree`` child
    a class, under it a sweep child: the root's, then each wave's."""
    x, y = _data(1000)
    ev = str(tmp_path / "ev.jsonl")
    params = dict(BASE, tree_growth="frontier", data_stream_chunk_rows=400,
                  observability="full", obs_trace=True, obs_trace_sample=1.0,
                  obs_event_file=ev)
    bst = tlgb.train(params, tlgb.Dataset(x, label=y, params=params,
                                          device="cpu"), 2, device="cpu")
    trees = _merge_events().build_span_trees(_records(ev))
    assert len(trees) == 2
    waves = bst._impl._grow.waves
    names = sorted(s["name"] for t in trees.values() for s in t["spans"])
    assert names.count("train_iter") == 2 and names.count("tree") == 2
    assert names.count("root_sweep") == 2 and names.count("wave") == waves
    for t in trees.values():
        assert len(t["roots"]) == 1 and not t["orphans"]


# ------------------------------------------------------------ stats server
def _get(port, path):
    with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                timeout=30) as resp:
        body = resp.read()
    return json.loads(body) if path != "/metrics" and \
        not path.startswith("/metrics") else body.decode()


def test_stats_server_routes_answer_as_the_jax_packages():
    servers = [jserver.StatsServer(0, registry=jreg.MetricsRegistry()),
               tserver.StatsServer(0, registry=treg.MetricsRegistry())]
    try:
        for s in servers:
            s.start()
        keys = []
        for s in servers:
            got = {}
            for path in ("/stats", "/healthz", "/slo", "/drift",
                         "/stats/cluster", "/roofline"):
                got[path] = sorted(_get(s.port, path))
            got["/metrics"] = "lgbm_train_health_anomalies_total 0" in \
                _get(s.port, "/metrics")
            keys.append(got)
        assert keys[0] == keys[1]
    finally:
        for s in servers:
            s.stop()


def test_training_stats_port_serves_the_run(registries):
    _, tr = registries
    x, y = _data(400)
    bst = tlgb.train(dict(BASE, observability="basic", obs_stats_port=0,
                          train_slo_rows_per_sec=1.0),
                     tlgb.Dataset(x, label=y, device="cpu"), 3,
                     device="cpu")
    stats = bst._impl.obs.stats
    try:
        text = _get(stats.port, "/metrics")
        assert "lgbm_train_iterations_total 3" in text
        assert list(_get(stats.port, "/slo")["slos"]) == ["train_throughput"]
        assert _get(stats.port, "/healthz") == {"status": "ok",
                                                "anomalies": 0}
        roof = _get(stats.port, "/roofline")
        assert roof["peaks"] is None and roof["backend"] == "cpu"
    finally:
        stats.stop()


def test_the_obs_package_exports_the_jax_packages_names():
    """Every name the JAX package's ``obs`` exports resolves on the port's,
    but ``DistributedObs`` (several processes, ROADMAP Queue 1 #13)."""
    import lightgbm_tpu.obs as jobs
    import lightgbm_tpu_torch.obs as tobs
    names = {n for n in dir(jobs) if not n.startswith("_")
             and not isinstance(getattr(jobs, n), type(jobs))}
    missing = sorted(n for n in names - {"DistributedObs"}
                     if not hasattr(tobs, n))
    assert missing == []


def test_a_busy_stats_port_falls_back_to_a_free_one():
    import socket
    busy = socket.socket()
    busy.bind(("127.0.0.1", 0))
    busy.listen(1)
    try:
        port = busy.getsockname()[1]
        server = tserver.StatsServer(port, registry=treg.MetricsRegistry())
        try:
            assert server.port not in (0, port)
            server.start()
            assert _get(server.port, "/healthz")["status"] == "ok"
        finally:
            server.stop()
    finally:
        busy.close()
