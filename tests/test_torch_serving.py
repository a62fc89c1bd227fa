"""The serving path (ROADMAP Queue 1 #10) in the port, against its own
``Booster.predict`` and the JAX package's serving, on the CPU
(``device="cpu"``; on the card each predictor entry is a CUDA graph,
``tests/test_torch_kernels_cuda.py``):

- the bucket ladder, and the engine's power-of-two normalization;
- the four golden model texts served by both packages: the port's
  responses are its ``predict`` bit for bit (raw and transformed, padded,
  exact and chunked sizes, ``num_iteration``), and within 1e-6 of the JAX
  package's except at a row that a tree sends the other way when compared
  in float32 (the JAX server casts requests to float32);
- a trained booster through ``as_serving_bundle``, warmup with no cache
  miss after it, the hot roll to a staged generation and the cascade
  retune;
- the micro-batch queue (coalescing, each caller its rows, error
  delivery, shedding), the metrics snapshot and its JSON lines,
  ``latency_summary``, the registry, drift monitors against the JAX
  package's on one profile, the HTTP routes on 127.0.0.1, stdin, and
  ``python -m lightgbm_tpu_torch task=serve device_type=cpu`` in a
  subprocess.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from chip_smoke import bench_data
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.log import LightGBMError, OverloadedError
from lightgbm_tpu_torch.serving import (MicroBatchQueue, ModelRegistry,
                                        ServingEngine, ServingMetrics,
                                        build_app, bucket_rows, bucket_sizes,
                                        latency_summary, make_server,
                                        serve_stdin)
from test_torch_traversal import assert_jax_close, f32_flips

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
GOLDEN_MODELS = ["model_ref.txt", "multiclass_model_ref.txt",
                 "rank_model_ref.txt", "regression_model_ref.txt"]
_BOOSTER = {}


def _booster():
    """(rows, a port booster of 10 rounds on bench.py's features),
    trained once."""
    if not _BOOSTER:
        x, y = bench_data(3000)
        _BOOSTER["b"] = (x, tlgb.train(
            {"objective": "binary", "num_leaves": 15, "max_bin": 63,
             "min_data_in_leaf": 40, "verbosity": -1},
            tlgb.Dataset(x, label=y, device="cpu"), num_boost_round=10,
            device="cpu"))
    return _BOOSTER["b"]


def _engine(**kw):
    return ServingEngine(device="cpu", **kw)


# --------------------------------------------------------------- bucketing
def test_bucket_rows_ladder():
    assert bucket_rows(1) == 16
    assert bucket_rows(16) == 16
    assert bucket_rows(17) == 32
    assert bucket_rows(100) == 128
    assert bucket_rows(4096) == 4096
    assert bucket_rows(5000) == 4096     # capped (engine chunks the rest)
    assert bucket_rows(3, min_bucket=1) == 4
    with pytest.raises(LightGBMError):
        bucket_rows(0)
    assert bucket_sizes(16, 4096) == [16, 32, 64, 128, 256, 512, 1024,
                                      2048, 4096]
    assert bucket_sizes(64, 64) == [64]
    eng = _engine(max_batch=1000, min_bucket=10)
    assert eng.min_bucket == 16 and eng.max_batch == 1024


# ----------------------------------------------------------- golden parity
@pytest.mark.parametrize("model_file", GOLDEN_MODELS)
def test_golden_models_served_as_predict_and_as_jax(model_file):
    path = os.path.join(GOLDEN, model_file)
    tb = tlgb.Booster(model_file=path, device="cpu")
    nf = tb.num_feature()
    eng = _engine(max_batch=64, min_bucket=16)
    eng.registry.load_file("m", path)
    jeng = jlgb.serving.ServingEngine(max_batch=64, min_bucket=16)
    jeng.registry.load_file("m", path)
    rng = np.random.RandomState(3)
    for n in (1, 16, 17, 100):             # padded, exact, padded, chunked
        x = rng.rand(n, nf) * 2
        flips = f32_flips(tb.models, x)
        for raw in (False, True):
            got = eng.predict("m", x, raw_score=raw)
            np.testing.assert_array_equal(got, tb.predict(x, raw_score=raw))
            assert_jax_close(got, jeng.predict("m", x, raw_score=raw), flips)
    x = rng.rand(20, nf)
    for ni in (1, 3):
        np.testing.assert_array_equal(eng.predict("m", x, num_iteration=ni),
                                      tb.predict(x, num_iteration=ni))


# --------------------------------------------------------- in-process path
def test_trained_booster_served_in_process():
    x, bst = _booster()
    eng = _engine(max_batch=256, min_bucket=16)
    eng.registry.register(bst.as_serving_bundle("live"))
    for n in (1, 33, 256, 700):
        np.testing.assert_array_equal(eng.predict("live", x[:n]),
                                      bst.predict(x[:n]))
    assert eng.registry.get("live").num_features == x.shape[1]
    with pytest.raises(LightGBMError, match="expects 28 features"):
        eng.predict("live", x[:3, :5])
    # a booster trained past its best iteration serves what predict and
    # save_model use by default
    best = tlgb.Booster(model_str=bst.model_to_string(), device="cpu")
    best.best_iteration = 6
    eng.registry.register(best.as_serving_bundle("best"))
    assert eng.registry.get("best").total_iterations == 6
    np.testing.assert_array_equal(eng.predict("best", x[:50]),
                                  best.predict(x[:50]))


def test_no_cache_miss_after_warmup():
    x, bst = _booster()
    eng = _engine(max_batch=128, min_bucket=16)
    eng.registry.register(bst.as_serving_bundle("m"))
    warmed = eng.warmup(raw_scores=(False, True))
    assert warmed == len(bucket_sizes(16, 128)) * 2 == eng.cache_size()
    rng = np.random.RandomState(6)
    for n in rng.randint(1, 300, size=12):
        rows = x[rng.randint(0, len(x), n)]
        np.testing.assert_array_equal(eng.predict("m", rows),
                                      bst.predict(rows))
    assert eng.metrics.cache_misses_after_warmup() == 0
    # the CPU captures nothing: every entry runs eagerly
    assert eng.metrics.recompiles_after_warmup() == 0
    assert eng.cache_size() == warmed


def test_hot_roll_to_a_staged_generation(tmp_path):
    x, bst = _booster()
    path_a, path_b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    bst.save_model(path_a, num_iteration=4)
    bst.save_model(path_b)
    eng = _engine(max_batch=64, min_bucket=16)
    eng.registry.load_file("m", path_a)
    warmed = eng.warmup()
    np.testing.assert_array_equal(eng.predict("m", x[:40]),
                                  bst.predict(x[:40], num_iteration=4))
    staged = eng.stage_and_prewarm("m", path_b)
    assert staged.generation == eng.registry.generation("m") + 1
    assert eng.cache_size() == 2 * warmed
    eng.registry.register(staged, replace=True)
    assert eng.cache_size() == warmed      # the old generation purged
    np.testing.assert_array_equal(eng.predict("m", x[:40]),
                                  bst.predict(x[:40]))
    assert eng.metrics.cache_misses_after_warmup() == 0
    # the prewarm's misses are credited (the canary's bucket was warm)
    assert eng.metrics.snapshot()["warmup_credit_misses"] == warmed
    # a plain replace drops every stale entry
    eng.registry.load_file("m", path_a, replace=True)
    assert eng.cache_size() == 0


def test_guarded_roll_refuses_a_nonfinite_model(tmp_path):
    x, bst = _booster()
    good, bad = str(tmp_path / "good.txt"), str(tmp_path / "bad.txt")
    bst.save_model(good)
    text = bst.model_to_string()
    head, _, rest = text.partition("leaf_value=")
    open(bad, "w").write(head + "leaf_value=nan " + rest.split(" ", 1)[1])
    eng = _engine(max_batch=32, min_bucket=16)
    eng.registry.load_file("m", good)
    with pytest.raises(LightGBMError, match="canary"):
        eng.stage_and_prewarm("m", bad)
    assert eng.metrics.rollbacks == 1
    assert eng.registry.generation("m") == 1
    np.testing.assert_array_equal(eng.predict("m", x[:5]), bst.predict(x[:5]))


def test_cascade_retune_rebuilds_entries():
    x, bst = _booster()
    eng = _engine(max_batch=32, min_bucket=16, cascade_trees=3,
                  cascade_margin=float("inf"))
    eng.registry.register(bst.as_serving_bundle("m"))
    eng.warmup()
    np.testing.assert_array_equal(eng.predict("m", x[:20]),
                                  bst.predict(x[:20]))
    assert eng.set_cascade_margin(0.0) == len(bucket_sizes(16, 32))
    np.testing.assert_array_equal(eng.predict("m", x[:20]),
                                  bst.predict(x[:20], num_iteration=3))
    assert eng.metrics.cache_misses_after_warmup() == 0


def test_quantized_engine_is_close():
    x, bst = _booster()
    eng = _engine(max_batch=64, quantize_leaves=True)
    eng.registry.register(bst.as_serving_bundle("m"))
    raw = bst.predict(x[:200], raw_score=True)
    got = eng.predict("m", x[:200], raw_score=True)
    assert np.abs(got - raw).max() <= 1e-4 * np.abs(raw).max()


# ------------------------------------------------------- micro-batch queue
def test_micro_batch_queue_roundtrip_and_coalescing():
    x, bst = _booster()
    eng = _engine(max_batch=128)
    eng.registry.register(bst.as_serving_bundle("m"))
    eng.warmup()
    base = eng.metrics.batches
    q = MicroBatchQueue(eng, deadline_ms=250).start()
    try:
        sizes = (1, 2, 5, 1, 30, 3)
        parts = np.split(x[:sum(sizes)], np.cumsum(sizes)[:-1])
        # mixed keys in flight at once: raw and transformed must not fuse
        futs = [q.submit("m", p) for p in parts]
        futs_raw = [q.submit("m", p, raw_score=True) for p in parts[:2]]
        for p, f in zip(parts, futs):
            np.testing.assert_array_equal(f.result(timeout=60),
                                          bst.predict(p))
        for p, f in zip(parts, futs_raw):
            np.testing.assert_array_equal(f.result(timeout=60),
                                          bst.predict(p, raw_score=True))
        assert eng.metrics.queue_depth == 0
    finally:
        q.stop()
    assert eng.metrics.batches - base < len(sizes) + 2     # fused
    assert eng.metrics.requests == len(sizes) + 2          # per caller


def test_micro_batch_queue_from_threads():
    x, bst = _booster()
    eng = _engine(max_batch=64)
    eng.registry.register(bst.as_serving_bundle("m"))
    q = MicroBatchQueue(eng, deadline_ms=5).start()
    out = {}

    def caller(i):
        rows = x[i * 7:i * 7 + 1 + i % 5]
        out[i] = (rows, q.predict("m", rows))
    threads = [threading.Thread(target=caller, args=(i,)) for i in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        q.stop()
    assert len(out) == 8
    for rows, got in out.values():
        np.testing.assert_array_equal(got, bst.predict(rows))


def test_micro_batch_queue_error_delivery_and_shedding():
    x, bst = _booster()
    eng = _engine(max_batch=64)
    eng.registry.register(bst.as_serving_bundle("m"))
    q = MicroBatchQueue(eng, deadline_ms=1).start()
    try:
        bad = q.submit("m", np.zeros((2, 3)))        # wrong features
        unknown = q.submit("nope", np.zeros((2, 3)))
        with pytest.raises(LightGBMError):
            bad.result(timeout=60)
        with pytest.raises(LightGBMError):
            unknown.result(timeout=60)
    finally:
        q.stop()
    assert eng.metrics.errors >= 2
    shed = MicroBatchQueue(eng, deadline_ms=1, max_queue_rows=4)
    shed.start()
    try:
        with pytest.raises(OverloadedError, match="serve_max_queue_rows"):
            shed.submit("m", x[:5])
    finally:
        shed.stop()
    assert eng.metrics.shed == 1


# ----------------------------------------------------------------- metrics
def test_metrics_snapshot_schema_and_jsonl(tmp_path):
    m = ServingMetrics(window=8)
    m.record_request(5, 0.002)
    m.record_request(7, 0.004)
    m.record_batch(16)
    m.record_cache(hit=False)
    m.record_cache(hit=True)
    m.set_queue_depth(3)
    snap = m.snapshot()
    # the JAX package's schema, key for key
    want = jlgb.serving.ServingMetrics(window=8).snapshot()
    assert sorted(snap) == sorted(want)
    assert snap["requests"] == 2 and snap["rows"] == 12
    assert snap["cache_hits"] == 1 and snap["cache_misses"] == 1
    assert snap["queue_depth"] == 3
    lat = snap["latency_ms"]
    assert lat["count"] == 2 and lat["p50_ms"] <= lat["p99_ms"] <= lat["max_ms"]
    path = tmp_path / "metrics.jsonl"
    m.write_jsonl(str(path))
    m.write_jsonl(str(path))
    lines = path.read_text().splitlines()
    assert len(lines) == 2 and json.loads(lines[1])["requests"] == 2


def test_latency_summary_quantiles():
    from lightgbm_tpu.profiling import latency_summary as jax_summary
    s = latency_summary(range(1, 101))
    assert s == jax_summary(range(1, 101))
    assert s["count"] == 100 and s["p50_ms"] == pytest.approx(50.5)
    assert s["p99_ms"] == pytest.approx(99.01) and s["max_ms"] == 100
    assert latency_summary([])["count"] == 0


# ---------------------------------------------------------------- registry
def test_registry_rejects_duplicates_unknown_and_other_devices():
    reg = ModelRegistry(device="cpu")
    path = os.path.join(GOLDEN, "model_ref.txt")
    reg.load_file("m", path)
    with pytest.raises(LightGBMError, match="already registered"):
        reg.load_file("m", path)
    with pytest.raises(LightGBMError, match="unknown model id"):
        reg.get("other")
    assert reg.ids() == ["m"] and reg.generation("m") == 1
    reg.load_file("m", path, replace=True)
    assert reg.generation("m") == 2


def test_drift_monitor_matches_jax_on_one_profile():
    """The JAX package profiles a dataset; both packages' monitors score
    the same shifted traffic against it."""
    from lightgbm_tpu.obs.drift import DataProfile as JaxProfile
    from lightgbm_tpu.obs.drift import DriftMonitor as JaxMonitor
    from lightgbm_tpu_torch.obs.drift import DataProfile, DriftMonitor
    x, y = bench_data(3000)
    jds = jlgb.Dataset(x, label=y, params={"verbosity": -1}).construct()
    prof = JaxProfile.from_binned_dataset(jds._binned).to_json_dict()
    port = DriftMonitor(DataProfile.from_json_dict(prof), model_id="p",
                        min_rows=100)
    ref = JaxMonitor(JaxProfile.from_json_dict(prof), model_id="j",
                     min_rows=100)
    shifted = x[:1000] + np.array([3.0] + [0.0] * (x.shape[1] - 1))
    for mon in (port, ref):
        mon.observe(shifted)
    a, b = port.evaluate(), ref.evaluate()
    assert a["status"] == b["status"] == "warn"
    assert a["features"] == b["features"]


# -------------------------------------------------------------- front-ends
def _config(**extra):
    d = {"task": "serve", "input_model": os.path.join(GOLDEN, "model_ref.txt"),
         "serve_max_batch": 64, "serve_min_bucket": 8, "verbosity": -1,
         "device_type": "cpu"}
    d.update(extra)
    return Config(d)


def _get(host, port, route):
    return json.loads(urllib.request.urlopen(
        "http://%s:%d%s" % (host, port, route)).read())


def test_http_server_roundtrip():
    app = build_app(_config())
    tb = tlgb.Booster(model_file=os.path.join(GOLDEN, "model_ref.txt"),
                      device="cpu")
    nf = tb.num_feature()
    srv = make_server(app, "127.0.0.1", 0)       # port 0: OS-assigned
    host, port = srv.server_address
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        x = np.random.RandomState(9).rand(5, nf)
        body = json.dumps({"data": x.tolist()}).encode()
        rep = json.loads(urllib.request.urlopen(urllib.request.Request(
            "http://%s:%d/predict" % (host, port), data=body)).read())
        assert rep["rows"] == 5 and rep["model"] == "default"
        np.testing.assert_array_equal(rep["predictions"], tb.predict(x))
        assert _get(host, port, "/metrics")["requests"] == 1
        stats = _get(host, port, "/stats")
        assert stats["queue"]["queued_rows"] == 0
        assert stats["breaker"]["state"] == "closed"
        health = _get(host, port, "/healthz")
        assert health["status"] == "ok" and health["models"] == ["default"]
        # a bare model file carries no training profile
        assert health["drift"] == "no_profile"
        assert _get(host, port, "/drift")["status"] == "no_profile"
        assert _get(host, port, "/models")["models"][0]["num_features"] == nf
        assert _get(host, port, "/slo") == {"status": "disabled", "slos": {}}
        assert _get(host, port, "/traces") == {"traces": []}
        assert _get(host, port, "/stats/cluster")["fleet"]["replicas"] == 0
        prom = urllib.request.urlopen(
            "http://%s:%d/metrics/prometheus" % (host, port)).read().decode()
        assert "lgbm_serving_requests_total" in prom
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(urllib.request.Request(
                "http://%s:%d/predict" % (host, port), data=b"{}"))
        assert exc.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen("http://%s:%d/nope" % (host, port))
        assert exc.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()
        app.close()


def test_stdin_transport():
    app = build_app(_config())
    try:
        tb = tlgb.Booster(model_file=os.path.join(GOLDEN, "model_ref.txt"),
                          device="cpu")
        x = np.random.RandomState(10).rand(3, tb.num_feature())
        lines = (json.dumps({"data": x.tolist(), "raw_score": True}) + "\n"
                 + json.dumps({"data": [[0.0]]}) + "\n")   # bad width
        out = io.StringIO()
        assert serve_stdin(app, io.StringIO(lines), out) == 2
        ok, bad = [json.loads(s) for s in out.getvalue().splitlines()]
        assert ok["rows"] == 3
        np.testing.assert_array_equal(ok["predictions"],
                                      tb.predict(x, raw_score=True))
        assert "error" in bad and "features" in bad["error"]
    finally:
        app.close()


def test_cli_serve_stdin_subprocess():
    """``task=serve`` end to end through the command line in a
    subprocess, on the CPU."""
    path = os.path.join(GOLDEN, "multiclass_model_ref.txt")
    tb = tlgb.Booster(model_file=path, device="cpu")
    x = np.random.RandomState(11).rand(2, tb.num_feature())
    req = json.dumps({"data": x.tolist()}) + "\n"
    p = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", "task=serve",
         "input_model=%s" % path, "device_type=cpu", "serve_stdin=true",
         "serve_max_batch=16", "serve_min_bucket=8", "verbosity=-1"],
        input=req, capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-1500:]
    reply = json.loads([line for line in p.stdout.splitlines()
                        if line.startswith("{")][-1])
    np.testing.assert_array_equal(reply["predictions"], tb.predict(x))
