"""Request tracing and SLOs of the port's server against the JAX
package's, on the CPU:

- one HTTP request that carries a trace header, through each package's
  app with ``obs_trace=true`` and ``obs_trace_sample=1.0``: ``/traces``
  holds the trace under the inbound ID, as the same tree of span names
  (request, queue_wait, batch, predict with its device_dispatch and
  device_wait), whose spans also reach ``obs_event_file``; the response
  equals ``Booster.predict``;
- ``/slo`` over HTTP names the same SLOs with the same fields in both
  packages under ``serve_slo_p99_ms`` and ``serve_slo_availability``;
- a shed request's trace is kept, whatever the sample.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import importlib.util
import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.serving import build_app as jbuild_app
from lightgbm_tpu.serving import make_server as jmake_server

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.log import OverloadedError
from lightgbm_tpu_torch.obs.reqtrace import TRACE_HEADER
from lightgbm_tpu_torch.serving import build_app, make_server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE = "00c0ffee12345678"


def _model(tmp_path):
    r = np.random.RandomState(0)
    x = r.randn(600, 5)
    y = (x[:, 0] + 0.5 * r.randn(600) > 0).astype(np.float64)
    bst = tlgb.train({"objective": "binary", "verbosity": -1,
                      "num_leaves": 7}, tlgb.Dataset(x, label=y,
                                                     device="cpu"), 3,
                     device="cpu")
    path = str(tmp_path / "m.txt")
    bst.save_model(path)
    return bst, path, x


def _serve(app, make):
    server = make(app, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, server.server_address[1]


def _http(port, path, body=None, headers=None):
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path),
        data=None if body is None else json.dumps(body).encode(),
        headers=dict(headers or {}, **({"Content-Type": "application/json"}
                                       if body is not None else {})))
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _tree(records):
    """The span tree as nested (name, children) tuples, children sorted."""
    by_parent = {}
    for r in records:
        by_parent.setdefault(r["parent"], []).append(r)
    ids = {r["span_id"] for r in records}

    def build(r):
        return (r["name"], tuple(sorted(build(c) for c in
                                        by_parent.get(r["span_id"], []))))
    return tuple(sorted(build(r) for r in records
                        if r["parent"] not in ids))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Each package's app with tracing and both SLOs, one traced request
    through HTTP: {package: (response, /traces, /slo, event records)}."""
    tmp = tmp_path_factory.mktemp("serve")
    bst, path, x = _model(tmp)
    out = {"_predict": bst.predict(x[:3]), "_rows": x[:3]}
    for name, cfg_cls, build, make, extra in (
            ("jax", JConfig, jbuild_app, jmake_server, {}),
            ("port", Config, build_app, make_server,
             {"device_type": "cpu"})):
        ev = str(tmp / ("%s.jsonl" % name))
        app = build(cfg_cls(dict(
            extra, input_model=path, obs_trace=True, obs_trace_sample=1.0,
            obs_trace_slow_ms=1e9,
            obs_event_file=ev, serve_slo_p99_ms=50.0,
            serve_slo_availability=0.99)))
        server, thread, port = _serve(app, make)
        try:
            resp = _http(port, "/predict",
                         {"model": "default", "data": x[:3].tolist()},
                         {TRACE_HEADER: TRACE + "-ab12"})
            traces = _http(port, "/traces")
            slo = _http(port, "/slo")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
            app.close()
        with open(ev) as f:
            records = [json.loads(line) for line in f]
        out[name] = (resp, traces, slo, records)
    return out


def test_a_traced_request_answers_as_predict(served):
    resp = served["port"][0]
    np.testing.assert_array_equal(np.asarray(resp["predictions"]),
                                  served["_predict"])
    np.testing.assert_allclose(served["jax"][0]["predictions"],
                               resp["predictions"], rtol=0, atol=1e-6)


def test_traces_hold_the_inbound_id_as_the_jax_packages_tree(served):
    trees = {}
    for name in ("jax", "port"):
        traces = served[name][1]["traces"]
        assert [t["trace"] for t in traces] == [TRACE]
        assert traces[0]["reason"] == "sample"
        records = traces[0]["records"]
        root = [r for r in records if r["name"] == "request"]
        assert len(root) == 1 and root[0]["parent"] == "ab12"
        trees[name] = _tree(records)
    assert trees["port"] == trees["jax"]
    assert trees["port"] == (("request", (
        ("batch", (("predict", (("device_dispatch", ()),
                                ("device_wait", ()))),)),
        ("queue_wait", ()))),)


def test_kept_spans_reach_the_event_file(served):
    spec = importlib.util.spec_from_file_location(
        "merge_events", os.path.join(ROOT, "tools", "merge_events.py"))
    merge_events = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(merge_events)
    for name in ("jax", "port"):
        records = served[name][3]
        assert {r["source"] for r in records} == {"serve"}
        trees = merge_events.build_span_trees(records)
        assert list(trees) == [TRACE]
        assert len(trees[TRACE]["spans"]) == 6


def test_slo_route_answers_as_the_jax_packages(served):
    docs = [served[name][2] for name in ("jax", "port")]
    assert sorted(docs[1]["slos"]) == sorted(docs[0]["slos"]) == [
        "serve_availability", "serve_p99"]
    for slo in docs[0]["slos"]:
        assert sorted(docs[1]["slos"][slo]) == sorted(docs[0]["slos"][slo])
        assert docs[1]["slos"][slo]["burning"] is False
    assert sorted(docs[1]) == sorted(docs[0])


def test_a_shed_request_keeps_its_trace(tmp_path):
    _, path, x = _model(tmp_path)
    app = build_app(Config({"input_model": path, "device_type": "cpu",
                            "obs_trace": True, "obs_trace_sample": 0.0,
                            "serve_max_queue_rows": 2}))
    try:
        with pytest.raises(OverloadedError):
            app.handle_predict({"model": "default",
                                "data": x[:3].tolist()}, trace="0fed")
        app.handle_predict({"model": "default", "data": x[:1].tolist()},
                           trace="0abc")
        traces = app.tracer.recent_traces()
    finally:
        app.close()
    assert [(t["trace"], t["status"], t["reason"]) for t in traces] == [
        ("0fed", "shed", "status")]
