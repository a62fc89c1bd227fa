"""Rules the PyTorch port keeps.

- The port and ``chip_smoke.py`` import neither JAX nor the JAX package.
- Entry points run on CUDA unless the caller asks for the CPU, and raise
  when there is no CUDA device instead of slipping onto the CPU.
- Every option outside the port's slice raises ``NotImplementedError``
  instead of training a different model, and every public method of the
  JAX package's ``Booster`` and ``Dataset`` exists on the port's, ported
  or refusing the same way.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import device as tdevice

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "lightgbm_tpu_torch")


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "lightgbm_tpu")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_jax_package_import(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno)


def test_the_scan_covers_the_wave_growers():
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for module in ("core/grow.py", "core/grow_frontier.py",
                   "core/grow_batched.py", "core/grow_batched_part.py",
                   "core/repack.py", "core/kernels.py"):
        assert os.path.join("lightgbm_tpu_torch", module) in scanned


def test_the_scan_covers_the_serving_layers():
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for module in ("serving/traversal.py", "serving/predictor.py",
                   "serving/registry.py", "serving/batching.py",
                   "serving/server.py", "serving/metrics.py",
                   "obs/registry.py", "obs/drift.py", "obs/health.py",
                   "resilience/breaker.py"):
        assert os.path.join("lightgbm_tpu_torch", module) in scanned


def test_the_scan_covers_the_fleet_package():
    """The fleet (#15 slice a) keeps its own copies of the JAX package's
    fleet/qos.py and fleet/replica.py."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for module in ("fleet/__init__.py", "fleet/refit.py", "fleet/qos.py",
                   "fleet/replica.py"):
        assert os.path.join("lightgbm_tpu_torch", module) in scanned


def test_the_jax_fleets_public_names_resolve_on_the_port():
    """Every name of ``lightgbm_tpu.fleet.__all__`` is one of the port's
    fleet package."""
    import lightgbm_tpu.fleet as jfleet
    import lightgbm_tpu_torch.fleet as tfleet
    missing = [n for n in jfleet.__all__ if not hasattr(tfleet, n)]
    assert not missing, missing
    assert sorted(tfleet.__all__) == sorted(jfleet.__all__)


def test_the_scan_covers_the_stream_package_and_the_words():
    """Streaming (#11) and packed words (#9) keep their own copies of what
    they need from the JAX package's stream/ and core/binpack.py."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for module in ("stream/__init__.py", "stream/source.py",
                   "stream/sampler.py", "stream/pipeline.py",
                   "stream/grow_stream.py", "core/binpack.py"):
        assert os.path.join("lightgbm_tpu_torch", module) in scanned


def test_importing_the_port_leaves_jax_out():
    mods = ["lightgbm_tpu_torch"] + [
        "lightgbm_tpu_torch." + os.path.relpath(p, PORT)[:-3]
        .replace(os.sep, ".").replace(".__init__", "")
        for p in _port_sources() if p.startswith(PORT)]
    code = ("import importlib, sys\n"
            "for m in %r: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lightgbm_tpu')]\n"
            "assert not bad, bad\n" % sorted(set(mods)))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_no_cuda_raises_instead_of_using_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.RandomState(0).randn(200, 3)
    y = (x[:, 0] > 0).astype(float)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlgb.Dataset(x, label=y)
    ds = tlgb.Dataset(x, label=y, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlgb.train({"objective": "binary"}, ds, num_boost_round=1)
    bst = tlgb.train({"objective": "binary", "verbosity": -1}, ds,
                     num_boost_round=1, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlgb.Booster(model_str=bst.model_to_string())
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


def _data(n=400):
    r = np.random.RandomState(1)
    x = r.randn(n, 4)
    return x, (x[:, 0] + 0.3 * r.randn(n) > 0).astype(float)


OUTSIDE_SLICE = {
    # f64 histograms are in the slice; on a device mesh they are not
    "gpu_use_dp": ({"gpu_use_dp": True, "tree_learner": "data"}, None),
    # frontier, batched and partitioned batched growth are in the slice, as
    # are packed bin words and model statistics; the cross-process
    # telemetry beside them is not
    "tree_growth_frontier": ({"tree_growth": "frontier",
                              "tpu_bin_packing": "byte",
                              "obs_modelstats": True,
                              "obs_distributed": "on"}, None),
    "tree_growth_batched": ({"tree_growth": "batched",
                             "tpu_batched_part": "true",
                             "obs_modelstats": True,
                             "obs_distributed": "on"}, None),
    "mesh": ({"tree_learner": "data"}, None),
    "pallas_impl": ({"tpu_hist_impl": "pallas"}, None),
}


# refusals raised while the data are binned or the options checked, each
# citing the ROADMAP Queue 1 item that brings what it refuses
REFUSALS = {
    # packed words, dataset-wide pairing and streaming train on one device
    # (#9, #11); on a device mesh they refuse with it
    "packed_words": ({"tree_growth": "frontier", "tpu_bin_packing": "byte",
                      "tree_learner": "data"}, "#13"),
    "nibble_pairs": ({"tpu_bin_packing": "nibble", "tree_learner": "data"},
                     "#13"),
    "fault_inject_kv": ({"fault_inject": "kv_timeout@round:2"}, "#13"),
    "data_stream_chunk_rows": ({"data_stream_chunk_rows": 100,
                                "tree_growth": "frontier",
                                "tree_learner": "data"}, "#13"),
    # methods of the JAX package's Booster the port lacks
    "booster_set_network": ({}, "#13"),
    # the cross-process telemetry (DistributedObs); one process is off
    "obs_distributed": ({"obs_distributed": "on",
                         "observability": "basic"}, "#13"),
    # serving options outside the serving slice (#10), refused where the
    # engine or the app is built
    "serve_mesh": ({"serve_num_devices": 2}, "#13"),
    "serve_fault_inject_kv": ({"fault_inject": "kv_delay@round:1"}, "#13"),
}


def _nan_fobj(preds, data):
    """Logistic gradients, one in seven NaN."""
    p = 1.0 / (1.0 + np.exp(-preds))
    grad = (p - data.get_label()).astype(np.float32)
    grad[::7] = np.nan
    return grad, np.maximum(p * (1 - p), 1e-3).astype(np.float32)


def _events(path):
    import json
    with open(path) as f:
        return [json.loads(line)["event"] for line in f]


def _acts_observability(tmp_path, x, y):
    ev = str(tmp_path / "events.jsonl")
    tlgb.train({"objective": "binary", "verbosity": -1,
                "observability": "basic", "obs_event_file": ev},
               tlgb.Dataset(x, label=y, device="cpu"), num_boost_round=3,
               device="cpu")
    assert _events(ev).count("block") == 1


def _acts_observability_full(tmp_path, x, y):
    ev = str(tmp_path / "events.jsonl")
    tlgb.train({"objective": "binary", "verbosity": -1,
                "observability": "full", "obs_event_file": ev},
               tlgb.Dataset(x, label=y, device="cpu"), num_boost_round=3,
               device="cpu")
    assert _events(ev).count("iteration") == 3


def _acts_health_monitor(tmp_path, x, y):
    with pytest.raises(tlgb.basic.LightGBMError, match="health monitor"):
        tlgb.train({"verbosity": -1, "health_monitor": "raise"},
                   tlgb.Dataset(x, label=y, device="cpu"), num_boost_round=3,
                   fobj=_nan_fobj, device="cpu")


def _acts_health_monitor_warn(tmp_path, x, y):
    bst = tlgb.train({"verbosity": -1, "health_monitor": "warn"},
                     tlgb.Dataset(x, label=y, device="cpu"),
                     num_boost_round=3, fobj=_nan_fobj, device="cpu")
    assert bst._impl.obs.monitor.anomaly_count() >= 1


def _serving_app(params, x, y):
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.serving import build_app
    bst = tlgb.train({"objective": "binary", "verbosity": -1},
                     tlgb.Dataset(x, label=y, device="cpu"),
                     num_boost_round=2, device="cpu")
    app = build_app(Config(dict(params, device_type="cpu")))
    app.engine.registry.register(bst.as_serving_bundle("m"))
    return app


def _acts_serve_obs_trace(tmp_path, x, y):
    app = _serving_app({"obs_trace": True, "obs_trace_sample": 1.0}, x, y)
    try:
        app.handle_predict({"model": "m", "data": x[:2].tolist()},
                           trace="00ab12")
        traces = app.tracer.recent_traces()
    finally:
        app.close()
    assert [t["trace"] for t in traces] == ["00ab12"]


def _acts_serve_slo(tmp_path, x, y):
    import json
    import threading
    import urllib.request
    from lightgbm_tpu_torch.serving import make_server
    app = _serving_app({"serve_slo_p99_ms": 5.0}, x, y)
    server = make_server(app, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = "http://127.0.0.1:%d/slo" % server.server_address[1]
        with urllib.request.urlopen(url, timeout=30) as resp:
            body = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        app.close()
    assert list(body["slos"]) == ["serve_p99"]


# options the port refused until its observability layers came (ROADMAP
# Queue 1 #15): each keeps its case, which now checks that it acts
NOW_ACT = {
    "observability": _acts_observability,
    "observability_full": _acts_observability_full,
    "health_monitor": _acts_health_monitor,
    "health_monitor_warn": _acts_health_monitor_warn,
    "serve_obs_trace": _acts_serve_obs_trace,
    "serve_slo": _acts_serve_slo,
}


def _refused_call(kind, params, x, y):
    """The call that ``kind`` refuses."""
    params = dict(params, objective="binary", verbosity=-1)
    if kind.startswith("serve_"):
        from lightgbm_tpu_torch.config import Config
        from lightgbm_tpu_torch.serving import build_app
        return build_app(Config(dict(params, device_type="cpu")))
    if kind.startswith("booster_"):
        bst = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                         num_boost_round=1, device="cpu")
        return bst.set_network("127.0.0.1:12400")
    return tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                      num_boost_round=1, device="cpu")


@pytest.mark.parametrize("kind", sorted(set(REFUSALS) | set(NOW_ACT)))
def test_refusals_cite_their_roadmap_item(kind, tmp_path):
    x, y = _data()
    if kind in NOW_ACT:
        NOW_ACT[kind](tmp_path, x, y)
        return
    params, item = REFUSALS[kind]
    if kind == "nibble_pairs":
        x = _small_pair_data(x)
    with pytest.raises(NotImplementedError,
                       match=r"\(ROADMAP Queue 1 %s\)$" % item):
        _refused_call(kind, params, x, y)


def test_every_refusal_cites_a_roadmap_item():
    """Every ``outside_slice`` call in the port names the ROADMAP Queue 1
    item that brings what it refuses."""
    uncited = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "outside_slice"
                    and len(node.args) + len(node.keywords) < 2):
                uncited.append("%s:%d" % (os.path.relpath(path, ROOT),
                                          node.lineno))
    assert not uncited, uncited


def _small_pair_data(x):
    """A 0/1 and a 0/1/2 column beside ``x``: the JAX package packs them
    into one stored column."""
    r = np.random.RandomState(3)
    return np.column_stack([x, r.randint(0, 2, len(x)),
                            r.randint(0, 3, len(x))])


def _exclusive_sparse_data(n=400):
    """Mutually exclusive sparse columns: EFB bundles them."""
    r = np.random.RandomState(2)
    x = np.zeros((n, 6))
    which = r.randint(0, 6, n)
    x[np.arange(n), which] = r.rand(n) + 1
    return x


# data on which the port once refused to train (EFB bundles and packed
# small-feature pairs form under default parameters); it trains now, on
# the JAX package's stored layout
NOW_TRAINED = {
    "efb_bundles": ({}, "bundles"),
    "small_feature_pairs": ({"enable_bundle": False}, "pairs"),
}


# options the port once refused: categorical features (the JAX package's
# categorical split, ROADMAP Queue 1 #4) and custom objectives (#19)
NOW_TRAINS = {
    "categorical": ({"categorical_feature": "0"}, None),
    "fobj": ({}, lambda preds, data: (preds - data.get_label(),
                                      np.ones_like(preds))),
}


@pytest.mark.parametrize("option", sorted(NOW_TRAINS))
def test_categorical_features_and_fobj_train(option):
    params, fobj = NOW_TRAINS[option]
    x, y = _data()
    if option == "categorical":
        x = x.copy()
        x[:, 0] = (x[:, 0] > 0) + 2 * (x[:, 1] > 0.5)
    bst = tlgb.train(dict(params, objective="binary", verbosity=-1),
                     tlgb.Dataset(x, label=y, device="cpu"),
                     num_boost_round=2, fobj=fobj, device="cpu")
    assert len(bst.models) == 2
    if option == "categorical":
        assert bst._impl.grow_params.split.cat_features == (0,)
        assert any(t.is_categorical[:t.num_leaves_actual - 1].any()
                   for t in bst.models)
    else:
        assert bst._impl.objective is None
    assert np.isfinite(bst.predict(x)).all()


# objectives the port once refused: cross-entropy and lambdarank, which
# takes query groups (ROADMAP Queue 1 #2)
NOW_TRAIN_OBJECTIVES = ("lambdarank", "xentlambda", "xentropy")


@pytest.mark.parametrize("objective", NOW_TRAIN_OBJECTIVES)
def test_ranking_and_cross_entropy_train(objective):
    x, y = _data()
    group = [100] * 4 if objective == "lambdarank" else None
    ds = tlgb.Dataset(x, label=y, group=group, device="cpu")
    bst = tlgb.train({"objective": objective, "verbosity": -1}, ds,
                     num_boost_round=2, device="cpu")
    assert bst._impl.objective.name == objective
    assert len(bst.models) == 2
    assert np.isfinite(bst.predict(x)).all()
    if objective == "lambdarank":
        assert list(ds.get_group()) == group
        assert [m for _, m, _, _ in bst.eval_train()] == [
            "ndcg@%d" % k for k in range(1, 6)]


# options the port once refused (row sampling, ROADMAP Queue 1 #7): bagging,
# GOSS, DART, RF, bagging under lambdarank (whole queries, in four queries
# or in one) and loading an averaged (RF) model text
NOW_SAMPLES = {
    "bagging": ({"bagging_freq": 1, "bagging_fraction": 0.5}, None),
    "goss": ({"boosting": "goss", "learning_rate": 1.0}, None),
    "dart": ({"boosting": "dart", "skip_drop": 0.0}, None),
    "rf": ({"boosting": "rf", "bagging_freq": 1,
            "bagging_fraction": 0.5}, None),
    "lambdarank": ({"objective": "lambdarank", "bagging_freq": 1,
                    "bagging_fraction": 0.5}, [100] * 4),
    "lambdarank_bagging": ({"objective": "lambdarank", "bagging_freq": 1,
                            "bagging_fraction": 0.5}, [400]),
    "averaged_model_text": ({}, None),
}


@pytest.mark.parametrize("mode", sorted(NOW_SAMPLES))
def test_boosting_modes_train(mode):
    params, group = NOW_SAMPLES[mode]
    x, y = _data()
    params = dict(params, verbosity=-1)
    params.setdefault("objective", "binary")
    bst = tlgb.train(params, tlgb.Dataset(x, label=y, group=group,
                                          device="cpu"),
                     num_boost_round=3, device="cpu")
    impl = bst._impl
    assert len(bst.models) == 3
    assert np.isfinite(bst.predict(x)).all()
    if mode == "averaged_model_text":
        text = bst.model_to_string().replace(
            "label_index=0", "label_index=0\naverage_output")
        loaded = tlgb.Booster(model_str=text, device="cpu")
        assert loaded._impl.average_output
        np.testing.assert_allclose(loaded.predict(x, raw_score=True) * 3,
                                   bst.predict(x, raw_score=True),
                                   rtol=1e-12, atol=1e-12)
        return
    assert impl.boosting_type == params.get("boosting", "gbdt")
    if "bagging_freq" in params:
        mask = impl._bag_mask.numpy()
        assert 0 < mask.sum() <= len(y) - (0 if group == [400] else 1)
        assert bst.models[-1].internal_count[0] == mask.sum()
    if group is not None:
        # whole queries in or out of the bag
        for q in np.split(impl._bag_mask.numpy(), np.cumsum(group)[:-1]):
            assert q.min() == q.max()
    if mode == "rf":
        assert impl.average_output and "average_output" in \
            bst.model_to_string()


# split-selection options the port once refused (ROADMAP Queue 1 #4/#6):
# monotone constraints, forced splits (a file, written per test) and CEGB
NOW_CONSTRAINS = {
    "monotone": {"monotone_constraints": [1, 0, 0, 0]},
    "forced_splits": {"forcedsplits_filename": "forced.json"},
    "cegb": {"cegb_penalty_split": 0.5},
}


@pytest.mark.parametrize("option", sorted(NOW_CONSTRAINS))
def test_split_constraints_train(option, tmp_path):
    params = dict(NOW_CONSTRAINS[option], objective="binary", verbosity=-1)
    if option == "forced_splits":
        path = tmp_path / params["forcedsplits_filename"]
        path.write_text('{"feature": 1, "threshold": 0.0}')
        params["forcedsplits_filename"] = str(path)
    x, y = _data()
    bst = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                     num_boost_round=2, device="cpu")
    impl = bst._impl
    assert len(bst.models) == 2
    assert np.isfinite(bst.predict(x)).all()
    if option == "monotone":
        assert impl.grow_params.split.with_monotone
        assert impl.feature_meta.monotone.tolist() == [1, 0, 0, 0]
    elif option == "forced_splits":
        assert all(int(t.split_feature[0]) == 1 for t in bst.models)
    else:
        assert impl._cegb is not None
        assert impl._cegb.state.feature_used.any()


@pytest.mark.parametrize("kind", sorted(NOW_TRAINED))
def test_bundles_and_small_pairs_train(kind):
    params, layout = NOW_TRAINED[kind]
    x, y = _data()
    x = _exclusive_sparse_data() if layout == "bundles" \
        else _small_pair_data(x)
    bst = tlgb.train(dict(params, objective="binary", verbosity=-1),
                     tlgb.Dataset(x, label=y, device="cpu"),
                     num_boost_round=2, device="cpu")
    ds = bst._impl.train_data
    assert (ds.has_bundles, ds.has_packed) == (layout == "bundles",
                                               layout == "pairs")
    assert ds.num_columns < ds.num_features
    assert len(bst.models) == 2
    assert np.isfinite(bst.predict(x)).all()


@pytest.mark.parametrize("option", sorted(OUTSIDE_SLICE))
def test_outside_the_slice_raises(option):
    params, _ = OUTSIDE_SLICE[option]
    x, y = _data()
    ds = tlgb.Dataset(x, label=y, device="cpu")
    with pytest.raises(NotImplementedError, match="outside what the PyTorch port covers"):
        tlgb.train(dict(params, objective=params.get("objective", "binary"),
                        verbosity=-1), ds, num_boost_round=1, device="cpu")


@pytest.mark.parametrize("cls", ["Booster", "Dataset"])
def test_every_jax_method_is_ported_or_refuses(cls):
    """Each public method of the JAX package's class exists on the port's;
    one the port has not ported raises ``outside_slice`` citing its ROADMAP
    item, never ``AttributeError``. Only the Booster's network setup (#13)
    still refuses."""
    import lightgbm_tpu as jlgb
    x, y = _data()
    ds = tlgb.Dataset(x, label=y, device="cpu")
    obj = (tlgb.train({"objective": "binary", "verbosity": -1}, ds,
                      num_boost_round=1, device="cpu")
           if cls == "Booster" else ds)
    names = sorted(m for m in dir(getattr(jlgb, cls))
                   if not m.startswith("_")
                   and callable(getattr(getattr(jlgb, cls), m)))
    refusing = []
    for name in names:
        method = getattr(obj, name)        # AttributeError fails the test
        if (method.__doc__ or "").startswith("Not ported yet"):
            with pytest.raises(NotImplementedError,
                               match=r"\(ROADMAP Queue 1 #\d+\)$"):
                method()
            refusing.append(name)
    assert refusing == ([] if cls == "Dataset" else [
        "free_network", "set_network"])


def test_the_jax_packages_public_names_resolve_on_the_port():
    """Every name in the JAX package's ``__all__``, and its four plotting
    functions, is a name of the port's package too."""
    import lightgbm_tpu as jlgb
    names = list(jlgb.__all__) + ["plot_importance", "plot_metric",
                                  "plot_tree", "create_tree_digraph"]
    missing = [n for n in names if not hasattr(tlgb, n)]
    assert not missing, missing
    for name in ("cv", "CVBooster", "LGBMClassifier", "plot_tree"):
        assert name in tlgb.__all__
