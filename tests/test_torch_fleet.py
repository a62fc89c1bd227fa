"""The port's fleet (``lightgbm_tpu_torch/fleet/``) against the JAX package.

Case by case the port of ``tests/test_fleet.py``, each held against the
JAX package on the same seeded inputs:

- refit: the port's device path (flat-forest routing, fixed-order leaf
  sums) and host loop against the JAX package's ``refit_booster`` and host
  loop on the same trees (the port's model text loaded into both), leaf
  ids first, for binary, multiclass, weights, lambdarank with groups,
  DART, ``max_delta_step`` and ``lambda_l1``; scipy CSR through the host
  loop; ``decay_rate=1.0`` byte for byte; structure byte for byte; a held
  ``Refitter`` equal to a one-shot refit; ``task=refit``;
- the checkpoint seam (``save_refit``): served by ``latest_model``,
  skipped by ``load_latest``, retention, a directory of refits only;
- QoS and the cascade autotuner fed the same call sequences as the JAX
  classes; the queue's per-model shed and weighted-fair pick;
- the file KV, the announcer, the rolling-deploy coordinator and the
  cluster provider; the drift hook's poll; ``build_app``'s fleet wiring.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

import lightgbm_tpu as jlgb
from lightgbm_tpu import cli as jcli
from lightgbm_tpu import fleet as jfleet

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import cli as tcli
from lightgbm_tpu_torch.checkpoint import CheckpointManager
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.fleet import (CascadeAutotuner, FileKvClient,
                                      FleetClusterProvider, QosPolicy,
                                      ReplicaAnnouncer, Refitter,
                                      RollingDeployCoordinator, refit_booster)
from lightgbm_tpu_torch.fleet.refit import leaf_layout, leaf_sums
from lightgbm_tpu_torch.log import OverloadedError
from lightgbm_tpu_torch.serving import (MicroBatchQueue, ModelRegistry,
                                        ServingEngine, build_app, make_server)

from conftest import make_binary, make_multiclass, make_ranking

LEAF_RTOL, LEAF_ATOL = 1e-5, 1e-6

# the trees every refit test starts from: the port trains them once a
# module (CPU), and the JAX package loads the port's model text, so both
# packages refit the same trees
MODELS = {
    "binary": ({"objective": "binary", "num_leaves": 15,
                "learning_rate": 0.2}, 8),
    "multiclass": ({"objective": "multiclass", "num_class": 3,
                    "num_leaves": 7}, 4),
    "lambdarank": ({"objective": "lambdarank", "num_leaves": 7}, 4),
    "dart": ({"objective": "binary", "boosting": "dart", "drop_rate": 0.5,
              "skip_drop": 0.0, "num_leaves": 7}, 6),
}
_TRAINED = {}


def _data(kind):
    if kind == "multiclass":
        x, y = make_multiclass(n=400, f=6, k=3, seed=5)
        return x, y, None
    if kind == "lambdarank":
        return make_ranking(num_queries=30, per_query=20, f=6, seed=17)
    x, y = make_binary(n=500, f=6, seed=3)
    return x, y, None


def _trained(kind):
    """(the port's trained booster, its model text, x, y, group)."""
    if kind not in _TRAINED:
        params, rounds = MODELS[kind]
        x, y, group = _data(kind)
        bst = tlgb.train(dict(params, verbosity=-1),
                         tlgb.Dataset(x, label=y, group=group, device="cpu"),
                         num_boost_round=rounds, device="cpu")
        _TRAINED[kind] = (bst, bst.model_to_string(), x, y, group)
    return _TRAINED[kind]


def _window(x, seed=0, scale=0.3):
    return x + scale * np.random.RandomState(seed).randn(*x.shape)


def _leaf_tables(booster):
    models = booster.models if hasattr(booster, "models") \
        else booster._impl.models
    return [np.asarray(t.leaf_value, np.float64).copy() for t in models]


def _live_leaves(booster):
    """Each tree's first ``num_leaves_actual`` leaf values."""
    models = booster.models if hasattr(booster, "models") \
        else booster._impl.models
    return [np.asarray(t.leaf_value[:t.num_leaves_actual], np.float64)
            for t in models]


def _structure(booster):
    return [(np.asarray(t.split_feature).tobytes(),
             np.asarray(t.threshold).tobytes(),
             np.asarray(t.left_child).tobytes(),
             np.asarray(t.right_child).tobytes())
            for t in booster.models]


def _assert_leaves_close(a, b, rtol=LEAF_RTOL, atol=LEAF_ATOL):
    la, lb = _live_leaves(a), _live_leaves(b)
    assert len(la) == len(lb)
    for i, (u, v) in enumerate(zip(la, lb)):
        np.testing.assert_allclose(u, v, rtol=rtol, atol=atol,
                                   err_msg="tree %d" % i)


def _assert_same_leaf_ids(tb, jb, x):
    """The port routes in float64, the JAX package in float32: the leaf
    ids agree unless a value lies within a float32 rounding of a
    threshold, which the message names."""
    import jax
    import jax.numpy as jnp
    from lightgbm_tpu.serving.traversal import forest_leaf_ids, \
        pack_flat_forest
    forest, depth = pack_flat_forest(jb._impl.models)
    want = np.asarray(forest_leaf_ids(jax.tree.map(jnp.asarray, forest),
                                      jnp.asarray(x, jnp.float32), depth))
    got = Refitter(tb).route(x).numpy()
    parted = np.argwhere(got != want)
    if len(parted):
        row, tree = parted[0]
        t = tb.models[tree]
        nn = t.num_leaves_actual - 1
        gaps = np.abs(x[row, t.split_feature[:nn]] - t.threshold[:nn])
        node = int(np.argmin(gaps))
        raise AssertionError(
            "%d (row, tree) pairs part from the JAX package's float32 "
            "routing; first row %d tree %d: feature %d value %r against "
            "threshold %r" % (len(parted), row, tree, t.split_feature[node],
                              x[row, t.split_feature[node]],
                              t.threshold[node]))


# ------------------------------------------------------------------ refit
# (the model, the booster's config overrides, whether the window is weighted)
PARITY = {
    "binary": ("binary", {}, False),
    "multiclass": ("multiclass", {}, False),
    "weights": ("binary", {}, True),
    "lambdarank": ("lambdarank", {}, False),
    "dart": ("dart", {}, False),
    "max_delta_step": ("binary", {"max_delta_step": 0.05}, False),
    "lambda_l1": ("binary", {"lambda_l1": 2.0}, False),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_refit_matches_jax(case):
    """Device path and host loop of each package on the same trees and
    window: the port's device refit against the JAX package's
    ``refit_booster``, the port's host loop against the JAX host loop,
    and the port's two paths against each other."""
    kind, overrides, weighted = PARITY[case]
    _, text, x, y, group = _trained(kind)
    tb = tlgb.Booster(model_str=text, device="cpu")
    jb = jlgb.Booster(model_str=text)
    for b in (tb, jb):
        for key, value in overrides.items():
            setattr(b.config, key, value)
    xw = _window(x, seed=1)
    w = np.where(y > 0, 3.0, 1.0) if weighted else None
    _assert_same_leaf_ids(tb, jb, xw)
    kw = dict(decay_rate=0.4, weight=w, group=group)
    t_dev = refit_booster(tb, xw, y, **kw)
    j_dev = jfleet.refit_booster(jb, xw, y, **kw)
    tb.config.refit_device = jb.config.refit_device = False
    t_host = tb.refit(xw, y, **kw)
    j_host = jb.refit(xw, y, **kw)
    _assert_leaves_close(t_dev, j_dev)
    _assert_leaves_close(t_host, j_host)
    _assert_leaves_close(t_dev, t_host, rtol=1e-9, atol=1e-12)
    assert _structure(t_dev) == _structure(tb)


@pytest.mark.parametrize("path", ["device", "host"])
def test_refit_decay_one_is_byte_stable(path):
    """decay_rate=1.0 keeps every stored leaf double bit for bit: the
    blend is float64 against the original values, on both paths."""
    bst, _, x, y, _ = _trained("binary")
    if path == "host":
        bst = tlgb.Booster(model_str=bst.model_to_string(), device="cpu")
        bst.config.refit_device = False
    refitted = bst.refit(x, y, decay_rate=1.0)
    for old, new in zip(_leaf_tables(bst), _leaf_tables(refitted)):
        np.testing.assert_array_equal(old, new)


def test_refit_device_matches_host_golden_binary():
    """The JAX package's slow golden, at its size: the device refit
    against the host loop, leaves and predictions."""
    bst, text, x, y, _ = _trained("binary")
    xw = x + 0.3 * np.random.RandomState(0).randn(*x.shape)
    dev = refit_booster(bst, xw, y, decay_rate=0.4)
    host_bst = tlgb.Booster(model_str=text, device="cpu")
    host_bst.config.refit_device = False
    host = host_bst.refit(xw, y, decay_rate=0.4)
    _assert_leaves_close(dev, host)
    np.testing.assert_allclose(dev.predict(x[:100]), host.predict(x[:100]),
                               rtol=1e-5, atol=1e-6)


def test_refit_device_matches_host_golden_multiclass():
    """k>1: the [N, k] gradients inside the loop over iterations."""
    bst, text, x, y, _ = _trained("multiclass")
    dev = refit_booster(bst, x, y, decay_rate=0.0)
    host_bst = tlgb.Booster(model_str=text, device="cpu")
    host_bst.config.refit_device = False
    host = host_bst.refit(x, y, decay_rate=0.0)
    _assert_leaves_close(dev, host)


def test_refit_shifted_data_changes_only_leaf_tables():
    bst, _, x, y, _ = _trained("binary")
    refitted = bst.refit(x + 0.5, 1.0 - y, decay_rate=0.0)
    assert _structure(refitted) == _structure(bst)
    changed = sum(not np.array_equal(a, b) for a, b in
                  zip(_leaf_tables(bst), _leaf_tables(refitted)))
    assert changed == len(bst.models)
    assert not np.allclose(refitted.predict(x[:50]), bst.predict(x[:50]))


def test_refitter_reuse_matches_one_shot():
    """A held Refitter (the fleet worker's pattern) gives the same bits
    as a fresh one-shot refit, across windows."""
    bst, _, x, y, _ = _trained("binary")
    r = Refitter(bst)
    for seed in (1, 2):
        xw = _window(x, seed=seed, scale=0.2)
        held = r.refit(xw, y, decay_rate=0.3)
        shot = refit_booster(bst, xw, y, decay_rate=0.3)
        for a, b in zip(_leaf_tables(held), _leaf_tables(shot)):
            np.testing.assert_array_equal(a, b)


def test_refit_weight_changes_leaf_values():
    bst, _, x, y, _ = _trained("binary")
    w = np.where(y > 0, 5.0, 1.0)
    plain = bst.refit(x, y, decay_rate=0.0)
    weighted = bst.refit(x, y, decay_rate=0.0, weight=w)
    assert any(not np.array_equal(a, b) for a, b in
               zip(_leaf_tables(plain), _leaf_tables(weighted)))


def test_refit_csr_host_loop_matches_the_dense_refit():
    """A scipy CSR window takes the host loop a row block at a time and
    gives the dense device refit's leaves."""
    import scipy.sparse as sp
    bst, text, x, y, _ = _trained("binary")
    xw = _window(x, seed=4)
    xw[np.abs(xw) < 0.5] = 0.0
    csr = sp.csr_matrix(xw)
    dense = refit_booster(bst, xw, y, decay_rate=0.2)
    sparse = bst.refit(csr, y, decay_rate=0.2)
    _assert_leaves_close(sparse, dense, rtol=1e-9, atol=1e-12)
    jb = jlgb.Booster(model_str=text)
    _assert_leaves_close(sparse, jb.refit(csr, y, decay_rate=0.2))


def test_refit_refuses_a_custom_objective():
    x, y, _ = _data("binary")
    bst = tlgb.train({"objective": "none", "verbosity": -1},
                     tlgb.Dataset(x, label=y, device="cpu"),
                     num_boost_round=2, device="cpu",
                     fobj=lambda p, d: (p - d.get_label(), np.ones_like(p)))
    with pytest.raises(Exception, match="custom objective"):
        bst.refit(x, y)


def test_leaf_sums_are_fixed_order_segment_sums():
    """The fixed-order leaf sums equal float64 ``bincount`` on leaves of
    every size, empty ones and ones past a block included."""
    r = np.random.RandomState(0)
    leaf = np.concatenate([np.zeros(700, np.int64), r.randint(2, 6, 300)])
    r.shuffle(leaf)
    v = r.randn(len(leaf)).astype(np.float32)
    import torch
    layout = leaf_layout(torch.as_tensor(leaf), 7, block=64)
    got = leaf_sums(torch.as_tensor(v), layout).numpy()
    want = np.bincount(leaf, weights=v.astype(np.float64), minlength=7)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert got[1] == 0.0 and got[6] == 0.0


def test_task_refit_matches_booster_refit(tmp_path):
    """``task=refit`` of the port's CLI (``.weight`` sidecar,
    ``refit_decay_rate``) writes what ``Booster.refit`` gives, and the
    JAX package's CLI on the same files writes the same leaves."""
    bst, _, x, y, _ = _trained("binary")
    model = tmp_path / "m.txt"
    bst.save_model(str(model))
    xw = _window(x, seed=5)
    data = tmp_path / "window.csv"
    np.savetxt(data, np.column_stack([y, xw]), fmt="%.17g", delimiter=",",
               comments="", header=",".join(
                   ["label"] + ["f%d" % j for j in range(x.shape[1])]))
    w = np.where(y > 0, 2.0, 1.0)
    np.savetxt(str(data) + ".weight", w, fmt="%.17g")
    outs = {}
    for name, cli, extra in (("port", tcli, ["device_type=cpu"]),
                             ("jax", jcli, [])):
        out = tmp_path / ("%s_refit.txt" % name)
        assert cli.main(["task=refit", "data=%s" % data, "header=true",
                         "input_model=%s" % model, "output_model=%s" % out,
                         "refit_decay_rate=0.3", "verbosity=-1"]
                        + extra) == 0
        outs[name] = out
    cli_bst = tlgb.Booster(model_file=str(outs["port"]), device="cpu")
    want = tlgb.Booster(model_file=str(model), device="cpu").refit(
        xw, y, decay_rate=0.3, weight=w)
    for a, b in zip(_live_leaves(cli_bst), _live_leaves(want)):
        np.testing.assert_array_equal(a, b)
    _assert_leaves_close(
        cli_bst, tlgb.Booster(model_file=str(outs["jax"]), device="cpu"))


# ------------------------------------------------------- checkpoint seam
def test_checkpoint_refit_resume_byte_stable(tmp_path):
    """save -> save_refit -> latest_model serves the refit; load_latest
    resumes the FULL snapshot with its model text byte-identical; the JAX
    package reads the same directory the same way."""
    from lightgbm_tpu.checkpoint.manager import CheckpointManager as JMgr
    bst, _, x, y, _ = _trained("binary")
    mgr = CheckpointManager(str(tmp_path), keep_last_n=5)
    mgr.save(bst)
    full_text = bst.model_to_string()
    full_id, _ = mgr.latest_model()

    refitted = bst.refit(x + 0.5, y, decay_rate=0.0)
    entry = mgr.save_refit(refitted)
    assert entry["refit"] is True
    assert int(entry["id"]) > full_id

    snap_id, model_path = mgr.latest_model()
    assert snap_id == int(entry["id"])     # serving hot-rolls the refit
    served = tlgb.Booster(model_file=model_path, device="cpu")
    for a, b in zip(_live_leaves(served), _live_leaves(refitted)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)

    handle = mgr.load_latest()             # training resume skips it
    assert int(handle.entry["id"]) == full_id
    assert not handle.entry.get("refit")
    with open(handle.model_path) as fh:
        assert fh.read() == full_text
    jm = JMgr(str(tmp_path))
    assert jm.latest_model()[0] == snap_id
    assert int(jm.load_latest().entry["id"]) == full_id


def test_refit_retention_keeps_last_full_snapshot(tmp_path):
    bst, _, x, y, _ = _trained("binary")
    mgr = CheckpointManager(str(tmp_path), keep_last_n=2)
    mgr.save(bst)
    full_id, _ = mgr.latest_model()
    for shift in (0.1, 0.2, 0.3, 0.4):
        mgr.save_refit(bst.refit(x + shift, y, decay_rate=0.0))
    handle = mgr.load_latest()
    assert handle is not None and int(handle.entry["id"]) == full_id
    assert mgr.latest_model()[0] > full_id


def test_refit_only_directory_resumes_fresh(tmp_path):
    bst, _, x, y, _ = _trained("binary")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_refit(bst.refit(x, y, decay_rate=0.5))
    assert mgr.load_latest() is None       # nothing resumable: fresh start
    assert mgr.latest_model() is not None  # but the model still serves


def test_save_refit_carries_the_window_profile(tmp_path):
    """The window's data profile rides in the refit snapshot's meta and
    reaches the served bundle."""
    from lightgbm_tpu_torch.obs.drift import DataProfile
    bst, _, x, y, _ = _trained("binary")
    xw = _window(x, seed=3) + 2.0
    window = tlgb.Dataset(xw, label=y, device="cpu").construct()._binned
    CheckpointManager(str(tmp_path)).save_refit(
        bst.refit(xw, y, decay_rate=0.0),
        data_profile=DataProfile.from_binned_dataset(window))
    reg = ModelRegistry(device="cpu")
    assert reg.watch_dir("m", str(tmp_path)).poll()
    assert reg.get("m").profile is not None


# ---------------------------------------------------------------- QoS
def _both_qos(*args, **kwargs):
    return (QosPolicy(*args, **kwargs), jfleet.QosPolicy(*args, **kwargs))


def test_qos_from_spec_and_quota_admission():
    for qos in (QosPolicy.from_spec("gold=4, bronze=1", quota_rows=100),
                jfleet.QosPolicy.from_spec("gold=4, bronze=1",
                                           quota_rows=100)):
        assert qos.weight("gold") == 4.0
        assert qos.weight("unknown") == 1.0
        assert qos.quota("gold") == 100
        assert qos.admit("gold", 90, 10)         # exactly at quota
        assert not qos.admit("gold", 91, 10)     # over: shed, counted
        assert qos.snapshot()["gold"]["shed"] == 1
    with pytest.raises(Exception):
        QosPolicy.from_spec("missing-equals")


def test_qos_quota_sheds_only_offending_model():
    for qos in _both_qos(quota_rows={"noisy": 10}):
        assert not qos.admit("noisy", 10, 1)
        assert qos.admit("quiet", 10_000, 64)    # unlisted: no quota


def test_qos_weighted_fair_pick_converges_to_weights():
    port, ref = _both_qos(weights={"gold": 4.0, "bronze": 1.0})
    r = np.random.RandomState(0)
    picks = {id(port): [], id(ref): []}
    rows = r.randint(1, 64, 200)
    queued = {"gold": 64, "bronze": 64, "tin": 64}
    for qos in (port, ref):
        for n in rows:
            mid = qos.pick(queued)
            qos.account(mid, int(n))
            picks[id(qos)].append(mid)
    assert picks[id(port)] == picks[id(ref)]
    assert port.snapshot() == ref.snapshot()
    served = port.snapshot()
    ratio = served["gold"]["served_rows"] / served["bronze"]["served_rows"]
    assert 3.0 < ratio < 5.0


def test_qos_new_model_starts_at_floor():
    """A late-arriving model gets no unbounded catch-up burst."""
    for qos in _both_qos():
        qos.account("old", 10_000)
        assert qos.pick({"new": 1, "old": 1}) == "new"
        qos.account("new", 1)
        assert qos._served_rows["new"] >= 10_000


class _FakeTunerEngine:
    def __init__(self, margin=0.8):
        self.cascade_trees = 4
        self.cascade_margin = margin
        self.applied = []
        self.metrics = self
        self.lat = {}

    def bucket_latency(self):
        return self.lat

    def set_cascade_margin(self, m):
        self.applied.append(m)


TUNER_FEED = [None, {16: {"count": 10, "p99_ms": 50.0}}, None,
              {16: {"count": 20, "p99_ms": 50.0}},
              {16: {"count": 30, "p99_ms": 50.0}},
              {16: {"count": 40, "p99_ms": 2.0}},
              {16: {"count": 50, "p99_ms": 8.0}},
              {16: {"count": 60, "p99_ms": 1.0}, 64: {"count": 3,
                                                      "p99_ms": 90.0}}]


def test_cascade_autotuner_walks_ladder_one_rung_per_step():
    """The same latency feed through the port's and the JAX package's
    tuners: the same margins applied, one rung a step, fresh samples
    only, headroom hysteresis."""
    out = []
    for cls in (CascadeAutotuner, jfleet.CascadeAutotuner):
        eng = _FakeTunerEngine(margin=0.8)
        tuner = cls(eng, budget_ms=10.0, rungs=3, min_samples=5)
        steps = []
        for lat in TUNER_FEED:
            if lat is not None:
                eng.lat = lat
            steps.append(tuner.step())
        out.append((steps, eng.applied, tuner.snapshot()))
    assert out[0] == out[1]
    steps, applied, snap = out[0]
    assert steps[:7] == [None, pytest.approx(0.4), None, pytest.approx(0.2),
                         None, pytest.approx(0.4), None]
    assert snap["retunes"] == len(applied) == 4


def test_queue_sheds_only_the_model_over_its_quota():
    """The queue's QoS hooks on a CPU engine: a request of ``a`` past
    its quota is shed (OverloadedError, counted), ``b`` keeps being
    served, and ``stats()`` carries the policy's block."""
    x, y, _ = _data("binary")
    eng = ServingEngine(device="cpu", max_batch=64, min_bucket=16)
    bst = _trained("binary")[0]
    for mid in ("a", "b"):
        eng.registry.register(bst.as_serving_bundle(mid))
    q = MicroBatchQueue(eng, deadline_ms=1.0,
                        qos=QosPolicy(weights={"a": 4.0, "b": 1.0},
                                      quota_rows={"a": 32}))
    q.start()
    try:
        with pytest.raises(OverloadedError, match="QoS quota"):
            q.predict("a", x[:40])
        np.testing.assert_array_equal(q.predict("b", x[:40]),
                                      bst.predict(x[:40]))
        np.testing.assert_array_equal(q.predict("a", x[:8]),
                                      bst.predict(x[:8]))
        st = q.stats()["qos"]
        assert st["a"]["shed"] == 1 and st["b"]["shed"] == 0
        # a newcomer starts at the floor of virtual time: b's 40 rows at
        # weight 1 are 160 of a's rows at weight 4
        assert st["b"]["served_rows"] == 40
        assert st["a"]["served_rows"] == 40 * 4 + 8
        assert eng.metrics.snapshot()["shed"] == 1
    finally:
        q.stop()


def test_queue_picks_by_virtual_time():
    """With both models queued, dispatch follows the policy's pick."""
    eng = ServingEngine(device="cpu", max_batch=64, min_bucket=16)
    bst, _, x, _, _ = _trained("binary")
    for mid in ("a", "b"):
        eng.registry.register(bst.as_serving_bundle(mid))
    qos = QosPolicy(weights={"a": 1.0, "b": 1.0})
    qos.account("a", 1000)               # a is far ahead in virtual time
    q = MicroBatchQueue(eng, deadline_ms=200.0, qos=qos)
    order = []
    real = eng.predict

    def spy(model_id, X, **kw):
        order.append(model_id)
        return real(model_id, X, **kw)
    eng.predict = spy
    q.start()
    try:
        fa = q.submit("a", x[:4])
        fb = q.submit("b", x[:4])
        fa.result(timeout=30)
        fb.result(timeout=30)
    finally:
        q.stop()
    assert order == ["b", "a"]


# ------------------------------------------------------------ FileKvClient
def test_file_kv_client_contract(tmp_path):
    kv = FileKvClient(str(tmp_path))
    kv.key_value_set("fleet/a", "one")
    assert kv.blocking_key_value_get("fleet/a", 100) == "one"
    kv.key_value_set("fleet/a", "two")
    assert kv.try_get("fleet/a") == "two"
    assert kv.try_get("missing") is None
    kv.key_value_set("fleet/b", "x")
    kv.key_value_set("other", "y")
    assert kv.keys("fleet/") == ["fleet/a", "fleet/b"]
    # the JAX package's client reads the same directory
    assert jfleet.FileKvClient(str(tmp_path)).keys("fleet/") == \
        ["fleet/a", "fleet/b"]
    kv.key_value_delete("fleet/a")
    kv.key_value_delete("fleet/a")           # idempotent
    assert kv.try_get("fleet/a") is None


def test_file_kv_client_timeout_is_deadline_exceeded(tmp_path):
    kv = FileKvClient(str(tmp_path), poll_interval_s=0.01)
    with pytest.raises(Exception, match="DEADLINE_EXCEEDED"):
        kv.blocking_key_value_get("never", timeout_ms=50)


def test_file_kv_client_blocking_get_sees_concurrent_set(tmp_path):
    kv = FileKvClient(str(tmp_path), poll_interval_s=0.005)
    t = threading.Timer(0.05, kv.key_value_set, args=("late", "value"))
    t.start()
    try:
        assert kv.blocking_key_value_get("late", 2000) == "value"
    finally:
        t.cancel()


def test_file_kv_client_takes_two_writers_of_one_key(tmp_path):
    """The announcer's loop and the coordinator both write a replica's
    document: writers of one key in two threads never race on a temp
    file's rename."""
    kv = FileKvClient(str(tmp_path))
    faults = []

    def write(tag):
        try:
            for i in range(300):
                kv.key_value_set("fleet/a", "%s%d" % (tag, i))
        except Exception as e:  # noqa: BLE001 - asserted below
            faults.append(e)
    threads = [threading.Thread(target=write, args=(t,)) for t in "xy"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not faults, faults[:1]
    assert kv.try_get("fleet/a") in ("x299", "y299")
    assert kv.keys("fleet/") == ["fleet/a"]


# ------------------------------------------------------------ announcer
def test_announcer_roundtrip_lease_and_retract(tmp_path):
    kv = FileKvClient(str(tmp_path))
    ann = ReplicaAnnouncer(kv, "replica-a")
    doc = ann.announce_once()
    assert doc["replica"] == "replica-a" and doc["pid"] == os.getpid()
    stale = {"replica": "replica-b", "time": time.time() - 100}
    kv.key_value_set("fleet/replica-b", json.dumps(stale))
    kv.key_value_set("fleet/replica-c", "{not json")   # torn: skipped
    fleet = ReplicaAnnouncer.read_fleet(kv, lease_s=10.0)
    assert fleet["replica-a"]["live"] is True
    assert fleet["replica-b"]["live"] is False
    assert "replica-c" not in fleet
    ref = jfleet.ReplicaAnnouncer.read_fleet(jfleet.FileKvClient(
        str(tmp_path)), lease_s=10.0)
    assert {k: v["live"] for k, v in ref.items()} == \
        {k: v["live"] for k, v in fleet.items()}
    ann.retract()
    assert "replica-a" not in ReplicaAnnouncer.read_fleet(kv)


def _fleet_fixture(tmp_path, name):
    """One replica's registry, watcher and announcer over a shared KV."""
    kv = FileKvClient(str(tmp_path / "kv"))
    registry = ModelRegistry(device="cpu")
    watcher = registry.watch_dir("default", str(tmp_path / "ckpt"))
    ann = ReplicaAnnouncer(kv, name, watcher=watcher)
    return kv, registry, watcher, ann


def _saved(tmp_path):
    bst = _trained("binary")[0]
    CheckpointManager(str(tmp_path / "ckpt")).save(bst)
    return CheckpointManager(str(tmp_path / "ckpt")).latest_model()[0]


def test_rolling_deploy_first_replica_rolls_immediately(tmp_path):
    _saved(tmp_path)
    kv, registry, watcher, ann = _fleet_fixture(tmp_path, "a")
    coord = RollingDeployCoordinator(kv, ann, watcher,
                                     predecessor_timeout_s=5.0)
    assert coord.step() is True
    assert "default" in registry.ids()
    assert watcher._last_id >= 0
    fleet = ReplicaAnnouncer.read_fleet(kv)
    assert fleet["a"]["snap_id"] == watcher._last_id
    assert coord.step() is False             # nothing new: no-op


def test_rolling_deploy_waits_for_predecessor_then_rolls(tmp_path):
    target = _saved(tmp_path)
    kv, registry, watcher, ann = _fleet_fixture(tmp_path, "b")
    kv.key_value_set("fleet/a", json.dumps(
        {"replica": "a", "time": time.time(), "snap_id": target - 1}))
    coord = RollingDeployCoordinator(kv, ann, watcher,
                                     poll_interval_s=0.02,
                                     predecessor_timeout_s=30.0)
    ready, rejected_by = coord._predecessors_ready(target)
    assert not ready and rejected_by is None
    t = threading.Timer(0.05, kv.key_value_set, args=("fleet/a", json.dumps(
        {"replica": "a", "time": time.time(), "snap_id": target})))
    t.start()
    try:
        assert coord.step() is True
    finally:
        t.cancel()
    assert "default" in registry.ids()


def test_rolling_deploy_dead_predecessor_cannot_block(tmp_path):
    target = _saved(tmp_path)
    kv, registry, watcher, ann = _fleet_fixture(tmp_path, "b")
    kv.key_value_set("fleet/a", json.dumps(
        {"replica": "a", "time": time.time() - 100, "snap_id": -1}))
    coord = RollingDeployCoordinator(kv, ann, watcher,
                                     predecessor_timeout_s=30.0)
    assert coord._predecessors_ready(target) == (True, None)
    assert coord.step() is True


def test_rolling_deploy_canary_rejection_propagates(tmp_path):
    """A predecessor's announced rejection: this replica NEVER stages
    the snapshot, and announces the rejection itself."""
    target = _saved(tmp_path)
    kv, registry, watcher, ann = _fleet_fixture(tmp_path, "c")
    kv.key_value_set("fleet/a", json.dumps(
        {"replica": "a", "time": time.time(), "snap_id": -1,
         "rejected": [target]}))
    coord = RollingDeployCoordinator(kv, ann, watcher,
                                     predecessor_timeout_s=30.0)
    assert coord.step() is False
    assert target in watcher._rejected_ids
    assert "default" not in registry.ids()
    assert target in ReplicaAnnouncer.read_fleet(kv)["c"]["rejected"]
    assert coord.step() is False


# ------------------------------------------------------- cluster provider
def test_fleet_cluster_provider_stats_and_prometheus(tmp_path):
    kv = FileKvClient(str(tmp_path))
    now = time.time()
    kv.key_value_set("fleet/a", json.dumps(
        {"replica": "a", "time": now, "snap_id": 3,
         "metrics": {"requests": 10, "shed": 1}}))
    kv.key_value_set("fleet/b", json.dumps(
        {"replica": "b", "time": now, "snap_id": 4,
         "metrics": {"requests": 5, "shed": 0}}))
    kv.key_value_set("fleet/c", json.dumps(
        {"replica": "c", "time": now - 100, "snap_id": 2,
         "metrics": {"requests": 99, "shed": 9}}))
    kv.key_value_set("fleet/d\"q", json.dumps(
        {"replica": "d\"q", "time": now - 100}))
    prov = FleetClusterProvider(kv, lease_s=10.0)
    stats = prov.cluster_stats()
    assert stats["fleet"]["replicas"] == 4
    assert stats["fleet"]["live"] == 2
    assert stats["fleet"]["requests"] == 15
    assert stats["fleet"]["shed"] == 1
    assert stats["fleet"]["snap_id_min"] == 3
    assert stats["fleet"]["snap_id_max"] == 4
    assert stats["fleet"]["rolling"] is True
    text = prov.cluster_prometheus()
    assert 'lgbm_fleet_replica_up{replica="a"} 1' in text
    assert 'lgbm_fleet_replica_up{replica="c"} 0' in text
    assert 'lgbm_fleet_replica_up{replica="d\\"q"} 0' in text
    assert 'lgbm_fleet_replica_snap_id{replica="b"} 4' in text
    assert "lgbm_fleet_live_replicas 2" in text
    assert "lgbm_fleet_rolling 1" in text
    ref = jfleet.FleetClusterProvider(jfleet.FileKvClient(str(tmp_path)),
                                      lease_s=10.0)
    assert ref.cluster_stats()["fleet"] == stats["fleet"]
    assert ref.cluster_prometheus() == text


# ------------------------------------------------------- the drift loop
def test_drift_warn_polls_the_directory_once(tmp_path):
    """A shifted stream through the port's engine turns its monitor to
    warn; the watcher's hook polls the checkpoint directory once, off the
    request thread, and rolls the refit snapshot in."""
    from lightgbm_tpu_torch.obs.drift import DataProfile
    bst, _, x, y, _ = _trained("binary")
    d = str(tmp_path / "ckpt")
    CheckpointManager(d).save(bst)
    eng = ServingEngine(device="cpu", max_batch=256, min_bucket=16,
                        drift_min_rows=100)
    watcher = eng.registry.watch_dir("default", d, engine=eng)
    assert watcher.poll()
    polls = []
    real = watcher.poll

    def counted():
        polls.append(threading.current_thread().name)
        return real()
    watcher.poll = counted
    shifted = x + np.array([3.0] + [0.0] * (x.shape[1] - 1))
    window = tlgb.Dataset(shifted, label=y, device="cpu").construct()
    CheckpointManager(d).save_refit(
        bst.refit(shifted, y, decay_rate=0.0),
        data_profile=DataProfile.from_binned_dataset(window._binned))
    before = eng.registry.generation("default")
    for lo in range(0, 400, 100):
        eng.predict("default", shifted[lo:lo + 100])
    deadline = time.monotonic() + 30
    while eng.registry.generation("default") == before \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert polls and all(n.startswith("ckpt-drift-poll") for n in polls)
    assert len(polls) == 1
    assert eng.registry.generation("default") == before + 1
    eng.predict("default", shifted[:200])
    assert eng.drift_status()["status"] in ("ok", "no_profile")


def _get(host, port, path):
    with urllib.request.urlopen("http://%s:%d%s" % (host, port, path),
                                timeout=10) as r:
        body = r.read()
    return json.loads(body) if path != "/metrics/cluster" else body.decode()


def test_build_app_wires_qos_the_tuner_and_the_fleet(tmp_path):
    """``serve_qos_*``, ``serve_latency_budget_ms`` and ``fleet_kv_dir``
    with ``checkpoint_dir``: the queue's policy, the tuner, an announced
    replica that rolled the directory's snapshot through its coordinator,
    and /stats, /stats/cluster and /metrics/cluster over HTTP."""
    _saved(tmp_path)
    cfg = Config({"device_type": "cpu", "verbosity": -1,
                  "checkpoint_dir": str(tmp_path / "ckpt"),
                  "fleet_kv_dir": str(tmp_path / "kv"),
                  "fleet_replica": "r1", "fleet_announce_period_s": 0.05,
                  "serve_qos_weights": "default=2",
                  "serve_qos_quota_rows": 512,
                  "serving_cascade_trees": 2,
                  "serve_latency_budget_ms": 50.0,
                  "serve_min_bucket": 16, "serve_max_batch": 64})
    app = build_app(cfg)
    server = make_server(app, "127.0.0.1", 0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    host, port = server.server_address
    try:
        assert app.queue.qos.weight("default") == 2.0
        assert app.tuner is not None and app.tuner._thread is not None
        assert app.watcher._thread is None   # driven by the coordinator
        assert app.watcher._last_id >= 0
        x = _data("binary")[0]
        app.handle_predict({"data": x[:5].tolist()})
        stats = _get(host, port, "/stats")
        assert stats["replica"]["snap_id"] == app.watcher._last_id
        assert stats["queue"]["qos"]["default"]["served_rows"] == 5
        assert stats["cascade_autotune"]["rungs"] == 4
        cluster = _get(host, port, "/stats/cluster")
        assert cluster["fleet"]["live"] == 1
        assert not cluster["fleet"]["rolling"]
        assert 'lgbm_fleet_replica_up{replica="r1"} 1' in \
            _get(host, port, "/metrics/cluster")
    finally:
        server.shutdown()
        server.server_close()
        app.close()
    assert app.tuner._thread is None and app.coordinator._thread is None
    assert "fleet/r1" not in FileKvClient(str(tmp_path / "kv")).keys(
        "fleet/")
