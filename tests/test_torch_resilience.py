"""Fault injection and supervised training (``lightgbm_tpu_torch/
resilience/``, ROADMAP Queue 1 #18) in the port on the CPU, after the JAX
package's tests/test_resilience.py (its KV, loopback and serving-queue
cases belong to #13 and to tests/test_torch_serving.py):

- fault plans parse the JAX package's units and arguments, malformed
  tokens fail, a ``kv_*`` kind refuses (its seam is the device mesh's,
  #13), ``inject`` is inert without a plan and a numbered fault fires
  once; ``Config`` validates ``fault_inject``;
- the watchdog's warm-up grace and its firing (the abort event, then
  ``WatchdogAbort`` at the next seam), the heartbeat file, the
  supervisor's retries, its exhaustion (the message without a flight-dump
  suffix when the run keeps no flight recorder) and its need of a
  checkpoint directory, ``ProcessSupervisor`` on a trivial child and its
  budget, ``ckpt_torn`` breaking the sha and the manifest falling back;
- the options ``train`` used to accept and ignore: ``fault_inject=
  crash@iter:2`` now raises, in the fused loop too; ``supervise=true``
  restarts a crash at iteration 3 from its checkpoint and ends with the
  uninterrupted run's trees byte for byte (the parameters each model text
  echoes differ, as the parameters do); an exhausted supervisor raises; a
  ``hang`` fault is woken by the watchdog and the run resumes;
- serving: the guarded roll refuses a NaN model and the prior generation
  keeps serving, also through the checkpoint watcher, which remembers the
  refusal; ``build_app`` with ``checkpoint_dir`` serves the newest snapshot
  and ``fault_inject=serve_error`` reaches the breaker;
- what still refuses, citing its item: ``KvHeartbeat`` (#13);
  ``save_refit`` and ``arm_drift_refit`` are ported with the fleet
  (tests/test_torch_fleet.py).
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import os
import re
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.checkpoint import (CheckpointManager, load_latest,
                                           snapshot)
from lightgbm_tpu_torch.checkpoint.manifest import Manifest, sha256_file
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.resilience import faults
from lightgbm_tpu_torch.resilience.supervisor import (
    ATTEMPT_ENV, KvHeartbeat, ProcessSupervisor, Supervisor, Watchdog,
    heartbeat_file_callback)
from lightgbm_tpu_torch.serving import ServingEngine, build_app
import lightgbm_tpu_torch.checkpoint.manager as manager_mod

BASE = dict(objective="binary", num_leaves=5, min_data_in_leaf=5,
            verbosity=-1)
FAST_RESTART = dict(supervise_backoff_s=0.01, supervise_backoff_max_s=0.02)


@pytest.fixture(autouse=True)
def _clean_plan():
    faults.clear_plan()
    yield
    faults.clear_plan()


def _data(n=200, f=5, seed=9):
    r = np.random.RandomState(seed)
    x = r.randn(n, f)
    y = (x[:, 0] + 2 * x[:, 1] + 0.2 * r.randn(n) > 0).astype(np.float64)
    return x, y


def _train(params, rounds=6, **kw):
    x, y = _data()
    return tlgb.train(dict(params), tlgb.Dataset(x, label=y, device="cpu"),
                      num_boost_round=rounds, verbose_eval=False,
                      device="cpu", **kw)


def _trees(text):
    return text.split("\nparameters:", 1)[0]


# ------------------------------------------------------------- fault plans
def test_fault_plan_parses_units_and_args():
    plan = faults.parse_plan("kill@iter:7,serve_error@req:50,"
                             "serve_delay@request:*:125,hang@iteration:3:10,"
                             "ckpt_torn@snap:2,crash@block:1")
    specs = {repr(f) for f in plan.faults}
    assert specs == {"kill@iteration:7", "serve_error@request:50",
                     "serve_delay@request:*:125", "hang@iteration:3:10",
                     "ckpt_torn@snapshot:2", "crash@round:1"}
    d = [f for f in plan.faults if f.kind == "serve_delay"][0]
    assert d.match is None and d.arg_float(0.0) == 125.0
    h = [f for f in plan.faults if f.kind == "hang"][0]
    assert h.arg_float(3600.0) == 10.0


@pytest.mark.parametrize("bad", ["bogus@iter:1", "kill", "kill@iter:x",
                                 "kill@:3"])
def test_fault_plan_rejects_malformed(bad):
    with pytest.raises(LightGBMError):
        faults.parse_plan(bad)


@pytest.mark.parametrize("kind", ["kv_timeout", "kv_error", "kv_set_error",
                                  "kv_delay"])
def test_kv_fault_kinds_refuse(kind):
    with pytest.raises(NotImplementedError, match="#13"):
        faults.parse_plan("%s@round:2" % kind)
    with pytest.raises(NotImplementedError, match="#13"):
        Config({"fault_inject": "crash@iter:3,%s@round:1" % kind})


def test_inject_inert_without_plan_and_single_shot():
    faults.inject("serve_predict")
    faults.inject("train_dispatch", iteration=7)
    faults.install_plan("serve_error@req:2")
    faults.inject("serve_predict")                 # request 1: no fire
    with pytest.raises(LightGBMError, match="injected serving fault"):
        faults.inject("serve_predict")             # request 2: fires
    faults.inject("serve_predict")                 # single shot: spent
    # an identical plan re-installed is kept (fire counts survive restarts)
    plan = faults.active_plan()
    assert faults.install_plan("serve_error@req:2") is plan
    faults.inject("serve_predict")


def test_config_validates_fault_plan():
    c = Config({"fault_inject": "crash@iter:3", "fault_seed": 5})
    assert c.fault_inject == "crash@iter:3" and c.fault_seed == 5
    with pytest.raises(LightGBMError):
        Config({"fault_inject": "nope@iter:1"})


def test_ckpt_torn_breaks_the_sha(tmp_path):
    faults.install_plan("ckpt_torn@snap:1")
    entry = snapshot.write_snapshot(
        str(tmp_path), 1, {"iteration": 1, "trees": {}},
        {"scores": np.zeros((8, 1), np.float32)}, "model-text")
    state = os.path.join(str(tmp_path), entry["files"]["state"])
    # the recorded sha is the one before the tear: verification fails
    assert sha256_file(state) != entry["sha256"][entry["files"]["state"]]
    assert not Manifest(str(tmp_path)).verify_entry(entry)


def test_ckpt_torn_in_training_falls_back(tmp_path):
    d = str(tmp_path / "c")
    _train(dict(BASE, checkpoint_dir=d, fault_inject="ckpt_torn@snap:4"),
           rounds=4)
    assert load_latest(d).iteration == 3
    assert CheckpointManager(d).latest_model()[0] == 3


# ---------------------------------------------------------------- watchdog
def test_watchdog_warmup_grace_no_false_fire():
    fired = []
    wd = Watchdog(0.15, warmup_grace_s=1.5, on_fire=fired.append).start()
    try:
        time.sleep(0.5)          # a slow first iteration, alive
        assert not wd.fired and not fired
        wd.beat()
        time.sleep(0.05)
        assert not wd.fired
    finally:
        wd.stop()
        faults.clear_abort()


def test_watchdog_fires_when_beats_stop():
    fired = []
    wd = Watchdog(0.1, warmup_grace_s=0.0, on_fire=fired.append).start()
    try:
        wd.beat()
        time.sleep(0.5)
        assert wd.fired and len(fired) == 1
        assert faults.abort_event().is_set()
        with pytest.raises(faults.WatchdogAbort):
            faults.inject("train_dispatch", iteration=0)
    finally:
        wd.stop()
        faults.clear_abort()


def test_heartbeat_file_callback_touches(tmp_path):
    path = str(tmp_path / "hb")
    cb = heartbeat_file_callback(path)
    assert cb.before_iteration
    cb(SimpleNamespace(iteration=4))
    assert open(path).read().startswith("4 ")


# -------------------------------------------------------------- supervisor
def test_supervisor_needs_checkpoint_dir():
    with pytest.raises(LightGBMError, match="checkpoint_dir"):
        Supervisor("")
    with pytest.raises(LightGBMError, match="checkpoint_dir"):
        _train(dict(BASE, supervise=True), rounds=2)


def test_supervisor_retries_then_succeeds(tmp_path):
    sup = Supervisor(str(tmp_path), max_restarts=3, backoff_s=0.01,
                     backoff_max_s=0.02)
    seen = []

    def attempt(resume, wd):
        seen.append(resume)
        if len(seen) < 3:
            raise RuntimeError("boom %d" % len(seen))
        return "done"

    assert sup.run(attempt) == "done"
    assert sup.restarts == 2
    assert seen == [None, str(tmp_path), str(tmp_path)]


@pytest.mark.parametrize("dump", [None, "/tmp/events.0.crash.jsonl"])
def test_supervisor_exhaustion_message(tmp_path, dump):
    sup = Supervisor(str(tmp_path), max_restarts=2, backoff_s=0.01,
                     backoff_max_s=0.02)

    def attempt(resume, wd):
        err = RuntimeError("persistent failure")
        if dump:
            err.flight_dump_path = dump
        raise err

    with pytest.raises(LightGBMError) as ei:
        sup.run(attempt)
    msg = str(ei.value)
    assert "after 2 restarts" in msg
    assert ("last flight dump" in msg) == bool(dump)
    assert sup.restarts == 3                     # the first try + 2


def test_process_supervisor_attempt_env():
    prog = ("import os, sys; "
            "sys.exit(0 if os.environ['%s'] == '1' else 7)" % ATTEMPT_ENV)
    sup = ProcessSupervisor([sys.executable, "-c", prog], max_restarts=2,
                            backoff_s=0.01, backoff_max_s=0.02)
    assert sup.run() == 0
    assert sup.restarts == 1 and sup.attempts == [7, 0]


def test_process_supervisor_kills_a_stale_heartbeat(tmp_path):
    """A child that never beats is killed after the grace and restarted;
    the budget then runs out."""
    hb = str(tmp_path / "hb")
    sup = ProcessSupervisor([sys.executable, "-c",
                             "import time; time.sleep(60)"], max_restarts=1,
                            backoff_s=0.01, backoff_max_s=0.02,
                            hang_timeout_s=0.3, warmup_grace_s=0.2,
                            heartbeat_file=hb, poll_s=0.05)
    with pytest.raises(LightGBMError, match="after 1 restarts"):
        sup.run()
    assert sup.hang_kills == 2 and sup.attempts == [-9, -9]
    cli = ProcessSupervisor.train_cli(["task=train", "device_type=cpu"])
    assert cli.argv[1:3] == ["-m", "lightgbm_tpu_torch"]


# ------------------------------------- the options train() used to ignore
def test_fault_inject_crash_now_raises():
    # no callback: the fused loop (GBDT.train_many) fires the seam too
    with pytest.raises(LightGBMError, match="injected crash"):
        _train(dict(BASE, fault_inject="crash@iter:2"), rounds=4)
    faults.clear_plan()
    with pytest.raises(LightGBMError, match="injected crash"):
        x, y = _data()
        ds = tlgb.Dataset(x, label=y, device="cpu")
        _train(dict(BASE, fault_inject="crash@iter:2"), rounds=4,
               valid_sets=[ds])


@pytest.fixture(scope="module")
def golden_text(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("golden") / "c")
    return _train(dict(BASE, checkpoint_dir=d)).model_to_string()


def test_supervised_crash_resume_byte_identical(tmp_path, golden_text):
    d = str(tmp_path / "v")
    victim = _train(dict(BASE, checkpoint_dir=d,
                         fault_inject="crash@iter:3", supervise=True,
                         **FAST_RESTART))
    assert faults.active_plan().faults[0].fires == 1
    assert _trees(victim.model_to_string()) == _trees(golden_text)


def test_supervised_hang_woken_by_the_watchdog(tmp_path, golden_text):
    d = str(tmp_path / "h")
    t0 = time.perf_counter()
    victim = _train(dict(BASE, checkpoint_dir=d,
                         fault_inject="hang@iter:2:60", supervise=True,
                         supervise_hang_timeout_s=0.5,
                         supervise_warmup_grace_s=5.0, **FAST_RESTART))
    assert time.perf_counter() - t0 < 30
    assert _trees(victim.model_to_string()) == _trees(golden_text)


def test_supervised_exhaustion_raises(tmp_path):
    p = dict(BASE, checkpoint_dir=str(tmp_path / "c"),
             fault_inject="crash@iter:*", supervise=True,
             supervise_max_restarts=1, **FAST_RESTART)
    with pytest.raises(LightGBMError, match="after 1 restart"):
        _train(p, rounds=4)


# ----------------------------------------------------------------- serving
def _tiny_model(tmp_path):
    r = np.random.RandomState(3)
    x = r.randn(160, 4)
    y = x[:, 0] * 2 + np.abs(x[:, 1]) + 0.1 * r.randn(160)
    bst = tlgb.train(dict(objective="regression", num_leaves=4,
                          min_data_in_leaf=5, verbosity=-1),
                     tlgb.Dataset(x, label=y, device="cpu"),
                     num_boost_round=3, verbose_eval=False, device="cpu")
    path = str(tmp_path / "good.txt")
    bst.save_model(path)
    return path, x[:4]


def _nan_copy(src, dst):
    def poison(m):
        return "leaf_value=" + " ".join(["nan"] * len(m.group(1).split()))
    with open(dst, "w") as f:
        f.write(re.sub(r"leaf_value=([^\n]+)", poison, open(src).read()))


def test_guarded_roll_rejects_nan_model(tmp_path):
    good, xq = _tiny_model(tmp_path)
    bad = str(tmp_path / "bad.txt")
    _nan_copy(good, bad)
    eng = ServingEngine(max_batch=16, min_bucket=16, device="cpu")
    eng.registry.register(eng.stage_and_prewarm("m", good), replace=True)
    ref = eng.predict("m", xq)
    with pytest.raises(LightGBMError, match="canary"):
        eng.stage_and_prewarm("m", bad)
    assert eng.metrics.rollbacks == 1
    out = eng.predict("m", xq)                    # the prior generation
    np.testing.assert_array_equal(out, ref)


def test_guarded_roll_watcher_keeps_serving(tmp_path, monkeypatch):
    good, xq = _tiny_model(tmp_path)
    eng = ServingEngine(max_batch=16, min_bucket=16, device="cpu")
    eng.registry.register(eng.stage_and_prewarm("m", good), replace=True)
    ref = eng.predict("m", xq)
    bad = str(tmp_path / "bad.txt")
    _nan_copy(good, bad)
    watcher = eng.registry.watch_dir("m", str(tmp_path), engine=eng)
    # the manifest's newest snapshot is the poisoned file
    monkeypatch.setattr(manager_mod.CheckpointManager, "latest_model",
                        lambda self: (1, bad))
    assert watcher.poll() is False                # refused, not rolled
    assert 1 in watcher._rejected_ids
    assert watcher.poll() is False                # remembered
    assert eng.metrics.rollbacks == 1
    np.testing.assert_array_equal(eng.predict("m", xq), ref)


def test_build_app_watches_and_injects(tmp_path):
    d = str(tmp_path / "c")
    bst = _train(dict(BASE, checkpoint_dir=d), rounds=3)
    x, _ = _data()
    app = build_app(Config({"device_type": "cpu", "checkpoint_dir": d,
                            "fault_inject": "serve_error@req:2",
                            "serve_breaker_failures": 1}))
    try:
        assert app.watcher is not None and app.watcher._thread is not None
        reply = app.handle_predict({"data": x[:5].tolist()})
        np.testing.assert_array_equal(reply["predictions"],
                                      bst.predict(x[:5]))
        with pytest.raises(LightGBMError, match="injected serving fault"):
            app.handle_predict({"data": x[:5].tolist()})
        assert app.breaker.state == "open"
    finally:
        app.close()
    assert app.watcher._thread is None


# ------------------------------------------------------- what still refuses
def test_refusals_cite_their_items(tmp_path):
    with pytest.raises(NotImplementedError, match="#13"):
        KvHeartbeat(namespace="x")
