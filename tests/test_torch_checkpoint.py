"""Checkpoints and resume (``lightgbm_tpu_torch/checkpoint/``, ROADMAP
Queue 1 #12) in the port on the CPU, after the JAX package's
tests/test_checkpoint.py and tests/test_stream.py's streamed resume:

- a run stopped at iteration 3 and resumed from its directory ends with
  the uninterrupted run's model text, eval history and best iteration, byte
  for byte, for gbdt with bagging and ``feature_fraction``, DART, GOSS, RF
  with a valid set, CEGB, multiclass, valid sets with early stopping,
  frontier growth, float64 histograms and streamed training (the CPU's
  plain path repeats itself, so every case is held bit for bit);
- the real-process kills: the port's command line (``python -m
  lightgbm_tpu_torch``, ``device_type=cpu``) as golden, SIGTERM victim
  (``fault_inject=kill@iter:3:term``: the snapshot at the iteration
  boundary, exit -15) and SIGKILL victim (``kill@iter:3``, exit -9), each
  victim's directory resumed to the golden model file byte for byte;
- the manifest: the corrupt newest snapshot falls back, all corrupt
  raises, the ``.bak`` manifest, retention, a fingerprint mismatch raises,
  an empty directory starts fresh, a run at its target trains nothing;
- against the JAX package: ``dataset_fingerprint`` on the same dense data
  and on the same streamed source, the JAX package's ``read_snapshot`` and
  ``Manifest.verify_entry`` on a port snapshot, the port resuming from the
  JAX package's snapshot at iteration 3 (bagging on; gbdt, and RF, whose
  JAX snapshot lacks the running sums) held to the JAX
  package's uninterrupted run under the parity rule of
  tests/test_torch_regression.py (tree 0 identical, later trees under the
  f32 tie rule, raw predictions within 1e-4), and the snapshot's data
  profile equal to the JAX package's;
- serving a snapshot: ``watch_dir`` rolls the newest snapshot in, answers
  as its booster's ``predict`` bit for bit, and the bundle has a profile.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import glob
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import callback as jcallback
from lightgbm_tpu.checkpoint import manifest as jmanifest
from lightgbm_tpu.checkpoint import snapshot as jsnapshot
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.obs.drift import DataProfile as JDataProfile
from lightgbm_tpu.stream import ArraySource as JArraySource
from lightgbm_tpu.stream.sampler import ingest as jingest
from lightgbm_tpu_torch import callback
from lightgbm_tpu_torch.checkpoint import (CheckpointManager, load_latest,
                                           snapshot)
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.serving import ServingEngine
from lightgbm_tpu_torch.stream import ArraySource, ingest

from test_torch_regression import assert_tie_rule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(objective="binary", num_leaves=5, learning_rate=0.2,
            min_data_in_leaf=5, verbosity=-1)
TOTAL, KILL_AT = 8, 3


def _data(n=300, f=6, seed=7, num_class=1):
    r = np.random.RandomState(seed)
    x = r.randn(n, f)
    s = x[:, 0] + 2 * x[:, 1] + 0.3 * r.randn(n)
    y = (s > 0) if num_class == 1 else np.digitize(s, [-1.0, 0.0, 1.0])
    return x, y.astype(np.float64)


def _train(params, ckpt, rounds, resume=False, valid=False, early_stop=False,
           num_class=1, data=None):
    x, y = data if data is not None else _data(num_class=num_class)
    ds = tlgb.Dataset(x, label=y, params=dict(params), device="cpu")
    valid_sets = None
    if valid:
        xv, yv = _data(n=150, seed=8, num_class=num_class)
        valid_sets = [ds.create_valid(xv, label=yv)]
    cbs = [callback.checkpoint(ckpt, period=1)]
    if early_stop:
        cbs.append(callback.early_stopping(3, verbose=False))
    ev = {}
    bst = tlgb.train(dict(params), ds, num_boost_round=rounds,
                     valid_sets=valid_sets, callbacks=cbs, evals_result=ev,
                     resume_from=ckpt if resume else None,
                     verbose_eval=False, device="cpu")
    return bst, ev


RESUME_CASES = {
    "gbdt_bagging_ff": (dict(BASE, bagging_fraction=0.7, bagging_freq=1,
                             feature_fraction=0.8), {}),
    "dart": (dict(BASE, boosting="dart", drop_rate=0.3), {}),
    "goss": (dict(BASE, boosting="goss"), {}),
    "rf_valid": (dict(BASE, boosting="rf", bagging_fraction=0.7,
                      bagging_freq=1, feature_fraction=0.8),
                 dict(valid=True)),
    "cegb": (dict(BASE, cegb_penalty_split=0.01,
                  cegb_penalty_feature_coupled=[0.3] * 6,
                  cegb_penalty_feature_lazy=[0.05] * 6,
                  bagging_fraction=0.8, bagging_freq=1), {}),
    "multiclass": (dict(BASE, objective="multiclass", num_class=4,
                        bagging_fraction=0.7, bagging_freq=2),
                   dict(num_class=4, valid=True)),
    # overfits fast: the golden run stops at iteration 5, best at 2
    "valid_early_stopping": (dict(BASE, bagging_fraction=0.7,
                                  bagging_freq=1, learning_rate=1.0,
                                  num_leaves=15, metric="binary_logloss"),
                             dict(valid=True, early_stop=True)),
    "frontier": (dict(BASE, tree_growth="frontier", feature_fraction=0.8),
                 dict(valid=True)),
    "f64": (dict(BASE, gpu_use_dp=True, bagging_fraction=0.7,
                 bagging_freq=1), {}),
    "streamed": (dict(BASE, tree_growth="frontier",
                      data_stream_chunk_rows=100, bagging_fraction=0.8,
                      bagging_freq=1), {}),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_byte_identical(tmp_path, case):
    params, kw = RESUME_CASES[case]
    golden, ev_g = _train(params, str(tmp_path / "g"), TOTAL, **kw)
    # the interrupted run: KILL_AT rounds reach the directory
    _train(params, str(tmp_path / "i"), KILL_AT, **kw)
    resumed, ev_r = _train(params, str(tmp_path / "i"), TOTAL, resume=True,
                           **kw)
    assert len(golden.models) >= KILL_AT + 2
    if kw.get("early_stop"):
        assert golden.best_iteration < len(golden.models) < TOTAL
    if case == "streamed":
        assert resumed._impl._stream is not None
    assert golden.model_to_string() == resumed.model_to_string()
    assert ev_g == ev_r
    assert golden.best_iteration == resumed.best_iteration


def test_resume_from_empty_dir_is_fresh_start(tmp_path):
    bst, _ = _train(BASE, str(tmp_path / "fresh"), 3, resume=True)
    assert bst.current_iteration() == 3


def test_resume_past_target_trains_nothing(tmp_path):
    _train(BASE, str(tmp_path / "c"), 4)
    bst, _ = _train(BASE, str(tmp_path / "c"), 4, resume=True)
    assert bst.current_iteration() == 4


def test_checkpoint_dir_param_attaches_callback(tmp_path):
    d = str(tmp_path / "auto")
    x, y = _data()
    tlgb.train(dict(BASE, checkpoint_dir=d, checkpoint_period=2),
               tlgb.Dataset(x, label=y, device="cpu"), num_boost_round=5,
               verbose_eval=False, device="cpu")
    # every second iteration and the last
    assert sorted(e["id"] for e in
                  jmanifest.Manifest.load(d).entries) == [2, 4, 5]
    assert load_latest(d).iteration == 5
    with pytest.raises(LightGBMError):
        Config({"checkpoint_period": 0})


# ------------------------------------------------- kill and resume, CLI
CLI_PARAMS = ["task=train", "data=train.csv", "objective=binary",
              "num_leaves=4", "num_iterations=%d" % TOTAL,
              "bagging_fraction=0.7", "bagging_freq=1", "device_type=cpu",
              "checkpoint_dir=ckpt", "resume=ckpt",
              "output_model=final.txt", "verbosity=-1"]
CLI_RUNS = {"golden": [], "term": ["fault_inject=kill@iter:%d:term"
                                   % KILL_AT],
            "kill": ["fault_inject=kill@iter:%d" % KILL_AT]}


def _cli(cwd, extra):
    """The port's command line in ``cwd``: every path relative, so the
    parameters each model file echoes are the same in every directory."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", "lightgbm_tpu_torch"]
                            + CLI_PARAMS + extra, cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """{run: (victim's return code, stderr, model text after the resume,
    snapshot files the victim left)}: the golden run and both victims at
    once, then both victims' directories resumed at once."""
    x, y = _data(n=200, f=5)
    dirs = {}
    for name in CLI_RUNS:
        d = tmp_path_factory.mktemp("cli_" + name)
        np.savetxt(d / "train.csv", np.column_stack([y, x]), delimiter=",",
                   fmt="%.17g")
        dirs[name] = d
    procs = {name: _cli(dirs[name], extra) for name, extra in
             CLI_RUNS.items()}
    first = {name: (p.wait(timeout=300), p.communicate()[1])
             for name, p in procs.items()}
    assert first["golden"][0] == 0, first["golden"][1][-2000:]
    left = {name: sorted(os.path.basename(p) for p in glob.glob(
        str(dirs[name] / "ckpt" / "snap_*.model.txt")))
        for name in ("term", "kill")}
    procs = {name: _cli(dirs[name], []) for name in ("term", "kill")}
    out = {}
    for name, p in procs.items():
        rc = p.wait(timeout=300)
        assert rc == 0, p.communicate()[1][-2000:]
        out[name] = (first[name][0], first[name][1],
                     (dirs[name] / "final.txt").read_text(), left[name])
    out["golden"] = (dirs["golden"] / "final.txt").read_text()
    return out


@pytest.mark.parametrize("run,signum,last_snapshot",
                         [("term", signal.SIGTERM, KILL_AT + 1),
                          ("kill", signal.SIGKILL, KILL_AT)])
def test_cli_kill_and_resume_byte_identical(cli_runs, run, signum,
                                            last_snapshot):
    """SIGTERM is latched and the snapshot of the iteration it landed in
    written before the process dies of it; SIGKILL leaves the snapshots
    of the iterations before it. Either way the resumed model file is the
    golden one."""
    rc, err, resumed, left = cli_runs[run]
    assert rc == -signum, err[-2000:]
    assert left[-1] == "snap_%08d.model.txt" % last_snapshot
    assert resumed == cli_runs["golden"]


# ---------------------------------------------------- manifest, fallback
@pytest.fixture(scope="module")
def five_snapshots(tmp_path_factory):
    """A directory of a 5-round run with every snapshot kept, and its
    booster: copied by each test that corrupts it."""
    d = str(tmp_path_factory.mktemp("five") / "c")
    x, y = _data()
    bst = tlgb.train(dict(BASE), tlgb.Dataset(x, label=y, device="cpu"),
                     num_boost_round=5,
                     callbacks=[callback.checkpoint(d, keep_last_n=10)],
                     verbose_eval=False, device="cpu")
    return d, bst


def _copy(src, tmp_path):
    dst = str(tmp_path / "copy")
    shutil.copytree(src, dst)
    return dst


def _corrupt(path, truncate=False):
    with open(path, "r+b") as f:
        if truncate:
            f.truncate(10)
        else:
            f.write(b"\x00" * 64)


def _newest(d, kind, back=1):
    return sorted(glob.glob(os.path.join(d, "snap_*." + kind)))[-back]


def test_corrupt_newest_snapshot_falls_back(five_snapshots, tmp_path):
    d = _copy(five_snapshots[0], tmp_path)
    assert load_latest(d).iteration == 5
    _corrupt(_newest(d, "state.npz"))
    assert load_latest(d).iteration == 4
    # a truncated write (the preemption artifact) is caught too
    _corrupt(_newest(d, "meta.json", back=2), truncate=True)
    assert load_latest(d).iteration == 3
    # and resume from the fallback ends where the uninterrupted run does
    golden, _ = _train(BASE, str(tmp_path / "g"), TOTAL)
    resumed, _ = _train(BASE, d, TOTAL, resume=True)
    assert golden.model_to_string() == resumed.model_to_string()


def test_all_snapshots_corrupt_raises(five_snapshots, tmp_path):
    d = _copy(five_snapshots[0], tmp_path)
    for p in glob.glob(os.path.join(d, "snap_*.state.npz")):
        _corrupt(p)
    with pytest.raises(LightGBMError, match="none passed verification"):
        load_latest(d)


def test_manifest_bak_fallback(five_snapshots, tmp_path):
    d = _copy(five_snapshots[0], tmp_path)
    os.remove(os.path.join(d, "MANIFEST.json"))
    assert load_latest(d).iteration == 4    # .bak: the previous publish


def test_retention_keeps_last_n(tmp_path):
    """The newest ``checkpoint_keep`` snapshots and the best so far by the
    valid set's metric; the others' files are deleted."""
    d = str(tmp_path / "r")
    x, y = _data()
    ds = tlgb.Dataset(x, label=y, device="cpu")
    xv, yv = _data(n=150, seed=8)
    tlgb.train(dict(BASE, checkpoint_dir=d, checkpoint_keep=2,
                    learning_rate=1.0, num_leaves=15), ds,
               num_boost_round=6, valid_sets=[ds.create_valid(xv, label=yv)],
               verbose_eval=False, device="cpu")
    entries = jmanifest.Manifest.load(d).entries
    ids = sorted(e["id"] for e in entries)
    files = sorted(int(os.path.basename(p)[5:13]) for p in
                   glob.glob(os.path.join(d, "snap_*.state.npz")))
    best = [e["id"] for e in entries if e.get("best")]
    assert ids == files and ids[-2:] == [5, 6] and len(best) == 1
    assert ids == sorted(set([5, 6] + best))


def test_dataset_fingerprint_mismatch_raises(five_snapshots, tmp_path):
    d = _copy(five_snapshots[0], tmp_path)
    with pytest.raises(LightGBMError, match="fingerprint"):
        _train(BASE, d, TOTAL, resume=True, data=_data(seed=99))


# ---------------------------------------------------- the JAX package
def test_fingerprint_equals_jax_dense_and_streamed():
    x, y = _data(n=2000)
    params = dict(BASE, bagging_fraction=0.7, bagging_freq=1)
    ours = tlgb.Dataset(x, label=y, params=dict(params),
                        device="cpu").construct()._binned
    ref = jlgb.Dataset(x, label=y, params=dict(params)).construct()._binned
    assert snapshot.dataset_fingerprint(ours) == \
        jsnapshot.dataset_fingerprint(ref)
    streamed = dict(params, tree_growth="frontier",
                    data_stream_chunk_rows=600)
    ours = ingest(ArraySource(x, label=y, chunk_rows=600), Config(streamed))
    ref = jingest(JArraySource(x, label=y, chunk_rows=600),
                  JConfig(streamed))
    assert snapshot.dataset_fingerprint(ours) == \
        jsnapshot.dataset_fingerprint(ref)
    assert ours.data_profile().to_json_dict() == \
        JDataProfile.from_binned_chunks(ref).to_json_dict()


def test_jax_reads_port_snapshot(five_snapshots):
    d, bst = five_snapshots
    manifest = jmanifest.Manifest.load(d)
    entry = manifest.latest_valid_entry()
    assert entry["id"] == 5 and manifest.verify_entry(entry)
    meta, arrays, model_path = jsnapshot.read_snapshot(d, entry)
    assert meta["iteration"] == 5 and meta["boosting_type"] == "gbdt"
    np.testing.assert_array_equal(arrays["scores"], bst._impl.scores_of(0)
                                  .reshape(-1, 1))
    assert open(model_path).read() == bst.model_to_string()
    ref = JDataProfile.from_binned_dataset(
        jlgb.Dataset(*_data()).construct()._binned)
    assert meta["data_profile"] == ref.to_json_dict()


@pytest.mark.parametrize("boosting", ["gbdt", "rf"])
def test_port_resumes_jax_snapshot(tmp_path, boosting):
    """RF: the JAX package's snapshot lacks the running sums, which the
    port rebuilds from the averaged scores."""
    params = dict(BASE, bagging_fraction=0.7, bagging_freq=1,
                  boosting=boosting)
    x, y = _data()

    def jax_run(d, rounds):
        return jlgb.train(dict(params), jlgb.Dataset(x, label=y),
                          num_boost_round=rounds,
                          callbacks=[jcallback.checkpoint(d, period=1)],
                          verbose_eval=False)
    golden = jax_run(str(tmp_path / "g"), TOTAL)
    d = str(tmp_path / "i")
    jax_run(d, KILL_AT)
    resumed, _ = _train(params, d, TOTAL, resume=True)
    jt, tt = golden._impl.models, resumed.models
    assert len(jt) == len(tt) == TOTAL
    for a, b in zip(jt[:KILL_AT + 1], tt[:KILL_AT + 1]):
        # the restored trees and the first one grown on restored state
        nn = a.num_leaves_actual - 1
        assert b.num_leaves_actual - 1 == nn
        for name in ("split_feature", "threshold_bin", "left_child",
                     "right_child", "default_left"):
            np.testing.assert_array_equal(getattr(b, name)[:nn],
                                          getattr(a, name)[:nn])
    for a, b in zip(jt[KILL_AT + 1:], tt[KILL_AT + 1:]):
        assert_tie_rule(a, b)
    np.testing.assert_allclose(resumed.predict(x, raw_score=True),
                               golden.predict(x, raw_score=True), rtol=0,
                               atol=1e-4)


# ---------------------------------------------------------- serving
def test_watch_dir_serves_the_newest_snapshot(five_snapshots):
    d, bst = five_snapshots
    x, _ = _data()
    eng = ServingEngine(device="cpu", max_batch=64, min_bucket=16)
    watcher = eng.registry.watch_dir("m", d, engine=eng)
    assert watcher.poll() is True
    assert watcher.poll() is False           # nothing newer
    np.testing.assert_array_equal(eng.predict("m", x), bst.predict(x))
    assert eng.registry.get("m").profile is not None
    assert eng.drift_status()["status"] != "no_profile"
    # a bare re-registration of a live id is refused
    with pytest.raises(LightGBMError, match="replace=True"):
        eng.registry.load_file("m", CheckpointManager(d).latest_model()[1])
