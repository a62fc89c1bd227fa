"""Exact growth, row sampling and float64 on a rank group, held to the JAX
package's serial runs (and the draws to the port's own), on the CPU.

- Exact growth over thread ranks at 2,001 rows (a short last block over
  8 ranks; ``make_binary``, num_leaves=15, max_bin=63, 3 rounds): the
  data-parallel all-reduce (``tree_learner=data``), with forced splits and
  with CEGB (its lazy costs' unpaid rows summed over the ranks), the
  full-``top_k`` vote and feature-parallel (3 ranks, bin-balanced columns,
  the best splits elected): tree 0 is the JAX package's serial tree node
  for node, leaf values within 1e-5 relative; every tree keeps its split
  count and raw predictions agree within 1e-4.
- ``gpu_use_dp`` data-parallel trees over 8 ranks are the JAX package's
  serial float64 trees node for node (tests/test_torch_f64.py's
  configuration, 3,000 rows, and its bagging case with the x64 draws),
  leaf values within its LEAF_REL; x64 is switched off after each JAX
  training.
- Bagging: every rank draws over all the rows from the serial key and
  keeps its block, so the ranks' masks, laid end to end, are the JAX
  package's and the serial port's masks bit for bit; the model is the
  JAX package's serial model under the tie rule, raw predictions within
  2e-4 (tests/test_torch_parallel_options.py's ``assert_jax_serial``).
- GOSS on a data mesh takes its counts and threshold from the real rows
  (tests/test_parallel.py::test_goss_under_mesh_uses_real_counts): every
  rank sizes the top and the rest from 1,501 rows, not the padded 1,504,
  and the model is the JAX package's serial GOSS model, as above.
- A thread rank's checkpoint holds every row's state and resumes on the
  uninterrupted run's model.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import json
import shutil

import jax
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu.boosting.gbdt as jgbdt
import lightgbm_tpu_torch as tlgb
from chip_smoke import bench_data
from lightgbm_tpu_torch.boosting import goss as port_goss

from conftest import make_binary
from test_torch_parallel_options import assert_jax_serial
from test_torch_sampling import _record
from test_torch_f64 import (LEAF_REL, PARAMS as F64_PARAMS, _jax_f64,
                            assert_trees_equal)

MESH = {"mesh_shape": [8]}
PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "verbosity": -1}
ROUNDS = 3
FORCED = {"feature": 0, "threshold": 0.0,
          "left": {"feature": 1, "threshold": 0.0}}
CEGB = {"cegb_penalty_split": 0.002,
        "cegb_penalty_feature_coupled": [0.5] * 10,
        "cegb_penalty_feature_lazy": [0.02] * 10}
EXACT = {
    "data": ({"tree_learner": "data"}, "psum"),
    "forced": ({"tree_learner": "data"}, "psum"),
    "cegb": (dict(CEGB, tree_learner="data"), "psum"),
    "voting_full": ({"tree_learner": "voting", "top_k": 10}, "voting"),
    "feature": ({"tree_learner": "feature", "mesh_shape": [3]}, "feature"),
}


@pytest.fixture(autouse=True)
def x64_stays_off():
    assert not jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def forced_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("parallel") / "forced.json"
    path.write_text(json.dumps(FORCED))
    return str(path)


def _port(params, x, y, rounds=ROUNDS):
    return tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                      num_boost_round=rounds, device="cpu")


@pytest.mark.parametrize("case", sorted(EXACT))
def test_exact_growth_on_ranks_is_the_jax_serial_growth(case, forced_file):
    extra, kind = EXACT[case]
    x, y = make_binary(n=2001, f=10)
    serial = dict(PARAMS, **{k: v for k, v in extra.items()
                             if k not in ("tree_learner", "top_k",
                                          "mesh_shape")})
    if case == "forced":
        serial["forcedsplits_filename"] = forced_file
    jb = jlgb.train(serial, jlgb.Dataset(x, label=y),
                    num_boost_round=ROUNDS)
    tb = _port(dict(serial, **dict(MESH, **extra)), x, y)
    impl = tb._impl
    assert impl._dist.kind == kind
    assert impl.num_data == (2001 if kind == "feature" else 251)
    jt, tt = jb._impl.models[0], tb.models[0]
    nn = jt.num_leaves_actual - 1
    assert tt.num_leaves_actual == jt.num_leaves_actual
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child", "default_left", "split_leaf"):
        np.testing.assert_array_equal(getattr(tt, name)[:nn],
                                      getattr(jt, name)[:nn], err_msg=name)
    np.testing.assert_allclose(tt.leaf_value[:nn + 1],
                               jt.leaf_value[:nn + 1], rtol=1e-5, atol=1e-7)
    if case == "forced":
        assert all(int(t.split_feature[0]) == 0 for t in tb.models)
    for jt, tt in zip(jb._impl.models, tb.models):
        assert tt.num_leaves_actual == jt.num_leaves_actual
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=0,
                               atol=1e-4)


F64_CASES = {
    "binary": {"objective": "binary"},
    "bagging": {"objective": "binary", "bagging_fraction": 0.7,
                "bagging_freq": 1},
}


@pytest.mark.parametrize("case", sorted(F64_CASES))
def test_gpu_use_dp_on_ranks_is_the_jax_serial_f64_growth(case):
    x, y = bench_data(3000)
    if case == "bagging":
        x = x[:, :8]
    params = dict(F64_PARAMS, **F64_CASES[case])

    def train():
        jb = jlgb.train(params, jlgb.Dataset(x, label=y),
                        num_boost_round=ROUNDS)
        assert jb._impl.grow_params.hist_dtype == "f64"
        return jb._impl.models
    jmodels = _jax_f64(train)
    tb = _port(dict(params, tree_learner="data", **MESH), x, y)
    assert tb._impl.grow_params.hist_dtype == "f64"
    assert tb._impl._dist.kind == "psum"
    assert len(tb.models) == len(jmodels) == ROUNDS
    for jt, tt in zip(jmodels, tb.models):
        assert tt.num_leaves_actual > 1
        assert_trees_equal(jt, tt, LEAF_REL)


def test_bagging_draws_are_the_serial_ports(monkeypatch):
    x, y = make_binary(n=1001, f=6)
    params = dict(PARAMS, bagging_fraction=0.5, bagging_freq=1,
                  feature_fraction=0.7)
    jax_masks = []
    _record(monkeypatch, jgbdt.GBDT, "_sample_bagging_mask", jax_masks)
    jb = jlgb.Booster(params, jlgb.Dataset(x, label=y))
    serial = tlgb.Booster(params, tlgb.Dataset(x, label=y, device="cpu"),
                          device="cpu")
    meshed = tlgb.Booster(dict(params, tree_learner="data", **MESH),
                          tlgb.Dataset(x, label=y, device="cpu"),
                          device="cpu")
    for i in range(ROUNDS):
        jb.update()
        serial.update()
        meshed.update()
        got = meshed._impl._gather_attr(lambda g: g._bag_mask).numpy()
        np.testing.assert_array_equal(got, serial._impl._bag_mask.numpy())
        np.testing.assert_array_equal(got, jax_masks[i])
    assert_jax_serial(jb, meshed, x)
    np.testing.assert_allclose(meshed.predict(x, raw_score=True),
                               serial.predict(x, raw_score=True), rtol=0,
                               atol=1e-5)


def test_goss_on_a_data_mesh_counts_the_real_rows(monkeypatch):
    x, y = make_binary(n=1501)
    params = {"objective": "binary", "metric": "auc", "boosting": "goss",
              "top_rate": 0.3, "other_rate": 0.2, "learning_rate": 0.1,
              "verbosity": -1}
    seen = []
    counts = port_goss.goss_counts

    def recording(n, top_rate, other_rate):
        seen.append(n)
        return counts(n, top_rate, other_rate)

    monkeypatch.setattr(port_goss, "goss_counts", recording)
    meshed = _port(dict(params, tree_learner="data", **MESH), x, y, 12)
    assert meshed._impl._layout.num_padded == 1504
    # GOSS samples from the 10th iteration on, on each of the 8 ranks
    assert seen == [1501] * (8 * 2)
    jb = jlgb.train(params, jlgb.Dataset(x, label=y), num_boost_round=12)
    assert_jax_serial(jb, meshed, x)


def test_thread_ranks_checkpoint_and_resume(tmp_path):
    x, y = make_binary(n=1001, f=6)
    ckpt = str(tmp_path / "ckpt")
    params = dict(PARAMS, tree_learner="data", bagging_fraction=0.5,
                  bagging_freq=1, checkpoint_dir=ckpt, **MESH)
    full = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"), 6,
                      device="cpu")
    shutil.rmtree(ckpt)
    tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"), 3,
               device="cpu")
    resumed = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"), 6,
                         resume_from=ckpt, device="cpu")
    assert resumed.model_to_string() == full.model_to_string()
