"""The wave growers on a rank group, held to the JAX package, on the CPU.

Thread ranks (``mesh_shape=[8]``) against the JAX package's serial runs
(its own mesh trainings compile for tens of seconds and are marked slow):

- tests/test_parallel_learners.py's tie-free golden cases
  (``_golden_data``, ``_mesh8``, 5 rounds of frontier growth): the port's
  reduce-scatter (``tree_learner=data``), all-reduce
  (``tpu_frontier_rs=false``) and full-``top_k`` voting trees are the JAX
  package's serial frontier trees (``_canonical_splits``'s view: split
  and leaf multisets, leaf values within 1e-5), also on shards
  skewed by sorting the rows by label; raw predictions within 2e-4;
- voting with ``top_k=3`` is the JAX package's documented approximation
  (tests/test_parallel_learners.py:198-234): the train logloss never rises
  by more than 1e-6, ends below 0.8 of its start and within 10% of the
  JAX serial run's drop of it;
- batched and partitioned batched growth under ``tree_learner=data`` at
  2,001 rows over 8 ranks (a short last block): tree 0 is the JAX
  package's serial tree node for node, every tree keeps its split count,
  raw predictions within 1e-4;
- the payload counter of a frontier training reads a tally a wave.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)

import numpy as np
import pytest

import lightgbm_tpu_torch as tlgb

from conftest import make_binary
from test_grow_frontier import _golden_data, _train
from test_parallel_learners import _mesh8

MESH = {"mesh_shape": [8]}


def _port(params, x, y, rounds):
    return tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                      num_boost_round=rounds, device="cpu")


def _canonical(models, num=5):
    """``_canonical_splits`` over each tree's real nodes and leaves
    (``num_leaves_actual``, in both packages): the sorted (feature,
    threshold bin) multiset, and the leaves' (count, value) sorted."""
    out = []
    for t in models[:num]:
        nl = int(t.num_leaves_actual)
        splits = sorted(zip(t.split_feature[:nl - 1].tolist(),
                            t.threshold_bin[:nl - 1].tolist()))
        leaves = sorted(zip(t.leaf_count[:nl].tolist(),
                            t.leaf_value[:nl].tolist()))
        out.append((splits, leaves))
    return out


def assert_same_canonical(port_models, jax_models, num=5):
    ours, ref = _canonical(port_models, num), _canonical(jax_models, num)
    assert len(ours) == len(ref) == num
    for (s1, l1), (s2, l2) in zip(ours, ref):
        assert s1 == s2
        assert [c for c, _ in l1] == [c for c, _ in l2]
        np.testing.assert_allclose([v for _, v in l1], [v for _, v in l2],
                                   rtol=1e-5, atol=1e-7)


_SERIAL = {}


def _jax_serial(key, x, y, params, rounds):
    if key not in _SERIAL:
        _SERIAL[key] = _train(x, y, params, rounds=rounds)
    return _SERIAL[key]


GOLDEN = {
    "data_rs": {"tree_learner": "data"},
    "psum": {"tree_learner": "data", "tpu_frontier_rs": False},
    "voting_full": {"tree_learner": "voting", "top_k": 6},
    "skewed": {"tree_learner": "data"},
}


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_golden_frontier_trees_are_the_jax_serial_ones(case):
    x, y = _golden_data()
    if case == "skewed":
        order = np.argsort(y, kind="stable")
        x, y = x[order], y[order]
    jb = _jax_serial(case == "skewed", x, y, _mesh8(), 5)
    tb = _port(_mesh8(dict(GOLDEN[case], **MESH)), x, y, 5)
    want = {"data_rs": "data_rs", "psum": "psum", "voting_full": "voting",
            "skewed": "data_rs"}[case]
    assert tb._impl._dist.kind == want and tb._impl._comm.world == 8
    assert_same_canonical(tb.models, jb.models)
    np.testing.assert_allclose(tb.predict(x[:200], raw_score=True),
                               jb.predict(x[:200], raw_score=True),
                               rtol=2e-4, atol=2e-4)


def test_voting_small_top_k_is_the_documented_approximation():
    x, y = make_binary(n=2000)
    base = {"objective": "binary", "num_leaves": 31,
            "metric": "binary_logloss", "verbosity": -1,
            "tree_growth": "frontier"}
    from lightgbm_tpu.boosting import create_boosting
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import BinnedDataset
    from lightgbm_tpu.metrics import create_metric
    from lightgbm_tpu.objectives import create_objective
    cfg = JConfig(base)
    jb = create_boosting(cfg, BinnedDataset.from_matrix(x, cfg, label=y),
                         create_objective(cfg),
                         [create_metric("binary_logloss", cfg)])
    ls = []
    for _ in range(8):
        jb.train_one_iter()
        ls.append(jb.get_eval_at(0)[0][2])
    tb = tlgb.Booster(dict(base, tree_learner="voting", top_k=3, **MESH),
                      tlgb.Dataset(x, label=y, device="cpu"), device="cpu")
    lv = []
    for _ in range(8):
        tb.update()
        lv.append(tb.eval_train()[0][2])
    assert tb._impl._dist.kind == "voting"
    assert all(b <= a + 1e-6 for a, b in zip(lv, lv[1:])), lv
    assert lv[-1] < lv[0] * 0.8
    assert abs(lv[-1] - ls[-1]) < 0.1 * max(ls[0] - ls[-1], 1e-6), (lv, ls)


WAVES = {
    "batched": {"tree_growth": "batched", "tree_batch_splits": 4},
    "batched_part": {"tree_growth": "batched", "tree_batch_splits": 4,
                     "tpu_batched_part": "true"},
}


@pytest.mark.parametrize("growth", sorted(WAVES))
def test_batched_growers_on_a_data_mesh(growth):
    import lightgbm_tpu as jlgb
    x, y = make_binary(n=2001, f=10)
    params = dict({"objective": "binary", "num_leaves": 15, "max_bin": 63,
                   "verbosity": -1}, **WAVES[growth])
    jb = jlgb.train(params, jlgb.Dataset(x, label=y), num_boost_round=3)
    tb = _port(dict(params, tree_learner="data", **MESH), x, y, 3)
    impl = tb._impl
    assert impl._dist.kind == "psum" and impl.num_data == 251
    assert impl.grow_params.batched_part == (growth == "batched_part")
    jt, tt = jb._impl.models[0], tb.models[0]
    nn = jt.num_leaves_actual - 1
    assert tt.num_leaves_actual == jt.num_leaves_actual == 15
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child", "default_left", "split_leaf"):
        np.testing.assert_array_equal(getattr(tt, name)[:nn],
                                      getattr(jt, name)[:nn], err_msg=name)
    np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=1e-5,
                               atol=1e-7)
    for jt, tt in zip(jb._impl.models, tb.models):
        assert tt.num_leaves_actual == jt.num_leaves_actual
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=0,
                               atol=1e-4)


def test_the_counter_keeps_a_tally_a_wave():
    x, y = _golden_data()
    tb = _port(_mesh8(dict(tree_learner="data", **MESH)), x, y, 1)
    counts = tb._impl._comm.counter.summary()
    assert len(counts["waves"]) == len(counts["wave_splits"]) >= 2
    # data_rs: the wave's histograms reduce-scattered, its 2k records
    # all-gathered (k splits, 6 features padded to 8, 64 bins)
    b = tb._impl.num_bins
    for k, payload in zip(counts["wave_splits"], counts["waves"]):
        assert payload == k * 8 * b * 3 / 8 + 8 * 2 * k * 21


def test_batched_part_needs_the_data_learner():
    """A rank group partitions its rows under ``tree_learner=data`` only:
    with the serial learner on a mesh the JAX package warns and takes the
    unpartitioned batched step (gbdt.py:589-604 there), as the port does."""
    x, y = make_binary(n=600, f=6)
    params = dict({"objective": "binary", "num_leaves": 15, "max_bin": 63,
                   "verbosity": -1}, **WAVES["batched_part"])
    tb = _port(dict(params, tree_learner="serial", mesh_shape=[2]), x, y, 2)
    assert not tb._impl.grow_params.batched_part
    assert tb._impl._dist.kind == "psum"
    one = _port(params, x, y, 2)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               one.predict(x, raw_score=True), rtol=0,
                               atol=1e-6)
