"""Frontier-wave and top-K batched growth, in the port and in the JAX package.

Both packages train on ``conftest.make_binary`` with num_leaves=15,
max_bin=63 for 3 rounds under ``tree_growth=frontier`` and
``tree_growth=batched`` (``tree_batch_splits`` 4 and 16, with and without
``tpu_batched_pack``): the JAX package through its Pallas slot kernels in
interpret mode or its scatter path, the port with ``device="cpu"`` (the
plain versions of its slot kernels). Tree 0 must be structurally
identical, node numbering included, with leaf values within 1e-5
relative; later trees see gradients through earlier predictions and
follow tests/test_torch_slice.py's tie rule; raw predictions agree within
1e-4.

The port's own contracts: batched growth with K=1 is exact growth node by
node, and frontier growth makes exact growth's split set when the leaf cap
never binds (tests/test_grow_frontier.py's golden data, which has no
near-ties). The ranking of a wave keeps ``lax.top_k``'s order among equal
gains, which the node numbering follows.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.core import grow_batched, grow_frontier
from lightgbm_tpu_torch.core.split import BestSplit, K_MIN_SCORE

from conftest import make_binary
from test_grow_frontier import _golden_data
from test_torch_slice import _missing_data

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "verbosity": -1}
ROUNDS = 3
GROWTHS = {
    "frontier": {"tree_growth": "frontier"},
    "batched4": {"tree_growth": "batched", "tree_batch_splits": 4},
    "batched16": {"tree_growth": "batched", "tree_batch_splits": 16},
    "pack4": {"tree_growth": "batched", "tree_batch_splits": 4,
              "tpu_batched_pack": True},
    "pack16": {"tree_growth": "batched", "tree_batch_splits": 16,
               "tpu_batched_pack": True},
}
CASES = [("frontier", "pallas_interpret"), ("frontier", "scatter"),
         ("batched4", "pallas_interpret"), ("batched4", "scatter"),
         ("batched16", "pallas_interpret"), ("pack4", "pallas_interpret"),
         ("pack16", "scatter")]
_TRAINED = {}


@pytest.fixture(params=CASES, ids=["%s-%s" % c for c in CASES])
def trained(request):
    """(x, JAX booster, port booster) of one growth mode and JAX impl,
    trained once per module."""
    growth, impl = request.param
    if request.param not in _TRAINED:
        x, y = make_binary(n=2000, f=10)
        params = dict(PARAMS, **GROWTHS[growth])
        jb = jlgb.train(dict(params, tpu_hist_impl=impl),
                        jlgb.Dataset(x, label=y), num_boost_round=ROUNDS)
        tb = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                        num_boost_round=ROUNDS, device="cpu")
        _TRAINED[request.param] = (x, jb, tb)
    return _TRAINED[request.param]


def test_tree0_identical(trained):
    _, jb, tb = trained
    jt, tt = jb._impl.models[0], tb.models[0]
    assert tt.num_leaves_actual == jt.num_leaves_actual == 15
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child", "default_left", "split_leaf"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name),
                                      err_msg=name)
    np.testing.assert_array_equal(tt.threshold, jt.threshold)
    np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(tt.leaf_count, jt.leaf_count)


def test_later_trees_follow_the_tie_rule(trained):
    _, jb, tb = trained
    assert len(tb.models) == len(jb._impl.models) == ROUNDS
    for jt, tt in zip(jb._impl.models[1:], tb.models[1:]):
        nn = jt.num_leaves_actual - 1
        assert tt.num_leaves_actual - 1 == nn
        mism = np.flatnonzero(tt.split_feature[:nn] != jt.split_feature[:nn])
        assert len(mism) <= 6
        ours = collections.Counter(zip(tt.split_feature[:nn].tolist(),
                                       np.round(tt.threshold[:nn], 9)))
        ref = collections.Counter(zip(jt.split_feature[:nn].tolist(),
                                      np.round(jt.threshold[:nn], 9)))
        assert sum(((ours - ref) + (ref - ours)).values()) <= 4
        np.testing.assert_allclose(tt.split_gain[:nn].sum(),
                                   jt.split_gain[:nn].sum(), rtol=1e-3)


def test_predictions_agree(trained):
    x, jb, tb = trained
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=0,
                               atol=1e-4)


def _port_train(x, y, params, rounds):
    return tlgb.train(dict(params, verbosity=-1),
                      tlgb.Dataset(x, label=y, device="cpu"),
                      num_boost_round=rounds, device="cpu")


def test_batched_with_one_split_per_step_is_exact_growth():
    """K=1 commits the single best leaf per step: exact best-first growth,
    node numbering and leaf values included."""
    x, y = make_binary(n=3000, f=8, seed=11)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63}
    exact = _port_train(x, y, params, 2)
    k1 = _port_train(x, y, dict(params, tree_growth="batched",
                                tree_batch_splits=1), 2)
    for te, tk in zip(exact.models, k1.models):
        assert tk.num_leaves_actual == te.num_leaves_actual
        for name in ("split_feature", "threshold_bin", "left_child",
                     "right_child", "split_leaf", "leaf_count"):
            np.testing.assert_array_equal(getattr(tk, name),
                                          getattr(te, name), err_msg=name)
        np.testing.assert_allclose(tk.leaf_value, te.leaf_value, rtol=1e-6,
                                   atol=1e-7)


def _canonical_splits(booster):
    """Each tree's (feature, threshold bin) multiset and its (count, value)
    leaf multiset: the tree up to node numbering."""
    out = []
    for t in booster.models:
        nn = t.num_leaves_actual - 1
        out.append((sorted(zip(t.split_feature[:nn].tolist(),
                               t.threshold_bin[:nn].tolist())),
                    sorted(zip(t.leaf_count[:nn + 1].tolist(),
                               np.round(t.leaf_value[:nn + 1], 5).tolist()))))
    return out


def test_frontier_split_set_is_exact_growths_without_a_cap():
    """When the leaf cap never binds, each leaf's best split depends only
    on its rows: the frontier makes exact growth's splits, numbered in wave
    order instead of best-first order."""
    x, y = _golden_data()
    params = {"objective": "binary", "num_leaves": 64, "max_depth": 4,
              "min_data_in_leaf": 40}
    exact = _port_train(x, y, params, 3)
    front = _port_train(x, y, dict(params, tree_growth="frontier"), 3)
    assert _canonical_splits(front) == _canonical_splits(exact)
    np.testing.assert_allclose(front.predict(x, raw_score=True),
                               exact.predict(x, raw_score=True), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("option,growth", [
    ({"tpu_batched_part": "true", "tree_learner": "data"}, "batched"),
    ({"tpu_bin_packing": "byte"}, "frontier"),
    ({"tpu_bin_packing": "nibble"}, "frontier"),
    ({"obs_modelstats": True}, "frontier"),
    ({"obs_modelstats": True}, "batched"),
])
def test_options_outside_the_slice_raise(option, growth):
    x, y = make_binary(n=300, f=4)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue"):
        _port_train(x, y, dict(option, objective="binary",
                               tree_growth=growth), 1)


def _best_table(gain):
    n = len(gain)
    g = torch.as_tensor(np.asarray(gain, np.float32))
    z = torch.zeros(n)
    return BestSplit(gain=g, feature=torch.arange(n),
                     threshold=torch.arange(n) * 2,
                     default_left=torch.zeros(n, dtype=torch.bool),
                     **{k: z.clone() for k in BestSplit._fields[4:]})


@pytest.mark.parametrize("seed", range(4))
def test_ranking_keeps_top_k_tie_order(seed):
    """Equal gains rank lower leaf first, as ``lax.top_k`` does, and the
    wave numbers its nodes and right leaves in that order."""
    r = np.random.RandomState(seed)
    gain = r.choice([0.5, 1.25, 3.0, -np.inf, K_MIN_SCORE], size=40)
    gain = gain.astype(np.float32)
    _, ref = jax.lax.top_k(jnp.asarray(gain), 12)
    ours = grow_batched.rank_leaves(torch.as_tensor(gain), 12)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    plan = grow_frontier.wave_plan(_best_table(gain), 7, 12)
    np.testing.assert_array_equal(plan.gleaf.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(plan.node.numpy(), 6 + np.arange(12))
    np.testing.assert_array_equal(plan.right_leaf.numpy(), 7 + np.arange(12))
    np.testing.assert_array_equal(plan.cur.feature.numpy(), np.asarray(ref))
    rol = plan.rank_of_leaf.numpy()
    np.testing.assert_array_equal(rol[np.asarray(ref)], np.arange(12))
    assert (np.delete(rol, np.asarray(ref)) == -1).all()


def test_frontier_width_ladder_does_not_change_the_tree():
    """``tpu_frontier_bucketing`` picks the JAX package's compiled wave
    widths; the port's eager waves take the committed split count as
    their width, so the option is accepted and the tree is the same
    either way."""
    x, y = make_binary(n=2500, f=8, seed=5)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "tree_growth": "frontier"}
    on = _port_train(x, y, params, 2)
    off = _port_train(x, y, dict(params, tpu_frontier_bucketing=False), 2)
    for ta, tb in zip(on.models, off.models):
        for name in ("split_feature", "threshold_bin", "left_child",
                     "right_child", "split_leaf", "leaf_count"):
            np.testing.assert_array_equal(getattr(ta, name),
                                          getattr(tb, name), err_msg=name)
        np.testing.assert_allclose(ta.leaf_value, tb.leaf_value, rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("growth,module,fn", [
    ({"tree_growth": "frontier"}, grow_frontier, "hist_slots"),
    ({"tree_growth": "batched", "tree_batch_splits": 4}, grow_batched,
     "hist_slots6"),
    ({"tree_growth": "batched", "tree_batch_splits": 4,
      "tpu_batched_pack": True}, grow_batched, "hist_slots")])
def test_slot_count_is_the_committed_splits(monkeypatch, growth, module, fn):
    """Each wave's or step's slot pass has one slot per committed split
    (two under ``tpu_batched_pack``), every row carries a slot in range or
    -1, and so the passes add up to the tree's splits."""
    calls = []
    real = getattr(module, fn)

    def spy(xb, slot, *rest):
        num_slots = rest[-3]           # (..., num_slots, impl, f64_sums)
        assert int(slot.max()) < num_slots and int(slot.min()) >= -1
        calls.append(num_slots)
        return real(xb, slot, *rest)

    monkeypatch.setattr(module, fn, spy)
    x, y = make_binary(n=2500, f=8, seed=5)
    bst = _port_train(x, y, dict({"objective": "binary", "num_leaves": 31,
                                  "max_bin": 63}, **growth), 2)
    per_split = 2 if growth.get("tpu_batched_pack") else 1
    splits = sum(t.num_leaves_actual - 1 for t in bst.models)
    assert sum(calls) == per_split * splits
    assert len(calls) < splits


def _route_case(seed, n=600, f=6, k=5):
    """Bins, per-row split ranks, K split descriptors and feature meta
    with every missing type, made with numpy."""
    r = np.random.RandomState(seed)
    num_bin = r.randint(4, 17, f)
    missing = r.randint(0, 3, f)                  # none, zero, NaN
    default_bin = r.randint(0, num_bin)
    xb = (r.randint(0, 1 << 16, (n, f)) % num_bin).astype(np.uint8)
    feature = r.randint(0, f, k)
    threshold = r.randint(0, num_bin[feature])
    default_left = r.rand(k) < 0.5
    rs = r.randint(0, k, n)
    return xb, rs, feature, threshold, default_left, num_bin, missing, \
        default_bin


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("jax_route", ["gather", "one_hot"])
def test_row_routing_matches_jax(seed, jax_route):
    """The wave growers' per-row routing gives the go-left decision of the
    JAX frontier's gather routing and of the JAX batched grower's [K, N]
    one-hot routing, missing bins included."""
    from lightgbm_tpu.core import grow_batched as jgb
    from lightgbm_tpu.core import grow_frontier as jgf
    from lightgbm_tpu.core.split import BestSplit as JBestSplit
    from lightgbm_tpu.core.split import FeatureMeta as JFeatureMeta
    from lightgbm_tpu_torch.core.grow_batched import _route_rows_gather
    from lightgbm_tpu_torch.core.split import FeatureMeta

    xb, rs, feat, thr, dl, num_bin, missing, dbin = _route_case(seed)
    k, f = len(feat), xb.shape[1]
    z = np.zeros(k, np.float32)
    ours = _route_rows_gather(
        torch.as_tensor(xb), torch.as_tensor(rs),
        BestSplit(torch.as_tensor(z), torch.as_tensor(feat),
                  torch.as_tensor(thr), torch.as_tensor(dl),
                  *[torch.as_tensor(z)] * 8),
        FeatureMeta(*[torch.as_tensor(a.astype(np.int64))
                      for a in (num_bin, missing, dbin)],
                    torch.ones(f))).numpy()
    i32 = [jnp.asarray(a, jnp.int32) for a in (feat, thr)]
    cur = JBestSplit(jnp.asarray(z), i32[0], i32[1], jnp.asarray(dl),
                     *[jnp.asarray(z)] * 8, jnp.zeros(k, bool),
                     jnp.zeros((k, 8), jnp.uint32))
    meta = JFeatureMeta(*[jnp.asarray(a, jnp.int32)
                          for a in (num_bin, missing, dbin)],
                        jnp.zeros(f, bool), jnp.ones(f, jnp.float32),
                        jnp.zeros(f, jnp.int32))
    jrs = jnp.asarray(rs, jnp.int32)
    if jax_route == "gather":
        ref = jgf._route_rows_gather(jnp.asarray(xb), jrs, cur, meta, False,
                                     False)
    else:
        rank = jnp.arange(k, dtype=jnp.int32)
        ref = jgb.route_split_rows(jnp.asarray(xb.T), rank, jrs,
                                   rank[:, None] == jrs[None, :], cur, meta,
                                   False, False)
    np.testing.assert_array_equal(ours, np.asarray(ref))


@pytest.mark.parametrize("growth", ["frontier", "batched"])
def test_wave_growth_needs_cuda_unless_asked_for_the_cpu(monkeypatch,
                                                         growth):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = make_binary(n=300, f=4)
    ds = tlgb.Dataset(x, label=y, device="cpu")
    params = {"objective": "binary", "verbosity": -1, "tree_growth": growth}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlgb.train(params, ds, num_boost_round=1)
    assert len(tlgb.train(params, ds, num_boost_round=1,
                          device="cpu").models) == 1


def _missing_rows_at_nodes(tree, x):
    """Per internal node: how many training rows reaching it are missing
    (zero or NaN) in its split feature, routed through ``tree``."""
    nn = tree.num_leaves_actual - 1
    out = np.zeros(nn, np.int64)
    todo = [(0, np.ones(len(x), bool))]
    while todo:
        node, rows = todo.pop()
        v = x[:, tree.split_feature[node]]
        kind = tree.missing_type[node]         # 0 none, 1 zero, 2 NaN
        miss = (np.isnan(v) & (kind > 0)) | ((v == 0) & (kind == 1))
        v = np.nan_to_num(v, nan=0.0)
        out[node] = (rows & miss).sum()
        left = np.where(miss, tree.default_left[node],
                        v <= tree.threshold[node])
        for child, sub in ((tree.left_child[node], rows & left),
                           (tree.right_child[node], rows & ~left)):
            if child >= 0:
                todo.append((child, sub))
    return out


@pytest.mark.parametrize("growth,kind,extra", [
    ("frontier", "nan", {"max_depth": 3}),
    ("frontier", "zero", {"zero_as_missing": True, "lambda_l2": 1.0,
                          "min_data_in_leaf": 5}),
    ("batched", "nan", {"max_depth": 3, "tree_batch_splits": 4}),
    ("batched", "zero", {"zero_as_missing": True, "lambda_l1": 0.1,
                         "feature_fraction": 0.7}),
])
def test_wave_growth_options_train_like_jax(growth, kind, extra):
    """Missing values route the same way in the wave growers' row routing
    as in the JAX package's, and depth limits, regularisation and column
    sampling build its trees. ``default_left`` may differ only at a node
    none of whose rows is missing in its feature: both scan directions
    then make the same partition and an f32 gain tie picks one."""
    x, y = _missing_data(kind)
    params = dict(PARAMS, tree_growth=growth, **extra)
    jb = jlgb.train(params, jlgb.Dataset(x, label=y), num_boost_round=2)
    tb = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                    num_boost_round=2, device="cpu")
    jt, tt = jb._impl.models[0], tb.models[0]
    assert tt.num_leaves_actual == jt.num_leaves_actual
    for name in ("split_feature", "threshold_bin", "missing_type",
                 "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name),
                                      err_msg=name)
    flipped = np.flatnonzero(tt.default_left != jt.default_left)
    assert (_missing_rows_at_nodes(jt, x)[flipped] == 0).all()
    np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), atol=1e-4)
