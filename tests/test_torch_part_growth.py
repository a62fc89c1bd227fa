"""Partitioned batched growth (``tpu_batched_part=true``), in the port and in
the JAX package.

- The grower alone: ``grow_tree_batched_part`` of both packages on the same
  numpy bins, gradients and 0/1 sample mask (about 40% of the rows masked
  out, so masked rows travel through the layout) at K=4, num_leaves=15 and
  5,000 rows (three 2048-row tiles): the tree must be identical, node
  numbering included, and so must the per-row leaf ids. The JAX side runs
  its part kernel in interpret mode and its scatter path.
- End to end through ``train``, against the JAX package's partitioned
  grower under both spellings: tree 0 identical, later trees under
  tests/test_torch_slice.py's tie rule, raw predictions within 1e-4.
- The port's partitioned grower against its batched grower: the same
  split structure (the same algorithm; only the order of the additions in
  a histogram differs), as tests/test_grow_batched_part.py holds for the
  JAX package.
- The policy of ``tpu_batched_part`` and ``_local_slot_mask``'s cases.
"""
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.core import grow_batched_part as jgp
from lightgbm_tpu.core.grow import GrowParams as JGrowParams
from lightgbm_tpu.core.split import FeatureMeta as JFeatureMeta
from lightgbm_tpu.core.split import SplitParams as JSplitParams
from lightgbm_tpu_torch.boosting.gbdt import batched_part_on
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.core import grow_batched_part as tgp
from lightgbm_tpu_torch.core.grow import GrowParams
from lightgbm_tpu_torch.core.split import FeatureMeta, SplitParams

from conftest import make_binary

SPLIT = dict(lambda_l1=0.0, lambda_l2=0.5, max_delta_step=0.0,
             min_data_in_leaf=20, min_sum_hessian_in_leaf=1e-3,
             min_gain_to_split=0.0)


def _grower_inputs(n=5000, f=8, b=32, seed=3):
    r = np.random.RandomState(seed)
    xb = r.randint(0, b, (n, f)).astype(np.uint8)
    grad = (0.8 * xb[:, 1] / b - (xb[:, 0] > b // 2)
            + 0.5 * (xb[:, 2] < 5) * (xb[:, 3] > 20)
            + 0.3 * r.randn(n)).astype(np.float32)
    hess = (0.5 + r.rand(n)).astype(np.float32)
    mask = (r.rand(n) >= 0.4).astype(np.float32)
    num_bin = np.full(f, b)
    return xb, grad, hess, mask, num_bin


@pytest.mark.parametrize("jax_impl", ["scatter", "pallas_interpret"])
def test_grower_matches_jax(jax_impl):
    xb, grad, hess, mask, num_bin = _grower_inputs()
    f, b = xb.shape[1], int(num_bin.max())
    jparams = JGrowParams(
        num_leaves=15, num_bins=b, max_depth=-1,
        split=JSplitParams(max_cat_threshold=32, cat_smooth=10.0,
                           cat_l2=10.0, max_cat_to_onehot=4,
                           min_data_per_group=100, **SPLIT),
        hist_impl=jax_impl, batch_splits=4, batched_part=True)
    jmeta = JFeatureMeta(
        num_bin=jnp.asarray(num_bin, jnp.int32),
        missing_type=jnp.zeros(f, jnp.int32),
        default_bin=jnp.zeros(f, jnp.int32),
        is_categorical=jnp.zeros(f, bool), penalty=jnp.ones(f, jnp.float32),
        monotone=jnp.zeros(f, jnp.int32))
    grow = jax.jit(functools.partial(jgp.grow_tree_batched_part,
                                     params=jparams))
    jtree, jleaf, _ = grow(*(jnp.asarray(a) for a in (xb, grad, hess, mask)),
                           jmeta, feature_mask=jnp.ones(f, bool))

    tparams = GrowParams(num_leaves=15, num_bins=b, max_depth=-1,
                         split=SplitParams(**SPLIT), batch_splits=4,
                         batched_part=True)
    tmeta = FeatureMeta(num_bin=torch.as_tensor(num_bin, dtype=torch.int64),
                        missing_type=torch.zeros(f, dtype=torch.int64),
                        default_bin=torch.zeros(f, dtype=torch.int64),
                        penalty=torch.ones(f))
    ttree, tleaf = tgp.grow_tree_batched_part(
        *(torch.as_tensor(a) for a in (xb, grad, hess, mask)), tmeta,
        torch.ones(f, dtype=torch.bool), tparams)

    assert ttree.num_leaves == int(jtree.num_leaves) == 15
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child", "split_leaf", "leaf_parent", "leaf_depth"):
        np.testing.assert_array_equal(getattr(ttree, name),
                                      np.asarray(getattr(jtree, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(ttree.leaf_count,
                                  np.asarray(jtree.leaf_count))
    # the scatter path adds in f32 like the port; the Pallas kernel's two-term
    # bf16 contraction is worth ~3e-6 of a leaf's sum of |g|, which shows as
    # an absolute error on leaves whose value is near 0
    atol = 1e-7 if jax_impl == "scatter" else 2e-6
    np.testing.assert_allclose(ttree.leaf_value, np.asarray(jtree.leaf_value),
                               rtol=1e-5, atol=atol)
    np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))


PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "verbosity": -1, "tree_growth": "batched", "tree_batch_splits": 4,
          "tpu_batched_part": "true"}
ROUNDS = 3
_TRAINED = {}


@pytest.fixture(params=["pallas_interpret", "scatter"])
def trained(request):
    """(x, JAX booster, port booster) trained once per JAX spelling."""
    impl = request.param
    if impl not in _TRAINED:
        x, y = make_binary(n=5000, f=10)
        jb = jlgb.train(dict(PARAMS, tpu_hist_impl=impl),
                        jlgb.Dataset(x, label=y), num_boost_round=ROUNDS)
        tb = tlgb.train(PARAMS, tlgb.Dataset(x, label=y, device="cpu"),
                        num_boost_round=ROUNDS, device="cpu")
        _TRAINED[impl] = (x, jb, tb)
    return _TRAINED[impl]


def test_tree0_identical(trained):
    _, jb, tb = trained
    assert jb._impl.grow_params.batched_part
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


def test_part_matches_port_batched_structure():
    """The partitioned grower makes the batched grower's trees: the same
    split structure and, within f32 summation order, the same
    predictions."""
    x, y = make_binary(n=3000)
    base = {"objective": "binary", "num_leaves": 31, "min_data_in_leaf": 5,
            "tree_growth": "batched", "tree_batch_splits": 4}
    b0 = _port_train(x, y, base, 4)
    b1 = _port_train(x, y, dict(base, tpu_batched_part="true"), 4)
    for t0, t1 in zip(b0.models, b1.models):
        for name in ("split_feature", "threshold_bin", "split_leaf",
                     "left_child", "right_child", "leaf_count"):
            np.testing.assert_array_equal(getattr(t1, name),
                                          getattr(t0, name), err_msg=name)
    np.testing.assert_allclose(b1.predict(x, raw_score=True),
                               b0.predict(x, raw_score=True), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("params,on", [
    ({"tree_growth": "batched"}, False),
    ({"tree_growth": "batched", "tpu_batched_part": "auto"}, False),
    ({"tree_growth": "batched", "tpu_batched_part": "false"}, False),
    ({"tree_growth": "batched", "tpu_batched_part": "true"}, True),
    ({"tree_growth": "batched", "tpu_batched_part": "1"}, True),
    ({"tree_growth": "exact", "tpu_batched_part": "true"}, False),
    ({"tree_growth": "frontier", "tpu_batched_part": "true"}, False),
])
def test_policy(monkeypatch, params, on):
    """``auto`` stays off, ``true`` turns the partitioned grower on under
    batched growth, and exact and frontier growth ignore the option."""
    assert batched_part_on(Config(params)) == on
    calls = []
    real = tgp.grow_tree_batched_part

    def spy(*args):
        calls.append(1)
        return real(*args)

    from lightgbm_tpu_torch.boosting import gbdt
    monkeypatch.setattr(gbdt, "grow_tree_batched_part", spy)
    x, y = make_binary(n=600, f=4)
    bst = _port_train(x, y, dict(params, objective="binary", num_leaves=7),
                      1)
    assert bst._impl.grow_params.batched_part == on
    assert bool(calls) == on


def test_one_part_pass_a_step_with_the_committed_slots(monkeypatch):
    """Each step runs one partitioned pass whose slot count is the step's
    committed splits, so the passes add up to the tree's splits; every
    tile carries a slot in range or -1."""
    calls = []
    real = tgp.hist_part_tiles

    def spy(xb_fm, sel, vals3, tile_slot, tile_first, num_bins, n_slots,
            *rest):
        assert int(tile_slot.max()) < n_slots
        assert int(tile_slot.min()) >= -1
        calls.append(n_slots)
        return real(xb_fm, sel, vals3, tile_slot, tile_first, num_bins,
                    n_slots, *rest)

    monkeypatch.setattr(tgp, "hist_part_tiles", spy)
    x, y = make_binary(n=2500, f=8, seed=5)
    bst = _port_train(x, y, dict(PARAMS, num_leaves=31), 2)
    splits = sum(t.num_leaves_actual - 1 for t in bst.models)
    assert sum(calls) == splits
    assert len(calls) < splits


def test_local_slot_mask():
    """tests/test_grow_batched_part.py's cases: only slots that own a tile
    survive; -1 marks nothing, never the last slot."""
    mask = tgp._local_slot_mask
    np.testing.assert_array_equal(
        mask(torch.tensor([-1, 2, 2, 0, -1]), 4).numpy(),
        [True, False, True, False])
    assert not mask(torch.full((6,), -1), 4).any()
    np.testing.assert_array_equal(mask(torch.tensor([3, 3, 3]), 4).numpy(),
                                  [False, False, False, True])


def test_part_capacity_keeps_the_last_row_padding():
    """Every leaf segment rounded up to a tile fits below the last row."""
    for n, l in ((5000, 15), (1_000_000, 255), (1, 2)):
        cap = tgp._part_capacity(n, l, tgp.PART_TILE)
        assert cap == jgp._part_capacity(n, l, jgp.PART_TILE)
        assert cap % tgp.PART_TILE == 0
        assert n + l * (tgp.PART_TILE - 1) < cap - 1
