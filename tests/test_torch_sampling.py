"""Row sampling (bagging, GOSS, DART, RF) in the port and in the JAX
package.

- ``lightgbm_tpu_torch.random`` against ``jax.random`` (JAX on the CPU,
  ``jax_threefry_partitionable`` on, which each case asserts first):
  ``PRNGKey`` for seeds 0, 3 and 2**31 - 1, chained ``split``s and
  ``split(key, 65)``, and ``uniform`` at n = 1, 7 and 100,003, compared as
  uint32 bits: equal.
- Bagging masks, bit for bit, on both of the JAX package's key streams:
  per iteration (``lgb.train`` with a valid set, and ``Booster.update``)
  each iteration's mask equal to the JAX package's; fused (``lgb.train``
  without one, 70 rounds, so two blocks) every mask equal to the JAX
  package's block derivation drawn with ``jax.random``, each tree's root
  count equal to the JAX tree's and the key and mask left at the end equal
  to the JAX booster's. Lambdarank bags whole queries, on both streams.
- GOSS: the gradients, hessians and row mask the trees grow on, for the
  same custom gradients and keys, equal bit for bit to what the JAX
  package's grower is handed (a ``jax.debug.callback`` on its
  ``grow_tree``): continuous values, values that tie at the threshold (more
  rows kept than ``top_rate`` asks), three classes, and the warm-up, which
  does not sample.
- DART: drop sets, ``tree_weight`` and ``sum_weight`` equal under uniform
  and weighted drops, ``xgboost_dart_mode`` and ``max_drop``; trees under
  the f32 tie rule, training and valid scores within 1e-5.
- RF: averaged training and valid scores within 1e-5 of the JAX package's
  and of ``predict``.
- 4-round end-to-end training of each mode under ``exact`` at 3,000 rows
  (num_leaves=15, max_bin=63, min_data_in_leaf=40, as
  tests/test_torch_fobj.py trains): every tree under
  tests/test_torch_slice.py's tie rule, raw predictions within 1e-5 of the
  JAX model's training scores. The same for leaf renewal
  (``regression_l1``) under bagging and under GOSS, multiclass GOSS and
  lambdarank with bagging.
- DART's and RF's model texts load in both packages (RF's writes
  ``average_output``), and ``booster_from_numpy`` averages an RF forest.

Frontier, batched and batched_part growth are in
tests/test_torch_sampling_waves.py.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu.boosting.gbdt as jgbdt
import lightgbm_tpu_torch as tlgb
from chip_smoke import bench_data, multiclass_data, regression_data
from lightgbm_tpu.boosting.dart import DART as JDART
from lightgbm_tpu_torch import random as threefry
from lightgbm_tpu_torch.boosting.dart import DART as TDART
from lightgbm_tpu_torch.boosting.gbdt import GBDT as TGBDT
from lightgbm_tpu_torch.boosting.goss import GOSS as TGOSS
from lightgbm_tpu_torch.convert import booster_from_numpy

from test_torch_ranking import rank_data
from test_torch_regression import assert_tie_rule

ROUNDS = 4
ROWS = 3000
PARAMS = {"num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 40,
          "verbosity": -1}
# the sampling options of each mode; GOSS at learning_rate 0.5 samples
# from iteration 2 on (warm-up int(1 / 0.5))
MODES = {
    "bagging": {"bagging_fraction": 0.7, "bagging_freq": 2},
    "goss": {"boosting": "goss", "learning_rate": 0.5, "top_rate": 0.2,
             "other_rate": 0.1},
    "dart": {"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0},
    "rf": {"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
           "feature_fraction": 0.8},
}
SCORE_TOL = 1e-5
_TRAINED = {}


def _data(objective):
    if objective == "lambdarank":
        return rank_data()
    if objective == "multiclass":
        x, y = multiclass_data(ROWS, num_class=3)
        return x[:, :10], y, None
    if objective == "regression_l1":
        x, y = regression_data(ROWS)
        return x[:, :10], y, None
    x, y = bench_data(ROWS)
    return x[:, :10], y, None


def train_both(mode, growth=(), objective="binary", valid=False):
    """(x, JAX booster, port booster) trained on the same data with the
    same parameters, once a module and case; ``valid`` keeps a valid set of
    1,000 rows (seed 1), which puts the JAX package on its per-iteration
    key stream."""
    key = (mode, growth, objective, valid)
    if key not in _TRAINED:
        x, y, group = _data(objective)
        params = dict(PARAMS, objective=objective, **MODES[mode],
                      **dict(growth))
        if objective == "multiclass":
            params["num_class"] = 3
        jd = jlgb.Dataset(x, label=y, group=group)
        td = tlgb.Dataset(x, label=y, group=group, device="cpu")
        jk, tk = {}, {}
        if valid:
            xv, yv = bench_data(1000, seed=1)
            jk = {"valid_sets": [jd.create_valid(xv[:, :10], label=yv)]}
            tk = {"valid_sets": [td.create_valid(xv[:, :10], label=yv)]}
        jb = jlgb.train(params, jd, num_boost_round=ROUNDS, **jk)
        tb = tlgb.train(params, td, num_boost_round=ROUNDS, device="cpu",
                        **tk)
        _TRAINED[key] = (x, jb, tb)
    return _TRAINED[key]


def jax_scores(jb, data_idx=0):
    """The JAX booster's device scores, [N] or [N, K], in float64: the
    training set's (0) or valid set ``data_idx - 1``'s."""
    s = (jb._impl.scores if data_idx == 0
         else jb._impl._valid_pred_cache[data_idx - 1]["scores"])
    s = np.asarray(s, np.float64)
    return s[:, 0] if s.shape[1] == 1 else s


def assert_mode_parity(x, jb, tb):
    """Every tree splits and keeps the tie rule; raw predictions within
    SCORE_TOL of the port's training scores and of the JAX model's."""
    assert len(tb.models) == len(jb._impl.models) > 0
    for jt, tt in zip(jb._impl.models, tb.models):
        assert tt.num_leaves_actual > 1
        assert_tie_rule(jt, tt)
    raw = tb.predict(x, raw_score=True)
    np.testing.assert_allclose(raw, tb._impl.scores_of(0), rtol=0,
                               atol=SCORE_TOL)
    np.testing.assert_allclose(raw, jax_scores(jb), rtol=0, atol=SCORE_TOL)


# ------------------------------------------------------------ threefry
def _jax_key(seed):
    # the port follows the partitionable layout; a JAX that flips it must
    # fail here, not drift silently
    assert jax.config.jax_threefry_partitionable
    return jax.random.PRNGKey(seed)


def _bits(key):
    return tuple(int(v) for v in np.asarray(key).view(np.uint32))


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 - 1])
def test_prng_key_matches_jax(seed):
    assert threefry.prng_key(seed) == _bits(_jax_key(seed))


def test_split_matches_jax():
    jk, tk = _jax_key(3), threefry.prng_key(3)
    for _ in range(4):
        jk, jsub = jax.random.split(jk)
        tk, tsub = threefry.split(tk)
        assert (tk, tsub) == (_bits(jk), _bits(jsub))
    jkeys = jax.random.split(jk, 65)
    assert threefry.split(tk, 65) == [_bits(k) for k in jkeys]
    # a key given as a tensor splits the same
    assert threefry.split(torch.tensor(tk), 65) == [_bits(k) for k in jkeys]


@pytest.mark.parametrize("n", [1, 7, 100_003])
def test_uniform_matches_jax(n):
    jk = jax.random.split(_jax_key(7), 3)[2]
    want = np.asarray(jax.random.uniform(jk, (n,)))
    got = threefry.uniform(_bits(jk), n).numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert 0.0 <= got.min() and got.max() < 1.0


# ------------------------------------------------------------ bagging
def _record(monkeypatch, cls, name, out, pick=lambda self, ret: ret):
    """Wrap method ``name`` of ``cls`` so that each call appends
    ``pick(self, return value)`` as a numpy array to ``out``."""
    method = getattr(cls, name)

    def wrapped(self, *args):
        ret = method(self, *args)
        val = pick(self, ret)
        out.append(np.array(val.cpu() if isinstance(val, torch.Tensor)
                            else val))
        return ret
    monkeypatch.setattr(cls, name, wrapped)


BAG = {"bagging_fraction": 0.5, "bagging_freq": 2}


@pytest.mark.parametrize("objective", ["binary", "lambdarank"])
@pytest.mark.parametrize("stream", ["valid", "update"])
def test_bagging_masks_match_jax_per_iteration(stream, objective,
                                               monkeypatch):
    """The per-iteration stream: a split for a refresh, another for GOSS,
    every iteration; lambdarank draws one uniform a query."""
    x, y, group = _data(objective)
    params = dict(PARAMS, objective=objective, **BAG)
    masks = {"jax": [], "port": []}
    _record(monkeypatch, jgbdt.GBDT, "_sample_bagging_mask", masks["jax"])
    _record(monkeypatch, TGBDT, "_sample_bagging_mask", masks["port"])
    jd = jlgb.Dataset(x, label=y, group=group)
    td = tlgb.Dataset(x, label=y, group=group, device="cpu")
    if stream == "valid":
        jlgb.train(params, jd, 5, valid_sets=[jd.create_valid(
            x[:500], label=y[:500], group=None if group is None else [500])])
        tlgb.train(params, td, 5, device="cpu", valid_sets=[td.create_valid(
            x[:500], label=y[:500], group=None if group is None else [500])])
    else:
        jb, tb = jlgb.Booster(params, jd), tlgb.Booster(params, td,
                                                       device="cpu")
        for _ in range(5):
            jb.update()
            tb.update()
    assert len(masks["port"]) == len(masks["jax"]) == 5
    for j, t in zip(masks["jax"], masks["port"]):
        np.testing.assert_array_equal(t, j)
    assert 0.3 < masks["port"][0].mean() < 0.7
    # a refresh every second iteration
    np.testing.assert_array_equal(masks["port"][1], masks["port"][0])
    assert (masks["port"][2] != masks["port"][1]).any()
    if group is not None:
        bounds = np.cumsum([0] + list(group))
        for m in masks["port"]:
            for a, b in zip(bounds[:-1], bounds[1:]):
                assert m[a:b].min() == m[a:b].max()


def _block_masks(seed, n, rounds, freq, frac, row_group=None, groups=0):
    """The masks of the JAX package's fused loop, drawn with ``jax.random``
    as gbdt.py:1622-1647 and :1915-1922 there draw them."""
    key, masks, it = jax.random.PRNGKey(seed), [], 0
    mask = np.ones(n, np.float32)
    while it < rounds:
        block = min(rounds - it, 64)
        keys = jax.random.split(key, block + 1)
        key = keys[0]
        for k in keys[1:]:
            bkey, _ = jax.random.split(k)
            if it % freq == 0:
                u = np.asarray(jax.random.uniform(
                    bkey, (groups if row_group is not None else n,)))
                if row_group is not None:
                    u = u[row_group]
                mask = (u < np.float32(frac)).astype(np.float32)
            masks.append(mask)
            it += 1
    return masks, _bits(key)


@pytest.mark.parametrize("objective", ["binary", "lambdarank"])
def test_bagging_masks_match_jax_fused(objective, monkeypatch):
    """The fused stream over 70 rounds (a block of 64 and one of 6): every
    mask, each tree's in-bag count, and the key and mask left at the end."""
    x, y, group = _data(objective)
    if group is None:
        x, y = x[:600], y[:600]
    rounds, freq = 70, 3
    params = dict(PARAMS, objective=objective, num_leaves=4,
                  min_data_in_leaf=20, bagging_fraction=0.5,
                  bagging_freq=freq)
    drawn = []
    _record(monkeypatch, TGBDT, "_draw_bag_mask", drawn,
            lambda self, ret: self._bag_mask)
    jb = jlgb.train(params, jlgb.Dataset(x, label=y, group=group), rounds)
    tb = tlgb.train(params, tlgb.Dataset(x, label=y, group=group,
                                         device="cpu"), rounds, device="cpu")
    impl = tb._impl
    row_group = (None if impl._row_group is None
                 else impl._row_group.numpy())
    want, key = _block_masks(impl.config.bagging_seed, len(y), rounds,
                             freq, 0.5, row_group,
                             impl._num_groups)
    assert len(drawn) == len(range(0, rounds, freq))
    for got, it in zip(drawn, range(0, rounds, freq)):
        np.testing.assert_array_equal(got, want[it])
    assert len(tb.models) == len(jb._impl.models) == rounds
    for i, (jt, tt) in enumerate(zip(jb._impl.models, tb.models)):
        in_bag = int(want[i].sum())
        assert tt.internal_count[0] == jt.internal_count[0] == in_bag
    assert impl._bag_key == key == _bits(jb._impl._bag_key)
    np.testing.assert_array_equal(impl._bag_mask.numpy(), want[-1])
    np.testing.assert_array_equal(np.asarray(jb._impl._bag_mask), want[-1])
    if group is not None:
        assert impl._num_groups == len(group) + 1
        bounds = np.cumsum([0] + list(group))
        m = impl._bag_mask.numpy()
        for a, b in zip(bounds[:-1], bounds[1:]):
            assert m[a:b].min() == m[a:b].max()


# ------------------------------------------------------------ GOSS
def _goss_gradients(case, n, k):
    """Fixed custom gradients: continuous, or from a few values (every
    leaf's rows share g and h after a tree, so GOSS ties at its
    threshold)."""
    r = np.random.RandomState(5)
    if case == "ties":
        g = r.choice([-0.5, -0.25, 0.125, 0.5], n * k).astype(np.float32)
        h = r.choice([0.25, 0.5], n * k).astype(np.float32)
    else:
        g = r.randn(n * k).astype(np.float32)
        h = (r.rand(n * k) + 0.1).astype(np.float32)
    return g, h


GOSS_CASES = {"continuous": (1.0, 1), "ties": (1.0, 1),
              "multiclass": (1.0, 3), "warmup": (0.25, 1)}


@pytest.mark.parametrize("case", sorted(GOSS_CASES))
def test_goss_rows_match_jax(case, monkeypatch):
    lr, k = GOSS_CASES[case]
    x, y = bench_data(2000)
    x = x[:, :10]
    g, h = _goss_gradients(case, len(y), k)
    params = dict(PARAMS, objective="none", boosting="goss",
                  learning_rate=lr, top_rate=0.2, other_rate=0.1)
    if k > 1:
        params["num_class"] = k
    seen = {"jax": [], "port": []}
    grow_tree = jgbdt.grow_tree

    def spy(xb, gk, hk, mask, *args, **kwargs):
        jax.debug.callback(lambda a, b, m: seen["jax"].append(
            (np.asarray(a), np.asarray(b), np.asarray(m))), gk, hk, mask)
        return grow_tree(xb, gk, hk, mask, *args, **kwargs)
    monkeypatch.setattr(jgbdt, "grow_tree", spy)
    rows = TGOSS._row_sample

    def port_spy(self, *args):
        gk, hk, mask = rows(self, *args)
        for c in range(gk.shape[0]):
            seen["port"].append((gk[c].numpy(), hk[c].numpy(),
                                 mask.numpy()))
        return gk, hk, mask
    monkeypatch.setattr(TGOSS, "_row_sample", port_spy)

    def fobj(preds, data):
        return g, h
    jlgb.train(params, jlgb.Dataset(x, label=y), 3, fobj=fobj)
    tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"), 3,
               fobj=fobj, device="cpu")
    assert len(seen["port"]) == len(seen["jax"]) == 3 * k

    def key(t):
        return t[0].tobytes() + t[2].tobytes()
    for it in range(3):
        jit = sorted(seen["jax"][it * k:(it + 1) * k], key=key)
        tit = sorted(seen["port"][it * k:(it + 1) * k], key=key)
        for (jg, jh, jm), (tg, th, tm) in zip(jit, tit):
            np.testing.assert_array_equal(tg.view(np.uint32),
                                          jg.view(np.uint32))
            np.testing.assert_array_equal(th.view(np.uint32),
                                          jh.view(np.uint32))
            np.testing.assert_array_equal(tm, jm)
    n = len(y)
    top, other = int(n * 0.2), int(n * 0.1)
    kept = [m.sum() for _, _, m in seen["port"][::k]]
    if case == "warmup":
        assert kept == [n] * 3          # int(1 / 0.25) = 4 > 3 iterations
        return
    assert kept[0] == n                 # int(1 / 1.0) = 1: iteration 0
    gh = (np.abs(g * h).reshape(k, n).sum(axis=0) if k > 1
          else np.abs(g * h))
    is_top = gh >= np.sort(gh)[-top]
    if case == "ties":
        assert is_top.sum() > top
    amplify = np.float32((n - top) / other)
    for it in (1, 2):
        tg, _, tm = seen["port"][it * k]
        others = (tm > 0) & ~is_top
        assert (tm[is_top] == 1).all()
        np.testing.assert_array_equal(tg[is_top], g[:n][is_top])
        np.testing.assert_array_equal(tg[others], g[:n][others] * amplify)
        # each of the rest kept with probability other / (n - top)
        expect = (n - is_top.sum()) * other / (n - top)
        assert abs(others.sum() - expect) < 5 * np.sqrt(expect)


# ------------------------------------------------------------ DART
DART_CASES = {"uniform": {"uniform_drop": True},
              "weighted": {},
              "xgboost": {"xgboost_dart_mode": True, "skip_drop": 0.2},
              "max_drop": {"max_drop": 2, "drop_rate": 0.9}}


@pytest.mark.parametrize("case", sorted(DART_CASES))
def test_dart_drops_match_jax(case, monkeypatch):
    """Drop sets, tree weights, trees and scores (with a valid set) of 6
    DART rounds."""
    drops = {"jax": [], "port": []}
    _record(monkeypatch, JDART, "_dropping_trees", drops["jax"])
    _record(monkeypatch, TDART, "_dropping_trees", drops["port"])
    x, y = bench_data(ROWS)
    x = x[:, :10]
    xv, yv = bench_data(1000, seed=1)
    xv = xv[:, :10]
    params = dict(PARAMS, objective="binary", boosting="dart",
                  **dict({"drop_rate": 0.5, "skip_drop": 0.0},
                         **DART_CASES[case]))
    jd = jlgb.Dataset(x, label=y)
    td = tlgb.Dataset(x, label=y, device="cpu")
    jb = jlgb.train(params, jd, 6, valid_sets=[jd.create_valid(xv,
                                                               label=yv)])
    tb = tlgb.train(params, td, 6, device="cpu",
                    valid_sets=[td.create_valid(xv, label=yv)])
    assert [d.tolist() for d in drops["port"]] == [
        d.tolist() for d in drops["jax"]]
    assert sum(len(d) for d in drops["port"]) > 0
    if case == "max_drop":
        assert max(len(d) for d in drops["port"]) == 2
    assert tb._impl.tree_weight == jb._impl.tree_weight
    assert tb._impl.sum_weight == jb._impl.sum_weight
    assert bool(tb._impl.tree_weight) == (case != "uniform")
    assert_mode_parity(x, jb, tb)
    np.testing.assert_allclose(tb._impl.scores_of(1), jax_scores(jb, 1),
                               rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(tb._impl.scores_of(1),
                               tb.predict(xv, raw_score=True), rtol=0,
                               atol=SCORE_TOL)


# ------------------------------------------------------------ RF
def test_rf_scores_are_averages_as_in_jax():
    x, jb, tb = train_both("rf", valid=True)
    assert tb._impl.average_output and jb._impl.average_output
    assert tb._impl.shrinkage_rate == 1.0
    assert_mode_parity(x, jb, tb)
    np.testing.assert_allclose(tb._impl.scores_of(1), jax_scores(jb, 1),
                               rtol=0, atol=SCORE_TOL)
    xv = bench_data(1000, seed=1)[0][:, :10]
    np.testing.assert_allclose(tb._impl.scores_of(1),
                               tb.predict(xv, raw_score=True), rtol=0,
                               atol=SCORE_TOL)
    # predict divides by the iterations it uses
    one = tlgb.Booster(model_str=tb.model_to_string(num_iteration=1),
                       device="cpu")
    np.testing.assert_allclose(one.predict(x, raw_score=True),
                               tb.predict(x, raw_score=True,
                                          num_iteration=1), rtol=0,
                               atol=1e-12)


# ------------------------------------------------------------ end to end
@pytest.mark.parametrize("mode", sorted(MODES))
def test_exact_matches_jax(mode):
    x, jb, tb = train_both(mode)
    assert type(tb._impl).__name__ == type(jb._impl).__name__
    assert tb._impl.boosting_type == ("gbdt" if mode == "bagging" else mode)
    assert_mode_parity(x, jb, tb)


@pytest.mark.parametrize("mode", ["bagging", "goss"])
def test_renewal_under_sampling_matches_jax(mode):
    x, jb, tb = train_both(mode, objective="regression_l1")
    assert tb._impl._renew_alpha is not None
    assert_mode_parity(x, jb, tb)


def test_multiclass_goss_matches_jax():
    x, jb, tb = train_both("goss", objective="multiclass")
    assert tb.num_model_per_iteration() == 3
    assert_mode_parity(x, jb, tb)


def test_lambdarank_bagging_matches_jax():
    x, jb, tb = train_both("bagging", objective="lambdarank")
    assert_mode_parity(x, jb, tb)
    jm = {m: v for _, m, v, _ in jb.eval_train()}
    for _, m, v, _ in tb.eval_train():
        np.testing.assert_allclose(v, jm[m], rtol=1e-6, err_msg=m)


# ------------------------------------------------------------ model text
@pytest.mark.parametrize("mode", ["dart", "rf"])
def test_model_text_crosses_both_ways(mode):
    x, jb, tb = train_both(mode, valid=mode == "rf")
    text = tb.model_to_string()
    assert ("\naverage_output\n" in text) == (mode == "rf")
    loaded = tlgb.Booster(model_str=text, device="cpu")
    assert loaded._impl.average_output == (mode == "rf")
    np.testing.assert_array_equal(loaded.predict(x, raw_score=True),
                                  tb.predict(x, raw_score=True))
    in_jax = jlgb.Booster(model_str=text)
    assert in_jax._impl.average_output == (mode == "rf")
    np.testing.assert_allclose(in_jax.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=0,
                               atol=SCORE_TOL)
    back = tlgb.Booster(model_str=jb.model_to_string(), device="cpu")
    np.testing.assert_allclose(back.predict(x, raw_score=True),
                               jax_scores(jb), rtol=0, atol=SCORE_TOL)


def test_booster_from_numpy_averages_rf():
    x, jb, _ = train_both("rf", valid=True)
    fields = ("split_feature", "threshold", "threshold_bin", "default_left",
              "missing_type", "left_child", "right_child", "leaf_value",
              "internal_value", "split_gain", "leaf_count", "internal_count")
    trees = [{k: np.asarray(getattr(t, k)) for k in fields}
             | {"shrinkage": t.shrinkage} for t in jb._impl.models]
    mappers = [m.to_dict() for m in jb._train_set._binned.bin_mappers]
    params = dict(PARAMS, objective="binary", **MODES["rf"])
    booster = booster_from_numpy(trees, mappers, params, device="cpu")
    assert booster._impl.average_output
    np.testing.assert_allclose(booster.predict(x, raw_score=True),
                               jax_scores(jb), rtol=0, atol=SCORE_TOL)
    # the same trees without boosting=rf are a sum
    summed = booster_from_numpy(trees, mappers, {"objective": "binary"},
                                device="cpu")
    assert not summed._impl.average_output
    np.testing.assert_allclose(summed.predict(x, raw_score=True),
                               jax_scores(jb) * ROUNDS, rtol=0,
                               atol=SCORE_TOL * ROUNDS)
