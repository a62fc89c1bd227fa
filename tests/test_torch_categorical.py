"""Categorical features in the port and in the JAX package.

Every case holds the port against the JAX package (JAX on the CPU) on the
same numpy data:

- the categorical bin mappers and the stored matrix byte for byte, with
  ids above 255, negative ids, NaN, and ids a validation set has and the
  training set has not;
- ``per_feature_split_categorical`` on identical histograms: bitsets
  equal, gains and outputs within 1e-6 relative, through the one-vs-rest
  and the sorted-subset branches and with ``max_cat_threshold`` and
  ``min_data_per_group`` binding;
- training under every grower on chip_smoke.py's categorical workload
  shrunk to 4,000 rows (``chip_smoke.categorical_data``), binary and L2:
  trees under the f32 tie rule with each categorical node's bitset in its
  key, raw predictions within 1e-5;
- the model text line for line, a JAX-written text loaded by the port,
  pandas ``category`` columns and the ``pandas_categorical`` line, valid
  sets and continued training against ``predict``, and the raw bitset of
  category ids past 255.

The growers' cases run in three files, one worker each under
``--dist loadfile``: this one (exact), ``test_torch_categorical_waves.py``
(frontier, batched) and ``test_torch_categorical_part.py``
(batched_pack, batched_part); each trains its growers' boosters once.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import collections

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from chip_smoke import CATEGORICAL_FEATURES, categorical_data, \
    categorical_splits
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.core import split as jsplit
from lightgbm_tpu.io.dataset import BinnedDataset as JBinned
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.core import split as tsplit
from lightgbm_tpu_torch.io.dataset import BinnedDataset as TBinned

# leaves of at least 40 rows, as tests/test_torch_efb.py: a binary tree 0
# has one hessian and two gradients, so small leaves tie exactly
PARAMS = {"num_leaves": 15, "min_data_in_leaf": 40, "verbosity": -1}
ROUNDS = 3
GROWTHS = {
    "exact": {},
    "frontier": {"tree_growth": "frontier"},
    "batched": {"tree_growth": "batched", "tree_batch_splits": 4},
    "batched_pack": {"tree_growth": "batched", "tree_batch_splits": 4,
                     "tpu_batched_pack": True},
    "batched_part": {"tree_growth": "batched", "tree_batch_splits": 4,
                     "tpu_batched_part": "true"},
}


def small_categorical(n=4000, seed=0):
    return categorical_data(n, seed)


def regression_target(x, y):
    return y + 0.5 * x[:, 1] + 0.3 * (x[:, 29] % 3)


def wide_ids(n=3000, seed=4):
    """Three numerical columns and one id column whose 12 ids all lie past
    255 (300 + 977 k), each with its own effect: the raw bitsets are ~16
    words wide."""
    r = np.random.RandomState(seed)
    x = r.randn(n, 4)
    k = r.randint(0, 12, n)
    x[:, 3] = 300 + 977 * k
    eff = np.random.RandomState(9).randn(12)
    y = (x[:, 0] + eff[k] + 0.3 * r.randn(n) > 0).astype(np.float32)
    return x, y


def odd_values(n=2500, seed=6):
    """An id column with ids past 255, negative ids and NaN, and a 3-id
    column; the validation rows add ids the training rows never have."""
    r = np.random.RandomState(seed)
    x = r.randn(n, 4)
    x[:, 2] = r.choice([0, 1, 2, 7, 300, 70_000, -3, np.nan], n,
                       p=[.2, .2, .1, .1, .15, .15, .05, .05])
    x[:, 3] = r.randint(0, 3, n)
    y = (x[:, 0] + (x[:, 2] == 300) - (x[:, 3] == 1) > 0).astype(np.float32)
    xv = x[:600].copy()
    xv[::3, 2] = r.choice([5, 999, 123_456], len(xv[::3]))
    return x, y, xv


# ---------------------------------------------------------------- binning
def _mapper_fields(m):
    d = m.to_dict()
    d["categorical_2_bin"] = dict(m.categorical_2_bin)
    return d


@pytest.mark.parametrize("kind", ["workload", "odd_values"])
def test_mappers_and_stored_matrix_match_jax(kind):
    if kind == "workload":
        x, y = small_categorical()
        xv, cat = small_categorical(1500, seed=1)[0], CATEGORICAL_FEATURES
    else:
        x, y, xv = odd_values()
        cat = [2, 3]
    params = {"objective": "binary", "verbosity": -1}
    t = TBinned.from_matrix(x, TConfig(params), label=y,
                            categorical_feature=cat)
    j = JBinned.from_matrix(x, JConfig(params), label=y,
                            categorical_feature=cat)
    for tm, jm in zip(t.bin_mappers, j.bin_mappers):
        assert _mapper_fields(tm) == _mapper_fields(jm)
    assert t.X_binned.tobytes() == j.X_binned.tobytes()
    assert t.col_features == j.col_features
    assert t.get_feature_infos() == j.get_feature_infos()
    tv = TBinned.from_matrix(xv, TConfig(params), reference=t)
    jv = JBinned.from_matrix(xv, JConfig(params), reference=j)
    assert tv.X_binned.tobytes() == jv.X_binned.tobytes()
    if kind == "odd_values":
        m = t.bin_mappers[2]
        assert 70_000 in m.bin_2_categorical and -3 not in m.bin_2_categorical
        # NaN, the negative id and the unseen ids all take bin 0
        assert (t.X_binned[np.isnan(x[:, 2]) | (x[:, 2] < 0), 2] == 0).all()
        unseen = ~np.isin(xv[:, 2], m.bin_2_categorical)
        assert unseen.any() and (tv.X_binned[unseen, 2] == 0).all()


def test_mapper_dict_round_trip():
    x, y, _ = odd_values()
    t = TBinned.from_matrix(x, TConfig({}), label=y, categorical_feature=[2])
    m = t.bin_mappers[2]
    back = type(m).from_dict(m.to_dict())
    assert _mapper_fields(back) == _mapper_fields(m)
    vals = np.array([0, 7, 300, 70_000, -3, np.nan, 12.0, 300.7])
    np.testing.assert_array_equal(back.values_to_bins(vals),
                                  [m.value_to_bin(v) for v in vals])
    assert back.bin_to_value(0) == 0.0
    assert back.bin_to_value(1) == float(m.bin_2_categorical[0])


# ---------------------------------------------------------------- finder
def _leaf_histograms(seed, n=3000, bins=(12, 4, 30, 200)):
    """[F, B, 3] histograms of one leaf's rows over a numerical feature and
    categorical ones of 4, 30 and 200 bins, low bins the most frequent,
    each bin of each feature with its own effect on the gradients."""
    r = np.random.RandomState(seed)
    binv = [np.minimum((r.rand(n) ** 2 * nb).astype(int), nb - 1)
            for nb in bins]
    g = r.randn(n) + sum(0.7 * np.random.RandomState(seed + f).randn(nb)[bv]
                         for f, (nb, bv) in enumerate(zip(bins, binv)))
    h = 0.1 + r.rand(n)
    hist = np.zeros((len(bins), 256, 3), np.float32)
    for f, bv in enumerate(binv):
        for k, v in enumerate((g, h, np.ones(n))):
            np.add.at(hist[f, :, k], bv, v.astype(np.float32))
    return hist, bins


FINDER_CASES = {
    "default": {},
    "max_cat_threshold": {"max_cat_threshold": 2},
    "min_data_per_group": {"min_data_per_group": 400},
    "onehot_wide": {"max_cat_to_onehot": 32},
}


def _split_params(pkg, extra):
    base = dict(lambda_l1=0.0, lambda_l2=0.0, max_delta_step=0.0,
                min_data_in_leaf=20, min_sum_hessian_in_leaf=1e-3,
                min_gain_to_split=0.0, max_cat_threshold=32, cat_smooth=10.0,
                cat_l2=10.0, max_cat_to_onehot=4, min_data_per_group=100)
    base.update(extra)
    if pkg is jsplit:
        return jsplit.SplitParams(**base)
    return tsplit.SplitParams(**base, cat_features=(1, 2, 3))


def _run_finders(hist, bins, extra):
    f = len(bins)
    is_cat = np.array([False, True, True, True])
    jmeta = jsplit.FeatureMeta(
        num_bin=jnp.asarray(bins, jnp.int32),
        missing_type=jnp.zeros(f, jnp.int32),
        default_bin=jnp.zeros(f, jnp.int32),
        is_categorical=jnp.asarray(is_cat),
        penalty=jnp.ones(f, jnp.float32), monotone=jnp.zeros(f, jnp.int32))
    tmeta = tsplit.FeatureMeta(
        num_bin=torch.as_tensor(bins), missing_type=torch.zeros(f, dtype=int),
        default_bin=torch.zeros(f, dtype=int), penalty=torch.ones(f),
        is_categorical=torch.as_tensor(is_cat))
    # the first feature's totals, as a leaf's are
    sg, sh, nd = (np.float32(hist[0, :, k].sum()) for k in range(3))
    jpf, jbits = jsplit.per_feature_split_categorical(
        jnp.asarray(hist), jmeta, _split_params(jsplit, extra),
        jnp.float32(sg), jnp.float32(sh), jnp.float32(nd),
        jnp.ones(f, bool))
    tpf, tbits = tsplit.per_feature_split_categorical(
        torch.as_tensor(hist)[None], tmeta, _split_params(tsplit, extra),
        torch.tensor([sg]), torch.tensor([sh]), torch.tensor([nd]),
        torch.ones(f, dtype=torch.bool))
    return jpf, np.asarray(jbits)[1:], tpf, tbits[0].numpy()


@pytest.mark.parametrize("case", sorted(FINDER_CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_categorical_finder_matches_jax(case, seed):
    hist, bins = _leaf_histograms(seed)
    jpf, jbits, tpf, tbits = _run_finders(hist, bins, FINDER_CASES[case])
    np.testing.assert_array_equal(tbits.astype(np.uint32), jbits)
    for name in ("gain", "left_sum_grad", "left_sum_hess", "left_count",
                 "left_output", "right_output"):
        np.testing.assert_allclose(getattr(tpf, name)[0].numpy(),
                                   np.asarray(getattr(jpf, name))[1:],
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    # feature 1 (4 bins) splits one-vs-rest, the others by sorted subsets
    left = [bin(int.from_bytes(np.asarray(w, "<u4").tobytes(), "little"))
            .count("1") for w in tbits]
    assert np.isfinite(tpf.gain[0].numpy()).any()
    assert left[0] == 1
    if case == "onehot_wide":
        assert left[1] == 1          # 30 bins, now under max_cat_to_onehot
    elif case == "max_cat_threshold":
        assert max(left[1:]) <= 2
    else:
        assert max(left[1:]) > 1


@pytest.mark.parametrize("case", ["max_cat_threshold", "min_data_per_group"])
def test_finder_options_bind(case):
    """Each option changes some feature's bitset on these histograms."""
    changed = 0
    for seed in (0, 1):
        hist, bins = _leaf_histograms(seed)
        base = _run_finders(hist, bins, {})[3]
        other = _run_finders(hist, bins, FINDER_CASES[case])[3]
        changed += int((base != other).any())
    assert changed > 0


# ---------------------------------------------------------------- training
def cat_key(t, i):
    return (int(t.split_feature[i]), round(float(t.threshold[i]), 9),
            np.trim_zeros(np.asarray(t.cat_bitset[i], np.uint32),
                          "b").tobytes() if t.is_categorical[i] else b"")


def assert_tie_rule(jt, tt):
    """tests/test_torch_regression.py's f32 tie rule, with a categorical
    node's raw bitset in its key: the same size, at most 6 positional and
    4 substituted splits apart."""
    nn = jt.num_leaves_actual - 1
    assert tt.num_leaves_actual - 1 == nn
    assert len(np.flatnonzero(tt.split_feature[:nn]
                              != jt.split_feature[:nn])) <= 6
    ours = collections.Counter(cat_key(tt, i) for i in range(nn))
    ref = collections.Counter(cat_key(jt, i) for i in range(nn))
    assert sum(((ours - ref) + (ref - ours)).values()) <= 4


_TRAINED = {}


def _train_both(growth, objective):
    """(x, JAX booster, port booster, both evals_result, the valid rows) on
    the small categorical data with a validation set of 1,500 rows (seed
    1), trained once per module and shared by every test of the pair."""
    key = (growth, objective)
    if key not in _TRAINED:
        x, y = small_categorical()
        xv, yv = small_categorical(1500, seed=1)
        if objective == "regression":
            y, yv = regression_target(x, y), regression_target(xv, yv)
        params = dict(PARAMS, objective=objective, **GROWTHS[growth])
        jev, tev = {}, {}
        jtr = jlgb.Dataset(x, label=y,
                           categorical_feature=CATEGORICAL_FEATURES,
                           free_raw_data=False)
        jb = jlgb.train(params, jtr, num_boost_round=ROUNDS,
                        valid_sets=[jtr.create_valid(xv, label=yv)],
                        evals_result=jev, verbose_eval=False)
        ttr = tlgb.Dataset(x, label=y,
                           categorical_feature=CATEGORICAL_FEATURES,
                           device="cpu")
        tb = tlgb.train(params, ttr, num_boost_round=ROUNDS,
                        valid_sets=[ttr.create_valid(xv, label=yv)],
                        evals_result=tev, verbose_eval=False, device="cpu")
        _TRAINED[key] = (x, jb, tb, jev, tev, xv)
    return _TRAINED[key]


@pytest.mark.parametrize("objective", ["binary", "regression"])
@pytest.mark.parametrize("growth", ["exact"])
def test_trees_match_jax(growth, objective):
    x, jb, tb = _train_both(growth, objective)[:3]
    assert tb._impl.grow_params.split.cat_features == (28, 29, 30, 31)
    assert len(tb.models) == len(jb._impl.models) == ROUNDS
    for jt, tt in zip(jb._impl.models, tb.models):
        assert_tie_rule(jt, tt)
        nn = jt.num_leaves_actual - 1
        np.testing.assert_allclose(tt.split_gain[:nn].sum(),
                                   jt.split_gain[:nn].sum(), rtol=1e-3)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=0,
                               atol=1e-5)
    splits = categorical_splits(tb.models)
    assert splits["categorical"] > 0 and splits["multi_category"] > 0


def test_tree0_is_the_jax_tree():
    """Exact growth's first tree, node for node: features, bins, children,
    default directions and both bitsets."""
    _, jb, tb = _train_both("exact", "binary")[:3]
    jt, tt = jb._impl.models[0], tb.models[0]
    nn = jt.num_leaves_actual - 1
    assert tt.num_leaves_actual - 1 == nn
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child", "default_left", "is_categorical",
                 "cat_bitset_bin", "cat_bitset"):
        np.testing.assert_array_equal(getattr(tt, name)[:nn],
                                      getattr(jt, name)[:nn], err_msg=name)
    np.testing.assert_allclose(tt.leaf_value[:nn + 1],
                               jt.leaf_value[:nn + 1], rtol=1e-5)


def test_ids_past_255_route_through_the_raw_bitset():
    x, y = wide_ids()
    params = dict(PARAMS, objective="binary")
    jb = jlgb.train(params, jlgb.Dataset(x, label=y, categorical_feature=[3]),
                    num_boost_round=ROUNDS)
    tb = tlgb.train(params, tlgb.Dataset(x, label=y, categorical_feature=[3],
                                         device="cpu"),
                    num_boost_round=ROUNDS, device="cpu")
    splits = categorical_splits(tb.models)
    assert splits["max_category"] >= 256 and splits["widest_words"] > 8
    xt = x.copy()
    xt[::5, 3] = np.nan
    xt[1::5, 3] = -300.0
    xt[2::5, 3] = 300.5          # truncates to the id 300
    xt[3::5, 3] = 1e9            # past every bitset: right
    for data in (x, xt):
        np.testing.assert_allclose(tb.predict(data, raw_score=True),
                                   jb.predict(data, raw_score=True), rtol=0,
                                   atol=1e-5)


SUMMED_KEYS = ("split_gain", "leaf_value", "internal_value", "leaf_weight",
               "internal_weight")


def test_model_text_matches_jax():
    """A categorical model's text is the JAX package's: every line equal
    (num_cat, thresholds as cat_boundaries indices, decision_type bit 0,
    cat_boundaries, cat_threshold), the f32 sums within 1e-4 relative; the
    text reloads in the port with the same predictions, and a JAX-written
    text loads in the port within 1e-6."""
    x, jb, tb = _train_both("exact", "binary")[:3]
    ours, ref = tb.model_to_string(), jb.model_to_string()
    assert "cat_threshold=" in ours
    lines, ref_lines = ours.splitlines(), ref.splitlines()
    assert len(lines) == len(ref_lines)
    for a, b in zip(lines, ref_lines):
        key = a.split("=", 1)[0]
        if key == "tree_sizes":
            continue
        if key in SUMMED_KEYS:
            assert key == b.split("=", 1)[0]
            np.testing.assert_allclose(
                np.array(a.split("=", 1)[1].split(), float),
                np.array(b.split("=", 1)[1].split(), float), rtol=1e-4,
                atol=1e-6, err_msg=key)
        else:
            assert a == b
    loaded = tlgb.Booster(model_str=ours, device="cpu")
    np.testing.assert_allclose(loaded.predict(x, raw_score=True),
                               tb.predict(x, raw_score=True), rtol=0,
                               atol=1e-6)
    from_jax = tlgb.Booster(model_str=ref, device="cpu")
    np.testing.assert_allclose(from_jax.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=0,
                               atol=1e-6)


def test_numpy_forest_carries_categorical_trees():
    """convert.py builds the port's trees and mappers from the JAX
    package's numpy fields, bitsets included."""
    from lightgbm_tpu_torch.convert import booster_from_numpy
    x, jb = _train_both("exact", "binary")[:2]
    fields = ("split_feature", "threshold", "threshold_bin", "default_left",
              "missing_type", "left_child", "right_child", "leaf_value",
              "internal_value", "split_gain", "is_categorical", "cat_bitset",
              "cat_bitset_bin")
    trees = [{k: getattr(t, k) for k in fields} for t in jb._impl.models]
    mappers = [m.to_dict() for m in jb._impl.train_data.bin_mappers]
    bst = booster_from_numpy(trees, mappers, device="cpu")
    np.testing.assert_allclose(bst.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=0,
                               atol=1e-6)
    assert bst.model_to_string().count("cat_threshold=") == ROUNDS


# ---------------------------------------------------------------- pandas
def _frame(n=3000, seed=2):
    r = np.random.RandomState(seed)
    colors = np.array(["red", "green", "blue", "teal", "gold"])
    df = pd.DataFrame({
        "a": r.randn(n), "b": r.randn(n),
        "color": pd.Categorical(colors[r.randint(0, 5, n)],
                                categories=["teal", "red", "gold", "green",
                                            "blue"]),
        "size": pd.Categorical(r.choice([3, 10, 30], n))})
    y = (df["a"] + (df["color"] == "red") - 0.8 * (df["size"] == 30)
         + 0.3 * r.randn(n) > 0).astype(np.float32)
    return df, y.values


def test_pandas_category_columns_match_jax():
    df, y = _frame()
    params = dict(PARAMS, objective="binary")
    jb = jlgb.train(params, jlgb.Dataset(df, label=y), num_boost_round=ROUNDS)
    tb = tlgb.train(params, tlgb.Dataset(df, label=y, device="cpu"),
                    num_boost_round=ROUNDS, device="cpu")
    assert tb.pandas_categorical == jb.pandas_categorical
    assert categorical_splits(tb.models)["categorical"] > 0
    np.testing.assert_allclose(tb.predict(df, raw_score=True),
                               jb.predict(df, raw_score=True), rtol=0,
                               atol=1e-5)
    # the sidecar line is the JAX package's, and a reloaded port model
    # codes a frame whose categories come in another order the same way
    line = [l for l in tb.model_to_string().splitlines()
            if l.startswith("pandas_categorical:")]
    assert line == [l for l in jb.model_to_string().splitlines()
                    if l.startswith("pandas_categorical:")]
    loaded = tlgb.Booster(model_str=tb.model_to_string(), device="cpu")
    shuffled = df.copy()
    shuffled["color"] = shuffled["color"].cat.reorder_categories(
        ["blue", "green", "gold", "red", "teal"])
    np.testing.assert_allclose(loaded.predict(shuffled, raw_score=True),
                               tb.predict(df, raw_score=True), rtol=0,
                               atol=1e-6)
    with pytest.raises(Exception, match="different categorical columns"):
        loaded.predict(df.assign(color=df["color"].astype(str)
                                 .map(len).astype(float)))


def test_set_categorical_feature_before_construct():
    x, y, _ = odd_values()
    ds = tlgb.Dataset(x, label=y, device="cpu").set_categorical_feature([3])
    bst = tlgb.train(dict(PARAMS, objective="binary"), ds,
                     num_boost_round=1, device="cpu")
    assert bst._impl.grow_params.split.cat_features == (3,)
    with pytest.raises(Exception, match="after dataset was constructed"):
        ds.set_categorical_feature([2])


# ---------------------------------------------------------------- replay
@pytest.mark.parametrize("growth", ["exact"])
def test_valid_scores_are_predict(growth):
    """A categorical validation set's device scores (the binned replay of
    each tree) are the model's raw predictions, its metric the JAX
    package's (binary's default, binary_logloss)."""
    _, _, tb, jev, tev, xv = _train_both(growth, "binary")
    np.testing.assert_allclose(tb._impl.scores_of(1),
                               tb.predict(xv, raw_score=True), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tev["valid_0"]["binary_logloss"],
                               jev["valid_0"]["binary_logloss"], rtol=0,
                               atol=1e-5)


def test_continued_training_rederives_the_bin_bitsets():
    """Continuing from a model text re-derives each categorical node's
    bin-space bitset from its raw one through the new training set's
    mappers (the JAX package's loaded trees have none): with every valid
    category known to those mappers, the replayed valid scores are the
    model's raw predictions, and so are the training scores after a
    rollback."""
    x, y = small_categorical()
    params = dict(PARAMS, objective="binary")
    first = tlgb.train(params, tlgb.Dataset(
        x, label=y, categorical_feature=CATEGORICAL_FEATURES, device="cpu"),
        num_boost_round=2, device="cpu")
    text = first.model_to_string()
    ttr = tlgb.Dataset(x, label=y, categorical_feature=CATEGORICAL_FEATURES,
                       free_raw_data=False, device="cpu")
    xv = x[::3].copy()
    known = [set(m.bin_2_categorical)
             for m in ttr.construct()._binned.bin_mappers[28:]]
    keep = np.all([np.isin(xv[:, 28 + j], sorted(k))
                   for j, k in enumerate(known)], axis=0)
    xv = xv[keep]
    more = tlgb.train(params, ttr, num_boost_round=2,
                      init_model=tlgb.Booster(model_str=text, device="cpu"),
                      valid_sets=[ttr.create_valid(xv, label=y[::3][keep])],
                      verbose_eval=False, device="cpu")
    assert more.num_trees() == 4
    assert any(t.cat_bitset_bin.any() for t in more.models[:2])
    np.testing.assert_allclose(more._impl.scores_of(1),
                               more.predict(xv, raw_score=True), rtol=0,
                               atol=1e-5)
    more.rollback_one_iter()
    np.testing.assert_allclose(more._impl.scores_of(0),
                               more.predict(x, raw_score=True), rtol=0,
                               atol=1e-5)
