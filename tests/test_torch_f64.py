"""Float64 histograms (``gpu_use_dp=true``, ``tpu_hist_dtype=float64``) in
the port and in the JAX package, on the CPU.

- ``hist_dtype`` resolves the spellings as the JAX package's
  ``_hist_dtype`` does, and raises its ``LightGBMError`` on an unknown one.
- The plain histogram in float64 against the JAX package's f64 scatter,
  and ``find_best_split`` on float64 histograms against the JAX package's
  f64 search: the same split, its gain and sums within 1e-12 relative.
- Exact growth under ``gpu_use_dp=true``, 3 rounds at 3,000 rows
  (num_leaves=15, max_bin=63), each booster trained once per module:
  binary, L2, 4-class softmax, lambdarank, categorical data, monotone
  constraints, forced splits with CEGB and bagging. Every tree is
  the JAX package's node for node (feature, threshold bin, default_left,
  children), its leaf values within LEAF_REL (2e-7) of the tree's largest
  leaf value, and raw predictions within 1e-6 of the JAX model's training
  scores. On the categorical data a one-vs-rest split and its mirror are
  the same split (an exact tie that f64 keeps), so a node may hold either.
- Bagging and GOSS under f64 draw the JAX package's x64 draws (float64
  uniforms, an int64 seed). The JAX package's GOSS raises under f64, so
  the port's GOSS is held to its warm-up trees and the JAX selection.
- ``max_delta_step=0.3`` with ``min_sum_hessian_in_leaf=20`` at
  ``max_bin=63``, where f32 sums tie at zero gain (ROADMAP Queue 3): the
  f64 trees are the JAX package's up to the first split whose true gain
  is 0, which both take on rounding noise; from there one noise gain
  beats another in each, and the test shows both.
- frontier, batched and ``tpu_batched_part=true`` under f64 log the JAX
  package's warning and grow the exact trees; forced splits or CEGB under
  frontier still raise first.
- ``tpu_hist_dtype=float64`` trains the trees of ``gpu_use_dp=true``; the
  model text reloads and predicts within 1e-6.
- histogram.cu's f64 launch plan, and the f64 wrappers' refusal of CPU
  tensors.

Every JAX training runs with ``jax_enable_x64`` off before it and turns it
off after it (``_jax_f64``, and the autouse ``x64_stays_off``), as
tests/test_parity.py does: the JAX GBDT turns x64 on for the whole process
when f64 is asked for, which would change the dtypes of every later test
on the worker.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import collections
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from chip_smoke import (FORCED_SPLITS, bench_data, multiclass_data,
                        ranking_data, regression_data)
from lightgbm_tpu.boosting.gbdt import _hist_dtype as jax_hist_dtype
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.core import split as js
from lightgbm_tpu.core.histogram import _hist_scatter
from lightgbm_tpu_torch import random as threefry
from lightgbm_tpu_torch.boosting import goss as port_goss
from lightgbm_tpu_torch.boosting.gbdt import hist_dtype
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.core import histogram as th
from lightgbm_tpu_torch.core import kernels
from lightgbm_tpu_torch.core import split as ts
from lightgbm_tpu_torch.log import LightGBMError, Log

from test_torch_categorical import CATEGORICAL_FEATURES, cat_key
from test_torch_constraints import _metas, _two_leaves
from test_torch_split import SPLIT_PARAMS

ROUNDS = 3
ROWS = 3000
PARAMS = {"num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 20,
          "verbosity": -1, "gpu_use_dp": True}
# leaf values of identical trees, within this share of the tree's largest
# |leaf value|: f64 sums agree to ~1e-16, and each leaf is rounded to f32
# once; what is left are the gradients, which the port computes in f32 an
# ulp from the JAX package's in some rows after tree 0 (lambdarank's pairs
# also sum in another association). A leaf whose gradients nearly cancel
# carries that as a larger share of its own value: 9.3e-7 of a -0.0104
# leaf under bagging, an absolute 9.7e-9
LEAF_REL = 2e-7
SCORE_TOL = 1e-6
MONO = [1, -1, 0, 0, 0, 0, 0, 0]
CEGB = {"cegb_penalty_split": 0.002,
        "cegb_penalty_feature_coupled": [0.5] * 8,
        "cegb_penalty_feature_lazy": [0.02] * 8}
ZERO_GAIN = {"objective": "binary", "max_delta_step": 0.3,
             "min_sum_hessian_in_leaf": 20}
# a split gain no larger than this share of its tree's root gain is f64
# rounding noise of a true gain of 0 (the zero-gain case's 2.8e-14 against
# a root gain of 444)
NOISE_REL = 1e-12


@pytest.fixture(autouse=True)
def x64_stays_off():
    assert not jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", False)


def _jax_f64(train):
    """``train()`` (JAX package calls, returning host values) with
    jax_enable_x64 off before it and turned off after it."""
    assert not jax.config.jax_enable_x64
    try:
        return train()
    finally:
        jax.config.update("jax_enable_x64", False)


# ------------------------------------------------------------- spellings
SPELLINGS = {"float64": "f64", "f64": "f64", "double": "f64",
             " Float64 ": "f64", "float32": "f32", "f32": "f32",
             "single": "f32", "": "f32"}


@pytest.mark.parametrize("gpu_use_dp", [False, True])
@pytest.mark.parametrize("spelled", sorted(SPELLINGS))
def test_hist_dtype_spellings_match_jax(spelled, gpu_use_dp):
    params = {"tpu_hist_dtype": spelled, "gpu_use_dp": gpu_use_dp}
    want = SPELLINGS[spelled]
    if want == "f32" and gpu_use_dp:
        want = "f64"
    assert hist_dtype(Config(params)) == want
    assert jax_hist_dtype(JConfig(params)) == want


def test_unknown_spelling_raises_the_jax_error():
    x, y = bench_data(300)
    with pytest.raises(LightGBMError) as ours:
        tlgb.train({"objective": "binary", "tpu_hist_dtype": "bf16",
                    "verbosity": -1},
                   tlgb.Dataset(x, label=y, device="cpu"), 1, device="cpu")
    with pytest.raises(jlgb.LightGBMError) as ref:
        jax_hist_dtype(JConfig({"tpu_hist_dtype": "bf16"}))
    assert str(ours.value) == str(ref.value) == (
        "unknown tpu_hist_dtype 'bf16' (use float32 or float64)")


# ------------------------------------------------------ histogram, split
@pytest.mark.parametrize("k", [3, 6])
def test_plain_histogram_in_f64_matches_jax(k):
    r = np.random.RandomState(k)
    xb = r.randint(0, 31, (4000, 5)).astype(np.uint8)
    vals = r.randn(4000, k) * 10.0 ** r.randint(-3, 4, (4000, 1))
    ours = th.hist_tile_vals(torch.as_tensor(xb), torch.as_tensor(vals), 32)
    assert ours.dtype == torch.float64
    ref = _jax_f64(lambda: (jax.config.update("jax_enable_x64", True),
                            np.asarray(_hist_scatter(
                                jnp.asarray(xb), jnp.asarray(vals),
                                32)))[1])
    assert ref.dtype == np.float64
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-13, atol=1e-12)


@pytest.mark.parametrize("cat", [(), (2, 5)], ids=["numerical",
                                                   "categorical"])
@pytest.mark.parametrize("seed", [0, 1])
def test_find_best_split_in_f64_matches_jax(seed, cat):
    hist, tot, meta = _two_leaves(10 * seed + 3, cat)
    hist, tot = hist.astype(np.float64), tot.astype(np.float64)
    f = hist.shape[1]
    fmask = np.ones(f, bool)
    kw = SPLIT_PARAMS[seed % 2]
    sp = ts.SplitParams(**kw, cat_features=tuple(cat),
                        min_data_per_group=20, cat_smooth=5.0)
    pen = np.abs(np.random.RandomState(seed).randn(2, f)) * 0.5
    t = torch.as_tensor(tot)
    ours = ts.find_best_split(torch.as_tensor(hist), _metas(
        meta, cat, np.zeros(f, np.int64))[1], sp, t[:, 0], t[:, 1],
        t[:, 2], torch.as_tensor(fmask), gain_penalty=torch.as_tensor(pen))
    assert ours.gain.dtype == ours.left_output.dtype == torch.float64

    def reference():
        jax.config.update("jax_enable_x64", True)
        jmeta = _metas(meta, cat, np.zeros(f, np.int64))[0]
        jparams = js.SplitParams(max_cat_threshold=32, cat_smooth=5.0,
                                 cat_l2=10.0, max_cat_to_onehot=4,
                                 min_data_per_group=20, **kw)
        out = []
        for i in range(2):
            ref = js.find_best_split(
                jnp.asarray(hist[i]), jmeta, jparams, jnp.float64(tot[i, 0]),
                jnp.float64(tot[i, 1]), jnp.float64(tot[i, 2]),
                jnp.asarray(fmask), with_categorical=bool(cat),
                gain_penalty=jnp.asarray(pen[i]))
            assert ref.gain.dtype == jnp.float64
            out.append({k: np.asarray(v) for k, v in ref._asdict().items()})
        return out

    for i, ref in enumerate(_jax_f64(reference)):
        assert int(ours.feature[i]) == int(ref["feature"])
        assert int(ours.threshold[i]) == int(ref["threshold"])
        assert bool(ours.default_left[i]) == bool(ref["default_left"])
        np.testing.assert_array_equal(
            ours.cat_bitset[i].numpy().astype(np.uint32), ref["cat_bitset"])
        for name in ("gain", "left_output", "right_output", "left_sum_grad",
                     "left_sum_hess", "left_count"):
            np.testing.assert_allclose(float(getattr(ours, name)[i]),
                                       float(ref[name]), rtol=1e-12,
                                       atol=1e-300, err_msg=name)


# ---------------------------------------------------------------- training
def _binary8():
    x, y = bench_data(ROWS)
    return x[:, :8], y, {}


def _data(name):
    """(x, label, Dataset keywords) of one case."""
    if name in ("l2", "monotone"):
        x, t = regression_data(ROWS)
        return (x[:, :8] if name == "monotone" else x), t, {}
    if name == "softmax":
        x, y = multiclass_data(ROWS, num_class=4)
        return x, y, {}
    if name == "lambdarank":
        x, rel, sizes = ranking_data(ROWS)
        return x, rel, {"group": sizes}
    if name == "categorical":
        from chip_smoke import categorical_data
        x, y = categorical_data(ROWS)
        return x, y, {"categorical_feature": CATEGORICAL_FEATURES}
    if name in ("forced_cegb", "bagging", "goss"):
        return _binary8()
    x, y = bench_data(ROWS)
    return x, y, {}


CASES = {
    "binary": {"objective": "binary"},
    "l2": {"objective": "regression"},
    "softmax": {"objective": "multiclass", "num_class": 4},
    "lambdarank": {"objective": "lambdarank"},
    "categorical": {"objective": "binary", "min_data_in_leaf": 40},
    "monotone": {"objective": "regression", "monotone_constraints": MONO},
    "forced_cegb": dict(CEGB, objective="binary"),
    "bagging": {"objective": "binary", "bagging_fraction": 0.7,
                "bagging_freq": 1},
    # learning_rate 0.5: the third iteration samples
    "goss": {"objective": "binary", "boosting": "goss",
             "learning_rate": 0.5},
    "zero_gain": ZERO_GAIN,
}
_TRAINED = {}


@pytest.fixture(scope="module")
def forced_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("f64") / "forced.json"
    path.write_text(json.dumps(FORCED_SPLITS))
    return str(path)


def _params(name, forced_file):
    params = dict(PARAMS, **CASES[name])
    if name == "forced_cegb":
        params["forcedsplits_filename"] = forced_file
    return params


def train_both(name, forced_file):
    """(x, JAX models and training scores, port booster), trained once per
    module."""
    if name not in _TRAINED:
        x, y, extra = _data(name)
        params = _params(name, forced_file)

        def train():
            jb = jlgb.train(params, jlgb.Dataset(x, label=y, **extra),
                            num_boost_round=ROUNDS)
            assert jb._impl.grow_params.hist_dtype == "f64"
            s = np.asarray(jb._impl.scores, np.float64)
            return jb._impl.models, s[:, 0] if s.shape[1] == 1 else s
        models, scores = _jax_f64(train)
        tb = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu",
                                             **extra),
                        num_boost_round=ROUNDS, device="cpu")
        _TRAINED[name] = (x, (models, scores), tb)
    return _TRAINED[name]


TREE_FIELDS = ("split_feature", "threshold_bin", "default_left",
               "left_child", "right_child", "split_leaf")
# what a split decides (the children follow from the splits made)
DECISION_FIELDS = ("split_feature", "threshold_bin", "default_left",
                   "split_leaf")


def assert_trees_equal(jt, tt, leaf_rel, mirror=False):
    """Node for node, leaf values within ``leaf_rel`` of the largest. With
    ``mirror`` a
    categorical node may send the other side of the same partition left
    (its bitset then differs, and its children's values swap sides)."""
    nn = jt.num_leaves_actual - 1
    assert tt.num_leaves_actual == jt.num_leaves_actual
    scale = np.abs(jt.leaf_value[:nn + 1]).max()
    if mirror:
        assert collections.Counter(
            cat_key(tt, i)[0] for i in range(nn)) == collections.Counter(
            cat_key(jt, i)[0] for i in range(nn))
        np.testing.assert_allclose(np.sort(tt.leaf_value[:nn + 1]),
                                   np.sort(jt.leaf_value[:nn + 1]), rtol=0,
                                   atol=leaf_rel * scale)
        return
    for name in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(tt, name)[:nn],
                                      getattr(jt, name)[:nn], err_msg=name)
    np.testing.assert_allclose(tt.leaf_value[:nn + 1],
                               jt.leaf_value[:nn + 1], rtol=0,
                               atol=leaf_rel * scale)


PARITY = [n for n in CASES if n not in ("zero_gain", "goss")]


@pytest.mark.parametrize("name", PARITY)
def test_exact_f64_matches_jax(name, forced_file):
    x, (jmodels, jscores), tb = train_both(name, forced_file)
    assert tb._impl.grow_params.hist_dtype == "f64"
    assert len(tb.models) == len(jmodels) == ROUNDS * (
        4 if name == "softmax" else 1)
    for jt, tt in zip(jmodels, tb.models):
        assert tt.num_leaves_actual > 1
        assert_trees_equal(jt, tt, LEAF_REL,
                           mirror=name == "categorical"
                           and not np.array_equal(tt.cat_bitset,
                                                  jt.cat_bitset))
    np.testing.assert_allclose(tb.predict(x, raw_score=True), jscores,
                               rtol=0, atol=SCORE_TOL)


def _logloss(raw, y):
    p = 1.0 / (1.0 + np.exp(-raw))
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def test_zero_gain_splits_part_only_on_f64_noise(forced_file):
    """f64 does not settle this case. The trees are the JAX package's up to
    the first split whose gain is rounding noise of a true 0 (both children
    clamped to the parent's output by max_delta_step): there several
    leaves offer such a gain, and the two summation orders pick different
    ones. The trees after that one regrow from other scores (chip_smoke.py
    phase 5's rule for a located tie), so the forests are held to their
    train loss within 1e-3 relative, this case alone."""
    x, (jmodels, jscores), tb = train_both("zero_gain", forced_file)
    parted = None
    for i, (jt, tt) in enumerate(zip(jmodels, tb.models)):
        nn = jt.num_leaves_actual - 1
        same = np.array([all(getattr(tt, k)[j] == getattr(jt, k)[j]
                             for k in DECISION_FIELDS) for j in range(nn)])
        if same.all() and tt.num_leaves_actual == jt.num_leaves_actual:
            assert_trees_equal(jt, tt, LEAF_REL)
            continue
        first = int(np.argmin(same))
        root = float(jt.split_gain[0])
        # the parting node: both splits are noise of a zero gain
        for t in (jt, tt):
            assert abs(float(t.split_gain[first])) <= NOISE_REL * root, (
                i, first, t.split_gain)
        parted = (i, first, int(jt.split_leaf[first]),
                  float(jt.split_gain[first]), int(tt.split_leaf[first]),
                  float(tt.split_gain[first]))
        break
    # tree 0, node 6: the JAX package splits leaf 3 at gain 2.8e-14, the
    # port leaf 0 at gain 2.8e-14, every split before it identical
    assert parted is not None and parted[:3] == (0, 6, 3) \
        and parted[4] == 0, parted
    print("f64 zero-gain parting (tree, node, JAX leaf, gain, port leaf, "
          "gain):", parted)
    y = _data("zero_gain")[1]
    np.testing.assert_allclose(_logloss(tb.predict(x, raw_score=True), y),
                               _logloss(jscores, y), rtol=1e-3)


# --------------------------------------------------------- sampled rows
@pytest.mark.parametrize("seed", [3, -5])
def test_x64_key_and_f64_draw_match_jax(seed):
    """Under f64 the JAX package runs with 64-bit types on: its key takes
    an int64 seed and ``uniform`` draws float64 from 64 random bits."""
    def draw():
        jax.config.update("jax_enable_x64", True)
        key = jax.random.PRNGKey(seed)
        sub = jax.random.split(key)[1]
        u = jax.random.uniform(sub, (5000,))
        assert u.dtype == jnp.float64
        return (tuple(int(v) for v in jax.random.key_data(key)),
                np.asarray(u))
    jkey, ju = _jax_f64(draw)
    key = threefry.prng_key(seed, x64=True)
    assert key == jkey
    got = threefry.uniform(threefry.split(key)[1], 5000,
                           dtype=torch.float64)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), ju)


def test_goss_rows_under_f64_are_the_jax_draws():
    """GOSS's kept rows from a float64 draw, against the JAX package's
    selection (gbdt.py:1131-1139 there) computed under x64."""
    r = np.random.RandomState(0)
    g = r.randn(1, 4000).astype(np.float32)
    h = r.rand(1, 4000).astype(np.float32)
    key = threefry.split(threefry.prng_key(3, x64=True))[1]
    top_cnt, other_cnt = port_goss.goss_counts(4000, 0.2, 0.1)
    ours = port_goss.goss_multipliers(torch.as_tensor(g),
                                      torch.as_tensor(h), key, 0.2, 0.1,
                                      torch.float64).numpy()

    def reference():
        jax.config.update("jax_enable_x64", True)
        gh = jnp.sum(jnp.abs(jnp.asarray(g.T) * jnp.asarray(h.T)), axis=1)
        is_top = gh >= jax.lax.top_k(gh, top_cnt)[0][-1]
        u = jax.random.uniform(jnp.asarray(key, jnp.uint32), (4000,))
        keep = (~is_top) & (u < other_cnt / (4000 - top_cnt))
        return np.asarray(is_top), np.asarray(keep)
    is_top, keep = _jax_f64(reference)
    np.testing.assert_array_equal(ours > 0, is_top | keep)
    np.testing.assert_array_equal(ours == 1.0, is_top)


def test_goss_trains_where_the_jax_package_raises(forced_file):
    """The JAX package's GOSS raises under f64 (its two ``lax.cond``
    branches return float64 and float32 multipliers; ROADMAP Queue 3), so
    there is nothing to hold the port's GOSS trees to: the port trains,
    its warm-up trees are the JAX package's f64 trees at the same
    learning rate without GOSS, and its rows are the JAX draws
    (``test_goss_rows_under_f64_are_the_jax_draws``)."""
    x, y, _ = _data("goss")
    params = _params("goss", forced_file)

    def train():
        with pytest.raises(TypeError, match="cond branches"):
            jlgb.train(params, jlgb.Dataset(x, label=y),
                       num_boost_round=ROUNDS)
        jb = jlgb.train(dict(params, boosting="gbdt"),
                        jlgb.Dataset(x, label=y), num_boost_round=2)
        return jb._impl.models
    warm = _jax_f64(train)
    tb = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                    num_boost_round=ROUNDS, device="cpu")
    assert tb._impl.goss_active(2) and not tb._impl.goss_active(1)
    assert all(t.num_leaves_actual > 1 for t in tb.models)
    for jt, tt in zip(warm, tb.models[:2]):
        assert_trees_equal(jt, tt, LEAF_REL)
    assert np.isfinite(tb.predict(x, raw_score=True)).all()


# ------------------------------------------------------- growth fallbacks
WAVES = {"frontier": {"tree_growth": "frontier"},
         "batched": {"tree_growth": "batched", "tree_batch_splits": 4},
         "batched_part": {"tree_growth": "batched", "tree_batch_splits": 4,
                          "tpu_batched_part": "true"}}


@pytest.mark.parametrize("growth", sorted(WAVES))
def test_wave_growth_falls_back_to_exact(growth, forced_file):
    x, (jmodels, jscores), exact = train_both("binary", forced_file)
    logged = []
    Log.reset_callback(logged.append)
    try:
        x, y, _ = _data("binary")
        params = dict(_params("binary", forced_file), verbosity=0,
                      **WAVES[growth])
        tb = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                        num_boost_round=ROUNDS, device="cpu")
    finally:
        Log.reset_callback(None)
    mode = WAVES[growth]["tree_growth"]
    assert any("tree_growth=%s does not support f64 histograms yet; "
               "falling back to exact growth" % mode in line
               for line in logged), logged
    assert not tb._impl.grow_params.batched_part
    for et, tt in zip(exact.models, tb.models):
        for name in TREE_FIELDS + ("leaf_value", "split_gain"):
            np.testing.assert_array_equal(getattr(tt, name),
                                          getattr(et, name), err_msg=name)
    for jt, tt in zip(jmodels, tb.models):
        assert_trees_equal(jt, tt, LEAF_REL)


@pytest.mark.parametrize("growth", ["frontier", "batched"])
def test_forced_or_cegb_under_waves_still_raise(growth, forced_file):
    x, y, _ = _binary8()
    for extra in ({"forcedsplits_filename": forced_file}, CEGB):
        with pytest.raises(LightGBMError, match="requires exact split "
                                                "ordering"):
            tlgb.train(dict(PARAMS, objective="binary", tree_growth=growth,
                            **extra),
                       tlgb.Dataset(x, label=y, device="cpu"), 1,
                       device="cpu")


def test_tpu_hist_dtype_spelling_trains_the_same_trees(forced_file):
    x, _, dp = train_both("binary", forced_file)
    x, y, _ = _data("binary")
    params = dict(_params("binary", forced_file), gpu_use_dp=False,
                  tpu_hist_dtype="float64")
    tb = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                    num_boost_round=ROUNDS, device="cpu")
    assert tb._impl.grow_params.hist_dtype == "f64"
    for dt, tt in zip(dp.models, tb.models):
        for name in TREE_FIELDS + ("leaf_value", "split_gain"):
            np.testing.assert_array_equal(getattr(tt, name),
                                          getattr(dt, name), err_msg=name)


@pytest.mark.parametrize("name", ["binary", "softmax"])
def test_model_text_reloads(name, forced_file):
    x, _, tb = train_both(name, forced_file)
    text = tb.model_to_string()
    loaded = tlgb.Booster(model_str=text, device="cpu")
    np.testing.assert_allclose(loaded.predict(x, raw_score=True),
                               tb.predict(x, raw_score=True), rtol=0,
                               atol=1e-6)


# ------------------------------------------------------------- the kernel
@pytest.mark.parametrize("n,f,k,tiles,ft,replicas", [
    (1_000_000, 28, 3, 1, 28, 1), (1_000_000, 28, 6, 2, 14, 1),
    (1_000_000, 34, 6, 2, 17, 1), (20_000, 4, 3, 1, 4, 4)])
def test_f64_launch_plan(n, f, k, tiles, ft, replicas):
    plan = kernels.hist_launch_plan(n, f, 255, k, 132, "block", 8)
    assert (plan.grid_x, plan.feature_tile, plan.replicas) == (
        tiles, ft, replicas)
    assert plan.smem_bytes == replicas * -(-ft * 255 * k * 8 // 16) * 16
    assert plan.smem_bytes <= kernels.HIST_SMEM_OPT_IN
    # the f32 plan is unchanged by the element size argument
    assert kernels.hist_launch_plan(n, f, 255, k, 132, "block") == \
        kernels.hist_launch_plan(n, f, 255, k, 132, "block", 4)
    assert kernels.hist_bytes(n, f, 255, k, 8) == (
        n * f + 8 * n * k + 8 * f * 255 * k)


@pytest.mark.parametrize("wrapper", ["build_histogram_f64_cuda",
                                     "build_histogram_leaf_f64_cuda"])
def test_f64_wrappers_take_cuda_tensors_only(wrapper):
    xb = torch.zeros((8, 2), dtype=torch.uint8)
    vals = torch.zeros((8, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(kernels, wrapper)(xb, vals, 4)
