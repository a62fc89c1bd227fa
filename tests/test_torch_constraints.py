"""Monotone constraints, forced splits and CEGB in the port and in the JAX
package, on the CPU.

- ``find_best_split`` with output bounds, per-feature monotone
  constraints and a CEGB gain penalty, numerical and categorical features,
  two leaves at once in the port against one JAX call a leaf on the same
  histograms: feature, threshold, direction and bitset equal; gain and
  outputs within 1e-5 relative (float32 prefix sums in another order).
  With no option set the search is bit-equal to the plain call.
- Exact growth, 4 rounds at 3,000 rows (num_leaves=15, max_bin=63, as
  tests/test_torch_sampling.py trains): monotone constraints (regression,
  and binary with a categorical feature), forced splits (the four-step
  file of chip_smoke.py, a step whose left side is empty, which ends the
  forced phase there, and a forced split on a feature stored in an EFB
  bundle) and CEGB (split penalty alone, coupled, lazy, lazy with
  bagging, multiclass, whose classes grow from the iteration's state and
  merge theirs): every tree under tests/test_torch_slice.py's tie rule
  (identical where the JAX package's gains do not tie), raw predictions
  within 1e-5 of the JAX model's training scores, the forced nodes where
  they are forced, the constrained models monotone on a grid, and the CEGB
  state (features bought, rows paid) equal after 3 rounds.
- The JAX package's refusals, with its messages: a forced split on a
  categorical feature, forced splits or CEGB under frontier or batched
  growth, and a monotone_constraints list that does not cover every
  feature.
- The model text writes these options in its parameters block as the JAX
  package's does, and a reloaded model predicts within 1e-6.
- chip_smoke.py phase 5's rule for its monotone rows (``trees_match``
  under ``CLAMP_PARTING``) passes two summation orders of the plain path
  (float32 and float64 sums) and fails a float32 run whose histograms
  drop every 64th row.

Frontier, batched and batched_part growth under monotone constraints are in
tests/test_torch_constraints_waves.py.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from chip_smoke import (FORCED_SPLITS, FORCED_STEPS, bench_data,
                        bundled_data, forced_nodes, monotone_violation,
                        multiclass_data, regression_data)
from lightgbm_tpu.core import split as js
from lightgbm_tpu_torch.core import split as ts
from lightgbm_tpu_torch.log import LightGBMError

from test_torch_regression import assert_tie_rule
from test_torch_split import MISSING, SPLIT_PARAMS, _case

ROUNDS = 4
ROWS = 3000
PARAMS = {"num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 20,
          "verbosity": -1}
SCORE_TOL = 1e-5
MONO = [1, -1, 0, 0, 0, 0, 0, 0]
# CEGB settings on 8 features: the split penalty alone, coupled costs
# (features 4-7 too dear to buy), lazy costs, and lazy costs on bagged rows
CEGB = {
    "split": {"cegb_penalty_split": 0.01},
    "coupled": {"cegb_penalty_split": 0.002,
                "cegb_penalty_feature_coupled": [0.0] * 4 + [1e4] * 4},
    "lazy": {"cegb_penalty_feature_lazy": [0.02] * 8},
    "lazy_bagged": {"cegb_penalty_split": 0.002,
                    "cegb_penalty_feature_coupled": [0.5] * 8,
                    "cegb_penalty_feature_lazy": [0.02] * 8,
                    "bagging_fraction": 0.7, "bagging_freq": 1},
}


# ------------------------------------------------------------ split search
def _metas(meta, cat, monotone):
    f = len(meta["num_bin"])
    is_cat = np.zeros(f, bool)
    is_cat[list(cat)] = True
    jmeta = js.FeatureMeta(
        num_bin=jnp.asarray(meta["num_bin"]),
        missing_type=jnp.asarray(meta["missing_type"]),
        default_bin=jnp.asarray(meta["default_bin"]),
        is_categorical=jnp.asarray(is_cat),
        penalty=jnp.asarray(meta["penalty"]),
        monotone=jnp.asarray(monotone, jnp.int32))
    tmeta = ts.FeatureMeta(
        num_bin=torch.as_tensor(meta["num_bin"], dtype=torch.int64),
        missing_type=torch.as_tensor(meta["missing_type"], dtype=torch.int64),
        default_bin=torch.as_tensor(meta["default_bin"], dtype=torch.int64),
        penalty=torch.as_tensor(meta["penalty"]),
        is_categorical=torch.as_tensor(is_cat) if cat else None,
        monotone=torch.as_tensor(monotone, dtype=torch.int64))
    return jmeta, tmeta


def _two_leaves(seed, cat=()):
    """Two leaves' histograms over 8 features, the features of ``cat``
    categorical (their missing type none)."""
    missing = list(MISSING["mixed"])
    for c in cat:
        missing[c] = 0
    cases = [_case(seed + i, missing) for i in range(2)]
    meta = cases[0][2]
    for c in cat:
        meta["num_bin"][c] = max(meta["num_bin"][c], 12)
    return (np.stack([c[0] for c in cases]), np.stack([c[1] for c in cases]),
            meta)


@pytest.mark.parametrize("cat", [(), (2, 5)], ids=["numerical", "categorical"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_best_split_with_constraints_matches_jax(seed, cat):
    hist, tot, meta = _two_leaves(10 * seed, cat)
    r = np.random.RandomState(seed)
    f = hist.shape[1]
    monotone = r.choice([-1, 0, 1], f).astype(np.int64)
    fmask = np.ones(f, bool)
    kw = SPLIT_PARAMS[seed % 2]
    jmeta, tmeta = _metas(meta, cat, monotone)
    sp = ts.SplitParams(**kw, cat_features=tuple(cat), with_monotone=True,
                        min_data_per_group=20, cat_smooth=5.0)
    # bounds that bind: a narrow band around 0 on leaf 0, one-sided on 1
    lo = np.array([-0.05, -np.inf], np.float32)
    hi = np.array([0.04, 0.02], np.float32)
    pen = np.abs(r.randn(2, f)).astype(np.float32) * 0.5
    t = torch.as_tensor(tot)
    ours = ts.find_best_split(
        torch.as_tensor(hist), tmeta, sp, t[:, 0], t[:, 1], t[:, 2],
        torch.as_tensor(fmask), torch.as_tensor(lo), torch.as_tensor(hi),
        torch.as_tensor(pen))
    jparams = js.SplitParams(max_cat_threshold=32, cat_smooth=5.0,
                             cat_l2=10.0, max_cat_to_onehot=4,
                             min_data_per_group=20, **kw)
    for i in range(2):
        ref = js.find_best_split(
            jnp.asarray(hist[i]), jmeta, jparams, jnp.float32(tot[i, 0]),
            jnp.float32(tot[i, 1]), jnp.float32(tot[i, 2]),
            jnp.asarray(fmask), min_constraint=jnp.float32(lo[i]),
            max_constraint=jnp.float32(hi[i]), with_categorical=bool(cat),
            gain_penalty=jnp.asarray(pen[i]))
        assert int(ours.feature[i]) == int(ref.feature)
        assert bool(ours.is_categorical[i]) == bool(ref.is_categorical)
        if not bool(ref.is_categorical):
            assert int(ours.threshold[i]) == int(ref.threshold)
            assert bool(ours.default_left[i]) == bool(ref.default_left)
        np.testing.assert_array_equal(
            ours.cat_bitset[i].numpy().astype(np.uint32),
            np.asarray(ref.cat_bitset))
        for name in ("gain", "left_output", "right_output", "left_sum_grad",
                     "left_sum_hess", "left_count", "right_count"):
            np.testing.assert_allclose(
                float(getattr(ours, name)[i]), float(getattr(ref, name)),
                rtol=1e-5, atol=1e-6, err_msg=name)
        # the outputs keep to the leaf's bounds
        assert lo[i] <= float(ours.left_output[i]) <= hi[i]
        assert lo[i] <= float(ours.right_output[i]) <= hi[i]


def test_no_constraint_is_bit_equal_to_the_plain_search():
    """Unbounded leaves, no monotone feature and no penalty give today's
    numbers bit for bit, as do zero constraints carried on the meta."""
    hist, tot, meta = _two_leaves(7, (2,))
    f = hist.shape[1]
    _, tmeta = _metas(meta, (2,), np.zeros(f, np.int64))
    t = torch.as_tensor(tot)
    args = (torch.as_tensor(hist), tmeta)
    sums = (t[:, 0], t[:, 1], t[:, 2], torch.ones(f, dtype=torch.bool))
    plain = ts.find_best_split(*args, ts.SplitParams(
        **SPLIT_PARAMS[0], cat_features=(2,)), *sums)
    carried = ts.find_best_split(
        *args, ts.SplitParams(**SPLIT_PARAMS[0], cat_features=(2,),
                              with_monotone=True), *sums,
        torch.full((2,), -np.inf), torch.full((2,), np.inf),
        torch.zeros(2, f))
    for a, b in zip(plain, carried):
        assert torch.equal(a, b)


# ------------------------------------------------------------ exact growth
_TRAINED = {}


def _forced_file(tmp_path, tree) -> str:
    path = tmp_path / "forced.json"
    path.write_text(json.dumps(tree))
    return str(path)


def train_both(name, params, data, tmp_path=None, rounds=ROUNDS):
    """(x, JAX booster, port booster) trained on the same data and
    parameters through ``lgb.train``."""
    if name not in _TRAINED:
        x, y, extra = data()
        params = dict(PARAMS, **params)
        jb = jlgb.train(params, jlgb.Dataset(x, label=y, **extra),
                        num_boost_round=rounds)
        tb = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu",
                                             **extra),
                        num_boost_round=rounds, device="cpu")
        _TRAINED[name] = (x, jb, tb)
    return _TRAINED[name]


def _regression():
    x, t = regression_data(ROWS)
    return x[:, :8], t, {}


def _binary():
    x, y = bench_data(ROWS)
    return x[:, :8], y, {}


def _binary_categorical():
    x, y = bench_data(ROWS)
    x = x[:, :8].copy()
    # feature 3 (the target's sin term) as 5 categories in shuffled order
    x[:, 3] = np.array([3, 0, 4, 1, 2])[
        np.digitize(x[:, 3], [-1.0, -0.3, 0.2, 0.9])]
    return x, y, {"categorical_feature": [3]}


def _scores(jb):
    s = np.asarray(jb._impl.scores, np.float64)
    return s[:, 0] if s.shape[1] == 1 else s


def assert_parity(x, jb, tb, identical=True):
    """Every tree under the tie rule (node for node with ``identical``),
    raw predictions within SCORE_TOL of the JAX model's training scores."""
    assert len(tb.models) == len(jb._impl.models) > 0
    for jt, tt in zip(jb._impl.models, tb.models):
        assert_tie_rule(jt, tt)
        if identical:
            nn = jt.num_leaves_actual - 1
            for k in ("split_feature", "threshold_bin", "left_child",
                      "right_child", "split_leaf"):
                np.testing.assert_array_equal(getattr(tt, k)[:nn],
                                              getattr(jt, k)[:nn], err_msg=k)
    np.testing.assert_allclose(tb.predict(x, raw_score=True), _scores(jb),
                               rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("data", ["regression", "categorical"])
def test_monotone_exact_matches_jax(data):
    params = {"objective": "regression" if data == "regression"
              else "binary", "monotone_constraints": MONO}
    make = _regression if data == "regression" else _binary_categorical
    x, jb, tb = train_both("mono_" + data, params, make)
    assert_parity(x, jb, tb)
    if data == "categorical":
        assert any(t.is_categorical[:t.num_leaves_actual - 1].any()
                   for t in tb.models)
    assert monotone_violation(lambda p: tb.predict(p, raw_score=True), x,
                              MONO, 32, 50) <= 1e-6
    # the constraints bind: without them the trees differ
    free = tlgb.train(dict(PARAMS, objective=params["objective"]),
                      tlgb.Dataset(x, label=make()[1], device="cpu",
                                   **make()[2]),
                      num_boost_round=ROUNDS, device="cpu")
    assert any(not np.array_equal(a.split_feature, b.split_feature)
               or not np.array_equal(a.threshold_bin, b.threshold_bin)
               for a, b in zip(free.models, tb.models))
    assert monotone_violation(lambda p: free.predict(p, raw_score=True), x,
                              MONO, 32, 50) > 1e-3


def test_forced_splits_exact_match_jax(tmp_path):
    params = {"objective": "binary",
              "forcedsplits_filename": _forced_file(tmp_path,
                                                    FORCED_SPLITS)}
    x, jb, tb = train_both("forced", params, _binary)
    assert_parity(x, jb, tb)
    got, want = forced_nodes(tb.models, tb._impl.train_data)
    assert got == [want] * ROUNDS
    assert forced_nodes(jb._impl.models, jb._impl.train_data)[0] == got


def test_forced_split_with_an_empty_side_ends_the_forced_phase(tmp_path):
    """Step 1's left side is empty (threshold below every value): it and
    the steps after it grow best-first, as in the JAX package."""
    tree = {"feature": 0, "threshold": 0.0,
            "left": {"feature": 1, "threshold": -1e9},
            "right": {"feature": 2, "threshold": 0.0}}
    params = {"objective": "binary",
              "forcedsplits_filename": _forced_file(tmp_path, tree)}
    x, jb, tb = train_both("forced_abort", params, _binary)
    assert_parity(x, jb, tb)
    for t in tb.models:
        assert int(t.split_feature[0]) == 0
        # step 2 would have split leaf 1 on feature 2; best-first did not
        assert (int(t.split_leaf[2]), int(t.split_feature[2])) != (1, 2)


def test_forced_split_on_a_bundled_feature_matches_jax(tmp_path):
    """A forced split on a one-hot column stored in an EFB bundle: the
    leaf's feature view comes from ``expand_hist``, routing decodes the
    bundle."""
    def data():
        x, y = bundled_data(ROWS)
        return x[:, :60], y, {}
    feature = 40                       # in the first one-hot block
    tree = {"feature": feature, "threshold": 0.5,
            "right": {"feature": 0, "threshold": 0.0}}
    params = {"objective": "binary", "min_data_in_leaf": 40,
              "forcedsplits_filename": _forced_file(tmp_path, tree)}
    x, jb, tb = train_both("forced_bundled", params, data)
    ds = tb._impl.train_data
    assert ds.has_bundles
    assert ds.feature_layout()[2][ds.inner_feature_index(feature)]
    assert_parity(x, jb, tb)
    for t in tb.models:
        assert (int(t.split_feature[0]), int(t.split_leaf[1]),
                int(t.split_feature[1])) == (feature, 1, 0)


def _cegb_state(impl, jax_impl):
    ours = impl._cegb.state
    ref = jax_impl._cegb_state
    np.testing.assert_array_equal(ours.feature_used.numpy(),
                                  np.asarray(ref.feature_used))
    np.testing.assert_array_equal(ours.row_used.numpy(),
                                  np.asarray(ref.row_used))
    np.testing.assert_array_equal(ours.coupled_penalty.numpy(),
                                  np.asarray(ref.coupled_penalty))
    np.testing.assert_array_equal(ours.lazy_penalty.numpy(),
                                  np.asarray(ref.lazy_penalty))


@pytest.mark.parametrize("kind", sorted(CEGB))
def test_cegb_exact_matches_jax(kind):
    params = dict(CEGB[kind], objective="binary")
    x, jb, tb = train_both("cegb_" + kind, params, _binary, rounds=3)
    assert_parity(x, jb, tb)
    _cegb_state(tb._impl, jb._impl)
    assert tb._impl._cegb.state.feature_used.any()
    if kind == "coupled":
        # the dear features are never bought
        assert not tb._impl._cegb.state.feature_used[4:].any()
    if "lazy" in kind:
        assert tb._impl._cegb.state.row_used.shape == (8, ROWS)
        assert tb._impl._cegb.state.row_used.any()
    # the penalty shrinks the trees or the gains: a split's recorded gain
    # is its penalised gain
    free = tlgb.train(dict(PARAMS, objective="binary",
                           **{k: v for k, v in CEGB[kind].items()
                              if k.startswith("bagging")}),
                      tlgb.Dataset(x, label=_binary()[1], device="cpu"),
                      num_boost_round=3, device="cpu")
    assert sum(t.split_gain[:t.num_leaves_actual - 1].sum()
               for t in tb.models) < sum(
        t.split_gain[:t.num_leaves_actual - 1].sum() for t in free.models)


def test_cegb_multiclass_merges_the_class_states():
    """Three classes grow from the iteration's state; their purchases
    merge (any, max) for the next iteration, as in the JAX package."""
    def data():
        x, y = multiclass_data(ROWS, num_class=3)
        return x[:, :8], y, {}
    params = dict(CEGB["lazy_bagged"], objective="multiclass", num_class=3,
                  min_data_in_leaf=40)
    x, jb, tb = train_both("cegb_multiclass", params, data, rounds=3)
    assert_parity(x, jb, tb)
    _cegb_state(tb._impl, jb._impl)


# ------------------------------------------------------------ refusals
def _refusal(params, x, y, **ds):
    """The errors of both packages' ``train`` on ``params``."""
    params = dict(PARAMS, objective="binary", **params)
    errors = []
    for lgb, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        with pytest.raises(Exception) as info:
            lgb.train(params, lgb.Dataset(x, label=y, **ds, **kw),
                      num_boost_round=1, **kw)
        errors.append(info.value)
    return errors


REFUSED = {
    "forced_categorical": ({"forced": {"feature": 3, "threshold": 1.0}},
                           "forced splits on categorical features"),
    "forced_frontier": ({"forced": FORCED_SPLITS,
                         "tree_growth": "frontier"},
                        "requires exact split ordering"),
    "forced_batched": ({"forced": FORCED_SPLITS, "tree_growth": "batched"},
                       "requires exact split ordering"),
    "cegb_frontier": ({"cegb_penalty_split": 0.1,
                       "tree_growth": "frontier"},
                      "requires exact split ordering"),
    "cegb_batched_part": ({"cegb_penalty_feature_lazy": [1.0] * 8,
                           "tree_growth": "batched",
                           "tpu_batched_part": "true"},
                          "requires exact split ordering"),
    "monotone_length": ({"monotone_constraints": [1, -1]},
                        "monotone_constraints has 2 entries but the "
                        "dataset has 8 features"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_match_jax(case, tmp_path):
    params, message = REFUSED[case]
    params = dict(params)
    if "forced" in params:
        params["forcedsplits_filename"] = _forced_file(
            tmp_path, params.pop("forced"))
    x, y, ds = (_binary_categorical if case == "forced_categorical"
                else _binary)()
    jerr, terr = _refusal(params, x, y, **ds)
    assert type(terr) is LightGBMError
    assert type(jerr).__name__ == "LightGBMError"
    assert message in str(terr)
    assert str(terr) == str(jerr)


# ------------------------------------------------------------ model text
def test_model_text_writes_the_options_and_reloads(tmp_path):
    params = dict(PARAMS, objective="binary", monotone_constraints=MONO,
                  forcedsplits_filename=_forced_file(tmp_path,
                                                     FORCED_SPLITS),
                  cegb_penalty_split=0.002,
                  cegb_penalty_feature_coupled=[0.5] * 8,
                  cegb_penalty_feature_lazy=[0.02] * 8)
    x, y, _ = _binary()
    jb = jlgb.train(params, jlgb.Dataset(x, label=y), num_boost_round=2)
    tb = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                    num_boost_round=2, device="cpu")
    block = tb.model_to_string().split("\nparameters:\n")[1]
    assert block == jb.model_to_string().split("\nparameters:\n")[1]
    for key in ("monotone_constraints=1,-1,0", "forcedsplits_filename=",
                "cegb_penalty_split=0.002",
                "cegb_penalty_feature_coupled=0.5",
                "cegb_penalty_feature_lazy=0.02"):
        assert key in block
    loaded = tlgb.Booster(model_str=tb.model_to_string(), device="cpu")
    np.testing.assert_allclose(loaded.predict(x, raw_score=True),
                               tb.predict(x, raw_score=True), rtol=0,
                               atol=1e-6)
    got, want = forced_nodes(tb.models, tb._impl.train_data)
    assert got == [want] * 2 and len(want) == len(FORCED_STEPS)


@pytest.mark.parametrize("growth", ["exact", "frontier"])
def test_phase5_monotone_rule_holds_summation_orders_and_fails_a_fault(
        growth, monkeypatch):
    """chip_smoke.py phase 5 holds its monotone rows with ``trees_match``
    under CLAMP_PARTING, matching nodes by the rows they split
    (``parting_tie``). Binary on bench.py's data under
    MONOTONE_CONSTRAINTS, 2 rounds: a forest matches itself; float32
    against float64 histogram sums (the kernel path against phase 5's
    plain path) hold the rule; and a float32 run whose histograms drop
    every 64th row of what they sum (a kernel that loses rows) fails it."""
    import chip_smoke
    from lightgbm_tpu_torch.core import histogram
    x, y = bench_data(ROWS)
    rows = torch.as_tensor(x, dtype=torch.float64)
    params = dict(PARAMS, objective="binary",
                  monotone_constraints=chip_smoke.MONOTONE_CONSTRAINTS,
                  **chip_smoke.GROWTH_PARAMS[growth])
    ds = tlgb.Dataset(x, label=y, params=params, device="cpu").construct()

    def forest(f64_sums):
        bst = tlgb.Booster(params=params, train_set=ds, device="cpu")
        bst._impl.grow_params = bst._impl.grow_params._replace(
            plain_f64_sums=f64_sums)
        for _ in range(2):
            bst.update()
        return bst.models

    limits = chip_smoke.tie_limits(params, False)
    assert limits[0] == chip_smoke.CLAMP_PARTING
    f32, f64 = forest(False), forest(True)
    assert chip_smoke.trees_match(f32, f32, [], *limits, rows)
    chip_smoke.trees_match(f32, f64, [], *limits, rows)
    sums = histogram._sums

    def dropping_sums(vals, f64_sums):
        vals = vals.clone()
        vals[::64] = 0
        return sums(vals, f64_sums)

    monkeypatch.setattr(histogram, "_sums", dropping_sums)
    faulty = forest(False)
    with pytest.raises(AssertionError, match="tie rule"):
        chip_smoke.trees_match(faulty, f64, [], *limits, rows)
