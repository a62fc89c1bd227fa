"""EFB bundles and packed small-feature pairs, in the port and in the JAX
package.

Both options are on by default (``enable_bundle``, ``enable_nbit_packing``).
Every case holds the port against the JAX package (JAX on the CPU) on the
same numpy data:

- the stored layout: ``col_features``, ``col_offsets``, ``col_num_bin``,
  ``col_packed``, the uint8 matrix byte for byte and ``feature_layout``,
  for bundles, pairs, both, a validation set built with ``reference=`` and
  data where pairing would widen the histogram;
- ``expand_hist`` on random column histograms and totals (1e-6 relative)
  and ``decode_bundle_value`` on every stored value, exactly;
- training under every grower on chip_smoke.py's bundled workload shrunk
  to 4,000 rows and 3 one-hot blocks of 8 (``chip_smoke.bundled_data``),
  binary and L2: trees under tests/test_torch_regression.py's f32 tie
  rule, raw predictions within 1e-5;
- the layout changes nothing in the port (bundling and packing on against
  off), valid sets replay the stored layout, and a bundled model's text is
  the JAX package's.
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from chip_smoke import bundled_data
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.core import grow as jgrow
from lightgbm_tpu.io.dataset import BinnedDataset as JBinned
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.core import grow as tgrow
from lightgbm_tpu_torch.io.dataset import BinnedDataset as TBinned

from test_torch_regression import assert_tie_rule

# leaves of at least 40 rows: in tree 0 of a binary model every row has one
# hessian and one of two gradients, so two features that cut a small leaf
# into the same label counts tie exactly, either package may take either,
# and the trees after such a tie differ (on this data's unbundled layout
# as much as on its stored one)
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


def small_bundled(n=4000, seed=0):
    """chip_smoke.py's bundled workload at test size: 28 HIGGS-shaped
    columns (four b-tags) and 3 one-hot blocks of 8."""
    return bundled_data(n, seed, groups=3, width=8)


def regression_target(x, y):
    return y + 0.5 * x[:, 1] + 0.25 * (x[:, 12] > 1) + x[:, 29]


def exclusive_groups(n=1500, groups=4, per_group=6, seed=3):
    """Sparse blocks, at most one feature of a block non-zero per row:
    bundles and nothing to pair."""
    r = np.random.RandomState(seed)
    x = np.zeros((n, groups * per_group))
    for g in range(groups):
        which = r.randint(0, per_group + 3, n)
        vals = r.randint(1, 40, n).astype(np.float64)
        for k in range(per_group):
            x[which == k, g * per_group + k] = vals[which == k]
    y = (x[:, 0] + x[:, per_group] - x[:, 2 * per_group]
         + 3 * r.randn(n) > 2).astype(np.float32)
    return x, y


def mixed_small(n=3000, seed=0):
    """tests/test_nbit_packing.py's data: 2 wide and 6 small features, so
    three pairs form."""
    r = np.random.RandomState(seed)
    x = np.concatenate([r.randn(n, 2),
                        r.randint(0, 10, size=(n, 6)).astype(np.float64)],
                       axis=1).astype(np.float32)
    y = ((x[:, 0] + (x[:, 2] > 5) + (x[:, 3] < 3) * 0.5 + 0.3 * x[:, 1])
         > 1).astype(np.float32)
    return x, y


def all_small(n=2000, seed=1):
    """tests/test_nbit_packing.py:49: every feature small, so a pair would
    be wider than any column and none forms."""
    r = np.random.RandomState(seed)
    x = r.randint(0, 10, size=(n, 6)).astype(np.float32)
    return x, ((x[:, 0] > 5) | (x[:, 1] < 3)).astype(np.float32)


LAYOUT_DATA = {"bundles": exclusive_groups, "pairs": mixed_small,
               "mixed": small_bundled, "widen": all_small}


def assert_same_layout(t, j):
    assert t.col_features == j.col_features
    assert t.col_offsets == j.col_offsets
    assert t.col_num_bin == j.col_num_bin
    assert t.col_packed == j.col_packed
    assert t.X_binned.dtype == j.X_binned.dtype == np.uint8
    assert t.X_binned.tobytes() == j.X_binned.tobytes()
    for name, a, b in zip(("col", "offset", "bundled", "pack_div", "pack_mod",
                           "pack_partner"), t.feature_layout(),
                          j.feature_layout()):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (t.num_columns, t.max_col_bins(), t.has_bundles, t.has_packed) \
        == (j.num_columns, j.max_col_bins(), j.has_bundles, j.has_packed)


@pytest.mark.parametrize("kind", sorted(LAYOUT_DATA))
def test_layout_matches_jax(kind):
    x, y = LAYOUT_DATA[kind]()
    params = {"objective": "binary", "verbosity": -1}
    t = TBinned.from_matrix(x, TConfig(params), label=y)
    j = JBinned.from_matrix(x, JConfig(params), label=y)
    assert_same_layout(t, j)
    expect = {"bundles": (True, False), "pairs": (False, True),
              "mixed": (True, True), "widen": (False, False)}[kind]
    assert (t.has_bundles, t.has_packed) == expect
    if kind == "mixed":
        # 24 dense singletons, 3 bundles of 8 one-hot features, 2 b-tag pairs
        assert t.num_columns == 29 and t.max_col_bins() == 255


def test_valid_layout_reuses_the_training_layout():
    x, y = small_bundled()
    xv, yv = small_bundled(1500, seed=1)
    params = {"objective": "binary", "verbosity": -1}
    t = TBinned.from_matrix(x, TConfig(params), label=y)
    j = JBinned.from_matrix(x, JConfig(params), label=y)
    tv = TBinned.from_matrix(xv, TConfig(params), label=yv, reference=t)
    jv = JBinned.from_matrix(xv, JConfig(params), label=yv, reference=j)
    assert_same_layout(tv, jv)
    assert tv.col_features is t.col_features


def _layout_pair(x, y):
    """Port and JAX boosters built (not trained) on the same data: their
    feature metadata and growth parameters."""
    params = {"objective": "binary", "verbosity": -1}
    tb = tlgb.Booster(params, tlgb.Dataset(x, label=y, device="cpu"),
                      device="cpu")
    jb = jlgb.Booster(params, jlgb.Dataset(x, label=y))
    return tb._impl, jb._impl


@pytest.mark.parametrize("kind", ["mixed", "pairs", "bundles"])
def test_expand_hist_matches_jax(kind):
    x, y = LAYOUT_DATA[kind]()
    timpl, jimpl = _layout_pair(x, y)
    tp, jp = timpl.grow_params, jimpl.grow_params
    assert tp.with_efb and jp.with_efb
    assert (tp.num_bins, tp.num_feat_bins, tp.pack_j, tp.packed_features) \
        == (jp.num_bins, jp.num_feat_bins, jp.pack_j, jp.packed_features)
    c = timpl.xb.shape[1]
    r = np.random.RandomState(5)
    hist = r.randn(3, c, tp.num_bins, 3).astype(np.float32)
    hist[..., 2] = np.abs(hist[..., 2]) * 10
    totals = (r.randn(3, 3) * 20).astype(np.float32)
    got = tgrow.expand_hist(torch.as_tensor(hist),
                            *[torch.as_tensor(totals[:, k]) for k in range(3)],
                            timpl.feature_meta, tp).numpy()
    for s in range(3):
        want = np.asarray(jgrow.expand_hist(
            jnp.asarray(hist[s]), *[jnp.asarray(totals[s, k])
                                    for k in range(3)],
            jimpl.feature_meta, jp, c))
        assert got[s].shape == want.shape
        np.testing.assert_allclose(got[s], want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("kind", ["mixed", "pairs", "bundles"])
def test_decode_matches_jax_on_every_stored_value(kind):
    x, y = LAYOUT_DATA[kind]()
    timpl, jimpl = _layout_pair(x, y)
    tm, jm = timpl.feature_meta, jimpl.feature_meta
    f = tm.num_bin.shape[0]
    v = np.arange(256)
    for i in range(f):
        got = tgrow.decode_bundle_value(
            torch.as_tensor(v, dtype=torch.uint8), tm.offset[i],
            tm.num_bin[i], tm.default_bin[i], tm.pack_div[i],
            tm.pack_mod[i]).numpy()
        want = np.asarray(jgrow.decode_bundle_value(
            jnp.asarray(v, jnp.uint8), jm.offset[i], jm.num_bin[i],
            jm.default_bin[i], pack_div=jm.pack_div[i],
            pack_mod=jm.pack_mod[i]))
        np.testing.assert_array_equal(got, want, err_msg="feature %d" % i)


_TRAINED = {}


def _train_both(growth, objective):
    """(x, JAX booster, port booster) on the small bundled data, trained
    once per module."""
    key = (growth, objective)
    if key not in _TRAINED:
        x, y = small_bundled()
        if objective == "regression":
            y = regression_target(x, y)
        params = dict(PARAMS, objective=objective, **GROWTHS[growth])
        jb = jlgb.train(params, jlgb.Dataset(x, label=y),
                        num_boost_round=ROUNDS)
        tb = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                        num_boost_round=ROUNDS, device="cpu")
        _TRAINED[key] = (x, jb, tb)
    return _TRAINED[key]


def _layout_splits(bst):
    ds = bst._impl.train_data
    in_bundle, in_pair = set(), set()
    for feats, packed in zip(ds.col_features, ds.col_packed):
        if len(feats) > 1:
            (in_pair if packed else in_bundle).update(feats)
    feats = collections.Counter(
        int(f) for t in bst.models
        for f in t.split_feature[:t.num_leaves_actual - 1])
    return (sum(v for f, v in feats.items() if f in in_bundle),
            sum(v for f, v in feats.items() if f in in_pair))


@pytest.mark.parametrize("objective", ["binary", "regression"])
@pytest.mark.parametrize("growth", sorted(GROWTHS))
def test_trees_match_jax(growth, objective):
    x, jb, tb = _train_both(growth, objective)
    assert tb._impl.grow_params.with_efb
    assert len(tb.models) == len(jb._impl.models) == ROUNDS
    for jt, tt in zip(jb._impl.models, tb.models):
        assert_tie_rule(jt, tt)
        nn = jt.num_leaves_actual - 1
        np.testing.assert_allclose(tt.split_gain[:nn].sum(),
                                   jt.split_gain[:nn].sum(), rtol=1e-3)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=0,
                               atol=1e-5)
    bundled, _ = _layout_splits(tb)
    assert bundled > 0


def test_trees_split_on_packed_features():
    """The b-tag pairs are on the path the trees take: some split of the
    exact and batched binary runs falls on a packed feature."""
    packed = sum(_layout_splits(_train_both(g, "binary")[2])[1]
                 for g in ("exact", "batched"))
    assert packed > 0


@pytest.mark.parametrize("growth", sorted(GROWTHS))
def test_layout_changes_nothing_in_the_port(growth):
    """Bundling and packing on against off, the port alone: predictions
    within rtol 1e-4 and atol 1e-5 (tests/test_efb.py:74-95). The "on"
    booster is the one ``_train_both`` trained with the same parameters
    (enable_bundle and enable_nbit_packing are on by default)."""
    x, _, on = _train_both(growth, "binary")
    y = small_bundled()[1]
    assert on._impl.config.enable_bundle and on._impl.config.enable_nbit_packing
    params = dict(PARAMS, objective="binary", **GROWTHS[growth])
    out = []
    for bst in (on, None):
        if bst is None:
            bst = tlgb.train(dict(params, enable_bundle=False,
                                  enable_nbit_packing=False),
                             tlgb.Dataset(x, label=y, device="cpu"),
                             num_boost_round=ROUNDS, device="cpu")
        assert bst._impl.grow_params.with_efb == (bst is on)
        out.append(bst.predict(x, raw_score=True))
    np.testing.assert_allclose(out[0], out[1], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("growth", ["exact", "batched_part"])
def test_valid_scores_replay_the_stored_layout(growth):
    """A bundled validation set: its device scores are the model's raw
    predictions, and its metric is the JAX package's."""
    x, y = small_bundled()
    xv, yv = small_bundled(1500, seed=1)
    params = dict(PARAMS, objective="binary", metric="binary_logloss",
                  **GROWTHS[growth])
    jev, tev = {}, {}
    jtr = jlgb.Dataset(x, label=y, free_raw_data=False)
    jb = jlgb.train(params, jtr, num_boost_round=ROUNDS,
                    valid_sets=[jtr.create_valid(xv, label=yv)],
                    evals_result=jev, verbose_eval=False)
    ttr = tlgb.Dataset(x, label=y, device="cpu")
    tb = tlgb.train(params, ttr, num_boost_round=ROUNDS,
                    valid_sets=[ttr.create_valid(xv, label=yv)],
                    evals_result=tev, verbose_eval=False, device="cpu")
    assert tb._impl.grow_params.with_efb
    np.testing.assert_allclose(tb._impl.scores_of(1),
                               tb.predict(xv, raw_score=True), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tev["valid_0"]["binary_logloss"],
                               jev["valid_0"]["binary_logloss"], rtol=0,
                               atol=1e-5)


# model-text keys whose values are f32 sums: the same up to summation order
# in the two packages (a gain is a difference of such sums)
SUMMED_KEYS = ("split_gain", "leaf_value", "internal_value", "leaf_weight",
               "internal_weight")


def test_model_text_matches_jax():
    """A bundled model's text is the JAX package's: every line equal, the
    f32 sums within 1e-4 relative (``tree_sizes`` counts their
    characters), feature importances in real feature indices; the text
    reloads in the port with the same predictions."""
    x, jb, tb = _train_both("exact", "binary")
    ours, ref = tb.model_to_string(), jb.model_to_string()
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
    np.testing.assert_array_equal(tb.feature_importance("split"),
                                  jb.feature_importance("split"))
    loaded = tlgb.Booster(model_str=ours, device="cpu")
    np.testing.assert_allclose(loaded.predict(x, raw_score=True),
                               tb.predict(x, raw_score=True), rtol=0,
                               atol=1e-6)


def test_rollback_and_init_model_replay_the_stored_layout():
    """The binned replay of a tree over bundled and packed columns serves
    rollback (the training scores) and continued training (the merged
    trees' valid scores): each stays the model's raw prediction."""
    x, y = small_bundled()
    xv, yv = small_bundled(1500, seed=1)
    params = dict(PARAMS, objective="binary")
    ttr = tlgb.Dataset(x, label=y, device="cpu")
    bst = tlgb.Booster(params, ttr, device="cpu")
    for _ in range(3):
        bst.update()
    bst.rollback_one_iter()
    assert bst.num_trees() == 2
    np.testing.assert_allclose(bst._impl.scores_of(0),
                               bst.predict(x, raw_score=True), rtol=0,
                               atol=1e-5)
    more = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                      num_boost_round=2, init_model=bst,
                      valid_sets=[ttr.create_valid(xv, label=yv)],
                      verbose_eval=False, device="cpu")
    assert more.num_trees() == 4 and more._impl.grow_params.with_efb
    np.testing.assert_allclose(more._impl.scores_of(1),
                               more.predict(xv, raw_score=True), rtol=0,
                               atol=1e-5)
