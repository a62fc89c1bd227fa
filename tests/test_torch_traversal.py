"""The serving traversal (ROADMAP Queue 1 #10) in the port and in the JAX
package: ``pack_flat_forest`` and ``forest_scores_flat``.

Every model is trained once per module by the port (binary on bench.py's
features, with missing values, with categorical id columns, on bundled
sparse columns, three classes; 2,000-3,000 rows, 15 leaves, 8 rounds) and
loaded by both packages from the port's model text, so both serve the
same trees:

- structure: the two packs of one model text are equal array for array
  (features, children, default-left, missing types, bitsets, leaves, the
  int16 leaves and scales, the depth); the port's float64 thresholds cast
  to float32 are the JAX package's;
- scores: the port's traversal is its own ``predict(raw_score=True)`` bit
  for bit, and within 1e-6 of the JAX package's traversal, except at a
  row that some tree sends the other way when its value and threshold
  are compared in float32 (the JAX package casts requests and thresholds
  to float32; the port compares in float64, as training bins);
- the cascade at margin inf is the full model and at margin 0 the first
  iterations, the quantized leaves are the JAX package's, a chain tree
  (a root whose left child is a leaf) is traversed to its full depth, and
  the traversal and replay backends of the engine give equal outputs.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from chip_smoke import CATEGORICAL_FEATURES, bench_data, categorical_data
from conftest import make_multiclass
from lightgbm_tpu.serving import traversal as jtv
from lightgbm_tpu_torch.serving import ServingEngine
from lightgbm_tpu_torch.serving import traversal as ttv

CPU = torch.device("cpu")
ROUNDS = 8
PARAMS = {"num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 40,
          "verbosity": -1}
KINDS = ["dense", "missing", "categorical", "efb", "multiclass"]
_TRAINED = {}


def _data(kind):
    if kind == "multiclass":
        return make_multiclass(n=2000, f=10, k=3, seed=13)
    if kind == "categorical":
        return categorical_data(3000)
    if kind == "efb":
        # mutually exclusive sparse columns (EFB bundles them) beside two
        # dense ones
        r = np.random.RandomState(11)
        x = np.zeros((3000, 14))
        x[:, :2] = r.randn(3000, 2)
        x[np.arange(3000), 2 + r.randint(0, 12, 3000)] = r.rand(3000) + 1
        y = x[:, 0] + x[:, 2:8].sum(axis=1) - x[:, 8:].sum(axis=1)
        return x, (y + 0.3 * r.randn(3000) > 0).astype(float)
    x, y = bench_data(3000)
    if kind == "missing":
        x = x.copy()
        x[np.random.RandomState(3).rand(*x.shape) < 0.15] = np.nan
    return x, y


def _trained(kind):
    """(rows, the port's booster, its model text), trained once."""
    if kind not in _TRAINED:
        x, y = _data(kind)
        params = dict(PARAMS, objective="binary")
        if kind == "multiclass":
            params.update(objective="multiclass", num_class=3)
        cat = CATEGORICAL_FEATURES if kind == "categorical" else "auto"
        bst = tlgb.train(params, tlgb.Dataset(
            x, label=y, categorical_feature=cat, device="cpu"),
            num_boost_round=ROUNDS, device="cpu")
        if kind == "efb":
            assert bst._impl.train_data.has_bundles
        _TRAINED[kind] = (x, bst, bst.model_to_string())
    return _TRAINED[kind]


def _loaded(text):
    """The trees of ``text`` as each package loads them."""
    return (tlgb.Booster(model_str=text, device="cpu").models,
            jlgb.Booster(model_str=text)._impl.models)


def _port_scores(models, x, k, **kw):
    host, depth = ttv.pack_flat_forest(models, quantize=kw.pop(
        "quantize", False))
    return ttv.forest_scores_flat(ttv.to_device(host, CPU),
                                  torch.as_tensor(x), k, depth,
                                  **kw).numpy()


def _jax_scores(models, x, k, **kw):
    import jax
    import jax.numpy as jnp
    host, depth = jtv.pack_flat_forest(models, quantize=kw.pop(
        "quantize", False))
    return np.asarray(jtv.forest_scores_flat(
        jax.tree.map(jnp.asarray, host),
        jnp.asarray(np.asarray(x, np.float32)), k, depth, **kw))


def f32_flips(models, x) -> np.ndarray:
    """[N] whether some numerical node of ``models`` decides a row of ``x``
    otherwise when value and threshold are compared in float32."""
    out = np.zeros(len(x), bool)
    for t in models:
        nn = t.num_leaves_actual - 1
        num = ~np.asarray(t.is_categorical[:nn], bool)
        v = x[:, t.split_feature[:nn][num]]
        thr = t.threshold[:nn][num]
        with np.errstate(invalid="ignore"):
            out |= ((v.astype(np.float32) <= thr.astype(np.float32))
                    != (v <= thr)).any(axis=1)
    return out


def assert_jax_close(got, want, flips, atol=1e-6):
    """``got`` within ``atol`` of ``want`` at every row that no tree
    decides otherwise in float32."""
    got = np.asarray(got, np.float64).reshape(len(flips), -1)
    want = np.asarray(want, np.float64).reshape(len(flips), -1)
    np.testing.assert_allclose(got[~flips], want[~flips], rtol=0, atol=atol)


@pytest.mark.parametrize("kind", ["dense", "categorical", "multiclass"])
def test_pack_matches_jax(kind):
    _, _, text = _trained(kind)
    tm, jm = _loaded(text)
    for quantize in (False, True):
        (tp, tdepth), (jp, jdepth) = (ttv.pack_flat_forest(tm, quantize),
                                      jtv.pack_flat_forest(jm, quantize))
        assert tdepth == jdepth
        for field in tp._fields:
            a, b = getattr(tp, field), getattr(jp, field)
            assert a.shape == b.shape, field
            if field == "threshold":
                assert a.dtype == np.float64
                np.testing.assert_array_equal(a.astype(np.float32), b)
            else:
                np.testing.assert_array_equal(a, b, err_msg=field)
                assert a.dtype == b.dtype, field
    if kind == "categorical":
        assert tp.is_categorical.any()


@pytest.mark.parametrize("kind", KINDS)
def test_scores_are_predict_and_match_jax(kind):
    x, bst, text = _trained(kind)
    k = bst.num_model_per_iteration()
    tm, jm = _loaded(text)
    got = _port_scores(tm, x, k)
    assert got.dtype == np.float32 and got.shape == (len(x), k)
    np.testing.assert_array_equal(
        got.astype(np.float64), bst.predict(x, raw_score=True).reshape(
            len(x), k))
    np.testing.assert_array_equal(got, _port_scores(bst.models, x, k))
    assert_jax_close(got, _jax_scores(jm, x, k), f32_flips(tm, x))


def test_num_iteration_truncation_matches_jax():
    x, bst, text = _trained("multiclass")
    tm, jm = _loaded(text)
    for iters in (1, 3, ROUNDS):
        got = _port_scores(tm[:3 * iters], x, 3)
        np.testing.assert_array_equal(
            got.astype(np.float64),
            bst.predict(x, raw_score=True, num_iteration=iters))
        assert_jax_close(got, _jax_scores(jm[:3 * iters], x, 3),
                         f32_flips(tm[:3 * iters], x))


CHAIN_TREE = """tree
version=v2
num_class=1
num_tree_per_iteration=1
label_index=0
max_feature_idx=3
objective=binary sigmoid:1
feature_names=f0 f1 f2 f3
feature_infos=[-3:3] [-3:3] [-3:3] [-3:3]
tree_sizes=1

Tree=0
num_leaves=5
num_cat=0
split_feature=0 1 2 3
split_gain=1 1 1 1
threshold=0 0.5 -0.5 0.25
decision_type=2 2 2 2
left_child=-1 -2 -3 -4
right_child=1 2 3 -5
leaf_value=0.1 0.2 0.30000000000000004 0.4 0.5
leaf_count=1 1 1 1 1
internal_value=0 0 0 0
internal_count=5 4 3 2
shrinkage=1


end of trees
"""


def test_chain_tree_gets_full_depth():
    """The root's left child a leaf and the spine hanging off its right
    child: the depth counts the spine (``_tree_depth``'s chain case), and
    every leaf is reached, as in the JAX package."""
    left = np.array([-1, -2, -3, -4], np.int32)
    right = np.array([1, 2, 3, -5], np.int32)
    assert ttv._tree_depth(left, right) == jtv._tree_depth(left, right) == 4
    assert ttv._tree_depth(np.array([-1], np.int32),
                           np.array([-2], np.int32)) == 1
    tm, jm = _loaded(CHAIN_TREE)
    assert ttv.pack_flat_forest(tm)[1] == 4
    x = np.random.RandomState(5).randn(400, 4)
    got = _port_scores(tm, x, 1)
    np.testing.assert_array_equal(np.unique(got[:, 0]),
                                  np.float32([0.1, 0.2, 0.3, 0.4, 0.5]))
    np.testing.assert_array_equal(
        got[:, 0].astype(np.float64),
        tlgb.Booster(model_str=CHAIN_TREE, device="cpu").predict(
            x, raw_score=True))
    assert_jax_close(got, _jax_scores(jm, x, 1), f32_flips(tm, x))


@pytest.mark.parametrize("kind", ["dense", "multiclass"])
def test_cascade_matches_jax(kind):
    x, bst, text = _trained(kind)
    k = bst.num_model_per_iteration()
    tm, jm = _loaded(text)
    flips = f32_flips(tm, x)
    full = _port_scores(tm, x, k)
    first = bst.predict(x, raw_score=True, num_iteration=3).reshape(
        len(x), k).astype(np.float32)
    if k > 1:
        top2 = -np.sort(-first, axis=1)[:, :2]
        first_margin = top2[:, 0] - top2[:, 1]
    else:
        first_margin = 2 * np.abs(first[:, 0])
    # inf: every row uncertain; 0: none; the median: half of them
    for margin in (float("inf"), 0.0, float(np.median(first_margin))):
        got = _port_scores(tm, x, k, cascade_trees=3, cascade_margin=margin)
        sure = first_margin >= np.float32(margin)
        if margin == float("inf"):
            assert not sure.any()
        elif margin == 0.0:
            assert sure.all()
        else:
            assert 0 < sure.sum() < len(x)
        # each row is its stage-1 score when confident, else the full one
        np.testing.assert_array_equal(got, np.where(sure[:, None], first,
                                                    full))
        want = _jax_scores(jm, x, k, cascade_trees=3, cascade_margin=margin)
        assert_jax_close(got, want, flips)


def test_quantized_leaves_match_jax():
    x, bst, text = _trained("dense")
    tm, jm = _loaded(text)
    got = _port_scores(tm, x, 1, quantize=True)
    full = _port_scores(tm, x, 1)
    assert np.abs(got - full).max() <= 1e-4 * np.abs(full).max()
    assert not np.array_equal(got, full)
    assert_jax_close(got, _jax_scores(jm, x, 1, quantize=True),
                     f32_flips(tm, x))


def test_leaf_ids_are_pred_leaf():
    x, bst, _ = _trained("categorical")
    host, depth = ttv.pack_flat_forest(bst.models)
    ids = ttv.forest_leaf_ids(ttv.to_device(host, CPU), torch.as_tensor(x),
                              depth).numpy()
    np.testing.assert_array_equal(ids, bst.predict(x, pred_leaf=True))


@pytest.mark.parametrize("raw", [False, True])
def test_engine_backends_agree(raw):
    x, bst, _ = _trained("categorical")
    xq = x[:77]
    outs = {}
    for backend in ("traversal", "replay"):
        eng = ServingEngine(max_batch=64, min_bucket=16, backend=backend,
                            device="cpu")
        eng.registry.register(bst.as_serving_bundle("m"))
        outs[backend] = eng.predict("m", xq, raw_score=raw)
        assert eng._cache and all(e.backend == backend
                                  for e in eng._cache.values())
    np.testing.assert_array_equal(outs["traversal"], outs["replay"])
    np.testing.assert_array_equal(outs["traversal"],
                                  bst.predict(xq, raw_score=raw))
