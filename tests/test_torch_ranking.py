"""Ranking (query groups, lambdarank) and the cross-entropy objectives in
the port and in the JAX package.

- ``Metadata`` query boundaries, ``num_queries`` and the lazy query weights
  (the mean of a query's doc weights, reset by ``set_weight``) equal the
  JAX package's; a group that does not sum to the rows raises in both.
- Lambdarank gradients and hessians against
  ``LambdarankNDCG.get_gradients`` on the same float32 scores: each
  element within 1e-6 of its query's sum of |g| (or |h|). The JAX package
  sums a query's pairs over its padded width, the port over its chunk's,
  so the float32 sums associate differently; measured 2e-8 to 1e-7. Cases:
  random, all-equal and leaf-tied scores, weights, ``label_gain`` and
  ``max_position``, single-doc queries and a query whose labels are all 0.
  The chunked layout (``query_chunks``) against one padded chunk, to the
  same bound.
- ``xentropy`` gradients: rtol 1e-6, atol 1e-6 (float32 elementwise;
  ``exp`` may differ in the last bit). ``xentlambda``: rtol 1e-4, atol
  1e-6, the same formulas in the same order, where an ulp of ``exp`` or
  ``log1p`` goes through ``z = 1 - exp(-w hhat)``, ``1 - y / z`` and
  ``1 / (1 - z)`` (up to 9.2e-5 relative, 5.4e-5 absolute measured over
  200,000 scores of sd 2);
  ``boost_from_score`` within rtol 1e-7 and ``convert_output`` within
  1e-6.
- Every new metric (``xentropy``, ``xentlambda``, ``kldiv``, ``ndcg``,
  ``map``, the fork's ``topavg`` and ``topavgdiff``, their aliases and
  ``name@k:k``) against the JAX metric on the same scores: rtol 1e-12
  (both float64 numpy), with and without weights (query weights).
- End to end under ``exact`` on ``chip_smoke.ranking_data`` cut to 3,000
  rows of 10 features in ~60 queries of 20-80 docs (num_leaves=15,
  max_bin=63, 3 rounds): every tree under tests/test_torch_slice.py's tie
  rule, raw predictions within 1e-5 of the JAX model's training scores,
  the train ndcg and map within 1e-6 relative. The same for xentropy and
  weighted xentlambda on ``chip_smoke.xentropy_data``. A valid set with
  its own groups and early stopping on ``ndcg`` stop where the JAX
  package stops. Model texts load in both packages, and the JAX package's
  golden lambdarank model (tests/golden/rank_model_ref.txt) predicts in
  the port what it predicts there.

Frontier, batched and batched_part growth are in
tests/test_torch_ranking_waves.py.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from chip_smoke import ranking_data, xentropy_data
from lightgbm_tpu import metrics as jmetrics
from lightgbm_tpu import objectives as jobjectives
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMetadata
from lightgbm_tpu_torch import metrics as tmetrics
from lightgbm_tpu_torch import objectives as tobjectives
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.convert import booster_from_numpy
from lightgbm_tpu_torch.io.dataset import Metadata as TMetadata

from test_torch_regression import assert_tie_rule

ROUNDS = 3
PARAMS = {"num_leaves": 15, "max_bin": 63, "verbosity": -1}
RANK_PARAMS = dict(PARAMS, objective="lambdarank",
                   metric="ndcg,map,topavg,topavgdiff", eval_at=[1, 3, 5])
CPU = torch.device("cpu")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def rank_data(n=3000, seed=0):
    """chip_smoke's ranking workload at the suite's size: 10 features,
    queries of 20-80 docs."""
    x, rel, sizes = ranking_data(n, seed=seed, docs=(20, 80))
    return x[:, :10], rel, sizes


def _metas(label, weight=None, group=None):
    jm, tm = JMetadata(), TMetadata()
    for m in (jm, tm):
        m.set_label(label)
        m.set_weight(weight)
        m.set_query(group)
    return jm, tm


# ------------------------------------------------------------ query groups
def test_metadata_query_groups_match_jax():
    r = np.random.RandomState(1)
    sizes = r.randint(1, 30, 40)
    n = int(sizes.sum())
    jm, tm = _metas(r.rand(n), group=sizes)
    np.testing.assert_array_equal(tm.query_boundaries, jm.query_boundaries)
    assert tm.query_boundaries.dtype == jm.query_boundaries.dtype
    assert tm.num_queries == jm.num_queries == 40
    assert tm.query_weights is None and jm.query_weights is None
    w = r.rand(n) + 0.5
    for m in (jm, tm):
        m.set_weight(w)
    np.testing.assert_array_equal(tm.query_weights, jm.query_weights)
    first = tm.query_weights
    for m in (jm, tm):
        m.set_weight(np.full(n, 2.0))          # resets the cached weights
    assert tm.query_weights is not first
    np.testing.assert_array_equal(tm.query_weights, np.full(40, 2.0,
                                                            np.float32))
    for m, err in ((jm, jlgb.LightGBMError),
                   (tm, tlgb.LightGBMError)):
        with pytest.raises(err, match="Sum of query counts"):
            m.set_query(sizes[:-1])
    tm.set_query(None)
    assert tm.num_queries == 0 and tm.query_weights is None


def test_dataset_groups_match_jax():
    x, rel, sizes = rank_data(600)
    jd = jlgb.Dataset(x, label=rel, group=sizes)
    td = tlgb.Dataset(x, label=rel, group=sizes, device="cpu")
    np.testing.assert_array_equal(td.get_group(), jd.get_group())
    np.testing.assert_array_equal(td.get_group(), sizes)
    # set_group before and after binning, as the JAX package takes it
    late = tlgb.Dataset(x, label=rel, device="cpu")
    assert late.get_group() is None
    late.set_group(sizes[::-1])
    np.testing.assert_array_equal(late.get_group(), sizes[::-1])
    early = tlgb.Dataset(x, label=rel, device="cpu").set_group(sizes)
    np.testing.assert_array_equal(early.get_group(), sizes)
    xv, relv, sizes_v = rank_data(300, seed=1)
    valid = td.create_valid(xv, label=relv, group=sizes_v)
    np.testing.assert_array_equal(valid.get_group(), sizes_v)
    with pytest.raises(tlgb.LightGBMError, match="Sum of query counts"):
        tlgb.Dataset(x, label=rel, group=sizes[1:], device="cpu").construct()
    with pytest.raises(tlgb.LightGBMError, match="query information"):
        tlgb.train({"objective": "lambdarank", "verbosity": -1},
                   tlgb.Dataset(x, label=rel, device="cpu"),
                   num_boost_round=1, device="cpu")


# ------------------------------------------------------------- lambdarank
def _rank_objectives(label, weight, sizes, **params):
    params = dict(params, objective="lambdarank")
    jo = jobjectives.create_objective(JConfig(params))
    to = tobjectives.create_objective(TConfig(params))
    jm, tm = _metas(label, weight, sizes)
    jo.init(jm, len(label))
    to.init(tm, CPU)
    return jo, to


def assert_query_close(got, want, sizes, rel=1e-6):
    """Each element within ``rel`` of its query's sum of |want|."""
    qid = np.repeat(np.arange(len(sizes)), sizes)
    qsum = np.bincount(qid, weights=np.abs(want), minlength=len(sizes))
    bound = rel * qsum[qid]
    bad = np.flatnonzero(np.abs(got - want) > bound)
    assert not len(bad), (bad[:5], got[bad[:5]], want[bad[:5]])


def _rank_case():
    """Queries of 1-79 docs (the first two single-doc ones), labels 0-4,
    one query whose labels are all 0."""
    r = np.random.RandomState(3)
    sizes = r.randint(1, 80, 50)
    sizes[:2] = 1
    qb = np.concatenate([[0], np.cumsum(sizes)])
    label = r.randint(0, 5, qb[-1]).astype(np.float64)
    label[qb[5]:qb[6]] = 0
    return r, sizes, label


SCORES = ("random", "equal", "leaf_tied")
RANK_CASES = {"default": {}, "weights": {},
              "label_gain": {"label_gain": [0, 1, 3, 7, 15, 40]},
              "max_position": {"max_position": 3}}


@pytest.mark.parametrize("scores", SCORES)
@pytest.mark.parametrize("case", sorted(RANK_CASES))
def test_lambdarank_gradients_match_jax(case, scores):
    r, sizes, label = _rank_case()
    n = len(label)
    weight = r.rand(n) + 0.5 if case == "weights" else None
    jo, to = _rank_objectives(label, weight, sizes, **RANK_CASES[case])
    s = {"random": r.randn(n),
         "equal": np.zeros(n),
         # a tree's leaves: docs of one leaf tie
         "leaf_tied": r.choice([-0.3, 0.1, 0.25], n)}[scores]
    s = s.astype(np.float32)
    jg, jh = (np.asarray(a) for a in jo.get_gradients(jnp.asarray(s)))
    tg, th = to.get_gradients(torch.as_tensor(s))
    assert tg.dtype == th.dtype == torch.float32
    assert_query_close(tg.numpy(), jg, sizes)
    assert_query_close(th.numpy(), jh, sizes)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    # single-doc and all-zero-label queries have no pairs
    for lo, hi in ((qb[0], qb[2]), (qb[5], qb[6])):
        assert not tg[lo:hi].any() and not th[lo:hi].any()
    assert to.boost_from_score() == jo.boost_from_score() == 0.0


def test_lambdarank_chunks_match_one_padded_chunk():
    r, sizes, label = _rank_case()
    params = TConfig({"objective": "lambdarank"})
    meta = _metas(label, None, sizes)[1]
    whole = tobjectives.LambdarankNDCG(params, pair_bytes_cap=1 << 40)
    small = tobjectives.LambdarankNDCG(params, pair_bytes_cap=4 * 79 ** 2 * 3)
    for obj in (whole, small):
        obj.init(meta, CPU)
    assert len(whole.chunks) == 1
    assert len(small.chunks) > 3
    # each chunk pads to its own longest query, never past the cap
    for ch in small.chunks:
        c, m = ch.rows.shape
        assert c * m * m * 4 <= small.pair_bytes_cap
    assert sorted(torch.cat([ch.dest for ch in small.chunks]).tolist()) \
        == list(range(len(label)))
    s = torch.as_tensor(r.randn(len(label)).astype(np.float32))
    for a, b in zip(small.get_gradients(s), whole.get_gradients(s)):
        assert_query_close(a.numpy(), b.numpy(), sizes)


def test_query_chunks_bucket_by_length():
    sizes = np.array([5, 100, 3, 50, 100, 4])
    runs = tobjectives.query_chunks(sizes, cap_bytes=4 * 100 * 100 + 1)
    assert [list(run) for run in runs] == [[2, 5, 0, 3], [1], [4]]
    # a query wider than the cap is a run of its own
    assert [list(r) for r in tobjectives.query_chunks(sizes, 16)] == \
        [[2], [5], [0], [3], [1], [4]]


def test_lambdarank_refuses_labels_past_label_gain():
    meta = _metas(np.array([0, 1, 2, 3, 4, 0.0]), None, [3, 3])[1]
    obj = tobjectives.create_objective(TConfig({"objective": "lambdarank",
                                                "label_gain": [0, 1, 3]}))
    with pytest.raises(tlgb.LightGBMError, match="label_gain"):
        obj.init(meta, CPU)


# ------------------------------------------------------------ xentropy
@pytest.mark.parametrize("weighted", [False, True], ids=["unw", "w"])
@pytest.mark.parametrize("name", ["xentropy", "xentlambda"])
def test_cross_entropy_gradients_match_jax(name, weighted):
    r = np.random.RandomState(4)
    n = 500
    label = r.rand(n)
    label[:3] = (0.0, 1.0, 0.5)
    weight = r.rand(n) + 0.5 if weighted else None
    jo = jobjectives.create_objective(JConfig({"objective": name}))
    to = tobjectives.create_objective(TConfig({"objective": name}))
    jm, tm = _metas(label, weight)
    jo.init(jm, n)
    to.init(tm, CPU)
    score = (r.randn(n) * 2).astype(np.float32)
    jg, jh = jo.get_gradients(jnp.asarray(score))
    tg, th = to.get_gradients(torch.as_tensor(score))
    assert tg.dtype == th.dtype == torch.float32
    rtol = 1e-6 if name == "xentropy" else 1e-4
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=rtol,
                               atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=rtol,
                               atol=1e-6)
    np.testing.assert_allclose(to.boost_from_score(), jo.boost_from_score(),
                               rtol=1e-7)
    raw = r.randn(50) * 3
    np.testing.assert_allclose(to.convert_output(raw),
                               np.asarray(jo.convert_output(raw)), rtol=1e-6)
    meta = _metas(np.array([0.2, 1.5]))[1]
    with pytest.raises(tlgb.LightGBMError, match=r"\[0, 1\]"):
        tobjectives.create_objective(TConfig({"objective": name})).init(
            meta, CPU)


# ------------------------------------------------------------- metrics
POINT_METRICS = ["xentropy", "cross_entropy", "xentlambda",
                 "cross_entropy_lambda", "kldiv", "kullback_leibler"]
QUERY_METRICS = ["ndcg", "lambdarank", "map", "mean_average_precision",
                 "topavg", "topavgdiff", "ndcg@2:4", "map@3", "topavg@-2:3",
                 "topavgdiff@1:10"]


@pytest.mark.parametrize("weighted", [False, True], ids=["unw", "w"])
@pytest.mark.parametrize("name", POINT_METRICS)
def test_cross_entropy_metrics_match_jax(name, weighted):
    r = np.random.RandomState(6)
    n = 400
    label = r.rand(n)
    weight = r.rand(n) + 0.5 if weighted else None
    score = r.randn(n)
    jm = jmetrics.create_metric(name, JConfig({}))
    tm = tmetrics.create_metric(name, TConfig({}))
    metas = _metas(label, weight)
    jm.init(metas[0], n)
    tm.init(metas[1], n)
    assert tm.names == jm.names
    assert tm.factor_to_bigger_better == jm.factor_to_bigger_better < 0
    for obj in ("xentropy", "xentlambda"):
        conv = tobjectives.create_objective(
            TConfig({"objective": obj})).convert_output
        np.testing.assert_allclose(tm.eval(score, conv),
                                   jm.eval(score, conv), rtol=1e-12)


@pytest.mark.parametrize("weighted", [False, True], ids=["unw", "w"])
@pytest.mark.parametrize("name", QUERY_METRICS)
def test_query_metrics_match_jax(name, weighted):
    r, sizes, label = _rank_case()
    n = len(label)
    weight = r.rand(n) + 0.5 if weighted else None
    params = {"eval_at": [1, 3, 5], "label_gain": [0, 1, 3, 7, 15, 31]}
    jm = jmetrics.create_metric(name, JConfig(params))
    tm = tmetrics.create_metric(name, TConfig(params))
    metas = _metas(label, weight, sizes)
    jm.init(metas[0], n)
    tm.init(metas[1], n)
    assert tm.names == jm.names
    assert tm.factor_to_bigger_better == jm.factor_to_bigger_better > 0
    # rounded scores tie within queries: the stable sorts decide
    for score in (r.randn(n), np.round(r.randn(n), 1)):
        np.testing.assert_allclose(tm.eval(score), jm.eval(score),
                                   rtol=1e-12)


def test_name_at_k_overrides_eval_at():
    cfg = TConfig({"eval_at": [1, 2]})
    assert tmetrics.create_metric("ndcg@3:7", cfg).names == ["ndcg@3",
                                                             "ndcg@7"]
    assert tmetrics.create_metric("map", cfg).names == ["map@1", "map@2"]
    assert cfg.eval_at == [1, 2]
    with pytest.raises(tlgb.LightGBMError, match="query information"):
        tmetrics.create_metric("ndcg", cfg).init(_metas(np.zeros(4))[1], 4)


# ------------------------------------------------------------ end to end
_TRAINED = {}


def train_both(objective, growth=(), **extra):
    """(x, label, sizes or None, JAX booster, port booster) trained with
    the same parameters, once per module and case."""
    key = (objective, growth, tuple(sorted(extra.items())))
    if key not in _TRAINED:
        weight = None
        if objective == "lambdarank":
            x, y, sizes = rank_data()
            params = dict(RANK_PARAMS, **dict(growth), **extra)
        else:
            x, y, w = xentropy_data(3000)
            x, sizes = x[:, :10], None
            weight = w if objective == "xentlambda" else None
            params = dict(PARAMS, objective=objective, metric="xentropy,kldiv"
                          if objective == "xentropy" else "xentlambda",
                          **dict(growth), **extra)
        jb = jlgb.train(params, jlgb.Dataset(x, label=y, weight=weight,
                                             group=sizes),
                        num_boost_round=ROUNDS)
        tb = tlgb.train(params, tlgb.Dataset(x, label=y, weight=weight,
                                             group=sizes, device="cpu"),
                        num_boost_round=ROUNDS, device="cpu")
        _TRAINED[key] = (x, y, sizes, jb, tb)
    return _TRAINED[key]


def jax_scores(jb):
    """The JAX model's raw training scores (through its bins, as the model
    was trained; its float32 ``predict`` may route a row at a threshold's
    float32 rounding otherwise)."""
    return np.asarray(jb._impl.scores, np.float64)[:, 0]


def assert_ranking_parity(x, jb, tb, metric_rtol=1e-6):
    """Every tree under the tie rule, raw predictions within 1e-5 of the
    port's training scores and of the JAX model's, every train metric
    within ``metric_rtol``."""
    assert len(tb.models) == len(jb._impl.models) == ROUNDS
    for jt, tt in zip(jb._impl.models, tb.models):
        assert tt.num_leaves_actual > 1
        assert_tie_rule(jt, tt)
    raw = tb.predict(x, raw_score=True)
    np.testing.assert_allclose(raw, tb._impl.scores_of(0), rtol=0, atol=1e-5)
    np.testing.assert_allclose(raw, jax_scores(jb), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        tb.predict(x), tb._impl.objective.convert_output(jax_scores(jb)),
        rtol=0, atol=1e-5)
    jm = {m: v for _, m, v, _ in jb.eval_train()}
    tm = {m: v for _, m, v, _ in tb.eval_train()}
    assert list(tm) == list(jm)
    for name in tm:
        np.testing.assert_allclose(tm[name], jm[name], rtol=metric_rtol,
                                   err_msg=name)
    return tm


def test_lambdarank_exact_matches_jax():
    x, _, _, jb, tb = train_both("lambdarank")
    metrics = assert_ranking_parity(x, jb, tb)
    assert list(metrics)[:3] == ["ndcg@1", "ndcg@3", "ndcg@5"]
    assert len(metrics) == 12
    assert 0.5 < metrics["ndcg@5"] <= 1.0


@pytest.mark.parametrize("objective", ["xentropy", "xentlambda"])
def test_cross_entropy_exact_matches_jax(objective):
    x, _, _, jb, tb = train_both(objective)
    assert_ranking_parity(x, jb, tb)
    # boost from average folds the init score into tree 0
    np.testing.assert_allclose(tb.models[0].leaf_value[0],
                               jb._impl.models[0].leaf_value[0], rtol=0,
                               atol=1e-5)


def test_valid_groups_and_early_stopping_on_ndcg_match_jax():
    """A valid set with its own groups, drawn from another seed with its
    labels shuffled within each query, so that its ndcg@1 turns down within
    a few rounds; the port stops where the JAX package stops, with the same
    history, and its device valid scores are its predictions."""
    x, rel, sizes = rank_data(1500, seed=2)
    xv, relv, sizes_v = rank_data(800, seed=3)
    r = np.random.RandomState(4)
    qb = np.concatenate([[0], np.cumsum(sizes_v)])
    for lo, hi in zip(qb[:-1], qb[1:]):
        relv[lo:hi] = r.permutation(relv[lo:hi])
    params = dict(RANK_PARAMS, metric="ndcg", eval_at=[1],
                  learning_rate=0.5)
    out = {}
    for name, pkg, kw in (("jax", jlgb, {}),
                          ("port", tlgb, {"device": "cpu"})):
        ds = pkg.Dataset(x, label=rel, group=sizes, **kw)
        ev = {}
        bst = pkg.train(params, ds, num_boost_round=20,
                        valid_sets=[ds.create_valid(xv, label=relv,
                                                    group=sizes_v)],
                        early_stopping_rounds=2, evals_result=ev,
                        verbose_eval=False, **kw)
        out[name] = (bst.best_iteration, ev["valid_0"]["ndcg@1"], bst)
    assert out["port"][0] == out["jax"][0] < 18
    np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=1e-6)
    bst = out["port"][2]
    assert bst.eval_valid()[0][3]             # bigger is better
    np.testing.assert_allclose(bst._impl.scores_of(1),
                               bst._impl.predict(xv, raw_score=True),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("objective", ["lambdarank", "xentropy",
                                       "xentlambda"])
def test_model_text_crosses_both_ways(objective):
    x, _, _, jb, tb = train_both(objective)
    text = tb.model_to_string()
    assert "objective=%s\n" % objective in text
    loaded = tlgb.Booster(model_str=text, device="cpu")
    np.testing.assert_array_equal(loaded.predict(x, raw_score=True),
                                  tb.predict(x, raw_score=True))
    np.testing.assert_array_equal(loaded.predict(x), tb.predict(x))
    in_jax = jlgb.Booster(model_str=text)
    np.testing.assert_allclose(in_jax.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(in_jax.predict(x), jb.predict(x), rtol=0,
                               atol=1e-5)
    back = tlgb.Booster(model_str=jb.model_to_string(), device="cpu")
    np.testing.assert_allclose(back.predict(x, raw_score=True),
                               jax_scores(jb), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        back.predict(x), back._impl.objective.convert_output(jax_scores(jb)),
        rtol=0, atol=1e-6)
    assert "objective=%s\n" % objective in back.model_to_string()


def test_golden_rank_model_predicts_as_jax():
    """The reference's lambdarank model (301 features, 10 trees of 31
    leaves) on seeded rows of hundredths in [0, 1], 30% of them 0: no value
    lies within a float32 rounding of a threshold, so the JAX package's
    float32 compare routes every row as the port's float64 one does."""
    path = os.path.join(GOLDEN, "rank_model_ref.txt")
    r = np.random.RandomState(0)
    x = r.randint(0, 101, (500, 301)) / 100.0
    x[r.rand(*x.shape) < 0.3] = 0.0
    jb = jlgb.Booster(model_file=path)
    tb = tlgb.Booster(model_file=path, device="cpu")
    assert tb.num_trees() == 10
    assert tb._impl.objective.name == "lambdarank"
    want = np.asarray(jb.predict(x, raw_score=True), np.float64)
    np.testing.assert_allclose(tb.predict(x, raw_score=True), want, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tb.predict(x), want, rtol=0, atol=1e-6)
    assert np.ptp(want) > 0.1


@pytest.mark.parametrize("objective", ["lambdarank", "xentropy"])
def test_booster_from_numpy_takes_the_objective(objective):
    x, _, _, jb, _ = train_both(objective)
    fields = ("split_feature", "threshold", "threshold_bin", "default_left",
              "missing_type", "left_child", "right_child", "leaf_value",
              "internal_value", "split_gain", "leaf_count", "internal_count")
    trees = [{k: np.asarray(getattr(t, k)) for k in fields}
             | {"shrinkage": t.shrinkage} for t in jb._impl.models]
    mappers = [m.to_dict() for m in jb._train_set._binned.bin_mappers]
    booster = booster_from_numpy(trees, mappers, device="cpu",
                                 params={"objective": objective})
    np.testing.assert_allclose(booster.predict(x, raw_score=True),
                               jax_scores(jb), rtol=0, atol=1e-6)
    want = (jax_scores(jb) if objective == "lambdarank"
            else 1.0 / (1.0 + np.exp(-jax_scores(jb))))
    np.testing.assert_allclose(booster.predict(x), want, rtol=0, atol=1e-6)


def test_lambdarank_bagging_refuses_citing_group_aware_bagging():
    """Bagging under lambdarank once refused here, citing group-aware
    bagging (ROADMAP Queue 1 #7). It trains now and bags whole queries as
    the JAX package does: every query wholly in or out of the mask, which
    is the JAX package's bit for bit (tests/test_torch_sampling.py holds
    the trees)."""
    x, rel, sizes = rank_data(600)
    params = dict(RANK_PARAMS, bagging_freq=1, bagging_fraction=0.5)
    tb = tlgb.train(params, tlgb.Dataset(x, label=rel, group=sizes,
                                         device="cpu"),
                    num_boost_round=2, device="cpu")
    jb = jlgb.train(params, jlgb.Dataset(x, label=rel, group=sizes),
                    num_boost_round=2)
    mask = tb._impl._bag_mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(jb._impl._bag_mask))
    assert 0 < mask.sum() < len(rel)
    for q in np.split(mask, np.cumsum(sizes)[:-1]):
        assert q.min() == q.max()
