"""The port's options on a rank group against the JAX package's serial
training and the port's own one-device training, on the CPU.

4 thread ranks (``mesh_shape=[4]``, 1,003 rows: a short last block) train
each option as the JAX package trains it serially on the same inputs:
multiclass (3 classes) under exact and frontier growth, DART, RF,
monotone constraints under the reduce-scatter learner, a custom
objective (its gradients over every row, each rank taking its block),
categorical features under every learner and grower that takes them,
continued training from an init model, a valid set with early stopping,
and a rollback on every rank. Voting elects every feature here
(``top_k=6``), where it is exact. Against the JAX package: the same
number of trees, each under tests/test_torch_categorical.py's f32 tie
rule, raw predictions within 2e-4; against the port on one device: raw
predictions within 1e-6. Every rank's model digest agrees, and a rank
whose trees differ is caught.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.log import LightGBMError

from conftest import make_binary
from test_torch_categorical import assert_tie_rule

BASE = {"objective": "binary", "num_leaves": 7, "verbosity": -1}
MESH = {"tree_learner": "data", "mesh_shape": [4]}
JAX_TOL = 2e-4
PORT_TOL = 1e-6


def _data():
    x, y = make_binary(n=1003, f=6)
    xc = x.copy()
    xc[:, 5] = (np.abs(xc[:, 5]) * 3).astype(int)
    ymc = np.random.RandomState(1).randint(0, 3, len(x)).astype(float)
    return x, y, xc, ymc


def _logistic(preds, data):
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - data.get_label(), p * (1.0 - p)


OPTIONS = {
    "multiclass": ({"objective": "multiclass", "num_class": 3}, {}),
    "multiclass_frontier": ({"objective": "multiclass", "num_class": 3,
                             "tree_growth": "frontier"}, {}),
    "dart": ({"boosting": "dart", "skip_drop": 0.0}, {}),
    "rf": ({"boosting": "rf", "bagging_freq": 1, "bagging_fraction": 0.5},
           {}),
    "monotone_data_rs": ({"monotone_constraints": [1, 0, 0, 0, 0, -1],
                          "tree_growth": "frontier"}, {}),
    "fobj": ({}, {"fobj": _logistic}),
    "cat_data_exact": ({"tree_learner": "data"}, {"cat": True}),
    "cat_data_rs": ({"tree_learner": "data", "tree_growth": "frontier"},
                    {"cat": True}),
    "cat_voting_exact": ({"tree_learner": "voting", "top_k": 6},
                         {"cat": True}),
    "cat_voting_frontier": ({"tree_learner": "voting", "top_k": 6,
                             "tree_growth": "frontier"}, {"cat": True}),
    "cat_feature": ({"tree_learner": "feature"}, {"cat": True}),
}


def _dataset(lgb, x, y, cat=False):
    kw = {} if lgb is jlgb else {"device": "cpu"}
    return lgb.Dataset(x, label=y, categorical_feature=[5] if cat else "auto",
                       **kw)


def _train(params, x, y, rounds, cat=False, **kw):
    return tlgb.train(dict(BASE, **params), _dataset(tlgb, x, y, cat),
                      rounds, device="cpu", **kw)


def _jax(params, x, y, rounds, cat=False, **kw):
    return jlgb.train(dict(BASE, **params), _dataset(jlgb, x, y, cat),
                      rounds, **kw)


def assert_jax_serial(jb, tb, x):
    """The rank group's model against the JAX package's serial one."""
    assert len(tb.models) == len(jb._impl.models) > 0
    for jt, tt in zip(jb._impl.models, tb.models):
        assert tt.num_leaves_actual > 1
        assert_tie_rule(jt, tt)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=0,
                               atol=JAX_TOL)


def _serial(params):
    return {k: v for k, v in params.items()
            if k not in ("tree_learner", "top_k", "mesh_shape")}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_an_option_on_ranks_trains_the_one_device_model(option):
    x, y, xc, ymc = _data()
    params, how = OPTIONS[option]
    cat = how.get("cat", False)
    data = xc if cat else x
    label = ymc if params.get("objective") == "multiclass" else y
    kw = {"fobj": how["fobj"]} if "fobj" in how else {}
    jb = _jax(_serial(params), data, label, 4, cat, **kw)
    one = _train(_serial(params), data, label, 4, cat, **kw)
    ranks = _train(dict(MESH, **params), data, label, 4, cat, **kw)
    assert ranks._impl._comm.world == 4
    assert_jax_serial(jb, ranks, data)
    assert len(ranks.models) == len(one.models)
    np.testing.assert_allclose(ranks.predict(data, raw_score=True),
                               one.predict(data, raw_score=True), rtol=0,
                               atol=PORT_TOL)


def test_init_model_early_stopping_and_rollback_on_ranks():
    x, y, _, _ = _data()
    xv, yv = make_binary(n=300, f=6, seed=3)
    # both packages continue the same JAX-written model text
    text = _jax({}, x, y, 3).model_to_string()
    jb = _jax({}, x, y, 2, init_model=jlgb.Booster(model_str=text))
    ranks = _train(MESH, x, y, 2,
                   init_model=tlgb.Booster(model_str=text, device="cpu"))
    assert ranks.num_trees() == jb.num_trees() == 5
    assert_jax_serial(jb, ranks, x)
    stopped = []
    for lgb, params in ((jlgb, {}), (tlgb, {}), (tlgb, MESH)):
        train = _jax if lgb is jlgb else _train
        bst = train(dict(params, metric="auc", learning_rate=0.5), x, y, 40,
                    valid_sets=[_dataset(lgb, xv, yv)],
                    early_stopping_rounds=2)
        stopped.append((bst.best_iteration, bst.best_score["valid_0"]["auc"]))
    assert stopped[0][0] == stopped[1][0] == stopped[2][0] < 40
    assert stopped[2][1] == pytest.approx(stopped[0][1], rel=1e-5)
    assert stopped[2] == stopped[1]
    ranks = _train(MESH, x, y, 4)
    ranks.rollback_one_iter()
    assert ranks.current_iteration() == 3
    assert [len(p.models) for p in ranks._impl._peers] == [3, 3, 3]
    jb = jlgb.Booster(BASE, _dataset(jlgb, x, y))
    for _ in range(4):
        jb.update()
    jb.rollback_one_iter()
    assert_jax_serial(jb, ranks, x)
    np.testing.assert_allclose(ranks.predict(x, raw_score=True),
                               _train({}, x, y, 3).predict(x, raw_score=True),
                               rtol=0, atol=PORT_TOL)


def test_thread_ranks_agree_on_the_model_and_catch_a_divergence():
    x, y, _, _ = _data()
    ranks = _train(MESH, x, y, 3)
    digests = ranks.model_digests
    assert len(digests) == 4 and len(set(digests)) == 1
    impl = ranks._impl
    assert impl.check_model_agreement(ranks._model_text) == digests
    impl._peers[2].models[1].leaf_value[0] += 1e-3
    with pytest.raises(LightGBMError, match="model disagreement"):
        impl.check_model_agreement(ranks._model_text)
