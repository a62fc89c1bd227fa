"""Rules the PyTorch port keeps.

- The port and ``chip_smoke.py`` import neither JAX nor the JAX package.
- Entry points run on CUDA unless the caller asks for the CPU, and raise
  when there is no CUDA device instead of slipping onto the CPU.
- Every option outside the port's slice raises ``NotImplementedError``
  instead of training a different model, and every public method of the
  JAX package's ``Booster`` and ``Dataset`` exists on the port's, ported
  or refusing the same way.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import device as tdevice

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "lightgbm_tpu_torch")


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "lightgbm_tpu")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_jax_package_import(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno)


def test_the_scan_covers_the_wave_growers():
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for module in ("core/grow.py", "core/grow_frontier.py",
                   "core/grow_batched.py", "core/grow_batched_part.py",
                   "core/repack.py", "core/kernels.py"):
        assert os.path.join("lightgbm_tpu_torch", module) in scanned


def test_importing_the_port_leaves_jax_out():
    mods = ["lightgbm_tpu_torch"] + [
        "lightgbm_tpu_torch." + os.path.relpath(p, PORT)[:-3]
        .replace(os.sep, ".").replace(".__init__", "")
        for p in _port_sources() if p.startswith(PORT)]
    code = ("import importlib, sys\n"
            "for m in %r: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lightgbm_tpu')]\n"
            "assert not bad, bad\n" % sorted(set(mods)))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_no_cuda_raises_instead_of_using_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.RandomState(0).randn(200, 3)
    y = (x[:, 0] > 0).astype(float)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlgb.Dataset(x, label=y)
    ds = tlgb.Dataset(x, label=y, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlgb.train({"objective": "binary"}, ds, num_boost_round=1)
    bst = tlgb.train({"objective": "binary", "verbosity": -1}, ds,
                     num_boost_round=1, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlgb.Booster(model_str=bst.model_to_string())
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


def _data(n=400):
    r = np.random.RandomState(1)
    x = r.randn(n, 4)
    return x, (x[:, 0] + 0.3 * r.randn(n) > 0).astype(float)


OUTSIDE_SLICE = {
    "monotone": ({"monotone_constraints": [1, 0, 0, 0]}, None),
    "forced_splits": ({"forcedsplits_filename": "forced.json"}, None),
    "cegb": ({"cegb_penalty_split": 0.5}, None),
    "gpu_use_dp": ({"gpu_use_dp": True}, None),
    # frontier, batched and partitioned batched growth are in the slice;
    # packed bin words and model statistics on the partitioned step are not
    "tree_growth_frontier": ({"tree_growth": "frontier",
                              "tpu_bin_packing": "byte"}, None),
    "tree_growth_batched": ({"tree_growth": "batched",
                             "tpu_batched_part": "true",
                             "obs_modelstats": True}, None),
    "mesh": ({"tree_learner": "data"}, None),
    "pallas_impl": ({"tpu_hist_impl": "pallas"}, None),
}


# refusals raised while the data are binned or the options checked, each
# citing the ROADMAP Queue 1 item that brings what it refuses
REFUSALS = {
    "packed_words": ({"tree_growth": "frontier", "tpu_bin_packing": "byte"},
                     "#9"),
    "sparse_input": ({}, "#16"),
    "sparse_matrix_binning": ({}, "#16"),
    # dataset-wide pairing (the JAX package's nibble cap) stays refused
    "nibble_pairs": ({"tpu_bin_packing": "nibble"}, "#9"),
    "checkpoint_callback": ({}, "#12"),
    # refusals of the user-facing Dataset and Booster
    "data_file": ({}, "#16"),
    # methods of the JAX package's Booster and Dataset the port lacks
    "booster_dump_model": ({}, "#17"),
    "booster_refit": ({}, "#15"),
    "dataset_subset": ({}, "#17"),
    "dataset_save_binary": ({}, "#16"),
    "reset_training_data": ({}, "#20"),
    "pred_leaf": ({}, "#8"),
}


def _refused_call(kind, params, x, y):
    """The call that ``kind`` refuses."""
    if kind == "sparse_matrix_binning":
        # the binning entry point itself, below the Dataset's check
        from lightgbm_tpu_torch.config import Config
        from lightgbm_tpu_torch.io.dataset import BinnedDataset
        return BinnedDataset.from_matrix(x, Config({}), label=y)
    if kind == "data_file":
        return tlgb.Dataset("train.csv", device="cpu").construct()
    params = dict(params, objective="binary", verbosity=-1)
    if kind == "dataset_subset":
        return tlgb.Dataset(x, label=y, device="cpu").subset([0, 1, 2])
    if kind == "dataset_save_binary":
        return tlgb.Dataset(x, label=y, device="cpu").save_binary("x.bin")
    if kind in ("reset_training_data", "pred_leaf", "booster_dump_model",
                "booster_refit"):
        bst = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                         num_boost_round=1, device="cpu")
        text = bst.model_to_string()
        if kind == "booster_dump_model":
            return bst.dump_model()
        if kind == "booster_refit":
            return bst.refit(x, y)
        if kind == "reset_training_data":
            return bst.update(train_set=tlgb.Dataset(x, label=y,
                                                     device="cpu"))
        return bst.predict(x, pred_leaf=True)
    extra = {}
    if kind == "checkpoint_callback":
        extra["callbacks"] = [tlgb.callback.checkpoint("checkpoints")]
    return tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                      num_boost_round=1, device="cpu", **extra)


@pytest.mark.parametrize("kind", sorted(REFUSALS))
def test_refusals_cite_their_roadmap_item(kind):
    params, item = REFUSALS[kind]
    x, y = _data()
    if kind.startswith("sparse"):
        import scipy.sparse
        x = scipy.sparse.csr_matrix(x)
    if kind == "nibble_pairs":
        x = _small_pair_data(x)
    with pytest.raises(NotImplementedError,
                       match=r"\(ROADMAP Queue 1 %s\)$" % item):
        _refused_call(kind, params, x, y)


def test_every_refusal_cites_a_roadmap_item():
    """Every ``outside_slice`` call in the port names the ROADMAP Queue 1
    item that brings what it refuses."""
    uncited = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "outside_slice"
                    and len(node.args) + len(node.keywords) < 2):
                uncited.append("%s:%d" % (os.path.relpath(path, ROOT),
                                          node.lineno))
    assert not uncited, uncited


def _small_pair_data(x):
    """A 0/1 and a 0/1/2 column beside ``x``: the JAX package packs them
    into one stored column."""
    r = np.random.RandomState(3)
    return np.column_stack([x, r.randint(0, 2, len(x)),
                            r.randint(0, 3, len(x))])


def _exclusive_sparse_data(n=400):
    """Mutually exclusive sparse columns: EFB bundles them."""
    r = np.random.RandomState(2)
    x = np.zeros((n, 6))
    which = r.randint(0, 6, n)
    x[np.arange(n), which] = r.rand(n) + 1
    return x


# data on which the port once refused to train (EFB bundles and packed
# small-feature pairs form under default parameters); it trains now, on
# the JAX package's stored layout
NOW_TRAINED = {
    "efb_bundles": ({}, "bundles"),
    "small_feature_pairs": ({"enable_bundle": False}, "pairs"),
}


# options the port once refused: categorical features (the JAX package's
# categorical split, ROADMAP Queue 1 #4) and custom objectives (#19)
NOW_TRAINS = {
    "categorical": ({"categorical_feature": "0"}, None),
    "fobj": ({}, lambda preds, data: (preds - data.get_label(),
                                      np.ones_like(preds))),
}


@pytest.mark.parametrize("option", sorted(NOW_TRAINS))
def test_categorical_features_and_fobj_train(option):
    params, fobj = NOW_TRAINS[option]
    x, y = _data()
    if option == "categorical":
        x = x.copy()
        x[:, 0] = (x[:, 0] > 0) + 2 * (x[:, 1] > 0.5)
    bst = tlgb.train(dict(params, objective="binary", verbosity=-1),
                     tlgb.Dataset(x, label=y, device="cpu"),
                     num_boost_round=2, fobj=fobj, device="cpu")
    assert len(bst.models) == 2
    if option == "categorical":
        assert bst._impl.grow_params.split.cat_features == (0,)
        assert any(t.is_categorical[:t.num_leaves_actual - 1].any()
                   for t in bst.models)
    else:
        assert bst._impl.objective is None
    assert np.isfinite(bst.predict(x)).all()


# objectives the port once refused: cross-entropy and lambdarank, which
# takes query groups (ROADMAP Queue 1 #2)
NOW_TRAIN_OBJECTIVES = ("lambdarank", "xentlambda", "xentropy")


@pytest.mark.parametrize("objective", NOW_TRAIN_OBJECTIVES)
def test_ranking_and_cross_entropy_train(objective):
    x, y = _data()
    group = [100] * 4 if objective == "lambdarank" else None
    ds = tlgb.Dataset(x, label=y, group=group, device="cpu")
    bst = tlgb.train({"objective": objective, "verbosity": -1}, ds,
                     num_boost_round=2, device="cpu")
    assert bst._impl.objective.name == objective
    assert len(bst.models) == 2
    assert np.isfinite(bst.predict(x)).all()
    if objective == "lambdarank":
        assert list(ds.get_group()) == group
        assert [m for _, m, _, _ in bst.eval_train()] == [
            "ndcg@%d" % k for k in range(1, 6)]


# options the port once refused (row sampling, ROADMAP Queue 1 #7): bagging,
# GOSS, DART, RF, bagging under lambdarank (whole queries, in four queries
# or in one) and loading an averaged (RF) model text
NOW_SAMPLES = {
    "bagging": ({"bagging_freq": 1, "bagging_fraction": 0.5}, None),
    "goss": ({"boosting": "goss", "learning_rate": 1.0}, None),
    "dart": ({"boosting": "dart", "skip_drop": 0.0}, None),
    "rf": ({"boosting": "rf", "bagging_freq": 1,
            "bagging_fraction": 0.5}, None),
    "lambdarank": ({"objective": "lambdarank", "bagging_freq": 1,
                    "bagging_fraction": 0.5}, [100] * 4),
    "lambdarank_bagging": ({"objective": "lambdarank", "bagging_freq": 1,
                            "bagging_fraction": 0.5}, [400]),
    "averaged_model_text": ({}, None),
}


@pytest.mark.parametrize("mode", sorted(NOW_SAMPLES))
def test_boosting_modes_train(mode):
    params, group = NOW_SAMPLES[mode]
    x, y = _data()
    params = dict(params, verbosity=-1)
    params.setdefault("objective", "binary")
    bst = tlgb.train(params, tlgb.Dataset(x, label=y, group=group,
                                          device="cpu"),
                     num_boost_round=3, device="cpu")
    impl = bst._impl
    assert len(bst.models) == 3
    assert np.isfinite(bst.predict(x)).all()
    if mode == "averaged_model_text":
        text = bst.model_to_string().replace(
            "label_index=0", "label_index=0\naverage_output")
        loaded = tlgb.Booster(model_str=text, device="cpu")
        assert loaded._impl.average_output
        np.testing.assert_allclose(loaded.predict(x, raw_score=True) * 3,
                                   bst.predict(x, raw_score=True),
                                   rtol=1e-12, atol=1e-12)
        return
    assert impl.boosting_type == params.get("boosting", "gbdt")
    if "bagging_freq" in params:
        mask = impl._bag_mask.numpy()
        assert 0 < mask.sum() <= len(y) - (0 if group == [400] else 1)
        assert bst.models[-1].internal_count[0] == mask.sum()
    if group is not None:
        # whole queries in or out of the bag
        for q in np.split(impl._bag_mask.numpy(), np.cumsum(group)[:-1]):
            assert q.min() == q.max()
    if mode == "rf":
        assert impl.average_output and "average_output" in \
            bst.model_to_string()


@pytest.mark.parametrize("kind", sorted(NOW_TRAINED))
def test_bundles_and_small_pairs_train(kind):
    params, layout = NOW_TRAINED[kind]
    x, y = _data()
    x = _exclusive_sparse_data() if layout == "bundles" \
        else _small_pair_data(x)
    bst = tlgb.train(dict(params, objective="binary", verbosity=-1),
                     tlgb.Dataset(x, label=y, device="cpu"),
                     num_boost_round=2, device="cpu")
    ds = bst._impl.train_data
    assert (ds.has_bundles, ds.has_packed) == (layout == "bundles",
                                               layout == "pairs")
    assert ds.num_columns < ds.num_features
    assert len(bst.models) == 2
    assert np.isfinite(bst.predict(x)).all()


@pytest.mark.parametrize("option", sorted(OUTSIDE_SLICE))
def test_outside_the_slice_raises(option):
    params, _ = OUTSIDE_SLICE[option]
    x, y = _data()
    ds = tlgb.Dataset(x, label=y, device="cpu")
    with pytest.raises(NotImplementedError, match="outside what the PyTorch port covers"):
        tlgb.train(dict(params, objective=params.get("objective", "binary"),
                        verbosity=-1), ds, num_boost_round=1, device="cpu")


@pytest.mark.parametrize("cls", ["Booster", "Dataset"])
def test_every_jax_method_is_ported_or_refuses(cls):
    """Each public method of the JAX package's class exists on the port's;
    one the port has not ported raises ``outside_slice`` citing its ROADMAP
    item, never ``AttributeError``."""
    import lightgbm_tpu as jlgb
    x, y = _data()
    ds = tlgb.Dataset(x, label=y, device="cpu")
    obj = (tlgb.train({"objective": "binary", "verbosity": -1}, ds,
                      num_boost_round=1, device="cpu")
           if cls == "Booster" else ds)
    names = sorted(m for m in dir(getattr(jlgb, cls))
                   if not m.startswith("_")
                   and callable(getattr(getattr(jlgb, cls), m)))
    refusing = []
    for name in names:
        method = getattr(obj, name)        # AttributeError fails the test
        if (method.__doc__ or "").startswith("Not ported yet"):
            with pytest.raises(NotImplementedError,
                               match=r"\(ROADMAP Queue 1 #\d+\)$"):
                method()
            refusing.append(name)
    assert len(refusing) < len(names)
