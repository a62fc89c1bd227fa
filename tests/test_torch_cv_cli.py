"""Cross-validation, the command line and the C++ export (ROADMAP Queue 1
#17) in the port and in the JAX package.

- ``cv``: the folds index for index (stratified, plain, group-aware, and
  a scikit-learn ``KFold`` and a list of pairs); each round's mean and
  standard deviation within 1e-5; early stopping cuts every list at the
  best round in both; ``return_cvbooster`` gives a booster a fold; a
  Dataset built with the default ``free_raw_data=True`` works; one binned
  and freed before ``cv`` raises; lambdarank raises the JAX package's
  error (a fold's Datasets carry no query groups there either).
- ``model_to_cpp``: the port's C++ text is byte for byte the JAX
  package's, and compiled with ``g++`` its ``Predict`` is within 1e-6 of
  ``Booster.predict``.
- The command line: ``task=train``, ``predict`` and ``convert_model`` on
  the same CSV in both packages (``device_type=cpu`` for the port); the
  predictions agree within 1e-6 except on rows within a float32 rounding
  of a threshold (the JAX package compares in float32), which are
  counted. The tasks and keys not ported yet refuse, citing their items,
  and without CUDA the default device raises.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from chip_smoke import bench_data, ranking_data
from lightgbm_tpu import cli as jcli
from lightgbm_tpu import engine as jengine
from lightgbm_tpu.io import model_text as jtext
from lightgbm_tpu_torch import cli as tcli
from lightgbm_tpu_torch import engine as tengine
from lightgbm_tpu_torch.io import model_text as ttext

CV_TOL = 1e-5
CPP_REL_TOL = 1e-6
PARAMS = {"objective": "binary", "metric": "auc", "num_leaves": 7,
          "min_data_in_leaf": 40, "verbosity": -1}


def _binary(n=2000, seed=0):
    x, y = bench_data(n, f=6, seed=seed)
    return x.astype(np.float64), y.astype(np.float64)


def _folds(pkg, engine, kind):
    kw = {} if pkg is jlgb else {"device": "cpu"}
    folds, stratified, group = None, kind == "stratified", None
    if kind == "grouped":
        x, y, group = ranking_data(1500)
    else:
        x, y = _binary(1003)
    if kind == "kfold":
        from sklearn.model_selection import KFold
        folds = KFold(n_splits=4, shuffle=True, random_state=2)
    elif kind == "pairs":
        folds = [(np.arange(0, 600), np.arange(600, 1003)),
                 (np.arange(300, 1003), np.arange(0, 300))]
    ds = pkg.Dataset(x, label=y, group=group, **kw)
    return engine._make_n_folds(ds, folds, 5, PARAMS, 7, stratified, True)


@pytest.mark.parametrize("kind", ["stratified", "plain", "grouped", "kfold",
                                  "pairs"])
def test_folds_are_the_jax_packages(kind):
    want = _folds(jlgb, jengine, kind)
    got = _folds(tlgb, tengine, kind)
    assert len(got) == len(want)
    for (tr, te), (jtr, jte) in zip(got, want):
        np.testing.assert_array_equal(tr, jtr)
        np.testing.assert_array_equal(te, jte)
        assert np.intersect1d(tr, te).size == 0


CV_CASES = {
    "stratified": ({}, {}),
    # a learning rate and leaves that overfit fast, so early stopping fires
    "early_stopping": ({"learning_rate": 0.9, "metric": "binary_logloss"},
                       {"early_stopping_rounds": 2, "stratified": False}),
    "train_metric": ({"metric": ["auc", "binary_logloss"]},
                     {"eval_train_metric": True, "nfold": 3}),
}


def _cv(pkg, case, rounds=6):
    params, kwargs = CV_CASES[case]
    kw = {} if pkg is jlgb else {"device": "cpu"}
    x, y = _binary()
    if case == "early_stopping":
        y = np.where(np.random.RandomState(4).rand(len(y)) < 0.35, 1 - y, y)
    return pkg.cv(dict(PARAMS, **params), pkg.Dataset(x, label=y, **kw),
                  num_boost_round=rounds, seed=3,
                  **dict({"nfold": 4, "return_cvbooster": True}, **kwargs),
                  **kw)


@pytest.mark.parametrize("case", sorted(CV_CASES))
def test_cv_matches_the_jax_package(case):
    want, got = _cv(jlgb, case), _cv(tlgb, case)
    boosters = got.pop("cvbooster")
    want.pop("cvbooster")
    assert sorted(got) == sorted(want)
    for key, values in want.items():
        np.testing.assert_allclose(got[key], values, rtol=0, atol=CV_TOL)
    rounds = len(next(iter(got.values())))
    if case == "early_stopping":
        assert rounds < 6 and boosters.best_iteration == rounds
    else:
        assert rounds == 6 and boosters.best_iteration == -1
    assert len(boosters.boosters) == CV_CASES[case][1].get("nfold", 4)
    assert all(b.device == torch.device("cpu") for b in boosters.boosters)


def test_cv_on_freed_and_ranking_data():
    x, y = _binary(600)
    # the default free_raw_data=True: cv reads the rows before binning
    ds = tlgb.Dataset(x, label=y, device="cpu")
    res = tlgb.cv(PARAMS, ds, num_boost_round=2, nfold=3, device="cpu")
    assert len(res["valid auc-mean"]) == 2 and ds.data is None
    with pytest.raises(tlgb.LightGBMError, match="free_raw_data=False"):
        tlgb.cv(PARAMS, ds, num_boost_round=2, nfold=3, device="cpu")
    xr, rel, sizes = ranking_data(600)
    errors = []
    for pkg, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        with pytest.raises(pkg.LightGBMError) as err:
            pkg.cv({"objective": "lambdarank", "verbosity": -1},
                   pkg.Dataset(xr, label=rel, group=sizes, **kw),
                   num_boost_round=1, nfold=3, **kw)
        errors.append(str(err.value))
    assert errors[0] == errors[1] == \
        "Lambdarank tasks require query information"


def test_cv_raises_without_cuda(monkeypatch):
    x, y = _binary(300)
    ds = tlgb.Dataset(x, label=y, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlgb.cv(PARAMS, ds, num_boost_round=1)


_TEXTS = {}


def _model_text(kind):
    """The port's model text: binary with a categorical column and missing
    values, three classes, or Poisson regression (an exp link)."""
    if kind not in _TEXTS:
        x, y = _binary()
        params = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
        cat = "auto"
        if kind == "binary":
            x[:, 5] = np.floor(np.abs(x[:, 5]) * 4)
            x[::9, 2] = np.nan
            cat = [5]
        elif kind == "multiclass":
            y = np.digitize(x[:, 0] + x[:, 1] * x[:, 2], [-0.5, 0.5])
            params.update(objective="multiclass", num_class=3)
        else:
            y = np.exp(0.5 * x[:, 0])
            params.update(objective="poisson")
        bst = tlgb.train(params, tlgb.Dataset(
            x, label=y, categorical_feature=cat, device="cpu"),
            num_boost_round=4, device="cpu")
        _TEXTS[kind] = (bst.model_to_string(), x, bst)
    return _TEXTS[kind]


@pytest.mark.parametrize("kind", ["binary", "multiclass", "poisson"])
def test_cpp_export_is_the_jax_packages_and_scores(kind, tmp_path):
    text, x, bst = _model_text(kind)
    code = ttext.model_to_cpp(ttext.parse_model_string(text))
    assert code == jtext.model_to_cpp(jtext.parse_model_string(text))
    src, lib = tmp_path / "model.cpp", tmp_path / "model.so"
    src.write_text(code)
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(lib),
                    str(src)], check=True, timeout=120)
    scorer = ctypes.CDLL(str(lib))
    k = bst.num_model_per_iteration()
    out = np.zeros(k, np.float64)
    rows = np.ascontiguousarray(x[:200], np.float64)
    got = np.empty((len(rows), k))
    for i, row in enumerate(rows):
        scorer.Predict(row.ctypes.data_as(ctypes.c_void_p),
                       out.ctypes.data_as(ctypes.c_void_p))
        got[i] = out
    want = bst.predict(rows).reshape(len(rows), k)
    np.testing.assert_allclose(got, want, rtol=CPP_REL_TOL, atol=1e-12)


def _f32_threshold_rows(models, x) -> np.ndarray:
    """Rows whose value on some split feature lies within a float32
    rounding of that split's threshold."""
    near = np.zeros(len(x), bool)
    for t in models:
        for node in range(t.num_leaves_actual - 1):
            if t.is_categorical[node]:
                continue
            v = x[:, int(t.split_feature[node])]
            near |= (np.float32(v) == np.float32(t.threshold[node])) | (
                (v <= t.threshold[node])
                != (np.float32(v) <= np.float32(t.threshold[node])))
    return near


def _write_csv(path, x, y):
    np.savetxt(path, np.column_stack([y, x]), fmt="%.17g", delimiter=",",
               comments="", header=",".join(
                   ["label"] + ["f%d" % j for j in range(x.shape[1])]))


def test_cli_matches_the_jax_package(tmp_path):
    x, y = _binary(2000)
    data = tmp_path / "train.csv"
    _write_csv(data, x, y)
    out = {}
    for name, cli, extra in (("port", tcli, ["device_type=cpu"]),
                             ("jax", jcli, [])):
        model = tmp_path / ("%s.model" % name)
        pred = tmp_path / ("%s.pred" % name)
        common = ["data=%s" % data, "header=true", "verbosity=-1"] + extra
        assert cli.main(["task=train", "objective=binary", "num_leaves=15",
                         "num_trees=4", "output_model=%s" % model]
                        + common) == 0
        assert cli.main(["task=predict", "input_model=%s" % model,
                         "output_result=%s" % pred] + common) == 0
        # both packages convert the port's model
        cpp = tmp_path / ("%s.cpp" % name)
        assert cli.main(["task=convert_model",
                         "input_model=%s" % (tmp_path / "port.model"),
                         "convert_model=%s" % cpp] + extra) == 0
        out[name] = (ttext.parse_model_file(str(model))["trees"],
                     np.loadtxt(pred), cpp.read_text())
    # the same trees; leaf values and gains part in the last float32 bits
    for tt, jt in zip(out["port"][0], out["jax"][0]):
        for field in ("split_feature", "threshold", "left_child",
                      "right_child", "default_left", "leaf_count"):
            np.testing.assert_array_equal(getattr(tt, field),
                                          getattr(jt, field))
        np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=0,
                                   atol=1e-6)
    assert out["port"][2] == out["jax"][2]
    bst = tlgb.Booster(model_file=str(tmp_path / "port.model"),
                       device="cpu")
    near = _f32_threshold_rows(bst.models, x)
    diff = np.abs(out["port"][1] - out["jax"][1])
    assert (diff[~near] <= 1e-6).all(), diff[~near].max()
    np.testing.assert_allclose(out["port"][1], bst.predict(x), rtol=0,
                               atol=1e-12)


REFUSED_CLI = {
    # task=serve runs (ROADMAP #10); its options outside the slice refuse
    "serve": (["task=serve", "serve_num_devices=2"], "#13 slice b"),
    # the coordination service's faults, whose seam is the device mesh's
    "fault_inject_kv": (["fault_inject=kv_timeout@round:2"], "#13 slice b"),
    "serve_fault_inject_kv": (["task=serve", "fault_inject=kv_error@calls:1"],
                              "#13 slice b"),
    # refused until the health monitor came (#15): it now acts, and a NaN
    # label's gradients abort the run from the monitor
    "health_monitor": (["health_monitor=abort", "objective=regression"],
                       None),
}


@pytest.mark.parametrize("what", sorted(REFUSED_CLI))
def test_cli_refusals_cite_their_items(what, tmp_path, capsys):
    tokens, item = REFUSED_CLI[what]
    data = tmp_path / "train.csv"
    x, y = _binary(200)
    if item is None:
        y[5] = np.nan
        _write_csv(data, x, y)
        assert tcli.main(["task=train", "data=%s" % data, "header=true",
                          "device_type=cpu", "num_trees=3",
                          "output_model=%s" % (tmp_path / "m.txt")]
                         + tokens) == 1
        assert "training aborted by health monitor: non-finite gradient" \
            "/hessian at iteration 0" in capsys.readouterr().err
        return
    _write_csv(data, x, y)
    with pytest.raises(NotImplementedError,
                       match=r"\(ROADMAP Queue 1 %s\)$" % item):
        tcli.main(["data=%s" % data, "header=true", "device_type=cpu",
                   "input_model=m.txt"] + tokens)


def test_cli_runs_on_cuda_unless_told_otherwise(monkeypatch, tmp_path):
    assert [tcli.device_of(tcli.Config({"device_type": v}))
            for v in ("cpu", "CPU", "cuda", "gpu", "tpu")] == [
        "cpu", "cpu", None, None, None]
    data = tmp_path / "train.csv"
    _write_csv(data, *_binary(200))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["task=train", "data=%s" % data, "header=true",
                   "output_model=%s" % (tmp_path / "m.txt")])
    assert tcli.main(["task=train", "data=%s" % data, "header=true",
                      "num_trees=1", "device=cpu", "verbosity=-1",
                      "output_model=%s" % (tmp_path / "m.txt")]) == 0
    assert os.path.exists(tmp_path / "m.txt")
