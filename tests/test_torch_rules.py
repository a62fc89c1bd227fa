"""Rules the PyTorch port keeps.

- The port and ``chip_smoke.py`` import neither JAX nor the JAX package.
- Entry points run on CUDA unless the caller asks for the CPU, and raise
  when there is no CUDA device instead of slipping onto the CPU.
- Every option outside the port's slice raises ``NotImplementedError``
  instead of training a different model.
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
    "categorical": ({"categorical_feature": "0"}, None),
    "efb_bundles": ({}, "sparse"),
    "bagging": ({"bagging_freq": 1, "bagging_fraction": 0.5}, None),
    "goss": ({"boosting": "goss"}, None),
    "dart": ({"boosting": "dart"}, None),
    "rf": ({"boosting": "rf", "bagging_freq": 1,
            "bagging_fraction": 0.5}, None),
    "regression": ({"objective": "regression"}, None),
    "multiclass": ({"objective": "multiclass", "num_class": 3}, "classes"),
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
    "small_feature_pairs": ({"enable_bundle": False}, "#4"),
}


@pytest.mark.parametrize("kind", sorted(REFUSALS))
def test_refusals_cite_their_roadmap_item(kind):
    params, item = REFUSALS[kind]
    x, y = _data()
    if kind.startswith("sparse"):
        import scipy.sparse
        x = scipy.sparse.csr_matrix(x)
    if kind == "small_feature_pairs":
        # a 0/1 and a 0/1/2 column: the JAX package packs them into one
        r = np.random.RandomState(3)
        x = np.column_stack([x, r.randint(0, 2, len(x)),
                             r.randint(0, 3, len(x))])
    with pytest.raises(NotImplementedError,
                       match=r"\(ROADMAP Queue 1 %s\)$" % item):
        if kind == "sparse_matrix_binning":
            # the binning entry point itself, below the Dataset's check
            from lightgbm_tpu_torch.config import Config
            from lightgbm_tpu_torch.io.dataset import BinnedDataset
            BinnedDataset.from_matrix(x, Config({}), label=y)
        tlgb.train(dict(params, objective="binary", verbosity=-1),
                   tlgb.Dataset(x, label=y, device="cpu"),
                   num_boost_round=1, device="cpu")


@pytest.mark.parametrize("option", sorted(OUTSIDE_SLICE))
def test_outside_the_slice_raises(option):
    params, data = OUTSIDE_SLICE[option]
    x, y = _data()
    if data == "sparse":
        # mutually exclusive sparse columns: EFB would bundle them
        r = np.random.RandomState(2)
        x = np.zeros((400, 6))
        which = r.randint(0, 6, 400)
        x[np.arange(400), which] = r.rand(400) + 1
    if data == "classes":
        y = np.arange(len(y)) % 3
    ds = tlgb.Dataset(x, label=y, device="cpu")
    with pytest.raises(NotImplementedError, match="outside what the PyTorch port covers"):
        tlgb.train(dict(params, objective=params.get("objective", "binary"),
                        verbosity=-1), ds, num_boost_round=1, device="cpu")
