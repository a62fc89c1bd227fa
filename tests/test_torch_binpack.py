"""Packed bin words and dataset-wide pair coding (``tpu_bin_packing``), in
the port and in the JAX package.

On the CPU (JAX on the CPU, imported inside the fixture ``jx`` so that the
card's tests below run where only PyTorch is installed), on numpy data of
2,000-4,000 rows:

- ``pack_words_np``/``unpack_words_np`` byte for byte the JAX package's for
  every tail shape (1-9 columns), the torch unpack and the per-row gather
  of codes straight from the words equal to its ``unpack_words`` and
  ``gather_code_columns``;
- ``resolve_bin_packing``'s policy, the JAX package's for every mode;
- the plain packed histograms (root and slots) equal the unpacked ones bit
  for bit, and the JAX package's packed scatter histograms within 1e-5;
- frontier growth under ``byte`` builds the trees of ``none`` (identical,
  raw predictions equal) and the JAX package's ``byte`` trees (tree 0
  node for node, later trees under the f32 tie rule, raw within 1e-5);
- ``nibble`` pairs the small features dataset-wide as the JAX package
  does (the stored matrix byte for byte, its columns halved) and builds
  the JAX package's ``nibble`` trees;
- routing from the words equals routing from the unpacked codes.

Marked ``cuda`` (skipped without a card): each word variant of
``histogram.cu`` and ``hist_slots.cu`` against its plain version on the
same codes, and frontier training on words launching only them:

    python -m pytest tests/test_torch_binpack.py -m cuda --noconftest -q
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import os
import shutil
import types

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.core import binpack as tbp
from lightgbm_tpu_torch.core import grow_batched as tgb
from lightgbm_tpu_torch.core import histogram as th
from lightgbm_tpu_torch.core import kernels
from lightgbm_tpu_torch.core.split import BestSplit


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules, on the CPU."""
    import jax.numpy as jnp

    import lightgbm_tpu as jlgb
    from lightgbm_tpu.core import binpack as jbp
    from lightgbm_tpu.core import histogram as jh
    return types.SimpleNamespace(jnp=jnp, lgb=jlgb, bp=jbp, hist=jh)


PARAMS = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 40,
          "tree_growth": "frontier", "verbosity": -1}
ROUNDS = 3


def dense_data(n=3000, f=10, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(n, f)
    y = (x[:, 0] + 0.5 * x[:, 1] * x[:, 2] + 0.3 * r.randn(n) > 0)
    return x, y.astype(np.float32)


def small_bin_data(n=4000, seed=0):
    """12 numerical features of 2-16 levels: the default cap (the widest
    column, 16 bins) pairs 2 of them, ``nibble``'s (256) all 12 into 6
    stored columns."""
    r = np.random.RandomState(seed)
    levels = [2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 16, 7]
    x = np.column_stack([r.randint(0, k, n) for k in levels]).astype(
        np.float64)
    y = (x[:, 9] / 15 + x[:, 6] / 9 - x[:, 2] / 3 + 0.05 * x[:, 7]
         + 0.3 * r.randn(n) > 0.4)
    return x, y.astype(np.float32)


def _codes(n, c, seed, high=256):
    return np.random.RandomState(seed).randint(0, high, (n, c)).astype(
        np.uint8)


@pytest.mark.parametrize("cols", range(1, 10))
def test_word_roundtrip_every_tail_shape(jx, cols):
    xb = _codes(2000, cols, cols)
    words = tbp.pack_words_np(xb)
    np.testing.assert_array_equal(words, jx.bp.pack_words_np(xb))
    assert words.dtype == np.int32 and words.shape == (
        2000, tbp.words_per_row(cols))
    np.testing.assert_array_equal(tbp.unpack_words_np(words, cols), xb)
    np.testing.assert_array_equal(jx.bp.unpack_words_np(words, cols), xb)
    tw = torch.from_numpy(words)
    np.testing.assert_array_equal(tbp.unpack_words(tw, cols).numpy(), xb)
    np.testing.assert_array_equal(
        tbp.unpack_words(tw, cols).numpy(),
        np.asarray(jx.bp.unpack_words(jx.jnp.asarray(words), cols)))
    # a column a row, gathered straight from the words
    col = np.random.RandomState(cols).randint(0, cols, 2000).astype(np.int32)
    got = tbp.gather_code_columns(tw, torch.from_numpy(col)).numpy()
    np.testing.assert_array_equal(got, xb[np.arange(2000), col])
    np.testing.assert_array_equal(got, np.asarray(jx.bp.gather_code_columns(
        jx.jnp.asarray(words), jx.jnp.asarray(col))))


def test_resolve_bin_packing_policy(jx):
    for mode in ("auto", "none", "byte", "nibble", " Byte "):
        for streamed in (False, True):
            for tpu in (False, True):
                for bins in ([4, 16, 2], [4, 17], []):
                    kw = dict(streamed=streamed, tpu_shaped=tpu,
                              col_num_bin=bins)
                    assert tbp.resolve_bin_packing(mode, **kw) == \
                        jx.bp.resolve_bin_packing(mode, **kw)
    # the card is not TPU-shaped: auto is none in memory, byte streamed
    assert tbp.resolve_bin_packing("auto", streamed=False, tpu_shaped=False,
                                   col_num_bin=[4]) == "none"
    assert tbp.resolve_bin_packing("auto", streamed=True, tpu_shaped=False,
                                   col_num_bin=[4]) == "byte"


@pytest.mark.parametrize("cols", [7, 8, 13])
def test_plain_packed_histograms_equal_unpacked(jx, cols):
    r = np.random.RandomState(cols)
    n, b, s = 3000, 64, 5
    xb = _codes(n, cols, cols, b)
    words = torch.from_numpy(tbp.pack_words_np(xb))
    vals = torch.from_numpy(r.randn(n, 3).astype(np.float32))
    slot = torch.from_numpy(r.randint(-1, s, n).astype(np.int32))
    for sums in ("running", "blocked"):
        root = th.hist_tile_vals(words, vals, b, "auto", sums, cols)
        assert torch.equal(root, th.hist_tile_vals(torch.from_numpy(xb),
                                                   vals, b, "auto", sums))
        slots = th.hist_slots(words, slot, vals, b, s, "auto", sums, cols)
        assert torch.equal(slots, th.hist_slots(torch.from_numpy(xb), slot,
                                                vals, b, s, "auto", sums))
    g, h, m = (vals[:, k].numpy() for k in range(3))
    want = np.asarray(jx.hist.build_histogram(
        jx.jnp.asarray(words.numpy()), jx.jnp.asarray(g),
        jx.jnp.asarray(h), jx.jnp.asarray(m), num_bins=b, impl="scatter",
        packed_cols=cols))
    got = th.build_histogram(words, vals[:, 0], vals[:, 1], vals[:, 2], b,
                             packed_cols=cols).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want = np.asarray(jx.hist.build_histogram_frontier(
        jx.jnp.asarray(words.numpy()), jx.jnp.asarray(slot.numpy()),
        jx.jnp.asarray(g), jx.jnp.asarray(h), jx.jnp.asarray(m),
        num_bins=b, num_slots=s, impl="scatter", packed_cols=cols))
    got = th.build_histogram_frontier(words, slot, vals[:, 0], vals[:, 1],
                                      vals[:, 2], b, s,
                                      packed_cols=cols).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_routing_from_words_equals_routing_from_codes():
    r = np.random.RandomState(4)
    n, c, k = 2500, 11, 6
    xb = _codes(n, c, 4, 32)
    words = torch.from_numpy(tbp.pack_words_np(xb))
    z = torch.zeros(k)
    cur = BestSplit(gain=torch.ones(k),
                    feature=torch.as_tensor(r.randint(0, c, k)),
                    threshold=torch.as_tensor(r.randint(0, 32, k)),
                    default_left=torch.as_tensor(r.rand(k) < 0.5),
                    **{f: z.clone() for f in BestSplit._fields[4:]})
    meta = types.SimpleNamespace(
        num_bin=torch.full((c,), 32), default_bin=torch.zeros(c,
                                                              dtype=torch.long),
        missing_type=torch.as_tensor(r.randint(0, 3, c)))
    rs = torch.as_tensor(r.randint(0, k, n))
    want = tgb._route_rows_gather(torch.from_numpy(xb), rs, cur, meta)
    got = tgb._route_rows_gather(words, rs, cur, meta, packed_cols=c)
    assert torch.equal(got, want) and 0 < int(want.sum()) < n


def _port(x, y, params, rounds=ROUNDS):
    return tlgb.train(dict(params), tlgb.Dataset(x, label=y, device="cpu"),
                      num_boost_round=rounds, device="cpu")


def _jax(jx, x, y, params, rounds=ROUNDS):
    return jx.lgb.train(dict(params), jx.lgb.Dataset(x, label=y),
                        num_boost_round=rounds)


def assert_forests_agree(x, jb, tb):
    """Tree 0 node for node, later trees under the f32 tie rule
    (tests/test_torch_regression.py), raw predictions within 1e-5."""
    from test_torch_regression import assert_tie_rule
    jt, tt = jb._impl.models[0], tb.models[0]
    nn = jt.num_leaves_actual - 1
    assert tt.num_leaves_actual == jt.num_leaves_actual
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child", "split_leaf"):
        np.testing.assert_array_equal(getattr(tt, name)[:nn],
                                      getattr(jt, name)[:nn], err_msg=name)
    for jt, tt in zip(jb._impl.models[1:], tb.models[1:]):
        assert_tie_rule(jt, tt)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=0,
                               atol=1e-5)


@pytest.fixture(scope="module")
def byte_boosters(jx):
    """One training a mode on ``dense_data``, shared by the byte tests."""
    x, y = dense_data()
    return x, {"none": _port(x, y, dict(PARAMS, tpu_bin_packing="none")),
               "byte": _port(x, y, dict(PARAMS, tpu_bin_packing="byte")),
               "jax_byte": _jax(jx, x, y, dict(PARAMS,
                                               tpu_bin_packing="byte"))}


def test_byte_builds_the_trees_of_none(byte_boosters):
    x, bst = byte_boosters
    none, byte = bst["none"], bst["byte"]
    assert byte._impl.grow_params.word_packed_cols == x.shape[1]
    assert byte._impl.xb.dtype == torch.int32 and byte._impl.xb.shape[1] == \
        tbp.words_per_row(x.shape[1])
    assert none._impl.grow_params.word_packed_cols == 0
    # the texts differ in their parameters line only
    assert byte.model_to_string().split("parameters:")[0] == \
        none.model_to_string().split("parameters:")[0]
    np.testing.assert_array_equal(byte.predict(x, raw_score=True),
                                  none.predict(x, raw_score=True))


def test_byte_builds_the_jax_packages_trees(byte_boosters):
    x, bst = byte_boosters
    assert bst["jax_byte"]._impl._word_packed_cols == x.shape[1]
    assert_forests_agree(x, bst["jax_byte"], bst["byte"])


def test_byte_rollback_replays_unpacked_codes(byte_boosters):
    x, bst = byte_boosters
    y = dense_data()[1]
    b = _port(x, y, dict(PARAMS, tpu_bin_packing="byte"), 2)
    one = _port(x, y, dict(PARAMS, tpu_bin_packing="byte"), 1)
    b.rollback_one_iter()
    np.testing.assert_allclose(b._impl.scores_of(0), one._impl.scores_of(0),
                               rtol=0, atol=1e-6)


def test_nibble_halves_columns_and_builds_the_jax_trees(jx):
    x, y = small_bin_data()
    params = dict(PARAMS, tpu_bin_packing="nibble")
    tb, jb = _port(x, y, params), _jax(jx, x, y, params)
    tds, jds = tb._train_set._binned, jb._train_set._binned
    assert tds.col_features == jds.col_features
    assert tds.col_num_bin == jds.col_num_bin
    np.testing.assert_array_equal(tds.X_binned, jds.X_binned)
    plain = tlgb.Dataset(x, label=y, params=dict(PARAMS),
                         device="cpu").construct()._binned
    assert tds.num_columns == x.shape[1] // 2 < plain.num_columns
    assert max(tds.col_num_bin) > max(plain.col_num_bin)
    assert tb._impl.grow_params.word_packed_cols == tds.num_columns
    assert_forests_agree(x, jb, tb)


# ---- on the card -------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available() or (
            shutil.which("nvcc") is None
            and not os.path.exists("/usr/local/cuda/bin/nvcc")):
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU "
                    "or interpret mode")
    return torch.device("cuda")


def _within_sum_bound(got, want, vals_abs_sum):
    """The kernels' f32 atomics add in any order: a cell within 1e-5 of the
    sum of |values| that land in it, plus 1e-6."""
    tol = 1e-5 * vals_abs_sum + 1e-6
    assert (np.abs(got - want) <= tol).all(), float(
        np.abs(got - want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,cols,variant", [
    (4096, 28, "direct"), (4096, 30, "direct"), (300_000, 28, "block"),
    (300_000, 34, "block"), (300_000, 13, None)])
def test_word_histogram_kernel_matches_plain(cuda_device, n, cols, variant):
    r = np.random.RandomState(n + cols)
    xb = _codes(n, cols, cols, 255)
    words = torch.from_numpy(tbp.pack_words_np(xb)).to(cuda_device)
    vals = torch.from_numpy(r.randn(n, 3).astype(np.float32)).to(cuda_device)
    before = kernels.build_histogram_words_cuda.launches
    got = kernels.build_histogram_words_cuda(words, vals, 255, cols, variant)
    assert kernels.build_histogram_words_cuda.launches == before + 1
    want = th.hist_plain(torch.from_numpy(xb).to(cuda_device), vals, 255,
                         "f64")
    absum = th.hist_plain(torch.from_numpy(xb).to(cuda_device), vals.abs(),
                          255, "f64")
    _within_sum_bound(got.cpu().numpy(), want.cpu().numpy(),
                      absum.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n,cols,s", [(300_000, 28, 2), (300_000, 28, 16),
                                      (300_000, 34, 16), (5000, 9, 254)])
def test_word_slot_kernel_matches_plain(cuda_device, n, cols, s):
    r = np.random.RandomState(n + s)
    xb = _codes(n, cols, s, 255)
    words = torch.from_numpy(tbp.pack_words_np(xb)).to(cuda_device)
    vals = torch.from_numpy(r.randn(n, 3).astype(np.float32)).to(cuda_device)
    slot = torch.from_numpy(np.where(r.rand(n) < 0.5, r.randint(0, s, n),
                                     -1).astype(np.int32)).to(cuda_device)
    before = kernels.build_histogram_slots_words_cuda.launches
    got = kernels.build_histogram_slots_words_cuda(words, slot, vals, 255, s,
                                                   cols)
    assert kernels.build_histogram_slots_words_cuda.launches == before + 1
    codes = torch.from_numpy(xb).to(cuda_device)
    want = th.hist_slots_plain(codes, slot, vals, 255, s, "f64")
    absum = th.hist_slots_plain(codes, slot, vals.abs(), 255, s, "f64")
    _within_sum_bound(got.cpu().numpy(), want.cpu().numpy(),
                      absum.cpu().numpy())


@pytest.mark.cuda
def test_frontier_on_words_launches_the_word_kernels(cuda_device):
    x, y = dense_data(20_000)
    counted = (kernels.build_histogram_cuda, kernels.build_histogram_slots_cuda,
               kernels.build_histogram_words_cuda,
               kernels.build_histogram_slots_words_cuda)
    before = [w.launches for w in counted]
    bst = tlgb.train(dict(PARAMS, tpu_bin_packing="byte"),
                     tlgb.Dataset(x, label=y), num_boost_round=ROUNDS)
    after = [w.launches - b for w, b in zip(counted, before)]
    assert after[:2] == [0, 0] and after[2] == ROUNDS and after[3] > 0
    plain = tlgb.train(dict(PARAMS, tpu_bin_packing="byte",
                            tpu_hist_impl="plain"),
                       tlgb.Dataset(x, label=y), num_boost_round=1)
    assert bst.models[0].split_feature[0] == plain.models[0].split_feature[0]
    assert np.isfinite(bst.predict(x)).all()
