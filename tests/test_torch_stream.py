"""Out-of-core streamed ingest and training (``data_stream_chunk_rows``,
``lightgbm_tpu_torch/stream/``), held against the JAX package on the CPU
and against the port's own in-memory training, after the JAX package's
tests/test_stream.py.

Histograms add over row partitions, so growth over chunks makes the
in-memory trees at the same bin boundaries (``bin_construct_sample_cnt >=
N`` keeps round 1's reservoir equal to the data, so the mappers are the
in-memory loader's byte for byte): the port's streamed trees equal its
in-memory trees node for node, raw predictions within 1e-5 (chunked f32
sums add in another order), on dense data, a half-empty last chunk, chunk
rows >= N, categorical data with EFB bundles, multiclass, bagging and
GOSS; and the JAX package's streamed trees (tree 0 node for node, later
trees under the f32 tie rule of tests/test_torch_regression.py, raw
predictions within 1e-5). Around them: the chunk sources (array, ``.npy``
memory map, CSV), the reservoir sample against the two-round file loader
and the JAX package's ingest (mappers and stored chunks byte for byte),
the uniform repack and the pipeline's accounting, and the gates and
refusals (a mesh #13); streamed checkpoints and resume are held in
tests/test_torch_checkpoint.py.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.core import histogram as jh
from lightgbm_tpu.stream import ArraySource as JArraySource
from lightgbm_tpu.stream.sampler import ingest as jingest
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.core import histogram as th
from lightgbm_tpu_torch.core import binpack
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.stream import (ArraySource, ChunkSource, CsvSource,
                                       NpyMmapSource, ingest)
from lightgbm_tpu_torch.stream.pipeline import ChunkPipeline, repack_uniform

from test_torch_regression import assert_tie_rule

BASE = dict(objective="binary", num_leaves=8, verbosity=-1,
            tree_growth="frontier", bin_construct_sample_cnt=200000,
            min_data_in_leaf=5)
ROUNDS = 5
STRUCT = ("split_feature", "threshold_bin", "left_child", "right_child",
          "split_leaf", "cat_bitset_bin")


def _data(n=3000, f=8, seed=0, categorical=False):
    r = np.random.RandomState(seed)
    x = r.randn(n, f)
    if categorical:
        x[:, 3] = r.randint(0, 8, n)
    y = (2 * x[:, 0] + np.sin(x[:, 1]) + 0.7 * x[:, 2]
         + 0.3 * r.randn(n) > 0).astype(np.float64)
    return x, y


def _port(params, x, y, rounds=ROUNDS, **dskw):
    return tlgb.train(dict(params), tlgb.Dataset(x, label=y, device="cpu",
                                                 **dskw),
                      num_boost_round=rounds, device="cpu")


def assert_same_trees(a, b, x, atol=1e-5):
    """Node for node, and raw predictions within ``atol``."""
    assert len(a.models) == len(b.models)
    for ta, tb in zip(a.models, b.models):
        nn = ta.num_leaves_actual - 1
        assert tb.num_leaves_actual - 1 == nn
        for name in STRUCT:
            np.testing.assert_array_equal(getattr(ta, name)[:nn],
                                          getattr(tb, name)[:nn],
                                          err_msg=name)
    np.testing.assert_allclose(a.predict(x, raw_score=True),
                               b.predict(x, raw_score=True), rtol=0,
                               atol=atol)


# ---- histograms add over chunks ------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
def test_histograms_additive_over_chunks(packed):
    r = np.random.RandomState(1)
    n, f, b, k = 2000, 6, 32, 4
    xb = r.randint(0, b, (n, f)).astype(np.uint8)
    slot = r.randint(-1, k, n).astype(np.int32)
    g, h = r.randn(n).astype(np.float32), np.abs(r.randn(n)).astype(
        np.float32)
    m = (r.rand(n) < 0.8).astype(np.float32)
    bins = binpack.pack_words_np(xb) if packed else xb
    pc = f if packed else 0
    t = torch.from_numpy
    full = th.build_histogram(t(bins), t(g), t(h), t(m), b,
                              packed_cols=pc).numpy()
    full_s = th.build_histogram_frontier(t(bins), t(slot), t(g), t(h), t(m),
                                         b, k, packed_cols=pc).numpy()
    acc, acc_s = np.zeros_like(full), np.zeros_like(full_s)
    for lo in range(0, n, 700):               # a ragged last chunk (600)
        c = slice(lo, min(lo + 700, n))
        acc += th.build_histogram(t(bins[c]), t(g[c]), t(h[c]), t(m[c]), b,
                                  packed_cols=pc).numpy()
        acc_s += th.build_histogram_frontier(
            t(bins[c]), t(slot[c]), t(g[c]), t(h[c]), t(m[c]), b, k,
            packed_cols=pc).numpy()
    np.testing.assert_allclose(acc, full, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(acc_s, full_s, rtol=1e-5, atol=1e-3)
    # the JAX package's full-matrix histograms
    jfull = np.asarray(jh.build_histogram(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), jnp.asarray(m),
        num_bins=b, impl="scatter", packed_cols=pc))
    np.testing.assert_allclose(full, jfull, rtol=1e-5, atol=1e-4)


# ---- end to end against the in-memory trees and the JAX package ----------


@pytest.fixture(scope="module")
def dense_run():
    """Dense data trained in memory, streamed in chunks of 700 (packed
    words, streamed auto's byte) and by the JAX package streamed."""
    x, y = _data()
    p = dict(BASE, data_stream_chunk_rows=700)
    return x, y, {
        "memory": _port(BASE, x, y),
        "stream": _port(p, x, y),
        "jax": jlgb.train(dict(p), jlgb.Dataset(x, label=y),
                          num_boost_round=ROUNDS)}


def test_streamed_matches_single_shot_dense(dense_run):
    x, _, bst = dense_run
    s = bst["stream"]._impl
    assert s._stream is not None and s._stream.num_chunks == 5
    assert s._stream.packed and s.grow_params.word_packed_cols == x.shape[1]
    assert s._grow.trees_grown == ROUNDS
    assert_same_trees(bst["memory"], bst["stream"], x)


def test_streamed_matches_the_jax_packages_streamed_trees(dense_run):
    x, _, bst = dense_run
    jb, tb = bst["jax"], bst["stream"]
    jt, tt = jb._impl.models[0], tb.models[0]
    nn = jt.num_leaves_actual - 1
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child"):
        np.testing.assert_array_equal(getattr(tt, name)[:nn],
                                      getattr(jt, name)[:nn], err_msg=name)
    for jt, tt in zip(jb._impl.models[1:], tb.models[1:]):
        assert_tie_rule(jt, tt)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=0,
                               atol=1e-5)


def test_streamed_pipeline_accounting_after_training(dense_run):
    x, _, bst = dense_run
    st = bst["stream"]._impl._stream.stats()
    waves = bst["stream"]._impl._grow.waves
    assert st["sweeps"] == ROUNDS + waves
    assert st["rows_transferred"] == st["sweeps"] * len(x)
    assert st["wait_s"] == 0.0 and st["overlap_efficiency"] == 1.0


STREAM_CASES = {
    # 3000 % 1999 = 1001: the last chunk is half empty after the repack
    "skewed_last_chunk": (dict(data_stream_chunk_rows=1999), {}),
    "chunk_rows_ge_n": (dict(data_stream_chunk_rows=10 ** 6), {}),
    "unpacked": (dict(data_stream_chunk_rows=750, tpu_bin_packing="none"),
                 {}),
    # a categorical feature, and two sparse columns that share one
    "categorical_efb": (dict(data_stream_chunk_rows=777),
                        dict(categorical=True)),
    "bagging": (dict(data_stream_chunk_rows=750, bagging_fraction=0.7,
                     bagging_freq=1), {}),
    "goss": (dict(data_stream_chunk_rows=750, boosting="goss",
                  learning_rate=0.5), {}),
    "feature_fraction": (dict(data_stream_chunk_rows=750,
                              feature_fraction=0.6), {}),
    "multiclass": (dict(data_stream_chunk_rows=700, objective="multiclass",
                        num_class=3), {}),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_streamed_matches_single_shot(case):
    extra, data_kw = STREAM_CASES[case]
    x, y = _data(seed=3 if data_kw else 0, **data_kw)
    dskw = {}
    if case == "categorical_efb":
        # two sparse, nearly exclusive columns bundle (EFB)
        r = np.random.RandomState(4)
        x[:, 4] = (r.rand(len(x)) < 0.05) * r.randint(1, 5, len(x))
        x[:, 5] = (r.rand(len(x)) < 0.05) * r.randint(1, 5, len(x))
        dskw["categorical_feature"] = [3]
    if case == "multiclass":
        y = np.digitize(2 * x[:, 0] + np.sin(x[:, 1]),
                        [-1.0, 1.0]).astype(np.float64)
    memory = dict(BASE, **{k: v for k, v in extra.items()
                           if k != "data_stream_chunk_rows"})
    rounds = 3 if case == "multiclass" else ROUNDS
    # the streamed booster takes the per-iteration key stream, as the JAX
    # package does; a valid set puts the in-memory one on it too
    a = tlgb.train(dict(memory), tlgb.Dataset(x, label=y, device="cpu",
                                              **dskw),
                   num_boost_round=rounds, device="cpu",
                   callbacks=[lambda env: None])
    b = _port(dict(BASE, **extra), x, y, rounds, **dskw)
    chunks = b._train_set._binned.chunks
    assert len(chunks) == -(-len(x) // min(len(x), extra[
        "data_stream_chunk_rows"]))
    if case == "categorical_efb":
        # the two sparse columns share a stored column
        assert b._train_set._binned.num_columns < x.shape[1]
    # GOSS amplifies the sampled rows' gradients by (1 - top) / other = 8
    # at a learning rate of 0.5: a leaf value's f32 rounding moves raw
    # predictions 5 x 8 times further
    assert_same_trees(a, b, x, atol=1e-5 * (40 if case == "goss" else 1))


# ---- sources and ingest ---------------------------------------------------


def test_npy_and_csv_sources_match_the_array(tmp_path):
    x, y = _data(n=1200)
    p = dict(BASE, data_stream_chunk_rows=500)
    ref = _port(p, x, y, 3)
    npy = str(tmp_path / "x.npy")
    np.save(npy, x)
    b1 = tlgb.train(dict(p), tlgb.Dataset(npy, label=y, params=dict(p),
                                          device="cpu"),
                    num_boost_round=3, device="cpu")
    assert_same_trees(ref, b1, x, atol=0)
    csv = str(tmp_path / "d.csv")
    np.savetxt(csv, np.column_stack([y, x]), delimiter=",", fmt="%.17g")
    np.savetxt(csv + ".weight", np.ones(len(y)))
    ds = tlgb.Dataset(csv, params=dict(p), device="cpu")
    b2 = tlgb.train(dict(p), ds, num_boost_round=3, device="cpu")
    assert ds._binned.is_streamed and ds._binned.metadata.weight is not None
    assert_same_trees(ref, b2, x)


def test_streamed_dataset_equals_the_jax_packages():
    """Mappers, stored layout and binned chunks byte for byte, from a
    sub-sample (``bin_construct_sample_cnt`` < N) too."""
    x, y = _data(n=2500, f=4, seed=9)
    x[:, 3] = (x[:, 3] > 0.5) * x[:, 2]      # zeros: a sparse column
    for params in (dict(bin_construct_sample_cnt=400, data_random_seed=11),
                   dict(bin_construct_sample_cnt=200000)):
        ours = ingest(ArraySource(x, label=y, chunk_rows=600),
                      Config(params))
        ref = jingest(JArraySource(x, label=y, chunk_rows=600),
                      JConfig(params))
        assert [m.to_dict() for m in ours.bin_mappers] == \
            [m.to_dict() for m in ref.bin_mappers]
        assert ours.col_features == ref.col_features
        assert ours.chunk_row_counts == ref.chunk_row_counts == \
            [600, 600, 600, 600, 100]
        for a, b in zip(ours.chunks, ref.chunks):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ours.metadata.label,
                                      ref.metadata.label)


def test_reservoir_sample_matches_two_round_loader(tmp_path):
    x, y = _data(n=2500, f=4, seed=9)
    cfg = Config(dict(bin_construct_sample_cnt=400, data_random_seed=11))
    sd = ingest(ArraySource(x, label=y, chunk_rows=600), cfg)
    path = str(tmp_path / "x.csv")
    np.savetxt(path, np.column_stack([y, x]), delimiter=",", fmt="%.17g")
    ref = BinnedDataset.from_file_two_round(path, cfg)
    for m1, m2 in zip(sd.bin_mappers, ref.bin_mappers):
        assert m1.to_dict() == m2.to_dict()
    stride = ingest(ArraySource(x, label=y, chunk_rows=600), cfg,
                    sample_stride=7)
    assert stride.num_data == 2500 and stride.is_streamed


def test_streamed_dataset_shape_and_refusals(tmp_path):
    x, y = _data(n=1100, f=4)
    sd = ingest(ArraySource(x, label=y, chunk_rows=300),
                Config(dict(bin_construct_sample_cnt=200000)))
    assert sd.is_streamed and sd.X_binned is None
    assert sd.chunk_row_counts == [300, 300, 300, 200]
    assert sd.num_data == 1100
    with pytest.raises(LightGBMError, match="save_binary"):
        sd.save_binary(str(tmp_path / "nope.bin"))


def test_bad_sources_raise(tmp_path):
    import scipy.sparse
    cfg = Config(dict(bin_construct_sample_cnt=1000))
    with pytest.raises(LightGBMError):
        ArraySource(scipy.sparse.eye(10).tocsr(), chunk_rows=5)
    with pytest.raises(LightGBMError):
        ArraySource(np.zeros((10, 2)), chunk_rows=0)
    with pytest.raises(LightGBMError):
        ArraySource(np.zeros((10, 2)), label=np.zeros(7), chunk_rows=5)
    with pytest.raises(LightGBMError):
        NpyMmapSource(str(tmp_path / "missing.npy"), chunk_rows=5)
    libsvm = str(tmp_path / "d.libsvm")
    with open(libsvm, "w") as fh:
        fh.write("1 0:2.5 3:1.2\n0 1:0.5\n")
    with pytest.raises(LightGBMError, match="LibSVM"):
        CsvSource(libsvm, chunk_rows=4)

    class Ragged(ChunkSource):
        chunk_rows = 4

        def reset(self):
            pass

        def __iter__(self):
            yield np.zeros((4, 3)), None
            yield np.zeros((4, 2)), None      # the feature count changes

    with pytest.raises(LightGBMError, match="feature"):
        ingest(Ragged(), cfg)

    class Empty(ChunkSource):
        chunk_rows = 4

        def reset(self):
            pass

        def __iter__(self):
            return iter(())

    with pytest.raises(LightGBMError, match="no rows"):
        ingest(Empty(), cfg)

    class Shrinking(ChunkSource):
        """Not restartable: round 2 yields fewer rows than round 1."""
        chunk_rows = 4

        def __init__(self):
            self.calls = 0

        def reset(self):
            self.calls += 1

        def __iter__(self):
            for _ in range(3 if self.calls <= 1 else 2):
                yield np.random.RandomState(0).randn(4, 3), None

    with pytest.raises(LightGBMError, match="restartable"):
        ingest(Shrinking(), cfg)
    with pytest.raises(LightGBMError, match="sparse"):
        tlgb.Dataset(scipy.sparse.random(50, 3, density=0.5, format="csr"),
                     label=np.zeros(50), device="cpu",
                     params=dict(BASE, data_stream_chunk_rows=10)).construct()


# ---- the pipeline ----------------------------------------------------------


def test_repack_uniform_and_pipeline_accounting():
    chunks = [np.arange(i * 10, i * 10 + r * 3, dtype=np.uint8
                        ).reshape(r, 3) % 250
              for i, r in enumerate([5, 2, 7, 1])]
    uni, total = repack_uniform(chunks, 4)
    assert total == 15
    assert [c.shape for c in uni] == [(4, 3)] * 4
    np.testing.assert_array_equal(np.concatenate(uni)[:total],
                                  np.concatenate(chunks))
    assert not np.any(np.concatenate(uni)[total:])   # zero padding
    for packed in (False, True):
        pipe = ChunkPipeline(chunks, 4, prefetch=2, packed=packed)
        assert pipe.num_chunks == 4 and pipe.num_padded == 16
        assert pipe.valid_rows == [4, 4, 4, 3] and pipe.num_cols == 3
        seen = [(i, c.numpy()) for i, c in pipe.sweep()]
        assert [i for i, _ in seen] == [0, 1, 2, 3]
        got = np.concatenate([c for _, c in seen])
        if packed:
            assert got.dtype == np.int32 and got.shape == (16, 1)
            got = binpack.unpack_words_np(got, 3)
        np.testing.assert_array_equal(got, np.concatenate(uni))
        st = pipe.stats()
        assert st["sweeps"] == 1 and st["rows_transferred"] == 15
        assert 0.0 <= st["overlap_efficiency"] <= 1.0


# ---- gates and refusals ----------------------------------------------------


GATES = {
    "negative_chunk_rows": dict(data_stream_chunk_rows=-1),
    "prefetch_0": dict(data_stream_chunk_rows=100, data_stream_prefetch=0),
    "exact_growth": dict(data_stream_chunk_rows=100, tree_growth="exact"),
    "dart": dict(data_stream_chunk_rows=100, boosting="dart"),
    "f64": dict(data_stream_chunk_rows=100, gpu_use_dp=True),
    "f64_hist_dtype": dict(data_stream_chunk_rows=100,
                           tpu_hist_dtype="float64"),
}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_streaming_config_gates(gate):
    x, y = _data(n=400)
    with pytest.raises(LightGBMError):
        _port(dict(BASE, **GATES[gate]), x, y, 1)


def test_streamed_rollback_input_grads_and_replays_refused():
    x, y = _data(n=600)
    bst = _port(dict(BASE, data_stream_chunk_rows=200), x, y, 2)
    with pytest.raises(LightGBMError, match="rollback"):
        bst.rollback_one_iter()
    with pytest.raises(LightGBMError, match="gradients"):
        bst._impl.train_one_iter(grad=np.zeros(len(y), np.float32),
                                 hess=np.ones(len(y), np.float32))
    # a valid set bins with the streamed set's mappers, in memory
    valid = bst._train_set.create_valid(x[:100], label=y[:100])
    bst.add_valid(valid.construct(), "v")
    np.testing.assert_allclose(bst._impl.scores_of(1),
                               bst.predict(x[:100], raw_score=True),
                               rtol=0, atol=1e-5)


REFUSED = {
    "sharded_source": "#13 slice b",
    "sharded_ingest": "#13 slice b",
    "mesh": "#13 slice b",
}


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_streamed_refusals_cite_their_roadmap_item(kind, tmp_path):
    from lightgbm_tpu_torch.stream.source import ShardedSource
    x, y = _data(n=400)
    match = r"\(ROADMAP Queue 1 %s\)$" % REFUSED[kind]
    src = ArraySource(x, label=y, chunk_rows=100)
    with pytest.raises(NotImplementedError, match=match):
        if kind == "sharded_source":
            ShardedSource(src, rank=0, world=2)
        elif kind == "sharded_ingest":
            ingest(src, Config(dict(BASE)), comm=object())
        else:
            _port(dict(BASE, data_stream_chunk_rows=100,
                       tree_learner="data"), x, y, 1)
