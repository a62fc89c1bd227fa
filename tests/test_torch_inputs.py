"""Input formats (ROADMAP Queue 1 #16) in the port and in the JAX package:
scipy sparse matrices, text files and the binary dataset cache.

- Sparse binning (``BinnedDataset.from_matrix`` on a CSR, a CSC and a CSR
  with duplicate entries, and a validation set binned with ``reference=``):
  mappers, used features, bundles, ``col_offsets`` and ``X_binned`` byte
  for byte the JAX package's, and the port's own dense path's on the same
  matrix densified. A stored zero is the one difference: the sparse path
  takes it as a value (both packages), the dense path sees no entry.
- ``parse_file`` on CSV with a header and a ``name:`` label column, TSV,
  space-separated and libsvm files; the sidecar files ``.weight``,
  ``.query`` and ``.init``; ``parse_file_chunks`` and the two-round load
  (``from_file_two_round``, sampling fewer rows than the file holds, and a
  validation file binned with the training layout): equal to the JAX
  package's, through ``Dataset(path)`` too.
- ``save_binary``: a cache written by either package loads in the other
  with the same ``X_binned``, mappers and metadata.
- ``Booster.predict`` on a sparse matrix of more than one row block:
  raw scores, leaves and contributions equal to the dense matrix's.
- ``tree_to_host`` moves a tree's int fields, bitset words up to 2**32 - 1
  and float32 fields through float64 bit for bit (the JAX package's
  ``core/pack.py``, one int32 buffer a tree, has nothing left to do).
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from chip_smoke import sparse_data
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io import parser as jparser
from lightgbm_tpu.io.dataset import BinnedDataset as JBinned
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.core import grow as tgrow
from lightgbm_tpu_torch.io import parser as tparser
from lightgbm_tpu_torch.io.dataset import BinnedDataset as TBinned

PARAMS = {"max_bin": 63, "verbosity": -1}
LAYOUT = ("used_features", "col_features", "col_offsets", "col_num_bin",
          "col_packed", "num_total_features")


def _small_sparse(n=3000, seed=0):
    """chip_smoke.sparse_data's shape, narrowed: four one-hot blocks of 10
    columns and 20 numeric columns at 5%."""
    return sparse_data(n, seed, blocks=4, width=10, numeric=20,
                       density=0.05)


def assert_same_binned(a, b):
    for name in LAYOUT:
        assert getattr(a, name) == getattr(b, name), name
    assert [m.to_dict() for m in a.bin_mappers] \
        == [m.to_dict() for m in b.bin_mappers]
    assert a.X_binned.dtype == b.X_binned.dtype == np.uint8
    np.testing.assert_array_equal(a.X_binned, b.X_binned)
    for name in ("label", "weight", "query_boundaries", "init_score"):
        va, vb = getattr(a.metadata, name), getattr(b.metadata, name)
        assert (va is None) == (vb is None), name
        if va is not None:
            np.testing.assert_array_equal(va, vb, err_msg=name)


# ---------------------------------------------------------------- sparse
@pytest.mark.parametrize("form", ["csr", "csc", "duplicates"])
def test_sparse_binning_matches_jax_and_the_dense_path(form):
    x, y = _small_sparse()
    if form == "csc":
        x = x.tocsc()
    if form == "duplicates":
        # every stored value split into two entries of half its value
        nnz = x.nnz
        x = sp.csr_matrix((np.repeat(x.data / 2, 2),
                           np.repeat(x.indices, 2), x.indptr * 2),
                          shape=x.shape)
        assert x.nnz == 2 * nnz
    ours = TBinned.from_matrix(x.copy(), TConfig(PARAMS), label=y)
    ref = JBinned.from_matrix(x.copy(), JConfig(PARAMS), label=y)
    assert ours.has_bundles and ours.num_columns < x.shape[1]
    assert_same_binned(ours, ref)
    dense = TBinned.from_matrix(x.toarray(), TConfig(PARAMS), label=y)
    assert_same_binned(ours, dense)


def test_sparse_valid_set_takes_the_training_layout():
    x, y = _small_sparse()
    xv, yv = _small_sparse(1000, seed=1)
    ours = TBinned.from_matrix(x, TConfig(PARAMS), label=y)
    ref = JBinned.from_matrix(x, JConfig(PARAMS), label=y)
    v_ours = TBinned.from_matrix(xv, TConfig(PARAMS), label=yv,
                                 reference=ours)
    v_ref = JBinned.from_matrix(xv, JConfig(PARAMS), label=yv,
                                reference=ref)
    assert_same_binned(v_ours, v_ref)
    ds = tlgb.Dataset(x, label=y, params=PARAMS, device="cpu")
    valid = ds.create_valid(xv, label=yv).construct()
    assert_same_binned(valid._binned, v_ours)
    with pytest.raises(Exception, match="number of features in data"):
        ds.create_valid(xv[:, :-1], label=yv).construct()


def test_a_stored_zero_is_a_value_of_the_sparse_path():
    """Column 0 stores an explicit 0.0 on the rows where column 1 has its
    values: the sparse path hands them to EFB as entries, as the JAX
    package does, so the two columns conflict there and stay apart; the
    densified matrix has no entry there, and they bundle."""
    r = np.random.RandomState(3)
    n = 2000
    dense = np.zeros((n, 3))
    dense[:200, 0] = r.rand(200) + 1
    dense[200:400, 1] = r.rand(200) + 1
    dense[:, 2] = r.randn(n)
    x = sp.csr_matrix(dense)
    coo = x.tocoo()
    zero_rows = np.arange(200, 400)
    x = sp.csr_matrix((np.concatenate([coo.data, np.zeros(len(zero_rows))]),
                       (np.concatenate([coo.row, zero_rows]),
                        np.concatenate([coo.col,
                                        np.zeros(len(zero_rows), int)]))),
                      shape=x.shape)
    assert x.nnz == coo.nnz + len(zero_rows)
    y = (dense[:, 2] > 0).astype(float)
    ours = TBinned.from_matrix(x, TConfig(PARAMS), label=y)
    assert_same_binned(ours, JBinned.from_matrix(x, JConfig(PARAMS),
                                                 label=y))
    from_dense = TBinned.from_matrix(dense, TConfig(PARAMS), label=y)
    assert [0, 1] in from_dense.col_features
    assert [0, 1] not in ours.col_features


def test_sparse_training_is_the_dense_training():
    x, y = _small_sparse()
    params = dict(PARAMS, objective="binary", num_leaves=15)
    models = [tlgb.train(params, tlgb.Dataset(data, label=y, device="cpu"),
                         num_boost_round=2, device="cpu").models
              for data in (x, x.toarray())]
    for a, b in zip(*models):
        nn = a.num_leaves_actual - 1
        np.testing.assert_array_equal(a.split_feature[:nn],
                                      b.split_feature[:nn])
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)


def test_sparse_predict_in_blocks_is_dense_predict():
    """tests/test_api.py::test_sparse_predict_blocks_not_densified's shape:
    6,000 columns, so 3,000 rows are two row blocks."""
    rng = np.random.RandomState(11)
    n, f = 3000, 6000
    s = sp.random(n, f, density=0.01, random_state=3, format="csr",
                  data_rvs=lambda k: rng.randn(k))
    y = (np.asarray(s[:, 0].todense()).ravel()
         + np.asarray(s[:, 1].todense()).ravel() > 0).astype(np.float64)
    bst = tlgb.train({"objective": "binary", "verbosity": -1,
                      "num_leaves": 15},
                     tlgb.Dataset(s[:2000], y[:2000], device="cpu"),
                     num_boost_round=5, device="cpu")
    dense = np.asarray(s.todense())
    assert max(256, (1 << 24) // f) < n
    np.testing.assert_array_equal(bst.predict(s, raw_score=True),
                                  bst.predict(dense, raw_score=True))
    np.testing.assert_array_equal(bst.predict(s, pred_leaf=True),
                                  bst.predict(dense, pred_leaf=True))
    np.testing.assert_array_equal(bst.predict(s, pred_contrib=True),
                                  bst.predict(dense, pred_contrib=True))
    want = jlgb.Booster(model_str=bst.model_to_string()).predict(
        s, raw_score=True)
    np.testing.assert_allclose(bst.predict(s, raw_score=True), want,
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------- files
def _write_delimited(path, x, y, delim, header=None):
    with open(path, "w") as fh:
        if header:
            fh.write(delim.join(header) + "\n")
        for row, label in zip(x, y):
            fh.write(delim.join(["%.17g" % label]
                                + ["%.17g" % v for v in row]) + "\n")


def _write_libsvm(path, x, y):
    x = sp.csr_matrix(x)
    with open(path, "w") as fh:
        for i in range(x.shape[0]):
            lo, hi = x.indptr[i], x.indptr[i + 1]
            fh.write(" ".join(["%.17g" % y[i]] + [
                "%d:%.17g" % (j, v)
                for j, v in zip(x.indices[lo:hi], x.data[lo:hi])]) + "\n")


def _dense_table(n=1500, seed=5):
    r = np.random.RandomState(seed)
    x = r.randn(n, 6)
    x[r.rand(n, 6) < 0.1] = 0.0
    return x, (x[:, 0] + 0.5 * r.randn(n) > 0).astype(float)


FILES = ["csv_header", "tsv", "space", "libsvm"]


def _data_file(tmp_path, kind):
    """(path, params, x, y) of a data file of ``kind``, with sidecars."""
    x, y = _dense_table()
    path = str(tmp_path / ("train." + kind))
    params = dict(PARAMS)
    if kind == "csv_header":
        # the label in column 2 of the file, named in the header
        cols = ["f%d" % j for j in range(x.shape[1])]
        table = np.column_stack([x[:, :2], y, x[:, 2:]])
        with open(path, "w") as fh:
            fh.write(",".join(cols[:2] + ["target"] + cols[2:]) + "\n")
            for row in table:
                fh.write(",".join("%.17g" % v for v in row) + "\n")
        params.update(header=True, label_column="name:target")
    elif kind == "libsvm":
        _write_libsvm(path, x, y)
    else:
        _write_delimited(path, x, y, "\t" if kind == "tsv" else " ")
    r = np.random.RandomState(9)
    np.savetxt(path + ".weight", r.uniform(0.5, 1.5, len(y)))
    np.savetxt(path + ".init", r.randn(len(y)) * 0.1)
    np.savetxt(path + ".query", np.full(len(y) // 50, 50), fmt="%d")
    return path, params, x, y


@pytest.mark.parametrize("kind", FILES)
def test_parse_file_and_sidecars_match_jax(tmp_path, kind):
    path, params, x, y = _data_file(tmp_path, kind)
    cfg = TConfig(params)
    ours = tparser.parse_file(path, has_header=cfg.header,
                              label_column=cfg.label_column)
    ref = jparser._try_parse_native
    jparser._try_parse_native = lambda *a: None    # the Python path
    try:
        want = jparser.parse_file(path, has_header=cfg.header,
                                  label_column=cfg.label_column)
    finally:
        jparser._try_parse_native = ref
    np.testing.assert_array_equal(ours[0], want[0])
    np.testing.assert_array_equal(ours[1], want[1])
    assert ours[2] == want[2]
    np.testing.assert_array_equal(ours[0], x)
    np.testing.assert_array_equal(ours[1], y)
    for load in ("load_weight_file", "load_query_file",
                 "load_init_score_file"):
        np.testing.assert_array_equal(getattr(tparser, load)(path),
                                      getattr(jparser, load)(path))
    ds = tlgb.Dataset(path, params=params, device="cpu").construct()
    jds = jlgb.Dataset(path, params=params).construct()
    assert_same_binned(ds._binned, jds._binned)
    assert ds._binned.feature_names == jds._binned.feature_names
    if kind == "csv_header":
        assert ds.get_feature_name()[:3] == ["f0", "f1", "f2"]
    # the file's Dataset is the in-memory one
    mem = tlgb.Dataset(x, label=y, params=params, device="cpu").construct()
    np.testing.assert_array_equal(ds._binned.X_binned, mem._binned.X_binned)


def test_two_round_chunks_match_jax(tmp_path):
    path, params, x, y = _data_file(tmp_path, "csv_header")
    kw = dict(has_header=True, label_column="name:target", chunk_rows=400)
    ours = list(tparser.parse_file_chunks(path, **kw))
    want = list(jparser.parse_file_chunks(path, **kw))
    assert len(ours) == len(want) == 4
    for a, b in zip(ours, want):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]
    # fewer rows sampled than the file holds: the reservoir draws
    params = dict(params, two_round=True, bin_construct_sample_cnt=700)
    t = TBinned.from_file_two_round(path, TConfig(params), chunk_rows=400)
    j = JBinned.from_file_two_round(path, JConfig(params), chunk_rows=400)
    assert_same_binned(t, j)
    vpath, _, _, _ = _data_file(tmp_path / "..", "csv_header")
    tv = TBinned.from_file_two_round(vpath, TConfig(params),
                                     chunk_rows=300, reference=t)
    jv = JBinned.from_file_two_round(vpath, JConfig(params),
                                     chunk_rows=300, reference=j)
    assert_same_binned(tv, jv)
    ds = tlgb.Dataset(path, params=params, device="cpu").construct()
    jds = jlgb.Dataset(path, params=params).construct()
    assert_same_binned(ds._binned, jds._binned)


def test_two_round_refuses_libsvm_chunks_as_jax_does(tmp_path):
    path, params, x, y = _data_file(tmp_path, "libsvm")
    with pytest.raises(Exception) as ours:
        list(tparser.parse_file_chunks(path))
    with pytest.raises(Exception) as want:
        list(jparser.parse_file_chunks(path))
    assert str(ours.value) == str(want.value)
    assert str(ours.value).startswith(
        "two_round loading supports delimited files only; ")
    # a Dataset under two_round parses a libsvm file in one shot
    ds = tlgb.Dataset(path, params=dict(params, two_round=True),
                      device="cpu").construct()
    assert_same_binned(ds._binned, tlgb.Dataset(
        path, params=params, device="cpu").construct()._binned)


# ---------------------------------------------------------------- binary
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_binary_cache_loads_in_either_package(tmp_path, writer):
    x, y = _small_sparse()
    group = np.full(len(y) // 100, 100)
    weight = np.random.RandomState(1).uniform(0.5, 1.5, len(y))
    init = np.random.RandomState(2).randn(len(y))
    kw = dict(label=y, group=group, weight=weight, init_score=init)
    path = str(tmp_path / "cache.bin")
    if writer == "port":
        src = tlgb.Dataset(x, params=PARAMS, device="cpu", **kw)
        assert src.save_binary(path) is src
        loaded = jlgb.Dataset(path).construct()._binned
    else:
        src = jlgb.Dataset(x, params=PARAMS, **kw).save_binary(path)
        loaded = tlgb.Dataset(path, device="cpu").construct()._binned
    assert_same_binned(loaded, src._binned)
    assert loaded.feature_names == src._binned.feature_names
    assert loaded.bin_params == src._binned.bin_params
    # the loaded cache trains the same trees as the in-memory data
    params = dict(PARAMS, objective="binary", num_leaves=15)
    if writer == "jax":
        models = [tlgb.train(params, ds, num_boost_round=2,
                             device="cpu").models
                  for ds in (tlgb.Dataset(path, device="cpu"),
                             tlgb.Dataset(x, device="cpu", **kw))]
        for a, b in zip(*models):
            np.testing.assert_array_equal(a.split_feature, b.split_feature)
            np.testing.assert_array_equal(a.leaf_value, b.leaf_value)


# ---------------------------------------------------------------- pack
def test_tree_to_host_moves_every_field_bit_for_bit():
    """The port's one transfer a tree packs every field into float64:
    int32 fields, bitset words up to 2**32 - 1 and float32 values survive
    it exactly."""
    leaves = 9
    tree = tgrow.empty_tree(leaves, torch.device("cpu"))
    r = np.random.RandomState(4)
    fields = {}
    for name, value in tree._asdict().items():
        if value.dtype == torch.bool:
            new = torch.as_tensor(r.rand(*value.shape) < 0.5)
        elif value.dtype.is_floating_point:
            new = torch.as_tensor(r.randn(*value.shape).astype(np.float32)
                                  * 10.0 ** r.randint(-30, 30, value.shape))
        else:
            new = torch.as_tensor(r.randint(-2**31, 2**31 - 1, value.shape,
                                            dtype=np.int64))
        fields[name] = new.to(value.dtype)
    words = fields["cat_bitset"]
    words[:] = torch.as_tensor(r.randint(0, 2**32, tuple(words.shape),
                                         dtype=np.int64))
    words[0, 0] = 2**32 - 1
    host = tgrow.tree_to_host(type(tree)(**fields), leaves)
    for name, value in fields.items():
        got = getattr(host, name)
        want = value.numpy()
        if name == "cat_bitset":
            assert got.dtype == np.uint32 and int(got[0, 0]) == 2**32 - 1
            np.testing.assert_array_equal(got.astype(np.int64), want)
        elif want.dtype == np.float32:
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
        else:
            np.testing.assert_array_equal(got.astype(np.int64),
                                          want.astype(np.int64))
