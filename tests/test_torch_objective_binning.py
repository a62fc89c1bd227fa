"""The port's binary objective and host binning against the JAX package's.

Gradients, hessians and the boost-from-average init score agree within
1e-6. Binning is a copy of the JAX package's code path, so the bin matrix
is byte-equal and every mapper's upper bounds are equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JBinned
from lightgbm_tpu.objectives import create_objective as j_objective
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import BinnedDataset as TBinned
from lightgbm_tpu_torch.objectives import create_objective as t_objective


@pytest.mark.parametrize("extra", [
    {}, {"is_unbalance": True}, {"scale_pos_weight": 3.0, "sigmoid": 1.7},
    {"weighted": True}])
def test_binary_gradients_match(extra):
    r = np.random.RandomState(4)
    n = 5000
    label = (r.rand(n) < 0.3).astype(np.float64)
    weight = r.rand(n) + 0.5 if extra.pop("weighted", False) else None
    score = (r.randn(n) * 2).astype(np.float32)
    params = dict(objective="binary", **extra)
    jd = JBinned.from_matrix(r.randn(n, 2), JConfig(params), label=label,
                             weight=weight)
    td = TBinned.from_matrix(r.randn(n, 2), TConfig(params), label=label,
                             weight=weight)
    jo, to = j_objective(JConfig(params)), t_objective(TConfig(params))
    jo.init(jd.metadata, n)
    to.init(td.metadata, torch.device("cpu"))
    jg, jh = jo.get_gradients(jnp.asarray(score))
    tg, tw = to.get_gradients(torch.as_tensor(score))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-6)
    assert abs(to.boost_from_score() - jo.boost_from_score()) <= 1e-6
    np.testing.assert_allclose(to.convert_output(score),
                               np.asarray(jo.convert_output(
                                   jnp.asarray(score))), rtol=1e-6)


def _matrix():
    r = np.random.RandomState(12)
    n = 2000
    x = r.randn(n, 7)
    x[r.rand(n) < 0.1, 1] = np.nan          # NaN missing
    x[r.rand(n) < 0.4, 2] = 0.0             # many zeros
    x[:, 3] = 5.0                           # trivial (constant)
    x[:, 4] = np.round(x[:, 4] * 2)         # few distinct values
    x[:, 5] = np.exp(x[:, 5] * 3)           # heavy tail
    x[r.rand(n) < 0.05, 6] = np.nan
    return x


@pytest.mark.parametrize("params", [
    {"max_bin": 63},
    {"max_bin": 255, "bin_construct_sample_cnt": 500},
    {"max_bin": 15, "zero_as_missing": True, "enable_nbit_packing": False},
    {"max_bin": 32, "use_missing": False, "min_data_in_bin": 10},
])
def test_binning_is_byte_equal(params):
    x = _matrix()
    jd = JBinned.from_matrix(x, JConfig(params))
    td = TBinned.from_matrix(x, TConfig(params))
    assert td.used_features == jd.used_features
    np.testing.assert_array_equal(td.X_binned, jd.X_binned)
    assert td.X_binned.dtype == np.uint8
    for jm, tm in zip(jd.bin_mappers, td.bin_mappers):
        np.testing.assert_array_equal(tm.bin_upper_bound, jm.bin_upper_bound)
        assert (tm.num_bin, tm.missing_type, tm.default_bin, tm.is_trivial) \
            == (jm.num_bin, jm.missing_type, jm.default_bin, jm.is_trivial)
    assert td.get_feature_infos() == jd.get_feature_infos()
