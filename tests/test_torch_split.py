"""The port's split search against the JAX package's on the same histograms.

Histograms come from random rows (so counts and hessians are consistent
with the leaf totals) over features of every missing type. Feature,
threshold and default_left must be equal; gain and outputs agree to 1e-5
relative (both sides compute in float32, with prefix sums in another
order).
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.core import split as js
from lightgbm_tpu_torch.core import split as ts
from lightgbm_tpu_torch.core.histogram import hist_plain


def _case(seed, missing_types, num_bins=32, n=3000):
    r = np.random.RandomState(seed)
    f = len(missing_types)
    num_bin = r.randint(3, num_bins + 1, f)
    num_bin[0] = 2                          # a two-bin feature
    default_bin = np.array([r.randint(0, nb) for nb in num_bin])
    xb = np.stack([r.randint(0, nb, n) for nb in num_bin], 1).astype(np.uint8)
    g = r.randn(n).astype(np.float32)
    h = (r.rand(n) * 0.3 + 0.01).astype(np.float32)
    # a skewed target makes some splits clearly better than others
    g += (xb[:, 1] < num_bin[1] // 3) * 0.8
    # centred, as boosting gradients are: a large leaf total would make the
    # shifted gain a difference of large f32 numbers
    g -= g.mean()
    vals = np.stack([g, h, np.ones(n, np.float32)], 1)
    hist = hist_plain(torch.as_tensor(xb), torch.as_tensor(vals),
                      num_bins).numpy()
    totals = vals.sum(0)
    meta = dict(num_bin=num_bin.astype(np.int32),
                missing_type=np.asarray(missing_types, np.int32),
                default_bin=default_bin.astype(np.int32),
                penalty=r.choice([1.0, 0.7], f).astype(np.float32))
    return hist, totals, meta


def _jax_split(hist, totals, meta, fmask, **sp):
    f = len(fmask)
    jmeta = js.FeatureMeta(
        num_bin=jnp.asarray(meta["num_bin"]),
        missing_type=jnp.asarray(meta["missing_type"]),
        default_bin=jnp.asarray(meta["default_bin"]),
        is_categorical=jnp.zeros((f,), bool),
        penalty=jnp.asarray(meta["penalty"]),
        monotone=jnp.zeros((f,), jnp.int32))
    params = js.SplitParams(max_cat_threshold=32, cat_smooth=10.0,
                            cat_l2=10.0, max_cat_to_onehot=4,
                            min_data_per_group=100, **sp)
    return js.find_best_split(
        jnp.asarray(hist), jmeta, params, jnp.float32(totals[0]),
        jnp.float32(totals[1]), jnp.float32(totals[2]), jnp.asarray(fmask))


def _torch_split(hist, totals, meta, fmask, **sp):
    tmeta = ts.FeatureMeta(
        num_bin=torch.as_tensor(meta["num_bin"], dtype=torch.int64),
        missing_type=torch.as_tensor(meta["missing_type"], dtype=torch.int64),
        default_bin=torch.as_tensor(meta["default_bin"], dtype=torch.int64),
        penalty=torch.as_tensor(meta["penalty"]))
    t = torch.as_tensor(totals)
    return ts.find_best_split(torch.as_tensor(hist), tmeta,
                              ts.SplitParams(**sp), t[0], t[1], t[2],
                              torch.as_tensor(fmask))


SPLIT_PARAMS = [
    dict(lambda_l1=0.0, lambda_l2=0.0, max_delta_step=0.0,
         min_data_in_leaf=20, min_sum_hessian_in_leaf=1e-3,
         min_gain_to_split=0.0),
    dict(lambda_l1=0.5, lambda_l2=2.0, max_delta_step=0.3,
         min_data_in_leaf=50, min_sum_hessian_in_leaf=1.0,
         min_gain_to_split=0.1),
]

MISSING = {"none": [0] * 8, "zero": [1] * 8, "nan": [2] * 8,
           "mixed": [0, 1, 2, 2, 1, 0, 2, 1]}


@pytest.mark.parametrize("sp", range(len(SPLIT_PARAMS)))
@pytest.mark.parametrize("missing", sorted(MISSING))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_best_split_matches_jax(seed, missing, sp):
    hist, totals, meta = _case(seed, MISSING[missing])
    fmask = np.ones(len(meta["num_bin"]), bool)
    fmask[3] = seed != 1                    # feature_fraction drops one
    kw = SPLIT_PARAMS[sp]
    ref = _jax_split(hist, totals, meta, fmask, **kw)
    ours = _torch_split(hist, totals, meta, fmask, **kw)
    assert int(ours.feature) == int(ref.feature)
    assert int(ours.threshold) == int(ref.threshold)
    assert bool(ours.default_left) == bool(ref.default_left)
    for name in ("gain", "left_output", "right_output", "left_sum_grad",
                 "left_sum_hess", "left_count", "right_count"):
        np.testing.assert_allclose(float(getattr(ours, name)),
                                   float(getattr(ref, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_batched_search_equals_single():
    """grow_tree searches both children in one call over a leading batch
    dim; each row must equal its own single search."""
    cases = [_case(s, MISSING["mixed"]) for s in (3, 4)]
    meta = cases[0][2]
    fmask = np.ones(8, bool)
    kw = SPLIT_PARAMS[0]
    hist2 = np.stack([c[0] for c in cases])
    tot2 = np.stack([c[1] for c in cases])
    tmeta = ts.FeatureMeta(
        *(torch.as_tensor(meta[k], dtype=torch.int64)
          for k in ("num_bin", "missing_type", "default_bin")),
        penalty=torch.as_tensor(meta["penalty"]))
    t2 = torch.as_tensor(tot2)
    both = ts.find_best_split(torch.as_tensor(hist2), tmeta,
                              ts.SplitParams(**kw), t2[:, 0], t2[:, 1],
                              t2[:, 2], torch.as_tensor(fmask))
    for i in range(2):
        one = _torch_split(hist2[i], tot2[i], meta, fmask, **kw)
        for a, b in zip(both, one):
            assert torch.equal(a[i], b), a


def test_unsplittable_leaf_has_minus_inf_gain():
    hist, totals, meta = _case(0, MISSING["none"])
    kw = dict(SPLIT_PARAMS[0], min_data_in_leaf=10_000)
    ours = _torch_split(hist, totals, meta, np.ones(8, bool), **kw)
    assert float(ours.gain) == float("-inf")
