"""The port's threefry2x32 (``utils/threefry.py``) against ``jax.random``
on the CPU: key data, split, fold_in, bits, uniform and bernoulli bit for
bit; gumbel within one float32 epsilon of max(1, |g|). XLA's float32 log
is not correctly rounded (torch's is, nearly always), and near g = 0 the
double log turns a one-ulp difference in the inner log into an absolute
one of about an epsilon, so gumbel is held to that, not to its bits.
"""

import jax
import numpy as np
import pytest
import torch

from fraud_detection_tpu_torch.utils import threefry

SEEDS = [0, 42, 2 ** 31 + 5]
SHAPES = [(1,), (7,), (3, 5), (8, 1280)]
F32_EPS = float(np.finfo(np.float32).eps)


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    if want.dtype == np.float32:          # compare float32 bit patterns
        got, want = got.numpy().view(np.int32), want.view(np.int32)
    else:
        got = got.numpy().astype(want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_equals_jax_random(seed, shape):
    # the port reproduces the partitionable streams; a jax whose default
    # changed would draw other bits, and must fail here, not drift
    assert jax.config.jax_threefry_partitionable
    jkey, key = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    _equal(key, jax.random.key_data(jkey))
    _equal(threefry.split(key, shape), jax.random.split(jkey, shape))
    _equal(threefry.split(key), jax.random.split(jkey))
    for data in (0, 8, shape[-1], 2 ** 32 - 1):
        _equal(threefry.fold_in(key, data), jax.random.fold_in(jkey, data))
    _equal(threefry.random_bits(key, shape), jax.random.bits(jkey, shape))
    _equal(threefry.uniform(key, shape), jax.random.uniform(jkey, shape))
    _equal(threefry.uniform(key, shape, -2.5, 3.0),
           jax.random.uniform(jkey, shape, minval=-2.5, maxval=3.0))
    for p in (0.5, np.sqrt(np.float32(10_000)) / np.float32(10_000)):
        _equal(threefry.bernoulli(key, p, shape),
               jax.random.bernoulli(jkey, np.float32(p), shape))
    want = np.asarray(jax.random.gumbel(jkey, shape), np.float64)
    got = threefry.gumbel(key, shape).numpy().astype(np.float64)
    assert np.all(np.abs(got - want) <= F32_EPS * np.maximum(1.0, np.abs(want)))

    # a batch of keys draws what each key draws alone (the forest's
    # per-tree masks and the decoder's per-row noise)
    jkeys = jax.random.split(jkey, 3)
    keys = threefry.split(key, 3)
    _equal(threefry.uniform(keys, shape),
           jax.vmap(lambda k: jax.random.uniform(k, shape))(jkeys))
    _equal(threefry.fold_in(key, torch.arange(5)),
           jax.vmap(lambda d: jax.random.fold_in(jkey, d))(np.arange(5)))


def test_threefry_refuses_other_dtypes():
    with pytest.raises(ValueError, match="float32"):
        threefry.gumbel(threefry.prng_key(0), (3,), torch.float64)
