"""The port's threefry chain (``lightgbm_tpu_torch/utils/prng.py``) against
``jax.random``: keys from ``PRNGKey``, ``fold_in`` and ``split``, and f32
``uniform`` draws, bit for bit, over several seeds (negative and 32-bit
ones too) and lengths (odd ones too). These are the draws of stochastic
rounding, ``fold_in(PRNGKey(seed), iteration * K + k)`` split into the
grad and hess keys (ROADMAP C3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.utils import prng

LENGTHS = (1, 2, 7, 1000, 4097)


def _key(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", [0, 7, -1, 2 ** 31 - 1, 3_000_000_000])
def test_threefry_matches_jax_random(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.prng_key(seed)
    assert tk == _key(jk)
    for data in (0, 3, 1000):
        jf, tf = jax.random.fold_in(jk, data), prng.fold_in(tk, data)
        assert tf == _key(jf)
        jkeys, tkeys = jax.random.split(jf), prng.split(tf)
        assert list(tkeys) == [_key(k) for k in jkeys]
        for jkey, tkey in zip(jkeys, tkeys):
            for n in LENGTHS:
                ju = np.asarray(jax.random.uniform(jkey, (n,), jnp.float32))
                tu = prng.uniform(tkey, n)
                assert tu.dtype == torch.float32 and tu.shape == (n,)
                np.testing.assert_array_equal(tu.numpy().view(np.int32),
                                              ju.view(np.int32))


def test_split_into_more_keys_and_empty_draw():
    jk = jax.random.fold_in(jax.random.PRNGKey(11), 5)
    tk = prng.fold_in(prng.prng_key(11), 5)
    assert list(prng.split(tk, 5)) == [_key(k)
                                       for k in jax.random.split(jk, 5)]
    assert prng.uniform(tk, 0).shape == (0,)


def test_seed_outside_32_bits_is_refused():
    with pytest.raises(ValueError):
        prng.prng_key(1 << 32)
    with pytest.raises(ValueError):
        prng.prng_key(-(1 << 31) - 1)
