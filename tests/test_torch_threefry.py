"""``ops/threefry.py`` against ``jax.random`` (JAX 0.9, threefry2x32 in its
partitionable form) on the CPU: the hash, ``key``, ``fold_in``, ``split``,
32-bit ``bits`` and ``uniform`` on [0, 1) bit for bit (on other bounds
within half an ulp of the scaled value: XLA fuses the scaling into a
multiply-add); ``exponential``
within 2 ulp
and ``gumbel`` within 2 ulp plus 2 float32 epsilons (torch's and XLA's
``log``/``log1p`` differ by an ulp, and the Gumbel's outer log carries the
inner one's absolute error); ``categorical`` equal. Keys and data come from
a numpy seed. ``FIXED`` pins JAX's own values, which ``chip_smoke.py``
(``phase_threefry``) holds kernel 2 to on the card."""

import jax
import jax.extend.random as jex
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch.ops import threefry as tf

torch.set_num_threads(1)

# jax.random values (JAX 0.9.0, the CPU): key(7); fold_in(key(7), 1);
# split(fold_in(key(7), 1), 3); bits(fold_in(key(7), 1), (), uint32)
FIXED = {
    "key7": [0, 7],
    "fold_in1": [195045567, 4062205631],
    "split3": [[1294055386, 3790878917], [1610437339, 2357010365],
               [3281109246, 2806878594]],
    "bits": 2899676959,
}


def _keys(n, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 2**32, size=(n, 2), dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _jkeys(data):
    return jax.random.wrap_key_data(jnp.asarray(data))


def test_fixed_values():
    k = tf.key(7)
    f = tf.fold_in(k, 1)
    assert k.tolist() == FIXED["key7"]
    assert f.tolist() == FIXED["fold_in1"]
    assert tf.split(f, 3).tolist() == FIXED["split3"]
    assert int(tf.random_bits(f)) == FIXED["bits"]
    jf = jax.random.fold_in(jax.random.key(7), 1)
    assert np.asarray(jax.random.key_data(jf)).tolist() == FIXED["fold_in1"]
    assert np.asarray(jax.random.key_data(jax.random.split(jf, 3))).tolist() == FIXED["split3"]
    assert int(jax.random.bits(jf, (), jnp.uint32)) == FIXED["bits"]


def test_hash_matches_jax():
    keys, counts = _keys(4096, 1), _keys(4096, 2)
    want = jex.threefry_2x32(jnp.asarray(keys[0]), jnp.asarray(counts[:, 0]))
    # JAX's hash of a flat count array pairs the halves: (x[i], x[i + M/2])
    half = 2048
    got = tf.threefry2x32_reference(_t(keys[0]), torch.stack(
        [_t(counts[:half, 0]), _t(counts[half:, 0])], dim=-1))
    np.testing.assert_array_equal(np.concatenate([got[:, 0].numpy(), got[:, 1].numpy()]),
                                  np.asarray(want))
    with pytest.raises(ValueError, match="device"):
        tf.keyed_hash(_t(keys).to("meta"), 1)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, -1, 2**32 + 5])
def test_key_matches_jax(seed):
    assert tf.key(seed).tolist() == np.asarray(jax.random.key_data(
        jax.random.key(seed))).tolist()


def test_fold_in_and_split_match_jax():
    keys = _keys(64, 3)
    data = np.random.RandomState(4).randint(0, 2**32, size=64, dtype=np.uint64).astype(np.uint32)
    want = jax.vmap(jax.random.fold_in)(_jkeys(keys), jnp.asarray(data))
    got = tf.fold_in(_t(keys), _t(data))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.random.key_data(want)))
    want = jax.vmap(lambda k: jax.random.split(k, 5))(want)
    np.testing.assert_array_equal(tf.split(got, 5).numpy(),
                                  np.asarray(jax.random.key_data(want)))
    np.testing.assert_array_equal(convert.keys_from_numpy(keys).numpy(), keys)
    np.testing.assert_array_equal(tf.key_data(_t(keys)), keys)


def test_bits_and_uniform_match_jax():
    keys = _keys(256, 5)
    jk = _jkeys(keys)
    for shape in ((), (3,), (2, 5)):
        want = jax.vmap(lambda k, s=shape: jax.random.bits(k, s, jnp.uint32))(jk)
        np.testing.assert_array_equal(tf.random_bits(_t(keys), shape).numpy(),
                                      np.asarray(want))
        want = jax.vmap(lambda k, s=shape: jax.random.uniform(k, s))(jk)
        got = tf.uniform(_t(keys), shape)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # other bounds: XLA fuses f (maxval - minval) + minval into a
    # multiply-add, torch rounds the product first: half an ulp of the
    # product apart at most
    want = jax.vmap(lambda k: jax.random.uniform(k, (4,), minval=-2.0, maxval=3.5))(jk)
    np.testing.assert_allclose(tf.uniform(_t(keys), (4,), -2.0, 3.5).numpy(), want,
                               rtol=0, atol=np.spacing(np.float32(5.5)))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return np.abs(a.astype(np.float64) - b.astype(np.float64)) / scale


def test_exponential_and_gumbel_match_jax():
    keys = _keys(20000, 6)
    jk = _jkeys(keys)
    want = np.asarray(jax.vmap(jax.random.exponential)(jk))
    got = tf.exponential(_t(keys)).numpy()
    assert got.dtype == np.float32 and _ulps(got, want).max() <= 2
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (3,)))(jk))
    got = tf.gumbel(_t(keys), (3,)).numpy()
    eps = np.finfo(np.float32).eps
    assert np.all(np.abs(got - want) <= 2 * np.spacing(np.abs(want)) + 2 * eps)


def test_categorical_matches_jax():
    keys = _keys(4000, 7)
    rs = np.random.RandomState(8)
    rates = rs.uniform(0.0, 1.0, size=(4000, 3)).astype(np.float32)
    rates[rs.rand(4000, 3) < 0.2] = 0.0  # zero rates: log -> -inf, never drawn
    with np.errstate(divide="ignore"):
        logits = np.log(rates)
    want = np.asarray(jax.vmap(jax.random.categorical)(_jkeys(keys), jnp.asarray(logits)))
    got = tf.categorical(_t(keys), torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    drawn = rates[np.arange(4000), got]
    assert np.all(drawn[rates.max(axis=1) > 0] > 0)
