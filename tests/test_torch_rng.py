"""The port's counter hash (cmdlmc_tpu_torch/ops/rng.py) against the JAX
package's (cmdlmc_tpu/ops/kmc_sweep.py): keys and uniforms must be bit-exact,
including seeds and ids that wrap negative in int32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu.ops.kmc_sweep import _mix_key, _u01, _u01_t
from cmdlmc_tpu_torch.ops import rng

from test_torch_slice import jax_kernels_run_to_end  # noqa: F401  (runs by itself)

torch.set_num_threads(1)


def _tuples():
    r = np.random.RandomState(7)
    out = [(0, 0, 0, 0, 1), (1, 3, 17, 2, 3), (2**31 - 1, 2**31 - 1, 2**31 - 1, 7, 2),
           (-1, -5, -123456, 3, 1), (2**32 + 5, 0, 2**24 + 3, 0, 3)]
    for _ in range(40):
        out.append((int(r.randint(-2**31, 2**31)), int(r.randint(-2**31, 2**31)),
                    int(r.randint(-2**31, 2**31)), int(r.randint(0, 16)),
                    int(r.randint(1, 4))))
    return out


def _jax_key(seed, tile, frame, ev, salt):
    return _mix_key(seed, jnp.int32(rng._i32(tile)), jnp.int32(rng._i32(frame)),
                    ev, salt)


def test_mix_key_bit_exact():
    tuples = _tuples()
    want = np.array([np.asarray(_jax_key(*t)).astype(np.uint32) for t in tuples])
    got = np.array([int(rng.mix_key(*t)) for t in tuples], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)


def test_mix_key_vectorized_over_tiles():
    tiles = np.arange(-70, 70, 3)
    want = np.array([np.asarray(_jax_key(11, int(t), 5, 1, 2)).astype(np.uint32)
                     for t in tiles])
    got = rng.mix_key(11, torch.as_tensor(tiles), 5, 1, 2).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 1), (4, 32), (128, 144), (3, 1), (8, 1152)])
def test_u01_bit_exact(shape):
    for t in _tuples()[:12]:
        key = _jax_key(*t)
        want = np.asarray(_u01(key, shape))
        got = rng.u01(rng.mix_key(*t), shape).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        assert got.min() > 0 and got.max() < 1


@pytest.mark.parametrize("shape", [(144, 128), (32, 4), (1, 8)])
def test_u01_t_bit_exact(shape):
    for t in _tuples()[:6]:
        want = np.asarray(_u01_t(_jax_key(*t), shape))
        got = rng.u01_t(rng.mix_key(*t), shape).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_counter_form_matches_tile_layout():
    """The kernel's per-replica counter rin * n + slot draws what the JAX
    kernel's [TR, n] tile draws."""
    key = rng.mix_key(5, 2, 9, 0, 1)
    tile, n = 8, 20
    rin = torch.arange(tile)[:, None]
    got = rng.u01_counter(key, rin * n + torch.arange(n))
    np.testing.assert_array_equal(got.numpy(), rng.u01(key, (tile, n)).numpy())
