"""The water tables and the transform against the JAX package on the CPU.

* The tables (K5's plain version with no cutoff) against B4's table
  arithmetic written out in jnp (``cmdlmc_tpu/ops/water_sweep.py:319-360``):
  indices exact, distances bit for bit, a tie included.
* The transform against B4's ``_apply_transform`` for each kind, bit for
  bit, with a table that repeats x points.

The cases come from ``test_torch_water.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu.core.cell import Cell as JCell
from cmdlmc_tpu.models import water as jwm
from cmdlmc_tpu.ops import water_sweep as jws
from cmdlmc_tpu.rates.laws import Fermi as JFermi
from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch.models import water as twm
from cmdlmc_tpu_torch.ops import water_sweep as ws
from test_torch_water import BOX, INTERP_X, N, _f, _frames, _transform
from test_torch_slice import jax_kernels_run_to_end  # noqa: F401  (runs by itself)

torch.set_num_threads(1)


def test_tables_match_b4_arithmetic():
    """K5's plain version with no cutoff against B4's per-frame table build
    written out in jnp: rows minimg1(p_i - p_j), acc over the dims from 0,
    sqrt, self at 1e9, K passes of min and first argmin with the pick masked
    (indices exact, distances bit for bit)."""
    _, pos = _frames(n_frames=3, seed=4)
    # two sites at the same distance from a third: a tie
    pos[:, 5] = pos[:, 4] + np.float32([1.0, 0.0, 0.0])
    pos[:, 6] = pos[:, 4] - np.float32([1.0, 0.0, 0.0])
    for k in (3, 4):
        topd, topi, _ = ws.water_tables(torch.from_numpy(pos), (BOX,) * 3, k,
                                        ws.T_NONE, np.zeros(5, np.float32))
        for f in range(pos.shape[0]):
            post = jnp.asarray(pos[f].T)  # [3, N]
            acc = jnp.zeros((N, N), jnp.float32)
            for dim in range(3):
                delta = post[dim][:, None] - post[dim][None, :]
                dd = delta - _f(BOX) * jnp.round(delta / _f(BOX))
                acc = acc + dd * dd
            d = jnp.where(jnp.eye(N, dtype=bool), _f(1.0e9), jnp.sqrt(acc))
            lane = jnp.arange(N)[None, :]
            for kk in range(k):
                vals = jnp.min(d, axis=1)
                idx = jnp.argmin(d, axis=1)
                np.testing.assert_array_equal(topi[f, kk].numpy(), np.asarray(idx))
                np.testing.assert_array_equal(topd[f, kk].numpy(), np.asarray(vals))
                d = jnp.where(lane == idx[:, None], _f(1.0e9), d)


@pytest.mark.parametrize("tname", ["none", "linear", "ramp", "interp"])
def test_transform_matches_b4(tname):
    """apply_transform against B4's _apply_transform, bit for bit, on
    distances that hit every segment, both bounds, the repeated points and
    the table's ends exactly."""
    rs = np.random.RandomState(7)
    d = np.concatenate([rs.uniform(0.5, 12.0, 4000), INTERP_X, [0.0, 1.2, 2.0, 3.0, 10.0],
                        np.nextafter(INTERP_X, 0), np.nextafter(INTERP_X, 9)]
                       ).astype(np.float32).reshape(1, -1)
    jt = _transform(tname)
    jm = jwm.WaterModel(cell=JCell.cubic([BOX] * 3), law=JFermi(a=_f(0.1), b=_f(2.3), c=_f(0.1)),
                        transform=jt, d_oh=_f(0.0))
    tkind, tparams, tx, ty = jwm._transform_spec(jm)
    m = 0 if tx is None else tx.shape[0]
    tp = [tparams[i] for i in range(5)]
    want = jws._apply_transform(tkind, jnp.asarray(d), tp,
                                tx=None if tx is None else [tx[i] for i in range(m)],
                                ty=None if ty is None else [ty[i] for i in range(m)],
                                m_interp=m)
    tm = convert.water_model_from_fields(jm)
    tkind2, tparams2, tx2, ty2 = twm._transform_spec(tm)
    assert tkind2 == tkind
    got = ws.apply_transform(tkind2, torch.from_numpy(d), tparams2, tx2, ty2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
