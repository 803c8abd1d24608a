"""Verlet candidate reuse of the top-K supercell path against the JAX
package on the CPU: ``topk_tables_verlet`` with few rebuilds, with a
rebuild every frame (thrash), from a JAX carry, for HydroniumRates, and its
chunk invariance. The cases come from ``test_torch_supercell.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu.ops import topk_sweep as jts
from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch.engine import fused
from cmdlmc_tpu_torch.engine.lattice import init_replicas
from cmdlmc_tpu_torch.ops import topk_sweep as ts

from test_torch_supercell import N, _models, _walk
from test_torch_slice import jax_kernels_run_to_end  # noqa: F401  (runs by itself)

torch.set_num_threads(1)


def _verlet_pair(jm, tm, pos, law, jcarry, frame0):
    want = jts.topk_tables_verlet(jm, jnp.asarray(pos), 8, law, jcarry, frame0)
    tcarry = None if jcarry is None else convert.neighbor_carry_from_fields(jcarry, tm.k)
    got = ts.topk_tables_verlet(tm, torch.from_numpy(pos), law, tcarry, frame0)
    return got, want


def _verlet_matches(got, want, k, carried):
    topd, topi, resc, carry, rebuilt = got
    jd, ji, jr, mode = (np.asarray(want[q]) for q in (0, 1, 2, 6))
    jc = want[7]
    np.testing.assert_array_equal(topi.numpy(), ji[:, :k].astype(np.int32))
    np.testing.assert_allclose(topd.numpy(), jd[:, :k], rtol=3e-7, atol=0)
    np.testing.assert_allclose(resc.numpy(), jr[:, :k], rtol=2e-5, atol=1e-12)
    # the JAX package marks rebuild frames with mode 2, and frame 0 always
    np.testing.assert_array_equal(rebuilt[1:], mode[1:] == 2)
    assert rebuilt[0] or carried
    np.testing.assert_array_equal(carry.ref_pos.numpy(), np.asarray(jc.ref_pos))
    np.testing.assert_array_equal(carry.ref_topi.numpy(),
                                  np.asarray(jc.ref_topi)[:k].astype(np.int32))
    np.testing.assert_array_equal(carry.ref_valid.numpy(), np.asarray(jc.ref_valid)[:k] > 0.5)
    assert np.float32(carry.thresh) == np.float32(jc.thresh)
    assert (carry.last_rebuild, carry.thrash_until) == (float(jc.last_rebuild),
                                                       float(jc.thrash_until))
    return rebuilt


@pytest.fixture(scope="module")
def topk_models():
    return _models("topk")


@pytest.fixture(scope="module")
def few_rebuilds(topk_models):
    """48 frames of a walk; the JAX package's tables and carry for the first
    24 (from frame 100) and the port's."""
    jm, tm = topk_models
    pos = _walk(48, 0.015, 3)
    return pos, _verlet_pair(jm, tm, pos[:24], True, None, 100)


def test_verlet_few_rebuilds_matches_jax(few_rebuilds):
    """Four rebuilds, none within the thrash gap: the JAX package takes its
    device-resident schedule."""
    _, (got, want) = few_rebuilds
    rebuilt = _verlet_matches(got, want, 8, carried=False)
    assert list(np.nonzero(rebuilt)[0]) == [0, 5, 10, 19]


def test_verlet_thrash_matches_jax(topk_models):
    """Drift past the threshold every frame: the thrash guard rebuilds every
    frame and opens a window 128 frames past its trigger (the JAX package's
    host loop)."""
    jm, tm = topk_models
    got, want = _verlet_pair(jm, tm, _walk(6, 0.1, 3), True, None, 100)
    rebuilt = _verlet_matches(got, want, 8, carried=False)
    assert rebuilt.all() and got[3].thrash_until == 101 + ts._THRASH_SPAN


def test_verlet_from_a_jax_carry_matches_jax(topk_models, few_rebuilds):
    """The second of two blocks, started from the carry the JAX package left
    after the first (convert.neighbor_carry_from_fields)."""
    jm, tm = topk_models
    pos, (_, first) = few_rebuilds
    got, want = _verlet_pair(jm, tm, pos[24:], True, first[7], 124)
    rebuilt = _verlet_matches(got, want, 8, carried=True)
    assert 0 < rebuilt.sum() < 24


def test_verlet_hydronium_matches_jax():
    """HydroniumRates k=4 (ReLU transformation, the blend, so the tables
    carry rescaled distances) under nbr_reuse = on."""
    jm, tm = _models("hydronium")
    got, want = _verlet_pair(jm, tm, _walk(16, 0.015, 6), False, None, 0)
    rebuilt = _verlet_matches(got, want, 4, carried=False)
    assert 1 < rebuilt.sum() < 16


@pytest.mark.parametrize("seed", [8, 9], ids=["rebuild", "thrash-window"])
def test_verlet_chunk_invariance(topk_models, seed):
    """run_block_fused with nbr_reuse on over 9 frames in one block and in
    blocks of 3 with the carry threaded: the same integer state and carry,
    disp_base to rtol 1e-6. Seed 8 rebuilds inside the last block; seed 9
    opens a thrash window at frame 4 that the last block resumes."""
    _, tm = topk_models
    pos = torch.from_numpy(_walk(9, 0.015, seed))
    tens = init_replicas(torch.Generator().manual_seed(1), 16, N, 24, pos[0])
    kw = dict(dt=0.5, seed=3, tile=8, nbr_reuse=True)
    whole = fused.run_block_fused(tm, tm.cell, tens, pos, 0, **kw)
    part = tens
    for s in range(0, 9, 3):
        part = fused.run_block_fused(tm, tm.cell, part, pos[s:s + 3], s, **kw)
    a, b = whole.replicas, part.replicas
    for x, y in ((a.occ, b.occ), (a.site_of_proton, b.site_of_proton),
                 (a.clock.event_count, b.clock.event_count)):
        assert torch.equal(x, y)
    torch.testing.assert_close(a.disp_base, b.disp_base, rtol=1e-6, atol=0)
    ca, cb = whole.nbr_carry, part.nbr_carry
    assert torch.equal(ca.ref_pos, cb.ref_pos) and torch.equal(ca.ref_topi, cb.ref_topi)
    assert (ca.thresh, ca.last_rebuild, ca.thrash_until) == (
        cb.thresh, cb.last_rebuild, cb.thrash_until)
    assert int(a.clock.event_count.sum()) > 0
