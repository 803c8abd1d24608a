"""The angle family of the port against the JAX package on the CPU: the PBC
angle at a vertex, the static O -> P grouping (ties, shared donors and a
donor no P adopts), and the AngleTopology rate matrix W of stage 1.
Tolerances: angles 1e-6 rad (float32 arccos, an ulp apart in torch and
XLA); W to rtol 1e-6 with the same zero pattern (exp an ulp apart)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu.core import cell as jcell
from cmdlmc_tpu.rates import laws as jlaws
from cmdlmc_tpu.topo import models as jmodels
from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch.core import cell as tcell
from cmdlmc_tpu_torch.ops.kmc_sweep_streamed import dense_tables
from cmdlmc_tpu_torch.topo import models as tmodels

from test_torch_slice import jax_kernels_run_to_end  # noqa: F401  (runs by itself)

torch.set_num_threads(1)

BOX = 12.0


def _cells():
    return jcell.Cell.cubic([BOX] * 3), tcell.Cell.cubic([BOX] * 3)


def test_angle_matches_jax():
    jc, tc = _cells()
    rng = np.random.RandomState(7)
    r1, r2, r3 = (rng.uniform(-6, 18, size=(64, 3)).astype(np.float32)
                  for _ in range(3))
    want = np.asarray(jcell.angle(jc, *(jnp.asarray(r) for r in (r1, r2, r3))))
    got = tcell.angle(tc, *(torch.from_numpy(r) for r in (r1, r2, r3))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # a straight and a right angle, across the boundary
    a = torch.tensor([[11.5, 0.0, 0.0], [0.5, 11.0, 0.0]])
    b = torch.tensor([[0.5, 0.0, 0.0], [0.5, 0.0, 0.0]])
    c = torch.tensor([[1.5, 0.0, 0.0], [1.5, 0.0, 0.0]])
    np.testing.assert_allclose(tcell.angle(tc, a, b, c).numpy(),
                               [np.pi, np.pi / 2], atol=1e-6)


def _groups(extras, donors, group_size):
    jc, tc = _cells()
    want = np.asarray(jmodels.determine_groups(
        jc, jnp.asarray(extras), jnp.asarray(donors), group_size))
    got = tmodels.determine_groups(tc, torch.from_numpy(extras),
                                   torch.from_numpy(donors), group_size)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    return want


def test_determine_groups_random():
    rng = np.random.RandomState(2)
    p = rng.uniform(0, BOX, size=(8, 3)).astype(np.float32)
    o = rng.uniform(0, BOX, size=(32, 3)).astype(np.float32)
    groups = _groups(p, o, 4)
    assert groups.min() >= 0 and groups.max() < 8


def test_determine_groups_ties_and_fallback():
    """P0 and P1 with five donors whose distances tie exactly. One slot
    each: donors 0 and 1 tie for P0 (the lower donor index wins), donors 1,
    3 and 4 fall back to their nearest P, and donor 4, as near to P0 as to
    P1, takes the lower P index. Three slots each: donors 0 and 2 are chosen
    by both P atoms and take the higher P index (the last write of the JAX
    package's scatter); donor 3 falls back."""
    p = np.array([[2.0, 2.0, 2.0], [8.0, 2.0, 2.0]], np.float32)
    o = np.array([
        [2.0, 3.5, 2.0],  # 1.5 from P0, 6.18 from P1
        [2.0, 2.0, 3.5],  # the same distances
        [6.2, 2.0, 2.0],  # 4.2 from P0, 1.8 from P1
        [2.0, 2.0, 7.0],  # 5.0 from P0, 7.81 from P1
        [5.0, 6.0, 2.0],  # 5.0 from both
    ], np.float32)
    assert _groups(p, o, 1).tolist() == [0, 0, 1, 0, 0]
    assert _groups(p, o, 3).tolist() == [1, 0, 1, 0, 1]


@pytest.mark.parametrize("law", ["fermi_angle", "fermi"])
def test_angle_pair_rates_w_matches_jax(law):
    """W of AnglePairRates.shared for one frame and for a block, against the
    JAX model on each frame; with a distance-only law W is PairRates' W."""
    jc, tc = _cells()
    rng = np.random.RandomState(5)
    p = rng.uniform(0, BOX, size=(8, 3)).astype(np.float32)
    o = rng.uniform(0, BOX, size=(32, 3)).astype(np.float32)
    f32 = jnp.float32
    jlaw = (jlaws.FermiAngle(a=f32(0.06), b=f32(2.3), c=f32(0.3), theta=f32(1.2))
            if law == "fermi_angle" else
            jlaws.Fermi(a=f32(0.06), b=f32(2.3), c=f32(0.3)))
    jm = jmodels.AnglePairRates.from_first_frame(
        jc, jlaw, 3.0, 2.0, jnp.asarray(o), jnp.asarray(p), 4)
    tm = convert.angle_pair_rates_from_fields(jm)
    again = tmodels.AnglePairRates.from_first_frame(
        tc, convert.law_from_fields(jlaw), 3.0, 2.0, torch.from_numpy(o),
        torch.from_numpy(p), 4)
    assert torch.equal(again.o_to_p, tm.o_to_p)
    jit = np.random.RandomState(6)
    donors = (o[None] + jit.normal(scale=0.05, size=(3, 32, 3))).astype(np.float32)
    extras = (p[None] + jit.normal(scale=0.05, size=(3, 8, 3))).astype(np.float32)
    got = dense_tables(tm, torch.from_numpy(donors), torch.from_numpy(extras)).numpy()
    for f in range(3):
        want = np.asarray(jm.shared(jmodels.Frame(
            donors=jnp.asarray(donors[f]), extras=jnp.asarray(extras[f]),
            time=jnp.float32(0), index=jnp.int32(0))).W)
        np.testing.assert_array_equal(got[f] > 0, want > 0)
        np.testing.assert_allclose(got[f], want, rtol=1e-6, atol=0)
    one = tm.shared(tmodels.Frame(donors=torch.from_numpy(donors[0]),
                                  extras=torch.from_numpy(extras[0]))).W.numpy()
    np.testing.assert_array_equal(one, got[0])
    if law == "fermi_angle":
        assert not np.array_equal(got, got.transpose(0, 2, 1))  # the gate
    else:
        plain = tmodels.PairRates(tc, convert.law_from_fields(jlaw), 3.0, 2.0)
        np.testing.assert_array_equal(
            dense_tables(plain, torch.from_numpy(donors)).numpy(), got)
