"""The plain version of kernel K3 (cmdlmc_tpu_torch/ops/kmc_sweep.py) against
the JAX package's in-kernel-W Pallas kernel in interpret mode, for the law
kinds 0-4 (N=32, P=12, R=16 in RNG tiles of 4, 6 frames, max_events 4):
integer state exact, u_rem / tlast / site_disp / prev_pos to rtol 1e-5 with
atol 1e-5, disp_base to atol 1e-4 (the bounds of
tests/test_torch_sweep_streamed.py: exp, log and the rate sums round by an
ulp differently in the two packages). Both sides get the same law parameters
(the JAX package's packing) and the same state; the packings agree to an ulp
of cos(theta). Also the port's two routes against each other through
run_block_fused (kinds 0-3), the wrapper's checks, and the race on a draw of
one."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu.engine import lattice as jeng
from cmdlmc_tpu.ops import kmc_sweep as jks
from cmdlmc_tpu.rates import laws as jlaws
from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch.core import cell as tcell
from cmdlmc_tpu_torch.engine import fused
from cmdlmc_tpu_torch.ops import kmc_sweep as ks
from cmdlmc_tpu_torch.ops import rng
from cmdlmc_tpu_torch.topo import models as tmodels
from cmdlmc_tpu_torch.topo.models import PairRates

torch.set_num_threads(1)

N, P, R, TR, B, M = 32, 12, 16, 4, 6, 8
BOX, CUTOFF, BUFFER, DT, SEED = 9.0, 3.0, 2.0, 0.5, 3

_f = jnp.float32
LAWS = {
    0: jlaws.Fermi(a=_f(0.2), b=_f(2.3), c=_f(0.1)),
    1: jlaws.Constant(a=_f(0.02)),
    2: jlaws.Exponential(a=_f(2.0), b=_f(-2.0)),
    3: jlaws.ActivationEnergy(A=_f(0.2), a=_f(1.6), b=_f(0.6), d0=_f(2.6),
                              T=_f(500.0)),
    4: jlaws.FermiAngle(a=_f(0.2), b=_f(2.3), c=_f(0.1), theta=_f(1.2)),
}


def _inputs():
    """Donor block [B, N, 3], grouped P block [B, N, 3] and the replica
    state [prev_pos, site_disp, occ, labels, sites, tlast, disp_base, u_rem,
    ev_count], all numpy from seeds."""
    rng_ = np.random.RandomState(3)
    pos0 = rng_.uniform(0, BOX, size=(N, 3)).astype(np.float32)
    p0 = rng_.uniform(0, BOX, size=(M, 3)).astype(np.float32)
    jit = np.random.RandomState(11)
    block = (pos0[None] + jit.normal(scale=0.05, size=(B, N, 3))).astype(np.float32)
    extras = (p0[None] + jit.normal(scale=0.05, size=(B, M, 3))).astype(np.float32)
    o_to_p = tmodels.determine_groups(
        tcell.Cell.cubic([BOX] * 3), torch.from_numpy(extras[0]),
        torch.from_numpy(block[0]), 4).numpy()
    sites = np.stack([rng_.permutation(N)[:P] for _ in range(R)]).astype(np.int32)
    occ = np.zeros((R, N), np.float32)
    labels = np.zeros((R, N), np.float32)
    for r in range(R):
        occ[r, sites[r]] = 1.0
        labels[r, sites[r]] = np.arange(1, P + 1)
    u_rem = -np.log(rng_.uniform(size=R)).astype(np.float32)
    state = [pos0, np.zeros((N, 3), np.float32), occ, labels, sites,
             np.full((R, P), -1.0, np.float32), np.zeros((R, P, 3), np.float32),
             u_rem, np.zeros(R, np.int32)]
    return block, np.ascontiguousarray(extras[:, o_to_p]), state


def _ensemble(state):
    """The port's EnsembleState holding ``state``."""
    prev, s, occ, labels, sites, tlast, db, u, evc = state
    zeros = np.zeros(R, np.int32)
    clock = SimpleNamespace(u_remaining=u, phase=np.zeros(R), event_count=evc,
                            last_event_frame=zeros, last_event_phase=np.zeros(R))
    rep = SimpleNamespace(occ=occ, proton_of_site=labels, site_of_proton=sites,
                          t_last_jump=tlast, clock=clock, jumps=zeros,
                          disp_base=db, autocorr_ref=sites)
    return convert.ensemble_from_numpy(
        SimpleNamespace(replicas=rep, site_disp=s, prev_pos=prev))


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


INT_KEYS = ("occ", "labels", "sites", "ev_count", "trunc")
FLOAT_KEYS = ("u_rem", "tlast", "site_disp", "prev_pos")


def _compare(got, want):
    for k in INT_KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(np.asarray(got["disp_base"]),
                               np.asarray(want["disp_base"]), atol=1e-4)


@pytest.fixture(scope="module")
def jax_runs(inputs):
    """The JAX kernel in interpret mode, once per law kind."""
    block, pgrp, state = inputs
    runs = {}
    for kind, law in LAWS.items():
        runs[kind] = jks.kmc_sweep(
            jnp.asarray(block), *[jnp.asarray(a) for a in state],
            jks.law_params_array(law), jnp.int32(7), jnp.full(3, BOX, jnp.float32),
            0, pgrp_positions=jnp.asarray(pgrp) if kind == 4 else None,
            kind=kind, tile=TR, max_events=4, dt=DT, seed=SEED,
            cutbuf=CUTOFF + BUFFER, interpret=True,
        )
    return block, pgrp, state, runs


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4],
                         ids=["fermi", "constant", "exponential", "ae", "fermi_angle"])
def test_reference_matches_jax_kernel(jax_runs, kind):
    block, pgrp, state, runs = jax_runs
    law = LAWS[kind]
    tlaw = convert.law_from_fields(law)
    assert ks.law_kind(tlaw) == jks.law_kind(law) == kind
    np.testing.assert_allclose(ks.law_params_array(tlaw).numpy(),
                               np.asarray(jks.law_params_array(law)), rtol=2e-7)
    got = ks.kmc_sweep(
        torch.from_numpy(block), *[torch.from_numpy(a) for a in state],
        torch.from_numpy(np.array(jks.law_params_array(law))), 7, (BOX,) * 3, 0,
        torch.from_numpy(pgrp) if kind == 4 else None, kind=kind, tile=TR,
        max_events=4, dt=DT, seed=SEED, cutbuf=CUTOFF + BUFFER,
    )
    _compare({k: v.numpy() for k, v in got.items()}, runs[kind])
    assert int(np.asarray(runs[kind]["ev_count"]).sum() - state[8].sum()) > 0
    assert ks.kmc_sweep.launches == 0  # CPU tensors: plain version


@pytest.mark.parametrize("kind", [0, 1, 2, 3],
                         ids=["fermi", "constant", "exponential", "ae"])
def test_routes_agree(inputs, kind):
    """run_block_fused on the in-kernel route (K3's plain version, W built
    from the law kind) and on the streamed route (stage 1 + K1's plain
    version, W from the law module): the same state. AE rounds its rsqrt
    differently on the two routes, as in the JAX package."""
    block, _, state = inputs
    model = PairRates(tcell.Cell.cubic([BOX] * 3),
                      convert.law_from_fields(LAWS[kind]), CUTOFF, BUFFER)
    ens = _ensemble(state)
    assert fused.inkernel_route(model, model.cell, R, N, TR, False, torch.device("cpu"))
    kw = dict(dt=DT, seed=SEED, tile=TR, return_truncation=True)
    pos = torch.from_numpy(block)
    a, ta = fused.run_block_fused(model, model.cell, ens, pos, 0, streamed=False, **kw)
    b, tb = fused.run_block_fused(model, model.cell, ens, pos, 0, streamed=True, **kw)
    ra, rb = a.replicas, b.replicas
    for x, y in ((ra.occ, rb.occ), (ra.site_of_proton, rb.site_of_proton),
                 (ra.proton_of_site, rb.proton_of_site),
                 (ra.clock.event_count, rb.clock.event_count), (ta, tb)):
        assert torch.equal(x, y)
    assert int(ra.clock.event_count.sum() - ens.replicas.clock.event_count.sum()) > 0
    torch.testing.assert_close(ra.clock.u_remaining, rb.clock.u_remaining,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ra.disp_base, rb.disp_base, rtol=0, atol=1e-4)
    torch.testing.assert_close(a.site_disp, b.site_disp, rtol=0, atol=0)


# (salt, frame, counter) whose uniform draw (seed SEED, tile 0, event 0) rounds
# to exactly 1.0 (tests/test_torch_sweep_streamed.py::test_race_on_a_draw_of_one):
# on the state below a zero-rate source, a zero-rate destination, and the
# source site 19 of replica 3, whose rate is positive.
@pytest.mark.parametrize("salt,frame,counter", [
    (1, 120944, 48), (2, 248351, 127), (1, 875943, 115),
], ids=["zero-source", "zero-destination", "positive-source"])
def test_race_on_a_draw_of_one(salt, frame, counter):
    """K3's races score zero rates 0 and use E = 0 - log(u), as K1's do: a
    draw of 1.0 never moves a proton off an empty site or onto an occupied
    one, and makes a positive-rate candidate win."""
    key = rng.mix_key(SEED, 0, frame, 0, salt)
    assert float(rng.u01_counter(key, torch.tensor(counter))) == 1.0
    n, p, r = 32, 16, 8  # the state of tests/test_torch_sweep_streamed.py
    jrng = np.random.RandomState(3)
    pos0 = jrng.uniform(0, 8.1, size=(n, 3)).astype(np.float32)
    block = (pos0[None] + np.random.RandomState(11).normal(
        scale=0.05, size=(1, n, 3))).astype(np.float32)
    ens = jeng.init_replicas(jax.random.fold_in(jax.random.key(0), 0), r, n, p,
                             jnp.asarray(pos0))
    tens = convert.ensemble_from_numpy(ens)
    rep = tens.replicas
    occ0 = rep.occ
    out = ks.kmc_sweep(
        torch.from_numpy(block), tens.prev_pos, tens.site_disp, occ0,
        rep.proton_of_site.float(), rep.site_of_proton, rep.t_last_jump,
        rep.disp_base, torch.full((r,), 1e-6), rep.clock.event_count,
        ks.law_params_array(convert.law_from_fields(LAWS[0])), frame, (BOX,) * 3,
        kind=0, tile=TR, max_events=1, dt=DT, seed=SEED, cutbuf=CUTOFF + BUFFER)
    assert torch.equal(out["ev_count"], rep.clock.event_count + 1)
    occ = out["occ"]
    assert bool(((occ == 0) | (occ == 1)).all())
    assert torch.equal(occ.sum(dim=1), torch.full((r,), float(p)))
    row, site = divmod(counter, n)
    if counter != 115:
        assert float(occ[row, site]) == float(occ0[row, site])
    else:  # the proton on site 19 is the one that jumps
        assert float(occ0[row, site]) == 1.0 and float(occ[row, site]) == 0.0


def test_wrapper_validates(inputs):
    block, pgrp, state = inputs
    args = [torch.from_numpy(a) for a in state]
    params = ks.law_params_array(convert.law_from_fields(LAWS[0]))
    kw = dict(kind=0, tile=TR, max_events=4, dt=DT, seed=SEED, cutbuf=5.0)
    pos = torch.from_numpy(block)
    with pytest.raises(ValueError, match="tile"):
        ks.kmc_sweep(pos, *args, params, 0, (BOX,) * 3, **{**kw, "tile": 3})
    with pytest.raises(ValueError, match="max_events"):
        ks.kmc_sweep(pos, *args, params, 0, (BOX,) * 3, **{**kw, "max_events": 0})
    with pytest.raises(ValueError, match="kind 4"):
        ks.kmc_sweep(pos, *args, params, 0, (BOX,) * 3, **{**kw, "kind": 4})
    with pytest.raises(ValueError, match="kind 4"):
        ks.kmc_sweep(pos, *args, params, 0, (BOX,) * 3, 0, torch.from_numpy(pgrp),
                     **kw)
    with pytest.raises(ValueError, match="law kind"):
        ks.kmc_sweep(pos, *args, params, 0, (BOX,) * 3, **{**kw, "kind": 5})


def test_route_rule():
    """K3 below 16 RNG tiles when W[N, N+1] fits in an H100 block's shared
    memory (227 KB opt-in: N=224 at 8 warps, not N=225); stage 1 + K1 at 16
    tiles, with stale rates, or for a law K3 does not evaluate."""
    cpu = torch.device("cpu")
    cell = tcell.Cell.cubic([BOX] * 3)
    model = PairRates(cell, convert.law_from_fields(LAWS[0]), CUTOFF, BUFFER)
    assert ks.smem_bytes(144, 8) == 4 * (144 * 145 + 6 * 144 + 8 * 3 * 144 + 4 * 144)
    assert fused.inkernel_route(model, cell, 1024, 144, 128, False, cpu)
    assert not fused.inkernel_route(model, cell, 2048, 144, 128, False, cpu)
    assert not fused.inkernel_route(model, cell, 1024, 144, 128, True, cpu)
    assert ks.WARPS_PER_BLOCK == 8
    assert fused.inkernel_route(model, cell, 1024, 224, 128, False, cpu)
    assert not fused.inkernel_route(model, cell, 1024, 225, 128, False, cpu)

    class Other(torch.nn.Module):
        def forward(self, d, angle=None):
            return d

    odd = PairRates(cell, Other(), CUTOFF, BUFFER)
    assert not fused.inkernel_route(odd, cell, 16, 32, 4, False, cpu)
    assert "law kind" in fused.inkernel_reason(odd, cell, 32, False, cpu)
