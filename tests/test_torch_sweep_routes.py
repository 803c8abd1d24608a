"""The two dense routes of the port on the CPU: the in-kernel route (K3's
plain version) against the streamed route (stage 1 + K1's plain version)
for the distance laws, and the exponential races on a draw of exactly one.
The cases come from ``test_torch_sweep_inkernel.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu.engine import lattice as jeng
from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch.core import cell as tcell
from cmdlmc_tpu_torch.engine import fused
from cmdlmc_tpu_torch.ops import kmc_sweep as ks
from cmdlmc_tpu_torch.ops import rng
from cmdlmc_tpu_torch.topo.models import PairRates

from test_torch_sweep_inkernel import (
    BOX, BUFFER, CUTOFF, DT, LAWS, N, R, SEED, TR, _ensemble, inputs,
)

from test_torch_slice import jax_kernels_run_to_end  # noqa: F401  (runs by itself)

torch.set_num_threads(1)


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
    assert fused.inkernel_route(model, model.cell, R, N, TR, False)
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
