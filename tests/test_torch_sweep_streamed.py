"""The plain version of kernel K1 (cmdlmc_tpu_torch/ops/kmc_sweep_streamed.py)
against the JAX package's streamed kernel in interpret mode, rows layout, on
the same JAX-built W: integer state exact, u_rem / tlast / site_disp /
prev_pos to rtol 1e-5 and disp_base to atol 1e-4 (the JAX package's own
cross-route bounds, tests/engine/test_streamed.py). The float state also
gets atol 1e-5: u_rem is a fresh O(1) draw minus an O(1) integrated rate, so
near zero its error is absolute (log and the rate sums round differently in
the two packages, by an ulp). Also the port's engine entry (stage 1 + sweep)
and its frame-chunk invariance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu.core.cell import Cell as JCell
from cmdlmc_tpu.engine import lattice as jeng
from cmdlmc_tpu.ops.kmc_sweep_streamed import dense_tables as j_dense_tables
from cmdlmc_tpu.ops.kmc_sweep_streamed import kmc_sweep_streamed as j_sweep
from cmdlmc_tpu.rates.laws import Fermi as JFermi
from cmdlmc_tpu.topo.models import PairRates as JPairRates
from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch.engine import fused
from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss

from test_torch_slice import jax_kernels_run_to_end  # noqa: F401  (runs by itself)

torch.set_num_threads(1)

N, P, R, TR, B = 32, 16, 8, 4, 12
DT, SEED = 0.5, 3


def _setup():
    jc = JCell.cubic([9.0, 9.0, 9.0])
    model = JPairRates(
        cell=jc, law=JFermi(a=jnp.float32(0.2), b=jnp.float32(2.3),
                            c=jnp.float32(0.1)),
        cutoff=jnp.float32(3.0), buffer=jnp.float32(2.0),
    )
    rng = np.random.RandomState(3)
    pos0 = rng.uniform(0, 8.1, size=(N, 3)).astype(np.float32)
    block = (pos0[None] + np.random.RandomState(11).normal(
        scale=0.05, size=(B, N, 3))).astype(np.float32)
    ens = jeng.init_replicas(jax.random.fold_in(jax.random.key(0), 0), R, N, P,
                             jnp.asarray(pos0))
    return model, block, ens


def _state_args(ens):
    rep = ens.replicas
    return [np.array(x) for x in (
        ens.prev_pos, ens.site_disp, rep.occ,
        np.asarray(rep.proton_of_site).astype(np.float32), rep.site_of_proton,
        rep.t_last_jump, rep.disp_base, rep.clock.u_remaining,
        rep.clock.event_count)]


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


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
def test_reference_matches_jax_kernel(stale):
    model, block, ens = _setup()
    w, _ = j_dense_tables(model, jnp.asarray(block))
    args = _state_args(ens)
    want = j_sweep(
        w, jnp.asarray(block), *[jnp.asarray(a) for a in args], jnp.int32(7),
        model.cell.h, model.cell.h_inv, 0, tile=TR, max_events=4, dt=DT,
        seed=SEED, interpret=True, stale=stale, layout="rows",
    )
    got = kss.kmc_sweep_streamed(
        torch.from_numpy(np.array(w)), torch.from_numpy(block),
        *[torch.from_numpy(a) for a in args], 7, (9.0, 9.0, 9.0), 0,
        tile=TR, max_events=4, dt=DT, seed=SEED, stale=stale,
    )
    _compare({k: v.numpy() for k, v in got.items()}, want)
    assert int(np.asarray(want["ev_count"]).sum()) > 0
    assert kss.kmc_sweep_streamed.launches == 0  # CPU tensors: plain version


def test_engine_block_matches_jax_and_is_chunk_invariant():
    """run_block_fused of the port (stage 1 + sweep) against the JAX
    package's streamed route, and 12 frames as one block vs 5 + 7."""
    model, block, ens = _setup()
    from cmdlmc_tpu.engine import fused as jfused

    want = jfused.run_block_fused(model, model.cell, ens, jnp.asarray(block), 0,
                                  dt=DT, seed=SEED, tile=TR, interpret=True,
                                  streamed=True, layout="rows")
    tmodel = convert.pair_rates_from_fields(model)
    tens = convert.ensemble_from_numpy(ens)
    kw = dict(dt=DT, seed=SEED, tile=TR)
    pos = torch.from_numpy(block)
    whole = fused.run_block_fused(tmodel, tmodel.cell, tens, pos, 0, **kw)
    part = fused.run_block_fused(tmodel, tmodel.cell, tens, pos[:5], 0, **kw)
    part = fused.run_block_fused(tmodel, tmodel.cell, part, pos[5:], 5, **kw)
    for got in (whole, part):
        rep, jrep = got.replicas, want.replicas
        np.testing.assert_array_equal(rep.occ.numpy(), np.asarray(jrep.occ))
        np.testing.assert_array_equal(rep.proton_of_site.numpy(),
                                      np.asarray(jrep.proton_of_site))
        np.testing.assert_array_equal(rep.site_of_proton.numpy(),
                                      np.asarray(jrep.site_of_proton))
        np.testing.assert_array_equal(rep.clock.event_count.numpy(),
                                      np.asarray(jrep.clock.event_count))
        np.testing.assert_array_equal(rep.jumps.numpy(), np.asarray(jrep.jumps))
        np.testing.assert_allclose(rep.disp_base.numpy(),
                                   np.asarray(jrep.disp_base), atol=1e-4)
        np.testing.assert_allclose(got.site_disp.numpy(),
                                   np.asarray(want.site_disp), atol=1e-5)
    np.testing.assert_array_equal(whole.replicas.occ.numpy(), part.replicas.occ.numpy())
    np.testing.assert_allclose(whole.replicas.disp_base.numpy(),
                               part.replicas.disp_base.numpy(), rtol=1e-6)


# (salt, frame, counter) whose uniform draw (seed SEED, tile 0, event 0) rounds
# to exactly 1.0: 24 set bits plus half a step is a float32 halfway case. In
# _setup's state the first lands on an empty site of replica 1 (a zero source
# rate), the second on an occupied site of replica 3 (a zero destination
# rate), the third on site 19 of replica 3, whose source rate is positive.
@pytest.mark.parametrize("salt,frame,counter", [
    (1, 120944, 48), (2, 248351, 127), (1, 875943, 115),
], ids=["zero-source", "zero-destination", "positive-source"])
def test_race_on_a_draw_of_one(salt, frame, counter):
    """A draw of 1.0 gives the exponential E = -log(1) = -0.0 in the JAX
    kernels: a zero-rate candidate scores 0 / -0.0 = NaN, which argmax takes
    as the maximum (a proton leaves an empty site or lands on an occupied
    one), and a positive rate scores -inf. The port scores zero rates 0 and
    uses E = +0, so occupancy stays 0/1 and a positive rate wins."""
    from cmdlmc_tpu_torch.ops import rng

    key = rng.mix_key(SEED, 0, frame, 0, salt)
    assert float(rng.u01_counter(key, torch.tensor(counter))) == 1.0
    model, block, ens = _setup()
    args = [torch.from_numpy(a) for a in _state_args(ens)]
    args[7] = torch.full((R,), 1e-6)  # u_rem: every replica fires at once
    pos = torch.from_numpy(block[:1])
    w = kss.dense_tables(convert.pair_rates_from_fields(model), pos)
    out = kss.kmc_sweep_streamed(w, pos, *args, frame, (9.0,) * 3, 0, tile=TR,
                                 max_events=1, dt=DT, seed=SEED)
    assert torch.equal(out["ev_count"], args[8] + 1)
    occ = out["occ"]
    assert bool(((occ == 0) | (occ == 1)).all())
    assert torch.equal(occ.sum(dim=1), torch.full((R,), float(P)))
    r, site = divmod(counter, N)
    if counter != 115:
        assert float(occ[r, site]) == float(args[2][r, site])
    else:  # the proton on site 19 is the one that jumps
        assert float(args[2][r, site]) == 1.0 and float(occ[r, site]) == 0.0


def test_wrapper_validates():
    model, block, ens = _setup()
    args = [torch.from_numpy(a) for a in _state_args(ens)]
    w = torch.zeros((B, N, N))
    with pytest.raises(ValueError, match="tile"):
        kss.kmc_sweep_streamed(w, torch.from_numpy(block), *args, 0, (9.0,) * 3,
                               tile=3, max_events=4, dt=DT, seed=SEED)
    with pytest.raises(ValueError, match="max_events"):
        kss.kmc_sweep_streamed(w, torch.from_numpy(block), *args, 0, (9.0,) * 3,
                               tile=4, max_events=0, dt=DT, seed=SEED)
