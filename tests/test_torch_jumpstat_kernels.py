"""The jump statistics of the three event-loop kernels' plain versions
against the JAX package's Pallas kernels in interpret mode, rows layout: K1
(cmdlmc_tpu_torch/ops/kmc_sweep_streamed.py) against B1 in a cubic cell and
in examples/triclinic.ini's monoclinic cell, K3 (ops/kmc_sweep.py) against
B2 and K4 (ops/topk_sweep.py) against B3, each with 6 histogram bins over
[2.2, 3.2) and the jump matrix, on N=32, P=12, R=16 in RNG tiles of 4 over
10 frames. The jump histograms, the jump matrix and the integer state must
be equal, and the exposure equal bit for bit: its per-frame sums are whole
numbers in float32. The float state keeps the bounds of
tests/test_torch_sweep_streamed.py. Also: a block cut into two calls gives
the same histograms and matrix, and convert.py carries the three fields
there and back."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu.core.cell import Cell as JCell
from cmdlmc_tpu.engine import lattice as jeng
from cmdlmc_tpu.ops import kmc_sweep as jks
from cmdlmc_tpu.ops import topk_sweep as jts
from cmdlmc_tpu.ops.kmc_sweep_streamed import dense_tables as j_dense_tables
from cmdlmc_tpu.ops.kmc_sweep_streamed import kmc_sweep_streamed as j_sweep
from cmdlmc_tpu.rates.laws import Fermi as JFermi
from cmdlmc_tpu.topo.models import PairRates as JPairRates
from cmdlmc_tpu.topo.models import TopKPairRates as JTopKPairRates
from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch.engine import fused
from cmdlmc_tpu_torch.ops import kmc_sweep as ks
from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss
from cmdlmc_tpu_torch.ops import topk_sweep as ts
from cmdlmc_tpu_torch.topo.models import PairRates, TopKPairRates

from test_torch_slice import jax_kernels_run_to_end  # noqa: F401  (runs by itself)

torch.set_num_threads(1)

N, P, R, TR, B = 32, 12, 16, 4, 10
BOX, DT, SEED, FRAME0 = 9.0, 0.5, 3, 7
NBINS, HIST_RANGE = 6, (2.2, 3.2)
# examples/triclinic.ini's cell rows
MONOCLINIC = [[12.0, 0.0, 0.0], [2.5, 11.5, 0.0], [0.0, 0.0, 12.0]]
_f = jnp.float32
FERMI = JFermi(a=_f(0.2), b=_f(2.3), c=_f(0.1))
STATS = dict(nbins=NBINS, hist_range=HIST_RANGE, track_matrix=True)


def _cell(name):
    return JCell.triclinic(MONOCLINIC) if name == "monoclinic" else JCell.cubic([BOX] * 3)


def _inputs(name):
    """A block of frames [B, N, 3] (sites uniform in fractional coordinates,
    jittered) and the JAX package's ensemble with histograms and matrix."""
    rng_ = np.random.RandomState(3)
    frac = rng_.uniform(0, 1, size=(N, 3))
    h = np.asarray(_cell(name).h, np.float64)
    pos0 = (frac @ h.T).astype(np.float32)
    block = (pos0[None] + np.random.RandomState(11).normal(
        scale=0.05, size=(B, N, 3))).astype(np.float32)
    ens = jeng.init_replicas(jax.random.fold_in(jax.random.key(0), 0), R, N, P,
                             jnp.asarray(pos0), hist_bins=NBINS,
                             track_jump_matrix=True)
    # histograms that do not start at zero
    start = np.random.RandomState(5)
    rep = dataclasses.replace(
        ens.replicas,
        jump_hist=jnp.asarray(start.randint(0, 9, (R, NBINS)), jnp.int32),
        opportunity_hist=jnp.asarray(start.randint(0, 99, (R, NBINS)), jnp.float32))
    return block, dataclasses.replace(ens, replicas=rep)


def _state_args(tens):
    rep = tens.replicas
    return [tens.prev_pos, tens.site_disp, rep.occ, rep.proton_of_site.float(),
            rep.site_of_proton, rep.t_last_jump, rep.disp_base,
            rep.clock.u_remaining, rep.clock.event_count]


INT_KEYS = ("occ", "labels", "sites", "ev_count", "trunc", "jump_hist")
FLOAT_KEYS = ("u_rem", "tlast", "site_disp", "prev_pos")


def _compare(got, want):
    got = {k: v.numpy() for k, v in got.items()}
    for k in INT_KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["exposure"], np.asarray(want["exposure"]))
    # the JAX kernels return the matrix as float32 sums (B1: summed over
    # tiles) that the engine rounds
    np.testing.assert_array_equal(got["jump_matrix"],
                                  np.rint(np.asarray(want["jump_matrix"])))
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["disp_base"], np.asarray(want["disp_base"]),
                               atol=1e-4)
    assert got["jump_matrix"].sum() == got["ev_count"].sum() - want["_ev0"] > 0
    assert got["jump_hist"].sum() > int(want["_hist0"])  # in-range jumps counted
    assert (got["exposure"] > want["_expo0"]).any()


@pytest.mark.parametrize("name", ["cubic", "monoclinic"])
def test_k1_reference_matches_b1(name):
    """K1's plain version: histogram of the jump lengths, exposure over the
    stage-1 distances, the matrix; triclinic through the round-based h /
    h^-1 minimum image."""
    block, ens = _inputs(name)
    jc = _cell(name)
    model = JPairRates(cell=jc, law=FERMI, cutoff=_f(3.0), buffer=_f(1.0))
    w, dist = j_dense_tables(model, jnp.asarray(block), nbins=NBINS)
    rep = ens.replicas
    want = j_sweep(
        w, jnp.asarray(block), ens.prev_pos, ens.site_disp, rep.occ,
        rep.proton_of_site.astype(jnp.float32), rep.site_of_proton,
        rep.t_last_jump, rep.disp_base, rep.clock.u_remaining,
        rep.clock.event_count, jnp.int32(FRAME0), jc.h, jc.h_inv, 0,
        dist_block=dist, jump_hist=rep.jump_hist, exposure=rep.opportunity_hist,
        tile=TR, max_events=4, dt=DT, seed=SEED,
        orthorhombic=bool(jc.orthorhombic), interpret=True, layout="rows",
        **STATS)
    want = {**want, "_ev0": np.asarray(rep.clock.event_count).sum(),
            "_hist0": np.asarray(rep.jump_hist).sum(),
            "_expo0": np.asarray(rep.opportunity_hist)}
    tens = convert.ensemble_from_numpy(ens)
    tm = convert.pair_rates_from_fields(model)
    # the JAX package's stage 1 on both sides: its jitted distances round
    # differently from the exact ones of the port's stage 1 (an ulp in some
    # entries), as tests/test_torch_sweep_streamed.py uses them
    tw, tdist = (torch.from_numpy(np.array(x)) for x in (w, dist))
    got = kss.kmc_sweep_streamed(
        tw, torch.from_numpy(block), *_state_args(tens), FRAME0, tm.box, 0,
        tile=TR, max_events=4, dt=DT, seed=SEED,
        geometry=None if tm.cell.orthorhombic else tm.geometry,
        dist_block=tdist, jump_hist=tens.replicas.jump_hist,
        exposure=tens.replicas.opportunity_hist, **STATS)
    _compare(got, want)
    assert kss.kmc_sweep_streamed.launches == 0  # CPU tensors: plain version


def test_k3_reference_matches_b2():
    """K3's plain version: the exposure over the distances the kernel
    computes itself."""
    block, ens = _inputs("cubic")
    rep = ens.replicas
    want = jks.kmc_sweep(
        jnp.asarray(block), ens.prev_pos, ens.site_disp, rep.occ,
        rep.proton_of_site.astype(jnp.float32), rep.site_of_proton,
        rep.t_last_jump, rep.disp_base, rep.clock.u_remaining,
        rep.clock.event_count, jks.law_params_array(FERMI), jnp.int32(FRAME0),
        jnp.full(3, BOX, jnp.float32), 0, jump_hist=rep.jump_hist,
        exposure=rep.opportunity_hist, kind=0, tile=TR, max_events=4, dt=DT,
        seed=SEED, cutbuf=4.0, interpret=True, **STATS)
    want = {**want, "_ev0": np.asarray(rep.clock.event_count).sum(),
            "_hist0": np.asarray(rep.jump_hist).sum(),
            "_expo0": np.asarray(rep.opportunity_hist)}
    tens = convert.ensemble_from_numpy(ens)
    got = ks.kmc_sweep(
        torch.from_numpy(block), *_state_args(tens),
        torch.from_numpy(np.array(jks.law_params_array(FERMI))), FRAME0,
        (BOX,) * 3, 0, None, kind=0, tile=TR, max_events=4, dt=DT, seed=SEED,
        cutbuf=4.0, jump_hist=tens.replicas.jump_hist,
        exposure=tens.replicas.opportunity_hist, **STATS)
    _compare(got, want)
    assert ks.kmc_sweep.launches == 0


def test_k4_reference_matches_b3():
    """K4's plain version: the histogram of the events' table distances,
    the exposure slot by slot over the K candidates."""
    block, ens = _inputs("cubic")
    jm = JTopKPairRates(cell=_cell("cubic"), law=FERMI, cutoff=_f(3.0),
                        buffer=_f(1.0), k=8)
    want = jts.run_block_topk(jm, ens, jnp.asarray(block), FRAME0, dt=DT,
                              max_events=4, seed=SEED, tile=TR, interpret=True,
                              layout="rows", hist_range=HIST_RANGE)
    rep = ens.replicas
    want = {**want, "_ev0": np.asarray(rep.clock.event_count).sum(),
            "_hist0": np.asarray(rep.jump_hist).sum(),
            "_expo0": np.asarray(rep.opportunity_hist)}
    tm = convert.topk_pair_rates_from_fields(jm)
    tens = convert.ensemble_from_numpy(ens)
    got = ts.run_block_topk(tm, tens, torch.from_numpy(block), FRAME0, dt=DT,
                            max_events=4, seed=SEED, tile=TR,
                            hist_range=HIST_RANGE)
    _compare(got, want)
    assert ts.topk_sweep.launches == 0


def _split_equals_whole(model, tens, pos, **kw):
    """One block as one call and as calls of 4 + 6 frames: the same
    histograms, exposure and matrix. Both start from ``tens``, the split
    after the whole ran from it, and ``tens`` is left as it was: a second
    run from a state counts its jumps once, not on top of the first run's."""
    matrix_before = tens.replicas.jump_matrix.clone()
    whole = fused.run_block_fused(model, model.cell, tens, pos, FRAME0,
                                  hist_range=HIST_RANGE, **kw)
    part = fused.run_block_fused(model, model.cell, tens, pos[:4], FRAME0,
                                 hist_range=HIST_RANGE, **kw)
    part = fused.run_block_fused(model, model.cell, part, pos[4:], FRAME0 + 4,
                                 hist_range=HIST_RANGE, **kw)
    assert torch.equal(tens.replicas.jump_matrix, matrix_before)
    for key in ("jump_hist", "opportunity_hist", "jump_matrix", "occ",
                "site_of_proton"):
        assert torch.equal(getattr(whole.replicas, key), getattr(part.replicas, key)), key
    rep = whole.replicas
    assert int(rep.jump_matrix.sum()) == int(
        (rep.clock.event_count - tens.replicas.clock.event_count).sum()) > 0
    assert int(rep.jump_matrix[1:].abs().sum()) == 0  # all in replica 0


@pytest.mark.parametrize("route", ["streamed", "inkernel", "topk"])
def test_split_block_keeps_the_statistics(route):
    block, ens = _inputs("monoclinic" if route == "streamed" else "cubic")
    tens = convert.ensemble_from_numpy(ens)
    law = convert.law_from_fields(FERMI)
    if route == "topk":
        model = TopKPairRates(convert.cell_from_fields(_cell("cubic")), law,
                                 3.0, 1.0, k=8)
        kw = {}
    else:
        model = PairRates(convert.cell_from_fields(
            _cell("monoclinic" if route == "streamed" else "cubic")), law, 3.0, 1.0)
        kw = {"streamed": route == "streamed"}
    _split_equals_whole(model, tens, torch.from_numpy(block), dt=DT, seed=SEED,
                        tile=TR, **kw)


def test_convert_round_trips_the_statistics():
    _, ens = _inputs("cubic")
    tens = convert.ensemble_from_numpy(ens)
    back = convert.ensemble_to_numpy(tens)
    for key in ("jump_hist", "opportunity_hist", "jump_matrix"):
        want = np.asarray(getattr(ens.replicas, key))
        np.testing.assert_array_equal(getattr(back.replicas, key), want)
        assert getattr(back.replicas, key).dtype == want.dtype
    again = convert.ensemble_from_numpy(back)
    for key in ("jump_hist", "opportunity_hist", "jump_matrix", "occ"):
        assert torch.equal(getattr(again.replicas, key), getattr(tens.replicas, key))
    assert tens.replicas.jump_matrix.shape == (R, N, N)
