"""The plain version of kernel K4 (cmdlmc_tpu_torch/ops/topk_sweep.py)
against the JAX package's top-K Pallas kernel (B3) in interpret mode, rows
layout, on the JAX package's own stage-1 tables (N=32, P=12, R=16 in RNG
tiles of 4, 6 frames, max_events 4): TopKPairRates k=8; HydroniumRates k=4
with a ReLU transformation and the residence-time blend in the loop;
HydroniumRates k=8 with an interpolation table and no blend; a triclinic
TopKPairRates. Integer state exact; u_rem / tlast / tlast_site / site_disp /
prev_pos to rtol 1e-5 with atol 1e-5 and disp_base to atol 1e-4, the bounds
of tests/test_torch_sweep_streamed.py (log, exp and the rate sums round by an
ulp differently in the two packages). Also both of K4's races on a draw of
one, the engine's chunk invariance, and the wrapper's checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu.core.cell import Cell as JCell
from cmdlmc_tpu.engine import lattice as jeng
from cmdlmc_tpu.ops import topk_sweep as jts
from cmdlmc_tpu.rates.laws import Fermi as JFermi
from cmdlmc_tpu.topo import models as jmodels
from cmdlmc_tpu.topo import transforms as jtr
from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch.engine import fused
from cmdlmc_tpu_torch.ops import rng
from cmdlmc_tpu_torch.ops import topk_sweep as ts

from test_torch_slice import jax_kernels_run_to_end  # noqa: F401  (runs by itself)

torch.set_num_threads(1)

N, P, R, TR, B = 32, 12, 16, 4, 6
BOX, DT, SEED, FRAME0 = 9.0, 0.5, 3, 7
_f = jnp.float32
FERMI = JFermi(a=_f(0.2), b=_f(2.3), c=_f(0.1))
TRICLINIC = [[9.0, 0.0, 0.0], [1.5, 9.0, 0.0], [0.5, 1.0, 9.0]]


def _jax_model(name):
    if name == "triclinic":
        return jmodels.TopKPairRates(cell=JCell.triclinic(TRICLINIC), law=FERMI,
                                     cutoff=_f(3.0), buffer=_f(1.0), k=8)
    cell = JCell.cubic([BOX] * 3)
    if name == "topk":
        return jmodels.TopKPairRates(cell=cell, law=FERMI, cutoff=_f(3.0),
                                     buffer=_f(2.0), k=8)
    if name == "hydronium_blend":
        transform = jtr.ReLUTransformation(a=_f(0.5), b=_f(2.2), d0=_f(2.2),
                                           left_bound=_f(2.0), right_bound=_f(3.3))
        interp = jtr.DistanceInterpolator(relaxation_time=_f(2.0))
    else:
        xs = jnp.linspace(2.0, 3.5, 31)
        transform = jtr.InterpolatedTransformation(
            x=xs, y=xs - 0.3 * jnp.exp(-((xs - 2.6) ** 2) / 0.08))
        interp = None
    # the table case takes k=8, so its JAX kernel compiles as the topk case's
    return jmodels.HydroniumRates(cell=cell, law=FERMI, cutoff=_f(3.0),
                                  buffer=_f(2.0), transform=transform,
                                  interpolator=interp, k=4 if interp else 8)


def _port_model(name, jm):
    if name in ("topk", "triclinic"):
        return convert.topk_pair_rates_from_fields(jm)
    return convert.hydronium_rates_from_fields(jm)


def _inputs(name):
    """A block of frames [B, N, 3] and the JAX package's initial ensemble."""
    rng_ = np.random.RandomState(3)
    frac = rng_.uniform(0, 1, size=(N, 3)).astype(np.float32)
    h = np.asarray(TRICLINIC, np.float32).T if name == "triclinic" else np.eye(3) * BOX
    pos0 = (frac @ h.T).astype(np.float32)
    block = (pos0[None] + np.random.RandomState(11).normal(
        scale=0.05, size=(B, N, 3))).astype(np.float32)
    ens = jeng.init_replicas(jax.random.fold_in(jax.random.key(0), 0), R, N, P,
                             jnp.asarray(pos0))
    return block, ens


NAMES = ["topk", "hydronium_blend", "hydronium_table", "triclinic"]


@pytest.fixture(scope="module")
def jax_runs():
    """Each model's JAX kernel run (interpret, rows) and its tables."""
    runs = {}
    for name in NAMES:
        jm = _jax_model(name)
        block, ens = _inputs(name)
        blend = name == "hydronium_blend"
        tables = jts.topk_tables(jm, jnp.asarray(block), 8, not blend)
        out = jts.run_block_topk(jm, ens, jnp.asarray(block), FRAME0, dt=DT,
                                 max_events=4, seed=SEED, tile=TR, interpret=True,
                                 layout="rows")
        runs[name] = (jm, block, ens, [np.asarray(t) for t in tables], out)
    return runs


INT_KEYS = ("occ", "labels", "sites", "ev_count", "trunc")
FLOAT_KEYS = ("u_rem", "tlast", "site_disp", "prev_pos")


def _compare(got, want):
    for k in INT_KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    # tlast_site: the occupied sites' entries (an empty site's goes stale)
    occ = np.asarray(want["occ"]) > 0
    np.testing.assert_allclose(got["tlast_site"][occ],
                               np.asarray(want["tlast_site"])[occ], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["disp_base"], np.asarray(want["disp_base"]), atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_reference_matches_jax_kernel(jax_runs, name):
    jm, block, ens, (topd, topi, resc), want = jax_runs[name]
    tm = _port_model(name, jm)
    k = min(tm.k, N - 1)
    tens = convert.ensemble_from_numpy(ens)
    rep = tens.replicas
    labels = rep.proton_of_site.float()
    tls = ts.entry_tlast_site(rep.occ, labels, rep.t_last_jump)
    np.testing.assert_array_equal(tls.numpy(), np.asarray(jts._entry_tlast_site(ens.replicas)))
    tables = [torch.from_numpy(np.array(t[:, :k])) for t in (topd, topi, resc)]
    tables[1] = tables[1].to(torch.int32)
    params = ts.law_params8(tm)
    got = ts.topk_sweep_reference(
        torch.from_numpy(block), *tables, tens.prev_pos, tens.site_disp, rep.occ,
        labels, rep.site_of_proton, rep.t_last_jump, tls, rep.disp_base,
        rep.clock.u_remaining, rep.clock.event_count, params, FRAME0,
        tm.geometry, 0, orthorhombic=tm.cell.orthorhombic, kind=0, tile=TR,
        max_events=4, dt=DT, seed=SEED, blend=ts.has_blend(tm))
    _compare({k_: v.numpy() for k_, v in got.items()}, want)
    assert int(np.asarray(want["ev_count"]).sum()) > 0
    assert int(np.asarray(want["trunc"]).sum()) > 0  # frames that used every event
    # the port's own stage 1 and wrapper land in the same state
    whole = ts.run_block_topk(tm, tens, torch.from_numpy(block), FRAME0, dt=DT,
                              max_events=4, seed=SEED, tile=TR)
    for k_ in INT_KEYS:
        np.testing.assert_array_equal(whole[k_].numpy(), np.asarray(want[k_]), err_msg=k_)
    assert ts.topk_sweep.launches == 0  # CPU tensors: plain version


def test_engine_chunk_invariance(jax_runs, monkeypatch):
    """run_block_fused over 6 frames == 2 + 4 frames == a table budget that
    splits the block frame by frame: the same integer state, disp_base to
    rtol 1e-6."""
    jm, block, ens, _, _ = jax_runs["hydronium_blend"]
    tm = _port_model("hydronium_blend", jm)
    tens = convert.ensemble_from_numpy(ens)
    pos = torch.from_numpy(block)
    kw = dict(dt=DT, seed=SEED, tile=TR, nbr_reuse=False)
    whole = fused.run_block_fused(tm, tm.cell, tens, pos, 0, **kw)
    part = fused.run_block_fused(tm, tm.cell, tens, pos[:2], 0, **kw)
    part = fused.run_block_fused(tm, tm.cell, part, pos[2:], 2, **kw)
    monkeypatch.setattr(fused, "STREAMED_TABLE_BUDGET_BYTES", 3 * 4 * 4 * N)
    split = fused.run_block_fused(tm, tm.cell, tens, pos, 0, **kw)
    for got in (part, split):
        for a, b in ((whole.replicas.occ, got.replicas.occ),
                     (whole.replicas.site_of_proton, got.replicas.site_of_proton),
                     (whole.replicas.clock.event_count, got.replicas.clock.event_count),
                     (whole.replicas.jumps, got.replicas.jumps)):
            assert torch.equal(a, b)
        torch.testing.assert_close(whole.replicas.disp_base, got.replicas.disp_base,
                                   rtol=1e-6, atol=0)
    assert int(whole.replicas.clock.event_count.sum()) > int(tens.replicas.clock.event_count.sum())


# Draws (seed SEED, tile 0, event 0) that round to exactly 1.0: the slot
# race (salt 11, counter replica * K + slot, K = 8) and the site race (salt
# 12, counter replica * N + site).
SLOT_ONE = (664525, 21)  # replica 2, slot 5
SITE_ONE = (396653, 20)  # replica 0, site 20


def _synthetic(slot_rates, occupied=(), empty=(), r_fix=0):
    """One frame of tables over N=32 sites with nbr_k[i] = (i + k + 1) % N,
    slot k's rate slot_rates[k] at every site; 4 replicas (one RNG tile) of
    P protons, replica r_fix holding the sites in ``occupied`` and none in
    ``empty``; every replica fires at once."""
    K, r = len(slot_rates), 4
    gen = np.random.RandomState(5)
    sites = []
    for q in range(r):
        pick = [s for s in gen.permutation(N) if q != r_fix or s not in empty]
        if q == r_fix:
            pick = list(occupied) + [s for s in pick if s not in occupied]
        sites.append(pick[:P])
    sites = np.asarray(sites, np.int32)
    occ = np.zeros((r, N), np.float32)
    labels = np.zeros((r, N), np.float32)
    for q in range(r):
        occ[q, sites[q]] = 1.0
        labels[q, sites[q]] = np.arange(1, P + 1)
    i = np.arange(N)
    topi = np.stack([(i + k + 1) % N for k in range(K)])[None].astype(np.int32)
    topd = np.full((1, K, N), 2.5, np.float32)
    resc = np.repeat(np.asarray(slot_rates, np.float32)[None, :, None], N, axis=2)
    pos = gen.uniform(0, BOX, size=(1, N, 3)).astype(np.float32)
    t = torch.from_numpy
    state = [t(pos[0]), torch.zeros((N, 3)), t(occ), t(labels), t(sites),
             torch.full((r, P), -1.0), torch.full((r, N), -1.0),
             torch.zeros((r, P, 3)), torch.full((r,), 1e-6),
             torch.zeros(r, dtype=torch.int32)]
    return [t(pos), t(topd), t(topi), t(resc)], state


def _one_event(frame, tables, state):
    out = ts.topk_sweep(*tables, *state, torch.zeros(8), frame,
        (BOX, 0, 0, 0, BOX, 0, 0, 0, BOX, 1 / BOX, 0, 0, 0, 1 / BOX, 0, 0, 0, 1 / BOX),
        orthorhombic=True, kind=0, tile=4, max_events=1, dt=DT, seed=SEED, blend=False)
    occ = out["occ"]
    assert torch.equal(out["ev_count"], torch.ones(4, dtype=torch.int32))
    assert bool(((occ == 0) | (occ == 1)).all())
    assert torch.equal(occ.sum(dim=1), torch.full((4,), float(P)))
    moved = []
    for q in range(4):
        before, after = state[4][q], out["sites"][q]
        (p,) = (before != after).nonzero()[:, 0].tolist()
        moved.append((int(before[p]), int(after[p])))
    return moved


@pytest.mark.parametrize("positive", [False, True], ids=["zero-slot", "positive-slot"])
def test_slot_race_on_a_draw_of_one(positive):
    """A draw of 1.0 gives E = -log(1) = -0.0 in the JAX kernel: a slot whose
    rates sum to 0 scores NaN there and wins the argmax (the site race then
    moves a proton from site 0 whether it holds one or not). The port scores
    it 0 and uses E = +0, so a positive slot wins outright instead."""
    frame, counter = SLOT_ONE
    key = rng.mix_key(SEED, 0, frame, 0, 11)
    assert float(rng.u01_counter(key, torch.tensor(counter))) == 1.0
    r, slot = divmod(counter, 8)
    rates = [0.05] * 8
    if not positive:
        rates[slot] = 0.0
    tables, state = _synthetic(rates, r_fix=r)
    src, dst = _one_event(frame, tables, state)[r]
    chosen = (dst - src - 1) % N
    assert (chosen == slot) == positive


@pytest.mark.parametrize("positive", [False, True], ids=["empty-site", "occupied-site"])
def test_site_race_on_a_draw_of_one(positive):
    """The same within the slot: on a draw of 1.0 an empty site (rate 0)
    never becomes the source, an occupied one with a vacant neighbor does."""
    frame, counter = SITE_ONE
    key = rng.mix_key(SEED, 0, frame, 0, 12)
    assert float(rng.u01_counter(key, torch.tensor(counter))) == 1.0
    r, site = divmod(counter, N)
    rates = [0.05] + [0.0] * 7  # only slot 0 (nbr = site + 1) carries rate
    if positive:
        tables, state = _synthetic(rates, occupied=(site,), empty=(site + 1,), r_fix=r)
    else:
        tables, state = _synthetic(rates, empty=(site,), r_fix=r)
    src, dst = _one_event(frame, tables, state)[r]
    assert dst == (src + 1) % N
    assert (src == site) == positive


def test_wrapper_validates():
    tables, state = _synthetic([0.05] * 4)
    params = torch.zeros(8)
    geom = (BOX, 0, 0, 0, BOX, 0, 0, 0, BOX) + (0,) * 9
    kw = dict(orthorhombic=True, kind=0, tile=4, max_events=1, dt=DT, seed=SEED,
              blend=False)
    with pytest.raises(ValueError, match="tile"):
        ts.topk_sweep(*tables, *state, params, 0, geom, **{**kw, "tile": 3})
    with pytest.raises(ValueError, match="max_events"):
        ts.topk_sweep(*tables, *state, params, 0, geom, **{**kw, "max_events": 0})
    with pytest.raises(ValueError, match="law kind"):
        ts.topk_sweep(*tables, *state, params, 0, geom, **{**kw, "kind": 4})
    assert ts.topk_unsupported_reason(convert.topk_pair_rates_from_fields(
        jmodels.TopKPairRates(cell=JCell.cubic([BOX] * 3), law=FERMI,
                              cutoff=_f(3.0), buffer=_f(2.0), k=17))) is not None
