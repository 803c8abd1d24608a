"""The row-list event loop of K1 and K3 against their plain versions on the
card (marked ``cuda``; they skip without one), on the W the lists must get
right: every pair in range (the lists are whole rows, in shared memory and,
past its size, in global memory), exact zeros inside the cutoff (+0 and -0
in a streamed W, rates that underflow in K3's), the asymmetric W of the
angle gate, stale rates, and a draw of exactly one in each race. Integer
state agrees but for at most one replica (a near-tie the two summation
orders can split), floats to rtol 1e-5. On a machine with a GPU and no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda_sparse.py
"""

import numpy as np
import pytest
import torch

from cmdlmc_tpu_torch.core.cell import Cell
from cmdlmc_tpu_torch.ops import kmc_sweep as ks
from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss
from cmdlmc_tpu_torch.ops import rng
from cmdlmc_tpu_torch.rates.laws import Fermi, FermiAngle
from cmdlmc_tpu_torch.topo.models import AnglePairRates, PairRates

from test_torch_kernels_cuda import _setup, dev

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

INT_KEYS = ("occ", "labels", "sites", "ev_count", "trunc")


def _matches_plain(got, want):
    r = want["occ"].shape[0]
    same = torch.ones(r, dtype=torch.bool, device=want["occ"].device)
    for k in INT_KEYS:
        same &= (got[k] == want[k]).reshape(r, -1).all(dim=1)
    assert int((~same).sum()) <= 1
    assert int(want["ev_count"].sum()) > 0
    for k, rtol, atol in (("u_rem", 1e-5, 1e-5), ("tlast", 1e-5, 1e-5),
                          ("disp_base", 0.0, 1e-4)):
        torch.testing.assert_close(got[k][same], want[k][same], rtol=rtol, atol=atol)
    torch.testing.assert_close(got["site_disp"], want["site_disp"], rtol=1e-5, atol=1e-5)


def _k1(model, pos, state, w=None, **extra):
    """K1 and its plain version on stage 1's W (or ``w``)."""
    w = kss.dense_tables(model, pos) if w is None else w
    kw = dict(tile=64, max_events=4, dt=0.5, seed=9, **extra)
    return (w, kss.kmc_sweep_streamed(w, pos, *state, 0, model.box, **kw),
            kss.kmc_sweep_streamed_reference(w, pos, *state, 0, model.box, **kw))


def _k3(model, pos, state, pgrp=None):
    """K3 and its plain version."""
    params = ks.law_params_array(model.law)
    kw = dict(kind=ks.law_kind(model.law), tile=64, max_events=4, dt=0.5, seed=9,
              cutbuf=model.cutbuf)
    args = (pos, *state, params, 0, model.box, 0, pgrp)
    return ks.kmc_sweep(*args, **kw), ks.kmc_sweep_reference(*args, **kw)


@pytest.mark.parametrize("route,n,in_smem", [("k1", 64, True), ("k3", 64, True),
                                             ("k1", 256, False), ("k3", 224, False)])
def test_full_rows_match_plain(dev, route, n, in_smem, monkeypatch):
    """Cutoff + buffer past half the box diagonal: every pair is in range, so
    each list is the whole row. At N=256 (K1) and N=224 (K3, the in-kernel
    route's largest N) whole-row lists do not fit in shared memory and go
    to global memory. The list lengths counted on the card equal the plain
    count, and sizing the global scratch from them (past
    LIST_SCRATCH_BUDGET, after a device sync) gives the same bits."""
    box = 10.0 * (n / 64) ** (1 / 3)
    model, pos, state = _setup(dev, n=n, p=n // 3, r=128, frames=4, box=box)
    model = PairRates(model.cell, Fermi(a=0.002, b=2.3, c=0.5).to(dev), box, 0.0)

    def run():
        if route == "k1":
            return _k1(model, pos, state)[1:]
        return _k3(model, pos, state)

    if route == "k1":
        w = kss.dense_tables(model, pos)
        caps = kss.list_caps(w)
        assert torch.equal(caps.cpu(), kss.list_caps(w.cpu()))
        plan = kss.launch_plan(n, caps.tolist(), dev)
    else:
        caps = ks.range_caps(pos, model.box, model.cutbuf)
        assert torch.equal(caps.cpu(), ks.range_caps(pos.cpu(), model.box, model.cutbuf))
        plan = ks.launch_plan(n, caps.tolist(), dev)
    assert caps.tolist() == [n - 1, n - 1] and plan["lists_in_smem"] == in_smem
    got, want = run()
    _matches_plain(got, want)
    monkeypatch.setattr(kss, "LIST_SCRATCH_BUDGET", 0)
    again = run()[0]
    for k in got:
        assert torch.equal(got[k], again[k]), k


@pytest.mark.parametrize("route", ["k1", "k3"])
def test_exact_zeros_in_range_match_plain(dev, route):
    """K1: a streamed W with a third of its in-range entries set to +0 or
    -0. K3: a Fermi law whose rate underflows to exactly 0 past
    b + 88 c = 4.06 A, inside cutoff + buffer = 5 A: the lists hold fewer
    entries than the sites in range."""
    model, pos, state = _setup(dev, n=96, p=32, r=128, frames=6, box=11.0)
    if route == "k1":
        w = kss.dense_tables(model, pos)
        g = torch.Generator(device="cpu").manual_seed(7)
        pick = (torch.rand(w.shape, generator=g) < 1 / 3).to(dev) & (w > 0)
        sign = torch.rand(w.shape, generator=g).to(dev) < 0.5
        w = torch.where(pick, torch.where(sign, 0.0, -0.0), w)
        assert bool((torch.signbit(w) & (w == 0)).any())
        w, got, want = _k1(model, pos, state, w=w)
    else:
        model = PairRates(model.cell, Fermi(a=0.2, b=2.3, c=0.02).to(dev), 3.0, 2.0)
        w = ks.inkernel_tables(pos, ks.law_params_array(model.law), model.box,
                               kind=0, cutbuf=model.cutbuf)
        assert (int(kss.list_caps(w)[0])
                < int(ks.range_caps(pos, model.box, model.cutbuf)[0]))
        got, want = _k3(model, pos, state)
    _matches_plain(got, want)


def test_k1_angle_w_matches_plain(dev):
    """K1 on the asymmetric W of AnglePairRates (FermiAngle, the P-O-O
    gate at each row's donor; 16 P atoms, each with its 4 nearest O): a
    column's list is not its row's."""
    _, pos, state = _setup(dev)
    rs = np.random.RandomState(8)
    p0 = rs.uniform(0, 10.0, size=(16, 3)).astype(np.float32)
    extras = torch.from_numpy(p0[None] + rs.normal(
        scale=0.05, size=(pos.shape[0], 16, 3)).astype(np.float32)).to(dev)
    model = AnglePairRates.from_first_frame(
        Cell.cubic([10.0] * 3, device=dev),
        FermiAngle(a=0.2, b=2.3, c=0.1, theta=1.2).to(dev), 3.0, 2.0, pos[0],
        extras[0], 4)
    w, got, want = _k1(model, pos, state, w=kss.dense_tables(model, pos, extras))
    assert not torch.equal(w != 0, (w != 0).transpose(1, 2))
    _matches_plain(got, want)


def test_k1_stale_matches_plain(dev):
    """Stale rates: the frame-start rows and total through the frame."""
    model, pos, state = _setup(dev, frames=8)
    _, got, want = _k1(model, pos, state, stale=True)
    _matches_plain(got, want)


@pytest.mark.parametrize("salt,frame,counter,occupied", [
    (1, 120944, 48, False), (2, 248351, 127, True), (1, 875943, 115, True),
], ids=["zero-source", "zero-destination", "positive-source"])
def test_race_on_a_draw_of_one(dev, salt, frame, counter, occupied):
    """A draw of exactly one (seed 3, RNG tile 0, event 0) at the counter
    of site counter % 32 in replica counter // 32, with that site occupied
    or not: K1 and K3 take the plain versions' decisions (a zero rate never
    wins, a positive one wins outright), every replica fires once, the
    occupancy stays 0 or 1 and no proton is lost."""
    key = rng.mix_key(3, 0, frame, 0, salt)
    assert float(rng.u01_counter(key, torch.tensor(counter))) == 1.0
    n, p, r, tile = 32, 16, 8, 4
    rs = np.random.RandomState(3)
    pos = torch.from_numpy(rs.uniform(0, 9.0, size=(1, n, 3)).astype(np.float32)).to(dev)
    q, site = divmod(counter, n)
    occ = np.zeros((r, n), np.float32)
    for i in range(r):
        others = rs.permutation([j for j in range(n) if j != site])
        last = site if occupied and i == q else int(others[p - 1])
        occ[i, others[:p - 1].tolist() + [last]] = 1.0
    sites = np.stack([np.flatnonzero(o) for o in occ]).astype(np.int32)
    labels = np.zeros((r, n), np.float32)
    for i in range(r):
        labels[i, sites[i]] = np.arange(1, p + 1)
    T = torch.from_numpy
    state = (pos[0], torch.zeros((n, 3), device=dev), T(occ).to(dev), T(labels).to(dev),
             T(sites).to(dev), torch.zeros((r, p), device=dev),
             torch.zeros((r, p, 3), device=dev), torch.full((r,), 1e-6, device=dev),
             torch.zeros(r, dtype=torch.int32, device=dev))
    model = PairRates(Cell.cubic([9.0] * 3, device=dev),
                      Fermi(a=0.06, b=2.3, c=0.1).to(dev), 3.0, 2.0)
    w = kss.dense_tables(model, pos)
    kw = dict(tile=tile, max_events=1, dt=0.5, seed=3)
    params = ks.law_params_array(model.law)
    k3kw = dict(kind=0, cutbuf=model.cutbuf, **kw)
    runs = [(kss.kmc_sweep_streamed(w, pos, *state, frame, model.box, **kw),
             kss.kmc_sweep_streamed_reference(w, pos, *state, frame, model.box, **kw)),
            (ks.kmc_sweep(pos, *state, params, frame, model.box, **k3kw),
             ks.kmc_sweep_reference(pos, *state, params, frame, model.box, **k3kw))]
    for got, want in runs:
        for k in INT_KEYS:
            assert torch.equal(got[k], want[k]), k
        assert torch.equal(got["ev_count"], torch.ones_like(got["ev_count"]))
        assert bool(((got["occ"] == 0) | (got["occ"] == 1)).all())
        assert torch.equal(got["occ"].sum(dim=1), torch.full((r,), float(p), device=dev))
        if salt == 1 and occupied:  # E = +0: the occupied site wins outright
            assert float(got["occ"][q, site]) == 0.0
