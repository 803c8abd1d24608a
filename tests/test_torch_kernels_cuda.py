"""Kernel checks that need the card (marked ``cuda``; they skip without one).
``chip_smoke.py`` holds each kernel against its plain version; these add the
wrappers' refusals and the kernels' own invariants. On a machine with a GPU
and no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from cmdlmc_tpu_torch.core.cell import Cell
from cmdlmc_tpu_torch.engine.lattice import init_replicas
from cmdlmc_tpu_torch.ops import kmc_sweep as ks
from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss
from cmdlmc_tpu_torch.ops.pairwise import pairwise_cubic
from cmdlmc_tpu_torch.rates.laws import Fermi, FermiAngle
from cmdlmc_tpu_torch.topo.models import AnglePairRates, PairRates

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _setup(dev, n=64, p=24, r=256, frames=12, box=10.0):
    rng = np.random.RandomState(5)
    base = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    block = (base[None] + rng.normal(scale=0.05, size=(frames, n, 3))).astype(np.float32)
    model = PairRates(Cell.cubic([box] * 3, device=dev),
                      Fermi(a=0.2, b=2.3, c=0.1).to(dev), 3.0, 2.0)
    pos = torch.from_numpy(block).to(dev)
    ens = init_replicas(torch.Generator().manual_seed(2), r, n, p, pos[0], device=dev)
    rep = ens.replicas
    state = (ens.prev_pos, ens.site_disp, rep.occ, rep.proton_of_site.float(),
             rep.site_of_proton, rep.t_last_jump, rep.disp_base,
             rep.clock.u_remaining, rep.clock.event_count)
    return model, pos, state


def test_k2_batched_equals_per_frame(dev):
    pos = torch.rand((5, 200, 3), device=dev) * 12.0
    whole = pairwise_cubic(pos, (12.0, 12.0, 12.0))
    for f in range(5):
        assert torch.equal(whole[f], pairwise_cubic(pos[f:f + 1], (12.0,) * 3)[0])


def test_k1_chunk_invariant(dev):
    """12 frames in one launch == 5 + 7 (draws are keyed by absolute frame)."""
    model, pos, state = _setup(dev)
    w = kss.dense_tables(model, pos)
    kw = dict(tile=64, max_events=4, dt=0.5, seed=9)
    whole = kss.kmc_sweep_streamed(w, pos, *state, 0, model.box, **kw)
    a = kss.kmc_sweep_streamed(w[:5], pos[:5], *state, 0, model.box, **kw)
    keys = ("occ", "labels", "sites", "tlast", "disp_base", "u_rem", "ev_count")
    b = kss.kmc_sweep_streamed(w[5:], pos[5:], a["prev_pos"], a["site_disp"],
                               *[a[k] for k in keys], 5, model.box, **kw)
    torch.cuda.synchronize()
    for k in ("occ", "labels", "sites", "ev_count", "u_rem", "tlast", "disp_base"):
        assert torch.equal(whole[k], b[k]), k
    assert torch.equal(whole["trunc"], a["trunc"] + b["trunc"])
    assert int(whole["ev_count"].sum()) > 0


def test_k1_global_w_path_matches_plain(dev):
    """At N=256 W[f] does not fit in shared memory: K1 reads it from global
    memory and must still agree with its plain version."""
    n = 256
    assert not kss.w_in_shared_memory(n, dev)
    model, pos, state = _setup(dev, n=n, p=96, r=128, frames=6, box=16.0)
    w = kss.dense_tables(model, pos)
    kw = dict(tile=64, max_events=4, dt=0.5, seed=3)
    got = kss.kmc_sweep_streamed(w, pos, *state, 0, model.box, **kw)
    want = kss.kmc_sweep_streamed_reference(w, pos, *state, 0, model.box, **kw)
    same = torch.ones(128, dtype=torch.bool, device=dev)
    for k in ("occ", "labels", "sites", "ev_count", "trunc"):
        same &= (got[k] == want[k]).reshape(128, -1).all(dim=1)
    assert int((~same).sum()) <= 1
    assert int(want["ev_count"].sum()) > 0
    for k, rtol, atol in (("u_rem", 1e-5, 1e-5), ("tlast", 1e-5, 1e-5),
                          ("disp_base", 0.0, 1e-4)):
        assert torch.allclose(got[k][same], want[k][same], rtol=rtol, atol=atol), k


def test_wrappers_refuse_bad_cuda_inputs(dev):
    """A CUDA tensor reaches the kernel or raises: never the plain version."""
    model, pos, state = _setup(dev)
    w = kss.dense_tables(model, pos)
    before = kss.kmc_sweep_streamed.launches
    with pytest.raises(ValueError, match="sites"):
        bad = list(state)
        bad[4] = bad[4].long()
        kss.kmc_sweep_streamed(w, pos, *bad, 0, model.box, tile=64,
                               max_events=4, dt=0.5, seed=1)
    with pytest.raises(ValueError, match="float32"):
        pairwise_cubic(pos.double(), model.box)
    assert kss.kmc_sweep_streamed.launches == before


def _k3_model(dev, kind, pos, n_p=16, box=10.0):
    """Fermi (kind 0) PairRates, or FermiAngle (kind 4) AnglePairRates with
    random P atoms, and each donor's grouped P positions."""
    cell = Cell.cubic([box] * 3, device=dev)
    if kind == 0:
        return PairRates(cell, Fermi(a=0.2, b=2.3, c=0.1).to(dev), 3.0, 2.0), None
    rng = np.random.RandomState(8)
    p0 = rng.uniform(0, box, size=(n_p, 3)).astype(np.float32)
    extras = torch.from_numpy(p0[None] + rng.normal(
        scale=0.05, size=(pos.shape[0], n_p, 3)).astype(np.float32)).to(dev)
    model = AnglePairRates.from_first_frame(
        cell, FermiAngle(a=0.2, b=2.3, c=0.1, theta=1.2).to(dev), 3.0, 2.0,
        pos[0], extras[0], 4)
    return model, model.grouped_positions(extras)


@pytest.mark.parametrize("kind", [0, 4])
def test_k3_matches_plain_and_is_chunk_invariant(dev, kind):
    """K3 against its plain version (at most one replica parting, as K1's
    check) and 12 frames in one launch == 5 + 7; every warps-per-block
    launch shape gives the same bits."""
    _, pos, state = _setup(dev)
    model, pgrp = _k3_model(dev, kind, pos)
    params = ks.law_params_array(model.law)
    kw = dict(kind=kind, tile=64, max_events=4, dt=0.5, seed=9, cutbuf=model.cutbuf)
    whole = ks.kmc_sweep(pos, *state, params, 0, model.box, 0, pgrp, **kw)
    want = ks.kmc_sweep_reference(pos, *state, params, 0, model.box, 0, pgrp, **kw)
    same = torch.ones(256, dtype=torch.bool, device=dev)
    for k in ("occ", "labels", "sites", "ev_count", "trunc"):
        same &= (whole[k] == want[k]).reshape(256, -1).all(dim=1)
    assert int((~same).sum()) <= 1
    assert int(want["ev_count"].sum()) > 0
    torch.testing.assert_close(whole["u_rem"][same], want["u_rem"][same],
                               rtol=1e-5, atol=1e-5)
    sl = (lambda a, b: None) if pgrp is None else (lambda a, b: pgrp[a:b])
    a = ks.kmc_sweep(pos[:5], *state, params, 0, model.box, 0, sl(0, 5), **kw)
    keys = ("occ", "labels", "sites", "tlast", "disp_base", "u_rem", "ev_count")
    b = ks.kmc_sweep(pos[5:], a["prev_pos"], a["site_disp"],
                     *[a[k] for k in keys], params, 5, model.box, 0, sl(5, 12), **kw)
    for k in keys:
        assert torch.equal(whole[k], b[k]), k
    assert torch.equal(whole["trunc"], a["trunc"] + b["trunc"])
    for warps in (2, 4, 16):
        other = ks.kmc_sweep(pos, *state, params, 0, model.box, 0, pgrp,
                             warps=warps, **kw)
        for k in keys:
            assert torch.equal(whole[k], other[k]), (warps, k)


def test_k3_refuses_bad_cuda_inputs(dev):
    """A CUDA tensor reaches K3 or raises: never the plain version."""
    _, pos, state = _setup(dev)
    model, _ = _k3_model(dev, 0, pos)
    params = ks.law_params_array(model.law)
    kw = dict(kind=0, tile=64, max_events=4, dt=0.5, seed=1, cutbuf=model.cutbuf)
    before = ks.kmc_sweep.launches
    bad = list(state)
    bad[2] = bad[2].double()
    with pytest.raises(ValueError, match="occ"):
        ks.kmc_sweep(pos, *bad, params, 0, model.box, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        ks.kmc_sweep(pos, *state, params, 0, model.box, warps=4096, **kw)
    assert ks.kmc_sweep.launches == before


def test_k5_matches_plain(dev):
    """K5 against its plain version on random positions (no ties): equal
    indices, distances within an ulp."""
    from cmdlmc_tpu_torch.ops import knn_tables as knn

    pos = torch.rand((4, 200, 3), device=dev) * 13.0
    for k in (1, 8, 16):
        got_d, got_i = knn.knn_block_tables(pos, (13.0,) * 3, 5.0, k)
        want_d, want_i = knn.knn_block_tables_reference(pos, (13.0,) * 3, 5.0, k)
        assert torch.equal(got_i, want_i), k
        torch.testing.assert_close(got_d, want_d, rtol=2.4e-7, atol=0)
    assert knn.knn_block_tables.launches >= 3


def _k4_setup(dev, name, n=64, p=24, r=256, frames=12, box=10.0):
    """A TopKPairRates (k=8) or blended HydroniumRates (k=4) model over the
    _setup trajectory, its stage-1 tables, and the replica state in the
    sweep's order (tlast_site from the state)."""
    from cmdlmc_tpu_torch.ops import topk_sweep as ts
    from cmdlmc_tpu_torch.topo.models import HydroniumRates, TopKPairRates
    from cmdlmc_tpu_torch.topo.transforms import DistanceInterpolator, ReLUTransformation

    _, pos, state = _setup(dev, n=n, p=p, r=r, frames=frames, box=box)
    cell = Cell.cubic([box] * 3, device=dev)
    law = Fermi(a=0.2, b=2.3, c=0.1).to(dev)
    if name == "topk":
        model = TopKPairRates(cell, law, 3.0, 2.0, k=8)
    else:
        model = HydroniumRates(
            cell, law, 3.0, 2.0,
            transform=ReLUTransformation(a=0.5, b=2.2, d0=2.2, left_bound=2.0,
                                         right_bound=3.3).to(dev),
            interpolator=DistanceInterpolator(relaxation_time=2.0).to(dev), k=4)
    blend = ts.has_blend(model)
    tables = ts.topk_tables(model, pos, precompute_law=not blend)
    prev, s, occ, labels, sites, tlast, db, u, evc = state
    tls = ts.entry_tlast_site(occ, labels, tlast)
    kw = dict(orthorhombic=True, kind=0, tile=64, max_events=4, dt=0.5, seed=9,
              blend=blend)
    return model, pos, tables, [prev, s, occ, labels, sites, tlast, tls, db, u, evc], kw


@pytest.mark.parametrize("name", ["topk", "hydronium"])
def test_k4_matches_plain_and_is_chunk_invariant(dev, name):
    """K4 against its plain version (at most one replica parting), and 12
    frames in one launch == 5 + 7."""
    from cmdlmc_tpu_torch.ops import topk_sweep as ts

    model, pos, tables, state, kw = _k4_setup(dev, name)
    params = ts.law_params8(model)
    geom = model.geometry
    whole = ts.topk_sweep(pos, *tables, *state, params, 0, geom, **kw)
    want = ts.topk_sweep_reference(pos, *tables, *state, params, 0, geom, **kw)
    same = torch.ones(256, dtype=torch.bool, device=dev)
    for k in ("occ", "labels", "sites", "ev_count", "trunc"):
        same &= (whole[k] == want[k]).reshape(256, -1).all(dim=1)
    assert int((~same).sum()) <= 1
    assert int(want["ev_count"].sum()) > 0
    torch.testing.assert_close(whole["u_rem"][same], want["u_rem"][same],
                               rtol=1e-5, atol=1e-5)
    keys = ("occ", "labels", "sites", "tlast", "tlast_site", "disp_base", "u_rem",
            "ev_count")
    a = ts.topk_sweep(pos[:5], *[t[:5] for t in tables], *state, params, 0, geom, **kw)
    b = ts.topk_sweep(pos[5:], *[t[5:] for t in tables], a["prev_pos"], a["site_disp"],
                      *[a[k] for k in keys], params, 5, geom, **kw)
    for k in keys:
        assert torch.equal(whole[k], b[k]), k
    assert torch.equal(whole["trunc"], a["trunc"] + b["trunc"])


def test_k4_refuses_bad_cuda_inputs(dev):
    """A CUDA tensor reaches K4 or raises: never the plain version."""
    from cmdlmc_tpu_torch.ops import topk_sweep as ts

    model, pos, tables, state, kw = _k4_setup(dev, "topk")
    before = ts.topk_sweep.launches
    bad = list(state)
    bad[6] = bad[6].double()
    with pytest.raises(ValueError, match="tlast_site"):
        ts.topk_sweep(pos, *tables, *bad, ts.law_params8(model), 0, model.geometry, **kw)
    with pytest.raises(ValueError, match="topi"):
        ts.topk_sweep(pos, tables[0], tables[1].long(), tables[2], *state,
                      ts.law_params8(model), 0, model.geometry, **kw)
    assert ts.topk_sweep.launches == before


@pytest.mark.parametrize("name", ["topk", "hydronium"])
def test_k4_global_layout_matches_plain(dev, name):
    """Past 14,528 sites K4's state leaves shared memory for global scratch
    (its global layout); there too it agrees with its plain version."""
    from cmdlmc_tpu_torch.ops import topk_sweep as ts

    n, r = 14976, 64
    model, pos, tables, state, kw = _k4_setup(
        dev, name, n=n, p=5616, r=r, frames=3, box=10.0 * (n / 64) ** (1 / 3))
    k = tables[0].shape[1]
    assert ts.sweep_scratch_bytes(256, 64, k, kw["blend"], dev) == 0
    assert ts.sweep_scratch_bytes(r, n, k, kw["blend"], dev) > 0
    args = (pos, *tables, *state, ts.law_params8(model), 0, model.geometry)
    got = ts.topk_sweep(*args, **kw)
    want = ts.topk_sweep_reference(*args, **kw)
    same = torch.ones(r, dtype=torch.bool, device=dev)
    for key in ("occ", "labels", "sites", "ev_count", "trunc"):
        same &= (got[key] == want[key]).reshape(r, -1).all(dim=1)
    assert int((~same).sum()) <= 1
    assert int(want["ev_count"].sum()) > 0


def test_k6_equals_k5(dev):
    """K6 over a plan equals K5 bit for bit, at k=8 and k=16 and with plan
    shapes of the card's sizes (which prune here) and of the JAX package's
    (which keep every chunk of these 3000 sites)."""
    from cmdlmc_tpu_torch.ops import knn_sparse as kns
    from cmdlmc_tpu_torch.ops import knn_tables as knn

    rng = np.random.RandomState(3)
    base = rng.uniform(0, 40.0, size=(3000, 3)).astype(np.float32)
    walk = np.cumsum(rng.normal(scale=0.05, size=(6, 3000, 3)), axis=0)
    pos = torch.from_numpy((base[None] + walk).astype(np.float32)).to(dev)
    for rc, tc in ((kns.RC, kns.TC), (512, 512), (32, 64)):
        plan = kns.sparse_plan_for(pos, (40.0,) * 3, 5.0, min_n=0, max_ratio=1.0,
                                   rc=rc, tc=tc)
        assert (plan.lists.shape[1] < plan.n_ch) == (rc < 512)
        for k in (8, 16):
            got = kns.knn_sparse_tables(pos, (40.0,) * 3, 5.0, k, plan)
            want = knn.knn_block_tables(pos, (40.0,) * 3, 5.0, k)
            assert torch.equal(got[1], want[1]), (rc, tc, k)
            assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


def _k7_setup(dev, n=216, r=512, frames=12, box=18.6, k=3, tkind=1):
    """Jittered frames on the card, their water tables (K5, no cutoff) and a
    fresh water state; the linear transform of the water deployment."""
    from cmdlmc_tpu_torch.ops import water_sweep as ws

    rng = np.random.RandomState(6)
    base = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    block = (base[None] + rng.normal(scale=0.03, size=(frames, n, 3))).astype(np.float32)
    pos = torch.from_numpy(block).to(dev)
    tables = ws.water_tables(pos, (box,) * 3, k, tkind,
                             np.array([0.5, 1.2, 0.0, 0.0, 10.0], np.float32))
    i32 = dict(dtype=torch.int32, device=dev)
    g = torch.Generator().manual_seed(4)
    state = [torch.randint(0, n, (r,), generator=g, dtype=torch.int32).to(dev),
             torch.full((r,), -1, **i32), torch.full((r,), 10**9, **i32),
             torch.zeros(r, **i32), torch.zeros(r, **i32), torch.zeros(r, **i32),
             torch.rand(r, generator=g).to(dev), torch.zeros((r, 3), device=dev),
             torch.zeros((r, 3), device=dev)]
    kw = dict(kind=0, tile=256, max_events=4, dt=0.5, seed=5, relax=10, waiting=0,
              keep_last=True, check_old=True, d_oh=0.3)
    law = np.array([0.06, 2.3, 0.1, 0, 0, 0], np.float32)
    return pos, tables, pos[0].clone(), torch.zeros((n, 3), device=dev), state, \
        torch.from_numpy(law), (box,) * 3, kw


def test_k7_matches_plain_and_is_chunk_invariant(dev):
    """K7 against its plain version (at most one replica parting, at a
    near-tie), 12 frames in one launch == 5 + 7, and the CUDA block size
    changes nothing."""
    from cmdlmc_tpu_torch.ops import water_sweep as ws

    pos, tables, prev, sd, state, law, box, kw = _k7_setup(dev)
    args = (pos, *tables, prev, sd, *state, law, 0, box)
    whole = ws.water_sweep(*args, **kw)
    want = ws.water_sweep_reference(*args, **kw)
    ints = ("site", "last", "fsj", "wait", "jumps", "ev_count", "trunc")
    same = torch.ones(state[0].shape[0], dtype=torch.bool, device=dev)
    for k in ints:
        same &= whole[k] == want[k]
    assert int((~same).sum()) <= 1
    assert int(want["ev_count"].sum()) > 0
    torch.testing.assert_close(whole["u_rem"][same], want["u_rem"][same],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(whole["site_disp"], want["site_disp"], rtol=0, atol=0)
    wide = ws.water_sweep(*args, block_threads=128, **kw)
    for k in ints + ("u_rem", "corr", "disp_base"):
        assert torch.equal(whole[k], wide[k]), k
    a = ws.water_sweep(pos[:5], *[t[:5] for t in tables], prev, sd, *state, law, 0,
                       box, **kw)
    b = ws.water_sweep(pos[5:], *[t[5:] for t in tables], a["prev_pos"], a["site_disp"],
                       *[a[k] for k in ws.STATE_KEYS], law, 5, box, **kw)
    for k in ws.STATE_KEYS + ("site_disp", "prev_pos"):
        assert torch.equal(whole[k], b[k]), k
    assert torch.equal(whole["trunc"], a["trunc"] + b["trunc"])


def test_k7_refuses_bad_cuda_inputs(dev):
    """A CUDA tensor reaches K7 or raises: never the plain version."""
    from cmdlmc_tpu_torch.ops import water_sweep as ws

    pos, tables, prev, sd, state, law, box, kw = _k7_setup(dev, r=256, frames=2)
    before = ws.water_sweep.launches
    bad = list(state)
    bad[1] = bad[1].long()
    with pytest.raises(ValueError, match="last"):
        ws.water_sweep(pos, *tables, prev, sd, *bad, law, 0, box, **kw)
    with pytest.raises(ValueError, match="tile"):
        ws.water_sweep(pos, *tables, prev, sd, *state, law, 0, box, **{**kw, "tile": 100})
    assert ws.water_sweep.launches == before


def test_k7_pick_on_a_draw_of_one(dev):
    """K7 takes the last positive slot where a draw of exactly 1.0 lands
    B4's pick on a zero rate (as tests/test_torch_water.py shows for the
    plain version; ROADMAP queue C item 7)."""
    from cmdlmc_tpu_torch.ops import water_sweep as ws

    frame, r, tile = 2051326, 3, 16  # a pick draw of 1.0 at seed 3, tile 0
    pos = torch.tensor([[[0, 0, 0], [1.0, 0, 0], [0, 1.5, 0], [20.0, 0, 0],
                         [0, 0, 21.0]]], device=dev)
    box = (60.0,) * 3
    tables = ws.water_tables(pos, box, 3, ws.T_NONE, np.zeros(5, np.float32))
    z = torch.zeros(tile, dtype=torch.int32, device=dev)
    state = [z, z - 1, z + 10**9, z, z, z, torch.zeros(tile, device=dev),
             torch.zeros((tile, 3), device=dev), torch.zeros((tile, 3), device=dev)]
    law = torch.tensor([0.06, 2.3, 0.1, 0, 0, 0])
    kw = dict(kind=0, tile=tile, max_events=1, dt=0.5, seed=3, relax=0, waiting=0,
              keep_last=False, check_old=False, d_oh=0.0)
    out = ws.water_sweep(pos, *tables, pos[0], torch.zeros((5, 3), device=dev),
                         *state, law, frame, box, **kw)
    assert int(out["ev_count"][r]) == 1 and int(out["site"][r]) == 2
