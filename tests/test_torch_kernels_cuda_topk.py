"""Top-K kernel checks that need the card (marked ``cuda``; they skip
without one): K5 and K4 against their plain versions, K4's refusals, its
global-memory layout, its determinism, a slot that empties and 16 events a
frame, K6 against K5. ``chip_smoke.py`` holds each kernel
against its plain version at the deployments' shapes. On a machine with a
GPU and no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda_topk.py
"""

import numpy as np
import pytest
import torch

from cmdlmc_tpu_torch.core.cell import Cell
from cmdlmc_tpu_torch.rates.laws import Fermi

from test_torch_kernels_cuda import _setup, dev

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


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


def _k4_setup(dev, name, n=64, p=24, r=256, frames=12, box=10.0, cutoff=3.0,
              buffer=2.0, max_events=4):
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
        model = TopKPairRates(cell, law, cutoff, buffer, k=8)
    else:
        model = HydroniumRates(
            cell, law, cutoff, buffer,
            transform=ReLUTransformation(a=0.5, b=2.2, d0=2.2, left_bound=2.0,
                                         right_bound=3.3).to(dev),
            interpolator=DistanceInterpolator(relaxation_time=2.0).to(dev), k=4)
    blend = ts.has_blend(model)
    tables = ts.topk_tables(model, pos, precompute_law=not blend)
    prev, s, occ, labels, sites, tlast, db, u, evc = state
    tls = ts.entry_tlast_site(occ, labels, tlast)
    kw = dict(orthorhombic=True, kind=0, tile=64, max_events=max_events, dt=0.5,
              seed=9, blend=blend)
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
    assert ts.sweep_plan(256, 64, k, kw["blend"], dev)["scratch"] == 0
    plan = ts.sweep_plan(r, n, k, kw["blend"], dev)
    assert plan["scratch"] > 0 and plan["stage_tile"] > 0
    _hold_to_plain(model, pos, tables, state, kw)


def _hold_to_plain(model, pos, tables, state, kw):
    """K4 against its plain version: at most one replica parting, events
    fired; returns the plain version's output."""
    from cmdlmc_tpu_torch.ops import topk_sweep as ts

    args = (pos, *tables, *state, ts.law_params8(model), 0, model.geometry)
    got = ts.topk_sweep(*args, **kw)
    want = ts.topk_sweep_reference(*args, **kw)
    r = state[2].shape[0]
    same = torch.ones(r, dtype=torch.bool, device=pos.device)
    for key in ("occ", "labels", "sites", "ev_count", "trunc"):
        same &= (got[key] == want[key]).reshape(r, -1).all(dim=1)
    assert int((~same).sum()) <= 1
    assert int(want["ev_count"].sum()) > 0
    torch.testing.assert_close(got["u_rem"][same], want["u_rem"][same],
                               rtol=1e-5, atol=1e-5)
    return want


def test_k4_two_launches_give_the_same_bits(dev):
    """No float atomics: the carried sums, and every output, repeat bit for
    bit from launch to launch."""
    from cmdlmc_tpu_torch.ops import topk_sweep as ts

    model, pos, tables, state, kw = _k4_setup(dev, "topk")
    args = (pos, *tables, *state, ts.law_params8(model), 0, model.geometry)
    first, second = ts.topk_sweep(*args, **kw), ts.topk_sweep(*args, **kw)
    for key, a in first.items():
        b = second[key]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), key


def test_k4_slot_that_empties(dev):
    """Three protons among sites with few neighbours in range (many slots
    exhausted): moves take slots' last positive candidates away, and K4,
    whose carried sum of such a slot must be +0 exactly, agrees with its
    plain version."""
    model, pos, tables, state, kw = _k4_setup(dev, "topk", p=3, cutoff=1.6,
                                              buffer=0.4)
    valid = tables[0] < 1.0e5  # [B, K, N]
    assert bool((valid[:, 0] & ~valid[:, -1]).any())  # sites with exhausted slots
    want = _hold_to_plain(model, pos, tables, state, kw)
    assert int(want["ev_count"].sum() - state[9].sum()) > 100


def test_k4_sixteen_events_a_frame_match_plain(dev):
    """max_events = 16: the carried sums take up to 16 rounded deltas a
    frame (more events fire than under a budget of 4), and K4 still agrees
    with its plain version."""
    from cmdlmc_tpu_torch.ops import topk_sweep as ts

    model, pos, tables, state, kw = _k4_setup(dev, "topk", max_events=16)
    want = _hold_to_plain(model, pos, tables, state, kw)
    four = ts.topk_sweep_reference(pos, *tables, *state, ts.law_params8(model), 0,
                                   model.geometry, **{**kw, "max_events": 4})
    assert int(want["ev_count"].sum()) > int(four["ev_count"].sum())


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
        plan = kns.SparsePlan(*kns.plan_sparse(pos.cpu().numpy(), (40.0,) * 3, 5.0,
                                               rc=rc, tc=tc), rc, tc)
        assert (plan.lists.shape[1] < plan.n_ch) == (rc < 512)
        for k in (8, 16):
            got = kns.knn_sparse_tables(pos, (40.0,) * 3, 5.0, k, plan)
            want = knn.knn_block_tables(pos, (40.0,) * 3, 5.0, k)
            assert torch.equal(got[1], want[1]), (rc, tc, k)
            assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
