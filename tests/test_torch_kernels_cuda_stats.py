"""The jump statistics of K1, K3 and K4 on the card (marked ``cuda``; they
skip without one): each kernel with 6 bins and the jump matrix against its
plain version on the same inputs, K1 also in a monoclinic cell and with its
lists in global memory (whole rows at N=256), K3 also with the angle gate
(kind 4), K4 also with the residence-time blend and at N=4608 (the staged
plan of the supercells). The replicas whose integer state agrees (all but at
most one, which may part at a near-tie as in the other card tests) must
have equal histograms and an exposure equal bit for bit; the matrix must
count every fired jump and equal the plain version's where no replica
parted. And the statistics draw nothing: each kernel with them lands in the
state it reaches without them, bit for bit. ``chip_smoke.py`` holds the
same at the deployments' shapes.

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda*.py
"""

import numpy as np
import pytest
import torch

from cmdlmc_tpu_torch.core.cell import Cell
from cmdlmc_tpu_torch.engine.lattice import init_replicas
from cmdlmc_tpu_torch.ops import kmc_sweep as ks
from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss
from cmdlmc_tpu_torch.ops import topk_sweep as ts
from cmdlmc_tpu_torch.rates.laws import Fermi, FermiAngle
from cmdlmc_tpu_torch.topo.models import (
    AnglePairRates, HydroniumRates, PairRates, TopKPairRates,
)
from cmdlmc_tpu_torch.topo.transforms import DistanceInterpolator, ReLUTransformation

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

NBINS, HIST_RANGE = 6, (2.2, 3.2)
INT_KEYS = ("occ", "labels", "sites", "ev_count", "trunc")
STATE_KEYS = ("occ", "labels", "sites", "tlast", "disp_base", "u_rem", "ev_count",
              "trunc", "site_disp", "prev_pos")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _setup(dev, n=64, p=24, r=256, frames=12, box=10.0, cell_rows=None):
    """A jittered block (sites uniform in fractional coordinates), the cell,
    the replica state and zeroed-but-for-noise histograms."""
    rng = np.random.RandomState(5)
    rows = np.asarray(cell_rows if cell_rows is not None else np.eye(3) * box)
    base = (rng.uniform(0, 1, size=(n, 3)) @ rows).astype(np.float32)
    block = (base[None] + rng.normal(scale=0.05, size=(frames, n, 3))).astype(np.float32)
    cell = (Cell.cubic([box] * 3, device=dev) if cell_rows is None
            else Cell.triclinic(cell_rows, device=dev))
    pos = torch.from_numpy(block).to(dev)
    ens = init_replicas(torch.Generator().manual_seed(2), r, n, p, pos[0], device=dev,
                        hist_bins=NBINS)
    rep = ens.replicas
    state = [ens.prev_pos, ens.site_disp, rep.occ, rep.proton_of_site.float(),
             rep.site_of_proton, rep.t_last_jump, rep.disp_base,
             rep.clock.u_remaining, rep.clock.event_count]
    hist = torch.from_numpy(rng.randint(0, 9, (r, NBINS)).astype(np.int32)).to(dev)
    expo = torch.from_numpy(rng.randint(0, 99, (r, NBINS)).astype(np.float32)).to(dev)
    return cell, pos, state, dict(jump_hist=hist, exposure=expo, nbins=NBINS,
                                  hist_range=HIST_RANGE, track_matrix=True)


def _hold(got, want, ev0):
    torch.cuda.synchronize()
    r = ev0.shape[0]
    same = torch.ones(r, dtype=torch.bool, device=ev0.device)
    for k in INT_KEYS:
        same &= (got[k] == want[k]).reshape(r, -1).all(dim=1)
    assert int((~same).sum()) <= 1
    assert torch.equal(got["jump_hist"][same], want["jump_hist"][same])
    assert torch.equal(got["exposure"][same], want["exposure"][same])
    for out in (got, want):
        assert int(out["jump_matrix"].sum()) == int((out["ev_count"] - ev0).sum()) > 0
    if bool(same.all()):
        assert torch.equal(got["jump_matrix"], want["jump_matrix"])
    torch.testing.assert_close(got["u_rem"][same], want["u_rem"][same],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got["disp_base"][same], want["disp_base"][same],
                               rtol=0.0, atol=1e-4)


def _k1_case(dev, name):
    if name == "whole_rows":  # every pair in range: lists in global memory
        n = 256
        cell, pos, state, stats = _setup(dev, n=n, p=96, r=128, frames=6, box=16.0)
        model = PairRates(cell, Fermi(a=0.2, b=2.3, c=0.5).to(dev), 16.0, 0.0)
    else:
        rows = [[10.0, 0.0, 0.0], [2.0, 9.5, 0.0], [0.0, 0.0, 10.0]]
        cell, pos, state, stats = _setup(
            dev, cell_rows=rows if name == "monoclinic" else None)
        model = PairRates(cell, Fermi(a=0.2, b=2.3, c=0.1).to(dev), 3.0, 1.0)
    w, dist = kss.dense_tables(model, pos, nbins=NBINS)
    kw = dict(tile=64, max_events=4, dt=0.5, seed=3,
              geometry=None if cell.orthorhombic else model.geometry,
              dist_block=dist)
    return model, w, pos, state, stats, kw


@pytest.mark.parametrize("name", ["cubic", "monoclinic", "whole_rows"])
def test_k1_statistics_match_plain(dev, name):
    model, w, pos, state, stats, kw = _k1_case(dev, name)
    if name == "whole_rows":
        plan = kss.launch_plan(w.shape[-1], kss.list_caps(w).tolist(), dev,
                               nbins=NBINS, track_matrix=True)
        assert not plan["lists_in_smem"]
    got = kss.kmc_sweep_streamed(w, pos, *state, 0, model.box, **kw, **stats)
    want = kss.kmc_sweep_streamed_reference(w, pos, *state, 0, model.box, **kw,
                                            **stats)
    _hold(got, want, state[8])


@pytest.mark.parametrize("kind", [0, 4])
def test_k3_statistics_match_plain(dev, kind):
    """Kind 0 (Fermi) and kind 4 (FermiAngle, the angle gate K3 evaluates
    from each donor's grouped P atoms)."""
    cell, pos, state, stats = _setup(dev)
    pgrp = None
    if kind == 0:
        model = PairRates(cell, Fermi(a=0.2, b=2.3, c=0.1).to(dev), 3.0, 2.0)
    else:
        rng = np.random.RandomState(8)
        p0 = rng.uniform(0, 10.0, size=(16, 3)).astype(np.float32)
        extras = torch.from_numpy(p0[None] + rng.normal(
            scale=0.05, size=(pos.shape[0], 16, 3)).astype(np.float32)).to(dev)
        model = AnglePairRates.from_first_frame(
            cell, FermiAngle(a=0.2, b=2.3, c=0.1, theta=1.2).to(dev), 3.0, 2.0,
            pos[0], extras[0], 4)
        pgrp = model.grouped_positions(extras)
    args = (pos, *state, ks.law_params_array(model.law), 0, model.box, 0, pgrp)
    kw = dict(kind=kind, tile=64, max_events=4, dt=0.5, seed=9, cutbuf=model.cutbuf)
    _hold(ks.kmc_sweep(*args, **kw, **stats),
          ks.kmc_sweep_reference(*args, **kw, **stats), state[8])


def _k4_case(dev, name):
    """TopKPairRates k=8 at N=64 ("topk") or past LARGE_N ("staged": 32
    warps, the frame's first evaluation staged through shared memory, the
    plan the supercells take), or the blended HydroniumRates k=4."""
    if name == "staged":
        n = 4608
        cell, pos, state, stats = _setup(dev, n=n, p=3072, r=128, frames=3,
                                         box=10.0 * (n / 64) ** (1 / 3))
    else:
        cell, pos, state, stats = _setup(dev)
    blend = name == "hydronium"
    law = Fermi(a=0.2, b=2.3, c=0.1).to(dev)
    if blend:
        model = HydroniumRates(
            cell, law, 3.0, 2.0, k=4,
            transform=ReLUTransformation(a=0.5, b=2.2, d0=2.2, left_bound=2.0,
                                         right_bound=3.3).to(dev),
            interpolator=DistanceInterpolator(relaxation_time=2.0).to(dev))
    else:
        model = TopKPairRates(cell, law, 3.0, 2.0, k=8)
    tables = ts.topk_tables(model, pos, precompute_law=not blend)
    labels = state[3]
    tls = ts.entry_tlast_site(state[2], labels, state[5])
    args = (pos, *tables, *state[:6], tls, *state[6:], ts.law_params8(model), 0,
            model.geometry, 0)
    kw = dict(orthorhombic=True, kind=0, tile=64, max_events=4, dt=0.5, seed=9,
              blend=blend)
    return args, kw, stats, state


@pytest.mark.parametrize("name", ["topk", "hydronium", "staged"])
def test_k4_statistics_match_plain(dev, name):
    args, kw, stats, state = _k4_case(dev, name)
    if name == "staged":  # the statistics' counters shift the staged buffers
        n, k = args[0].shape[1], args[1].shape[1]
        plan = ts.sweep_plan(state[2].shape[0], n, k, False, dev, NBINS)
        assert plan["warps"] == 32 and plan["stage_tile"] > 0
    _hold(ts.topk_sweep(*args, **kw, **stats),
          ts.topk_sweep_reference(*args, **kw, **stats), state[8])


@pytest.mark.parametrize("kernel", ["k1", "k3", "k4"])
def test_statistics_leave_the_trajectory(dev, kernel):
    """The kernel with statistics and the one without (the default entry
    point) land in the same state bit for bit."""
    if kernel == "k1":
        model, w, pos, state, stats, kw = _k1_case(dev, "cubic")
        kw.pop("geometry")
        dist = kw.pop("dist_block")
        off = kss.kmc_sweep_streamed(w, pos, *state, 0, model.box, **kw)
        on = kss.kmc_sweep_streamed(w, pos, *state, 0, model.box, dist_block=dist,
                                    **kw, **stats)
    elif kernel == "k3":
        cell, pos, state, stats = _setup(dev)
        model = PairRates(cell, Fermi(a=0.2, b=2.3, c=0.1).to(dev), 3.0, 2.0)
        args = (pos, *state, ks.law_params_array(model.law), 0, model.box, 0, None)
        kw = dict(kind=0, tile=64, max_events=4, dt=0.5, seed=9, cutbuf=model.cutbuf)
        off, on = ks.kmc_sweep(*args, **kw), ks.kmc_sweep(*args, **kw, **stats)
    else:
        args, kw, stats, state = _k4_case(dev, "topk")
        off, on = ts.topk_sweep(*args, **kw), ts.topk_sweep(*args, **kw, **stats)
    torch.cuda.synchronize()
    for k in STATE_KEYS:
        assert torch.equal(off[k], on[k]), k
    assert int(on["jump_matrix"].sum()) == int((on["ev_count"] - state[8]).sum()) > 0
