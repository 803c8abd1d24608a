"""Dense-kernel checks that need the card (marked ``cuda``; they skip
without one): K2, K1 and K3. ``chip_smoke.py`` holds each kernel against its
plain version at the deployments' shapes; these add the wrappers' refusals
and the kernels' own invariants. The sparse event loop's cases are in
``test_torch_kernels_cuda_sparse.py``, the top-K and water kernels' in
``test_torch_kernels_cuda_topk.py`` and ``test_torch_kernels_cuda_water.py``.
On a machine with a GPU and no jax, all of them:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda*.py
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

torch.set_num_threads(1)

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
    """At N=256, where the dense W[f] did not fit in shared memory (K1 read
    it from global memory), the 32-warp block's own arrays leave too little
    shared memory for the lists, which go to global memory; K1 must agree
    with its plain version."""
    n = 256
    model, pos, state = _setup(dev, n=n, p=96, r=128, frames=6, box=16.0)
    w = kss.dense_tables(model, pos)
    assert 4 * n * (n + 1) > 232448
    assert not kss.launch_plan(n, kss.list_caps(w).tolist(), dev)["lists_in_smem"]
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


