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
from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss
from cmdlmc_tpu_torch.ops.pairwise import pairwise_cubic
from cmdlmc_tpu_torch.rates.laws import Fermi
from cmdlmc_tpu_torch.topo.models import PairRates

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
