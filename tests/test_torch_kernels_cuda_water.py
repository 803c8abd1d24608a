"""Water kernel checks that need the card (marked ``cuda``; they skip
without one): K7 against its plain version, chunk and block-width
invariance, its refusals and the pick on a draw of one. On a machine with a
GPU and no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda_water.py
"""

import numpy as np
import pytest
import torch

from test_torch_kernels_cuda import dev

pytestmark = pytest.mark.cuda


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
