"""K5's cell route and K7's prefix table on the card (marked ``cuda``; they
skip without one): K5 against its plain version bit for bit on the cell
route (a supercell with unwrapped positions and an exact-tie lattice, and the
no-cutoff water tables with the verified search and its rescans), two
launches giving the same bits; K7 at narrow blocks against its plain version
and against its wide blocks, its prefix pre-pass against
``water_prefix_reference``. ``chip_smoke.py`` also holds both against the
earlier kernels' outputs. On a machine with a GPU and no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda_knn.py
"""

import numpy as np
import pytest
import torch

from test_torch_kernels_cuda import dev
from test_torch_kernels_cuda_water import _k7_setup

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


def _same_tables(got, want):
    return (torch.equal(got[1], want[1])
            and torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)))


def _supercell(dev):
    """[8, 4608] on 9 x 9 x 10 cells: four random frames, unwrapped by up to
    two boxes either way, and four frames of a 16 x 16 x 18 simple cubic
    lattice (six neighbours at one distance, twelve at the next: exact
    ties), shifted by whole boxes."""
    a = 2.9
    box = (16 * a, 16 * a, 18 * a)
    rng = np.random.RandomState(8)
    rand = rng.uniform(0, 1, size=(4, 4608, 3)) * np.float32(box)
    rand = rand + np.float32(box) * rng.randint(-2, 3, size=rand.shape)
    g = np.stack(np.meshgrid(np.arange(16), np.arange(16), np.arange(18), indexing="ij"),
                 -1).reshape(-1, 3) * np.float32(a)
    lat = g[None] + np.float32(box) * rng.randint(-1, 2, size=(4, 4608, 3))
    pos = np.concatenate([rand, lat]).astype(np.float32)
    return torch.from_numpy(pos).to(dev), box


def test_k5_cell_route_matches_plain(dev):
    """The cutoff route at [8, 4608], k=8 and 16: bit for bit the plain
    version; the same bits on a second launch."""
    from cmdlmc_tpu_torch.ops import knn_tables as knn

    pos, box = _supercell(dev)
    assert knn.cell_grid(4608, box, 5.0, 8) == (9, 9, 10)
    before = knn.knn_block_tables.launches
    for k in (8, 16):
        got = knn.knn_block_tables(pos, box, 5.0, k)
        want = knn.knn_block_tables_reference(pos, box, 5.0, k)
        assert _same_tables(got, want), k
        assert _same_tables(knn.knn_block_tables(pos, box, 5.0, k), got), k
    assert knn.knn_block_tables.launches == before + 4


def test_k5_verified_search_matches_plain(dev):
    """No cutoff at [16, 1728], k=3 (the water tables' route, 8 cells an
    axis): the card's binning equals its plain version (cell lists and
    bounds); the tables bit for bit the plain K5, also where a site sits alone in an
    empty ball, so its 27 cells hold the wrong neighbours and the kernel
    must scan its column in full; a frame past the binned range is scanned
    in full."""
    from cmdlmc_tpu_torch.ops import knn_tables as knn

    L = 37.2
    box = (L,) * 3
    rng = np.random.RandomState(9)
    pos = rng.uniform(0, L, size=(16, 1728, 3)).astype(np.float32)
    grid = knn.cell_grid(1728, box, float("inf"), 3)
    assert grid == (8, 8, 8)
    w, c = L / 8, np.float32(L / 2)
    v = pos[:8] - c
    r = np.linalg.norm(v, axis=2, keepdims=True)
    inside = (r < 2.5 * w)[..., 0]
    pos[:8][inside] = (c + v / np.maximum(r, 1e-6) * np.float32(2.5 * w))[inside]
    pos[:8, 0] = c
    pos[15, 3] += np.float32(300 * L)  # past BIN_RANGE box lengths
    t = torch.from_numpy(pos).to(dev)
    cl = knn.cell_lists(t, box, grid, verify=True)
    assert cl.bad.tolist() == [0] * 15 + [1]
    plain = knn.cell_lists(t.cpu(), box, grid, verify=True)  # the binning's plain version
    for key in ("order", "scell", "start", "bad"):
        assert torch.equal(getattr(cl, key).cpu(), getattr(plain, key)), key
    assert torch.equal(cl.thr[:15].cpu().view(torch.int32), plain.thr[:15].view(torch.int32))
    got = knn.knn_block_tables(t, box, float("inf"), 3)
    want = knn.knn_block_tables_reference(t, box, float("inf"), 3)
    assert _same_tables(got, want)
    assert _same_tables(knn.knn_block_tables(t, box, float("inf"), 3), got)


def test_k7_narrow_blocks_and_prefix(dev):
    """K7 at 32 and 64 threads per block gives the bits of 256; against its
    plain version at most one replica parts (at a near-tie) and site_disp
    equals the plain pre-pass's last row bit for bit; with no replicas the
    prefix still advances."""
    from cmdlmc_tpu_torch.ops import water_sweep as ws

    pos, tables, prev, sd, state, law, box, kw = _k7_setup(dev, r=1024, frames=20)
    sd = torch.randn(sd.shape, generator=torch.Generator().manual_seed(3)).to(dev)
    args = (pos, *tables, prev, sd, *state, law, 0, box)
    wide = ws.water_sweep(*args, block_threads=256, **kw)
    for threads in (32, 64):
        narrow = ws.water_sweep(*args, block_threads=threads, **kw)
        for key, val in wide.items():
            assert torch.equal(val.view(torch.int32), narrow[key].view(torch.int32)), \
                (threads, key)
    want = ws.water_sweep_reference(*args, **kw)
    same = torch.ones(state[0].shape[0], dtype=torch.bool, device=dev)
    for key in ("site", "last", "fsj", "wait", "jumps", "ev_count", "trunc"):
        same &= wide[key] == want[key]
    assert int((~same).sum()) <= 1 and int(want["ev_count"].sum()) > 0
    assert torch.equal(wide["site_trace"], want["site_trace"])
    rows = ws.water_prefix_reference(pos, prev, sd, box)
    assert torch.equal(wide["site_disp"].view(torch.int32), rows[-1].view(torch.int32))
    assert torch.equal(want["site_disp"].view(torch.int32), rows[-1].view(torch.int32))
    empty = [t[:0] for t in state]
    none = ws.water_sweep(pos, *tables, prev, sd, *empty, law, 0, box,
                          **{**kw, "tile": 1})
    assert torch.equal(none["site_disp"].view(torch.int32), rows[-1].view(torch.int32))
