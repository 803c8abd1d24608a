"""K5's cell route on the CPU (``ops/knn_tables.py``): the cell lists built
on the tensors' device, the 27-cell search written plainly
(``knn_cell_tables_reference``) held bit for bit against the plain K5
(``knn_block_tables_reference``), the verified search with no cutoff, and
the route rule. The kernel itself (``csrc/knn_tables.cu``) is held to the
same tables on the card in ``test_torch_kernels_cuda_knn.py`` and
``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch

from cmdlmc_tpu_torch.ops import knn_tables as knn
from test_torch_slice import jax_kernels_run_to_end  # noqa: F401  (runs by itself)

torch.set_num_threads(1)

CUTBUF = 5.0


def _case(name):
    """(positions [B, N, 3] f32, box, cutbuf, k) of one cell-route case."""
    rng = np.random.RandomState(11)
    if name in ("uniform", "unwrapped", "faces"):
        box = (22.0, 22.0, 23.5)  # 4 x 4 x 4 cells of 5.5 and 5.875
        pos = rng.uniform(0, 1, size=(3, 400, 3)) * np.float32(box)
        if name == "unwrapped":  # images up to 3 boxes away, both signs
            pos = pos + np.float32(box) * rng.randint(-3, 4, size=pos.shape)
        if name == "faces":  # sites exactly on cell faces and box edges
            w = np.float32(box) / 4
            pos[:, :120] = np.round(pos[:, :120] / w) * w
            pos[:, 120:124] = [[0.0, 0.0, 0.0], [22.0, 22.0, 23.5], [-0.0, 5.5, 11.75],
                               [-5.5, -11.0, -5.875]]
        return pos.astype(np.float32), box, CUTBUF, 8
    if name == "three_cells":  # exactly 3 cells an axis: every cell is a neighbour
        box = (16.0, 15.5, 17.0)
        pos = rng.uniform(0, 1, size=(2, 80, 3)) * np.float32(box)
        return pos.astype(np.float32), box, CUTBUF, 8
    # no cutoff: the water tables at a water deployment's density
    n = 900
    side = (n / 0.0336) ** (1 / 3)
    box = (side,) * 3
    pos = rng.uniform(0, side, size=(2, n, 3)) + rng.normal(scale=0.03, size=(2, n, 3))
    return pos.astype(np.float32), box, float("inf"), 3


def _pair_cell_steps(cl, grid):
    """Each (row, column) pair's cell step per axis, circular, in {0 .. g-1}."""
    g = torch.tensor(grid)
    return (cl.cell[:, :, None, :] - cl.cell[:, None, :, :]) % g


@pytest.mark.parametrize("name", ["uniform", "unwrapped", "faces", "three_cells"])
def test_pairs_in_range_lie_in_27_cells(name):
    """Every pair within cutoff + buffer by the plain minimum image lies in
    its column's 27 cells (cell steps of -1, 0 or 1 on every axis), and the
    lists hold every site once, sorted by cell, with the cells' starts."""
    pos, box, cutbuf, k = _case(name)
    grid = knn.cell_dims(pos.shape[1], box, cutbuf, k)
    assert grid == ((3, 3, 3) if name == "three_cells" else (4, 4, 4))
    t = torch.from_numpy(pos)
    cl = knn.cell_lists(t, box, grid, verify=False)
    assert bool((cl.bad == 0).all())
    B, N, _ = pos.shape
    assert torch.equal(cl.order.sort(dim=1).values, torch.arange(N).expand(B, N))
    cid = (cl.cell[..., 0] * grid[1] + cl.cell[..., 1]) * grid[2] + cl.cell[..., 2]
    assert torch.equal(cl.scell.long(), cid.gather(1, cl.order))
    assert bool((cl.scell[:, 1:] >= cl.scell[:, :-1]).all())
    count = torch.stack([torch.bincount(c, minlength=math.prod(grid)) for c in cid])
    assert torch.equal(cl.start[:, 1:].long() - cl.start[:, :-1].long(), count)
    box_t = torch.tensor(box, dtype=torch.float32)
    delta = t[:, :, None, :] - t[:, None, :, :]
    delta = delta - box_t * torch.round(delta / box_t)
    sq = delta * delta
    d = torch.sqrt(((sq[..., 0] + sq[..., 1]) + sq[..., 2]).double())
    in_range = d <= np.float32(cutbuf)
    step = _pair_cell_steps(cl, grid)
    near = ((step <= 1) | (step == torch.tensor(grid) - 1)).all(dim=3)
    assert int(in_range.sum()) > 10 * B * N  # the case has pairs to lose
    assert bool(near[in_range].all())


@pytest.mark.parametrize("name", ["uniform", "unwrapped", "faces", "three_cells",
                                  "no_cutoff"])
def test_cell_search_equals_plain(name):
    """The 27-cell search with the (distance, index) order equals the plain
    K5 bit for bit: indices, and distances as int32 bits."""
    pos, box, cutbuf, k = _case(name)
    t = torch.from_numpy(pos)
    grid = knn.cell_dims(pos.shape[1], box, cutbuf, k)
    assert min(grid) >= 3
    got_d, got_i = knn.knn_cell_tables_reference(t, box, cutbuf, k, grid)
    want_d, want_i = knn.knn_block_tables_reference(t, box, cutbuf, k)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
    if math.isfinite(cutbuf):
        assert bool((want_d == knn.BIG).any())  # columns that run out in range


def test_no_cutoff_check_rescans_what_it_must():
    """With no cutoff a column whose k-th distance within its 27 cells does
    not lie below its block's nearest face (``thr``) is scanned in full: an
    isolated site's 27 cells hold the wrong neighbours, the check refuses
    them, and the tables equal the plain K5's; the columns it keeps are
    right. A frame past BIN_RANGE box lengths is scanned in full."""
    pos, box, _, k = _case("no_cutoff")
    n = pos.shape[1]
    grid = knn.cell_dims(n, box, float("inf"), k)
    w = box[0] / grid[0]
    centre = np.float32(box[0] / 2)
    v = pos - centre
    r = np.linalg.norm(v, axis=2, keepdims=True)
    inside = (r < 2.5 * w)[..., 0]  # push a ball's sites out to its surface
    pos[inside] = (centre + v / np.maximum(r, 1e-6) * np.float32(2.5 * w))[inside]
    pos[:, 0] = centre  # site 0 alone in the middle of the empty ball
    t = torch.from_numpy(pos)
    cl = knn.cell_lists(t, box, grid, verify=True)
    # the restricted search alone (cut mode at a huge cutoff, no check)
    lone_d, lone_i = knn.knn_cell_tables_reference(t, box, 1e30, k, grid)
    want_d, want_i = knn.knn_block_tables_reference(t, box, float("inf"), k)
    assert not torch.equal(lone_i[:, :, 0], want_i[:, :, 0])
    assert bool((lone_d[:, k - 1, 0] >= cl.thr[:, 0]).all())  # refused
    kept = lone_d[:, k - 1] < cl.thr
    assert float(kept.float().mean()) > 0.9
    assert torch.equal(lone_i[kept[:, None].expand_as(lone_i)],
                       want_i[kept[:, None].expand_as(want_i)])
    got_d, got_i = knn.knn_cell_tables_reference(t, box, float("inf"), k, grid)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
    # positions past BIN_RANGE box lengths, or not finite: bad = 1
    t2 = t.clone()
    t2[0, 5, 1] = float(np.float32(knn.BIN_RANGE * box[0] * 1.01))
    t2[1, 7, 2] = float("nan")
    assert knn.cell_lists(t2, box, grid, verify=True).bad.tolist() == [1, 1]


def test_cell_grid_follows_the_shapes():
    """The route of each deployment's shape: the cell route at the N=4608
    and 9216 supercells (cutoff 3 + buffer 2) and the N=1728 water tables
    (no cutoff); the full scan at N=144 (2 cells an axis) and the N=216 water
    tables (too few columns per pencil to fill a warp); a cell is at least
    cutoff + buffer plus the margin wide. The full scan's lanes per column
    and the cell route's block width follow the block's size."""
    sc_box = 14.5 * (4608 / 144) ** (1 / 3)
    assert knn.cell_grid(4608, (sc_box,) * 3, CUTBUF, 8) == (9, 9, 9)
    assert knn.cell_grid(9216, (58.0,) * 3, CUTBUF, 8) == (11, 11, 11)
    assert knn.cell_grid(1728, (37.2,) * 3, float("inf"), 3) == (8, 8, 8)
    assert knn.cell_grid(144, (14.5,) * 3, CUTBUF, 8) is None
    assert knn.cell_grid(144, (14.5,) * 3, CUTBUF, 4) is None
    assert knn.cell_grid(216, (18.6,) * 3, float("inf"), 3) is None
    for L in (15.0, 15.02, 30.0, 46.03):
        g = knn.cell_dims(100, (L,) * 3, CUTBUF, 8)[0]
        least = CUTBUF * (1 + knn.CELL_MARGIN) + knn.CELL_MARGIN * L
        assert L / g >= least > L / (g + 1)  # as many cells as the margin allows
    assert knn.cell_grid(144, (15.02,) * 3, CUTBUF, 8) is None  # 3 cells, no gain
    assert knn.cell_threads(64 * 81) == 32 and knn.cell_threads(121) == 128
    assert [knn.full_split(b, n) for b, n in ((100, 144), (256, 216), (256, 1728),
                                              (1, 9216))] == [8, 2, 1, 8]
