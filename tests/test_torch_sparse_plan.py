"""K6's device plan (``ops/knn_sparse.py::device_plan``) on the CPU, where
its plain version builds it, and the shape rule that routes the top-K
tables to K6.

* The plan is conservative: K6's plain version over it equals K5's plain
  version bit for bit (distances and indices, exhausted slots included) on a
  jittered lattice, an exact-tie lattice, a drifting block of 3 frames and
  a block moved by whole boxes, at K6's tiles of 32 and chunks of 16 sites
  and at smaller ones that prune harder;
* its integers: a permutation and its inverse, each tile's kept chunks in
  ascending order then padding, the count, every chunk kept where the
  block leaves the binned range; and it keeps fewer (tile, chunk) pairs than
  the JAX package's bin-major order at the box x4 supercell's density;
* ``sparse_route`` reads N and the bins per axis alone.

``tests/test_torch_supercell.py`` holds the plain K6 over this plan against
the JAX package's B6 in interpret mode; ``tests/test_torch_kernels_cuda_k6.py``
holds the card's plan and K6 against these plain versions.
"""

import math

import numpy as np
import pytest
import torch

from cmdlmc_tpu_torch.ops import knn_sparse as kns
from cmdlmc_tpu_torch.ops import knn_tables as knn

torch.set_num_threads(1)

CUTBUF = float(np.float32(2.6) + np.float32(0.9))


def _jittered():
    """A 7 x 7 x 7 simple cubic lattice at 3.1 Å, each site jittered."""
    g = np.stack(np.meshgrid(*[np.arange(7)] * 3, indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.RandomState(4)
    pos = g * 3.1 + rng.normal(scale=0.2, size=g.shape)
    return pos.astype(np.float32)[None], 7 * 3.1


def _ties():
    """An 8 x 8 x 8 simple cubic lattice at 2.5 Å: six equidistant first
    neighbours and twelve second ones, so the (distance, id) order decides."""
    g = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return (g.astype(np.float32) * 2.5)[None], 20.0


def _drifting():
    """500 sites in a 24 Å cube, a random walk of 0.15 Å per frame and
    coordinate over 3 frames (the plan widens its boxes by the drift)."""
    rng = np.random.RandomState(1)
    base = rng.uniform(0, 24.0, (500, 3)).astype(np.float32)
    walk = np.cumsum(rng.normal(scale=0.15, size=(3, 500, 3)), axis=0)
    return (base[None] + walk).astype(np.float32), 24.0


def _unwrapped():
    """The drifting block, each site moved by whole boxes (up to 3 away)."""
    pos, box = _drifting()
    shift = np.random.RandomState(2).randint(-3, 4, size=(1, 500, 3)) * box
    return (pos + shift).astype(np.float32), box


@pytest.mark.parametrize("make", [_jittered, _ties, _drifting, _unwrapped],
                         ids=["jittered", "ties", "drift", "unwrapped"])
def test_device_plan_is_conservative(make):
    """The tables over the device plan equal K5's plain tables bit for bit
    in every frame, at k = 4 and at k = 12 (past the lattices' first shell,
    so columns run out of neighbours in range), for K6's tiles of 32 and
    chunks of 16 sites and for 16-site tiles of 8-site chunks, which drop
    most chunks."""
    pos, box = make()
    pos = torch.from_numpy(pos)
    box3 = (box,) * 3
    want = {k: knn.knn_block_tables_reference(pos, box3, CUTBUF, k) for k in (4, 12)}
    assert bool((want[12][0] == knn.BIG).any())
    for rc, tc in ((kns.PLAN_RC, kns.PLAN_TC), (8, 16)):
        plan = kns.device_plan(pos, box3, CUTBUF, rc=rc, tc=tc)
        if rc == 8:  # most chunks dropped
            assert float(plan.count.float().mean()) < plan.n_ch / 2
        for k, (wd, wi) in want.items():
            gd, gi = kns.knn_sparse_tables(pos, box3, CUTBUF, k, plan)
            assert torch.equal(gd, wd) and torch.equal(gi, wi), (rc, tc, k)
    assert kns.knn_sparse_tables.launches == 0 and kns.device_plan.launches == 0


def _bench_density(n, seed=0):
    """n uniform sites at bench.py's density (144 in a 14.5 Å cube), two
    frames a random walk of 0.004 Å apart."""
    box = 14.5 * (n / 144) ** (1 / 3)
    rng = np.random.RandomState(seed)
    base = rng.uniform(0, box, (n, 3)).astype(np.float32)
    step = rng.normal(scale=0.004, size=(1, n, 3)).astype(np.float32)
    return torch.from_numpy(np.concatenate([base[None], base[None] + step])), box


def test_device_plan_integers():
    """perm is a permutation and inv its inverse; each tile's list holds its
    count of kept chunks in ascending order, then n_ch to the end; at the box
    x4 supercell's size and density the serpentine pencils keep over a fifth
    fewer (tile, chunk) pairs than the JAX package's bin-major order at the
    same sizes."""
    pos, box = _bench_density(9216)
    box3 = (box,) * 3
    plan = kns.device_plan(pos, box3, 5.0)
    n = pos.shape[1]
    assert plan.perm.dtype == plan.lists.dtype == plan.count.dtype == torch.int32
    assert torch.equal(torch.sort(plan.perm).values, torch.arange(n, dtype=torch.int32))
    assert torch.equal(plan.inv[plan.perm.long()], torch.arange(n, dtype=torch.int32))
    n_ct = -(-n // plan.tc)
    assert plan.lists.shape == (n_ct, plan.n_ch) and plan.n_ch == -(-n // plan.rc)
    for t in range(n_ct):
        row, c = plan.lists[t], int(plan.count[t])
        assert c >= 1 and bool((row[:c] < plan.n_ch).all())
        assert bool((row[1:c] > row[:c - 1]).all()) and bool((row[c:] == plan.n_ch).all())
    host = kns.SparsePlan(*kns.plan_sparse(pos.numpy(), box3, 5.0, rc=plan.rc, tc=plan.tc),
                          plan.rc, plan.tc)
    host_kept = int((host.lists < host.n_ch).sum())
    assert int(plan.count.sum()) < 0.8 * host_kept


@pytest.mark.parametrize("far", [math.nan, 257.0], ids=["nan", "past_range"])
def test_device_plan_keeps_every_chunk_out_of_range(far):
    """A coordinate that is not finite, or past BIN_RANGE box lengths, in
    any frame makes every tile keep every chunk (the plan's float error
    bound holds only inside that range)."""
    pos, box = _bench_density(600, seed=3)
    pos[1, 17, 2] = far * box if math.isfinite(far) else far
    plan = kns.device_plan(pos, (box,) * 3, 3.0, rc=8, tc=16)
    assert bool((plan.count == plan.n_ch).all())
    tight = kns.device_plan(pos[:1], (box,) * 3, 3.0, rc=8, tc=16)
    assert int(tight.count.max()) < tight.n_ch
    assert torch.equal(tight.perm, plan.perm)  # the key reads frame 0 only


def test_sparse_route():
    """K6 from SPARSE_MIN_N = 864 sites on, with a finite cutoff + buffer
    and at least 3 bins of that width an axis: the box x4 supercell (9216
    sites, 58 Å, 11 bins), the 4608-site supercell (9 bins) and bench.py's
    cell x 2 (1152 sites, 5 bins) take it; 863 sites, a box of 2 bins an
    axis and no cutoff do not; the plan's bins are K5's cells."""
    assert kns.plan_bins((58.0,) * 3, 5.0) == knn.cell_dims(9216, (58.0,) * 3, 5.0, 8)
    assert kns.plan_bins((58.0,) * 3, 5.0) == (11, 11, 11)
    assert kns.sparse_route(9216, (58.0,) * 3, 5.0)
    assert kns.sparse_route(kns.SPARSE_MIN_N, (58.0,) * 3, 5.0)
    assert not kns.sparse_route(kns.SPARSE_MIN_N - 1, (58.0,) * 3, 5.0)
    assert kns.SPARSE_MIN_N == 864
    assert kns.sparse_route(4608, (14.5 * 32 ** (1 / 3),) * 3, 5.0)
    assert kns.sparse_route(1152, (29.0,) * 3, 5.0)
    assert not kns.sparse_route(9216, (58.0, 58.0, 14.0), 5.0)
    assert not kns.sparse_route(9216, (58.0,) * 3, math.inf)
    assert kns.plan_bins((3.0,) * 3, 5.0) == (1, 1, 1)


def test_minimg_near_equals_minimg():
    """kmc_common.cuh::minimg_near (K2, K5-K7), written in numpy float32: d * inv
    rounded, and the division only where frac(q) lies within |q| 2^-20 of
    1/2, gives minimg's d - L rint(d / L) bit for bit, at random d and at the
    13 floats nearest every half-integer multiple of L out to 600 L."""
    f32 = np.float32
    rng = np.random.RandomState(7)
    for length in (f32(14.5), f32(46.03), f32(58.0), f32(84.1), f32(3.0)):
        inv = f32(1) / length
        centre = ((np.arange(-600, 601) + 0.5) * float(length)).astype(np.float32)
        up, down, near = centre, centre, [centre]
        for _ in range(6):
            up, down = np.nextafter(up, f32(np.inf)), np.nextafter(down, f32(-np.inf))
            near += [up, down]
        d = np.concatenate(near + [rng.uniform(-300, 300, 200000).astype(np.float32)
                                   * length]).astype(np.float32)
        want = d - length * np.rint(d / length)
        q = d * inv
        r = np.rint(q)
        far = np.abs(np.abs(q - r) - f32(0.5)) > np.abs(q) * f32(2.0 ** -20)
        got = d - length * np.where(far, r, np.rint(d / length))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        assert far[-200000:].mean() > 0.999  # the division is rare
