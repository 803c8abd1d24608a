"""K6 over the plan built on the card, and K2, against their plain versions
(marked ``cuda``; they skip without one): the card's plan equals
``device_plan_reference`` (integers exact), K6 equals K5 bit for bit at the
box x4 rebuild's [1, 9216], at [64, 4608] and at a ragged N, and K2 equals
``pairwise_reference`` bit for bit at N = 143, 144 and 1152 and over more
frames than a grid row holds. ``chip_smoke.py`` also holds both against
the earlier kernels and times them. On a machine with a GPU and no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda_k6.py
"""

import math

import numpy as np
import pytest
import torch

from test_torch_kernels_cuda import dev

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

BENCH_BOX, BENCH_SITES = 14.5, 144  # bench.py's density


def _walk(n, frames, seed, sigma=0.004):
    """n uniform sites at bench.py's density plus a random walk of sigma per
    frame and coordinate; returns the block and the box length."""
    box = BENCH_BOX * (n / BENCH_SITES) ** (1 / 3)
    rng = np.random.RandomState(seed)
    base = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    walk = np.cumsum(rng.normal(scale=sigma, size=(frames, n, 3)), axis=0)
    return torch.from_numpy((base[None] + walk).astype(np.float32)), box


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_device_plan_matches_plain(dev):
    """The card's plan (site, box and list kernels around torch's sort)
    equals its plain version on the CPU: perm, inv, lists and count, at the
    box x4 rebuild's shape, a drifting block, a ragged N and a block with a
    NaN (every chunk kept)."""
    from cmdlmc_tpu_torch.ops import knn_sparse as kns

    cases = [_walk(9216, 1, 0), _walk(4608, 8, 1, sigma=0.05), _walk(6151, 3, 2)]
    nan, box = _walk(3000, 2, 3)
    nan[1, 5, 0] = math.nan
    cases.append((nan, box))
    for pos, box in cases:
        got = kns.device_plan(pos.to(dev), (box,) * 3, 5.0)
        want = kns.device_plan_reference(pos, (box,) * 3, 5.0)
        assert got.n_ch == want.n_ch and got.lists.shape == want.lists.shape
        for f in ("perm", "inv", "lists", "count"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), (pos.shape, f)
    assert bool((got.count == got.n_ch).all())  # the NaN block keeps everything
    assert kns.device_plan.launches >= 4


@pytest.mark.parametrize("n,frames,k", [(9216, 1, 8), (4608, 64, 8), (6151, 5, 16)],
                         ids=["rebuild_9216", "block_4608", "ragged_6151"])
def test_k6_equals_k5(dev, n, frames, k):
    """K6 over the plan it builds on the card gives K5's tables bit for bit
    (the rebuild's one frame takes 8 warps per 32 columns, the block one)."""
    from cmdlmc_tpu_torch.ops import knn_sparse as kns
    from cmdlmc_tpu_torch.ops import knn_tables as knn

    pos, box = _walk(n, frames, n)
    pos = pos.to(dev)
    before = kns.knn_sparse_tables.launches
    got = kns.knn_sparse_tables(pos, (box,) * 3, 5.0, k)
    want = knn.knn_block_tables(pos, (box,) * 3, 5.0, k)
    assert kns.knn_sparse_tables.launches == before + 1
    assert torch.equal(got[1], want[1]) and _same_bits(got[0], want[0])
    assert bool((got[0] < 1e5).any())


def test_k2_matches_plain_bit_for_bit(dev):
    """K2 against pairwise_reference bit for bit: N=143 (scalar stores), 144
    with positions outside the box (float4 stores), 1152, and 70000 frames
    of 4 sites (more frames than a grid row and than the launch's blocks)."""
    from cmdlmc_tpu_torch.ops.pairwise import pairwise_cubic, pairwise_reference

    for n, batch in ((143, 7), (144, 100), (1152, 2), (4, 70000)):
        rng = np.random.RandomState(n)
        pos = torch.from_numpy(rng.uniform(-5.0, 35.0, size=(batch, n, 3))
                               .astype(np.float32)).to(dev)
        box = (14.5, 13.0, 15.5)
        got = pairwise_cubic(pos, box)
        want = pairwise_reference(pos, torch.tensor(box, device=dev))
        assert got.shape == (batch, n, n) and _same_bits(got, want), n
