"""Kernel 2 (``csrc/threefry.cu``) and the scan engine on the card against
their plain versions (marked ``cuda``; they skip without one): the hash bit
for bit at several M and through split and fold_in, JAX's key chain, and
the dense scan engine on the card landing where it lands on the CPU but for
near-ties (the float sums run in another order). ``chip_smoke.py`` times
kernel 2 and drives the scan engine at full width. On a machine with a GPU
and no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda_threefry.py
"""

import numpy as np
import pytest
import torch

from test_torch_kernels_cuda import dev

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


def _words(rng, *shape):
    return torch.from_numpy(rng.randint(0, 2**32, size=(*shape, 2), dtype=np.uint64)
                            .astype(np.int64))


def test_threefry_kernel_matches_plain(dev):
    from cmdlmc_tpu_torch.ops import threefry as tf

    rng = np.random.RandomState(0)
    # (key batch, base: None for 0, "int", "tensor"; num, xor): the fold-ins,
    # splits and draws of the scan engine, a broadcast key, the wrap of base + j
    for batch, base, num, xor in (((1,), "int", 1, False), ((1000,), "tensor", 1, False),
                                  ((2, 257), "tensor", 1, False), ((64,), None, 5, False),
                                  ((3, 4), None, 1, True), ((), None, 1000, True),
                                  ((1 << 18,), None, 2, True), ((7,), "wrap", 9, False)):
        key = _words(rng, *batch)
        b = {None: 0, "int": int(rng.randint(0, 2**32, dtype=np.uint64)),
             "wrap": 2**32 - 4,
             "tensor": torch.from_numpy(rng.randint(0, 2**32, size=batch, dtype=np.uint64)
                                        .astype(np.int64))}[base]
        before = tf.keyed_hash.launches
        got = tf.keyed_hash(key.to(dev), b.to(dev) if base == "tensor" else b, num, xor)
        assert tf.keyed_hash.launches == before + 1
        assert torch.equal(got.cpu(), tf.keyed_hash_reference(key, b, num, xor))
    key = _words(rng, 64)
    assert torch.equal(tf.split(key.to(dev), 5).cpu(), tf.split(key, 5))
    data = torch.from_numpy(rng.randint(0, 2**32, size=64, dtype=np.uint64).astype(np.int64))
    assert torch.equal(tf.fold_in(key.to(dev), data.to(dev)).cpu(), tf.fold_in(key, data))
    assert torch.equal(tf.fold_in(key[:1].to(dev), data.to(dev)).cpu(),
                       tf.fold_in(key[:1], data))  # one key broadcast: stride 0
    assert torch.equal(tf.uniform(key.to(dev), (3,)).cpu(), tf.uniform(key, (3,)))
    f = tf.fold_in(tf.key(7, dev), 1)
    assert f.tolist() == [195045567, 4062205631]  # jax.random's value
    assert tf.split(f, 3).tolist()[2] == [3281109246, 2806878594]


def test_dense_scan_on_the_card_matches_the_cpu(dev):
    from cmdlmc_tpu_torch.core.cell import Cell
    from cmdlmc_tpu_torch.engine import lattice as eng
    from cmdlmc_tpu_torch.ops import threefry as tf
    from cmdlmc_tpu_torch.rates.laws import Fermi
    from cmdlmc_tpu_torch.topo.models import PairRates

    rng = np.random.RandomState(1)
    n, p, r, frames, box = 144, 96, 256, 32, 14.5
    base = rng.uniform(0, box, (n, 3))
    pos = torch.from_numpy((base[None] + rng.normal(scale=0.03, size=(frames, n, 3)))
                           .astype(np.float32))
    keys = tf.split(tf.fold_in(tf.key(1), 1), r)
    out = {}
    for d in ("cpu", dev):
        cell = Cell.cubic([box] * 3, device=d)
        model = PairRates(cell, Fermi(a=0.06, b=2.3, c=0.1).to(d), 3.0, 2.0)
        ens = eng.init_replicas(torch.Generator().manual_seed(0), r, n, p, pos[0], d,
                                hist_bins=4, track_jump_matrix=True)
        out[str(d)], _ = eng.run_block(model, cell, ens, keys.to(d), eng.block_frames(
            pos.to(d), 0, 0.5), dt=0.5, reset_frequency=10, hist_range=(2.0, 3.0))
    a, b = out["cpu"].replicas, out[str(dev)].replicas
    same = ((a.site_of_proton == b.site_of_proton.cpu()).all(dim=1)
            & (a.clock.event_count == b.clock.event_count.cpu()))
    assert int((~same).sum()) <= 2 and int(a.clock.event_count.sum()) > r
    assert torch.equal(a.jump_hist[same], b.jump_hist.cpu()[same])
