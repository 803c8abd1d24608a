"""Stage 1 of the port's top-K path against the JAX package on the CPU: the
plain version of kernel K5 against the JAX K5 kernel (B5) in interpret
mode and against the JAX package's XLA build, and the port's topk_tables
against the JAX topk_tables with the law precomputed and not. The
distance transformations, the residence-time interpolator, k_smallest and
the models' shared are in ``test_torch_topk_transforms.py``.

Tolerances: neighbor indices and validity exact; raw distances exact
against the JAX model run op by op, and to rtol 3e-7 (an ulp) against the
JAX package's jitted builds, where XLA fuses the sum of squares; rescaled
distances to rtol 1e-6 (a transform adds a multiply-add, an ulp apart
between XLA and torch), rates to rtol 2e-5 (the Fermi law turns a distance
an ulp apart into a rate about d/c = 25 ulp apart); the JAX package's own bound
between its K5 kernel and its XLA build is atol 2e-4
(tests/ops/test_knn_tables.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu.core.cell import Cell as JCell
from cmdlmc_tpu.ops import knn_tables as jknn
from cmdlmc_tpu.ops import topk_sweep as jts
from cmdlmc_tpu.rates.laws import Fermi as JFermi
from cmdlmc_tpu.topo import models as jmodels
from cmdlmc_tpu.topo import transforms as jtr
from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch.ops import knn_tables as knn
from cmdlmc_tpu_torch.ops import topk_sweep as ts

from test_torch_slice import jax_kernels_run_to_end  # noqa: F401  (runs by itself)

torch.set_num_threads(1)

N, B, BOX = 32, 3, 9.0
_f = jnp.float32
FERMI = JFermi(a=_f(0.2), b=_f(2.3), c=_f(0.1))
XS = np.linspace(2.0, 3.5, 31).astype(np.float32)
YS = (XS - 0.3 * np.exp(-((XS - 2.6) ** 2) / 0.08)).astype(np.float32)
TRANSFORMS = {
    "relu": jtr.ReLUTransformation(a=_f(0.5), b=_f(2.2), d0=_f(2.2),
                                   left_bound=_f(2.0), right_bound=_f(3.3)),
    "linear": jtr.LinearTransformation(a=_f(0.9), b=_f(0.1), left_bound=_f(0.0),
                                       right_bound=_f(2.0e6)),
    "interpolated": jtr.InterpolatedTransformation(x=jnp.asarray(XS),
                                                   y=jnp.asarray(YS)),
}


def _positions():
    rng = np.random.RandomState(4)
    base = rng.uniform(0, BOX, size=(N, 3)).astype(np.float32)
    return (base[None] + rng.normal(scale=0.05, size=(B, N, 3))).astype(np.float32)


def _models(name, k):
    """A JAX top-K model and the port's, built from it."""
    cell = JCell.cubic([BOX] * 3)
    if name == "topk":
        jm = jmodels.TopKPairRates(cell=cell, law=FERMI, cutoff=_f(2.5),
                                   buffer=_f(1.0), k=k)
        return jm, convert.topk_pair_rates_from_fields(jm)
    transform, relax = {"relu": ("relu", 20.0), "interp_table": ("interpolated", None),
                        "plain": (None, None)}[name]
    jm = jmodels.HydroniumRates(
        cell=cell, law=FERMI, cutoff=_f(2.5), buffer=_f(1.0),
        transform=TRANSFORMS[transform] if transform else None,
        interpolator=jtr.DistanceInterpolator(relaxation_time=_f(relax)) if relax else None,
        k=k)
    return jm, convert.hydronium_rates_from_fields(jm)


@pytest.fixture(scope="module")
def jax_knn():
    """The JAX K5 kernel (B5) in interpret mode and the JAX XLA build, k=8."""
    jm, _ = _models("topk", 8)
    pos = _positions()
    kernel = jknn.knn_block_tables(jnp.asarray(pos), jnp.diagonal(jm.cell.h),
                                   jm.cutoff + jm.buffer, k=8, kl=8, interpret=True)
    xla = jts._topk_tables_xla(jm, jnp.asarray(pos), 8, False)
    return pos, [np.asarray(x) for x in kernel], [np.asarray(x) for x in xla]


def test_knn_reference_matches_jax_kernel(jax_knn):
    pos, (kd, ki), (xd, xi, _) = jax_knn
    topd, topi = knn.knn_block_tables(torch.from_numpy(pos), (BOX,) * 3, 3.5, 8)
    assert topd.shape == (B, 8, N) and topi.dtype == torch.int32
    for want_d, want_i in ((kd, ki), (xd, xi)):
        np.testing.assert_array_equal(topi.numpy(), want_i.astype(np.int32))
        np.testing.assert_allclose(topd.numpy(), want_d, rtol=0, atol=2e-4)
    np.testing.assert_allclose(topd.numpy(), xd, rtol=3e-7, atol=0)
    assert np.any(topd.numpy() == knn.BIG)
    assert knn.knn_block_tables.launches == 0  # CPU tensors: plain version


def test_knn_reference_ties_and_exhaustion():
    """A simple cubic lattice: six equidistant first neighbors (the
    first-lowest-index tie-break decides) and k=8 past them (exhausted
    slots: index 0, distance 1e6), as tests/ops/test_knn_tables.py sets it."""
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1)
    pos = (g.reshape(-1, 3).astype(np.float32) * 2.5)[None]
    topd, topi = knn.knn_block_tables_reference(torch.from_numpy(pos), (10.0,) * 3,
                                                float(np.float32(2.4) + np.float32(0.2)), 8)
    jm = jmodels.TopKPairRates(cell=JCell.cubic([10.0] * 3), law=FERMI,
                               cutoff=_f(2.4), buffer=_f(0.2), k=8)
    want = jts._topk_tables_xla(jm, jnp.asarray(pos), 8, False)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(want[1]).astype(np.int32))
    np.testing.assert_allclose(topd.numpy(), np.asarray(want[0]), rtol=3e-7, atol=0)
    assert np.all(topd.numpy()[0, 6:] == knn.BIG) and np.all(topi.numpy()[0, 6:] == 0)


@pytest.mark.parametrize("name,k,law", [("topk", 8, True), ("topk", 8, False),
                                        ("relu", 4, True), ("relu", 4, False),
                                        ("interp_table", 4, True)])
def test_topk_tables_match_jax(name, k, law):
    """The first K rows of the JAX package's [B, KL, N] tables (KL = k
    padded to 8), with the law precomputed (min(resc, 50), 0 where invalid)
    and not."""
    jm, tm = _models(name, k)
    pos = _positions()
    want = [np.asarray(x) for x in jts.topk_tables(jm, jnp.asarray(pos), 8, law)]
    got = ts.topk_tables(tm, torch.from_numpy(pos), precompute_law=law)
    assert all(t.shape == (B, k, N) for t in got)
    np.testing.assert_allclose(got[0].numpy(), want[0][:, :k], rtol=3e-7, atol=0)
    np.testing.assert_array_equal(got[1].numpy(), want[1][:, :k].astype(np.int32))
    np.testing.assert_allclose(got[2].numpy(), want[2][:, :k], rtol=2e-5 if law else 1e-6,
                               atol=1e-12)
    if law:
        assert np.all(got[2].numpy()[got[0].numpy() >= 1e5] == 0)
