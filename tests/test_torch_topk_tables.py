"""Stage 1 of the port's top-K path against the JAX package on the CPU: the
distance transformations (with the interpolation table's clamps below,
inside and above its range) and the residence-time interpolator, k_smallest
(ties and exhausted rows), TopKPairRates.shared and HydroniumRates.shared,
the plain version of kernel K5 against the JAX K5 kernel (B5) in interpret
mode and against the JAX package's XLA build, and the port's topk_tables
against the JAX topk_tables with the law precomputed and not.

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
from cmdlmc_tpu_torch.topo import models as tmodels
from cmdlmc_tpu_torch.topo.models import Frame

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


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transforms_match_jax(name):
    # below, at and inside the bounds and the table, above them, and the 1e6 fill
    d = np.concatenate([np.linspace(0.5, 4.5, 161), XS, [1.0e6]]).astype(np.float32)
    jt = TRANSFORMS[name]
    tt = convert.transform_from_fields(jt)
    got = tt(torch.from_numpy(d)).numpy()
    want = np.asarray(jt(jnp.asarray(d)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if name == "interpolated":
        assert np.all(got[d < XS[0]] == YS[0]) and np.all(got[d > XS[-1]] == d[d > XS[-1]])
        inside = (d > XS[0]) & (d < XS[-1])
        assert np.any(got[inside] != d[inside])


def test_distance_interpolator_matches_jax():
    """The port's DistanceInterpolator holds the relaxation time; the top-K
    sweep blends in its own form d + ratio (r - d). Its candidate rates with
    the blend against the JAX interpolator followed by the law, on residence
    times below 0 (never jumped), at 0, inside and past the relaxation time:
    rtol 2e-5 (the two forms round an ulp apart, the law makes that about 25
    ulp)."""
    rng = np.random.RandomState(1)
    m, t = 64, np.float32(100.0)
    # multiples of 1/64, so t - (t - res) == res exactly in float32
    res = np.concatenate([[-1.0, 0.0, 20.0, 50.0],
                          np.round(rng.uniform(-5, 40, m - 4) * 64) / 64]).astype(np.float32)
    dn = rng.uniform(2, 3.5, m).astype(np.float32)
    dr = rng.uniform(2, 3.5, m).astype(np.float32)
    jm, tm = _models("relu", 4)
    assert float(tm.interpolator.relaxation_time) == 20.0
    want = np.asarray(jm.law(jnp.minimum(jm.interpolator(res, dn, dr), 50.0)))
    # sites 0..m-1 occupied, each with slot 0 pointing at an empty site m + i
    occ = torch.cat([torch.ones(1, m), torch.zeros(1, m)], dim=1)
    tls = torch.from_numpy(np.where(res < 0, -1.0, t - res).astype(np.float32))
    tls = torch.cat([tls[None], torch.full((1, m), -1.0)], dim=1)
    pad = np.full(m, 1.0e6, np.float32)
    rates = ts.candidate_rates(
        torch.from_numpy(np.concatenate([dn, pad]))[None],
        torch.from_numpy(np.concatenate([np.arange(m, 2 * m), np.zeros(m)]).astype(np.int32))[None],
        torch.from_numpy(np.concatenate([dr, pad]))[None], occ, tls,
        torch.tensor(t), ts.law_params8(tm), kind=0, blend=True)
    np.testing.assert_allclose(rates[0, 0, :m].numpy(), want, rtol=2e-5)
    assert torch.equal(rates[0, 0, m:], torch.zeros(m))


def test_k_smallest_matches_jax():
    """Ties (an integer-valued matrix with many repeats) and exhausted rows
    (fewer finite entries than k): the same indices and distances."""
    rng = np.random.RandomState(2)
    d = rng.randint(0, 6, size=(12, 20)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.5] = np.inf
    d[3] = np.inf  # a row with no finite entry at all
    for k in (1, 5, 9):
        got_d, got_i = tmodels.k_smallest(torch.from_numpy(d), k)
        want_d, want_i = jmodels.k_smallest(jnp.asarray(d), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    assert np.all(got_i.numpy()[3] == 0)


@pytest.mark.parametrize("name,k", [("topk", 8), ("relu", 4), ("interp_table", 4),
                                    ("plain", 4)])
def test_shared_matches_jax(name, k):
    jm, tm = _models(name, k)
    pos = _positions()
    got = tm.shared(Frame(donors=torch.from_numpy(pos)))  # the whole block at once
    for f in range(B):
        want = jm.shared(jmodels.Frame(donors=jnp.asarray(pos[f]), extras=None,
                                       time=_f(0.0), index=jnp.int32(0)))
        np.testing.assert_array_equal(got.nbr[f].numpy(), np.asarray(want.nbr))
        np.testing.assert_array_equal(got.valid[f].numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.dist[f].numpy(), np.asarray(want.dist))
        np.testing.assert_allclose(got.dist_rescaled[f].numpy(),
                                   np.asarray(want.dist_rescaled), rtol=1e-6)
    assert not bool(got.valid.all())  # some slots run out of neighbors in range


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
