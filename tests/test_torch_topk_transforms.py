"""The top-K path's distance transformations and models against the JAX
package on the CPU: the transformations (with the interpolation table's
clamps below, inside and above its range), the residence-time
interpolator, k_smallest (ties and exhausted rows), and TopKPairRates.shared
and HydroniumRates.shared. Tolerances as in ``test_torch_topk_tables.py``,
whose cases these are.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu.topo import models as jmodels
from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch.ops import topk_sweep as ts
from cmdlmc_tpu_torch.topo import models as tmodels
from cmdlmc_tpu_torch.topo.models import Frame

from test_torch_topk_tables import B, TRANSFORMS, XS, YS, _f, _models, _positions
from test_torch_slice import jax_kernels_run_to_end  # noqa: F401  (runs by itself)

torch.set_num_threads(1)


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
