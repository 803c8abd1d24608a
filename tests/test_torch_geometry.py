"""Geometry and stage 1 of the port against the JAX package on the CPU:
minimum image and distances (cubic and triclinic) and the rate laws; the
plain version of the distance kernel K2 and the PairRates rate matrix W are
in ``test_torch_pairwise.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu.core import cell as jcell
from cmdlmc_tpu.rates import laws as jlaws
from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch.core import cell as tcell
from cmdlmc_tpu_torch.rates import laws as tlaws

from test_torch_slice import jax_kernels_run_to_end  # noqa: F401  (runs by itself)

torch.set_num_threads(1)

CELLS = {
    "cubic": ([17.0, 11.0, 23.0], jcell.Cell.cubic, tcell.Cell.cubic),
    "triclinic": ([[10, 0, 0], [3, 9, 0], [1, 0.5, 8]],
                  jcell.Cell.triclinic, tcell.Cell.triclinic),
}


def _cells(kind):
    box, jmake, tmake = CELLS[kind]
    return jmake(box), tmake(box)


@pytest.mark.parametrize("kind", ["cubic", "triclinic"])
def test_cell_minimum_image_and_distances(kind):
    """Tolerance 1e-6 (absolute, Å): float32 geometry in both packages."""
    jc, tc = _cells(kind)
    np.testing.assert_allclose(tc.h.numpy(), np.asarray(jc.h), rtol=0, atol=0)
    np.testing.assert_allclose(tc.h_inv.numpy(), np.asarray(jc.h_inv), atol=1e-6)
    assert tc.orthorhombic == jc.orthorhombic
    rng = np.random.RandomState(4)
    a = rng.uniform(-12, 30, size=(40, 3)).astype(np.float32)
    b = rng.uniform(-12, 30, size=(40, 3)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(
        tcell.minimum_image(tc, tb - ta).numpy(),
        np.asarray(jcell.minimum_image(jc, jnp.asarray(b - a))), atol=1e-6,
    )
    np.testing.assert_allclose(
        tcell.displacement(tc, ta, tb).numpy(),
        np.asarray(jcell.displacement(jc, jnp.asarray(a), jnp.asarray(b))),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        tcell.distance(tc, ta, tb).numpy(),
        np.asarray(jcell.distance(jc, jnp.asarray(a), jnp.asarray(b))), atol=1e-6,
    )
    np.testing.assert_allclose(
        tcell.pairwise_distances(tc, ta, tb).numpy(),
        np.asarray(jcell.pairwise_distances(jc, jnp.asarray(a), jnp.asarray(b))),
        atol=1e-6,
    )


def test_from_parameter_array():
    c3 = tcell.Cell.from_parameter_array([9, 8, 7], box_multiplier=(2, 1, 1))
    j3 = jcell.Cell.from_parameter_array([9, 8, 7], box_multiplier=(2, 1, 1))
    np.testing.assert_array_equal(c3.h.numpy(), np.asarray(j3.h))
    c9 = tcell.Cell.from_parameter_array([10, 0, 0, 3, 9, 0, 0, 0, 8])
    assert not c9.orthorhombic
    with pytest.raises(ValueError):
        tcell.Cell.from_parameter_array([1, 2])


LAWS = [
    ("Fermi", dict(a=0.06, b=2.3, c=0.1)),
    ("Constant", dict(a=0.02)),
    ("Exponential", dict(a=0.5, b=-1.3)),
    ("ActivationEnergy", dict(A=0.1, a=0.8, b=1.5, d0=2.4, T=300.0)),
]


@pytest.mark.parametrize("name,params", LAWS)
def test_laws(name, params):
    """rtol 1e-6: the same float32 expression; exp differs between the two
    math libraries by at most an ulp or two."""
    d = np.random.RandomState(1).uniform(1.5, 5.0, size=500).astype(np.float32)
    d[:3] = [2.4, 2.3, 5.0]  # AE pole and the Fermi midpoint
    jlaw = getattr(jlaws, name)(**{k: jnp.float32(v) for k, v in params.items()})
    tlaw = getattr(tlaws, name)(**params)
    np.testing.assert_allclose(
        tlaw(torch.from_numpy(d)).numpy(), np.asarray(jlaw(jnp.asarray(d))),
        rtol=1e-6,
    )
    port = convert.law_from_fields(jlaw)
    assert type(port) is type(tlaw)
    for n in tlaw.param_names:
        assert float(getattr(port, n)) == float(getattr(tlaw, n))


