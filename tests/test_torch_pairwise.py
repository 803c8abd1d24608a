"""The port's distances and dense rate matrices against the JAX package on
the CPU: K2's plain version against the JAX B7 kernel (interpret mode) and
its XLA build, and PairRates.shared's W against the JAX model's. The cases
come from ``test_torch_geometry.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu.core import cell as jcell
from cmdlmc_tpu.ops.pairwise import _pairwise_cubic_pallas
from cmdlmc_tpu.rates import laws as jlaws
from cmdlmc_tpu.topo.models import Frame as JFrame, PairRates as JPairRates
from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch.ops.kmc_sweep_streamed import dense_tables
from cmdlmc_tpu_torch.ops.pairwise import pairwise_cubic, pairwise_reference

from test_torch_geometry import LAWS
from test_torch_slice import jax_kernels_run_to_end  # noqa: F401  (runs by itself)

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [64, 144, 200])
def test_pairwise_reference_matches_pallas_and_xla(n):
    """atol 2e-4, the JAX package's own bound for its kernel
    (tests/ops/test_pairwise.py)."""
    rng = np.random.RandomState(n)
    pos = rng.uniform(-15, 25, size=(n, 3)).astype(np.float32)
    box = [17.0, 11.0, 23.0]
    jc = jcell.Cell.cubic(box)
    pallas = np.asarray(_pairwise_cubic_pallas(
        jnp.asarray(pos), jnp.diagonal(jc.h), interpret=True))
    xla = np.asarray(jcell.pairwise_distances(jc, jnp.asarray(pos), jnp.asarray(pos)))
    got = pairwise_reference(torch.from_numpy(pos), torch.tensor(box)).numpy()
    np.testing.assert_allclose(got, pallas, atol=2e-4)
    np.testing.assert_allclose(got, xla, atol=2e-4)
    # the wrapper takes the plain version for CPU tensors, batched
    batch = np.stack([pos, pos[::-1].copy()])
    got_b = pairwise_cubic(torch.from_numpy(batch), box).numpy()
    np.testing.assert_array_equal(got_b[0], got)
    assert pairwise_cubic.launches == 0


@pytest.mark.parametrize("law", [LAWS[0], LAWS[3]], ids=["fermi", "ae"])
def test_pair_rates_w_matches_jax(law):
    """W of PairRates.shared, block-batched, against the JAX model frame by
    frame: rtol 1e-6 (identical distances, law as above)."""
    name, params = law
    rng = np.random.RandomState(2)
    base = rng.uniform(0, 14.5, size=(144, 3)).astype(np.float32)
    block = (base[None] + rng.normal(scale=0.03, size=(3, 144, 3))).astype(np.float32)
    jc = jcell.Cell.cubic([14.5] * 3)
    jlaw = getattr(jlaws, name)(**{k: jnp.float32(v) for k, v in params.items()})
    jmodel = JPairRates(cell=jc, law=jlaw, cutoff=jnp.float32(3.0),
                        buffer=jnp.float32(2.0))
    tmodel = convert.pair_rates_from_fields(jmodel)
    w = dense_tables(tmodel, torch.from_numpy(block)).numpy()
    for f in range(block.shape[0]):
        sh = jmodel.shared(JFrame(donors=jnp.asarray(block[f]), extras=None,
                                  time=jnp.float32(0), index=jnp.int32(0)))
        np.testing.assert_allclose(w[f], np.asarray(sh.W), rtol=1e-6, atol=0)
        assert (w[f] > 0).sum() == (np.asarray(sh.W) > 0).sum()
