"""The port's top-K slice against the JAX package on the CPU: the output
rows of the top-K (k=8) and hydronium (k=4) configurations, frame by frame,
through both drivers. The configurations come from ``test_torch_slice.py``.
"""

import pytest
import torch

from cmdlmc_tpu_torch.ops import topk_sweep as ts
from cmdlmc_tpu_torch.ops.knn_tables import knn_block_tables

from test_torch_slice import (  # noqa: F401  (the fixture runs by itself)
    HYDRONIUM_INI, TOPK_INI, _both_drivers, _final_state_matches, _rows_match,
    _write_slice_traj, jax_kernels_run_to_end,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["topk", "hydronium"])
def topk_runs(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    ini = tmp / "slice.ini"
    text = TOPK_INI if request.param == "topk" else HYDRONIUM_INI
    ini.write_text(text.format(traj=_write_slice_traj(tmp)))
    ts.topk_sweep.launches = knn_block_tables.launches = 0
    return _both_drivers(ini)


def test_topk_rows_match_jax(topk_runs):
    """max_neighbors = 8 and HydroniumTopology: the rows and the final state
    of the JAX driver (its top-K kernel), the port on K4's plain version."""
    _rows_match(topk_runs, list(range(4)))
    _final_state_matches(topk_runs)
    tsim = topk_runs[2]
    assert type(tsim.model).__name__ in ("TopKPairRates", "HydroniumRates")
    assert tsim.routes == {"inkernel": 0, "streamed": 0}
    assert ts.topk_sweep.launches == 0 and knn_block_tables.launches == 0
