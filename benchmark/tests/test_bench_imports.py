"""What the benchmark loads: nothing of JAX or the JAX package in a run (the
port's name begins with the JAX package's, so names are compared whole,
by the part before the first dot), and the reference loads nothing of the
program either. Each check runs in a fresh process."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
from pathlib import Path
from benchmark import harness
from benchmark.tests import tiny
harness.run_cell(tiny.dense(), 5, 0.5, False, "cpu", time.perf_counter(),
                 work=Path({work!r}))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from benchmark import check, yardstick
from benchmark.reference import kmc, rng, trajectory
pos = torch.from_numpy(trajectory.jitter_frames(12, 3, 8.0, 0.03, 0, 1))
w, d = kmc.dense_rates(pos, (8.0,) * 3, {{"a": 0.06, "b": 2.3, "c": 0.1}}, 5.0)
kmc.knn_f32(pos[0], (8.0,) * 3, 5.0, 4)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    loaded = _modules(RUN.format(root=str(ROOT), work=str(tmp_path)))
    assert "cmdlmc_tpu_torch" in loaded  # the port ran
    assert not loaded & {"jax", "jaxlib", "flax", "cmdlmc_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules(REFERENCE.format(root=str(ROOT)))
    assert "benchmark" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "cmdlmc_tpu", "cmdlmc_tpu_torch"}
