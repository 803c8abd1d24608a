"""The port's whole slice against the JAX package on the CPU: one small INI
(N=32 synthetic xyz, 12 protons, 16 replicas in RNG tiles of 4, 30 frames in
blocks of 10, print every 10, reset every 20, backend = fused) through the
JAX driver and through the port's driver started from the JAX package's own
initial state. At 4 tiles the JAX package takes its in-kernel-W route, which
lands in the same state as its streamed route (tests/engine/test_streamed.py),
so the port must match it: Autocorr and Jumps to 1e-5, MSD to rtol 1e-4, and
the final occupancy, sites and event counts exactly.

Also: the port's config loader against the JAX package's on every example
INI, and an import of the port's driver and CLI that leaves jax out of
sys.modules."""

import dataclasses
import glob
import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cmdlmc_tpu import driver as jdriver
from cmdlmc_tpu.config.schema import load_config as j_load_config
from cmdlmc_tpu.engine import lattice as jeng
from cmdlmc_tpu_torch import convert, driver as tdriver
from cmdlmc_tpu_torch.config.schema import load_config as t_load_config
from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss
from cmdlmc_tpu_torch.ops.pairwise import pairwise_cubic

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

INI = """[Trajectory]
filename = {traj}
time_step = 0.5
[AtomBox]
type = AtomBoxCubic
periodic_boundaries = 9.0, 9.0, 9.0
[NeighborTopology]
type = NeighborTopology
donor_atoms = O
cutoff = 3.0
buffer = 2.0
[JumpRate]
type = Fermi
a = 0.2
b = 2.3
c = 0.1
[KMCLattice]
lattice_size = 32
proton_number = 12
time_step = 0.5
[Output]
type = ObservablesOutput
print_frequency = 10
reset_frequency = 20
[Engine]
replicas = 16
tile = 4
seed = 1
block_size = 10
backend = fused
"""


def _recording(cls):
    class Recording(cls):
        def observable_rows(self):
            self.records = []
            for r in super().observable_rows():
                self.records.append(r)
                yield r

    return Recording


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    rng = np.random.RandomState(0)
    base = rng.uniform(0, 9.0, size=(32, 3))
    with open(tmp / "traj.xyz", "w") as f:
        for i in range(30):
            pos = base + rng.normal(scale=0.03, size=base.shape)
            f.write(f"32\nframe {i}\n")
            for x, y, z in pos:
                f.write(f"O {x:14.8f} {y:14.8f} {z:14.8f}\n")
    ini = tmp / "slice.ini"
    ini.write_text(INI.format(traj=tmp / "traj.xyz"))

    jcfg = j_load_config(str(ini))
    jsim = _recording(jdriver.Simulation)(jcfg)
    jbuf = io.StringIO()
    jsim.run(out=jbuf)

    # the JAX driver's own initialization (driver.py: init_replicas)
    names, pos, _ = next(jdriver.build_trajectory(jcfg).iter_batches())
    first = pos[0][names == "O"]
    key = jax.random.key(jcfg.engine.seed)
    jinit = jeng.init_replicas(jax.random.fold_in(key, 0), jcfg.engine.replicas,
                               first.shape[0], jcfg.kmc.proton_number, first)
    tcfg = t_load_config(str(ini))
    kss.kmc_sweep_streamed.launches = 0
    pairwise_cubic.launches = 0
    tsim = _recording(tdriver.Simulation)(
        tcfg, device="cpu", initial_state=convert.ensemble_from_numpy(jinit))
    tbuf = io.StringIO()
    tsim.run(out=tbuf)
    return jsim, jbuf.getvalue(), tsim, tbuf.getvalue()


def _table(text):
    lines = text.splitlines()
    header = [ln for ln in lines if ln.startswith("#") and "Sweeps" in ln]
    rows = [ln.split() for ln in lines if ln.strip() and not ln.startswith("#")]
    return header, rows


def test_rows_match_jax(runs):
    jsim, jtext, tsim, ttext = runs
    jh, jrows = _table(jtext)
    th, trows = _table(ttext)
    assert th == jh and len(th) == 1
    assert len(trows) == len(jrows) == 3
    assert all(len(r) == 7 for r in trows)
    assert "# perf:" in ttext
    assert [r.frame for r in tsim.records] == [r.frame for r in jsim.records] == [0, 10, 20]
    for t, j in zip(tsim.records, jsim.records):
        assert t.time == pytest.approx(j.time)
        np.testing.assert_allclose(t.autocorr, j.autocorr, atol=1e-5)
        np.testing.assert_allclose(t.jumps, j.jumps, atol=1e-5)
        np.testing.assert_allclose(t.msd, j.msd, rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(t.msd4, j.msd4, rtol=1e-4, atol=1e-7)
    assert max(r.jumps for r in tsim.records) > 0


def test_final_state_matches_jax(runs):
    jsim, _, tsim, _ = runs
    jrep, trep = jsim.final_states.replicas, tsim.final_states.replicas
    np.testing.assert_array_equal(trep.occ.numpy(), np.asarray(jrep.occ))
    np.testing.assert_array_equal(trep.site_of_proton.numpy(),
                                  np.asarray(jrep.site_of_proton))
    np.testing.assert_array_equal(trep.clock.event_count.numpy(),
                                  np.asarray(jrep.clock.event_count))
    assert int(trep.clock.event_count.sum()) > 0
    # CPU tensors never reach the kernels
    assert kss.kmc_sweep_streamed.launches == 0 and pairwise_cubic.launches == 0


def test_settings_echo_matches_jax(runs):
    jsim, jtext, tsim, ttext = runs
    assert tdriver.config_echo(tsim.cfg) == jdriver.config_echo(jsim.cfg)
    assert tdriver.config_fingerprint(tsim.cfg) == jdriver.config_fingerprint(jsim.cfg)


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(REPO, "examples", "*.ini"))),
    ids=os.path.basename,
)
def test_load_config_matches_jax(path):
    assert repr(t_load_config(path)) == repr(j_load_config(path))


def test_unsupported_features_raise(runs):
    jsim = runs[0]
    cfg = t_load_config(io.StringIO(INI.format(traj=jsim.cfg.trajectory.filename)))
    for section, field, value in (
        ("engine", "checkpoint_path", "x.npz"),
        ("engine", "backend", "scan"),
        ("output", "jumpstat_bins", 4),
        ("topology", "max_neighbors", 8),
    ):
        bad = dataclasses.replace(
            cfg, **{section: dataclasses.replace(getattr(cfg, section),
                                                 **{field: value})})
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tdriver.Simulation(bad, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tdriver.Simulation(cfg, device="cuda")


def test_port_imports_no_jax():
    code = (
        "import sys, cmdlmc_tpu_torch.driver, cmdlmc_tpu_torch.cli.mdmc, "
        "cmdlmc_tpu_torch.convert\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'cmdlmc_tpu'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
