"""The driver's scan route against the JAX driver on the CPU (where the JAX
driver runs its scan engine for ``backend = auto`` and ``scan``).

A small INI (N = 32 synthetic xyz, 12 protons, 16 replicas, 30 frames in
blocks of 10, print every 5, reset every 10): the port runs it from the JAX
driver's own initial state (``init_replicas(fold_in(key(seed), 0))``,
carried over by ``convert``) with the keys it makes itself, JAX's
``split(fold_in(key(seed), 1), R)``. Rows agree: frame, time, Autocorr and
Jumps to 1e-5, MSD to rtol 1e-4 (the scan engines make the same decisions;
their float sums run in another order).

* ``backend = scan``, and ``backend = auto`` on a top-K k = 20 config (the
  top-K kernel takes k <= 16: the route logs the refusal and runs the scan
  engine); XYZOutput on the scan route prints the JAX driver's frames;
* a JAX scan checkpoint (frame 10) resumed by the port and by the JAX
  driver: the same rows;
* a port checkpoint (frame 10, with the keys) resumed by the JAX driver:
  the rows of the port's own resume;
* ``backend = fused`` on a configuration the kernels refuse still raises
  with the reason.

No Pallas kernel of the JAX package runs here (its distance kernel starts
at 512 sites).
"""

import dataclasses
import io
import logging
import shutil

import jax
import numpy as np
import pytest
import torch

from cmdlmc_tpu import driver as jdriver
from cmdlmc_tpu.config.schema import load_config as j_load_config
from cmdlmc_tpu.engine import lattice as jeng
from cmdlmc_tpu.io.xyz import write_xyz_frame
from cmdlmc_tpu_torch import convert, driver as tdriver
from cmdlmc_tpu_torch.config.schema import load_config as t_load_config

torch.set_num_threads(1)

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
{topology}[JumpRate]
type = Fermi
a = 0.2
b = 2.3
c = 0.1
[KMCLattice]
lattice_size = 32
proton_number = 12
time_step = 0.5
[Output]
type = {output}
print_frequency = 5
reset_frequency = 10
[Engine]
replicas = 16
seed = 1
block_size = 10
backend = {backend}
{engine}"""


@pytest.fixture(scope="module")
def traj(tmp_path_factory):
    path = tmp_path_factory.mktemp("scan") / "traj.xyz"
    rng = np.random.RandomState(0)
    base = rng.uniform(0, 9.0, size=(32, 3))
    with open(path, "w") as f:
        for _ in range(30):
            write_xyz_frame(f, ["O"] * 32, base + rng.normal(scale=0.03, size=base.shape))
    return path


def _ini(tmp_path, traj, name="run.ini", backend="scan", topology="", engine="",
         output="ObservablesOutput"):
    path = tmp_path / name
    path.write_text(INI.format(traj=traj, backend=backend, topology=topology,
                               engine=engine, output=output))
    return path


def _jax_init(ini):
    cfg = j_load_config(str(ini))
    names, pos, _ = next(jdriver.build_trajectory(cfg).iter_batches())
    first = pos[0][names == "O"]
    key = jax.random.key(cfg.engine.seed)
    return jeng.init_replicas(jax.random.fold_in(key, 0), cfg.engine.replicas,
                              first.shape[0], cfg.kmc.proton_number, first)


def _rows(text):
    return np.array([[float(v) for v in ln.split()] for ln in text.splitlines()
                     if ln and not ln.startswith("#")])


def _run_jax(ini):
    out = io.StringIO()
    jdriver.run_from_config(str(ini), out=out)
    return out.getvalue()


def _run_port(ini, init=None):
    out = io.StringIO()
    sim = tdriver.Simulation(t_load_config(str(ini)), device="cpu", initial_state=init)
    sim.run(out=out)
    return out.getvalue(), sim


def _assert_rows(got, want, n):
    got, want = _rows(got), _rows(want)
    assert got.shape == want.shape and got.shape[0] == n, (got.shape, want.shape)
    np.testing.assert_allclose(got[:, [0, 1, 5, 6]], want[:, [0, 1, 5, 6]], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got[:, 2:5], want[:, 2:5], rtol=1e-4, atol=1e-4)
    assert want[:, 6].max() > 0


@pytest.mark.parametrize("backend,topology", [
    ("scan", ""), ("auto", "max_neighbors = 20\n")], ids=["scan", "auto-k20"])
def test_scan_route_matches_jax(tmp_path, traj, backend, topology, caplog):
    ini = _ini(tmp_path, traj, backend=backend, topology=topology)
    want = _run_jax(ini)
    with caplog.at_level(logging.WARNING, logger="cmdlmc_tpu_torch.driver"):
        got, sim = _run_port(ini, convert.ensemble_from_numpy(_jax_init(ini)))
    assert sim.use_scan
    if backend == "auto":
        assert any("k=20" in r.getMessage() and "scan engine" in r.getMessage()
                   for r in caplog.records)
    _assert_rows(got, want, 6)


def test_xyz_output_on_the_scan_route_matches_jax(tmp_path, traj):
    ini = _ini(tmp_path, traj, output="XYZOutput")
    want = _run_jax(ini)
    got, _ = _run_port(ini, convert.ensemble_from_numpy(_jax_init(ini)))

    def body(text):
        return [ln for ln in text.splitlines() if not ln.startswith("#")]

    assert sum(ln.startswith("frame ") for ln in body(want)) == 6
    assert body(got) == body(want)


def test_jax_checkpoint_resumes_in_both(tmp_path, traj):
    """The JAX driver stops at frame 10 with a checkpoint; the port and the
    JAX driver each resume a copy of it to the end: the same rows."""
    ckpt = tmp_path / "jax.npz"
    engine = f"checkpoint_path = {ckpt}\ncheckpoint_interval = 1\n"
    stop = _ini(tmp_path, traj, "stop.ini", engine=engine + "sweeps = 10\n")
    _run_jax(stop)
    shutil.copy(ckpt, tmp_path / "port.npz")
    want = _run_jax(_ini(tmp_path, traj, "j.ini", engine=engine))
    port_engine = f"checkpoint_path = {tmp_path / 'port.npz'}\ncheckpoint_interval = 1\n"
    got, _ = _run_port(_ini(tmp_path, traj, "t.ini", engine=port_engine))
    _assert_rows(got, want, 4)


def test_port_checkpoint_resumes_in_jax(tmp_path, traj):
    """The port stops at frame 10 with a checkpoint, which now carries the
    keys; the JAX driver resumes a copy of it and prints the rows of the
    port's own resume."""
    ckpt = tmp_path / "port.npz"
    engine = f"checkpoint_path = {ckpt}\ncheckpoint_interval = 1\n"
    _run_port(_ini(tmp_path, traj, "stop.ini", engine=engine + "sweeps = 10\n"))
    with np.load(ckpt) as f:
        assert f["keys"].dtype == np.uint32 and f["keys"].shape == (16, 2)
    shutil.copy(ckpt, tmp_path / "jax.npz")
    got, _ = _run_port(_ini(tmp_path, traj, "t.ini", engine=engine))
    jax_engine = f"checkpoint_path = {tmp_path / 'jax.npz'}\ncheckpoint_interval = 1\n"
    want = _run_jax(_ini(tmp_path, traj, "j.ini", engine=jax_engine))
    _assert_rows(got, want, 4)


def test_fused_backend_on_a_refused_configuration_raises(tmp_path, traj):
    cfg = t_load_config(str(_ini(tmp_path, traj, backend="fused",
                                 topology="max_neighbors = 20\n")))
    with pytest.raises(ValueError, match=r"backend = fused .*k=20"):
        tdriver.Simulation(cfg, device="cpu")
    skewed = dataclasses.replace(cfg, topology=dataclasses.replace(
        cfg.topology, max_neighbors=None), atombox=dataclasses.replace(
        cfg.atombox, type_="AtomBoxMonoclinic",
        periodic_boundaries=(9.0, 0.0, 0.0, 4.0, 8.0, 0.0, 0.0, 0.0, 9.0)))
    with pytest.raises(ValueError, match="skewed"):
        tdriver.Simulation(skewed, device="cpu")
    auto = dataclasses.replace(skewed, engine=dataclasses.replace(skewed.engine,
                                                                  backend="auto"))
    assert tdriver.Simulation(auto, device="cpu").use_scan
