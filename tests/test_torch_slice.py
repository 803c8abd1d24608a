"""The port's whole slice against the JAX package on the CPU: one small INI
(N=32 synthetic xyz, 12 protons, 16 replicas in RNG tiles of 4, 30 frames in
blocks of 10, print every 10, reset every 20, backend = fused) through the
JAX driver and through the port's driver started from the JAX package's own
initial state. At 4 tiles the JAX package takes its in-kernel-W route, which
lands in the same state as its streamed route (tests/engine/test_streamed.py),
so the port must match it: Autocorr and Jumps to 1e-5, MSD to rtol 1e-4, and
the final occupancy, sites and event counts exactly.

The same for an AngleTopology + FermiAngle configuration laid out like
tests/integration/test_full_pipeline.py (8 P atoms each with 4 O at 1.3 Å,
12 Å cube, 16 replicas in RNG tiles of 4): the JAX package takes its
in-kernel-W kernel with the angle gate, the port takes its in-kernel route
(K3's plain version), with the same bounds. And the route rule as the
driver applies it.

``test_torch_slice_topk.py`` does the same for the top-K path (kernel K4's
plain version, stage 1 by model.shared) on the first slice's trajectory:
NeighborTopology with max_neighbors = 8, and HydroniumTopology (k = 4, a
ReLU distance transformation, the residence-time blend), each printing
every frame over 4 frames with a reset at frame 2, so every launch spans
one frame and the JAX kernel compiles once (in interpret mode on the CPU,
several seconds, and about 0.7 s a frame); the JAX package runs its top-K
Pallas kernel in interpret mode, rows layout. Same bounds.

Also: the port's config loader against the JAX package's on every example
INI, and an import of the port's driver, CLI and kernel modules that leaves
jax out of sys.modules."""

import contextlib
import dataclasses
import functools
import glob
import importlib
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
from cmdlmc_tpu.io.xyz import write_xyz_frame
from cmdlmc_tpu_torch import convert, driver as tdriver
from cmdlmc_tpu_torch.config.schema import load_config as t_load_config
from cmdlmc_tpu_torch.ops import kmc_sweep as ks
from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss
from cmdlmc_tpu_torch.ops.pairwise import pairwise_cubic

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX package's Pallas kernels (the jitted functions around each
# pl.pallas_call)
_JAX_KERNELS = (
    ("cmdlmc_tpu.ops.kmc_sweep_streamed", "kmc_sweep_streamed"),
    ("cmdlmc_tpu.ops.kmc_sweep", "kmc_sweep"),
    ("cmdlmc_tpu.ops.topk_sweep", "topk_sweep"),
    ("cmdlmc_tpu.ops.knn_tables", "knn_block_tables"),
    ("cmdlmc_tpu.ops.knn_sparse", "knn_sparse_tables"),
    ("cmdlmc_tpu.ops.water_sweep", "water_sweep"),
    ("cmdlmc_tpu.ops.pairwise", "_pairwise_cubic_pallas"),
)


@contextlib.contextmanager
def jax_kernels_synchronous():
    """While it is open, each of the JAX package's Pallas kernels returns
    only once it has run, wherever it is called from. In interpret mode a
    kernel's ordered io_callbacks dispatch JAX work of their own (the
    device-barrier clocks of jax/_src/pallas/mosaic/interpret); when the
    main thread dispatches its next operation before the kernel ends, the
    two can wait on each other for good, which stopped whole test runs.
    The results are the same."""
    originals = [getattr(importlib.import_module(m), n) for m, n in _JAX_KERNELS]

    def synchronous(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            if not any(isinstance(x, jax.core.Tracer)
                       for x in jax.tree_util.tree_leaves(out)):
                jax.block_until_ready(out)
            return out
        return run

    patched = []
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith("cmdlmc_tpu."):
            continue
        for name, value in list(vars(mod).items()):
            if any(value is fn for fn in originals):
                patched.append((mod, name, value))
                setattr(mod, name, synchronous(value))
    try:
        yield
    finally:
        for mod, name, value in patched:
            setattr(mod, name, value)


@pytest.fixture(autouse=True, scope="module")
def jax_kernels_run_to_end():
    """Every module of the port's tests that reaches the JAX package's
    kernels imports this fixture: its kernels then run synchronously
    (:func:`jax_kernels_synchronous`)."""
    with jax_kernels_synchronous():
        yield

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


ANGLE_INI = """[Trajectory]
filename = {traj}
time_step = 0.4
[AtomBox]
type = AtomBoxCubic
periodic_boundaries = 12.0, 12.0, 12.0
[NeighborTopology]
type = AngleTopology
donor_atoms = O
extra_atoms = P
group_size = 4
cutoff = 3.0
buffer = 1.0
[JumpRate]
type = FermiAngle
a = 0.06
b = 2.3
c = 0.1
theta = 1.0
[KMCLattice]
lattice_size = 32
proton_number = 8
donor_atoms = O
time_step = 0.4
[Output]
type = ObservablesOutput
print_frequency = 1
reset_frequency = 4
[Engine]
replicas = {replicas}
tile = 4
seed = 1
block_size = 10
backend = fused
"""


def _both_drivers(ini):
    """Run ``ini`` through the JAX driver and through the port's on the CPU,
    the port from the JAX driver's own initial state; also count which
    route each of the port's launches took."""
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
    with _route_counts() as routes:
        tsim.run(out=tbuf)
    tsim.routes = dict(routes)
    return jsim, jbuf.getvalue(), tsim, tbuf.getvalue()


@contextlib.contextmanager
def _route_counts():
    """Count calls of the two routes' sweep functions."""
    counts = {"inkernel": 0, "streamed": 0}

    def counting(fn, name):
        def wrapped(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ks, "kmc_sweep", counting(ks.kmc_sweep, "inkernel"))
        mp.setattr(kss, "kmc_sweep_streamed",
                   counting(kss.kmc_sweep_streamed, "streamed"))
        yield counts


def _write_slice_traj(tmp):
    rng = np.random.RandomState(0)
    base = rng.uniform(0, 9.0, size=(32, 3))
    with open(tmp / "traj.xyz", "w") as f:
        for i in range(30):
            pos = base + rng.normal(scale=0.03, size=base.shape)
            f.write(f"32\nframe {i}\n")
            for x, y, z in pos:
                f.write(f"O {x:14.8f} {y:14.8f} {z:14.8f}\n")
    return tmp / "traj.xyz"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    ini = tmp / "slice.ini"
    ini.write_text(INI.format(traj=_write_slice_traj(tmp)))
    return _both_drivers(ini)


# the first slice's INI, printing every frame over 4 frames, with a reset at 2
_EVERY_FRAME = INI.replace("print_frequency = 10\nreset_frequency = 20",
                           "print_frequency = 1\nreset_frequency = 2").replace(
    "backend = fused\n", "backend = fused\nsweeps = 4\n")
TOPK_INI = _EVERY_FRAME.replace("buffer = 2.0\n", "buffer = 2.0\nmax_neighbors = 8\n")
HYDRONIUM_INI = _EVERY_FRAME.replace("type = NeighborTopology\n", "type = HydroniumTopology\n").replace(
    "buffer = 2.0\n", """buffer = 2.0
neighbors = 4
[DistanceTransformation]
type = ReLUTransformation
a = 0.5
b = 2.2
d0 = 2.2
left_bound = 2.0
right_bound = 3.3
[DistanceInterpolator]
relaxation_time = 2.0
""")


def _write_angle_inputs(tmp, replicas, frames=8):
    """Synthetic solid-acid-like trajectory: 8 'PO4-like' groups, each P
    with 4 O at 1.3 Å, every atom jittering frame to frame."""
    traj = tmp / "angle.xyz"
    if not traj.exists():
        rng = np.random.RandomState(0)
        p_pos = rng.uniform(0, 12, size=(8, 3))
        offsets = np.array([[1.3, 0, 0], [-1.3, 0, 0], [0, 1.3, 0], [0, -1.3, 0]])
        base = np.vstack([p_pos, (p_pos[:, None] + offsets[None]).reshape(-1, 3)])
        names = ["P"] * 8 + ["O"] * 32
        with open(traj, "w") as f:
            for _ in range(frames):
                write_xyz_frame(f, names, base + rng.normal(scale=0.05, size=base.shape))
    ini = tmp / f"angle_{replicas}.ini"
    ini.write_text(ANGLE_INI.format(traj=traj, replicas=replicas))
    return ini


@pytest.fixture(scope="module")
def angle_runs(tmp_path_factory):
    return _both_drivers(_write_angle_inputs(tmp_path_factory.mktemp("angle"), 16))


def _table(text):
    lines = text.splitlines()
    header = [ln for ln in lines if ln.startswith("#") and "Sweeps" in ln]
    rows = [ln.split() for ln in lines if ln.strip() and not ln.startswith("#")]
    return header, rows


def _rows_match(runs, frames):
    jsim, jtext, tsim, ttext = runs
    jh, jrows = _table(jtext)
    th, trows = _table(ttext)
    assert th == jh and len(th) == 1
    assert len(trows) == len(jrows) == len(frames)
    assert all(len(r) == 7 for r in trows)
    assert "# perf:" in ttext
    assert [r.frame for r in tsim.records] == [r.frame for r in jsim.records] == frames
    for t, j in zip(tsim.records, jsim.records):
        assert t.time == pytest.approx(j.time)
        np.testing.assert_allclose(t.autocorr, j.autocorr, atol=1e-5)
        np.testing.assert_allclose(t.jumps, j.jumps, atol=1e-5)
        np.testing.assert_allclose(t.msd, j.msd, rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(t.msd4, j.msd4, rtol=1e-4, atol=1e-7)
    assert max(r.jumps for r in tsim.records) > 0


def test_rows_match_jax(runs):
    _rows_match(runs, [0, 10, 20])


def test_angle_rows_match_jax(angle_runs):
    _rows_match(angle_runs, list(range(8)))
    _final_state_matches(angle_runs)


def test_route_rule(runs, angle_runs, tmp_path):
    """Both slices run 4 RNG tiles: every launch takes the in-kernel route,
    as the JAX package's did. At 16 tiles (64 replicas) the angle
    configuration takes stage 1 + the streamed sweep."""
    for r in (runs, angle_runs):
        routes = r[2].routes
        assert routes["inkernel"] > 0 and routes["streamed"] == 0, routes
    cfg = t_load_config(str(_write_angle_inputs(tmp_path, 64, frames=3)))
    sim = tdriver.Simulation(cfg, device="cpu")
    with _route_counts() as routes:
        sim.run(out=io.StringIO())
    assert routes["streamed"] > 0 and routes["inkernel"] == 0, routes
    assert int(sim.final_states.replicas.clock.event_count.sum()) > 0


def test_final_state_matches_jax(runs):
    _final_state_matches(runs)


def _final_state_matches(runs):
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
    assert ks.kmc_sweep.launches == 0


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
        ("engine", "backend", "scan"),
        ("topology", "type_", "KMCWater"),
    ):
        bad = dataclasses.replace(
            cfg, **{section: dataclasses.replace(getattr(cfg, section),
                                                 **{field: value})})
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tdriver.Simulation(bad, device="cpu")
    # AngleTopology on a supercell would group differently from the JAX driver
    angle_box = dataclasses.replace(
        cfg, topology=dataclasses.replace(cfg.topology, type_="AngleTopology",
                                          extra_atoms="P", group_size=4),
        atombox=dataclasses.replace(cfg.atombox, box_multiplier=(2, 2, 2)))
    with pytest.raises(NotImplementedError, match="box_multiplier"):
        tdriver.Simulation(angle_box, device="cpu")
    # the box_multiplier supercell and Verlet candidate reuse on the top-K
    # path (forced on, or at a lattice size where the auto rule turns it on)
    # are ported: they configure
    sim = tdriver.Simulation(dataclasses.replace(
        cfg, atombox=dataclasses.replace(cfg.atombox, box_multiplier=(2, 2, 2))),
        device="cpu")
    assert torch.equal(torch.diagonal(sim.cell.h), torch.full((3,), 18.0))
    for engine, kmc in (({"nbr_reuse": "on"}, {}),
                        ({"nbr_reuse": "auto"}, {"lattice_size": 1024,
                                                 "proton_number": 12})):
        ok = dataclasses.replace(
            cfg, topology=dataclasses.replace(cfg.topology, max_neighbors=8),
            engine=dataclasses.replace(cfg.engine, **engine),
            kmc=dataclasses.replace(cfg.kmc, **kmc))
        assert type(tdriver.Simulation(ok, device="cpu").model).__name__ == "TopKPairRates"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tdriver.Simulation(cfg, device="cuda")


def test_port_imports_no_jax():
    code = (
        "import sys, cmdlmc_tpu_torch.driver, cmdlmc_tpu_torch.cli.mdmc, "
        "cmdlmc_tpu_torch.convert, cmdlmc_tpu_torch.ops.kmc_sweep, "
        "cmdlmc_tpu_torch.topo.models, cmdlmc_tpu_torch.ops.topk_sweep, "
        "cmdlmc_tpu_torch.ops.knn_tables, cmdlmc_tpu_torch.topo.transforms, "
        "cmdlmc_tpu_torch.ops.knn_sparse, cmdlmc_tpu_torch.engine.lattice, "
        "cmdlmc_tpu_torch.core.cell\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'cmdlmc_tpu'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
