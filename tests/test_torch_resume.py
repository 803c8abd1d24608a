"""The port's driver resumes from its checkpoints bit for bit, on the CPU (the
kernels' plain versions), as ``tests/integration/test_driver_checkpoint.py``,
``test_checkpoint_robustness.py`` and ``test_xyz_backend.py`` hold the JAX
package's: a run stopped at a checkpoint and resumed prints the rows of the
straight run and ends in its state, with or without the ``.npz`` suffix,
with the top-K neighbor carry and in XYZOutput mode; a finished run is not
simulated again; other physics and a block size that straddles the
checkpoint are refused. XYZOutput ends in the observables run's state, and
its frames are the JAX driver's text. ``config_fingerprint`` is the JAX
package's on every example INI. Runs are tiny (32 sites, 16 replicas in
RNG tiles of 4, at most 80 frames); no JAX kernel runs here."""

import dataclasses
import glob
import io
import os

import numpy as np
import pytest
import torch

from cmdlmc_tpu import driver as jdriver
from cmdlmc_tpu.config.schema import load_config as j_load_config
from cmdlmc_tpu_torch import driver as tdriver
from cmdlmc_tpu_torch.config.schema import load_config as t_load_config
from cmdlmc_tpu_torch.io.xyz import write_xyz_frame
from cmdlmc_tpu_torch.ops import threefry

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
print_frequency = 10
reset_frequency = 30
[Engine]
replicas = 16
tile = 4
seed = {seed}
block_size = {block}
sweeps = {sweeps}
{engine}"""


@pytest.fixture(scope="module")
def traj(tmp_path_factory):
    rng = np.random.RandomState(0)
    base = rng.uniform(0, 9.0, size=(32, 3))
    path = tmp_path_factory.mktemp("resume") / "t.xyz"
    with open(path, "w") as f:
        for _ in range(80):
            write_xyz_frame(f, ["O"] * 32, base + rng.normal(scale=0.03, size=base.shape))
    return path


def run(traj, sweeps=80, ckpt=None, block=20, seed=1, output="ObservablesOutput",
        topology="", interval=0):
    engine = ""
    if ckpt:
        engine = f"checkpoint_path = {ckpt}\ncheckpoint_interval = {interval}\n"
    text = INI.format(traj=traj, sweeps=sweeps, block=block, seed=seed,
                      output=output, topology=topology, engine=engine)
    out = io.StringIO()
    sim = tdriver.run_from_config(io.StringIO(text), out=out, device="cpu")
    rows = [ln for ln in out.getvalue().splitlines() if ln and not ln.startswith("#")]
    return rows, sim.final_states


def _same_state(a, b):
    for f in ("occ", "proton_of_site", "site_of_proton", "t_last_jump", "jumps",
              "disp_base", "autocorr_ref"):
        assert torch.equal(getattr(a.replicas, f), getattr(b.replicas, f)), f
    for f in ("u_remaining", "event_count"):
        assert torch.equal(getattr(a.replicas.clock, f), getattr(b.replicas.clock, f)), f
    assert torch.equal(a.site_disp, b.site_disp) and torch.equal(a.prev_pos, b.prev_pos)
    assert int(a.replicas.clock.event_count.sum()) > 0


@pytest.fixture(scope="module")
def straight(traj):
    return run(traj)


@pytest.mark.parametrize("name,interval", [("r.npz", 1), ("r.ckpt", 0)],
                         ids=["npz-every-block", "no-suffix-end-only"])
def test_resume_is_bit_exact(traj, straight, tmp_path, name, interval):
    full, final = straight
    ckpt = tmp_path / name
    part1, _ = run(traj, sweeps=40, ckpt=ckpt, interval=interval)
    assert sorted(p.name for p in tmp_path.iterdir()) == [name]
    part2, resumed = run(traj, ckpt=ckpt, interval=interval)
    assert part1 == full[:len(part1)] and part2 == full[len(part1):]
    assert len(part2) == 4
    _same_state(resumed, final)
    with np.load(ckpt) as f:
        # the scan engine's keys of seed 1 and 16 replicas, on every route
        assert int(f["next_frame"]) == 80
        np.testing.assert_array_equal(f["keys"], threefry.key_data(threefry.split(
            threefry.fold_in(threefry.key(1), 1), 16)))


def test_rerun_of_a_finished_run_does_nothing(traj, tmp_path):
    ckpt = tmp_path / "c.npz"
    assert run(traj, sweeps=40, ckpt=ckpt)[0]
    for _ in range(2):
        rows, _ = run(traj, sweeps=40, ckpt=ckpt)
        assert rows == []
        with np.load(ckpt) as f:
            assert int(f["next_frame"]) == 40


def test_refusals(traj, tmp_path):
    """Other physics (here the seed) is refused; so is a block size whose
    blocks straddle the checkpoint frame (30 in blocks of 20)."""
    ckpt = tmp_path / "c.npz"
    run(traj, sweeps=30, ckpt=ckpt, block=10)
    with pytest.raises(ValueError, match="different physics"):
        run(traj, ckpt=ckpt, block=10, seed=2)
    with pytest.raises(ValueError, match="block_size"):
        run(traj, ckpt=ckpt, block=20)


def test_compatible_block_size_continues(traj, straight, tmp_path):
    full, final = straight
    ckpt = tmp_path / "c.npz"
    run(traj, sweeps=30, ckpt=ckpt, block=10)
    rows, resumed = run(traj, ckpt=ckpt, block=15)
    assert rows == [r for r in full if int(r.split()[0]) >= 30]
    _same_state(resumed, final)


def test_topk_neighbor_carry_survives_resume(traj, tmp_path):
    """Top-K with Verlet candidate reuse: the carry (frozen lists, drift
    reference, rebuild schedule) crosses the checkpoint, and the resumed
    run is the straight run, lists and all."""
    _carry_survives_resume(traj, tmp_path, 1)


def test_verlet_supercell_carry_survives_resume(traj, tmp_path):
    """The same as a 2x2x2 supercell (256 sites, the lists built on the
    device plan's route): the checkpoint's schedule scalars read back as
    the carry's floats, and the resumed run is the straight run."""
    mid, saved = _carry_survives_resume(traj, tmp_path, 2)
    assert [a.dtype for a in saved] == [np.float64] * 3
    assert [float(a) for a in saved] == [mid.thresh, mid.last_rebuild, mid.thrash_until]


def _carry_survives_resume(traj, tmp_path, mult):
    """Runs straight and stopped at frame 40 and resumed; returns the carry
    that crossed the checkpoint and its schedule scalars as saved."""
    topo = "max_neighbors = 8\n"
    reuse = "nbr_reuse = on\n"
    full, final = _run_topk(traj, None, topo, reuse, mult=mult)
    ckpt = tmp_path / "k.npz"
    part1, mid = _run_topk(traj, ckpt, topo, reuse, sweeps=40, mult=mult)
    assert mid.nbr_carry is not None
    with np.load(ckpt) as f:
        saved = [f[f"state.nbr_carry.{n}"] for n in ("thresh", "last_rebuild", "thrash_until")]
    part2, resumed = _run_topk(traj, ckpt, topo, reuse, mult=mult)
    assert part1 + part2 == full
    _same_state(resumed, final)
    a, b = resumed.nbr_carry, final.nbr_carry
    for f in ("ref_pos", "ref_topi", "ref_valid"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.thresh, a.last_rebuild, a.thrash_until) == (
        b.thresh, b.last_rebuild, b.thrash_until)
    return mid.nbr_carry, saved


def _run_topk(traj, ckpt, topo, reuse, sweeps=80, mult=1):
    engine = reuse + (f"checkpoint_path = {ckpt}\n" if ckpt else "")
    text = INI.format(traj=traj, sweeps=sweeps, block=20, seed=1,
                      output="ObservablesOutput", topology=topo, engine=engine)
    if mult > 1:
        text = text.replace("9.0, 9.0, 9.0", f"9.0, 9.0, 9.0\nbox_multiplier = {mult}, {mult}, {mult}")
        text = text.replace("lattice_size = 32", f"lattice_size = {32 * mult**3}")
    out = io.StringIO()
    sim = tdriver.run_from_config(io.StringIO(text), out=out, device="cpu")
    rows = [ln for ln in out.getvalue().splitlines() if ln and not ln.startswith("#")]
    return rows, sim.final_states


def _frames(rows):
    frames, i = [], 0
    while i < len(rows):
        n = int(rows[i])
        frames.append(rows[i:i + 2 + n])
        i += 2 + n
    return frames


def test_xyz_output_and_its_resume(traj, straight, tmp_path):
    """XYZOutput applies the observables run's resets, so it ends in the
    same state; its frames are well formed (each proton on a donor site);
    stopped and resumed, it prints the tail of the straight run."""
    _, final = straight
    rows, xyz_final = run(traj, output="XYZOutput")
    _same_state(xyz_final, final)
    frames = _frames(rows)
    assert [f[1] for f in frames] == [f"frame {i}" for i in range(0, 80, 10)]
    for f in frames:
        assert int(f[0]) == 44 and len(f) == 46
        pos = np.array([[float(x) for x in ln.split()[1:]] for ln in f[2:]])
        assert [ln.split()[0] for ln in f[2:]] == ["O"] * 32 + ["H"] * 12
        d = np.linalg.norm(pos[32:, None] - pos[None, :32], axis=-1).min(axis=1)
        assert np.all(d == 0)
    ckpt = tmp_path / "x.npz"
    part1, _ = run(traj, sweeps=40, ckpt=ckpt, output="XYZOutput", interval=1)
    part2, resumed = run(traj, ckpt=ckpt, output="XYZOutput", interval=1)
    assert part1 + part2 == rows
    _same_state(resumed, final)


def test_format_xyz_matches_jax(traj):
    """The same positions and sites give the JAX driver's text, with and
    without ``periodic_wrap``, in a cube and in a monoclinic cell."""
    rng = np.random.RandomState(2)
    pos = rng.uniform(-12, 21, size=(32, 3)).astype(np.float32)
    sites = rng.permutation(32)[:12].astype(np.int32)
    base = INI.format(traj=traj, sweeps=80, block=20, seed=1,
                      output="XYZOutput", topology="", engine="")
    mono = base.replace("type = AtomBoxCubic\nperiodic_boundaries = 9.0, 9.0, 9.0",
                        "type = AtomBoxMonoclinic\n"
                        "periodic_boundaries = 12.0, 0, 0, 1.5, 12.0, 0, 0, 0, 12.0")
    for text in (base, mono):
        for wrap in ("", "periodic_wrap = True\n"):
            t = text.replace("print_frequency = 10\n", "print_frequency = 10\n" + wrap)
            jsim = jdriver.Simulation(j_load_config(io.StringIO(t)))
            tsim = tdriver.Simulation(t_load_config(io.StringIO(t)), device="cpu")
            assert tsim._format_xyz(pos, sites, 30) == jsim._format_xyz(pos, sites, 30)


def test_config_fingerprint_matches_jax():
    paths = sorted(glob.glob(os.path.join(REPO, "examples", "*.ini")))
    assert len(paths) >= 3
    for path in paths:
        tcfg, jcfg = t_load_config(path), j_load_config(path)
        assert tdriver.config_fingerprint(tcfg) == jdriver.config_fingerprint(jcfg), path
        bumped = dataclasses.replace(tcfg, engine=dataclasses.replace(
            tcfg.engine, seed=tcfg.engine.seed + 1))
        assert tdriver.config_fingerprint(bumped) != tdriver.config_fingerprint(tcfg)
