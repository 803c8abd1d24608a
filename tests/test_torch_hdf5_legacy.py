"""What ``mdmc`` reads and writes besides xyz, in the port, against the JAX
package on the host: ``trajconv`` files with the JAX package's datasets bit
for bit, ``HDF5Trajectory`` batches under stride, clip, repeat and shuffle,
``trajzip``'s output, the legacy keyword config's ``SimulationConfig``; and
the port's own runs on the CPU: an HDF5 run prints the rows of the xyz run
of the same frames, ``kmc_water`` reads ``.h5``, ``mdmc --legacy`` and
``mdmc --profile DIR`` run, and the port imports where h5py does not. Every
file a conversion writes lies under the test's own temporary directory. No
JAX kernel runs here."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from cmdlmc_tpu.cli import trajzip as jzip
from cmdlmc_tpu.config.legacy import load_legacy_config as j_legacy
from cmdlmc_tpu.io.converters import save_xyz_to_hdf5 as j_convert
from cmdlmc_tpu.io.hdf5 import HDF5Trajectory as JHDF5
from cmdlmc_tpu_torch import driver as tdriver
from cmdlmc_tpu_torch.cli import kmc_water, mdmc, trajconv
from cmdlmc_tpu_torch.cli import trajzip as tzip
from cmdlmc_tpu_torch.config.keyword import load_configfile
from cmdlmc_tpu_torch.config.legacy import load_legacy_config as t_legacy
from cmdlmc_tpu_torch.io.converters import save_xyz_to_hdf5 as t_convert
from cmdlmc_tpu_torch.io.hdf5 import HDF5Trajectory as THDF5
from cmdlmc_tpu_torch.io.xyz import write_xyz_frame

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_xyz(path, n_o=10, n_p=2, frames=30, seed=0, box=10.0):
    rng = np.random.RandomState(seed)
    base = rng.uniform(0, box, size=(n_o + n_p, 3))
    names = ["O"] * n_o + ["P"] * n_p
    with open(path, "w") as f:
        for _ in range(frames):
            write_xyz_frame(f, names, base + rng.normal(scale=0.03, size=base.shape))
    return path


def _datasets(path):
    with h5py.File(path, "r") as f:
        return {k: (f[k][:], f[k].dtype, f[k].chunks, f[k].compression) for k in f}


def test_trajconv_matches_jax(tmp_path, capsys):
    xyz = _write_xyz(tmp_path / "t.xyz")
    for kwargs in ({}, {"compression": "none"}, {"selection": "O"},
                   {"remove_com_movement": True, "compression": "gzip"}):
        tag = "_".join(f"{k}{v}" for k, v in kwargs.items())
        want = _datasets(j_convert(str(xyz), str(tmp_path / f"j{tag}.h5"), **kwargs))
        got = _datasets(t_convert(str(xyz), str(tmp_path / f"t{tag}.h5"), **kwargs))
        assert got.keys() == want.keys() == {"trajectory", "atom_names"}
        for k in want:
            assert got[k][1:] == want[k][1:], (kwargs, k)
            np.testing.assert_array_equal(got[k][0], want[k][0])
    trajconv.main([str(xyz)])
    assert capsys.readouterr().out.strip() == str(tmp_path / "t.hdf5")
    np.testing.assert_array_equal(_datasets(tmp_path / "t.hdf5")["trajectory"][0],
                                  _datasets(tmp_path / "j.h5")["trajectory"][0])


def test_iter_batches_match_jax(tmp_path):
    xyz = _write_xyz(tmp_path / "t.xyz", frames=23)
    h5 = j_convert(str(xyz), str(tmp_path / "t.h5"))
    for kwargs, take in (({}, None), ({"stride": 3}, None), ({"clip": 7}, None),
                         ({"stride": 2, "clip": 9, "repeat": True}, 5),
                         ({"shuffle_seed": 4}, 3), ({"selection": "P"}, None),
                         ({"selection": ("O", "P"), "stride": 4}, None)):
        j = JHDF5(h5, time_step=0.5, chunk_size=4, **kwargs)
        t = THDF5(h5, time_step=0.5, chunk_size=4, **kwargs)
        assert len(t) == len(j) and t.effective_time_step == j.effective_time_step
        jb, tb = j.iter_batches(), t.iter_batches()
        n = 0
        for (tn, tp, ts), (jn, jp, js) in zip(tb, jb):
            np.testing.assert_array_equal(tn, jn)
            np.testing.assert_array_equal(tp.view(np.uint32), jp.view(np.uint32))
            assert tp.dtype == np.float32 and ts == js, kwargs
            n += 1
            if take is not None and n == take:
                break
        assert n > 0
        if take is None:  # both ran out together
            assert next(tb, None) is None and next(jb, None) is None


INI = """[Trajectory]
type = {ttype}
filename = {traj}
time_step = 0.5
[AtomBox]
type = AtomBoxCubic
periodic_boundaries = 10.0, 10.0, 10.0
[NeighborTopology]
type = NeighborTopology
donor_atoms = O
cutoff = 3.0
buffer = 2.0
[JumpRate]
type = Fermi
a = 0.3
b = 2.3
c = 0.1
[KMCLattice]
lattice_size = 10
proton_number = 4
time_step = 0.5
[Output]
type = ObservablesOutput
print_frequency = 5
[Engine]
replicas = 16
tile = 4
seed = 3
block_size = 10
"""


def _rows(text):
    return [ln for ln in text.splitlines() if ln and not ln.startswith("#")]


def test_hdf5_run_prints_the_xyz_rows(tmp_path):
    xyz = _write_xyz(tmp_path / "t.xyz")
    h5 = t_convert(str(xyz), str(tmp_path / "t.h5"))
    out = {}
    for ttype, traj in (("XYZTrajectory", xyz), ("HDF5Trajectory", h5)):
        buf = io.StringIO()
        sim = tdriver.run_from_config(
            io.StringIO(INI.format(ttype=ttype, traj=traj)), out=buf, device="cpu")
        out[ttype] = (_rows(buf.getvalue()), sim.final_states.replicas)
    (xrows, xrep), (hrows, hrep) = out["XYZTrajectory"], out["HDF5Trajectory"]
    assert len(xrows) == 6 and hrows == xrows
    assert torch.equal(hrep.site_of_proton, xrep.site_of_proton)
    assert torch.equal(hrep.clock.u_remaining, xrep.clock.u_remaining)
    assert int(hrep.clock.event_count.sum()) > 0
    # shuffle mode: random frames of the HDF5 file, bounded by sweeps
    text = INI.format(ttype="HDF5Trajectory", traj=h5).replace(
        "time_step = 0.5\n[AtomBox]", "time_step = 0.5\nshuffle_seed = 2\n[AtomBox]", 1)
    buf = io.StringIO()
    tdriver.run_from_config(io.StringIO(text + "sweeps = 20\n"), out=buf, device="cpu")
    assert len(_rows(buf.getvalue())) == 4


WATER = """filename {traj}
pbc 10 10 10
md_timestep_fs 0.5
sweeps 12
print_frequency 3
chunk_size 6
jumprate_params_fs a=0.3 b=2.3 c=0.1
rescale_function linear
rescale_parameters a=0.5 b=1.2 left_bound=0 right_bound=10
seed 5
replicas 8
"""


def test_kmc_water_reads_h5(tmp_path):
    xyz = _write_xyz(tmp_path / "w.xyz", n_o=16, n_p=0, frames=12)
    h5 = t_convert(str(xyz), str(tmp_path / "w.h5"))
    rows = {}
    for traj in (xyz, h5):
        cfg = tmp_path / f"{os.path.basename(traj)}.cfg"
        cfg.write_text(WATER.format(traj=traj))
        buf = io.StringIO()
        kmc_water.kmc_water_main(load_configfile(str(cfg), config_name="KMCWater"),
                                 out=buf, device="cpu")
        rows[traj] = [ln.split()[:-1] for ln in _rows(buf.getvalue())]
    assert len(rows[xyz]) == 4 and rows[h5] == rows[xyz]


LEGACY = """filename {fname}
pbc 10 10 10
md_timestep_fs 0.5
sweeps 60
equilibration_sweeps 20
print_frequency 10
reset_freq 0
proton_number 4
lattice_size 10
donor_atoms O
jumprate_type MD_rates
jumprate_params_fs a=0.1 b=2.5 c=0.3
cutoff_radius 3.0
neighbor_search_radius 5.0
seed 3
replicas 4
"""


def test_legacy_config_matches_jax(tmp_path):
    """``load_legacy_config`` gives the JAX package's SimulationConfig on
    ``examples/legacy_cmdlmc.cfg`` and the cases of
    tests/integration/test_legacy_config.py and test_legacy_keys.py (the
    HDF5 conversion of a tmp copy, once, by the port)."""
    xyz = _write_xyz(tmp_path / "legacy.xyz", n_p=0, frames=60)
    example = open(os.path.join(REPO, "examples", "legacy_cmdlmc.cfg")).read()
    base = LEGACY.format(fname=xyz)
    cases = [
        example.replace("filename examples/demo.xyz", f"filename {xyz}"),
        base,
        base.replace("jumprate_type MD_rates", "jumprate_type AE_rates").replace(
            "a=0.1 b=2.5 c=0.3", "A=0.1 a=0.2 b=0.3 d0=2.2 T=300"),
        base.replace("jumprate_type MD_rates", "jumprate_type Exponential_rates").replace(
            "a=0.1 b=2.5 c=0.3", "a=0.1 b=2.5"),
        base + "angle_threshold 1.2\no_neighbor P\n",
        base + "skip_frames 1\nclip_trajectory 30\nvariance_per_proton True\n"
               "higher_msd True\nneighbor_list True\nxyz_output True\n"
               "periodic_wrap True\n",
        base.replace(f"filename {xyz}", f"auxiliary_file {xyz}"),
        base + "hdf5 True\n",
        base + "shuffle True\n",
    ]
    for text in cases:
        got = t_legacy(io.StringIO(text))
        assert repr(got) == repr(j_legacy(io.StringIO(text))), text
    assert got.trajectory.type_ == "HDF5Trajectory"
    assert sorted(os.listdir(tmp_path)) == ["legacy.hdf5", "legacy.xyz"]
    with pytest.raises(ValueError):
        t_legacy(io.StringIO(base.replace(f"filename {xyz}\n", "")))


def test_mdmc_legacy_runs(tmp_path, capsys):
    xyz = _write_xyz(tmp_path / "legacy.xyz", n_p=0, frames=60)
    cfg = tmp_path / "legacy.cfg"
    cfg.write_text(LEGACY.format(fname=xyz))
    mdmc.main([str(cfg), "--legacy", "--device", "cpu"])
    rows = [r.split() for r in _rows(capsys.readouterr().out)]
    assert [int(r[0]) for r in rows] == [20, 30, 40, 50]
    assert all(np.isfinite(np.array(rows, dtype=float)).ravel())


def test_mdmc_profile_writes_a_trace(tmp_path, capsys):
    xyz = _write_xyz(tmp_path / "t.xyz", frames=10)
    ini = tmp_path / "p.ini"
    ini.write_text(INI.format(ttype="XYZTrajectory", traj=xyz))
    mdmc.main([str(ini), "--device", "cpu", "--profile", str(tmp_path / "prof")])
    assert len(_rows(capsys.readouterr().out)) == 2
    with open(tmp_path / "prof" / "mdmc_trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_trajzip_matches_jax(tmp_path):
    a = _write_xyz(tmp_path / "a.xyz", frames=5, seed=1)
    b = _write_xyz(tmp_path / "b.xyz", n_o=3, n_p=1, frames=4, seed=2)
    outs = []
    for merge in (jzip.merge, tzip.merge):
        buf = io.StringIO()
        with open(a) as fa, open(b) as fb:
            merge(fa, fb, buf)
        outs.append(buf.getvalue())
    assert outs[1] == outs[0] and outs[0].count("\n16\n\n") == 3
    shutil.copy(a, tmp_path / "c.xyz")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tzip.main([str(a), str(tmp_path / "c.xyz")])
    assert buf.getvalue().startswith("24\n\n")


def test_port_imports_without_h5py(tmp_path):
    """With h5py made unimportable the port's driver and CLIs import (and
    no JAX); only an HDF5 trajectory fails, naming h5py."""
    h5 = t_convert(str(_write_xyz(tmp_path / "t.xyz", frames=3)), str(tmp_path / "t.h5"))
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "import cmdlmc_tpu_torch.driver, cmdlmc_tpu_torch.cli.mdmc, "
        "cmdlmc_tpu_torch.cli.kmc_water, cmdlmc_tpu_torch.cli.trajconv, "
        "cmdlmc_tpu_torch.cli.trajzip, cmdlmc_tpu_torch.config.legacy, "
        "cmdlmc_tpu_torch.io.converters, cmdlmc_tpu_torch.utils.checkpoint, "
        "cmdlmc_tpu_torch.native\n"
        "from cmdlmc_tpu_torch.io.hdf5 import HDF5Trajectory\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'cmdlmc_tpu'))\n"
        "assert not bad, bad\n"
        f"try:\n    HDF5Trajectory({str(h5)!r}, time_step=0.5)\n"
        "except ImportError as e:\n    print(e)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "h5py" in out.stdout
