"""The port's jump statistics end to end against the JAX package on the CPU:
the mdmc driver with ``[Output] jumpstat_bins`` / ``jumpstat_range`` and
``[Engine] jumpmatrix_filename`` on the first slice's cubic INI (N=32, 12
protons, 16 replicas in RNG tiles of 4: both packages take their in-kernel
routes, the port K3's plain version), the same with a monoclinic cell (both
take the streamed route, the port K1's plain version with the triclinic
minimum image), and the ``jumpstat`` CLI. The port starts from the JAX
package's own initial state (``convert.ensemble_from_numpy``). Rows as in
test_torch_slice.py (Autocorr and Jumps to 1e-5, MSD to rtol 1e-4); the
jumpstat lines equal as text; the saved matrices equal; the CLI's Fermi fit
to rtol 1e-4 (the fit runs on equal counts; scipy's optimizer is the only
difference). Also: an import of the new CLI leaves jax out of sys.modules."""

import contextlib
import io
import os
import subprocess
import sys

import jax
import numpy as np
import torch

from cmdlmc_tpu import driver as jdriver
from cmdlmc_tpu.cli import jumpstat as jjumpstat
from cmdlmc_tpu.config.schema import load_config as j_load_config
from cmdlmc_tpu.engine import lattice as jeng
from cmdlmc_tpu_torch import convert, driver as tdriver
from cmdlmc_tpu_torch.cli import jumpstat as tjumpstat
from cmdlmc_tpu_torch.config.schema import load_config as t_load_config
from cmdlmc_tpu_torch.engine import lattice as teng

from test_torch_slice import (  # noqa: F401  (the fixture runs by itself)
    INI, _recording, _rows_match, _write_slice_traj, jax_kernels_run_to_end,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS_INI = INI.replace(
    "reset_frequency = 20\n",
    "reset_frequency = 20\njumpstat_bins = 6\njumpstat_range = 2.2, 3.2\n",
).replace("backend = fused\n", "backend = fused\njumpmatrix_filename = {jm}\n")
# examples/triclinic.ini's cell shape, scaled to the slice's 9 A sites
MONO_INI = STATS_INI.replace(
    "type = AtomBoxCubic\nperiodic_boundaries = 9.0, 9.0, 9.0",
    "type = AtomBoxMonoclinic\nperiodic_boundaries = 9,0,0, 1.875,8.625,0, 0,0,9",
).replace("buffer = 2.0", "buffer = 1.0")


def _jax_init(cfg, hist_bins, track):
    """The JAX driver's own initial state (driver.py: init_replicas)."""
    names, pos, _ = next(jdriver.build_trajectory(cfg).iter_batches())
    first = pos[0][names == "O"]
    key = jax.random.key(cfg.engine.seed)
    return jeng.init_replicas(jax.random.fold_in(key, 0), cfg.engine.replicas,
                              first.shape[0], cfg.kmc.proton_number, first,
                              hist_bins=hist_bins, track_jump_matrix=track)


def _both(tmp, ini_text):
    """Run the INI through the JAX driver and through the port's on the CPU,
    the port from the JAX driver's initial state; each saves its matrix."""
    out = {}
    for side in ("jax", "port"):
        ini = tmp / f"{side}.ini"
        ini.write_text(ini_text.format(traj=_write_slice_traj(tmp),
                                       jm=tmp / f"{side}_jm.npy"))
        buf = io.StringIO()
        if side == "jax":
            sim = _recording(jdriver.Simulation)(j_load_config(str(ini)))
            jcfg = sim.cfg
        else:
            init = convert.ensemble_from_numpy(_jax_init(jcfg, 6, True))
            sim = _recording(tdriver.Simulation)(t_load_config(str(ini)),
                                                 device="cpu", initial_state=init)
        sim.run(out=buf)
        if side == "port":  # the run counted into its own copy of the matrix
            assert int(init.replicas.jump_matrix.abs().sum()) == 0
        out[side] = (sim, buf.getvalue(), np.load(tmp / f"{side}_jm.npy"))
    return out


def _rows_text(text):
    """The output with its jumpstat block (7 comment lines and a row per bin) cut out."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("# jumpstat over"))
    return "\n".join(lines[:start] + lines[start + 7 + 6:])


def _jumpstat_block(text):
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("# jumpstat over"))
    return lines[start:start + 7 + 6]


def _statistics_match(out):
    (jsim, jtext, jjm), (tsim, ttext, tjm) = out["jax"], out["port"]
    # the observable rows: the text before the jumpstat block
    _rows_match((jsim, _rows_text(jtext), tsim, _rows_text(ttext)), [0, 10, 20])
    assert _jumpstat_block(ttext) == _jumpstat_block(jtext)
    np.testing.assert_array_equal(tjm, jjm)
    assert tjm.dtype == jjm.dtype
    trep = tsim.final_states.replicas
    events = int(trep.clock.event_count.sum())
    assert int(tjm.sum()) == events > 0  # the matrix counts every jump
    np.testing.assert_array_equal(trep.jump_hist.numpy(),
                                  np.asarray(jsim.final_states.replicas.jump_hist))
    np.testing.assert_array_equal(
        trep.opportunity_hist.numpy(),
        np.asarray(jsim.final_states.replicas.opportunity_hist))
    assert int(trep.jump_hist.sum()) > 0 and float(trep.opportunity_hist.sum()) > 0
    assert "# jump matrix saved to" in ttext


def test_driver_jumpstat_matches_jax(tmp_path):
    _statistics_match(_both(tmp_path, STATS_INI))


def test_driver_monoclinic_matches_jax(tmp_path):
    out = _both(tmp_path, MONO_INI)
    assert not out["port"][0].cell.orthorhombic
    _statistics_match(out)


def _cli_lines(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


def test_jumpstat_cli_matches_jax(tmp_path, monkeypatch):
    """Both CLIs on the cubic INI (no jumpstat keys: the CLI turns the
    histograms on) with --bins 6 --range 2.2 3.2 --fit; the port's from the
    JAX package's initial state."""
    ini = tmp_path / "cli.ini"
    ini.write_text(INI.format(traj=_write_slice_traj(tmp_path)))
    argv = [str(ini), "--bins", "6", "--range", "2.2", "3.2", "--fit"]
    jlines = _cli_lines(jjumpstat.main, argv)
    init = convert.ensemble_from_numpy(_jax_init(j_load_config(str(ini)), 6, False))
    monkeypatch.setattr(teng, "init_replicas", lambda *a, **k: init)
    tlines = _cli_lines(tjumpstat.main, [*argv, "--device", "cpu"])
    fit = [i for i, ln in enumerate(jlines) if ln.startswith("# Fermi fit")]
    assert fit and len(tlines) == len(jlines)
    assert tlines[:fit[0] + 1] == jlines[:fit[0] + 1]
    assert "jumps" in tlines[6] and sum(int(ln.split()[1]) for ln in tlines[7:13]) > 0
    for tl, jl in zip(tlines[fit[0] + 1:], jlines[fit[0] + 1:]):
        t, j = tl.split(), jl.split()
        assert t[:3] == j[:3]  # "#", name, "="
        np.testing.assert_allclose(float(t[3]), float(j[3]), rtol=1e-4)


def test_jumpstat_cli_imports_no_jax():
    code = ("import sys, cmdlmc_tpu_torch.cli.jumpstat\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'cmdlmc_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_unsupported_reason_takes_the_statistics(tmp_path):
    """The driver no longer refuses jumpstat_bins or jumpmatrix_filename,
    and the fused gate lets a monoclinic cell under the skew bound through
    (and refuses one past it)."""
    from cmdlmc_tpu_torch.engine import fused

    ini = tmp_path / "s.ini"
    ini.write_text(MONO_INI.format(traj=_write_slice_traj(tmp_path),
                                   jm=tmp_path / "m.npy"))
    cfg = t_load_config(str(ini))
    assert tdriver.unsupported_reason(cfg) is None
    sim = tdriver.Simulation(cfg, device="cpu")
    assert sim.hist_bins == 6 and sim.track_jump_matrix
    assert fused.fused_unsupported_reason(sim.model, sim.cell) is None
    skewed = tdriver.build_model(
        cfg, tdriver.build_cell(cfg), sim.law).__class__(
        sim.cell, sim.law, 3.0, 1.5)  # cutoff + buffer 4.5 >= half of 8.625
    assert "skewed" in fused.fused_unsupported_reason(skewed, sim.cell)
