"""The port's ``kmc_water`` slice against the JAX package on the CPU.

* The per-frame site: the JAX package's fused path in interpret mode, run
  one frame per block (B4 keys its draws by the absolute frame, so that run
  passes through every frame's state), gives replica 0's site after each
  frame; the port's plain version of K7 returns the same sites as its site
  trace over blocks of 8 frames.
* The slice: ``cli/kmc_water.py::kmc_water_main`` on the CPU from the JAX
  package's ``init_water_states`` prints, at each print frame, replica 0's
  site after that frame, and the block-end jumps and correction, as the JAX
  CLI's scan branch does (rows equal but the fps column).
* The two keyword loaders, the device refusal, the models the water kernel
  refuses running on the scan engine, the acceptance of more sites than an
  earlier K7 could take, and no jax import.

The cases come from ``test_torch_water.py``.
"""

import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu.config import keyword as jkw
from cmdlmc_tpu.models import water as jwm
from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch.cli import kmc_water as tcli
from cmdlmc_tpu_torch.config import keyword as tkw
from cmdlmc_tpu_torch.models import water as twm
from cmdlmc_tpu_torch.ops import water_sweep as ws
from test_torch_water import BOX, DT, N, R, REPO, SEED, TR, _frames, _jax_model
from test_torch_slice import jax_kernels_run_to_end  # noqa: F401  (runs by itself)

torch.set_num_threads(1)

FRAMES, CHUNK = 16, 8


def _write_water_inputs(tmp_path, frames=FRAMES, chunk=CHUNK):
    _, pos = _frames(n_frames=frames, seed=9)
    from cmdlmc_tpu_torch.io.xyz import write_xyz_frame

    traj = tmp_path / "water.xyz"
    with open(traj, "w") as f:
        for fr in pos:
            write_xyz_frame(f, ["O"] * N, fr)
    cfg = tmp_path / "water.cfg"
    cfg.write_text(f"""filename {traj}
pbc {BOX} {BOX} {BOX}
md_timestep_fs {DT}
sweeps {frames}
print_frequency 5
chunk_size {chunk}
jumprate_params_fs a=0.3 b=2.3 c=0.1
rescale_function linear
rescale_parameters a=0.5 b=1.2 left_bound=0 right_bound=10
relaxation_time 10
d_oh 0.3
keep_last_neighbor_rescaled True
seed {SEED}
replicas {R}
""")
    return cfg, pos


def _rows(text):
    return [ln.split()[:-1] for ln in text.splitlines() if ln and not ln.startswith("#")]


@pytest.fixture(scope="module")
def jax_frame_by_frame(tmp_path_factory):
    """The slice's inputs and the JAX package's fused path (interpret mode,
    rows layout) over its FRAMES frames, as parsed back from the xyz file
    the CLI reads, from the JAX package's initial states, one frame per
    block: every replica's site after each frame [FRAMES, R] and the states
    at the end of each of the CLI's CHUNK-frame blocks (B4 keys its draws by
    the absolute frame, so the integer state is that of CHUNK-frame blocks;
    its floats, the d_OH correction among them, can differ by an ulp: XLA
    contracts its arithmetic per program)."""
    from cmdlmc_tpu_torch.io.xyz import XYZTrajectory

    cfg, _ = _write_water_inputs(tmp_path_factory.mktemp("slice"))
    settings = tkw.load_configfile(str(cfg), config_name="KMCWater")
    pos = np.concatenate([p for _, p, _ in XYZTrajectory(
        settings.filename, time_step=DT, batch_frames=FRAMES).iter_batches()])
    jm = _jax_model("linear_check_old")
    init = jwm.init_water_states(jax.random.fold_in(jax.random.key(SEED), 0), R, N,
                                 jnp.asarray(pos[0]))
    kw = dict(dt=DT, seed=SEED, tile=TR, interpret=True, layout="rows",
              return_truncation=True)

    states, sd, prev = init, jnp.zeros((N, 3), jnp.float32), jnp.asarray(pos[0])
    sites, block_end = [], []
    for f in range(FRAMES):
        states, sd, prev, _ = jwm.run_water_block_fused(
            jm, states, jnp.asarray(pos[f:f + 1]), f, site_disp=sd, prev_pos=prev,
            **kw)
        sites.append(np.asarray(states.site))
        if (f + 1) % CHUNK == 0:
            block_end.append(states)
    return settings, pos, init, np.stack(sites), block_end


def test_site_trace_matches_jax(jax_frame_by_frame):
    """K7's plain version, through run_water_block_fused in blocks of CHUNK
    frames from the same states, returns replica 0's site after each frame
    as the JAX fused path run one frame per block has it; the block-end
    states agree too."""
    _, pos, init, sites, block_end = jax_frame_by_frame
    tm = convert.water_model_from_fields(_jax_model("linear_check_old"))
    states = convert.water_states_from_fields(init)
    sd, prev = torch.zeros((N, 3)), torch.from_numpy(pos[0])
    trace = []
    for b0 in range(0, FRAMES, CHUNK):
        states, sd, prev, _, site_trace = twm.run_water_block_fused(
            tm, states, torch.from_numpy(pos[b0:b0 + CHUNK]), b0, site_disp=sd,
            prev_pos=prev, dt=DT, seed=SEED, tile=TR)
        assert site_trace.dtype == torch.int32 and site_trace.shape == (CHUNK,)
        assert int(site_trace[-1]) == int(states.site[0])
        np.testing.assert_array_equal(states.site.numpy(),
                                      np.asarray(block_end[b0 // CHUNK].site))
        trace.append(site_trace.numpy())
    np.testing.assert_array_equal(np.concatenate(trace), sites[:, 0])
    # the trace moves within a block: the block-end site alone would not do
    assert any(len(set(sites[b0:b0 + CHUNK, 0].tolist())) > 1
               for b0 in range(0, FRAMES, CHUNK))


def test_slice_matches_jax(jax_frame_by_frame):
    """kmc_water_main on the CPU from the JAX package's initial states
    against rows built from the JAX package's fused path in interpret mode:
    at every print frame replica 0's site after that frame (the fused path
    run one frame per block), and the jumps and correction of replica 0 at
    the end of the CLI's block (the JAX CLI's scan-branch rule), its
    position the frame's O plus that correction. Two blocks of CHUNK
    frames."""
    settings, pos, init, sites, block_end = jax_frame_by_frame
    jm = _jax_model("linear_check_old")
    assert float(jm.d_oh) == float(np.float32(settings.d_oh))
    want = []
    for b0 in range(0, FRAMES, CHUNK):
        states = block_end[b0 // CHUNK]
        jumps0 = int(states.jumps[0])
        corr0 = np.asarray(states.correction)[0]
        for i in range(CHUNK):
            step = b0 + i
            if step % 5 == 0:
                site0 = int(sites[step, 0])
                p = pos[step, site0] + corr0
                want.append("{:18d} {:18.2f} {:15.8f} {:15.8f} {:15.8f} {:10d} {:10d}"
                            .format(step, step * DT, p[0], p[1], p[2], site0, jumps0).split())
    buf = io.StringIO()
    final = tcli.kmc_water_main(settings, out=buf, device="cpu",
                                initial_states=convert.water_states_from_fields(init),
                                tile=TR)
    text = buf.getvalue()
    assert "# kmc_water" not in text and "O-Neighbor" in text
    got = _rows(text)
    assert len(got) == len(want) == 4
    # step, time, site and jumps as printed; the position carries the d_OH
    # correction, whose floats the two packages round an ulp apart (XLA's
    # approximate rsqrt), so it agrees to 1e-6 A where the sweep's floats
    # agree to 1e-5
    assert [r[:2] + r[5:] for r in got] == [r[:2] + r[5:] for r in want]
    np.testing.assert_allclose(np.array([r[2:5] for r in got], np.float64),
                               np.array([r[2:5] for r in want], np.float64),
                               rtol=0, atol=1e-6)
    states = block_end[-1]
    assert int(final.clock.event_count.sum()) == int(np.asarray(states.clock.event_count).sum())
    np.testing.assert_allclose(final.displacement.numpy(), np.asarray(states.displacement),
                               rtol=1e-5, atol=1e-5)


def test_keyword_loaders_agree(tmp_path):
    """The port's copy of the keyword loader returns the JAX package's
    settings on examples/water.cfg and on the KMCWater template."""
    tmpl = io.StringIO()
    jkw.print_config_template("KMCWater", out=tmpl)
    path = tmp_path / "template.cfg"
    path.write_text(tmpl.getvalue().replace("# REQUIRED", "1"))
    for src in (os.path.join(REPO, "examples", "water.cfg"), str(path)):
        a = vars(jkw.load_configfile(src, config_name="KMCWater"))
        b = vars(tkw.load_configfile(src, config_name="KMCWater"))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_equal(b[k], a[k], err_msg=k)
    t_help, j_help = io.StringIO(), io.StringIO()
    tkw.print_confighelp("KMCWater", out=t_help)
    jkw.print_confighelp("KMCWater", out=j_help)
    assert t_help.getvalue() == j_help.getvalue()


def test_cli_refusals(tmp_path, capsys):
    cfg, _ = _write_water_inputs(tmp_path, frames=4, chunk=4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tcli.main(["load", str(cfg)])
    tcli.main(["config_file"])
    assert "relaxation_time" in capsys.readouterr().out
    base = cfg.read_text()
    bad = {
        "triclinic": base.replace(f"pbc {BOX} {BOX} {BOX}",
                                  f"pbc {BOX} 0 0 1 {BOX} 0 0 0 {BOX}"),
        "n_atoms": base + "n_atoms 5\n",
        "interp": base + f"conversion_data {tmp_path / 'big.txt'}\n",
    }
    x = np.linspace(1.0, 4.0, ws.MAX_INTERP_POINTS + 1)
    np.savetxt(tmp_path / "big.txt", np.stack([x, x], axis=1))
    # the models the water kernel refuses run on the scan engine
    for name, text in bad.items():
        path = tmp_path / f"{name}.cfg"
        path.write_text(text)
        settings = tkw.load_configfile(str(path), config_name="KMCWater")
        assert twm.water_unsupported_reason(tcli.build_model(settings, "cpu"))
        out = io.StringIO()
        tcli.kmc_water_main(settings, out=out, device="cpu")
        assert len(_rows(out.getvalue())) == 1, name
    assert not twm.water_fused_supported(tcli.build_model(
        tkw.load_configfile(str(tmp_path / "n_atoms.cfg"), config_name="KMCWater"), "cpu"))


def test_accepts_more_sites_than_the_earlier_kernel(tmp_path, monkeypatch):
    """The model and the CLI take more than 19,370 sites, the limit of an
    earlier K7 whose site prefix sum (12 bytes a site) had to fit in a
    block's shared memory: water_unsupported_reason has no site count, and
    the CLI hands a one-frame trajectory of 19,371 oxygens to the water
    tables (stopped there, so K5's plain version never runs at that N on
    the CPU; ``chip_smoke.py`` runs the CLI past it on the card)."""
    earlier_limit = 232448 // 12
    assert earlier_limit == 19370
    cfg, _ = _write_water_inputs(tmp_path, frames=1, chunk=1)
    settings = tkw.load_configfile(str(cfg), config_name="KMCWater")
    assert twm.water_unsupported_reason(tcli.build_model(settings, "cpu")) is None
    n = earlier_limit + 1
    side = int(np.ceil(n ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    traj = tmp_path / "big.xyz"
    traj.write_text(f"{n}\nframe 0\n" + "".join(
        f"O {x * 2.9:.3f} {y * 2.9:.3f} {z * 2.9:.3f}\n" for x, y, z in grid[:n]))
    big = cfg.read_text().replace(str(tmp_path / "water.xyz"), str(traj)).replace(
        f"pbc {BOX} {BOX} {BOX}", f"pbc {side * 2.9} {side * 2.9} {side * 2.9}")
    (tmp_path / "big.cfg").write_text(big)
    settings = tkw.load_configfile(str(tmp_path / "big.cfg"), config_name="KMCWater")
    assert twm.water_unsupported_reason(tcli.build_model(settings, "cpu")) is None

    class Reached(Exception):
        pass

    shapes = []

    def tables(positions, *args):
        shapes.append(tuple(positions.shape))
        raise Reached

    monkeypatch.setattr(ws, "water_tables", tables)
    with pytest.raises(Reached):
        tcli.kmc_water_main(settings, out=io.StringIO(), device="cpu")
    assert shapes == [(1, n, 3)]


def test_water_modules_import_no_jax():
    code = (
        "import sys, cmdlmc_tpu_torch.cli.kmc_water, cmdlmc_tpu_torch.models.water, "
        "cmdlmc_tpu_torch.ops.water_sweep, cmdlmc_tpu_torch.config.keyword, "
        "cmdlmc_tpu_torch.convert\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'cmdlmc_tpu'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env={**os.environ, "PYTHONPATH": REPO})
