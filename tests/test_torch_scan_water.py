"""The water scan engine (``models/water.py::run_water_block``) and the
``kmc_water`` CLI's scan branch against the JAX package's on the CPU.

* ``run_water_block`` from the JAX package's initial states and keys
  (carried over by ``convert``) over 16 frames at N = 28, R = 32, for models
  the water kernel refuses: ``n_atoms = 5`` (keep_last with check_from_old,
  relaxation, a waiting time), a triclinic cell (check_from_old, a linear
  transform) and, with the 4-neighbour slot promotion, a 1500-point
  interpolation table. Integer state (site, last site, counters, jumps,
  event counts) and the per-frame sites exact; floats within 1e-5 (XLA and
  torch round the d_OH correction's arithmetic and ``log`` an ulp apart).
* ``kmc_water_main`` on a 1500-point table (above the kernel's 1024): its
  rows against the JAX CLI's, which runs its scan branch on the CPU, from
  the JAX package's initial states carried across (step, time, site and
  jumps as printed; the position within 1e-6 A).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu.cli import kmc_water as jcli
from cmdlmc_tpu.config import keyword as jkw
from cmdlmc_tpu.core.cell import Cell as JCell
from cmdlmc_tpu.io.xyz import XYZTrajectory as JXYZ, write_xyz_frame
from cmdlmc_tpu.models import water as jwm
from cmdlmc_tpu.rates.laws import Fermi as JFermi
from cmdlmc_tpu.topo import transforms as jtr
from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch.cli import kmc_water as tcli
from cmdlmc_tpu_torch.config import keyword as tkw
from cmdlmc_tpu_torch.models import water as twm

torch.set_num_threads(1)

N, R, B, DT, SEED, BOX = 28, 32, 16, 0.5, 3, 7.0
TABLE_POINTS = 1500
TOL = dict(rtol=1e-5, atol=1e-5)


def _f(x):
    return jnp.float32(x)


def _table():
    x = np.linspace(1.0, 4.0, TABLE_POINTS)
    return x, 0.8 * x + 0.5 + 0.05 * np.sin(7.0 * x)


def _model(case):
    law = JFermi(a=_f(0.3), b=_f(2.3), c=_f(0.1))
    linear = jtr.LinearTransformation(a=_f(0.5), b=_f(1.2), left_bound=_f(0.0),
                                      right_bound=_f(10.0))
    if case == "n_atoms5":
        return jwm.WaterModel(cell=JCell.cubic([BOX] * 3), law=law, transform=linear,
                              d_oh=_f(0.3), n_atoms=5, relaxation_time=6, waiting_time=2,
                              keep_last_neighbor_rescaled=True, check_from_old=True)
    if case == "triclinic":
        cell = JCell.triclinic(jnp.asarray([[BOX, 0, 0], [1.5, BOX, 0], [0.5, 1.0, BOX]],
                                           jnp.float32))
        return jwm.WaterModel(cell=cell, law=law, transform=linear, d_oh=_f(0.3),
                              n_atoms=3, relaxation_time=10,
                              keep_last_neighbor_rescaled=True, check_from_old=True)
    x, y = _table()
    table = jtr.InterpolatedTransformation(x=jnp.asarray(x, jnp.float32),
                                           y=jnp.asarray(y, jnp.float32))
    return jwm.WaterModel(cell=JCell.cubic([BOX] * 3), law=law, transform=table,
                          d_oh=_f(0.3), n_atoms=4, relaxation_time=4,
                          keep_last_neighbor_rescaled=True)


def _positions(seed=0, frames=B):
    rs = np.random.RandomState(seed)
    base = rs.uniform(0, BOX, size=(N, 3))
    return (base[None] + rs.normal(scale=0.08, size=(frames, N, 3))).astype(np.float32)


@pytest.mark.parametrize("case", ["n_atoms5", "triclinic", "interp1500_four"])
def test_run_water_block_matches_jax(case):
    jm = _model(case)
    tm = convert.water_model_from_fields(jm)
    assert twm.water_unsupported_reason(tm)
    pos = _positions(seed=len(case))
    key = jax.random.key(SEED)
    init = jwm.init_water_states(jax.random.fold_in(key, 0), R, N, jnp.asarray(pos[0]))
    keys = jax.random.split(jax.random.fold_in(key, 1), R)
    idx = np.arange(5, 5 + B, dtype=np.int32)
    jst, jsites, jmsd = jwm.run_water_block(jm, init, keys, jnp.asarray(pos),
                                            jnp.asarray(idx), dt=DT)
    tst, tsites, tmsd = twm.run_water_block(
        tm, convert.water_states_from_fields(init),
        convert.keys_from_numpy(jax.random.key_data(keys)), torch.from_numpy(pos), idx,
        dt=DT)
    np.testing.assert_array_equal(np.asarray(jsites), tsites.numpy())
    for name in ("site", "last_site", "frames_since_jump", "wait_left", "jumps"):
        np.testing.assert_array_equal(np.asarray(getattr(jst, name)),
                                      getattr(tst, name).numpy(), err_msg=name)
    for name in ("event_count", "last_event_frame"):
        np.testing.assert_array_equal(np.asarray(getattr(jst.clock, name)),
                                      getattr(tst.clock, name).numpy(), err_msg=name)
    for name in ("correction", "snapshot", "displacement"):
        np.testing.assert_allclose(np.asarray(getattr(jst, name)),
                                   getattr(tst, name).numpy(), err_msg=name, **TOL)
    for name in ("u_remaining", "last_event_phase"):
        np.testing.assert_allclose(np.asarray(getattr(jst.clock, name)),
                                   getattr(tst.clock, name).numpy(), err_msg=name, **TOL)
    np.testing.assert_allclose(np.asarray(jmsd), tmsd.numpy(), **TOL)
    assert int(tst.jumps.sum()) > R


def test_cli_scan_rows_match_jax(tmp_path):
    """kmc_water_main's scan branch (a 1500-point conversion table) prints
    the JAX CLI's rows from the JAX package's initial states."""
    pos = _positions(seed=7, frames=24)
    traj = tmp_path / "water.xyz"
    with open(traj, "w") as f:
        for fr in pos:
            write_xyz_frame(f, ["O"] * N, fr)
    x, y = _table()
    table = tmp_path / "conversion.txt"
    np.savetxt(table, np.stack([x, y], axis=1))
    cfg = tmp_path / "water.cfg"
    cfg.write_text(f"""filename {traj}
pbc {BOX} {BOX} {BOX}
md_timestep_fs {DT}
sweeps 24
print_frequency 3
chunk_size 10
jumprate_params_fs a=0.3 b=2.3 c=0.1
conversion_data {table}
relaxation_time 5
d_oh 0.3
keep_last_neighbor_rescaled True
seed {SEED}
replicas {R}
""")
    tset = tkw.load_configfile(str(cfg), config_name="KMCWater")
    assert "1024" in twm.water_unsupported_reason(tcli.build_model(tset, "cpu"))
    first = next(JXYZ(str(traj), time_step=DT).iter_batches())[1][0]
    init = jwm.init_water_states(jax.random.fold_in(jax.random.key(SEED), 0), R, N,
                                 jnp.asarray(first))
    jout, tout = io.StringIO(), io.StringIO()
    jcli.kmc_water_main(jkw.load_configfile(str(cfg), config_name="KMCWater"), out=jout)
    final = tcli.kmc_water_main(tset, out=tout, device="cpu",
                                initial_states=convert.water_states_from_fields(init))

    def rows(text):
        return [ln.split()[:-1] for ln in text.splitlines()
                if ln and not ln.startswith("#")]

    got, want = rows(tout.getvalue()), rows(jout.getvalue())
    assert len(got) == len(want) == 8
    assert [r[:2] + r[5:] for r in got] == [r[:2] + r[5:] for r in want]
    np.testing.assert_allclose(np.array([r[2:5] for r in got], np.float64),
                               np.array([r[2:5] for r in want], np.float64),
                               rtol=0, atol=1e-6)
    assert len({r[5] for r in got}) > 1 and int(final.jumps[0]) > 0
