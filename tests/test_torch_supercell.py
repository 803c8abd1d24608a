"""The port's top-K supercell slice against the JAX package on the CPU.

* ``extended_positions`` (the box_multiplier supercell) bit-equal to JAX's,
  cubic and triclinic;
* the plain version of kernel K6 (``ops/knn_sparse.py``) against the JAX
  package's B6 in interpret mode over the same plan (N=200, k=6,
  rc = tc = 64, as tests/ops/test_knn_sparse.py sets it): indices exact,
  distances within an ulp (rtol 2.4e-7: the JAX kernel's sum of squares is
  contracted into multiply-adds by XLA's CPU backend, the port rounds each
  operation, as K5's test bounds it); and against the port's K5 plain
  version bit for bit on a tie-heavy lattice, a drifting block and
  coordinates far outside the box;
* ``test_torch_supercell_verlet.py`` holds ``topk_tables_verlet`` against
  the JAX package's: the tables (indices exact, distances to rtol 3e-7, an
  ulp of XLA's fused epilogue; rates to rtol 2e-5, the Fermi law turning an
  ulp into about 25), the rebuild frames, and the carry (exact; the
  threshold as float32), for a block with a few rebuilds (the JAX package's
  device schedule), a thrashing one (its host loop), a block started from a
  carried JAX NeighborCarry, and HydroniumRates under nbr_reuse = on; and
  Verlet reuse through the engine: the same frames in one block and in
  blocks of 3 with the carry threaded give the same state;
* the slice through ``run_from_config``: box_multiplier = 2, 2, 2 with
  per-frame lists against the JAX package's frozen golden curves of
  tests/golden/scenarios.py::scenario_5_fused_topk (no JAX kernel runs),
  and with nbr_reuse = on against the JAX driver run on the same config
  (rows: Autocorr and Jumps to 1e-5, MSD to the golden tolerance rtol 2e-4;
  final integer state exact)."""

import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu import driver as jdriver
from cmdlmc_tpu.config.schema import load_config as j_load_config
from cmdlmc_tpu.core.cell import Cell as JCell
from cmdlmc_tpu.core.cell import extended_positions as j_extended_positions
from cmdlmc_tpu.engine import lattice as jeng
from cmdlmc_tpu.ops import knn_sparse as jks
from cmdlmc_tpu.rates.laws import Fermi as JFermi
from cmdlmc_tpu.topo import models as jmodels
from cmdlmc_tpu.topo import transforms as jtr
from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch import driver as tdriver
from cmdlmc_tpu_torch.config.schema import load_config as t_load_config
from cmdlmc_tpu_torch.core.cell import extended_positions
from cmdlmc_tpu_torch.ops import knn_sparse as kns
from cmdlmc_tpu_torch.ops import knn_tables as knn
from cmdlmc_tpu_torch.ops import topk_sweep as ts

from test_torch_slice import jax_kernels_run_to_end  # noqa: F401  (runs by itself)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
_f = jnp.float32
L, N = 11.0, 64  # the Verlet cases: bench.py's site density, k=8 truncated


# -- extended_positions ---------------------------------------------------------


@pytest.mark.parametrize("cell", [[9.3, 10.1, 8.7],
                                  [[10.0, 0.0, 0.0], [1.3, 9.5, 0.0], [0.7, 0.4, 11.1]]],
                         ids=["cubic", "triclinic"])
def test_extended_positions_match_jax(cell):
    """One frame and a block of two, box_multiplier 2, 3, 2: the same
    ordering and float32 sums as the JAX package, bit for bit."""
    rng = np.random.RandomState(0)
    p = rng.uniform(-2, 12, (2, 7, 3)).astype(np.float32)
    vectors = np.diag(cell) if np.asarray(cell).ndim == 1 else np.asarray(cell)
    for f in range(2):
        want = np.asarray(j_extended_positions(jnp.asarray(vectors, jnp.float32),
                                               jnp.asarray(p[f]), (2, 3, 2)))
        got = extended_positions(cell, torch.from_numpy(p), (2, 3, 2))
        assert got.shape == (2, 84, 3)
        np.testing.assert_array_equal(got[f].numpy(), want)
        np.testing.assert_array_equal(
            extended_positions(cell, torch.from_numpy(p[f]), (2, 3, 2)).numpy(), want)


# -- K6's plain version -------------------------------------------------------


def _plan(pos, box, rcut, rc, tc):
    return kns.SparsePlan(*kns.plan_sparse(pos, (box,) * 3, rcut, rc=rc, tc=tc), rc, tc)


def test_knn_sparse_reference_matches_jax_kernel():
    rng = np.random.RandomState(0)
    box, rcut = 14.0, 3.0
    base = rng.uniform(0, box, (200, 3)).astype(np.float32)
    pos = (base[None] + rng.normal(scale=0.05, size=(1, 200, 3))).astype(np.float32)
    plan = _plan(pos, box, rcut, 64, 64)
    want_d, want_i = jks.knn_sparse_tables(
        jnp.asarray(pos), jnp.asarray([box] * 3, jnp.float32), rcut, plan.perm,
        plan.inv, plan.lists, k=6, kl=8, rc=64, tc=64, n_ch=plan.n_ch,
        maxa=plan.lists.shape[1], interpret=True)
    got_d, got_i = kns.knn_sparse_tables(torch.from_numpy(pos), (box,) * 3, rcut, 6, plan)
    assert got_d.shape == (1, 6, 200) and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i)[:, :6].astype(np.int32))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d)[:, :6], rtol=2.4e-7, atol=0)
    assert np.any(got_d.numpy() == knn.BIG)
    k5_d, k5_i = knn.knn_block_tables(torch.from_numpy(pos), (box,) * 3, rcut, 6)
    assert torch.equal(got_d, k5_d) and torch.equal(got_i, k5_i)
    assert kns.knn_sparse_tables.launches == 0  # CPU tensors: plain version


def _lattice():
    """A simple cubic lattice, 8 x 8 x 8 at 2.5 Å: six equidistant first
    neighbors and twelve second ones, so the (distance, id) order decides."""
    g = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1)
    return (g.reshape(-1, 3).astype(np.float32) * 2.5)[None], 20.0


def _drifting():
    """500 sites in a 24 Å cube, a random walk of 0.15 Å per frame and
    coordinate over 3 frames (the plan widens its boxes by the drift)."""
    rng = np.random.RandomState(1)
    base = rng.uniform(0, 24.0, (500, 3)).astype(np.float32)
    walk = np.cumsum(rng.normal(scale=0.15, size=(3, 500, 3)), axis=0)
    return (base[None] + walk).astype(np.float32), 24.0


def _unwrapped():
    """The drifting block, each site moved by whole boxes (up to 3 away)."""
    pos, box = _drifting()
    shift = np.random.RandomState(2).randint(-3, 4, size=(1, 500, 3)) * box
    return (pos + shift).astype(np.float32), box


@pytest.mark.parametrize("make", [_lattice, _drifting, _unwrapped],
                         ids=["ties", "drift", "unwrapped"])
def test_knn_sparse_equals_k5(make):
    """K6's plain version equals K5's bit for bit, including exhausted slots
    (k = 12 past the lattice's shell of six) and a plan that prunes."""
    pos, box = make()
    rcut = float(np.float32(2.6) + np.float32(0.9))
    plan = _plan(pos, box, rcut, 32, 32)
    assert plan.lists.shape[1] < plan.n_ch
    for k in (4, 12):
        got = kns.knn_sparse_tables(torch.from_numpy(pos), (box,) * 3, rcut, k, plan)
        want = knn.knn_block_tables(torch.from_numpy(pos), (box,) * 3, rcut, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((got[0] == knn.BIG).any())


def test_topk_tables_takes_the_sparse_plan(monkeypatch):
    """topk_tables takes K6's wrapper wherever sparse_plan_for gives a plan
    (here with the gate opened at 64 sites), K5's below SPARSE_MIN_N; the
    tables are the same."""
    _, tm = _models("topk")
    pos = torch.from_numpy(_walk(3, 0.01, 5))
    calls = []

    def counting(fn):
        def wrapped(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(kns, "knn_sparse_tables", counting(kns.knn_sparse_tables))
    monkeypatch.setattr(ts, "knn_block_tables", counting(ts.knn_block_tables))
    want = ts.topk_tables(tm, pos, precompute_law=True)
    plan_for = kns.sparse_plan_for
    monkeypatch.setattr(kns, "sparse_plan_for", lambda *a, **kw: plan_for(
        *a, min_n=0, max_ratio=1.0, rc=16, tc=32))
    got = ts.topk_tables(tm, pos, precompute_law=True)
    assert calls == ["knn_block_tables", "knn_sparse_tables"]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -- Verlet candidate reuse -----------------------------------------------------


def _models(name):
    cell = JCell.cubic([L] * 3)
    law = JFermi(a=_f(0.06), b=_f(2.3), c=_f(0.1))
    if name == "topk":
        jm = jmodels.TopKPairRates(cell=cell, law=law, cutoff=_f(3.0), buffer=_f(2.0), k=8)
        return jm, convert.topk_pair_rates_from_fields(jm)
    jm = jmodels.HydroniumRates(
        cell=cell, law=law, cutoff=_f(3.0), buffer=_f(2.0),
        transform=jtr.ReLUTransformation(a=_f(0.5), b=_f(2.2), d0=_f(2.2),
                                         left_bound=_f(2.0), right_bound=_f(3.3)),
        interpolator=jtr.DistanceInterpolator(relaxation_time=_f(20.0)), k=4)
    return jm, convert.hydronium_rates_from_fields(jm)


def _walk(frames, sigma, seed):
    """N sites uniform in the L cube plus a random walk of sigma per frame
    and coordinate."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(0, L, (N, 3)).astype(np.float32)
    steps = rng.normal(scale=sigma, size=(frames, N, 3)).astype(np.float32)
    return (base[None] + np.cumsum(steps, axis=0)).astype(np.float32)


# -- the slice through the driver ------------------------------------------------


def _scenario5():
    sys.path.insert(0, GOLDEN)
    import scenarios

    return scenarios


def test_box_multiplier_matches_golden(tmp_path):
    """tests/golden/scenarios.py::scenario_5_fused_topk (N = 8 O sites x 8
    copies, 16 protons, 16 replicas in RNG tiles of 8, 120 frames, per-frame
    lists: the auto rule stays off below 1024 sites) through the port's
    driver, started from the JAX driver's initial state, against the frozen
    curves of the JAX package's own run, at test_golden.py's tolerance."""
    sc = _scenario5()
    names, frames = sc._solid_acid_frames(n_p=2, n_o=8, seed=31)
    traj = str(tmp_path / "s5f.xyz")
    sc._write_xyz(traj, names, frames)
    ini = sc._fused(sc._INI.format(
        traj=traj, box=10.0, mult="box_multiplier = 2,2,2", law="Fermi",
        law_params=sc.FERMI, sites=64, protons=16, pf=20, rf=60, replicas=16,
        bs=30).replace("buffer = 2.0", "buffer = 2.0\nmax_neighbors = 8"), tile=8)
    rows = _port_rows(ini, _jax_init(ini))
    with np.load(os.path.join(GOLDEN, "config5_fused_topk.npz")) as f:
        want = {k: f[k] for k in f.files}
    got = {"frame": rows[:, 0], "msd": rows[:, 2:5], "autocorr": rows[:, 5],
           "jumps": rows[:, 6]}
    for key, w in want.items():
        scale = max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(got[key], w, rtol=2e-4, atol=2e-4 * scale, err_msg=key)
    assert got["jumps"].max() > 0


def _jax_init(ini):
    """The JAX driver's initial state for ``ini`` on its extended sites (the
    supercell by the port's extended_positions, bit-equal to JAX's; the
    JAX package's init_replicas under one jit)."""
    jcfg = j_load_config(io.StringIO(ini))
    names, pos, _ = next(jdriver.build_trajectory(jcfg).iter_batches())
    small = torch.from_numpy(np.asarray(pos[0][names == "O"], np.float32))
    first = extended_positions(jcfg.atombox.periodic_boundaries, small,
                               jcfg.atombox.box_multiplier).numpy()
    key = jax.random.key(jcfg.engine.seed)
    init = jax.jit(jeng.init_replicas, static_argnums=(1, 2, 3))
    return init(jax.random.fold_in(key, 0), jcfg.engine.replicas, first.shape[0],
                jcfg.kmc.proton_number, jnp.asarray(first))


def _port_rows(ini, jinit, sim_out=None):
    sim = tdriver.Simulation(t_load_config(io.StringIO(ini)), device="cpu",
                             initial_state=convert.ensemble_from_numpy(jinit))
    buf = io.StringIO()
    sim.run(out=buf)
    if sim_out is not None:
        sim_out.append(sim)
    return np.asarray([[float(x) for x in ln.split()] for ln in buf.getvalue().splitlines()
                       if ln and not ln.startswith("#")])


REUSE_INI = """[Trajectory]
filename = {traj}
time_step = 0.5
[AtomBox]
type = AtomBoxCubic
periodic_boundaries = 5.5, 5.5, 5.5
box_multiplier = 2, 2, 2
[NeighborTopology]
type = NeighborTopology
donor_atoms = O
cutoff = 3.0
buffer = 2.0
max_neighbors = 8
[JumpRate]
type = Fermi
a = 0.1
b = 2.5
c = 0.3
[KMCLattice]
lattice_size = 64
proton_number = 16
time_step = 0.5
[Output]
type = ObservablesOutput
print_frequency = 1
reset_frequency = 2
[Engine]
replicas = 16
tile = 8
seed = 17
block_size = 2
sweeps = 3
backend = fused
nbr_reuse = on
"""


def test_box_multiplier_reuse_matches_jax_driver(tmp_path):
    """box_multiplier = 2, 2, 2, max_neighbors = 8 and nbr_reuse = on
    through both drivers, the port's from the JAX driver's initial state:
    8 sites in a 5.5 Å cube as a random walk, printing every frame over 3
    frames in blocks of 2 with a reset at frame 2, so the carry crosses
    launches, a block boundary and a reset (the JAX top-K kernel compiles
    once, all launches spanning one frame)."""
    rng = np.random.RandomState(8)
    base = rng.uniform(0, 5.5, (8, 3))
    walk = np.cumsum(rng.normal(scale=0.04, size=(3, 8, 3)), axis=0)
    traj = tmp_path / "walk.xyz"
    with open(traj, "w") as f:
        for pos in base[None] + walk:
            f.write("8\nframe\n" + "".join(f"O {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in pos))
    ini = REUSE_INI.format(traj=traj)
    jsim = jdriver.Simulation(j_load_config(io.StringIO(ini)))
    jbuf = io.StringIO()
    inits = []
    jit_init = jax.jit(jeng.init_replicas, static_argnums=(1, 2, 3),
                       static_argnames=("hist_bins", "track_jump_matrix"))
    with pytest.MonkeyPatch.context() as mp:  # keep the JAX driver's own state
        mp.setattr(jeng, "init_replicas",
                   lambda *a, **kw: inits.append(jit_init(*a, **kw)) or inits[-1])
        jsim.run(out=jbuf)
    want = np.asarray([[float(x) for x in ln.split()] for ln in jbuf.getvalue().splitlines()
                       if ln and not ln.startswith("#")])
    sims = []
    rows = _port_rows(ini, inits[0], sims)
    assert rows.shape == want.shape == (3, 7)
    np.testing.assert_array_equal(rows[:, 0], want[:, 0])
    np.testing.assert_allclose(rows[:, 5:7], want[:, 5:7], atol=1e-5)
    np.testing.assert_allclose(rows[:, 2:5], want[:, 2:5], rtol=2e-4, atol=1e-7)
    trep, jrep = sims[0].final_states.replicas, jsim.final_states.replicas
    for a, b in ((trep.occ, jrep.occ), (trep.site_of_proton, jrep.site_of_proton),
                 (trep.clock.event_count, jrep.clock.event_count)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tc, jc = sims[0].final_states.nbr_carry, jsim.final_states.nbr_carry
    assert (tc.last_rebuild, tc.thrash_until) == (float(jc.last_rebuild),
                                                 float(jc.thrash_until))
    assert sims[0].final_states.replicas.occ.shape == (16, 64)
    assert int(trep.clock.event_count.sum()) > 0
