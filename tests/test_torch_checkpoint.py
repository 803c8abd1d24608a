"""The port's checkpoints (``cmdlmc_tpu_torch/utils/checkpoint.py``) against
the JAX package's (``cmdlmc_tpu/utils/checkpoint.py``), on the host: a
checkpoint the JAX package writes from its own ``init_replicas`` state
(jump bins, the jump matrix, a neighbor carry) loads into the port field
for field as ``convert.ensemble_from_numpy`` carries that state over; the
port writes the same keys; its own states (and a WaterState) come back
equal; ``CheckpointWriter.save`` snapshots the state before it returns;
the port's driver resumes from a JAX-written checkpoint (its fingerprint of
the config included) as from the carried-over state. No JAX kernel runs
here."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu.engine import lattice as jeng
from cmdlmc_tpu.utils import checkpoint as jck
from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch.engine import lattice as teng
from cmdlmc_tpu_torch.models import water as twm
from cmdlmc_tpu_torch.utils import checkpoint as tck

R, N, P, K, BINS = 8, 12, 4, 5, 6


def _jax_state():
    """The JAX package's initial state with statistics, and a neighbor
    carry laid out as its kernels keep it (float ids, K rounded up to a
    whole 8-row tile)."""
    rng = np.random.RandomState(0)
    pos = rng.uniform(0, 9, size=(N, 3)).astype(np.float32)
    ens = jeng.init_replicas(jax.random.key(3), R, N, P, jnp.asarray(pos),
                             hist_bins=BINS, track_jump_matrix=True)
    rep = dataclasses.replace(
        ens.replicas,
        jump_hist=jnp.asarray(rng.randint(0, 9, size=(R, BINS)), jnp.int32),
        opportunity_hist=jnp.asarray(rng.uniform(0, 50, size=(R, BINS)), jnp.float32),
        jump_matrix=jnp.asarray(rng.randint(0, 3, size=(R, N, N)), jnp.int32))
    topi = np.zeros((8, N), np.float32)
    topi[:K] = rng.randint(0, N, size=(K, N))
    valid = np.zeros((8, N), np.float32)
    valid[:K] = rng.uniform(size=(K, N)) < 0.8
    carry = jeng.NeighborCarry(
        ref_pos=jnp.asarray(pos + 0.01), ref_topi=jnp.asarray(topi),
        ref_valid=jnp.asarray(valid), thresh=0.37109375, last_rebuild=21.0,
        thrash_until=30.0)
    return dataclasses.replace(ens, replicas=rep, nbr_carry=carry)


def _leaves(obj, prefix=""):
    """{dotted field name: value} of a nested dataclass."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_leaves(v, f"{prefix}{f.name}."))
        elif v is not None:
            out[prefix + f.name] = v
    return out


def _equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        x, y = la[k], lb[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert torch.equal(x, y), k
        else:
            assert type(x) is type(y) and x == y, k


def test_jax_checkpoint_loads_into_port(tmp_path):
    jstate = _jax_state()
    keys = jax.random.split(jax.random.key(5), R)
    path = str(tmp_path / "jax.npz")
    jck.save_checkpoint(path, jstate, keys, 40, meta={"seed": 7, "block_size": 20})
    states, tkeys, frame, meta = tck.load_checkpoint(path, k=K)
    _equal(states, convert.ensemble_from_numpy(jstate, k=K))
    assert isinstance(states.nbr_carry.thresh, float)
    np.testing.assert_array_equal(tkeys, np.asarray(jax.random.key_data(keys)))
    assert frame == 40 and int(meta["seed"]) == 7 and int(meta["block_size"]) == 20
    with pytest.raises(ValueError, match="k"):
        tck.load_checkpoint(path)


def test_port_writes_the_jax_layout(tmp_path):
    """Key for key the JAX package's file, the keys carried through; a run
    the port began writes no keys."""
    jstate = _jax_state()
    keys = jax.random.split(jax.random.key(5), R)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_checkpoint(jpath, jstate, keys, 40, meta={"seed": 7})
    states, tkeys, _, _ = tck.load_checkpoint(jpath, k=K)
    tck.save_checkpoint(tpath, states, tkeys, 40, meta={"seed": 7})
    with np.load(jpath) as j, np.load(tpath) as t:
        assert sorted(j.files) == sorted(t.files)
        for name in j.files:
            if not name.startswith("state.nbr_carry.ref_"):
                assert j[name].dtype == t[name].dtype, name
                np.testing.assert_array_equal(j[name], t[name], err_msg=name)
        assert t["state.nbr_carry.thresh"].shape == ()
    tck.save_checkpoint(tpath, states, None, 40)
    with np.load(tpath) as t:
        assert "keys" not in t.files
    assert tck.load_checkpoint(tpath)[1] is None


def _port_state():
    gen = torch.Generator().manual_seed(4)
    pos = torch.rand((N, 3), generator=gen) * 9
    ens = teng.init_replicas(gen, R, N, P, pos, hist_bins=BINS, track_jump_matrix=True)
    carry = teng.NeighborCarry(
        ref_pos=pos[None].expand(3, N, 3)[1],  # a view, as the kernels leave it
        ref_topi=torch.randint(0, N, (K, N), dtype=torch.int32, generator=gen),
        ref_valid=torch.rand((K, N), generator=gen) < 0.5, thresh=0.25,
        last_rebuild=-1.0e18, thrash_until=0.0)
    return dataclasses.replace(ens, nbr_carry=carry)


def test_port_roundtrip_and_water_state(tmp_path):
    states = _port_state()
    path = str(tmp_path / "p.npz")
    tck.save_checkpoint(path, states, None, 60, meta={"block_size": 20})
    loaded, keys, frame, meta = tck.load_checkpoint(path)
    _equal(loaded, states)
    assert keys is None and frame == 60 and int(meta["block_size"]) == 20
    gen = torch.Generator().manual_seed(0)
    water = twm.init_water_states(gen, R, N, torch.rand((N, 3), generator=gen) * 9)
    water = dataclasses.replace(water, jumps=torch.arange(R, dtype=torch.int32))
    tck.save_checkpoint(path, water, None, 3)
    loaded, _, frame, _ = tck.load_checkpoint(path)
    assert type(loaded).__name__ == "WaterState" and frame == 3
    _equal(loaded, water)


def test_save_snapshots_the_state_before_returning(tmp_path):
    """The port's state changes in place after a save (the jump matrix is
    added into, the kernels' outputs are written over): the file holds the
    state as it was at ``save()``."""
    states = _port_state()
    want = tck.snapshot(states)[0]
    path = str(tmp_path / "w.ckpt")
    writer = tck.CheckpointWriter(path)
    writer.save(states, None, 20)
    rep = states.replicas
    rep.jump_matrix += 1
    rep.occ.fill_(7.0)
    rep.clock.u_remaining.zero_()
    states.nbr_carry.ref_pos.add_(1.0)
    writer.close()
    _equal(tck.load_checkpoint(path)[0], want)
    assert writer.save_seconds > 0 and writer.write_seconds > 0


def test_exact_path_and_write_errors(tmp_path):
    """The file lands on exactly the configured path (no ``.npz`` added, no
    temporary left); a write that fails is raised by the next call."""
    states = _port_state()
    path = tmp_path / "run.ckpt"
    tck.save_checkpoint(str(path), states, None, 1)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["run.ckpt"]
    writer = tck.CheckpointWriter(str(tmp_path / "missing" / "run.ckpt"))
    writer.save(states, None, 1)
    with pytest.raises(FileNotFoundError):
        writer.close()
    writer.close()  # the error is raised once


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
[Engine]
replicas = 16
tile = 4
seed = 1
block_size = 20
sweeps = 40
"""


def test_port_resumes_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX package wrote (its initial state, its keys, its
    fingerprint of the config) resumes in the port's driver: the rows and
    the final state are those of the port's run from that state carried
    over by ``convert``, and the port's own save carries the keys through."""
    import io

    from cmdlmc_tpu.config.schema import load_config as j_load_config
    from cmdlmc_tpu.driver import config_fingerprint
    from cmdlmc_tpu_torch import driver as tdriver
    from cmdlmc_tpu_torch.io.xyz import write_xyz_frame

    rng = np.random.RandomState(0)
    base = rng.uniform(0, 9.0, size=(32, 3))
    frames = [base + rng.normal(scale=0.03, size=base.shape) for _ in range(40)]
    traj = tmp_path / "t.xyz"
    with open(traj, "w") as f:
        for pos in frames:
            write_xyz_frame(f, ["O"] * 32, pos)
    text = INI.format(traj=traj)
    jinit = jeng.init_replicas(jax.random.key(9), 16, 32, 12,
                               jnp.asarray(np.float32(frames[0])))
    keys = jax.random.split(jax.random.key(2), 16)
    ckpt = tmp_path / "jax.npz"
    jck.save_checkpoint(str(ckpt), jinit, keys, 0, meta={
        "seed": 1, "block_size": 20,
        "config_fingerprint": np.bytes_(
            config_fingerprint(j_load_config(io.StringIO(text))).encode())})
    runs = []
    for ini, init in ((text + f"checkpoint_path = {ckpt}\n", None),
                      (text, convert.ensemble_from_numpy(jinit))):
        out = io.StringIO()
        sim = tdriver.Simulation(tdriver.load_config(io.StringIO(ini)), device="cpu",
                                 initial_state=init)
        sim.run(out=out)
        runs.append(([ln for ln in out.getvalue().splitlines()
                      if ln and not ln.startswith("#")], sim.final_states))
    (rows, final), (want_rows, want) = runs
    assert len(rows) == 4 and rows == want_rows
    _equal(final, want)
    with np.load(ckpt) as f:
        assert int(f["next_frame"]) == 40
        np.testing.assert_array_equal(f["keys"], np.asarray(jax.random.key_data(keys)))
