"""The Verlet schedule kernel (``csrc/verlet_schedule.cu``) against its plain
version, and Verlet reuse on the card against the CPU (marked ``cuda``; they
skip without one). On the same positions, tables and carry the kernel and
``verlet_schedule_reference`` give the same list rows, rebuild frames and
carry scalars, bit for bit; ``topk_tables_verlet`` on the card gives the
CPU's lists, tables and carry: for a block entered with no carry, a carry
with few rebuilds, a thrash window that opens inside the block and one
resumed from an earlier block, a carry in the JAX package's layout
(``convert.neighbor_carry_from_fields``) and a triclinic cell; the same
frames cut into blocks of 7, 16 and 100 give the same lists; and a supercell
run stopped at a checkpoint and resumed ends as the straight run. On a
machine with a GPU and no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda_verlet.py
"""

import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch import driver as tdriver
from cmdlmc_tpu_torch.core.cell import Cell
from cmdlmc_tpu_torch.io.xyz import write_xyz_frame
from cmdlmc_tpu_torch.ops import topk_sweep as ts
from cmdlmc_tpu_torch.rates.laws import Fermi
from cmdlmc_tpu_torch.topo.models import TopKPairRates

from test_torch_kernels_cuda import dev

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

N_SITES = 1152  # the 2x2x2 supercell's sites, at bench.py's density
CUBIC = 14.5 * (N_SITES / 144) ** (1 / 3)
MONOCLINIC = [[19.0, 0.0, 0.0], [0.0, 18.0, 0.0], [2.5, 0.0, 17.5]]  # 300 sites


def _model(device, cell=None):
    cell = Cell.cubic([CUBIC] * 3, device=device) if cell is None else \
        Cell.triclinic(cell, device=device)
    return TopKPairRates(cell, Fermi(a=0.06, b=2.3, c=0.1).to(device), 3.0, 2.0, k=8)


def _walk(sigmas, seed, n=N_SITES, box=CUBIC):
    """n uniform sites in the box plus a random walk of sigmas[f] per frame
    and coordinate."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(0, box, size=(n, 3))
    steps = rng.normal(size=(len(sigmas), n, 3)) * np.asarray(sigmas)[:, None, None]
    return torch.from_numpy((base[None] + np.cumsum(steps, axis=0)).astype(np.float32))


def _carry_to(carry, device):
    return None if carry is None else carry.to(device)


def _same_carry(a, b):
    for f in ("ref_pos", "ref_topi", "ref_valid"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()), f
    assert (a.thresh, a.last_rebuild, a.thrash_until) == (b.thresh, b.last_rebuild,
                                                          b.thrash_until)


def _hold(dev, pos, carry, frame0, cell=None):
    """The kernel against its plain version on the card's stage-1 tables,
    then the whole of topk_tables_verlet on the card against the CPU.
    Returns the card's outputs and the rebuild frames."""
    mc, md = _model("cpu", cell), _model(dev, cell)
    pd = pos.to(dev)
    topd, _, _ = ts.topk_tables(md, pd, precompute_law=False)
    before = ts.verlet_schedule.launches
    rows, rebuilt, sched = ts.verlet_schedule(md, pd, topd, _carry_to(carry, dev), frame0)
    assert ts.verlet_schedule.launches == before + 1
    want = ts.verlet_schedule_reference(mc, pos, topd.cpu(), _carry_to(carry, "cpu"), frame0)
    assert torch.equal(rows.cpu(), want[0])
    np.testing.assert_array_equal(rebuilt.cpu().numpy(), want[1])
    assert torch.equal(sched.cpu().view(torch.int64), want[2].view(torch.int64))
    got = ts.topk_tables_verlet(md, pd, True, _carry_to(carry, dev), frame0)
    ref = ts.topk_tables_verlet(mc, pos, True, _carry_to(carry, "cpu"), frame0)
    assert torch.equal(got[1].cpu(), ref[1])
    np.testing.assert_allclose(got[0].cpu().numpy(), ref[0].numpy(), rtol=2.4e-7, atol=0)
    np.testing.assert_allclose(got[2].cpu().numpy(), ref[2].numpy(), rtol=2e-5, atol=1e-12)
    np.testing.assert_array_equal(got[4].cpu().numpy(), ref[4])
    _same_carry(got[3], ref[3])
    return got, ref[4]


def _jax_layout_carry(pos, k=8, tile=16):
    """A carry as the JAX package's kernels keep it: float ids and flags
    padded to a whole tile of rows (the port's lists from the CPU)."""
    m = _model("cpu")
    topd, topi, _ = ts.topk_tables(m, pos[None], precompute_law=False)
    ids = np.zeros((tile, pos.shape[0]), np.float32)
    ids[:k] = topi[0].numpy()
    valid = np.zeros((tile, pos.shape[0]), np.float32)
    valid[:k] = topd[0].numpy() < 1.0e5
    return convert.neighbor_carry_from_fields(SimpleNamespace(
        ref_pos=pos.numpy(), ref_topi=ids, ref_valid=valid, thresh=np.float32(0.2),
        last_rebuild=95.0, thrash_until=0.0), k)


@pytest.mark.parametrize("case", ["fresh", "carried", "thrash_starts", "thrash_resumed",
                                  "jax_layout", "triclinic"])
def test_schedule_kernel_matches_plain(dev, case):
    """Few rebuilds from no carry (frames 100-147: rebuilds at 0, 20, 45);
    the next 40 frames from the card's carry; a block whose drift quickens
    at frame 24 (a thrash window opens at 125, to 253); the block after it,
    resuming the window; a JAX-layout carry at frame 96 (rebuilds at 12,
    18, 23, 28); a monoclinic cell (the plain tables, the 27-image minimum
    image)."""
    if case in ("fresh", "carried"):
        pos = _walk([0.006] * 88, 1)
        first, rebuilt = _hold(dev, pos[:48], None, 100)
        assert list(np.nonzero(rebuilt)[0]) == [0, 20, 45]
        if case == "carried":
            _, rebuilt = _hold(dev, pos[48:], first[3], 148)
            assert 0 < rebuilt.sum() < 8 and not rebuilt[0]
    elif case.startswith("thrash"):
        pos = _walk([0.004] * 24 + [0.05] * 40, 2)
        first, rebuilt = _hold(dev, pos[:48], None, 100)
        # frame 124 rebuilds alone, 125 passes the threshold within the gap
        assert list(np.nonzero(rebuilt)[0]) == [0] + list(range(24, 48))
        assert first[3].thrash_until == 125 + ts._THRASH_SPAN
        if case == "thrash_resumed":
            _, rebuilt = _hold(dev, pos[48:], first[3], 148)
            assert rebuilt.all()
    elif case == "jax_layout":
        pos = _walk([0.014] * 33, 3)
        _, rebuilt = _hold(dev, pos[1:], _jax_layout_carry(pos[0]), 96)
        assert list(np.nonzero(rebuilt)[0]) == [12, 18, 23, 28]
    else:
        pos = _walk([0.02] * 32, 4, n=300, box=18.0)
        _, rebuilt = _hold(dev, pos, None, 0, cell=MONOCLINIC)
        assert 1 < rebuilt.sum() < 32


def test_schedule_is_chunk_invariant_on_the_card(dev):
    """100 frames in blocks of 7, 16 and 100 with the carry threaded on the
    card: the same lists, tables and rebuild frames, those of the plain
    schedule over the whole block."""
    pos = _walk([0.006] * 60 + [0.04] * 40, 5)
    md = _model(dev)
    want = ts.topk_tables_verlet(_model("cpu"), pos, True, None, 0)[4]
    runs = []
    for size in (7, 16, 100):
        carry, topi, topd, rebuilt = None, [], [], []
        for s in range(0, 100, size):
            out = ts.topk_tables_verlet(md, pos[s:s + size].to(dev), True, carry, s)
            carry = out[3]
            topd.append(out[0])
            topi.append(out[1])
            rebuilt.append(out[4])
        runs.append((torch.cat(topd), torch.cat(topi), torch.cat(rebuilt).cpu().numpy(), carry))
    assert list(np.nonzero(want)[0][:3]) == [0, 23, 53] and want[60:].all()
    for topd, topi, rebuilt, carry in runs:
        np.testing.assert_array_equal(rebuilt, want)
        assert torch.equal(topi, runs[-1][1])
        assert torch.equal(topd.view(torch.int32), runs[-1][0].view(torch.int32))
        _same_carry(carry, runs[-1][3])


INI = """[Trajectory]
filename = {traj}
time_step = 0.4
[AtomBox]
type = AtomBoxCubic
periodic_boundaries = 14.5, 14.5, 14.5
box_multiplier = 2, 2, 2
[NeighborTopology]
type = NeighborTopology
donor_atoms = O
cutoff = 3.0
buffer = 2.0
max_neighbors = 8
[JumpRate]
type = Fermi
a = 0.06
b = 2.3
c = 0.1
[KMCLattice]
lattice_size = 1152
proton_number = 768
time_step = 0.4
[Output]
type = ObservablesOutput
print_frequency = 20
reset_frequency = 100
[Engine]
replicas = 256
seed = 7
block_size = 40
sweeps = {sweeps}
max_events_per_frame = 64
checkpoint_path = {ckpt}
checkpoint_interval = 1
"""


def test_verlet_supercell_resumes_bit_for_bit_on_the_card(dev, tmp_path):
    """The benchmark's 2x2x2 supercell (Verlet reuse by the auto rule) at
    R=256: a run stopped at frame 80 and resumed from its checkpoint prints
    the straight run's rows and ends in its state and carry; the
    checkpoint's schedule scalars read back as the carry's floats."""
    rng = np.random.RandomState(6)
    base = rng.uniform(0, 14.5, size=(144, 3))
    pos = base + np.cumsum(rng.normal(scale=0.004, size=(160, 144, 3)), axis=0)
    traj = tmp_path / "walk.xyz"
    with open(traj, "w") as f:
        for p in pos:
            write_xyz_frame(f, ["O"] * 144, p)

    def run(sweeps, ckpt):
        out = io.StringIO()
        text = INI.format(traj=traj, sweeps=sweeps, ckpt=tmp_path / ckpt)
        sim = tdriver.run_from_config(io.StringIO(text), out=out, device="cuda")
        rows = [ln for ln in out.getvalue().splitlines() if ln and not ln.startswith("#")]
        return rows, sim.final_states

    full, final = run(160, "straight.npz")
    part1, mid = run(80, "part.npz")
    with np.load(tmp_path / "part.npz") as f:
        saved = [float(f[f"state.nbr_carry.{n}"]) for n in
                 ("thresh", "last_rebuild", "thrash_until")]
    assert saved == [mid.nbr_carry.thresh, mid.nbr_carry.last_rebuild,
                     mid.nbr_carry.thrash_until]
    part2, resumed = run(160, "part.npz")
    assert part1 + part2 == full
    a, b = resumed.replicas, final.replicas
    for x, y in ((a.occ, b.occ), (a.site_of_proton, b.site_of_proton),
                 (a.disp_base, b.disp_base), (a.clock.event_count, b.clock.event_count)):
        assert torch.equal(x, y)
    _same_carry(resumed.nbr_carry, final.nbr_carry)
