"""The port's spans and counters (``cmdlmc_tpu_torch/utils/trace.py``): tiny
dense and Verlet supercell runs on the CPU under ``torch.profiler`` export
every span, nested as documented; no span encloses the consumer; with no
profiler running a span is the shared no-op; the sync counters follow the
transfer schedule; closing the rows ends the prefetch thread; the ``# perf:``
line reads the counters. The ``cuda``-marked test runs two blocks of each
deployment on the card under ``torch.cuda.set_sync_debug_mode("error")``:
every blocking transfer must go through the marked helper. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py
"""

import io
import json
import threading

import numpy as np
import pytest
import torch

from cmdlmc_tpu_torch.config.schema import load_config
from cmdlmc_tpu_torch.driver import Simulation
from cmdlmc_tpu_torch.io.xyz import write_xyz_frame
from cmdlmc_tpu_torch.ops import topk_sweep as ts
from cmdlmc_tpu_torch.utils import trace

torch.set_num_threads(1)

INI = """[Trajectory]
filename = {traj}
time_step = 0.4
[AtomBox]
type = AtomBoxCubic
periodic_boundaries = {box}, {box}, {box}
box_multiplier = {mult}, {mult}, {mult}
[NeighborTopology]
type = NeighborTopology
donor_atoms = O
cutoff = 3.0
buffer = 2.0
{topk}
[JumpRate]
type = Fermi
a = 0.06
b = 2.3
c = 0.1
[KMCLattice]
lattice_size = {sites}
proton_number = {protons}
time_step = 0.4
[Output]
type = ObservablesOutput
print_frequency = {print_freq}
reset_frequency = {reset_freq}
[Engine]
replicas = {replicas}
seed = 7
block_size = {block}
sweeps = {sweeps}
max_events_per_frame = 64
{engine}
"""

# (cell sites, box, multiplier, protons, replicas, block, blocks, step of the
# trajectory per frame, jitter (else a walk)); the card's are the
# benchmark's deployments (144 sites, 2x2x2 supercell), the CPU's tiny
SIZES = {
    ("dense", "cpu"): (48, 10.5, 1, 16, 16, 8, 3, 0.03, True),
    ("verlet", "cpu"): (32, 8.0, 3, 64, 2, 8, 3, 0.015, False),
    ("dense", "cuda"): (144, 14.5, 1, 96, 16384, 256, 2, 0.03, True),
    ("verlet", "cuda"): (144, 14.5, 2, 768, 4096, 256, 2, 0.004, False),
}

# the innermost kmc.* span enclosing each span on its thread (None: none)
PARENTS = {
    "kmc.stream.wait": {"kmc.block"}, "kmc.stream.parse": {None}, "kmc.stream.h2d": {None},
    "kmc.block": {None}, "kmc.driver.emit": {None}, "kmc.driver.ckpt": {None},
    "kmc.run_block": {"kmc.block", "kmc.run_block"},
    "kmc.stage1": {"kmc.run_block"}, "kmc.loop": {"kmc.run_block"},
    "kmc.stage1.knn": {"kmc.stage1"}, "kmc.stage1.plan": {"kmc.stage1.knn"},
    "kmc.driver.post": {"kmc.block"},
    "kmc.sync.emit": {"kmc.driver.emit"}, "kmc.sync.init": {"kmc.block"},
    "kmc.sync.stream_h2d": {"kmc.stream.h2d"}, "kmc.sync.supercell_h2d": {"kmc.stream.h2d"},
}


def _config(tmp_path, kind, device="cpu", checkpoint=False, blocks=None):
    n, box, mult, protons, replicas, block, nblocks, step, jitter = SIZES[kind, device]
    blocks = blocks or nblocks
    rng = np.random.RandomState(3)
    base = rng.uniform(0, box, size=(n, 3))
    frames = block * blocks
    moves = rng.normal(scale=step, size=(frames, n, 3))
    pos = base + (moves if jitter else np.cumsum(moves, axis=0))
    traj = tmp_path / f"{kind}.xyz"
    with open(traj, "w") as f:
        for p in pos:
            write_xyz_frame(f, ["O"] * n, p)
    # 16 replicas in tiles of one take stage 1 + the streamed loop
    engine = "nbr_reuse = on" if kind == "verlet" else "tile = 1" if device == "cpu" else ""
    if checkpoint:
        engine += f"\ncheckpoint_path = {tmp_path / 'run.npz'}\ncheckpoint_interval = 1"
    ini = tmp_path / f"{kind}.ini"
    ini.write_text(INI.format(
        traj=traj, box=box, mult=mult, sites=n * mult**3, protons=protons,
        replicas=replicas, block=block, sweeps=frames, engine=engine,
        topk="max_neighbors = 8" if kind == "verlet" else "",
        print_freq=4 if device == "cpu" else 100, reset_freq=8 if device == "cpu" else 500))
    return load_config(str(ini))


def _profiled(path, fn):
    """Run ``fn`` under a CPU profiler that records every thread; returns
    its result and the kmc.* spans as (name, start, end, thread)."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"])
             for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return out, spans


def _parent(span, spans):
    name, a, b, tid = span
    inside = [s for s in spans if s is not span and s[3] == tid and s[0].startswith("kmc.")
              and s[1] <= a and b <= s[2]]
    return min(inside, key=lambda s: s[2] - s[1])[0] if inside else None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each tiny run under the profiler, with the counters it moved."""
    out = {}
    for kind in ("dense", "verlet"):
        tmp = tmp_path_factory.mktemp(kind)
        sim = Simulation(_config(tmp, kind, checkpoint=kind == "dense"), device="cpu")
        before = trace.snapshot()
        rows, spans = _profiled(tmp / "trace.json", lambda: list(sim.observable_rows()))
        out[kind] = dict(sim=sim, rows=rows, spans=spans, moved=trace.since(before))
    return out


@pytest.mark.parametrize("kind", ["dense", "verlet"])
def test_a_profiled_run_exports_the_spans_nested_as_documented(runs, kind):
    spans = [s for s in runs[kind]["spans"] if s[0].startswith("kmc.")]
    names = {s[0] for s in spans}
    want = {"kmc.stream.wait", "kmc.stream.parse", "kmc.stream.h2d", "kmc.block",
            "kmc.run_block", "kmc.stage1", "kmc.loop", "kmc.driver.post",
            "kmc.driver.emit", "kmc.sync.emit", "kmc.sync.init", "kmc.sync.stream_h2d"}
    if kind == "dense":
        want |= {"kmc.driver.ckpt"}
    else:
        want |= {"kmc.stage1.plan", "kmc.stage1.knn", "kmc.sync.supercell_h2d"}
    assert want <= names <= set(PARENTS)
    for s in spans:
        assert _parent(s, spans) in PARENTS[s[0]], s
    # the n-th block span holding a launch is block n; the last finds the end
    blocks = sorted((s for s in spans if s[0] == "kmc.block"), key=lambda s: s[1])
    launched = [b for b in blocks if any(_parent(s, spans) == "kmc.block" and
                                         b[1] <= s[1] <= b[2] for s in spans
                                         if s[0] == "kmc.run_block" and s[3] == b[3])]
    assert len(blocks) == 4 and launched == blocks[:3]
    # the reader's spans are on its own thread, the rest on the main thread
    main = {s[3] for s in spans if s[0] == "kmc.block"}
    reader = {s[3] for s in spans if s[0] == "kmc.stream.parse"}
    assert len(main) == len(reader) == 1 and main != reader
    # the Verlet schedule is decided on the device: stage 1 waits for nothing
    assert not any(s[0].startswith("kmc.sync.") and _parent(s, spans) == "kmc.stage1"
                   for s in spans)


@pytest.mark.parametrize("kind", ["dense", "verlet"])
def test_the_sync_counters_follow_the_transfer_schedule(runs, kind):
    """Three blocks: each block's rows fetched once, each block copied to
    the device once (and made a supercell there), one seeded start. Each
    block's launches end at its print frames; the Verlet schedule makes no
    transfer (one schedule launch a K4 launch on the card, none of either
    here) and rebuilds where the plain schedule over all the frames at once
    does."""
    moved, sim = runs[kind]["moved"], runs[kind]["sim"]
    syncs = {k[len("syncs."):]: v for k, v in moved.items() if k.startswith("syncs.")}
    want = {"emit": 3, "stream_h2d": 3, "init": 1}
    block = sim.cfg.engine.block_size
    launches = sum(len(list(sim._fused_spans(s, s + block))) for s in range(0, 3 * block, block))
    assert launches == 9
    if kind == "verlet":
        rebuilds = moved["verlet.rebuild_frames"]
        assert 2 <= rebuilds < 3 * block
        pos = torch.cat([donors for _, donors, _ in sim._blocks()])
        assert pos.shape[0] == 3 * block
        assert rebuilds == ts.topk_tables_verlet(sim.model, pos, True, None, 0)[4].sum()
        want.update(supercell_h2d=3)
        assert moved.get("launches.verlet_schedule", 0) == moved.get("launches.topk_sweep", 0)
    assert syncs == want
    assert (moved["blocks"], moved["frames"]) == (3, 3 * block)
    launches = "launches.topk_sweep" if kind == "verlet" else "launches.kmc_sweep_streamed"
    assert moved.get(launches, 0) == 0  # the CPU runs the plain versions


def test_no_span_encloses_the_consumer(tmp_path):
    """A range the consumer opens between two rows lies outside every
    kmc.* span of the main thread: no span stays open across a yield."""
    from torch.profiler import record_function

    sim = Simulation(_config(tmp_path, "dense"), device="cpu")

    def consume():
        for _ in sim.observable_rows():
            with record_function("consumer"):
                pass

    _, spans = _profiled(tmp_path / "trace.json", consume)
    consumer = [s for s in spans if s[0] == "consumer"]
    assert consumer
    for c in consumer:
        assert not any(s[0].startswith("kmc.") and s[3] == c[3] and s[1] <= c[1]
                       and c[2] <= s[2] for s in spans)


def test_a_span_without_a_profiler_is_the_shared_noop():
    assert trace.span("kmc.block") is trace.span("kmc.loop") is trace.NOOP
    with trace.span("kmc.block"), trace.span("kmc.block"):
        pass
    before = trace.snapshot()
    with trace.sync("test_site"):
        pass
    assert trace.since(before) == {"syncs.test_site": 1}


def test_a_run_without_a_profiler_never_opens_a_range(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    sim = Simulation(_config(tmp_path, "dense"), device="cpu")
    assert len(list(sim.observable_rows())) == 6


def test_closing_the_rows_ends_the_prefetch_thread(tmp_path):
    before = set(threading.enumerate())
    sim = Simulation(_config(tmp_path, "dense", blocks=8), device="cpu")
    rows = sim.observable_rows()
    next(rows)
    started = set(threading.enumerate()) - before
    assert started  # the reader runs
    rows.close()
    assert not [t for t in started if t.is_alive()]


def test_the_perf_line_reads_the_counters(tmp_path):
    sim = Simulation(_config(tmp_path, "dense"), device="cpu")
    out = io.StringIO()
    sim.run(out)
    perf = [ln for ln in out.getvalue().splitlines() if ln.startswith("# perf:")]
    assert len(perf) == 1
    line = perf[0]
    assert "from the first block's rows on" in line
    # a fetch of rows and a copy of positions a block, and the seeded start
    assert line.endswith(f", {7 / 3:.2f} host syncs/block")
    events = int(sim.final_states.replicas.clock.event_count.sum())
    rate = events / (sim.cfg.engine.replicas * 3 * sim.cfg.engine.block_size)
    assert f"{rate:.4f} events/replica-frame" in line


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "verlet"])
def test_every_sync_on_the_card_goes_through_the_marked_helper(tmp_path, kind):
    """Two blocks of the benchmark's deployment (dense: 144 sites, R=16384;
    the 2x2x2 supercell with Verlet reuse, R=4096) under sync debug mode
    "error": any blocking transfer outside trace.sync raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim = Simulation(_config(tmp_path, kind, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    before = trace.snapshot()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rows = list(sim.observable_rows())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    moved = trace.since(before)
    assert rows and moved["blocks"] == 2
    assert moved["syncs.emit"] == 2
    if kind == "verlet":  # the schedule kernel, once a K4 launch; no Verlet sync
        assert moved["launches.verlet_schedule"] == moved["launches.topk_sweep"] > 0
        assert not [k for k in moved if k.startswith("syncs.verlet")]
