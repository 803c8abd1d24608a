#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cmdlmc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing as it goes; any failure raises, so the run exits
nonzero without the final ``ok`` line:

1. environment: torch / CUDA versions, the card, its power limit;
2. build: every kernel in ``cmdlmc_tpu_torch/csrc/`` with nvcc for sm_90a;
3. RNG: the CUDA counter hash against the torch hash, bit for bit;
4. K2 (distance matrices) against its plain PyTorch version;
5. K1 (streamed event loop) against its plain version, stale off and on;
6. end to end: ``driver.run_from_config`` on a synthetic 144-site trajectory
   at the ``bench.py`` scale (96 protons, 16384 replicas, 256-frame blocks),
   plus a small run held against the same run on the CPU;
7. with ``--profile`` only: the end-to-end run traced with torch.profiler,
   fresh and stale rates (device busy and idle time, each kernel's share),
   and the host's xyz parse timed alone.

Before the last line it prints one JSON object with each kernel's launch
count in the end-to-end run, its error against the plain version and both
times, and the card's name and power limit as ``nvidia-smi`` reports them.
The last line is ``{"ok": true, "device": {...}}``. Generated inputs and the
end-to-end run's output go to ``cmdlmc_tpu_torch/_build/smoke/`` inside the
checkout.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# bench.py's deployment: the reference's integration scale
N_SITES, N_PROTONS, REPLICAS, BLOCK, MAX_EVENTS = 144, 96, 16384, 256, 4
BOX, FERMI, CUTOFF, BUFFER, DT = 14.5, (0.06, 2.3, 0.1), 3.0, 2.0, 0.5
PRINT_FREQ = 100  # the main path's launches span up to PRINT_FREQ frames
WORK = ROOT / "cmdlmc_tpu_torch" / "_build" / "smoke"


def say(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1):
    """Mean device time of fn() in ms over `reps` calls (CUDA events), and
    the last call's result."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def phase_rng(dev):
    import torch

    from cmdlmc_tpu_torch.ops import build, rng

    params = torch.tensor([
        [0, 0, 0, 0, 1], [1, 3, 17, 2, 3], [2**31 - 1, 5, 2**24 + 3, 7, 2],
        [-1, -5, -123456, 3, 1], [12345, 127, 1023, 1, 2], [7, 0, 255, 0, 3],
        [-2**31, 2**31 - 1, -1, 15, 1], [99, 42, 4096, 3, 3],
    ], dtype=torch.int32)
    m, n = params.shape[0], 1 << 17  # 8 keys x 131072 counters = 1M draws
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    keys = torch.empty(m, dtype=torch.int32, device=dev)
    p_dev = params.to(dev)
    lib = build.library()
    build.check(lib.cmdlmc_rng_fill(p_dev.data_ptr(), m, n, out.data_ptr(),
                                    keys.data_ptr(), build.stream_of(out), 0),
                "rng fill kernel")
    torch.cuda.synchronize()
    want_keys = torch.stack([rng.mix_key(*[int(x) for x in row]) for row in params])
    counters = torch.arange(n, dtype=torch.int64, device=dev)
    want = rng.u01_counter(want_keys.to(dev)[:, None], counters)
    got_keys = keys.cpu().to(torch.int64) & 0xFFFFFFFF
    if not torch.equal(got_keys, want_keys):
        raise AssertionError(f"mix_key differs: {got_keys} vs {want_keys}")
    diff = int((out.view(torch.int32) != want.view(torch.int32)).sum())
    if diff:
        raise AssertionError(f"u01 differs in {diff} of {m * n} draws")
    say(f"[rng] CUDA hash == torch hash bit for bit over {m} keys x {n} "
        f"counters ({m * n} draws)")


def phase_k2(dev):
    """K2 against pairwise_reference on the card, at the main path's launch
    shape [PRINT_FREQ, 144, 3] (timed there too), at N=144 with positions
    far outside the box, and at N=1152. Bound 2e-4, as the JAX package's
    tests/ops/test_pairwise.py has it."""
    import numpy as np
    import torch

    from cmdlmc_tpu_torch.ops.pairwise import pairwise_cubic, pairwise_reference

    def check(pos, box, label):
        got = pairwise_cubic(pos, box)
        want = pairwise_reference(pos, torch.tensor(box, device=dev))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        say(f"[k2] {label}: max |kernel - plain| = {err:.3e}")
        if not err <= 2e-4:
            raise AssertionError(f"K2 disagrees with its plain version: {err}")
        return err

    worst = 0.0
    for n, batch, box, lo, hi in ((N_SITES, 16, (BOX,) * 3, -5.0, 35.0),
                                  (1152, 2, (29.0,) * 3, -5.0, 35.0)):
        rng = np.random.RandomState(n)
        pos = torch.from_numpy(rng.uniform(lo, hi, size=(batch, n, 3))
                               .astype(np.float32)).to(dev)
        worst = max(worst, check(pos, box, f"N={n} B={batch}"))
    # the main path's launch shape: one print span of frames
    rng = np.random.RandomState(0)
    pos = torch.from_numpy(rng.uniform(0, BOX, size=(PRINT_FREQ, N_SITES, 3))
                           .astype(np.float32)).to(dev)
    box_t = torch.tensor((BOX,) * 3, device=dev)
    ms, got = cuda_ms(lambda: pairwise_cubic(pos, (BOX,) * 3), reps=50)
    plain_ms, want = cuda_ms(lambda: pairwise_reference(pos, box_t), reps=50)
    err = float((got - want).abs().max())
    say(f"[k2] [{PRINT_FREQ},{N_SITES},{N_SITES}] (main path's shape): "
        f"max |kernel - plain| = {err:.3e}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    if not err <= 2e-4:
        raise AssertionError(f"K2 disagrees with its plain version: {err}")
    return {"max_abs_err": max(worst, err), "ms": ms, "plain_ms": plain_ms}


def _k1_inputs(dev, replicas, frames, n=N_SITES, protons=N_PROTONS, box=BOX,
               seed=0):
    """Random bench-like state and a block of W from stage 1."""
    import numpy as np
    import torch

    from cmdlmc_tpu_torch.core.cell import Cell
    from cmdlmc_tpu_torch.engine.lattice import init_replicas
    from cmdlmc_tpu_torch.ops.kmc_sweep_streamed import dense_tables
    from cmdlmc_tpu_torch.rates.laws import Fermi
    from cmdlmc_tpu_torch.topo.models import PairRates

    rng = np.random.RandomState(seed)
    base = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    block = (base[None] + rng.normal(scale=0.03, size=(frames, n, 3))
             ).astype(np.float32)
    cell = Cell.cubic([box] * 3, device=dev)
    model = PairRates(cell, Fermi(a=FERMI[0], b=FERMI[1], c=FERMI[2]).to(dev),
                      CUTOFF, BUFFER)
    pos = torch.from_numpy(block).to(dev)
    ens = init_replicas(torch.Generator().manual_seed(seed), replicas, n,
                        protons, pos[0], device=dev)
    rep = ens.replicas
    return (dense_tables(model, pos), pos, ens.prev_pos, ens.site_disp,
            rep.occ, rep.proton_of_site.float(), rep.site_of_proton,
            rep.t_last_jump, rep.disp_base, rep.clock.u_remaining,
            rep.clock.event_count)


INT_KEYS = ("occ", "labels", "sites", "ev_count", "trunc")
STATE_KEYS = ("occ", "labels", "sites", "tlast", "disp_base", "u_rem", "ev_count")


def _agreeing(got, want):
    import torch

    same = torch.ones(got["occ"].shape[0], dtype=torch.bool, device=got["occ"].device)
    for k in INT_KEYS:
        a, b = got[k], want[k]
        same &= (a == b).reshape(a.shape[0], -1).all(dim=1)
    return same


# Kernel and plain version sum the rates in different orders, so a decision
# whose two outcomes lie within float32 rounding of each other can go either
# way; the replica then follows another, equally valid, trajectory. Such
# partings are counted per replica-frame (1e-4 allows the same one replica in
# R=1024 x B=16 as a 0.1% bound) and each must be a near-tie: its decision's
# relative margin below NEAR_TIE. A bug parts replicas at large margins.
PARTINGS_PER_REPLICA_FRAME = 1e-4
NEAR_TIE = 1e-4


def _smallest_margin(w, occ, u, frame_idx, tile_id, rin, kw):
    """Replay one replica's event iterations of one frame the plain way and
    return the smallest relative margin of any decision taken there (the
    clock test u <= budget; the gap between the best two candidates of the
    source and of the destination race) and the decision's name."""
    import torch

    from cmdlmc_tpu_torch.ops import rng

    n = occ.shape[0]
    f32 = torch.float32
    dt = torch.tensor(kw["dt"], dtype=f32, device=occ.device)
    phase = torch.zeros((), dtype=f32, device=occ.device)
    ctr = rin * n + torch.arange(n, device=occ.device)
    row0 = occ * ((1.0 - occ) @ w.T)
    total0 = row0.sum()
    best = (float("inf"), "none")

    def race(vals, ev, salt):
        key = rng.mix_key(kw["seed"], tile_id, frame_idx, ev, salt)
        e = 0.0 - torch.log(rng.u01_counter(key.to(occ.device), ctr))
        v = torch.where(vals > 0, vals / e, 0.0)  # as the plain version races
        top = torch.topk(v, 2).values
        return int(torch.argmax(v)), float((top[0] - top[1]) / top[0])

    for ev in range(kw["max_events"]):
        if kw.get("stale"):
            row, total = row0 * occ, total0
        else:
            row = occ * ((1.0 - occ) @ w.T)
            total = row.sum()
        budget = total * (dt - phase)
        if budget > 0:
            best = min(best, (float(abs(u - budget) / budget), f"clock, event {ev}"))
        if not (u <= budget and budget > 0):
            break
        eph = phase + u / total
        src, m = race(row, ev, 1)
        best = min(best, (m, f"source race, event {ev}"))
        dst, m = race(w[src] * (1.0 - occ), ev, 2)
        best = min(best, (m, f"destination race, event {ev}"))
        occ = occ.clone()
        occ[src] -= 1.0
        occ[dst] += 1.0
        key = rng.mix_key(kw["seed"], tile_id, frame_idx, ev, 3).to(occ.device)
        u = -torch.log(rng.u01_counter(key, torch.tensor(rin, device=occ.device)))
        phase = eph
    return best


def _partings(args, frame0, box, kw, cap=64):
    """Step every replica frame by frame through both versions from the plain
    version's state, and for each replica that parts in a frame (up to `cap`)
    give (replica, frame, smallest decision margin, decision)."""
    from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss

    w, pos, prev, s = args[:4]
    state = list(args[4:])
    tile = kw["tile"]
    found = []
    for f in range(w.shape[0]):
        call = (w[f:f + 1], pos[f:f + 1], prev, s, *state, frame0 + f, box, 0)
        got = kss.kmc_sweep_streamed(*call, **kw)
        want = kss.kmc_sweep_streamed_reference(*call, **kw)
        for r in (~_agreeing(got, want)).nonzero()[:, 0].tolist():
            if len(found) < cap:
                margin, what = _smallest_margin(
                    w[f], state[0][r], state[5][r], frame0 + f, r // tile,
                    r % tile, kw)
                found.append((r, f, margin, what))
        prev, s = want["prev_pos"], want["site_disp"]
        state = [want[k] for k in STATE_KEYS]
    return found


def _k1_check(label, args, got, want, frame0, box, kw) -> float:
    """Hold K1's outputs to its plain version's on the same inputs: replicas
    whose integer state differs at most PARTINGS_PER_REPLICA_FRAME per
    replica-frame, each parting at a near-tie, then the float state of the
    agreeing replicas to rtol 1e-5 (disp_base atol 1e-4). Returns the worst
    float error."""
    import torch

    same = _agreeing(got, want)
    n_diff = int((~same).sum())
    events = int(want["ev_count"].sum() - args[10].sum())
    replica_frames = same.numel() * args[0].shape[0]
    say(f"[k1] {label}: {n_diff} of {same.numel()} replicas differ in integer "
        f"state ({events} events in the plain run)")
    if n_diff > PARTINGS_PER_REPLICA_FRAME * replica_frames:
        raise AssertionError(
            f"K1 {label}: {n_diff} replicas differ, more than "
            f"{PARTINGS_PER_REPLICA_FRAME} per replica-frame")
    if n_diff:
        found = _partings(args, frame0, box, kw)
        worst_tie = max(m for _, _, m, _ in found) if found else float("inf")
        say(f"[k1]   frame-by-frame replay: {len(found)} partings; largest "
            f"decision margin among them {worst_tie:.3e} (near-tie bound "
            f"{NEAR_TIE})")
        for r, f, m, what in found[:5]:
            say(f"[k1]     replica {r}, frame {frame0 + f}: {what}, margin {m:.3e}")
        if not found or worst_tie >= NEAR_TIE:
            raise AssertionError(f"K1 {label}: replicas part away from a near-tie")
    if events == 0:
        raise AssertionError(f"K1 {label}: the comparison fired no events")
    worst = 0.0
    # u_rem is an O(1) draw minus an O(1) integrated rate: near zero its
    # float32 error is absolute, hence the atol beside the rtol
    for k, rtol, atol in (("u_rem", 1e-5, 1e-5), ("tlast", 1e-5, 1e-5),
                          ("disp_base", 0.0, 1e-4), ("site_disp", 1e-5, 1e-5),
                          ("prev_pos", 0.0, 0.0)):
        if k in ("site_disp", "prev_pos"):  # shared by all replicas
            a, b = got[k], want[k]
        else:
            a, b = got[k][same], want[k][same]
        err = float((a - b).abs().max())
        worst = max(worst, err)
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            raise AssertionError(f"K1 {label} {k} differs: max abs {err}")
    say(f"[k1] {label}: float state of agreeing replicas within tolerance "
        f"(max abs {worst:.3e})")
    return worst


def phase_k1(dev):
    """K1 against kmc_sweep_streamed_reference on the same W: at R=1024 with
    stale off and on; at N=256, where W[f] no longer fits in shared memory and
    the kernel reads it from global memory; and at the main path's launch
    shape (all replicas, one print span of frames), timed there too."""
    from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss

    box3 = (BOX,) * 3
    if not kss.w_in_shared_memory(N_SITES, dev):
        raise AssertionError(f"K1 at N={N_SITES} should stage W in shared memory")
    worst = 0.0
    for stale in (False, True):
        args = _k1_inputs(dev, replicas=1024, frames=16)
        kw = dict(tile=128, max_events=MAX_EVENTS, dt=DT, seed=1, stale=stale)
        got = kss.kmc_sweep_streamed(*args, 1000, box3, 0, **kw)
        want = kss.kmc_sweep_streamed_reference(*args, 1000, box3, 0, **kw)
        worst = max(worst, _k1_check(f"R=1024 B=16 stale={stale}", args, got,
                                     want, 1000, box3, kw))

    # the global-memory W path: N=256 at bench.py's site and proton density
    n_big = 256
    if kss.w_in_shared_memory(n_big, dev):
        raise AssertionError(f"K1 at N={n_big} should read W from global memory")
    box_big = BOX * (n_big / N_SITES) ** (1.0 / 3.0)
    args = _k1_inputs(dev, replicas=256, frames=8, n=n_big,
                      protons=N_PROTONS * n_big // N_SITES, box=box_big)
    for stale in (False, True):
        kw = dict(tile=128, max_events=MAX_EVENTS, dt=DT, seed=1, stale=stale)
        got = kss.kmc_sweep_streamed(*args, 0, (box_big,) * 3, 0, **kw)
        want = kss.kmc_sweep_streamed_reference(*args, 0, (box_big,) * 3, 0, **kw)
        worst = max(worst, _k1_check(
            f"N={n_big} (W from global memory) R=256 B=8 stale={stale}", args,
            got, want, 0, (box_big,) * 3, kw))

    # the main path's launch shape
    args = _k1_inputs(dev, replicas=REPLICAS, frames=PRINT_FREQ)
    kw = dict(tile=128, max_events=MAX_EVENTS, dt=DT, seed=1)
    ms, got = cuda_ms(lambda: kss.kmc_sweep_streamed(*args, 0, box3, 0, **kw),
                      reps=5)
    plain_ms, want = cuda_ms(
        lambda: kss.kmc_sweep_streamed_reference(*args, 0, box3, 0, **kw),
        reps=1)
    say(f"[k1] R={REPLICAS} B={PRINT_FREQ} N={N_SITES}: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms")
    worst = max(worst, _k1_check(
        f"R={REPLICAS} B={PRINT_FREQ} (main path's shape)", args, got, want,
        0, box3, kw))
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def write_inputs(workdir: Path, frames: int, replicas: int, sweeps=None,
                 stale: bool = False) -> Path:
    """Synthetic trajectory (seed 0, as bench.py builds it) and an INI."""
    import numpy as np

    workdir.mkdir(parents=True, exist_ok=True)
    traj = workdir / f"traj_{frames}.xyz"
    if not traj.exists():
        rng = np.random.RandomState(0)
        base = rng.uniform(0, BOX, size=(N_SITES, 3)).astype(np.float32)
        jit = (base[None] + rng.normal(scale=0.03, size=(frames, N_SITES, 3))
               ).astype(np.float32)
        lines = []
        for f in range(frames):
            lines.append(f"{N_SITES}\nframe {f}\n")
            lines.append("".join(f"O {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in jit[f]))
        tmp = traj.with_suffix(".tmp")
        tmp.write_text("".join(lines))
        tmp.replace(traj)
    cfg = workdir / f"run_{frames}_{replicas}{'_stale' if stale else ''}.ini"
    cfg.write_text(f"""[Trajectory]
filename = {traj}
time_step = {DT}
[AtomBox]
type = AtomBoxCubic
periodic_boundaries = {BOX}, {BOX}, {BOX}
[NeighborTopology]
type = NeighborTopology
donor_atoms = O
cutoff = {CUTOFF}
buffer = {BUFFER}
[JumpRate]
type = Fermi
a = {FERMI[0]}
b = {FERMI[1]}
c = {FERMI[2]}
[KMCLattice]
lattice_size = {N_SITES}
proton_number = {N_PROTONS}
time_step = {DT}
[Output]
type = ObservablesOutput
print_frequency = {PRINT_FREQ}
reset_frequency = 500
[Engine]
replicas = {replicas}
seed = 1
block_size = {BLOCK}
max_events_per_frame = {MAX_EVENTS}
{f"sweeps = {sweeps}" if sweeps else ""}
{"stale_rates = on" if stale else ""}
""")
    return cfg


def parse_rows(text: str):
    lines = text.splitlines()
    header = [ln for ln in lines if ln.startswith("#") and "Sweeps" in ln]
    rows = [ln.split() for ln in lines if ln.strip() and not ln.startswith("#")]
    perf = [ln for ln in lines if ln.startswith("# perf:")]
    return header, rows, perf


def phase_end_to_end(card: str):
    import numpy as np
    import torch

    from cmdlmc_tpu_torch import driver
    from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss
    from cmdlmc_tpu_torch.ops.pairwise import pairwise_cubic

    work = WORK
    # small run: the same config and initial state on the card and on the
    # CPU (plain versions) must land in the same final state
    small = write_inputs(work, frames=64, replicas=256)
    finals = {}
    for d in ("cuda", "cpu"):
        buf = io.StringIO()
        finals[d] = driver.run_from_config(small, out=buf, device=d).final_states
    a, b = finals["cuda"].replicas, finals["cpu"].replicas
    same = ((a.site_of_proton.cpu() == b.site_of_proton).all(dim=1)
            & (a.clock.event_count.cpu() == b.clock.event_count))
    n_diff = int((~same).sum())
    say(f"[e2e] small run (N={N_SITES}, R=256, 64 frames): {n_diff} of 256 "
        f"replicas end differently on cuda vs cpu; events "
        f"{int(a.clock.event_count.sum())} vs {int(b.clock.event_count.sum())}")
    if n_diff > 2:
        raise AssertionError("cuda and cpu runs of the small config disagree")

    cfg = write_inputs(work, frames=1024, replicas=REPLICAS)
    buf = io.StringIO()
    torch.cuda.synchronize()
    kss.kmc_sweep_streamed.launches = 0
    pairwise_cubic.launches = 0
    t0 = time.perf_counter()
    sim = driver.run_from_config(cfg, out=buf, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"kmc_sweep_streamed": kss.kmc_sweep_streamed.launches,
                "pairwise_cubic": pairwise_cubic.launches}
    text = buf.getvalue()
    (work / "e2e_output.txt").write_text(text)
    header, rows, perf = parse_rows(text)
    say(f"[e2e] launches in the main run: {launches}")
    if not header or header[0].split()[1:8] != [
            "Sweeps", "Time", "MSD_x", "MSD_y", "MSD_z", "Autocorr", "Jumps"]:
        raise AssertionError(f"bad header: {header}")
    if not rows or any(len(r) != 7 for r in rows):
        raise AssertionError("rows missing or not 7 columns")
    vals = np.array(rows, dtype=np.float64)
    if not np.isfinite(vals).all():
        raise AssertionError("non-finite values in the output rows")
    if not (vals[:, 5] <= N_PROTONS).all() or not (vals[:, 6] > 0).any():
        raise AssertionError("Autocorr > proton count or no jumps")
    if not perf:
        raise AssertionError("no '# perf:' line")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    ev = sim.final_states.replicas.clock.event_count
    say(f"[e2e] {len(rows)} rows, frames {int(vals[0, 0])}..{int(vals[-1, 0])}, "
        f"last Autocorr {vals[-1, 5]:.2f} Jumps {vals[-1, 6]:.2f}; "
        f"{int(ev.sum())} events in total")
    say(f"[e2e] {perf[0]}")
    say(f"[e2e] wall {wall:.2f} s for 1024 frames x {REPLICAS} replicas x "
        f"{N_SITES} sites ({card})")
    return launches


def _union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def phase_profile(card: str):
    """Where the end-to-end run's time goes: the bench.py deployment with
    fresh and with stale rates, each traced with torch.profiler after a warm
    run. Device busy time is the union of kernel and copy intervals in the
    trace; idle is the rest of the traced wall time. Also times the host's
    xyz parse of the same trajectory alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cmdlmc_tpu_torch import driver
    from cmdlmc_tpu_torch.io.xyz import XYZTrajectory

    write_inputs(WORK, frames=1024, replicas=REPLICAS)
    traj = WORK / "traj_1024.xyz"
    t0 = time.perf_counter()
    frames = sum(pos.shape[0] for _, pos, _ in XYZTrajectory(
        traj, time_step=DT, batch_frames=BLOCK).iter_batches())
    say(f"[profile] host xyz parse of {frames} frames x {N_SITES} atoms: "
        f"{time.perf_counter() - t0:.3f} s (numpy tokenizer, one thread)")
    for stale in (False, True):
        name = "stale" if stale else "fresh"
        cfg = write_inputs(WORK, frames=1024, replicas=REPLICAS, stale=stale)
        driver.run_from_config(cfg, out=io.StringIO(), device="cuda")  # warm
        torch.cuda.synchronize()
        buf = io.StringIO()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            driver.run_from_config(cfg, out=buf, device="cuda")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        trace = WORK / f"e2e_trace_{name}.json"
        prof.export_chrome_trace(str(trace))
        events = [e for e in json.loads(trace.read_text())["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and "dur" in e]
        if not events:
            raise AssertionError("the trace holds no device activity")
        busy = _union_us((e["ts"], e["ts"] + e["dur"]) for e in events) / 1e3
        k1 = sum(e["dur"] for e in events
                 if "kmc_sweep_streamed_kernel" in e["name"]) / 1e3
        k2 = sum(e["dur"] for e in events
                 if "pairwise_kernel" in e["name"]) / 1e3
        perf = [ln for ln in buf.getvalue().splitlines()
                if ln.startswith("# perf:")]
        say(f"[profile] {name} rates: traced wall {wall_ms:.2f} ms, device busy "
            f"{busy:.2f} ms, idle {100 * (1 - busy / wall_ms):.1f}%; K1 "
            f"{k1:.2f} ms ({100 * k1 / busy:.2f}% of busy), K2 {k2:.3f} ms "
            f"({100 * k2 / busy:.2f}%), other device work "
            f"{100 * (busy - k1 - k2) / busy:.2f}% ({card})")
        say(f"[profile] {name} rates: {perf[0] if perf else 'no perf line'}; "
            f"trace {trace}")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace the end-to-end run (fresh and stale "
                         "rates) with torch.profiler and print where the "
                         "device time goes")
    opts = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from cmdlmc_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    say(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    say(f"[env] nvidia-smi: {card}")

    t0 = time.perf_counter()
    build.library()
    info = build.build_info
    say(f"[build] {'built' if info['built'] else 'loaded'} {info['path']} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"[build]   {line.strip()}")

    phase_rng(dev)
    k2 = phase_k2(dev)
    k1 = phase_k1(dev)
    launches = phase_end_to_end(card)
    if opts.profile:
        phase_profile(card)

    kernels = [
        {"name": "kmc_sweep_streamed", "route": "cuda",
         "source": "cmdlmc_tpu_torch/csrc/kmc_sweep_streamed.cu",
         "replaces": "cmdlmc_tpu/ops/kmc_sweep_streamed.py:628",
         "launches": launches["kmc_sweep_streamed"], **k1},
        {"name": "pairwise_cubic", "route": "cuda",
         "source": "cmdlmc_tpu_torch/csrc/pairwise.cu",
         "replaces": "cmdlmc_tpu/ops/pairwise.py:55",
         "launches": launches["pairwise_cubic"], **k2},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
