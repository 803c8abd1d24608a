#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cmdlmc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing as it goes; any failure raises, so the run exits
nonzero without the final ``ok`` line:

1. environment: torch / CUDA versions, the card, its power limit;
2. build: every kernel in ``cmdlmc_tpu_torch/csrc/`` with nvcc for sm_90a,
   one nvcc per source, all at once;
3. RNG: the CUDA counter hash against the torch hash, bit for bit;
4. K2 (distance matrices) against its plain PyTorch version;
5. K1 (streamed event loop) against its plain version, stale off and on, at
   N=144 and N=256, with whole rows at N=256 (its lists in global memory),
   and every output against the SHA-256 digests recorded from the dense
   kernel before the row lists (PARENT_DIGESTS); timed at the main path's
   launch, with the launch plan (list lengths counted on the card, shared
   memory, where the lists live, blocks per SM) and the bound from the
   least work (`sweep_work`) beside the dense count;
6. K3 (in-kernel-W event loop) against its plain version for the law kinds
   0-4, with whole rows at N=224 (the route's largest N; the lists in
   global memory), and against the recorded digests; against stage 1 + K1
   on the same state, at 2-16 warps per block, and the two routes timed at
   8, 16 and 128 RNG tiles;
7. K5 (K-nearest tables) against its plain version at [B=100 and 256,
   N=144] and [B=64, N=4608], k=8, timed there; K6 (the same tables over a
   sparse plan) against its plain version and against K5 bit for bit at
   the box x4 path's rebuild launch [1, 9216], at [64, 9216] and, with the
   plan forced, [64, 4608], all timed there;
8. K4 (top-K event loop) against its plain version: TopKPairRates k=8 and
   HydroniumRates k=4 (ReLU, relaxation time 20, the blend in the loop) at
   R=4096, B=100, N=144; law kinds 1-3 and a triclinic cell at R=256, B=16;
   the supercells R=4096, B=16, N=4608, P=3072 and N=9216, P=6144, and
   N=14976 at R=256, B=4 (K4's state in global scratch); timed at R=4096;
9. the water tables (K5 with no cutoff, then the transform) bit for bit
   against their plain version at [256, 216] and [256, 1728]; K7 (the water
   event loop) against its plain version at the water path's shape (N=216,
   R=8192, RNG tiles of 256, the linear transform, keep_last,
   check_from_old, relaxation 10, d_OH 0.3) over 100 frames, and for the
   ramp, the 57-point table, n_atoms = 4 and a waiting time at R=1024,
   B=32; K7 timed at its path's launch (R=8192, B=256) at N=216 and N=1728;
10. end to end through ``driver.run_from_config`` on synthetic trajectories:
   the ``bench.py`` deployment (144 sites, 96 protons, 256-frame blocks) at
   16384 replicas (stage 1 + K1) and at 1024 (K3), the angle deployment of
   ``tools/bench_fused_variants.py`` (36 P atoms, FermiAngle) at 1024 (K3)
   and 4096 replicas (stage 1 + K1), that tool's top-K (k=8) and hydronium
   (k=4) deployments at 4096 replicas, and ``tools/bench_topk_e2e.py``'s
   supercell (4608 sites, 3072 protons, 4096 replicas; K5 + K4), and the
   box x4 supercell (bench.py's cell with box_multiplier = 4, 4, 4: 9216
   sites, 6144 protons, 4096 replicas, Verlet candidate reuse by the auto
   rule; K6 + K4), each with its own launch counts; before them small
   dense, angle, top-K, hydronium and box x2 reuse runs are held against
   the same runs on the CPU;
11. the water deployment of ``tools/bench_water.py`` end to end through the
   port's ``kmc_water`` main (K5 + K7): 216 O sites at 8192 replicas over
   1024 frames and 1728 sites (its 57-point conversion table) over 512
   frames, each with its own launch counts, wall time and site-updates/s;
   before them a small water run (R=64, 64 frames) whose rows on the card
   equal those on the CPU;
12. with ``--profile`` only: the R=16384 end-to-end run (fresh and stale
   rates), the two top-K supercell runs and the water N=216 run traced
   with torch.profiler (device busy and idle time, each kernel's share and
   the Verlet epilogue's; for each run the idle time before the first
   launch of its main kernel apart from the gaps between launches, and the
   host ranges that fill those gaps), and the host's xyz parse of the dense
   and water trajectories timed alone.

Before the last line it prints one JSON object with each kernel's launch
count in the end-to-end run of its path, its error against the plain
version, its time, its plain version's time and its bound, and the card's
name and power limit as ``nvidia-smi`` reports them.
The last line is ``{"ok": true, "device": {...}}``. Generated inputs and the
end-to-end run's output go to ``cmdlmc_tpu_torch/_build/smoke/`` inside the
checkout.
"""

from __future__ import annotations

import contextlib
import hashlib
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
# the angle deployment of tools/bench_fused_variants.py: N // 4 P atoms, each
# grouped with its 4 nearest O sites, FermiAngle with the bench.py Fermi
N_P, GROUP, THETA = N_SITES // 4, 4, 1.2
INKERNEL_REPLICAS = 1024  # 8 RNG tiles of 128: the in-kernel route
ANGLE_STREAMED_REPLICAS = 4096  # 32 tiles: the streamed route
# the top-K deployments of tools/bench_fused_variants.py at 4096 replicas:
# TopKPairRates k=8, and HydroniumRates k=4 with a ReLU transformation
# (a, b, d0, left, right) and the residence-time blend
TOPK_REPLICAS, TOPK_K, HYD_K = 4096, 8, 4
RELU, RELAX = (0.5, 2.2, 2.2, 2.0, 3.3), 20.0
# tools/bench_topk_e2e.py's supercell: 32x the sites at bench.py's density,
# frames a random walk of 0.004 A per frame and coordinate
SC_SITES, SC_PROTONS, SC_REPLICAS, SC_DRIFT = 4608, 3072, 4096, 0.004
SC_BOX = BOX * (SC_SITES / N_SITES) ** (1.0 / 3.0)
# the top-K supercell deployment with Verlet candidate reuse: bench.py's cell
# as a random walk of SC_DRIFT, replicated 4 x 4 x 4 by box_multiplier (9216
# sites, 6144 protons), max_neighbors = TOPK_K, [Engine] nbr_reuse left at
# its default (auto), R = SC_REPLICAS
BOX_MULT = (4, 4, 4)
BX_SITES, BX_PROTONS, BX_BOX = N_SITES * 64, N_PROTONS * 64, BOX * 4
# a site count past K4's shared-memory layout (16 N bytes > 232,448), so
# its global layout runs
WIDE_SITES = N_SITES * 104

# Published peaks of one H100 SXM (NVIDIA's data sheet, at its 700 W limit),
# for the least time the card could take for a kernel's work.
PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3
# Operations per pair (i, j) of one frame: the minimum-image distance is
# three minimum images (sub, div, rint, mul, sub), three squares, two adds
# and a square root (21); W adds the cutoff test and the Fermi law (sub,
# div, exp, add, div), 27 in all.
PAIRWISE_OPS, W_BUILD_OPS = 21, 27


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


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations over
    the float32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def sweep_work(w, P) -> dict:
    """The terms the event loop's least work adds, estimated from the
    frames' W [B, N, N] and averaged over the frames (with binary occupancy
    a term is one add):
    - `pairs`: a whole rate evaluation, the occupied x vacant pairs with
      W != 0: each frame's count of W != 0 scaled by P (N - P) / (N (N - 1)),
      the share of ordered pairs that join an occupied to a vacant site;
    - `vacant`: the vacant entries of one row, c (N - P) / (N - 1) with c the
      frame's nonzeros per row (also the destination race's candidates);
    - `rows`: the rows one event sums again, the occupied share P / N of
      |C_s u C_d u {s, d}| (C_j: the rows with W[i][j] != 0) averaged over
      the moves s -> d with W[s][d] != 0."""
    import torch

    n = w.shape[-1]
    m = (w != 0).to(torch.float32)
    col = m.sum(dim=1)  # [B, N]: |C_j|
    inter = m.transpose(1, 2) @ m  # [B, s, d]: |C_s n C_d|
    diag = torch.diagonal(m, dim1=1, dim2=2)  # W[j][j] != 0
    s_in = torch.clamp(diag[:, :, None] + m, max=1.0)  # s in C_s u C_d
    d_in = torch.clamp(m.transpose(1, 2) + diag[:, None, :], max=1.0)
    union = col[:, :, None] + col[:, None, :] - inter + (1 - s_in) + (1 - d_in)
    moves = m.sum(dim=(1, 2)).clamp(min=1)
    per_frame_union = (union * m).sum(dim=(1, 2)) / moves
    nnz = m.sum(dim=(1, 2))
    return {"pairs": float((nnz * P * (n - P) / (n * (n - 1))).mean()),
            "vacant": float((nnz / n * (n - P) / (n - 1)).mean()),
            "rows": float(per_frame_union.mean()) * P / n}


def sweep_bound(R, B, N, P, events, work, w_bytes=0.0, extra_flops=0.0,
                extra_bytes=0.0) -> dict:
    """Bound of an event-loop sweep over R replicas and B frames that fired
    `events` events with fresh rates, from :func:`sweep_work`: one whole
    rate evaluation per replica-frame (`pairs` adds); per event the rows it
    changes summed again (`rows` x `vacant` adds) and the N rows added to
    the total, and the two races over the P occupied sources and src's
    `vacant` columns, a log, a divide and a compare per candidate. Bytes:
    positions, W where it is read, and the replica state read once and
    written once."""
    flops = (work["pairs"] * R * B
             + (work["rows"] * work["vacant"] + N) * events
             + 3.0 * (P + work["vacant"]) * events + extra_flops)
    state = 4.0 * R * (2 * N + 5 * P + 2)  # occ, labels, sites, tlast, db, u, evc
    nbytes = (4.0 * B * N * 3 + w_bytes + 2 * state + 4.0 * R + 4 * 4.0 * N * 3
              + extra_bytes)
    return bound(flops, nbytes)


def dense_sweep_bound(R, B, N, P, events, w_bytes=0.0, extra_flops=0.0,
                      extra_bytes=0.0) -> dict:
    """The bound as it was counted before the row lists: every evaluation
    sums all N x N terms (a multiply and an add each), one evaluation per
    event plus one per replica-frame, and each event races 2N candidates (a
    log, a divide and a compare each)."""
    flops = 2.0 * N * N * (events + R * B) + 6.0 * N * events + extra_flops
    state = 4.0 * R * (2 * N + 5 * P + 2)
    nbytes = (4.0 * B * N * 3 + w_bytes + 2 * state + 4.0 * R + 4 * 4.0 * N * 3
              + extra_bytes)
    return bound(flops, nbytes)


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
    # no single PyTorch call computes minimum-image distances (torch.cdist
    # has no periodic images)
    return {"max_abs_err": max(worst, err), "ms": ms, "plain_ms": plain_ms,
            **bound(PAIRWISE_OPS * PRINT_FREQ * N_SITES ** 2,
                    4.0 * PRINT_FREQ * N_SITES * (N_SITES + 3)),
            "library_ms": None}


def _k1_inputs(dev, replicas, frames, n=N_SITES, protons=N_PROTONS, box=BOX,
               seed=0, fermi=FERMI, cutbuf=(CUTOFF, BUFFER)):
    """Random bench-like state and a block of W from stage 1 (Fermi `fermi`
    within cutoff + buffer `cutbuf`)."""
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
    model = PairRates(cell, Fermi(a=fermi[0], b=fermi[1], c=fermi[2]).to(dev),
                      *cutbuf)
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


def _agreeing(got, want, int_keys=INT_KEYS):
    import torch

    first = got[int_keys[0]]
    same = torch.ones(first.shape[0], dtype=torch.bool, device=first.device)
    for k in int_keys:
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


def _partings(n_frames, state0, step, margin, keys=STATE_KEYS, cap=64,
              int_keys=INT_KEYS):
    """Step every replica frame by frame through a kernel and its plain
    version from the plain version's state (``step(f, prev, s, state)``
    returns both outputs for frame f alone; ``state`` in the order of
    ``keys``), and for each replica that parts in a frame (up to `cap`) give
    (replica, frame, smallest decision margin, decision) from
    ``margin(f, state, r)``."""
    prev, s = state0[:2]
    state = list(state0[2:])
    found = []
    for f in range(n_frames):
        got, want = step(f, prev, s, state)
        for r in (~_agreeing(got, want, int_keys)).nonzero()[:, 0].tolist():
            if len(found) < cap:
                found.append((r, f, *margin(f, state, r)))
        prev, s = want["prev_pos"], want["site_disp"]
        state = [want[k] for k in keys]
    return found


def _dense_margin(w, frame0, kw):
    """``margin`` of :func:`_partings` for the dense loop over W [B, N, N]."""
    tile = kw["tile"]
    return lambda f, st, r: _smallest_margin(w[f], st[0][r], st[5][r],
                                             frame0 + f, r // tile, r % tile, kw)


# (key, rtol, atol) of the float state held by _hold: u_rem is an O(1) draw
# minus an O(1) integrated rate, so near zero its float32 error is absolute,
# hence the atol beside the rtol
DENSE_FLOATS = (("u_rem", 1e-5, 1e-5), ("tlast", 1e-5, 1e-5),
                ("disp_base", 0.0, 1e-4), ("site_disp", 1e-5, 1e-5),
                ("prev_pos", 0.0, 0.0))


def _hold(tag, label, got, want, ev0, n_frames, replay, int_keys=INT_KEYS,
          floats=DENSE_FLOATS) -> float:
    """Hold a kernel's outputs to its plain version's on the same inputs:
    replicas whose integer state differs at most PARTINGS_PER_REPLICA_FRAME
    per replica-frame, each parting at a near-tie (``replay()`` finds the
    partings frame by frame), then the float state of the agreeing replicas
    to rtol 1e-5 (disp_base atol 1e-4). Returns the worst float error."""
    import torch

    same = _agreeing(got, want, int_keys)
    n_diff = int((~same).sum())
    events = int(want["ev_count"].sum() - ev0.sum())
    replica_frames = same.numel() * n_frames
    say(f"[{tag}] {label}: {n_diff} of {same.numel()} replicas differ in "
        f"integer state ({events} events in the plain run)")
    if n_diff > PARTINGS_PER_REPLICA_FRAME * replica_frames:
        raise AssertionError(
            f"{tag} {label}: {n_diff} replicas differ, more than "
            f"{PARTINGS_PER_REPLICA_FRAME} per replica-frame")
    if n_diff:
        found = replay()
        worst_tie = max(m for _, _, m, _ in found) if found else float("inf")
        say(f"[{tag}]   frame-by-frame replay: {len(found)} partings; largest "
            f"decision margin among them {worst_tie:.3e} (near-tie bound "
            f"{NEAR_TIE})")
        for r, f, m, what in found[:5]:
            say(f"[{tag}]     replica {r}, frame {f}: {what}, margin {m:.3e}")
        if not found or worst_tie >= NEAR_TIE:
            raise AssertionError(f"{tag} {label}: replicas part away from a near-tie")
    if events == 0:
        raise AssertionError(f"{tag} {label}: the comparison fired no events")
    worst = 0.0
    floats = list(floats)
    if "tlast_site" in want:
        floats.append(("tlast_site", 1e-5, 1e-5))
    for k, rtol, atol in floats:
        if k in ("site_disp", "prev_pos"):  # shared by all replicas
            a, b = got[k], want[k]
        else:
            a, b = got[k][same], want[k][same]
        err = float((a - b).abs().max())
        worst = max(worst, err)
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            raise AssertionError(f"{tag} {label} {k} differs: max abs {err}")
    say(f"[{tag}] {label}: float state of agreeing replicas within tolerance "
        f"(max abs {worst:.3e})")
    return worst


def _k1_check(label, args, got, want, frame0, box, kw) -> float:
    """K1 held to its plain version (``args`` as the sweep takes them)."""
    from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss

    w, pos = args[:2]

    def step(f, prev, s, state):
        call = (w[f:f + 1], pos[f:f + 1], prev, s, *state, frame0 + f, box, 0)
        return (kss.kmc_sweep_streamed(*call, **kw),
                kss.kmc_sweep_streamed_reference(*call, **kw))

    return _hold("k1", label, got, want, args[10], w.shape[0],
                 lambda: _partings(w.shape[0], args[2:], step,
                                   _dense_margin(w, frame0, kw)))


OUT_KEYS = ("occ", "labels", "sites", "tlast", "disp_base", "u_rem",
            "ev_count", "site_disp", "prev_pos", "trunc")


def _digests(out) -> dict:
    """SHA-256 of each output of a dense sweep (K1, K3), over its bytes."""
    return {k: hashlib.sha256(out[k].detach().cpu().contiguous().numpy()
                              .tobytes()).hexdigest() for k in OUT_KEYS}


# SHA-256 of every output of K1 and K3 at the fixed-seed cases of phase_k1
# and phase_k3, recorded on an NVIDIA H100 80GB HBM3 from the kernels as
# they were before the sparse event loop (dense W staged in shared memory,
# or read from global memory where it did not fit, every row summed over
# every column). The kernels must reproduce them bit for bit.
PARENT_DIGESTS = {
    "R=1024 B=16 stale=False": {
        "occ": "1620b08d8aa9a242b976c9646c260b53b3167597eff56db4230613678a770e07",
        "labels": "2c97c1d7b7f84199eb4d9fd8e931d5675d757b8471a657b941980d9b35f14b0b",
        "sites": "8ff5cbf1911f9f254e7cab94111bab651dcd38e5c02ad2b54d8a6e077fe0281e",
        "tlast": "ea7f9a241df41c9874d4b00b8c44b806de21c26f5bcbb9ea16382612870a6b1c",
        "disp_base": "b41389ffddb60dbee09ec0b70dcacf2d4a38eb93f24f4a59446a96f68163440d",
        "u_rem": "1cd13f30c3d7b7ea5c4044e5f318df79575d9a3f7c42a47f36061c15e90e2b22",
        "ev_count": "840bcdb64e785b594e06f85df3fac447caa366b60dbdf2a3bac276759e663c77",
        "site_disp": "4b6e62530bb6fd53f02663b089dd417d62655273b3483f4f3daf3d87984b9641",
        "prev_pos": "7489e880640af4a3fbd515bee0d8731b19241a3aba4413dd0adca489a23d6420",
        "trunc": "63c88a25bd280c466d49fe294bc6c397e9c1d03dda2a52a1a24913021935ed35",
    },
    "R=1024 B=16 stale=True": {
        "occ": "8f01eb9e10b52cca43f0d2c1d3c09766f280ea4cfd9f85d2e1f549ca01c5f712",
        "labels": "e078f2e126ea5a08ad8ad2471e541e9f80ac7ef87fa9b12deaefbe8027d1e82d",
        "sites": "10a6311f671419e8e4ad1b3b2b0954414df69e6224bb3b3b0087f0b023dea9e5",
        "tlast": "7c933a2d72bd5533d2615377db72433b3cdd77d297e7e6e8f2570b398db0dddd",
        "disp_base": "ff5577eab42c2e67f75ac63d74f688e83d28fb60691e20b59b9512d1e10d4f71",
        "u_rem": "00d5421398499f5a116a61c22d7576a35810f108abb6461da2aae64b7e46dbf6",
        "ev_count": "2056079f2d3bee94373a1bb409dc9cd663ead58bde2a2743237edbe197fc7640",
        "site_disp": "4b6e62530bb6fd53f02663b089dd417d62655273b3483f4f3daf3d87984b9641",
        "prev_pos": "7489e880640af4a3fbd515bee0d8731b19241a3aba4413dd0adca489a23d6420",
        "trunc": "17cbc7989438b789cac2289d50832cf346653843d4ed3f4ade34d57c55333c9e",
    },
    "N=256 R=256 B=8 stale=False": {
        "occ": "ff8df86daef26d7334b07974904c0dcae897cb768afc0caaa3cb076b40206363",
        "labels": "e248b7cc26faa690611012eec27612461e8b3c1b2a1a4529d7e5beb1c88a6cdb",
        "sites": "b2a34af7416c3abe28b1d6f7454660f8a14828e39e14e194c507966aecfc0709",
        "tlast": "6cb977733a7f4dcc3a2e89c8bc57beaaf9012e2e165994a80a7cc44001e8f10c",
        "disp_base": "7b545f1b3f4f569703b4f7ef8060c4252fba0f5c225ac70fbaf2408416f6594e",
        "u_rem": "e27a785731c08337954c4d695afcbeba85d7a0d6dd25c1340da2626225c35bfa",
        "ev_count": "eeda06ba6f568ae61ccbe2adb29c1b76f6ee63641842688d7eaab3c07422d3bc",
        "site_disp": "55fa7a87dc14f320bc17c45fb7fd37f41622750efd58addffa47dcee84782447",
        "prev_pos": "a47e41143e06f7c1b26f94d9e278570581122ea041b6b31482243704d09e47da",
        "trunc": "a41ed4e76c708fa912b3f20d1c62d4ee9d89f0bd29098e3e4712d8588675a5d9",
    },
    "N=256 R=256 B=8 stale=True": {
        "occ": "f1881e4062f8b70186777990afa4a159b7f31a035ae96b2832dd051549e128de",
        "labels": "93d007d68a84791543db9dfacc6f90fac562fa15172b0b7848dd568a4516e75e",
        "sites": "331dccd4f2ead07a48d9b8a9f5618b19e554259ae65d15e34a68867f6b4d6864",
        "tlast": "e4f18b16a01e6502d03fb82d59636205cf7f3341cd4727c8557bffda4178783c",
        "disp_base": "483993a29b542cfeea8bdd22bba1c046f587e1ffb0985ebf2506e355318e34a9",
        "u_rem": "bfdfb2f6e3a6c51989cb5aff0ec7065a2b84f3828c94e8425e32f50a4f168133",
        "ev_count": "1488492fb1ea5d36f049d8bc07d9e674657b8b60163de2a4046d05ebff0ea6cd",
        "site_disp": "55fa7a87dc14f320bc17c45fb7fd37f41622750efd58addffa47dcee84782447",
        "prev_pos": "a47e41143e06f7c1b26f94d9e278570581122ea041b6b31482243704d09e47da",
        "trunc": "2acc261a9ab3c3b422458a54ffb04dda0692580f17626f73d663f3032cac9310",
    },
    "R=16384 B=100 (main path's shape)": {
        "occ": "41ad9bcacbf5c099f3d6abbe575e4ca2f99b91e64ae4c188df686fa948e3ae31",
        "labels": "79f07551ab8b418d7eb763574dd6529f3c1e3c11ff7f88d02ff2db712fe437fb",
        "sites": "e49b1b918d0cb59c5dd2755ede3b99a3b6e0b3f454d58d75a6698ced870126f5",
        "tlast": "b192daff0859b7abcfe31167e5fd34d964acfa237c2208d4282fb7c7afb2261f",
        "disp_base": "7f128f30aaec6362f74c516dc72e65adb95e80caaccf47ee153a251d56f8fa45",
        "u_rem": "72828745bd540374fc881197f559a6ea137d3acb633b6aa4b9ef7e826cfe3ecc",
        "ev_count": "c90229eef841749a76c4476cd01e0f052cd09dc7750d6168fae618c208305ba2",
        "site_disp": "219488ef119c6bc8619451f4c8935cdb22a283d5a9bccc149251a5516c5b35aa",
        "prev_pos": "2569e7a6e8dadc5f10afad1cdcd349684f42ab11a6ab2cbcb1fd5709444fdbd9",
        "trunc": "61c89faf7ede6e9aa3b2d0ead71b6a1628ba74a8ed10233889d11fa198d76a8e",
    },
    "kind 0 R=1024 B=100": {
        "occ": "29df896f424378aee753cb6a99eacdd5e1920b199822a36ecbfcf59bed9b742e",
        "labels": "edb9990d1d3b3e4f3128204c5f3e32115265f5f661c200a07b669ce5b01924a9",
        "sites": "aa70916d511946e68e9cd6b2443aa5469788d8b52d163e124c87dc60f2c9fd85",
        "tlast": "7a5bc86b46699aa7519b0222a6eafbd4ee222b7f90c04fd29bf59b4a045a7882",
        "disp_base": "735cf30424889509a522800bfac5309e6b8b74bb212042a49c2ca02827669c23",
        "u_rem": "82b47cf54c3ed6c52231be51ccfa76bf744a53ab468e03e8501ed00a4843a25f",
        "ev_count": "12713b788a1a4334acb724ff2488b3516de751c8c8ea6c3d2c8d171f9e04cccd",
        "site_disp": "91894c7efdfe9e71a7fd24c2b5351df92721aef46c5b3dddf793ee5f1c26f870",
        "prev_pos": "4a777dce842b6b16f2b86a4906cf9aa6a1846b67192099d168b775a68fa07749",
        "trunc": "9ea05764aa634d44ffeb98a088b35a8398d6915d55e92874f9669257f6890e28",
    },
    "kind 4 R=1024 B=100": {
        "occ": "b56414762d705c9b762270182b705b05632421d6115fd09b699aeaa5ca6ede17",
        "labels": "89c20acad781507397743791765762b7c643a0f81e71ce98863385aea23aeb35",
        "sites": "7fe407e3bb0dab607ae7746f3e6c1887848260b2d3ed48987c2249b2c4815c66",
        "tlast": "09fbe09000dd4421dd1e8a12b17863a28839b8c5656a1a9f0dcfaf8e1499a453",
        "disp_base": "53a5789c1c413e0f4856ad3a2dd3ccf5cc14a334cb8badd6d751cd07d6cf1fc5",
        "u_rem": "d8f826490ded9d4552eefa6c048722c5982e6c39146d9834d37d3f90be9a8dbc",
        "ev_count": "95bcd52c12fdc85acff0a47196dac2058effd05fc939dfb930967d3d74de81ff",
        "site_disp": "91894c7efdfe9e71a7fd24c2b5351df92721aef46c5b3dddf793ee5f1c26f870",
        "prev_pos": "4a777dce842b6b16f2b86a4906cf9aa6a1846b67192099d168b775a68fa07749",
        "trunc": "eba9bf2f0f1cdb6707e550ae28b267eacad03b6f207324af4f5bf89d0ff822c0",
    },
    "kind 1 R=256 B=16": {
        "occ": "a8ff1ec635478cbdcae76a0f8b4846daafee462bf354f9437f98b741db0e3810",
        "labels": "30c0ac222aa0ffd915aa57c47646d64a631c7f1749a619280a4cff99b3c06b7e",
        "sites": "8b7a087aeac4825d005c4cce8f7ff6a3d3f09ab73c43db2086648a4f7aeb8197",
        "tlast": "a84f075fb7b485aaa216dee8aad24c0a3f21cbdc569ed2d162f962e6047ccdfe",
        "disp_base": "435ecc6abdee6ac5a9043c243141b7411e0689430168f733e61432fc1560a076",
        "u_rem": "da35e1adb9b0496f23ee94834ed16e9141db2733b10c72e016a85dc3d2ca2330",
        "ev_count": "ecbb3c9e92e2dfa802fc15ab7a693cb04fc93b7d85d279001b02c4ac10571758",
        "site_disp": "ca035e1806aa5fd86723ce3838e133a5deefff2775a03628306fe5dd37ad3563",
        "prev_pos": "270a72a890069846f549badabeefd5c9a04f04dcd0a4a03e0800f090bbdc9528",
        "trunc": "fae2144922750e28f3c3fb4395da381df86972d8ed6518120561543fe2ec854d",
    },
    "kind 2 R=256 B=16": {
        "occ": "07a2d735cf36b2a060b3ad8c917c97993f6d20b1f080740d30b02bafad8a4ec1",
        "labels": "9ce6d8cff0d41f9447e92b98e848af429966c5ea996491931005c8c8ee9499c3",
        "sites": "7a92080aa55685611a9044340ea1ca96608f8445e51340acca1d3bfdd5a92477",
        "tlast": "3ca5d407811d700d84f69b1743bde09670d435fd448ad6c06c87279459a470a5",
        "disp_base": "822199e43f0a963387d1c9c3acc6452e366f0e865ea69587be71110f7939e3a6",
        "u_rem": "ba1fa444b90cc51aaad656d0286593b5615b7d603fb838aa145ca3c1fc4325fe",
        "ev_count": "a5d65384467b813722508e3b908b6faec33cd83e9533b411ff93e46deb001fd6",
        "site_disp": "ea95879c2eb037ba775846e8a01125e972ceef40c02a50a6cf43b03d9ea633ce",
        "prev_pos": "35b614de4f12e5c343a229eff1ba3273bbb757efd5b02b91dee747adf8754ad8",
        "trunc": "f2668f88710d07f95848938d4c2f736732470950d12ce49b3bcc69ff62dc2ce8",
    },
    "kind 3 R=256 B=16": {
        "occ": "5bdc039e35b7c5c7f8f25f19a3b20ccdf707c751312c459939cccfd7887e02a1",
        "labels": "cb4b706e031869b0a6c7e9ab707adcda4985285f1cccb40129b8d30c734d29a4",
        "sites": "c73d4d41269cdc60dcfec5ee8828925dbe8d2b0c5732bcf51ffb0067e79e4fb4",
        "tlast": "6fe2086aad677071d479849b5353fce81fc2acd84e5ec2ea1c263f90aa8501b0",
        "disp_base": "1b47b1898be920f731374c2fc7bfd5f281eeb6a3a9a2449c2056ffb338e1cf29",
        "u_rem": "20085e77087b92bd02a38b676b6c3c8ee31241edf3e210fe8b6682464a0b1dcc",
        "ev_count": "760ab46aa0a02fbf9e63cee9072fdd89a7233e2bfd25ac2ec4c52fb118494926",
        "site_disp": "75dea189b7e416745f54aa2a640275984920a7b7369b264641c8e0e1a3cdce62",
        "prev_pos": "beb5cd907e2985ffd4c95c1c4e5925aa3b77a24aec68e9a3af721e68158063b0",
        "trunc": "410d3d5762be78783127f8e1ec6213d0c7038719d968500f9ba2ef92b59782c6",
    },
    "whole rows N=256 R=256 B=8": {
        "occ": "477b13a240fe26b71d30bd5cc3f2483648718a6819c6e1f5744be0c0a2b15a90",
        "labels": "bf28380063785b5feafbda0d95ebd9b2463d9dae1b525bc5c8ee7296b3171139",
        "sites": "5ab8fea65d625c7924e408503e023362c35582e1a9d9261bfd3219ab4e5dc98a",
        "tlast": "70a9cd58e970136b0e4e3dc15157a232c6aacbf22712123ba52a0e7eb95e9450",
        "disp_base": "c7e44836e7f1aa8fafa9e0f3f23cdd2ac5f659f9ecfa04ed017842048edf12ae",
        "u_rem": "8187295f91dbbc304fa7d92b6f7273943bf440aa7f4b4ebfd45184705317edfe",
        "ev_count": "beef046723ad173a6c06369bd057e32abe4269b3ab7ed2c5a8058173efbca3f4",
        "site_disp": "55fa7a87dc14f320bc17c45fb7fd37f41622750efd58addffa47dcee84782447",
        "prev_pos": "a47e41143e06f7c1b26f94d9e278570581122ea041b6b31482243704d09e47da",
        "trunc": "5e0f2c20d0242531c7aa78e02ebf9933fb0d1998aa4e4df88967a349bea46933",
    },
    "whole rows kind 0 N=224 R=256 B=8": {
        "occ": "bb2a9cf39eb2625061c31cacebd17cb98b360ac1ce2eb3e62e7fcd0938501d45",
        "labels": "8b08b793ecbaefe3ab3c36a90915261960d7bd40d59b61f8066fe462f800bf6e",
        "sites": "451625392b052a086a52d2a10ef8dd46aa5d4c874fdbabb5bd7225c2869b56ae",
        "tlast": "3325176303113636d62b545340ac220867728d3db6a7dc500fd6d6dfe89994b2",
        "disp_base": "052424e843a1aec5caeed22e9ecdb8c2d835b801ed0956503ca560a478dc5b6d",
        "u_rem": "e1dd95637a7b82443792277aea4dba2689e274cf115a65977923417aa914b53b",
        "ev_count": "3a5fce006b504ea1569424645183ac99cd73a59d2ea87133add28bf5f9976d94",
        "site_disp": "c58fca0a8b98ffb8565837594b617b4470d400298e14285645112c8e3091b9f5",
        "prev_pos": "d3a1650edfdbcade9a79186e827c3ab783df9e1da0495385319fc91b7e38d050",
        "trunc": "9263ddfed709dc5114353840d120ed8bf0f37959391058076ad03bb3f983fe09",
    },
}


def _same_bits(tag, label, out):
    """Hold a sweep's outputs to PARENT_DIGESTS[label], output by output."""
    got = _digests(out)
    want = PARENT_DIGESTS.get(label)
    if want is None:
        raise AssertionError(f"{tag} {label}: no recorded digest")
    differ = [k for k in OUT_KEYS if got[k] != want[k]]
    if differ:
        raise AssertionError(f"{tag} {label}: outputs {differ} differ from the "
                             "recorded digests")
    say(f"[{tag}] {label}: all {len(OUT_KEYS)} outputs equal the recorded "
        "digests bit for bit")


# Whole rows: cutoff + buffer past half the box diagonal and a Fermi law
# that stays above float32's smallest number there, so every pair has a
# rate and every list is the whole row (too long for shared memory)
WHOLE_FERMI = (FERMI[0], FERMI[1], 0.5)


def _k1_cases(dev):
    """K1's fixed-seed cases: (label, sweep args, frame0, box, kw). R=1024
    with stale off and on; N=256 (the size whose dense W did not fit in
    shared memory) with stale off and on; N=256 with whole rows; and the
    main path's launch shape (all replicas, one print span of frames)
    last."""
    box3 = (BOX,) * 3
    cases = []
    args = _k1_inputs(dev, replicas=1024, frames=16)
    for stale in (False, True):
        kw = dict(tile=128, max_events=MAX_EVENTS, dt=DT, seed=1, stale=stale)
        cases.append((f"R=1024 B=16 stale={stale}", args, 1000, box3, kw))
    n_big = 256
    box_big = BOX * (n_big / N_SITES) ** (1.0 / 3.0)
    args = _k1_inputs(dev, replicas=256, frames=8, n=n_big,
                      protons=N_PROTONS * n_big // N_SITES, box=box_big)
    for stale in (False, True):
        kw = dict(tile=128, max_events=MAX_EVENTS, dt=DT, seed=1, stale=stale)
        cases.append((f"N={n_big} R=256 B=8 stale={stale}", args, 0,
                      (box_big,) * 3, kw))
    args = _k1_inputs(dev, replicas=256, frames=8, n=n_big,
                      protons=N_PROTONS * n_big // N_SITES, box=box_big,
                      fermi=WHOLE_FERMI, cutbuf=(box_big, 0.0))
    kw = dict(tile=128, max_events=MAX_EVENTS, dt=DT, seed=1)
    cases.append((f"whole rows N={n_big} R=256 B=8", args, 0, (box_big,) * 3, kw))
    args = _k1_inputs(dev, replicas=REPLICAS, frames=PRINT_FREQ)
    kw = dict(tile=128, max_events=MAX_EVENTS, dt=DT, seed=1)
    cases.append((f"R={REPLICAS} B={PRINT_FREQ} (main path's shape)", args, 0,
                  box3, kw))
    return cases


def _plan_text(plan, caps) -> str:
    return (f"rows and columns of up to {tuple(caps)} entries; block of "
            f"{plan['warps']} warps, {plan['smem']} bytes of shared memory "
            f"({plan['list_budget']} for lists; the lists in "
            f"{'shared' if plan['lists_in_smem'] else 'global'} memory), "
            f"{plan['blocks_per_sm']} blocks per SM")


def phase_k1(dev):
    """K1 against kmc_sweep_streamed_reference on the same W, and against
    the recorded digests, at every case of :func:`_k1_cases` (the whole-row
    case must put its lists in global memory); the main path's launch shape
    timed too."""
    from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss

    worst = 0.0
    *small, main = _k1_cases(dev)
    for label, args, frame0, box, kw in small:
        n = args[1].shape[1]
        caps = kss.list_caps(args[0]).tolist()
        plan = kss.launch_plan(n, caps, dev)
        say(f"[k1] {label}: {_plan_text(plan, caps)}")
        if label.startswith("whole rows") and (
                caps != [n - 1, n - 1] or plan["lists_in_smem"]):
            raise AssertionError(f"K1 {label}: not whole rows in global memory")
        got = kss.kmc_sweep_streamed(*args, frame0, box, 0, **kw)
        want = kss.kmc_sweep_streamed_reference(*args, frame0, box, 0, **kw)
        _same_bits("k1", label, got)
        worst = max(worst, _k1_check(label, args, got, want, frame0, box, kw))

    label, args, frame0, box3, kw = main
    ms, got = cuda_ms(lambda: kss.kmc_sweep_streamed(*args, 0, box3, 0, **kw),
                      reps=5)
    plain_ms, want = cuda_ms(
        lambda: kss.kmc_sweep_streamed_reference(*args, 0, box3, 0, **kw),
        reps=1)
    caps = kss.list_caps(args[0]).tolist()
    plan = kss.launch_plan(N_SITES, caps, dev)
    say(f"[k1] R={REPLICAS} B={PRINT_FREQ} N={N_SITES}: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms; {_plan_text(plan, caps)}")
    _same_bits("k1", label, got)
    worst = max(worst, _k1_check(label, args, got, want, 0, box3, kw))
    events = int(want["ev_count"].sum() - args[10].sum())
    work = sweep_work(args[0], N_PROTONS)
    w_bytes = 4.0 * PRINT_FREQ * N_SITES ** 2
    b = sweep_bound(REPLICAS, PRINT_FREQ, N_SITES, N_PROTONS, events, work,
                    w_bytes=w_bytes)
    dense = dense_sweep_bound(REPLICAS, PRINT_FREQ, N_SITES, N_PROTONS, events,
                              w_bytes=w_bytes)
    say(f"[k1] bound {b['bound_ms']:.4f} ms ({b['bound_by']}; {events} events; "
        f"{work['pairs']:.1f} occupied x vacant pairs with W != 0 per whole "
        f"evaluation, {work['rows']:.2f} rows of {work['vacant']:.2f} vacant "
        f"terms summed again per event); counting every pair, "
        f"{dense['bound_ms']:.4f} ms")
    # no single PyTorch call runs this event loop
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": None}


def _k3_law(kind):
    """The law of each kind at the bench.py site density: Fermi and
    FermiAngle are bench.py's; the others are set to fire about one event
    per replica-frame."""
    from cmdlmc_tpu_torch.rates import laws

    a, b, c = FERMI
    return {0: lambda: laws.Fermi(a=a, b=b, c=c),
            1: lambda: laws.Constant(a=0.004),
            2: lambda: laws.Exponential(a=0.5, b=-2.0),
            3: lambda: laws.ActivationEnergy(A=0.04, a=1.6, b=0.6, d0=2.0, T=500.0),
            4: lambda: laws.FermiAngle(a=a, b=b, c=c, theta=THETA)}[kind]()


def _k3_inputs(dev, replicas, frames, kind, seed=0, n=N_SITES,
               protons=N_PROTONS, box=BOX, whole=False):
    """Positions of a block (and for kind 4 each donor's grouped P atom),
    a model of the deployment, and random bench-like replica state
    [prev, s, occ, labels, sites, tlast, disp_base, u, evc]. With `whole`
    (kind 0): the WHOLE_FERMI law within a cutoff of the box length, so
    every pair is in range."""
    import numpy as np
    import torch

    from cmdlmc_tpu_torch.core.cell import Cell
    from cmdlmc_tpu_torch.engine.lattice import init_replicas
    from cmdlmc_tpu_torch.topo.models import AnglePairRates, PairRates

    rng = np.random.RandomState(seed)
    base = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    pbase = rng.uniform(0, box, size=(N_P, 3)).astype(np.float32)
    block = (base[None] + rng.normal(scale=0.03, size=(frames, n, 3))
             ).astype(np.float32)
    eblock = (pbase[None] + rng.normal(scale=0.03, size=(frames, N_P, 3))
              ).astype(np.float32)
    cell = Cell.cubic([box] * 3, device=dev)
    law = _k3_law(kind).to(dev)
    pos = torch.from_numpy(block).to(dev)
    extras = torch.from_numpy(eblock).to(dev)
    if kind == 4:
        model = AnglePairRates.from_first_frame(cell, law, CUTOFF, BUFFER,
                                                pos[0], extras[0], GROUP)
        pgrp = model.grouped_positions(extras)
    elif whole:
        from cmdlmc_tpu_torch.rates.laws import Fermi

        a, b, c = WHOLE_FERMI
        model = PairRates(cell, Fermi(a=a, b=b, c=c).to(dev), box, 0.0)
        pgrp = None
    else:
        model, pgrp = PairRates(cell, law, CUTOFF, BUFFER), None
    ens = init_replicas(torch.Generator().manual_seed(seed), replicas, n,
                        protons, pos[0], device=dev)
    rep = ens.replicas
    state = [ens.prev_pos, ens.site_disp, rep.occ, rep.proton_of_site.float(),
             rep.site_of_proton, rep.t_last_jump, rep.disp_base,
             rep.clock.u_remaining, rep.clock.event_count]
    return model, pos, pgrp, state


def _k3_call(model, pos, pgrp, state, frame0, **kw):
    """K3 (or, with plain=True, its plain version) on the card."""
    from cmdlmc_tpu_torch.ops import kmc_sweep as ks

    plain = kw.pop("plain", False)
    fn = ks.kmc_sweep_reference if plain else ks.kmc_sweep
    return fn(pos, *state, ks.law_params_array(model.law), frame0, model.box, 0,
              pgrp, **kw)


def _k3_kw(model, **extra):
    from cmdlmc_tpu_torch.ops import kmc_sweep as ks

    return dict(kind=ks.law_kind(model.law), tile=128, max_events=MAX_EVENTS,
                dt=DT, seed=1, cutbuf=model.cutbuf, **extra)


def _k3_check(label, model, pos, pgrp, state, got, want, frame0, kw) -> float:
    """K3 held to its plain version, as K1 is."""
    from cmdlmc_tpu_torch.ops import kmc_sweep as ks

    def sl(x, f):
        return None if x is None else x[f:f + 1]

    def step(f, prev, s, st):
        args = (model, sl(pos, f), sl(pgrp, f), [prev, s, *st], frame0 + f)
        return _k3_call(*args, **kw), _k3_call(*args, plain=True, **kw)

    w = ks.inkernel_tables(pos, ks.law_params_array(model.law), model.box, pgrp,
                           kind=kw["kind"], cutbuf=kw["cutbuf"])
    return _hold("k3", label, got, want, state[8], pos.shape[0],
                 lambda: _partings(pos.shape[0], state, step,
                                   _dense_margin(w, frame0, kw)))


def phase_k3(dev):
    """K3 against kmc_sweep_reference: at the in-kernel route's launch shape
    (R=1024, B=100; kind 0 with bench.py's Fermi law and kind 4 with the
    angle gate of the variant deployment), timed there; at R=256, B=16 for
    kinds 1-3; with whole rows at the route's largest N (224; the lists in
    global memory). Then K3 against stage 1 + K1 on the same state (kind 0,
    the two routes' agreement), K3 at 2, 4, 8 and 16 warps per block, and
    the two routes timed at 8, 16 and 128 RNG tiles."""
    import torch

    from cmdlmc_tpu_torch.engine import fused
    from cmdlmc_tpu_torch.ops import kmc_sweep as ks
    from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss

    R, B = INKERNEL_REPLICAS, PRINT_FREQ
    worst, result = 0.0, {}
    for kind in (0, 4):
        model, pos, pgrp, state = _k3_inputs(dev, R, B, kind)
        kw = _k3_kw(model)
        ms, got = cuda_ms(lambda: _k3_call(model, pos, pgrp, state, 0, **kw), reps=5)
        plain_ms, want = cuda_ms(
            lambda: _k3_call(model, pos, pgrp, state, 0, plain=True, **kw), reps=1)
        say(f"[k3] kind {kind} R={R} B={B} N={N_SITES} P={N_PROTONS}: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
        _same_bits("k3", f"kind {kind} R={R} B={B}", got)
        worst = max(worst, _k3_check(f"kind {kind} R={R} B={B}", model, pos,
                                     pgrp, state, got, want, 0, kw))
        events = int(want["ev_count"].sum() - state[8].sum())
        angle_bytes = 4.0 * B * N_SITES * 3 if kind == 4 else 0.0
        w = ks.inkernel_tables(pos, ks.law_params_array(model.law), model.box,
                               pgrp, kind=kind, cutbuf=model.cutbuf)
        work = sweep_work(w, N_PROTONS)
        b = sweep_bound(R, B, N_SITES, N_PROTONS, events, work,
                        extra_flops=W_BUILD_OPS * B * N_SITES ** 2,
                        extra_bytes=angle_bytes)
        dense = dense_sweep_bound(R, B, N_SITES, N_PROTONS, events,
                                  extra_flops=W_BUILD_OPS * B * N_SITES ** 2,
                                  extra_bytes=angle_bytes)
        caps = ks.range_caps(pos, model.box, model.cutbuf).tolist()
        plan = ks.launch_plan(N_SITES, caps, dev)
        say(f"[k3] kind {kind}: bound {b['bound_ms']:.4f} ms ({b['bound_by']}; "
            f"{events} events; {work['pairs']:.1f} occupied x vacant pairs "
            f"with W != 0 per whole evaluation, {work['rows']:.2f} rows of "
            f"{work['vacant']:.2f} vacant terms summed again per event); "
            f"counting every pair, {dense['bound_ms']:.4f} ms; "
            f"{_plan_text(plan, caps)}")
        if kind == 0:
            # no single PyTorch call runs this event loop
            result = {"ms": ms, "plain_ms": plain_ms, **b, "library_ms": None}
            k0 = (model, pos, state, kw, got)
    for kind in (1, 2, 3):
        model, pos, pgrp, state = _k3_inputs(dev, 256, 16, kind, seed=kind)
        kw = _k3_kw(model)
        got = _k3_call(model, pos, pgrp, state, 500, **kw)
        want = _k3_call(model, pos, pgrp, state, 500, plain=True, **kw)
        _same_bits("k3", f"kind {kind} R=256 B=16", got)
        worst = max(worst, _k3_check(f"kind {kind} R=256 B=16", model, pos,
                                     pgrp, state, got, want, 500, kw))
    n = fused.INKERNEL_MAX_SITES
    label = f"whole rows kind 0 N={n} R=256 B=8"
    model, pos, pgrp, state = _k3_inputs(
        dev, 256, 8, 0, n=n, protons=N_PROTONS * n // N_SITES,
        box=BOX * (n / N_SITES) ** (1.0 / 3.0), whole=True)
    caps = ks.range_caps(pos, model.box, model.cutbuf).tolist()
    plan = ks.launch_plan(n, caps, dev)
    say(f"[k3] {label}: {_plan_text(plan, caps)}")
    if caps != [n - 1, n - 1] or plan["lists_in_smem"]:
        raise AssertionError(f"K3 {label}: not whole rows in global memory")
    kw = _k3_kw(model)
    got = _k3_call(model, pos, pgrp, state, 0, **kw)
    want = _k3_call(model, pos, pgrp, state, 0, plain=True, **kw)
    _same_bits("k3", label, got)
    worst = max(worst, _k3_check(label, model, pos, pgrp, state, got, want, 0, kw))
    result["max_abs_err"] = worst

    # the two routes on the same state: K3 against stage 1 + K1 (kind 0)
    model, pos, state, kw, k3_out = k0
    kw1 = dict(tile=128, max_events=MAX_EVENTS, dt=DT, seed=1)
    w = kss.dense_tables(model, pos)
    k1_out = kss.kmc_sweep_streamed(w, pos, *state, 0, model.box, 0, **kw1)

    def step(f, prev, s, st):
        return (_k3_call(model, pos[f:f + 1], None, [prev, s, *st], f, **kw),
                kss.kmc_sweep_streamed(w[f:f + 1], pos[f:f + 1], prev, s, *st,
                                       f, model.box, 0, **kw1))

    w3 = ks.inkernel_tables(pos, ks.law_params_array(model.law), model.box,
                            kind=0, cutbuf=model.cutbuf)
    say(f"[routes] max |W of K3's plain build - W of stage 1| = "
        f"{float((w3 - w).abs().max()):.3e}")
    _hold("routes", f"K3 vs stage 1 + K1, kind 0 R={R} B={B}", k3_out, k1_out,
          state[8], B, lambda: _partings(B, state, step, _dense_margin(w, 0, kw1)))

    # launch shape: replicas (warps) per block; the results must not move
    times = {}
    caps = ks.range_caps(pos, model.box, model.cutbuf).tolist()
    for warps in (2, 4, 8, 16):
        t, out = cuda_ms(lambda: _k3_call(model, pos, None, state, 0,
                                          warps=warps, **kw), reps=5)
        times[warps] = (t, ks.launch_plan(N_SITES, caps, dev, warps)["blocks_per_sm"])
        same = all(torch.equal(out[k], k3_out[k]) for k in k3_out)
        if not same:
            raise AssertionError(f"K3 at {warps} warps per block differs")
    say(f"[k3] warps per block at R={R} B={B} kind 0: " + ", ".join(
        f"{w_}: {t:.3f} ms ({n} blocks per SM)" for w_, (t, n) in times.items())
        + f" (default {ks.WARPS_PER_BLOCK}); results identical")

    # route timing at 8, 16 and 128 RNG tiles, in turns: K3, stage 1 + K1,
    # both again in the other order
    for r in (R, 2 * R, REPLICAS):
        if r == R:
            model, pos, state = k0[:3]
        else:
            model, pos, _, state = _k3_inputs(dev, r, B, 0)

        def inkernel():
            return _k3_call(model, pos, None, state, 0, **kw)

        def streamed():
            return kss.kmc_sweep_streamed(kss.dense_tables(model, pos), pos,
                                          *state, 0, model.box, 0, **kw1)

        a1, _ = cuda_ms(inkernel, reps=3)
        b1, _ = cuda_ms(streamed, reps=3)
        b2, _ = cuda_ms(streamed, reps=3)
        a2, _ = cuda_ms(inkernel, reps=3)
        say(f"[route] R={r} ({r // 128} tiles) B={B} kind 0: in-kernel K3 "
            f"{a1:.3f} / {a2:.3f} ms, stage 1 + K1 {b1:.3f} / {b2:.3f} ms")
    return result


def _jitter_block(n, frames, box, seed=0):
    """bench.py's frames: uniform sites, each frame jittered by 0.03 A."""
    import numpy as np

    rng = np.random.RandomState(seed)
    base = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    return (base[None] + rng.normal(scale=0.03, size=(frames, n, 3))).astype(np.float32)


def _walk_block(n, frames, box, seed=0):
    """tools/bench_topk_e2e.py's frames: uniform sites plus a random walk of
    SC_DRIFT per frame and coordinate."""
    import numpy as np

    rng = np.random.RandomState(seed)
    base = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    walk = np.cumsum(rng.normal(scale=SC_DRIFT, size=(frames, n, 3)).astype(np.float32),
                     axis=0)
    return (base[None] + walk).astype(np.float32)


def _box4_block(frames, seed=0):
    """The supercell deployment's frames: bench.py's cell as a random walk
    (:func:`_walk_block`), replicated by BOX_MULT as the driver does it."""
    import torch

    from cmdlmc_tpu_torch.core.cell import extended_positions

    small = torch.from_numpy(_walk_block(N_SITES, frames, BOX, seed))
    return extended_positions((BOX,) * 3, small, BOX_MULT).numpy()


CUTBUF = CUTOFF + BUFFER  # 5.0, exact in float32


def knn_ops(n: int) -> float:
    """K5's least operations per frame: each unordered pair's distance
    (d(i,j) = d(j,i)) and cutoff test, and one compare per ordered pair to
    keep the k nearest of each column."""
    return n * (n - 1) / 2 * (PAIRWISE_OPS + 1) + n * (n - 1)


def _knn_hold(what, pos, box3, gd, gi, wd, wi):
    """K-nearest tables (gd, gi) of a kernel held to its plain version's
    (wd, wi): indices equal except where the two candidates' distances lie
    within an ulp of each other, distances within an ulp. Returns the
    number of index partings and the largest distance error."""
    import torch

    parted = (gi != wi).nonzero().tolist()
    for fb, s, j in parted[:64]:  # a parting must be a tie within an ulp

        def dist(i):
            d = pos[fb, i] - pos[fb, j]
            d = d - torch.tensor(box3, device=pos.device) * torch.round(d / box3[0])
            return float(torch.sqrt((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]))

        a, c = dist(int(gi[fb, s, j])), dist(int(wi[fb, s, j]))
        if abs(a - c) > 2.4e-7 * max(a, c):
            raise AssertionError(f"{what} parts at ({fb}, {s}, {j}) "
                                 f"away from a tie: {a} vs {c}")
    err = float((gd - wd).abs().max())
    if not torch.allclose(gd, wd, rtol=2.4e-7, atol=0):
        raise AssertionError(f"{what} distances differ by more than an ulp: {err}")
    return len(parted), err


def phase_k5(dev):
    """K5 against knn_block_tables_reference at k=8: at the top-K path's
    launch shape [PRINT_FREQ, 144], at [256, 144] and at the supercell's
    [64, 4608]. Indices equal, except where the two candidates' distances lie
    within an ulp of each other; distances within an ulp. Timed at each
    shape."""
    import torch

    from cmdlmc_tpu_torch.ops.knn_tables import knn_block_tables, knn_block_tables_reference

    k, worst, result = TOPK_K, 0.0, {}
    for b, n, box in ((PRINT_FREQ, N_SITES, BOX), (256, N_SITES, BOX),
                      (64, SC_SITES, SC_BOX)):
        block = _walk_block(n, b, box) if n == SC_SITES else _jitter_block(n, b, box)
        pos = torch.from_numpy(block).to(dev)
        box3 = (box,) * 3
        ms, (gd, gi) = cuda_ms(lambda: knn_block_tables(pos, box3, CUTBUF, k), reps=5)
        plain_ms, (wd, wi) = cuda_ms(
            lambda: knn_block_tables_reference(pos, box3, CUTBUF, k), reps=1)
        parted, err = _knn_hold(f"K5 [{b},{n}]", pos, box3, gd, gi, wd, wi)
        worst = max(worst, err)
        b_ = bound(b * knn_ops(n), 4.0 * b * n * 3 + 8.0 * b * k * n)
        say(f"[k5] [B={b}, N={n}, k={k}]: {parted} index partings (ties within "
            f"an ulp), max |kernel - plain| distance {err:.3e}; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.3f} ms, bound {b_['bound_ms']:.4f} ms ({b_['bound_by']})")
        if b == PRINT_FREQ:
            # no single PyTorch call computes it: torch.cdist has no periodic
            # images and torch.topk no first-lowest-index tie rule
            result = {"ms": ms, "plain_ms": plain_ms, **b_, "library_ms": None}
    result["max_abs_err"] = worst
    return result


def knn_sparse_ops(plan, n: int) -> float:
    """K6's least operations per frame over a sparse plan, counted as
    knn_ops counts K5's: the distance and cutoff test of each unordered pair
    that one of its two (tile, chunk) pairs keeps (d(i,j) = d(j,i)), and one
    compare per ordered kept (column, row) pair but self. Returns the
    operations and the share of all unordered pairs that the plan keeps."""
    import math

    import numpy as np

    g = math.gcd(plan.rc, plan.tc)  # each g-block lies in one tile and one chunk
    first = np.arange(0, n, g)
    size = np.minimum(g, n - first).astype(np.float64)
    keep = np.zeros((plan.lists.shape[0], plan.n_ch), dtype=bool)
    for t, chunks in enumerate(plan.lists):
        keep[t, chunks[chunks < plan.n_ch]] = True
    ordered = keep[first // plan.tc][:, first // plan.rc]  # [column block, row block]
    either = ordered | ordered.T
    w = np.outer(size, size)
    unordered = (w * np.triu(either, 1)).sum() + (either.diagonal() * size * (size - 1) / 2).sum()
    compares = (w * ordered).sum() - (ordered.diagonal() * size).sum()
    return float(unordered * (PAIRWISE_OPS + 1) + compares), unordered / (n * (n - 1) / 2)


def phase_k6(dev):
    """K6 against its plain version (as K5 is held to its own) and against
    K5, which it must equal bit for bit: at the box x4 path's own launch, a
    rebuild's one frame [1, 9216] over that frame's plan; at [64, 9216]
    (bench.py's cell replicated 4 x 4 x 4, the JAX gate open); and at
    [64, 4608] (tools/bench_topk_e2e.py's supercell, the gate closed there,
    so the plan is forced). K6 and K5 timed in turns (K6, K5, K5, K6) at
    each shape, the host plan timed for each."""
    import torch

    from cmdlmc_tpu_torch.ops import knn_sparse as kns
    from cmdlmc_tpu_torch.ops.knn_tables import knn_block_tables

    k, worst, result = TOPK_K, 0.0, {}
    box4 = _box4_block(64)
    for b, n, box, forced in ((1, BX_SITES, BX_BOX, False), (64, BX_SITES, BX_BOX, False),
                              (64, SC_SITES, SC_BOX, True)):
        block = box4[:b] if n == BX_SITES else _walk_block(n, b, box)
        pos = torch.from_numpy(block).to(dev)
        box3 = (box,) * 3
        gate = dict(min_n=0, max_ratio=1.0) if forced else {}
        shape = f"[{b},{n}]{' (gate forced)' if forced else ''}"
        t0 = time.perf_counter()
        plan = kns.sparse_plan_for(pos, box3, CUTBUF, **gate)
        plan_s = time.perf_counter() - t0
        if plan is None or (kns.sparse_plan_for(pos, box3, CUTBUF) is None) != forced:
            raise AssertionError(f"K6 {shape}: the plan's gate is not as expected")
        reps = 20 if b == 1 else 5
        a1, (d6, i6) = cuda_ms(lambda: kns.knn_sparse_tables(pos, box3, CUTBUF, k, plan),
                               reps=reps)
        b1, (d5, i5) = cuda_ms(lambda: knn_block_tables(pos, box3, CUTBUF, k), reps=reps)
        b2, _ = cuda_ms(lambda: knn_block_tables(pos, box3, CUTBUF, k), reps=reps)
        a2, _ = cuda_ms(lambda: kns.knn_sparse_tables(pos, box3, CUTBUF, k, plan), reps=reps)
        plain_ms, (wd, wi) = cuda_ms(
            lambda: kns.knn_sparse_tables_reference(pos, box3, CUTBUF, k, plan), reps=1)
        n_i = int((i6 != i5).sum())
        n_d = int((d6.view(torch.int32) != d5.view(torch.int32)).sum())
        say(f"[k6] {shape} k={k}: K6 vs K5 {n_i} differing indices, {n_d} differing "
            f"distances (bit for bit)")
        if n_i or n_d:
            raise AssertionError(f"K6 {shape} differs from K5")
        parted, err = _knn_hold(f"K6 {shape}", pos, box3, d6, i6, wd, wi)
        worst = max(worst, err)
        ops, share = knn_sparse_ops(plan, n)
        b_ = bound(b * ops, 4.0 * b * n * 3 + 8.0 * b * k * n)
        say(f"[k6] {shape}: plan keeps {plan.lists.shape[1]} of {plan.n_ch} chunks per "
            f"tile at most (ratio {plan.ratio:.3f}), {share:.4f} of the unordered "
            f"pairs; host plan {1e3 * plan_s:.1f} ms; {parted} index partings against "
            f"the plain version (ties within an ulp), max distance error {err:.3e}")
        say(f"[k6] {shape}: K6 {a1:.4f} / {a2:.4f} ms, K5 {b1:.4f} / {b2:.4f} ms, "
            f"plain {plain_ms:.3f} ms, K6 bound {b_['bound_ms']:.5f} ms ({b_['bound_by']})")
        if b == 1:
            # no single PyTorch call computes it (see phase_k5)
            result = {"ms": a1, "plain_ms": plain_ms, **b_, "library_ms": None}
    result["max_abs_err"] = worst
    return result


TOPK_STATE_KEYS = ("occ", "labels", "sites", "tlast", "tlast_site", "disp_base",
                   "u_rem", "ev_count")
TRICLINIC_VECTORS = ((BOX, 0.0, 0.0), (0.2 * BOX, BOX, 0.0), (0.15 * BOX, 0.1 * BOX, BOX))


def _k4_inputs(dev, replicas, frames, name, kind=0, triclinic=False, seed=0):
    """A top-K model ("topk": TopKPairRates k=8 with law kind `kind`;
    "hydronium": HydroniumRates k=4, ReLU, the blend; "supercell": the
    TopKPairRates of tools/bench_topk_e2e.py; "box4": that of the box x4
    supercell deployment; "wide": WIDE_SITES sites at bench.py's density),
    a block of its frames, its stage-1 tables, random replica state [prev,
    s, occ, labels, sites, tlast, tlast_site, disp_base, u, evc] and the
    sweep's keywords."""
    import numpy as np
    import torch

    from cmdlmc_tpu_torch.core.cell import Cell
    from cmdlmc_tpu_torch.engine.lattice import init_replicas
    from cmdlmc_tpu_torch.ops import topk_sweep as ts
    from cmdlmc_tpu_torch.topo.models import HydroniumRates, TopKPairRates
    from cmdlmc_tpu_torch.topo.transforms import DistanceInterpolator, ReLUTransformation

    n, protons, box = {"supercell": (SC_SITES, SC_PROTONS, SC_BOX),
                       "box4": (BX_SITES, BX_PROTONS, BX_BOX),
                       "wide": (WIDE_SITES, N_PROTONS * WIDE_SITES // N_SITES,
                                BOX * (WIDE_SITES / N_SITES) ** (1.0 / 3.0)),
                       }.get(name, (N_SITES, N_PROTONS, BOX))
    if name == "box4":
        block = _box4_block(frames, seed)
    elif name in ("supercell", "wide"):
        block = _walk_block(n, frames, box, seed)
    elif triclinic:
        rng = np.random.RandomState(seed)
        frac = rng.uniform(0, 1, size=(n, 3))
        base = frac @ np.asarray(TRICLINIC_VECTORS)
        block = (base[None] + rng.normal(scale=0.03, size=(frames, n, 3))).astype(np.float32)
    else:
        block = _jitter_block(n, frames, box, seed)
    cell = (Cell.triclinic(TRICLINIC_VECTORS, device=dev) if triclinic
            else Cell.cubic([box] * 3, device=dev))
    law = _k3_law(kind).to(dev)
    if name == "hydronium":
        model = HydroniumRates(
            cell, law, CUTOFF, BUFFER,
            transform=ReLUTransformation(a=RELU[0], b=RELU[1], d0=RELU[2],
                                         left_bound=RELU[3], right_bound=RELU[4]).to(dev),
            interpolator=DistanceInterpolator(relaxation_time=RELAX).to(dev), k=HYD_K)
    else:
        model = TopKPairRates(cell, law, CUTOFF, BUFFER, k=TOPK_K)
    pos = torch.from_numpy(block).to(dev)
    blend = ts.has_blend(model)
    tables = ts.topk_tables(model, pos, precompute_law=not blend)
    ens = init_replicas(torch.Generator().manual_seed(seed), replicas, n, protons,
                        pos[0], device=dev)
    rep = ens.replicas
    labels = rep.proton_of_site.float()
    state = [ens.prev_pos, ens.site_disp, rep.occ, labels, rep.site_of_proton,
             rep.t_last_jump, ts.entry_tlast_site(rep.occ, labels, rep.t_last_jump),
             rep.disp_base, rep.clock.u_remaining, rep.clock.event_count]
    tile = ts.pick_tile_topk(replicas, n_sites=n, n_protons=protons, k_cand=model.k)
    kw = dict(orthorhombic=cell.orthorhombic, kind=kind, tile=tile,
              max_events=MAX_EVENTS, dt=DT, seed=1, blend=blend)
    return model, pos, tables, state, kw


def _k4_call(model, pos, tables, state, frame0, plain=False, **kw):
    """K4 (or, with plain=True, its plain version) on the card."""
    from cmdlmc_tpu_torch.ops import topk_sweep as ts

    fn = ts.topk_sweep_reference if plain else ts.topk_sweep
    return fn(pos, *tables, *state, ts.law_params8(model), frame0, model.geometry,
              0, **kw)


def _topk_margin(model, tab, st, r, frame_idx, kw):
    """Replay replica r's event iterations of one frame the plain way over
    that frame's tables and return the smallest relative margin of any
    decision (the clock test, the gap between the best two slots and
    between the best two sites) and its name."""
    import torch

    from cmdlmc_tpu_torch.ops import rng
    from cmdlmc_tpu_torch.ops import topk_sweep as ts

    td, ti, rs = tab
    n_k, n = td.shape
    occ, tls, u = st[0][r:r + 1].clone(), st[4][r:r + 1].clone(), st[6][r]
    dev, f32 = occ.device, torch.float32
    tile_id, rin = r // kw["tile"], r % kw["tile"]
    dt = torch.tensor(kw["dt"], dtype=f32, device=dev)
    frame_time = torch.tensor(float(frame_idx), dtype=f32, device=dev) * dt
    p = ts.law_params8(model).to(dev)
    phase = torch.zeros((), dtype=f32, device=dev)
    best = (float("inf"), "none")

    def race(vals, ev, salt, width):
        key = rng.mix_key(kw["seed"], tile_id, frame_idx, ev, salt).to(dev)
        e = 0.0 - torch.log(rng.u01_counter(
            key, rin * width + torch.arange(width, device=dev)))
        v = torch.where(vals > 0, vals / e, 0.0)  # as the plain version races
        top = torch.topk(v, 2).values
        return int(torch.argmax(v)), float((top[0] - top[1]) / top[0])

    for ev in range(kw["max_events"]):
        rates = ts.candidate_rates(td, ti, rs, occ, tls, frame_time, p,
                                   kind=kw["kind"], blend=kw["blend"])
        sums, total = ts.slot_totals(rates)
        budget = total[0] * (dt - phase)
        if budget > 0:
            best = min(best, (float(abs(u - budget) / budget), f"clock, event {ev}"))
        if not (u <= budget and budget > 0):
            break
        eph = phase + u / total[0]
        k, m = race(sums[0], ev, 11, n_k)
        best = min(best, (m, f"slot race, event {ev}"))
        src, m = race(rates[0, k], ev, 12, n)
        best = min(best, (m, f"site race, event {ev}"))
        dst = int(ti[k, src])
        occ[0, src] -= 1.0
        occ[0, dst] += 1.0
        tls[0, dst] = frame_time + eph
        key = rng.mix_key(kw["seed"], tile_id, frame_idx, ev, 3).to(dev)
        u = -torch.log(rng.u01_counter(key, torch.tensor(rin, device=dev)))
        phase = eph
    return best


def _k4_check(label, model, pos, tables, state, got, want, frame0, kw) -> float:
    """K4 held to its plain version, as K1 is."""

    def step(f, prev, s, st):
        args = (model, pos[f:f + 1], [t[f:f + 1] for t in tables], [prev, s, *st],
                frame0 + f)
        return _k4_call(*args, **kw), _k4_call(*args, plain=True, **kw)

    def margin(f, st, r):
        return _topk_margin(model, [t[f] for t in tables], st, r, frame0 + f, kw)

    return _hold("k4", label, got, want, state[9], pos.shape[0],
                 lambda: _partings(pos.shape[0], state, step, margin, TOPK_STATE_KEYS))


def topk_bound(R, B, N, P, K, events, blend, table_bytes) -> dict:
    """Bound of a top-K sweep that fired `events` events: each rate
    evaluation is K candidates at each of the P occupied sites per replica
    (occ[i] is 1 there: 1 - occ[nbr], the multiply by omega and the add into
    the slot sum; with the blend also d + ratio (r - d), the clamp at 50 and
    the Fermi law, 9 more, and the site's ratio, 3 per site), one per event
    plus the one that ends each replica-frame; each event races the K slots
    and the P occupied sites, the only ones with a positive rate (a log, a
    divide and a compare each). Bytes: positions, the tables, the replica
    state read once and written once."""
    per_site = K * (12.0 if blend else 3.0) + (3.0 if blend else 0.0)
    flops = (events + R * B) * P * per_site + 3.0 * (P + K) * events
    state = 4.0 * R * (3 * N + 5 * P + 2)  # occ, labels, tlast_site, sites, tlast, db, u, evc
    return bound(flops, 4.0 * B * N * 3 + table_bytes + 2 * state + 4.0 * R
                 + 4 * 4.0 * N * 3)


def phase_k4(dev):
    """K4 against topk_sweep_reference on the same tables: TopKPairRates k=8
    (Fermi) and HydroniumRates k=4 (the blend in the loop) at the top-K
    path's launch shape R=4096, B=100, N=144, timed there; law kinds 1-3 and
    a triclinic cell at R=256, B=16; the supercells at R=4096, B=16: N=4608,
    P=3072 and the box x4 deployment's N=9216, P=6144 (RNG tile from
    pick_tile_topk), timed there; N=WIDE_SITES at R=256, B=4, where the
    global layout runs (K4's state in global scratch)."""
    from cmdlmc_tpu_torch.ops import topk_sweep as ts

    worst, result = 0.0, {}
    cases = [("topk", TOPK_REPLICAS, PRINT_FREQ, 0, False),
             ("hydronium", TOPK_REPLICAS, PRINT_FREQ, 0, False),
             ("topk", 256, 16, 1, False), ("topk", 256, 16, 2, False),
             ("topk", 256, 16, 3, False), ("topk", 256, 16, 0, True),
             ("supercell", SC_REPLICAS, 16, 0, False),
             ("box4", SC_REPLICAS, 16, 0, False), ("wide", 256, 4, 0, False)]
    want_layout = {N_SITES: "shared", SC_SITES: "shared", BX_SITES: "shared",
                   WIDE_SITES: "global"}
    for name, R, B, kind, tri in cases:
        model, pos, tables, state, kw = _k4_inputs(dev, R, B, name, kind, tri, seed=kind)
        N, P, K = pos.shape[1], state[4].shape[1], tables[0].shape[1]
        layout = "global" if ts.sweep_scratch_bytes(R, N, K, kw["blend"], dev) else "shared"
        label = (f"{name} k={K} kind {kind}{' triclinic' if tri else ''} R={R} B={B} "
                 f"N={N} TR={kw['tile']} layout {layout!r}")
        if layout != want_layout[N]:
            raise AssertionError(f"K4 {label}: expected the {want_layout[N]!r} layout")
        timed = R == TOPK_REPLICAS
        frame0 = 0 if timed or name == "wide" else 500
        ms, got = cuda_ms(lambda: _k4_call(model, pos, tables, state, frame0, **kw),
                          reps=3 if timed else 1)
        plain_ms, want = cuda_ms(
            lambda: _k4_call(model, pos, tables, state, frame0, plain=True, **kw), reps=1)
        worst = max(worst, _k4_check(label, model, pos, tables, state, got, want,
                                     frame0, kw))
        events = int(want["ev_count"].sum() - state[9].sum())
        n_tab = 3 if kw["blend"] else 2
        b = topk_bound(R, B, N, P, K, events, kw["blend"], 4.0 * n_tab * B * K * N)
        if timed:
            say(f"[k4] {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']}; {events} events)")
        if name == "topk" and timed:
            # no single PyTorch call runs this event loop
            result = {"ms": ms, "plain_ms": plain_ms, **b, "library_ms": None}
    result["max_abs_err"] = worst
    return result


# the water deployment of tools/bench_water.py (ROADMAP A20): 216 O in an
# 18.6 A cube (bulk water density), Fermi a=0.06 b=2.3 c=0.1, the linear
# rescaling a=0.5 b=1.2 on (0, 10), d_OH 0.3, relaxation time 10,
# keep_last_neighbor_rescaled, n_atoms 3, check_from_old at the keyword
# schema's default (True), 8192 replicas in RNG tiles of 256, dt 0.5,
# max_events 4; and the same at 1728 sites and constant density with its
# interpolation table (bench_water.py --transform interp: 57 points,
# 2.0-3.4 -> 1.9-3.4)
W_SITES, W_BIG_SITES, W_REPLICAS, W_TILE, W_BLOCK = 216, 1728, 8192, 256, 256
W_BOX = 18.6
W_BIG_BOX = W_BOX * (W_BIG_SITES / W_SITES) ** (1.0 / 3.0)
W_LINEAR = (0.5, 1.2, 0.0, 0.0, 10.0)  # a, b, (d0), left, right
W_INTERP_POINTS = 57
W_RELAX, W_D_OH = 10, 0.3
W_INT_KEYS = ("site", "last", "fsj", "wait", "jumps", "ev_count", "trunc")
W_FLOATS = (("u_rem", 1e-5, 1e-5), ("corr", 1e-5, 1e-5), ("disp_base", 0.0, 1e-4),
            ("site_disp", 1e-5, 1e-5), ("prev_pos", 0.0, 0.0))
# operations of one candidate evaluation at K table slots: the blend (3 per
# slot and 3 for the factor), the back-connection test (1 per slot), the
# Fermi law on 3 slots (5 each), the waiting gate and the total (2 + 3), and
# the clock test (2); of one event besides: two keyed draws (about 40 integer
# operations each), the pick (4), the jump's minimum image (15), the rebase
# (9), the d_OH step (17), the log and the counters (10)
W_EVENT_OPS = 135.0


def water_eval_ops(k: int) -> float:
    return 4.0 * k + 3.0 + 15.0 + 5.0 + 2.0


def water_bound(R, B, N, K, events, trunc) -> dict:
    """Bound of a water sweep that fired `events` events and ran out of
    event budget in `trunc` replica-frames: each replica-frame evaluates its
    candidates once per event, once more in the iteration that does not fire
    (unless its budget ran out) and once for the leftover rate; each event
    adds W_EVENT_OPS; the prefix sum advances once per frame (6 per site and
    axis). Bytes: positions and the three tables read once, the replica
    state (9 words) read and written once, the prefix sum and previous
    positions in, both out."""
    evals = events + (R * B - trunc) + R * B
    flops = evals * water_eval_ops(K) + events * W_EVENT_OPS + 18.0 * B * N
    nbytes = 4.0 * B * N * 3 + 12.0 * B * K * N + 2 * 4.0 * R * 13 + 4.0 * R + 4 * 4.0 * N * 3
    return bound(flops, nbytes)


def _water_transform(name):
    """(tkind, params[5], interp x, interp y) of the smoke's transforms."""
    import numpy as np

    from cmdlmc_tpu_torch.ops import water_sweep as ws

    zeros = np.zeros(5, np.float32)
    if name == "linear":
        return ws.T_LINEAR, np.array(W_LINEAR, np.float32), None, None
    if name == "ramp":  # the hydronium deployment's ReLU
        a, b, d0, left, right = RELU
        return ws.T_RAMP, np.array([a, b, d0, left, right], np.float32), None, None
    if name == "interp":
        return (ws.T_INTERP, zeros, np.linspace(2.0, 3.4, W_INTERP_POINTS, dtype=np.float32),
                np.linspace(1.9, 3.4, W_INTERP_POINTS, dtype=np.float32))
    return ws.T_NONE, zeros, None, None


def _k7_inputs(dev, n, frames, replicas, box, transform="linear", k=3, seed=0):
    """bench_water.py's frames (uniform sites, 0.03 A jitter per frame), the
    water tables on the card (K5, no cutoff) and fresh replica states."""
    import numpy as np
    import torch

    from cmdlmc_tpu_torch.models import water as wm
    from cmdlmc_tpu_torch.ops import water_sweep as ws

    pos = torch.from_numpy(_jitter_block(n, frames, box, seed)).to(dev)
    tkind, tp, tx, ty = _water_transform(transform)
    tables = ws.water_tables(pos, (box,) * 3, k, tkind, tp, tx, ty)
    st = wm.init_water_states(torch.Generator().manual_seed(seed), replicas, n, pos[0])
    state = [st.site, st.last_site, st.frames_since_jump, st.wait_left, st.jumps,
             st.clock.event_count, st.clock.u_remaining, st.correction,
             torch.zeros((replicas, 3), device=dev)]
    law = torch.from_numpy(np.array([*FERMI, 0, 0, 0], np.float32))
    return pos, tables, [pos[0].clone(), torch.zeros((n, 3), device=dev), *state], law


def _water_margin(pos, tables, law, st, f, r, frame0, box, kw):
    """Replay one replica's event iterations of one frame the plain way and
    return the smallest relative margin of a decision taken there (the clock
    test u <= budget, the pick's two thresholds u2 >= r0 and u2 >= r0 + r1)
    and the decision's name. The other decisions (the blend, the
    back-connection, the farthest slot) compare values that both versions
    compute with the same IEEE operations."""
    import torch

    from cmdlmc_tpu_torch.ops import rng
    from cmdlmc_tpu_torch.ops import water_sweep as ws

    dev = pos.device
    sl = [t[r:r + 1].clone() for t in st]
    site, last, fsj, wait = sl[0], sl[1], sl[2], sl[3]
    u = sl[6]
    td, ti, rs = (t[f] for t in tables)
    p = law.to(dev)
    ckw = dict(kind=kw["kind"], relax=kw["relax"], keep_last=kw["keep_last"],
               check_old=kw["check_old"])
    tid = torch.tensor([r // kw["tile"]], device=dev)
    rin = torch.tensor([r % kw["tile"]], device=dev)
    dt = torch.tensor(kw["dt"], dtype=torch.float32, device=dev)
    phase = torch.zeros(1, device=dev)
    best = (float("inf"), "none")
    for ev in range(kw["max_events"]):
        rates, cand = ws.candidate_rates(td, ti, rs, site, last, fsj, wait, p, **ckw)
        total = ws.total_rate(rates)
        budget = total * (dt - phase)
        if float(budget) > 0:
            best = min(best, (float(abs(u - budget) / budget), f"clock, event {ev}"))
        if not (bool(u <= budget) and float(budget) > 0):
            break
        u2 = rng.u01_counter(rng.mix_key(kw["seed"], tid, frame0 + f, ev, 12), rin) * total
        for thr, what in ((rates[:, 0], "pick r0"), (rates[:, 0] + rates[:, 1], "pick r0+r1")):
            best = min(best, (float(abs(u2 - thr) / total), f"{what}, event {ev}"))
        eph = phase + u / total
        last, site = site, cand.gather(1, ws.pick_slot(rates, u2)[:, None])[:, 0].to(torch.int32)
        fsj = torch.full_like(fsj, -1)
        wait = torch.full_like(wait, kw["waiting"] + 1 if kw["waiting"] else 0)
        u = -torch.log(rng.u01_counter(rng.mix_key(kw["seed"], tid, frame0 + f, ev, 13), rin))
        phase = eph
    return best


def _k7_check(label, pos, tables, state, law, got, want, frame0, box, kw) -> float:
    """K7 held to its plain version, as K1 is."""
    from cmdlmc_tpu_torch.ops import water_sweep as ws

    def step(f, prev, s, st):
        args = (pos[f:f + 1], *[t[f:f + 1] for t in tables], prev, s, *st, law,
                frame0 + f, box)
        return ws.water_sweep(*args, **kw), ws.water_sweep_reference(*args, **kw)

    def margin(f, st, r):
        return _water_margin(pos, tables, law, st, f, r, frame0, box, kw)

    return _hold("k7", label, got, want, state[7], pos.shape[0],
                 lambda: _partings(pos.shape[0], state, step, margin, ws.STATE_KEYS,
                                   int_keys=W_INT_KEYS),
                 int_keys=W_INT_KEYS, floats=W_FLOATS)


def _water_kw(**extra):
    kw = dict(kind=0, tile=W_TILE, max_events=MAX_EVENTS, dt=DT, seed=3, relax=W_RELAX,
              waiting=0, keep_last=True, check_old=True, d_oh=W_D_OH)
    kw.update(extra)
    return kw


def phase_k7(dev):
    """The water tables (K5 with no cutoff, then the transform) bit for bit
    against their plain version at [256, 216] and [256, 1728]; K7 against
    water_sweep_reference at the water path's shape (N=216, R=8192, TR=256,
    the linear transform, keep_last, check_from_old, relaxation 10, d_OH
    0.3) over B=100 frames, and smaller cases (R=1024, B=32) for the ramp,
    the 57-point table, n_atoms = 4 and a waiting time of 3; K7 timed at its
    path's launch, R=8192, B=256, at N=216 and N=1728 (64 to 512 threads
    per block, in turns), held there too, with its plain version timed
    once."""
    import torch

    from cmdlmc_tpu_torch.ops import water_sweep as ws
    from cmdlmc_tpu_torch.ops.knn_tables import knn_block_tables, knn_block_tables_reference

    for n, box, tname in ((W_SITES, W_BOX, "linear"), (W_BIG_SITES, W_BIG_BOX, "interp")):
        pos = torch.from_numpy(_jitter_block(n, W_BLOCK, box)).to(dev)
        tkind, tp, tx, ty = _water_transform(tname)
        ms, got = cuda_ms(lambda: ws.water_tables(pos, (box,) * 3, 3, tkind, tp, tx, ty),
                          reps=5)
        knn_ms, _ = cuda_ms(lambda: knn_block_tables(pos, (box,) * 3, float("inf"), 3),
                            reps=5)
        plain_ms, (wd, wi) = cuda_ms(
            lambda: knn_block_tables_reference(pos, (box,) * 3, float("inf"), 3), reps=1)
        wr = ws.apply_transform(tkind, wd, tp, tx, ty)
        same = (torch.equal(got[1], wi) and torch.equal(got[0].view(torch.int32),
                                                        wd.view(torch.int32))
                and torch.equal(got[2].view(torch.int32), wr.view(torch.int32)))
        b_ = bound(W_BLOCK * knn_ops(n), 4.0 * W_BLOCK * n * 3 + 8.0 * W_BLOCK * 3 * n)
        say(f"[k7] water tables [B={W_BLOCK}, N={n}, k=3, {tname}]: bit for bit "
            f"against the plain version: {same}; K5 {knn_ms:.4f} ms (bound "
            f"{b_['bound_ms']:.5f} ms, {b_['bound_by']}), with the transform "
            f"{ms:.4f} ms, K5's plain version {plain_ms:.3f} ms")
        if not same:
            raise AssertionError(f"water tables at N={n} differ from their plain version")

    worst = 0.0
    cases = [("linear", 3, {}, W_REPLICAS, 100), ("ramp", 3, {"waiting": 3, "relax": 4},
                                                    1024, 32),
             ("interp", 3, {}, 1024, 32), ("linear", 4, {}, 1024, 32),
             ("none", 3, {"waiting": 3, "check_old": False}, 1024, 32)]
    for tname, k, extra, R, B in cases:
        pos, tables, state, law = _k7_inputs(dev, W_SITES, B, R, W_BOX, tname, k)
        kw = _water_kw(**extra)
        args = (pos, *tables, *state, law, 0, (W_BOX,) * 3)
        got = ws.water_sweep(*args, **kw)
        want = ws.water_sweep_reference(*args, **kw)
        label = (f"{tname} n_atoms={k} R={R} B={B} N={W_SITES} TR={W_TILE} "
                 f"{ {key: kw[key] for key in ('relax', 'waiting', 'keep_last', 'check_old')} }")
        worst = max(worst, _k7_check(label, pos, tables, state, law, got, want, 0,
                                     (W_BOX,) * 3, kw))

    result = {}
    for n, box, tname in ((W_SITES, W_BOX, "linear"), (W_BIG_SITES, W_BIG_BOX, "interp")):
        pos, tables, state, law = _k7_inputs(dev, n, W_BLOCK, W_REPLICAS, box, tname)
        kw = _water_kw()
        args = (pos, *tables, *state, law, 0, (box,) * 3)
        times = {}
        for threads in (64, 128, 256, 512, 512, 256, 128, 64):
            ms, got = cuda_ms(lambda: ws.water_sweep(*args, block_threads=threads, **kw),
                              reps=3)
            times.setdefault(threads, []).append(ms)
        plain_ms, want = cuda_ms(lambda: ws.water_sweep_reference(*args, **kw), reps=1)
        label = f"{tname} R={W_REPLICAS} B={W_BLOCK} N={n} (the path's launch)"
        worst = max(worst, _k7_check(label, pos, tables, state, law, got, want, 0,
                                     (box,) * 3, kw))
        events = int(want["ev_count"].sum() - state[7].sum())
        b = water_bound(W_REPLICAS, W_BLOCK, n, 3, events, int(want["trunc"].sum()))
        ms = min(times[ws.BLOCK_THREADS])
        say(f"[k7] {label}: kernel {ms:.3f} ms at {ws.BLOCK_THREADS} threads per "
            f"block (runs {', '.join(f'{t}: ' + ' '.join(f'{x:.3f}' for x in v) for t, v in times.items())} ms), "
            f"plain {plain_ms:.3f} ms, bound {b['bound_ms']:.5f} ms ({b['bound_by']}; "
            f"{events} events, {int(want['trunc'].sum())} truncated replica-frames)")
        if n == W_SITES:
            # no single PyTorch call runs this event loop
            result = {"ms": ms, "plain_ms": plain_ms, **b, "library_ms": None}
    result["max_abs_err"] = worst
    return result


def write_inputs(workdir: Path, frames: int, replicas: int, sweeps=None,
                 stale: bool = False, angle: bool = False, topk: str = "") -> Path:
    """Synthetic trajectory (seed 0, as bench.py builds it) and an INI. With
    ``angle`` the trajectory also holds N_P P atoms (uniform in the box,
    jittered like the O sites) and the INI is the angle deployment:
    AngleTopology grouping GROUP O per P, FermiAngle with theta THETA.
    ``topk`` picks a top-K deployment on the same frames: "topk"
    (max_neighbors = TOPK_K) or "hydronium" (HydroniumTopology, HYD_K
    neighbors, the RELU transformation, relaxation time RELAX); "supercell"
    is tools/bench_topk_e2e.py's (SC_SITES sites in the SC_BOX cube, frames a
    random walk, SC_PROTONS protons, max_neighbors = TOPK_K, nbr_reuse off);
    "box4" is bench.py's cell as a random walk, replicated by
    box_multiplier = BOX_MULT (max_neighbors = TOPK_K, nbr_reuse at its
    default, auto); "box2" the same cell replicated 2 x 2 x 2 with
    nbr_reuse = on."""
    import numpy as np

    workdir.mkdir(parents=True, exist_ok=True)
    supercell = topk == "supercell"
    mult = {"box4": BOX_MULT, "box2": (2, 2, 2)}.get(topk, (1, 1, 1))
    walk = supercell or mult != (1, 1, 1)
    tag = "angle_" if angle else "sc_" if supercell else "walk_" if walk else ""
    n_sites, protons, box = ((SC_SITES, SC_PROTONS, SC_BOX) if supercell
                             else (N_SITES, N_PROTONS, BOX))
    traj = workdir / f"traj_{tag}{frames}.xyz"
    if not traj.exists():
        rng = np.random.RandomState(0)
        if walk:
            block = _walk_block(n_sites, frames, box)
            names = np.array(["O"] * n_sites)
        else:
            base = rng.uniform(0, BOX, size=(N_SITES, 3)).astype(np.float32)
            pbase = rng.uniform(0, BOX, size=(N_P if angle else 0, 3)).astype(np.float32)
            names = np.array(["O"] * N_SITES + ["P"] * len(pbase))
            atoms = np.vstack([base, pbase])
            block = (atoms[None] + np.stack([rng.normal(scale=0.03, size=atoms.shape)
                                             for _ in range(frames)])).astype(np.float32)
        lines = []
        for f in range(frames):
            lines.append(f"{len(names)}\nframe {f}\n")
            lines.append("".join(f"{a} {x:.6f} {y:.6f} {z:.6f}\n"
                                 for a, (x, y, z) in zip(names, block[f].tolist())))
        tmp = traj.with_suffix(".tmp")
        tmp.write_text("".join(lines))
        tmp.replace(traj)
    extra = ""
    if angle:
        topology = f"""type = AngleTopology
donor_atoms = O
extra_atoms = P
group_size = {GROUP}"""
        law = f"type = FermiAngle\ntheta = {THETA}"
    elif topk == "hydronium":
        topology = f"type = HydroniumTopology\ndonor_atoms = O\nneighbors = {HYD_K}"
        law = "type = Fermi"
        a, b, d0, left, right = RELU
        extra = f"""[DistanceTransformation]
type = ReLUTransformation
a = {a}
b = {b}
d0 = {d0}
left_bound = {left}
right_bound = {right}
[DistanceInterpolator]
relaxation_time = {RELAX}
"""
    elif topk:
        topology = f"type = NeighborTopology\ndonor_atoms = O\nmax_neighbors = {TOPK_K}"
        law = "type = Fermi"
    else:
        topology, law = "type = NeighborTopology\ndonor_atoms = O", "type = Fermi"
    copies = mult[0] * mult[1] * mult[2]
    name = f"run_{tag}{topk}{frames}_{replicas}{'_stale' if stale else ''}.ini"
    cfg = workdir / name
    cfg.write_text(f"""[Trajectory]
filename = {traj}
time_step = {DT}
[AtomBox]
type = AtomBoxCubic
periodic_boundaries = {box}, {box}, {box}
box_multiplier = {", ".join(str(m) for m in mult)}
[NeighborTopology]
{topology}
cutoff = {CUTOFF}
buffer = {BUFFER}
{extra}[JumpRate]
{law}
a = {FERMI[0]}
b = {FERMI[1]}
c = {FERMI[2]}
[KMCLattice]
lattice_size = {n_sites * copies}
proton_number = {protons * copies}
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
{"nbr_reuse = off" if supercell else "nbr_reuse = on" if topk == "box2" else ""}
""")
    return cfg


def parse_rows(text: str):
    lines = text.splitlines()
    header = [ln for ln in lines if ln.startswith("#") and "Sweeps" in ln]
    rows = [ln.split() for ln in lines if ln.strip() and not ln.startswith("#")]
    perf = [ln for ln in lines if ln.startswith("# perf:")]
    return header, rows, perf


def _counters():
    """The launch counter of every kernel wrapper, by kernel name."""
    from cmdlmc_tpu_torch.ops import kmc_sweep as ks
    from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss
    from cmdlmc_tpu_torch.ops import topk_sweep as ts
    from cmdlmc_tpu_torch.ops import water_sweep as ws
    from cmdlmc_tpu_torch.ops.knn_sparse import knn_sparse_tables
    from cmdlmc_tpu_torch.ops.knn_tables import knn_block_tables
    from cmdlmc_tpu_torch.ops.pairwise import pairwise_cubic

    return {"kmc_sweep_streamed": kss.kmc_sweep_streamed,
            "pairwise_cubic": pairwise_cubic, "kmc_sweep": ks.kmc_sweep,
            "topk_sweep": ts.topk_sweep, "knn_tables": knn_block_tables,
            "knn_sparse": knn_sparse_tables, "water_sweep": ws.water_sweep}


def _small_cuda_vs_cpu(label, cfg):
    """The same config and initial state on the card and on the CPU (plain
    versions) must land in the same final state, but for near-ties."""
    from cmdlmc_tpu_torch import driver

    finals = {}
    for d in ("cuda", "cpu"):
        finals[d] = driver.run_from_config(cfg, out=io.StringIO(), device=d).final_states
    a, b = finals["cuda"].replicas, finals["cpu"].replicas
    same = ((a.site_of_proton.cpu() == b.site_of_proton).all(dim=1)
            & (a.clock.event_count.cpu() == b.clock.event_count))
    n_diff, n = int((~same).sum()), same.numel()
    say(f"[e2e] small {label} run (N={a.occ.shape[1]}, R={n}): {n_diff} of {n} "
        f"replicas end differently on cuda vs cpu; events "
        f"{int(a.clock.event_count.sum())} vs {int(b.clock.event_count.sum())}")
    if n_diff > 2 or int(b.clock.event_count.sum()) == 0:
        raise AssertionError(f"cuda and cpu runs of the small {label} config disagree")


def _drive(label, cfg, card, frames, replicas, expect, refuse=(),
           n_sites=N_SITES, protons=N_PROTONS):
    """One end-to-end run through driver.run_from_config with every launch
    count set to 0 just before it and read just after; checks the output
    rows and that the kernels in `expect` launched and those in `refuse`
    did not. Returns the launch counts."""
    import numpy as np
    import torch

    from cmdlmc_tpu_torch import driver

    counters = _counters()
    buf = io.StringIO()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    sim = driver.run_from_config(cfg, out=buf, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    text = buf.getvalue()
    (WORK / f"e2e_output_{label.replace(' ', '_')}.txt").write_text(text)
    header, rows, perf = parse_rows(text)
    say(f"[e2e] {label}: launches {launches}")
    if not header or header[0].split()[1:8] != [
            "Sweeps", "Time", "MSD_x", "MSD_y", "MSD_z", "Autocorr", "Jumps"]:
        raise AssertionError(f"{label}: bad header: {header}")
    if not rows or any(len(r) != 7 for r in rows):
        raise AssertionError(f"{label}: rows missing or not 7 columns")
    vals = np.array(rows, dtype=np.float64)
    if not np.isfinite(vals).all():
        raise AssertionError(f"{label}: non-finite values in the output rows")
    if not (vals[:, 5] <= protons).all() or not (vals[:, 6] > 0).any():
        raise AssertionError(f"{label}: Autocorr > proton count or no jumps")
    if not perf:
        raise AssertionError(f"{label}: no '# perf:' line")
    if min(launches[k] for k in expect) <= 0 or any(launches[k] for k in refuse):
        raise AssertionError(
            f"{label}: expected launches of {expect} and none of {refuse}, "
            f"got {launches}")
    ev = sim.final_states.replicas.clock.event_count
    say(f"[e2e] {label}: {len(rows)} rows, frames {int(vals[0, 0])}.."
        f"{int(vals[-1, 0])}, last Autocorr {vals[-1, 5]:.2f} Jumps "
        f"{vals[-1, 6]:.2f}; {int(ev.sum())} events in total")
    say(f"[e2e] {label}: {perf[0]} ({card})")
    say(f"[e2e] {label}: wall {wall:.2f} s for {frames} frames x {replicas} "
        f"replicas x {n_sites} sites ({card})")
    return launches


def phase_end_to_end(card: str):
    """Four small runs (dense, angle, top-K, hydronium) held against the
    CPU, then the deployments end to end on the card: bench.py's at R=16384
    (stage 1 + K1, the main path) and at R=1024 (K3), the angle deployment at
    R=1024 (K3, law kind 4) and R=4096 (stage 1 with the angle W + K1), the
    top-K and hydronium deployments at R=4096 and the top-K supercell at
    N=4608 (K5 + K4 each, none of K1, K2, K3)."""
    _small_cuda_vs_cpu("dense", write_inputs(WORK, frames=64, replicas=256))
    _small_cuda_vs_cpu("angle", write_inputs(WORK, frames=64, replicas=256,
                                             angle=True))
    for topk in ("topk", "hydronium"):
        _small_cuda_vs_cpu(topk, write_inputs(WORK, frames=64, replicas=256, topk=topk))
    _small_cuda_vs_cpu("box x2 reuse on", write_inputs(WORK, frames=64, replicas=256,
                                                       topk="box2"))
    paths = {}
    paths["dense R=16384"] = _drive(
        "dense R=16384", write_inputs(WORK, frames=1024, replicas=REPLICAS),
        card, 1024, REPLICAS, expect=("kmc_sweep_streamed", "pairwise_cubic"),
        refuse=("kmc_sweep",))
    paths["dense R=1024"] = _drive(
        "dense R=1024", write_inputs(WORK, frames=1024, replicas=INKERNEL_REPLICAS,
                                     sweeps=512),
        card, 512, INKERNEL_REPLICAS, expect=("kmc_sweep",),
        refuse=("kmc_sweep_streamed", "pairwise_cubic"))
    paths["angle R=1024"] = _drive(
        "angle R=1024", write_inputs(WORK, frames=512, replicas=INKERNEL_REPLICAS,
                                     angle=True),
        card, 512, INKERNEL_REPLICAS, expect=("kmc_sweep",),
        refuse=("kmc_sweep_streamed",))
    paths["angle R=4096"] = _drive(
        "angle R=4096", write_inputs(WORK, frames=512,
                                     replicas=ANGLE_STREAMED_REPLICAS, angle=True),
        card, 512, ANGLE_STREAMED_REPLICAS,
        expect=("kmc_sweep_streamed", "pairwise_cubic"), refuse=("kmc_sweep",))
    dense = ("kmc_sweep_streamed", "pairwise_cubic", "kmc_sweep")
    for topk in ("topk", "hydronium"):
        label = f"{topk} R={TOPK_REPLICAS}"
        paths[label] = _drive(
            label, write_inputs(WORK, frames=512, replicas=TOPK_REPLICAS, topk=topk),
            card, 512, TOPK_REPLICAS, expect=("topk_sweep", "knn_tables"),
            refuse=dense)
    paths["topk supercell N=4608"] = _drive(
        "topk supercell N=4608",
        write_inputs(WORK, frames=512, replicas=SC_REPLICAS, topk="supercell"),
        card, 512, SC_REPLICAS, expect=("topk_sweep", "knn_tables"), refuse=dense,
        n_sites=SC_SITES, protons=SC_PROTONS)
    paths[BOX4] = _drive_box4(card)
    return paths


BOX4 = "topk supercell N=9216 box x4 reuse"


def _drive_box4(card: str):
    """The supercell deployment end to end: K4 and K6 launch (K6 at the
    rebuilds of Verlet candidate reuse, which the auto rule turns on), the
    dense kernels do not; prints the rebuild frames and K5's launches."""
    from cmdlmc_tpu_torch.ops import topk_sweep as ts

    cfg = write_inputs(WORK, frames=512, replicas=SC_REPLICAS, topk="box4")
    if "nbr_reuse" in cfg.read_text():
        raise AssertionError(f"{BOX4}: the config must leave nbr_reuse at its default")
    ts.topk_tables_verlet.rebuild_frames = 0
    launches = _drive(BOX4, cfg, card, 512, SC_REPLICAS,
                      expect=("topk_sweep", "knn_sparse"),
                      refuse=("kmc_sweep_streamed", "pairwise_cubic", "kmc_sweep"),
                      n_sites=BX_SITES, protons=BX_PROTONS)
    rebuilds = ts.topk_tables_verlet.rebuild_frames
    say(f"[e2e] {BOX4}: {rebuilds} rebuild frames of 512, knn_sparse launches "
        f"{launches['knn_sparse']}, knn_tables launches {launches['knn_tables']}")
    if not 0 < rebuilds < 512:
        raise AssertionError(f"{BOX4}: Verlet reuse rebuilt {rebuilds} of 512 frames")
    return launches


def write_water_inputs(workdir: Path, n: int, frames: int, replicas: int,
                       interp: bool = False, print_freq: int = PRINT_FREQ,
                       chunk: int = W_BLOCK) -> Path:
    """A synthetic water xyz made from seed 0 as tools/bench_water.py makes
    its frames (uniform O sites in the cube of the water density, 0.03 A of
    jitter per frame) and a KMCWater keyword config of the water deployment
    (``chunk_size 256``, ``print_frequency 100``; max_events is the fused
    path's 4); with ``interp`` its conversion_data is the 57-point table."""
    import numpy as np

    workdir.mkdir(parents=True, exist_ok=True)
    box = W_BOX * (n / W_SITES) ** (1.0 / 3.0)
    traj = workdir / f"water_{n}_{frames}.xyz"
    if not traj.exists():
        block = _jitter_block(n, frames, box)
        lines = []
        for f in range(frames):
            lines.append(f"{n}\nframe {f}\n")
            lines.append("".join(f"O {x:.6f} {y:.6f} {z:.6f}\n"
                                 for x, y, z in block[f].tolist()))
        tmp = traj.with_suffix(".tmp")
        tmp.write_text("".join(lines))
        tmp.replace(traj)
    extra = ""
    if interp:
        _, _, x, y = _water_transform("interp")
        table = workdir / "water_conversion.txt"
        np.savetxt(table, np.stack([x, y], axis=1), fmt="%.9g")
        extra = f"conversion_data {table}\n"
    a, b, _, left, right = W_LINEAR
    cfg = workdir / (f"water_{n}_{frames}_{replicas}_{print_freq}_{chunk}"
                     f"{'_interp' if interp else ''}.cfg")
    cfg.write_text(f"""filename {traj}
pbc {box} {box} {box}
md_timestep_fs {DT}
sweeps {frames}
print_frequency {print_freq}
chunk_size {chunk}
jumprate_params_fs a={FERMI[0]} b={FERMI[1]} c={FERMI[2]}
rescale_function linear
rescale_parameters a={a} b={b} left_bound={left} right_bound={right}
{extra}relaxation_time {W_RELAX}
d_oh {W_D_OH}
n_atoms 3
keep_last_neighbor_rescaled True
seed 3
replicas {replicas}
""")
    return cfg


def _water_rows(text: str):
    lines = text.splitlines()
    header = [ln for ln in lines if ln.startswith("#") and "O-Neighbor" in ln]
    rows = [ln.split() for ln in lines if ln.strip() and not ln.startswith("#")]
    warn = [ln for ln in lines if ln.startswith("# WARNING")]
    return header, rows, warn


def _run_water(cfg: Path, device: str):
    from cmdlmc_tpu_torch.cli.kmc_water import kmc_water_main
    from cmdlmc_tpu_torch.config.keyword import load_configfile

    buf = io.StringIO()
    states = kmc_water_main(load_configfile(str(cfg), config_name="KMCWater"), out=buf,
                            device=device)
    return buf.getvalue(), states


def _water_cuda_vs_cpu():
    """The N=216 water config at R=64 for 64 frames in blocks of 16,
    printing every 4th frame, on the card and on the CPU (plain versions)
    from the same initial states: the printed rows equal (but the fps
    column), and the final states but for near-ties."""
    cfg = write_water_inputs(WORK, W_SITES, 64, 64, print_freq=4, chunk=16)
    text, states = {}, {}
    for d in ("cuda", "cpu"):
        text[d], states[d] = _run_water(cfg, d)
    rows = {d: [r[:-1] for r in _water_rows(t)[1]] for d, t in text.items()}
    a, b = states["cuda"], states["cpu"]
    same = ((a.site.cpu() == b.site) & (a.clock.event_count.cpu() == b.clock.event_count)
            & (a.jumps.cpu() == b.jumps))
    n_diff = int((~same).sum())
    say(f"[e2e] small water run (N={W_SITES}, R=64, 64 frames): rows equal on cuda "
        f"and cpu: {rows['cuda'] == rows['cpu']} ({len(rows['cpu'])} rows); {n_diff} "
        f"of 64 replicas end differently; events {int(a.clock.event_count.sum())} vs "
        f"{int(b.clock.event_count.sum())}")
    if rows["cuda"] != rows["cpu"] or not rows["cpu"] or n_diff > 2 \
            or int(b.clock.event_count.sum()) == 0:
        raise AssertionError("cuda and cpu runs of the small water config disagree")


def _drive_water(label, cfg, card, n, frames, replicas):
    """One water run end to end through cli/kmc_water.py's main with every
    launch count set to 0 just before it and read just after: K5 and K7
    launch, no other kernel does; the rows are the header and one finite
    8-column row per print frame. Returns the launch counts."""
    import numpy as np
    import torch

    counters = _counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    text, states = _run_water(cfg, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    (WORK / f"e2e_output_{label.replace(' ', '_')}.txt").write_text(text)
    header, rows, warn = _water_rows(text)
    say(f"[e2e] {label}: launches {launches}")
    if not header or header[0].split()[1:] != ["Step", "Time", "x", "y", "z",
                                               "O-Neighbor", "Jumps", "fps"]:
        raise AssertionError(f"{label}: bad header: {header}")
    want_rows = len(range(0, frames, PRINT_FREQ))
    if len(rows) != want_rows or any(len(r) != 8 for r in rows):
        raise AssertionError(f"{label}: {len(rows)} rows (want {want_rows}) or not 8 columns")
    vals = np.array(rows, dtype=np.float64)
    if not np.isfinite(vals).all() or not ((vals[:, 5] >= 0) & (vals[:, 5] < n)).all():
        raise AssertionError(f"{label}: non-finite values or a site out of range")
    others = [k for k in launches if k not in ("knn_tables", "water_sweep")]
    if launches["knn_tables"] <= 0 or launches["water_sweep"] <= 0 or any(
            launches[k] for k in others):
        raise AssertionError(f"{label}: expected launches of K5 and K7 only, got {launches}")
    ev = states.clock.event_count
    disp = states.displacement
    if not bool(torch.isfinite(disp).all()):
        raise AssertionError(f"{label}: non-finite displacements")
    msd = (disp.double() ** 2).sum(dim=1).mean()
    say(f"[e2e] {label}: {len(rows)} rows, last Jumps {int(vals[-1, 6])}; "
        f"{int(ev.sum())} events in total ({float(ev.double().mean()):.2f} per "
        f"replica), final MSD {float(msd):.4f} A^2; {warn[0] if warn else 'no truncation warning'}")
    say(f"[e2e] {label}: wall {wall:.2f} s for {frames} frames x {replicas} replicas x "
        f"{n} sites: {n * replicas * frames / wall:.4e} site-updates/s ({card})")
    return launches


W216, W1728 = "water N=216 R=8192", "water N=1728 R=8192 interp"


def phase_water(card: str):
    """The water deployment end to end through the port's kmc_water main:
    a small run held against the CPU, then N=216 at R=8192 over 1024
    frames and N=1728 (its 57-point table) over 512 frames, K5 + K7 each."""
    _water_cuda_vs_cpu()
    paths = {W216: _drive_water(W216, write_water_inputs(WORK, W_SITES, 1024, W_REPLICAS),
                                card, W_SITES, 1024, W_REPLICAS)}
    paths[W1728] = _drive_water(
        W1728, write_water_inputs(WORK, W_BIG_SITES, 512, W_REPLICAS, interp=True),
        card, W_BIG_SITES, 512, W_REPLICAS)
    return paths


def _union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


VERLET_RANGE = "verlet_tables"


def _host_ranges():
    """(object, attribute, range name, kind) of the driver's host stages
    that phase_profile wraps in profiler ranges: kind "call" for a
    function, "iter" for a method returning an iterator (the range covers
    each ``next``), "gen" for a generator method (the range covers its
    whole run)."""
    from cmdlmc_tpu_torch import driver
    from cmdlmc_tpu_torch.engine import fused as eng_fused
    from cmdlmc_tpu_torch.engine import lattice as eng
    from cmdlmc_tpu_torch.io import stream
    from cmdlmc_tpu_torch.models import water as wm
    from cmdlmc_tpu_torch.ops import knn_sparse as kns
    from cmdlmc_tpu_torch.ops import topk_sweep as ts

    # the water CLI imports prefetch when it runs, so the patched one (the
    # driver bound its own at import and is not affected)
    return [(wm, "init_water_states", "init_water_states", "call"),
            (stream, "prefetch", "water_next_block", "iter"),
            (wm, "run_water_block_fused", "water_block", "call"),
            (eng, "init_replicas", "init_replicas", "call"),
            (driver.Simulation, "_blocks", "next_block", "iter"),
            (eng_fused, "run_block_fused", "run_block", "call"),
            (ts, "topk_tables_verlet", VERLET_RANGE, "call"),
            (kns, "sparse_plan_for", "sparse_plan", "call"),
            (driver.Simulation, "_fused_post", "fused_post", "call"),
            (driver.Simulation, "_emit_fused", "emit_rows", "gen")]


@contextlib.contextmanager
def _annotated():
    """Run the host stages of :func:`_host_ranges` inside profiler ranges of
    their names, for :func:`_verlet_epilogue_ms` and :func:`_idle_report`
    (the port itself carries no annotation). A wrapped function's
    attributes (a launch or rebuild counter) are carried over and back."""
    from torch.profiler import record_function

    def wrap(inner, name, kind):
        if kind == "iter":
            def annotated(*args, **kwargs):
                it = iter(inner(*args, **kwargs))
                while True:
                    with record_function(name):
                        item = next(it, it)
                    if item is it:
                        return
                    yield item
        elif kind == "gen":
            def annotated(*args, **kwargs):
                with record_function(name):
                    items = list(inner(*args, **kwargs))
                yield from items
        else:
            def annotated(*args, **kwargs):
                with record_function(name):
                    return inner(*args, **kwargs)
        annotated.__dict__.update(inner.__dict__)
        return annotated

    patched = []
    try:
        for obj, attr, name, kind in _host_ranges():
            inner = getattr(obj, attr)
            setattr(obj, attr, wrap(inner, name, kind))
            patched.append((obj, attr, inner))
        yield
    finally:
        for obj, attr, inner in reversed(patched):
            inner.__dict__.update(getattr(obj, attr).__dict__)
            setattr(obj, attr, inner)


def _overlap_us(spans, intervals) -> float:
    """Time of the (start, end) spans that lies in the disjoint intervals."""
    return sum(max(0.0, min(b, d) - max(a, c)) for a, b in spans for c, d in intervals)


def _idle_report(all_events, device_events, main_kernel):
    """Where the traced run's device idles: before the first launch of
    `main_kernel`, between its first and last launch, and after; for the
    first two, the time of each host range of :func:`_host_ranges` that
    overlaps the idle time (ranges nest: run_block holds verlet_tables, which
    holds sparse_plan) and the idle time that no range covers. Returns text."""
    host = [e for e in all_events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime")]
    t_begin = min(e["ts"] for e in host)
    t_end = max(max(e["ts"] + e["dur"] for e in host),
                max(e["ts"] + e["dur"] for e in device_events))
    idle, end = [], t_begin
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in device_events):
        if a > end:
            idle.append((end, a))
        end = max(end, b)
    if t_end > end:
        idle.append((end, t_end))
    mains = [(e["ts"], e["ts"] + e["dur"]) for e in device_events
             if main_kernel in e["name"]]
    first, last = min(a for a, _ in mains), max(b for _, b in mains)

    def clip(lo, hi):
        return [(max(a, lo), min(b, hi)) for a, b in idle if min(b, hi) > max(a, lo)]

    ranges = {}
    for e in all_events:
        if e.get("cat") == "user_annotation" and "dur" in e:
            ranges.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    names = [name for _, _, name, _ in _host_ranges() if name in ranges]
    covered = [span for spans in ranges.values() for span in spans]

    def breakdown(parts):
        total = sum(b - a for a, b in parts)
        free = total - _union_us(
            (max(a, c), min(b, d)) for a, b in covered for c, d in parts
            if min(b, d) > max(a, c))
        shares = [f"{name} {_overlap_us(ranges[name], parts) / 1e3:.2f}" for name in names]
        return total, f"{', '.join(shares)}, in no range {free / 1e3:.2f} ms"

    head, head_by = breakdown(clip(t_begin, first))
    between = clip(first, last)
    mid, mid_by = breakdown(between)
    tail = sum(b - a for a, b in clip(last, t_end))
    big = sorted((b - a for a, b in between), reverse=True)
    return (f"idle before the first {main_kernel} launch {head / 1e3:.2f} ms "
            f"({head_by}); between its launches {mid / 1e3:.2f} ms in "
            f"{sum(g >= 1e3 for g in big)} gaps of 1 ms or more (largest "
            f"{', '.join(f'{g / 1e3:.2f}' for g in big[:4])} ms; {mid_by}); "
            f"after the last {tail / 1e3:.2f} ms")


def _verlet_epilogue_ms(events, knn_kernels) -> float:
    """Device time of the kernels launched inside VERLET_RANGE, but for
    the K-nearest kernels of the rebuilds: the drift tests and the
    frozen-id distances and gathers (matched by the launch's correlation
    id)."""
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("name") == VERLET_RANGE and e.get("cat") == "user_annotation"]
    corr = {e["args"]["correlation"] for e in events
            if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})
            and any(a <= e["ts"] <= b for a, b in ranges)}
    return sum(e["dur"] for e in events
               if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in corr
               and not any(k in e["name"] for k in knn_kernels)) / 1e3


def phase_profile(card: str):
    """Where the end-to-end run's time goes: the bench.py deployment with
    fresh and with stale rates, both top-K supercells and the water N=216
    deployment (through the kmc_water main), each traced with
    torch.profiler after a warm run. The fresh run is traced four times, in
    turns with K1's lists sized on the host (LIST_SCRATCH_BUDGET = 0: the
    host waits for the counted lengths before each launch) and on the device
    (the default: no wait), to show what the host's wait costs. Device busy time is the union of kernel
    and copy intervals in the trace; idle is the rest of the traced wall
    time; the box x4 run's Verlet epilogue is the device time launched from
    its stage 1 but for K5 and K6. Each run's idle time is split at the
    first and last launch of its main kernel (K1, K4, K7) and laid against
    the host stages (:func:`_idle_report`). Also times the host's xyz parse
    of the dense and the water trajectories alone."""
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
    water_cfg = write_water_inputs(WORK, W_SITES, 1024, W_REPLICAS)
    t0 = time.perf_counter()
    frames = sum(pos.shape[0] for _, pos, _ in XYZTrajectory(
        WORK / f"water_{W_SITES}_1024.xyz", time_step=DT,
        batch_frames=W_BLOCK).iter_batches())
    say(f"[profile] host xyz parse of {frames} frames x {W_SITES} atoms: "
        f"{time.perf_counter() - t0:.3f} s (numpy tokenizer, one thread)")
    dense = {"K1": "kmc_sweep_streamed_kernel", "K2": "pairwise_kernel"}
    knn = {"K5": "knn_tables_kernel", "K6": "knn_sparse_kernel"}
    fresh = write_inputs(WORK, frames=1024, replicas=REPLICAS)
    runs = [("fresh, host-sized lists", fresh, dense), ("fresh", fresh, dense),
            ("fresh again", fresh, dense),
            ("fresh, host-sized lists again", fresh, dense),
            ("stale", write_inputs(WORK, frames=1024, replicas=REPLICAS, stale=True),
             dense),
            ("supercell", write_inputs(WORK, frames=512, replicas=SC_REPLICAS,
                                       topk="supercell"),
             {"K4": "topk_sweep_kernel", "K5": "knn_tables_kernel"}),
            ("box4", write_inputs(WORK, frames=512, replicas=SC_REPLICAS, topk="box4"),
             {"K4": "topk_sweep_kernel", **knn}),
            ("water", water_cfg, {"K7": "water_sweep_kernel", "K5": "knn_tables_kernel"})]
    from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss

    scratch_budget = kss.LIST_SCRATCH_BUDGET
    for name, cfg, kernels in runs:
        kss.LIST_SCRATCH_BUDGET = 0 if "host-sized" in name else scratch_budget
        if name == "water":
            def run(out, cfg=cfg):
                out.write(_run_water(cfg, "cuda")[0])
        else:
            def run(out, cfg=cfg):
                driver.run_from_config(cfg, out=out, device="cuda")
        run(io.StringIO())  # warm
        torch.cuda.synchronize()
        buf = io.StringIO()
        with _annotated(), profile(activities=[ProfilerActivity.CPU,
                                                      ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(buf)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        trace = WORK / f"e2e_trace_{name.replace(',', '').replace(' ', '_')}.json"
        prof.export_chrome_trace(str(trace))
        all_events = json.loads(trace.read_text())["traceEvents"]
        events = [e for e in all_events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and "dur" in e]
        if not events:
            raise AssertionError("the trace holds no device activity")
        busy = _union_us((e["ts"], e["ts"] + e["dur"]) for e in events) / 1e3
        shares = []
        rest = busy
        for tag, kname in kernels.items():
            ms = sum(e["dur"] for e in events if kname in e["name"]) / 1e3
            rest -= ms
            shares.append(f"{tag} {ms:.3f} ms ({100 * ms / busy:.2f}% of busy)")
        epilogue = _verlet_epilogue_ms(all_events, knn.values())
        if epilogue:
            rest -= epilogue
            shares.append(f"Verlet epilogue {epilogue:.3f} ms "
                          f"({100 * epilogue / busy:.2f}% of busy)")
        perf = [ln for ln in buf.getvalue().splitlines()
                if ln.startswith("# perf:")]
        say(f"[profile] {name}: traced wall {wall_ms:.2f} ms, device busy "
            f"{busy:.2f} ms, idle {100 * (1 - busy / wall_ms):.1f}%; "
            + ", ".join(shares)
            + f", other device work {100 * rest / busy:.2f}% ({card})")
        if name == "water":
            perf = [f"{W_SITES * W_REPLICAS * 1024 / (wall_ms / 1e3):.4e} site-updates/s "
                    "over the traced wall"]
        say(f"[profile] {name}: {perf[0] if perf else 'no perf line'}; "
            f"trace {trace}")
        main_tag, main_kernel = next(iter(kernels.items()))
        say(f"[profile] {name}: {main_tag} ({main_kernel}) "
            f"{_idle_report(all_events, events, main_kernel)}")
    kss.LIST_SCRATCH_BUDGET = scratch_budget


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace the dense end-to-end run (fresh and "
                         "stale rates) and the top-K supercells with "
                         "torch.profiler and print where the device time "
                         "goes")
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
    k3 = phase_k3(dev)
    k5 = phase_k5(dev)
    k6 = phase_k6(dev)
    k4 = phase_k4(dev)
    k7 = phase_k7(dev)
    paths = phase_end_to_end(card)
    paths.update(phase_water(card))
    if opts.profile:
        phase_profile(card)

    # each kernel's launches in the end-to-end run of its own path: K1 and
    # K2 on the main path (R=16384), K3 on the in-kernel route (R=1024), K4
    # and K5 on the top-K path (R=4096), K6 on the box x4 supercell, K7 on
    # the water path (N=216, R=8192)
    main_path, inkernel_path = paths["dense R=16384"], paths["dense R=1024"]
    topk_path = paths[f"topk R={TOPK_REPLICAS}"]
    kernels = [
        {"name": "kmc_sweep_streamed", "route": "cuda",
         "source": "cmdlmc_tpu_torch/csrc/kmc_sweep_streamed.cu",
         "replaces": "cmdlmc_tpu/ops/kmc_sweep_streamed.py:628",
         "launches": main_path["kmc_sweep_streamed"], **k1},
        {"name": "pairwise_cubic", "route": "cuda",
         "source": "cmdlmc_tpu_torch/csrc/pairwise.cu",
         "replaces": "cmdlmc_tpu/ops/pairwise.py:55",
         "launches": main_path["pairwise_cubic"], **k2},
        {"name": "kmc_sweep", "route": "cuda",
         "source": "cmdlmc_tpu_torch/csrc/kmc_sweep.cu",
         "replaces": "cmdlmc_tpu/ops/kmc_sweep.py:690",
         "launches": inkernel_path["kmc_sweep"], **k3},
        {"name": "topk_sweep", "route": "cuda",
         "source": "cmdlmc_tpu_torch/csrc/topk_sweep.cu",
         "replaces": "cmdlmc_tpu/ops/topk_sweep.py:1538",
         "launches": topk_path["topk_sweep"], **k4},
        {"name": "knn_tables", "route": "cuda",
         "source": "cmdlmc_tpu_torch/csrc/knn_tables.cu",
         "replaces": "cmdlmc_tpu/ops/knn_tables.py:122",
         "launches": topk_path["knn_tables"], **k5},
        {"name": "knn_sparse", "route": "cuda",
         "source": "cmdlmc_tpu_torch/csrc/knn_sparse.cu",
         "replaces": "cmdlmc_tpu/ops/knn_sparse.py:293",
         "launches": paths[BOX4]["knn_sparse"], **k6},
        {"name": "water_sweep", "route": "cuda",
         "source": "cmdlmc_tpu_torch/csrc/water_sweep.cu",
         "replaces": "cmdlmc_tpu/ops/water_sweep.py:506",
         "launches": paths[W216]["water_sweep"], **k7},
    ]
    say(f"[e2e] launches by path: {json.dumps(paths)}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
