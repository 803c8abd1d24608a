#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cmdlmc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--k4-before CSRC]

Phases, each printing as it goes; any failure raises, so the run exits
nonzero without the final ``ok`` line:

1. environment: torch / CUDA versions, the card, its power limit;
2. build: every kernel in ``cmdlmc_tpu_torch/csrc/`` with nvcc for sm_90a,
   one nvcc per source, all at once;
3. RNG: the CUDA counter hash against the torch hash, bit for bit;
4. K2 (distance matrices) against its plain PyTorch version bit for bit,
   timed at the main path's [100, 144, 144] and at [16, 1152, 1152];
5. K1 (streamed event loop) against its plain version, stale off and on, at
   N=144 and N=256, with whole rows at N=256 (its lists in global memory),
   and every output against the SHA-256 digests recorded from the dense
   kernel before the row lists (PARENT_DIGESTS); timed at the main path's
   launch, with the launch plan (list lengths counted on the card, shared
   memory, where the lists live, blocks per SM) and the bound from the
   least work (`sweep_work`) beside the dense count; then with jump
   statistics (20 bins and the jump matrix) at that launch, in bench.py's
   cube and in a monoclinic cell (the triclinic minimum image): histograms
   and exposure equal to the plain version's on the replicas that agree
   (the exposure bit for bit), the matrix counting every jump, every output
   equal to the same launch without statistics, timed in turns with it;
6. K3 (in-kernel-W event loop) against its plain version for the law kinds
   0-4, with whole rows at N=224 (the route's largest N; the lists in
   global memory), and against the recorded digests; against stage 1 + K1
   on the same state, at 2-16 warps per block, and the two routes timed at
   8, 16 and 128 RNG tiles; kind 0 at the route's launch with jump
   statistics, held and timed as K1's;
7. K5 (K-nearest tables) against its plain version at [B=100 and 256,
   N=144] (k=8, and k=4 for hydronium; the full scan) and [B=64, N=4608]
   (k=8; the cell route), timed there with the bound from the pairs the
   route needs beside the all-pairs count; K6 (the same tables over a
   spatial plan built on the card) against its plain version and against
   K5 bit for bit, its plan against the plan's plain version (integers
   exact), at the box x4 path's rebuild launch [1, 9216], at [64, 9216] and
   at the N=4608 supercell's launch [64, 4608], K6 with its plan, the plan
   alone and K6's kernel alone timed in turns with K5 there, with the kept
   share of the pairs and two bounds (the pairs in neighbouring bins, K6's
   bound; this plan's kept pairs), and K6 and K5 timed in turns from 162 to
   9216 sites (the route sweep); at every K5 shape here and in 9
   the tables equal the K5 before its cell route bit for bit
   (PARENT_K5_DIGESTS, the SHA-256 recorded from it);
8. K4 (top-K event loop) against its plain version: TopKPairRates k=8 and
   HydroniumRates k=4 (ReLU, relaxation time 20, the blend in the loop) at
   R=4096, B=100, N=144; law kinds 1-3, a triclinic cell, 16 events a frame
   and slots that empty at R=256, B=16; the supercells R=4096, B=16,
   N=4608, P=3072 and N=9216, P=6144, and N=14976 at R=256, B=4 (K4's state
   in global scratch); timed at R=4096 with its in-neighbour lists' build,
   the events per replica-frame and the bound from the least work beside
   the count of a full evaluation per event; with ``--k4-before CSRC`` also
   the parent's K4 (from the parent's csrc/) and this K4 without its staged
   first evaluation, timed in turns with it; the top-K launch with jump
   statistics (the events' table distances, the exposure over the K slots),
   held and timed as K1's;
9. the water tables (K5 with no cutoff, then the transform) bit for bit
   against their plain version at [256, 216] (the full scan) and
   [256, 1728] (the verified cell search); K7 (the water event loop and its
   prefix pre-pass) against its plain version at the water path's shape
   (N=216, R=8192, RNG tiles of 256, the linear transform, keep_last,
   check_from_old, relaxation 10, d_OH 0.3) over 100 frames, and for the
   ramp, the 57-point table, n_atoms = 4 and a waiting time at R=1024,
   B=32; K7 timed at its path's launch (R=8192, B=256) at N=216 and N=1728
   at 32 to 256 threads per block in turns; every K7 output at every case
   equal to the K7 before its prefix table bit for bit (PARENT_K7_DIGESTS);
10. end to end through ``driver.run_from_config`` on synthetic trajectories:
   the ``bench.py`` deployment (144 sites, 96 protons, 256-frame blocks) at
   16384 replicas (stage 1 + K1) and at 1024 (K3), the angle deployment of
   ``tools/bench_fused_variants.py`` (36 P atoms, FermiAngle) at 1024 (K3)
   and 4096 replicas (stage 1 + K1), that tool's top-K (k=8) and hydronium
   (k=4) deployments at 4096 replicas, and ``tools/bench_topk_e2e.py``'s
   supercell (4608 sites, 3072 protons, 4096 replicas; K6 + K4), and the
   box x4 supercell (bench.py's cell with box_multiplier = 4, 4, 4: 9216
   sites, 6144 protons, 4096 replicas, Verlet candidate reuse by the auto
   rule; K6 + K4), each with its own launch counts; then bench.py's
   deployment at R=16384 with ``jumpstat_bins = 20`` and a jump-matrix file
   (K2 + K1; its rows equal those of the run without statistics bit for
   bit, its saved matrix sums to its events), bench.py's sites in a
   monoclinic cell at R=16384 (K1 with the triclinic minimum image, no K2)
   and the ``jumpstat`` CLI at R=1024 (K3) with ``--fit``; before them small
   dense, jumpstat, monoclinic, angle, top-K, hydronium and box x2 reuse
   runs are held against the same runs on the CPU;
11. the water deployment of ``tools/bench_water.py`` end to end through the
   port's ``kmc_water`` main (K5 + K7): 216 O sites at 8192 replicas over
   1024 frames and 1728 sites (its 57-point conversion table) over 512
   frames, each with its own launch counts, wall time and site-updates/s;
   before them a small water run (R=64, 64 frames) whose rows on the card
   equal those on the CPU; after them, past the 19,370 sites of the K7
   before its prefix table, the water tables and K7 against their plain
   versions at N=20000 and the CLI run there (R=256, 16 frames);
12. the host's side of ``mdmc``: the native xyz tokenizer must build and
   load on the card's host, timed against the numpy path at 1024 x 144,
   1024 x 216 and 64 x 4608 with the count of floats where they differ;
   ``mdmc --legacy`` on a keyword config (R=256, K3) and ``mdmc --profile
   DIR`` (its trace holds the card's kernels); trajconv and an HDF5 run
   equal to the xyz run where h5py imports (else it says so);
13. checkpoints: the ``bench.py`` deployment (R=16384, 1024 frames, a save
   every 256-frame block; K2 + K1) and the box x4 supercell (512 frames,
   reuse by the auto rule; K6, the Verlet epilogue and K4) each straight
   through, then stopped halfway and resumed: rows and final states (the
   neighbor carry included) equal bit for bit; each save's host and write
   time and the device gap it leaves between the event loop's launches,
   the load's time and the walls with and without saves;
14. XYZOutput at R=1024 (K3): its final state equals the observables run's
   bit for bit, its frames are well formed, and stopped and resumed it
   prints the same frames;
15. with ``--profile`` only: the R=16384 end-to-end run (fresh and stale
   rates), the two top-K supercell runs and the water N=216 run traced
   with torch.profiler (device busy and idle time, each kernel's share, the
   Verlet epilogue's, that of K4's in-neighbour lists and that of torch's
   sort and cumsum of K5's cell lists; for each run the idle time before the first
   launch of its main kernel apart from the gaps between launches, and the
   host ranges that fill those gaps), and the host's xyz parse of the dense
   and water trajectories timed alone.

With ``--k4-before CSRC`` (a copy of the parent tree's csrc/, e.g. from
``git archive``) the parent's K1, K2, K3, K4, K5, K6 and K7 are built
beside this tree's; K1, K2, K3, K5, K6 and K7 are held to them bit for bit
in this run (K6 against the parent's K6 over the same plan) and all seven
timed in turns with them.

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
import ctypes
import hashlib
import io
import json
import math
import re
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

# Jump statistics: [Output] jumpstat_bins = 20 over the schema's default
# jumpstat_range, with the jump matrix ([Engine] jumpmatrix_filename)
STATS_BINS, STATS_RANGE = 20, (2.0, 3.0)
# the monoclinic deployment: bench.py's sites (uniform in fractional
# coordinates) in a monoclinic cell whose smallest height, 14.0 A, keeps
# cutoff + buffer (5.0) under half of it, as the skew gate asks
MONO_VECTORS = ((BOX, 0.0, 0.0), (3.0, 14.0, 0.0), (0.0, 0.0, BOX))

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


def device_ms(fn, reps: int = 20, names=None) -> float:
    """Mean device time of fn() in ms per call: the durations of the device
    work (kernels, memsets, copies) its calls launched, or of the kernels
    whose names hold one of `names`, in a torch.profiler trace of `reps`
    calls after a warm call. Unlike cuda_ms it leaves out the host's time
    between launches, which bounds the small shapes. Where two traces in a
    row hold no device work it says so and returns cuda_ms's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    WORK.mkdir(parents=True, exist_ok=True)
    trace = WORK / "device_ms_trace.json"
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        events = [e for e in json.loads(trace.read_text())["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy") and "dur" in e
                  and (names is None or any(n in e.get("name", "") for n in names))]
        if events:
            return sum(e["dur"] for e in events) / 1e3 / reps
    # CUPTI now and then hands the profiler no device records for a window:
    # time the same calls with CUDA events, which include the host's gaps
    ms, _ = cuda_ms(fn, reps)
    say(f"[device_ms] two profiler windows held no device work; {ms:.4f} ms per "
        "call from CUDA events (host gaps included)")
    return ms


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


def pairwise_bound(batch: int, n: int) -> dict:
    """K2's bound: PAIRWISE_OPS per output; the positions read once and the
    [B, N, N] distances written once (the store bounds it)."""
    return bound(PAIRWISE_OPS * batch * n * n, 4.0 * batch * n * (n + 3))


def _parent_pairwise(lib, pos, box3):
    """The parent's K2 (one thread per output) launched as its wrapper
    launched it."""
    import torch

    from cmdlmc_tpu_torch.ops import build

    B, n, _ = pos.shape
    out = torch.empty((B, n, n), dtype=torch.float32, device=pos.device)
    build.check(lib.cmdlmc_pairwise(pos.data_ptr(), B, n, *(float(x) for x in box3),
                                    out.data_ptr(), build.stream_of(pos),
                                    pos.device.index or 0), "parent K2")
    return out


def phase_k2(dev, libs=None):
    """K2 against pairwise_reference on the card, bit for bit: at N=143 (rows
    not 16-byte aligned: scalar stores), N=144 with positions far outside
    the box, N=1152, and 70000 frames of 4 sites (more frames than a grid
    row and than the launch's blocks); timed at the main path's launch shape
    [PRINT_FREQ, 144, 144] and at the dense supercell's [16, 1152, 1152]
    (85 MB of stores), in turns with the parent's K2 when `libs` holds it
    (parent, this, this, parent; held to it bit for bit there)."""
    import numpy as np
    import torch

    from cmdlmc_tpu_torch.ops.pairwise import pairwise_cubic, pairwise_reference

    def same(got, want):
        return bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))

    for n, batch, box, lo, hi in ((143, 16, (BOX,) * 3, 0.0, BOX),
                                  (N_SITES, 16, (BOX,) * 3, -5.0, 35.0),
                                  (1152, 2, (29.0,) * 3, -5.0, 35.0),
                                  (4, 70000, (BOX,) * 3, -5.0, 35.0)):
        rng = np.random.RandomState(n)
        pos = torch.from_numpy(rng.uniform(lo, hi, size=(batch, n, 3))
                               .astype(np.float32)).to(dev)
        got = pairwise_cubic(pos, box)
        want = pairwise_reference(pos, torch.tensor(box, device=dev))
        err = float((got - want).abs().max())
        say(f"[k2] N={n} B={batch}: bit for bit against the plain version: "
            f"{same(got, want)} (max |kernel - plain| {err:.3e})")
        if not same(got, want):
            raise AssertionError(f"K2 differs from its plain version at N={n} B={batch}")
    result = {}
    for batch, n, box in ((PRINT_FREQ, N_SITES, BOX), (16, 1152, 29.0)):
        rng = np.random.RandomState(batch)
        pos = torch.from_numpy(rng.uniform(0, box, size=(batch, n, 3))
                               .astype(np.float32)).to(dev)
        box3 = (box,) * 3
        box_t = torch.tensor(box3, device=dev)
        turns = {"parent": [], "this": []}
        order = ("parent", "this", "this", "parent") if libs else ("this", "this")
        parent = None
        for name in order:
            if name == "parent":
                t, parent = cuda_ms(lambda: _parent_pairwise(libs["parent_pairwise"], pos,
                                                             box3), reps=50)
            else:
                t, got = cuda_ms(lambda: pairwise_cubic(pos, box3), reps=50)
            turns[name].append(t)
        plain_ms, want = cuda_ms(lambda: pairwise_reference(pos, box_t), reps=5)
        dev_ms = {"this": device_ms(lambda: pairwise_cubic(pos, box3))}
        if libs:
            dev_ms["parent"] = device_ms(
                lambda: _parent_pairwise(libs["parent_pairwise"], pos, box3))
        b_ = pairwise_bound(batch, n)
        if not same(got, want) or (parent is not None and not same(got, parent)):
            raise AssertionError(f"K2 [{batch},{n},{n}] differs from its plain version "
                                 "or the parent's")
        ms = min(turns["this"])
        say(f"[k2] [{batch},{n},{n}]: bit for bit against the plain version"
            + (" and the parent's K2" if parent is not None else "") + "; in turns: "
            + "; ".join(f"{k} " + ", ".join(f"{t:.4f}" for t in v) + " ms"
                        for k, v in turns.items() if v)
            + " (per call, CUDA events); the kernel's device time (profiler): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in dev_ms.items())
            + f"; plain {plain_ms:.4f} ms; bound {b_['bound_ms']:.5f} ms ({b_['bound_by']}), "
            f"{100 * b_['bound_ms'] / dev_ms['this']:.1f}% of it on the device, "
            f"{100 * b_['bound_ms'] / ms:.1f}% per call")
        if n == N_SITES:
            # no single PyTorch call computes minimum-image distances
            # (torch.cdist has no periodic images)
            result = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **b_,
                      "library_ms": None}
    return result


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


def _k1_stats_inputs(dev, mono=False):
    """The main path's launch (R=16384, B=100) with the stage-1 distances:
    bench.py's sites in its cube, or (``mono``) uniform in fractional
    coordinates of the MONO_VECTORS cell, seed 0, 0.03 A of jitter. Returns
    the sweep's arguments, the distances, the model and the sweep's
    geometry keywords."""
    import numpy as np
    import torch

    from cmdlmc_tpu_torch.core.cell import Cell
    from cmdlmc_tpu_torch.engine.lattice import init_replicas
    from cmdlmc_tpu_torch.ops.kmc_sweep_streamed import dense_tables
    from cmdlmc_tpu_torch.rates.laws import Fermi
    from cmdlmc_tpu_torch.topo.models import PairRates

    if not mono:
        args = _k1_inputs(dev, replicas=REPLICAS, frames=PRINT_FREQ)
        model = PairRates(Cell.cubic([BOX] * 3, device=dev),
                          Fermi(a=FERMI[0], b=FERMI[1], c=FERMI[2]).to(dev),
                          CUTOFF, BUFFER)
        return args, dense_tables(model, args[1], nbins=STATS_BINS)[1], model, {}
    rng = np.random.RandomState(0)
    base = rng.uniform(0, 1, size=(N_SITES, 3)) @ np.asarray(MONO_VECTORS)
    block = (base[None] + rng.normal(scale=0.03, size=(PRINT_FREQ, N_SITES, 3))
             ).astype(np.float32)
    cell = Cell.triclinic(MONO_VECTORS, device=dev)
    model = PairRates(cell, Fermi(a=FERMI[0], b=FERMI[1], c=FERMI[2]).to(dev),
                      CUTOFF, BUFFER)
    pos = torch.from_numpy(block).to(dev)
    w, dist = dense_tables(model, pos, nbins=STATS_BINS)
    ens = init_replicas(torch.Generator().manual_seed(0), REPLICAS, N_SITES,
                        N_PROTONS, pos[0], device=dev)
    rep = ens.replicas
    args = (w, pos, ens.prev_pos, ens.site_disp, rep.occ, rep.proton_of_site.float(),
            rep.site_of_proton, rep.t_last_jump, rep.disp_base,
            rep.clock.u_remaining, rep.clock.event_count)
    return args, dist, model, {"geometry": model.geometry}


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
    """Step every replica frame by frame through a kernel and through its
    plain version, each from its own state (``step(f, prev, s, state)``
    returns both outputs for frame f alone from one state; ``state`` in the
    order of ``keys``). A replica parts at the frame after which its integer
    state differs, having agreed before; for each (up to `cap`) give
    (replica, frame, smallest decision margin, decision) from
    ``margin(f, state, r)`` on the plain version's state. Each follows its
    own state because a decision can flip on float state that drifted apart
    over earlier frames (u_rem an ulp apart), which a replay of both from
    one shared state does not show."""
    import torch

    k_run = p_run = list(state0)
    found, agree = [], None
    for f in range(n_frames):
        got, want = step(f, p_run[0], p_run[1], p_run[2:])
        if not all(torch.equal(a, b) for a, b in zip(k_run, p_run)):
            got = step(f, k_run[0], k_run[1], k_run[2:])[0]
        now = _agreeing(got, want, int_keys)
        before = now.clone().fill_(True) if agree is None else agree
        for r in (before & ~now).nonzero()[:, 0].tolist():
            if len(found) < cap:
                found.append((r, f, *margin(f, p_run[2:], r)))
        agree = before & now
        k_run = [got["prev_pos"], got["site_disp"], *(got[k] for k in keys)]
        p_run = [want["prev_pos"], want["site_disp"], *(want[k] for k in keys)]
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


def _stats_kw(R, dev, seed=7) -> dict:
    """The sweeps' jump-statistics keywords: STATS_BINS bins over
    STATS_RANGE, the jump matrix, and histograms that do not start at zero
    (noise from `seed`), so the kernels' carry of their inputs is held too."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    hist = torch.from_numpy(rng.randint(0, 9, (R, STATS_BINS)).astype(np.int32))
    expo = torch.from_numpy(rng.randint(0, 99, (R, STATS_BINS)).astype(np.float32))
    return dict(jump_hist=hist.to(dev), exposure=expo.to(dev), nbins=STATS_BINS,
                hist_range=STATS_RANGE, track_matrix=True)


def _hold_stats(tag, label, got, want, ev0):
    """Hold a kernel's jump statistics to its plain version's on the replicas
    whose integer state agrees (:func:`_hold` bounds the others): histograms
    equal, the exposure equal bit for bit; the matrix counts every fired
    jump in both and, where no replica parted, is the plain version's.
    """
    import torch

    same = _agreeing(got, want)
    for k in ("jump_hist", "exposure"):
        if not torch.equal(got[k][same], want[k][same]):
            raise AssertionError(f"{tag} {label}: {k} differs from the plain version")
    for name, out in (("kernel", got), ("plain", want)):
        events = int((out["ev_count"] - ev0).sum())
        if int(out["jump_matrix"].sum()) != events or events == 0:
            raise AssertionError(f"{tag} {label}: the {name} jump matrix sums to "
                                 f"{int(out['jump_matrix'].sum())}, not {events} events")
    if bool(same.all()) and not torch.equal(got["jump_matrix"], want["jump_matrix"]):
        raise AssertionError(f"{tag} {label}: the jump matrix differs")
    say(f"[{tag}] {label}: jump histograms and exposure equal on the "
        f"{int(same.sum())} agreeing replicas (exposure bit for bit), the matrix "
        f"counts all {int(got['jump_matrix'].sum())} jumps"
        f"{' and equals the plain one' if bool(same.all()) else ''}; "
        f"{int(got['jump_hist'].sum())} binned jumps, "
        f"{float(got['exposure'].sum()):.0f} frames of exposure in all")


def _same_trajectory(tag, label, on, off):
    """The statistics draw nothing: the kernel with them lands where the
    kernel without them does, every output bit for bit."""
    import torch

    keys = OUT_KEYS + (("tlast_site",) if "tlast_site" in on else ())
    differ = [k for k in keys if not torch.equal(on[k], off[k])]
    if differ:
        raise AssertionError(f"{tag} {label}: with statistics {differ} differ "
                             "from the run without them")
    say(f"[{tag}] {label}: with statistics every output equals the run without "
        "them bit for bit")


def stats_bound(R, B, N, nbins, events, cands, table_bytes) -> dict:
    """Bound of the work the statistics add to a sweep: per replica-frame
    the exposure's `cands` candidates (a range test, the bin's subtract and
    multiply, an add: 4 each), per event the jump length (5) and its bin (4);
    bytes: the distances the exposure reads (`table_bytes`), both
    histograms read once and written once, the [N, N] int32 matrix
    written."""
    flops = 4.0 * R * B * cands + 9.0 * events
    nbytes = table_bytes + 2 * 2 * 4.0 * R * nbins + 4.0 * N * N
    return bound(flops, nbytes)


def _in_turns(fns, reps=3) -> dict:
    """Time each named function in turns, a, b, ..., then in the reverse
    order (CUDA events, `reps` calls each); {name: [ms, ms]} and the
    outputs of the last calls."""
    times, outs = {n: [] for n in fns}, {}
    for name in [*fns, *reversed(list(fns))]:
        ms, outs[name] = cuda_ms(fns[name], reps=reps)
        times[name].append(ms)
    return times, outs


def _turns_text(times) -> str:
    return "; ".join(f"{n} " + ", ".join(f"{t:.3f}" for t in ts_) + " ms"
                     for n, ts_ in times.items())


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


def phase_k1(dev, libs=None):
    """K1 against kmc_sweep_streamed_reference on the same W, and against
    the recorded digests, at every case of :func:`_k1_cases` (the whole-row
    case must put its lists in global memory); the main path's launch shape
    timed too, and with `libs` (:func:`_k4_before_libraries`) in turns with
    the parent's K1. Then K1 with jump statistics (STATS_BINS bins and the
    matrix) at that shape, in bench.py's cube and in the MONO_VECTORS cell,
    against its plain version (:func:`_hold_stats`) and against itself
    without them (the same trajectory bit for bit), timed in turns with
    statistics off."""
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
    if libs:
        this = lambda: kss.kmc_sweep_streamed(*args, 0, box3, 0, **kw)  # noqa: E731

        def parent():
            with _library(libs["parent_dense"]):
                return this()

        times, outs = _in_turns({"parent": parent, "this": this})
        if _digests(outs["parent"]) != _digests(got):
            raise AssertionError(f"K1 {label}: the parent's K1 gives other bits")
        say(f"[k1] {label}: the parent's K1 gives the same bits; in turns: "
            f"{_turns_text(times)}")

    for mono in (False, True):
        tag = "monoclinic" if mono else "cube"
        s_args, dist, model, geo = _k1_stats_inputs(dev, mono)
        s_box = None if mono else box3
        stats = _stats_kw(REPLICAS, dev)
        s_kw = {**kw, **geo}
        on = kss.kmc_sweep_streamed(*s_args, 0, s_box, 0, dist_block=dist, **s_kw,
                                    **stats)
        plain_on = kss.kmc_sweep_streamed_reference(*s_args, 0, s_box, 0,
                                                    dist_block=dist, **s_kw, **stats)
        slabel = f"{tag}, {STATS_BINS} bins and the matrix, R={REPLICAS} B={PRINT_FREQ}"
        worst = max(worst, _k1_check(slabel, s_args, on, plain_on, 0, s_box, s_kw))
        _hold_stats("k1", slabel, on, plain_on, s_args[10])
        off = kss.kmc_sweep_streamed(*s_args, 0, s_box, 0, **s_kw)
        _same_trajectory("k1", slabel, on, off)
        if mono:
            say(f"[k1] {slabel}: every decision and output as the plain version's "
                "with the triclinic minimum image")
            continue
        times, _ = _in_turns({
            "off": lambda: kss.kmc_sweep_streamed(*s_args, 0, s_box, 0, **s_kw),
            "on": lambda: kss.kmc_sweep_streamed(*s_args, 0, s_box, 0,
                                                 dist_block=dist, **s_kw, **stats)})
        s_events = int((on["ev_count"] - s_args[10]).sum())
        added = stats_bound(REPLICAS, PRINT_FREQ, N_SITES, STATS_BINS, s_events,
                            work["pairs"], 4.0 * PRINT_FREQ * N_SITES ** 2)
        whole = sweep_bound(REPLICAS, PRINT_FREQ, N_SITES, N_PROTONS, s_events, work,
                            w_bytes=w_bytes, extra_flops=4.0 * REPLICAS * PRINT_FREQ
                            * work["pairs"] + 9.0 * s_events,
                            extra_bytes=4.0 * PRINT_FREQ * N_SITES ** 2
                            + 16.0 * REPLICAS * STATS_BINS + 4.0 * N_SITES ** 2)
        say(f"[k1] {slabel}: in turns: {_turns_text(times)}; bound with statistics "
            f"{whole['bound_ms']:.4f} ms ({whole['bound_by']}), of the added work "
            f"alone {added['bound_ms']:.5f} ms ({added['bound_by']}: the [B, N, N] "
            "distances read, the histograms in and out, the matrix written)")
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


def _k3_stats(dev, libs, model, pos, pgrp, state, kw, off, work):
    """K3 at the in-kernel route's launch with jump statistics: held to its
    plain version and to its own run without them (`off`), timed in turns
    with statistics off and, with `libs`, with the parent's K3."""
    stats = _stats_kw(INKERNEL_REPLICAS, dev)
    label = (f"kind {kw['kind']} R={INKERNEL_REPLICAS} B={PRINT_FREQ}, {STATS_BINS} "
             "bins and the matrix")
    on = _k3_call(model, pos, pgrp, state, 0, **kw, **stats)
    want = _k3_call(model, pos, pgrp, state, 0, plain=True, **kw, **stats)
    _k3_check(label, model, pos, pgrp, state, on, want, 0, kw)
    _hold_stats("k3", label, on, want, state[8])
    _same_trajectory("k3", label, on, off)
    fns = {"off": lambda: _k3_call(model, pos, pgrp, state, 0, **kw),
           "on": lambda: _k3_call(model, pos, pgrp, state, 0, **kw, **stats)}
    if libs:
        def parent():
            with _library(libs["parent_dense"]):
                return fns["off"]()
        fns["parent"] = parent
    times, outs = _in_turns(fns)
    if libs and _digests(outs["parent"]) != _digests(off):
        raise AssertionError("K3: the parent's K3 gives other bits")
    s_events = int((on["ev_count"] - state[8]).sum())
    added = stats_bound(INKERNEL_REPLICAS, PRINT_FREQ, N_SITES, STATS_BINS, s_events,
                        work["pairs"], 0.0)
    say(f"[k3] {label}: in turns: {_turns_text(times)}"
        f"{' (the parent: the same bits)' if libs else ''}; bound of the added "
        f"work {added['bound_ms']:.5f} ms ({added['bound_by']}; {s_events} events)")


def phase_k3(dev, libs=None):
    """K3 against kmc_sweep_reference: at the in-kernel route's launch shape
    (R=1024, B=100; kind 0 with bench.py's Fermi law and kind 4 with the
    angle gate of the variant deployment), timed there; at R=256, B=16 for
    kinds 1-3; with whole rows at the route's largest N (224; the lists in
    global memory). Then K3 against stage 1 + K1 on the same state (kind 0,
    the two routes' agreement), K3 at 2, 4, 8 and 16 warps per block, and
    the two routes timed at 8, 16, 32, 64 and 128 RNG tiles, without and
    with jump statistics. Kind 0 at the launch
    shape also with jump statistics (STATS_BINS bins and the matrix) against
    the plain version and against itself without them, timed in turns with
    statistics off, and with `libs` K3 timed in turns with the parent's."""
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
        _k3_stats(dev, libs, model, pos, pgrp, state, kw, got, work)
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

    # route timing at 8, 16, 32, 64 and 128 RNG tiles, in turns: K3, stage
    # 1 + K1, both again in the other order; without and with jump statistics
    for r in (R, 2 * R, 4 * R, 8 * R, REPLICAS):
        if r == R:
            model, pos, state = k0[:3]
        else:
            model, pos, _, state = _k3_inputs(dev, r, B, 0)
        for stats in ({}, _stats_kw(r, dev)):

            def inkernel():
                return _k3_call(model, pos, None, state, 0, **kw, **stats)

            def streamed():
                if not stats:
                    return kss.kmc_sweep_streamed(kss.dense_tables(model, pos), pos,
                                                  *state, 0, model.box, 0, **kw1)
                w_, dist = kss.dense_tables(model, pos, nbins=STATS_BINS)
                return kss.kmc_sweep_streamed(w_, pos, *state, 0, model.box, 0,
                                              dist_block=dist, **kw1, **stats)

            a1, _ = cuda_ms(inkernel, reps=3)
            b1, _ = cuda_ms(streamed, reps=3)
            b2, _ = cuda_ms(streamed, reps=3)
            a2, _ = cuda_ms(inkernel, reps=3)
            say(f"[route] R={r} ({r // 128} tiles) B={B} kind 0"
                f"{f', {STATS_BINS} bins and the matrix' if stats else ''}: "
                f"in-kernel K3 {a1:.3f} / {a2:.3f} ms, stage 1 + K1 {b1:.3f} / "
                f"{b2:.3f} ms")
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


def _digest(tensors: dict) -> dict:
    """SHA-256 of each tensor's bytes."""
    return {k: hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for k, t in tensors.items()}


def _held_to_parent(tag, label, got: dict, recorded: dict, parent=None):
    """Hold a kernel's outputs to the parent kernel's: to `parent` (its
    outputs on the same inputs in this run, when --k4-before built it) and
    to the digests `recorded` from it (PARENT_K5_DIGESTS,
    PARENT_K7_DIGESTS), bit for bit. Prints the parent's digests where it
    ran, for recording; fails where neither is there."""
    mine = _digest(got)
    want = recorded.get(label)
    if parent is not None:
        theirs = _digest(parent)
        say(f"[{tag}] parent digests {label!r}: {json.dumps(theirs)}")
        differ = [k for k in mine if mine[k] != theirs[k]]
        if differ:
            raise AssertionError(f"{tag} {label}: {differ} differ from the parent's")
    if want is not None:
        differ = [k for k in mine if mine[k] != want.get(k)]
        if differ:
            raise AssertionError(f"{tag} {label}: {differ} differ from the recorded "
                                 "parent digests")
    elif parent is None:
        raise AssertionError(f"{tag} {label}: no recorded parent digest")
    against = [w for w, there in (("the recorded digests", want is not None),
                                  ("its run here", parent is not None)) if there]
    say(f"[{tag}] {label}: all {len(mine)} outputs equal the parent kernel's bit for "
        f"bit ({' and '.join(against)})")


# SHA-256 of K5's tables and K7's outputs at every shape and case chip_smoke
# holds them, recorded on an NVIDIA H100 80GB HBM3 from the kernels as they
# were before the cell route and the prefix table (K5 one thread per column
# over every row with a 16-entry list; K7 a copy of the prefix sum in each
# block's shared memory, advanced every frame). The kernels must reproduce
# them bit for bit.
PARENT_K5_DIGESTS = {
    "[100,144] k=8": {
        "topd": "9e3deba8c27566230e1a2e3253b6c34dacab6a84c98283acb8886217c902efa4",
        "topi": "14a544d7717f73ec1dca1ffd0ffd6e5566ce34340626302a1de28cb98c286904",
    },
    "[100,144] k=4": {
        "topd": "72563b41b1da96711f994c81bb83d1b34abc48799789738905a0bd7498e1445a",
        "topi": "da6e374e773c3285f38c7ddfba4cc44669656c4a6e95494203e1f12636db2cc1",
    },
    "[256,144] k=8": {
        "topd": "d3dfde4518001cf1a43ad41e744039117f13712c74359b079d0b7dab8c1e4c5d",
        "topi": "08de7ad236132ad42a0bfd0e02031a7df4eabf55eab19a48f50a2fbfabf71bec",
    },
    "[64,4608] k=8": {
        "topd": "e412ef521348795e483a0d28056b3ebe57d10f4c7c2cecbe6ce55b8d66fd45d8",
        "topi": "4314d070438bcc639fa6346b9b2b53575b779118ba252526aa537bcf41be8c05",
    },
    "[1,9216] k=8": {
        "topd": "d0eab025d81f053f28e79407f8d84d7502e4c450afab6c5ba31d7fa0458ad1b5",
        "topi": "99dbc4af9d2d50181bd902dbaf6cba39259859836825447eedbb5b88973b3c58",
    },
    "[64,9216] k=8": {
        "topd": "60f09fd523a6374be1315f17f35b5d7e52022a873502a95cc3ba4652583efc15",
        "topi": "ddfb394169fdb964f24b47bbdf4671a28c4de7cbfa986ace7b72690966fe0c1c",
    },
    "[256,216] k=3 no cutoff": {
        "topd": "ae00f14a830d6f355a1671a42a5a6d24fafebf37e89495b37a1eb24a2d3e8a64",
        "topi": "116ec4f8afbb98da4831ecb1ab3504a506bd2c351fe8060ab09372e57f3a26d5",
    },
    "[256,1728] k=3 no cutoff": {
        "topd": "249d9be50f7af6a80f2c40ab12f28c5a4aa6b616f67d342ccf9f54e891950f88",
        "topi": "a9415a311943c78ca8d880a66988f3925ce20a7252c3066572f5a20205839355",
    },
}
PARENT_K7_DIGESTS = {
    "linear n_atoms=3 R=8192 B=100 N=216 TR=256 {'relax': 10, 'waiting': 0, 'keep_last': True, 'check_old': True}": {
        "site": "9a6e66e9752c92c22edd3869e74a8043006cd8c2812183fb67d408208bf24b29",
        "last": "a08b93f7c5a658686f7ae3d0b5d538d51c003b963e7ff5f7ac46e217cc039a37",
        "fsj": "9ceeb42198174f2177c6262d444cba645435158e43d4b5f2e044794c3906d03a",
        "wait": "c35020473aed1b4642cd726cad727b63fff2824ad68cedd7ffb73c7cbd890479",
        "jumps": "100f71c9ea6ea078f8bc3726242c14a3cf8a5e0b799d364c28eed8a9cfa2069f",
        "ev_count": "100f71c9ea6ea078f8bc3726242c14a3cf8a5e0b799d364c28eed8a9cfa2069f",
        "u_rem": "ed698e2be44ef79fc8c4123fb8631885118acb910a88602ef9d503291a03c84f",
        "corr": "a02b8efba9344cd9736f2aefdbaffc291b2e68ca14613681476b3d470d428262",
        "disp_base": "5f0b61d67755e0751bcc25ef4f825926697b0057d3c6cf41ebd3c44336334c0e",
        "site_disp": "605fd38004acb8f0a0d22cfac0484796f2d7dee35e46d3874e7205e159dc1345",
        "prev_pos": "36131c36d546f586e5228954d683a35d61d8d32160036a651ab4097dc2290834",
        "trunc": "c35020473aed1b4642cd726cad727b63fff2824ad68cedd7ffb73c7cbd890479",
        "site_trace": "fcde8d430e0f5379d3b4effe8751d8fb3958bde37aa47176337325da3b36750e",
    },
    "ramp n_atoms=3 R=1024 B=32 N=216 TR=256 {'relax': 4, 'waiting': 3, 'keep_last': True, 'check_old': True}": {
        "site": "e2649ac6902e225a9592fafff88f10b5d7a34d40c7be92d9374a7ae186267376",
        "last": "d4179cbebdc5c580a1a2cb3166c102a71ae85eb8382bff8c0a7dc5d3669722a3",
        "fsj": "672e3a5e4997dedae162b218b4c3fd7323c668218a03a38ef65314a4d38b7d47",
        "wait": "ac64f315af03e37d142c083e959888536755b1e96747c182201ec5af2e64bae3",
        "jumps": "1be8c4d524c8d2567f57bebb9e8ff9c35910a30187c0cf036e2af56efc21b24a",
        "ev_count": "1be8c4d524c8d2567f57bebb9e8ff9c35910a30187c0cf036e2af56efc21b24a",
        "u_rem": "0ecf2f09e9af9e3735670a3d69dc40709e8bada85f505d7c07d5ccd01b841e9e",
        "corr": "066a9cc9c67d331b673ab6f7a01bbc2f823e60595c181658ffc13fb4f0ee6006",
        "disp_base": "7a53e16ef10af0cfa93e8b9bf5ce9486c476dcf2b280f669f67ceee976209b99",
        "site_disp": "e99863bb13b84c973988df2699aa9c7069c2bf8f85a3986f3a85917522d7790f",
        "prev_pos": "ebe0eb8bde43fb1b5df1f724fcf82083a79173fa922fbdaf4212f3f71d387fef",
        "trunc": "ad7facb2586fc6e966c004d7d1d16b024f5805ff7cb47c7a85dabd8b48892ca7",
        "site_trace": "ac424bebc363828a4b5c4c68d94551c15d0789dc764a1ad96f198be3fa18e76c",
    },
    "interp n_atoms=3 R=1024 B=32 N=216 TR=256 {'relax': 10, 'waiting': 0, 'keep_last': True, 'check_old': True}": {
        "site": "b3706cc5277e18fa32e523d75b1362413242e8a6e14df61bf0020f8a8bc900d0",
        "last": "afc2d2840898a43afed05f6c07ac26339538c622c3ac8aa18f9e3a3cdb14de30",
        "fsj": "d734df4978aa67116186a57fce15789cd5e5026242d290e97a9588506c70c6e8",
        "wait": "ad7facb2586fc6e966c004d7d1d16b024f5805ff7cb47c7a85dabd8b48892ca7",
        "jumps": "1d417a80c8c24df7a4be88fbb5f929f90a200b6dadf957448ddefb33346fab6f",
        "ev_count": "1d417a80c8c24df7a4be88fbb5f929f90a200b6dadf957448ddefb33346fab6f",
        "u_rem": "d9bbfe0528e6e21fcc0f3dadbda917f3cb7a8539b1d914a26b95bb516975a510",
        "corr": "57c8061f1a6220c0c5e18c3b38820973608ccc946b0f3f88a670923c8e7ae541",
        "disp_base": "144e846f89c2f91718422cea2c925a9faf42a098aa4d8327e3db679a2a459db6",
        "site_disp": "e99863bb13b84c973988df2699aa9c7069c2bf8f85a3986f3a85917522d7790f",
        "prev_pos": "ebe0eb8bde43fb1b5df1f724fcf82083a79173fa922fbdaf4212f3f71d387fef",
        "trunc": "ad7facb2586fc6e966c004d7d1d16b024f5805ff7cb47c7a85dabd8b48892ca7",
        "site_trace": "e064a385efcf9c87b58806a019af573380c64d602474752eb51495db43faae79",
    },
    "linear n_atoms=4 R=1024 B=32 N=216 TR=256 {'relax': 10, 'waiting': 0, 'keep_last': True, 'check_old': True}": {
        "site": "d12891c055e9b2b4083101b84ce055c606ab842b897437e24911ab6a7e439376",
        "last": "b123a46d6a28e96b0ff3a31dffe1de68e186153661238879ed65c369f38a38ca",
        "fsj": "e97b0326e9bccdb8f6808bda71fbcc342335b8d6438135888e008d8192171b62",
        "wait": "ad7facb2586fc6e966c004d7d1d16b024f5805ff7cb47c7a85dabd8b48892ca7",
        "jumps": "2c35396c53b114f7146d2a7ede48e73d570f9cf4cc8deae3a2f37516b3bd24c4",
        "ev_count": "2c35396c53b114f7146d2a7ede48e73d570f9cf4cc8deae3a2f37516b3bd24c4",
        "u_rem": "b60d57fcc94f3852c0c56fe6bc0fd24fd4dc1fb4dfb883e2cda18058186410a2",
        "corr": "f6e7af73910b766533072c4005fe0095fdf9c6019e092c6eb618c7b7750aca95",
        "disp_base": "81b9f04fa2383df0fb285f7f15f9512e2c00ee413e389b44c81b5c3d8e189446",
        "site_disp": "e99863bb13b84c973988df2699aa9c7069c2bf8f85a3986f3a85917522d7790f",
        "prev_pos": "ebe0eb8bde43fb1b5df1f724fcf82083a79173fa922fbdaf4212f3f71d387fef",
        "trunc": "ad7facb2586fc6e966c004d7d1d16b024f5805ff7cb47c7a85dabd8b48892ca7",
        "site_trace": "44a86a675abe3880ea6624b634cf00d91798ce63e0f124b745311d2e73e839d0",
    },
    "none n_atoms=3 R=1024 B=32 N=216 TR=256 {'relax': 10, 'waiting': 3, 'keep_last': True, 'check_old': False}": {
        "site": "455e64ec1dbeb1e67efd6517759acce2dc7efea5f12b3987fc1c79aa566ee7a0",
        "last": "c4817074e7f37341b28358671acfc0a4180e3f05608b1d9b0e1052652c1e65f3",
        "fsj": "719c2a2bc8dc7704c7b93073397b12bc73d77688275ae400f50646351f2e0cd9",
        "wait": "16452ed466358c6aaa97520da88dedf3c310513088efa235ff7ca96b5ec39060",
        "jumps": "c1e41cebdd2a71717681d0b5926b031eaac5e4fa1ba8587e3d1ff80b88dbdc35",
        "ev_count": "c1e41cebdd2a71717681d0b5926b031eaac5e4fa1ba8587e3d1ff80b88dbdc35",
        "u_rem": "4a38a6fd36075b3f0b7ff4dd90862b398e955e0b2eaa38476716e9f036a3b816",
        "corr": "97868963e0920c246a4138ae99e94d2bba20248529dc693f6a4c502025e27714",
        "disp_base": "cfff6a8d8f36f53986d9e6ceca665a01675cd7e6ecaa6e7dce2db261c84a00fb",
        "site_disp": "e99863bb13b84c973988df2699aa9c7069c2bf8f85a3986f3a85917522d7790f",
        "prev_pos": "ebe0eb8bde43fb1b5df1f724fcf82083a79173fa922fbdaf4212f3f71d387fef",
        "trunc": "ad7facb2586fc6e966c004d7d1d16b024f5805ff7cb47c7a85dabd8b48892ca7",
        "site_trace": "e064a385efcf9c87b58806a019af573380c64d602474752eb51495db43faae79",
    },
    "linear R=8192 B=256 N=216 (the path's launch)": {
        "site": "ce0561a478d2e4e176d0dea76913f654e59cbfb27fb0ed83ad78f598f0e7845f",
        "last": "352d4e655b92c409914c5fd21d5ef880814b223a69f5433a201db049c55088c0",
        "fsj": "4700c81822dc7e17db8e53512b29ebf79437ff12efe269439763cd02f29084d1",
        "wait": "c35020473aed1b4642cd726cad727b63fff2824ad68cedd7ffb73c7cbd890479",
        "jumps": "41c91118bf9171b0c4157e89472b0e75346e22af269f2e9ad8e89761029d869f",
        "ev_count": "41c91118bf9171b0c4157e89472b0e75346e22af269f2e9ad8e89761029d869f",
        "u_rem": "3ca5ef230a178485d10d0fedf38657b48dfd23cfc185b1cb90a4ba13663ef32f",
        "corr": "74f372418d03607337dc58f528bad4575dd282c6c0bccf0ee7a42f6963ab7a2d",
        "disp_base": "b6f2ca9501a3798ca3e666474eaefccd8d7f3a291e8b970ae47308f616d5520d",
        "site_disp": "94b5600cef2c7286b41adb86c8b58c82435539713de76289d0d7a78bec470c0a",
        "prev_pos": "297cd605c501dc70f59b0752ea8cc6c632a78d5f7641b50160503e85f53fe897",
        "trunc": "a474c34b3a9b50b1617d0b15a342cdf958f21ab4bcc21635462b5e37a92736fa",
        "site_trace": "4b1ab127d4b54a1ad8cfb3837cb39a62259ef2f94b7a58fd881e5610b730dda1",
    },
    "interp R=8192 B=256 N=1728 (the path's launch)": {
        "site": "6e4315f9c91083c7b6a9158ee4d2c7be80506fe5f77f41bcc1f0ef09cfec3b84",
        "last": "484956ec46a418b99846b640877a1c08f4be2328b407f4f8f81a52d09870bf54",
        "fsj": "3e28d6413d562f3f9352738ed16f58f1309136bf49487e5d3fb8f6fe816beccd",
        "wait": "c35020473aed1b4642cd726cad727b63fff2824ad68cedd7ffb73c7cbd890479",
        "jumps": "f47f6c84a019bcff119a0b0eeb850313c160f806b5004a6b0ec26262830832b1",
        "ev_count": "f47f6c84a019bcff119a0b0eeb850313c160f806b5004a6b0ec26262830832b1",
        "u_rem": "9440929a10d3cc08c08e8902161a5164d5b6e481a327ddd677ee00c10f63b859",
        "corr": "773347c10a913dd0434c32f84c3ccbdb557db8701ed8d7e4148a7337a634c812",
        "disp_base": "759e14a23909f51f5d0dc3674fe087991411920a48307e40c25c226aad0e864c",
        "site_disp": "674573f1a0e2d03b776fa875d7d9d75dd6452d746c5519a9de46cf03771939e3",
        "prev_pos": "79b7966443b8a9d516772b520d2f7bd4cf0520e193a6b1e3c1ad76cd7ed33097",
        "trunc": "8d59d68c70e96cd40ce17be4a1b5e323edc8fed734b86203fdc4d7be2c22d181",
        "site_trace": "fbf723ba33ffe0f57e2da7739ee7d8d3bb758166569e26a710ea11cc8c71cf24",
    },
}

# operations to bin one site: per axis a division, a floor, a multiply and
# a subtract to wrap it, a multiply and a floor for its cell; the cell id
# (two multiply-adds) and a counting sort's count and place
BIN_OPS = 22.0


def knn_cell_ops(pos, box3, k, grid, topd=None) -> float:
    """K5's least operations on the cell route over a block [B, N, 3]: each
    site binned, and each unordered pair in neighbouring cells (the pairs
    that cells of width cutoff + buffer can hold in range) counted as
    knn_ops counts a pair (a distance and a test, a compare per ordered
    pair). With the verified search (`topd` given: no cutoff) add every row
    of each column that the check sends to a full scan (its k-th distance
    not below its bound)."""
    import torch

    from cmdlmc_tpu_torch.ops import knn_tables as knn

    B, N, _ = pos.shape
    cl = knn.cell_lists(pos, box3, grid, verify=topd is not None)
    counts = (cl.start[:, 1:] - cl.start[:, :-1]).double().reshape(B, *grid)
    pairs = float((counts * (counts - 1) / 2).sum())
    offsets = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)
               if (a, b, c) > (0, 0, 0)]  # 13: each neighbouring pair of cells once
    for off in offsets:
        pairs += float((counts * counts.roll(off, dims=(1, 2, 3))).sum())
    ops = pairs * (PAIRWISE_OPS + 1) + 2 * pairs + BIN_OPS * B * N
    if topd is not None:
        rescans = int((~(topd[:, k - 1] < cl.thr)).sum())
        ops += rescans * (N - 1) * (PAIRWISE_OPS + 2)
    return ops


def _knn_bound(pos, box3, cutbuf, k, topd) -> tuple:
    """(the bound of this K5 launch, the all-pairs bound, the route):
    knn_cell_ops on the cell route, knn_ops on the full scan."""
    from cmdlmc_tpu_torch.ops import knn_tables as knn

    B, N, _ = pos.shape
    nbytes = 4.0 * B * N * 3 + 8.0 * B * k * N
    grid = knn.cell_grid(N, box3, cutbuf, k)
    every = bound(B * knn_ops(N), nbytes)
    if grid is None:
        return every, every, "full scan"
    ops = knn_cell_ops(pos, box3, k, grid,
                       None if math.isfinite(float(cutbuf)) else topd)
    return bound(ops, nbytes), every, f"cells {grid}"


def _k5_cell_parts(pos, box3, cutbuf, k):
    """The cell route's parts timed alone, as text: the binning
    (ops/knn_tables.py::cell_lists: knn_bin_kernel, torch's sort and cumsum)
    and the cell kernel at 32 to 256 threads per block over those lists (the
    route's width is ops/knn_tables.py::cell_threads)."""
    import numpy as np
    import torch

    from cmdlmc_tpu_torch.ops import build
    from cmdlmc_tpu_torch.ops import knn_tables as knn

    B, N, _ = pos.shape
    grid = knn.cell_grid(N, box3, cutbuf, k)
    verify = not math.isfinite(float(cutbuf))
    bin_ms, cl = cuda_ms(lambda: knn.cell_lists(pos, box3, grid, verify), reps=20)
    topd = torch.empty((B, k, N), dtype=torch.float32, device=pos.device)
    topi = torch.empty((B, k, N), dtype=torch.int32, device=pos.device)
    lib = build.library()
    widths = {}
    for threads in (32, 64, 128, 256):
        widths[threads], _ = cuda_ms(lambda: build.check(lib.cmdlmc_knn_tables(
            pos.data_ptr(), B, N, k, *(float(x) for x in box3), float(np.float32(cutbuf)),
            cl.order.data_ptr(), cl.scell.data_ptr(), cl.start.data_ptr(),
            None if cl.thr is None else cl.thr.data_ptr(), cl.bad.data_ptr(), *grid,
            threads, 1, topd.data_ptr(), topi.data_ptr(), build.stream_of(pos),
            pos.device.index or 0), "knn_tables kernel"), reps=20)
    return (f"binning {bin_ms:.4f} ms; the cell kernel alone at "
            + ", ".join(f"{t}: {ms:.4f}" for t, ms in widths.items())
            + f" ms (the route takes {knn.cell_threads(B * grid[0] * grid[1])})")


def _hold_k5(tag, label, got):
    """K5's tables `got` held bit for bit to the digests recorded from the
    K5 before its cell route (PARENT_K5_DIGESTS)."""
    _held_to_parent(tag, label, {"topd": got[0], "topi": got[1]}, PARENT_K5_DIGESTS)


def phase_k5(dev, libs=None):
    """K5 against knn_block_tables_reference: at the top-K path's launch
    shape [PRINT_FREQ, 144] at k=8 and, for the hydronium path, k=4, at
    [256, 144] and at the supercell's [64, 4608] (the cell route). Indices
    equal, except where the two candidates' distances lie within an ulp of
    each other; distances within an ulp. Held bit for bit to the K5 before
    its cell route (recorded digests). Timed at each shape, the bound from
    the pairs the route needs beside the all-pairs count. With `libs` the
    parent's K5 is held to it bit for bit and timed in turns with it
    (parent, this, this, parent), and K5 at the box x4 rebuild's [1, 9216]
    too."""
    import torch

    from cmdlmc_tpu_torch.ops.knn_tables import knn_block_tables, knn_block_tables_reference

    worst, result = 0.0, {}
    for b, n, box, k in ((PRINT_FREQ, N_SITES, BOX, TOPK_K), (PRINT_FREQ, N_SITES, BOX, HYD_K),
                         (256, N_SITES, BOX, TOPK_K), (64, SC_SITES, SC_BOX, TOPK_K)):
        block = _walk_block(n, b, box) if n == SC_SITES else _jitter_block(n, b, box)
        pos = torch.from_numpy(block).to(dev)
        box3 = (box,) * 3
        label = f"[{b},{n}] k={k}"
        ms, (gd, gi) = cuda_ms(lambda: knn_block_tables(pos, box3, CUTBUF, k), reps=20)
        if libs:
            say(f"[k5] {label}: {_k5_in_turns(libs, pos, box3, CUTBUF, k, (gd, gi))}")
        plain_ms, (wd, wi) = cuda_ms(
            lambda: knn_block_tables_reference(pos, box3, CUTBUF, k), reps=1)
        parted, err = _knn_hold(f"K5 {label}", pos, box3, gd, gi, wd, wi)
        worst = max(worst, err)
        _hold_k5("k5", label, (gd, gi))
        b_, every, route = _knn_bound(pos, box3, CUTBUF, k, gd)
        if route != "full scan":
            say(f"[k5] {label}: {_k5_cell_parts(pos, box3, CUTBUF, k)}")
        say(f"[k5] {label} ({route}): {parted} index partings (ties within an ulp), "
            f"max |kernel - plain| distance {err:.3e}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b_['bound_ms']:.5f} ms ({b_['bound_by']}; "
            f"every pair {every['bound_ms']:.5f} ms)")
        if b == PRINT_FREQ and k == TOPK_K:
            # no single PyTorch call computes it: torch.cdist has no periodic
            # images and torch.topk no first-lowest-index tie rule
            result = {"ms": ms, "plain_ms": plain_ms, **b_, "library_ms": None}
    if libs:
        pos = torch.from_numpy(_box4_block(1)).to(dev)
        got = knn_block_tables(pos, (BX_BOX,) * 3, CUTBUF, TOPK_K)
        say(f"[k5] [1,{BX_SITES}] k={TOPK_K}: "
            f"{_k5_in_turns(libs, pos, (BX_BOX,) * 3, CUTBUF, TOPK_K, got)}")
    result["max_abs_err"] = worst
    return result


def _k5_in_turns(libs, pos, box3, cutbuf, k, got, reps=20) -> str:
    """This K5 and the parent's timed in turns (parent, this, this, parent),
    the parent's tables held to `got` bit for bit, as text."""
    import torch

    from cmdlmc_tpu_torch.ops.knn_tables import knn_block_tables

    times = {"parent": [], "this": []}
    for name in ("parent", "this", "this", "parent"):
        if name == "parent":
            with _library(libs["parent_knn"]):
                ms, out = cuda_ms(lambda: knn_block_tables(pos, box3, cutbuf, k), reps=reps)
            if not (torch.equal(out[1], got[1])
                    and torch.equal(out[0].view(torch.int32), got[0].view(torch.int32))):
                raise AssertionError(f"K5 at {tuple(pos.shape)} differs from the parent's")
        else:
            ms, _ = cuda_ms(lambda: knn_block_tables(pos, box3, cutbuf, k), reps=reps)
        times[name].append(ms)
    return ("equals the parent's K5 bit for bit; in turns: " + "; ".join(
        f"{n} " + ", ".join(f"{t:.4f}" for t in v) + " ms" for n, v in times.items()))


def knn_sparse_ops(plan, n: int) -> float:
    """K6's least operations per frame over a sparse plan (either kind),
    counted as knn_ops counts K5's: the distance and cutoff test of each
    unordered pair that one of its two (tile, chunk) pairs keeps (d(i,j) =
    d(j,i)), and one compare per ordered kept (column, row) pair but self.
    Returns the operations and the share of all unordered pairs that the
    plan keeps."""
    import math

    import numpy as np

    from cmdlmc_tpu_torch.ops import knn_sparse as kns

    lists = kns._host_lists(plan)
    g = math.gcd(plan.rc, plan.tc)  # each g-block lies in one tile and one chunk
    first = np.arange(0, n, g)
    size = np.minimum(g, n - first).astype(np.float64)
    keep = np.zeros((lists.shape[0], plan.n_ch), dtype=bool)
    for t, chunks in enumerate(lists):
        keep[t, chunks[chunks < plan.n_ch]] = True
    ordered = keep[first // plan.tc][:, first // plan.rc]  # [column block, row block]
    either = ordered | ordered.T
    w = np.outer(size, size)
    unordered = (w * np.triu(either, 1)).sum() + (either.diagonal() * size * (size - 1) / 2).sum()
    compares = (w * ordered).sum() - (ordered.diagonal() * size).sum()
    return float(unordered * (PAIRWISE_OPS + 1) + compares), unordered / (n * (n - 1) / 2)


def _same_plan(a, b) -> bool:
    import torch

    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in ("perm", "inv", "lists", "count")) and a.n_ch == b.n_ch


def phase_k6(dev, libs=None):
    """K6 over the plan built on the card: at the box x4 path's own launch, a
    rebuild's one frame [1, 9216]; at [64, 9216] (bench.py's cell replicated
    4 x 4 x 4); and at [64, 4608] (tools/bench_topk_e2e.py's supercell, a
    block of its path). At each shape:
    the card's plan equals its plain version (device_plan_reference on the
    CPU, integers exact); K6 equals K5 bit for bit, and its plain version
    over the same plan as K5's is held; K6 with its plan, the plan alone and
    the kernel alone timed in turns with K5 (K6, K5, K5, K6); the kept share
    of the unordered pairs for this plan and for the host plan copied from
    the JAX package (RC=64, TC=128), the bound from the pairs in neighbouring
    bins of width cutoff + buffer (no plan at all: K6's bound in the result,
    as K5's) and from this plan's kept pairs; K5 held bit for bit to the digests of the K5 before its cell
    route. With `libs` the parent's K6 (this tree's interface) over the same
    plan is held to K6 bit for bit and timed in turns with it (parent,
    this, this, parent)."""
    import torch

    from cmdlmc_tpu_torch.ops import knn_sparse as kns
    from cmdlmc_tpu_torch.ops.knn_tables import knn_block_tables

    k, worst, result = TOPK_K, 0.0, {}
    box4 = _box4_block(64)
    for b, n, box in ((1, BX_SITES, BX_BOX), (64, BX_SITES, BX_BOX), (64, SC_SITES, SC_BOX)):
        block = box4[:b] if n == BX_SITES else _walk_block(n, b, box)
        pos = torch.from_numpy(block).to(dev)
        box3 = (box,) * 3
        routed = kns.sparse_route(n, box3, CUTBUF)
        shape = f"[{b},{n}]{'' if routed else ' (K5 by the route; K6 called directly)'}"
        plan = kns.device_plan(pos, box3, CUTBUF)
        want_plan = kns.device_plan_reference(pos.cpu(), box3, CUTBUF)
        if not _same_plan(plan, want_plan):
            raise AssertionError(f"K6 {shape}: the card's plan differs from its plain version")
        reps = 20 if b == 1 else 5
        turns = {"K6": [], "K5": [], "K6 kernel": [], "plan": []}
        for name in ("K6", "K5", "K6 kernel", "plan", "plan", "K6 kernel", "K5", "K6"):
            if name == "K6":
                t, (d6, i6) = cuda_ms(lambda: kns.knn_sparse_tables(pos, box3, CUTBUF, k),
                                      reps=reps)
            elif name == "K5":
                t, (d5, i5) = cuda_ms(lambda: knn_block_tables(pos, box3, CUTBUF, k),
                                      reps=reps)
            elif name == "plan":
                t, _ = cuda_ms(lambda: kns.device_plan(pos, box3, CUTBUF), reps=reps)
            else:
                t, _ = cuda_ms(lambda: kns.knn_sparse_tables(pos, box3, CUTBUF, k, plan),
                               reps=reps)
            turns[name].append(t)
        plain_ms, (wd, wi) = cuda_ms(
            lambda: kns.knn_sparse_tables_reference(pos, box3, CUTBUF, k, plan), reps=1)
        on_device = {"K6": device_ms(lambda: kns.knn_sparse_tables(pos, box3, CUTBUF, k)),
               "K5": device_ms(lambda: knn_block_tables(pos, box3, CUTBUF, k)),
               "K6 kernel": device_ms(
                   lambda: kns.knn_sparse_tables(pos, box3, CUTBUF, k, plan)),
               "plan": device_ms(lambda: kns.device_plan(pos, box3, CUTBUF))}
        n_i = int((i6 != i5).sum())
        n_d = int((d6.view(torch.int32) != d5.view(torch.int32)).sum())
        say(f"[k6] {shape} k={k}: the card's plan equals its plain version; K6 vs K5 "
            f"{n_i} differing indices, {n_d} differing distances (bit for bit)")
        if n_i or n_d:
            raise AssertionError(f"K6 {shape} differs from K5")
        _hold_k5("k6", f"[{b},{n}] k={k}", (d5, i5))
        parted, err = _knn_hold(f"K6 {shape}", pos, box3, d6, i6, wd, wi)
        worst = max(worst, err)
        ops, share = knn_sparse_ops(plan, n)
        t0 = time.perf_counter()
        host = kns.SparsePlan(*kns.plan_sparse(pos.cpu().numpy(), box3, CUTBUF),
                              kns.RC, kns.TC)
        host_s = time.perf_counter() - t0
        _, host_share = knn_sparse_ops(host, n)
        # the JAX package's bin-major order at this plan's sizes
        rods = kns.SparsePlan(*kns.plan_sparse(pos.cpu().numpy(), box3, CUTBUF, rc=plan.rc,
                                               tc=plan.tc), plan.rc, plan.tc)
        _, rods_share = knn_sparse_ops(rods, n)
        nbytes = 4.0 * b * n * 3 + 8.0 * b * k * n
        b_ = bound(b * ops, nbytes)
        grid = kns.plan_bins(box3, CUTBUF)
        cells = bound(knn_cell_ops(pos, box3, k, grid), nbytes)
        kept = plan.count.sum().item()
        say(f"[k6] {shape}: plan keeps {kept} of {plan.lists.shape[0] * plan.n_ch} "
            f"(tile, chunk) pairs, {share:.4f} of the unordered pairs (the bin-major "
            f"order at RC={plan.rc} TC={plan.tc}: {rods_share:.4f}; the host plan "
            f"RC={host.rc} TC={host.tc}: {host_share:.4f}, built on the host in "
            f"{1e3 * host_s:.1f} ms); {parted} index partings against the plain version "
            f"(ties within an ulp), max distance error {err:.3e}")
        if libs:
            def this_k6():
                return kns.knn_sparse_tables(pos, box3, CUTBUF, k, plan)

            def parent_k6():
                with _library(libs["parent_sparse"]):
                    return this_k6()

            ptimes, outs = _in_turns({"parent": parent_k6, "this": this_k6}, reps=reps)
            parent = outs["parent"]
            if not (torch.equal(parent[1], i6)
                    and torch.equal(parent[0].view(torch.int32), d6.view(torch.int32))):
                raise AssertionError(f"K6 {shape} differs from the parent's K6")
            say(f"[k6] {shape}: equals the parent's K6 over the same plan bit for bit; "
                f"kernels in turns: {_turns_text(ptimes)}")
        say(f"[k6] {shape}: in turns: " + "; ".join(
            f"{name} " + ", ".join(f"{t:.4f}" for t in v) + " ms"
            for name, v in turns.items())
            + " (K6 with its plan, K5, K6's kernel over a built plan, the plan alone; "
            "per call, CUDA events); device time (profiler): "
            + ", ".join(f"{name} {v:.4f} ms" for name, v in on_device.items())
            + "; "
            f"plain {plain_ms:.3f} ms; K6 bound {cells['bound_ms']:.5f} ms "
            f"({cells['bound_by']}: the pairs in neighbouring bins {grid}, no plan), "
            f"{b_['bound_ms']:.5f} ms (this plan's kept pairs); "
            f"K6 {'beats' if min(turns['K6']) < min(turns['K5']) else 'loses to'} K5")
        if b == 1:
            say(f"[k6] {shape}: K5 {_k5_cell_parts(pos, box3, CUTBUF, k)}")
            # the bound of the function, as K5's: it does not shrink with the
            # plan; no single PyTorch call computes it (see phase_k5)
            result = {"ms": min(turns["K6"]), "plain_ms": plain_ms, **cells,
                      "library_ms": None}
    say(f"[k6] route: {_sparse_route_sweep(dev)}")
    result["max_abs_err"] = worst
    return result


# the sites of the route sweep: bench.py's density (boxes 14.5 (N / 144)^(1/3)),
# from the fewest sites with 3 bins of cutoff + buffer an axis (162; 160 is
# the first) to 11 bins
ROUTE_SITES = (162, 216, 288, 432, 576, 864, 1152, 2304, 3456, 4608, 6912, 9216)


def _sparse_route_sweep(dev) -> str:
    """K6 (its plan included) and K5 timed in turns (K6, K5, K5, K6) per call
    at ROUTE_SITES, for one frame (a Verlet rebuild) and a block of 64 (a
    run without reuse), the tables held equal; returns the table as text,
    each entry `N/frames: K6 ms, K5 ms` with the route's pick."""
    import torch

    from cmdlmc_tpu_torch.ops import knn_sparse as kns
    from cmdlmc_tpu_torch.ops.knn_tables import knn_block_tables

    out = []
    for n in ROUTE_SITES:
        box = BOX * (n / N_SITES) ** (1.0 / 3.0)
        box3 = (box,) * 3
        block = torch.from_numpy(_walk_block(n, 64, box, seed=n)).to(dev)
        for b in (1, 64):
            pos = block[:b]
            times = {"K6": [], "K5": []}
            for name in ("K6", "K5", "K5", "K6"):
                fn = ((lambda: kns.knn_sparse_tables(pos, box3, CUTBUF, TOPK_K))
                      if name == "K6" else (lambda: knn_block_tables(pos, box3, CUTBUF, TOPK_K)))
                t, got = cuda_ms(fn, reps=10 if b == 1 else 3)
                times[name].append(t)
                if name == "K6":
                    six = got
                else:
                    five = got
            if not (torch.equal(six[1], five[1])
                    and torch.equal(six[0].view(torch.int32), five[0].view(torch.int32))):
                raise AssertionError(f"K6 differs from K5 at [{b},{n}]")
            pick = "K6" if kns.sparse_route(n, box3, CUTBUF) else "K5"
            out.append(f"{n}/{b}: K6 " + ", ".join(f"{t:.4f}" for t in times["K6"])
                       + ", K5 " + ", ".join(f"{t:.4f}" for t in times["K5"])
                       + f" ms (route: {pick})")
    return "; ".join(out)


# phase_k4's two stress cases of K4's carried sums: bench.py's Fermi at 8x
# its amplitude (about 19 events per replica-frame at N=144, so a budget of
# 16 is used up), and that law within 1.6 + 0.4 A of 3 protons, where most
# sites have exhausted slots (about 1.6 neighbours in range at bench.py's
# density) and a move often takes a slot's last positive candidate away
HOT_FERMI = (8 * FERMI[0], FERMI[1], FERMI[2])
SPARSE_CUT, SPARSE_PROTONS = (1.6, 0.4), 3

TOPK_STATE_KEYS = ("occ", "labels", "sites", "tlast", "tlast_site", "disp_base",
                   "u_rem", "ev_count")
TRICLINIC_VECTORS = ((BOX, 0.0, 0.0), (0.2 * BOX, BOX, 0.0), (0.15 * BOX, 0.1 * BOX, BOX))


def _k4_inputs(dev, replicas, frames, name, kind=0, triclinic=False, seed=0,
               max_events=MAX_EVENTS):
    """A top-K model ("topk": TopKPairRates k=8 with law kind `kind`;
    "hydronium": HydroniumRates k=4, ReLU, the blend; "supercell": the
    TopKPairRates of tools/bench_topk_e2e.py; "box4": that of the box x4
    supercell deployment; "wide": WIDE_SITES sites at bench.py's density;
    "hot": "topk" with HOT_FERMI, about 8x the events; "sparse": HOT_FERMI
    within SPARSE_CUT of SPARSE_PROTONS protons, so that most sites have
    exhausted slots and moves empty slots), a block of its frames, its
    stage-1 tables, random replica state [prev, s, occ, labels, sites,
    tlast, tlast_site, disp_base, u, evc] and the sweep's keywords."""
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
                       "sparse": (N_SITES, SPARSE_PROTONS, BOX),
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
    if name in ("hot", "sparse"):
        from cmdlmc_tpu_torch.rates.laws import Fermi

        law = Fermi(a=HOT_FERMI[0], b=HOT_FERMI[1], c=HOT_FERMI[2]).to(dev)
    if name == "hydronium":
        model = HydroniumRates(
            cell, law, CUTOFF, BUFFER,
            transform=ReLUTransformation(a=RELU[0], b=RELU[1], d0=RELU[2],
                                         left_bound=RELU[3], right_bound=RELU[4]).to(dev),
            interpolator=DistanceInterpolator(relaxation_time=RELAX).to(dev), k=HYD_K)
    elif name == "sparse":
        model = TopKPairRates(cell, law, *SPARSE_CUT, k=TOPK_K)
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
              max_events=max_events, dt=DT, seed=1, blend=blend)
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


def topk_changed(tables, blend) -> float:
    """The candidates one event changes, counted from the run's tables
    [B, K, N] (topd, topi, resc) and averaged over the frames: src's and
    dst's K slots and the entries whose neighbour is src or dst. A site is
    a move's end through one of its in-entries, so each end's in-degree is
    the size-biased mean sum(deg^2) / sum(deg) over the entries with a
    nonzero rate (omega > 0; the others change nothing)."""
    import torch

    topd, topi, resc = tables
    B, K, N = topi.shape
    valid = (topd < 1.0e5) if blend else (resc > 0)
    flat = (topi.long() + torch.arange(B, device=topi.device)[:, None, None] * N)[valid]
    deg = torch.bincount(flat, minlength=B * N).reshape(B, N).to(torch.float64)
    biased = (deg * deg).sum(dim=1) / deg.sum(dim=1).clamp(min=1)
    return 2.0 * K + 2.0 * float(biased.mean())


def _topk_terms(R, N, P, K, blend):
    """Operations per candidate (occ[i] is 1 at the P occupied sites: 1 -
    occ[nbr], the multiply by omega and the add; with the blend also d +
    ratio (r - d), the clamp at 50 and the Fermi law, 9 more, and the site's
    ratio, 3 per site) and the replica state's bytes (occ, labels,
    tlast_site, sites, tlast, db, u, evc)."""
    per_cand = (12.0 if blend else 3.0) + (3.0 / K if blend else 0.0)
    return per_cand, 4.0 * R * (3 * N + 5 * P + 2)


def topk_bound(R, B, N, P, K, events, blend, table_bytes, changed) -> dict:
    """Bound of a top-K sweep that fired `events` events, from the least
    work: one full evaluation per replica-frame (K candidates at each of the
    P occupied sites), per event the `changed` candidates
    (:func:`topk_changed`) and the races over the K slots and the P
    occupied sites, the only ones with a positive rate (a log, a divide and
    a compare each). Bytes: positions, the tables, the replica state read
    once and written once."""
    per_cand, state = _topk_terms(R, N, P, K, blend)
    flops = (R * B * P * K * per_cand
             + events * (changed * per_cand + 3.0 * (P + K)))
    return bound(flops, 4.0 * B * N * 3 + table_bytes + 2 * state + 4.0 * R
                 + 4 * 4.0 * N * 3)


def full_topk_bound(R, B, N, P, K, events, blend, table_bytes) -> dict:
    """The bound as counted before the carried sums: a full evaluation per
    event besides the one that ends each replica-frame."""
    per_cand, state = _topk_terms(R, N, P, K, blend)
    flops = (events + R * B) * P * K * per_cand + 3.0 * (P + K) * events
    return bound(flops, 4.0 * B * N * 3 + table_bytes + 2 * state + 4.0 * R
                 + 4 * 4.0 * N * 3)


def _k4_before_libraries(parent_csrc):
    """Start the nvcc builds of the kernels timed beside this tree's: the
    parent's ``topk_sweep.cu`` (K4), ``knn_sparse.cu`` (K6), ``pairwise.cu``
    (K2), ``knn_tables.cu`` (K5), ``water_sweep.cu`` (K7) and
    ``kmc_sweep_streamed.cu`` with ``kmc_sweep.cu`` (K1, K3) from
    `parent_csrc` (a copy of an earlier tree's csrc/, e.g. from ``git
    archive``; its K5 and K7 have this tree's interface), each on its own,
    this tree's K4
    built with -DCMDLMC_TOPK_UNSTAGED (the first evaluation read by every
    warp from L2) and this tree's K7 with 4 and 16 lanes per replica
    (-DWATER_LANES). Returns a function that waits for them and loads them."""
    from cmdlmc_tpu_torch.ops import build

    out = build.BUILD_DIR / "k4_before"
    out.mkdir(parents=True, exist_ok=True)
    csrc = Path(parent_csrc)
    jobs = {"parent": ([csrc / "topk_sweep.cu", csrc / "errors.cu"], []),
            "parent_sparse": ([csrc / "knn_sparse.cu", csrc / "errors.cu"], []),
            "parent_pairwise": ([csrc / "pairwise.cu"], []),
            "parent_knn": ([csrc / "knn_tables.cu", csrc / "errors.cu"], []),
            "parent_water": ([csrc / "water_sweep.cu", csrc / "errors.cu"], []),
            "parent_dense": ([csrc / "kmc_sweep_streamed.cu", csrc / "kmc_sweep.cu",
                              csrc / "errors.cu"], []),
            "unstaged": ([build.CSRC_DIR / "topk_sweep.cu", build.CSRC_DIR / "errors.cu"],
                         ["-DCMDLMC_TOPK_UNSTAGED"])}
    for lanes in (4, 16):  # this K7 with other lanes per replica than its 8
        jobs[f"water_lanes{lanes}"] = (
            [build.CSRC_DIR / "water_sweep.cu", build.CSRC_DIR / "errors.cu"],
            [f"-DWATER_LANES={lanes}"])
    procs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, *defs, "-shared", "-o",
         str(out / f"{name}.so"), *map(str, srcs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (srcs, defs) in jobs.items()}

    def wait():
        libs = {}
        for name, proc in procs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc of the {name} kernels failed:\n{log}")
            for line in log.splitlines():
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    say(f"[before] {name} build: {line.strip()}")
            libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
        for name, fns in (("unstaged", ("cmdlmc_topk_sweep", "cmdlmc_topk_sweep_plan")),
                          ("water_lanes4", ("cmdlmc_water_sweep",)),
                          ("water_lanes16", ("cmdlmc_water_sweep",)),
                          ("parent_water", ("cmdlmc_water_sweep",)),
                          ("parent_knn", ("cmdlmc_knn_bin", "cmdlmc_knn_tables")),
                          ("parent_dense", ("cmdlmc_kmc_sweep_streamed_caps",
                                            "cmdlmc_kmc_sweep_caps"))):
            lib = libs[name]
            for fn in fns:
                getattr(lib, fn).argtypes = build._SIGNATURES[fn]
            lib.cmdlmc_error_string.argtypes = [ctypes.c_int]
            lib.cmdlmc_error_string.restype = ctypes.c_char_p
        # the parent's K1, K3 and K4 take no statistics
        libs["parent"] = _ParentSweeps(libs["parent"])
        libs["parent_dense"] = _ParentSweeps(libs["parent_dense"])
        # the parent's K6 has this tree's interface
        libs["parent_sparse"].cmdlmc_knn_sparse.argtypes = build._SIGNATURES["cmdlmc_knn_sparse"]
        libs["parent_sparse"].cmdlmc_error_string.argtypes = [ctypes.c_int]
        libs["parent_sparse"].cmdlmc_error_string.restype = ctypes.c_char_p
        libs["parent_pairwise"].cmdlmc_pairwise.argtypes = build._SIGNATURES["cmdlmc_pairwise"]
        return libs

    return wait


class _ParentSweeps:
    """The parent tree's K1, K3 and K4 behind this tree's C entry points,
    for the wrappers under :func:`_library`. The parent's entries have no
    jump statistics and no triclinic K1, and its K3 takes the law's six
    parameters by value: the statistics' arguments are dropped (they must
    be off) and the rest forwarded. Other symbols are the library's own."""

    _F, _I, _LL, _P = ctypes.c_float, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    _SIGNATURES = {
        "cmdlmc_kmc_sweep_streamed": [_P] * 14 + [_I] * 9 + [_P, _P, _LL]
        + [_F, ctypes.c_uint32, _F, _F, _F, _P, _I],
        "cmdlmc_kmc_sweep_streamed_plan": [_I, _I] + [ctypes.POINTER(_LL)] * 2
        + [ctypes.POINTER(_I)],
        "cmdlmc_kmc_sweep": [_P] * 14 + [_I] * 9 + [_P, _P, _LL, _I, _F, ctypes.c_uint32]
        + [_F] * 10 + [_P, _I],
        "cmdlmc_kmc_sweep_plan": [_I] * 3 + [ctypes.POINTER(_LL)] * 2 + [ctypes.POINTER(_I)],
        "cmdlmc_topk_sweep": [_P] * 20 + [_LL] + [_I] * 12 + [_F, _F, ctypes.c_uint32]
        + [ctypes.POINTER(_F)] * 2 + [_P, _I],
        "cmdlmc_topk_sweep_plan": [_I] * 5 + [ctypes.POINTER(_LL)],
    }

    def __init__(self, lib):
        self._lib = lib
        for name, argtypes in self._SIGNATURES.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes = argtypes
        if hasattr(lib, "cmdlmc_sweep_list_bytes"):
            lib.cmdlmc_sweep_list_bytes.argtypes = [ctypes.c_int] * 3
            lib.cmdlmc_sweep_list_bytes.restype = ctypes.c_longlong
        lib.cmdlmc_error_string.argtypes = [ctypes.c_int]
        lib.cmdlmc_error_string.restype = ctypes.c_char_p

    def __getattr__(self, name):
        return getattr(self._lib, name)

    @staticmethod
    def _off(stats_flag, tri=0):
        if stats_flag or tri:
            raise ValueError("the parent's kernels take no statistics and no "
                             "triclinic cell")

    def cmdlmc_kmc_sweep_streamed(self, *a):
        # a[31:42]: dist, hist, expo, jm, stats, nbins, lo, hi, scale, tri, geom
        self._off(a[35], a[40])
        return self._lib.cmdlmc_kmc_sweep_streamed(*a[:31], *a[42:])

    def cmdlmc_kmc_sweep_streamed_plan(self, n, stats, nbins, tri, device, *out):
        self._off(stats, tri)
        return self._lib.cmdlmc_kmc_sweep_streamed_plan(n, device, *out)

    def cmdlmc_sweep_list_bytes(self, n, cap, ccap, stats):
        self._off(stats)
        return self._lib.cmdlmc_sweep_list_bytes(n, cap, ccap)

    def cmdlmc_kmc_sweep(self, *a):
        # a[33]: the law's parameters; a[34:42]: hist ... scale
        self._off(a[37])
        return self._lib.cmdlmc_kmc_sweep(*a[:33], *a[33], *a[42:])

    def cmdlmc_kmc_sweep_plan(self, n, warps, stats, nbins, device, *out):
        self._off(stats)
        return self._lib.cmdlmc_kmc_sweep_plan(n, warps, device, *out)

    def cmdlmc_topk_sweep(self, *a):
        # a[38:46]: hist ... scale
        self._off(a[41])
        return self._lib.cmdlmc_topk_sweep(*a[:38], *a[46:])

    def cmdlmc_topk_sweep_plan(self, r, n, k, blend, nbins, device, out):
        self._off(nbins)
        return self._lib.cmdlmc_topk_sweep_plan(r, n, k, blend, device, out)


@contextlib.contextmanager
def _library(lib):
    """Run the port's wrappers against another build of the kernels."""
    from cmdlmc_tpu_torch.ops import build

    saved = build._lib
    build._lib = lib
    try:
        yield
    finally:
        build._lib = saved


def _k4_before(libs, model, pos, tables, state, frame0, kw, got):
    """The parent's K4 and this K4 unstaged, timed in turns with this K4
    (parent, this, unstaged, unstaged, this, parent; 3 launches each),
    as text."""
    this = lambda: _k4_call(model, pos, tables, state, frame0, **kw)  # noqa: E731

    def parent():
        with _library(libs["parent"]):
            return this()

    def unstaged():
        with _library(libs["unstaged"]):
            return this()

    times = {"parent": [], "this": [], "unstaged": []}
    outs = {}
    for name, fn in (("parent", parent), ("this", this), ("unstaged", unstaged),
                     ("unstaged", unstaged), ("this", this), ("parent", parent)):
        ms, outs[name] = cuda_ms(fn, reps=3)
        times[name].append(ms)
    same = {name: int(_agreeing(outs[name], got).sum())
            for name in ("parent", "unstaged")}
    text = "; ".join(f"{name} " + ", ".join(f"{t:.3f}" for t in ts_) + " ms"
                     for name, ts_ in times.items())
    return (f"{text} (replicas whose integer state equals this K4's: parent "
            f"{same['parent']}, unstaged {same['unstaged']} of {state[2].shape[0]})")


# replicas of K4's statistics check at the supercell shapes (the state's
# first ones; the plain version's time bounds it)
K4_STATS_CUT = 512


def _k4_stats(dev, model, pos, tables, state, frame0, kw, off, timed=True):
    """K4 at a top-K launch with jump statistics (the events' table
    distances, the exposure over the K slots, the matrix): held to its plain
    version and to its own run without them (`off`) and, where `timed`,
    timed in turns with statistics off. Not `timed`, the check runs on the
    first K4_STATS_CUT replicas (and `off` is run on them here): the
    supercells' plan (32 warps, the staged first evaluation, the global
    layout), whose shared memory the statistics' counters shift."""
    if not timed and state[2].shape[0] > K4_STATS_CUT:
        state = state[:2] + [t[:K4_STATS_CUT] for t in state[2:]]
        off = _k4_call(model, pos, tables, state, frame0, **kw)
    R, B, N = state[2].shape[0], pos.shape[0], pos.shape[1]
    K = tables[0].shape[1]
    stats = _stats_kw(R, dev)
    from cmdlmc_tpu_torch.ops import topk_sweep as ts

    plan = ts.sweep_plan(R, N, K, kw["blend"], dev, STATS_BINS)
    label = (f"topk k={K} R={R} B={B} N={N}, {STATS_BINS} bins and the matrix, "
             f"plan {plan}")
    on = _k4_call(model, pos, tables, state, frame0, **kw, **stats)
    want = _k4_call(model, pos, tables, state, frame0, plain=True, **kw, **stats)
    _k4_check(label, model, pos, tables, state, on, want, frame0, kw)
    _hold_stats("k4", label, on, want, state[9])
    _same_trajectory("k4", label, on, off)
    if not timed:
        return
    times, _ = _in_turns({
        "off": lambda: _k4_call(model, pos, tables, state, frame0, **kw),
        "on": lambda: _k4_call(model, pos, tables, state, frame0, **kw, **stats)})
    s_events = int((on["ev_count"] - state[9]).sum())
    added = stats_bound(R, B, N, STATS_BINS, s_events, N_PROTONS * K,
                        4.0 * B * K * N)
    say(f"[k4] {label}: in turns: {_turns_text(times)}; bound of the added work "
        f"{added['bound_ms']:.5f} ms ({added['bound_by']}: the table distances "
        f"read, the histograms in and out, the matrix written; {s_events} events)")


def phase_k4(dev, libs=None):
    """K4 against topk_sweep_reference on the same tables: TopKPairRates k=8
    (Fermi) and HydroniumRates k=4 (the blend in the loop) at the top-K
    path's launch shape R=4096, B=100, N=144, timed there; law kinds 1-3, a
    triclinic cell, the hot law at max_events 16 and the sparse case (slots
    that empty) at R=256, B=16; the supercells at R=4096, B=16: N=4608,
    P=3072 and the box x4 deployment's N=9216, P=6144 (RNG tile from
    pick_tile_topk), timed there; N=WIDE_SITES at R=256, B=4, where the
    global layout runs (K4's state in global scratch). At each timed shape
    also the in-neighbour lists' build, the events per replica-frame, the
    bound from the least work beside the count of a full evaluation per
    event and, with `libs` (from :func:`_k4_before_libraries`), the
    parent's K4 and this one unstaged, timed in turns with it."""
    from cmdlmc_tpu_torch.ops import topk_sweep as ts

    worst, result = 0.0, {}
    cases = [("topk", TOPK_REPLICAS, PRINT_FREQ, 0, False),
             ("hydronium", TOPK_REPLICAS, PRINT_FREQ, 0, False),
             ("topk", 256, 16, 1, False), ("topk", 256, 16, 2, False),
             ("topk", 256, 16, 3, False), ("topk", 256, 16, 0, True),
             ("hot", 256, 16, 0, False), ("sparse", 256, 16, 0, False),
             ("supercell", SC_REPLICAS, 16, 0, False),
             ("box4", SC_REPLICAS, 16, 0, False), ("wide", 256, 4, 0, False)]
    want_layout = {N_SITES: 0, SC_SITES: 0, BX_SITES: 0, WIDE_SITES: 1}
    for name, R, B, kind, tri in cases:
        max_events = 16 if name == "hot" else MAX_EVENTS
        model, pos, tables, state, kw = _k4_inputs(dev, R, B, name, kind, tri,
                                                   seed=kind, max_events=max_events)
        N, P, K = pos.shape[1], state[4].shape[1], tables[0].shape[1]
        plan = ts.sweep_plan(R, N, K, kw["blend"], dev)
        label = (f"{name} k={K} kind {kind}{' triclinic' if tri else ''} R={R} B={B} "
                 f"N={N} P={P} TR={kw['tile']} max_events {max_events} plan {plan}")
        if plan["layout"] != want_layout[N]:
            raise AssertionError(f"K4 {label}: expected layout {want_layout[N]}")
        timed = R == TOPK_REPLICAS
        frame0 = 0 if timed or name == "wide" else 500
        ms, got = cuda_ms(lambda: _k4_call(model, pos, tables, state, frame0, **kw),
                          reps=3 if timed else 1)
        plain_ms, want = cuda_ms(
            lambda: _k4_call(model, pos, tables, state, frame0, plain=True, **kw), reps=1)
        worst = max(worst, _k4_check(label, model, pos, tables, state, got, want,
                                     frame0, kw))
        events = int(want["ev_count"].sum() - state[9].sum())
        if name in ("supercell", "box4", "wide"):
            _k4_stats(dev, model, pos, tables, state, frame0, kw, got, timed=False)
        if name == "sparse":
            valid = tables[0] < 1.0e5
            mixed = float((valid[:, 0] & ~valid[:, -1]).float().mean())
            say(f"[k4] {label}: {100 * mixed:.1f}% of site-frames have both live and "
                f"exhausted slots; {events} events")
        if not timed:
            continue
        table_bytes = 4.0 * (3 if kw["blend"] else 2) * B * K * N
        changed = topk_changed(tables, kw["blend"])
        b = topk_bound(R, B, N, P, K, events, kw["blend"], table_bytes, changed)
        old = full_topk_bound(R, B, N, P, K, events, kw["blend"], table_bytes)
        lists_ms, _ = cuda_ms(lambda: ts.in_neighbour_lists(tables[1]), reps=5)
        say(f"[k4] {label}: kernel {ms:.3f} ms (in-neighbour lists {lists_ms:.4f} ms "
            f"of it), plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}; {changed:.1f} candidates changed per event; a full "
            f"evaluation per event: {old['bound_ms']:.4f} ms, {old['bound_by']}); "
            f"{events} events, {events / (R * B):.3f} per replica-frame")
        if libs:
            say(f"[k4] {label}: in turns: "
                f"{_k4_before(libs, model, pos, tables, state, frame0, kw, got)}")
        if name == "topk":
            # no single PyTorch call runs this event loop
            result = {"ms": ms, "plain_ms": plain_ms, **b, "library_ms": None}
            _k4_stats(dev, model, pos, tables, state, frame0, kw, got)
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


def _k7_lanes(libs, args, kw, got):
    """This K7 (8 lanes a replica) timed in turns with its builds at 4 and 16
    lanes (8, 4, 16, 16, 4, 8), each held to its bits, as text."""
    from cmdlmc_tpu_torch.ops import water_sweep as ws

    times = {}
    for lanes in (8, 4, 16, 16, 4, 8):
        if lanes == 8:
            ms, out = cuda_ms(lambda: ws.water_sweep(*args, **kw), reps=3)
        else:
            with _library(libs[f"water_lanes{lanes}"]):
                ms, out = cuda_ms(lambda: ws.water_sweep(*args, **kw), reps=3)
        if _digest(out) != _digest(got):
            raise AssertionError(f"K7 at {lanes} lanes a replica differs")
        times.setdefault(lanes, []).append(ms)
    return "; ".join(f"{n} lanes " + ", ".join(f"{t:.4f}" for t in v) + " ms"
                     for n, v in times.items()) + " (the same bits)"


def phase_k7(dev, libs=None):
    """The water tables (K5 with no cutoff, then the transform) bit for bit
    against their plain version at [256, 216] and [256, 1728]; K7 against
    water_sweep_reference at the water path's shape (N=216, R=8192, TR=256,
    the linear transform, keep_last, check_from_old, relaxation 10, d_OH
    0.3) over B=100 frames, and smaller cases (R=1024, B=32) for the ramp,
    the 57-point table, n_atoms = 4 and a waiting time of 3; K7 timed at its
    path's launch, R=8192, B=256, at N=216 and N=1728 (32 to 256 threads
    per block, in turns), held there too, with its plain version timed
    once. The tables and every K7 output held bit for bit to the parent
    kernels' (recorded digests; with `libs` their runs, timed in turns)."""
    import torch

    from cmdlmc_tpu_torch.ops import water_sweep as ws
    from cmdlmc_tpu_torch.ops.knn_tables import knn_block_tables, knn_block_tables_reference

    inf = float("inf")
    for n, box, tname in ((W_SITES, W_BOX, "linear"), (W_BIG_SITES, W_BIG_BOX, "interp")):
        pos = torch.from_numpy(_jitter_block(n, W_BLOCK, box)).to(dev)
        box3 = (box,) * 3
        tkind, tp, tx, ty = _water_transform(tname)
        ms, got = cuda_ms(lambda: ws.water_tables(pos, box3, 3, tkind, tp, tx, ty), reps=20)
        knn_ms, _ = cuda_ms(lambda: knn_block_tables(pos, box3, inf, 3), reps=20)
        plain_ms, (wd, wi) = cuda_ms(lambda: knn_block_tables_reference(pos, box3, inf, 3),
                                     reps=1)
        wr = ws.apply_transform(tkind, wd, tp, tx, ty)
        same = (torch.equal(got[1], wi) and torch.equal(got[0].view(torch.int32),
                                                        wd.view(torch.int32))
                and torch.equal(got[2].view(torch.int32), wr.view(torch.int32)))
        b_, every, route = _knn_bound(pos, box3, inf, 3, got[0])
        say(f"[k7] water tables [B={W_BLOCK}, N={n}, k=3, {tname}] ({route}): bit for bit "
            f"against the plain version: {same}; K5 {knn_ms:.4f} ms (bound "
            f"{b_['bound_ms']:.5f} ms, {b_['bound_by']}; every pair "
            f"{every['bound_ms']:.5f} ms), with the transform {ms:.4f} ms, K5's plain "
            f"version {plain_ms:.3f} ms")
        if not same:
            raise AssertionError(f"water tables at N={n} differ from their plain version")
        _hold_k5("k7", f"[{W_BLOCK},{n}] k=3 no cutoff", got[:2])
        if libs:
            say(f"[k7] water tables [{W_BLOCK},{n}]: K5 "
                f"{_k5_in_turns(libs, pos, box3, inf, 3, got[:2])}")
        if route != "full scan":
            say(f"[k7] water tables [{W_BLOCK},{n}]: {_k5_cell_parts(pos, box3, inf, 3)}")

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
        _held_to_parent("k7", label, got, PARENT_K7_DIGESTS)

    result = {}
    for n, box, tname in ((W_SITES, W_BOX, "linear"), (W_BIG_SITES, W_BIG_BOX, "interp")):
        pos, tables, state, law = _k7_inputs(dev, n, W_BLOCK, W_REPLICAS, box, tname)
        kw = _water_kw()
        args = (pos, *tables, *state, law, 0, (box,) * 3)
        times = {}
        for threads in (32, 64, 128, 256, 256, 128, 64, 32):
            ms, got = cuda_ms(lambda: ws.water_sweep(*args, block_threads=threads, **kw),
                              reps=3)
            times.setdefault(threads, []).append(ms)
        plain_ms, want = cuda_ms(lambda: ws.water_sweep_reference(*args, **kw), reps=1)
        label = f"{tname} R={W_REPLICAS} B={W_BLOCK} N={n} (the path's launch)"
        worst = max(worst, _k7_check(label, pos, tables, state, law, got, want, 0,
                                     (box,) * 3, kw))
        parent = None
        if libs:
            turns = {"parent": [], "this": []}
            for name in ("parent", "this", "this", "parent"):
                if name == "parent":
                    with _library(libs["parent_water"]):
                        t, parent = cuda_ms(lambda: ws.water_sweep(*args, **kw), reps=3)
                else:
                    t, _ = cuda_ms(lambda: ws.water_sweep(*args, **kw), reps=3)
                turns[name].append(t)
            say(f"[k7] {label}: K7 in turns with the parent's: " + "; ".join(
                f"{k_} " + ", ".join(f"{t:.4f}" for t in v) + " ms"
                for k_, v in turns.items()))
            say(f"[k7] {label}: lanes per replica in turns: {_k7_lanes(libs, args, kw, got)}")
        _held_to_parent("k7", label, got, PARENT_K7_DIGESTS, parent)
        events = int(want["ev_count"].sum() - state[7].sum())
        b = water_bound(W_REPLICAS, W_BLOCK, n, 3, events, int(want["trunc"].sum()))
        ms = min(times[ws.BLOCK_THREADS])
        say(f"[k7] {label}: kernel {ms:.4f} ms at {ws.BLOCK_THREADS} threads per "
            f"block (runs {', '.join(f'{t}: ' + ' '.join(f'{x:.4f}' for x in v) for t, v in times.items())} ms), "
            f"plain {plain_ms:.3f} ms, bound {b['bound_ms']:.5f} ms ({b['bound_by']}; "
            f"{events} events, {int(want['trunc'].sum())} truncated replica-frames)")
        if n == W_SITES:
            # no single PyTorch call runs this event loop
            result = {"ms": ms, "plain_ms": plain_ms, **b, "library_ms": None}
    result["max_abs_err"] = worst
    return result


def write_inputs(workdir: Path, frames: int, replicas: int, sweeps=None,
                 stale: bool = False, angle: bool = False, topk: str = "",
                 jumpstat: bool = False, mono: bool = False) -> Path:
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
    nbr_reuse = on. ``jumpstat`` adds ``[Output] jumpstat_bins`` = STATS_BINS
    (the default range) and a ``jumpmatrix_filename`` beside the INI;
    ``mono`` puts bench.py's sites uniform in fractional coordinates of the
    MONO_VECTORS cell (AtomBoxMonoclinic; seed 0, 0.03 A of jitter)."""
    import numpy as np

    workdir.mkdir(parents=True, exist_ok=True)
    supercell = topk == "supercell"
    mult = {"box4": BOX_MULT, "box2": (2, 2, 2)}.get(topk, (1, 1, 1))
    walk = supercell or mult != (1, 1, 1)
    tag = ("angle_" if angle else "sc_" if supercell else "walk_" if walk
           else "mono_" if mono else "")
    n_sites, protons, box = ((SC_SITES, SC_PROTONS, SC_BOX) if supercell
                             else (N_SITES, N_PROTONS, BOX))
    traj = workdir / f"traj_{tag}{frames}.xyz"
    if not traj.exists():
        rng = np.random.RandomState(0)
        if walk:
            block = _walk_block(n_sites, frames, box)
            names = np.array(["O"] * n_sites)
        elif mono:
            base = rng.uniform(0, 1, size=(N_SITES, 3)) @ np.asarray(MONO_VECTORS)
            names = np.array(["O"] * N_SITES)
            block = (base[None] + np.stack([rng.normal(scale=0.03, size=base.shape)
                                            for _ in range(frames)])).astype(np.float32)
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
    name = (f"run_{tag}{topk}{frames}_{replicas}{'_stale' if stale else ''}"
            f"{'_js' if jumpstat else ''}.ini")
    cfg = workdir / name
    atombox = (f"type = AtomBoxCubic\nperiodic_boundaries = {box}, {box}, {box}"
               if not mono else "type = AtomBoxMonoclinic\nperiodic_boundaries = "
               + ", ".join(str(x) for v in MONO_VECTORS for x in v))
    stats = (f"jumpstat_bins = {STATS_BINS}\n" if jumpstat else "")
    matrix = (f"jumpmatrix_filename = {cfg.with_suffix('.npy')}" if jumpstat else "")
    cfg.write_text(f"""[Trajectory]
filename = {traj}
time_step = {DT}
[AtomBox]
{atombox}
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
{stats}[Engine]
replicas = {replicas}
seed = 1
block_size = {BLOCK}
max_events_per_frame = {MAX_EVENTS}
{f"sweeps = {sweeps}" if sweeps else ""}
{"stale_rates = on" if stale else ""}
{"nbr_reuse = off" if supercell else "nbr_reuse = on" if topk == "box2" else ""}
{matrix}
""")
    return cfg


def parse_rows(text: str):
    """(header, observable rows, perf lines) of a run's output; the rows
    stop at the jumpstat block (:func:`jumpstat_rows`)."""
    lines = text.splitlines()
    header = [ln for ln in lines if ln.startswith("#") and "Sweeps" in ln]
    end = next((i for i, ln in enumerate(lines) if ln.startswith("# jumpstat over")),
               len(lines))
    rows = [ln.split() for ln in lines[:end] if ln.strip() and not ln.startswith("#")]
    perf = [ln for ln in lines if ln.startswith("# perf:")]
    return header, rows, perf


def jumpstat_rows(text: str, bins: int = STATS_BINS):
    """The jumpstat block's rows (d, jumps, exposure, P(jump), omega) as
    floats, checked: `bins` rows after its 7 comment lines, finite, some
    jumps and exposure."""
    import numpy as np

    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("# jumpstat over"))
    rows = np.array([ln.split() for ln in lines[start + 7:start + 7 + bins]],
                    dtype=np.float64)
    if rows.shape != (bins, 5) or not np.isfinite(rows).all():
        raise AssertionError(f"jumpstat block malformed: {lines[start:start + 9]}")
    if rows[:, 1].sum() <= 0 or rows[:, 2].sum() <= 0:
        raise AssertionError("jumpstat block: no jumps or no exposure")
    return rows


def _counters():
    """The launch counter of every kernel wrapper, by kernel name (and of
    K6's plan builder, whose kernels launch once per call)."""
    from cmdlmc_tpu_torch.ops import kmc_sweep as ks
    from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss
    from cmdlmc_tpu_torch.ops import topk_sweep as ts
    from cmdlmc_tpu_torch.ops import water_sweep as ws
    from cmdlmc_tpu_torch.ops.knn_sparse import device_plan, knn_sparse_tables
    from cmdlmc_tpu_torch.ops.knn_tables import knn_block_tables
    from cmdlmc_tpu_torch.ops.pairwise import pairwise_cubic

    return {"kmc_sweep_streamed": kss.kmc_sweep_streamed,
            "pairwise_cubic": pairwise_cubic, "kmc_sweep": ks.kmc_sweep,
            "topk_sweep": ts.topk_sweep, "knn_tables": knn_block_tables,
            "knn_sparse": knn_sparse_tables, "device_plan": device_plan,
            "water_sweep": ws.water_sweep}


def _small_cuda_vs_cpu(label, cfg):
    """The same config and initial state on the card and on the CPU (plain
    versions) must land in the same final state, but for near-ties; with
    jump statistics their histograms on the replicas that agree too, and,
    where every replica agrees, the saved jump matrices (each device's run
    saves its own file)."""
    import numpy as np
    import torch

    from cmdlmc_tpu_torch import driver

    finals, matrices = {}, {}
    text = Path(cfg).read_text()
    for d in ("cuda", "cpu"):
        npy = Path(cfg).with_name(f"{Path(cfg).stem}_{d}.npy")
        ini = Path(cfg).with_name(f"{Path(cfg).stem}_{d}.ini")
        ini.write_text(re.sub(r"(?m)^jumpmatrix_filename = .*$",
                              f"jumpmatrix_filename = {npy}", text))
        finals[d] = driver.run_from_config(ini, out=io.StringIO(), device=d).final_states
        if "jumpmatrix_filename" in text:
            matrices[d] = np.load(npy)
    a, b = finals["cuda"].replicas, finals["cpu"].replicas
    same = ((a.site_of_proton.cpu() == b.site_of_proton).all(dim=1)
            & (a.clock.event_count.cpu() == b.clock.event_count))
    for k in ("jump_hist", "opportunity_hist"):
        if not torch.equal(getattr(a, k).cpu()[same], getattr(b, k)[same]):
            raise AssertionError(f"small {label} run: {k} differs on cuda vs cpu")
    if a.jump_hist.shape[-1] and int(a.jump_hist.sum()) == 0:
        raise AssertionError(f"small {label} run: no jump binned")
    if matrices:
        events = int(a.clock.event_count.sum())
        if int(matrices["cuda"].sum()) != events:
            raise AssertionError(f"small {label} run: the card's jump matrix sums to "
                                 f"{int(matrices['cuda'].sum())}, not {events}")
        if bool(same.all()) and not np.array_equal(matrices["cuda"], matrices["cpu"]):
            raise AssertionError(f"small {label} run: the jump matrix differs on "
                                 "cuda vs cpu")
        agree = " and equals the CPU run's" if bool(same.all()) else ""
        say(f"[e2e] small {label} run: the saved jump matrix sums to the {events} "
            f"events{agree}")
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
    _drive.last_events = int(ev.sum())
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
    top-K and hydronium deployments at R=4096 (K5 + K4 each) and the top-K
    supercell at N=4608 (K6 + K4: the route takes K6 from 864 sites; none
    of K1, K2, K3 in any of them). Then the jump statistics
    (:func:`_drive_statistics`)."""
    _small_cuda_vs_cpu("dense", write_inputs(WORK, frames=64, replicas=256))
    _small_cuda_vs_cpu("jumpstat", write_inputs(WORK, frames=64, replicas=256,
                                                jumpstat=True))
    _small_cuda_vs_cpu("monoclinic", write_inputs(WORK, frames=64, replicas=256,
                                                  mono=True))
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
        card, 512, SC_REPLICAS, expect=("topk_sweep", "knn_sparse", "device_plan"),
        refuse=(*dense, "knn_tables"),
        n_sites=SC_SITES, protons=SC_PROTONS)
    paths[BOX4] = _drive_box4(card)
    paths.update(_drive_statistics(card))
    return paths


BOX4 = "topk supercell N=9216 box x4 reuse"
JS, MONO, JS_CLI = ("dense R=16384 jumpstat", "monoclinic R=16384",
                    "jumpstat CLI R=1024")


def _drive_statistics(card: str):
    """The jump statistics end to end: bench.py's deployment at R=16384 with
    STATS_BINS bins and the jump matrix (K2 + K1, no K3), whose rows must
    equal those of the run without statistics bit for bit and whose saved
    matrix must sum to the run's events; the monoclinic deployment at
    R=16384 (K1 with the triclinic cell, no K2, no K3); and the jumpstat
    CLI at R=1024 (K3) with --fit."""
    import numpy as np

    from cmdlmc_tpu_torch.cli import jumpstat

    out = {}
    cfg = write_inputs(WORK, frames=1024, replicas=REPLICAS, jumpstat=True)
    out[JS] = _drive(JS, cfg, card, 1024, REPLICAS,
                     expect=("kmc_sweep_streamed", "pairwise_cubic"),
                     refuse=("kmc_sweep",))
    text = (WORK / f"e2e_output_{JS.replace(' ', '_')}.txt").read_text()
    plain = (WORK / "e2e_output_dense_R=16384.txt").read_text()
    if parse_rows(text)[1] != parse_rows(plain)[1]:
        raise AssertionError(f"{JS}: the rows differ from the run without statistics")
    rows = jumpstat_rows(text)
    matrix = np.load(cfg.with_suffix(".npy"))
    events = int(_drive.last_events)
    if int(matrix.sum()) != events or matrix.shape != (N_SITES, N_SITES):
        raise AssertionError(f"{JS}: the saved matrix sums to {int(matrix.sum())}, "
                             f"not the run's {events} events")
    say(f"[e2e] {JS}: rows equal the run without statistics bit for bit; the "
        f"saved {matrix.shape} matrix sums to the {events} events; "
        f"{int(rows[:, 1].sum())} jumps binned, {rows[:, 2].sum():.1f} frames of "
        f"exposure; omega(d) over the bins: "
        + ", ".join(f"{d:.3f}: {w:.4g}" for d, w in rows[::4, [0, 4]]))
    out[MONO] = _drive(MONO, write_inputs(WORK, frames=1024, replicas=REPLICAS,
                                          mono=True),
                       card, 1024, REPLICAS, expect=("kmc_sweep_streamed",),
                       refuse=("kmc_sweep", "pairwise_cubic"))
    cfg = write_inputs(WORK, frames=1024, replicas=INKERNEL_REPLICAS, sweeps=512)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        jumpstat.main([str(cfg), "--bins", str(STATS_BINS), "--range", "2.2", "3.0",
                       "--fit"])
    wall = time.perf_counter() - t0
    out[JS_CLI] = {name: fn.launches for name, fn in counters.items()}
    text = buf.getvalue()
    (WORK / "e2e_output_jumpstat_cli.txt").write_text(text)
    say(f"[e2e] {JS_CLI}: launches {out[JS_CLI]}; wall {wall:.2f} s ({card})")
    if out[JS_CLI]["kmc_sweep"] <= 0 or out[JS_CLI]["kmc_sweep_streamed"]:
        raise AssertionError(f"{JS_CLI}: expected K3 launches only, got {out[JS_CLI]}")
    rows = jumpstat_rows(text)
    at = text.find("# Fermi fit omega")
    if at < 0:
        raise AssertionError(f"{JS_CLI}: the Fermi fit did not run: {text[-300:]}")
    fit = text[at:].splitlines()[:4]
    say(f"[e2e] {JS_CLI}: {int(rows[:, 1].sum())} jumps binned; "
        + "; ".join(ln[2:].strip() for ln in fit)
        + f" (the run's law: a={FERMI[0]}, b={FERMI[1]}, c={FERMI[2]})")
    return out


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
                      expect=("topk_sweep", "knn_sparse", "device_plan"),
                      refuse=("kmc_sweep_streamed", "pairwise_cubic", "kmc_sweep",
                              "knn_tables"),
                      n_sites=BX_SITES, protons=BX_PROTONS)
    rebuilds = ts.topk_tables_verlet.rebuild_frames
    say(f"[e2e] {BOX4}: {rebuilds} rebuild frames of 512, knn_sparse launches "
        f"{launches['knn_sparse']} (each over a plan built on the card: "
        f"{launches['device_plan']}), knn_tables launches {launches['knn_tables']}")
    if not 0 < rebuilds < 512:
        raise AssertionError(f"{BOX4}: Verlet reuse rebuilt {rebuilds} of 512 frames")
    if not 0 < launches["knn_sparse"] <= rebuilds \
            or launches["device_plan"] != launches["knn_sparse"]:
        raise AssertionError(f"{BOX4}: K6 and its plan must launch once per rebuild "
                             f"build, got {launches}")
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
# past 19,370 sites, the limit of the K7 before its prefix table (its prefix
# sum had to fit in a block's shared memory): a few frames at a small R
W_HUGE_SITES, W_HUGE_REPLICAS, W_HUGE_FRAMES = 20000, 256, 16
W_HUGE_BOX = W_BOX * (W_HUGE_SITES / W_SITES) ** (1.0 / 3.0)
WHUGE = f"water N={W_HUGE_SITES} R={W_HUGE_REPLICAS}"


def _water_past_the_old_limit(dev):
    """At N=20000 (bench_water.py's density, a 84.1 A cube) over 4 frames:
    the water tables bit for bit against their plain version, and K7 at
    R=256 against water_sweep_reference, held as phase_k7 holds it."""
    import torch

    from cmdlmc_tpu_torch.ops import water_sweep as ws
    from cmdlmc_tpu_torch.ops.knn_tables import knn_block_tables_reference

    n, box3, frames = W_HUGE_SITES, (W_HUGE_BOX,) * 3, 4
    pos, tables, state, law = _k7_inputs(dev, n, frames, W_HUGE_REPLICAS, W_HUGE_BOX)
    wd, wi = knn_block_tables_reference(pos, box3, float("inf"), 3)
    tkind, tp, tx, ty = _water_transform("linear")
    wr = ws.apply_transform(tkind, wd, tp, tx, ty)
    same = (torch.equal(tables[1], wi) and torch.equal(tables[0].view(torch.int32),
                                                       wd.view(torch.int32))
            and torch.equal(tables[2].view(torch.int32), wr.view(torch.int32)))
    say(f"[water] tables [{frames},{n}] k=3, linear: bit for bit against the plain "
        f"version: {same}")
    if not same:
        raise AssertionError(f"water tables at N={n} differ from their plain version")
    kw = _water_kw()
    args = (pos, *tables, *state, law, 0, box3)
    got = ws.water_sweep(*args, **kw)
    want = ws.water_sweep_reference(*args, **kw)
    _k7_check(f"linear R={W_HUGE_REPLICAS} B={frames} N={n}", pos, tables, state, law,
              got, want, 0, box3, kw)


def phase_water(card: str):
    """The water deployment end to end through the port's kmc_water main:
    a small run held against the CPU, then N=216 at R=8192 over 1024
    frames and N=1728 (its 57-point table) over 512 frames, K5 + K7 each;
    then past the earlier K7's 19,370 sites: K5 and K7 held against their
    plain versions at N=20000, and the CLI run there (R=256, 16 frames)."""
    _water_cuda_vs_cpu()
    paths = {W216: _drive_water(W216, write_water_inputs(WORK, W_SITES, 1024, W_REPLICAS),
                                card, W_SITES, 1024, W_REPLICAS)}
    paths[W1728] = _drive_water(
        W1728, write_water_inputs(WORK, W_BIG_SITES, 512, W_REPLICAS, interp=True),
        card, W_BIG_SITES, 512, W_REPLICAS)
    import torch

    _water_past_the_old_limit(torch.device("cuda", 0))
    paths[WHUGE] = _drive_water(
        WHUGE, write_water_inputs(WORK, W_HUGE_SITES, W_HUGE_FRAMES, W_HUGE_REPLICAS),
        card, W_HUGE_SITES, W_HUGE_FRAMES, W_HUGE_REPLICAS)
    return paths


# -- what mdmc reads and writes: host I/O, checkpoints, XYZOutput ------------

# the native tokenizer against numpy at the parse shapes of the measured
# paths: the dense deployment, water N=216 and the N=4608 supercell's block
PARSE_SHAPES = ((1024, N_SITES, BOX), (1024, W_SITES, W_BOX), (64, SC_SITES, SC_BOX))


def _best_s(fn, reps=3) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _cut_ini(cfg: Path, tag: str, engine=(), output=None, sweeps=None) -> Path:
    """A copy of a write_inputs INI beside it: ``engine`` lines added to
    [Engine], the output type replaced, the frame count (``sweeps``) set."""
    text = cfg.read_text()
    if sweeps is not None:
        text = re.sub(r"(?m)^sweeps = .*\n", "", text)
        engine = (*engine, f"sweeps = {sweeps}")
    text = text.replace("[Engine]\n", "[Engine]\n" + "".join(f"{ln}\n" for ln in engine))
    if output:
        text = text.replace("type = ObservablesOutput", f"type = {output}")
    out = cfg.with_name(f"{cfg.stem}_{tag}.ini")
    out.write_text(text)
    return out


def _run_counted(cfg: Path):
    """driver.run_from_config on the card with every launch count set to 0
    just before and read just after: (text, simulation, launches, wall s)."""
    import torch

    from cmdlmc_tpu_torch import driver

    counters = _counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    sim = driver.run_from_config(cfg, out=buf, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return buf.getvalue(), sim, {n: fn.launches for n, fn in counters.items()}, wall


def _state_diff(a, b, prefix="") -> list:
    """Names of the fields where two states differ (tensors bit for bit,
    the neighbor carry's floats exactly)."""
    import dataclasses

    import torch

    diff = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x) and dataclasses.is_dataclass(y):
            diff += _state_diff(x, y, f"{prefix}{f.name}.")
        elif isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and x.shape == y.shape and torch.equal(x, y)):
                diff.append(prefix + f.name)
        elif x != y:
            diff.append(prefix + f.name)
    return diff


@contextlib.contextmanager
def _save_probe(mod, attr):
    """While open, each launch of ``mod.attr`` (an event-loop kernel's
    wrapper) is bracketed by CUDA events and each checkpoint save is noted
    with the launches before it, its host time and its write's time. Yields
    (launches, saves); the wrapper's launch counter is carried over."""
    import torch

    from cmdlmc_tpu_torch.utils import checkpoint as ck

    launches, saves = [], []
    inner, save = getattr(mod, attr), ck.CheckpointWriter.save

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args, **kwargs)
        end.record()
        launches.append((start, end))
        return out

    def noted(self, *args, **kwargs):
        self.wait()
        if saves and saves[-1]["writer"] is self:
            saves[-1]["write_s"] = self.write_seconds
        save(self, *args, **kwargs)
        saves.append({"after": len(launches), "save_s": self.save_seconds,
                      "writer": self, "write_s": None})

    timed.__dict__.update(inner.__dict__)
    setattr(mod, attr, timed)
    ck.CheckpointWriter.save = noted
    try:
        yield launches, saves
    finally:
        inner.__dict__.update(timed.__dict__)
        setattr(mod, attr, inner)
        ck.CheckpointWriter.save = save
        for s in saves:
            if s["write_s"] is None:
                s["write_s"] = s["writer"].write_seconds


def _save_report(label, launches, saves, card) -> str:
    """Each save's host time and write time, and the device gap between the
    kernel launches around it beside the median of the other gaps."""
    gaps = [launches[i][1].elapsed_time(launches[i + 1][0])
            for i in range(len(launches) - 1)]
    at = {s["after"] - 1 for s in saves}
    others = sorted(g for i, g in enumerate(gaps) if i not in at)
    median = others[len(others) // 2] if others else float("nan")
    parts = []
    for s in saves:
        i = s["after"] - 1
        gap = f"{gaps[i]:.3f} ms" if 0 <= i < len(gaps) else "after the last launch"
        parts.append(f"after launch {s['after']}: save() {1e3 * s['save_s']:.3f} ms on the "
                     f"host, write {1e3 * s['write_s']:.1f} ms on its thread, gap {gap}")
    return (f"[resume] {label}: {len(saves)} saves; " + "; ".join(parts)
            + f"; median gap without a save {median:.3f} ms over {len(others)} gaps ({card})")


def phase_host_io(card: str):
    """The host's side of mdmc on the card's machine: the native tokenizer
    must build and load (the phase fails otherwise), timed against the
    numpy path at PARSE_SHAPES with the count of floats where the two
    differ; ``mdmc --legacy`` and ``mdmc --profile DIR`` on a small dense
    run; and, where h5py imports, trajconv and an HDF5 run whose rows equal
    the xyz run's (else it says that they were not run, and why)."""
    import numpy as np

    from cmdlmc_tpu_torch import native
    from cmdlmc_tpu_torch.io import xyz

    if native.get_lib() is None:
        raise AssertionError("the native xyz tokenizer did not build or load on this host")
    say(f"[host_io] native tokenizer loaded: {Path(native.so_path()).name}")
    for frames, n, box in PARSE_SHAPES:
        block = _jitter_block(n, frames, box)
        lines = [f"O {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in block.reshape(-1, 3).tolist()]
        _, fast = xyz._parse_batch(lines, n)
        t_native = _best_s(lambda: xyz._parse_batch(lines, n))
        parse = native.parse_atom_lines
        native.parse_atom_lines = lambda *args: None
        try:
            _, slow = xyz._parse_batch(lines, n)
            t_numpy = _best_s(lambda: xyz._parse_batch(lines, n))
        finally:
            native.parse_atom_lines = parse
        if fast.shape != (frames, n, 3) or slow.shape != fast.shape:
            raise AssertionError(f"parse of {frames} x {n}: shapes {fast.shape}, {slow.shape}")
        ulps = np.abs(fast.view(np.int32).astype(np.int64) - slow.view(np.int32).astype(np.int64))
        say(f"[host_io] parse of {frames} frames x {n} atoms: native {1e3 * t_native:.1f} ms, "
            f"numpy {1e3 * t_numpy:.1f} ms (best of 3, one thread); {int((ulps > 0).sum())} of "
            f"{ulps.size} floats differ (at most {int(ulps.max())} ulp) ({card})")
        if ulps.max() > 1:
            raise AssertionError("the native and numpy parses differ by more than an ulp")
    _legacy_and_profile(card)
    _hdf5_run(card)


def _legacy_and_profile(card: str):
    """``mdmc --legacy`` on a keyword config of the dense deployment at
    R=256 (K3), and ``mdmc --profile DIR`` on its INI twin, whose trace must
    hold the card's kernels."""
    from cmdlmc_tpu_torch.cli import mdmc

    ini = write_inputs(WORK, frames=64, replicas=256)
    legacy = WORK / "legacy_64_256.cfg"
    legacy.write_text(f"""filename {WORK / 'traj_64.xyz'}
pbc {BOX} {BOX} {BOX}
md_timestep_fs {DT}
sweeps 64
print_frequency 16
reset_freq 0
proton_number {N_PROTONS}
lattice_size {N_SITES}
donor_atoms O
jumprate_type MD_rates
jumprate_params_fs a={FERMI[0]} b={FERMI[1]} c={FERMI[2]}
cutoff_radius {CUTOFF}
neighbor_search_radius {CUTOFF + BUFFER}
seed 1
replicas 256
""")
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mdmc.main([str(legacy), "--legacy"])
    _, rows, _ = parse_rows(buf.getvalue())
    launches = {n: fn.launches for n, fn in counters.items()}
    if [int(r[0]) for r in rows] != [0, 16, 32, 48] or launches["kmc_sweep"] <= 0:
        raise AssertionError(f"mdmc --legacy: rows {rows}, launches {launches}")
    say(f"[host_io] mdmc --legacy (R=256, 64 frames): {len(rows)} rows, K3 launches "
        f"{launches['kmc_sweep']} ({card})")
    trace_dir = WORK / "mdmc_profile"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mdmc.main([str(ini), "--profile", str(trace_dir)])
    events = json.loads((trace_dir / "mdmc_trace.json").read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels or not parse_rows(buf.getvalue())[1]:
        raise AssertionError("mdmc --profile: no rows, or no kernel in the trace")
    say(f"[host_io] mdmc --profile: {len(kernels)} kernel records in "
        f"{trace_dir / 'mdmc_trace.json'}")


def _hdf5_run(card: str):
    """trajconv of the dense R=1024 trajectory and the HDF5 run of it,
    whose rows must equal the xyz run's; where h5py does not import, says
    so instead."""
    try:
        import h5py  # noqa: F401
    except ImportError as exc:
        say(f"[host_io] HDF5 not run: h5py does not import on this host ({exc}); "
            "trajconv and HDF5 trajectories need it")
        return
    from cmdlmc_tpu_torch.io.converters import save_xyz_to_hdf5

    cfg = write_inputs(WORK, frames=1024, replicas=INKERNEL_REPLICAS, sweeps=512)
    h5 = save_xyz_to_hdf5(str(WORK / "traj_1024.xyz"), str(WORK / "traj_1024.h5"))
    h5cfg = cfg.with_name(f"{cfg.stem}_h5.ini")
    h5cfg.write_text(cfg.read_text().replace(
        f"filename = {WORK / 'traj_1024.xyz'}", f"type = HDF5Trajectory\nfilename = {h5}"))
    text, _, _, _ = _run_counted(cfg)
    h5text, _, launches, wall = _run_counted(h5cfg)
    if parse_rows(h5text)[1] != parse_rows(text)[1] or launches["kmc_sweep"] <= 0:
        raise AssertionError("the HDF5 run's rows differ from the xyz run's")
    say(f"[host_io] HDF5 run (R=1024, 512 frames): rows equal the xyz run's; K3 "
        f"launches {launches['kmc_sweep']}; wall {wall:.2f} s ({card})")


def phase_resume(card: str):
    """Checkpoints on the main path and on the box x4 supercell: each run
    straight through with a save every block, then stopped halfway and
    resumed; the rows and the final states must equal bit for bit. Prints
    each save's time and the device gap it leaves between the event-loop
    kernel's launches, the load's time, and each run's launch counts."""
    from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss
    from cmdlmc_tpu_torch.ops import topk_sweep as ts

    dense = write_inputs(WORK, frames=1024, replicas=REPLICAS)
    box4 = write_inputs(WORK, frames=512, replicas=SC_REPLICAS, topk="box4")
    paths = {}
    for label, cfg, frames, mod, attr in (
            ("dense R=16384", dense, 1024, kss, "kmc_sweep_streamed"),
            (BOX4, box4, 512, ts, "topk_sweep")):
        paths.update(_resume(label, cfg, frames, mod, attr, card))
    return paths


def _resume(label, cfg, frames, mod, attr, card):
    from cmdlmc_tpu_torch import driver

    tag = "".join(c if c.isalnum() else "_" for c in label)
    ckpts = [WORK / f"ckpt_{tag}_{which}.npz" for which in ("straight", "split")]
    for p in ckpts:
        p.unlink(missing_ok=True)
    every = ("checkpoint_interval = 1",)
    straight = _cut_ini(cfg, "ckpt_straight", (f"checkpoint_path = {ckpts[0]}", *every))
    split = [_cut_ini(cfg, f"ckpt_split{i}", (f"checkpoint_path = {ckpts[1]}", *every),
                      sweeps=n) for i, n in ((1, frames // 2), (2, frames))]
    _, _, _, plain_wall = _run_counted(cfg)
    with _save_probe(mod, attr) as (launches, saves):
        text, sim, counts, wall = _run_counted(straight)
    say(_save_report(f"{label} straight, a save every block", launches, saves, card))
    text1, _, counts1, wall1 = _run_counted(split[0])
    load = driver.Simulation._load_checkpoint
    loads = []

    def timed_load(self, path):
        t0 = time.perf_counter()
        out = load(self, path)
        loads.append(time.perf_counter() - t0)
        return out

    driver.Simulation._load_checkpoint = timed_load
    try:
        text2, sim2, counts2, wall2 = _run_counted(split[1])
    finally:
        driver.Simulation._load_checkpoint = load
    rows, rows1, rows2 = (parse_rows(t)[1] for t in (text, text1, text2))
    diff = _state_diff(sim2.final_states, sim.final_states)
    say(f"[resume] {label}: straight {len(rows)} rows, stopped at frame {frames // 2} "
        f"with {len(rows1)} rows, resumed with {len(rows2)}; launches straight {counts}, "
        f"first half {counts1}, resumed {counts2}")
    say(f"[resume] {label}: wall without checkpoints {plain_wall:.3f} s, with a save "
        f"every block {wall:.3f} s; first half {wall1:.3f} s, resumed half {wall2:.3f} s "
        f"(its load {1e3 * loads[0]:.1f} ms) ({card})")
    if rows1 + rows2 != rows or not rows2 or diff:
        raise AssertionError(f"{label}: the resumed run differs from the straight run "
                             f"(rows equal: {rows1 + rows2 == rows}; fields {diff})")
    if min(counts1[attr], counts2[attr]) <= 0:
        raise AssertionError(f"{label}: {attr} did not launch on both sides of the checkpoint")
    carry = sim2.final_states.nbr_carry
    say(f"[resume] {label}: rows and final state equal the straight run's bit for bit"
        + (f", the neighbor carry included (last rebuild at frame {carry.last_rebuild:.0f})"
           if carry is not None else ""))
    return {f"{label} resumed": counts2}


def phase_xyz(card: str):
    """XYZOutput at R=1024 (K3): its final state equals the observables run
    of the same config bit for bit, its frames are well formed (the donors
    and a pseudo-atom on a donor site for each proton), and stopped at frame
    256 and resumed it prints the straight run's frames."""
    import numpy as np

    cfg = write_inputs(WORK, frames=1024, replicas=INKERNEL_REPLICAS, sweeps=512)
    xyz = _cut_ini(cfg, "xyz", output="XYZOutput")
    _, obs, _, _ = _run_counted(cfg)
    text, sim, launches, wall = _run_counted(xyz)
    diff = _state_diff(sim.final_states, obs.final_states)
    if diff or launches["kmc_sweep"] <= 0 or launches["kmc_sweep_streamed"]:
        raise AssertionError(f"XYZOutput R=1024: fields {diff} differ from the observables "
                             f"run's, launches {launches}")
    lines = [ln for ln in text.splitlines() if ln and not ln.startswith("#")]
    frames, i = [], 0
    while i < len(lines):
        n = int(lines[i])
        frames.append(lines[i:i + 2 + n])
        i += 2 + n
    if [f[1] for f in frames] != [f"frame {k}" for k in range(0, 512, PRINT_FREQ)]:
        raise AssertionError(f"XYZOutput R=1024: frames {[f[1] for f in frames]}")
    for f in frames:
        names = [ln.split()[0] for ln in f[2:]]
        pos = np.array([ln.split()[1:] for ln in f[2:]], dtype=np.float64)
        donors, protons = pos[:N_SITES], pos[N_SITES:]
        on_site = (np.abs(protons[:, None] - donors[None]).max(axis=-1) == 0).any(axis=1)
        if (names != ["O"] * N_SITES + ["H"] * N_PROTONS or not np.isfinite(pos).all()
                or not on_site.all()):
            raise AssertionError(f"XYZOutput R=1024: {f[1]} is malformed")
    ckpt = WORK / "ckpt_xyz.npz"
    ckpt.unlink(missing_ok=True)
    parts = [_run_counted(_cut_ini(xyz, f"ckpt{n}", (f"checkpoint_path = {ckpt}",),
                                   sweeps=n))[0] for n in (256, 512)]
    resumed = [ln for t in parts for ln in t.splitlines() if ln and not ln.startswith("#")]
    if resumed != lines:
        raise AssertionError("XYZOutput R=1024: the resumed run's frames differ")
    say(f"[xyz] XYZOutput R=1024 (512 frames): {len(frames)} frames well formed; final "
        f"state equal to the observables run's bit for bit; stopped at 256 and resumed, "
        f"the same frames; launches {launches}; wall {wall:.2f} s ({card})")
    return {"xyz R=1024": launches}


def _union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


VERLET_RANGE = "verlet_tables"
LISTS_RANGE = "k4_in_lists"
CELLS_RANGE = "k5_cell_lists"


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
    from cmdlmc_tpu_torch.ops import knn_tables as knn
    from cmdlmc_tpu_torch.ops import topk_sweep as ts
    from cmdlmc_tpu_torch.utils import checkpoint as ck

    # the water CLI imports prefetch when it runs, so the patched one (the
    # driver bound its own at import and is not affected)
    return [(wm, "init_water_states", "init_water_states", "call"),
            (stream, "prefetch", "water_next_block", "iter"),
            (wm, "run_water_block_fused", "water_block", "call"),
            (eng, "init_replicas", "init_replicas", "call"),
            (driver.Simulation, "_blocks", "next_block", "iter"),
            (eng_fused, "run_block_fused", "run_block", "call"),
            (ts, "topk_tables_verlet", VERLET_RANGE, "call"),
            (ts, "in_neighbour_lists", LISTS_RANGE, "call"),
            (knn, "cell_lists", CELLS_RANGE, "call"),
            (kns, "device_plan", "device_plan", "call"),
            (driver.Simulation, "_fused_post", "fused_post", "call"),
            (driver.Simulation, "_emit_fused", "emit_rows", "gen"),
            (ck.CheckpointWriter, "save", "ckpt_save", "call"),
            (driver.Simulation, "_load_checkpoint", "ckpt_load", "call")]


@contextlib.contextmanager
def _annotated():
    """Run the host stages of :func:`_host_ranges` inside profiler ranges of
    their names, for :func:`_range_device_ms` and :func:`_idle_report`
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
    holds device_plan) and the idle time that no range covers. Returns text."""
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


def _range_device_ms(events, name, exclude=()) -> float:
    """Device time of the kernels launched inside the profiler range `name`
    (matched by the launch's correlation id), but for those whose names hold
    one of `exclude`: for VERLET_RANGE, less the K-nearest kernels of the
    rebuilds, the Verlet epilogue (the drift tests and the frozen-id
    distances and gathers); for LISTS_RANGE, K4's in-neighbour lists; for
    CELLS_RANGE, less K5's binning kernel, torch's sort and cumsum of K5's
    cell lists."""
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("name") == name and e.get("cat") == "user_annotation"]
    corr = {e["args"]["correlation"] for e in events
            if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})
            and any(a <= e["ts"] <= b for a, b in ranges)}
    return sum(e["dur"] for e in events
               if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in corr
               and not any(k in e["name"] for k in exclude)) / 1e3


def phase_profile(card: str):
    """Where the end-to-end run's time goes: the bench.py deployment with
    fresh and with stale rates, both top-K supercells and the water N=216
    deployment (through the kmc_water main), each traced with
    torch.profiler after a warm run. The fresh run is traced four times, in
    turns with K1's lists sized on the host (LIST_SCRATCH_BUDGET = 0: the
    host waits for the counted lengths before each launch) and on the device
    (the default: no wait), to show what the host's wait costs; the fresh
    run with a checkpoint every block is traced too (its saves and the
    load in ranges). Device busy time is the union of kernel
    and copy intervals in the trace; idle is the rest of the traced wall
    time; the box x4 run's Verlet epilogue is the device time launched from
    its stage 1 but for K5 and K6, and each top-K run's in-neighbour lists
    the device time launched from their build. Each run's idle time is split at the
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
        f"{time.perf_counter() - t0:.3f} s (the native tokenizer, one thread)")
    water_cfg = write_water_inputs(WORK, W_SITES, 1024, W_REPLICAS)
    t0 = time.perf_counter()
    frames = sum(pos.shape[0] for _, pos, _ in XYZTrajectory(
        WORK / f"water_{W_SITES}_1024.xyz", time_step=DT,
        batch_frames=W_BLOCK).iter_batches())
    say(f"[profile] host xyz parse of {frames} frames x {W_SITES} atoms: "
        f"{time.perf_counter() - t0:.3f} s (the native tokenizer, one thread)")
    # each kernel's CUDA kernels by name: K5 is its full scan, its cell
    # route and that route's binning kernel; K7 its prefix pre-pass, its
    # packing of the tables and its loop
    k5 = ("knn_full_kernel", "knn_cells_kernel", "knn_bin_kernel")
    dense = {"K1": ("kmc_sweep_streamed_kernel",), "K2": ("pairwise_kernel",)}
    # K6: its kernel and the six of its plan
    knn = {"K5": k5, "K6": ("knn_sparse_kernel", *(f"sparse_{p}_kernel" for p in (
        "site", "scan", "bucket", "rank", "box", "list")))}
    fresh = write_inputs(WORK, frames=1024, replicas=REPLICAS)
    ckpt = WORK / "ckpt_profile.npz"
    runs = [("fresh, host-sized lists", fresh, dense), ("fresh", fresh, dense),
            ("fresh again", fresh, dense),
            ("fresh, host-sized lists again", fresh, dense),
            ("stale", write_inputs(WORK, frames=1024, replicas=REPLICAS, stale=True),
             dense),
            ("fresh, a save every block", _cut_ini(fresh, "ckpt_profile", (
                f"checkpoint_path = {ckpt}", "checkpoint_interval = 1")), dense),
            ("supercell", write_inputs(WORK, frames=512, replicas=SC_REPLICAS,
                                       topk="supercell"),
             {"K4": ("topk_sweep_kernel",), **knn}),
            ("box4", write_inputs(WORK, frames=512, replicas=SC_REPLICAS, topk="box4"),
             {"K4": ("topk_sweep_kernel",), **knn}),
            ("water", water_cfg, {"K7": ("water_sweep_kernel", "water_prefix_kernel",
                                         "water_pack_kernel"), "K5": k5})]
    from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss

    scratch_budget = kss.LIST_SCRATCH_BUDGET
    for name, cfg, kernels in runs:
        kss.LIST_SCRATCH_BUDGET = 0 if "host-sized" in name else scratch_budget
        if name == "water":
            def run(out, cfg=cfg):
                out.write(_run_water(cfg, "cuda")[0])
        elif "save" in name:
            def run(out, cfg=cfg):
                ckpt.unlink(missing_ok=True)  # a run from frame 0 each time
                driver.run_from_config(cfg, out=out, device="cuda")
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
        for tag, knames in kernels.items():
            ms = sum(e["dur"] for e in events if any(n in e["name"] for n in knames)) / 1e3
            rest -= ms
            shares.append(f"{tag} {ms:.3f} ms ({100 * ms / busy:.2f}% of busy)")
        for what, range_name, exclude in (("Verlet epilogue", VERLET_RANGE, (*k5, *knn["K6"])),
                                          ("K4's in-neighbour lists", LISTS_RANGE, ()),
                                          ("K5's sort and cumsum", CELLS_RANGE, k5)):
            ms = _range_device_ms(all_events, range_name, exclude)
            if ms:
                rest -= ms
                shares.append(f"{what} {ms:.3f} ms ({100 * ms / busy:.2f}% of busy)")
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
        main_tag, (main_kernel, *_) = next(iter(kernels.items()))
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
    ap.add_argument("--k4-before", metavar="CSRC",
                    help="also build the K1-K7 of the parent tree's csrc/ "
                         "directory (e.g. from git archive), hold this "
                         "tree's to them bit for bit where they must agree "
                         "and time each in turns with this tree's (K4 also "
                         "without its staged first evaluation)")
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
    before = _k4_before_libraries(opts.k4_before) if opts.k4_before else None
    build.library()
    info = build.build_info
    say(f"[build] {'built' if info['built'] else 'loaded'} {info['path']} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"[build]   {line.strip()}")

    from cmdlmc_tpu_torch import native

    t0 = time.perf_counter()
    built = not Path(native.so_path()).exists()
    if native.get_lib() is None:
        raise AssertionError("the native xyz tokenizer did not build or load on this host")
    say(f"[build] native xyz tokenizer {'built with g++ and ' if built else ''}loaded "
        f"({Path(native.so_path()).name}) in {time.perf_counter() - t0:.2f} s")

    libs = before() if before else None
    phase_rng(dev)
    k2 = phase_k2(dev, libs)
    k1 = phase_k1(dev, libs)
    k3 = phase_k3(dev, libs)
    k5 = phase_k5(dev, libs)
    k6 = phase_k6(dev, libs)
    k4 = phase_k4(dev, libs)
    k7 = phase_k7(dev, libs)
    paths = phase_end_to_end(card)
    paths.update(phase_water(card))
    phase_host_io(card)
    paths.update(phase_resume(card))
    paths.update(phase_xyz(card))
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
