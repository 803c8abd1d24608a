"""Top-K event loop: the least time of the window's top-K sweeps (the frozen
topk_changed / topk_bound of yardstick.py, from each launch's frames and
the events it fired; the candidates an event changes are counted on the
K-nearest tables of 8 frames spread over the window) over the device time
of the work launched inside run_block_fused but outside stage 1
(topk_tables_verlet, topk_tables, device_plan). K4's in-neighbour lists
count as the loop's."""

import numpy as np
import torch

from benchmark import yardstick as ys

RANGES = [("cmdlmc_tpu_torch.engine.fused:run_block_fused", "run_block", "call"),
          ("cmdlmc_tpu_torch.ops.topk_sweep:topk_tables_verlet", "topk_tables_verlet", "call"),
          ("cmdlmc_tpu_torch.ops.topk_sweep:topk_tables", "topk_tables", "call"),
          ("cmdlmc_tpu_torch.ops.knn_sparse:device_plan", "device_plan", "call")]
SAMPLE_FRAMES = 8


def read(ctx):
    from benchmark.reference import kmc

    ph = ctx.phys
    K = ph["k"]
    if not K or not ctx.calls:
        return None
    device_s = ctx.range_device_s(
        ["run_block"], exclude=["topk_tables_verlet", "topk_tables", "device_plan"])
    if device_s <= 0:
        return None
    first = ctx.calls[0]["frame0"]
    last = ctx.calls[-1]["frame0"] + ctx.calls[-1]["n"]
    cutbuf = float(np.float32(ph["cutoff"]) + np.float32(ph["buffer"]))
    big_box = tuple(b * m for b, m in zip(ph["box"], ph["mult"]))
    sample = np.linspace(first, last - 1, SAMPLE_FRAMES).astype(int)
    tabs = [kmc.knn_f32(p, big_box, cutbuf, K) for p in ctx.positions(sample)]
    topd = torch.stack([d for d, _ in tabs])
    topi = torch.stack([i for _, i in tabs])
    resc = kmc.topk_rates(topd, ph["law"])
    changed = ys.topk_changed((topd, topi, resc), False)
    R, P, N = ph["replicas"], ph["protons"], topi.shape[-1]
    bound_ms = 0.0
    for call, events in zip(ctx.calls, ctx.call_events()):
        B = call["n"]
        b = ys.topk_bound(R, B, N, P, K, events, False, 4.0 * 2 * B * K * N, changed)
        bound_ms += b["bound_ms"]
    return 100.0 * bound_ms / (1e3 * device_s)
