"""Dense event loop: the least time of the window's dense sweeps (the
frozen sweep_work / sweep_bound of yardstick.py, plus stats_bound's added
work where the cell counts jump statistics, counted from each launch's own
frames and the events it fired) over the device time of the work launched
inside run_block_fused but outside stage 1 (dense_tables). Where no
dense_tables range runs (K3 builds W itself) the bound adds W's build."""

import numpy as np

from benchmark import yardstick as ys

RANGES = [("cmdlmc_tpu_torch.engine.fused:run_block_fused", "run_block", "call"),
          ("cmdlmc_tpu_torch.ops.kmc_sweep_streamed:dense_tables", "dense_tables", "call")]


def read(ctx):
    from benchmark.reference import kmc

    ph = ctx.phys
    if ph["k"] or not ctx.calls:
        return None
    device_s = ctx.range_device_s(["run_block"], exclude=["dense_tables"])
    if device_s <= 0:
        return None
    streamed = ctx.has_range("dense_tables")
    R, P, nbins = ph["replicas"], ph["protons"], ph["nbins"]
    cutbuf = float(np.float32(ph["cutoff"]) + np.float32(ph["buffer"]))
    bound_ms = 0.0
    for call, events in zip(ctx.calls, ctx.call_events()):
        B = call["n"]
        pos = ctx.positions(range(call["frame0"], call["frame0"] + B))
        w, _ = kmc.dense_rates(pos, ph["box"], ph["law"], cutbuf)
        N = w.shape[-1]
        work = ys.sweep_work(w, P)
        extra_flops = extra_bytes = 0.0
        if nbins or ph["matrix"]:
            added = ys.stats_bound(R, B, N, nbins, events, work["pairs"], 4.0 * B * N * N)
            extra_flops, extra_bytes = added["flops"], added["nbytes"]
        if streamed:
            b = ys.sweep_bound(R, B, N, P, events, work, w_bytes=4.0 * B * N * N,
                               extra_flops=extra_flops, extra_bytes=extra_bytes)
        else:
            b = ys.sweep_bound(R, B, N, P, events, work,
                               extra_flops=ys.W_BUILD_OPS * B * N * N + extra_flops,
                               extra_bytes=extra_bytes)
        bound_ms += b["bound_ms"]
    return 100.0 * bound_ms / (1e3 * device_s)
