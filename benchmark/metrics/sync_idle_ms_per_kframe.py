"""Device: the idle time that the host's blocking transfers opened, read
from the program's own spans: each device-idle gap of the window that
opens while the main thread is inside a ``kmc.sync.*`` span (the sync
drained the stream), counted whole up to the next device operation, in ms
per 1000 frames of the window. A gap that opened before the sync began is
not the sync's. A program without the spans reads nothing."""

from benchmark import trace

RANGES = []
PREFIX = "kmc.sync."


def read(ctx):
    if not ctx.window_frames or ctx.device.type != "cuda":
        return None
    spans = sorted(s for n, ss in ctx.ranges.items() if n.startswith(PREFIX) for s in ss)
    if not spans:
        return None
    idle_us = sum(d - c for c, d in trace.idle_gaps(ctx)
                  if any(a <= c <= b for a, b in spans))
    return (idle_us / 1e3) / (ctx.window_frames / 1e3)
