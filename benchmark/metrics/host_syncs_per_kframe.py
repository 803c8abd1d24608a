"""Driver: the host's blocking transfers, read from the program's own
spans: the ``kmc.sync.*`` spans of the main thread that open inside the
window, per 1000 frames of the window. Each waits for the stream, so each
can leave the card idle. A program without the spans reads nothing."""

RANGES = []
PREFIX = "kmc.sync."


def read(ctx):
    if not ctx.window_frames:
        return None
    names = [n for n in ctx.ranges if n.startswith(PREFIX)]
    if not names:
        return None
    opened = sum(1 for n in names for a, _ in ctx.ranges[n] if ctx.t0 <= a < ctx.t1)
    return opened / (ctx.window_frames / 1e3)
