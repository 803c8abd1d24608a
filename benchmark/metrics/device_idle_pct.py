"""Device: the share of the traced window in which no kernel, copy or
memset ran on the card."""

RANGES = []


def read(ctx):
    if ctx.window_s <= 0 or ctx.device.type != "cuda":
        return None
    busy = sum(b - a for a, b in ctx.busy_spans()) / 1e6
    return 100.0 * (1.0 - busy / ctx.window_s)
