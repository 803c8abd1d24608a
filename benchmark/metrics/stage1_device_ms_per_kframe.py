"""Stage 1: device time of the work launched inside the program's
``kmc.stage1`` spans (the rate tables, or the K-nearest tables with the
Verlet schedule and K6's plan), found by the launches' correlation ids, in
ms per 1000 frames of the window. A program without the span reads
nothing."""

RANGES = []
SPAN = "kmc.stage1"


def read(ctx):
    if not ctx.window_frames or ctx.device.type != "cuda" or not ctx.has_range(SPAN):
        return None
    return 1e3 * ctx.range_device_s([SPAN]) / (ctx.window_frames / 1e3)
