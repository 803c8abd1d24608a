"""Stage 1: the main thread's time inside the program's ``kmc.stage1``
spans while the device sat idle, the part of stage 1 the card waited for
(its launch code, the Verlet schedule's fetches), in ms per 1000 frames of
the window. A program without the span reads nothing."""

RANGES = []
SPAN = "kmc.stage1"


def read(ctx):
    if not ctx.window_frames or ctx.device.type != "cuda" or not ctx.has_range(SPAN):
        return None
    return 1e3 * ctx.exposed_s([SPAN]) / (ctx.window_frames / 1e3)
