"""Driver: the main thread's time in the driver's per-span post-processing
(observable resets and row statistics, ``_fused_post``) and in emitting the
rows (``_emit_fused``: the block's one device->host copy, then the records)
while the device sat idle, per 1000 frames of the window. The copy waits
for the device; that wait is device time and is left out, so what remains
is the driver's host time that the card waited for."""

RANGES = [("cmdlmc_tpu_torch.driver:Simulation._fused_post", "fused_post", "call"),
          ("cmdlmc_tpu_torch.driver:Simulation._emit_fused", "emit_rows", "iter")]


def read(ctx):
    if not ctx.window_frames or ctx.device.type != "cuda":
        return None
    return 1e3 * ctx.exposed_s(["fused_post", "emit_rows"]) / (ctx.window_frames / 1e3)
