"""Host stream: the main thread's time waiting for the next block (the
prefetch thread's parse and host->device copy), per 1000 frames of the
window. Moves site_updates_per_s only where the card waits on the reader."""

RANGES = [("cmdlmc_tpu_torch.driver:Simulation._blocks", "next_block", "iter")]


def read(ctx):
    if not ctx.window_frames:
        return None
    return 1e3 * ctx.host_s(["next_block"]) / (ctx.window_frames / 1e3)
