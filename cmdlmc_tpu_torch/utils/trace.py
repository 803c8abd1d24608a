"""The port's own spans and counters.

Spans. :func:`span` names a stretch of the program's work. Under a running
``torch.profiler`` it is ``torch.profiler.record_function(name)``, so the
span lands in the same trace as the device's kernel, copy and memset
records, on the same clock, and an idle gap on the device can be put down
to what the host was doing. With no profiler running it is one shared
no-op (:data:`NOOP`); the test reads ``torch.autograd.profiler``'s flag at
each entry, so a profiler started mid-run sees the spans that open after
it. A span's parent is the span that encloses it on the same thread; none
stays open across a ``yield``. Every name starts with ``kmc.``:

    kmc.stream.wait      the main thread waiting for the prefetch thread's next block
    kmc.stream.parse     (prefetch thread) the tokenizer's next batch of frames
    kmc.stream.h2d       (prefetch thread) a block's copy to the device, the supercell made there
    kmc.block            one block's launches and post-processing (the n-th is block n)
    kmc.run_block        one launch of the event loop, stage 1 and loop together
    kmc.stage1           stage 1: the rate tables or the K-nearest tables
    kmc.stage1.knn       the K-nearest tables' kernel (K5, or K6 with its plan)
    kmc.stage1.plan      inside it, K6's spatial plan (``device_plan``)
    kmc.loop             the event loop's launch wrapper (K1, K3 or K4 with its lists)
    kmc.driver.post      observable resets and row statistics at a print or reset frame
    kmc.driver.emit      a block's rows: their copy to the host and the records
    kmc.driver.ckpt      a checkpoint's snapshot and hand-off to its writer
    kmc.sync.<site>      the host waiting for the stream (:func:`sync`)

Counters. A module-level registry of integers, cheap to bump (a dict
increment under a lock): ``syncs.<site>`` for each blocking transfer,
``blocks`` and ``frames`` for the blocks whose rows reached the host. A
reader takes :func:`snapshot` before and after and subtracts
(:func:`since`), so two runs in one process do not mix; the snapshot also
reads the launch counters that live on the ops wrappers (``launches.<op>``)
and ``topk_tables_verlet.rebuild_frames`` (``verlet.rebuild_frames``, a sum
kept on the device: reading it waits for the stream, so the snapshot is
taken before and after a run, not inside it).
:func:`block_clock` gives the time and frame count of the latest block
emitted, for ``driver.py``'s ``# perf:`` line. The counters count on every
device, so a CPU run shows the schedule of transfers the card runs.

Host syncs. Every blocking device-to-host read, stream synchronize or copy
of host values to the device that waits for the stream goes through
:func:`sync` (or :func:`to_host`, :func:`to_device`, :func:`synchronize`):
it opens ``kmc.sync.<site>``, counts ``syncs.<site>``, and lowers
``torch.cuda``'s sync debug mode for its own duration, so a run under
``torch.cuda.set_sync_debug_mode("error")`` fails at any unmarked sync.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

NOOP = contextlib.nullcontext()

_lock = threading.Lock()
_counts: dict[str, int] = {}
_clock = [0.0, 0]  # (perf_counter, frames) at the latest block emitted


def span(name: str):
    """A context manager spanning ``name``: a profiler range while a
    profiler runs, else the shared no-op."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return NOOP


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def emitted(frames: int) -> None:
    """A block of ``frames`` frames has its rows on the host: counts
    ``blocks`` and ``frames`` and moves the block clock."""
    now = time.perf_counter()
    with _lock:
        _counts["blocks"] = _counts.get("blocks", 0) + 1
        _counts["frames"] = _counts.get("frames", 0) + frames
        _clock[0], _clock[1] = now, _counts["frames"]


def block_clock() -> tuple[float, int]:
    """(perf_counter seconds, frames emitted) at the latest block emitted."""
    with _lock:
        return _clock[0], _clock[1]


def _op_counters() -> dict[str, int]:
    from cmdlmc_tpu_torch.ops import (
        kmc_sweep, kmc_sweep_streamed, knn_sparse, knn_tables, pairwise,
        threefry, topk_sweep, water_sweep,
    )

    ops = (kmc_sweep_streamed.kmc_sweep_streamed, kmc_sweep.kmc_sweep,
           topk_sweep.topk_sweep, pairwise.pairwise_cubic,
           knn_tables.knn_block_tables, knn_sparse.knn_sparse_tables,
           knn_sparse.device_plan, water_sweep.water_sweep, threefry.keyed_hash,
           topk_sweep.verlet_schedule)
    # a wrapper set over an op from outside may not carry its counter
    out = {f"launches.{op.__name__}": int(op.launches) for op in ops
           if hasattr(op, "launches")}
    rebuilds = getattr(topk_sweep.topk_tables_verlet, "rebuild_frames", None)
    if rebuilds is not None:
        # summed on the device, so read here, where the counters are read,
        # and nowhere on the launch path
        with _sync_allowed():
            out["verlet.rebuild_frames"] = int(rebuilds)
    return out


def snapshot() -> dict[str, int]:
    """Every counter's value now."""
    with _lock:
        out = dict(_counts)
    out.update(_op_counters())
    return out


def since(before: dict[str, int]) -> dict[str, int]:
    """The counters that moved since the snapshot ``before``, by how much."""
    now = snapshot()
    moved = {k: v - before.get(k, 0) for k, v in now.items()}
    return {k: v for k, v in moved.items() if v}


# -- host syncs ---------------------------------------------------------------

_mode_lock = threading.Lock()
_mode_depth = 0
_mode_saved = 0


@contextlib.contextmanager
def _sync_allowed():
    """Lower the process-wide CUDA sync debug mode while any thread is
    inside a marked sync; the last one out restores it."""
    global _mode_depth, _mode_saved
    if not torch.cuda.is_initialized():
        yield
        return
    with _mode_lock:
        if _mode_depth == 0:
            _mode_saved = torch.cuda.get_sync_debug_mode()
            if _mode_saved:
                torch.cuda.set_sync_debug_mode(0)
        _mode_depth += 1
    try:
        yield
    finally:
        with _mode_lock:
            _mode_depth -= 1
            if _mode_depth == 0 and _mode_saved:
                torch.cuda.set_sync_debug_mode(_mode_saved)


@contextlib.contextmanager
def sync(site: str):
    """One blocking transfer at ``site``: the span ``kmc.sync.<site>``, the
    counter ``syncs.<site>``."""
    count("syncs." + site)
    with span("kmc.sync." + site), _sync_allowed():
        yield


def to_host(t: torch.Tensor, site: str) -> torch.Tensor:
    """``t.cpu()``, marked."""
    with sync(site):
        return t.cpu()


def to_device(t: torch.Tensor, device, site: str) -> torch.Tensor:
    """``t.to(device)`` of a host tensor (a copy from pageable memory waits
    for the stream), marked."""
    with sync(site):
        return t.to(device)


def synchronize(site: str, stream=None) -> None:
    """Wait for ``stream`` (the current stream by default), marked."""
    with sync(site):
        (stream or torch.cuda.current_stream()).synchronize()
