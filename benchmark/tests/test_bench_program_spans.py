"""The readers of the program's own spans (host_syncs_per_kframe,
sync_idle_ms_per_kframe, stage1_device_ms_per_kframe,
stage1_exposed_ms_per_kframe) held to synthetic traces: a gap opened inside
a sync span against one opened before it, device work found by the
correlation ids of the launches made inside a span, and nothing read from a
trace without the spans."""

import importlib

import pytest
import torch

from benchmark import trace

MAIN, OTHER = 1, 2
FRAMES = 500  # the window's frames


def _range(name, a, b, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a, "dur": b - a,
            "tid": tid}


def _launch(corr, ts, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": 2, "tid": tid, "args": {"correlation": corr}}


def _kernel(corr, a, b):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": a, "dur": b - a,
            "tid": 7, "args": {"correlation": corr}}


def _ctx(events, device="cuda"):
    return trace.Context(events=[_range(trace.WINDOW, 0, 1000)] + events, calls=[],
                         spec={}, phys={}, frames=None, window_frames=FRAMES,
                         device=torch.device(device))


def _read(metric, ctx):
    return importlib.import_module(f"benchmark.metrics.{metric}").read(ctx)


# device busy over [0, 100], [300, 400] and [600, 1000]: gaps (100, 300) and
# (400, 600); the first opens inside the emit sync, the second before the
# rebuild sync begins
BUSY = [_kernel(1, 0, 100), _kernel(2, 300, 400), _kernel(3, 600, 1000)]
SYNCS = [_range("kmc.sync.emit", 50, 120), _range("kmc.sync.verlet_rebuild", 450, 500)]


def test_host_syncs_count_the_main_threads_sync_spans_that_open_in_the_window():
    events = BUSY + SYNCS + [_range("kmc.sync.emit", -80, -10),  # before the window
                             _range("kmc.sync.stream_h2d", 200, 250, tid=OTHER),
                             _range("kmc.block", 0, 900)]
    assert _read("host_syncs_per_kframe", _ctx(events)) == pytest.approx(2 / 0.5)


def test_sync_idle_counts_a_gap_opened_inside_a_sync_not_one_opened_before():
    got = _read("sync_idle_ms_per_kframe", _ctx(BUSY + SYNCS))
    assert got == pytest.approx(0.2 / 0.5)  # the whole (100, 300) gap, in ms
    # the same sync opened after the device went idle: no gap is its
    late = [_range("kmc.sync.emit", 150, 290)]
    assert _read("sync_idle_ms_per_kframe", _ctx(BUSY + late)) == 0.0


def test_stage1_device_time_follows_the_launches_made_inside_the_span():
    events = [_range("kmc.stage1", 10, 60), _launch(11, 20), _launch(12, 70),
              _launch(13, 30, tid=OTHER), _kernel(11, 100, 130), _kernel(12, 130, 180),
              _kernel(13, 180, 200)]
    got = _read("stage1_device_ms_per_kframe", _ctx(events))
    assert got == pytest.approx(0.030 / 0.5)  # kernel 11 alone, in ms


def test_stage1_exposed_time_is_the_span_while_the_device_idled():
    events = BUSY + [_range("kmc.stage1", 80, 250), _range("kmc.stage1", 350, 380)]
    got = _read("stage1_exposed_ms_per_kframe", _ctx(events))
    assert got == pytest.approx(0.150 / 0.5)  # (100, 250) of the gap


@pytest.mark.parametrize("metric", ["host_syncs_per_kframe", "sync_idle_ms_per_kframe",
                                    "stage1_device_ms_per_kframe",
                                    "stage1_exposed_ms_per_kframe"])
def test_a_program_without_the_spans_reads_nothing(metric):
    events = BUSY + [_range("run_block", 0, 900), _range("emit_rows", 50, 120),
                     _launch(1, 5)]
    assert _read(metric, _ctx(events)) is None
