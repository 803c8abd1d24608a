"""The traced window: profiler ranges set from outside the program, and the
readings the per-layer metrics take from the trace.

The port carries no span of its own, so the harness wraps the port's
functions in ``torch.profiler`` ranges (``annotate``, a frozen copy of
``chip_smoke.py:4181-4218`` ``_annotated`` at commit 5a4702a, taking its
list of ranges from the metric files). ``range_device_s`` follows
``chip_smoke.py:4284-4300`` ``_range_device_ms``: the device work of a range
is found by the correlation ids of the launches made inside it, never by
kernel name; it counts copies and memsets besides kernels, and takes a
launch as inside a range only on the range's own thread. The idle time
follows ``chip_smoke.py:4229-4281`` ``_idle_report``: the gaps between the
union of the device's kernel, copy and memset intervals, each put down to
the innermost host range it falls in. ``device_ms``'s fallback to CUDA
events (``chip_smoke.py:249``) is not copied: a traced window that holds no
device record is an error here.
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench_window"


def annotate(patches, ranges) -> None:
    """Wrap each (``module:Attr.attr``, range name, kind) in a profiler
    range: kind "call" for a function, "iter" for a function returning an
    iterator or a generator (the range covers each ``next``, so the items
    come in the program's own order). A wrapped function's attributes (a
    launch counter) are carried over."""
    from torch.profiler import record_function

    from benchmark.harness import resolve

    def wrap(inner, name, kind):
        if kind == "iter":
            def annotated(*args, **kwargs):
                it = iter(inner(*args, **kwargs))
                while True:
                    with record_function(name):
                        item = next(it, it)
                    if item is it:
                        return
                    yield item
        else:
            def annotated(*args, **kwargs):
                with record_function(name):
                    return inner(*args, **kwargs)
        annotated.__dict__.update(inner.__dict__)
        return annotated

    seen = set()
    for target, name, kind in ranges:
        if (target, name) in seen:
            continue
        seen.add((target, name))
        obj, attr = resolve(target)
        patches.set(obj, attr, wrap(getattr(obj, attr), name, kind))


def start_profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def open_window():
    from torch.profiler import record_function

    rf = record_function(WINDOW)
    rf.__enter__()
    return rf


def close_window(rf) -> None:
    rf.__exit__(None, None, None)


def stop_profiler(prof, path: Path) -> list:
    """Stop, write the Chrome trace, read its events back, delete it."""
    prof.stop()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        return json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink()


def _union(spans) -> list:
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Context:
    """What a per-layer reader gets: the window's trace events, the launches
    of ``run_block_fused`` made in it (frames and event counts), the cell,
    its physics, the trajectory, the frames the window completed."""

    def __init__(self, events, calls, spec, phys, frames, window_frames, device):
        self.events, self.calls, self.spec, self.phys = events, calls, spec, phys
        self.frames, self.window_frames, self.device = frames, window_frames, device
        win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
        if not win:
            raise RuntimeError("the trace holds no window range")
        w = win[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.main_tid = w.get("tid")
        self.window_s = (self.t1 - self.t0) / 1e6
        self.device_events = [
            e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
            and float(e["ts"]) < self.t1 and float(e["ts"]) + float(e["dur"]) > self.t0]
        self.ranges = {}
        for e in events:
            if (e.get("cat") == "user_annotation" and "dur" in e and e.get("name") != WINDOW
                    and e.get("tid") == self.main_tid):
                a = float(e["ts"])
                self.ranges.setdefault(e["name"], []).append((a, a + float(e["dur"])))

    def clip(self, a, b):
        return max(a, self.t0), min(b, self.t1)

    def busy_spans(self) -> list:
        spans = []
        for e in self.device_events:
            a, b = self.clip(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            if b > a:
                spans.append((a, b))
        return _union(spans)

    def host_s(self, names) -> float:
        """Seconds the main thread spent inside the ranges ``names`` (their
        union) within the window."""
        spans = []
        for n in names:
            for a, b in self.ranges.get(n, []):
                a, b = self.clip(a, b)
                if b > a:
                    spans.append((a, b))
        return sum(b - a for a, b in _union(spans)) / 1e6

    def exposed_s(self, names) -> float:
        """Seconds the main thread spent inside the ranges ``names`` while
        the device was idle: the part of that host time the device waited
        for."""
        clipped = (self.clip(a, b) for n in names for a, b in self.ranges.get(n, []))
        spans = _union(ab for ab in clipped if ab[1] > ab[0])
        gaps = idle_gaps(self)
        return sum(max(0.0, min(b, d) - max(a, c)) for a, b in spans for c, d in gaps) / 1e6

    def _corr(self, names) -> set:
        spans = _union(s for n in names for s in self.ranges.get(n, []))
        starts = [a for a, _ in spans]
        out = set()
        for e in self.events:
            if e.get("cat") not in LAUNCH_CATS or e.get("tid") != self.main_tid:
                continue
            c = e.get("args", {}).get("correlation")
            ts = float(e["ts"])
            i = bisect.bisect_right(starts, ts) - 1
            if c is not None and i >= 0 and ts <= spans[i][1]:
                out.add(c)
        return out

    def range_device_s(self, names, exclude=()) -> float:
        """Device seconds of the work launched inside the ranges ``names``
        but outside the ranges ``exclude``, by correlation id."""
        corr = self._corr(names) - self._corr(exclude)
        return sum(float(e["dur"]) for e in self.device_events
                   if e.get("args", {}).get("correlation") in corr) / 1e6

    def has_range(self, name) -> bool:
        return bool(self.ranges.get(name))

    def positions(self, abs_frames):
        """float32 positions of absolute frames on the device, supercell
        included, from the run's trajectory."""
        import torch

        from benchmark.reference import kmc

        t = self.frames.shape[0]
        idx = [int(f) % t for f in abs_frames]
        pos = torch.from_numpy(self.frames[idx]).to(self.device)
        return kmc.extend(pos, self.phys["box"], self.phys["mult"])

    def call_events(self) -> list:
        """Events fired in each launch of the window."""
        return [int((c["ev_out"].long() - c["ev_in"].long()).sum()) for c in self.calls]


def device_facts(ctx: Context) -> dict:
    """busy_s and window_s of the traced window; fails where the window holds
    no device record (a host-clock time is never passed off as device time)."""
    busy = sum(b - a for a, b in ctx.busy_spans()) / 1e6
    if ctx.device.type == "cuda" and not ctx.device_events:
        raise RuntimeError("the profiler's window holds no device record (no kernel, "
                           "copy or memset): the device metrics cannot be read")
    return {"busy_s": busy, "window_s": ctx.window_s}


def idle_gaps(ctx: Context) -> list:
    """(start, end) of the window's idle gaps on the device."""
    gaps, end = [], ctx.t0
    for a, b in ctx.busy_spans():
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if ctx.t1 > end:
        gaps.append((end, ctx.t1))
    return gaps


def breakdown(ctx: Context) -> dict:
    """The ten device operations that took most time in the window, and the
    idle time put down to the innermost host range each gap's middle lies
    in ("no range" where none), the ten largest."""
    ops = {}
    for e in ctx.device_events:
        a, b = ctx.clip(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        ops[e["name"]] = ops.get(e["name"], 0.0) + max(0.0, b - a) / 1e6
    spans = sorted((b - a, a, b, n) for n, ss in ctx.ranges.items() for a, b in ss)
    idle = {}
    for a, b in idle_gaps(ctx):
        mid = 0.5 * (a + b)
        name = next((n for _, c, d, n in spans if c <= mid <= d), "no range")
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}
