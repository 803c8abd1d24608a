"""One benchmark run of a cell: set-up, the measured window, the check.

The cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``configs/<config>.json``: the deployment's INI and sizes)
and a traffic mix (``traffic/<traffic>.json``: replicas, the trajectory's
kind, length and step, the INI settings the mix adds); its limits are in
``workloads/<cell>.json``. From the run's seed the harness writes the
trajectory and the INI into a work directory inside the checkout, then
drives the port exactly as ``python -m cmdlmc_tpu_torch.cli.mdmc run.ini``
does: ``Simulation(load_config(ini), device).observable_rows()``.

Set-up (``setup_s``) runs from the start of the process through the
imports, the kernels' build or load, the trajectory, the construction, the
seeded start and the warm-up blocks. The window then counts the frames of
the blocks whose rows the driver emitted (emitting a block's rows copies
them to the host, a device sync) over the host clock between two such
emissions. A ``--trace 1`` run holds the window in a torch.profiler trace
with ranges around the port's functions (declared by the per-layer metric
files of ``metrics/``), and reports those metrics instead.

During the window one launch of ``run_block_fused`` (picked from the seed)
is captured: its entry state, its positions, its stage-1 tables and its
output. After the window, with the program stopped, the plain reference
(``reference/``) checks them (``check.py``).
"""

from __future__ import annotations

import configparser
import gc
import importlib
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np

from benchmark.reference import trajectory as traj

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
WORK = BENCH / "_work"
SWEEPS = 10**9  # frames to run: more than any window
FORBIDDEN = ("jax", "jaxlib", "flax", "cmdlmc_tpu")


# -- the cell ------------------------------------------------------------------

def load_spec(workload: str, root: Path = ROOT) -> dict:
    """The cell's entry with its configuration, traffic and limits."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = dict(cells[workload])
    configs = {c["name"]: c for c in bench["configs"]}
    cell["config_spec"] = json.loads((root / configs[cell["config"]]["file"]).read_text())
    cell["traffic_spec"] = json.loads(
        (root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    cell["limits"] = json.loads(
        (root / "benchmark" / "workloads" / f"{workload}.json").read_text())["limits"]
    cell["end_to_end"] = [m for m in bench["end_to_end"]
                          if workload in m.get("workloads", [workload])]
    cell["per_layer"] = [m for m in bench["per_layer"]
                         if workload in m.get("workloads", [workload])]
    cell["run_seconds"] = bench["run_seconds"]
    return cell


def ini_sections(spec: dict, seed: int, traj_path: Path, work: Path) -> dict:
    """The run's INI as {section: {key: value}}: the configuration's, the
    traffic mix's on top, then the trajectory, the replicas and the seed."""
    sections = {s: dict(kv) for s, kv in spec["config_spec"]["ini"].items()}
    for s, kv in spec["traffic_spec"].get("ini", {}).items():
        sections.setdefault(s, {}).update(
            {k: v.replace("@work", str(work)) for k, v in kv.items()})
    sections["Trajectory"].update(filename=str(traj_path), repeat="True")
    sections["Engine"].update(replicas=str(spec["traffic_spec"]["replicas"]),
                              seed=str(int(seed)), sweeps=str(SWEEPS))
    return sections


def write_inputs(spec: dict, seed: int, work: Path) -> tuple[Path, dict, np.ndarray]:
    """The trajectory (xyz text) and the INI of a run; returns (ini, its
    sections, the trajectory's frames)."""
    work.mkdir(parents=True, exist_ok=True)
    frames = traj.make_frames(spec["traffic_spec"], spec["config_spec"], seed)
    path = work / "trajectory.xyz"
    traj.write_xyz(path, frames)
    sections = ini_sections(spec, seed, path, work)
    parser = configparser.ConfigParser()
    parser.optionxform = str
    parser.read_dict(sections)
    ini = work / "run.ini"
    with open(ini, "w") as f:
        parser.write(f)
    return ini, sections, frames


def physics(sections: dict) -> dict:
    """What the reference needs of a run's INI sections, with the schema's
    defaults (``cmdlmc_tpu_torch/config/schema.py`` at 5a4702a) where a
    section leaves a key out; the CPU tests hold it to the port's loader."""
    def get(sec, key, default=None):
        return sections.get(sec, {}).get(key, default)

    def vec(text):
        return tuple(float(x) for x in str(text).strip("[]() ").split(","))

    return dict(
        box=vec(get("AtomBox", "periodic_boundaries")),
        mult=tuple(int(m) for m in vec(get("AtomBox", "box_multiplier", "1, 1, 1"))),
        law={k: float(get("JumpRate", k)) for k in ("a", "b", "c")},
        cutoff=float(get("NeighborTopology", "cutoff")),
        buffer=float(get("NeighborTopology", "buffer")),
        k=int(get("NeighborTopology", "max_neighbors", 0)),
        dt=float(get("KMCLattice", "time_step") or get("Trajectory", "time_step")),
        max_events=int(get("Engine", "max_events_per_frame", 4)),
        block=int(get("Engine", "block_size", 256)),
        print_freq=int(get("Output", "print_frequency", 1)),
        reset_freq=int(get("Output", "reset_frequency", 0)),
        eq=int(get("Engine", "equilibration_sweeps", 0)),
        seed=int(get("Engine", "seed")), replicas=int(get("Engine", "replicas")),
        protons=int(get("KMCLattice", "proton_number")),
        nbins=int(get("Output", "jumpstat_bins", 0)),
        hist_range=vec(get("Output", "jumpstat_range", "2.0, 3.0")),
        matrix=bool(get("Engine", "jumpmatrix_filename")),
        tile=int(get("Engine", "tile")) if get("Engine", "tile") else None)


# -- patches from outside the program -------------------------------------------

class Patches:
    """Attributes replaced for the run and put back after it."""

    def __init__(self):
        self._undo = []

    def set(self, obj, attr, value):
        self._undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    def restore(self):
        for obj, attr, old in reversed(self._undo):
            setattr(obj, attr, old)
        self._undo.clear()


def resolve(path: str):
    """(object, attribute) of 'module:Attr.attr'."""
    mod, _, attr = path.partition(":")
    obj = importlib.import_module(mod)
    *owners, last = attr.split(".")
    for o in owners:
        obj = getattr(obj, o)
    return obj, last


class Capture:
    """Watches the driver's launches of ``run_block_fused`` (sub-range
    launches made inside one are not counted): keeps the start of the run
    (the first launch's entry), sums each launch's replica-frames whose
    event budget ran out (on the device, no sync), and, once armed, keeps
    one launch ``pick`` launches on whose span ends at a printed frame: its
    entry state, positions, stage-1 tables and output, and a copy of the
    launch before it's output, so the hand-over between the two (the
    driver's post-processing) is checked too. In a traced window it logs
    each launch's frames and event counts."""

    def __init__(self, pick: int, print_freq: int, eq: int):
        self.pick, self.print_freq, self.eq = pick, print_freq, eq
        self.calls = 0
        self.depth = 0
        self.armed_at = None
        self.first = None
        self.got = None
        self.prev = None
        self.tables = None
        self.truncated = None
        self._want_tables = False
        self.log = None  # list while a traced window runs

    def run_block(self, inner):
        def run_block_fused(model, cell, ens, frames_positions, frame0, **kw):
            if self.depth:
                return inner(model, cell, ens, frames_positions, frame0, **kw)
            self.depth += 1
            try:
                return self._launch(inner, model, cell, ens, frames_positions, frame0, kw)
            finally:
                self.depth -= 1
        return run_block_fused

    def _launch(self, inner, model, cell, ens, frames_positions, frame0, kw):
        rep = ens.replicas
        n = int(frames_positions.shape[0])
        if self.first is None:
            self.first = dict(sites=rep.site_of_proton, u=rep.clock.u_remaining,
                              donors=frames_positions[:1], frame0=int(frame0))
        end = int(frame0) + n - 1
        near = (self.got is None and self.armed_at is not None
                and self.calls - self.armed_at >= self.pick - 1)
        take = near and self.calls - self.armed_at >= self.pick \
            and end % self.print_freq == 0 and end >= self.eq
        self.calls += 1
        jm_in = None
        if take:
            if rep.jump_matrix.numel():
                jm_in = rep.jump_matrix[0].clone()
            self._want_tables = True
        out = inner(model, cell, ens, frames_positions, frame0, **kw)
        self._want_tables = False
        ens_out = out[0] if isinstance(out, tuple) else out
        if isinstance(out, tuple):
            t = out[1].sum()
            self.truncated = t if self.truncated is None else self.truncated + t
        if take:
            self.got = dict(frame0=int(frame0), n=n, donors=frames_positions,
                            ens=ens, out=ens_out, tables=self.tables, jm_in=jm_in,
                            prev=self.prev,
                            jm_out=(ens_out.replicas.jump_matrix[0].clone()
                                    if jm_in is not None else None))
            self.prev = None
        elif near:
            self.prev = snapshot(ens_out, end)
        if self.log is not None:
            self.log.append(dict(frame0=int(frame0), n=n,
                                 ev_in=rep.clock.event_count,
                                 ev_out=ens_out.replicas.clock.event_count))
        return out

    def tables_of(self, inner):
        def stage1(*args, **kwargs):
            out = inner(*args, **kwargs)
            if self._want_tables:
                self.tables = out
            return out
        stage1.__dict__.update(inner.__dict__)
        return stage1


def snapshot(ens, end: int) -> dict:
    """A copy of a launch's output state as the next launch should get it,
    before the driver's post-processing; ``end`` is its last frame."""
    rep = ens.replicas
    fields = dict(occ=rep.occ, labels=rep.proton_of_site, sites=rep.site_of_proton,
                  tlast=rep.t_last_jump, disp_base=rep.disp_base, u=rep.clock.u_remaining,
                  evc=rep.clock.event_count, jumps=rep.jumps, autocorr_ref=rep.autocorr_ref,
                  hist=rep.jump_hist, expo=rep.opportunity_hist, s=ens.site_disp,
                  prev=ens.prev_pos)
    snap = {k: v.clone() for k, v in fields.items()}
    snap["end"] = end
    return snap


class PrefetchStop:
    """Lets the run stop the driver's prefetch thread cleanly: the
    iterator that ``prefetch`` runs on its thread is wrapped so that it
    ends, closing the parser under it, once ``stop`` is asked; ``stop``
    then takes the items still queued until the prefetch generator ends,
    and joins the thread. Fails loudly where the driver no longer runs its
    blocks through ``prefetch``."""

    def __init__(self):
        self.gen = None
        self.thread = None
        self._stop = threading.Event()

    def wrap(self, inner):
        def prefetch(iterator, *args, **kwargs):
            self.gen = inner(self._stoppable(iterator), *args, **kwargs)
            return self.gen
        return prefetch

    def _stoppable(self, iterator):
        self.thread = threading.current_thread()
        try:
            for item in iterator:
                if self._stop.is_set():
                    return
                yield item
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()

    def stop(self, timeout: float = 60.0) -> None:
        if self.gen is None:
            raise RuntimeError("the driver's blocks never went through prefetch: the "
                               "harness cannot stop its thread")
        self._stop.set()
        deadline = time.monotonic() + timeout
        for _ in self.gen:
            if time.monotonic() > deadline:
                break
        if self.thread is not None:
            self.thread.join(max(0.0, deadline - time.monotonic()))
        if self.thread is None or self.thread.is_alive():
            raise RuntimeError(f"the prefetch thread did not stop within {timeout:.0f} s")


def judge(limits: dict, checks: dict) -> bool:
    """``correct``: every number compared has its limit, every limit its
    number, and none is over its limit."""
    return set(limits) == set(checks) and all(checks[n] <= limits[n] for n in checks)


# -- the run ---------------------------------------------------------------------

def block_of(frame: int, block: int) -> int:
    return frame // block


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, work: Path | None = None, faults=None,
             log=print) -> dict:
    """Run one cell; returns the result line. ``faults`` (tests only) is a
    callable given the Patches object before the capture wraps
    ``run_block_fused``, to break the timed path underneath it."""
    import torch

    from benchmark import check as chk
    from benchmark import trace as tr
    from cmdlmc_tpu_torch import driver
    from cmdlmc_tpu_torch.config.schema import load_config
    from cmdlmc_tpu_torch.engine import fused as eng_fused
    from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss
    from cmdlmc_tpu_torch.ops import topk_sweep as ts

    work = work or WORK / spec["name"]
    dev = torch.device(device)
    ini, sections, frames = write_inputs(spec, seed, work)
    cfg = load_config(str(ini))
    phys = physics(sections)
    tfc = spec["traffic_spec"]
    lo, hi = tfc["capture_calls"]
    pick = lo + int(np.random.RandomState(seed % 2**32).randint(0, hi - lo + 1))
    cap = Capture(pick, phys["print_freq"], phys["eq"])
    stopper = PrefetchStop()
    patches = Patches()
    metric_mods = [importlib.import_module(f"benchmark.metrics.{m['name']}")
                   for m in spec["per_layer"]] if trace else []
    try:
        patches.set(driver, "prefetch", stopper.wrap(driver.prefetch))
        patches.set(kss, "dense_tables", cap.tables_of(kss.dense_tables))
        patches.set(ts, "topk_tables_verlet", cap.tables_of(ts.topk_tables_verlet))
        if trace:
            tr.annotate(patches, [r for m in metric_mods for r in m.RANGES])
        if faults is not None:
            faults(patches)
        patches.set(eng_fused, "run_block_fused", cap.run_block(eng_fused.run_block_fused))
        sim = driver.Simulation(cfg, device=dev)
        rows = sim.observable_rows()
        result = _window(spec, rows, phys, cap, stopper, seconds, trace, dev,
                         t_start, metric_mods, frames, log)
    finally:
        patches.restore()
    got_rows, window = result
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
    if loaded:
        raise ForbiddenModules(loaded)
    # the program's own state goes before the reference runs
    del sim, rows
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = chk.check_run(phys, cap, got_rows, frames, work / "trajectory.xyz", dev)
    log(f"the check took {time.perf_counter() - t_check:.1f} s; float_err by field: "
        f"{checks.pop('_float_errs', {})}", file=sys.stderr)
    limits = spec["limits"]
    correct = judge(limits, checks)
    n_rows = window["rows"]
    failed = sum(1 for r in got_rows.values() if not np.all(np.isfinite(chk.row_vector(r))))
    metrics = {}
    if trace:
        metrics = window["per_layer"]
    else:
        metrics["site_updates_per_s"] = {"value": window["rate"], "unit": "site-updates/s"}
        metrics["setup_s"] = {"value": window["setup_s"], "unit": "s"}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": memory_peak}
    out = {"correct": bool(correct), "attempted": n_rows, "failed": failed,
           "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = window["busy_s"]
        device_info["window_s"] = window["window_s"]
        out["breakdown"] = window["breakdown"]
    out["checks"] = {name: {"value": checks[name], "limit": limits.get(name)}
                     for name in checks}
    return out


class ForbiddenModules(RuntimeError):
    pass


def _window(spec, rows, phys, cap, stopper, seconds, trace, dev, t_start,
            metric_mods, frames, log):
    """Warm up, measure, and stop the program. Returns (rows by frame,
    window facts)."""
    import torch

    from benchmark import trace as tr

    block = phys["block"]
    warm = int(spec["traffic_spec"]["warmup_blocks"])
    got = {}
    it = iter(rows)
    last_blk = -1
    prof = None
    t0 = blk0 = None
    window_range = None
    deadline = None
    rate = None
    while True:
        r = next(it)
        now = time.perf_counter()
        got[r.frame] = r
        blk = block_of(r.frame, block)
        new_burst = blk != last_blk
        last_blk = blk
        if not new_burst:
            continue
        if t0 is None:
            if blk < warm:
                continue
            if trace and prof is None:
                prof = tr.start_profiler()
                continue  # the window opens at the next emission
            setup_s = now - t_start
            t0, blk0 = time.perf_counter(), blk
            marks = [(t0, blk0)]
            cap.armed_at = cap.calls
            deadline = t0 + seconds
            if trace:
                cap.log = []
                window_range = tr.open_window()
            continue
        marks.append((now, blk))
        if now >= deadline:
            t1 = now
            frames_done = (blk - blk0) * block
            rate = phys["replicas"] * sim_sites(phys, spec) * frames_done / (t1 - t0)
            break
    n_rows = sum(1 for f in got if block_of(f, block) >= blk0 and block_of(f, block) < blk)
    facts = dict(rate=rate, setup_s=setup_s, frames=frames_done, window_s=t1 - t0,
                 rows=n_rows)
    # the window's rate in thirds (standard error only: how steady it was)
    pts = [min(marks, key=lambda m: abs(m[0] - (t0 + k * (t1 - t0) / 3))) for k in range(4)]
    log("frames/s by thirds of the window: " + ", ".join(
        f"{(b1 - b0) * block / max(s1 - s0, 1e-9):.1f}"
        for (s0, b0), (s1, b1) in zip(pts, pts[1:])), file=sys.stderr)
    if trace:
        tr.close_window(window_range)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        events = tr.stop_profiler(prof, WORK / spec["name"] / "trace.json")
        calls = cap.log
        cap.log = None
    # the captured launch's row comes one block after it; wait for it
    deadline = time.perf_counter() + 60.0
    while cap.got is not None and (cap.got["frame0"] + cap.got["n"] - 1) not in got \
            and time.perf_counter() < deadline:
        r = next(it)
        got[r.frame] = r
    stopper.stop()
    rows.close()
    del it
    if trace:
        ctx = tr.Context(events=events, calls=calls, spec=spec, phys=phys,
                         frames=frames, window_frames=frames_done, device=dev)
        facts.update(tr.device_facts(ctx))
        facts["per_layer"] = {}
        for m, mod in zip(spec["per_layer"], metric_mods):
            value = mod.read(ctx)
            if value is not None:
                facts["per_layer"][m["name"]] = {"value": value, "unit": m["unit"]}
        facts["breakdown"] = tr.breakdown(ctx)
    return got, facts


def sim_sites(phys: dict, spec: dict) -> int:
    m = phys["mult"]
    return int(spec["config_spec"]["cell_sites"]) * m[0] * m[1] * m[2]
