"""Simulation driver: config -> object graph -> streamed KMC run.

Port of ``cmdlmc_tpu/driver.py`` for the dense solid-acid paths
(NeighborTopology and AngleTopology): it

  1. builds the cell, trajectory reader, rate law and the ``PairRates`` or
     ``AnglePairRates`` model (the latter from the first block's extra atoms)
     on an explicit ``torch.device``,
  2. initializes a batch of replicas from a seeded ``torch.Generator`` (or
     takes a given initial state),
  3. streams trajectory frame blocks to the device on a prefetch thread and
     advances them with kernel K3 or stage 1 + kernel K1, as the route rule
     of ``engine/fused.py`` picks, cut at every print or reset frame,
  4. prints the reference's '#'-commented column output.

What the port does not run yet raises ``NotImplementedError`` naming its
ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import logging
import sys
import time
from typing import Iterator

import numpy as np
import torch

from cmdlmc_tpu_torch.config.schema import SimulationConfig, load_config
from cmdlmc_tpu_torch.core.cell import Cell
from cmdlmc_tpu_torch.engine import fused as eng_fused
from cmdlmc_tpu_torch.engine import lattice as eng
from cmdlmc_tpu_torch.io.stream import frame_blocks, prefetch
from cmdlmc_tpu_torch.io.xyz import XYZTrajectory
from cmdlmc_tpu_torch.rates import laws as rate_laws
from cmdlmc_tpu_torch.topo import models as topo_models

logger = logging.getLogger(__name__)


def resolve_device(device) -> torch.device:
    """The run's device; asking for CUDA without a card is an error."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is "
            "False; pass device 'cpu' to run the plain PyTorch versions"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def unsupported_reason(cfg: SimulationConfig) -> str | None:
    """Configuration-level features the port does not run yet."""
    topo = cfg.topology
    if cfg.trajectory.type_ == "HDF5Trajectory":
        return "HDF5 trajectories are not ported yet (ROADMAP A9)"
    if topo.type_ not in ("NeighborTopology", "AngleTopology"):
        return f"{topo.type_} is not ported yet (ROADMAP A14)"
    if topo.max_neighbors:
        return "NeighborTopology max_neighbors (top-K) is not ported yet (ROADMAP A14)"
    if cfg.output.jumpstat_bins > 0 or cfg.engine.jumpmatrix_filename:
        return "jump statistics and the jump matrix are not ported yet (ROADMAP A11)"
    if cfg.engine.checkpoint_path:
        return "checkpoints are not ported yet (ROADMAP A9)"
    if cfg.engine.backend == "scan":
        return "the scan engine is not ported yet (ROADMAP A12)"
    if cfg.output.type_ == "XYZOutput":
        return "XYZOutput is not ported yet (ROADMAP A9)"
    if tuple(cfg.atombox.box_multiplier) != (1, 1, 1):
        return "box_multiplier supercells are not ported yet (ROADMAP A15)"
    d = str(cfg.engine.devices).strip().lower()
    if d not in ("auto", "1"):
        return "multi-GPU replica sharding is not ported yet (ROADMAP A18)"
    return None


def build_trajectory(cfg: SimulationConfig):
    t = cfg.trajectory
    if t.type_ == "XYZTrajectory":
        if t.shuffle_seed is not None:
            raise ValueError(
                "shuffle mode needs random frame access — convert the "
                "trajectory to HDF5 with trajconv first"
            )
        return XYZTrajectory(
            t.filename,
            time_step=t.time_step,
            number_of_atoms=t.number_of_atoms,
            selection=t.selection,
            repeat=t.repeat,
            stride=t.stride,
            clip=t.clip,
        )
    raise ValueError(f"Unknown trajectory type {t.type_!r}")


def build_cell(cfg: SimulationConfig, device=None) -> Cell:
    b = cfg.atombox
    if b.type_ == "AtomBoxCubic":
        return Cell.cubic(b.periodic_boundaries, b.box_multiplier, device)
    if b.type_ == "AtomBoxMonoclinic":
        return Cell.triclinic(b.periodic_boundaries, b.box_multiplier, device)
    raise ValueError(f"Unknown atom box type {b.type_!r}")


def build_law(cfg: SimulationConfig, device=None):
    j = cfg.jumprate
    if j.type_ == "Fermi":
        law = rate_laws.Fermi(a=j.a, b=j.b, c=j.c)
    elif j.type_ in ("AE", "ActivationEnergy"):
        law = rate_laws.ActivationEnergy(A=j.A, a=j.a, b=j.b, d0=j.d0, T=j.T)
    elif j.type_ == "Exponential":
        law = rate_laws.Exponential(a=j.a, b=j.b)
    elif j.type_ == "Constant":
        law = rate_laws.Constant(a=j.a)
    elif j.type_ == "FermiAngle":
        law = rate_laws.FermiAngle(a=j.a, b=j.b, c=j.c, theta=j.theta)
    else:
        raise ValueError(f"Unknown jump rate type {j.type_!r}")
    return law.to(device)


def build_model(cfg: SimulationConfig, cell: Cell, law, donors0=None,
                extras0=None):
    """The rate model; AngleTopology groups its donors with the extra atoms
    of the first frame (``donors0`` [N, 3], ``extras0`` [M, 3])."""
    topo = cfg.topology
    if topo.type_ == "NeighborTopology" and not topo.max_neighbors:
        return topo_models.PairRates(cell, law, topo.cutoff, topo.buffer)
    if topo.type_ == "AngleTopology":
        if extras0 is None:
            raise ValueError("AngleTopology requires extra_atoms in the topology section")
        return topo_models.AnglePairRates.from_first_frame(
            cell, law, topo.cutoff, topo.buffer, donors0, extras0,
            topo.group_size)
    raise NotImplementedError(unsupported_reason(cfg))


def _fused_obs_stats(states: eng.EnsembleState, variance_mode="replicas"):
    """Device-side reduction of block-boundary observables into one vector:
    [msd_mean(3), msd_var(3), autocorr_mean, autocorr_var, jumps_mean,
    msd4_mean]."""
    msd, autocorr = eng.observables_of(states.replicas, states.site_disp)
    autocorr = autocorr.to(torch.float32)
    if variance_mode == "protons":
        pv_msd, pv_auto = eng.per_proton_variance(states.replicas, states.site_disp)
        msd_var, autocorr_var = pv_msd.mean(dim=0), pv_auto.mean()
    else:
        msd_var = msd.var(dim=0, correction=0)
        autocorr_var = autocorr.var(correction=0)
    return torch.cat([
        msd.mean(dim=0),
        msd_var,
        torch.stack([
            autocorr.mean(),
            autocorr_var,
            states.replicas.jumps.to(torch.float32).mean(),
            eng.displacement_moment4(states.replicas, states.site_disp).mean(),
        ]),
    ])


@dataclasses.dataclass
class ObservableRecord:
    frame: int
    time: float
    msd: np.ndarray  # [3]
    msd_var: np.ndarray  # [3]
    autocorr: float
    autocorr_var: float
    jumps: float
    msd4: float = 0.0  # 4th displacement moment (higher_msd)


class Simulation:
    """Configured simulation on ``device``; iterate :meth:`observable_rows`
    or call :meth:`run` to print reference-format output.
    ``initial_state`` replaces the seeded initialization (for example a state
    carried over from the JAX package by ``convert.ensemble_from_numpy``)."""

    def __init__(self, cfg: SimulationConfig, device="cuda",
                 initial_state: eng.EnsembleState | None = None):
        if (
            cfg.kmc.lattice_size is not None
            and cfg.kmc.proton_number > cfg.kmc.lattice_size
        ):
            raise ValueError(
                f"proton_number ({cfg.kmc.proton_number}) cannot exceed "
                f"lattice_size ({cfg.kmc.lattice_size})"
            )
        if cfg.kmc.proton_number < 1:
            raise ValueError("proton_number must be >= 1")
        if cfg.engine.replicas < 1:
            raise ValueError("[Engine] replicas must be >= 1")
        if cfg.engine.tile is not None and (
            cfg.engine.tile < 1 or cfg.engine.replicas % cfg.engine.tile
        ):
            raise ValueError(
                f"[Engine] tile ({cfg.engine.tile}) must divide "
                f"replicas ({cfg.engine.replicas})"
            )
        if cfg.output.variance_mode not in ("replicas", "protons"):
            raise ValueError(
                "[Output] variance_mode must be 'replicas' or 'protons', "
                f"got {cfg.output.variance_mode!r}"
            )
        reason = unsupported_reason(cfg)
        if reason:
            raise NotImplementedError(reason)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cell = build_cell(cfg, self.device)
        self.law = build_law(cfg, self.device)
        self.angle = cfg.topology.type_ == "AngleTopology"
        if self.angle and not cfg.topology.extra_atoms:
            raise ValueError("AngleTopology requires extra_atoms in the topology section")
        # AngleTopology's model needs the first frame: built in _stream
        self.model = None
        if not self.angle:
            self._set_model(build_model(cfg, self.cell, self.law))
        self.trajectory = build_trajectory(cfg)
        self.initial_state = initial_state
        # frame subsampling does not compress physical time: each used frame
        # covers the full interval of the stride
        self.dt = float(cfg.kmc.time_step or cfg.trajectory.time_step) * max(
            int(cfg.trajectory.stride), 1
        )
        self.final_states = None
        self._max_truncation = 0.0
        self._fused_trunc = None  # device scalar: max truncated fraction
        # (frames, stacked device stats) awaiting a host fetch: each block's
        # rows are fetched one block late so the copy rides under the next
        # block's kernels
        self._fused_stats_pending = None
        # steady-state perf bookkeeping (the first block carries the kernel
        # build; exclude it from the sustained rate)
        self._steady_t0 = None
        self._steady_frames0 = 0

    def _set_model(self, model):
        reason = eng_fused.fused_unsupported_reason(model, self.cell)
        if reason:
            raise NotImplementedError(reason)
        self.model = model

    # -- streaming --------------------------------------------------------------

    def _blocks(self):
        """Yield ``(block, donors, extras)`` with the parse and the
        host->device copy running on the prefetch thread (``extras`` is None
        without AngleTopology)."""
        topo = self.cfg.topology
        gen = frame_blocks(
            self.trajectory,
            block_size=self.cfg.engine.block_size,
            donor_atoms=topo.donor_atoms,
            extra_atoms=topo.extra_atoms if self.angle else None,
            max_frames=self.cfg.engine.sweeps,
        )

        def device_array(x):
            return torch.from_numpy(
                np.ascontiguousarray(x, dtype=np.float32)).to(self.device)

        def staged():
            for block in gen:
                extras = device_array(block.extras) if self.angle else None
                yield block, device_array(block.donors), extras

        return prefetch(staged())

    def observable_rows(self) -> Iterator[ObservableRecord]:
        return self._stream()

    def _stream(self):
        """Block-streaming engine behind :meth:`observable_rows`."""
        cfg = self.cfg
        states = None
        for block, donors, extras in self._blocks():
            block_end = block.start + block.n_frames
            if self.model is None:
                self._set_model(build_model(cfg, self.cell, self.law,
                                            donors[0], extras[0]))
            if states is None:
                n_sites = donors.shape[1]
                if (cfg.kmc.lattice_size is not None
                        and n_sites != cfg.kmc.lattice_size):
                    logger.warning(
                        "lattice_size=%d but trajectory provides %d donor "
                        "sites; using %d",
                        cfg.kmc.lattice_size, n_sites, n_sites,
                    )
                if self.initial_state is not None:
                    states = self.initial_state.to(self.device)
                else:
                    gen = torch.Generator().manual_seed(int(cfg.engine.seed))
                    states = eng.init_replicas(
                        gen, cfg.engine.replicas, n_sites,
                        cfg.kmc.proton_number, donors[0], device=self.device,
                    )
                if cfg.output.print_frequency < 8:
                    logger.warning(
                        "print_frequency=%d cuts every kernel launch to %d "
                        "frames with a host fetch each",
                        cfg.output.print_frequency, cfg.output.print_frequency,
                    )
            # cut the block so every launch ends where a row is printed or the
            # observables reset (the reference's per-frame cadence)
            pending = []
            for sub_start, sub_end in self._fused_spans(block.start, block_end):
                lo, hi = sub_start - block.start, sub_end - block.start
                states, trunc = eng_fused.run_block_fused(
                    self.model, self.cell, states, donors[lo:hi], sub_start,
                    dt=self.dt,
                    max_events=cfg.engine.max_events_per_frame,
                    seed=cfg.engine.seed,
                    tile=cfg.engine.tile,
                    return_truncation=True,
                    stale_rates=cfg.engine.stale_rates,
                    extras_positions=extras[lo:hi] if self.angle else None,
                )
                # stays on the device; fetched once at the end of the run
                frac = trunc.sum() / (trunc.shape[0] * (sub_end - sub_start))
                self._fused_trunc = (
                    frac if self._fused_trunc is None
                    else torch.maximum(self._fused_trunc, frac)
                )
                states, pend = self._fused_post(states, sub_end)
                pending.extend(pend)
            if self._steady_t0 is None:
                self._steady_t0 = time.time()
                self._steady_frames0 = block_end
            prev_batch = self._fused_stats_pending
            self._fused_stats_pending = (
                ([f for f, _ in pending], torch.stack([s for _, s in pending]))
                if pending else None
            )
            if prev_batch is not None:
                yield from self._emit_fused(prev_batch)
        if self._fused_stats_pending is not None:  # flush the deferred block
            yield from self._emit_fused(self._fused_stats_pending)
            self._fused_stats_pending = None
        self.final_states = states

    def _truncation_fraction(self) -> float:
        """Fold the on-device truncation accumulator into ``_max_truncation``."""
        if self._fused_trunc is not None:
            frac = float(self._fused_trunc)
            self._fused_trunc = None
            self._max_truncation = max(self._max_truncation, frac)
        return self._max_truncation

    def _fused_spans(self, start: int, end: int):
        """Split [start, end) at every position b where the reference acts
        after frame f = b - 1: print rows (f % print_freq == 0), observable
        resets (f % reset_freq == 0, f > 0) and the one-time equilibration
        reset (f == equilibration_sweeps)."""
        cfg = self.cfg
        bounds = set()
        pf = cfg.output.print_frequency
        rf = cfg.output.reset_frequency
        eq = cfg.engine.equilibration_sweeps
        first = start - (start % pf)
        for f in range(first, end, pf):
            if start <= f < end:
                bounds.add(f + 1)
        if rf > 0:
            firstr = start - (start % rf)
            for f in range(firstr, end, rf):
                if start <= f < end and f > 0:
                    bounds.add(f + 1)
        if eq > 0 and start <= eq < end:
            bounds.add(eq + 1)
        bounds.add(end)
        prev = start
        for b in sorted(b for b in bounds if start < b <= end):
            yield prev, b
            prev = b

    def _fused_post(self, states, boundary: int):
        """Observable reset and snapshot at a sub-block boundary (the action
        frame is f = boundary - 1; reset before print, as in the reference).
        Print-frame stats stay on the device as (frame, 10-vector) pairs."""
        cfg = self.cfg
        f = boundary - 1
        rf = cfg.output.reset_frequency
        eq = cfg.engine.equilibration_sweeps
        if (rf > 0 and f % rf == 0 and f > 0) or (eq > 0 and f == eq):
            states = dataclasses.replace(
                states,
                replicas=eng._reset_states(states.replicas, states.site_disp),
            )
        pending = []
        if f % cfg.output.print_frequency == 0 and f >= eq:
            pending.append((f, _fused_obs_stats(states, cfg.output.variance_mode)))
        return states, pending

    def _emit_fused(self, batch):
        """Materialize one block's deferred rows with one device->host copy."""
        frames_, stats = batch
        arr = stats.cpu().numpy()  # [n_prints, 10]
        for f, row in zip(frames_, arr):
            yield ObservableRecord(
                frame=f,
                time=f * self.dt,
                msd=row[0:3],
                msd_var=row[3:6],
                autocorr=float(row[6]),
                autocorr_var=float(row[7]),
                jumps=float(row[8]),
                msd4=float(row[9]),
            )

    def run(self, out=None):
        cfg = self.cfg
        close_out = False
        if out is None:
            if cfg.output.filename:
                out = open(cfg.output.filename, "w")
                close_out = True
            else:
                out = sys.stdout
        try:
            self._run(out, cfg)
        finally:
            if close_out:
                out.close()

    def _run(self, out, cfg):
        from cmdlmc_tpu_torch.utils.version import version_lines

        for line in version_lines():
            print(line, file=out)
        for line in config_echo(cfg):
            print(line, file=out)
        run_start = time.time()
        frames_done = 0
        header = ["Sweeps", "Time", "MSD_x", "MSD_y", "MSD_z", "Autocorr", "Jumps"]
        if cfg.output.higher_msd:
            header += ["MSD4"]
        if cfg.output.variance:
            header += ["MSD_var_x", "MSD_var_y", "MSD_var_z", "Autocorr_var"]
        print("# " + " ".join(f"{h:>12}" for h in header), file=out)
        for r in self.observable_rows():
            frames_done = r.frame + 1
            cols = [
                f"{r.frame:12d}",
                f"{r.time:14.2f}",
                f"{r.msd[0]:12.4f}",
                f"{r.msd[1]:12.4f}",
                f"{r.msd[2]:12.4f}",
                f"{r.autocorr:8.2f}",
                f"{r.jumps:8.2f}",
            ]
            if cfg.output.higher_msd:
                cols += [f"{r.msd4:12.4f}"]
            if cfg.output.variance:
                cols += [
                    f"{r.msd_var[0]:12.4f}",
                    f"{r.msd_var[1]:12.4f}",
                    f"{r.msd_var[2]:12.4f}",
                    f"{r.autocorr_var:8.2f}",
                ]
            print(" ".join(cols), file=out, flush=True)
        if cfg.output.replica_dump and self.final_states is not None:
            rep = self.final_states.replicas
            msd, autocorr = eng.observables_of(rep, self.final_states.site_disp)
            np.savez_compressed(
                cfg.output.replica_dump,
                msd=msd.cpu().numpy(),
                autocorrelation=autocorr.cpu().numpy(),
                jumps=rep.jumps.cpu().numpy(),
                event_count=rep.clock.event_count.cpu().numpy(),
                site_of_proton=rep.site_of_proton.cpu().numpy(),
            )
            print(f"# per-replica observables saved to {cfg.output.replica_dump}",
                  file=out)
        if self._truncation_fraction() > 0:
            print(
                f"# WARNING: up to {100 * self._max_truncation:.2f}% of replicas "
                "hit max_events_per_frame in some frame — raise "
                "[Engine] max_events_per_frame",
                file=out,
            )
        elapsed = max(time.time() - run_start, 1e-9)
        if frames_done and self.final_states is not None:
            n_sites = self.final_states.replicas.occ.shape[-1]
            fps = frames_done / elapsed
            line = (
                f"# perf: {fps:.1f} frames/s, "
                f"{fps * cfg.engine.replicas * n_sites:.3e} site-updates/s"
            )
            if self._steady_t0 is not None and frames_done > self._steady_frames0:
                steady_fps = (frames_done - self._steady_frames0) / max(
                    time.time() - self._steady_t0, 1e-9
                )
                line += (
                    f" (steady-state, excl. first block: {steady_fps:.1f} "
                    f"frames/s, {steady_fps * cfg.engine.replicas * n_sites:.3e} "
                    "site-updates/s)"
                )
            print(line, file=out)


def config_fingerprint(cfg: SimulationConfig) -> str:
    """Hash of the physics-relevant configuration (excludes execution knobs
    such as block_size, backend and output options)."""
    import hashlib

    e = cfg.engine
    parts = [
        repr(cfg.trajectory), repr(cfg.atombox), repr(cfg.topology),
        repr(cfg.jumprate), repr(cfg.kmc), repr(cfg.transformation),
        repr(cfg.interpolator),
        f"replicas={e.replicas} seed={e.seed} "
        f"max_events={e.max_events_per_frame} "
        f"equilibration={e.equilibration_sweeps}",
    ]
    return hashlib.sha1("\n".join(parts).encode()).hexdigest()


def config_echo(cfg: SimulationConfig) -> list[str]:
    """Echo every setting as '#' comments, followed by the canonical short
    keys the analysis tooling parses (last match wins)."""
    lines = []
    for field in dataclasses.fields(cfg):
        section = getattr(cfg, field.name)
        if section is None or field.name == "logging_level":
            continue
        if not dataclasses.is_dataclass(section):
            continue
        lines.append(f"# [{getattr(type(section), '__section__', field.name)}]")
        for f in dataclasses.fields(section):
            value = getattr(section, f.name)
            if isinstance(value, np.ndarray):
                value = value.tolist()
            lines.append(f"# {f.name.rstrip('_')} = {value}")
    if cfg.logging_level:
        lines.append("# [Logging]")
        lines.append(f"# level = {cfg.logging_level}")
    lines.append(f"# sweeps {cfg.engine.sweeps if cfg.engine.sweeps else 0}")
    lines.append(f"# reset_freq {cfg.output.reset_frequency}")
    lines.append(f"# print_freq {cfg.output.print_frequency}")
    lines.append(f"# replicas {cfg.engine.replicas}")
    lines.append(f"# seed {cfg.engine.seed}")
    lines.append(f"# proton_number {cfg.kmc.proton_number}")
    lines.append(f"# lattice_size {cfg.kmc.lattice_size}")
    lines.append(f"# time_step {cfg.kmc.time_step or cfg.trajectory.time_step}")
    return lines


def run_from_config(path_or_file, out=None, device="cuda",
                    initial_state=None) -> Simulation:
    cfg = load_config(path_or_file)
    if cfg.logging_level:
        logging.basicConfig(level=cfg.logging_level.upper())
    sim = Simulation(cfg, device=device, initial_state=initial_state)
    sim.run(out=out)
    return sim
