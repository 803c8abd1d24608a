"""Simulation driver: config -> object graph -> streamed KMC run.

Port of ``cmdlmc_tpu/driver.py`` for the solid-acid and hydronium paths
(NeighborTopology, dense or with ``max_neighbors``, AngleTopology and
HydroniumTopology; all but AngleTopology on a ``box_multiplier`` virtual
supercell too): it

  1. builds the cell, trajectory reader, rate law, distance transformation
     and the ``PairRates``, ``AnglePairRates`` (from the first block's extra
     atoms), ``TopKPairRates`` or ``HydroniumRates`` model on an explicit
     ``torch.device``,
  2. initializes a batch of replicas from a seeded ``torch.Generator`` (or
     takes a given initial state),
  3. streams trajectory frame blocks to the device on a prefetch thread
     (the supercell is materialized on the device after the copy, so only
     the small cell crosses PCIe) and advances them through
     ``engine/fused.py`` (kernel K3, stage 1 + K1, or for the top-K models
     stage 1 + K4, with the neighbor carry of Verlet candidate reuse
     threaded from block to block), cut at every print or reset frame,
  4. prints the reference's '#'-commented column output, then with
     ``[Output] jumpstat_bins`` the jumpstat block (:func:`jumpstat_lines`)
     and with ``[Engine] jumpmatrix_filename`` saves the jump matrix summed
     over the replicas with ``np.save``; or, with ``XYZOutput``, the donor
     frames with replica 0's protons as pseudo-atoms (:meth:`xyz_rows`),
  5. with ``[Engine] checkpoint_path`` resumes from the checkpoint there if
     it exists (bit for bit: the kernels key their draws by seed, absolute
     frame and event ordinal) and saves every ``checkpoint_interval`` blocks
     and at the end (``utils/checkpoint.py``, the JAX package's layout).

Trajectories are xyz files (the native tokenizer where it builds) or HDF5
files (``io/hdf5.py``; h5py is imported only when one is read).

What the port does not run yet raises ``NotImplementedError`` naming its
ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import os
import sys
import time
from typing import Iterator

import numpy as np
import torch

from cmdlmc_tpu_torch.config.schema import SimulationConfig, load_config
from cmdlmc_tpu_torch.core.cell import Cell, extended_positions, wrap_positions
from cmdlmc_tpu_torch.engine import fused as eng_fused
from cmdlmc_tpu_torch.engine import lattice as eng
from cmdlmc_tpu_torch.io.hdf5 import HDF5Trajectory
from cmdlmc_tpu_torch.io.stream import frame_blocks, prefetch
from cmdlmc_tpu_torch.io.xyz import XYZTrajectory, write_xyz_frame
from cmdlmc_tpu_torch.rates import laws as rate_laws
from cmdlmc_tpu_torch.topo import models as topo_models
from cmdlmc_tpu_torch.topo import transforms as topo_transforms

logger = logging.getLogger(__name__)


def _topk_config(cfg: SimulationConfig) -> bool:
    topo = cfg.topology
    return topo.type_ == "HydroniumTopology" or (
        topo.type_ == "NeighborTopology" and bool(topo.max_neighbors))


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
    if topo.type_ not in ("NeighborTopology", "AngleTopology", "HydroniumTopology"):
        return (f"topology type {topo.type_!r} is not supported by mdmc; the water "
                "family runs through cli/kmc_water.py (ROADMAP A16)")
    if cfg.engine.backend == "scan":
        return "the scan engine is not ported yet (ROADMAP A12)"
    if (topo.type_ == "AngleTopology"
            and tuple(int(m) for m in cfg.atombox.box_multiplier) != (1, 1, 1)):
        return ("AngleTopology with a box_multiplier is not ported yet: the JAX "
                "driver groups the small cell's donors (ROADMAP queue C item 6)")
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
    if t.type_ == "HDF5Trajectory":
        return HDF5Trajectory(
            t.filename,
            time_step=t.time_step,
            selection=t.selection,
            repeat=t.repeat,
            chunk_size=t.chunk_size,
            stride=t.stride,
            clip=t.clip,
            shuffle_seed=t.shuffle_seed,
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


def build_transformation(cfg: SimulationConfig, device=None):
    tr = cfg.transformation
    if tr is None:
        return None
    if tr.type_ == "ReLUTransformation":
        t = topo_transforms.ReLUTransformation(
            a=tr.a, b=tr.b, d0=tr.d0, left_bound=tr.left_bound,
            right_bound=tr.right_bound)
    elif tr.type_ == "LinearTransformation":
        t = topo_transforms.LinearTransformation(
            a=tr.a, b=tr.b, left_bound=tr.left_bound, right_bound=tr.right_bound)
    elif tr.type_ == "InterpolatedTransformation":
        t = topo_transforms.InterpolatedTransformation.from_file(
            tr.dist_array_filename, tr.conversion_array_filename)
    else:
        raise ValueError(f"Unknown distance transformation {tr.type_!r}")
    return t.to(device)


def build_model(cfg: SimulationConfig, cell: Cell, law, donors0=None,
                extras0=None):
    """The rate model; AngleTopology groups its donors with the extra atoms
    of the first frame (``donors0`` [N, 3], ``extras0`` [M, 3])."""
    topo = cfg.topology
    if topo.type_ == "NeighborTopology":
        if topo.max_neighbors:
            return topo_models.TopKPairRates(cell, law, topo.cutoff, topo.buffer,
                                             k=topo.max_neighbors)
        return topo_models.PairRates(cell, law, topo.cutoff, topo.buffer)
    if topo.type_ == "AngleTopology":
        if extras0 is None:
            raise ValueError("AngleTopology requires extra_atoms in the topology section")
        return topo_models.AnglePairRates.from_first_frame(
            cell, law, topo.cutoff, topo.buffer, donors0, extras0,
            topo.group_size)
    if topo.type_ == "HydroniumTopology":
        interp = None
        if cfg.interpolator is not None:
            interp = topo_transforms.DistanceInterpolator(
                relaxation_time=cfg.interpolator.relaxation_time).to(cell.h.device)
        return topo_models.HydroniumRates(
            cell, law, topo.cutoff, topo.buffer,
            transform=build_transformation(cfg, cell.h.device),
            interpolator=interp, k=topo.neighbors)
    raise NotImplementedError(unsupported_reason(cfg))


def jumpstat_lines(states, hist_range, bins, dt):
    """The distance-resolved jump statistics accumulated by the kernels'
    histograms, as the JAX package's ``driver.jumpstat_lines`` formats them
    (shared by the ``jumpstat`` CLI and ``[Output] jumpstat_bins``)."""
    jumps = states.replicas.jump_hist.cpu().numpy().sum(axis=0)
    opp = states.replicas.opportunity_hist.cpu().numpy().sum(axis=0)
    edges = np.linspace(hist_range[0], hist_range[1], bins + 1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    lines = [
        f"# jumpstat over [{hist_range[0]}, {hist_range[1]}] A, {bins} bins",
        "# estimator: omega(d) = jumps / (exposure * dt) — exposure-based "
        "rate estimate.",
        "# It is unbiased while omega*dt stays well below "
        "max_events_per_frame (tested at",
        "# omega*dt up to ~0.5); residual high-rate bias is "
        "O(omega*dt/max_events) from the",
        "# per-frame event budget plus end-of-frame exposure sampling — if "
        "the run printed",
        "# a truncation warning, raise [Engine] max_events_per_frame before "
        "trusting omega.",
        f"# {'d/A':>8} {'jumps':>10} {'exposure':>12} {'P(jump)':>12} "
        f"{'omega/fs^-1':>12}",
    ]
    for i in range(bins):
        p = jumps[i] / opp[i] if opp[i] > 0 else 0.0
        lines.append(
            f"{centers[i]:10.4f} {int(jumps[i]):10d} {opp[i]:12.1f} "
            f"{p:12.6g} {p / dt:12.6g}"
        )
    return lines


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
        if cfg.engine.nbr_reuse not in ("auto", "on", "off"):
            raise ValueError(
                f"[Engine] nbr_reuse must be 'auto', 'on' or 'off', "
                f"got {cfg.engine.nbr_reuse!r}"
            )
        reason = unsupported_reason(cfg)
        if reason:
            raise NotImplementedError(reason)
        if cfg.engine.stale_rates and _topk_config(cfg):
            logger.warning(
                "[Engine] stale_rates only changes the fused DENSE backends; "
                "the top-K kernel path recomputes in-frame rates after each "
                "event (distributionally equivalent at rate*dt << 1)")
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
        # jump statistics: [Output] jumpstat_bins / jumpstat_range and
        # [Engine] jumpmatrix_filename (the jumpstat CLI sets the first two)
        self.hist_bins = int(cfg.output.jumpstat_bins)
        self.hist_range = tuple(cfg.output.jumpstat_range)
        self.track_jump_matrix = bool(cfg.engine.jumpmatrix_filename)
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

    def _blocks(self, skip_until: int = 0):
        """Yield ``(block, donors, extras)`` with the parse and the
        host->device copy running on the prefetch thread (``extras`` is None
        without AngleTopology). With a ``box_multiplier`` the supercell's
        positions are made on the device from the copied small cell. Blocks
        that end at or before ``skip_until`` (a resumed checkpoint's frame)
        are parsed but not copied: their donors are None."""
        cfg = self.cfg
        topo = cfg.topology
        gen = frame_blocks(
            self.trajectory,
            block_size=cfg.engine.block_size,
            donor_atoms=topo.donor_atoms,
            extra_atoms=topo.extra_atoms if self.angle else None,
            max_frames=cfg.engine.sweeps,
        )
        mult = tuple(int(m) for m in cfg.atombox.box_multiplier)

        def device_array(x):
            t = torch.from_numpy(
                np.ascontiguousarray(x, dtype=np.float32)).to(self.device)
            if mult != (1, 1, 1):
                t = extended_positions(cfg.atombox.periodic_boundaries, t, mult)
            return t

        def staged():
            for block in gen:
                if block.start + block.n_frames <= skip_until:
                    yield block, None, None
                    continue
                extras = device_array(block.extras) if self.angle else None
                yield block, device_array(block.donors), extras

        return prefetch(staged())

    def observable_rows(self) -> Iterator[ObservableRecord]:
        return self._stream(xyz=False)

    def xyz_rows(self) -> Iterator[str]:
        """XYZOutput mode: donor frames with replica 0's protons appended as
        pseudo-atoms, at every print frame. The same engine as the
        observables path (:meth:`_stream`): checkpoints, spans, resets and
        truncation accounting are shared; replica 0's sites are fetched at
        each print boundary."""
        return self._stream(xyz=True)

    def _load_checkpoint(self, path: str):
        """(states, keys, next frame) of the checkpoint at ``path``, refused
        when it was written under different physics."""
        from cmdlmc_tpu_torch.utils.checkpoint import load_checkpoint

        states, keys, resume_frame, meta = load_checkpoint(
            path, device=self.device, k=getattr(self.model, "k", None))
        logger.info("Resuming from %s at frame %d", path, resume_frame)
        fp = meta.get("config_fingerprint")
        if fp is not None and bytes(fp).decode() != config_fingerprint(self.cfg):
            raise ValueError(
                f"Checkpoint {path} was written by a run with different "
                "physics settings (trajectory/cell/rates/topology/seed/"
                "replicas); refusing to resume. Delete the checkpoint or "
                "restore the original config.")
        return states, keys, resume_frame

    def _stream(self, xyz: bool):
        """The block-streaming engine behind :meth:`observable_rows` (yields
        :class:`ObservableRecord`) and :meth:`xyz_rows` (yields xyz frame
        strings): checkpoint resume and save, spans and truncation
        accounting are shared; only what a print boundary emits differs."""
        from cmdlmc_tpu_torch.utils.checkpoint import CheckpointWriter

        cfg = self.cfg
        states = keys = None
        ckpt_path = cfg.engine.checkpoint_path
        # saves ride under the next blocks' kernels (the writer snapshots
        # the state on the device first: the loop updates it in place)
        ckpt_writer = CheckpointWriter(ckpt_path) if ckpt_path else None
        resume_frame = blocks_done = last_frame_done = 0
        last_ckpt_frame = -1
        if ckpt_path and os.path.exists(ckpt_path):
            states, keys, resume_frame = self._load_checkpoint(ckpt_path)
            # a re-run of a finished run simulates nothing again
            last_frame_done = resume_frame
        for block, donors, extras in self._blocks(skip_until=resume_frame):
            block_end = block.start + block.n_frames
            if block_end <= resume_frame:
                continue  # simulated before the checkpoint
            if block.start < resume_frame:
                raise ValueError(
                    f"Checkpoint frame {resume_frame} falls inside the block "
                    f"[{block.start}, {block_end}) — the checkpoint was "
                    "written with a different [Engine] block_size. Resume "
                    "with the original block_size (checkpoints record it in "
                    "their meta) or delete the checkpoint.")
            if self.model is None:
                self._set_model(build_model(cfg, self.cell, self.law,
                                            donors[0], extras[0]))
            if states is None:
                states = self._initial_states(donors)
            # cut the block so every launch ends where a row is printed or the
            # observables reset (the reference's per-frame cadence)
            pending = []
            donors_np = None
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
                    nbr_reuse={"auto": None, "on": True, "off": False}[
                        cfg.engine.nbr_reuse],
                    hist_range=self.hist_range,
                    donate=True,
                )
                # stays on the device; fetched once at the end of the run
                frac = trunc.sum() / (trunc.shape[0] * (sub_end - sub_start))
                self._fused_trunc = (
                    frac if self._fused_trunc is None
                    else torch.maximum(self._fused_trunc, frac)
                )
                states, pend = self._fused_post(states, sub_end, snapshot=not xyz)
                pending.extend(pend)
                f = sub_end - 1
                if (xyz and f % cfg.output.print_frequency == 0
                        and f >= cfg.engine.equilibration_sweeps):
                    if donors_np is None:
                        donors_np = donors.cpu().numpy()
                    sites0 = states.replicas.site_of_proton[0].cpu().numpy()
                    yield self._format_xyz(donors_np[f - block.start], sites0, f)
            blocks_done += 1
            will_ckpt = (ckpt_path and cfg.engine.checkpoint_interval > 0
                         and blocks_done % cfg.engine.checkpoint_interval == 0)
            if self._steady_t0 is None:
                self._steady_t0 = time.time()
                self._steady_frames0 = block_end
            if not xyz:
                # this block's rows are fetched after the next block's
                # launches, so the copy rides under its kernels
                prev_batch = self._fused_stats_pending
                self._fused_stats_pending = (
                    ([f for f, _ in pending], torch.stack([s for _, s in pending]))
                    if pending else None
                )
                if prev_batch is not None:
                    yield from self._emit_fused(prev_batch)
                if will_ckpt and self._fused_stats_pending is not None:
                    # a checkpoint never covers frames whose rows were not
                    # printed (a crash after the save would lose them)
                    yield from self._emit_fused(self._fused_stats_pending)
                    self._fused_stats_pending = None
            if will_ckpt:
                ckpt_writer.save(states, keys, block_end, meta=self._ckpt_meta())
                last_ckpt_frame = block_end
            last_frame_done = block_end
        if self._fused_stats_pending is not None:  # flush the deferred block
            yield from self._emit_fused(self._fused_stats_pending)
            self._fused_stats_pending = None
        self.final_states = states
        if (ckpt_path and states is not None and blocks_done > 0
                and last_frame_done != last_ckpt_frame):
            # the last block's save already holds this frame
            ckpt_writer.save(states, keys, last_frame_done, meta=self._ckpt_meta())
        if ckpt_writer is not None:
            ckpt_writer.close()  # the run is complete only once the file is

    def _initial_states(self, donors):
        """The run's first state: the given initial state (its jump matrix
        copied, as the run adds into its own) or the seeded one."""
        cfg = self.cfg
        n_sites = donors.shape[1]
        if cfg.kmc.lattice_size is not None and n_sites != cfg.kmc.lattice_size:
            logger.warning(
                "lattice_size=%d but trajectory provides %d donor sites; using %d",
                cfg.kmc.lattice_size, n_sites, n_sites,
            )
        if cfg.output.print_frequency < 8:
            logger.warning(
                "print_frequency=%d cuts every kernel launch to %d frames with "
                "a host fetch each",
                cfg.output.print_frequency, cfg.output.print_frequency,
            )
        if self.initial_state is not None:
            states = self.initial_state.to(self.device)
            return dataclasses.replace(states, replicas=dataclasses.replace(
                states.replicas, jump_matrix=states.replicas.jump_matrix.clone()))
        gen = torch.Generator().manual_seed(int(cfg.engine.seed))
        return eng.init_replicas(
            gen, cfg.engine.replicas, n_sites, cfg.kmc.proton_number,
            donors[0], device=self.device, hist_bins=self.hist_bins,
            track_jump_matrix=self.track_jump_matrix,
        )

    def _ckpt_meta(self) -> dict:
        return {
            "seed": self.cfg.engine.seed,
            "block_size": self.cfg.engine.block_size,
            "config_fingerprint": np.bytes_(config_fingerprint(self.cfg).encode()),
        }

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

    def _fused_post(self, states, boundary: int, snapshot: bool = True):
        """Observable reset and snapshot at a sub-block boundary (the action
        frame is f = boundary - 1; reset before print, as in the reference).
        Print-frame stats stay on the device as (frame, 10-vector) pairs.
        ``snapshot=False`` (xyz mode) applies the resets, so the state and a
        checkpoint are those of the observables run, but skips the stats."""
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
        if snapshot and f % cfg.output.print_frequency == 0 and f >= eq:
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

    def _format_xyz(self, pos: np.ndarray, proton_sites: np.ndarray,
                    frame_no: int) -> str:
        """One xyz frame: the donors (wrapped into the cell with
        ``periodic_wrap``) and a pseudo-atom at each proton's site."""
        cfg = self.cfg
        if cfg.output.periodic_wrap:
            host_cell = Cell(h=self.cell.h.cpu(), h_inv=self.cell.h_inv.cpu(),
                             orthorhombic=self.cell.orthorhombic)
            pos = wrap_positions(host_cell, torch.from_numpy(pos)).numpy()
        proton_pos = pos[proton_sites]
        names = ([cfg.topology.donor_atoms] * len(pos)
                 + [cfg.output.particle_type] * len(proton_pos))
        buf = io.StringIO()
        write_xyz_frame(buf, names, np.vstack([pos, proton_pos]),
                        comment=f"frame {frame_no}")
        return buf.getvalue().rstrip("\n")

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
        if cfg.output.type_ == "XYZOutput":
            for row in self.xyz_rows():
                print(row, file=out)
            # the xyz stream must stay parseable: warn through the logger
            if self._truncation_fraction() > 0:
                logger.warning(
                    "up to %.2f%% of replicas hit max_events_per_frame in "
                    "some frame — raise [Engine] max_events_per_frame",
                    100 * self._max_truncation,
                )
            return
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
        if self.hist_bins > 0 and self.final_states is not None:
            for line in jumpstat_lines(self.final_states, self.hist_range,
                                       self.hist_bins, self.dt):
                print(line, file=out)
        if self.track_jump_matrix and self.final_states is not None:
            jumpmatrix = self.final_states.replicas.jump_matrix.sum(dim=0)
            np.save(cfg.engine.jumpmatrix_filename, jumpmatrix.cpu().numpy())
            print(f"# jump matrix saved to {cfg.engine.jumpmatrix_filename}",
                  file=out)
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
