"""Single-excess-proton water KMC (the legacy "KMCWater" scheme).

Port of ``cmdlmc_tpu/models/water.py``, fused backend only: one excess
proton per replica hops between the K = ``n_atoms`` nearest oxygens of its
site, with rescaled distances (linear, ramp or an interpolation table), the
relaxation blend after a jump, the waiting time, the back-connection kept
rescaled (``keep_last_neighbor_rescaled``, ``check_from_old``) and the d_OH
correction of the tracked position. :func:`run_water_block_fused` builds a
block's tables (``ops/water_sweep.py::water_tables``: kernel K5 on the card)
and runs the event loop (kernel K7 on the card, its plain version on the
CPU).

Not ported here: the scan model ``run_water_block`` (it needs the generic
engine, ROADMAP A12) and ``run_water_block_fused_sharded`` (A18); a
configuration the fused kernel cannot run raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from cmdlmc_tpu_torch.core.cell import Cell
from cmdlmc_tpu_torch.engine.clock import ClockState
from cmdlmc_tpu_torch.engine.fused import pick_tile
from cmdlmc_tpu_torch.ops import kmc_sweep as ks
from cmdlmc_tpu_torch.ops import water_sweep as ws
from cmdlmc_tpu_torch.topo import transforms as tr


class WaterModel(nn.Module):
    """Static configuration of the water KMC (legacy KMCWater schema keys:
    relaxation_time, waiting_time, rescale_function, d_oh, n_atoms,
    keep_last_neighbor_rescaled, check_from_old). ``law`` acts on the
    (possibly rescaled) distances; ``transform`` is a distance
    transformation or None; ``d_oh`` is the O-H bond length correction
    (0 disables it)."""

    def __init__(self, cell: Cell, law, transform, d_oh: float, n_atoms: int = 3,
                 relaxation_time: int = 0, waiting_time: int = 0,
                 keep_last_neighbor_rescaled: bool = False,
                 check_from_old: bool = False):
        super().__init__()
        self.cell = cell
        self.law = law
        self.transform = transform
        self.host_d_oh = float(np.float32(d_oh))
        self.register_buffer("d_oh", torch.tensor(self.host_d_oh, dtype=torch.float32))
        self.n_atoms = int(n_atoms)
        self.relaxation_time = int(relaxation_time)
        self.waiting_time = int(waiting_time)
        self.keep_last_neighbor_rescaled = bool(keep_last_neighbor_rescaled)
        self.check_from_old = bool(check_from_old)
        h = cell.h.detach().cpu().numpy()
        # the three box lengths on the host (launches need no device sync)
        self.box = (float(h[0, 0]), float(h[1, 1]), float(h[2, 2]))


@dataclasses.dataclass
class WaterState:
    """Per-replica state, each field [R] (or [R, 3])."""

    site: torch.Tensor  # i32 current oxygen index
    last_site: torch.Tensor  # i32 previous oxygen index, -1 before the first jump
    frames_since_jump: torch.Tensor  # i32, drives the relaxation blend
    wait_left: torch.Tensor  # i32 frames of zero rate remaining
    correction: torch.Tensor  # f32 [R, 3] accumulated d_OH correction
    clock: ClockState
    jumps: torch.Tensor  # i32
    snapshot: torch.Tensor  # f32 [R, 3] tracked proton position at the last frame
    displacement: torch.Tensor  # f32 [R, 3] accumulated displacement


def init_water_states(generator: torch.Generator, n_replicas: int, n_sites: int,
                      first_positions: torch.Tensor,
                      start_position: int | None = None) -> WaterState:
    """Start each replica on a fixed or random oxygen, with a fresh
    exponential clock draw. ``generator`` is a CPU ``torch.Generator``; the
    JAX package draws with threefry, so the two agree in distribution only
    (parity runs carry the JAX package's states over with
    ``convert.water_states_from_fields``)."""
    dev = first_positions.device
    R = n_replicas
    if start_position is None:
        site = torch.randint(0, n_sites, (R,), generator=generator, dtype=torch.int32)
    else:
        site = torch.full((R,), int(start_position), dtype=torch.int32)
    u0 = -torch.log(1.0 - torch.rand(R, generator=generator, dtype=torch.float32))
    site = site.to(dev)
    zeros3 = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    clock = ClockState(
        u_remaining=u0.to(dev),
        phase=torch.zeros(R, dtype=torch.float32, device=dev),
        event_count=torch.zeros(R, **i32),
        last_event_frame=torch.full((R,), -1, **i32),
        last_event_phase=torch.zeros(R, dtype=torch.float32, device=dev),
    )
    return WaterState(
        site=site, last_site=torch.full((R,), -1, **i32),
        frames_since_jump=torch.full((R,), 10**9, **i32),
        wait_left=torch.zeros(R, **i32), correction=zeros3.clone(), clock=clock,
        jumps=torch.zeros(R, **i32),
        snapshot=first_positions.to(torch.float32)[site.long()].clone(),
        displacement=zeros3.clone(),
    )


def water_unsupported_reason(model: WaterModel,
                             n_sites: int | None = None) -> str | None:
    """None if the fused kernel runs this model, else why not (the JAX
    package's ``water_fused_supported`` rules: an orthorhombic cell, a law
    the kernel knows, n_atoms 3 or 4, a linear, ramp or interpolated
    transform with at most MAX_INTERP_POINTS points; and, given the site
    count, K7's limit: its prefix sum takes 12 bytes of shared memory per
    site)."""
    scan = "the scan model is not ported yet (ROADMAP A12)"
    if n_sites is not None and n_sites > ws.MAX_SITES:
        return (f"{n_sites} sites exceed the water kernel's {ws.MAX_SITES}: its "
                f"site prefix sum ({12 * n_sites} bytes) does not fit in a "
                f"block's shared memory; {scan}")
    if not model.cell.orthorhombic:
        return f"the water kernel needs an orthorhombic cell; {scan}"
    if ks.law_kind(model.law) is None:
        return f"the water kernel has no law kind for {type(model.law).__name__}; {scan}"
    if model.n_atoms not in (3, 4):
        return f"the water kernel takes n_atoms 3 or 4, got {model.n_atoms}; {scan}"
    t = model.transform
    if t is not None and not isinstance(
            t, (tr.LinearTransformation, tr.ReLUTransformation,
                tr.InterpolatedTransformation)):
        return f"the water kernel has no transform {type(t).__name__}; {scan}"
    if (isinstance(t, tr.InterpolatedTransformation)
            and t.host["x"].shape[0] > ws.MAX_INTERP_POINTS):
        return (f"an interpolation table of {t.host['x'].shape[0]} points exceeds "
                f"the water kernel's {ws.MAX_INTERP_POINTS}; {scan}")
    return None


def water_fused_supported(model: WaterModel) -> bool:
    """Whether :func:`run_water_block_fused` runs this model."""
    return water_unsupported_reason(model) is None


def _transform_spec(model: WaterModel):
    """(tkind, params[5] float32, interp_x, interp_y) for the kernel."""
    t = model.transform
    zeros5 = np.zeros(5, np.float32)
    if t is None:
        return ws.T_NONE, zeros5, None, None
    h = t.host
    if isinstance(t, tr.LinearTransformation):
        return (ws.T_LINEAR, np.array([h["a"], h["b"], 0.0, h["left_bound"],
                                       h["right_bound"]], np.float32), None, None)
    if isinstance(t, tr.ReLUTransformation):
        return (ws.T_RAMP, np.array([h["a"], h["b"], h["d0"], h["left_bound"],
                                     h["right_bound"]], np.float32), None, None)
    if isinstance(t, tr.InterpolatedTransformation):
        return ws.T_INTERP, zeros5, h["x"], h["y"]
    raise ValueError(f"Unsupported transform {type(t)}")


def run_water_block_fused(model: WaterModel, states: WaterState,
                          positions_block: torch.Tensor, frame0: int, *,
                          site_disp: torch.Tensor, prev_pos: torch.Tensor,
                          dt: float, max_events: int = 4, seed: int = 0,
                          tile: int | None = None, tile_offset: int = 0):
    """Advance the water ensemble across a block of frames [B, N, 3].

    Returns (states', site_disp', prev_pos', trunc, site_trace): trunc is
    the per-replica count of frames whose event budget ran out, site_trace
    [B] replica 0's site after each frame (the site the CLI prints for the
    frame). The snapshot
    and displacement are converted to and from the kernel's rebased form at
    the block's ends (displacement = A + S[site] + corr, snapshot =
    prev[site] + corr), so the WaterState contract is the JAX package's.
    The tables come from K5 and the loop from K7 for tensors on the card,
    from their plain versions on the CPU. ``tile`` is the logical RNG tile
    (None: the JAX package's TPU rule, ``pick_tile(R, 256, N)``)."""
    R = states.site.shape[0]
    positions = positions_block.to(torch.float32)
    N = positions.shape[1]
    reason = water_unsupported_reason(model, N)
    if reason:
        raise NotImplementedError(reason)
    if tile is None:
        tile = pick_tile(R, target=256, n_sites=N)
    tkind, tparams, tx, ty = _transform_spec(model)
    box = model.box
    topd, topi, resc = ws.water_tables(positions, box, model.n_atoms, tkind,
                                       tparams, tx, ty)
    site_disp = site_disp.to(torch.float32)
    sites = states.site.long()
    # entry conversion: displacement = A + S[site] + corr
    a_in = states.displacement - site_disp[sites] - states.correction
    sweep = ws.water_sweep if positions.is_cuda else ws.water_sweep_reference
    out = sweep(
        positions, topd, topi, resc, prev_pos.to(torch.float32), site_disp,
        states.site, states.last_site, states.frames_since_jump, states.wait_left,
        states.jumps, states.clock.event_count, states.clock.u_remaining,
        states.correction, a_in, ks.law_params_array(model.law), int(frame0), box,
        int(tile_offset), kind=ks.law_kind(model.law), tile=tile,
        max_events=max_events, dt=float(dt), seed=int(seed),
        relax=model.relaxation_time, waiting=model.waiting_time,
        keep_last=model.keep_last_neighbor_rescaled,
        check_old=model.check_from_old, d_oh=model.host_d_oh,
    )
    site = out["site"]
    s_out, prev_out, corr = out["site_disp"], out["prev_pos"], out["corr"]
    clock = dataclasses.replace(states.clock, u_remaining=out["u_rem"],
                                event_count=out["ev_count"])
    new_states = WaterState(
        site=site, last_site=out["last"], frames_since_jump=out["fsj"],
        wait_left=out["wait"], correction=corr, clock=clock, jumps=out["jumps"],
        snapshot=prev_out[site.long()] + corr,
        displacement=out["disp_base"] + s_out[site.long()] + corr,
    )
    return new_states, s_out, prev_out, out["trunc"], out["site_trace"]
