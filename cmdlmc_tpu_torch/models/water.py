"""Single-excess-proton water KMC (the legacy "KMCWater" scheme).

Port of ``cmdlmc_tpu/models/water.py``, fused backend only: one excess
proton per replica hops between the K = ``n_atoms`` nearest oxygens of its
site, with rescaled distances (linear, ramp or an interpolation table), the
relaxation blend after a jump, the waiting time, the back-connection kept
rescaled (``keep_last_neighbor_rescaled``, ``check_from_old``) and the d_OH
correction of the tracked position. Two engines:

* :func:`run_water_block_fused` builds a block's tables
  (``ops/water_sweep.py::water_tables``: kernel K5 on the card) and runs the
  event loop (kernel K7 on the card, its plain version on the CPU), for the
  models :func:`water_unsupported_reason` lets through;
* :func:`run_water_block`, the scan engine, one step per frame over all
  replicas with the JAX package's clock and draws (``engine/clock.py``,
  ``ops/threefry.py``): any cell, law, transform and ``n_atoms``. Its
  per-frame neighbor tables come from kernel K2's distances on the card
  for an orthorhombic cell.

Not ported: ``run_water_block_fused_sharded`` (ROADMAP A18).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from cmdlmc_tpu_torch.core.cell import Cell, displacement as cell_displacement, sqrt32
from cmdlmc_tpu_torch.core.f32 import divisor
from cmdlmc_tpu_torch.engine import clock as kmc_clock
from cmdlmc_tpu_torch.engine.clock import ClockState
from cmdlmc_tpu_torch.engine.fused import pick_tile
from cmdlmc_tpu_torch.ops import kmc_sweep as ks
from cmdlmc_tpu_torch.ops import threefry
from cmdlmc_tpu_torch.ops import water_sweep as ws
from cmdlmc_tpu_torch.ops.pairwise import pairwise_distance_matrix
from cmdlmc_tpu_torch.topo import transforms as tr
from cmdlmc_tpu_torch.topo.models import k_smallest


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


def water_unsupported_reason(model: WaterModel) -> str | None:
    """None if the fused kernel runs this model, else why not (the JAX
    package's ``water_fused_supported`` rules: an orthorhombic cell, a law
    the kernel knows, n_atoms 3 or 4, a linear, ramp or interpolated
    transform with at most MAX_INTERP_POINTS points); the ``kmc_water`` CLI
    runs such a model on the scan engine (:func:`run_water_block`). The site
    count is not limited: K7 reads the site prefix sum from a table in
    device memory."""
    if not model.cell.orthorhombic:
        return "the water kernel needs an orthorhombic cell"
    if ks.law_kind(model.law) is None:
        return f"the water kernel has no law kind for {type(model.law).__name__}"
    if model.n_atoms not in (3, 4):
        return f"the water kernel takes n_atoms 3 or 4, got {model.n_atoms}"
    t = model.transform
    if t is not None and not isinstance(
            t, (tr.LinearTransformation, tr.ReLUTransformation,
                tr.InterpolatedTransformation)):
        return f"the water kernel has no transform {type(t).__name__}"
    if (isinstance(t, tr.InterpolatedTransformation)
            and t.host["x"].shape[0] > ws.MAX_INTERP_POINTS):
        return (f"an interpolation table of {t.host['x'].shape[0]} points exceeds "
                f"the water kernel's {ws.MAX_INTERP_POINTS}")
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
    reason = water_unsupported_reason(model)
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


# ----------------------------------------------------------------------------
# The scan engine
# ----------------------------------------------------------------------------


def water_shared(model: WaterModel, positions: torch.Tensor):
    """One frame's shared geometry from oxygen positions [N, 3]: the
    ``n_atoms`` nearest neighbors of every oxygen (no cutoff), their
    distances and the rescaled distances: (dist, resc [N, K] float32,
    nbr [N, K] int32)."""
    d = pairwise_distance_matrix(model.cell, positions, model.box)
    n = d.shape[-1]
    d = torch.where(torch.eye(n, dtype=torch.bool, device=d.device), float("inf"), d)
    dist, nbr = k_smallest(d, model.n_atoms)
    resc = model.transform(dist) if model.transform is not None else dist
    return dist, resc, nbr.to(torch.int32)


def _candidates(model: WaterModel, shared, site, last_site, fsj, wait_left):
    """The 3 candidate transitions of each replica's site: (rates [R, 3],
    destinations [R, 3]), with the relaxation blend, the back-jump rules
    and the waiting-time gate."""
    dist, resc, nbr = shared
    s = site.long()
    d_raw, d_resc, neighbors = dist[s], resc[s], nbr[s]
    if model.relaxation_time > 0:
        # fsj = -1 right after a jump: the next frame evaluates at factor 0
        factor = torch.clamp(fsj.to(torch.float32)
                             / divisor(model.relaxation_time, dist.device), 0.0, 1.0)[:, None]
        d_eff = d_raw + factor * (d_resc - d_raw)
    else:
        d_eff = d_resc
    if model.keep_last_neighbor_rescaled:
        # the connection back to the previous oxygen stays fully rescaled
        had_last = last_site >= 0
        is_last = (neighbors == last_site[:, None]) & had_last[:, None]
        d_eff = torch.where(is_last, d_resc, d_eff)
        if model.n_atoms == 4:
            # the old oxygen in slot 3 moves to slot 2, among the active three
            in3 = is_last[:, 3]
            d_eff = torch.cat([d_eff[:, :2], torch.where(in3, d_eff[:, 3], d_eff[:, 2])[:, None],
                               d_eff[:, 3:]], dim=1)
            neighbors = torch.cat([neighbors[:, :2],
                                   torch.where(in3, neighbors[:, 3], neighbors[:, 2])[:, None],
                                   neighbors[:, 3:]], dim=1)
        elif model.check_from_old:
            # where the connection exists only old -> new, the farthest
            # candidate gives way to the old oxygen
            old = torch.clamp(last_site, min=0).long()
            match = nbr[old] == site[:, None]
            do_swap = ~is_last.any(dim=-1) & match.any(dim=-1) & had_last
            rows = torch.arange(site.shape[0], device=site.device)
            far = torch.argmax(d_eff[:, :3], dim=-1)
            old_dist = resc[old, torch.argmax(match.to(torch.int32), dim=-1)]
            d_eff = d_eff.index_put((rows, far), torch.where(do_swap, old_dist,
                                                             d_eff[rows, far]))
            neighbors = neighbors.index_put((rows, far), torch.where(
                do_swap, last_site, neighbors[rows, far]))
    rates = torch.where(wait_left[:, None] > 0, 0.0, model.law(d_eff[:, :3]))
    return rates, neighbors[:, :3]


def water_frame_step(model: WaterModel, shared, positions: torch.Tensor, frame_idx: int,
                     dt: float, max_events: int, state: WaterState, keys, tags):
    """Advance every replica across one frame (oxygen positions [N, 3] and
    their :func:`water_shared` tables). Returns (state', n_fired [R])."""
    rows = torch.arange(state.site.shape[0], device=state.site.device)
    wait0 = model.waiting_time + 1 if model.waiting_time else 0
    two_d_oh = 2.0 * model.d_oh

    def rate_fn(aux):
        rates, _ = _candidates(model, shared, *aux[:4])
        total = rates[:, 0]
        for j in range(1, rates.shape[1]):  # in slot order, as XLA sums them
            total = total + rates[:, j]
        return total

    def apply_fn(aux, event_key, event_phase, fire):
        site, last_site, fsj, wait_left, jumps, corr = aux
        rates, cands = _candidates(model, shared, site, last_site, fsj, wait_left)
        new_site = cands[rows, threefry.categorical(event_key, torch.log(rates))]
        # d_OH correction per event: the proton lands 2 d_OH short of the
        # O-O step, so the correction points from the new oxygen to the old
        vec = cell_displacement(model.cell, positions[new_site.long()],
                                positions[site.long()])
        norm = sqrt32(vec[:, 0] * vec[:, 0] + vec[:, 1] * vec[:, 1]
                      + vec[:, 2] * vec[:, 2]) + 1e-12
        step = corr + two_d_oh * vec / norm[:, None]
        # fsj = -1, wait = waiting + 1: the end-of-frame counters run on the
        # jump frame too
        return (torch.where(fire, new_site, site), torch.where(fire, site, last_site),
                torch.where(fire, -1, fsj), torch.where(fire, wait0, wait_left),
                jumps + fire.to(torch.int32), torch.where(fire[:, None], step, corr))

    aux = (state.site, state.last_site, state.frames_since_jump, state.wait_left,
           state.jumps, state.correction)
    clock, aux, n_fired = kmc_clock.frame_step(
        state.clock, aux, frame_idx=frame_idx, dt=dt, rate_fn=rate_fn,
        apply_fn=apply_fn, key=keys, max_events=max_events, tags=tags)
    site, last_site, fsj, wait_left, jumps, corr = aux
    newpos = positions[site.long()] + corr
    return WaterState(
        site=site, last_site=last_site, frames_since_jump=fsj + 1,
        wait_left=torch.clamp(wait_left - 1, min=0), correction=corr, clock=clock,
        jumps=jumps, snapshot=newpos,
        displacement=state.displacement + cell_displacement(model.cell, state.snapshot,
                                                            newpos),
    ), n_fired


def run_water_block(model: WaterModel, states: WaterState, keys: torch.Tensor,
                    positions_block: torch.Tensor, frame_indices, *, dt: float,
                    max_events: int = 4):
    """The scan engine over a block of frames: oxygen positions [B, N, 3],
    their absolute indices (host ints), the replicas' keys [R, 2].

    Returns (states', sites [B, R] int32 after each frame, msd [B, 3]: the
    mean over replicas of the squared displacement)."""
    tags = kmc_clock.tag_keys(keys)
    positions_block = positions_block.to(torch.float32)
    sites, msd = [], []
    for f, fi in enumerate(torch.as_tensor(frame_indices).tolist()):
        pos = positions_block[f]
        states, _ = water_frame_step(model, water_shared(model, pos), pos, int(fi), dt,
                                     max_events, states, keys, tags)
        sites.append(states.site)
        msd.append((states.displacement ** 2).mean(dim=0))
    return states, torch.stack(sites), torch.stack(msd)
