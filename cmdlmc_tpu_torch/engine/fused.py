"""Fused engine backend: EnsembleState <-> event-loop kernel adapters.

Port of the dense branches of ``cmdlmc_tpu/engine/fused.py``, with two
routes that draw the same random numbers and, for the same W, land in the
same state:

* in-kernel W (``ops/kmc_sweep.py``, kernel K3): each thread block builds a
  frame's W from the positions in its shared memory. It serves few replica
  tiles, where one W build per block is cheap next to the event loop;
* streamed W (``ops/kmc_sweep_streamed.py``, kernel K1): stage 1 builds the
  block's W [B, N, N] once (``dense_tables``, with kernel K2 for the
  distances) and every replica reads it; any law, and ``stale_rates``.

:func:`inkernel_route` is the rule between them. ``AnglePairRates`` runs on
both: K3 evaluates the FermiAngle gate itself (law kind 4), stage 1 builds
the angle W for any other law or at many tiles.
"""

from __future__ import annotations

import dataclasses

import torch

from cmdlmc_tpu_torch.core.cell import Cell
from cmdlmc_tpu_torch.engine.lattice import EnsembleState
from cmdlmc_tpu_torch.ops import kmc_sweep as ks
from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss
from cmdlmc_tpu_torch.rates import laws as rate_laws
from cmdlmc_tpu_torch.topo.models import AnglePairRates, PairRates

# The in-kernel route serves fewer replica tiles than this: the JAX
# package's switch, so the port evaluates the FermiAngle gate where the
# reference does at every tile count. On the H100 the two routes tie at 8
# tiles and stage 1 + K1 is faster from 16 tiles on (PERF.md).
INKERNEL_MAX_TILES = 16


def fused_unsupported_reason(model, cell: Cell) -> str | None:
    """None if a port kernel can run this model and cell, else the reason,
    naming the ROADMAP item that will add it."""
    if not isinstance(model, PairRates):
        return (
            f"topology model {type(model).__name__} is not ported yet "
            "(top-K and hydronium: ROADMAP A14)"
        )
    if not cell.orthorhombic:
        return "triclinic cells on the streamed kernel are not ported yet (ROADMAP A11)"
    if (isinstance(model.law, rate_laws.FermiAngle)
            and not isinstance(model, AnglePairRates)):
        return f"rate law {type(model.law).__name__} needs AngleTopology"
    return None


def inkernel_reason(model, cell: Cell, n_sites: int, stale_rates: bool,
                    device: torch.device) -> str | None:
    """None if K3 can run this configuration, else why not."""
    kind = ks.law_kind(model.law)
    if not cell.orthorhombic:
        return "the in-kernel route needs an orthorhombic cell"
    if kind is None:
        return f"the in-kernel route has no law kind for {type(model.law).__name__}"
    if isinstance(model, AnglePairRates) and kind != ks.KIND_FERMI_ANGLE:
        return "AngleTopology with a distance-only law takes the streamed route"
    if stale_rates:
        return "stale rates live in the streamed route"
    if not ks.fits_in_shared_memory(n_sites, device):
        return f"W[{n_sites}, {n_sites + 1}] does not fit in a block's shared memory"
    return None


def inkernel_route(model, cell: Cell, n_replicas: int, n_sites: int,
                   tile: int, stale_rates: bool, device: torch.device) -> bool:
    """The route rule: K3 when it can run the configuration
    (:func:`inkernel_reason`) and there are fewer than INKERNEL_MAX_TILES
    RNG tiles; else stage 1 + K1, which gives the same result."""
    return (n_replicas < INKERNEL_MAX_TILES * tile
            and inkernel_reason(model, cell, n_sites, stale_rates, device) is None)


def pick_tile(n_replicas: int, target: int = 128, n_sites: int = 0) -> int:
    """Largest divisor of R not exceeding the target: the logical RNG tile
    of the JAX package (draw keys depend on it, the CUDA launch does not)."""
    if n_sites > 3072:
        target = min(target, 32)
    elif n_sites > 2048:
        target = min(target, 64)
    t = min(target, n_replicas)
    while n_replicas % t:
        t -= 1
    return t


# Memory budget for the stage-1 W block [B, N, N] f32 materialized before the
# kernel streams it; longer blocks split into frame sub-ranges, which is
# bit-exact because draws are keyed by absolute frame and event ordinal.
STREAMED_TABLE_BUDGET_BYTES = 2 << 30


def _streamed_frame_chunk(n_frames: int, n_sites: int) -> int:
    per_frame = n_sites * n_sites * 4
    return max(1, min(n_frames, STREAMED_TABLE_BUDGET_BYTES // max(per_frame, 1)))


def run_block_fused(
    model,
    cell: Cell,
    ens: EnsembleState,
    frames_positions: torch.Tensor,  # [B, N, 3] f32
    frame0: int,
    *,
    dt: float,
    max_events: int = 4,
    seed: int = 0,
    tile: int | None = None,
    tile_offset: int = 0,
    return_truncation: bool = False,
    stale_rates: bool = False,
    extras_positions: torch.Tensor | None = None,  # [B, M, 3] (AngleTopology)
    streamed: bool | None = None,  # None: the route rule decides
):
    """Advance all replicas across the block. With ``return_truncation``
    also returns the per-replica count of frames whose event budget ran out."""
    reason = fused_unsupported_reason(model, cell)
    if reason:
        raise NotImplementedError(reason)
    angle = isinstance(model, AnglePairRates)
    if angle and extras_positions is None:
        raise ValueError("AngleTopology fused run needs extra-atom positions")
    rep = ens.replicas
    R, N = rep.occ.shape
    if tile is None:
        tile = pick_tile(R, n_sites=N)
    positions = frames_positions.to(torch.float32)
    extras = extras_positions.to(torch.float32) if angle else None
    if streamed is None:
        streamed = not inkernel_route(model, cell, R, N, tile, stale_rates,
                                      rep.occ.device)
    elif not streamed:
        reason = inkernel_reason(model, cell, N, stale_rates, rep.occ.device)
        if reason:
            raise ValueError(reason)
    if not streamed:
        kind = ks.law_kind(model.law)
        out = ks.kmc_sweep(
            positions, ens.prev_pos, ens.site_disp,
            rep.occ, rep.proton_of_site.to(torch.float32), rep.site_of_proton,
            rep.t_last_jump, rep.disp_base, rep.clock.u_remaining,
            rep.clock.event_count, ks.law_params_array(model.law), int(frame0),
            model.box, int(tile_offset),
            model.grouped_positions(extras) if kind == ks.KIND_FERMI_ANGLE else None,
            kind=kind, tile=tile, max_events=max_events, dt=float(dt),
            seed=int(seed), cutbuf=model.cutbuf,
        )
        return _finish(ens, rep, out, return_truncation)
    B = positions.shape[0]
    chunk = _streamed_frame_chunk(B, N)
    if chunk < B:
        trunc_total = None
        for s in range(0, B, chunk):
            e = min(s + chunk, B)
            ens, trunc = run_block_fused(
                model, cell, ens, positions[s:e], frame0 + s, dt=dt,
                max_events=max_events, seed=seed, tile=tile,
                tile_offset=tile_offset, return_truncation=True,
                stale_rates=stale_rates,
                extras_positions=extras[s:e] if angle else None, streamed=True,
            )
            trunc_total = trunc if trunc_total is None else trunc_total + trunc
        return (ens, trunc_total) if return_truncation else ens
    w_block = kss.dense_tables(model, positions, extras)
    out = kss.kmc_sweep_streamed(
        w_block, positions, ens.prev_pos, ens.site_disp,
        rep.occ, rep.proton_of_site.to(torch.float32), rep.site_of_proton,
        rep.t_last_jump, rep.disp_base, rep.clock.u_remaining,
        rep.clock.event_count, int(frame0), model.box, int(tile_offset),
        tile=tile, max_events=max_events, dt=float(dt), seed=int(seed),
        stale=stale_rates,
    )
    return _finish(ens, rep, out, return_truncation)


def _finish(ens, rep, out, return_truncation):
    """Repack a kernel output dict into an EnsembleState."""
    jumps_delta = out["ev_count"] - rep.clock.event_count
    clock = dataclasses.replace(
        rep.clock, u_remaining=out["u_rem"], event_count=out["ev_count"]
    )
    replicas = dataclasses.replace(
        rep,
        occ=out["occ"],
        proton_of_site=torch.round(out["labels"]).to(torch.int32),
        site_of_proton=out["sites"],
        t_last_jump=out["tlast"],
        disp_base=out["disp_base"],
        clock=clock,
        jumps=rep.jumps + jumps_delta,
    )
    ens_out = dataclasses.replace(
        ens, replicas=replicas, site_disp=out["site_disp"],
        prev_pos=out["prev_pos"],
    )
    if return_truncation:
        return ens_out, out["trunc"]
    return ens_out
