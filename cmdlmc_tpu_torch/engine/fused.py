"""Fused engine backend: EnsembleState <-> streamed-kernel adapters.

Port of the dense streamed branch of ``cmdlmc_tpu/engine/fused.py``. Every
configuration the port accepts goes through stage 1 (``dense_tables``, with
kernel K2 for the distances) and kernel K1. The JAX package switches to its
in-kernel-W kernel below 16 replica tiles, a rule measured on a TPU; both of
its routes draw identical random numbers and land in the same state, so the
port always streams. The in-kernel-W kernel is ROADMAP A10.
"""

from __future__ import annotations

import dataclasses

import torch

from cmdlmc_tpu_torch.core.cell import Cell
from cmdlmc_tpu_torch.engine.lattice import EnsembleState
from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss
from cmdlmc_tpu_torch.topo.models import PairRates


def fused_unsupported_reason(model, cell: Cell) -> str | None:
    """None if the streamed kernel can run this model and cell, else the
    reason, naming the ROADMAP item that will add it."""
    if not isinstance(model, PairRates):
        return (
            f"topology model {type(model).__name__} is not ported yet "
            "(top-K: ROADMAP A14, angle: A13, hydronium: A14)"
        )
    if not cell.orthorhombic:
        return "triclinic cells on the streamed kernel are not ported yet (ROADMAP A11)"
    return None


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
):
    """Advance all replicas across the block. With ``return_truncation``
    also returns the per-replica count of frames whose event budget ran out."""
    reason = fused_unsupported_reason(model, cell)
    if reason:
        raise NotImplementedError(reason)
    rep = ens.replicas
    R, N = rep.occ.shape
    if tile is None:
        tile = pick_tile(R, n_sites=N)
    B = frames_positions.shape[0]
    chunk = _streamed_frame_chunk(B, N)
    if chunk < B:
        trunc_total = None
        for s in range(0, B, chunk):
            e = min(s + chunk, B)
            ens, trunc = run_block_fused(
                model, cell, ens, frames_positions[s:e], frame0 + s, dt=dt,
                max_events=max_events, seed=seed, tile=tile,
                tile_offset=tile_offset, return_truncation=True,
                stale_rates=stale_rates,
            )
            trunc_total = trunc if trunc_total is None else trunc_total + trunc
        return (ens, trunc_total) if return_truncation else ens
    positions = frames_positions.to(torch.float32)
    w_block = kss.dense_tables(model, positions)
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
