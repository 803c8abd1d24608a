"""Fused engine backend: EnsembleState <-> event-loop kernel adapters.

Port of ``cmdlmc_tpu/engine/fused.py`` without multi-GPU sharding (ROADMAP
A18). Three kernels advance a whole block of frames per launch, with the
jump histograms and the jump matrix where the state carries them:

* the dense models (``PairRates``, ``AnglePairRates``) on two routes that
  draw the same random numbers and, for the same W, land in the same state:
  in-kernel W (``ops/kmc_sweep.py``, kernel K3), where each thread block
  builds a frame's W from the positions, for few replica tiles; and
  streamed W (``ops/kmc_sweep_streamed.py``, kernel K1), where stage 1 builds
  the block's W [B, N, N] once (``dense_tables``, kernel K2 for the
  distances, or the triclinic torch distance) for any law, ``stale_rates``
  and triclinic cells. :func:`inkernel_route` is the rule between them; K3
  evaluates the FermiAngle gate itself (law kind 4);
* the top-K models (``TopKPairRates``, ``HydroniumRates``) on
  ``ops/topk_sweep.py``: stage 1 builds the K-nearest tables (kernels K5 and
  K6 for an orthorhombic cell on the card), per frame or, with Verlet
  candidate reuse, at drift-triggered rebuilds with the neighbor carry
  threaded through ``EnsembleState.nbr_carry``; kernel K4 runs the event
  loop over them, triclinic cells included where the round-based minimum
  image is exact.

What no kernel runs (:func:`fused_unsupported_reason`: a triclinic cell too
skewed for the round-based minimum image, k above K4's 16, a law with no
kernel) runs on the scan engine (``engine/lattice.py::run_block``).
"""

from __future__ import annotations

import dataclasses
import logging

import torch

from cmdlmc_tpu_torch.core.cell import Cell
from cmdlmc_tpu_torch.engine.lattice import EnsembleState
from cmdlmc_tpu_torch.ops import kmc_sweep as ks
from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss
from cmdlmc_tpu_torch.ops import topk_sweep as ts
from cmdlmc_tpu_torch.rates import laws as rate_laws
from cmdlmc_tpu_torch.topo.models import (
    AnglePairRates, PairRates, TopKPairRates, TopKRates,
)
from cmdlmc_tpu_torch.utils import trace

logger = logging.getLogger(__name__)

# The in-kernel route serves fewer replica tiles than this: the JAX
# package's switch, so the port evaluates the FermiAngle gate where the
# reference does at every tile count. On the H100 K3 is faster at 8 and 16
# tiles and stage 1 + K1 from 32 tiles on, with jump statistics or without
# (PERF.md).
INKERNEL_MAX_TILES = 16
# ... and at most this many sites. A frozen route boundary: it is where
# K3's former dense W[N, N+1] stopped fitting in an H100 block's shared
# memory, and nothing in the current K3 sets it (its lists go to global
# memory where they do not fit); it stays so that no configuration changes
# route until a measured crossover with stage 1 + K1 at large N replaces it.
INKERNEL_MAX_SITES = 224


def fused_unsupported_reason(model, cell: Cell) -> str | None:
    """None if a port kernel can run this model and cell, else the reason;
    the driver then runs the scan engine (``engine/lattice.py::run_block``)
    for ``backend = auto`` and raises for ``backend = fused``."""
    # the round-based minimum image of the kernels (K1, K4) is exact only for
    # vectors shorter than half the smallest cell height; candidate pair
    # vectors reach cutoff + buffer
    cutbuf = getattr(model, "cutbuf", 0.0)
    if not cell.orthorhombic and cutbuf >= 0.5 * cell.min_height:
        return (
            f"triclinic cell too skewed for the kernels' round-based minimum "
            f"image: cutoff+buffer ({cutbuf:.2f}) >= half the smallest "
            f"perpendicular cell height ({0.5 * cell.min_height:.2f})"
        )
    if isinstance(model, TopKRates):
        return ts.topk_unsupported_reason(model)
    if not isinstance(model, PairRates):
        return f"topology model {type(model).__name__} has no fused kernel"
    if (isinstance(model.law, rate_laws.FermiAngle)
            and not isinstance(model, AnglePairRates)):
        return f"rate law {type(model.law).__name__} needs AngleTopology"
    return None


def inkernel_reason(model, cell: Cell, n_sites: int,
                    stale_rates: bool) -> str | None:
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
    if n_sites > INKERNEL_MAX_SITES:
        return (f"{n_sites} sites exceed the in-kernel route's "
                f"{INKERNEL_MAX_SITES}")
    return None


def inkernel_route(model, cell: Cell, n_replicas: int, n_sites: int,
                   tile: int, stale_rates: bool) -> bool:
    """The route rule: K3 when it can run the configuration
    (:func:`inkernel_reason`) and there are fewer than INKERNEL_MAX_TILES
    RNG tiles; else stage 1 + K1, which gives the same result."""
    return (n_replicas < INKERNEL_MAX_TILES * tile
            and inkernel_reason(model, cell, n_sites, stale_rates) is None)


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


# Memory budget for the stage-1 W block [B, N, N] f32 (and, with jump
# histograms, the distances beside it) materialized before the kernel
# streams it; longer blocks split into frame sub-ranges, which is bit-exact
# because draws are keyed by absolute frame and event ordinal.
STREAMED_TABLE_BUDGET_BYTES = 2 << 30


def _streamed_frame_chunk(n_frames: int, n_sites: int, nbins: int = 0) -> int:
    per_frame = n_sites * n_sites * 4 * (2 if nbins else 1)
    return max(1, min(n_frames, STREAMED_TABLE_BUDGET_BYTES // max(per_frame, 1)))


def nbr_reuse_auto(top_k_pairs: bool, n_sites: int, buffer: float) -> bool:
    """The JAX package's ``[Engine] nbr_reuse = auto`` rule: Verlet candidate
    reuse on for TopKPairRates (``top_k_pairs``) at supercell N (>= 1024
    sites) with a positive buffer."""
    return top_k_pairs and n_sites >= 1024 and buffer > 0.0


_reuse_auto_logged = False


def _log_reuse_auto_once():
    """One INFO line per process when the auto rule turns Verlet reuse on,
    as the JAX package logs it: reuse changes the numerics against
    per-frame lists where k truncates the shell."""
    global _reuse_auto_logged
    if not _reuse_auto_logged:
        logger.info(
            "Verlet candidate-identity reuse auto-enabled for the top-K "
            "fused path (supercell N, buffered lists); set "
            "[Engine] nbr_reuse = off for per-frame rebuilds")
        _reuse_auto_logged = True


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
    nbr_reuse: bool | None = None,  # top-K only; None: the JAX auto rule
    hist_range: tuple = (2.0, 3.0),
    donate: bool = False,
):
    """Advance all replicas across the block. With ``return_truncation``
    also returns the per-replica count of frames whose event budget ran out.
    Top-K models reuse their neighbor lists (Verlet candidate reuse) with
    ``nbr_reuse`` True, or None where :func:`nbr_reuse_auto` turns it on;
    the lists then carry over in ``ens.nbr_carry``. Where the replicas
    carry jump histograms (``jump_hist`` with bins, over ``hist_range``)
    they advance too, and the block's jumps are added into replica 0 of a
    tracked ``jump_matrix``. ``ens`` is left unchanged unless the caller
    ``donate``s it: then the matrix is added into in place, which a loop
    over blocks wants (a copy of the [R, N, N] matrix per launch would move
    2.7 GB at R=16384, N=144), and ``ens`` must not be used again."""
    with trace.span("kmc.run_block"):
        reason = fused_unsupported_reason(model, cell)
        if reason:
            raise NotImplementedError(reason)
        if not donate and ens.replicas.jump_matrix.numel():
            ens = dataclasses.replace(ens, replicas=dataclasses.replace(
                ens.replicas, jump_matrix=ens.replicas.jump_matrix.clone()))
        if isinstance(model, TopKRates):
            return _run_block_topk(
                model, cell, ens, frames_positions, frame0, dt=dt,
                max_events=max_events, seed=seed, tile=tile, tile_offset=tile_offset,
                return_truncation=return_truncation, nbr_reuse=nbr_reuse,
                hist_range=hist_range)
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
            streamed = not inkernel_route(model, cell, R, N, tile, stale_rates)
        elif not streamed:
            reason = inkernel_reason(model, cell, N, stale_rates)
            if reason:
                raise ValueError(reason)
        stats = kss.stats_kwargs(rep, hist_range)
        if not streamed:
            kind = ks.law_kind(model.law)
            with trace.span("kmc.loop"):
                out = ks.kmc_sweep(
                    positions, ens.prev_pos, ens.site_disp,
                    rep.occ, rep.proton_of_site.to(torch.float32), rep.site_of_proton,
                    rep.t_last_jump, rep.disp_base, rep.clock.u_remaining,
                    rep.clock.event_count, ks.law_params_array(model.law), int(frame0),
                    model.box, int(tile_offset),
                    model.grouped_positions(extras) if kind == ks.KIND_FERMI_ANGLE
                    else None,
                    kind=kind, tile=tile, max_events=max_events, dt=float(dt),
                    seed=int(seed), cutbuf=model.cutbuf, **stats,
                )
            return _finish(ens, rep, out, return_truncation)
        B = positions.shape[0]
        chunk = _streamed_frame_chunk(B, N, stats["nbins"])
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
                    hist_range=hist_range, donate=True,
                )
                trunc_total = trunc if trunc_total is None else trunc_total + trunc
            return (ens, trunc_total) if return_truncation else ens
        with trace.span("kmc.stage1"):
            if stats["nbins"]:
                w_block, dist_block = kss.dense_tables(model, positions, extras,
                                                       nbins=stats["nbins"])
            else:
                w_block, dist_block = kss.dense_tables(model, positions, extras), None
        with trace.span("kmc.loop"):
            out = kss.kmc_sweep_streamed(
                w_block, positions, ens.prev_pos, ens.site_disp,
                rep.occ, rep.proton_of_site.to(torch.float32), rep.site_of_proton,
                rep.t_last_jump, rep.disp_base, rep.clock.u_remaining,
                rep.clock.event_count, int(frame0), model.box, int(tile_offset),
                tile=tile, max_events=max_events, dt=float(dt), seed=int(seed),
                stale=stale_rates,
                geometry=None if cell.orthorhombic else model.geometry,
                dist_block=dist_block, **stats,
            )
        return _finish(ens, rep, out, return_truncation)


def _run_block_topk(model, cell, ens, frames_positions, frame0, *, dt,
                    max_events, seed, tile, tile_offset, return_truncation,
                    nbr_reuse, hist_range):
    """The top-K branch of :func:`run_block_fused`: stage 1 over the block,
    then K4, split into frame sub-ranges where the tables would pass the
    table budget (bit-exact: draws are keyed by absolute frame and event
    ordinal, ``tlast_site`` is rebuilt from the state at each entry, and
    the reuse schedule depends on the carry and the absolute frames only).
    ``stale_rates`` does not reach it: K4 recomputes in-frame rates after
    every event (the driver says so once per run)."""
    rep = ens.replicas
    R, N = rep.occ.shape
    if nbr_reuse is None:
        nbr_reuse = nbr_reuse_auto(isinstance(model, TopKPairRates), N,
                                   model.host_buffer)
        if nbr_reuse:
            _log_reuse_auto_once()
    if tile is None:
        tile = ts.pick_tile_topk(R, n_sites=N, n_protons=rep.site_of_proton.shape[1],
                                 k_cand=model.k)
    B = frames_positions.shape[0]
    per_frame = 3 * 4 * min(model.k, N - 1) * N  # topd, topi, resc
    chunk = max(1, STREAMED_TABLE_BUDGET_BYTES // per_frame)
    if chunk < B:
        trunc_total = None
        for s in range(0, B, chunk):
            e = min(s + chunk, B)
            ens, trunc = _run_block_topk(
                model, cell, ens, frames_positions[s:e], frame0 + s, dt=dt,
                max_events=max_events, seed=seed, tile=tile,
                tile_offset=tile_offset, return_truncation=True,
                nbr_reuse=nbr_reuse, hist_range=hist_range)
            trunc_total = trunc if trunc_total is None else trunc_total + trunc
        return (ens, trunc_total) if return_truncation else ens
    out = ts.run_block_topk(model, ens, frames_positions, frame0, dt=dt,
                            max_events=max_events, seed=seed, tile=tile,
                            tile_offset=tile_offset, reuse=nbr_reuse,
                            hist_range=hist_range)
    return _finish(ens, rep, out, return_truncation)


def _finish(ens, rep, out, return_truncation):
    """Repack a kernel output dict into an EnsembleState; the block's jump
    matrix is added into replica 0's in place (the state is this run's own:
    see ``donate`` in :func:`run_block_fused`)."""
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
        jump_hist=out.get("jump_hist", rep.jump_hist),
        opportunity_hist=out.get("exposure", rep.opportunity_hist),
    )
    if "jump_matrix" in out:
        rep.jump_matrix[0] += out["jump_matrix"]
    ens_out = dataclasses.replace(
        ens, replicas=replicas, site_disp=out["site_disp"],
        prev_pos=out["prev_pos"], nbr_carry=out.get("nbr_carry", ens.nbr_carry),
    )
    if return_truncation:
        return ens_out, out["trunc"]
    return ens_out
