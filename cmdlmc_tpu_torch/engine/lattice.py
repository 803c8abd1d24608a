"""Replica state, initialization and observables of the KMC lattice engine.

Port of the state and observable parts of ``cmdlmc_tpu/engine/lattice.py``:
``ReplicaState``, ``EnsembleState``, ``init_replicas``,
``NeighborCarry``, ``proton_displacement``, ``observables_of``,
``displacement_moment4``, ``per_proton_variance`` and ``_reset_states``, with
the jump histograms and the jump matrix. The per-frame scan engine waits for
ROADMAP A12.

A replica is one KMC chain over the shared MD trajectory; all replicas of an
ensemble advance together and share the site-displacement prefix sum.
"""

from __future__ import annotations

import dataclasses

import torch

from cmdlmc_tpu_torch.engine.clock import ClockState


@dataclasses.dataclass
class ReplicaState:
    """Per-replica state, batched over R replicas.

    occ            f32[R, N]    1.0 where a proton sits
    proton_of_site i32[R, N]    proton label 1..P, 0 = empty
    site_of_proton i32[R, P]    inverse map
    t_last_jump    f32[R, P]    KMC time of each proton's last jump, -1 if never
    clock          ClockState
    jumps          i32[R]       events since the last observable reset
    disp_base      f32[R, P, 3] jump-rebased displacement offset: the proton's
                                displacement since reset is disp_base +
                                site_disp[site]
    autocorr_ref   i32[R, P]    site of each proton at the last reset
    jump_hist      i32[R, B]    distance-binned jump counts (jumpstat; B = 0
                                turns the statistics off)
    opportunity_hist f32[R, B]  distance-binned exposure of allowed
                                transitions, in frames (jump probability =
                                jump_hist / opportunity_hist)
    jump_matrix    i32[R, n, n] per-pair jump counts, n = N when tracked, else
                                0; the kernels add each block's count into
                                replica 0, so the sum over replicas is the
                                run's matrix (the JAX package's convention)
    """

    occ: torch.Tensor
    proton_of_site: torch.Tensor
    site_of_proton: torch.Tensor
    t_last_jump: torch.Tensor
    clock: ClockState
    jumps: torch.Tensor
    disp_base: torch.Tensor
    autocorr_ref: torch.Tensor
    jump_hist: torch.Tensor
    opportunity_hist: torch.Tensor
    jump_matrix: torch.Tensor

    def to(self, device) -> "ReplicaState":
        return ReplicaState(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


@dataclasses.dataclass
class NeighborCarry:
    """Frozen K-nearest candidate lists of Verlet candidate reuse
    (``ops/topk_sweep.py::topk_tables_verlet``), carried from block to block.

    ref_pos   f32[N, 3]  donor positions at the last rebuild (the drift
                         reference)
    ref_topi  i32[K, N]  candidate site ids frozen at the last rebuild
    ref_valid bool[K, N] whether the slot held a neighbor in range then
    thresh               drift up to which the lists stay valid
    last_rebuild         absolute frame of the last rebuild
    thrash_until         absolute frame up to which the thrash guard rebuilds
                         every frame
    The three floats live on the host, so the rebuild schedule is a function
    of the carry and the absolute frames alone."""

    ref_pos: torch.Tensor
    ref_topi: torch.Tensor
    ref_valid: torch.Tensor
    thresh: float = 0.0
    last_rebuild: float = -1.0e18
    thrash_until: float = 0.0

    def to(self, device) -> "NeighborCarry":
        return dataclasses.replace(self, ref_pos=self.ref_pos.to(device),
                                   ref_topi=self.ref_topi.to(device),
                                   ref_valid=self.ref_valid.to(device))


@dataclasses.dataclass
class EnsembleState:
    """Replica batch plus the shared trajectory-displacement carry:
    site_disp f32[N, 3] (prefix sum of per-frame minimum-image site
    displacements), prev_pos f32[N, 3] (positions of the previous frame) and,
    on the top-K path with Verlet candidate reuse, the neighbor carry."""

    replicas: ReplicaState
    site_disp: torch.Tensor
    prev_pos: torch.Tensor
    nbr_carry: NeighborCarry | None = None

    def to(self, device) -> "EnsembleState":
        carry = None if self.nbr_carry is None else self.nbr_carry.to(device)
        return EnsembleState(self.replicas.to(device), self.site_disp.to(device),
                             self.prev_pos.to(device), carry)


def init_replicas(
    generator: torch.Generator,
    n_replicas: int,
    n_sites: int,
    n_protons: int,
    first_positions: torch.Tensor,
    device=None,
    *,
    hist_bins: int = 0,
    track_jump_matrix: bool = False,
) -> EnsembleState:
    """Random occupancy: each replica places its protons on a uniformly
    random subset of sites, and draws its first exponential waiting time.
    The draws come from ``generator`` (a CPU generator, so a seed gives the
    same ensemble on every device); they match the JAX package's threefry
    initialization in distribution only. ``hist_bins > 0`` turns on the
    distance-resolved jump statistics (jumpstat), ``track_jump_matrix`` the
    N x N pair jump counter (1.36 GB at R=16384, N=144)."""
    R, N, P = n_replicas, n_sites, n_protons
    jm = N if track_jump_matrix else 0
    keys = torch.rand((R, N), generator=generator)
    sites = torch.argsort(keys, dim=1)[:, :P].to(torch.int32)
    u0 = torch.empty(R).exponential_(generator=generator)
    sites = sites.to(device)
    rows = torch.arange(R, device=device)[:, None]
    occ = torch.zeros((R, N), dtype=torch.float32, device=device)
    occ[rows, sites.long()] = 1.0
    labels = torch.arange(1, P + 1, dtype=torch.int32, device=device).expand(R, P)
    proton_of_site = torch.zeros((R, N), dtype=torch.int32, device=device)
    proton_of_site[rows, sites.long()] = labels
    clock = ClockState(
        u_remaining=u0.to(device=device, dtype=torch.float32),
        phase=torch.zeros(R, dtype=torch.float32, device=device),
        event_count=torch.zeros(R, dtype=torch.int32, device=device),
        last_event_frame=torch.full((R,), -1, dtype=torch.int32, device=device),
        last_event_phase=torch.zeros(R, dtype=torch.float32, device=device),
    )
    replicas = ReplicaState(
        occ=occ,
        proton_of_site=proton_of_site,
        site_of_proton=sites,
        t_last_jump=torch.full((R, P), -1.0, dtype=torch.float32, device=device),
        clock=clock,
        jumps=torch.zeros(R, dtype=torch.int32, device=device),
        disp_base=torch.zeros((R, P, 3), dtype=torch.float32, device=device),
        autocorr_ref=sites.clone(),
        jump_hist=torch.zeros((R, hist_bins), dtype=torch.int32, device=device),
        opportunity_hist=torch.zeros((R, hist_bins), dtype=torch.float32,
                                     device=device),
        jump_matrix=torch.zeros((R, jm, jm), dtype=torch.int32, device=device),
    )
    return EnsembleState(
        replicas=replicas,
        site_disp=torch.zeros((N, 3), dtype=torch.float32, device=device),
        prev_pos=first_positions.to(device=device, dtype=torch.float32),
    )


def proton_displacement(states: ReplicaState, site_disp: torch.Tensor) -> torch.Tensor:
    """Displacement of each proton since the last reset, [R, P, 3]."""
    return states.disp_base + site_disp[states.site_of_proton.long()]


def observables_of(states: ReplicaState, site_disp: torch.Tensor):
    """(msd [R, 3], autocorrelation count [R]) per replica."""
    disp = proton_displacement(states, site_disp)
    n_protons = disp.shape[-2]
    msd = torch.sum(disp**2, dim=-2) / n_protons
    autocorr = torch.sum(
        (states.site_of_proton == states.autocorr_ref).to(torch.int32), dim=-1
    )
    return msd, autocorr


def displacement_moment4(states: ReplicaState, site_disp: torch.Tensor) -> torch.Tensor:
    """Per-replica mean of |disp|^4 over protons."""
    disp = proton_displacement(states, site_disp)
    r2 = torch.sum(disp * disp, dim=-1)
    return torch.mean(r2 * r2, dim=-1)


def per_proton_variance(states: ReplicaState, site_disp: torch.Tensor):
    """The reference's variance across proton trajectories within one chain:
    of each proton's squared displacement per component [R, 3], and of the
    still-on-reference-site indicator [R]."""
    disp = proton_displacement(states, site_disp)
    msd_var = (disp * disp).var(dim=-2, correction=0)
    ind = (states.site_of_proton == states.autocorr_ref).to(torch.float32)
    return msd_var, ind.var(dim=-1, correction=0)


def _reset_states(states: ReplicaState, site_disp: torch.Tensor) -> ReplicaState:
    """Observable reset: zero displacement and jump counter, re-snapshot the
    autocorrelation reference."""
    sites = states.site_of_proton
    return dataclasses.replace(
        states,
        disp_base=-site_disp[sites.long()],
        jumps=torch.zeros_like(states.jumps),
        autocorr_ref=sites,
    )
