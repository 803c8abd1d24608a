"""Multi-proton KMC lattice engine: replica state, observables and the
generic per-frame scan engine.

Port of ``cmdlmc_tpu/engine/lattice.py``: ``ReplicaState``,
``EnsembleState``, ``NeighborCarry``, ``init_replicas`` (a seeded
``torch.Generator``, not threefry), the observables (``observables_of``,
``displacement_moment4``, ``per_proton_variance``, ``ObsRow``), the
observable reset, and the scan engine ``run_block`` /
``run_block_with_sites`` for every rate model: one Python step per MD frame
advances all R replicas at once (tensors [R, ...] where the JAX package
vmaps). The dense models keep each replica's outgoing rate vector
``out = (1 - occ) W^T`` (one [R, N] x [N, N] float32 product per frame,
then ``out += W^T[src] - W^T[dst]`` per event); the top-K models pick from
the flattened [N K] allowed rates. The clock and every draw are the JAX
package's (``engine/clock.py``, ``ops/threefry.py``), so from the same state
and keys the port makes the same decisions. The event-loop kernels
(``engine/fused.py``) run what they support; the driver routes the rest
here.

A replica is one KMC chain over the shared MD trajectory; all replicas of an
ensemble advance together and share the site-displacement prefix sum.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from cmdlmc_tpu_torch.core.cell import Cell, displacement as cell_displacement
from cmdlmc_tpu_torch.core.f32 import divisor, f32
from cmdlmc_tpu_torch.engine import clock as kmc_clock
from cmdlmc_tpu_torch.engine.clock import ClockState
from cmdlmc_tpu_torch.ops import threefry
from cmdlmc_tpu_torch.topo.models import DenseShared, Frame
from cmdlmc_tpu_torch.utils import trace


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


@dataclasses.dataclass(eq=False, repr=False)
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
    The rebuild schedule is a function of the carry and the absolute frames
    alone. Its three scalars are held as 0-d float64 tensors on ref_pos's
    device (:meth:`scalars`), where the schedule kernel reads and writes
    them; read as attributes they are Python floats, fetched through a
    marked sync (``verlet_carry``). A float given to the constructor goes
    to the device the same way. Neither ``==`` nor ``repr`` is generated,
    so no incidental comparison or print waits for the card; the held
    tensors are read by :meth:`scalars` (and ``utils/checkpoint.py``'s
    field walk, through ``vars``)."""

    ref_pos: torch.Tensor
    ref_topi: torch.Tensor
    ref_valid: torch.Tensor
    thresh: float = 0.0
    last_rebuild: float = -1.0e18
    thrash_until: float = 0.0

    def scalars(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(thresh, last_rebuild, thrash_until) as held: 0-d float64 tensors."""
        return tuple(vars(self)[name] for name in SCHEDULE_SCALARS)

    def to(self, device) -> "NeighborCarry":
        return NeighborCarry(*(vars(self)[f.name].to(device)
                               for f in dataclasses.fields(self)))


SCHEDULE_SCALARS = ("thresh", "last_rebuild", "thrash_until")


def _schedule_scalar(name: str) -> property:
    def get(self) -> float:
        return float(trace.to_host(vars(self)[name], "verlet_carry"))

    def put(self, value) -> None:
        if not isinstance(value, torch.Tensor):
            value = trace.to_device(torch.tensor(float(value), dtype=torch.float64),
                                    self.ref_pos.device, "verlet_carry")
        vars(self)[name] = value

    return property(get, put)


for _name in SCHEDULE_SCALARS:
    setattr(NeighborCarry, _name, _schedule_scalar(_name))
del _name


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


# ----------------------------------------------------------------------------
# The scan engine
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class ObsRow:
    """Per-frame ensemble observables of a block ([B] or [B, 3]): means and
    variances across replicas, zero on frames ``emit_every`` skips.
    ``truncated_mean`` is the fraction of replicas that used all
    ``max_events`` of the frame (never skipped); ``msd4_mean`` the 4th
    displacement moment. ``frame`` and ``time`` are host tensors, the rest
    lie on the run's device (:meth:`cpu` fetches them in one copy)."""

    frame: torch.Tensor
    time: torch.Tensor
    msd_mean: torch.Tensor
    msd_var: torch.Tensor
    autocorr_mean: torch.Tensor
    autocorr_var: torch.Tensor
    jumps_mean: torch.Tensor
    events_mean: torch.Tensor
    truncated_mean: torch.Tensor
    msd4_mean: torch.Tensor

    _STATS = ("msd_mean", "msd_var", "autocorr_mean", "autocorr_var", "jumps_mean",
              "msd4_mean", "events_mean", "truncated_mean")

    @classmethod
    def _from_table(cls, frame, time, table: torch.Tensor) -> "ObsRow":
        """Rows from a [B, 12] table: row_stats' 11 values, then the
        truncated fraction."""
        return cls(frame=frame, time=time, msd_mean=table[:, 0:3],
                   msd_var=table[:, 3:6], autocorr_mean=table[:, 6],
                   autocorr_var=table[:, 7], jumps_mean=table[:, 8],
                   msd4_mean=table[:, 9], events_mean=table[:, 10],
                   truncated_mean=table[:, 11])

    def cpu(self) -> "ObsRow":
        table = torch.cat([getattr(self, n).reshape(self.frame.shape[0], -1)
                           for n in self._STATS], dim=1).cpu()
        return ObsRow._from_table(self.frame, self.time, table)


def row_stats(states: ReplicaState, site_disp: torch.Tensor,
              variance_mode: str = "replicas") -> torch.Tensor:
    """One frame's ensemble observables as an 11-vector: msd mean (3), msd
    variance (3), autocorrelation mean and variance, jumps mean, msd4 mean,
    events mean. ``variance_mode = "protons"`` takes the variances across
    each chain's protons, averaged over replicas."""
    msd, autocorr = observables_of(states, site_disp)
    autocorr = autocorr.to(torch.float32)
    if variance_mode == "protons":
        pv_msd, pv_auto = per_proton_variance(states, site_disp)
        msd_var, autocorr_var = pv_msd.mean(dim=0), pv_auto.mean()
    else:
        msd_var = msd.var(dim=0, correction=0)
        autocorr_var = autocorr.var(correction=0)
    return torch.cat([
        msd.mean(dim=0), msd_var,
        torch.stack([
            autocorr.mean(), autocorr_var,
            states.jumps.to(torch.float32).mean(),
            displacement_moment4(states, site_disp).mean(),
            states.clock.event_count.to(torch.float32).mean(),
        ]),
    ])


def _hist_bin(dist: torch.Tensor, hist_range, n_bins: int) -> torch.Tensor:
    """clip(int((d - lo) / (hi - lo) * n_bins), 0, n_bins - 1), float32."""
    lo, hi = hist_range
    raw = (dist - f32(lo)) / divisor(hi - lo, dist.device) * f32(n_bins)
    return torch.clamp(raw.to(torch.int32), 0, n_bins - 1).long()


def _hist_in_range(dist: torch.Tensor, hist_range) -> torch.Tensor:
    lo, hi = hist_range
    return (dist >= f32(lo)) & (dist < f32(hi))


def _site_residence(occ, proton_of_site, t_last_jump, time):
    """Residence time [R, N] of the proton on each site; -1 where the site is
    empty or its proton never jumped."""
    p_idx = torch.clamp(proton_of_site - 1, min=0).long()
    t_last = torch.gather(t_last_jump, 1, p_idx)
    return torch.where((occ > 0) & ~(t_last < 0), time - t_last, -1.0)


def _cdf_pick(weights: torch.Tensor, u01: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF categorical draw per row of ``weights`` [R, n] with one
    uniform per row: the count of the cumulative sum below u * total,
    clamped to n - 1 (the reference's cumsum / uniform / searchsorted)."""
    u = u01 * weights.sum(dim=-1)
    below = (torch.cumsum(weights, dim=-1) < u[:, None]).sum(dim=-1)
    return torch.clamp(below, max=weights.shape[-1] - 1)


def _topk_allowed(model, shared, occ, proton_of_site, t_last, time):
    """allowed [R, N, K] = omega occ[i] (1 - occ[nbr]) and the neighbors."""
    residence = None
    if getattr(model, "interpolator", None) is not None:
        residence = _site_residence(occ, proton_of_site, t_last, time)
    omega, nbr, _ = model.replica_omega(shared, residence)
    return omega * occ[:, :, None] * (1.0 - occ[:, nbr.long()]), nbr


def _put(x: torch.Tensor, index: tuple, value, fire: torch.Tensor) -> torch.Tensor:
    """x with x[index] = value in the lanes where ``fire`` holds (one index
    per lane), out of place."""
    cur = x[index]
    f = fire.reshape(fire.shape + (1,) * (cur.dim() - 1))
    return x.index_put(index, torch.where(f, value, cur))


@contextlib.contextmanager
def _float32_matmul():
    """Full float32 products on the card (no TF32) while the engine runs."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def _replica_frame_step(model, frame: Frame, site_disp, dt, max_events, hist_range,
                        state: ReplicaState, keys, tags):
    """Advance every replica across one MD frame ``frame`` (donors [N, 3],
    a host time and index). ``keys`` [R, 2] are the replicas' keys; they
    must not change with the frame (the clock folds in event ordinals).

    Dense path: ONE [R, N] x [N, N] product per frame gives each replica's
    outgoing rate vector out[r, i] = sum_j W[i, j] (1 - occ[r, j]); an
    event updates it by W^T[src] - W^T[dst], and the clock's total rate is
    sum(occ out). Top-K path: the allowed rates [R, N, K] are recomputed
    per evaluation (the blend moves with each jump). The jump matrix is
    added into in place."""
    shared = model.shared(Frame(frame.donors, frame.extras, frame.time))
    dense = isinstance(shared, DenseShared)
    R = state.occ.shape[0]
    dev = state.occ.device
    rows = torch.arange(R, device=dev)
    n_bins = state.jump_hist.shape[-1]
    track_matrix = state.jump_matrix.shape[-1] > 0
    time = float(frame.time)  # float32's value, a host scalar
    donors = frame.donors
    if dense:
        W = shared.W
        WT = W.T
        out0 = (1.0 - state.occ) @ WT
    else:
        out0 = None

    def rate_fn(aux):
        occ, pos, _, t_last, out = aux[:5]
        if dense:
            return (occ * out).sum(dim=-1)
        allowed, _ = _topk_allowed(model, shared, occ, pos, t_last, time)
        return allowed.reshape(R, -1).sum(dim=-1)

    def apply_fn(aux, event_key, event_phase, fire):
        occ, pos, sop, t_last, out, jumps, hist, jmat, disp_base = aux
        u = threefry.uniform(threefry.split(event_key))  # [R, 2]
        if dense:
            src = _cdf_pick(occ * out, u[:, 0])
            dst = _cdf_pick(W[src] * (1.0 - occ), u[:, 1])
            d_evt = shared.dist[src, dst]
            out = torch.where(fire[:, None], out + WT[src] - WT[dst], out)
        else:
            allowed, nbr = _topk_allowed(model, shared, occ, pos, t_last, time)
            kk = allowed.shape[-1]
            flat = _cdf_pick(allowed.reshape(R, -1), u[:, 0])
            src = flat // kk
            dst = nbr.reshape(-1)[flat].long()
            d_evt = shared.dist.reshape(-1)[flat]
        label = pos[rows, src]
        p_idx = torch.clamp(label - 1, min=0).long()
        occ = _put(_put(occ, (rows, src), 0.0, fire), (rows, dst), 1.0, fire)
        pos = _put(_put(pos, (rows, src), 0, fire), (rows, dst), label, fire)
        sop = _put(sop, (rows, p_idx), dst.to(torch.int32), fire)
        t_last = _put(t_last, (rows, p_idx), time + event_phase, fire)
        # MSD rebase: the displacement stays continuous through the jump; the
        # jump vector is the minimum-image src -> dst connection this frame
        jump_vec = cell_displacement(model.cell, donors[src], donors[dst])
        disp_base = _put(disp_base, (rows, p_idx), disp_base[rows, p_idx]
                         + (site_disp[src] - site_disp[dst] + jump_vec), fire)
        if n_bins > 0:
            inc = (_hist_in_range(d_evt, hist_range) & fire).to(torch.int32)
            hist = hist.index_put((rows, _hist_bin(d_evt, hist_range, n_bins)),
                                  inc, accumulate=True)
        if track_matrix:
            jmat.index_put_((rows, src, dst), fire.to(torch.int32), accumulate=True)
        return (occ, pos, sop, t_last, out, jumps + fire.to(torch.int32), hist,
                jmat, disp_base)

    aux = (state.occ, state.proton_of_site, state.site_of_proton, state.t_last_jump,
           out0, state.jumps, state.jump_hist, state.jump_matrix, state.disp_base)
    new_clock, aux, n_fired = kmc_clock.frame_step(
        state.clock, aux, frame_idx=int(frame.index), dt=dt, rate_fn=rate_fn,
        apply_fn=apply_fn, key=keys, max_events=max_events, tags=tags)
    occ, pos, sop, t_last, _, jumps, hist, jmat, disp_base = aux

    opp = state.opportunity_hist
    if n_bins > 0:
        # exposure: the allowed transitions of this frame, binned by their
        # raw pair distance (jump probability = jump_hist / exposure); whole
        # numbers, so the sums are exact in any order
        if dense:
            mask = (W > 0) & _hist_in_range(shared.dist, hist_range)
            onehot = torch.nn.functional.one_hot(
                _hist_bin(shared.dist, hist_range, n_bins), n_bins) * mask[..., None]
            n = W.shape[0]
            tmp = (occ @ onehot.to(torch.float32).reshape(n, n * n_bins)).reshape(
                R, n, n_bins)
            opp = opp + (tmp * (1.0 - occ)[:, :, None]).sum(dim=1)
        else:
            residence = _site_residence(occ, pos, t_last, time)
            omega, nbr, valid = model.replica_omega(shared, residence)
            weights = (valid & (omega > 0)) * occ[:, :, None] * (1.0 - occ[:, nbr.long()])
            weights = weights * _hist_in_range(shared.dist, hist_range)
            onehot = torch.nn.functional.one_hot(
                _hist_bin(shared.dist, hist_range, n_bins), n_bins).to(torch.float32)
            opp = opp + weights.reshape(R, -1) @ onehot.reshape(-1, n_bins)

    return dataclasses.replace(
        state, occ=occ, proton_of_site=pos, site_of_proton=sop, t_last_jump=t_last,
        clock=new_clock, jumps=jumps, jump_hist=hist, jump_matrix=jmat,
        opportunity_hist=opp, disp_base=disp_base,
    ), n_fired


def block_frames(donors: torch.Tensor, frame0: int, dt: float,
                 extras: torch.Tensor | None = None) -> Frame:
    """A block of frames for the scan engine: donors [B, N, 3] (and extras
    [B, M, 3]) with the host index frame0 .. frame0 + B - 1 (int32) and time
    index * dt in float32, as the JAX driver makes them."""
    index = torch.arange(frame0, frame0 + donors.shape[0], dtype=torch.int32)
    time = index.to(torch.float32) * f32(dt)
    return Frame(donors=donors, extras=extras, time=time, index=index)


def _block_scan(model, cell: Cell, ens: EnsembleState, keys, frames: Frame, dt,
                max_events, reset_frequency, hist_range, emit_every, with_sites,
                equilibration=0, variance_mode="replicas"):
    states = ens.replicas
    if states.jump_matrix.shape[-1] > 0:  # added into in place: the caller's stays
        states = dataclasses.replace(states, jump_matrix=states.jump_matrix.clone())
    site_disp, prev_pos = ens.site_disp, ens.prev_pos
    tags = kmc_clock.tag_keys(keys)
    index = frames.index.tolist()
    stats, sites = [], []
    empty = torch.zeros(11, dtype=torch.float32, device=states.occ.device)
    with _float32_matmul():
        for f, fi in enumerate(index):
            frame = Frame(frames.donors[f],
                          None if frames.extras is None else frames.extras[f],
                          frames.time[f], fi)
            site_disp = site_disp + cell_displacement(cell, prev_pos, frame.donors)
            states, n_fired = _replica_frame_step(
                model, frame, site_disp, dt, max_events, hist_range, states, keys, tags)
            if ((reset_frequency > 0 and fi % reset_frequency == 0 and fi > 0)
                    or (equilibration > 0 and fi == equilibration)):
                states = _reset_states(states, site_disp)
            emit = emit_every <= 1 or fi % emit_every == 0
            row = row_stats(states, site_disp, variance_mode) if emit else empty
            # event-bound telemetry is never gated
            trunc = (n_fired >= max_events).to(torch.float32).mean()
            stats.append(torch.cat([row, trunc[None]]))
            if with_sites:
                sites.append(states.site_of_proton[0])
            prev_pos = frame.donors
    rows = ObsRow._from_table(frames.index, frames.time, torch.stack(stats))
    ens = dataclasses.replace(ens, replicas=states, site_disp=site_disp, prev_pos=prev_pos)
    return ens, rows, (torch.stack(sites) if with_sites else None)


def run_block(model, cell: Cell, ens: EnsembleState, keys: torch.Tensor,
              frames: Frame, *, dt: float, max_events: int = 4,
              reset_frequency: int = 0, hist_range: tuple = (2.0, 3.0),
              emit_every: int = 1, equilibration: int = 0,
              variance_mode: str = "replicas") -> tuple[EnsembleState, ObsRow]:
    """Advance all replicas across a block of frames (``frames`` from
    :func:`block_frames`) with the replicas' keys [R, 2]
    (``split(fold_in(key(seed), 1), R)`` in the drivers).

    Returns the final ensemble and the per-frame observables (zero on frames
    where ``emit_every`` skips the reduction). The event-ordinal keying
    makes the result independent of how the trajectory is cut into blocks.
    The given ensemble is left as it was."""
    ens, rows, _ = _block_scan(model, cell, ens, keys, frames, dt, max_events,
                               reset_frequency, hist_range, emit_every, False,
                               equilibration, variance_mode)
    return ens, rows


def run_block_with_sites(model, cell: Cell, ens: EnsembleState, keys: torch.Tensor,
                         frames: Frame, *, dt: float, max_events: int = 4,
                         reset_frequency: int = 0, hist_range: tuple = (2.0, 3.0),
                         emit_every: int = 1, equilibration: int = 0):
    """Like :func:`run_block`, and also replica 0's proton sites after each
    frame, [B, P] (the XYZOutput mode)."""
    return _block_scan(model, cell, ens, keys, frames, dt, max_events, reset_frequency,
                       hist_range, emit_every, True, equilibration)
