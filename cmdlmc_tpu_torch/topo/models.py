"""Per-frame rate models: the dense rate matrix W or the K-nearest tables.

Port of ``cmdlmc_tpu/topo/models.py``: ``Frame``, ``DenseShared``,
``PairRates``, ``determine_groups`` and ``AnglePairRates`` build the dense
W[N, N] shared by all replicas; ``TopKShared``, ``k_smallest``,
``TopKPairRates`` (the reference's Verlet-list option as a K-nearest list)
and ``HydroniumRates`` (K closest with a distance transformation and a
residence-time blend) build per-site neighbor tables, which the top-K event
loop (``ops/topk_sweep.py``) and the scan engine (``engine/lattice.py``,
through ``replica_omega``) combine with each replica's state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from cmdlmc_tpu_torch.core.cell import Cell, angle, pairwise_distances
from cmdlmc_tpu_torch.ops.pairwise import pairwise_distance_matrix


@dataclasses.dataclass
class Frame:
    """Donor positions [N, 3], or a block of frames [B, N, 3], the extra
    atoms' positions ([M, 3] or [B, M, 3]; the P atoms of AngleTopology),
    and for the scan engine the simulation time (float32, index * dt) and
    the frame index (int32), scalars or [B], host tensors so the engine
    reads them without a device sync."""

    donors: torch.Tensor
    extras: torch.Tensor | None = None
    time: torch.Tensor | None = None
    index: torch.Tensor | None = None


@dataclasses.dataclass
class DenseShared:
    """Replica-independent masked rate matrix W[i, j] (rate of donor i ->
    donor j; 0 outside cutoff+buffer and on the diagonal) and the raw
    distances."""

    W: torch.Tensor
    dist: torch.Tensor


class PairRates(nn.Module):
    """NeighborTopology: every donor pair within cutoff+buffer carries the
    rate law(d)."""

    def __init__(self, cell: Cell, law: nn.Module, cutoff: float, buffer: float):
        super().__init__()
        self.cell = cell
        self.law = law
        device = cell.h.device
        self.register_buffer(
            "cutoff", torch.tensor(float(cutoff), dtype=torch.float32, device=device)
        )
        self.register_buffer(
            "buffer", torch.tensor(float(buffer), dtype=torch.float32, device=device)
        )
        # host copies of the box, of cutoff + buffer (float32) and of the
        # cell geometry for the kernels' launches, so no call waits on the
        # device
        self.box = (
            tuple(torch.diagonal(cell.h).tolist()) if cell.orthorhombic else None
        )
        self.cutbuf = float(np.float32(cutoff) + np.float32(buffer))
        self.geometry = cell.host_geometry()

    def shared(self, frame: Frame) -> DenseShared:
        """W and distances for one frame ([N, 3] donors) or a block."""
        d = pairwise_distance_matrix(self.cell, frame.donors, self.box)
        n = d.shape[-1]
        eye = torch.eye(n, dtype=torch.bool, device=d.device)
        valid = (d <= self.cutoff + self.buffer) & ~eye
        return DenseShared(W=torch.where(valid, self.law(d), 0.0), dist=d)

    def replica_omega(self, shared: DenseShared, site_residence: torch.Tensor):
        """The dense rates are the same for every replica."""
        return shared


def determine_groups(cell: Cell, extras: torch.Tensor, donors: torch.Tensor,
                     group_size: int) -> torch.Tensor:
    """Static O -> P map [N] (int32): each extra atom (P) adopts its
    ``group_size`` closest donors, ties to the lower donor index; a donor
    adopted by several takes the highest P index (the last write of the JAX
    package's scatter); donors no P adopted fall back to their nearest P,
    ties to the lower P index."""
    d_po = pairwise_distances(cell, extras, donors)  # [M, N]
    closest = torch.argsort(d_po, dim=1, stable=True)[:, :group_size]
    n = donors.shape[0]
    p_ids = torch.arange(extras.shape[0], device=d_po.device)[:, None]
    o_to_p = torch.full((n,), -1, dtype=torch.int64, device=d_po.device)
    o_to_p = o_to_p.scatter_reduce(0, closest.reshape(-1),
                                   p_ids.expand_as(closest).reshape(-1), "amax")
    nearest_p = torch.argmin(d_po, dim=0)
    return torch.where(o_to_p < 0, nearest_p, o_to_p).to(torch.int32)


class AnglePairRates(PairRates):
    """AngleTopology: pair rates gated by the P-O-O angle at the donor, with
    the static O -> P map ``o_to_p`` [N] from the first frame."""

    def __init__(self, cell: Cell, law: nn.Module, cutoff: float,
                 buffer: float, o_to_p: torch.Tensor):
        super().__init__(cell, law, cutoff, buffer)
        self.register_buffer(
            "o_to_p", torch.as_tensor(o_to_p, dtype=torch.int64,
                                      device=cell.h.device))

    @classmethod
    def from_first_frame(cls, cell, law, cutoff, buffer, donors0, extras0,
                         group_size):
        o_to_p = determine_groups(cell, extras0, donors0, group_size)
        return cls(cell, law, cutoff, buffer, o_to_p)

    def grouped_positions(self, extras: torch.Tensor) -> torch.Tensor:
        """Position of each donor's P atom: [..., M, 3] -> [..., N, 3]."""
        return extras[..., self.o_to_p, :]

    def shared(self, frame: Frame) -> DenseShared:
        """W and distances for one frame or a block; the law sees the angle
        at vertex O_i between its P and every destination O_j."""
        donors = frame.donors
        d = pairwise_distance_matrix(self.cell, donors, self.box)
        ang = angle(
            self.cell,
            self.grouped_positions(frame.extras)[..., :, None, :],
            donors[..., :, None, :],
            donors[..., None, :, :],
        )
        n = d.shape[-1]
        eye = torch.eye(n, dtype=torch.bool, device=d.device)
        valid = (d <= self.cutoff + self.buffer) & ~eye
        return DenseShared(W=torch.where(valid, self.law(d, ang), 0.0), dist=d)


@dataclasses.dataclass
class TopKShared:
    """Replica-independent K-nearest geometry of one frame [N, K] or a block
    [B, N, K]: raw distances (1e6 where invalid), distances after the
    transformation (== dist without one), neighbor indices (int32), whether
    each slot is a real neighbor within cutoff+buffer, and the frame's time
    where the frame carries one."""

    dist: torch.Tensor
    dist_rescaled: torch.Tensor
    nbr: torch.Tensor
    valid: torch.Tensor
    time: torch.Tensor | None = None


def k_smallest(d: torch.Tensor, k: int):
    """The k smallest entries of each row of ``d`` ([..., N]), ascending:
    (dist [..., k], idx [..., k]), ties to the lowest index. A row with fewer
    than k finite entries repeats index 0 with distance inf, as argmin over
    an all-inf row gives it."""
    iota = torch.arange(d.shape[-1], device=d.device)
    dists, idxs = [], []
    for _ in range(k):
        i = torch.argmin(d, dim=-1)  # first index on ties
        dists.append(torch.gather(d, -1, i[..., None])[..., 0])
        idxs.append(i)
        d = torch.where(iota == i[..., None], float("inf"), d)
    return torch.stack(dists, dim=-1), torch.stack(idxs, dim=-1)


class TopKRates(nn.Module):
    """The K-nearest neighbor list of NeighborTopology: every donor's
    min(k, N - 1) closest donors within cutoff+buffer. Host copies of the
    box, cutoff + buffer (float32) and the cell geometry serve the kernels'
    launches without a device sync."""

    def __init__(self, cell: Cell, law: nn.Module, cutoff: float, buffer: float,
                 k: int, transform: nn.Module | None = None,
                 interpolator: nn.Module | None = None):
        super().__init__()
        self.cell = cell
        self.law = law
        self.k = int(k)
        self.transform = transform
        self.interpolator = interpolator
        device = cell.h.device
        self.register_buffer(
            "cutoff", torch.tensor(float(cutoff), dtype=torch.float32, device=device))
        self.register_buffer(
            "buffer", torch.tensor(float(buffer), dtype=torch.float32, device=device))
        self.box = (
            tuple(torch.diagonal(cell.h).tolist()) if cell.orthorhombic else None
        )
        self.cutbuf = float(np.float32(cutoff) + np.float32(buffer))
        self.host_cutoff = float(np.float32(cutoff))
        self.host_buffer = float(np.float32(buffer))
        self.geometry = cell.host_geometry()

    def shared(self, frame: Frame) -> TopKShared:
        """The tables of one frame ([N, 3] donors) or a block ([B, N, 3])."""
        d = pairwise_distance_matrix(self.cell, frame.donors, self.box)
        n = d.shape[-1]
        eye = torch.eye(n, dtype=torch.bool, device=d.device)
        d = torch.where(eye, float("inf"), d)
        d = torch.where(d <= self.cutoff + self.buffer, d, float("inf"))
        dist, nbr = k_smallest(d, min(self.k, n - 1))
        valid = torch.isfinite(dist)
        dist = torch.where(valid, dist, 1e6)
        rescaled = self.transform(dist) if self.transform is not None else dist
        return TopKShared(dist=dist, dist_rescaled=rescaled,
                          nbr=nbr.to(torch.int32), valid=valid, time=frame.time)

    def replica_omega(self, shared: TopKShared, site_residence: torch.Tensor):
        """(omega, nbr, valid) of the scan engine: the law over the rescaled
        distances, blended by ``interpolator`` over the residence time of the
        proton on each site (``site_residence`` [..., N], -1 where it never
        jumped); omega is [N, K] without an interpolator (the same for every
        replica), else [..., N, K]. TopKPairRates has no transformation, so
        its rescaled distances are the raw ones."""
        if self.interpolator is not None:
            d_eff = self.interpolator(site_residence[..., None], shared.dist,
                                      shared.dist_rescaled)
        else:
            d_eff = shared.dist_rescaled
        omega = torch.where(shared.valid, self.law(d_eff), 0.0)
        return omega, shared.nbr, shared.valid


class TopKPairRates(TopKRates):
    """NeighborTopology with ``max_neighbors = k``: the rate law(d) over each
    donor's K nearest (exactly PairRates where k covers every neighbor in
    range)."""

    def __init__(self, cell: Cell, law: nn.Module, cutoff: float, buffer: float,
                 k: int = 8):
        super().__init__(cell, law, cutoff, buffer, k)


class HydroniumRates(TopKRates):
    """HydroniumTopology: K-closest rates over distances rescaled by
    ``transform`` (a DistanceTransformation, or None) and blended by
    ``interpolator`` (a DistanceInterpolator: the time the occupying proton
    has sat on its site; None is instantaneous)."""

    def __init__(self, cell: Cell, law: nn.Module, cutoff: float, buffer: float,
                 transform: nn.Module | None = None,
                 interpolator: nn.Module | None = None, k: int = 4):
        super().__init__(cell, law, cutoff, buffer, k, transform, interpolator)
