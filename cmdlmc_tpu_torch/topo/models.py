"""Per-frame dense rate models: the stage-1 rate matrix W.

Port of the dense part of ``cmdlmc_tpu/topo/models.py`` (``Frame``,
``DenseShared``, ``PairRates``, ``determine_groups``, ``AnglePairRates``).
The top-K and hydronium models wait for ROADMAP A14.
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
    """Donor positions [N, 3], or a block of frames [B, N, 3], and the extra
    atoms' positions ([M, 3] or [B, M, 3]; the P atoms of AngleTopology).
    (The JAX Frame's time and index come with the scan engine, ROADMAP A12.)"""

    donors: torch.Tensor
    extras: torch.Tensor | None = None


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
        # host copies of the box and of cutoff + buffer (float32) for the
        # kernels' launches, so no call waits on the device
        self.box = (
            tuple(torch.diagonal(cell.h).tolist()) if cell.orthorhombic else None
        )
        self.cutbuf = float(np.float32(cutoff) + np.float32(buffer))

    def shared(self, frame: Frame) -> DenseShared:
        """W and distances for one frame ([N, 3] donors) or a block."""
        d = pairwise_distance_matrix(self.cell, frame.donors, self.box)
        n = d.shape[-1]
        eye = torch.eye(n, dtype=torch.bool, device=d.device)
        valid = (d <= self.cutoff + self.buffer) & ~eye
        return DenseShared(W=torch.where(valid, self.law(d), 0.0), dist=d)


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
