"""Per-frame dense rate model: the stage-1 rate matrix W.

Port of the dense part of ``cmdlmc_tpu/topo/models.py`` (``Frame``,
``DenseShared``, ``PairRates``). The top-K, angle and hydronium models wait
for ROADMAP A13/A14.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from cmdlmc_tpu_torch.core.cell import Cell
from cmdlmc_tpu_torch.ops.pairwise import pairwise_distance_matrix


@dataclasses.dataclass
class Frame:
    """Donor positions [N, 3], or a block of frames [B, N, 3]. (The JAX
    Frame's extra atoms, time and index come with the angle family and the
    scan engine, ROADMAP A12/A13.)"""

    donors: torch.Tensor


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
        # host copy of the box for the distance kernel (no device sync per call)
        self.box = (
            tuple(torch.diagonal(cell.h).tolist()) if cell.orthorhombic else None
        )

    def shared(self, frame: Frame) -> DenseShared:
        """W and distances for one frame ([N, 3] donors) or a block."""
        d = pairwise_distance_matrix(self.cell, frame.donors, self.box)
        n = d.shape[-1]
        eye = torch.eye(n, dtype=torch.bool, device=d.device)
        valid = (d <= self.cutoff + self.buffer) & ~eye
        return DenseShared(W=torch.where(valid, self.law(d), 0.0), dist=d)
