"""Minimum-image distance matrices: kernel K2 and its plain version.

Port of ``cmdlmc_tpu/ops/pairwise.py``. For orthorhombic cells the batched
matrix [B, N, N] comes from the CUDA kernel ``csrc/pairwise.cu`` on the card
(every N: the JAX package's ``min_pallas_n=512`` threshold was a TPU
measurement) and from :func:`pairwise_reference` on the CPU. Triclinic cells
take the 27-image search in ``core/cell.py``.
"""

from __future__ import annotations

import torch

from cmdlmc_tpu_torch.core.cell import Cell, pairwise_distances, sqrt32
from cmdlmc_tpu_torch.ops import build


def pairwise_reference(positions: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: positions [..., N, 3], box lengths [3] ->
    [..., N, N] with d[i, j] = |minimg(pos[j] - pos[i])|. The squares sum in
    the order x, y, z, like the JAX package's reduction."""
    d = positions[..., None, :, :] - positions[..., :, None, :]
    d = d - box * torch.round(d / box)
    sq = d * d
    return sqrt32(sq[..., 0] + sq[..., 1] + sq[..., 2])


def pairwise_cubic(positions: torch.Tensor, box) -> torch.Tensor:
    """Batched orthorhombic distance matrices [B, N, N] from positions
    [B, N, 3] and the three box lengths (floats, so no device sync): K2 for
    CUDA tensors, the plain version for CPU tensors."""
    lx, ly, lz = (float(x) for x in box)
    if positions.device.type == "cpu":
        return pairwise_reference(
            positions, torch.tensor([lx, ly, lz], dtype=torch.float32)
        )
    if positions.device.type != "cuda":
        raise ValueError(f"pairwise_cubic: unsupported device {positions.device}")
    if positions.dtype != torch.float32 or positions.dim() != 3 \
            or positions.shape[-1] != 3:
        raise ValueError(
            f"pairwise_cubic expects float32 [B, N, 3], got "
            f"{positions.dtype} {tuple(positions.shape)}"
        )
    pos = positions.contiguous()
    batch, n, _ = pos.shape
    out = torch.empty((batch, n, n), dtype=torch.float32, device=pos.device)
    if out.numel() == 0:
        return out
    lib = build.library()
    pairwise_cubic.launches += 1
    build.check(
        lib.cmdlmc_pairwise(pos.data_ptr(), batch, n, lx, ly, lz,
                            out.data_ptr(), build.stream_of(pos),
                            pos.device.index or 0),
        "pairwise kernel",
    )
    return out


pairwise_cubic.launches = 0


def pairwise_distance_matrix(cell: Cell, positions: torch.Tensor,
                             box=None) -> torch.Tensor:
    """Minimum-image all-to-all distances of positions [N, 3] or [B, N, 3].
    ``box`` may carry an orthorhombic cell's lengths as host floats."""
    if cell.orthorhombic:
        if box is None:
            box = torch.diagonal(cell.h).tolist()
        batched = positions if positions.dim() == 3 else positions[None]
        out = pairwise_cubic(batched, box)
        return out if positions.dim() == 3 else out[0]
    return pairwise_distances(cell, positions, positions)
