"""K-nearest tables of a block of frames: kernel K5 and its plain version.

Port of ``cmdlmc_tpu/ops/knn_tables.py`` for orthorhombic cells: per frame
and site j, the distances and indices of the k nearest sites i != j within
cutoff + buffer, ``topd`` / ``topi`` [B, k, N] (sites last, the layout the
top-K event loop reads). Ties go to the lowest index; slots past the last
neighbor in range hold index 0 and distance 1e6, as ``k_smallest`` gives
them. The CUDA kernel ``csrc/knn_tables.cu`` serves tensors on the card,
:func:`knn_block_tables_reference` tensors on the CPU. Nothing [N, N]-sized
reaches device memory in the kernel; the plain version builds the distance
matrices a few frames at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from cmdlmc_tpu_torch.core.cell import sqrt32
from cmdlmc_tpu_torch.ops import build

BIG = 1.0e6  # distance of an exhausted slot
MAX_K = 16  # the largest k: K5's register list, K4's candidate width
# bytes of the [chunk, N, N] float32 distances per step of a plain build
PLAIN_CHUNK_BYTES = 1 << 28


def knn_block_tables_reference(positions: torch.Tensor, box, cutbuf: float,
                               k: int):
    """Plain version of K5: positions [B, N, 3], the three box lengths and
    cutoff + buffer (float32 value) -> (topd f32, topi i32), each [B, k, N].
    d[i, j] = sqrt((dx^2 + dy^2) + dz^2) of minimg(p_i - p_j), self and
    d > cutbuf masked, then k passes of min and first-lowest argmin down
    each column, as the JAX kernel runs them."""
    B, N, _ = positions.shape
    dev = positions.device
    box_t = torch.tensor([float(x) for x in box], dtype=torch.float32, device=dev)
    rc = torch.tensor(np.float32(cutbuf), device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    rows = torch.arange(N, device=dev)
    eye = torch.eye(N, dtype=torch.bool, device=dev)
    topd = torch.empty((B, k, N), dtype=torch.float32, device=dev)
    topi = torch.empty((B, k, N), dtype=torch.int32, device=dev)
    chunk = max(1, PLAIN_CHUNK_BYTES // max(4 * N * N, 1))
    for b0 in range(0, B, chunk):
        pos = positions[b0:b0 + chunk]
        delta = pos[:, :, None, :] - pos[:, None, :, :]  # [b, i, j, 3]
        delta = delta - box_t * torch.round(delta / box_t)
        sq = delta * delta
        d = sqrt32((sq[..., 0] + sq[..., 1]) + sq[..., 2])
        d = torch.where(eye, inf, d)
        d = torch.where(d <= rc, d, inf)
        for s in range(k):
            m = d.min(dim=1).values  # [b, j]
            idx = torch.where(d == m[:, None, :], rows[:, None], N).min(dim=1).values
            topd[b0:b0 + chunk, s] = torch.where(m == inf, BIG, m)
            topi[b0:b0 + chunk, s] = idx.to(torch.int32)
            d = torch.where(rows[:, None] == idx[:, None, :], inf, d)
    return topd, topi


def knn_block_tables(positions: torch.Tensor, box, cutbuf: float, k: int):
    """K-nearest tables [B, k, N] (distances f32, indices i32) of a block of
    donor positions [B, N, 3] in an orthorhombic box (three floats, so no
    device sync): K5 for CUDA tensors, the plain version for CPU tensors."""
    if positions.dim() != 3 or positions.shape[-1] != 3:
        raise ValueError(f"knn_block_tables: positions must be [B, N, 3], "
                         f"got {tuple(positions.shape)}")
    B, N, _ = positions.shape
    if not 1 <= k <= min(MAX_K, N - 1):
        raise ValueError(f"knn_block_tables: k must be in [1, min({MAX_K}, N - 1)], got {k}")
    if positions.device.type == "cpu":
        return knn_block_tables_reference(positions, box, cutbuf, k)
    if positions.device.type != "cuda":
        raise ValueError(f"knn_block_tables: unsupported device {positions.device}")
    if positions.dtype != torch.float32:
        raise ValueError(f"knn_block_tables: positions must be float32, got {positions.dtype}")
    pos = positions.contiguous()
    dev = pos.device
    topd = torch.empty((B, k, N), dtype=torch.float32, device=dev)
    topi = torch.empty((B, k, N), dtype=torch.int32, device=dev)
    if B == 0:
        return topd, topi
    lx, ly, lz = (float(x) for x in box)
    lib = build.library()
    knn_block_tables.launches += 1
    build.check(
        lib.cmdlmc_knn_tables(pos.data_ptr(), B, N, int(k), lx, ly, lz,
                              float(np.float32(cutbuf)), topd.data_ptr(),
                              topi.data_ptr(), build.stream_of(pos),
                              dev.index or 0),
        "knn_tables kernel",
    )
    return topd, topi


knn_block_tables.launches = 0
