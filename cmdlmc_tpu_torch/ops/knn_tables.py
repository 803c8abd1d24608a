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

Where the box holds at least 3 cells a side (:func:`cell_grid`, from the
shapes alone), the kernel scans each site's 27 neighbouring cells only,
over cell lists that :func:`cell_lists` builds on the tensors' device;
:func:`knn_cell_tables_reference` is that search written plainly, which the
tests hold equal to :func:`knn_block_tables_reference` bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from cmdlmc_tpu_torch.core.cell import sqrt32
from cmdlmc_tpu_torch.ops import build

BIG = 1.0e6  # distance of an exhausted slot
MAX_K = 16  # the largest k: K5's register list, K4's candidate width
# bytes of the [chunk, N, N] float32 distances per step of a plain build
PLAIN_CHUNK_BYTES = 1 << 28
# The cell route bins exactly while every position lies within BIN_RANGE box
# lengths of the origin: a minimum image computed in float32 there is off by
# at most 2^-14 box lengths, under the cells' margin of 2^-12 (CELL_MARGIN)
# of the box length over cutoff + buffer. A frame past it is scanned in full.
BIN_RANGE = 256.0
CELL_MARGIN = 2.0 ** -12
# With no cutoff a cell is CELL_WIDTH_K times the radius of the sphere that
# holds k sites on average, and a column keeps its 27 cells' result when its
# k-th distance lies below the distance to its block of cells' nearest face
# less VERIFY_MARGIN of the box length (twice the float error above, and
# more) and 2^-18 of that distance.
CELL_WIDTH_K = 1.5
VERIFY_MARGIN = 2.0 ** -10
# the threads the full scan aims to give the card (132 SMs x 16 warps) by
# splitting each column's rows over 1, 2, 4 or 8 lanes
FULL_TARGET_THREADS = 132 * 16 * 32


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


def cell_dims(n: int, box, cutbuf: float, k: int) -> tuple:
    """The cells per axis of K5's cell grid for N = n sites in ``box``
    (three lengths): with a finite cutoff + buffer each cell at least
    cutbuf (1 + 2^-12) + 2^-12 L wide; with none, CELL_WIDTH_K times the
    radius that holds k sites on average."""
    lengths = [float(x) for x in box]
    cutbuf = float(cutbuf)
    if math.isfinite(cutbuf):
        return tuple(math.floor(L / (cutbuf * (1 + CELL_MARGIN) + CELL_MARGIN * L))
                     for L in lengths)
    rho = n / (lengths[0] * lengths[1] * lengths[2])
    width = CELL_WIDTH_K * (3.0 * k / (4.0 * math.pi * rho)) ** (1.0 / 3.0)
    return tuple(math.floor(L / width) for L in lengths)


def cell_grid(n: int, box, cutbuf: float, k: int):
    """The cell grid (nx, ny, nz) that K5's cell route scans (:func:`cell_dims`),
    or None for the full scan. The route needs 3 cells an axis (the 27 cells
    around a site are then distinct) and is taken where the rows a column
    scans in its 27 cells, counted per lane of its pencil's warps, are under
    half of N."""
    grid = cell_dims(n, box, cutbuf, k)
    if min(grid) < 3:
        return None
    nx, ny, nz = grid
    per_pencil = n / (nx * ny)
    lanes = 32 * math.ceil(per_pencil / 32)
    rows = 27.0 * n / (nx * ny * nz) * lanes / per_pencil
    return (nx, ny, nz) if 2.0 * rows < n else None


def cell_threads(blocks: int) -> int:
    """The cell route's block width for a grid of ``blocks`` (frames x
    pencils): one warp where the blocks fill the card eight times over,
    four where they do not (a single frame's 121 pencils at N=9216).
    ``chip_smoke.py`` times the cell kernel at 32 to 256 threads beside it
    (PERF.md)."""
    return 32 if blocks >= 8 * 132 else 128


def full_split(batch: int, n: int) -> int:
    """The full scan's lanes per column: 1, 2, 4 or 8, the fewest that give
    the card FULL_TARGET_THREADS threads."""
    split = 1
    while split < 8 and batch * n * split < FULL_TARGET_THREADS:
        split *= 2
    return split


class CellLists(NamedTuple):
    """Each frame's sites binned on a cell grid (:func:`cell_lists`)."""
    order: torch.Tensor  # [B, N] i64: site ids sorted by cell (a stable sort)
    scell: torch.Tensor  # [B, N] i32: the cell of each sorted site
    start: torch.Tensor  # [B, C + 1] i32: first sorted index of each cell
    bad: torch.Tensor    # [B] i32: 1 where a frame's positions pass BIN_RANGE
    thr: torch.Tensor | None  # [B, N] f32 by site: the verified search's bound
    cell: torch.Tensor | None  # [B, N, 3] i64: each site's cell per axis (CPU)


def cell_lists(positions: torch.Tensor, box, grid, verify: bool) -> CellLists:
    """Bin a block of frames [B, N, 3] on ``grid`` (nx, ny, nz) on their own
    device with no host wait: each site's wrapped position and cell in
    float64, cell id (cx ny + cy) nz + cz, the sites sorted by cell (a stable
    sort), a count per cell and its cumsum. ``verify`` adds ``thr``, the
    distance from each site to the nearest face of its 3 x 3 x 3 block of
    cells, times 1 - 2^-18, less VERIFY_MARGIN of the longest box length,
    rounded down to float32. On the card the per-site pass is
    ``csrc/knn_tables.cu::knn_bin_kernel`` (one launch, the same float64
    arithmetic; the count by integer atomics); the sort and the cumsum are
    torch's."""
    B, N, _ = positions.shape
    dev = positions.device
    nx, ny, nz = (int(x) for x in grid)
    reach = BIN_RANGE * min(float(x) for x in box)
    margin = VERIFY_MARGIN * max(float(x) for x in box)
    if positions.device.type == "cuda":
        pos = positions.to(torch.float32).contiguous()
        cid = torch.empty((B, N), dtype=torch.int32, device=dev)
        count = torch.zeros((B, nx * ny * nz + 1), dtype=torch.int32, device=dev)
        bad = torch.zeros(B, dtype=torch.int32, device=dev)
        thr = torch.empty((B, N), dtype=torch.float32, device=dev) if verify else None
        build.check(build.library().cmdlmc_knn_bin(
            pos.data_ptr(), B, N, *(float(x) for x in box), nx, ny, nz, reach, margin,
            cid.data_ptr(), count.data_ptr(), bad.data_ptr(),
            None if thr is None else thr.data_ptr(), build.stream_of(pos),
            dev.index or 0), "knn_tables binning")
        scell, order = torch.sort(cid, dim=1, stable=True)
        return CellLists(order, scell, torch.cumsum(count, dim=1, dtype=torch.int32), bad,
                         thr, None)
    f64 = torch.float64
    L = torch.tensor([float(x) for x in box], dtype=f64, device=dev)
    g = torch.tensor([float(x) for x in grid], dtype=f64, device=dev)
    p = positions.to(f64)
    u = p - L * torch.floor(p / L)  # wrapped into [0, L]
    c = torch.nan_to_num(torch.floor(u * (g / L)), nan=0.0)
    c = torch.minimum(torch.clamp(c, min=0.0), g - 1)
    cell = c.to(torch.int64)
    cid = (cell[..., 0] * ny + cell[..., 1]) * nz + cell[..., 2]
    scell, order = torch.sort(cid, dim=1, stable=True)
    start = torch.zeros((B, nx * ny * nz + 1), dtype=torch.int32, device=dev)
    start[:, 1:].scatter_add_(1, cid, torch.ones_like(cid, dtype=torch.int32))
    start = torch.cumsum(start, dim=1, dtype=torch.int32)
    bad = (~(positions.to(torch.float32).abs() <= reach).all(dim=2).all(dim=1)).to(torch.int32)
    thr = None
    if verify:
        w = L / g
        face = torch.minimum(u - (c - 1) * w, (c + 2) * w - u).amin(dim=2)
        bound = face * (1.0 - 2.0 ** -18) - margin
        thr = bound.to(torch.float32)
        thr = torch.where(thr.to(f64) > bound,
                          torch.nextafter(thr, torch.tensor(-math.inf, device=dev)), thr)
    return CellLists(order, scell.to(torch.int32), start, bad, thr, cell)


def knn_cell_tables_reference(positions: torch.Tensor, box, cutbuf: float, k: int,
                              grid):
    """The cell route written plainly, [B, k, N] like
    :func:`knn_block_tables_reference`: each column's candidates are the
    rows in the 27 cells around its own (:func:`cell_lists` on ``grid``),
    every frame's in full where its ``bad`` is 1; with no cutoff a column
    keeps that result only if its k-th distance lies below its ``thr``, and
    takes every row otherwise. The distances and the selection (k passes of
    min and first-lowest argmin, i.e. the (distance, index) order) are the
    plain version's, so the tables must equal it bit for bit."""
    B, N, _ = positions.shape
    dev = positions.device
    verify = not math.isfinite(float(cutbuf))
    cl = cell_lists(positions, box, grid, verify)
    g = torch.tensor([int(x) for x in grid], device=dev)
    box_t = torch.tensor([float(x) for x in box], dtype=torch.float32, device=dev)
    rc = torch.tensor(np.float32(cutbuf), device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    rows = torch.arange(N, device=dev)
    eye = torch.eye(N, dtype=torch.bool, device=dev)
    # the cell steps row - column per axis, circular: -1, 0 or 1 are neighbours
    step = (cl.cell[:, :, None, :] - cl.cell[:, None, :, :]) % g  # [B, i, j, 3]
    near = ((step <= 1) | (step == g - 1)).all(dim=3) | (cl.bad != 0)[:, None, None]
    pos = positions.to(torch.float32)
    delta = pos[:, :, None, :] - pos[:, None, :, :]  # [b, i, j, 3]
    delta = delta - box_t * torch.round(delta / box_t)
    sq = delta * delta
    d = sqrt32((sq[..., 0] + sq[..., 1]) + sq[..., 2])
    d = torch.where(eye, inf, d)
    d = torch.where(d <= rc, d, inf)

    def select(dist):
        topd = torch.empty((B, k, N), dtype=torch.float32, device=dev)
        topi = torch.empty((B, k, N), dtype=torch.int32, device=dev)
        for s in range(k):
            m = dist.min(dim=1).values  # [b, j]
            idx = torch.where(dist == m[:, None, :], rows[:, None], N).min(dim=1).values
            topd[:, s] = m
            topi[:, s] = idx.to(torch.int32)
            dist = torch.where(rows[:, None] == idx[:, None, :], inf, dist)
        return topd, topi

    topd, topi = select(torch.where(near, d, inf))
    if verify:
        keep = (topd[:, k - 1] < cl.thr) & (cl.bad == 0)[:, None]
        full_d, full_i = select(d)
        topd = torch.where(keep[:, None], topd, full_d)
        topi = torch.where(keep[:, None], topi, full_i)
    return torch.where(topd == inf, BIG, topd), torch.where(topd == inf, 0, topi)


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
    grid = cell_grid(N, box, cutbuf, k)
    cl, nx, ny, nz, threads = None, 0, 0, 0, 32
    if grid is not None:
        cl = cell_lists(pos, box, grid, not math.isfinite(float(cutbuf)))
        nx, ny, nz = grid
        threads = cell_threads(B * nx * ny)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = build.library()
    knn_block_tables.launches += 1
    build.check(
        lib.cmdlmc_knn_tables(pos.data_ptr(), B, N, int(k), lx, ly, lz,
                              float(np.float32(cutbuf)),
                              *(ptr(getattr(cl, f, None)) for f in
                                ("order", "scell", "start", "thr", "bad")),
                              nx, ny, nz, threads, full_split(B, N),
                              topd.data_ptr(), topi.data_ptr(),
                              build.stream_of(pos), dev.index or 0),
        "knn_tables kernel",
    )
    return topd, topi


knn_block_tables.launches = 0
