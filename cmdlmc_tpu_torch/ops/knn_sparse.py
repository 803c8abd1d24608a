"""Spatially sparse K-nearest tables: the host plan, kernel K6 and its plain version.

Port of ``cmdlmc_tpu/ops/knn_sparse.py``. At supercell N a site's k nearest
neighbors within cutoff + buffer lie a few Å away in a box tens of Å wide,
so most of the all-to-all distances of K5 (``ops/knn_tables.py``) are wasted.
The host plan (numpy, copied from the JAX package: ``SparsePlan``,
``sparse_plan_for``, ``plan_sparse``) sorts the sites by spatial bin (bin
edge >= cutoff + buffer), cuts the sorted order into row chunks of ``rc``
and column tiles of ``tc`` sites, and keeps for each tile the chunks that a
periodic bounding-box bound, widened by every site's drift over the block,
lets hold a pair within cutoff + buffer. The CUDA kernel
``csrc/knn_sparse.cu`` (K6) serves tensors on the card,
:func:`knn_sparse_tables_reference` tensors on the CPU; both give the
[B, k, N] tables in the original site order, equal to K5's bit for bit
(pairs the plan leaves out lie beyond cutoff + buffer, which K5 masks).

Chunk and tile sizes: the JAX package's 512 and 512 fill the TPU's lanes. On
the card a tile is a thread block (one thread per column) and a chunk one
staging of shared memory, so both are cut to the card: TC = 128 columns
(four warps; at N=9216 a frame has 72 tiles, so a block of frames fills
every SM many times over, while a Verlet rebuild's one frame fills 72 of
the H100's 132) and RC = 64 rows, since smaller chunks prune finer (PERF.md
gives the share of the pairs the plan keeps at the box x4 supercell). The
results do not depend on either.
"""

from __future__ import annotations

import numpy as np
import torch

from cmdlmc_tpu_torch.core.cell import sqrt32
from cmdlmc_tpu_torch.ops import build
from cmdlmc_tpu_torch.ops.knn_tables import BIG, MAX_K, PLAIN_CHUNK_BYTES

RC = 64  # row chunk (sorted sites), one shared-memory staging of K6
TC = 128  # column tile (sorted sites), one thread block of K6

# The JAX package's dispatch gate (cmdlmc_tpu/ops/knn_sparse.py:55-56): the
# plan is taken from this many sites on, when it keeps at most this share
# of the chunks.
SPARSE_MIN_N = 6144
SPARSE_MAX_RATIO = 0.75


class SparsePlan:
    """Host-side spatial plan, ready to feed :func:`knn_sparse_tables`
    (a copy of ``cmdlmc_tpu/ops/knn_sparse.py::SparsePlan``)."""

    __slots__ = ("perm", "inv", "lists", "n_ch", "rc", "tc")

    def __init__(self, perm, inv, lists, n_ch, rc, tc):
        self.perm, self.inv, self.lists = perm, inv, lists
        self.n_ch, self.rc, self.tc = n_ch, rc, tc

    @property
    def ratio(self) -> float:
        return self.lists.shape[1] / self.n_ch


def sparse_plan_for(positions_block, lengths, rcut, *,
                    min_n: int = SPARSE_MIN_N,
                    max_ratio: float = SPARSE_MAX_RATIO,
                    rc: int = RC, tc: int = TC):
    """A :class:`SparsePlan` when chunk pruning pays, else None (the caller
    takes K5). Fetches ``positions_block`` to the host (one block-sized
    copy) only from ``min_n`` sites on."""
    n = positions_block.shape[1]
    if n < min_n:
        return None
    if isinstance(positions_block, torch.Tensor):
        positions_block = positions_block.detach().cpu().numpy()
    pos = np.asarray(positions_block, np.float32)
    perm, inv, lists, n_ch = plan_sparse(
        pos, np.asarray(lengths, np.float32), float(rcut), rc=rc, tc=tc
    )
    plan = SparsePlan(perm, inv, lists, n_ch, rc, tc)
    return plan if plan.ratio <= max_ratio else None


def plan_sparse(positions_block, lengths, rcut, rc: int = RC, tc: int = TC):
    """Host-side spatial plan for a block of frames (a copy of
    ``cmdlmc_tpu/ops/knn_sparse.py::plan_sparse``).

    Returns ``(perm, inv, lists, n_chunks)``: the bin-sort permutation, its
    inverse, and the per-column-tile active row-chunk lists (i32
    [n_col_tiles, maxa], padded with ``n_chunks``).
    The bound covers every frame: chunk/tile bounding boxes are widened by
    each site's maximum drift from frame 0, so one plan serves the block.
    """
    pos = np.asarray(positions_block, np.float32)
    L = np.asarray(lengths, np.float32).reshape(3)
    rcut = float(rcut)
    B, N, _ = pos.shape
    p0 = pos[0]
    w0 = p0 - np.floor(p0 / L) * L  # wrapped frame-0 coordinates
    nbin = np.maximum((L / max(rcut, 1e-6)).astype(np.int64), 1)
    width = L / nbin
    bc = np.clip((w0 / width).astype(np.int64), 0, nbin - 1)
    bid = (bc[:, 0] * nbin[1] + bc[:, 1]) * nbin[2] + bc[:, 2]
    perm = np.argsort(bid, kind="stable").astype(np.int32)
    inv = np.argsort(perm).astype(np.int32)

    drift = np.abs(pos - p0[None]).max(axis=0) if B > 1 else np.zeros_like(p0)
    wp, dp = w0[perm], drift[perm]
    n_ch = -(-N // rc)
    n_ct = -(-N // tc)

    def boxes(step, count):
        lo = np.empty((count, 3), np.float32)
        hi = np.empty((count, 3), np.float32)
        for i in range(count):
            s = slice(i * step, min((i + 1) * step, N))
            lo[i] = (wp[s] - dp[s]).min(axis=0)
            hi[i] = (wp[s] + dp[s]).max(axis=0)
        return (lo + hi) / 2, (hi - lo) / 2

    rc_c, rc_h = boxes(rc, n_ch)
    ct_c, ct_h = boxes(tc, n_ct)
    d = np.abs(ct_c[:, None, :] - rc_c[None, :, :])  # [n_ct, n_ch, 3]
    d = np.minimum(d, L - d)  # periodic center distance (conservative)
    gap = np.maximum(d - rc_h[None] - ct_h[:, None], 0.0)
    active = (gap * gap).sum(-1) <= rcut * rcut
    maxa = int(active.sum(1).max())
    # the list width in multiples of 4, as the JAX package buckets it (for
    # its jit specializations); the gate reads this width
    maxa = min(n_ch, -(-maxa // 4) * 4)
    lists = np.full((n_ct, maxa), n_ch, np.int32)
    for j in range(n_ct):
        idx = np.nonzero(active[j])[0][:maxa]
        lists[j, : len(idx)] = idx
    return perm, inv, lists, n_ch


def knn_sparse_tables_reference(positions: torch.Tensor, box, cutbuf: float,
                                k: int, plan: SparsePlan):
    """Plain version of K6: positions [B, N, 3], the three box lengths,
    cutoff + buffer (float32 value) and the plan -> (topd f32, topi i32),
    each [B, k, N] in the original site order. Per column tile, the
    distances to the rows of its kept chunks as K5's plain version computes
    them, self and d > cutbuf masked, then k passes of min and lowest site
    id among equal distances; exhausted slots hold (1e6, 0)."""
    B, N, _ = positions.shape
    dev = positions.device
    box_t = torch.tensor([float(x) for x in box], dtype=torch.float32, device=dev)
    rc = torch.tensor(np.float32(cutbuf), device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    perm = torch.from_numpy(plan.perm.astype(np.int64)).to(dev)
    topd = torch.full((B, k, N), BIG, dtype=torch.float32, device=dev)
    topi = torch.zeros((B, k, N), dtype=torch.int32, device=dev)
    for t in range(plan.lists.shape[0]):
        cols = perm[t * plan.tc:(t + 1) * plan.tc]  # site ids
        rows = torch.cat([perm[int(c) * plan.rc:(int(c) + 1) * plan.rc]
                          for c in plan.lists[t] if c < plan.n_ch])
        chunk = max(1, PLAIN_CHUNK_BYTES // max(4 * len(rows) * len(cols), 1))
        for b0 in range(0, B, chunk):
            pos = positions[b0:b0 + chunk]
            delta = pos[:, rows, None, :] - pos[:, None, cols, :]  # [b, r, c, 3]
            delta = delta - box_t * torch.round(delta / box_t)
            sq = delta * delta
            d = sqrt32((sq[..., 0] + sq[..., 1]) + sq[..., 2])
            d = torch.where(rows[:, None] == cols[None, :], inf, d)
            d = torch.where(d <= rc, d, inf)
            for s in range(k):
                m = d.min(dim=1).values  # [b, c]
                idx = torch.where(d == m[:, None, :], rows[:, None], N).min(dim=1).values
                hit = m < inf
                topd[b0:b0 + chunk, s, cols] = torch.where(hit, m, BIG)
                topi[b0:b0 + chunk, s, cols] = torch.where(hit, idx, 0).to(torch.int32)
                d = torch.where(rows[:, None] == idx[:, None, :], inf, d)
    return topd, topi


def knn_sparse_tables(positions: torch.Tensor, box, cutbuf: float, k: int,
                      plan: SparsePlan):
    """K-nearest tables [B, k, N] (distances f32, indices i32) of a block of
    donor positions [B, N, 3] in an orthorhombic box (three floats) over a
    plan built from that block: K6 for CUDA tensors, the plain version for
    CPU tensors."""
    if positions.dim() != 3 or positions.shape[-1] != 3:
        raise ValueError(f"knn_sparse_tables: positions must be [B, N, 3], "
                         f"got {tuple(positions.shape)}")
    B, N, _ = positions.shape
    if not 1 <= k <= min(MAX_K, N - 1):
        raise ValueError(f"knn_sparse_tables: k must be in [1, min({MAX_K}, N - 1)], got {k}")
    if len(plan.perm) != N:
        raise ValueError(f"knn_sparse_tables: the plan is for {len(plan.perm)} sites, "
                         f"the positions hold {N}")
    if positions.device.type == "cpu":
        return knn_sparse_tables_reference(positions, box, cutbuf, k, plan)
    if positions.device.type != "cuda":
        raise ValueError(f"knn_sparse_tables: unsupported device {positions.device}")
    if positions.dtype != torch.float32:
        raise ValueError(f"knn_sparse_tables: positions must be float32, got {positions.dtype}")
    pos = positions.contiguous()
    dev = pos.device
    topd = torch.empty((B, k, N), dtype=torch.float32, device=dev)
    topi = torch.empty((B, k, N), dtype=torch.int32, device=dev)
    if B == 0:
        return topd, topi
    perm = torch.from_numpy(np.ascontiguousarray(plan.perm, np.int32)).to(dev)
    lists = torch.from_numpy(np.ascontiguousarray(plan.lists, np.int32)).to(dev)
    n_ct, maxa = plan.lists.shape
    lx, ly, lz = (float(x) for x in box)
    lib = build.library()
    knn_sparse_tables.launches += 1
    build.check(
        lib.cmdlmc_knn_sparse(pos.data_ptr(), B, N, int(k), lx, ly, lz,
                              float(np.float32(cutbuf)), perm.data_ptr(),
                              lists.data_ptr(), int(n_ct), int(maxa),
                              int(plan.n_ch), int(plan.rc), int(plan.tc),
                              topd.data_ptr(), topi.data_ptr(),
                              build.stream_of(pos), dev.index or 0),
        "knn_sparse kernel",
    )
    return topd, topi


knn_sparse_tables.launches = 0
