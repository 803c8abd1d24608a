"""Spatially sparse K-nearest tables: the plans, kernel K6 and its plain version.

Port of ``cmdlmc_tpu/ops/knn_sparse.py``. At supercell N a site's k nearest
neighbors within cutoff + buffer lie a few Å away in a box tens of Å wide,
so most of the all-to-all distances of K5's full scan are wasted. A plan
sorts the sites spatially, cuts the sorted order into row chunks of ``rc``
and column tiles of ``tc`` sites, and keeps for each tile the chunks that a
periodic bounding-box bound, widened by every site's drift over the block,
lets hold a pair within cutoff + buffer. The CUDA kernel
``csrc/knn_sparse.cu`` (K6) serves tensors on the card,
:func:`knn_sparse_tables_reference` tensors on the CPU; both give the
[B, k, N] tables in the original site order, equal to K5's bit for bit
(pairs a plan leaves out lie beyond cutoff + buffer, which K5 masks).

Two plans, one :class:`SparsePlan`:

* :func:`device_plan`, the one the port runs: built on the positions' own
  device with no host wait (on the card one call of ``csrc/knn_sparse.cu``'s
  six small plan kernels, a stable sort by bin column and rank among them;
  :func:`device_plan_reference` is its plain version, with the same
  integers). Sites sort along a
  serpentine through frame 0's bin columns (K5's cells, at least cutoff +
  buffer wide, in x and y), so that a tile of 32 or a chunk of 16
  consecutive sites is a short pencil with no jump across the box; the kept
  chunks of each tile are listed in ascending order with
  their count (``count``). The bound is widened by a margin for float error
  (as K5's cells are), and a block whose positions leave the range that
  margin covers keeps every chunk.
* the host plan copied from the JAX package (``SparsePlan(*plan_sparse(...),
  rc, tc)`` with numpy arrays: bin-major x order), which the tests use to
  hold the plain version against the JAX kernel over the JAX package's own
  plan.

Where the tables take K6 is a rule of the shapes alone (:func:`sparse_route`):
no plan is fetched to decide it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from cmdlmc_tpu_torch.core.cell import sqrt32
from cmdlmc_tpu_torch.ops import build
from cmdlmc_tpu_torch.utils import trace
from cmdlmc_tpu_torch.ops.knn_tables import (
    BIG, BIN_RANGE, CELL_MARGIN, MAX_K, PLAIN_CHUNK_BYTES, cell_dims,
)

# The host plan's chunk and tile (``plan_sparse``'s defaults).
RC = 64
TC = 128
# The device plan's row chunk and column tile: a tile is one warp of K6's
# columns, a chunk one staging of its rows; smaller chunks prune finer
# (PERF.md gives the kept share of the pairs at the box x4 supercell).
PLAN_RC, PLAN_TC = 16, 32
# The device plan's sort: bins of width cutoff + buffer in x and y, at most
# PLAN_MAX_BINS an axis (the card's column sort runs one block over them),
# and PLAN_Z_STEPS steps in z (the key fits int32).
PLAN_MAX_BINS = 256
PLAN_Z_STEPS = 1024

# The port's route (sparse_route), measured on the H100 by chip_smoke.py's
# route sweep (K6 with its plan against K5 per call, for one frame and for
# 64, at bench.py's density; PERF.md): K5 won from 162 sites (the first with
# 3 bins) to 576, where it runs its full scan in one launch, and K6 at every
# N from 864 to 9216. With fewer than 3 bins an axis every tile's box
# reaches every chunk's.
SPARSE_MIN_N = 864
SPARSE_MIN_BINS = 3

# K6's warps per 32 columns (1, 2, 4 or 8): the fewest that give the card
# this many warps (132 SMs x 16).
SPLIT_TARGET_WARPS = 132 * 16


def plan_bins(box, cutbuf: float) -> tuple:
    """The device plan's bins per axis: K5's cells of width cutoff + buffer
    and a margin (``knn_tables.cell_dims``), 1 to PLAN_MAX_BINS."""
    return tuple(min(max(g, 1), PLAN_MAX_BINS) for g in cell_dims(1, box, cutbuf, 1))


def sparse_route(n: int, box, cutbuf: float) -> bool:
    """Whether an orthorhombic block of ``n`` sites takes K6 over a device
    plan (else K5): from SPARSE_MIN_N sites on, with a finite cutoff +
    buffer and at least SPARSE_MIN_BINS bins of that width an axis (fewer,
    and every tile's box reaches every chunk's). The shapes alone decide."""
    cutbuf = float(cutbuf)
    return (n >= SPARSE_MIN_N and math.isfinite(cutbuf)
            and min(plan_bins(box, cutbuf)) >= SPARSE_MIN_BINS)


@functools.lru_cache(maxsize=64)
def _plan_constants(box: tuple, cutbuf: float) -> tuple:
    """(bins in x, bins in y, BIN_RANGE box lengths, plan_cut2) for the card's
    plan builder, once per box and cutoff."""
    gx, gy, _ = plan_bins(box, cutbuf)
    return gx, gy, BIN_RANGE * min(box), plan_cut2(box, cutbuf)


def plan_cut2(box, cutbuf: float) -> float:
    """The squared reach of the device plan's box test, rounded up to
    float32: cutoff + buffer widened by 2^-12 of itself and of the longest
    box length (CELL_MARGIN, which covers the float error of the wrapped
    coordinates and of K5's minimum image within BIN_RANGE box lengths)."""
    reach = float(cutbuf) * (1 + CELL_MARGIN) + CELL_MARGIN * max(float(x) for x in box)
    cut2 = np.float32(reach * reach)
    if float(cut2) < reach * reach:
        cut2 = np.nextafter(cut2, np.float32(np.inf))
    return float(cut2)


class SparsePlan:
    """A spatial plan, ready to feed :func:`knn_sparse_tables`: ``perm``
    (sorted position -> site id), ``inv`` (its inverse), ``lists`` (each
    tile's kept chunks, padded with ``n_ch``). The host plan (a copy of
    ``cmdlmc_tpu/ops/knn_sparse.py::SparsePlan``) holds numpy arrays and no
    ``count``; :func:`device_plan`'s holds int32 tensors on the positions'
    device, lists [n_tiles, n_ch] and ``count`` [n_tiles], the kept chunks
    of each tile."""

    __slots__ = ("perm", "inv", "lists", "n_ch", "rc", "tc", "count")

    def __init__(self, perm, inv, lists, n_ch, rc, tc, count=None):
        self.perm, self.inv, self.lists = perm, inv, lists
        self.n_ch, self.rc, self.tc = n_ch, rc, tc
        self.count = count

    @property
    def ratio(self) -> float:
        return self.lists.shape[1] / self.n_ch


def _serpentine(cell: torch.Tensor, gy: int) -> torch.Tensor:
    """csrc/knn_sparse.cu::serpentine_key of bins [..., 3] (int64): rows of
    bin columns (cx, cy) in x-major order, y reversed on odd x, the z step
    reversed on odd rows."""
    cx, cy, cz = cell.unbind(-1)
    row = cx * gy + torch.where(cx % 2 == 1, gy - 1 - cy, cy)
    return row * PLAN_Z_STEPS + torch.where(row % 2 == 1, PLAN_Z_STEPS - 1 - cz, cz)


def device_plan_reference(positions: torch.Tensor, box, cutbuf: float,
                          rc: int = PLAN_RC, tc: int = PLAN_TC) -> SparsePlan:
    """Plain version of :func:`device_plan`, the same integers: frame 0's
    serpentine keys over :func:`plan_bins` in x and y and PLAN_Z_STEPS in z
    (the float64 binning of ``knn_tables.cell_lists``), torch's stable sort,
    each site's box
    (w - drift, w + drift) with w = p - L floor(p / L) of frame 0 in float32
    and drift its largest |p_f - p_0| over the block, each chunk's and tile's
    center (lo + hi) / 2 and half-width (hi - lo) / 2, and per tile the
    chunks whose periodic gap g (per axis max((min(d, L - d) - half_c) -
    half_t, 0)) has (g_x^2 + g_y^2) + g_z^2 <= :func:`plan_cut2`; every chunk
    where a coordinate is past BIN_RANGE box lengths or not finite."""
    pos = positions.to(torch.float32)
    B, N, _ = pos.shape
    dev = pos.device
    L = torch.tensor([float(x) for x in box], dtype=torch.float32, device=dev)
    L64 = torch.tensor([float(x) for x in box], dtype=torch.float64, device=dev)
    bins = plan_bins(box, cutbuf)
    g = torch.tensor([bins[0], bins[1], PLAN_Z_STEPS], dtype=torch.float64, device=dev)
    p0 = pos[0]
    x = p0.to(torch.float64)
    u = x - L64 * torch.floor(x / L64)
    c = torch.nan_to_num(torch.floor(u * (g / L64)), nan=0.0)
    cell = torch.minimum(torch.clamp(c, min=0.0), g - 1).to(torch.int64)
    order = torch.sort(_serpentine(cell, bins[1]), stable=True).indices
    w = p0 - torch.floor(p0 / L) * L
    drift = (pos - p0).abs().amax(dim=0)
    lo, hi = (w - drift)[order], (w + drift)[order]
    n_ch, n_ct = -(-N // rc), -(-N // tc)

    def boxes(step, count):
        pad = count * step - N
        blo = torch.cat([lo, lo.new_full((pad, 3), math.inf)]).reshape(count, step, 3)
        bhi = torch.cat([hi, hi.new_full((pad, 3), -math.inf)]).reshape(count, step, 3)
        blo, bhi = blo.amin(dim=1), bhi.amax(dim=1)
        return (blo + bhi) * 0.5, (bhi - blo) * 0.5

    ch_c, ch_h = boxes(rc, n_ch)
    ct_c, ct_h = boxes(tc, n_ct)
    d = (ct_c[:, None] - ch_c[None]).abs()  # [n_ct, n_ch, 3]
    d = torch.minimum(d, L - d)
    gap = torch.clamp((d - ch_h[None]) - ct_h[:, None], min=0.0)
    acc = gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]
    acc = acc + gap[..., 2] * gap[..., 2]
    keep = acc <= plan_cut2(box, cutbuf)
    if not bool((pos.abs() <= BIN_RANGE * float(L.min())).all()):
        keep = torch.ones_like(keep)
    chunks = torch.arange(n_ch, device=dev).expand(n_ct, n_ch)
    lists = torch.where(keep, chunks, n_ch).sort(dim=1).values.to(torch.int32)
    inv = torch.empty(N, dtype=torch.int64, device=dev)
    inv[order] = torch.arange(N, device=dev)
    return SparsePlan(order.to(torch.int32), inv.to(torch.int32), lists, n_ch, rc, tc,
                      keep.sum(dim=1).to(torch.int32))


def device_plan(positions: torch.Tensor, box, cutbuf: float, rc: int = PLAN_RC,
                tc: int = PLAN_TC) -> SparsePlan:
    """The spatial plan of a block of frames [B, N, 3] in an orthorhombic box
    (three floats) on the positions' own device, with no host wait: on the
    card one call of ``csrc/knn_sparse.cu``'s plan kernels (the keys, a
    stable sort by bin column and rank, the boxes, the lists); on the CPU
    :func:`device_plan_reference`. Its tables over any frame of the block
    keep every pair within ``cutbuf``."""
    if positions.dim() != 3 or positions.shape[-1] != 3 or positions.shape[0] < 1:
        raise ValueError(f"device_plan: positions must be [B >= 1, N, 3], "
                         f"got {tuple(positions.shape)}")
    if positions.device.type == "cpu":
        return device_plan_reference(positions, box, cutbuf, rc, tc)
    if positions.device.type != "cuda":
        raise ValueError(f"device_plan: unsupported device {positions.device}")
    pos = positions.to(torch.float32).contiguous()
    B, N, _ = pos.shape
    dev = pos.device
    box = tuple(float(x) for x in box)
    gx, gy, reach, cut2 = _plan_constants(box, float(cutbuf))
    n_ch, n_ct = -(-N // rc), -(-N // tc)
    # perm, inv, count, lists, then the kernels' scratch (int32); the sites',
    # chunks' and tiles' boxes (float32)
    ints = torch.empty(4 * N + n_ct * (n_ch + 1) + 2 * gx * gy + 2, dtype=torch.int32,
                       device=dev)
    floats = torch.empty(6 * (N + n_ch + n_ct), dtype=torch.float32, device=dev)
    perm, inv, count = ints[:N], ints[N:2 * N], ints[2 * N:2 * N + n_ct]
    lists = ints[2 * N + n_ct:2 * N + n_ct * (n_ch + 1)].view(n_ct, n_ch)
    device_plan.launches += 1
    build.check(build.library().cmdlmc_sparse_plan(
        pos.data_ptr(), B, N, *box, gx, gy, reach, rc, tc, cut2, perm.data_ptr(),
        inv.data_ptr(), count.data_ptr(), lists.data_ptr(),
        ints.data_ptr() + 4 * (2 * N + n_ct * (n_ch + 1)), floats.data_ptr(),
        build.stream_of(pos), dev.index or 0), "sparse plan")
    return SparsePlan(perm, inv, lists, n_ch, rc, tc, count)


device_plan.launches = 0


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


def _host_lists(plan: SparsePlan):
    """The plan's lists as a numpy array (a copy from the device for a
    device plan: the plain version and reports only)."""
    lists = plan.lists
    return lists.cpu().numpy() if isinstance(lists, torch.Tensor) else np.asarray(lists)


def knn_sparse_tables_reference(positions: torch.Tensor, box, cutbuf: float,
                                k: int, plan: SparsePlan):
    """Plain version of K6: positions [B, N, 3], the three box lengths,
    cutoff + buffer (float32 value) and either plan -> (topd f32, topi i32),
    each [B, k, N] in the original site order. Per column tile, the
    distances to the rows of its kept chunks as K5's plain version computes
    them, self and d > cutbuf masked, then k passes of min and lowest site
    id among equal distances; exhausted slots hold (1e6, 0)."""
    B, N, _ = positions.shape
    dev = positions.device
    box_t = torch.tensor([float(x) for x in box], dtype=torch.float32, device=dev)
    rc = torch.tensor(np.float32(cutbuf), device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    perm = torch.as_tensor(plan.perm).to(dev, torch.int64)
    lists = _host_lists(plan)
    topd = torch.full((B, k, N), BIG, dtype=torch.float32, device=dev)
    topi = torch.zeros((B, k, N), dtype=torch.int32, device=dev)
    for t in range(lists.shape[0]):
        cols = perm[t * plan.tc:(t + 1) * plan.tc]  # site ids
        kept = [int(c) for c in lists[t] if c < plan.n_ch]
        if not kept:
            continue
        rows = torch.cat([perm[c * plan.rc:(c + 1) * plan.rc] for c in kept])
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


def _plan_tensors(plan: SparsePlan, dev):
    """(perm, lists, count) as contiguous int32 tensors on ``dev``: a device
    plan's as they are, a host plan's uploaded with each tile's count of
    real entries."""
    if plan.count is None:
        lists = np.ascontiguousarray(plan.lists, np.int32)
        count = (lists < plan.n_ch).sum(axis=1).astype(np.int32)
        return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                     for a in (plan.perm, lists, count))
    return tuple(t.to(dev, torch.int32).contiguous()
                 for t in (plan.perm, plan.lists, plan.count))


def sparse_splits(batch: int, column_warps: int) -> int:
    """K6's warps per 32 columns of a tile: 1, 2, 4 or 8, the fewest that
    give the card SPLIT_TARGET_WARPS warps."""
    splits = 1
    while splits < 8 and batch * column_warps * splits < SPLIT_TARGET_WARPS:
        splits *= 2
    return splits


def knn_sparse_tables(positions: torch.Tensor, box, cutbuf: float, k: int,
                      plan: SparsePlan | None = None):
    """K-nearest tables [B, k, N] (distances f32, indices i32) of a block of
    donor positions [B, N, 3] in an orthorhombic box (three floats) over a
    plan built from that block (by default :func:`device_plan`, built
    here): K6 for CUDA tensors, the plain version for CPU tensors."""
    if positions.dim() != 3 or positions.shape[-1] != 3:
        raise ValueError(f"knn_sparse_tables: positions must be [B, N, 3], "
                         f"got {tuple(positions.shape)}")
    B, N, _ = positions.shape
    if not 1 <= k <= min(MAX_K, N - 1):
        raise ValueError(f"knn_sparse_tables: k must be in [1, min({MAX_K}, N - 1)], got {k}")
    if plan is None:
        if B == 0:
            return (torch.empty((0, k, N), dtype=torch.float32, device=positions.device),
                    torch.empty((0, k, N), dtype=torch.int32, device=positions.device))
        with trace.span("kmc.stage1.plan"):
            plan = device_plan(positions, box, cutbuf)
    if len(plan.perm) != N:
        raise ValueError(f"knn_sparse_tables: the plan is for {len(plan.perm)} sites, "
                         f"the positions hold {N}")
    if positions.device.type == "cpu":
        return knn_sparse_tables_reference(positions, box, cutbuf, k, plan)
    if positions.device.type != "cuda":
        raise ValueError(f"knn_sparse_tables: unsupported device {positions.device}")
    if positions.dtype != torch.float32:
        raise ValueError(f"knn_sparse_tables: positions must be float32, got {positions.dtype}")
    if plan.tc % 32 or not 32 <= plan.tc <= 1024:
        raise ValueError(f"knn_sparse_tables: K6 takes tiles of 32 to 1024 columns in "
                         f"whole warps, got {plan.tc}")
    pos = positions.contiguous()
    dev = pos.device
    topd = torch.empty((B, k, N), dtype=torch.float32, device=dev)
    topi = torch.empty((B, k, N), dtype=torch.int32, device=dev)
    if B == 0:
        return topd, topi
    perm, lists, count = _plan_tensors(plan, dev)
    n_ct, width = lists.shape
    lx, ly, lz = (float(x) for x in box)
    lib = build.library()
    knn_sparse_tables.launches += 1
    build.check(
        lib.cmdlmc_knn_sparse(pos.data_ptr(), B, N, int(k), lx, ly, lz,
                              float(np.float32(cutbuf)), perm.data_ptr(),
                              lists.data_ptr(), count.data_ptr(), int(width),
                              int(plan.n_ch), int(n_ct), int(plan.rc), int(plan.tc),
                              sparse_splits(B, n_ct * (plan.tc // 32)),
                              topd.data_ptr(), topi.data_ptr(),
                              build.stream_of(pos), dev.index or 0),
        "knn_sparse kernel",
    )
    return topd, topi


knn_sparse_tables.launches = 0
