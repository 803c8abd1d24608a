"""The yardstick of the rooflines: the H100's published peaks and the least
work of the event loops, counted from the inputs and the events fired.

Frozen copies of ``chip_smoke.py`` at commit 5a4702a, so later edits there
cannot move the yardstick: ``bound`` (:282-287), ``sweep_work``
(:290-317), ``sweep_bound`` (:320-336), ``stats_bound`` (:966-975),
``topk_changed`` (:2178-2193), ``_topk_terms`` (:2196-2203) and
``topk_bound`` (:2206-2218), with the constants they read (:209-217). Two
changes: ``bound`` also returns the operations and bytes it was given (so
the statistics' added work joins a sweep's, as ``chip_smoke.py:1128-1133``
counts it), and ``topk_changed`` counts the in-degrees with
``scatter_add_``.
"""

from __future__ import annotations

import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet, at its 700 W limit).
PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3
# operations per pair of building W from positions inside a kernel (K3):
# three minimum images, three squares, two adds, a square root, the cutoff
# test and the Fermi law
W_BUILD_OPS = 27


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations over
    the float32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "nbytes": nbytes}


def sweep_work(w, P) -> dict:
    """The terms the event loop's least work adds, estimated from the
    frames' W [B, N, N] and averaged over the frames (with binary occupancy
    a term is one add):
    - `pairs`: a whole rate evaluation, the occupied x vacant pairs with
      W != 0: each frame's count of W != 0 scaled by P (N - P) / (N (N - 1)),
      the share of ordered pairs that join an occupied to a vacant site;
    - `vacant`: the vacant entries of one row, c (N - P) / (N - 1) with c the
      frame's nonzeros per row (also the destination race's candidates);
    - `rows`: the rows one event sums again, the occupied share P / N of
      |C_s u C_d u {s, d}| (C_j: the rows with W[i][j] != 0) averaged over
      the moves s -> d with W[s][d] != 0."""
    n = w.shape[-1]
    m = (w != 0).to(torch.float32)
    col = m.sum(dim=1)  # [B, N]: |C_j|
    inter = m.transpose(1, 2) @ m  # [B, s, d]: |C_s n C_d|
    diag = torch.diagonal(m, dim1=1, dim2=2)  # W[j][j] != 0
    s_in = torch.clamp(diag[:, :, None] + m, max=1.0)  # s in C_s u C_d
    d_in = torch.clamp(m.transpose(1, 2) + diag[:, None, :], max=1.0)
    union = col[:, :, None] + col[:, None, :] - inter + (1 - s_in) + (1 - d_in)
    moves = m.sum(dim=(1, 2)).clamp(min=1)
    per_frame_union = (union * m).sum(dim=(1, 2)) / moves
    nnz = m.sum(dim=(1, 2))
    return {"pairs": float((nnz * P * (n - P) / (n * (n - 1))).mean()),
            "vacant": float((nnz / n * (n - P) / (n - 1)).mean()),
            "rows": float(per_frame_union.mean()) * P / n}


def sweep_bound(R, B, N, P, events, work, w_bytes=0.0, extra_flops=0.0,
                extra_bytes=0.0) -> dict:
    """Bound of an event-loop sweep over R replicas and B frames that fired
    `events` events with fresh rates, from :func:`sweep_work`: one whole
    rate evaluation per replica-frame (`pairs` adds); per event the rows it
    changes summed again (`rows` x `vacant` adds) and the N rows added to
    the total, and the two races over the P occupied sources and src's
    `vacant` columns, a log, a divide and a compare per candidate. Bytes:
    positions, W where it is read, and the replica state read once and
    written once."""
    flops = (work["pairs"] * R * B
             + (work["rows"] * work["vacant"] + N) * events
             + 3.0 * (P + work["vacant"]) * events + extra_flops)
    state = 4.0 * R * (2 * N + 5 * P + 2)  # occ, labels, sites, tlast, db, u, evc
    nbytes = (4.0 * B * N * 3 + w_bytes + 2 * state + 4.0 * R + 4 * 4.0 * N * 3
              + extra_bytes)
    return bound(flops, nbytes)


def stats_bound(R, B, N, nbins, events, cands, table_bytes) -> dict:
    """Bound of the work the statistics add to a sweep: per replica-frame
    the exposure's `cands` candidates (a range test, the bin's subtract and
    multiply, an add: 4 each), per event the jump length (5) and its bin (4);
    bytes: the distances the exposure reads (`table_bytes`), both
    histograms read once and written once, the [N, N] int32 matrix
    written."""
    flops = 4.0 * R * B * cands + 9.0 * events
    nbytes = table_bytes + 2 * 2 * 4.0 * R * nbins + 4.0 * N * N
    return bound(flops, nbytes)


def topk_changed(tables, blend) -> float:
    """The candidates one event changes, counted from the run's tables
    [B, K, N] (topd, topi, resc) and averaged over the frames: src's and
    dst's K slots and the entries whose neighbour is src or dst. A site is
    a move's end through one of its in-entries, so each end's in-degree is
    the size-biased mean sum(deg^2) / sum(deg) over the entries with a
    nonzero rate (omega > 0; the others change nothing)."""
    topd, topi, resc = tables
    B, K, N = topi.shape
    valid = (topd < 1.0e5) if blend else (resc > 0)
    flat = (topi.long() + torch.arange(B, device=topi.device)[:, None, None] * N)[valid]
    deg = torch.zeros(B * N, dtype=torch.float64, device=topi.device)
    deg.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.float64))
    deg = deg.reshape(B, N)
    biased = (deg * deg).sum(dim=1) / deg.sum(dim=1).clamp(min=1)
    return 2.0 * K + 2.0 * float(biased.mean())


def _topk_terms(R, N, P, K, blend):
    """Operations per candidate (occ[i] is 1 at the P occupied sites: 1 -
    occ[nbr], the multiply by omega and the add; with the blend also d +
    ratio (r - d), the clamp at 50 and the Fermi law, 9 more, and the site's
    ratio, 3 per site) and the replica state's bytes (occ, labels,
    tlast_site, sites, tlast, db, u, evc)."""
    per_cand = (12.0 if blend else 3.0) + (3.0 / K if blend else 0.0)
    return per_cand, 4.0 * R * (3 * N + 5 * P + 2)


def topk_bound(R, B, N, P, K, events, blend, table_bytes, changed) -> dict:
    """Bound of a top-K sweep that fired `events` events, from the least
    work: one full evaluation per replica-frame (K candidates at each of the
    P occupied sites), per event the `changed` candidates
    (:func:`topk_changed`) and the races over the K slots and the P
    occupied sites, the only ones with a positive rate (a log, a divide and
    a compare each). Bytes: positions, the tables, the replica state read
    once and written once."""
    per_cand, state = _topk_terms(R, N, P, K, blend)
    flops = (R * B * P * K * per_cand
             + events * (changed * per_cand + 3.0 * (P + K)))
    return bound(flops, 4.0 * B * N * 3 + table_bytes + 2 * state + 4.0 * R
                 + 4 * 4.0 * N * 3)
