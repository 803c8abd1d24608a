"""Top-K KMC sweep: stage-1 tables, Verlet candidate reuse, kernel K4, its
plain version, the tile rule.

Port of ``cmdlmc_tpu/ops/topk_sweep.py`` in rows semantics, for the top-K
rate models (``TopKPairRates`` and ``HydroniumRates``, orthorhombic or
triclinic cells) without jump statistics and the jump matrix (ROADMAP A11).

Stage 1 (:func:`topk_tables`) builds per frame the tables [B, K, N]:
``topd`` (neighbor distances, 1e6 where invalid), ``topi`` (neighbor
indices, int32) and ``resc``: the law already applied to the rescaled
distance (``precompute_law``, 0 at invalid slots), or the rescaled distance
itself where the residence-time blend puts the law inside the event loop. An
orthorhombic cell takes ``ops/knn_sparse.py`` (kernel K6 over a plan built
on the device) where ``knn_sparse.sparse_route`` takes it (from
``SPARSE_MIN_N`` = 864 sites and 3 bins an axis), else ``ops/knn_tables.py``
(kernel K5 on the card), plain versions on the CPU; a
triclinic cell takes ``model.shared``, the counterpart of the JAX package's
XLA build. :func:`topk_tables_verlet` freezes the candidate ids between
drift-triggered rebuilds (Verlet candidate reuse) and recomputes the
distances at the frozen ids every frame. Stage 2 advances every replica
through the block: the CUDA kernel ``csrc/topk_sweep.cu`` (K4, over the
tables and their :func:`in_neighbour_lists`) for tensors on the card,
:func:`topk_sweep_reference` for tensors on the CPU.

Draws are keyed as in the dense kernels (``ops/rng.py``): the slot race with
salt 11 and counter ``replica_in_tile * K + slot``, the site race with salt
12 and counter ``replica_in_tile * N + site``, the fresh waiting time with
salt 3. The JAX kernel's occ[nbr] refresh machinery and its one-hot gathers
are index gathers here, which give the same values.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from cmdlmc_tpu_torch.core.cell import distance, minimum_image, sqrt32
from cmdlmc_tpu_torch.engine.lattice import NeighborCarry
from cmdlmc_tpu_torch.ops import build, knn_sparse, rng
from cmdlmc_tpu_torch.ops import kmc_sweep as ks
from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss
from cmdlmc_tpu_torch.ops.knn_tables import (
    BIG, MAX_K, PLAIN_CHUNK_BYTES, knn_block_tables,
)
from cmdlmc_tpu_torch.topo.models import Frame, HydroniumRates, TopKRates


def topk_unsupported_reason(model) -> str | None:
    """None if the top-K kernel can run this model."""
    if not isinstance(model, TopKRates):
        return f"{type(model).__name__} is not a top-K rate model"
    kind = ks.law_kind(model.law)
    if kind is None or kind == ks.KIND_FERMI_ANGLE:
        return f"rate law {type(model.law).__name__} has no top-K kernel"
    if model.k > MAX_K:
        return (f"k={model.k} exceeds the kernel's candidate width ({MAX_K}); "
                "the scan engine is not ported yet (ROADMAP A12)")
    return None


def has_blend(model) -> bool:
    """Whether the law runs inside the event loop on residence-time-blended
    distances (HydroniumRates with a DistanceInterpolator)."""
    return isinstance(model, HydroniumRates) and model.interpolator is not None


def _tables_epilogue(model, topd, resc, precompute_law: bool):
    """The law stage over the tables: with ``precompute_law`` the rate of
    min(resc, 50), 0 where topd >= 1e5."""
    if precompute_law:
        omega = model.law(torch.clamp(resc, max=50.0))
        resc = torch.where(topd < 1.0e5, omega, 0.0)
    return resc


def topk_tables(model, positions_block: torch.Tensor, precompute_law: bool):
    """Stage 1: (topd f32, topi i32, resc f32), each [B, K, N] with
    K = min(k, N - 1). The transformation sees the 1e6 fill of invalid
    slots, as the JAX package's builds do. An orthorhombic cell's tables
    come from K6 over the block's device plan where ``sparse_route``
    takes it (a rule of N and the bins per axis: no fetch), else from K5;
    both give the same tables."""
    pos = positions_block.to(torch.float32)
    B, N, _ = pos.shape
    k = min(model.k, N - 1)
    if model.cell.orthorhombic:
        if knn_sparse.sparse_route(N, model.box, model.cutbuf):
            topd, topi = knn_sparse.knn_sparse_tables(pos, model.box, model.cutbuf, k)
        else:
            topd, topi = knn_block_tables(pos, model.box, model.cutbuf, k)
        resc = model.transform(topd) if model.transform is not None else topd
    else:
        chunk = max(1, PLAIN_CHUNK_BYTES // (4 * N * N))
        parts = []
        for b0 in range(0, B, chunk):
            sh = model.shared(Frame(donors=pos[b0:b0 + chunk]))
            parts.append((sh.dist, sh.nbr, sh.dist_rescaled))
        topd, topi, resc = (torch.cat([p[q] for p in parts]).transpose(1, 2)
                            .contiguous() for q in range(3))
    return topd, topi, _tables_epilogue(model, topd, resc, precompute_law)


# -- Verlet candidate reuse ---------------------------------------------------
#
# The one host-loop schedule of the JAX package's topk_tables_verlet
# (cmdlmc_tpu/ops/topk_sweep.py:719-840) with its per-frame gather epilogue
# (_verlet_epilogue). Its device-resident scheduler and one-hot epilogue give
# the same schedule and tables there and have no counterpart here.

# Thrash guard: a drift-triggered rebuild within _THRASH_GAP frames of the
# previous one rebuilds every frame until the absolute frame reaches the
# trigger + _THRASH_SPAN, then probes the drift guard again. Both bounds are
# absolute frames and ride in the carry, so the schedule does not depend on
# how the frames are cut into blocks.
_THRASH_GAP = 4
_THRASH_SPAN = 128


def _thresh_of(model, topd_row: torch.Tensor) -> torch.Tensor:
    """The drift threshold for which lists frozen from ``topd_row`` [K, N]
    (a rebuild's raw distances) still cover every pair within the cutoff,
    float32 on the device (the JAX package's ``_thresh_of``): half the
    margin of the smallest covering radius (the K-th distance, or cutoff +
    buffer where fewer than K neighbors are in range) over the cutoff,
    clipped to [buffer / 16, buffer / 2]."""
    kth = topd_row[-1]
    cover = torch.where(kth < 1.0e5, kth, model.cutoff + model.buffer)
    margin = cover.min() - model.cutoff
    return torch.clamp(margin / 2.0, model.buffer / 16.0, model.buffer / 2.0)


def _rebuild_thresh(model, topd_row: torch.Tensor) -> float:
    """:func:`_thresh_of` in float64 on the host, as the JAX package's host
    loop takes it after a thrash span (``_rebuild_thresh``); the drift test
    compares in float32 all the same."""
    buf, cut = model.host_buffer, model.host_cutoff
    kth = topd_row[-1].cpu().numpy()
    cover = np.where(kth < 1.0e5, kth, np.float32(cut + buf))
    margin = float(cover.min()) - cut
    return float(np.clip(margin / 2.0, buf / 16.0, buf / 2.0))


def _drift_over(model, pos: torch.Tensor, ref: torch.Tensor,
                thresh: torch.Tensor) -> torch.Tensor:
    """[B] whether each frame's largest site drift from ``ref`` [N, 3]
    exceeds ``thresh`` (float32): minimum image per component, squares
    summed (x + y) + z, as the JAX package's ``_drift_over``."""
    d = minimum_image(model.cell, pos - ref[None])
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    return sqrt32(d2.max(dim=1).values) > thresh


def topk_tables_verlet(model, positions_block: torch.Tensor, precompute_law: bool,
                       carry: NeighborCarry | None, frame0: int):
    """:func:`topk_tables` with Verlet candidate reuse: the K-nearest ids
    are frozen between drift-triggered rebuilds (the lists stay valid while
    no site drifts past :func:`_thresh_of`), and the distances are
    recomputed every frame at the frozen ids (exact index gathers, the
    port's ``core.cell.distance``), masked at cutoff + buffer.

    ``carry`` is the previous block's :class:`NeighborCarry` (None rebuilds
    at the block's first frame); ``frame0`` is the block's absolute frame.
    The schedule is a function of (carry, frame0, frames), so results do not
    depend on how the frames are cut into blocks. One small fetch per
    segment: the drift flags, with the threshold after a rebuild.

    Returns (topd, topi, resc, new_carry, rebuilt): the tables [B, K, N] as
    :func:`topk_tables` gives them and ``rebuilt`` [B] bool (numpy), the
    frames whose lists were rebuilt."""
    pos = positions_block.to(torch.float32)
    B, N, _ = pos.shape
    dev = pos.device
    rows_i, rows_v = [], []
    rebuilt = np.zeros(B, bool)
    seg = np.zeros(B, np.int64)

    def over_of(ref, thresh):
        t = torch.tensor(np.float32(thresh), device=dev)
        return _drift_over(model, pos, ref, t).cpu().numpy()

    def rebuild(f):
        """Lists at frame f; (threshold, drift flags) in one fetch."""
        topd, topi, _ = topk_tables(model, pos[f:f + 1], precompute_law=False)
        rows_i.append(topi[0])
        rows_v.append(topd[0] < 1.0e5)
        rebuilt[f] = True
        seg[f:] = len(rows_i) - 1
        thresh = _thresh_of(model, topd[0])
        flags = _drift_over(model, pos, pos[f], thresh)
        packed = torch.cat([flags.to(torch.float32), thresh[None]]).cpu().numpy()
        return float(packed[-1]), packed[:-1] > 0.5

    def rebuild_span(f, hi):
        """Lists at every frame of [f, hi) in one build; the threshold of
        the last."""
        topd, topi, _ = topk_tables(model, pos[f:hi], precompute_law=False)
        for j in range(hi - f):
            rows_i.append(topi[j])
            rows_v.append(topd[j] < 1.0e5)
        rebuilt[f:hi] = True
        seg[f:hi] = np.arange(len(rows_i) - (hi - f), len(rows_i))
        seg[hi:] = len(rows_i) - 1
        return _rebuild_thresh(model, topd[-1])

    if carry is not None:
        rows_i.append(carry.ref_topi.to(dev))
        rows_v.append(carry.ref_valid.to(dev))
        ref = carry.ref_pos.to(dev)
        thresh = float(carry.thresh)
        last_rb = float(carry.last_rebuild)
        thrash_until = float(carry.thrash_until)
        start = 0
        over = over_of(ref, thresh)
    else:
        thrash_until = 0.0
        thresh, over = rebuild(0)
        ref = pos[0]
        last_rb = float(frame0)
        start = 1
    if frame0 + start < thrash_until:
        # resume a thrash window begun in an earlier block
        hi = min(B, int(thrash_until) - frame0)
        thresh = rebuild_span(start, hi)
        ref = pos[hi - 1]
        last_rb = float(frame0 + hi - 1)
        start = hi
        over = over_of(ref, thresh)
    while start < B:
        beyond = np.nonzero(over[start:])[0]
        if beyond.size == 0:
            break
        f = start + int(beyond[0])
        af = frame0 + f
        # a negative gap is a replay of earlier frames against a newer
        # carry, not a thrash
        if 0 <= af - last_rb <= _THRASH_GAP:
            thrash_until = float(af + _THRASH_SPAN)
            hi = min(B, int(thrash_until) - frame0)
            thresh = rebuild_span(f, hi)
            ref = pos[hi - 1]
            last_rb = float(frame0 + hi - 1)
            start = hi
            over = over_of(ref, thresh)
            continue
        thresh, over = rebuild(f)
        ref = pos[f]
        last_rb = float(af)
        start = f + 1

    seg_t = torch.from_numpy(seg).to(dev)
    topi = torch.stack(rows_i)[seg_t]  # [B, K, N]
    valid = torch.stack(rows_v)[seg_t]
    flat = topi.long() + torch.arange(B, device=dev)[:, None, None] * N
    nbr = pos.reshape(B * N, 3)[flat]  # [B, K, N, 3]
    topd = distance(model.cell, pos[:, None, :, :], nbr)
    topd = torch.where(valid & (topd <= model.cutbuf), topd, BIG)
    resc = model.transform(topd) if model.transform is not None else topd
    new_carry = NeighborCarry(ref_pos=ref, ref_topi=rows_i[-1], ref_valid=rows_v[-1],
                              thresh=float(thresh), last_rebuild=float(last_rb),
                              thrash_until=float(thrash_until))
    return (topd, topi, _tables_epilogue(model, topd, resc, precompute_law),
            new_carry, rebuilt)


topk_tables_verlet.rebuild_frames = 0


def entry_tlast_site(occ, proton_of_site, t_last_jump) -> torch.Tensor:
    """[R, N] last-jump time of the proton on each site (-1 where empty or
    never jumped), recomputed at every block entry. ``proton_of_site`` may
    be the kernel's float labels."""
    p_idx = torch.clamp(torch.round(proton_of_site).to(torch.int64) - 1, min=0)
    tls = torch.gather(t_last_jump, 1, p_idx)
    return torch.where((occ > 0) & (tls >= 0), tls, -1.0)


def law_params8(model) -> torch.Tensor:
    """The law's 6 parameters, the relaxation time (0 without the blend) and
    a pad, float32 [8] on the CPU: the JAX kernel's packing."""
    relax = model.interpolator.host["relaxation_time"] if has_blend(model) else 0.0
    out = np.zeros(8, np.float32)
    out[:6] = ks.law_params_array(model.law).numpy()
    out[6] = relax
    return torch.from_numpy(out)


# -- the RNG tile ------------------------------------------------------------
#
# The draw keys depend on the replica tile, so the port picks the tile the
# JAX package picks on the CPU (rows layout): the largest divisor of R up to
# 128 whose TPU VMEM estimate of the event-loop state fits its budget. That
# estimate is a TPU quantity and no memory limit here; it is kept only so the
# same configuration draws the same numbers in both packages.

_TR_STATE_BUDGET = 26 << 20


def padded_bytes(*shape: int, itemsize: int = 4) -> int:
    """Bytes of a buffer in TPU VMEM, the trailing two dims rounded up to the
    (8, 128) register tile (a copy of ``cmdlmc_tpu/ops/vmem_budget.py``)."""
    if not shape:
        return itemsize
    lane = -(-shape[-1] // 128) * 128
    sub = -(-shape[-2] // 8) * 8 if len(shape) >= 2 else 1
    lead = 1
    for d in shape[:-2]:
        lead *= d
    return itemsize * lead * sub * lane


def _tr_state_bytes(n_sites: int, n_protons: int, tile: int, k_cand: int) -> int:
    return ((6 + k_cand) * padded_bytes(tile, n_sites)
            + 10 * padded_bytes(tile, n_protons) + 7 * padded_bytes(tile, 1))


def pick_tile_topk(n_replicas: int, *, n_sites: int, n_protons: int,
                   k_cand: int, target: int = 128) -> int:
    """The JAX package's RNG tile of the top-K kernel in rows layout
    (``pick_tile_topk``): 128 at N=144, 64 at N=4608 with 3072 protons."""
    kc = min(k_cand, n_sites - 1)
    t = min(target, n_replicas)
    while n_replicas % t:
        t -= 1
    while t > 8 and _tr_state_bytes(n_sites, n_protons, t, kc) > _TR_STATE_BUDGET:
        nt = t // 2
        while n_replicas % nt:
            nt -= 1
        t = nt
    return t


# -- stage 2 -----------------------------------------------------------------


def _minimg3(d: torch.Tensor, geometry, orthorhombic: bool) -> torch.Tensor:
    """Round-based minimum image of [..., 3] vectors (the kernels' form)."""
    h = [geometry[0:3], geometry[3:6], geometry[6:9]]
    if orthorhombic:
        box = torch.tensor([h[0][0], h[1][1], h[2][2]], dtype=torch.float32,
                           device=d.device)
        return d - box * torch.round(d / box)
    hinv = [geometry[9:12], geometry[12:15], geometry[15:18]]
    f32 = np.float32
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    fr = [(f32(m[0]) * x + f32(m[1]) * y) + f32(m[2]) * z for m in hinv]
    fr = [v - torch.round(v) for v in fr]
    return torch.stack([(f32(m[0]) * fr[0] + f32(m[1]) * fr[1]) + f32(m[2]) * fr[2]
                        for m in h], dim=-1)


def candidate_rates(topd_f, topi_f, resc_f, occ, tls, frame_time, law_params,
                    *, kind: int, blend: bool) -> torch.Tensor:
    """a_k[r, i] = omega_k[i] occ[r, i] (1 - occ[r, nbr_k[i]]), [R, K, N], for
    one frame's tables [K, N]. Without the blend omega is the precomputed
    ``resc``; with it, law(min(d + ratio (r - d), 50)) with
    ratio = 1 where tls < 0 else min((t - tls) / relax, 1), 0 where d >= 1e5."""
    occ_n = occ[:, topi_f.long()]  # [R, K, N]
    if blend:
        ratio = torch.where(tls < 0, 1.0, torch.clamp(
            (frame_time - tls) / law_params[6], max=1.0))  # [R, N]
        d = topd_f[None]
        d_eff = d + ratio[:, None, :] * (resc_f - topd_f)[None]
        omega = torch.where(d < 1.0e5, ks._apply_law(
            kind, torch.clamp(d_eff, max=50.0), law_params), 0.0)
    else:
        omega = resc_f[None]
    return omega * occ[:, None, :] * (1.0 - occ_n)


def slot_totals(rates: torch.Tensor):
    """Per-slot sums [R, K] and their total [R], summed over slots in order."""
    sums = rates.sum(dim=2)
    total = sums[:, 0]
    for k in range(1, sums.shape[1]):
        total = total + sums[:, k]
    return sums, total


def topk_sweep_reference(
    positions, topd, topi, resc, prev_pos, site_disp, occ, labels, sites,
    tlast, tlast_site, disp_base, u_rem, ev_count, law_params, frame0: int,
    geometry, tile_offset: int = 0, *, orthorhombic: bool, kind: int,
    tile: int, max_events: int, dt: float, seed: int, blend: bool,
) -> dict:
    """Plain PyTorch version of K4: the reference's top-K event loop,
    vectorized over replicas, one frame and one event iteration at a time,
    index gathers, and the zero-rate rule of the races."""
    B, N, _ = positions.shape
    K = topd.shape[1]
    R = occ.shape[0]
    dev = occ.device
    f32 = torch.float32
    p = torch.as_tensor(law_params, dtype=f32).to(dev)
    dt32 = torch.tensor(dt, dtype=f32, device=dev)

    def minimg3(d):
        return _minimg3(d, geometry, orthorhombic)

    r_idx = torch.arange(R, device=dev)
    tid = r_idx // tile + tile_offset
    rin = r_idx % tile
    ctr_k = rin[:, None] * K + torch.arange(K, device=dev)
    ctr_n = rin[:, None] * N + torch.arange(N, device=dev)
    s, prev = site_disp, prev_pos
    u, evc, tls = u_rem, ev_count, tlast_site
    trunc = torch.zeros(R, dtype=torch.int32, device=dev)
    kw = dict(kind=kind, blend=blend)

    for f in range(B):
        post = positions[f]
        s = s + minimg3(post - prev)
        prev = post
        td, ti, rs = topd[f], topi[f].long(), resc[f]
        frame_idx = int(frame0) + f
        frame_time = torch.tensor(float(frame_idx), dtype=f32, device=dev) * dt32
        phase = torch.zeros(R, dtype=f32, device=dev)
        done = torch.zeros(R, dtype=torch.bool, device=dev)
        for ev in range(max_events):
            if ev > 0 and bool(done.all()):
                break  # iterations of done replicas change nothing
            rates = candidate_rates(td, ti, rs, occ, tls, frame_time, p, **kw)
            sums, total = slot_totals(rates)
            budget = total * (dt32 - phase)
            fire = ~done & (u <= budget) & (budget > 0)
            eph = phase + u / torch.where(total > 0, total, 1.0)

            def race(vals, salt, counter):
                key = rng.mix_key(seed, tid, frame_idx, ev, salt)
                e = 0.0 - torch.log(rng.u01_counter(key[:, None], counter))
                return torch.argmax(torch.where(vals > 0, vals / e, 0.0), dim=1)

            kbest = race(sums, 11, ctr_k)
            src = race(rates[r_idx, kbest], 12, ctr_n)
            dst = ti[kbest, src]

            firef = fire.to(f32)[:, None]
            oh_src = F.one_hot(src, N).to(f32)
            oh_dst = F.one_hot(dst, N).to(f32)
            label = labels.gather(1, src[:, None])
            occ = occ + firef * (oh_dst - oh_src)
            labels = labels * (1.0 - firef * (oh_src + oh_dst)) + firef * oh_dst * label
            t_event = frame_time + eph
            tls = torch.where((oh_dst > 0) & fire[:, None], t_event[:, None], tls)

            moving = (sites == src[:, None]) & fire[:, None]
            sites = torch.where(moving, dst[:, None].to(sites.dtype), sites)
            tlast = torch.where(moving, t_event[:, None], tlast)
            add = (s[src] - s[dst]) + minimg3(post[dst] - post[src])  # [R, 3]
            disp_base = disp_base + moving.to(f32)[..., None] * add[:, None, :]

            key3 = rng.mix_key(seed, tid, frame_idx, ev, 3)
            fresh = -torch.log(rng.u01_counter(key3[:, None], rin[:, None]))[:, 0]
            u = torch.where(fire, fresh, u)
            evc = evc + fire.to(evc.dtype)
            phase = torch.where(fire, eph, phase)
            done = done | ~fire
        trunc = trunc + (~done).to(torch.int32)
        total_end = slot_totals(candidate_rates(td, ti, rs, occ, tls, frame_time,
                                                p, **kw))[1]
        u = u - total_end * (dt32 - phase)

    out = kss._outputs(occ, labels, sites, tlast, disp_base, u, evc, s, prev, trunc)
    out["tlast_site"] = tls
    return out


def in_neighbour_lists(topi: torch.Tensor):
    """Each frame's in-neighbour lists of the tables ``topi`` [B, K, N]:
    ``in_off`` [B, N + 1] int32 offsets and ``in_ent`` [B, K N] int32
    entries q = k N + i, grouped by j = topi[f, k, i] (site j's entries at
    ``in_ent[f, in_off[f, j]:in_off[f, j + 1]]``), in increasing q within
    each j. K4 carries its per-slot rate sums across a frame's events
    through them. Built on the tensors' device with no host wait: a stable
    argsort, a count per site (``scatter_add_``: ``torch.bincount`` reads
    its input's maximum on the host), a cumsum."""
    B, K, N = topi.shape
    flat = topi.reshape(B, K * N).to(torch.int32)
    ent = torch.argsort(flat, dim=1, stable=True).to(torch.int32)
    off = torch.zeros((B, N + 1), dtype=torch.int32, device=topi.device)
    off[:, 1:].scatter_add_(1, flat.long(), torch.ones_like(flat))
    return torch.cumsum(off, dim=1, dtype=torch.int32), ent


def sweep_plan(R: int, N: int, K: int, blend: bool, device: torch.device) -> dict:
    """K4's launch plan at (R, N, K, blend) on ``device``
    (csrc/topk_sweep.cu): warps per block, layout (0 shared, 1 global),
    whether the frame's tables are staged whole in shared memory, the tile
    of the staged first evaluation (0: none), the dynamic shared memory and
    the global scratch in bytes (0 in the shared layout)."""
    out = (ctypes.c_longlong * 6)()
    build.check(
        build.library().cmdlmc_topk_sweep_plan(
            int(R), int(N), int(K), int(bool(blend)), device.index or 0, out),
        "topk_sweep plan",
    )
    keys = ("warps", "layout", "tables_in_smem", "stage_tile", "smem", "scratch")
    return dict(zip(keys, (int(v) for v in out)))


def topk_sweep(
    positions, topd, topi, resc, prev_pos, site_disp, occ, labels, sites,
    tlast, tlast_site, disp_base, u_rem, ev_count, law_params, frame0: int,
    geometry, tile_offset: int = 0, *, orthorhombic: bool, kind: int,
    tile: int, max_events: int, dt: float, seed: int, blend: bool,
) -> dict:
    """Advance every replica across a block of frames over the top-K tables:
    K4 for CUDA tensors, the plain version for CPU tensors. ``positions``
    [B, N, 3]; ``topd`` / ``topi`` / ``resc`` [B, K, N] (``topk_tables``);
    ``tlast_site`` [R, N] (``entry_tlast_site``); ``law_params`` [8]
    (``law_params8``; a CPU tensor spares a device sync); ``geometry`` the 18
    host floats of h and h^-1 (``Cell.host_geometry``). Returns the updated
    state as a dict like the dense sweeps' plus ``tlast_site``;
    the inputs are left unchanged."""
    B, N, _ = positions.shape
    K = topd.shape[1]
    R = occ.shape[0]
    P = sites.shape[1]
    if R % tile:
        raise ValueError(f"tile ({tile}) must divide the replica count ({R})")
    if max_events < 1:
        raise ValueError("max_events must be >= 1")
    if kind not in range(4):
        raise ValueError(f"the top-K kernel has no law kind {kind}")
    if not 1 <= K <= min(MAX_K, N - 1):
        raise ValueError(f"topk_sweep: K must be in [1, min({MAX_K}, N - 1)], got {K}")
    kw = dict(orthorhombic=orthorhombic, kind=kind, tile=tile,
              max_events=max_events, dt=dt, seed=seed, blend=blend)
    dev = occ.device
    if dev.type == "cpu":
        return topk_sweep_reference(
            positions, topd, topi, resc, prev_pos, site_disp, occ, labels,
            sites, tlast, tlast_site, disp_base, u_rem, ev_count, law_params,
            frame0, geometry, tile_offset, **kw,
        )
    if dev.type != "cuda":
        raise ValueError(f"topk_sweep: unsupported device {dev}")
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype, shape in (
        ("positions", positions, f32, (B, N, 3)),
        ("topd", topd, f32, (B, K, N)),
        ("topi", topi, i32, (B, K, N)),
        ("resc", resc, f32, (B, K, N)),
        ("prev_pos", prev_pos, f32, (N, 3)),
        ("site_disp", site_disp, f32, (N, 3)),
        ("occ", occ, f32, (R, N)),
        ("labels", labels, f32, (R, N)),
        ("sites", sites, i32, (R, P)),
        ("tlast", tlast, f32, (R, P)),
        ("tlast_site", tlast_site, f32, (R, N)),
        ("disp_base", disp_base, f32, (R, P, 3)),
        ("u_rem", u_rem, f32, (R,)),
        ("ev_count", ev_count, i32, (R,)),
    ):
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != dev:
            raise ValueError(
                f"topk_sweep: {name} must be {dtype} {tuple(shape)} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    params = [float(x) for x in torch.as_tensor(law_params, dtype=f32).tolist()]
    if len(params) != 8:
        raise ValueError("law_params must hold 8 values")
    geom = [float(x) for x in geometry]
    if len(geom) != 18:
        raise ValueError("geometry must hold the 18 values of h and h^-1")
    # the kernel updates replica state in place: work on copies
    state = [t.contiguous().clone() for t in
             (occ, labels, sites, tlast, tlast_site, disp_base, u_rem, ev_count)]
    tables = [t.contiguous() for t in (positions, topd, topi, resc)]
    prev_in = prev_pos.contiguous()
    s_in = site_disp.contiguous()
    s_out = torch.empty_like(s_in)
    prev_out = torch.empty_like(prev_in)
    trunc = torch.empty(R, dtype=i32, device=dev)
    occ2, lab2, sites2, tlast2, tls2, db2, u2, evc2 = state
    if B == 0 or R == 0:
        trunc.zero_()
        s_out.copy_(s_in)
        prev_out.copy_(prev_in)
    else:
        scratch_bytes = sweep_plan(R, N, K, blend, dev)["scratch"]
        scratch = torch.empty(max(scratch_bytes, 1), dtype=torch.uint8, device=dev)
        lists = in_neighbour_lists(tables[2])
        lib = build.library()
        topk_sweep.launches += 1
        build.check(
            lib.cmdlmc_topk_sweep(
                *(t.data_ptr() for t in (*tables, *lists)), prev_in.data_ptr(),
                s_in.data_ptr(), prev_out.data_ptr(), s_out.data_ptr(),
                *(t.data_ptr() for t in state[:6]), u2.data_ptr(),
                evc2.data_ptr(), trunc.data_ptr(), scratch.data_ptr(),
                scratch.numel(), R, N, P, B, K, int(tile), int(tile_offset),
                int(frame0), int(max_events), int(kind), int(bool(blend)),
                int(bool(orthorhombic)), float(np.float32(dt)),
                params[6], int(seed) & 0xFFFFFFFF, (ctypes.c_float * 6)(*params[:6]),
                (ctypes.c_float * 18)(*geom), build.stream_of(occ2), dev.index or 0,
            ),
            "topk_sweep kernel",
        )
    out = kss._outputs(occ2, lab2, sites2, tlast2, db2, u2, evc2, s_out,
                       prev_out, trunc)
    out["tlast_site"] = tls2
    return out


topk_sweep.launches = 0


def run_block_topk(model, ens, frames_positions: torch.Tensor, frame0: int, *,
                   dt: float, max_events: int = 4, seed: int = 0, tile: int,
                   tile_offset: int = 0, reuse: bool = False) -> dict:
    """EnsembleState adapter: stage-1 tables for the block, then one sweep.
    Returns the sweep's output dict (``tlast_site`` is rebuilt from the
    state at every entry, so it is not carried). With ``reuse`` the tables
    come from :func:`topk_tables_verlet` on ``ens.nbr_carry``, and the dict
    also holds the new carry (``nbr_carry``); the rebuild frames add to
    ``topk_tables_verlet.rebuild_frames``."""
    rep = ens.replicas
    positions = frames_positions.to(torch.float32)
    blend = has_blend(model)
    if reuse:
        topd, topi, resc, carry, rebuilt = topk_tables_verlet(
            model, positions, not blend, ens.nbr_carry, int(frame0))
        topk_tables_verlet.rebuild_frames += int(rebuilt.sum())
    else:
        topd, topi, resc = topk_tables(model, positions, precompute_law=not blend)
    labels = rep.proton_of_site.to(torch.float32)
    out = topk_sweep(
        positions, topd, topi, resc, ens.prev_pos, ens.site_disp, rep.occ,
        labels, rep.site_of_proton, rep.t_last_jump,
        entry_tlast_site(rep.occ, labels, rep.t_last_jump), rep.disp_base,
        rep.clock.u_remaining, rep.clock.event_count, law_params8(model),
        int(frame0), model.geometry, int(tile_offset),
        orthorhombic=model.cell.orthorhombic, kind=ks.law_kind(model.law),
        tile=tile, max_events=max_events, dt=float(dt), seed=int(seed),
        blend=blend,
    )
    if reuse:
        out["nbr_carry"] = carry
    return out
