"""Water KMC sweep: the per-frame tables, kernel K7, its plain version.

Port of ``cmdlmc_tpu/ops/water_sweep.py`` (the single-excess-proton water
model) in rows semantics. The JAX kernel B4 rebuilds, inside every replica
tile, each frame's [N, N] distances and the K = ``n_atoms`` nearest
neighbors of every site, then runs the event loop. Here the tables are built
once per frame for all replicas (:func:`water_tables`): they are kernel K5's
K-nearest tables (``ops/knn_tables.py``) with the cutoff at +inf, the same
minimum image, sum order, self exclusion and first-lowest tie rule as B4's
(B4's rows take p_i - p_j where K5 takes p_j - p_i; the minimum image is odd,
so the squares agree), followed by the transform as one elementwise pass.
The event loop runs in the CUDA kernel ``csrc/water_sweep.cu`` (K7) on the
card and in :func:`water_sweep_reference` on the CPU; both read the tables
by index where B4 gathers through one-hot matmuls.

Draws are keyed as in the other kernels (``ops/rng.py``): the 3-way pick
with salt 12 and the fresh exponential with salt 13, each with the in-tile
counter ``replica % tile``.

One rule differs from B4 (ROADMAP queue C item 7): a draw of exactly 1.0
makes B4's pick u2 = total, which lands on slot 2 when its rate is 0; the
port then takes the last slot with a positive rate.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cmdlmc_tpu_torch.core.cell import sqrt32
from cmdlmc_tpu_torch.ops import build, rng
from cmdlmc_tpu_torch.ops import kmc_sweep as ks
from cmdlmc_tpu_torch.ops.knn_tables import knn_block_tables

# transform kinds
T_NONE, T_LINEAR, T_RAMP, T_INTERP = 0, 1, 2, 3

# the largest interpolation table B4 takes (each segment is an unrolled
# masked lerp in the TPU kernel); the port keeps the JAX package's gate
MAX_INTERP_POINTS = 1024

# CUDA threads per block of K7's event loop (8 lanes a replica). The loop
# has no barrier, so narrow blocks spread the replicas over every SM
# (PERF.md times 32 to 256 at R=8192). The draws do not depend on it.
BLOCK_THREADS = 64


def apply_transform(tkind: int, d: torch.Tensor, tp, tx=None, ty=None) -> torch.Tensor:
    """B4's rescaling of the distances ``d`` (``_apply_transform``), in its
    arithmetic. ``tp`` = [a, b, d0, left, right] float32; ``tx`` / ``ty``
    the interpolation table (T_INTERP). The table is B4's segment lerp, not
    ``jnp.interp``: below x[0] y[0]; in segment j, x[j] <= d < x[j+1],
    y[j] + t (y[j+1] - y[j]) with t = (d - x[j]) / max(x[j+1] - x[j], 1e-12);
    at d == x[-1] y[-1]; above x[-1] d. Of the segments that hold d, B4's
    loop keeps the last; ``searchsorted(side='right') - 1`` finds it for a
    non-decreasing table (a repeated point is an empty segment)."""
    if tkind == T_NONE:
        return d
    # float32 values as python floats: torch applies them to a float32
    # tensor in float32, with no host-to-device copy
    a, b, d0, left, right = (float(np.float32(v)) for v in tp)
    if tkind == T_LINEAR:
        inside = (d > left) & (d < right)
        return torch.where(inside, d * a + b, d)
    if tkind == T_RAMP:
        resc = torch.where(d < d0, b, (d - d0) * a + b)
        outside = (d <= left) | (d >= right)
        return torch.where(outside, d, resc)
    if tkind != T_INTERP:
        raise ValueError(f"unknown transform kind {tkind}")
    x = torch.tensor(np.asarray(tx, np.float32), device=d.device)
    y = torch.tensor(np.asarray(ty, np.float32), device=d.device)
    m = x.shape[0]
    res = torch.where(d < x[0], y[0], d)
    if m > 1:
        j = torch.searchsorted(x, d.contiguous(), right=True) - 1
        seg = (j >= 0) & (j < m - 1)
        jc = torch.clamp(j, 0, m - 2)
        x0, x1, y0, y1 = x[jc], x[jc + 1], y[jc], y[jc + 1]
        t = (d - x0) / torch.clamp(x1 - x0, min=1e-12)
        inside = seg & (d >= x0) & (d < x1)
        res = torch.where(inside, y0 + t * (y1 - y0), res)
    return torch.where(d == x[m - 1], y[m - 1], res)


def water_tables(positions: torch.Tensor, box, k: int, tkind: int, tparams,
                 tx=None, ty=None):
    """The tables of a block of frames for the event loop: (topd f32, topi
    i32, resc f32), each [B, k, N], sites last. topd / topi are the k nearest
    other sites of every site (K5 on the card, its plain version on the CPU,
    no cutoff); resc is :func:`apply_transform` of topd."""
    topd, topi = knn_block_tables(positions.to(torch.float32), box, float("inf"), k)
    return topd, topi, apply_transform(tkind, topd, tparams, tx, ty)


# -- the event loop ----------------------------------------------------------


def candidate_rates(td, ti, rs, site, last, fsj, wait, law_params, *, kind: int,
                    relax: int, keep_last: bool, check_old: bool):
    """The 3 candidates of every replica's site on one frame's tables
    td / ti / rs [K, N]: (rates [R, 3] f32, dst [R, 3] i64), as B4's
    ``candidates`` gives them (the relaxation blend, the back-jump rescaling
    with the 4-neighbor promotion or ``check_from_old``, the law on the
    first 3 slots, the waiting-time gate)."""
    K = td.shape[0]
    s = site.long()
    d = td[:, s].T  # [R, K]
    r = rs[:, s].T
    ci = ti[:, s].T.long()
    if relax > 0:
        factor = torch.clamp(fsj.to(torch.float32) / np.float32(relax), 0.0, 1.0)
        d_eff = d + factor[:, None] * (r - d)
    else:
        d_eff = r
    if keep_last:
        lst = last.long()
        is_last = (ci == lst[:, None]) & (lst >= 0)[:, None]
        d_eff = torch.where(is_last, r, d_eff)
        if K == 4:
            # the old neighbor in slot 3 moves to slot 2
            in3 = is_last[:, 3]
            d_eff = d_eff.clone()
            ci = ci.clone()
            d_eff[:, 2] = torch.where(in3, d_eff[:, 3], d_eff[:, 2])
            ci[:, 2] = torch.where(in3, ci[:, 3], ci[:, 2])
        elif check_old:
            # the connection exists only old -> new: the farthest active
            # candidate becomes the old site at old's rescaled distance
            lo = torch.clamp(lst, min=0)
            old_i = ti[:, lo].T.long()
            old_r = rs[:, lo].T
            eq_site = old_i == s[:, None]
            do_swap = ~is_last.any(dim=1) & eq_site.any(dim=1) & (lst >= 0)
            far = torch.argmax(d_eff[:, :3], dim=1)  # the first max
            first_eq = torch.argmax(eq_site.to(torch.int32), dim=1)
            old_dist = old_r.gather(1, first_eq[:, None])
            slots = torch.arange(K, device=td.device)
            sel = (slots[None] == far[:, None]) & do_swap[:, None]
            d_eff = torch.where(sel, old_dist, d_eff)
            ci = torch.where(sel, lst[:, None], ci)
    rates = ks._apply_law(kind, d_eff[:, :3], law_params)
    rates = torch.where((wait > 0)[:, None], 0.0, rates)
    return rates, ci[:, :3]


def total_rate(rates: torch.Tensor) -> torch.Tensor:
    """(r0 + r1) + r2: the order of XLA's CPU reduction over B4's 8 lanes."""
    return (rates[:, 0] + rates[:, 1]) + rates[:, 2]


def pick_slot(rates: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """B4's 3-way inverse CDF, [u2 >= r0] + [u2 >= r0 + r1], and the port's
    rule for a zero-rate pick: the last slot with a positive rate (a pick
    lands on a zero rate only when u2 == total, i.e. a draw of 1.0; ROADMAP
    queue C item 7)."""
    r0, r1, r2 = rates.unbind(1)
    pick = (u2 >= r0).long() + (u2 >= r0 + r1).long()
    picked = rates.gather(1, pick[:, None])[:, 0]
    last_pos = torch.where(r2 > 0, 2, torch.where(r1 > 0, 1, 0))
    return torch.where(picked > 0, pick, last_pos)


def _minimg(d: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    return d - box * torch.round(d / box)


STATE_KEYS = ("site", "last", "fsj", "wait", "jumps", "ev_count", "u_rem", "corr",
              "disp_base")


def water_sweep_reference(
    positions, topd, topi, resc, prev_pos, site_disp, site, last, fsj, wait,
    jumps, ev_count, u_rem, corr, disp_base, law_params, frame0: int, box,
    tile_offset: int = 0, *, kind: int, tile: int, max_events: int, dt: float,
    seed: int, relax: int, waiting: int, keep_last: bool, check_old: bool,
    d_oh: float,
) -> dict:
    """Plain PyTorch version of K7: B4's event loop over the tables, in rows
    semantics, vectorized over replicas, one frame and one event iteration
    at a time (a done replica's iteration changes nothing, so the loop stops
    when every replica is done). Besides the state it returns
    ``site_trace`` [B] int32, replica 0's site after each frame."""
    B, N, _ = positions.shape
    R = site.shape[0]
    dev = site.device
    f32 = torch.float32
    p = torch.as_tensor(law_params, dtype=f32).to(dev)
    dt32 = torch.tensor(np.float32(dt), device=dev)
    box_t = torch.tensor([np.float32(b) for b in box], device=dev)
    r_idx = torch.arange(R, device=dev)
    tid = r_idx // tile + tile_offset
    rin = r_idx % tile
    kw = dict(kind=kind, relax=relax, keep_last=keep_last, check_old=check_old)
    c_oh = float(np.float32(2.0) * np.float32(d_oh))
    wait0 = waiting + 1 if waiting else 0
    s, prev = site_disp, prev_pos
    site, last, fsj, wait = (t.to(torch.int32) for t in (site, last, fsj, wait))
    jumps, evc = jumps.to(torch.int32), ev_count.to(torch.int32)
    u, cor, a = u_rem, corr, disp_base
    trunc = torch.zeros(R, dtype=torch.int32, device=dev)
    trace = []

    for f in range(B):
        post = positions[f]
        s = s + _minimg(post - prev, box_t)
        prev = post
        td, ti, rs = topd[f], topi[f], resc[f]
        frame_idx = int(frame0) + f
        phase = torch.zeros(R, dtype=f32, device=dev)
        done = torch.zeros(R, dtype=torch.bool, device=dev)
        for ev in range(max_events):
            if ev > 0 and bool(done.all()):
                break
            rates, cand = candidate_rates(td, ti, rs, site, last, fsj, wait, p, **kw)
            total = total_rate(rates)
            budget = total * (dt32 - phase)
            fire = ~done & (u <= budget) & (budget > 0)
            eph = phase + u / torch.where(total > 0, total, 1.0)
            key2 = rng.mix_key(seed, tid, frame_idx, ev, 12)
            u2 = rng.u01_counter(key2, rin) * total
            dst = cand.gather(1, pick_slot(rates, u2)[:, None])[:, 0]
            src = site.long()
            jump = _minimg(post[dst] - post[src], box_t)
            fire3 = fire[:, None]
            a = torch.where(fire3, a + ((s[src] - s[dst]) + jump), a)
            if d_oh != 0.0:
                jj = jump * jump
                norm2 = (jj[:, 0] + jj[:, 1]) + jj[:, 2]
                inv = 1.0 / sqrt32(torch.clamp(norm2, min=1e-12))
                cor = torch.where(fire3, cor - (c_oh * jump) * inv[:, None], cor)
            last = torch.where(fire, site, last)
            site = torch.where(fire, dst.to(torch.int32), site)
            fsj = torch.where(fire, -1, fsj).to(torch.int32)
            wait = torch.where(fire, wait0, wait).to(torch.int32)
            jumps = jumps + fire.to(torch.int32)
            evc = evc + fire.to(torch.int32)
            key3 = rng.mix_key(seed, tid, frame_idx, ev, 13)
            u = torch.where(fire, -torch.log(rng.u01_counter(key3, rin)), u)
            phase = torch.where(fire, eph, phase)
            done = done | ~fire
        trunc = trunc + (~done).to(torch.int32)
        rates, _ = candidate_rates(td, ti, rs, site, last, fsj, wait, p, **kw)
        u = u - total_rate(rates) * (dt32 - phase)
        fsj = fsj + 1
        wait = torch.clamp(wait - 1, min=0)
        trace.append(site[:1])

    site_trace = (torch.cat(trace) if trace and R
                  else torch.zeros(B, dtype=torch.int32, device=dev))
    return {"site": site, "last": last, "fsj": fsj, "wait": wait, "jumps": jumps,
            "ev_count": evc, "u_rem": u, "corr": cor, "disp_base": a,
            "site_disp": s, "prev_pos": prev, "trunc": trunc,
            "site_trace": site_trace}


def water_prefix_reference(positions: torch.Tensor, prev_pos: torch.Tensor,
                           site_disp: torch.Tensor, box) -> torch.Tensor:
    """Plain version of K7's prefix pre-pass: the site prefix sum after each
    frame of the block, [B, N, 3], s[b] = s[b - 1] + minimg(pos[b] -
    pos[b - 1]) with pos[-1] = ``prev_pos`` and s[-1] = ``site_disp``, as
    :func:`water_sweep_reference` carries it (its last row is that
    function's ``site_disp``)."""
    box_t = torch.tensor([np.float32(b) for b in box], device=positions.device)
    rows, s, prev = [], site_disp, prev_pos
    for post in positions:
        s = s + _minimg(post - prev, box_t)
        rows.append(s)
        prev = post
    if not rows:
        return site_disp.new_zeros((0,) + tuple(site_disp.shape))
    return torch.stack(rows)


def water_sweep(
    positions, topd, topi, resc, prev_pos, site_disp, site, last, fsj, wait,
    jumps, ev_count, u_rem, corr, disp_base, law_params, frame0: int, box,
    tile_offset: int = 0, *, kind: int, tile: int, max_events: int, dt: float,
    seed: int, relax: int, waiting: int, keep_last: bool, check_old: bool,
    d_oh: float, block_threads: int = BLOCK_THREADS,
) -> dict:
    """K7: advance every replica across a block of frames over the tables of
    :func:`water_tables`. ``positions`` [B, N, 3]; ``topd`` / ``topi`` /
    ``resc`` [B, K, N] with K = n_atoms in {3, 4}; ``prev_pos`` /
    ``site_disp`` [N, 3]; ``site`` ... ``ev_count`` [R] int32; ``u_rem``
    [R]; ``corr`` / ``disp_base`` [R, 3]; ``law_params`` [6] (a CPU tensor
    spares a device sync); ``box`` three floats. Returns the state as
    :func:`water_sweep_reference` does; the inputs are left unchanged. CUDA
    tensors only: the caller takes the plain version for CPU tensors.
    ``block_threads`` is the CUDA block (threads per block, 8 a replica);
    the draws do not depend on it. One launch runs K7's three kernels: the
    prefix pre-pass (:func:`water_prefix_reference` is its plain version),
    the tables packed per site, then the loop."""
    B, N, _ = positions.shape
    K = topd.shape[1]
    R = site.shape[0]
    dev = site.device
    if dev.type != "cuda":
        raise ValueError(f"water_sweep: K7 takes CUDA tensors, got {dev}; "
                         "water_sweep_reference is the CPU version")
    if R % tile:
        raise ValueError(f"tile ({tile}) must divide the replica count ({R})")
    if max_events < 1:
        raise ValueError("max_events must be >= 1")
    if kind not in range(5):
        raise ValueError(f"the water kernel has no law kind {kind}")
    if K not in (3, 4) or N < K + 1:
        raise ValueError(f"water_sweep: K must be 3 or 4 and below N, got K={K}, N={N}")
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype, shape in (
        ("positions", positions, f32, (B, N, 3)),
        ("topd", topd, f32, (B, K, N)),
        ("topi", topi, i32, (B, K, N)),
        ("resc", resc, f32, (B, K, N)),
        ("prev_pos", prev_pos, f32, (N, 3)),
        ("site_disp", site_disp, f32, (N, 3)),
        ("site", site, i32, (R,)),
        ("last", last, i32, (R,)),
        ("fsj", fsj, i32, (R,)),
        ("wait", wait, i32, (R,)),
        ("jumps", jumps, i32, (R,)),
        ("ev_count", ev_count, i32, (R,)),
        ("u_rem", u_rem, f32, (R,)),
        ("corr", corr, f32, (R, 3)),
        ("disp_base", disp_base, f32, (R, 3)),
    ):
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != dev:
            raise ValueError(
                f"water_sweep: {name} must be {dtype} {tuple(shape)} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    params = [float(x) for x in torch.as_tensor(law_params, dtype=f32).tolist()]
    if len(params) != 6:
        raise ValueError("law_params must hold 6 values")
    # the kernel updates replica state in place: work on copies
    state = [t.contiguous().clone() for t in
             (site, last, fsj, wait, jumps, ev_count, u_rem, corr, disp_base)]
    tables = [t.contiguous() for t in (positions, topd, topi, resc)]
    prev_in = prev_pos.contiguous()
    s_in = site_disp.contiguous()
    s_out = s_in.clone()
    s_tab = torch.empty((B, N, 3), dtype=f32, device=dev)
    rows = torch.empty((B, N, 12), dtype=f32, device=dev)  # packed tables (K7's scratch)
    trunc = torch.zeros(R, dtype=i32, device=dev)
    site_trace = torch.zeros(B, dtype=i32, device=dev)
    if B > 0:
        lx, ly, lz = (float(np.float32(b)) for b in box)
        lib = build.library()
        water_sweep.launches += 1
        build.check(
            lib.cmdlmc_water_sweep(
                *(t.data_ptr() for t in tables), prev_in.data_ptr(), s_in.data_ptr(),
                s_tab.data_ptr(), rows.data_ptr(), s_out.data_ptr(),
                *(t.data_ptr() for t in state), trunc.data_ptr(),
                site_trace.data_ptr(), R, N, B, K, int(tile), int(tile_offset),
                int(frame0), int(max_events), int(kind), int(relax), int(waiting),
                int(bool(keep_last)), int(bool(check_old)), int(block_threads),
                float(np.float32(dt)), float(np.float32(d_oh)), lx, ly, lz,
                int(seed) & 0xFFFFFFFF, (ctypes.c_float * 6)(*params),
                build.stream_of(trunc), dev.index or 0,
            ),
            "water_sweep kernel",
        )
    prev_out = tables[0][B - 1].clone() if B else prev_in.clone()
    keys = ("site", "last", "fsj", "wait", "jumps", "ev_count", "u_rem", "corr",
            "disp_base")
    out = dict(zip(keys, state))
    out.update(site_disp=s_out, prev_pos=prev_out, trunc=trunc, site_trace=site_trace)
    return out


water_sweep.launches = 0
