"""The plain reference of the solid-acid KMC: rates, event loops, rows.

Plain PyTorch, written from the semantics of the reference's event loop
(the JAX package's kernels in rows semantics): per frame the shared site
displacement advances, then at most ``max_events`` events fire while the
replica's remaining exponential draw ``u`` fits in the frame's integrated
rate; the source wins a race of rate / E over the occupied sites and the
destination a race over the source's vacant partners (E = -log of a
counter-keyed uniform, ``rng.py``); at the end of the frame ``u`` pays for
the rest of the frame. It imports nothing of the program: the benchmark
hands it the generated trajectory, the seed and, where it follows the
program, the program's state at a block's entry.

Everything a decision depends on runs in ``dtype`` (float64 for the
reference, bfloat16 for the control). Distances are float32 in the
kernels' operation order (minimum image d - L rint(d / L), squares summed
(x + y) + z, a correctly rounded square root), so the cutoff mask and the
jump-statistics bins see the bits the program sees. The loops also
return each replica's smallest decision margin: the clock test's
(|u - budget| - clock drift) / max(|budget|, 1) (u is an O(1) draw less
O(1) integrated rates, so its float32 error is absolute near zero; and
the clock runs on across frames, so a float32 program's u drifts from the
reference's by some ulps of each frame's integrated rate total * dt a
frame, which the clock drift allows: CLOCK_DRIFT_ULPS of them a frame
since the block's entry) and the relative gap between the two best
candidates of each race; a float32 program may part from the reference
only where that margin is within its rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import rng

BIG = 1.0e6  # distance of an exhausted top-K slot
F32 = torch.float32
# the float32 clock's drift a frame, in ulps (2^-24) of the frame's
# integrated rate: about 1.5 measured on the 2x2x2 supercell, kept with room
CLOCK_DRIFT_ULPS = 8.0


# -- the RNG tiles -------------------------------------------------------------
# Frozen copies of cmdlmc_tpu_torch/engine/fused.py:123-134 (pick_tile) and
# cmdlmc_tpu_torch/ops/topk_sweep.py:298-335 (pick_tile_topk) at 5a4702a:
# the draw keys depend on the replica tile these rules pick.

def pick_tile(n_replicas: int, target: int = 128, n_sites: int = 0) -> int:
    if n_sites > 3072:
        target = min(target, 32)
    elif n_sites > 2048:
        target = min(target, 64)
    t = min(target, n_replicas)
    while n_replicas % t:
        t -= 1
    return t


def _padded_bytes(*shape: int, itemsize: int = 4) -> int:
    lane = -(-shape[-1] // 128) * 128
    sub = -(-shape[-2] // 8) * 8 if len(shape) >= 2 else 1
    lead = 1
    for d in shape[:-2]:
        lead *= d
    return itemsize * lead * sub * lane


def pick_tile_topk(n_replicas: int, *, n_sites: int, n_protons: int, k_cand: int,
                   target: int = 128) -> int:
    kc = min(k_cand, n_sites - 1)

    def state_bytes(t):
        return ((6 + kc) * _padded_bytes(t, n_sites) + 10 * _padded_bytes(t, n_protons)
                + 7 * _padded_bytes(t, 1))

    t = min(target, n_replicas)
    while n_replicas % t:
        t -= 1
    while t > 8 and state_bytes(t) > (26 << 20):
        nt = t // 2
        while n_replicas % nt:
            nt -= 1
        t = nt
    return t


# -- the start -----------------------------------------------------------------

def init_state(seed: int, n_replicas: int, n_sites: int, n_protons: int):
    """(sites [R, P] int64, u [R] float32) of a seeded start: each replica's
    protons on a uniformly random subset of sites, then its first
    exponential draw, from one CPU ``torch.Generator`` (the draws of
    cmdlmc_tpu_torch/engine/lattice.py:160-162 at 5a4702a, so a seed gives
    the same start)."""
    gen = torch.Generator().manual_seed(int(seed))
    keys = torch.rand((n_replicas, n_sites), generator=gen)
    sites = torch.argsort(keys, dim=1)[:, :n_protons]
    u0 = torch.empty(n_replicas).exponential_(generator=gen)
    return sites, u0


# -- geometry and rates --------------------------------------------------------

def minimg(d: torch.Tensor, box) -> torch.Tensor:
    """Orthorhombic minimum image, rint to even, in d's dtype."""
    b = torch.tensor([float(x) for x in box], dtype=d.dtype, device=d.device)
    return d - b * torch.round(d / b)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root in x's dtype (through float64)."""
    return torch.sqrt(x.double()).to(x.dtype)


def norm_f32(d: torch.Tensor) -> torch.Tensor:
    """|d| of [..., 3] vectors in their dtype: squares summed (x + y) + z."""
    sq = d * d
    return sqrt_f32((sq[..., 0] + sq[..., 1]) + sq[..., 2])


def distances_f32(pos: torch.Tensor, box) -> torch.Tensor:
    """[..., N, N] minimum-image distances of [..., N, 3] positions, in
    their dtype (float32 as the kernels compute them)."""
    return norm_f32(minimg(pos[..., None, :, :] - pos[..., :, None, :], box))


def extend(pos: torch.Tensor, box, mult) -> torch.Tensor:
    """The supercell of [..., n, 3] positions replicated mx x my x mz
    times: index box_index * n + atom, box_index row-major over (mx, my,
    mz), the shift (i Lx, j Ly, k Lz) added to each position in float32."""
    mx, my, mz = (int(m) for m in mult)
    if (mx, my, mz) == (1, 1, 1):
        return pos
    b = torch.tensor([float(x) for x in box], dtype=pos.dtype, device=pos.device)
    shifts = torch.stack([torch.tensor([i, j, k], dtype=pos.dtype, device=pos.device) * b
                          for i in range(mx) for j in range(my) for k in range(mz)])
    out = shifts[:, None, :] + pos[..., None, :, :]
    return out.reshape(*pos.shape[:-2], -1, 3)


def fermi(d: torch.Tensor, law) -> torch.Tensor:
    a, b, c = (float(law[k]) for k in ("a", "b", "c"))
    return a / (1.0 + torch.exp((d - b) / c))


def dense_rates(pos32: torch.Tensor, box, law, cutbuf: float, dtype=torch.float64):
    """(W [B, N, N] in ``dtype``, dist float32): W[i, j] = law(d_ij) for
    i != j within cutoff + buffer, else 0. A ``dtype`` below float32 also
    takes the distances in it."""
    low = torch.finfo(dtype).bits < 32
    dist = distances_f32(pos32.to(dtype) if low else pos32, box)
    n = dist.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=dist.device)
    valid = (dist <= np.float32(cutbuf)) & ~eye
    w = torch.where(valid, fermi(dist.to(dtype), law), 0.0).to(dtype)
    return w, dist.to(F32)


def knn_f32(pos: torch.Tensor, box, cutbuf: float, k: int):
    """The k nearest other sites of each site j within cutbuf, by (distance,
    index): (topd float32 [k, N], BIG where exhausted; topi int64 [k, N], 0
    where exhausted)."""
    n = pos.shape[0]
    d = distances_f32(pos, box)
    inf = torch.tensor(float("inf"), device=pos.device)
    rows = torch.arange(n, device=pos.device)
    d = torch.where(torch.eye(n, dtype=torch.bool, device=pos.device), inf, d)
    d = torch.where(d <= np.float32(cutbuf), d, inf)
    topd = torch.empty((k, n), dtype=F32, device=pos.device)
    topi = torch.empty((k, n), dtype=torch.int64, device=pos.device)
    for s in range(k):
        m = d.min(dim=0).values
        idx = torch.where(d == m[None, :], rows[:, None], n).min(dim=0).values
        topd[s] = torch.where(m == inf, BIG, m)
        topi[s] = torch.where(m == inf, 0, idx)
        d = torch.where(rows[:, None] == idx[None, :], inf, d)
    return topd, topi


# -- Verlet candidate reuse ----------------------------------------------------
# The rebuild schedule of cmdlmc_tpu_torch/ops/topk_sweep.py:118-268 at
# 5a4702a (itself the JAX package's): lists frozen at a rebuild stay while no
# site drifts past a threshold; a drift rebuild within THRASH_GAP frames of
# the last starts a span of per-frame rebuilds up to THRASH_SPAN frames on.

THRASH_GAP, THRASH_SPAN = 4, 128


def thresh_f32(topd_row, cutoff: float, buffer: float) -> torch.Tensor:
    """The drift threshold after a single rebuild, float32."""
    c = torch.tensor(cutoff, dtype=F32, device=topd_row.device)
    b = torch.tensor(buffer, dtype=F32, device=topd_row.device)
    kth = topd_row[-1]
    cover = torch.where(kth < 1.0e5, kth, c + b)
    return torch.clamp((cover.min() - c) / 2.0, b / 16.0, b / 2.0)


def thresh_f64(topd_row, cutoff: float, buffer: float) -> float:
    """The drift threshold after a span of rebuilds, float64 on the host."""
    kth = topd_row[-1].cpu().numpy()
    cover = np.where(kth < 1.0e5, kth, np.float32(cutoff + buffer))
    return float(np.clip((float(cover.min()) - cutoff) / 2.0, buffer / 16.0, buffer / 2.0))


def drift_over(pos, ref, thresh: float, box) -> np.ndarray:
    """[B] whether each frame's largest site drift from ``ref`` passes the
    float32 threshold."""
    d = minimg(pos - ref[None], box)
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    t = torch.tensor(np.float32(thresh), device=pos.device)
    return (sqrt_f32(d2.max(dim=1).values) > t).cpu().numpy()


def verlet_tables(pos, carry: dict, frame0: int, box, cutoff: float, buffer: float,
                  k: int):
    """Tables [B, k, N] (topd float32, topi int64) of a block under Verlet
    reuse, from the schedule state ``carry`` at its entry (``ref_pos``,
    ``thresh``, ``last_rebuild``, ``thrash_until``), with the reference's own
    K-nearest lists at every rebuild and at the carry's reference positions.
    Returns (topd, topi, rebuilt frames)."""
    cutbuf = float(np.float32(cutoff) + np.float32(buffer))
    B = pos.shape[0]
    rows_i, rows_v = [], []
    seg = np.zeros(B, np.int64)
    rebuilt = np.zeros(B, bool)

    def lists(p):
        d, i = knn_f32(p, box, cutbuf, k)
        rows_i.append(i)
        rows_v.append(d < 1.0e5)
        return d

    def rebuild(f):
        d = lists(pos[f])
        rebuilt[f] = True
        seg[f:] = len(rows_i) - 1
        t = float(thresh_f32(d, cutoff, buffer))
        return t, drift_over(pos, pos[f], t, box)

    def rebuild_span(f, hi):
        for j in range(f, hi):
            d = lists(pos[j])
        rebuilt[f:hi] = True
        seg[f:hi] = np.arange(len(rows_i) - (hi - f), len(rows_i))
        seg[hi:] = len(rows_i) - 1
        return thresh_f64(d, cutoff, buffer)

    lists(carry["ref_pos"])
    ref, thresh = carry["ref_pos"], float(carry["thresh"])
    last_rb, thrash_until = float(carry["last_rebuild"]), float(carry["thrash_until"])
    start = 0
    over = drift_over(pos, ref, thresh, box)
    if frame0 + start < thrash_until:
        hi = min(B, int(thrash_until) - frame0)
        thresh = rebuild_span(start, hi)
        ref, last_rb, start = pos[hi - 1], float(frame0 + hi - 1), hi
        over = drift_over(pos, ref, thresh, box)
    while start < B:
        beyond = np.nonzero(over[start:])[0]
        if beyond.size == 0:
            break
        f = start + int(beyond[0])
        af = frame0 + f
        if 0 <= af - last_rb <= THRASH_GAP:
            thrash_until = float(af + THRASH_SPAN)
            hi = min(B, int(thrash_until) - frame0)
            thresh = rebuild_span(f, hi)
            ref, last_rb, start = pos[hi - 1], float(frame0 + hi - 1), hi
            over = drift_over(pos, ref, thresh, box)
            continue
        thresh, over = rebuild(f)
        ref, last_rb, start = pos[f], float(af), f + 1
    seg_t = torch.from_numpy(seg).to(pos.device)
    topi = torch.stack(rows_i)[seg_t]
    valid = torch.stack(rows_v)[seg_t]
    nbr = torch.gather(pos[:, None, :, :].expand(B, k, -1, 3), 2,
                       topi[..., None].expand(B, k, -1, 3))
    topd = norm_f32(minimg(nbr - pos[:, None, :, :], box))
    topd = torch.where(valid & (topd <= np.float32(cutbuf)), topd, BIG)
    return topd, topi, rebuilt


# -- the event loops -----------------------------------------------------------

def clock_margin(u, budget, clock_drift) -> torch.Tensor:
    """Margin of the clock test u <= budget, float64: the gap less the
    float32 clock's drift allowance, over max(|budget|, 1)."""
    gap = (u.double() - budget.double()).abs() - clock_drift
    return gap / budget.double().abs().clamp(min=1.0)


def clock_drift_step(total, dt: float) -> torch.Tensor:
    """The clock drift allowance one frame adds: CLOCK_DRIFT_ULPS ulps of
    its integrated rate total * dt."""
    return CLOCK_DRIFT_ULPS * 2.0**-24 * (total.double() * dt).abs()


def _race(vals, e):
    """Winner of a race of vals / e (zero rates never win) and its margin:
    the relative gap to the runner-up (1 where the winner is certain)."""
    v = torch.where(vals > 0, vals / e, torch.zeros((), dtype=vals.dtype, device=vals.device))
    win = torch.argmax(v, dim=1)
    top = torch.topk(v.double(), 2, dim=1).values
    certain = torch.isinf(top[:, 0]) | (top[:, 0] <= 0)
    gap = torch.where(certain, 1.0, (top[:, 0] - top[:, 1]) / top[:, 0].clamp(min=1e-300))
    return win, gap


def _draws(seed, tid, frame_idx, ev, salt, counter, dtype):
    """E = 0 - log(u) of the counter draws: +0 (not -0) for a draw of
    exactly 1.0, so a positive rate over it scores +inf and wins its race."""
    key = rng.mix_key(seed, tid, frame_idx, ev, salt)
    return 0.0 - torch.log(rng.u01(key[:, None], counter).to(dtype))


def _apply(st, fire, src, dst, t_event, jump, stats, jump32, hist_cfg):
    """Move each firing replica's proton src -> dst with its label, last-jump
    time and displacement; count the jump statistics."""
    r = torch.nonzero(fire)[:, 0]
    s_, d_ = src[r], dst[r]
    label = st["labels"][r, s_]
    st["occ"][r, s_] = 0
    st["occ"][r, d_] = 1
    st["labels"][r, s_] = 0
    st["labels"][r, d_] = label
    moving = (st["sites"] == src[:, None]) & fire[:, None]
    st["sites"] = torch.where(moving, dst[:, None], st["sites"])
    st["tlast"] = torch.where(moving, t_event[:, None], st["tlast"])
    add = (st["s"][src] - st["s"][dst]) + jump
    st["disp_base"] = st["disp_base"] + moving.to(add.dtype)[..., None] * add[:, None, :]
    if "hist" in stats:
        b, inr = hist_bins(norm_jump_f32(jump32), *hist_cfg)
        hit = fire & inr
        stats["hist"].index_put_((torch.nonzero(hit)[:, 0], b[hit]),
                                 torch.ones_like(b[hit]), accumulate=True)
    if "matrix" in stats:
        stats["matrix"].index_put_((s_, d_), torch.ones_like(s_), accumulate=True)


def norm_jump_f32(j: torch.Tensor) -> torch.Tensor:
    """The kernels' jump length: sqrt((jx^2 + jy^2) + jz^2) in float32."""
    sq = j[..., 0] * j[..., 0]
    sq = sq + j[..., 1] * j[..., 1]
    return sqrt_f32(sq + j[..., 2] * j[..., 2])


def hist_bins(d32, nbins: int, lo: float, hi: float):
    """(bin, in range) of float32 distances over [lo, hi) in nbins bins."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    scale = np.float32(float(nbins) / max(hi - lo, 1e-12))
    inr = (d32 >= float(lo32)) & (d32 < float(hi32))
    raw = ((d32 - float(lo32)) * float(scale)).to(torch.int32)
    return torch.clamp(raw, 0, nbins - 1).long(), inr


def _state(state: dict, dtype):
    st = {k: v.clone() for k, v in state.items()}
    for k in ("occ", "tlast", "disp_base", "u", "s"):
        st[k] = st[k].to(dtype)
    return st


def dense_loop(w, dist32, pos32, state: dict, frame0: int, ridx, *, tile, seed, dt,
               max_events, box, dtype=torch.float64, hist=None, matrix=False):
    """Advance the replicas ``ridx`` (global indices, for the draw keys)
    across the frames of a block under the dense rates ``w`` [B, N, N].
    ``state``: occ [R, N] 0/1, labels [R, N] (0 empty), sites [R, P],
    tlast [R, P], disp_base [R, P, 3], u [R], evc [R] of those replicas and
    the shared s, prev [N, 3]. ``hist`` = (nbins, lo, hi) adds the jump
    histogram and its exposure (``hist``, ``expo`` [R, nbins] in the state);
    ``matrix`` counts the jumps src -> dst over these replicas. Returns
    (state, margin [R], stats)."""
    st = _state(state, dtype)
    R, N = st["occ"].shape
    dev = st["occ"].device
    tid, rin = ridx // tile, ridx % tile
    ctr = rin[:, None] * N + torch.arange(N, device=dev)
    margin = torch.full((R,), float("inf"), dtype=torch.float64, device=dev)
    stats = {}
    if hist:
        stats["hist"] = st.pop("hist").clone()
        expo = st.pop("expo").to(torch.float64)
    if matrix:
        stats["matrix"] = torch.zeros((N, N), dtype=torch.int64, device=dev)
    w = w.to(dtype)
    pos = pos32.to(dtype)
    clock_drift = torch.zeros(R, dtype=torch.float64, device=dev)
    for f in range(pos.shape[0]):
        wf, post, post32 = w[f], pos[f], pos32[f]
        st["s"] = st["s"] + minimg(post - st["prev"].to(dtype), box)
        st["prev"] = pos32[f]
        frame_idx = frame0 + f
        phase = torch.zeros(R, dtype=dtype, device=dev)
        done = torch.zeros(R, dtype=torch.bool, device=dev)
        for ev in range(max_events):
            if ev > 0 and bool(done.all()):
                break
            occ = st["occ"]
            row = occ * ((1 - occ) @ wf.T)
            total = row.sum(dim=1)
            budget = total * (dt - phase)
            active = ~done & (budget > 0)
            fire = active & (st["u"] <= budget)
            eph = phase + st["u"] / torch.where(total > 0, total, 1.0)
            src, m1 = _race(row, _draws(seed, tid, frame_idx, ev, 1, ctr, dtype))
            dst, m2 = _race(wf[src] * (1 - occ), _draws(seed, tid, frame_idx, ev, 2, ctr, dtype))
            clock = clock_margin(st["u"], budget, clock_drift)
            margin = torch.minimum(margin, torch.where(active, clock, float("inf")))
            margin = torch.minimum(margin, torch.where(fire, torch.minimum(m1, m2), float("inf")))
            jump = minimg(post[dst] - post[src], box)
            jump32 = minimg(post32[dst] - post32[src], box) if hist else None
            _apply(st, fire, src, dst, frame_idx * dt + eph, jump, stats, jump32, hist)
            fresh = _draws(seed, tid, frame_idx, ev, 3, rin[:, None], dtype)[:, 0]
            st["u"] = torch.where(fire, fresh, st["u"])
            st["evc"] = st["evc"] + fire.to(st["evc"].dtype)
            phase = torch.where(fire, eph, phase)
            done = done | ~fire
        occ = st["occ"]
        if hist:
            b, inr = hist_bins(dist32[f], *hist)
            oh = torch.nn.functional.one_hot(b, hist[0]).to(torch.float64)
            oh = oh * ((w[f] > 0) & inr)[..., None]
            o64 = occ.double()
            tmp = (o64 @ oh.reshape(N, -1)).reshape(R, N, hist[0])
            expo = expo + (tmp * (1 - o64)[..., None]).sum(dim=1)
        total = (occ * ((1 - occ) @ wf.T)).sum(dim=1)
        st["u"] = st["u"] - total * (dt - phase)
        clock_drift = clock_drift + clock_drift_step(total, dt)
    if hist:
        st["hist"], st["expo"] = stats["hist"], expo
    return st, margin, stats


def topk_rates(topd32, law) -> torch.Tensor:
    """omega [.., K, N] float64 of the tables: law(min(d, 50)), 0 where exhausted."""
    d = topd32.double()
    return torch.where(d < 1.0e5, fermi(d.clamp(max=50.0), law), 0.0)


def topk_loop(omega, topi, pos32, state: dict, frame0: int, ridx, *, tile, seed, dt,
              max_events, box, dtype=torch.float64):
    """Advance the replicas ``ridx`` across a block under the top-K rates
    ``omega`` [B, K, N] to the neighbours ``topi`` [B, K, N]: the slot race
    over each slot's summed rates, then the source race inside the slot.
    ``state`` as for :func:`dense_loop`. Each event iteration works on the
    replicas still firing in the frame only (a replica that stopped stays
    stopped, so the others' iterations are no-ops). Returns (state, margin
    [R])."""
    st = _state(state, dtype)
    R, N = st["occ"].shape
    K = topi.shape[1]
    dev = st["occ"].device
    tid, rin = ridx // tile, ridx % tile
    ctr_k = rin[:, None] * K + torch.arange(K, device=dev)
    ctr_n = rin[:, None] * N + torch.arange(N, device=dev)
    margin = torch.full((R,), float("inf"), dtype=torch.float64, device=dev)
    omega = omega.to(dtype)
    pos = pos32.to(dtype)
    clock_drift = torch.zeros(R, dtype=torch.float64, device=dev)

    def rates_of(f, occ):
        return omega[f][None] * occ[:, None, :] * (1 - occ[:, topi[f]])

    for f in range(pos.shape[0]):
        post = pos[f]
        st["s"] = st["s"] + minimg(post - st["prev"].to(dtype), box)
        st["prev"] = pos32[f]
        frame_idx = frame0 + f
        phase = torch.zeros(R, dtype=dtype, device=dev)
        act = torch.arange(R, device=dev)  # the replicas still firing
        for ev in range(max_events):
            if act.numel() == 0:
                break
            rates = rates_of(f, st["occ"][act])
            sums = rates.sum(dim=2)
            total = sums.sum(dim=1)
            ph, u = phase[act], st["u"][act]
            budget = total * (dt - ph)
            active = budget > 0
            fire_a = active & (u <= budget)
            eph = ph + u / torch.where(total > 0, total, 1.0)
            kbest, m1 = _race(sums, _draws(seed, tid[act], frame_idx, ev, 11, ctr_k[act], dtype))
            src, m2 = _race(rates[torch.arange(act.numel(), device=dev), kbest],
                            _draws(seed, tid[act], frame_idx, ev, 12, ctr_n[act], dtype))
            dst = topi[f][kbest, src]
            clock = clock_margin(u, budget, clock_drift[act])
            m = torch.minimum(torch.where(active, clock, float("inf")),
                              torch.where(fire_a, torch.minimum(m1, m2), float("inf")))
            margin[act] = torch.minimum(margin[act], m)
            fire = torch.zeros(R, dtype=torch.bool, device=dev)
            fire[act] = fire_a
            src_r = torch.zeros(R, dtype=torch.int64, device=dev)
            dst_r = torch.zeros(R, dtype=torch.int64, device=dev)
            eph_r = phase.clone()
            src_r[act], dst_r[act], eph_r[act] = src, dst, eph
            jump = minimg(post[dst_r] - post[src_r], box)
            _apply(st, fire, src_r, dst_r, frame_idx * dt + eph_r, jump, {}, None, None)
            fresh = _draws(seed, tid, frame_idx, ev, 3, rin[:, None], dtype)[:, 0]
            st["u"] = torch.where(fire, fresh, st["u"])
            st["evc"] = st["evc"] + fire.to(st["evc"].dtype)
            phase = torch.where(fire, eph_r, phase)
            act = act[fire_a]
        total = rates_of(f, st["occ"]).sum(dim=(1, 2))
        st["u"] = st["u"] - total * (dt - phase)
        clock_drift = clock_drift + clock_drift_step(total, dt)
    return st, margin


# -- the rows ------------------------------------------------------------------

def row(sites, disp_base, autocorr_ref, jumps, site_disp, reset: bool,
        dtype=torch.float64) -> np.ndarray:
    """The ensemble row at a print frame from a state (after the observable
    reset where the frame resets): msd mean (3), msd variance over replicas
    (3), autocorrelation mean and variance, jumps mean, mean |disp|^4;
    computed in ``dtype``, returned as float64."""
    sites = sites.long()
    s = site_disp.to(dtype)
    db = disp_base.to(dtype)
    if reset:
        db = -s[sites]
        jumps = torch.zeros_like(jumps)
        autocorr_ref = sites
    disp = db + s[sites]
    P = disp.shape[1]
    msd = (disp * disp).sum(dim=1) / P
    auto = (sites == autocorr_ref.long()).sum(dim=1).to(dtype)
    r2 = (disp * disp).sum(dim=-1)
    out = torch.cat([msd.mean(dim=0), msd.var(dim=0, correction=0),
                     torch.stack([auto.mean(), auto.var(correction=0),
                                  jumps.to(dtype).mean(), (r2 * r2).mean(dim=1).mean()])])
    return out.double().cpu().numpy()
