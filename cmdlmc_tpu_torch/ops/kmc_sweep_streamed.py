"""Streamed-W KMC sweep: kernel K1, its plain version, and stage 1.

Port of ``cmdlmc_tpu/ops/kmc_sweep_streamed.py`` in rows semantics
(``layout="rows"``, ``pack=1``), with and without ``stale`` rates, for
orthorhombic and triclinic cells (the round-based h / h^-1 minimum image,
exact where cutoff + buffer stays under half the smallest cell height),
with the jump-distance histogram and its exposure (``nbins``) and the jump
matrix (``track_matrix``). Stage 1 (:func:`dense_tables`) builds the
per-frame rate matrices W [B, N, N] with the model's ``shared``
(``PairRates`` or ``AnglePairRates``, whose W is asymmetric), and with
``nbins`` the raw distances beside them; stage 2 advances every replica
through those frames: the CUDA kernel ``csrc/kmc_sweep_streamed.cu`` for
tensors on the card, :func:`kmc_sweep_streamed_reference` for tensors on
the CPU. The kernel keeps each frame's W as row and column lists of its
nonzero entries, sized by the longest row and column of the block, which a
small kernel counts on the device before the sweep (:func:`list_caps`), so
the host does not wait for the device.

Draws are keyed by (seed, global tile, absolute frame, event, salt) with the
counter ``replica_in_tile * n + slot`` (``ops/rng.py``), so results do not
depend on how the host chunks the frames, and ``tile`` (the logical RNG tile
of the JAX package) is independent of the CUDA launch shape.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from cmdlmc_tpu_torch.core.cell import sqrt32
from cmdlmc_tpu_torch.ops import build, rng
from cmdlmc_tpu_torch.utils import trace

# Replicas (warps) per thread block of K1 (csrc/kmc_sweep_streamed.cu::
# K1_WARPS): the launch shape, independent of the logical RNG tile.
WARPS_PER_BLOCK = 32
# Bytes of global scratch a launch may take for row and column lists of
# unknown length (every row whole) where they may not fit in shared memory;
# past it the host reads the counted lengths (one device sync) and sizes the
# scratch to them.
LIST_SCRATCH_BUDGET = 1 << 30


def dense_tables(model, positions_block: torch.Tensor,
                 extras_block: torch.Tensor | None = None, nbins: int = 0):
    """Stage 1: per-frame masked rate matrices W [B, N, N] for a block of
    donor positions [B, N, 3] and, for AngleTopology, the extra atoms'
    positions [B, M, 3] (K2 supplies the distances on the card, or the
    triclinic torch distance). With ``nbins > 0`` returns (W, dist), the
    raw distances [B, N, N] the exposure bins."""
    from cmdlmc_tpu_torch.topo.models import Frame

    sh = model.shared(Frame(donors=positions_block, extras=extras_block))
    return (sh.W, sh.dist) if nbins else sh.W


def _outputs(occ, labels, sites, tlast, disp_base, u_rem, ev_count,
             site_disp, prev_pos, trunc) -> dict:
    return {
        "occ": occ, "labels": labels, "sites": sites, "tlast": tlast,
        "disp_base": disp_base, "u_rem": u_rem, "ev_count": ev_count,
        "site_disp": site_disp, "prev_pos": prev_pos, "trunc": trunc,
    }


def minimg3(d: torch.Tensor, geometry) -> torch.Tensor:
    """The kernels' round-based minimum image of [..., 3] vectors in the
    cell of ``geometry``, h then h^-1 as 18 host floats
    (``Cell.host_geometry``): h^-1 d, round, h, each row product summed in
    index order with one rounding per operation (as the TPU kernels sum
    it). Exact for vectors shorter than half the smallest cell height."""
    f32 = np.float32
    h = [geometry[0:3], geometry[3:6], geometry[6:9]]
    hinv = [geometry[9:12], geometry[12:15], geometry[15:18]]
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    fr = [(f32(m[0]) * x + f32(m[1]) * y) + f32(m[2]) * z for m in hinv]
    fr = [v - torch.round(v) for v in fr]
    return torch.stack([(f32(m[0]) * fr[0] + f32(m[1]) * fr[1]) + f32(m[2]) * fr[2]
                        for m in h], dim=-1)


def hist_constants(nbins: int, hist_range) -> tuple:
    """(lo, hi, scale) of the histogram in float32, as the TPU kernels take
    them: the range [lo, hi) and nbins / (hi - lo) bins per unit."""
    lo, hi = float(hist_range[0]), float(hist_range[1])
    scale = float(nbins) / max(hi - lo, 1e-12)
    return np.float32(lo), np.float32(hi), np.float32(scale)


def histogram_bins(d: torch.Tensor, nbins: int, hist_range):
    """(bin, in range) of distances ``d``: clip(int((d - lo) scale), 0,
    nbins - 1), counted where lo <= d < hi."""
    lo, hi, scale = hist_constants(nbins, hist_range)
    inr = (d >= float(lo)) & (d < float(hi))
    raw = ((d - float(lo)) * float(scale)).to(torch.int32)
    return torch.clamp(raw, 0, nbins - 1).long(), inr


def _jump_length(jump: torch.Tensor) -> torch.Tensor:
    """sqrt(((0 + jx^2) + jy^2) + jz^2) of [..., 3] jump vectors."""
    sq = jump[..., 0] * jump[..., 0]
    sq = sq + jump[..., 1] * jump[..., 1]
    return sqrt32(sq + jump[..., 2] * jump[..., 2])


def exposure_counts(w, dist, occ, nbins: int, hist_range) -> torch.Tensor:
    """[R, nbins] per-bin sums over the pairs (i, j) with W[i, j] > 0 and
    lo <= dist[i, j] < hi of occ[r, i] (1 - occ[r, j]), for one frame's W and
    distances [N, N]: the exposure the kernels add at frame end (whole
    numbers for a 0/1 occupancy)."""
    b, inr = histogram_bins(dist, nbins, hist_range)
    onehot = F.one_hot(b, nbins).to(torch.float32) * ((w > 0) & inr)[..., None]
    n = w.shape[-1]
    tmp = (occ @ onehot.reshape(n, n * nbins)).reshape(-1, n, nbins)
    return (tmp * (1.0 - occ)[..., None]).sum(dim=1)


def kmc_sweep_streamed_reference(
    w_block, positions, prev_pos, site_disp, occ, labels, sites, tlast,
    disp_base, u_rem, ev_count, frame0: int, box, tile_offset: int = 0, *,
    tile: int, max_events: int, dt: float, seed: int, stale: bool = False,
    geometry=None, dist_block=None, jump_hist=None, exposure=None,
    nbins: int = 0, hist_range=(2.0, 3.0), track_matrix: bool = False,
) -> dict:
    """Plain PyTorch version of K1: the reference's event loop, vectorized
    over replicas, one frame and one event iteration at a time (arguments
    as :func:`kmc_sweep_streamed`)."""
    B, N, _ = positions.shape
    R = occ.shape[0]
    dev = occ.device
    f32 = torch.float32
    dt32 = torch.tensor(dt, dtype=f32, device=dev)
    if geometry is None:
        box_t = torch.tensor([float(x) for x in box], dtype=f32, device=dev)

        def minimg(d):
            return d - box_t * torch.round(d / box_t)
    else:
        def minimg(d):
            return minimg3(d, geometry)
    hist = expo = jm = None
    if nbins:
        hist, expo = jump_hist.clone(), exposure.clone()
    if track_matrix:
        jm = torch.zeros((N, N), dtype=torch.int32, device=dev)

    def total_rate(occ, W):
        out = (1.0 - occ) @ W.T  # out[r, i] = sum_j W[i, j] (1 - occ[r, j])
        row = occ * out
        return row, row.sum(dim=1)

    r_idx = torch.arange(R, device=dev)
    tid = r_idx // tile + tile_offset
    rin = r_idx % tile
    ctr_n = rin[:, None] * N + torch.arange(N, device=dev)
    s, prev = site_disp, prev_pos
    u, evc = u_rem, ev_count
    trunc = torch.zeros(R, dtype=torch.int32, device=dev)

    for f in range(B):
        W = w_block[f]
        post = positions[f]
        s = s + minimg(post - prev)
        prev = post
        frame_idx = int(frame0) + f
        frame_time = torch.tensor(float(frame_idx), dtype=f32, device=dev) * dt32
        phase = torch.zeros(R, dtype=f32, device=dev)
        done = torch.zeros(R, dtype=torch.bool, device=dev)
        if stale:
            row0, total0 = total_rate(occ, W)
        for ev in range(max_events):
            if ev > 0 and bool(done.all()):
                break  # iterations of done replicas change nothing
            if stale:
                row, total = row0 * occ, total0
            else:
                row, total = total_rate(occ, W)
            budget = total * (dt32 - phase)
            fire = ~done & (u <= budget) & (budget > 0)
            eph = phase + u / torch.where(total > 0, total, 1.0)

            def uniform(salt, counter):
                key = rng.mix_key(seed, tid, frame_idx, ev, salt)
                return rng.u01_counter(key[:, None], counter)

            def race(rates, salt):
                # E = 0 - log(u) is +0 for a draw of exactly 1.0 (which 24 set
                # bits round to), so that candidate wins outright if its rate
                # is positive; a zero rate races with 0, never with 0/0 = NaN
                e = 0.0 - torch.log(uniform(salt, ctr_n))
                return torch.argmax(torch.where(rates > 0, rates / e, 0.0), dim=1)

            src = race(row, 1)
            w2 = W[src] * (1.0 - occ)
            dst = race(w2, 2)

            firef = fire.to(f32)[:, None]
            oh_src = F.one_hot(src, N).to(f32)
            oh_dst = F.one_hot(dst, N).to(f32)
            label = labels.gather(1, src[:, None])
            occ = occ + firef * (oh_dst - oh_src)
            labels = labels * (1.0 - firef * (oh_src + oh_dst)) + firef * oh_dst * label

            moving = (sites == src[:, None]) & fire[:, None]
            sites = torch.where(moving, dst[:, None].to(sites.dtype), sites)
            tlast = torch.where(moving, (frame_time + eph)[:, None], tlast)
            jump = minimg(post[dst] - post[src])  # [R, 3]
            add = (s[src] - s[dst]) + jump
            disp_base = disp_base + moving.to(f32)[..., None] * add[:, None, :]
            if nbins:
                b, inr = histogram_bins(_jump_length(jump), nbins, hist_range)
                hit = fire & inr
                hist.index_put_((r_idx[hit], b[hit]),
                                torch.ones_like(b[hit], dtype=hist.dtype),
                                accumulate=True)
            if track_matrix:
                jm.index_put_((src[fire], dst[fire]),
                              torch.ones_like(src[fire], dtype=jm.dtype),
                              accumulate=True)

            u = torch.where(fire, -torch.log(uniform(3, rin[:, None]))[:, 0], u)
            evc = evc + fire.to(evc.dtype)
            phase = torch.where(fire, eph, phase)
            done = done | ~fire
        trunc = trunc + (~done).to(torch.int32)
        if nbins:
            expo = expo + exposure_counts(W, dist_block[f], occ, nbins, hist_range)
        total_end = total0 if stale else total_rate(occ, W)[1]
        u = u - total_end * (dt32 - phase)

    out = _outputs(occ, labels, sites, tlast, disp_base, u, evc, s, prev, trunc)
    return _with_stats(out, hist, expo, jm)


def _with_stats(out: dict, hist, expo, jm) -> dict:
    """``out`` with the statistics that are on (None: off)."""
    if hist is not None:
        out["jump_hist"], out["exposure"] = hist, expo
    if jm is not None:
        out["jump_matrix"] = jm
    return out


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"kmc_sweep_streamed: {name} must be {dtype} {tuple(shape)} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def list_caps(w_block: torch.Tensor) -> torch.Tensor:
    """The most nonzero entries (NaN included) of any row and of any column
    of W [B, N, N], as int32 [2] on W's device: the list lengths K1 is sized
    for. On the card a small kernel counts them without a host wait."""
    B, N = w_block.shape[0], w_block.shape[-1]
    if B == 0:
        return torch.zeros(2, dtype=torch.int32, device=w_block.device)
    if w_block.device.type == "cpu":
        nz = w_block != 0
        return torch.stack([nz.sum(dim=-1).amax(),
                            nz.sum(dim=-2).amax()]).to(torch.int32)
    w = w_block.contiguous()
    caps = torch.empty(2, dtype=torch.int32, device=w.device)
    build.check(build.library().cmdlmc_kmc_sweep_streamed_caps(
        w.data_ptr(), B, N, caps.data_ptr(), build.stream_of(w),
        w.device.index or 0), "kmc_sweep_streamed list count")
    return caps


def list_bytes(n_sites: int, cap: int, ccap: int, stats: bool = False) -> int:
    """Bytes of one block's row and column lists of ``cap`` and ``ccap``
    entries (K1 and K3 alike; with ``stats`` the kernels' with jump
    statistics, whose lists carry each entry's exposure bin)."""
    return int(build.library().cmdlmc_sweep_list_bytes(
        int(n_sites), int(cap), int(ccap), int(stats)))


def list_scratch(n_sites: int, blocks: int, list_budget: int,
                 caps: torch.Tensor, stats: bool = False
                 ) -> tuple[torch.Tensor | None, int]:
    """Global scratch for one launch's lists and the bytes of each block's
    slice: none where even whole rows fit in the block's ``list_budget``
    bytes of shared memory; else whole-row slices while they fit in
    LIST_SCRATCH_BUDGET, and past it slices of the counted ``caps`` (the
    one case that waits for the device)."""
    slice_ = list_bytes(n_sites, n_sites, n_sites, stats)
    if slice_ <= list_budget:
        return None, 0
    if blocks * slice_ > LIST_SCRATCH_BUDGET:
        with trace.sync("list_caps"):
            slice_ = list_bytes(n_sites, *caps.tolist(), stats)
        if slice_ <= list_budget:
            return None, 0
    return (torch.empty(blocks * slice_, dtype=torch.uint8, device=caps.device),
            slice_)


def stats_kwargs(rep, hist_range) -> dict:
    """The sweeps' jump-statistics keywords for a ReplicaState: its
    histograms where they have bins, the matrix where it is tracked."""
    nbins = rep.jump_hist.shape[-1]
    return dict(jump_hist=rep.jump_hist if nbins else None,
                exposure=rep.opportunity_hist if nbins else None, nbins=nbins,
                hist_range=tuple(hist_range),
                track_matrix=rep.jump_matrix.shape[-1] != 0)


def stats_args(R: int, N: int, nbins: int, hist_range, track_matrix: bool,
               jump_hist, exposure, dev) -> tuple:
    """The statistics outputs of one launch (K1, K3, K4): copies of the
    histograms [R, nbins] the kernel updates in place (None without
    ``nbins``), a zeroed int32 [N, N] jump matrix (None without
    ``track_matrix``), and the launch's arguments for them: the five
    pointers and flags (hist, expo, jm, stats, nbins) and the histogram's
    (lo, hi, scale)."""
    hist = expo = jm = None
    if not 0 <= nbins < 0xFFFF:  # the kernels mark entries out of range 0xFFFF
        raise ValueError(f"nbins must be in [0, 65535), got {nbins}")
    if nbins:
        for name, t, dtype in (("jump_hist", jump_hist, torch.int32),
                               ("exposure", exposure, torch.float32)):
            _check(name, t, dtype, (R, nbins), dev)
        hist, expo = jump_hist.contiguous().clone(), exposure.contiguous().clone()
    if track_matrix:
        jm = torch.zeros((N, N), dtype=torch.int32, device=dev)
    lo, hi, scale = hist_constants(nbins, hist_range) if nbins else (0.0, 0.0, 0.0)
    ptrs = [None if t is None else t.data_ptr() for t in (hist, expo, jm)]
    return (hist, expo, jm,
            (*ptrs, int(bool(nbins or track_matrix)), int(nbins),
             float(lo), float(hi), float(scale)))


def kmc_sweep_streamed(
    w_block, positions, prev_pos, site_disp, occ, labels, sites, tlast,
    disp_base, u_rem, ev_count, frame0: int, box, tile_offset: int = 0, *,
    tile: int, max_events: int, dt: float, seed: int, stale: bool = False,
    geometry=None, dist_block=None, jump_hist=None, exposure=None,
    nbins: int = 0, hist_range=(2.0, 3.0), track_matrix: bool = False,
) -> dict:
    """Advance every replica across a block of frames: K1 for CUDA tensors,
    the plain version for CPU tensors. ``box`` holds the three orthorhombic
    box lengths as floats; a triclinic cell passes ``geometry`` instead, its
    h then h^-1 as 18 host floats (``Cell.host_geometry``; ``box`` is then
    unused). Returns the updated state as a dict (occ, labels, sites, tlast,
    disp_base, u_rem, ev_count, site_disp, prev_pos, trunc), like the JAX
    function; the inputs are left unchanged. With ``nbins > 0`` the jump
    histogram ``jump_hist`` (int32 [R, nbins]) and its ``exposure`` (float32
    [R, nbins]) over ``hist_range`` advance too, the exposure from the raw
    distances ``dist_block`` [B, N, N] (``dense_tables``), and the dict
    also holds them; with ``track_matrix`` it holds the block's
    ``jump_matrix``, int32 [N, N], the fired jumps src -> dst summed over
    the replicas."""
    B, N, _ = positions.shape
    R = occ.shape[0]
    P = sites.shape[1]
    if R % tile:
        raise ValueError(f"tile ({tile}) must divide the replica count ({R})")
    if max_events < 1:
        raise ValueError("max_events must be >= 1")
    if nbins < 0:
        raise ValueError("nbins must be >= 0")
    if nbins and (dist_block is None or jump_hist is None or exposure is None):
        raise ValueError("nbins > 0 needs dist_block, jump_hist and exposure")
    if geometry is not None and len(geometry) != 18:
        raise ValueError("geometry must hold the 18 values of h and h^-1")
    kw = dict(tile=tile, max_events=max_events, dt=dt, seed=seed, stale=stale,
              geometry=geometry, dist_block=dist_block, jump_hist=jump_hist,
              exposure=exposure, nbins=nbins, hist_range=hist_range,
              track_matrix=track_matrix)
    dev = occ.device
    if dev.type == "cpu":
        return kmc_sweep_streamed_reference(
            w_block, positions, prev_pos, site_disp, occ, labels, sites,
            tlast, disp_base, u_rem, ev_count, frame0, box, tile_offset, **kw,
        )
    if dev.type != "cuda":
        raise ValueError(f"kmc_sweep_streamed: unsupported device {dev}")
    f32, i32 = torch.float32, torch.int32
    checks = [
        ("w_block", w_block, f32, (B, N, N)),
        ("positions", positions, f32, (B, N, 3)),
        ("prev_pos", prev_pos, f32, (N, 3)),
        ("site_disp", site_disp, f32, (N, 3)),
        ("occ", occ, f32, (R, N)),
        ("labels", labels, f32, (R, N)),
        ("sites", sites, i32, (R, P)),
        ("tlast", tlast, f32, (R, P)),
        ("disp_base", disp_base, f32, (R, P, 3)),
        ("u_rem", u_rem, f32, (R,)),
        ("ev_count", ev_count, i32, (R,)),
    ]
    if nbins:
        checks.append(("dist_block", dist_block, f32, (B, N, N)))
    for name, t, dtype, shape in checks:
        _check(name, t, dtype, shape, dev)
    # the kernel updates replica state in place: work on copies
    state = [t.contiguous().clone() for t in
             (occ, labels, sites, tlast, disp_base, u_rem, ev_count)]
    hist, expo, jm, stat_args = stats_args(R, N, nbins, hist_range, track_matrix,
                                           jump_hist, exposure, dev)
    w = w_block.contiguous()
    dist = dist_block.contiguous() if nbins else None
    pos = positions.contiguous()
    prev_in = prev_pos.contiguous()
    s_in = site_disp.contiguous()
    s_out = torch.empty_like(s_in)
    prev_out = torch.empty_like(prev_in)
    trunc = torch.empty(R, dtype=i32, device=dev)
    if B == 0 or R == 0:
        trunc.zero_()
        return _with_stats(_outputs(*state, s_in.clone(), prev_in.clone(), trunc),
                           hist, expo, jm)
    stats = bool(nbins or track_matrix)
    tri = geometry is not None
    lx, ly, lz = (0.0, 0.0, 0.0) if tri else (float(x) for x in box)
    caps = list_caps(w)
    plan = _plan(N, dev.index or 0, stats, int(nbins), tri)
    lists, slice_ = list_scratch(N, -(-R // WARPS_PER_BLOCK),
                                 plan["list_budget"], caps, stats)
    lib = build.library()
    args = (
        w.data_ptr(), pos.data_ptr(), prev_in.data_ptr(), s_in.data_ptr(),
        prev_out.data_ptr(), s_out.data_ptr(),
        *(t.data_ptr() for t in state), trunc.data_ptr(),
        R, N, P, B, int(tile), int(tile_offset), int(frame0),
        int(max_events), int(bool(stale)), caps.data_ptr(),
        None if lists is None else lists.data_ptr(), slice_,
        float(np.float32(dt)), int(seed) & 0xFFFFFFFF, lx, ly, lz,
    )
    geom = (ctypes.c_float * 18)(*geometry) if tri else None
    kmc_sweep_streamed.launches += 1
    build.check(lib.cmdlmc_kmc_sweep_streamed(
        *args, None if dist is None else dist.data_ptr(), *stat_args, int(tri),
        geom, build.stream_of(w), dev.index or 0), "kmc_sweep_streamed kernel")
    return _with_stats(_outputs(*state, s_out, prev_out, trunc), hist, expo, jm)


kmc_sweep_streamed.launches = 0


@functools.lru_cache(maxsize=None)
def _plan(n_sites: int, device_index: int, stats: bool = False, nbins: int = 0,
          tri: bool = False) -> dict:
    smem, budget = ctypes.c_longlong(0), ctypes.c_longlong(0)
    per_sm = ctypes.c_int(0)
    code = build.library().cmdlmc_kmc_sweep_streamed_plan(
        int(n_sites), int(stats), int(nbins), int(tri), device_index,
        ctypes.byref(smem), ctypes.byref(budget), ctypes.byref(per_sm))
    if code:
        raise ValueError(f"kmc_sweep_streamed: no launch at N={n_sites}: the "
                         "block does not fit in shared memory")
    return {"smem": smem.value, "list_budget": budget.value,
            "blocks_per_sm": per_sm.value, "warps": WARPS_PER_BLOCK}


def launch_plan(n_sites: int, caps, device: torch.device, nbins: int = 0,
                track_matrix: bool = False, triclinic: bool = False) -> dict:
    """K1's launch plan at ``n_sites`` (for the kernel with jump statistics
    where ``nbins`` or ``track_matrix``, for a triclinic cell where
    ``triclinic``): a block's dynamic shared memory in bytes (as much as its
    occupancy leaves it) and of that the bytes left for lists, the blocks
    one SM holds, the warps per block, and whether lists of ``caps``
    (longest row, longest column; :func:`list_caps`) live in shared memory
    (else in global scratch). Raises ValueError where no block fits."""
    stats = bool(nbins or track_matrix)
    plan = dict(_plan(int(n_sites), device.index or 0, stats, int(nbins),
                      bool(triclinic)))
    plan["lists_in_smem"] = list_bytes(n_sites, *caps, stats) <= plan["list_budget"]
    return plan
