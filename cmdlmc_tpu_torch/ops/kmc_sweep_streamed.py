"""Streamed-W KMC sweep: kernel K1, its plain version, and stage 1.

Port of ``cmdlmc_tpu/ops/kmc_sweep_streamed.py`` in rows semantics
(``layout="rows"``, ``pack=1``) for orthorhombic cells, with and without
``stale`` rates. Stage 1 (:func:`dense_tables`) builds the per-frame rate
matrices W [B, N, N] with the model's ``shared`` (``PairRates`` or
``AnglePairRates``, whose W is asymmetric); stage 2 advances every
replica through those frames: the CUDA kernel ``csrc/kmc_sweep_streamed.cu``
for tensors on the card, :func:`kmc_sweep_streamed_reference` for tensors on
the CPU. The kernel keeps each frame's W as row and column lists of its
nonzero entries, sized by the longest row and column of the block, which a
small kernel counts on the device before the sweep (:func:`list_caps`), so
the host does not wait for the device. Jump statistics, the jump matrix and
triclinic cells wait for ROADMAP A11.

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

from cmdlmc_tpu_torch.ops import build, rng

# Replicas (warps) per thread block of K1 (csrc/kmc_sweep_streamed.cu::
# K1_WARPS): the launch shape, independent of the logical RNG tile.
WARPS_PER_BLOCK = 32
# Bytes of global scratch a launch may take for row and column lists of
# unknown length (every row whole) where they may not fit in shared memory;
# past it the host reads the counted lengths (one device sync) and sizes the
# scratch to them.
LIST_SCRATCH_BUDGET = 1 << 30


def dense_tables(model, positions_block: torch.Tensor,
                 extras_block: torch.Tensor | None = None) -> torch.Tensor:
    """Stage 1: per-frame masked rate matrices W [B, N, N] for a block of
    donor positions [B, N, 3] and, for AngleTopology, the extra atoms'
    positions [B, M, 3] (K2 supplies the distances on the card)."""
    from cmdlmc_tpu_torch.topo.models import Frame

    return model.shared(Frame(donors=positions_block, extras=extras_block)).W


def _outputs(occ, labels, sites, tlast, disp_base, u_rem, ev_count,
             site_disp, prev_pos, trunc) -> dict:
    return {
        "occ": occ, "labels": labels, "sites": sites, "tlast": tlast,
        "disp_base": disp_base, "u_rem": u_rem, "ev_count": ev_count,
        "site_disp": site_disp, "prev_pos": prev_pos, "trunc": trunc,
    }


def kmc_sweep_streamed_reference(
    w_block, positions, prev_pos, site_disp, occ, labels, sites, tlast,
    disp_base, u_rem, ev_count, frame0: int, box, tile_offset: int = 0, *,
    tile: int, max_events: int, dt: float, seed: int, stale: bool = False,
) -> dict:
    """Plain PyTorch version of K1: the reference's event loop, vectorized
    over replicas, one frame and one event iteration at a time."""
    B, N, _ = positions.shape
    R = occ.shape[0]
    dev = occ.device
    f32 = torch.float32
    box_t = torch.tensor([float(x) for x in box], dtype=f32, device=dev)
    dt32 = torch.tensor(dt, dtype=f32, device=dev)

    def minimg(d):
        return d - box_t * torch.round(d / box_t)

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
            add = (s[src] - s[dst]) + minimg(post[dst] - post[src])  # [R, 3]
            disp_base = disp_base + moving.to(f32)[..., None] * add[:, None, :]

            u = torch.where(fire, -torch.log(uniform(3, rin[:, None]))[:, 0], u)
            evc = evc + fire.to(evc.dtype)
            phase = torch.where(fire, eph, phase)
            done = done | ~fire
        trunc = trunc + (~done).to(torch.int32)
        total_end = total0 if stale else total_rate(occ, W)[1]
        u = u - total_end * (dt32 - phase)

    return _outputs(occ, labels, sites, tlast, disp_base, u, evc, s, prev, trunc)


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


def list_bytes(n_sites: int, cap: int, ccap: int) -> int:
    """Bytes of one block's row and column lists of ``cap`` and ``ccap``
    entries (K1 and K3 alike)."""
    return int(build.library().cmdlmc_sweep_list_bytes(
        int(n_sites), int(cap), int(ccap)))


def list_scratch(n_sites: int, blocks: int, list_budget: int,
                 caps: torch.Tensor) -> tuple[torch.Tensor | None, int]:
    """Global scratch for one launch's lists and the bytes of each block's
    slice: none where even whole rows fit in the block's ``list_budget``
    bytes of shared memory; else whole-row slices while they fit in
    LIST_SCRATCH_BUDGET, and past it slices of the counted ``caps`` (the
    one case that waits for the device)."""
    slice_ = list_bytes(n_sites, n_sites, n_sites)
    if slice_ <= list_budget:
        return None, 0
    if blocks * slice_ > LIST_SCRATCH_BUDGET:
        if caps.is_cuda:
            torch.cuda.current_stream(caps.device).synchronize()
        slice_ = list_bytes(n_sites, *caps.tolist())
        if slice_ <= list_budget:
            return None, 0
    return (torch.empty(blocks * slice_, dtype=torch.uint8, device=caps.device),
            slice_)


def kmc_sweep_streamed(
    w_block, positions, prev_pos, site_disp, occ, labels, sites, tlast,
    disp_base, u_rem, ev_count, frame0: int, box, tile_offset: int = 0, *,
    tile: int, max_events: int, dt: float, seed: int, stale: bool = False,
) -> dict:
    """Advance every replica across a block of frames: K1 for CUDA tensors,
    the plain version for CPU tensors. ``box`` holds the three orthorhombic
    box lengths as floats. Returns the updated state as a dict (occ, labels,
    sites, tlast, disp_base, u_rem, ev_count, site_disp, prev_pos, trunc),
    like the JAX function; the inputs are left unchanged."""
    B, N, _ = positions.shape
    R = occ.shape[0]
    P = sites.shape[1]
    if R % tile:
        raise ValueError(f"tile ({tile}) must divide the replica count ({R})")
    if max_events < 1:
        raise ValueError("max_events must be >= 1")
    kw = dict(tile=tile, max_events=max_events, dt=dt, seed=seed, stale=stale)
    dev = occ.device
    if dev.type == "cpu":
        return kmc_sweep_streamed_reference(
            w_block, positions, prev_pos, site_disp, occ, labels, sites,
            tlast, disp_base, u_rem, ev_count, frame0, box, tile_offset, **kw,
        )
    if dev.type != "cuda":
        raise ValueError(f"kmc_sweep_streamed: unsupported device {dev}")
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype, shape in (
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
    ):
        _check(name, t, dtype, shape, dev)
    # the kernel updates replica state in place: work on copies
    state = [t.contiguous().clone() for t in
             (occ, labels, sites, tlast, disp_base, u_rem, ev_count)]
    w = w_block.contiguous()
    pos = positions.contiguous()
    prev_in = prev_pos.contiguous()
    s_in = site_disp.contiguous()
    s_out = torch.empty_like(s_in)
    prev_out = torch.empty_like(prev_in)
    trunc = torch.empty(R, dtype=i32, device=dev)
    if B == 0 or R == 0:
        trunc.zero_()
        return _outputs(*state, s_in.clone(), prev_in.clone(), trunc)
    lx, ly, lz = (float(x) for x in box)
    caps = list_caps(w)
    plan = _plan(N, dev.index or 0)
    lists, slice_ = list_scratch(N, -(-R // WARPS_PER_BLOCK),
                                 plan["list_budget"], caps)
    lib = build.library()
    kmc_sweep_streamed.launches += 1
    build.check(
        lib.cmdlmc_kmc_sweep_streamed(
            w.data_ptr(), pos.data_ptr(), prev_in.data_ptr(), s_in.data_ptr(),
            prev_out.data_ptr(), s_out.data_ptr(),
            *(t.data_ptr() for t in state), trunc.data_ptr(),
            R, N, P, B, int(tile), int(tile_offset), int(frame0),
            int(max_events), int(bool(stale)), caps.data_ptr(),
            None if lists is None else lists.data_ptr(), slice_,
            float(np.float32(dt)), int(seed) & 0xFFFFFFFF, lx, ly, lz,
            build.stream_of(w), dev.index or 0,
        ),
        "kmc_sweep_streamed kernel",
    )
    return _outputs(*state, s_out, prev_out, trunc)


kmc_sweep_streamed.launches = 0


@functools.lru_cache(maxsize=None)
def _plan(n_sites: int, device_index: int) -> dict:
    smem, budget = ctypes.c_longlong(0), ctypes.c_longlong(0)
    per_sm = ctypes.c_int(0)
    code = build.library().cmdlmc_kmc_sweep_streamed_plan(
        int(n_sites), device_index, ctypes.byref(smem), ctypes.byref(budget),
        ctypes.byref(per_sm))
    if code:
        raise ValueError(f"kmc_sweep_streamed: no launch at N={n_sites}: the "
                         "block does not fit in shared memory")
    return {"smem": smem.value, "list_budget": budget.value,
            "blocks_per_sm": per_sm.value, "warps": WARPS_PER_BLOCK}


def launch_plan(n_sites: int, caps, device: torch.device) -> dict:
    """K1's launch plan at ``n_sites``: a block's dynamic shared memory in
    bytes (as much as its occupancy leaves it) and of that the bytes left
    for lists, the blocks one SM holds, the warps per block, and whether
    lists of ``caps`` (longest row, longest column; :func:`list_caps`) live
    in shared memory (else in global scratch). Raises ValueError where no
    block fits."""
    plan = dict(_plan(int(n_sites), device.index or 0))
    plan["lists_in_smem"] = list_bytes(n_sites, *caps) <= plan["list_budget"]
    return plan
