"""In-kernel-W KMC sweep: kernel K3, its plain version, and the law packing.

Port of ``cmdlmc_tpu/ops/kmc_sweep.py`` for orthorhombic cells and the law
kinds 0 Fermi, 1 Constant, 2 Exponential, 3 ActivationEnergy and
4 FermiAngle (the P-O-O angle gate over AngleTopology). Each frame's rate
matrix W is built from the positions inside the kernel (no W in device
memory) as row and column lists of its nonzero entries, then every replica
runs the same event loop as kernel K1 (``csrc/event_loop.cuh``): the CUDA
kernel ``csrc/kmc_sweep.cu`` for tensors on the card,
:func:`kmc_sweep_reference` for tensors on the CPU. The lists are sized by
the most sites in range of any site over the block, which a small kernel
counts on the device before the sweep with K3's own range test
(:func:`range_caps`), so the host does not wait for the device. Jump
statistics and the jump matrix wait for ROADMAP A11.

Draws are keyed as in K1 (``ops/rng.py``), so for the same W the two routes
land in the same state. The W of kind 4 gates on a dot product against
cos(theta), as the TPU kernel does, while stage 1 (``AnglePairRates``) takes
the arccos: a pair within an ulp of theta can fall on either side.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cmdlmc_tpu_torch.core.cell import sqrt32
from cmdlmc_tpu_torch.ops import build
from cmdlmc_tpu_torch.ops import kmc_sweep_streamed as kss
from cmdlmc_tpu_torch.rates import laws as rate_laws

KIND_FERMI_ANGLE = 4
_LAW_KIND = {
    rate_laws.Fermi: 0,
    rate_laws.Constant: 1,
    rate_laws.Exponential: 2,
    rate_laws.ActivationEnergy: 3,
    rate_laws.FermiAngle: KIND_FERMI_ANGLE,
}

# Replicas (warps) per thread block of K3: the launch shape, independent of
# the logical RNG tile (PERF.md, PR 7: the fastest of 2, 4, 8 and 16 at
# R=1024, B=100 on the H100).
WARPS_PER_BLOCK = 16


def law_kind(law) -> int | None:
    """The kernel's law kind for ``law``; None if K3 cannot evaluate it."""
    return _LAW_KIND.get(type(law))


def law_params_array(law) -> torch.Tensor:
    """Law parameters as a float32 [6] CPU tensor. For FermiAngle slot 3
    holds cos(theta): the gate angle >= theta evaluates as
    dot(v1, v2) <= cos(theta) |v1| |v2|, with no arccos in the kernel."""
    hp = law.host_params
    if isinstance(law, rate_laws.FermiAngle):
        vals = [hp["a"], hp["b"], hp["c"], np.cos(hp["theta"])]
    elif isinstance(law, rate_laws.Fermi):
        vals = [hp["a"], hp["b"], hp["c"]]
    elif isinstance(law, rate_laws.Constant):
        vals = [hp["a"]]
    elif isinstance(law, rate_laws.Exponential):
        vals = [hp["a"], hp["b"]]
    elif isinstance(law, rate_laws.ActivationEnergy):
        vals = [hp["A"], hp["a"], hp["b"], hp["d0"], hp["T"]]
    else:
        raise ValueError(f"Unsupported law {type(law)}")
    out = np.zeros(6, np.float32)
    out[: len(vals)] = np.asarray(vals, np.float32)
    return torch.from_numpy(out)


def _apply_law(kind: int, dist: torch.Tensor, p) -> torch.Tensor:
    """Law ``kind`` at distances ``dist`` with parameters ``p`` (float32
    scalars), in the TPU kernel's operation order."""
    if kind in (0, KIND_FERMI_ANGLE):
        return p[0] / (1.0 + torch.exp((dist - p[1]) / p[2]))
    if kind == 1:
        return p[0].expand(dist.shape)
    if kind == 2:
        return p[0] * torch.exp(p[1] * dist)
    dd = dist - p[3]
    safe = torch.where(torch.abs(dd) > 1e-6, dd, 1e-6)
    # lax.rsqrt as 1 / sqrt, CUDA's 1.0f / sqrtf (XLA's CPU rsqrt is an
    # approximation an ulp or so away)
    rsqrt = 1.0 / sqrt32(p[2] + 1.0 / (safe * safe))
    energy = torch.clamp(p[1] * dd * rsqrt, min=0.0)
    kt = torch.tensor(rate_laws.KB_EV_PER_K, dtype=torch.float32,
                      device=dist.device) * p[4]
    return p[0] * torch.exp(-energy / kt)


def inkernel_tables(positions, law_params, box, pgrp_positions=None, *,
                    kind: int, cutbuf: float) -> torch.Tensor:
    """The W [B, N, N] that K3 builds per frame (ops/kmc_sweep.py:402-437 of
    the JAX package): d = minimg(pos_i - pos_j), dist = sqrt((dx^2 + dy^2) +
    dz^2), W = law(dist) where dist <= cutbuf and i != j; kind 4 also needs
    dot = -v1 . d <= cos(theta) |v1| dist with v1 = minimg(P(i) - O(i))."""
    dev = positions.device
    f32 = torch.float32
    p = torch.as_tensor(law_params, dtype=f32).to(dev)
    box_t = torch.tensor([float(x) for x in box], dtype=f32, device=dev)

    def minimg(d):
        return d - box_t * torch.round(d / box_t)

    dd, dist, valid = _in_range(positions, box, cutbuf)
    if kind == KIND_FERMI_ANGLE:
        v1 = minimg(pgrp_positions - positions)  # [B, N, 3]
        prod = v1[:, :, None, :] * dd
        dot = ((0.0 - prod[..., 0]) - prod[..., 1]) - prod[..., 2]
        n1 = (v1[..., 0] * v1[..., 0] + v1[..., 1] * v1[..., 1]) \
            + v1[..., 2] * v1[..., 2]
        valid = valid & (dot <= (p[3] * sqrt32(n1))[:, :, None] * dist)
    return torch.where(valid, _apply_law(kind, dist, p), 0.0)


def _in_range(positions, box, cutbuf: float):
    """d = minimg(pos_i - pos_j) [B, N, N, 3], dist = sqrt((dx^2 + dy^2) +
    dz^2) and the pairs in range (dist <= cutbuf, i != j), as K3 computes
    them."""
    dev = positions.device
    f32 = torch.float32
    box_t = torch.tensor([float(x) for x in box], dtype=f32, device=dev)
    dd = positions[:, :, None, :] - positions[:, None, :, :]
    dd = dd - box_t * torch.round(dd / box_t)
    sq = dd * dd
    dist = sqrt32((sq[..., 0] + sq[..., 1]) + sq[..., 2])
    n = positions.shape[1]
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    valid = (dist <= torch.tensor(cutbuf, dtype=f32, device=dev)) & ~eye
    return dd, dist, valid


def range_caps(positions, box, cutbuf: float) -> torch.Tensor:
    """The most sites in range of any site over the frames [B, N, 3], as
    int32 [2] (rows, columns: the distances are symmetric) on the positions'
    device: the list lengths K3 is sized for (a pair in range can still have
    a zero rate). On the card a small kernel counts them with K3's
    arithmetic and no host wait; on the CPU the plain version does."""
    B, N, _ = positions.shape
    dev = positions.device
    if B == 0:
        return torch.zeros(2, dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        cap = _in_range(positions, box, cutbuf)[2].sum(dim=-1).amax()
        return torch.stack([cap, cap]).to(torch.int32)
    pos = positions.contiguous()
    caps = torch.empty(2, dtype=torch.int32, device=dev)
    lx, ly, lz = (float(x) for x in box)
    build.check(build.library().cmdlmc_kmc_sweep_caps(
        pos.data_ptr(), B, N, float(np.float32(cutbuf)), lx, ly, lz,
        caps.data_ptr(), build.stream_of(pos), dev.index or 0),
        "kmc_sweep range count")
    return caps


def kmc_sweep_reference(
    positions, prev_pos, site_disp, occ, labels, sites, tlast, disp_base,
    u_rem, ev_count, law_params, frame0: int, box, tile_offset: int = 0,
    pgrp_positions=None, *, kind: int, tile: int, max_events: int, dt: float,
    seed: int, cutbuf: float,
) -> dict:
    """Plain PyTorch version of K3: the frames' W as the kernel builds it,
    then K1's plain event loop on it (one frame and one event iteration at a
    time, vectorized over replicas, index gathers, and the zero-rate rule of
    the races)."""
    w_block = inkernel_tables(positions, law_params, box, pgrp_positions,
                              kind=kind, cutbuf=cutbuf)
    return kss.kmc_sweep_streamed_reference(
        w_block, positions, prev_pos, site_disp, occ, labels, sites, tlast,
        disp_base, u_rem, ev_count, frame0, box, tile_offset, tile=tile,
        max_events=max_events, dt=dt, seed=seed,
    )


@functools.lru_cache(maxsize=None)
def _plan(n_sites: int, warps: int, device_index: int) -> dict:
    smem, budget = ctypes.c_longlong(0), ctypes.c_longlong(0)
    per_sm = ctypes.c_int(0)
    code = build.library().cmdlmc_kmc_sweep_plan(
        int(n_sites), int(warps), device_index, ctypes.byref(smem),
        ctypes.byref(budget), ctypes.byref(per_sm))
    if code:
        raise ValueError(
            f"kmc_sweep: no launch at N={n_sites} with {warps} warps per "
            "block: the block does not fit in shared memory or the warp count "
            "is not 2, 4, 8 or 16")
    return {"smem": smem.value, "list_budget": budget.value,
            "blocks_per_sm": per_sm.value, "warps": int(warps)}


def launch_plan(n_sites: int, caps, device: torch.device,
                warps: int = WARPS_PER_BLOCK) -> dict:
    """K3's launch plan at ``n_sites`` and ``warps`` warps per block: a
    block's dynamic shared memory in bytes (as much as its occupancy leaves
    it) and of that the bytes left for lists, the blocks one SM holds, and
    whether lists of ``caps`` entries (:func:`range_caps`) live in shared
    memory (else in global scratch). Raises ValueError where no block
    fits."""
    plan = dict(_plan(int(n_sites), int(warps), device.index or 0))
    plan["lists_in_smem"] = kss.list_bytes(n_sites, *caps) <= plan["list_budget"]
    return plan


def kmc_sweep(
    positions, prev_pos, site_disp, occ, labels, sites, tlast, disp_base,
    u_rem, ev_count, law_params, frame0: int, box, tile_offset: int = 0,
    pgrp_positions=None, *, kind: int, tile: int, max_events: int, dt: float,
    seed: int, cutbuf: float, warps: int = WARPS_PER_BLOCK,
) -> dict:
    """Advance every replica across a block of frames, W built in the kernel:
    K3 for CUDA tensors, the plain version for CPU tensors. ``positions``
    [B, N, 3]; ``pgrp_positions`` [B, N, 3] (each donor's P atom, kind 4
    only); ``law_params`` [6] (``law_params_array``; a CPU tensor spares a
    device sync); ``box`` the three box lengths as floats; ``cutbuf``
    cutoff + buffer. Returns the updated state as a dict (occ, labels, sites,
    tlast, disp_base, u_rem, ev_count, site_disp, prev_pos, trunc), like the
    JAX function; the inputs are left unchanged. ``warps`` is the kernel's
    replicas per thread block."""
    B, N, _ = positions.shape
    R = occ.shape[0]
    P = sites.shape[1]
    if R % tile:
        raise ValueError(f"tile ({tile}) must divide the replica count ({R})")
    if max_events < 1:
        raise ValueError("max_events must be >= 1")
    if kind not in range(5):
        raise ValueError(f"unknown law kind {kind}")
    angle = kind == KIND_FERMI_ANGLE
    if angle != (pgrp_positions is not None):
        raise ValueError("grouped P positions go with law kind 4, and only with it")
    kw = dict(kind=kind, tile=tile, max_events=max_events, dt=dt, seed=seed,
              cutbuf=cutbuf)
    dev = occ.device
    if dev.type == "cpu":
        return kmc_sweep_reference(
            positions, prev_pos, site_disp, occ, labels, sites, tlast,
            disp_base, u_rem, ev_count, law_params, frame0, box, tile_offset,
            pgrp_positions, **kw,
        )
    if dev.type != "cuda":
        raise ValueError(f"kmc_sweep: unsupported device {dev}")
    f32, i32 = torch.float32, torch.int32
    checks = [
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
    if angle:
        checks.append(("pgrp_positions", pgrp_positions, f32, (B, N, 3)))
    for name, t, dtype, shape in checks:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != dev:
            raise ValueError(
                f"kmc_sweep: {name} must be {dtype} {tuple(shape)} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    params = [float(x) for x in torch.as_tensor(law_params, dtype=f32).tolist()]
    if len(params) != 6:
        raise ValueError("law_params must hold 6 values")
    # the kernel updates replica state in place: work on copies
    state = [t.contiguous().clone() for t in
             (occ, labels, sites, tlast, disp_base, u_rem, ev_count)]
    pos = positions.contiguous()
    pgrp = pgrp_positions.contiguous() if angle else None
    prev_in = prev_pos.contiguous()
    s_in = site_disp.contiguous()
    s_out = torch.empty_like(s_in)
    prev_out = torch.empty_like(prev_in)
    trunc = torch.empty(R, dtype=i32, device=dev)
    if B == 0 or R == 0:
        trunc.zero_()
        return kss._outputs(*state, s_in.clone(), prev_in.clone(), trunc)
    lx, ly, lz = (float(x) for x in box)
    plan = _plan(N, int(warps), dev.index or 0)
    caps = range_caps(pos, box, cutbuf)
    lists, slice_ = kss.list_scratch(N, -(-R // int(warps)),
                                     plan["list_budget"], caps)
    lib = build.library()
    kmc_sweep.launches += 1
    build.check(
        lib.cmdlmc_kmc_sweep(
            pos.data_ptr(), pgrp.data_ptr() if angle else None,
            prev_in.data_ptr(), s_in.data_ptr(), prev_out.data_ptr(),
            s_out.data_ptr(), *(t.data_ptr() for t in state), trunc.data_ptr(),
            R, N, P, B, int(tile), int(tile_offset), int(frame0),
            int(max_events), int(kind), caps.data_ptr(),
            None if lists is None else lists.data_ptr(), slice_, int(warps),
            float(np.float32(dt)), int(seed) & 0xFFFFFFFF,
            float(np.float32(cutbuf)), lx, ly, lz,
            *params, build.stream_of(pos), dev.index or 0,
        ),
        "kmc_sweep kernel",
    )
    return kss._outputs(*state, s_out, prev_out, trunc)


kmc_sweep.launches = 0
