"""The comparison that decides ``correct``: the captured launch of the
timed path against the plain reference (``reference/``).

The reference cannot run the whole run again inside a run's budget (tens
of thousands of frames at R = 16384), so it follows the program from the
program's own state at the captured launch's entry, and checks by
themselves the start (the seeded initial state) and what that skips (the
entry state is a valid occupancy; the shared site displacement and the
positions agree with the reference's own). Every number is "lower is
better" and passes at or under its limit (``workloads/<cell>.json``):

- ``positions``: largest |program - reference| of the positions the stream
  handed the engine (the launch's frames, the previous frame, the first
  frame; the neighbour lists' reference frame), A. The reference parses
  the trajectory file itself and builds the supercell itself.
- ``init``: replicas whose seeded start (sites, first draw) differs.
- ``entry``: replicas whose state at the launch's entry is no valid
  occupancy (occupancy, labels and sites disagree, or protons lost).
- ``handoff``: replicas whose state at the launch's entry is not the
  launch before it's output passed through the reference's own
  observable reset (where that frame resets), plus one for each shared
  array (site displacement, previous positions) that differs; a gap or an
  overlap between the two launches' frames counts as infinite.
- ``truncated``: replica-frames of the whole run whose event budget
  (``max_events_per_frame``) ran out, as the program's launches return
  them. The deployment states a budget that never binds (the source's
  event loop has none), so the limit is 0.
- ``site_disp``: largest |program - reference| of the shared site
  displacement at the entry, A (the reference's own float64 prefix sum).
- ``stage1``: dense W of stage 1 (K2 and the law), largest |difference|
  over the largest rate. ``tables_ids`` / ``tables_dist`` / ``carry``: the
  top-K tables of the launch (ids that differ where a slot is live;
  largest distance difference, A) and the neighbour carry at the entry
  (ids of its frozen lists, the drift threshold).
- ``far_partings``: replicas whose integer state (occupancy, labels,
  sites, events, jumps, jump histogram) after the launch differs from the
  reference's although every decision the reference took for them had a
  relative margin of at least FAR (float32 rounding cannot flip those).
- ``parted_share``: the share of the compared replicas whose integer
  state differs at all.
- ``float_err``: largest |program - reference| / max(|reference|, 1) of
  the float state (remaining draw, last-jump times, displacements,
  exposure, site displacement) of the replicas that agree.
- ``rows``: largest relative difference (floor 1e-3) of the row the
  driver emitted at the launch's last frame from the reference's row of
  the program's state.
- ``matrix``: jumps of the jump matrix's change over the launch that the
  parted replicas do not explain.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import kmc
from benchmark.reference import trajectory as traj

FAR = 1.0e-4
INF = float("inf")


def _f(x) -> float:
    return float(x.item() if isinstance(x, torch.Tensor) else x)


def reference_positions(path, frames_np, idx, phys, dev) -> torch.Tensor:
    """float32 positions of absolute frames ``idx`` as the reference reads
    them from the file, supercell included."""
    n = frames_np.shape[1]
    t = frames_np.shape[0]
    small = traj.read_xyz_frames(path, n, [int(i) % t for i in idx])
    pos = torch.from_numpy(small).to(dev)
    return kmc.extend(pos, phys["box"], phys["mult"])


def site_disp_reference(frames_np, upto: int, phys, dev) -> torch.Tensor:
    """float64 sum over the absolute frames 1..upto of the repeated
    trajectory's minimum-image site steps, for the supercell's sites."""
    x = torch.from_numpy(frames_np).to(dev).double()
    t = x.shape[0]
    big_box = tuple(b * m for b, m in zip(phys["box"], phys["mult"]))
    steps = kmc.minimg(x - torch.roll(x, 1, dims=0), big_box)  # steps[0]: the wrap
    q, r = divmod(upto, t)
    s = q * steps.sum(dim=0) + steps[1:r + 1].sum(dim=0)
    mx, my, mz = phys["mult"]
    return s.repeat(mx * my * mz, 1)


def row_vector(r) -> np.ndarray:
    """The ten numbers of an emitted row, in ``kmc.row``'s order."""
    return np.concatenate([np.asarray(r.msd, np.float64), np.asarray(r.msd_var, np.float64),
                           [r.autocorr, r.autocorr_var, r.jumps, r.msd4]])


def row_err(have, want) -> float:
    """Largest relative difference of two rows (floor 1e-3)."""
    return float(np.max(np.abs(have - want) / np.maximum(np.abs(want), 1e-3)))


def _entry_bad(rep, P) -> int:
    occ = rep.occ
    sites = rep.site_of_proton.long()
    R, N = occ.shape
    rows = torch.arange(R, device=occ.device)[:, None]
    onehot = torch.zeros_like(occ)
    onehot[rows, sites] = 1.0
    labels_ok = rep.proton_of_site.long()[rows, sites] == torch.arange(1, P + 1, device=occ.device)
    bad = ((onehot != occ).any(dim=1) | ~labels_ok.all(dim=1)
           | (occ.sum(dim=1) != P) | (rep.proton_of_site != 0).sum(dim=1).ne(P))
    return int(bad.sum())


def resets_at(f: int, phys) -> bool:
    """Whether the observables reset after frame ``f`` (before its row)."""
    return ((phys["reset_freq"] > 0 and f % phys["reset_freq"] == 0 and f > 0)
            or (phys["eq"] > 0 and f == phys["eq"]))


def _handoff(prev, ens, f0: int, phys) -> float:
    """Replicas whose entry state is not ``prev`` (the launch before's
    output) after the reset rule, plus one per shared array that differs."""
    if prev is None or prev["end"] != f0 - 1:
        return INF
    rep = ens.replicas
    want = {k: prev[k] for k in ("occ", "labels", "sites", "tlast", "u", "evc", "hist",
                                 "expo", "disp_base", "jumps", "autocorr_ref")}
    if resets_at(f0 - 1, phys):
        want["disp_base"] = -prev["s"][prev["sites"].long()]
        want["jumps"] = torch.zeros_like(prev["jumps"])
        want["autocorr_ref"] = prev["sites"]
    have = dict(occ=rep.occ, labels=rep.proton_of_site, sites=rep.site_of_proton,
                tlast=rep.t_last_jump, u=rep.clock.u_remaining, evc=rep.clock.event_count,
                hist=rep.jump_hist, expo=rep.opportunity_hist, disp_base=rep.disp_base,
                jumps=rep.jumps, autocorr_ref=rep.autocorr_ref)
    R = rep.occ.shape[0]
    bad = torch.zeros(R, dtype=torch.bool, device=rep.occ.device)
    for k, w in want.items():
        h = have[k]
        if h.shape != w.shape:
            return INF
        if h.numel():
            bad |= (h.reshape(R, -1) != w.to(h.dtype).reshape(R, -1)).any(dim=1)
    shared = sum(int(not torch.equal(a, b)) for a, b in
                 ((ens.site_disp, prev["s"]), (ens.prev_pos, prev["prev"])))
    return float(int(bad.sum()) + shared)


def _state_of(ens, ridx) -> dict:
    rep = ens.replicas
    st = dict(occ=rep.occ[ridx], labels=rep.proton_of_site[ridx].long(),
              sites=rep.site_of_proton[ridx].long(), tlast=rep.t_last_jump[ridx],
              disp_base=rep.disp_base[ridx], u=rep.clock.u_remaining[ridx],
              evc=rep.clock.event_count[ridx].long(), s=ens.site_disp, prev=ens.prev_pos)
    if rep.jump_hist.shape[-1]:
        st["hist"] = rep.jump_hist[ridx].long()
        st["expo"] = rep.opportunity_hist[ridx]
    return st


def compare_states(prog: dict, ref: dict, margin, jumps_in=None, jumps_out=None) -> dict:
    """The loop's numbers from a program's (or the control's) state after a
    launch and the reference's, both for the same replicas."""
    agree = torch.ones(prog["occ"].shape[0], dtype=torch.bool, device=prog["occ"].device)
    for k in ("occ", "labels", "sites", "evc", "hist"):
        if k in ref:
            a, b = prog[k].double(), ref[k].double()
            agree &= (a == b).reshape(a.shape[0], -1).all(dim=1)
    if jumps_out is not None:
        agree &= (jumps_out.long() == jumps_in.long() + ref["evc"] - prog["evc_in"])
    parted = ~agree
    far = int((parted & (margin >= FAR)).sum())
    errs = {}
    for k in ("u", "tlast", "disp_base", "expo", "s"):
        if k in ref and (k == "s" or bool(agree.any())):
            a, b = (prog[k], ref[k]) if k == "s" else (prog[k][agree], ref[k][agree])
            errs[k] = _f(((a.double() - b.double()).abs() / b.double().abs().clamp(min=1.0)).max())
    return dict(far_partings=float(far), parted_share=_f(parted.double().mean()),
                float_err=max(errs.values()), _parted=parted, _errs=errs)


def check_run(phys, cap, rows, frames_np, traj_path, dev) -> dict:
    """Every number of the run's check (see the module's docstring)."""
    got = cap.got
    topk = phys["k"] > 0
    out = {}
    if cap.first is None or got is None:
        names = ["positions", "init", "entry", "handoff", "truncated", "site_disp",
                 "far_partings", "parted_share", "float_err", "rows"]
        return {n: INF for n in names}
    P, R = phys["protons"], phys["replicas"]
    f0, n = got["frame0"], got["n"]
    ens, ens_out = got["ens"], got["out"]
    N = ens.replicas.occ.shape[1]
    # -- the positions ----------------------------------------------------------
    idx = [0] + ([f0 - 1] if f0 > 0 else []) + list(range(f0, f0 + n))
    carry = ens.nbr_carry if topk else None
    if carry is not None:
        idx.append(int(carry.last_rebuild))
    ref_pos = reference_positions(traj_path, frames_np, idx, phys, dev)
    prog_pos = [cap.first["donors"][0]] + ([ens.prev_pos] if f0 > 0 else [])
    prog_pos += list(got["donors"].to(torch.float32))
    if carry is not None:
        prog_pos.append(carry.ref_pos)
    out["positions"] = max(_f((a.to(dev) - b).abs().max()) for a, b in zip(prog_pos, ref_pos))
    span = ref_pos[(2 if f0 > 0 else 1):(2 if f0 > 0 else 1) + n]
    # -- the start --------------------------------------------------------------
    sites0, u0 = kmc.init_state(phys["seed"], R, N, P)
    same = ((cap.first["sites"].cpu().long() == sites0).all(dim=1)
            & (cap.first["u"].cpu() == u0))
    out["init"] = float(int((~same).sum()))
    # -- the entry --------------------------------------------------------------
    out["entry"] = float(_entry_bad(ens.replicas, P))
    out["handoff"] = _handoff(got["prev"], ens, f0, phys)
    out["truncated"] = _f(cap.truncated) if cap.truncated is not None else INF
    s_ref = site_disp_reference(frames_np, f0 - 1, phys, dev) if f0 > 0 else None
    out["site_disp"] = (_f((ens.site_disp.double() - s_ref).abs().max())
                        if s_ref is not None else 0.0)
    # -- stage 1 ----------------------------------------------------------------
    cutbuf = float(np.float32(phys["cutoff"]) + np.float32(phys["buffer"]))
    big_box = tuple(b * m for b, m in zip(phys["box"], phys["mult"]))
    if topk and carry is None:  # lists rebuilt every frame
        tabs = [kmc.knn_f32(p, big_box, cutbuf, phys["k"]) for p in span]
        topd = torch.stack([d for d, _ in tabs])
        topi = torch.stack([i for _, i in tabs])
    elif topk:
        # the carry's lists, threshold and reference positions, the
        # reference's own: its read of the rebuild frame, its lists there
        cd, ci = kmc.knn_f32(ref_pos[-1], big_box, cutbuf, phys["k"])
        cl = cd < 1.0e5
        bad_ids = int(((carry.ref_topi.long() != ci) & cl).sum() + (carry.ref_valid != cl).sum())
        t32 = float(kmc.thresh_f32(cd, phys["cutoff"], phys["buffer"]))
        t64 = kmc.thresh_f64(cd, phys["cutoff"], phys["buffer"])
        thresh = min((t32, t64), key=lambda t: abs(t - carry.thresh))
        thr_ok = abs(carry.thresh - thresh) <= 1e-6 * max(thresh, 1.0)
        out["carry"] = float(bad_ids + (0 if thr_ok else 1))
        ref_carry = dict(ref_pos=ref_pos[-1], thresh=thresh,
                         last_rebuild=carry.last_rebuild, thrash_until=carry.thrash_until)
        topd, topi, _ = kmc.verlet_tables(span, ref_carry, f0, big_box, phys["cutoff"],
                                          phys["buffer"], phys["k"])
    if topk:
        ptopd, ptopi = got["tables"][0], got["tables"][1].long()
        live, plive = topd < 1.0e5, ptopd < 1.0e5
        out["tables_ids"] = float(int(((ptopi != topi) & live).sum() + (live != plive).sum()))
        both = live & plive
        out["tables_dist"] = (_f((ptopd[both].double() - topd[both].double()).abs().max())
                              if bool(both.any()) else 0.0)
        omega = kmc.topk_rates(topd, phys["law"])
    else:
        w_ref, dist_ref = kmc.dense_rates(span, big_box, phys["law"], cutbuf)
        tables = got["tables"]
        if tables is not None:
            w_prog = tables[0] if isinstance(tables, tuple) else tables
            out["stage1"] = _f((w_prog.double() - w_ref).abs().max() / w_ref.abs().max())
    # -- the event loop ---------------------------------------------------------
    ridx = torch.arange(R, device=dev)
    entry = _state_of(ens, ridx)
    kw = dict(tile=_tile(phys, N, topk), seed=phys["seed"], dt=phys["dt"],
              max_events=phys["max_events"], box=big_box)
    if topk:
        ref, margin = kmc.topk_loop(omega, topi, span, entry, f0, ridx, **kw)
        stats = {}
    else:
        hist = (phys["nbins"], *phys["hist_range"]) if phys["nbins"] else None
        ref, margin, stats = kmc.dense_loop(w_ref, dist_ref, span, entry, f0, ridx,
                                            hist=hist, matrix=phys["matrix"], **kw)
    prog = _state_of(ens_out, ridx)
    prog["evc_in"] = entry["evc"]
    loop = compare_states(prog, ref, margin, ens.replicas.jumps[ridx],
                          ens_out.replicas.jumps[ridx])
    parted = loop.pop("_parted")
    out["_float_errs"] = loop.pop("_errs")
    out.update(loop)
    if "matrix" in stats and got["jm_in"] is not None:
        dprog = (got["jm_out"].long() - got["jm_in"].long()).to(dev)
        l1 = _f((dprog - stats["matrix"]).abs().sum())
        explained = _f(((prog["evc"] - entry["evc"]) + (ref["evc"] - entry["evc"]))[parted].sum())
        out["matrix"] = max(0.0, l1 - explained)
    # -- the row ----------------------------------------------------------------
    f_end = f0 + n - 1
    reset = resets_at(f_end, phys)
    rep = ens_out.replicas
    want = kmc.row(rep.site_of_proton, rep.disp_base, rep.autocorr_ref, rep.jumps,
                   ens_out.site_disp, reset)
    out["rows"] = row_err(row_vector(rows[f_end]), want) if f_end in rows else INF
    return out


def _tile(phys, n_sites, topk) -> int:
    if phys["tile"]:
        return int(phys["tile"])
    if topk:
        return kmc.pick_tile_topk(phys["replicas"], n_sites=n_sites, n_protons=phys["protons"],
                                  k_cand=phys["k"])
    return kmc.pick_tile(phys["replicas"], n_sites=n_sites)
