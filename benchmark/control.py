"""The control of the comparison: the plain reference put in the program's
place, computed one precision below the configuration's float32
(bfloat16: positions, distances, rates, the clock and the displacements),
from the same seeded start and the same frames as the float64 reference,
over one launch's span at the cell's own sizes. It prints, per seed, the
numbers ``check.py`` compares (the upper readings the limits are set
below) and whether the cell's limits, through the harness's own rule
(``harness.judge``), find it correct: they must not. The benchmark's own
runs never run it.

    python3 benchmark/control.py --workload <name> --seeds 11 12 13 [--frames 100]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import check as chk  # noqa: E402
from benchmark.harness import ini_sections, judge, load_spec, physics  # noqa: E402
from benchmark.reference import kmc  # noqa: E402
from benchmark.reference import trajectory as traj  # noqa: E402


def control_numbers(spec: dict, seed: int, n_frames: int, dev) -> dict:
    """The numbers of one seed: the bfloat16 reference against the float64
    one over frames [0, n_frames) from the seeded start."""
    ph = physics(ini_sections(spec, seed, Path("unused.xyz"), Path(".")))
    frames = traj.make_frames(spec["traffic_spec"], spec["config_spec"], seed)
    pos = kmc.extend(torch.from_numpy(frames[:n_frames]).to(dev), ph["box"], ph["mult"])
    big_box = tuple(b * m for b, m in zip(ph["box"], ph["mult"]))
    cutbuf = float(np.float32(ph["cutoff"]) + np.float32(ph["buffer"]))
    R, P, N = ph["replicas"], ph["protons"], pos.shape[1]
    sites, u0 = kmc.init_state(seed, R, N, P)
    sites = sites.to(dev)
    ridx = torch.arange(R, device=dev)
    rows = ridx[:, None]
    occ = torch.zeros((R, N), dtype=torch.float32, device=dev)
    occ[rows, sites] = 1.0
    labels = torch.zeros((R, N), dtype=torch.int64, device=dev)
    labels[rows, sites] = torch.arange(1, P + 1, device=dev)
    entry = dict(occ=occ, labels=labels, sites=sites,
                 tlast=torch.full((R, P), -1.0, device=dev),
                 disp_base=torch.zeros((R, P, 3), device=dev), u=u0.to(dev),
                 evc=torch.zeros(R, dtype=torch.int64, device=dev),
                 s=torch.zeros((N, 3), device=dev), prev=pos[0])
    if ph["nbins"]:
        entry["hist"] = torch.zeros((R, ph["nbins"]), dtype=torch.int64, device=dev)
        entry["expo"] = torch.zeros((R, ph["nbins"]), device=dev)
    tile = ph["tile"] or (kmc.pick_tile_topk(R, n_sites=N, n_protons=P, k_cand=ph["k"])
                          if ph["k"] else kmc.pick_tile(R, n_sites=N))
    kw = dict(tile=tile, seed=seed, dt=ph["dt"], max_events=ph["max_events"], box=big_box)
    out = {}
    low = torch.bfloat16
    if ph["k"]:
        tabs = [kmc.knn_f32(p, big_box, cutbuf, ph["k"]) for p in pos]
        ctabs = [kmc.knn_f32(p.to(low), big_box, cutbuf, ph["k"]) for p in pos]
        topd, topi = torch.stack([d for d, _ in tabs]), torch.stack([i for _, i in tabs])
        ctopd = torch.stack([d.float() for d, _ in ctabs])
        ctopi = torch.stack([i for _, i in ctabs])
        live, clive = topd < 1.0e5, ctopd < 1.0e5
        out["tables_ids"] = float(int(((ctopi != topi) & live).sum() + (live != clive).sum()))
        both = live & clive
        out["tables_dist"] = float((ctopd[both].double() - topd[both].double()).abs().max())
        ref, margin = kmc.topk_loop(kmc.topk_rates(topd, ph["law"]), topi, pos, entry, 0,
                                    ridx, **kw)
        ctl, _ = kmc.topk_loop(kmc.topk_rates(ctopd, ph["law"]), ctopi, pos, entry, 0,
                               ridx, dtype=low, **kw)
    else:
        hist = (ph["nbins"], *ph["hist_range"]) if ph["nbins"] else None
        w, dist = kmc.dense_rates(pos, big_box, ph["law"], cutbuf)
        cw, cdist = kmc.dense_rates(pos, big_box, ph["law"], cutbuf, dtype=low)
        out["stage1"] = float((cw.double() - w).abs().max() / w.abs().max())
        ref, margin, stats = kmc.dense_loop(w, dist, pos, entry, 0, ridx, hist=hist,
                                            matrix=ph["matrix"], **kw)
        ctl, _, cstats = kmc.dense_loop(cw, cdist, pos, entry, 0, ridx, hist=hist,
                                        matrix=ph["matrix"], dtype=low, **kw)
        if ph["matrix"]:
            out["matrix"] = float((cstats["matrix"] - stats["matrix"]).abs().sum())
    ctl = dict(ctl, evc_in=entry["evc"])
    loop = chk.compare_states(ctl, ref, margin)
    loop.pop("_parted")
    loop.pop("_errs")
    out.update(loop)
    # the positions, the shared site displacement and the row, each as the
    # control holds or emits it against the reference's
    out["positions"] = float((pos.to(low).double() - pos.double()).abs().max())
    steps = kmc.minimg(pos[1:] - pos[:-1], big_box)
    out["site_disp"] = float((steps.to(low).cumsum(dim=0, dtype=low)[-1].double()
                              - steps.double().sum(dim=0)).abs().max())
    args = (ctl["sites"], ctl["disp_base"], ctl["sites"], ctl["evc"] - entry["evc"], ctl["s"],
            False)
    out["rows"] = chk.row_err(kmc.row(*args, dtype=low), kmc.row(*args))
    # what the control shares with the reference by construction: the
    # seeded start, its hand-over between launches (it makes one launch),
    # the neighbour carry (it rebuilds every frame) and the event budget
    for name in ("init", "entry", "handoff", "truncated", "carry"):
        out[name] = 0.0
    return {k: v for k, v in out.items() if k in spec["limits"]}


def control_correct(spec: dict, nums: dict) -> bool:
    """``correct`` of the control's numbers under the cell's limits, by the
    rule a run is judged by."""
    return judge(spec["limits"], nums)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=100)
    args = ap.parse_args(argv)
    spec = load_spec(args.workload)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        nums = control_numbers(spec, seed, args.frames, dev)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": control_correct(spec, nums), "control": nums}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
