"""``jumpstat`` of the PyTorch/CUDA port: proton jump probability against the
donor-acceptor distance (port of ``cmdlmc_tpu/cli/jumpstat.py``).

Runs the configured simulation with the kernels' distance histograms on and
prints, per distance bin, the jump count, the exposure (allowed-transition
frames), the per-frame jump probability and the implied rate
omega(d) = jumps / (exposure * dt); ``--fit`` fits a Fermi law to omega(d).

    python -m cmdlmc_tpu_torch.cli.jumpstat config.ini --bins 20 --range 2.2 3.0

with ``--fit`` for the fit and ``--device cpu`` for the plain versions.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Distance-resolved proton jump statistics (PyTorch/CUDA port)"
    )
    parser.add_argument("configfile", help="Same INI file as mdmc")
    parser.add_argument("--bins", type=int, default=20)
    parser.add_argument("--range", nargs=2, type=float, default=(2.0, 3.0),
                        metavar=("MIN", "MAX"))
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="Device to run on; cpu runs the kernels' plain PyTorch versions",
    )
    parser.add_argument(
        "--fit", action="store_true",
        help="Fit a Fermi law a/(1+exp((d-b)/c)) to the measured omega(d)",
    )
    args = parser.parse_args(argv)

    from cmdlmc_tpu_torch.config.schema import load_config
    from cmdlmc_tpu_torch.driver import Simulation, jumpstat_lines

    sim = Simulation(load_config(args.configfile), device=args.device)
    sim.hist_bins = args.bins
    sim.hist_range = tuple(args.range)

    for _ in sim.observable_rows():
        pass
    states = sim.final_states

    for line in jumpstat_lines(states, tuple(args.range), args.bins, sim.dt):
        print(line)

    if args.fit:
        jumps = states.replicas.jump_hist.cpu().numpy().sum(axis=0)
        opp = states.replicas.opportunity_hist.cpu().numpy().sum(axis=0)
        edges = np.linspace(args.range[0], args.range[1], args.bins + 1)
        centers = 0.5 * (edges[:-1] + edges[1:])
        print("\n".join(fermi_fit_lines(centers, jumps, opp, sim.dt)))


def fermi_fit_lines(centers, jumps, opp, dt) -> list[str]:
    """Fit omega(d) = a / (1 + exp((d - b) / c)) to the populated bins with
    Poisson errors (scipy, imported here) and format the parameters as the
    JAX package's CLI does."""
    from scipy.optimize import curve_fit

    mask = (opp > 0) & (jumps > 0)
    if mask.sum() < 3:
        return ["# Fermi fit skipped: not enough populated bins"]
    omega = jumps[mask] / opp[mask] / dt
    sigma = np.sqrt(jumps[mask]) / opp[mask] / dt  # Poisson errors

    def fermi(d, a, b, c):
        return a / (1.0 + np.exp((d - b) / c))

    p0 = (omega.max(), float(centers[mask].mean()), 0.1)
    try:
        popt, pcov = curve_fit(fermi, centers[mask], omega, p0=p0, sigma=sigma,
                               absolute_sigma=True, maxfev=10000)
    except RuntimeError as exc:
        return [f"# Fermi fit failed: {exc}"]
    perr = np.sqrt(np.diag(pcov))
    return (["# Fermi fit omega(d) = a / (1 + exp((d - b)/c)):"]
            + [f"#   {name} = {v:.6g} +- {e:.2g}" for name, v, e in zip("abc", popt, perr)])


if __name__ == "__main__":
    main()
