"""``kmc_water`` of the PyTorch/CUDA port: single-excess-proton water KMC.

Port of ``cmdlmc_tpu/cli/kmc_water.py`` on its fused path: subcommands
``load`` (run a keyword config file), ``config_help`` and ``config_file``;
column output with Step/Time/position/neighbor/jumps/fps, or xyz output.
``--device cuda`` (the default) runs kernels K5 and K7 and raises without a
card; ``--device cpu`` runs their plain PyTorch versions, whose states are
those of the JAX package's fused path in interpret mode. Each print frame
shows replica 0's site after that frame and the block-end jumps and
correction, the JAX CLI's rule on its scan backend. The trajectory is an
xyz file or, by its ``.h5``/``.hdf5`` suffix, an HDF5 file (h5py needed).

    python -m cmdlmc_tpu_torch.cli.kmc_water load water.cfg [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time as _time

import numpy as np
import torch


def build_model(settings, device):
    """The WaterModel of a KMCWater settings namespace (the JAX CLI's rules:
    Fermi a/b/c from ``jumprate_params_fs``; ``no_rescaling`` over
    ``conversion_data`` over ``rescale_function``)."""
    from cmdlmc_tpu_torch.core.cell import Cell
    from cmdlmc_tpu_torch.models.water import WaterModel
    from cmdlmc_tpu_torch.rates.laws import Fermi
    from cmdlmc_tpu_torch.topo.transforms import (
        InterpolatedTransformation, LinearTransformation, ReLUTransformation,
    )

    p = settings.jumprate_params_fs
    # 'a' stays a rate in fs^-1: the clock integrates rate * dt itself
    missing = [k for k in ("a", "b", "c") if k not in p]
    if missing:
        raise ValueError(
            "jumprate_params_fs must provide Fermi parameters a, b and c "
            f"(e.g. 'jumprate_params_fs a=0.06 b=2.3 c=0.1'); missing: "
            f"{', '.join(missing)}"
        )
    law = Fermi(a=p["a"], b=p["b"], c=p["c"])
    transform = None
    rp = settings.rescale_parameters
    if getattr(settings, "no_rescaling", False):
        pass  # overrides rescale_function and conversion_data
    elif settings.conversion_data:
        data = np.loadtxt(settings.conversion_data)
        transform = InterpolatedTransformation(x=data[:, 0], y=data[:, -1])
    elif settings.rescale_function == "linear":
        transform = LinearTransformation(a=rp["a"], b=rp["b"], left_bound=rp["left_bound"],
                                         right_bound=rp["right_bound"])
    elif settings.rescale_function in ("ramp", "ramp_function"):
        transform = ReLUTransformation(a=rp["a"], b=rp["b"], d0=rp["d0"],
                                       left_bound=rp["left_bound"],
                                       right_bound=rp["right_bound"])
    return WaterModel(
        cell=Cell.from_parameter_array(settings.pbc, device=device),
        law=law, transform=transform, d_oh=settings.d_oh, n_atoms=settings.n_atoms,
        relaxation_time=settings.relaxation_time, waiting_time=settings.waiting_time,
        keep_last_neighbor_rescaled=settings.keep_last_neighbor_rescaled,
        check_from_old=settings.check_from_old,
    ).to(device)


def kmc_water_main(settings, out=None, device="cuda", initial_states=None,
                   tile: int | None = None):
    """Run a KMCWater configuration and print its rows to ``out``.
    ``initial_states`` replaces the port's own start (a WaterState, e.g. the
    JAX package's carried over by ``convert.water_states_from_fields``);
    ``tile`` is the logical RNG tile (None: the JAX package's TPU rule).
    Returns the final WaterState."""
    from cmdlmc_tpu_torch.config.keyword import print_settings
    from cmdlmc_tpu_torch.driver import resolve_device
    from cmdlmc_tpu_torch.io.hdf5 import HDF5Trajectory
    from cmdlmc_tpu_torch.io.stream import frame_blocks, prefetch
    from cmdlmc_tpu_torch.io.xyz import XYZTrajectory, write_xyz_frame
    from cmdlmc_tpu_torch.models import water as wm

    out = out or sys.stdout
    device = resolve_device(device)
    print_settings(settings, out=out)
    if getattr(settings, "debug", False):
        import logging

        logging.basicConfig(
            level=logging.DEBUG,
            format="%(levelname)s:%(filename)s.%(funcName)s(%(lineno)d): %(message)s",
        )

    dt = settings.md_timestep_fs
    model = build_model(settings, device)
    reason = wm.water_unsupported_reason(model)
    if reason:
        raise NotImplementedError(reason)
    fname = settings.filename
    if fname is None:
        raise ValueError("KMCWater config needs 'filename'")
    if fname.endswith((".h5", ".hdf5")):
        traj = HDF5Trajectory(fname, time_step=dt, repeat=False)
    else:
        traj = XYZTrajectory(fname, time_step=dt, repeat=False)

    states = initial_states
    start_time = _time.time()
    printed_header = False
    site_disp = prev_pos = None
    trunc_total = None  # on the device, fetched once at the end
    frames_total = 0
    block_size = int(getattr(settings, "chunk_size", None) or 512)
    # mdconvert trajectories are in nm; the lattice works in angstrom
    unit_scale = 10.0 if getattr(settings, "mdconvert_trajectory", False) else 1.0

    for block in prefetch(frame_blocks(traj, block_size=block_size, donor_atoms="O",
                                       max_frames=settings.sweeps)):
        donors_np = np.asarray(block.donors)
        if unit_scale != 1.0:
            donors_np = (donors_np * unit_scale).astype(np.float32)
        positions = torch.from_numpy(np.ascontiguousarray(donors_np, np.float32)).to(device)
        if states is None:
            states = wm.init_water_states(
                torch.Generator().manual_seed(int(settings.seed)), settings.replicas,
                positions.shape[1], positions[0], start_position=settings.start_position)
        if site_disp is None:
            site_disp = torch.zeros((positions.shape[1], 3), dtype=torch.float32,
                                    device=device)
            prev_pos = positions[0]
        states, site_disp, prev_pos, trunc, site_trace = wm.run_water_block_fused(
            model, states, positions, block.start, site_disp=site_disp,
            prev_pos=prev_pos, dt=dt, seed=settings.seed, tile=tile)
        trunc_total = trunc.sum() if trunc_total is None else trunc_total + trunc.sum()
        frames_total += block.n_frames
        # each print frame reports replica 0's site after that frame, and the
        # block-end jumps and correction, as the JAX CLI's scan branch does
        sites_np = site_trace.cpu().numpy()
        jumps0 = int(states.jumps[0])
        corr0 = states.correction[0].cpu().numpy()

        if not printed_header and not settings.xyz_output:
            print(
                "# {:>16} {:>18} {:>15} {:>15} {:>15} {:>10} {:>10} {:>8}".format(
                    "Step", "Time", "x", "y", "z", "O-Neighbor", "Jumps", "fps"
                ),
                file=out,
            )
            printed_header = True

        for i in range(block.n_frames):
            step = block.start + i
            if step % settings.print_frequency:
                continue
            site0 = int(sites_np[i])
            pos = donors_np[i, site0] + corr0
            fps = (step + 1) / max(_time.time() - start_time, 1e-9)
            if settings.xyz_output:
                write_xyz_frame(out, ["H"] + ["O"] * donors_np.shape[1],
                                np.vstack([pos[None, :], donors_np[i]]))
            else:
                print(
                    "{:18d} {:18.2f} {:15.8f} {:15.8f} {:15.8f} {:10d} {:10d} "
                    "{:8.2f}".format(
                        step, step * dt, pos[0], pos[1], pos[2], site0, jumps0, fps
                    ),
                    file=out,
                    flush=True,
                )

    if trunc_total is not None and frames_total:
        frac = float(trunc_total) / (settings.replicas * frames_total)
        if frac > 0:
            print(
                f"# WARNING: {100 * frac:.2f}% of replica-frames exhausted the "
                "per-frame event budget — raise max_events",
                file=out,
            )
    return states


def main(argv=None):
    from cmdlmc_tpu_torch.config.keyword import (
        load_configfile, print_config_template, print_confighelp,
    )

    parser = argparse.ArgumentParser(
        description="Single-excess-proton water KMC (PyTorch/CUDA port)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_load = sub.add_parser("load", help="Load config file")
    p_load.add_argument("config_file")
    p_load.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="Device to run on; cpu runs the kernels' plain PyTorch versions")
    sub.add_parser("config_help", help="Keyword help")
    p_tmpl = sub.add_parser("config_file", help="Print config template")
    p_tmpl.add_argument("--sorted", "-s", action="store_true")
    args = parser.parse_args(argv)

    if args.cmd == "config_help":
        print_confighelp("KMCWater")
    elif args.cmd == "config_file":
        print_config_template("KMCWater", args.sorted)
    else:
        settings = load_configfile(args.config_file, config_name="KMCWater")
        if getattr(settings, "output", None):
            with open(settings.output, "w") as out:
                kmc_water_main(settings, out=out, device=args.device)
        else:
            kmc_water_main(settings, device=args.device)


if __name__ == "__main__":
    main()
