"""``mdmc`` entry point of the PyTorch/CUDA port — INI-config-driven cMD/LMC
run on one device (port of ``cmdlmc_tpu/cli/mdmc.py``).

    python -m cmdlmc_tpu_torch.cli.mdmc config.ini [--device cpu]
    python -m cmdlmc_tpu_torch.cli.mdmc legacy.cfg --legacy
    python -m cmdlmc_tpu_torch.cli.mdmc config.ini --profile DIR

``--legacy`` reads a first-generation cMDLMC keyword file (its trajectory
is converted to an HDF5 sibling once, which needs h5py); ``--profile``
writes a torch.profiler trace of the run (Chrome / Perfetto JSON) into DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import os


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="cMD/LMC kinetic Monte Carlo run (PyTorch/CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument(
        "configfile", help="INI file configuring the cMD/LMC scheme"
    )
    parser.add_argument(
        "--legacy",
        action="store_true",
        help="Treat the config as a legacy cMDLMC keyword-per-line file",
    )
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="Device to run on; cpu runs the kernels' plain PyTorch versions",
    )
    parser.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="Write a torch.profiler trace of the run into DIR "
             "(mdmc_trace.json; view with Perfetto or chrome://tracing)",
    )
    args = parser.parse_args(argv)

    if args.profile:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if args.device == "cuda" and torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        profile_cm = profile(activities=activities)
    else:
        profile_cm = contextlib.nullcontext()

    with profile_cm as prof:
        if args.legacy:
            from cmdlmc_tpu_torch.config.legacy import load_legacy_config
            from cmdlmc_tpu_torch.driver import Simulation

            cfg = load_legacy_config(args.configfile)
            Simulation(cfg, device=args.device).run()
        else:
            from cmdlmc_tpu_torch.driver import run_from_config

            run_from_config(args.configfile, device=args.device)
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "mdmc_trace.json"))


if __name__ == "__main__":
    main()
