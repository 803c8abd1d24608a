"""``mdmc`` entry point of the PyTorch/CUDA port — INI-config-driven cMD/LMC
run on one device (port of ``cmdlmc_tpu/cli/mdmc.py``; ``--legacy`` and
``--profile`` wait for ROADMAP A9)."""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="cMD/LMC kinetic Monte Carlo run (PyTorch/CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument(
        "configfile", help="INI file configuring the cMD/LMC scheme"
    )
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="Device to run on; cpu runs the kernels' plain PyTorch versions",
    )
    args = parser.parse_args(argv)

    from cmdlmc_tpu_torch.driver import run_from_config

    run_from_config(args.configfile, device=args.device)


if __name__ == "__main__":
    main()
