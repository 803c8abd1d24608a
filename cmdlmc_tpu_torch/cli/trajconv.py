# Copied from cmdlmc_tpu/cli/trajconv.py (kept jax-free so the port never imports the JAX package).
"""``trajconv`` console entry point — xyz -> HDF5 conversion
(reference IO/converters.py:53-55)."""

from __future__ import annotations

import argparse
import logging


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert an xyz trajectory to the HDF5 layout",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("xyz", help="Input xyz file")
    parser.add_argument("hdf5", nargs="?", default=None, help="Output HDF5 file")
    parser.add_argument(
        "--remove-com-movement",
        action="store_true",
        help="Remove center-of-mass movement per frame",
    )
    parser.add_argument(
        "--selection", default=None, help="Atom type to select (e.g. O)"
    )
    parser.add_argument(
        "--compression",
        default="auto",
        choices=("auto", "none", "blosc", "lzf", "gzip"),
        help="HDF5 dataset compression; 'none' is the streaming fast layout "
        "(raw chunked reads — no per-chunk decode on the prefetch thread)",
    )
    parser.add_argument("--verbose", "-v", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING)

    from cmdlmc_tpu_torch.io.converters import save_xyz_to_hdf5

    out = save_xyz_to_hdf5(
        args.xyz,
        args.hdf5,
        remove_com_movement=args.remove_com_movement,
        selection=args.selection,
        compression=args.compression,
    )
    print(out)


if __name__ == "__main__":
    main()
