# Copied from cmdlmc_tpu/cli/trajzip.py (kept jax-free so the port never imports the JAX package).
"""``trajzip`` — merge two xyz trajectories frame by frame into combined
frames of n1+n2 atoms (reference misc/trajzip.py:6-32: prints ``n1 + n2``,
an empty comment line, then both atom blocks)."""

from __future__ import annotations

import argparse
import sys


def _frames(f):
    while True:
        header = f.readline()
        if not header.strip():
            return
        n = int(header)
        f.readline()  # comment line (discarded, as in the reference)
        lines = [f.readline() for _ in range(n)]
        yield n, lines


def merge(file1, file2, out=None):
    """Combine corresponding frames of two xyz streams into single frames.

    Matches the reference output shape: atom count ``n1 + n2``, an empty
    comment line, then the atoms of file1 followed by the atoms of file2.
    Stops at the shorter trajectory.
    """
    out = out or sys.stdout
    for (n1, l1), (n2, l2) in zip(_frames(file1), _frames(file2)):
        out.write(f"{n1 + n2}\n")
        out.write("\n")
        out.writelines(l1)
        out.writelines(l2)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Merge two xyz trajectories into combined n1+n2-atom frames"
    )
    parser.add_argument("file1")
    parser.add_argument("file2")
    args = parser.parse_args(argv)
    try:
        with open(args.file1) as f1, open(args.file2) as f2:
            merge(f1, f2)
    except BrokenPipeError:
        sys.stderr.close()


if __name__ == "__main__":
    main()
