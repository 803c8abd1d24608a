# Copied from cmdlmc_tpu/io/converters.py (kept jax-free so the port never imports the JAX package).
"""xyz -> HDF5 trajectory conversion (the reference's ``trajconv`` console
script, IO/converters.py:22-55)."""

from __future__ import annotations

import logging
import os

from cmdlmc_tpu_torch.io.frames import remove_center_of_mass_movement
from cmdlmc_tpu_torch.io.hdf5 import TRAJECTORY_KEY, write_trajectory
from cmdlmc_tpu_torch.io.xyz import XYZTrajectory

logger = logging.getLogger(__name__)


def save_xyz_to_hdf5(
    xyz_fname: str,
    hdf5_fname: str | None = None,
    *,
    remove_com_movement: bool = False,
    dataset_name: str = TRAJECTORY_KEY,
    selection=None,
    compression: str = "auto",
) -> str:
    """Convert an xyz file to the reference HDF5 layout (float32; see
    io.hdf5.compression_kwargs for the compression choices — ``none`` is the
    streaming fast layout for decode-bound hosts)."""
    xyz = XYZTrajectory(xyz_fname, time_step=1.0, selection=selection)
    logger.info("Determining length of xyz trajectory")
    n_frames = len(xyz)

    if not hdf5_fname:
        hdf5_fname = os.path.splitext(xyz_fname)[0] + ".hdf5"

    first_names = None
    first_shape = None

    def frames():
        nonlocal first_names, first_shape
        for names, positions, _ in xyz.iter_batches():
            if first_names is None:
                first_names = names
            if remove_com_movement:
                positions = remove_center_of_mass_movement(names, positions)
            yield from positions

    # Peek to learn shape before creating datasets.
    gen = frames()
    try:
        first = next(gen)
    except StopIteration:
        raise ValueError(f"No frames in {xyz_fname}")
    first_shape = first.shape

    def chain():
        yield first
        yield from gen

    write_trajectory(
        hdf5_fname,
        first_names,
        n_frames,
        first_shape,
        chain(),
        dataset_name=dataset_name,
        compression=compression,
    )
    logger.info("Wrote %s (%d frames)", hdf5_fname, n_frames)
    return hdf5_fname
