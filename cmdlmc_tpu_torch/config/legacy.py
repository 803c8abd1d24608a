# Copied from cmdlmc_tpu/config/legacy.py (kept jax-free so the port never imports the JAX package).
"""Legacy cMDLMC keyword-config -> SimulationConfig conversion.

Lets ``mdmc --legacy`` run the reference's first-generation keyword config
files (IO/config_parser.py "cMDLMC" schema) on the new engine: jump-rate types
MD_rates/AE_rates/Exponential_rates map onto Fermi/ActivationEnergy/Exponential
laws, neighbor_search_radius onto cutoff+buffer, angle_threshold onto
FermiAngle + AngleTopology.
"""

from __future__ import annotations

import numpy as np

from cmdlmc_tpu_torch.config import schema as S
from cmdlmc_tpu_torch.config.keyword import load_configfile


def _maybe_convert_to_hdf5(fname: str) -> str:
    """Convert an .xyz trajectory to a compressed .hdf5 sibling once and
    stream from that (the legacy ``hdf5`` keyword, IO/config_parser.py:251-257;
    the reference converted on first use and re-used the cache)."""
    import os

    if str(fname).endswith((".h5", ".hdf5")):
        return fname
    target = os.path.splitext(str(fname))[0] + ".hdf5"
    if not os.path.exists(target):
        from cmdlmc_tpu_torch.io.converters import save_xyz_to_hdf5

        save_xyz_to_hdf5(str(fname), target)
    return target


def legacy_to_simulation_config(settings) -> S.SimulationConfig:
    # 'filename' with 'auxiliary_file' as the fallback name for the coordinate
    # file (IO/config_parser.py:161-168)
    fname = settings.filename or settings.auxiliary_file
    if fname is None:
        raise ValueError("config needs 'filename' (or 'auxiliary_file')")
    if settings.hdf5 or settings.shuffle:
        # shuffle needs random frame access, so it implies the HDF5 conversion
        fname = _maybe_convert_to_hdf5(fname)
    traj_type = (
        "HDF5Trajectory" if str(fname).endswith((".h5", ".hdf5")) else "XYZTrajectory"
    )
    pbc = np.asarray(settings.pbc, dtype=float)
    box_type = "AtomBoxCubic" if pbc.size == 3 else "AtomBoxMonoclinic"

    cutoff = settings.cutoff_radius
    buffer_ = max(settings.neighbor_search_radius - cutoff, 0.0)

    p = dict(settings.jumprate_params_fs)
    jr_type = settings.jumprate_type
    jumprate = S.JumpRateSection()
    topo_type = "NeighborTopology"
    if jr_type in ("MD_rates", "MD_rates_Water"):
        # angle_dependency False disables the gate even when a threshold is
        # set (IO/config_parser.py:463-468)
        if settings.angle_threshold > 0 and settings.angle_dependency:
            jumprate.type_ = "FermiAngle"
            jumprate.theta = settings.angle_threshold
            topo_type = "AngleTopology"
        else:
            jumprate.type_ = "Fermi"
        jumprate.a, jumprate.b, jumprate.c = p["a"], p["b"], p["c"]
    elif jr_type == "AE_rates":
        jumprate.type_ = "AE"
        jumprate.A = p["A"]
        jumprate.a = p["a"]
        jumprate.b = p["b"]
        jumprate.d0 = p["d0"]
        jumprate.T = p["T"]
    elif jr_type == "Exponential_rates":
        jumprate.type_ = "Exponential"
        jumprate.a, jumprate.b = p["a"], p["b"]
    else:
        raise ValueError(f"Unknown jumprate_type {jr_type!r}")

    return S.SimulationConfig(
        trajectory=S.TrajectorySection(
            filename=fname,
            time_step=settings.md_timestep_fs,
            type_=traj_type,
            # every (skip_frames+1)-th frame (IO/config_parser.py:196-202)
            stride=settings.skip_frames + 1,
            clip=settings.clip_trajectory,
            shuffle_seed=settings.seed if settings.shuffle else None,
            repeat=settings.clip_trajectory is not None,
        ),
        atombox=S.AtomBoxSection(
            periodic_boundaries=pbc,
            type_=box_type,
            box_multiplier=tuple(settings.box_multiplier),
        ),
        topology=S.TopologySection(
            type_=topo_type,
            donor_atoms=settings.donor_atoms,
            cutoff=cutoff,
            buffer=buffer_,
            # o_neighbor names the heavy atom for the P-O-O angle gate
            # (IO/config_parser.py:175-181)
            extra_atoms=settings.o_neighbor if topo_type == "AngleTopology" else None,
            # Verlet-list analog: K-nearest neighbor list instead of the dense
            # rate matrix; K = 16 covers every neighbor inside the search
            # radius in all reference systems (topology.py:80-114)
            max_neighbors=16 if settings.neighbor_list else None,
        ),
        jumprate=jumprate,
        kmc=S.KMCLatticeSection(
            lattice_size=settings.lattice_size,
            proton_number=settings.proton_number,
            donor_atoms=settings.donor_atoms,
            time_step=settings.md_timestep_fs,
        ),
        output=S.OutputSection(
            type_="XYZOutput" if settings.xyz_output else "ObservablesOutput",
            reset_frequency=settings.reset_freq,
            print_frequency=settings.print_frequency,
            variance=settings.variance_per_proton,
            # the legacy key's statistic is per-proton (config_parser.py:
            # 356-363), not across-replica
            variance_mode="protons" if settings.variance_per_proton else "replicas",
            periodic_wrap=settings.periodic_wrap,
            higher_msd=settings.higher_msd,
            filename=settings.output,
        ),
        engine=S.EngineSection(
            replicas=settings.replicas,
            seed=settings.seed,
            sweeps=settings.sweeps,
            equilibration_sweeps=settings.equilibration_sweeps,
            jumpmatrix_filename=settings.jumpmatrix_filename,
        ),
    )


def load_legacy_config(path_or_file) -> S.SimulationConfig:
    settings = load_configfile(path_or_file, config_name="cMDLMC")
    return legacy_to_simulation_config(settings)
