"""Tiny cells for the CPU tests: the harness's specs at sizes a test run
holds (the port runs its plain versions on the CPU)."""

from __future__ import annotations

import copy

LIMITS = {"positions": 0.0, "init": 0.0, "entry": 0.0, "site_disp": 1e-4,
          "stage1": 1e-5, "far_partings": 0.0, "parted_share": 0.1,
          "float_err": 1e-3, "rows": 1e-4, "matrix": 0.0,
          "tables_ids": 0.0, "tables_dist": 1e-5, "carry": 0.0, "handoff": 0.0,
          "truncated": 0.0}


def dense(replicas=16, jumpstat=False, streamed=True) -> dict:
    """The dense cell; ``streamed`` takes stage 1 + K1 (one replica per RNG
    tile, so 16 tiles), else K3."""
    ini = {
        "Trajectory": {"time_step": "0.4"},
        "AtomBox": {"type": "AtomBoxCubic", "periodic_boundaries": "10.5, 10.5, 10.5",
                    "box_multiplier": "1, 1, 1"},
        "NeighborTopology": {"type": "NeighborTopology", "donor_atoms": "O",
                             "cutoff": "3.0", "buffer": "2.0"},
        "JumpRate": {"type": "Fermi", "a": "0.06", "b": "2.3", "c": "0.1"},
        "KMCLattice": {"lattice_size": "48", "proton_number": "16", "time_step": "0.4"},
        "Output": {"type": "ObservablesOutput", "print_frequency": "5",
                   "reset_frequency": "20"},
        "Engine": {"block_size": "16", "max_events_per_frame": "16"},
    }
    if streamed:
        ini["Engine"]["tile"] = "1"
    traffic = {"replicas": replicas, "trajectory": "jitter", "frames": 40, "step": 0.03,
               "warmup_blocks": 2, "capture_calls": [1, 2], "ini": {}}
    if jumpstat:
        traffic["ini"] = {"Output": {"jumpstat_bins": "20", "jumpstat_range": "2.0, 3.0"},
                          "Engine": {"jumpmatrix_filename": "@work/jm.npy"}}
    config = {"name": "tiny_dense", "cell_sites": 48, "protons": 16, "box": 10.5,
              "multiplier": [1, 1, 1], "structure_seed": 0, "ini": ini}
    limits = {k: v for k, v in LIMITS.items()
              if k not in ("tables_ids", "tables_dist", "carry")
              and (jumpstat or k != "matrix") and (streamed or k != "stage1")}
    return {"name": "tiny_dense", "config": "tiny_dense", "traffic": "tiny", "chips": 1,
            "config_spec": config, "traffic_spec": traffic, "limits": limits,
            "end_to_end": [], "per_layer": [], "run_seconds": 1}


def topk() -> dict:
    spec = dense(replicas=8, streamed=False)
    ini = copy.deepcopy(spec["config_spec"]["ini"])
    ini["AtomBox"]["box_multiplier"] = "2, 2, 2"
    ini["NeighborTopology"]["max_neighbors"] = "8"
    ini["KMCLattice"].update(lattice_size="384", proton_number="128")
    ini["Engine"].update(nbr_reuse="on", max_events_per_frame="32")
    spec["config_spec"] = dict(spec["config_spec"], name="tiny_topk", multiplier=[2, 2, 2],
                               ini=ini)
    spec["traffic_spec"].update(trajectory="walk", step=0.004)
    spec["limits"] = {k: v for k, v in LIMITS.items() if k not in ("stage1", "matrix")}
    spec["name"] = spec["config"] = "tiny_topk"
    return spec
