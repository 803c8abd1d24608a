"""Carry parameters and state over from the JAX package.

The JAX package initializes replicas with threefry, which the port does not
reproduce; parity runs therefore hand the JAX package's own initial state to
``Simulation(cfg, initial_state=...)``. Everything here reads plain
attributes through ``np.asarray``, so this module never imports ``jax``: it
takes the JAX objects (or anything with the same fields) as they come.
"""

from __future__ import annotations

import numpy as np
import torch

from cmdlmc_tpu_torch.core.cell import Cell
from cmdlmc_tpu_torch.engine.clock import ClockState
from cmdlmc_tpu_torch.engine.lattice import EnsembleState, ReplicaState
from cmdlmc_tpu_torch.rates import laws
from cmdlmc_tpu_torch.topo.models import AnglePairRates, PairRates


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def ensemble_from_numpy(ens, device="cpu") -> EnsembleState:
    """The port's EnsembleState from the fields of a JAX ``EnsembleState``.
    Jump histograms and the jump matrix must be empty (ROADMAP A11)."""
    rep = ens.replicas
    for name in ("jump_hist", "opportunity_hist", "jump_matrix"):
        field = getattr(rep, name, None)
        if field is not None and np.asarray(field).size:
            raise NotImplementedError(f"{name} is not ported yet (ROADMAP A11)")
    c = rep.clock
    f32, i32 = np.float32, np.int32
    clock = ClockState(
        u_remaining=_t(c.u_remaining, device, f32),
        phase=_t(c.phase, device, f32),
        event_count=_t(c.event_count, device, i32),
        last_event_frame=_t(c.last_event_frame, device, i32),
        last_event_phase=_t(c.last_event_phase, device, f32),
    )
    replicas = ReplicaState(
        occ=_t(rep.occ, device, f32),
        proton_of_site=_t(rep.proton_of_site, device, i32),
        site_of_proton=_t(rep.site_of_proton, device, i32),
        t_last_jump=_t(rep.t_last_jump, device, f32),
        clock=clock,
        jumps=_t(rep.jumps, device, i32),
        disp_base=_t(rep.disp_base, device, f32),
        autocorr_ref=_t(rep.autocorr_ref, device, i32),
    )
    return EnsembleState(
        replicas=replicas,
        site_disp=_t(ens.site_disp, device, f32),
        prev_pos=_t(ens.prev_pos, device, f32),
    )


def law_from_fields(law, device="cpu"):
    """The port's rate law from a JAX law dataclass (same class name and
    parameter fields)."""
    cls = laws.LAW_REGISTRY.get(type(law).__name__)
    if cls is None:
        raise NotImplementedError(f"law {type(law).__name__} is not ported yet")
    missing = [n for n in cls.param_names if not hasattr(law, n)]
    if missing:
        raise ValueError(f"law {type(law).__name__} lacks fields {missing}")
    return cls(**{n: float(np.asarray(getattr(law, n))) for n in cls.param_names}).to(device)


def cell_from_fields(cell, device="cpu") -> Cell:
    h = _t(cell.h, device, np.float32)
    return Cell(h=h, h_inv=_t(cell.h_inv, device, np.float32),
                orthorhombic=bool(cell.orthorhombic))


def pair_rates_from_fields(model, device="cpu") -> PairRates:
    """The port's PairRates from a JAX ``PairRates``."""
    return PairRates(
        cell_from_fields(model.cell, device),
        law_from_fields(model.law, device),
        float(np.asarray(model.cutoff)),
        float(np.asarray(model.buffer)),
    )


def angle_pair_rates_from_fields(model, device="cpu") -> AnglePairRates:
    """The port's AnglePairRates from a JAX ``AnglePairRates``, its O -> P
    map carried over as it is."""
    return AnglePairRates(
        cell_from_fields(model.cell, device),
        law_from_fields(model.law, device),
        float(np.asarray(model.cutoff)),
        float(np.asarray(model.buffer)),
        _t(model.o_to_p, device, np.int64),
    )
