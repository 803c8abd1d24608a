"""Carry parameters, state and keys over from the JAX package.

The JAX package initializes replicas with threefry draws that the port's
``init_replicas`` does not reproduce; parity runs therefore hand the JAX
package's own initial state to ``Simulation(cfg, initial_state=...)``. The
scan engine's keys are JAX's own bit for bit (``ops/threefry.py``);
:func:`keys_from_numpy` takes JAX key data over, ``threefry.key_data``
gives it back. Everything here reads plain attributes through
``np.asarray``, so this module never imports ``jax``: it takes the JAX
objects (or anything with the same fields) as they come.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from cmdlmc_tpu_torch.core.cell import Cell
from cmdlmc_tpu_torch.engine.clock import ClockState
from cmdlmc_tpu_torch.engine.lattice import EnsembleState, NeighborCarry, ReplicaState
from cmdlmc_tpu_torch.rates import laws
from cmdlmc_tpu_torch.topo import transforms
from cmdlmc_tpu_torch.topo.models import (
    AnglePairRates, HydroniumRates, PairRates, TopKPairRates,
)


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def keys_from_numpy(keys, device="cpu") -> torch.Tensor:
    """The port's key tensor (int64 words) from JAX key data, uint32
    [..., 2] (``np.asarray(jax.random.key_data(keys))``)."""
    return _t(np.asarray(keys, dtype=np.uint32), device, np.int64)


def neighbor_carry_from_fields(carry, k: int, device="cpu") -> NeighborCarry:
    """The port's NeighborCarry from a JAX ``NeighborCarry``: its first
    ``k`` = min(max_neighbors, N - 1) rows (the JAX package pads the lists
    to whole float32 tiles and keeps the ids as floats)."""
    return NeighborCarry(
        ref_pos=_t(carry.ref_pos, device, np.float32),
        ref_topi=_t(np.rint(np.asarray(carry.ref_topi)[:k]), device, np.int32),
        ref_valid=_t(np.asarray(carry.ref_valid)[:k] > 0.5, device),
        thresh=float(carry.thresh),
        last_rebuild=float(carry.last_rebuild),
        thrash_until=float(carry.thrash_until),
    )


def ensemble_from_numpy(ens, device="cpu", k: int | None = None) -> EnsembleState:
    """The port's EnsembleState from the fields of a JAX ``EnsembleState``;
    a neighbor carry comes over with its first ``k`` rows
    (:func:`neighbor_carry_from_fields`). The jump histograms and the jump
    matrix come over as they are (empty where the statistics are off; a
    state without them gets them empty)."""
    rep = ens.replicas
    R, N = np.shape(rep.occ)
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
        jump_hist=_t(_field(rep, "jump_hist", (R, 0)), device, i32),
        opportunity_hist=_t(_field(rep, "opportunity_hist", (R, 0)), device, f32),
        jump_matrix=_t(_field(rep, "jump_matrix", (R, 0, 0)), device, i32),
    )
    carry = getattr(ens, "nbr_carry", None)
    if carry is not None:
        if k is None:
            raise ValueError("a state with a neighbor carry needs k")
        carry = neighbor_carry_from_fields(carry, k, device)
    return EnsembleState(
        replicas=replicas,
        site_disp=_t(ens.site_disp, device, f32),
        prev_pos=_t(ens.prev_pos, device, f32),
        nbr_carry=carry,
    )


def _field(obj, name: str, empty_shape) -> np.ndarray:
    value = getattr(obj, name, None)
    return np.zeros(empty_shape) if value is None else np.asarray(value)


def ensemble_to_numpy(ens: EnsembleState) -> SimpleNamespace:
    """The inverse of :func:`ensemble_from_numpy`: the state's fields as
    numpy arrays under the JAX package's names (``replicas``, its ``clock``,
    ``site_disp``, ``prev_pos``; the neighbor carry is not included)."""
    rep = ens.replicas

    def arrays(obj, names):
        return SimpleNamespace(**{n: getattr(obj, n).cpu().numpy() for n in names})

    replicas = arrays(rep, [f.name for f in dataclasses.fields(rep)
                            if f.name != "clock"])
    replicas.clock = arrays(rep.clock, [f.name for f in dataclasses.fields(rep.clock)])
    return SimpleNamespace(replicas=replicas, site_disp=ens.site_disp.cpu().numpy(),
                           prev_pos=ens.prev_pos.cpu().numpy(), nbr_carry=None)


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


def transform_from_fields(transform, device="cpu"):
    """The port's distance transformation (ReLU, Linear, or Interpolated
    with its x / y tables) from a JAX one, or None."""
    if transform is None:
        return None
    cls = transforms.TRANSFORM_REGISTRY.get(type(transform).__name__)
    if cls is None:
        raise NotImplementedError(
            f"transformation {type(transform).__name__} is not ported")
    return cls(**{n: np.asarray(getattr(transform, n)) for n in cls.names}).to(device)


def topk_pair_rates_from_fields(model, device="cpu") -> TopKPairRates:
    """The port's TopKPairRates from a JAX ``TopKPairRates``."""
    return TopKPairRates(
        cell_from_fields(model.cell, device),
        law_from_fields(model.law, device),
        float(np.asarray(model.cutoff)),
        float(np.asarray(model.buffer)),
        k=int(model.k),
    )


def hydronium_rates_from_fields(model, device="cpu") -> HydroniumRates:
    """The port's HydroniumRates from a JAX ``HydroniumRates``, with its
    transformation and interpolator."""
    interp = None
    if model.interpolator is not None:
        interp = transforms.DistanceInterpolator(
            relaxation_time=np.asarray(model.interpolator.relaxation_time)).to(device)
    return HydroniumRates(
        cell_from_fields(model.cell, device),
        law_from_fields(model.law, device),
        float(np.asarray(model.cutoff)),
        float(np.asarray(model.buffer)),
        transform=transform_from_fields(model.transform, device),
        interpolator=interp,
        k=int(model.k),
    )


def water_model_from_fields(model, device="cpu"):
    """The port's WaterModel from a JAX ``WaterModel``: its cell, law,
    transformation and static fields."""
    from cmdlmc_tpu_torch.models.water import WaterModel

    return WaterModel(
        cell_from_fields(model.cell, device), law_from_fields(model.law, device),
        transform_from_fields(model.transform, device),
        float(np.asarray(model.d_oh)), n_atoms=int(model.n_atoms),
        relaxation_time=int(model.relaxation_time),
        waiting_time=int(model.waiting_time),
        keep_last_neighbor_rescaled=bool(model.keep_last_neighbor_rescaled),
        check_from_old=bool(model.check_from_old),
    ).to(device)


def water_states_from_fields(states, device="cpu"):
    """The port's WaterState from the fields of a JAX ``WaterState`` (the
    clock's u_remaining and event_count included)."""
    from cmdlmc_tpu_torch.models.water import WaterState

    c = states.clock
    f32, i32 = np.float32, np.int32
    clock = ClockState(
        u_remaining=_t(c.u_remaining, device, f32),
        phase=_t(c.phase, device, f32),
        event_count=_t(c.event_count, device, i32),
        last_event_frame=_t(c.last_event_frame, device, i32),
        last_event_phase=_t(c.last_event_phase, device, f32),
    )
    return WaterState(
        site=_t(states.site, device, i32),
        last_site=_t(states.last_site, device, i32),
        frames_since_jump=_t(states.frames_since_jump, device, i32),
        wait_left=_t(states.wait_left, device, i32),
        correction=_t(states.correction, device, f32),
        clock=clock,
        jumps=_t(states.jumps, device, i32),
        snapshot=_t(states.snapshot, device, f32),
        displacement=_t(states.displacement, device, f32),
    )
