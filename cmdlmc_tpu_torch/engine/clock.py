"""Time-dependent KMC clock as a per-frame state machine.

Port of ``cmdlmc_tpu/engine/clock.py``, batched over R lanes (tensors
[R, ...] where the JAX package vmaps): every MD frame pushes one update into
a small per-lane state

    u_remaining       the part of the current exponential draw not yet
                      consumed (dimensionless integrated rate)
    phase             time consumed inside the current frame by the last
                      event, in [0, dt)
    event_count       events so far: keys the per-event draws, so results do
                      not depend on how the trajectory is cut into blocks
    last_event_frame / last_event_phase  exact timestamp of the last event

Within one frame at most ``max_events`` events fire; rates are recomputed
after each event through the ``rate_fn``/``apply_fn`` callables. The draws
are JAX's own (``ops/threefry.py``): the i-th exponential comes from
``fold_in(fold_in(key, 1), i)``, the i-th event's selection key from
``fold_in(fold_in(key, 2), i)``, so from the same keys and state the port
makes the JAX package's decisions. The event-loop kernels run their own
clock with the counter hash (``ops/rng.py``); this one serves the scan
engine (``engine/lattice.py``, ``models/water.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from cmdlmc_tpu_torch.core.f32 import f32
from cmdlmc_tpu_torch.ops import threefry

_DRAW_TAG = 1  # sub-stream of the exponential waiting-time draws
_SELECT_TAG = 2  # sub-stream of the selection keys handed to apply_fn


@dataclasses.dataclass
class ClockState:
    u_remaining: torch.Tensor  # f32 [R]
    phase: torch.Tensor  # f32 [R]
    event_count: torch.Tensor  # i32 [R]
    last_event_frame: torch.Tensor  # i32 [R]
    last_event_phase: torch.Tensor  # f32 [R]

    def to(self, device) -> "ClockState":
        return ClockState(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


def _draw_key(key: torch.Tensor, ordinal) -> torch.Tensor:
    return threefry.fold_in(threefry.fold_in(key, _DRAW_TAG), ordinal)


def _select_key(key: torch.Tensor, ordinal) -> torch.Tensor:
    return threefry.fold_in(threefry.fold_in(key, _SELECT_TAG), ordinal)


def tag_keys(key: torch.Tensor) -> torch.Tensor:
    """The two sub-stream bases of lane keys [R, 2]: [2, R, 2], the draw
    base fold_in(key, 1) first, then the selection base fold_in(key, 2).
    They depend on the keys alone, so a caller computes them once per run."""
    tags = torch.arange(_DRAW_TAG, _SELECT_TAG + 1, dtype=torch.int64, device=key.device)
    return threefry.fold_in(key[None], tags.reshape(2, *([1] * (key.dim() - 1))))


def init_clock(key: torch.Tensor) -> ClockState:
    """Fresh clocks for lane keys [R, 2]: the i-th exponential draw is keyed
    by the event ordinal i alone (never by the frame)."""
    u0 = threefry.exponential(_draw_key(key, 0))
    zeros = torch.zeros_like(u0)
    return ClockState(
        u_remaining=u0,
        phase=zeros,
        event_count=torch.zeros(u0.shape, dtype=torch.int32, device=u0.device),
        last_event_frame=torch.full(u0.shape, -1, dtype=torch.int32, device=u0.device),
        last_event_phase=zeros.clone(),
    )


def frame_step(
    clock: ClockState,
    aux: Any,
    *,
    frame_idx: int,
    dt: float,
    rate_fn: Callable[[Any], torch.Tensor],
    apply_fn: Callable[[Any, torch.Tensor, torch.Tensor, torch.Tensor], Any],
    key: torch.Tensor,
    max_events: int = 4,
    tags: torch.Tensor | None = None,
) -> tuple[ClockState, Any, torch.Tensor]:
    """Advance the lanes' clocks across one MD frame of duration ``dt``.

    rate_fn(aux) -> total jump rate of each lane [R] (1/fs) in state aux.
    apply_fn(aux, event_keys [R, 2], event_phase [R], fire [R] bool) -> aux
        after one jump event in the lanes where ``fire`` holds; the other
        lanes keep their state (the JAX package's fired mask).
    ``key`` holds the lane keys [R, 2]; ``tags`` their :func:`tag_keys`
    where the caller keeps them.

    Returns (clock', aux', n_fired [R] int32). A lane fires while
    u_remaining <= rate (dt - phase) with a positive budget; then no more
    event fires this frame and the leftover integrated rate is consumed.
    """
    if tags is None:
        tags = tag_keys(key)
    dev = clock.phase.device
    dt_f = f32(dt)
    done = torch.zeros(clock.phase.shape, dtype=torch.bool, device=dev)
    n_fired = torch.zeros(clock.phase.shape, dtype=torch.int32, device=dev)
    for _ in range(max_events):
        rate = rate_fn(aux)
        budget = rate * (dt_f - clock.phase)
        fire = ~done & (clock.u_remaining <= budget) & (budget > 0)
        safe_rate = torch.where(rate > 0, rate, 1.0)
        event_phase = clock.phase + clock.u_remaining / safe_rate
        # the selection key of this event and the draw key of the next
        ordinals = torch.stack([clock.event_count + 1, clock.event_count])
        draw_key, event_key = threefry.fold_in(tags, ordinals)
        aux = apply_fn(aux, event_key, event_phase, fire)
        next_u = threefry.exponential(draw_key)
        clock = ClockState(
            u_remaining=torch.where(fire, next_u, clock.u_remaining),
            phase=torch.where(fire, event_phase, clock.phase),
            event_count=clock.event_count + fire.to(torch.int32),
            last_event_frame=torch.where(fire, frame_idx, clock.last_event_frame),
            last_event_phase=torch.where(fire, event_phase, clock.last_event_phase),
        )
        done = done | ~fire
        n_fired = n_fired + fire.to(torch.int32)
    # no further event this frame: consume the leftover integrated rate and
    # hand a fresh frame (phase 0) to the next step
    leftover = rate_fn(aux) * (dt_f - clock.phase)
    clock = dataclasses.replace(clock, u_remaining=clock.u_remaining - leftover,
                                phase=torch.zeros_like(clock.phase))
    return clock, aux, n_fired


def event_time(clock: ClockState, dt: float) -> torch.Tensor:
    """Timestamp of each lane's last event (frame dt + phase) in float32;
    :func:`event_time_f64` is exact over long runs."""
    return (clock.last_event_frame.to(torch.float32) * f32(dt)
            + clock.last_event_phase)


def event_time_f64(clock: ClockState, dt: float) -> np.ndarray:
    """Host-side exact event timestamps (float64)."""
    frame = clock.last_event_frame.cpu().numpy().astype(np.float64)
    return frame * float(dt) + clock.last_event_phase.cpu().numpy().astype(np.float64)


def fastforward_events(rates: torch.Tensor, dt: float, key: torch.Tensor, *,
                       max_events: int = 4):
    """Standalone clock over a fixed per-frame rate: rates [F] for a key [2],
    or [F] or [F, R] for lane keys [R, 2]. The functional twin of the
    reference's ``fastforward_to_next_jump``.

    Returns n_fired int32 [F] (or [F, R]) and phases float32
    [F, max_events] (or [F, R, max_events]), NaN where unused."""
    single = key.dim() == 1
    keys = key[None] if single else key
    R = keys.shape[0]
    rates = torch.as_tensor(rates, dtype=torch.float32, device=keys.device)
    if rates.dim() == 1:
        rates = rates[:, None].expand(rates.shape[0], R)
    tags = tag_keys(keys)
    clock = init_clock(keys)
    lanes = torch.arange(R, device=keys.device)
    out_n, out_phases = [], []
    for f in range(rates.shape[0]):
        rate = rates[f]

        def apply_fn(aux, event_key, event_phase, fire):
            slot, phases = aux
            new = phases.clone()
            new[lanes, slot.clamp(max=max_events - 1).long()] = event_phase
            return (slot + fire.to(torch.int32),
                    torch.where(fire[:, None], new, phases))

        aux = (torch.zeros(R, dtype=torch.int32, device=keys.device),
               torch.full((R, max_events), float("nan"), device=keys.device))
        clock, (_, phases), n = frame_step(
            clock, aux, frame_idx=f, dt=dt, rate_fn=lambda aux: rate,
            apply_fn=apply_fn, key=keys, max_events=max_events, tags=tags)
        out_n.append(n)
        out_phases.append(phases)
    n_fired, phases = torch.stack(out_n), torch.stack(out_phases)
    if single:
        return n_fired[:, 0], phases[:, 0]
    return n_fired, phases
