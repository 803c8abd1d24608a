"""State of the time-dependent KMC clock.

Port of the ``ClockState`` fields of ``cmdlmc_tpu/engine/clock.py``; the
per-frame clock step of the scan engine waits for ROADMAP A12 (the streamed
kernel runs the clock itself).

    u_remaining       the part of the current exponential draw not yet consumed
    phase             time consumed inside the current frame by the last event
    event_count       events so far
    last_event_frame / last_event_phase  exact timestamp of the last event
"""

from __future__ import annotations

import dataclasses

import torch


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
