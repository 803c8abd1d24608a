"""float32 constants of the scan engines, one rule for all.

The JAX package writes Python numbers into float32 expressions (``dt``, the
histogram range, a relaxation time); XLA rounds them to float32 and applies
the operation in float32. The port's scan engines (``engine/clock.py``,
``engine/lattice.py``, ``models/water.py``, ``ops/threefry.py``) give torch
the same float32 values in one of two ways:

* :func:`f32`, a host scalar holding the float32 value: for a constant that
  adds, subtracts, multiplies or compares. torch passes it with the launch;
  no copy to the card.
* :func:`divisor`, a float32 tensor on the device, made once per value and
  device and then only read: for a constant that divides. torch's CUDA
  division by a host scalar multiplies by its reciprocal, which rounds
  otherwise than XLA's division; a tensor made afresh each time would be a
  copy to the card that waits for the stream.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cmdlmc_tpu_torch.utils import trace


def f32(value: float) -> float:
    """The float32 value of ``value``, as a host scalar."""
    return float(np.float32(value))


@functools.lru_cache(maxsize=64)
def divisor(value: float, device) -> torch.Tensor:
    """The float32 value of ``value`` on ``device``, to divide by (cached)."""
    return trace.to_device(torch.tensor(np.float32(value), dtype=torch.float32),
                           device, "constant")
