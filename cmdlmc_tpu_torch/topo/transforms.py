"""Donor-acceptor distance transformations of the hydronium model.

Port of ``cmdlmc_tpu/topo/transforms.py`` as ``nn.Module``s with float32
buffers, each in the JAX function's operation order:

* ``ReLUTransformation``: b below d0, a (d - d0) + b above, identity
  outside [left_bound, right_bound];
* ``LinearTransformation``: a d + b inside (left_bound, right_bound);
* ``InterpolatedTransformation``: a linear table lookup, y[0] below the
  table, identity above it;
* ``DistanceInterpolator``: the relaxation time of the blend neutral ->
  relaxed over the residence time of the proton on the donor site, which the
  top-K sweep evaluates in its own form (``ops/topk_sweep.py``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class _Buffers(nn.Module):
    """Stores each named value as a float32 buffer, and the same float32
    values on the host in ``host`` (read by kernel launches without a device
    sync)."""

    names: tuple[str, ...] = ()

    def __init__(self, **values):
        super().__init__()
        if set(values) != set(self.names):
            raise TypeError(f"{type(self).__name__} takes {self.names}, "
                            f"got {sorted(values)}")
        self.host = {n: np.asarray(values[n], np.float32) for n in self.names}
        for name in self.names:
            self.register_buffer(name, torch.from_numpy(self.host[name].copy()))


class ReLUTransformation(_Buffers):
    """b below d0, a (d - d0) + b above; identity outside
    [left_bound, right_bound]."""

    names = ("a", "b", "d0", "left_bound", "right_bound")

    def forward(self, distances: torch.Tensor) -> torch.Tensor:
        rescaled = torch.where(distances < self.d0, self.b,
                               self.a * (distances - self.d0) + self.b)
        outside = (distances <= self.left_bound) | (self.right_bound <= distances)
        return torch.where(outside, distances, rescaled)


class LinearTransformation(_Buffers):
    """a d + b inside (left_bound, right_bound), identity outside."""

    names = ("a", "b", "left_bound", "right_bound")

    def forward(self, distances: torch.Tensor) -> torch.Tensor:
        inside = (self.left_bound < distances) & (distances < self.right_bound)
        return torch.where(inside, self.a * distances + self.b, distances)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` as JAX computes it: the segment from
    searchsorted(side='right') clipped to [1, len - 1], then
    fp[i-1] + ((x - xp[i-1]) / dx) * df, fp[i-1] where |dx| is below the
    spacing of float32 eps, and fp[0] / fp[-1] outside the table."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class InterpolatedTransformation(_Buffers):
    """Linear table interpolation with the reference's clamps: inside
    [x0, x_last] interpolated, below y[0], above unchanged."""

    names = ("x", "y")

    @classmethod
    def from_file(cls, dist_array_filename: str, conversion_array_filename: str):
        return cls(x=np.load(dist_array_filename), y=np.load(conversion_array_filename))

    def forward(self, distances: torch.Tensor) -> torch.Tensor:
        out = torch.where(distances > self.x[-1], distances,
                          interp(distances, self.x, self.y))
        return torch.where(distances < self.x[0], self.y[0], out)


class DistanceInterpolator(_Buffers):
    """The linear blend neutral -> relaxed distances over the residence time
    of the proton on the donor site (a residence time < 0, "never jumped",
    is fully relaxed), as the scan engine evaluates it: (1 - ratio) neutral
    + ratio relaxed. The top-K kernel and its plain version evaluate it in
    their own form, d + ratio (r - d) (``ops/topk_sweep.py::candidate_rates``)."""

    names = ("relaxation_time",)

    def forward(self, residence_time: torch.Tensor, distance_neutral: torch.Tensor,
                distance_relaxed: torch.Tensor) -> torch.Tensor:
        ratio = torch.where(residence_time < 0, 1.0, torch.clamp(
            residence_time / self.relaxation_time, max=1.0))
        return (1.0 - ratio) * distance_neutral + ratio * distance_relaxed


TRANSFORM_REGISTRY = {
    "ReLUTransformation": ReLUTransformation,
    "LinearTransformation": LinearTransformation,
    "InterpolatedTransformation": InterpolatedTransformation,
}
