"""Jump-rate laws as ``nn.Module``s with float32 parameter buffers.

Port of ``cmdlmc_tpu/rates/laws.py``. Each law evaluates elementwise with the
same operation order as the JAX law, so both round alike. Every law takes an
optional angle (radians), which only FermiAngle reads. Units: distances in Å,
angles in radians, rates in fs^-1, temperatures in K, activation energies in
eV.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cmdlmc_tpu_torch.core.cell import sqrt32

KB_EV_PER_K = 8.617333262e-5  # Boltzmann constant, eV / K


class _Law(nn.Module):
    """Stores each named parameter as a float32 scalar buffer, and keeps the
    same float32 values on the host in ``host_params`` (read by the kernels'
    launches without a device sync)."""

    param_names: tuple[str, ...] = ()

    def __init__(self, **params):
        super().__init__()
        missing = set(self.param_names) - set(params)
        if missing or len(params) != len(self.param_names):
            raise TypeError(
                f"{type(self).__name__} takes parameters {self.param_names}, "
                f"got {sorted(params)}"
            )
        for name in self.param_names:
            self.register_buffer(
                name, torch.tensor(float(params[name]), dtype=torch.float32)
            )
        self.host_params = {n: np.float32(params[n]) for n in self.param_names}

    def extra_repr(self) -> str:
        return ", ".join(
            f"{n}={float(getattr(self, n)):g}" for n in self.param_names
        )


class Fermi(_Law):
    """ω(d) = a / (1 + exp((d - b) / c))."""

    param_names = ("a", "b", "c")

    def forward(self, distance: torch.Tensor, angle=None) -> torch.Tensor:
        return self.a / (1.0 + torch.exp((distance - self.b) / self.c))


class FermiAngle(_Law):
    """Fermi rate gated to zero below an angle threshold θ (radians)."""

    param_names = ("a", "b", "c", "theta")

    def forward(self, distance: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
        fermi = self.a / (1.0 + torch.exp((distance - self.b) / self.c))
        return torch.where(angle < self.theta, 0.0, fermi)


class ActivationEnergy(_Law):
    """ω(d) = A exp(-E(d) / (k_B T)) with
    E(d) = max(a (d - d0) / sqrt(b + 1 / (d - d0)^2), 0)."""

    param_names = ("A", "a", "b", "d0", "T")

    def forward(self, distance: torch.Tensor, angle=None) -> torch.Tensor:
        dd = distance - self.d0
        # guard the 1/dd^2 pole: at d == d0 the energy is exactly zero
        safe = torch.where(torch.abs(dd) > 1e-6, dd, 1e-6)
        energy = self.a * dd / sqrt32(self.b + 1.0 / (safe * safe))
        energy = torch.clamp(energy, min=0.0)
        # k_B T in float32 arithmetic, as the JAX law computes it
        kt = torch.tensor(KB_EV_PER_K, dtype=torch.float32, device=self.T.device) * self.T
        return self.A * torch.exp(-energy / kt)


class Exponential(_Law):
    """ω(d) = a exp(b d)."""

    param_names = ("a", "b")

    def forward(self, distance: torch.Tensor, angle=None) -> torch.Tensor:
        return self.a * torch.exp(self.b * distance)


class Constant(_Law):
    """Distance-independent rate."""

    param_names = ("a",)

    def forward(self, distance: torch.Tensor, angle=None) -> torch.Tensor:
        return self.a.expand(distance.shape)


LAW_REGISTRY = {
    "Constant": Constant,
    "Fermi": Fermi,
    "FermiAngle": FermiAngle,
    "ActivationEnergy": ActivationEnergy,
    "AE": ActivationEnergy,
    "Exponential": Exponential,
}
