"""Periodic simulation cell and minimum-image geometry in PyTorch.

Port of ``cmdlmc_tpu/core/cell.py``:

* cubic minimum image is the closed form ``d - L * round(d / L)``, with
  ``torch.round`` rounding half to even exactly like ``jnp.round``;
* triclinic cells use fractional coordinates (h^-1 . d, round, h .) plus the
  shortest of the 27 surrounding images;
* ``h`` holds the cell vectors as columns, so cartesian = h @ fractional.

All arithmetic is float32, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Offsets of the 27 periodic images around the home cell (triclinic search).
_IMAGE_SHIFTS = np.array(
    [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    dtype=np.float32,
)


@dataclasses.dataclass(frozen=True)
class Cell:
    """A periodic simulation cell: ``h`` (columns are cell vectors), its
    inverse, and whether the cheap closed-form minimum image applies."""

    h: torch.Tensor
    h_inv: torch.Tensor
    orthorhombic: bool = True

    @classmethod
    def cubic(cls, lengths, box_multiplier=(1, 1, 1), device=None) -> "Cell":
        """Orthorhombic cell from three box lengths, extended by
        ``box_multiplier`` for the virtual supercell."""
        lengths = torch.as_tensor(
            np.asarray(lengths, np.float32).reshape(3), device=device
        )
        lengths = lengths * torch.as_tensor(
            np.asarray(box_multiplier, np.float32), device=device
        )
        return cls(h=torch.diag(lengths), h_inv=torch.diag(1.0 / lengths),
                   orthorhombic=True)

    @classmethod
    def triclinic(cls, box_vectors, box_multiplier=(1, 1, 1),
                  device=None) -> "Cell":
        """General cell from 9 values or a (3, 3) array whose rows are the
        cell vectors (the reference's input convention)."""
        v = torch.as_tensor(
            np.asarray(box_vectors, np.float32).reshape(3, 3), device=device
        )
        v = v * torch.as_tensor(
            np.asarray(box_multiplier, np.float32), device=device
        )[:, None]
        h = v.T.contiguous()
        # numpy's float32 LAPACK inverse rounds like jnp.linalg.inv
        h_inv = torch.from_numpy(np.linalg.inv(h.cpu().numpy())).to(h.device)
        return cls(h=h, h_inv=h_inv, orthorhombic=False)

    @classmethod
    def from_parameter_array(cls, pbc, box_multiplier=(1, 1, 1),
                             device=None) -> "Cell":
        """3 values -> cubic, 9 values -> triclinic."""
        pbc = np.asarray(pbc, dtype=np.float32).ravel()
        if pbc.size == 3:
            return cls.cubic(pbc, box_multiplier, device)
        if pbc.size == 9:
            return cls.triclinic(pbc, box_multiplier, device)
        raise ValueError(f"Expected 3 or 9 box parameters, got {pbc.size}")

    @property
    def min_height(self) -> float:
        """Smallest perpendicular distance between opposite cell faces: the
        round-based fractional minimum image of the top-K kernels is exact
        only for vectors shorter than half of it."""
        h = self.h.detach().cpu().double().numpy()
        a, b, c = h[:, 0], h[:, 1], h[:, 2]
        volume = abs(np.dot(a, np.cross(b, c)))
        areas = np.array([np.linalg.norm(np.cross(b, c)),
                          np.linalg.norm(np.cross(c, a)),
                          np.linalg.norm(np.cross(a, b))])
        return float((volume / areas).min())

    def host_geometry(self) -> tuple[float, ...]:
        """h then h^-1, each row-major, as 18 host floats (the event-loop
        kernels' cell argument)."""
        return tuple(torch.cat([self.h.reshape(9), self.h_inv.reshape(9)]).tolist())


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root. torch's CPU ``sqrt`` may be one
    ulp off, while the JAX package, numpy and CUDA's ``sqrtf`` round
    correctly; a float64 square root rounded to float32 is correctly rounded."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def _rowvec_matmul_t(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x @ m.T for a 3x3 ``m``, summed in index order with one rounding per
    operation, as XLA's CPU dot does (torch's matmul fuses multiply-adds)."""
    cols = [x[..., 0] * m[i, 0] + x[..., 1] * m[i, 1] + x[..., 2] * m[i, 2]
            for i in range(3)]
    return torch.stack(cols, dim=-1)


def minimum_image(cell: Cell, dvec: torch.Tensor) -> torch.Tensor:
    """Wrap raw difference vectors (trailing dim 3) into the minimum image."""
    if cell.orthorhombic:
        lengths = torch.diagonal(cell.h)
        return dvec - lengths * torch.round(dvec / lengths)
    frac = _rowvec_matmul_t(dvec, cell.h_inv)
    frac = frac - torch.round(frac)
    base = _rowvec_matmul_t(frac, cell.h)
    shifts = _rowvec_matmul_t(
        torch.as_tensor(_IMAGE_SHIFTS, device=base.device), cell.h)
    candidates = base[..., None, :] + shifts  # (..., 27, 3)
    norms = torch.sum(candidates * candidates, dim=-1)
    best = torch.argmin(norms, dim=-1)  # first index on ties, like jnp
    idx = best[..., None, None].expand(*best.shape, 1, 3)
    return torch.gather(candidates, -2, idx).squeeze(-2)


def wrap_positions(cell: Cell, pos: torch.Tensor) -> torch.Tensor:
    """Wrap absolute positions into the home cell [0, L) per axis (fractional
    coordinates in [0, 1) for triclinic cells): the ``periodic_wrap`` output
    option."""
    if cell.orthorhombic:
        lengths = torch.diagonal(cell.h)
        return pos - lengths * torch.floor(pos / lengths)
    frac = _rowvec_matmul_t(pos, cell.h_inv)
    frac = frac - torch.floor(frac)
    return _rowvec_matmul_t(frac, cell.h)


def displacement(cell: Cell, r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Minimum-image displacement r2 - r1."""
    return minimum_image(cell, r2 - r1)


def distance(cell: Cell, r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Minimum-image scalar distance."""
    d = displacement(cell, r1, r2)
    return sqrt32(torch.sum(d * d, dim=-1))


def pairwise_distances(cell: Cell, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-to-all minimum-image distances of shape (..., len(a), len(b))."""
    d = displacement(cell, a[..., :, None, :], b[..., None, :, :])
    return sqrt32(torch.sum(d * d, dim=-1))


def _dot3(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing 3 of u * v, in index order, one rounding per
    operation (as XLA sums a 3-element reduction)."""
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] + u[..., 2] * v[..., 2]


def extended_positions(base_cell_vectors, positions: torch.Tensor,
                       multiplier) -> torch.Tensor:
    """Positions of the virtual supercell, [..., n, 3] -> [..., M n, 3] with
    M = mx my mz: ``index = box_index * n + atom_index``, box_index row-major
    over (mx, my, mz) (``cmdlmc_tpu/core/cell.py::extended_positions``, in
    its float32 order: shift (i v0 + j v1) + k v2, then shift + position).
    ``base_cell_vectors`` holds the unextended cell vectors as rows (3 box
    lengths for a cubic cell)."""
    base = np.asarray(base_cell_vectors, np.float32)
    v = torch.as_tensor(np.diag(base) if base.size == 3 else base.reshape(3, 3),
                        dtype=positions.dtype, device=positions.device)
    mx, my, mz = (int(m) for m in multiplier)
    shifts = torch.stack([i * v[0] + j * v[1] + k * v[2] for i in range(mx)
                          for j in range(my) for k in range(mz)])  # [M, 3]
    out = shifts[:, None, :] + positions[..., None, :, :]  # [..., M, n, 3]
    return out.reshape(*positions.shape[:-2], -1, 3)


def angle(cell: Cell, r1: torch.Tensor, r2: torch.Tensor, r3: torch.Tensor) -> torch.Tensor:
    """Angle (radians) at vertex ``r2`` between ``r1`` and ``r3`` under PBC:
    the angle between the minimum-image vectors r1 - r2 and r3 - r2. The
    arccos is float32 (torch's and XLA's may differ by an ulp)."""
    v1 = displacement(cell, r2, r1)
    v2 = displacement(cell, r2, r3)
    num = _dot3(v1, v2)
    den = sqrt32(_dot3(v1, v1) * _dot3(v2, v2))
    return torch.arccos(torch.clamp(num / den, -1.0, 1.0))
