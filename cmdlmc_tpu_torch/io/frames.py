# Copied from cmdlmc_tpu/io/frames.py (kept jax-free so the port never imports the JAX package).
"""Host-side frame container and atom utilities.

Mirrors the reference's ``Frame`` wrapper (IO/trajectory_parser.py:43-113) —
selection by atom name or index, append, xyz-style repr — plus the atom-level
helpers from atoms/numpy_atom.py (masses, center-of-mass motion removal, acidic
proton detection). Everything here is host/numpy; device code receives bare
position arrays.
"""

from __future__ import annotations

import numpy as np

# Atomic masses used by center-of-mass removal (numpy_atom.py:15-22).
ATOM_MASSES = {
    "H": 1.008,
    "C": 12.011,
    "N": 14.007,
    "O": 15.999,
    "P": 30.974,
    "S": 32.06,
    "Cs": 132.905,
    "Se": 78.971,
}


class HostFrame:
    """One frame: parallel (names, positions) arrays with an optional time."""

    __slots__ = ("names", "positions", "time")

    def __init__(self, names, positions, *, time=None):
        self.names = np.asarray(names)
        self.positions = np.asarray(positions)
        self.time = time

    # Reference-compatible aliases -------------------------------------------------
    @property
    def atom_names(self):
        return self.names

    @property
    def atom_positions(self):
        return self.positions

    @property
    def atom_number(self):
        return self.names.size

    def __getitem__(self, selection):
        if isinstance(selection, str):
            mask = self.names == selection
            return HostFrame(self.names[mask], self.positions[mask], time=self.time)
        if isinstance(selection, (list, tuple, np.ndarray)):
            sel = np.asarray(selection)
            return HostFrame(self.names[sel], self.positions[sel], time=self.time)
        raise ValueError(f"Selection {selection!r} not understood")

    def append(self, other: "HostFrame") -> "HostFrame":
        return HostFrame(
            np.hstack([self.names, other.names]),
            np.vstack([self.positions, other.positions]),
            time=self.time,
        )

    def __repr__(self):
        lines = "\n".join(
            f"{name}    {p[0]:20.10f} {p[1]:20.10f} {p[2]:20.10f}"
            for name, p in zip(self.names, self.positions)
        )
        return f"{self.atom_number}\n\n{lines}"


def remove_center_of_mass_movement(names, positions):
    """Shift each frame so its mass-weighted center sits at the origin — the
    reference semantics (numpy_atom.py:103-112). ``positions`` may be one frame
    [N, 3] or a batch [F, N, 3]; returns the shifted array."""
    positions = np.asarray(positions)
    masses = np.array([ATOM_MASSES.get(str(n), 1.0) for n in np.asarray(names)])
    w = masses / masses.sum()
    com = np.tensordot(positions, w, axes=(-2, 0))  # [..., 3]
    return positions - com[..., None, :]


def acidic_proton_indices(names, positions, box_lengths) -> np.ndarray:
    """Indices of H atoms whose nearest (minimum-image) non-H neighbor is an O
    (PBCHelper.pyx:198-211 / numpy_atom.py:25-48)."""
    names = np.asarray(names)
    positions = np.asarray(positions, dtype=np.float64)
    box = np.asarray(box_lengths, dtype=np.float64)
    h_idx = np.nonzero(names == "H")[0]
    other_idx = np.nonzero(names != "H")[0]
    if h_idx.size == 0 or other_idx.size == 0:
        return np.array([], dtype=np.int64)
    diffs = positions[other_idx][None, :, :] - positions[h_idx][:, None, :]
    diffs -= box * np.round(diffs / box)
    d2 = (diffs**2).sum(axis=-1)
    nearest = other_idx[np.argmin(d2, axis=1)]
    return h_idx[names[nearest] == "O"]
