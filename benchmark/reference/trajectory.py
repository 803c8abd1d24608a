"""Synthetic MD trajectories and their xyz text, made from seeds.

The frame generators are frozen copies of ``chip_smoke.py:1412-1430`` at
commit 5a4702a (``_jitter_block``: bench.py's frames, uniform sites each
jittered by 0.03 A per frame; ``_walk_block``: tools/bench_topk_e2e.py's
frames, uniform sites plus a random walk). One change: the uniform sites
take the configuration's own ``structure_seed`` (the crystal a deployment
runs on does not change from run to run), the jitter or the walk takes
the run's seed, or, where the traffic mix says ``rotate``, the walk is one
trajectory for every seed and the seed picks the frame it starts from
(:func:`make_frames`).

The xyz text has fixed-width lines, so a reader can seek to any frame:
``frame_bytes`` bytes a frame, the atom lines ``ATOM_LINE`` wide.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

ATOM_FMT = "{name} %10.5f %10.5f %10.5f\n"
HEADER_FMT = "{n}\nframe %8d\n"


def jitter_frames(n, frames, box, jitter, structure_seed, seed):
    """Uniform sites in a cube of side ``box``, each frame jittered by a
    Gaussian of ``jitter`` A per coordinate around them; float32 [T, n, 3]."""
    base = np.random.RandomState(structure_seed).uniform(0, box, size=(n, 3)).astype(np.float32)
    rng = np.random.RandomState(seed)
    return (base[None] + rng.normal(scale=jitter, size=(frames, n, 3))).astype(np.float32)


def walk_frames(n, frames, box, drift, structure_seed, seed):
    """Uniform sites plus a random walk of ``drift`` A per frame and
    coordinate; float32 [T, n, 3]."""
    base = np.random.RandomState(structure_seed).uniform(0, box, size=(n, 3)).astype(np.float32)
    rng = np.random.RandomState(seed)
    walk = np.cumsum(rng.normal(scale=drift, size=(frames, n, 3)).astype(np.float32), axis=0)
    return (base[None] + walk).astype(np.float32)


GENERATORS = {"jitter": jitter_frames, "walk": walk_frames}


def make_frames(traffic: dict, config: dict, seed: int) -> np.ndarray:
    """The trajectory of a traffic mix over a configuration's small cell.
    With ``"rotate": true`` the trajectory is the same for every seed (its
    steps drawn from ``structure_seed + 1``, as a deployment's one MD
    trajectory is) and the seed only picks the frame it starts from, so
    every seed runs the same frames, in another order; else the steps
    take the run's seed."""
    gen = GENERATORS[traffic["trajectory"]]
    n, t = int(config["cell_sites"]), int(traffic["frames"])
    structure = int(config["structure_seed"])
    if not traffic.get("rotate"):
        return gen(n, t, float(config["box"]), float(traffic["step"]), structure,
                   int(seed) % 2**32)
    frames = gen(n, t, float(config["box"]), float(traffic["step"]), structure,
                 structure + 1)
    start = int(np.random.RandomState(int(seed) % 2**32).randint(0, t))
    return np.ascontiguousarray(np.roll(frames, -start, axis=0))


def frame_bytes(n: int, name: str = "O") -> int:
    return len(HEADER_FMT.format(n=n) % 0) + n * len(ATOM_FMT.format(name=name) % (0, 0, 0))


def write_xyz(path: Path, frames: np.ndarray, name: str = "O") -> None:
    """Write [T, n, 3] positions as fixed-width xyz text (one atom kind)."""
    t, n, _ = frames.shape
    atoms = ATOM_FMT.format(name=name) * n
    header = HEADER_FMT.format(n=n)
    flat = frames.reshape(t, -1).tolist()
    text = "".join(header % f + atoms % tuple(flat[f]) for f in range(t))
    tmp = Path(str(path) + ".tmp")
    tmp.write_text(text)
    tmp.replace(path)


def read_xyz_frames(path: Path, n: int, indices, name: str = "O") -> np.ndarray:
    """The frames ``indices`` of a file written by :func:`write_xyz`, parsed
    from its text: float32 [len(indices), n, 3]."""
    size = frame_bytes(n, name)
    head = len(HEADER_FMT.format(n=n) % 0)
    out = np.empty((len(indices), n, 3), np.float32)
    with open(path, "rb") as f:
        for i, t in enumerate(indices):
            f.seek(int(t) * size + head)
            body = f.read(size - head).decode().split()
            vals = np.array([float(v) for k, v in enumerate(body) if k % 4], np.float64)
            out[i] = vals.reshape(n, 3).astype(np.float32)
    return out
