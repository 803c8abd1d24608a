# Copied from cmdlmc_tpu/io/xyz.py (kept jax-free so the port never imports the JAX package).
"""Streaming xyz trajectory reader.

Replaces the reference's line-filter + ``np.genfromtxt``-per-frame parser
(IO/trajectory_parser.py:138-287) with a block-tokenizing reader: frames are
gathered in batches, tokenized once with numpy string ops, and yielded as
(names, float32 positions). A native C++ tokenizer (cmdlmc_tpu_torch.native) is used
when available; the numpy path is the always-available fallback.

Selections follow the reference semantics: a string or tuple of strings selects
atom types (indices resolved from the first frame,
trajectory_parser.py:272-287), an index array selects atoms directly.
"""

from __future__ import annotations

import io
import logging
from typing import Iterator, Sequence

import numpy as np

from cmdlmc_tpu_torch.io.frames import HostFrame

logger = logging.getLogger(__name__)


def _open_maybe(file_or_name, mode="r"):
    if hasattr(file_or_name, "read"):
        return file_or_name, False
    return open(file_or_name, mode), True


def read_first_frame_names(filename) -> np.ndarray:
    """Atom names of the first frame."""
    f, close = _open_maybe(filename)
    try:
        if hasattr(f, "seek"):
            f.seek(0)
        n_atoms = int(f.readline())
        f.readline()
        names = [f.readline().split()[0] for _ in range(n_atoms)]
    finally:
        if close:
            f.close()
        elif hasattr(f, "seek"):
            f.seek(0)
    return np.array(names)


def selection_from_atomnames(filename, *atomnames) -> np.ndarray:
    """Indices of the given atom types in frame order (the reference's
    get_xyz_selection_from_atomname, trajectory_parser.py:272-287)."""
    names = read_first_frame_names(filename)
    return np.nonzero(np.isin(names, list(atomnames)))[0]


def _parse_batch(body_lines: list[str], n_atoms: int):
    """Tokenize a batch of frame bodies (header lines already stripped).

    Returns (names [n_atoms] from the first frame, positions [F, n_atoms, 3]).
    Uses the native C++ tokenizer when available; numpy string ops otherwise.
    """
    from cmdlmc_tpu_torch import native

    total_atoms = len(body_lines)
    text = "".join(body_lines).encode()
    result = native.parse_atom_lines(text, total_atoms, n_atoms)
    if result is not None:
        names, pos = result
        if pos.shape[0] == total_atoms:
            return names, pos.reshape(-1, n_atoms, 3)
        logger.warning("Native parser returned %d/%d atoms; falling back",
                       pos.shape[0], total_atoms)
    tokens = np.array(text.decode().split())
    tokens = tokens.reshape(-1, 4)
    names = tokens[:n_atoms, 0].astype("U4")
    positions = tokens[:, 1:].astype(np.float32).reshape(-1, n_atoms, 3)
    return names, positions


class XYZTrajectory:
    """Iterable over xyz frames; yields :class:`HostFrame`.

    Parameters mirror the reference XYZTrajectory (trajectory_parser.py:176-269):
    ``time_step`` (fs between frames), ``number_of_atoms`` (read from the file
    header if omitted), ``selection`` (name, tuple of names, or index array),
    ``repeat`` (loop forever). ``stride``/``clip`` re-provide the legacy
    ``skip_frames``/``clip_trajectory`` keys (IO/config_parser.py:196-243):
    every ``stride``-th source frame of the first ``clip`` frames is used (and
    looped over under ``repeat``). Each used frame covers the full physical
    interval of the frames it replaces, so frame times advance by
    ``time_step * stride`` (the effective time step; see
    :attr:`effective_time_step`).
    """

    def __init__(
        self,
        filename,
        *,
        time_step: float,
        number_of_atoms: int | None = None,
        selection=None,
        repeat: bool = False,
        batch_frames: int = 256,
        stride: int = 1,
        clip: int | None = None,
    ):
        self.filename = filename
        self.time_step = time_step
        self.selection = selection
        self.repeat = repeat
        self.batch_frames = batch_frames
        self.stride = max(int(stride), 1)
        self.clip = int(clip) if clip else None
        self._current_frame_number = 0

        if number_of_atoms is None:
            f, close = _open_maybe(filename)
            try:
                number_of_atoms = int(f.readline())
            finally:
                if close:
                    f.close()
                elif hasattr(f, "seek"):
                    f.seek(0)
        self._number_of_atoms = int(number_of_atoms)

    @property
    def effective_time_step(self) -> float:
        """Physical time between *used* frames: subsampling by ``stride`` does
        not compress physical time (reference skip_frames semantics,
        IO/config_parser.py:196-202)."""
        return self.time_step * self.stride

    def _resolve_selection(self):
        sel = self.selection
        if sel is None:
            return None
        if isinstance(sel, str):
            return selection_from_atomnames(self.filename, sel)
        if isinstance(sel, tuple) and sel and isinstance(sel[0], str):
            return selection_from_atomnames(self.filename, *sel)
        return np.asarray(sel)

    def iter_batches(self) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
        """Yield (names, positions [F, N, 3], first_frame_index) batches —
        the fast path used by the engine's block streamer."""
        n_atoms = self._number_of_atoms
        frame_len = n_atoms + 2
        sel = self._resolve_selection()

        while True:
            f, close = _open_maybe(self.filename)
            src_idx = 0
            try:
                body: list[str] = []
                frames_in_batch = 0
                batch_start = self._current_frame_number
                while True:
                    if self.clip is not None and src_idx >= self.clip:
                        break
                    lines = [f.readline() for _ in range(frame_len)]
                    if not lines[-1] and not lines[0]:
                        break  # EOF
                    if not lines[-1] and lines[0]:
                        logger.warning("Trailing partial frame ignored")
                        break
                    keep = src_idx % self.stride == 0
                    src_idx += 1
                    if not keep:
                        continue
                    body.extend(lines[2:])
                    frames_in_batch += 1
                    self._current_frame_number += 1
                    if frames_in_batch == self.batch_frames:
                        names, pos = _parse_batch(body, n_atoms)
                        if sel is not None:
                            names, pos = names[sel], pos[:, sel]
                        yield names, pos, batch_start
                        body, frames_in_batch = [], 0
                        batch_start = self._current_frame_number
                if body:
                    names, pos = _parse_batch(body, n_atoms)
                    if sel is not None:
                        names, pos = names[sel], pos[:, sel]
                    yield names, pos, batch_start
            finally:
                if close:
                    f.close()
                elif hasattr(f, "seek"):
                    f.seek(0)
            if not self.repeat:
                return

    def __iter__(self) -> Iterator[HostFrame]:
        for names, positions, start in self.iter_batches():
            for i in range(positions.shape[0]):
                yield HostFrame(
                    names, positions[i],
                    time=(start + i) * self.effective_time_step,
                )

    @property
    def current_frame_number(self):
        return self._current_frame_number

    def __len__(self):
        f, close = _open_maybe(self.filename)
        try:
            counter = sum(1 for _ in f)
        finally:
            if close:
                f.close()
            elif hasattr(f, "seek"):
                f.seek(0)
        n = counter // (self._number_of_atoms + 2)
        if self.clip is not None:
            n = min(n, self.clip)
        return -(-n // self.stride)


def write_xyz_frame(out: io.TextIOBase, names: Sequence[str], positions, comment=""):
    out.write(f"{len(names)}\n{comment}\n")
    for name, p in zip(names, np.asarray(positions)):
        out.write(f"{name} {p[0]:14.8f} {p[1]:14.8f} {p[2]:14.8f}\n")
