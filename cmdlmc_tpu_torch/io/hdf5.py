# Copied from cmdlmc_tpu/io/hdf5.py (kept jax-free so the port never imports the JAX package; h5py is imported where it is used, so the port imports on hosts without it).
"""HDF5 trajectory store.

Same on-disk layout as the reference (IO/trajectory_parser.py:290-337,
IO/converters.py:22-50): datasets ``trajectory`` (float32 [F, N, 3]) and
``atom_names`` (bytes). Compression preference: Blosc (filter 32001) when
available, then LZF+shuffle, then gzip — the reference hard-requires
pytables+conda for Blosc; we degrade gracefully.
"""

from __future__ import annotations

import logging
from typing import Iterator

import numpy as np

from cmdlmc_tpu_torch.io.frames import HostFrame

logger = logging.getLogger(__name__)

TRAJECTORY_KEY = "trajectory"
ATOMNAMES_KEY = "atom_names"
BLOSC_FILTER = 32001


def _h5py():
    """h5py, imported on first use: a host without it still imports the
    port, and only an HDF5 file fails, with an error that names h5py."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(
            "HDF5 trajectories need the h5py package, which is not installed "
            "on this host; use an xyz trajectory instead") from exc
    return h5py


class HDF5Trajectory:
    """Iterable over HDF5 trajectory frames with chunked reads
    (trajectory_parser.py:313-328)."""

    def __init__(
        self,
        filename: str,
        time_step: float,
        selection=None,
        repeat: bool = False,
        chunk_size: int = 1000,
        stride: int = 1,
        clip: int | None = None,
        shuffle_seed: int | None = None,
    ):
        """``stride``/``clip`` re-provide the legacy ``skip_frames``/
        ``clip_trajectory`` keys; ``shuffle_seed`` enables the legacy
        ``shuffle`` mode — frames drawn uniformly at random (with replacement,
        seeded, endless; bound the run with sweeps/max_frames)."""
        h5py = _h5py()
        self.filename = filename
        self.time_step = time_step
        self.repeat = repeat
        self.chunk_size = int(chunk_size)
        self.stride = max(int(stride), 1)
        self.clip = int(clip) if clip else None
        self.shuffle_seed = shuffle_seed
        self._current_frame_number = 0

        with h5py.File(filename, "r") as f:
            names = f[ATOMNAMES_KEY][:]
        self.atom_names = names.astype("U4")

        if selection is None:
            self.selection = None
        elif isinstance(selection, str):
            self.selection = np.nonzero(self.atom_names == selection)[0]
        elif isinstance(selection, tuple) and selection and isinstance(selection[0], str):
            self.selection = np.nonzero(np.isin(self.atom_names, list(selection)))[0]
        else:
            self.selection = np.asarray(selection)

    @property
    def effective_time_step(self) -> float:
        """Physical time between *used* frames: subsampling by ``stride`` does
        not compress physical time (reference skip_frames semantics,
        IO/config_parser.py:196-202)."""
        return self.time_step * self.stride

    def iter_batches(self) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
        h5py = _h5py()
        names = self.atom_names if self.selection is None else self.atom_names[self.selection]
        if self.shuffle_seed is not None:
            yield from self._iter_shuffled(names)
            return
        while True:
            with h5py.File(self.filename, "r") as f:
                traj = f[TRAJECTORY_KEY]
                n = traj.shape[0]
                if self.clip is not None:
                    n = min(n, self.clip)
                for start in range(0, n, self.chunk_size):
                    stop = min(start + self.chunk_size, n)
                    if self.stride > 1:
                        # h5py fancy-slices with a step natively
                        first = -(start % -self.stride) + start  # round up
                        if first >= stop:
                            continue
                        block = traj[first:stop:self.stride]
                    else:
                        block = traj[start:stop]
                    if self.selection is not None:
                        block = block[:, self.selection]
                    batch_start = self._current_frame_number
                    self._current_frame_number += block.shape[0]
                    yield names, np.asarray(block, dtype=np.float32), batch_start
            if not self.repeat:
                return

    def _iter_shuffled(self, names):
        """Legacy 'shuffle' mode (IO/config_parser.py:275-281): an endless,
        seeded stream of uniformly random frames."""
        h5py = _h5py()
        rng = np.random.default_rng(self.shuffle_seed)
        with h5py.File(self.filename, "r") as f:
            traj = f[TRAJECTORY_KEY]
            n = traj.shape[0]
            if self.clip is not None:
                n = min(n, self.clip)
            while True:
                idx = rng.integers(0, n, size=self.chunk_size)
                # h5py needs strictly increasing fancy indices; sampling is
                # with replacement, so read unique rows and expand
                uniq, inv = np.unique(idx, return_inverse=True)
                block = traj[uniq][inv]
                if self.selection is not None:
                    block = block[:, self.selection]
                batch_start = self._current_frame_number
                self._current_frame_number += block.shape[0]
                yield names, np.asarray(block, dtype=np.float32), batch_start

    def __iter__(self) -> Iterator[HostFrame]:
        for names, positions, start in self.iter_batches():
            for i in range(positions.shape[0]):
                yield HostFrame(
                    names, positions[i],
                    time=(start + i) * self.effective_time_step,
                )

    def __len__(self):
        h5py = _h5py()
        with h5py.File(self.filename, "r") as f:
            n = f[TRAJECTORY_KEY].shape[0]
        if self.clip is not None:
            n = min(n, self.clip)
        return -(-n // self.stride)

    @property
    def current_frame_number(self):
        return self._current_frame_number


def _compression_kwargs():
    """Prefer Blosc (the reference's on-disk format) when the HDF5 plugin is
    present, then LZF, then gzip. The choice only affects files WE write —
    reads handle whatever filter the file carries. LZF over gzip because the
    prefetch thread decompresses every chunk at stream time: gzip-4 decode of
    float32 positions is slow enough to starve the device pipeline on a
    small host (the 1M-frame soak), while LZF (+byte-shuffle, which recovers
    most of the ratio on coordinates) decodes several times faster. Note LZF
    is an h5py-native filter: files are portable across h5py installs but
    not to non-Python HDF5 tools — pass gzip explicitly via h5py if that
    matters more than stream speed."""
    h5py = _h5py()
    if h5py.h5z.filter_avail(BLOSC_FILTER):
        return {"compression": BLOSC_FILTER}
    if h5py.h5z.filter_avail(h5py.h5z.FILTER_LZF):
        return {"compression": "lzf", "shuffle": True}
    return {"compression": "gzip", "compression_opts": 4}


def compression_kwargs(compression: str = "auto") -> dict:
    """Dataset creation kwargs for a named compression choice.

    ``auto``  — Blosc > LZF+shuffle > gzip (see :func:`_compression_kwargs`);
    ``none``  — uncompressed: the streaming fast layout. MD position noise
    compresses poorly (~10% on the soak trajectory) while the decode burns
    the host CPU that also feeds the device — on a small host the
    decompression thread IS the cold-cache streaming wall, and raw chunked
    reads are a straight memcpy from the page cache / disk readahead;
    ``blosc`` / ``lzf`` / ``gzip`` — force one filter (error if missing)."""
    h5py = _h5py()
    if compression in ("auto", None):
        return _compression_kwargs()
    if compression in ("none", "raw"):
        return {}
    if compression == "blosc":
        if not h5py.h5z.filter_avail(BLOSC_FILTER):
            raise ValueError("Blosc HDF5 filter (32001) is not available")
        return {"compression": BLOSC_FILTER}
    if compression == "lzf":
        return {"compression": "lzf", "shuffle": True}
    if compression == "gzip":
        return {"compression": "gzip", "compression_opts": 4}
    raise ValueError(
        f"unknown compression {compression!r} "
        "(choose auto, none, blosc, lzf or gzip)"
    )


def write_trajectory(
    hdf5_fname: str,
    atom_names: np.ndarray,
    n_frames: int,
    frame_shape: tuple[int, int],
    frame_iter,
    *,
    dataset_name: str = TRAJECTORY_KEY,
    log_every: int = 10000,
    slab_frames: int = 1000,
    compression: str = "auto",
):
    """Create the reference-layout HDF5 file from an iterator of position
    arrays (converters.py:22-50). Frames are buffered into slabs so each HDF5
    write covers whole compressed chunks — frame-by-frame writes re-compress
    every chunk per frame and are ~100x slower at scale. ``compression``:
    see :func:`compression_kwargs` (``none`` = the streaming fast layout)."""
    h5py = _h5py()
    with h5py.File(hdf5_fname, "w") as f:
        names_bytes = np.asarray(atom_names).astype("S4")
        ds_names = f.create_dataset(ATOMNAMES_KEY, names_bytes.shape, dtype="S4")
        ds_names[:] = names_bytes
        chunk_frames = min(slab_frames, max(1, n_frames))
        traj = f.create_dataset(
            dataset_name,
            shape=(n_frames, *frame_shape),
            dtype=np.float32,
            chunks=(chunk_frames, *frame_shape),
            **compression_kwargs(compression),
        )
        slab = np.empty((slab_frames, *frame_shape), dtype=np.float32)
        filled = 0
        written = 0
        for positions in frame_iter:
            slab[filled] = positions
            filled += 1
            if filled == slab_frames:
                traj[written : written + filled] = slab
                written += filled
                filled = 0
                if written % log_every == 0:
                    logger.info("Frame %i", written)
        if filled:
            traj[written : written + filled] = slab[:filled]
    return hdf5_fname
