# Copied from cmdlmc_tpu/native/__init__.py (kept jax-free so the port never imports the JAX package).
"""Native (C++) host-side components, bound via ctypes.

Compiled lazily with g++ on first use into ``cmdlmc_tpu_torch/_build/``,
named by a hash of the sources and flags and written through a temporary
file and a rename, so that concurrent processes never load half a library
and an edited source rebuilds; every caller must tolerate absence
(pure-numpy fallbacks exist for all native paths). ``CMDLMC_NO_NATIVE``
turns the library off."""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_SOURCES = [os.path.join(_HERE, "xyz_parser.cpp")]
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_tried = False


def so_path() -> str:
    """The library's path: keyed on the sources and the compiler flags."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libcmdlmc_native_{h.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *_FLAGS, "-o", tmp, *_SOURCES]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)  # atomic: concurrent builders never load halves
        return True
    except (subprocess.SubprocessError, OSError) as exc:
        logger.warning("Native build failed (%s); using numpy fallbacks", exc)
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("CMDLMC_NO_NATIVE"):
            return None
        path = so_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as exc:
            logger.warning("Could not load %s: %s", path, exc)
            return None
        lib.parse_atom_lines.restype = ctypes.c_int64
        lib.parse_atom_lines.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int64,
        ]
        _lib = lib
        return _lib


NAME_WIDTH = 4


def parse_atom_lines(text: bytes, max_atoms: int, first_names: int):
    """Native tokenizer: atom lines -> (names [first_names], positions
    [n, 3] float32). Returns None if the native library is unavailable or the
    input is malformed (caller falls back to numpy)."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.empty((max_atoms, 3), dtype=np.float32)
    names_buf = ctypes.create_string_buffer(first_names * NAME_WIDTH)
    n = lib.parse_atom_lines(
        text, len(text), max_atoms,
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        names_buf, first_names, NAME_WIDTH,
    )
    if n < 0:
        return None
    names = np.frombuffer(names_buf.raw, dtype=f"S{NAME_WIDTH}").astype("U4")
    names = np.char.strip(names)
    return names, pos[:n]
