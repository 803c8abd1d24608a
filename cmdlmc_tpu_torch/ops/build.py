"""Build and load the hand-written CUDA kernels in ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, which ``ctypes`` loads. The build runs at
first use, goes to ``cmdlmc_tpu_torch/_build/`` and is keyed on a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads at
once. Nothing here runs at import time: the CPU tests import every module on
machines without ``nvcc``.

Launch functions take pointers and the CUDA stream as ``c_void_p`` and return
the CUDA error code; :func:`check` raises on a nonzero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "cmdlmc_pairwise": [_P, _I, _I, _F, _F, _F, _P, _P, _I],
    "cmdlmc_kmc_sweep_streamed": (
        [_P] * 14 + [_I] * 9 + [_F, ctypes.c_uint32, _F, _F, _F, _P, _I]
    ),
    "cmdlmc_kmc_sweep_w_in_smem": [_I, _I, ctypes.POINTER(_I)],
    "cmdlmc_rng_fill": [_P, _I, _I, _P, _P, _P, _I],
}

_lib = None
build_info: dict = {}  # what the last build or load did (for reports)


def _nvcc() -> str:
    # torch looks in $CUDA_HOME / $CUDA_PATH, then PATH, then /usr/local/cuda
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    BUILD_DIR.mkdir(exist_ok=True)
    out = BUILD_DIR / f"libcmdlmc_kernels_{source_hash()}.so"
    t0 = time.perf_counter()
    log = ""
    built = not out.exists()
    if built:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(p) for p in _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: concurrent builders never load halves
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cmdlmc_error_string.argtypes = [ctypes.c_int]
    lib.cmdlmc_error_string.restype = ctypes.c_char_p
    build_info.update(path=str(out), built=built,
                      seconds=time.perf_counter() - t0, log=log)
    _lib = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code:
        msg = library().cmdlmc_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(tensor) -> int:
    """Handle of torch's current stream on the tensor's device."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
