"""Build and load the hand-written CUDA kernels in ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one process
per source, all started together, and links the objects into one shared
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
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_PF = ctypes.POINTER(_F)
# the jump statistics' arguments (hist, expo, jm, stats, nbins, lo, hi, scale)
_STATS = [_P] * 3 + [_I, _I] + [_F] * 3
_SIGNATURES = {
    "cmdlmc_pairwise": [_P, _I, _I, _F, _F, _F, _P, _P, _I],
    "cmdlmc_kmc_sweep_streamed": (
        [_P] * 14 + [_I] * 9 + [_P, _P, _LL]
        + [_F, ctypes.c_uint32, _F, _F, _F, _P] + _STATS + [_I, _PF, _P, _I]
    ),
    "cmdlmc_kmc_sweep_streamed_plan": [_I] * 5 + [ctypes.POINTER(_LL)] * 2
    + [ctypes.POINTER(_I)],
    "cmdlmc_kmc_sweep_streamed_caps": [_P, _I, _I, _P, _P, _I],
    "cmdlmc_kmc_sweep": (
        [_P] * 14 + [_I] * 9 + [_P, _P, _LL, _I, _F, ctypes.c_uint32]
        + [_F] * 4 + [_PF] + _STATS + [_P, _I]
    ),
    "cmdlmc_kmc_sweep_plan": [_I] * 5 + [ctypes.POINTER(_LL)] * 2
    + [ctypes.POINTER(_I)],
    "cmdlmc_kmc_sweep_caps": [_P, _I, _I] + [_F] * 4 + [_P, _P, _I],
    "cmdlmc_rng_fill": [_P, _I, _I, _P, _P, _P, _I],
    "cmdlmc_threefry": [_P, _LL, _P, ctypes.c_uint32, _I, _I, _I, _P, _P, _I],
    "cmdlmc_knn_tables": [_P, _I, _I, _I] + [_F] * 4 + [_P] * 5 + [_I] * 5
    + [_P, _P, _P, _I],
    "cmdlmc_knn_bin": [_P, _I, _I] + [ctypes.c_double] * 3 + [_I] * 3
    + [_F, ctypes.c_double] + [_P] * 5 + [_I],
    "cmdlmc_knn_sparse": [_P, _I, _I, _I] + [_F] * 4 + [_P] * 3 + [_I] * 6
    + [_P, _P, _P, _I],
    "cmdlmc_sparse_plan": [_P, _I, _I] + [ctypes.c_double] * 3 + [_I, _I, _F, _I, _I, _F]
    + [_P] * 7 + [_I],
    "cmdlmc_topk_sweep_plan": [_I] * 6 + [ctypes.POINTER(_LL)],
    "cmdlmc_topk_sweep": (
        [_P] * 20 + [_LL] + [_I] * 12 + [_F, _F, ctypes.c_uint32]
        + [_PF] * 2 + _STATS + [_P, _I]
    ),
    "cmdlmc_verlet_schedule": [_P] * 6 + [_I] * 3 + [_LL] + [_F] * 3 + [_I, _PF]
    + [_P] * 4 + [_I],
    "cmdlmc_water_sweep": (
        [_P] * 20 + [_I] * 14 + [_F] * 5 + [ctypes.c_uint32, ctypes.POINTER(_F), _P, _I]
    ),
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


def _compile_and_link(out: Path) -> str:
    """One nvcc per source, all at once, then one link; returns the log."""
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for src, obj in zip(_sources(), objs)
    ]
    logs, failed = [], []
    for src, proc in zip(_sources(), procs):
        text = proc.communicate()[0]
        logs.append(text)
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    log = "".join(logs)
    if not failed:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *(str(o) for o in objs)],
            capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed.append(f"link ({link.returncode})")
        else:
            os.replace(tmp, out)  # atomic: concurrent builders never load halves
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}:\n{log}")
    return log


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
        log = _compile_and_link(out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cmdlmc_sweep_list_bytes.argtypes = [_I] * 4
    lib.cmdlmc_sweep_list_bytes.restype = _LL
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
