"""Counter-based uniform draws shared by the event-loop kernels.

Port of ``cmdlmc_tpu/ops/kmc_sweep.py::_fmix/_i32/_mix_key/_u01/_u01_t``.
Draws are keyed by (seed, global replica tile, absolute frame, event
iteration, salt) and take the counter ``replica_in_tile * n + slot``, so the
port and the JAX package draw bit-identical numbers for the same logical
(replica, slot) pair. The CUDA twin lives in ``csrc/rng.cuh``.

The hash is uint32 arithmetic. torch has no uint32 arithmetic with logical
shifts on every backend, so values ride in int64 tensors masked with
``& 0xFFFFFFFF``; multiplications split the constant into 16-bit halves so no
product leaves the int64 range.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9  # int32 -1640531527 in the JAX package


def _i32(x: int) -> int:
    """Wrap a python int into signed 32-bit range."""
    return ((int(x) + 2**31) % 2**32) - 2**31


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 ``h`` in [0, 2^32) and a 32-bit constant."""
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _MASK


def _fmix(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on int64-held uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _u32(x) -> torch.Tensor:
    """int or integer tensor -> int64 tensor holding its uint32 bits."""
    return torch.as_tensor(x, dtype=torch.int64) & _MASK


def mix_key(seed, tile_id, frame_idx, ev, salt) -> torch.Tensor:
    """Per-(tile, frame, event, salt) key as uint32 bits in an int64 tensor.
    Any argument may be an integer tensor (e.g. one tile id per replica)."""
    k = _mul32(_u32(seed), _GOLDEN)
    k = _fmix(k ^ _mul32(_u32(tile_id), 0x27D4EB2F))
    k = _fmix(k ^ _mul32(_u32(frame_idx), 0x165667B1))
    return _fmix(k ^ _mul32(_u32(ev), 0x1B873593) ^ _mul32(_u32(salt), 0x5BD1E995))


def u01_counter(key: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """Uniform in (0, 1) with 24-bit resolution for each (key, counter) pair
    (broadcast); float32."""
    h = _fmix(_mul32(_u32(counter), _GOLDEN) ^ key)
    h = _fmix(h ^ 0x243F6A88)
    bits24 = (h >> 8).to(torch.float32)
    return bits24 * (1.0 / 16777216.0) + (0.5 / 16777216.0)


def u01(key, shape, device=None) -> torch.Tensor:
    """``_u01(key, (TR, n))``: counter ``row * n + col``."""
    rows, cols = shape
    idx = torch.arange(rows * cols, dtype=torch.int64, device=device)
    return u01_counter(_u32(key), idx.reshape(rows, cols))


def u01_t(key, shape, device=None) -> torch.Tensor:
    """``_u01_t(key, (S, TR))[s, r] == u01(key, (TR, S))[r, s]``."""
    s, r = shape
    return u01(key, (r, s), device).T
