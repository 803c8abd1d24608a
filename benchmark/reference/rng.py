"""Counter-based uniform draws of the event loops, written plainly.

A frozen copy of the formula in ``cmdlmc_tpu_torch/ops/rng.py:28-76`` at
commit 5a4702a (``_mul32``, ``_fmix``, ``mix_key``, ``u01_counter``), the
draws the kernels K1, K3 and K4 key by (seed, replica tile, absolute
frame, event iteration, salt) with the counter ``replica_in_tile * n +
slot``. uint32 values ride in int64 tensors masked to 32 bits.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _MASK


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _u32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK


def mix_key(seed, tile_id, frame_idx, ev, salt) -> torch.Tensor:
    """Key of (seed, tile, frame, event, salt); any argument may be a tensor."""
    dev = tile_id.device if isinstance(tile_id, torch.Tensor) else None
    k = _mul32(_u32(seed, dev), _GOLDEN)
    k = _fmix(k ^ _mul32(_u32(tile_id, dev), 0x27D4EB2F))
    k = _fmix(k ^ _mul32(_u32(frame_idx, dev), 0x165667B1))
    return _fmix(k ^ _mul32(_u32(ev, dev), 0x1B873593)
                 ^ _mul32(_u32(salt, dev), 0x5BD1E995))


def u01(key: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """Uniform in (0, 1] with 24-bit resolution, float32, in the kernels'
    arithmetic: (h >> 8) / 2^24 + 2^-25, each step rounded to float32."""
    h = _fmix(_mul32(_u32(counter), _GOLDEN) ^ key)
    h = _fmix(h ^ 0x243F6A88)
    bits24 = (h >> 8).to(torch.float32)
    return bits24 * (1.0 / 16777216.0) + (0.5 / 16777216.0)
