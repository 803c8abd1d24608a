"""JAX's threefry2x32 keys and draws, bit for bit, and kernel 2.

The scan engine of the JAX package (``cmdlmc_tpu/engine/clock.py``,
``engine/lattice.py``, ``models/water.py``) draws every random number from
``jax.random`` with the threefry2x32 generator in its partitionable form
(``jax_threefry_partitionable``, the default of JAX 0.9). This module
reproduces it, so the port's scan engine makes the JAX package's decisions
from the same keys:

* :func:`threefry2x32_reference` is ``jax/_src/prng.py::threefry_2x32``: 20
  rounds of add, rotate and xor with the key schedule injected every 4
  rounds;
* :func:`key` is ``jax.random.key(seed)`` (``threefry_seed``: the seed's
  high and low words; JAX keeps 32-bit seeds, so the high word is 0);
* :func:`fold_in` is ``_threefry_fold_in``: the hash of (0, data);
* :func:`split` is ``_threefry_split_foldlike``: the hash of the counters
  (i >> 32, i & 0xFFFFFFFF) of an iota;
* :func:`random_bits` is ``_threefry_random_bits_partitionable`` at 32
  bits: the two output words xored, one counter per element;
* :func:`uniform`, :func:`exponential`, :func:`gumbel` (mode "low") and
  :func:`categorical` are ``jax/_src/random.py``'s ``_uniform``,
  ``_exponential``, ``_gumbel`` and ``categorical`` in float32.

A key is JAX's key data: two uint32 words in the last axis (what
``jax.random.key_data`` gives and what checkpoints store). torch's right
shift on signed integers is arithmetic and its uint32 support is partial, so
the words ride in int64 tensors holding values in [0, 2^32), masked after
every operation that can carry past 32 bits.

Every draw hashes key rows with the counters (0, base + j): a fold-in's
base is its data, a split's and a draw's counters are an iota.
:func:`keyed_hash` computes that function: on a CUDA tensor it launches
kernel 2 (``csrc/threefry.cu``, port-only: the JAX package fuses the hash
into its other XLA work) once, the counters derived in the kernel; on a CPU
tensor it runs :func:`keyed_hash_reference`, the same arithmetic in torch
operations. The float conversions after the hash are torch on both devices;
``log``/``log1p`` may differ from XLA's by an ulp.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cmdlmc_tpu_torch.core.f32 import f32
from cmdlmc_tpu_torch.ops import build

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# float32's smallest normal: the lower bound of the Gumbel uniform
_TINY = float(np.finfo(np.float32).tiny)


def _u32(x, device=None) -> torch.Tensor:
    """An int or integer tensor as int64 holding its low 32 bits."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32_reference(key: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """threefry2x32 of key words [..., 2] and any counter words [..., 2]
    (broadcast) -> [..., 2], every word an int64 in [0, 2^32), in torch
    operations on any device: the hash under :func:`keyed_hash_reference`."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (count[..., 0] + ks[0]) & _MASK
    x1 = (count[..., 1] + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return torch.stack([x0, x1], dim=-1)


def keyed_hash_reference(key: torch.Tensor, base=0, num: int = 1,
                         xor: bool = False) -> torch.Tensor:
    """Plain version of kernel 2: the hashes of key rows [..., 2] with the
    counters (0, base + j) for j < num -> [..., num, 2], or [..., num] with
    the two words xored. ``base`` is an int or an integer tensor of the
    keys' batch shape (values taken mod 2^32)."""
    base = _u32(base, key.device)[..., None]
    lo = (base + torch.arange(num, dtype=torch.int64, device=key.device)) & _MASK
    out = threefry2x32_reference(key[..., None, :],
                                 torch.stack([torch.zeros_like(lo), lo], dim=-1))
    return out[..., 0] ^ out[..., 1] if xor else out


def keyed_hash(key: torch.Tensor, base=0, num: int = 1, xor: bool = False) -> torch.Tensor:
    """The hashes of key rows [..., 2] (int64 holding uint32) with the
    counters (0, base + j) for j < num: [..., num, 2], or [..., num] with
    the words xored (JAX's 32-bit bits). A fold-in is ``base`` = the data,
    num 1; a split and a draw's bits are base 0, num the count (JAX's iota
    counters). Kernel 2 for CUDA tensors, one launch; the plain version for
    CPU tensors."""
    if isinstance(base, torch.Tensor):
        key, base = torch.broadcast_tensors(key, base[..., None])
        base = base[..., 0]
    if key.device.type == "cpu":
        return keyed_hash_reference(key, base, num, xor)
    if key.device.type != "cuda":
        raise ValueError(f"keyed_hash: unsupported device {key.device}")
    if key.dtype != torch.int64 or key.shape[-1] != 2:
        raise ValueError(f"keyed_hash expects int64 [..., 2] key words, got {key.dtype} "
                         f"{tuple(key.shape)}")
    batch = key.shape[:-1]
    rows = math.prod(batch)
    if rows * num >= 2**31:
        raise ValueError(f"keyed_hash: {rows} x {num} hashes in one launch")
    k = key.reshape(rows, 2)  # a view where the rows have one stride
    if k.stride(1) != 1:
        k = k.contiguous()
    stride = k.stride(0) if rows > 1 else 0
    scalar, b = 0, None
    if isinstance(base, torch.Tensor):
        b = base.reshape(rows)
        b = (b if b.dtype == torch.int32 else b.to(torch.int32)).contiguous()
    else:
        scalar = int(base) & _MASK
    out = torch.empty((*batch, num) if xor else (*batch, num, 2), dtype=torch.int64,
                      device=key.device)
    if rows * num:
        lib = build.library()
        keyed_hash.launches += 1
        build.check(lib.cmdlmc_threefry(k.data_ptr(), stride,
                                        None if b is None else b.data_ptr(), scalar,
                                        rows, num, int(xor), out.data_ptr(),
                                        build.stream_of(out), out.device.index or 0),
                    "threefry kernel")
    return out


keyed_hash.launches = 0


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))``: [2] words. JAX keeps
    the seed in 32 bits, so the high word is 0 and the low word the seed's
    low 32 bits."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys [..., 2] and data (an int or an integer
    tensor broadcast against the keys' batch shape) -> [..., 2]."""
    return keyed_hash(key, data)[..., 0, :]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys [..., 2] -> [..., num, 2]."""
    return keyed_hash(key, 0, num)


def random_bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` for keys [..., 2]:
    [..., *shape] int64 holding uint32."""
    shape = tuple(shape)
    return keyed_hash(key, 0, math.prod(shape), xor=True).reshape(key.shape[:-1] + shape)


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """The float32 in [0, 1) of the top 23 bits: (bits >> 9) | 0x3F800000
    read as a float in [1, 2), minus 1."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` for keys
    [..., 2]: max(minval, f (maxval - minval) + minval), in float32. Bit for
    bit on [0, 1) and [tiny, 1) (the scan engine's bounds); on others within
    half an ulp of f (maxval - minval), where XLA fuses the scaling into a
    multiply-add."""
    f = _unit(random_bits(key, shape))
    lo = f32(minval)
    width = f32(np.float32(maxval) - np.float32(minval))
    return torch.clamp(f * width + lo, min=lo)


def exponential(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.exponential``: -log1p(-u), float32."""
    return -torch.log1p(-uniform(key, shape))


def gumbel(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.gumbel`` in its default mode "low":
    -log(-log(u)) with u uniform on [tiny, 1), float32."""
    return -torch.log(-torch.log(uniform(key, shape, minval=_TINY)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis of
    ``logits`` [..., n] with keys [..., 2]: the first argmax of
    Gumbel noise plus the logits (int64)."""
    return torch.argmax(gumbel(key, (logits.shape[-1],)) + logits, dim=-1)


def key_data(keys) -> np.ndarray:
    """Keys as JAX's key data, uint32 numpy (what checkpoints store)."""
    if isinstance(keys, torch.Tensor):
        keys = keys.detach().cpu().numpy()
    return np.asarray(keys).astype(np.uint32)
