// Counter-based uniform draws: the CUDA twin of cmdlmc_tpu_torch/ops/rng.py
// and of cmdlmc_tpu/ops/kmc_sweep.py::_fmix/_mix_key/_u01.
//
// Draws are keyed by (seed, global replica tile, absolute frame, event
// iteration, salt) and take the counter replica_in_tile * n + slot, so every
// implementation draws the same bits for the same logical (replica, slot).
// All hash arithmetic is uint32 (the JAX package uses int32 with logical
// shifts: the same bits).
#pragma once
#include <stdint.h>

__host__ __device__ inline uint32_t cmdlmc_fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__host__ __device__ inline uint32_t cmdlmc_mix_key(uint32_t seed, uint32_t tile,
                                                   uint32_t frame, uint32_t ev,
                                                   uint32_t salt) {
  uint32_t k = seed * 0x9e3779b9u;
  k = cmdlmc_fmix(k ^ (tile * 0x27d4eb2fu));
  k = cmdlmc_fmix(k ^ (frame * 0x165667b1u));
  k = cmdlmc_fmix(k ^ (ev * 0x1b873593u) ^ (salt * 0x5bd1e995u));
  return k;
}

// Uniform in (0, 1) with 24-bit resolution. Build with --fmad=false: the
// multiply is exact, and the add must round on its own as in the reference.
__device__ inline float cmdlmc_u01(uint32_t key, uint32_t counter) {
  uint32_t h = cmdlmc_fmix((counter * 0x9e3779b9u) ^ key);
  h = cmdlmc_fmix(h ^ 0x243f6a88u);
  return (float)(h >> 8) * (1.0f / 16777216.0f) + (0.5f / 16777216.0f);
}
