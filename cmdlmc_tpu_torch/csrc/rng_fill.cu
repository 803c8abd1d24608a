// Test entry point for the shared counter hash (csrc/rng.cuh): fills
// out[m, i] = u01(mix_key(params[m]), i) and keys[m] = mix_key(params[m]) so
// a check on the card can hold the CUDA hash against the torch hash in
// ops/rng.py bit for bit. Not on the simulation path.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "rng.cuh"

__global__ void rng_fill_kernel(const int32_t* __restrict__ params, int m,
                                int n, float* __restrict__ out,
                                uint32_t* __restrict__ keys) {
  int row = blockIdx.y;
  const int32_t* p = params + 5 * row;
  uint32_t key = cmdlmc_mix_key((uint32_t)p[0], (uint32_t)p[1], (uint32_t)p[2],
                                (uint32_t)p[3], (uint32_t)p[4]);
  if (blockIdx.x == 0 && threadIdx.x == 0) keys[row] = key;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    out[(size_t)row * n + i] = cmdlmc_u01(key, (uint32_t)i);
  }
}

extern "C" int cmdlmc_rng_fill(const void* params, int m, int n, void* out,
                               void* keys, void* stream, int device) {
  if (m <= 0 || n <= 0) return 0;
  CmdlmcDeviceGuard guard(device);
  int err = (int)guard.err;
  if (err) return err;
  int blocks = (n + 255) / 256;
  if (blocks > 1024) blocks = 1024;
  dim3 grid(blocks, m);
  rng_fill_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)params, m, n, (float*)out, (uint32_t*)keys);
  return (int)cudaGetLastError();
}
