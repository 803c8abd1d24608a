// Kernel K2: batched minimum-image distance matrices for orthorhombic cells.
//
// Replaces the TPU kernel cmdlmc_tpu/ops/pairwise.py::_dist_kernel
// (pallas_call at ops/pairwise.py:55), and fills a whole block of frames in
// one launch: out[b, i, j] = |minimg(pos[b, j] - pos[b, i])|.
//
// Bound on the H100: the store of B*N*N floats (N=144, B=256: 21 MB per block
// of frames), a few microseconds at 3.35 TB/s; the positions (B*N*12 bytes)
// come from L1/L2. Deliberately simple: one thread per output element, rows
// of 32 threads along j so stores coalesce, positions read through the
// read-only cache. No tiling through shared memory yet.
//
// Numerics match the plain version (ops/pairwise.py::pairwise_reference) bit
// for bit: build with --fmad=false so d - L*rint(d/L) and the sum of squares
// round per operation, rintf rounds half to even like torch.round/jnp.round,
// and sqrtf/division are IEEE (no fast math).
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "kmc_common.cuh"

__global__ void pairwise_kernel(const float* __restrict__ pos, int n,
                                float lx, float ly, float lz,
                                float* __restrict__ out) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int i = blockIdx.y * blockDim.y + threadIdx.y;
  int b = blockIdx.z;
  if (i >= n || j >= n) return;
  const float* pi = pos + ((size_t)b * n + i) * 3;
  const float* pj = pos + ((size_t)b * n + j) * 3;
  float dx = minimg(__ldg(pj + 0) - __ldg(pi + 0), lx);
  float dy = minimg(__ldg(pj + 1) - __ldg(pi + 1), ly);
  float dz = minimg(__ldg(pj + 2) - __ldg(pi + 2), lz);
  float acc = dx * dx + dy * dy;
  acc = acc + dz * dz;
  out[((size_t)b * n + i) * n + j] = sqrtf(acc);
}

extern "C" int cmdlmc_pairwise(const void* pos, int batch, int n, float lx,
                               float ly, float lz, void* out, void* stream,
                               int device) {
  CmdlmcDeviceGuard guard(device);
  int err = (int)guard.err;
  if (err) return err;
  dim3 block(32, 8);
  // gridDim.z is capped at 65535 frames per launch
  for (int b0 = 0; b0 < batch; b0 += 65535) {
    int nb = batch - b0 < 65535 ? batch - b0 : 65535;
    dim3 grid((n + 31) / 32, (n + 7) / 8, nb);
    pairwise_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)pos + (size_t)b0 * n * 3, n, lx, ly, lz,
        (float*)out + (size_t)b0 * n * n);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}
