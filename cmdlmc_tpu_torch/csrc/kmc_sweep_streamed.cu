// Kernel K1: the streamed-W KMC event loop (rows semantics, orthorhombic).
//
// Replaces the TPU kernel cmdlmc_tpu/ops/kmc_sweep_streamed.py::_make_kernel
// (pallas_call at ops/kmc_sweep_streamed.py:628) with layout="rows", pack=1.
// One launch advances every replica through a whole block of frames; the
// frame loop runs inside the kernel, so replica state never leaves the SM
// between frames. The event loop itself is event_loop.cuh, shared with K3;
// K1's part is where W[f] comes from: stage 1 built it in global memory, and
// each frame the block copies it into shared memory with row stride N+1.
// When W does not fit, the warps read it from global memory instead.
//
// Bound on the H100: the per-event rate reduction is N*N multiply-adds per
// replica from shared memory (N=144: 20736 per replica per evaluation, about
// 3.4 evaluations per replica-frame at the bench.py rates), so the kernel is
// bound by operations: by shared-memory load throughput and by the serial
// event chain of each warp. The W stream (N*N*4 bytes per block per frame)
// comes from L2. Nothing here is tuned yet.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "event_loop.cuh"

#define WARPS 16  // replicas (warps) per thread block

// Copies W[f] from global memory into the block's shared memory.
struct CopyW {
  __device__ void operator()(const SweepArgs& a, int f, float* ws,
                             const float* /*cur*/, int warp, int lane) const {
    if (!a.w_in_smem) return;
    const int n = a.N;
    const float* wg = a.w + (size_t)f * n * n;
    for (int i = warp; i < n; i += WARPS)
      for (int j = lane; j < n; j += 32)
        ws[(size_t)i * (n + 1) + j] = wg[(size_t)i * n + j];
  }
};

__global__ void __launch_bounds__(WARPS * 32)
    kmc_sweep_streamed_kernel(SweepArgs a) {
  sweep_block<WARPS>(a, CopyW());
}

// Dynamic shared memory of one thread block at N sites, and whether W[f]
// fits in it under the device's opt-in limit (else W is read from global).
static cudaError_t smem_plan(int N, int device, int* w_in_smem, size_t* smem) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  *w_in_smem = sweep_smem_bytes(N, WARPS, 1) <= (size_t)optin ? 1 : 0;
  *smem = sweep_smem_bytes(N, WARPS, *w_in_smem);
  return *smem > (size_t)optin ? cudaErrorInvalidValue : cudaSuccess;
}

// Which W path a launch at N sites takes on `device`: 1 shared, 0 global.
extern "C" int cmdlmc_kmc_sweep_w_in_smem(int N, int device, int* w_in_smem) {
  size_t smem = 0;
  return (int)smem_plan(N, device, w_in_smem, &smem);
}

extern "C" int cmdlmc_kmc_sweep_streamed(
    const void* w, const void* pos, const void* prev_in, const void* s_in,
    void* prev_out, void* s_out, void* occ, void* lab, void* sites,
    void* tlast, void* db, void* u, void* evc, void* trunc, int R, int N,
    int P, int B, int tile, int tile_offset, int frame0, int max_events,
    int stale, float dt, uint32_t seed, float lx, float ly, float lz,
    void* stream, int device) {
  CmdlmcDeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  SweepArgs a = {};
  a.w = (const float*)w;
  a.pos = (const float*)pos;
  a.prev_in = (const float*)prev_in;
  a.s_in = (const float*)s_in;
  a.prev_out = (float*)prev_out;
  a.s_out = (float*)s_out;
  a.occ = (float*)occ;
  a.lab = (float*)lab;
  a.sites = (int*)sites;
  a.tlast = (float*)tlast;
  a.db = (float*)db;
  a.u = (float*)u;
  a.evc = (int*)evc;
  a.trunc = (int*)trunc;
  a.R = R;
  a.N = N;
  a.P = P;
  a.B = B;
  a.tile = tile;
  a.tile_offset = tile_offset;
  a.frame0 = frame0;
  a.max_events = max_events;
  a.stale = stale;
  a.dt = dt;
  a.seed = seed;
  a.box[0] = lx;
  a.box[1] = ly;
  a.box[2] = lz;

  size_t smem = 0;
  err = smem_plan(N, device, &a.w_in_smem, &smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kmc_sweep_streamed_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (R + WARPS - 1) / WARPS;
  kmc_sweep_streamed_kernel<<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
