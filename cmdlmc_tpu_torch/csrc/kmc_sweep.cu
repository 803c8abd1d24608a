// Kernel K3: the in-kernel-W KMC event loop (orthorhombic, law kinds 0-4).
//
// Replaces the TPU kernel cmdlmc_tpu/ops/kmc_sweep.py::_make_kernel
// (pallas_call at ops/kmc_sweep.py:690), without its jump statistics and
// jump matrix. One launch advances every replica through a whole block of
// frames. Each frame, every thread block builds that frame's rate matrix
// W[N, N] in its shared memory from the positions, as the TPU kernel builds
// it in VMEM (ops/kmc_sweep.py:402-437):
//   dist = sqrtf((dx^2 + dy^2) + dz^2), d = minimg(pos_i - pos_j);
//   W[i][j] = law(dist) if dist <= cutoff + buffer and i != j, else 0;
//   kind 4 (FermiAngle over AngleTopology) also gates on the P-O-O angle at
//   donor i: v1 = minimg(P(i) - O(i)), dot = -sum v1 . d, and the pair is
//   allowed when dot <= cos(theta) |v1| dist, which makes W asymmetric.
// Then the block runs the event loop of event_loop.cuh, the same code K1
// runs on a W built by stage 1, so the two routes agree wherever their W
// do. Laws: 0 Fermi, 1 Constant, 2 Exponential, 3 ActivationEnergy (its
// lax.rsqrt as 1.0f / sqrtf, kmc_common.cuh::apply_law), 4 FermiAngle.
//
// Bound on the H100: operations. The event loop does what K1's does (N*N
// multiply-adds per rate evaluation per replica, from shared memory); the W
// build adds N*N distance-and-law evaluations (one expf each) per frame and
// thread block, so it is repaid only across the block's replicas. Nothing
// leaves the SM between frames but the replica state at the end; the bytes
// (positions and state) bound it far less. The design keeps one warp per
// replica and takes the block's warp count as a launch parameter: fewer
// warps give more blocks (more SMs busy at the small replica counts this
// route serves) at the price of more W builds. The route is taken only
// where W[N, N+1] fits in shared memory.
//
// Numerics: build with --fmad=false and without fast math, as K1.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "event_loop.cuh"

// Builds W[f] into the block's shared memory from the frame's positions,
// every entry bit for bit as the reference computes it, with two savings:
// * distance and law are symmetric, so each pair i < j is evaluated once and
// written to W[i][j] and W[j][i]: minimg(p_j - p_i) is exactly
// -minimg(p_i - p_j), so both entries get the bits the reference computes
// for them. Kind 4 gates each direction on its own donor's P atom; for row
// j the reference's dot -sum v1_j . minimg(p_j - p_i) equals
// (v1_j.x dx + v1_j.y dy) + v1_j.z dz exactly (x - (-y) = x + y). The
// per-donor terms v1 and cos(theta) |v1| sit in `v1s` [N, 4], past the
// shared memory of event_loop.cuh;
// * sqrtf is monotone, so sqrtf(acc) <= cutbuf exactly when acc <= acc_cut,
// the largest float with that property (found on the host): pairs out of
// range skip the square root and the law.
template <int WARPS>
struct BuildW {
  __device__ void operator()(const SweepArgs& a, int f, float* ws,
                             const float* cur, int warp, int lane) const {
    const int n = a.N;
    const int kind = a.kind;
    const int ld = n + 1;
    const float lx = a.box[0], ly = a.box[1], lz = a.box[2];
    float* v1s = ws + (size_t)n * ld + (size_t)(6 + 3 * WARPS) * n;  // [N, 4]
    if (kind == 4) {
      const float* pg = a.pgrp + (size_t)f * 3 * n;
      for (int i = warp * 32 + lane; i < n; i += WARPS * 32) {
        float v1x = minimg(pg[3 * i] - cur[3 * i], lx);
        float v1y = minimg(pg[3 * i + 1] - cur[3 * i + 1], ly);
        float v1z = minimg(pg[3 * i + 2] - cur[3 * i + 2], lz);
        float n1 = v1x * v1x + v1y * v1y;
        n1 = n1 + v1z * v1z;
        v1s[4 * i] = v1x;
        v1s[4 * i + 1] = v1y;
        v1s[4 * i + 2] = v1z;
        v1s[4 * i + 3] = a.params[3] * sqrtf(n1);
      }
      __syncthreads();
    }
    for (int i = warp; i < n; i += WARPS) {
      const float xi = cur[3 * i], yi = cur[3 * i + 1], zi = cur[3 * i + 2];
      if (lane == 0) ws[(size_t)i * ld + i] = 0.f;
      for (int j = i + 1 + lane; j < n; j += 32) {
        const float dx = minimg(xi - cur[3 * j], lx);
        const float dy = minimg(yi - cur[3 * j + 1], ly);
        const float dz = minimg(zi - cur[3 * j + 2], lz);
        float acc = dx * dx + dy * dy;
        acc = acc + dz * dz;
        if (!(acc <= a.acc_cut)) {
          ws[(size_t)i * ld + j] = 0.f;
          ws[(size_t)j * ld + i] = 0.f;
          continue;
        }
        const float dist = sqrtf(acc);
        bool in_ij = true, in_ji = true;
        if (kind == 4) {
          float dot_i = 0.f - v1s[4 * i] * dx;
          dot_i = dot_i - v1s[4 * i + 1] * dy;
          dot_i = dot_i - v1s[4 * i + 2] * dz;
          float dot_j = v1s[4 * j] * dx + v1s[4 * j + 1] * dy;
          dot_j = dot_j + v1s[4 * j + 2] * dz;
          in_ij = dot_i <= v1s[4 * i + 3] * dist;
          in_ji = dot_j <= v1s[4 * j + 3] * dist;
        }
        const float w = (in_ij || in_ji) ? apply_law(kind, dist, a.params) : 0.f;
        ws[(size_t)i * ld + j] = in_ij ? w : 0.f;
        ws[(size_t)j * ld + i] = in_ji ? w : 0.f;
      }
    }
  }
};

template <int WARPS>
__global__ void __launch_bounds__(WARPS * 32) kmc_sweep_kernel(SweepArgs a) {
  sweep_block<WARPS>(a, BuildW<WARPS>());
}

template <int WARPS>
static cudaError_t launch(const SweepArgs& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kmc_sweep_kernel<WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int blocks = (a.R + WARPS - 1) / WARPS;
  kmc_sweep_kernel<WARPS><<<blocks, WARPS * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// Shared memory of one block: the event loop's with W staged, and v1s.
static size_t smem_bytes(int N, int warps) {
  return sweep_smem_bytes(N, warps, 1) + sizeof(float) * 4 * (size_t)N;
}

// Shared memory a launch at N sites and `warps` warps per block needs, and
// the device's opt-in limit per block.
extern "C" int cmdlmc_kmc_sweep_smem(int N, int warps, int device, int* need,
                                     int* optin) {
  *need = (int)smem_bytes(N, warps);
  return (int)cudaDeviceGetAttribute(
      optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

extern "C" int cmdlmc_kmc_sweep(
    const void* pos, const void* pgrp, const void* prev_in, const void* s_in,
    void* prev_out, void* s_out, void* occ, void* lab, void* sites,
    void* tlast, void* db, void* u, void* evc, void* trunc, int R, int N,
    int P, int B, int tile, int tile_offset, int frame0, int max_events,
    int kind, int warps, float dt, uint32_t seed, float cutbuf, float lx,
    float ly, float lz, float p0, float p1, float p2, float p3, float p4,
    float p5, void* stream, int device) {
  CmdlmcDeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  if (kind < 0 || kind > 4 || (kind == 4 && pgrp == nullptr))
    return (int)cudaErrorInvalidValue;
  SweepArgs a = {};
  a.pos = (const float*)pos;
  a.pgrp = (const float*)pgrp;
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
  a.stale = 0;
  a.w_in_smem = 1;
  a.kind = kind;
  a.dt = dt;
  a.cutbuf = cutbuf;
  a.seed = seed;
  a.box[0] = lx;
  a.box[1] = ly;
  a.box[2] = lz;
  a.params[0] = p0;
  a.params[1] = p1;
  a.params[2] = p2;
  a.params[3] = p3;
  a.params[4] = p4;
  a.params[5] = p5;
  a.acc_cut = sqrt_cut(cutbuf);

  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  size_t smem = smem_bytes(N, warps);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (warps) {
    case 2: return (int)launch<2>(a, smem, s);
    case 4: return (int)launch<4>(a, smem, s);
    case 8: return (int)launch<8>(a, smem, s);
    case 16: return (int)launch<16>(a, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
