// Kernel K1: the streamed-W KMC event loop (rows semantics, orthorhombic).
//
// Replaces the TPU kernel cmdlmc_tpu/ops/kmc_sweep_streamed.py::_make_kernel
// (pallas_call at ops/kmc_sweep_streamed.py:628) with layout="rows", pack=1.
// One launch advances every replica through a whole block of frames; the
// frame loop runs inside the kernel, so replica state never leaves the SM
// between frames. Per frame and replica, as in the reference:
//   * the shared site-displacement prefix sum s += minimg(post - prev), kept
//     per thread block in the reference's running float32 association;
//   * up to max_events event iterations: out = W (1 - occ), row = occ * out,
//     the clock test u <= total (dt - phase), the exponential race for the
//     source (argmax row / E1) and for the destination (argmax W[src] vac /
//     E2), the occupancy / label / site / t_last / disp_base updates (with
//     the minimum-image jump rebase) and a fresh exponential u;
//   * at frame end the unused budget leaves u, and a replica that fired on
//     every iteration counts one truncated frame.
// `stale` reuses the frame-start rows and total inside the frame.
//
// Design, deliberately simple: a thread block holds WARPS replicas, one warp
// per replica. Each frame the block stages W[f] into shared memory with a
// padded row stride (N+1) so that lane i reading W[i][j] is conflict-free;
// when W does not fit, the warps read it from global memory instead. Lanes
// stride over sites; sums and argmaxes are warp shuffles. The RNG tile of the
// reference (TR replicas per tile) stays a logical parameter for the draw
// keys and is independent of this launch shape.
//
// Bound on the H100: the per-event rate reduction is N*N multiply-adds per
// replica from shared memory (N=144: 20736 per replica per frame), so the
// kernel is bound by shared-memory load throughput and by the serial event
// chain of each warp; the W stream (N*N*4 bytes per block per frame) comes
// from L2. Nothing here is tuned yet.
//
// Numerics: build with --fmad=false and without fast math. rintf rounds half
// to even like jnp.round; logf is the accurate libm form. Argmax keeps the
// first index on ties. Gathers are index loads. In the two races a zero-rate
// candidate scores 0 and E = 0 - log(u) is +0 for a draw of exactly 1.0, so
// that draw makes a positive-rate candidate win; the JAX kernels compute
// rate / -log(u), where the same draw gives NaN for a zero rate (argmax takes
// it: an impossible move) and -inf for a positive one.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "rng.cuh"

#define WARPS 16  // replicas (warps) per thread block
#define FULL_MASK 0xffffffffu

struct SweepArgs {
  const float* w;        // [B, N, N]
  const float* pos;      // [B, N, 3]
  const float* prev_in;  // [N, 3]
  const float* s_in;     // [N, 3]
  float* prev_out;       // [N, 3]
  float* s_out;          // [N, 3]
  float* occ;            // [R, N]  in place
  float* lab;            // [R, N]  in place
  int* sites;            // [R, P]  in place
  float* tlast;          // [R, P]  in place
  float* db;             // [R, P, 3] in place
  float* u;              // [R]     in place
  int* evc;              // [R]     in place
  int* trunc;            // [R]     out
  int R, N, P, B, tile, tile_offset, frame0, max_events, stale, w_in_smem;
  float dt;
  uint32_t seed;
  float box[3];
};

__device__ inline float warp_sum(float v) {
  // xor butterfly: every lane ends with the same bits (fp add commutes)
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ inline void warp_argmax(float& v, int& idx) {
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(FULL_MASK, v, o);
    int oi = __shfl_xor_sync(FULL_MASK, idx, o);
    if (ov > v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
}

__device__ inline float minimg(float d, float len) {
  return d - len * rintf(d / len);
}

// row[i] = occ[i] * sum_j W[i][j] (1 - occ[j]); returns sum_i row[i].
__device__ float total_rate(const float* wf, int ldw, const float* occ,
                            float* row, int n, int lane) {
  float part = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float* wi = wf + (size_t)i * ldw;
    float out = 0.f;
    for (int j = 0; j < n; ++j) out = out + wi[j] * (1.0f - occ[j]);
    float r = occ[i] * out;
    row[i] = r;
    part = part + r;
  }
  __syncwarp();
  return warp_sum(part);
}

__global__ void __launch_bounds__(WARPS * 32)
    kmc_sweep_streamed_kernel(SweepArgs a) {
  extern __shared__ float sm[];
  const int n = a.N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t wsize = a.w_in_smem ? (size_t)n * (n + 1) : 0;
  float* ws = sm;              // [N, N+1] staged W of this frame
  float* s = sm + wsize;       // [N, 3] site-displacement prefix sum
  float* cur = s + 3 * n;      // [N, 3] positions of this frame
  float* wocc = cur + 3 * n + (size_t)warp * 3 * n;  // [N] this warp's occ
  float* wlab = wocc + n;                             // [N] labels
  float* wrow = wlab + n;                             // [N] rows (or row0)

  const int r = blockIdx.x * WARPS + warp;
  const bool active = r < a.R;
  for (int k = threadIdx.x; k < 3 * n; k += blockDim.x) {
    s[k] = a.s_in[k];
    cur[k] = a.prev_in[k];
  }
  float u = 0.f;
  int evc = 0, trn = 0;
  uint32_t tile_id = 0, rin = 0;
  if (active) {
    for (int i = lane; i < n; i += 32) {
      wocc[i] = a.occ[(size_t)r * n + i];
      wlab[i] = a.lab[(size_t)r * n + i];
    }
    u = a.u[r];
    evc = a.evc[r];
    tile_id = (uint32_t)(r / a.tile + a.tile_offset);
    rin = (uint32_t)(r % a.tile);
  }
  const float dt = a.dt;

  for (int f = 0; f < a.B; ++f) {
    __syncthreads();  // every warp is done with the previous frame
    const float* post = a.pos + (size_t)f * 3 * n;
    for (int k = threadIdx.x; k < 3 * n; k += blockDim.x) {
      float p = post[k];
      float d = minimg(p - cur[k], a.box[k % 3]);
      s[k] = s[k] + d;
      cur[k] = p;
    }
    const float* wg = a.w + (size_t)f * n * n;
    if (a.w_in_smem) {
      for (int i = warp; i < n; i += WARPS)
        for (int j = lane; j < n; j += 32)
          ws[(size_t)i * (n + 1) + j] = wg[(size_t)i * n + j];
    }
    __syncthreads();
    if (!active) continue;

    const float* wf = a.w_in_smem ? ws : wg;
    const int ldw = a.w_in_smem ? n + 1 : n;
    const int frame_idx = a.frame0 + f;
    const float frame_time = (float)frame_idx * dt;
    float phase = 0.f, total = 0.f, total0 = 0.f;
    bool done = false;
    if (a.stale) total0 = total_rate(wf, ldw, wocc, wrow, n, lane);

    for (int ev = 0; ev < a.max_events; ++ev) {
      // a replica that stopped firing stays done: its remaining iterations
      // are no-ops in the reference, so the warp leaves the loop
      total = a.stale ? total0 : total_rate(wf, ldw, wocc, wrow, n, lane);
      float budget = total * (dt - phase);
      if (!(u <= budget && budget > 0.f)) {
        done = true;
        break;
      }
      float eph = phase + u / total;  // budget > 0 implies total > 0

      // source: exponential race over row_i / E1_i (E1 = 0 - log u01)
      uint32_t k1 = cmdlmc_mix_key(a.seed, tile_id, (uint32_t)frame_idx,
                                   (uint32_t)ev, 1u);
      float bv = -1.f;
      int bi = 0x7fffffff;
      for (int i = lane; i < n; i += 32) {
        float ri = a.stale ? wrow[i] * wocc[i] : wrow[i];
        float v = 0.f;
        if (ri > 0.f) v = ri / (0.0f - logf(cmdlmc_u01(k1, rin * (uint32_t)n + i)));
        if (v > bv) {
          bv = v;
          bi = i;
        }
      }
      warp_argmax(bv, bi);
      const int src = bi;

      // destination: race over W[src][j] (1 - occ_j) / E2_j
      uint32_t k2 = cmdlmc_mix_key(a.seed, tile_id, (uint32_t)frame_idx,
                                   (uint32_t)ev, 2u);
      const float* wsrc = wf + (size_t)src * ldw;
      bv = -1.f;
      bi = 0x7fffffff;
      for (int j = lane; j < n; j += 32) {
        float w2 = wsrc[j] * (1.0f - wocc[j]);
        float v = 0.f;
        if (w2 > 0.f) v = w2 / (0.0f - logf(cmdlmc_u01(k2, rin * (uint32_t)n + j)));
        if (v > bv) {
          bv = v;
          bi = j;
        }
      }
      warp_argmax(bv, bi);
      const int dst = bi;

      const float label = wlab[src];
      const float t_event = frame_time + eph;
      float add[3];
      for (int dim = 0; dim < 3; ++dim) {
        float jump = minimg(cur[dst * 3 + dim] - cur[src * 3 + dim], a.box[dim]);
        add[dim] = (s[src * 3 + dim] - s[dst * 3 + dim]) + jump;
      }
      __syncwarp();  // all lanes have read occ / labels / rows
      if (lane == 0) {
        wocc[src] = wocc[src] - 1.0f;
        wocc[dst] = wocc[dst] + 1.0f;
        wlab[src] = 0.f;
        wlab[dst] = label;
      }
      for (int p = lane; p < a.P; p += 32) {
        size_t rp = (size_t)r * a.P + p;
        if (a.sites[rp] == src) {
          a.sites[rp] = dst;
          a.tlast[rp] = t_event;
          for (int dim = 0; dim < 3; ++dim)
            a.db[rp * 3 + dim] = a.db[rp * 3 + dim] + add[dim];
        }
      }
      uint32_t k3 = cmdlmc_mix_key(a.seed, tile_id, (uint32_t)frame_idx,
                                   (uint32_t)ev, 3u);
      u = -logf(cmdlmc_u01(k3, rin));
      evc += 1;
      phase = eph;
      __syncwarp();
    }
    if (!done) trn += 1;
    // frame end: occ is unchanged since the last rate evaluation unless the
    // event budget ran out, so the reference's recomputed total equals it
    float total_end = total;
    if (a.stale)
      total_end = total0;
    else if (!done)
      total_end = total_rate(wf, ldw, wocc, wrow, n, lane);
    u = u - total_end * (dt - phase);
  }

  if (active) {
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      a.occ[(size_t)r * n + i] = wocc[i];
      a.lab[(size_t)r * n + i] = wlab[i];
    }
    if (lane == 0) {
      a.u[r] = u;
      a.evc[r] = evc;
      a.trunc[r] = trn;
    }
  }
  if (blockIdx.x == 0) {
    for (int k = threadIdx.x; k < 3 * n; k += blockDim.x) {
      a.s_out[k] = s[k];
      a.prev_out[k] = cur[k];
    }
  }
}

// Dynamic shared memory of one thread block at N sites, and whether W[f]
// fits in it under the device's opt-in limit (else W is read from global).
static cudaError_t smem_plan(int N, int device, int* w_in_smem, size_t* smem) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  size_t base = sizeof(float) * ((size_t)6 * N + (size_t)WARPS * 3 * N);
  size_t with_w = base + sizeof(float) * (size_t)N * (N + 1);
  *w_in_smem = with_w <= (size_t)optin ? 1 : 0;
  *smem = *w_in_smem ? with_w : base;
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
  SweepArgs a;
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
