// Kernel K3: the in-kernel-W KMC event loop (orthorhombic, law kinds 0-4).
//
// Replaces the TPU kernel cmdlmc_tpu/ops/kmc_sweep.py::_make_kernel
// (pallas_call at ops/kmc_sweep.py:690), every branch of it: the jump
// histogram with its exposure and the jump matrix are event_loop.cuh's
// STATS option (the exposure bins each listed pair by the distance the
// stage computes for its W: the bits of B2's dist_scr). One launch advances every replica through a whole block of
// frames. Each frame, every thread block builds that frame's rate matrix
// from the positions, as the TPU kernel builds it in VMEM
// (ops/kmc_sweep.py:402-437):
//   dist = sqrtf((dx^2 + dy^2) + dz^2), d = minimg(pos_i - pos_j);
//   W[i][j] = law(dist) if dist <= cutoff + buffer and i != j, else 0;
//   kind 4 (FermiAngle over AngleTopology) also gates on the P-O-O angle at
//   donor i: v1 = minimg(P(i) - O(i)), dot = -sum v1 . d, and the pair is
//   allowed when dot <= cos(theta) |v1| dist, which makes W asymmetric.
// It keeps only the nonzero entries, as the lists of event_loop.cuh, and
// runs the same event loop K1 runs on the lists of a W built by stage 1, so
// the two routes agree wherever their W do. Laws: 0 Fermi, 1 Constant,
// 2 Exponential, 3 ActivationEnergy (its lax.rsqrt as 1.0f / sqrtf,
// kmc_common.cuh::apply_law), 4 FermiAngle.
//
// Where the time goes on the H100: the event loop's
// (csrc/kmc_sweep_streamed.cu) and the lists' build, N*N cheap range tests
// per frame and thread block
// (reciprocal box lengths, no division), then the exact distance and law
// on the pairs that pass, repaid only across the block's replicas. Nothing
// leaves the SM between frames but the replica state at the end. The
// block's warp count is a launch parameter (ops/kmc_sweep.py::
// WARPS_PER_BLOCK): fewer warps give more blocks (more SMs busy at the
// small replica counts this route serves) at the price of more list builds.
// The most sites in range of any site (`caps`, an upper bound of every row
// and column list) are counted on the device by `range_caps_kernel` with
// the same exact range test before the sweep, so the host never waits.
//
// Numerics: build with --fmad=false and without fast math, as K1.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "event_loop.cuh"

// uint16 slots of a warp's column list (an even count: 4-byte aligned).
__host__ __device__ inline int stage_pad(int N) { return (N + 1) & ~1; }

// Floats of K3's stage scratch: the angle gate's v1s [N, 4] and each
// warp's column list.
__host__ inline int stage_floats(int N, int warps) {
  return 4 * N + warps * stage_pad(N) / 2;
}

// Builds W[f]'s lists from the frame's positions, every entry bit for bit
// as the reference computes it: a warp per row i, a lane per column j,
// d = minimg(p_i - p_j). The reference's pair (i, j) holds minimg(p_j - p_i)
// = -minimg(p_i - p_j) exactly in row j, so each row gets the bits the
// reference computes for it; kind 4's dot for row i is
// ((0 - v1_i.x dx) - v1_i.y dy) - v1_i.z dz with the per-donor terms v1 and
// cos(theta) |v1| in the stage scratch [N, 4]. sqrtf is monotone, so
// sqrtf(acc) <= cutbuf exactly when acc <= acc_cut, the largest float with
// that property (found on the host): pairs out of range skip the square
// root and the law.
template <int WARPS, bool STATS>
struct BuildW {
  __device__ int operator()(const SweepArgs& a, int f, const Lists& L,
                            const float* cur, float* v1s, int warp,
                            int lane) const {
    const int n = a.N;
    const int kind = a.kind;
    const float lx = a.box[0], ly = a.box[1], lz = a.box[2];
    const float rlx = 1.0f / lx, rly = 1.0f / ly, rlz = 1.0f / lz;
    const float skip_cut = a.acc_cut * (1.0f + 0x1p-6f);
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
    // each warp's list of the columns that pass the cheap range test
    uint16_t* cand = (uint16_t*)(v1s + 4 * n) + (size_t)warp * stage_pad(n);
    const unsigned below = (1u << lane) - 1u;
    int bad = 0;
    for (int i = warp; i < n; i += WARPS) {
      const float xi = cur[3 * i], yi = cur[3 * i + 1], zi = cur[3 * i + 2];
      // a pair certainly out of range skips the exact minimum image (three
      // divisions): with the reciprocal lengths each component is the exact
      // one or, where d / len lies within a few ulps of a half-integer, the
      // other image, of the same length to within 4 len ulp(d / len); for
      // separations below 2^10 box lengths the square sum then exceeds
      // acc_cut * (1 + 2^-6) only if the exact one exceeds acc_cut. The
      // columns that pass are gathered in ascending order, so the exact
      // test runs on them alone, not on every 32nd column of the row.
      int nc = 0;
      for (int base = 0; base < n; base += 32) {
        const int j = base + lane;
        bool c = false;
        if (j < n && j != i) {
          const float ex = xi - cur[3 * j], ey = yi - cur[3 * j + 1],
                      ez = zi - cur[3 * j + 2];
          const float fx = ex - lx * rintf(ex * rlx),
                      fy = ey - ly * rintf(ey * rly),
                      fz = ez - lz * rintf(ez * rlz);
          c = fx * fx + fy * fy + fz * fz <= skip_cut;
        }
        const unsigned m = __ballot_sync(FULL_MASK, c);
        if (c) cand[nc + __popc(m & below)] = (uint16_t)j;
        nc += __popc(m);
      }
      __syncwarp();
      int cnt = 0;
      for (int k0 = 0; k0 < nc; k0 += 32) {
        const int k = k0 + lane;
        const int j = k < nc ? cand[k] : 0;
        float w = 0.f, dist = 0.f;
        if (k < nc) {
          const float dx = minimg(xi - cur[3 * j], lx);
          const float dy = minimg(yi - cur[3 * j + 1], ly);
          const float dz = minimg(zi - cur[3 * j + 2], lz);
          float acc = dx * dx + dy * dy;
          acc = acc + dz * dz;
          if (acc <= a.acc_cut) {
            dist = sqrtf(acc);
            bool in = true;
            if (kind == 4) {
              float dot = 0.f - v1s[4 * i] * dx;
              dot = dot - v1s[4 * i + 1] * dy;
              dot = dot - v1s[4 * i + 2] * dz;
              in = dot <= v1s[4 * i + 3] * dist;
            }
            if (in) w = apply_law(kind, dist, a.params);
          }
        }
        bad |= list_push<STATS>(L, i, j, w, STATS ? entry_bin(a, w, dist) : NO_BIN,
                                cnt, lane);
      }
      if (lane == 0) L.len[i] = (uint16_t)cnt;
      __syncwarp();  // the list is read before the next row rewrites it
    }
    return bad;
  }
};

template <int WARPS, bool STATS>
__global__ void __launch_bounds__(WARPS * 32, sweep_min_blocks(WARPS))
    kmc_sweep_kernel(SweepArgs a) {
  sweep_block<WARPS, STATS, false>(a, BuildW<WARPS, STATS>());
}

template <bool STATS>
static const void* kernel_for(int warps) {
  switch (warps) {
    case 2: return (const void*)kmc_sweep_kernel<2, STATS>;
    case 4: return (const void*)kmc_sweep_kernel<4, STATS>;
    case 8: return (const void*)kmc_sweep_kernel<8, STATS>;
    case 16: return (const void*)kmc_sweep_kernel<16, STATS>;
    default: return nullptr;
  }
}

static const void* kernel_for(int warps, bool stats) {
  return stats ? kernel_for<true>(warps) : kernel_for<false>(warps);
}

// Floats of a block's fixed scratch besides the prefix sum and the warps'
// arrays: the stage's, then STATS's counters, histograms and exposures (3
// nbins per warp). With statistics the plan gives a block all of an SM's
// shared memory (one block per SM), where the lists and their distances
// fit at bench.py's density (with two blocks per SM they went to global
// memory): the in-kernel route launches fewer than 16 RNG tiles of at most
// 128 replicas, 128 blocks of 16 warps at most, under the H100's 132 SMs.
static int k3_extra(int N, int warps, bool stats, int nbins) {
  return stage_floats(N, warps) + (stats ? warps * 3 * nbins : 0);
}

// The sites j != i within range of site i (sqrtf of the squared minimum
// image <= cutbuf, K3's exact test: `acc <= acc_cut`) of the frame's most
// crowded site, over the frames [B, N, 3], into caps[0] and caps[1] (the
// test is symmetric): a warp per site.
__global__ void range_caps_kernel(const float* __restrict__ pos, int B, int N,
                                  float lx, float ly, float lz, float acc_cut,
                                  int* caps) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  if (g >= (long long)B * N) return;
  const float* p = pos + (g / N) * 3 * N;
  const int i = (int)(g % N);
  const float xi = p[3 * i], yi = p[3 * i + 1], zi = p[3 * i + 2];
  int cnt = 0;
  for (int j = lane; j < N; j += 32) {
    const float dx = minimg(xi - p[3 * j], lx);
    const float dy = minimg(yi - p[3 * j + 1], ly);
    const float dz = minimg(zi - p[3 * j + 2], lz);
    float acc = dx * dx + dy * dy;
    acc = acc + dz * dz;
    cnt += j != i && acc <= acc_cut;
  }
  cnt = __reduce_add_sync(FULL_MASK, cnt);
  if (lane == 0) {
    raise_caps(caps, 0, cnt);
    raise_caps(caps, 1, cnt);
  }
}

// K3's launch plan at N sites and `warps` warps per block (`sweep_plan`;
// the stage scratch holds the angle gate's v1s [N, 4] and each warp's
// candidate columns) and how many of its blocks one SM holds, for the
// kernel with jump statistics (`stats`, `nbins` bins) or without.
extern "C" int cmdlmc_kmc_sweep_plan(int N, int warps, int stats, int nbins,
                                     int device, long long* smem,
                                     long long* list_budget,
                                     int* blocks_per_sm) {
  CmdlmcDeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const void* k = kernel_for(warps, stats != 0);
  if (!k) return (int)cudaErrorInvalidValue;
  size_t bytes = 0, budget = 0;
  cudaError_t err = sweep_plan(k, N, warps, k3_extra(N, warps, stats, nbins),
                               device, &bytes, &budget, stats != 0);
  if (err != cudaSuccess) return (int)err;
  *smem = (long long)bytes;
  *list_budget = (long long)budget;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, warps * 32, bytes);
}

// Counts the frames' most crowded site into caps [2] (int32, on the
// device) on `stream`, with no host wait.
extern "C" int cmdlmc_kmc_sweep_caps(const void* pos, int B, int N,
                                     float cutbuf, float lx, float ly,
                                     float lz, void* caps, void* stream,
                                     int device) {
  CmdlmcDeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(caps, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * N;
  const int threads = 256;
  const long long blocks = (rows + threads / 32 - 1) / (threads / 32);
  range_caps_kernel<<<(unsigned)blocks, threads, 0, s>>>(
      (const float*)pos, B, N, lx, ly, lz, sqrt_cut(cutbuf), (int*)caps);
  return (int)cudaGetLastError();
}

// One K3 launch: `caps` as counted by cmdlmc_kmc_sweep_caps; `lists` null,
// or `slice` bytes of global scratch per block for lists that do not fit in
// shared memory; `params` the law's 6 parameters; with `stats` (the kernel
// with jump statistics; else null and 0 after `params`) `hist` and
// `expo` [R, nbins] updated in place where nbins > 0, `jm` an [N, N] int32
// sum the fired jumps add to (or null), the histogram's range [lo, hi) and
// its bins per unit `scale`.
extern "C" int cmdlmc_kmc_sweep(
    const void* pos, const void* pgrp, const void* prev_in, const void* s_in,
    void* prev_out, void* s_out, void* occ, void* lab, void* sites,
    void* tlast, void* db, void* u, void* evc, void* trunc, int R, int N,
    int P, int B, int tile, int tile_offset, int frame0, int max_events,
    int kind, const void* caps, void* lists, long long slice, int warps,
    float dt, uint32_t seed, float cutbuf, float lx, float ly, float lz,
    const float* params, void* hist, void* expo, void* jm, int stats,
    int nbins, float lo, float hi, float scale, void* stream, int device) {
  CmdlmcDeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  if (kind < 0 || kind > 4 || (kind == 4 && pgrp == nullptr))
    return (int)cudaErrorInvalidValue;
  if (nbins < 0 || (nbins > 0 && (!stats || !hist || !expo)) || (jm && !stats))
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
  a.caps = (const int*)caps;
  a.lists_global = (unsigned char*)lists;
  a.slice = (size_t)slice;
  a.extra = stage_floats(N, warps);
  a.kind = kind;
  a.dt = dt;
  a.cutbuf = cutbuf;
  a.seed = seed;
  a.box[0] = lx;
  a.box[1] = ly;
  a.box[2] = lz;
  for (int q = 0; q < 6; ++q) a.params[q] = params[q];
  a.acc_cut = sqrt_cut(cutbuf);
  a.hist = (int*)hist;
  a.expo = (float*)expo;
  a.jm = (int*)jm;
  a.nbins = stats ? nbins : 0;
  a.hist_lo = lo;
  a.hist_hi = hi;
  a.hist_scale = scale;

  const void* k = kernel_for(warps, stats != 0);
  if (!k) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  err = sweep_plan(k, N, warps, k3_extra(N, warps, stats, nbins), device,
                   &smem, &a.list_budget, stats != 0);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  return (int)cudaLaunchKernel(k, dim3((R + warps - 1) / warps),
                               dim3(warps * 32), args, smem,
                               (cudaStream_t)stream);
}
