// Kernel K4: the KMC event loop over K-nearest neighbor tables.
//
// Replaces the TPU kernel cmdlmc_tpu/ops/topk_sweep.py::_make_kernel
// (pallas_call at ops/topk_sweep.py:1538) in rows semantics, without its jump
// statistics and jump matrix. One launch advances every replica through a
// whole block of frames; one warp runs one replica, lanes stride over sites.
// Per frame:
//   * the block advances its prefix sum s += minimg3(post - prev)
//     (kmc_common.cuh::step_prefix, orthorhombic or triclinic) and stages
//     the frame's tables in shared memory when they fit;
//   * each warp runs up to max_events event iterations. The candidate rate of
//     slot k at site i is a_k[i] = omega_k[i] occ[i] (1 - occ[nbr_k[i]]), where
//     omega_k[i] is the stage-1 table `resc` (the law already applied), or,
//     with the residence-time blend, law(min(d + ratio (r - d), 50)) with
//     ratio = 1 for tls < 0 else min((t - tls) / relax, 1), 0 where d >= 1e5;
//     the per-slot sums add to `total` in slot order; the clock test
//     u <= total (dt - phase); an exponential race for the slot over the
//     per-slot sums (salt 11, counter r*K + k), then for the site within it
//     (salt 12, counter r*N + i); dst = nbr_kbest[src] as an index load; the
//     occupancy / label / site / t_last_jump / tlast_site / disp_base updates
//     and a fresh exponential u (salt 3);
//   * at frame end the unused budget leaves u (total recomputed where the
//     event budget ran out), and a replica that fired on every iteration
//     counts one truncated frame.
// The occ[nbr] gather is an index load from the replica's occupancy, so the
// JAX kernel's occ[nbr] refresh modes (one-hot matmuls on the TPU) have no
// counterpart; its docstring states all three give the same occ[nbr].
//
// State: each warp keeps its replica's occupancy as bits (N/8 bytes: 18 B at
// N=144, 1152 B at N=9216). Each block keeps its own copy of the site prefix
// sum s (12 N bytes) and advances it frame by frame from the frame positions,
// which it reads from global memory (L2) like the tables. Warps per block:
// 8, and 32 past LARGE_N sites. The plan (topk_plan) picks one of two
// layouts from N:
//   0 "shared": s and the warps' bits in shared memory, 16 N bytes with 32
//     warps, and the frame's tables beside them where they fit too (N=144):
//     every N whose 16 N bytes fit the opt-in shared memory (232,448 B on
//     the H100), so up to 14,528 sites (N=4608: 73.7 KB; N=9216: 147.5 KB);
//   1 "global": s in a global scratch slice per block and the bits in one
//     per replica (both L2), every larger N, 32 warps per block.
// A layout moves data and nothing else: both take the same draws and
// decisions and advance s once per frame in the same order, so the results
// do not depend on it. At N=144 an 8-warp block takes
// under 18 KB and eight blocks fill the SM's 64 warp slots. occ only takes
// the values 0 and 1, so the rate products are those of the float occupancy
// bit for bit. Labels, sites, t_last_jump, tlast_site and disp_base stay in
// global memory, where the kernel updates them in place: they are touched at
// events (and tlast_site once per site and rate evaluation with the blend).
//
// Races: a zero-rate candidate scores 0 and E = 0 - log(u) is +0 for a draw of
// exactly 1.0, so that draw makes a positive-rate candidate win; the JAX
// kernel's rate / -log(u) gives NaN for a zero rate there (argmax takes it,
// an impossible move). Only sites with a positive rate draw at all, and only
// occupied sites (the only ones with a positive rate) are evaluated: both
// leave every sum and decision as it is.
//
// Bound on the H100: operations. A rate evaluation is K*P products per
// replica, over the P occupied sites (each a table load, an occupancy-bit
// load at the neighbour, and with the blend one law evaluation, expf
// included), one per event plus one per replica-frame; every replica's
// evaluations form one serial chain per warp.
// The bytes (tables read per block per frame, positions, replica state once
// in and out) bound it far less: the tables come from shared memory at small
// N and from L2 at supercell N, where every block reads the same rows, and so
// do the frame positions. The design keeps the loop free of one-hot work and
// of any [N, N] or [R, K, N] buffer.
//
// Numerics: build with --fmad=false and without fast math (kmc_common.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "kmc_common.cuh"
#include "rng.cuh"

struct TopkArgs {
  const float* pos;    // [B, N, 3]
  const float* topd;   // [B, K, N] neighbour distances (read with the blend)
  const int* topi;     // [B, K, N] neighbour indices
  const float* resc;   // [B, K, N] law rates, or rescaled distances (blend)
  const float* prev_in;  // [N, 3]
  const float* s_in;     // [N, 3]
  float* prev_out;       // [N, 3]
  float* s_out;          // [N, 3]
  float* occ;            // [R, N]  in place
  float* lab;            // [R, N]  in place
  int* sites;            // [R, P]  in place
  float* tlast;          // [R, P]  in place
  float* tls;            // [R, N]  in place: last-jump time of each site's proton
  float* db;             // [R, P, 3] in place
  float* u;              // [R]     in place
  int* evc;              // [R]     in place
  int* trunc;            // [R]     out
  float* s_glob;         // [blocks, N, 3] scratch (layout 1)
  uint32_t* bits_glob;   // [R, words] scratch (layout 1)
  int R, N, P, B, K, tile, tile_offset, frame0, max_events, kind, blend;
  int tables_in_smem;
  float dt, relax;
  uint32_t seed;
  float params[6];
  CellImage cell;
};

// Sites past which a block runs 32 warps instead of 8 (see the note above).
constexpr int LARGE_N = 1024;

// Dynamic shared memory of one block in the shared layout: s [N, 3], the
// frame's tables [2 or 3, K, N] when staged, each warp's occupancy bits.
__host__ inline size_t topk_smem_bytes(int N, int K, int blend, int warps,
                                       int with_tables) {
  const size_t tables = with_tables ? (size_t)(blend ? 3 : 2) * K * N : 0;
  const size_t words = (size_t)(N + 31) / 32;
  return sizeof(float) * ((size_t)3 * N + tables) +
         sizeof(uint32_t) * words * warps;
}

// A launch's plan: warps per block, layout (the shared one where it fits),
// whether the tables are staged, the dynamic shared memory and the global
// scratch in bytes (s per block, then the bits per replica).
struct TopkPlan {
  int warps, layout, tables_in_smem;
  size_t smem, scratch;
};

static cudaError_t topk_plan(int R, int N, int K, int blend, int device,
                             TopkPlan* plan) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t limit = (size_t)optin;
  plan->warps = N > LARGE_N ? 32 : 8;
  plan->layout = topk_smem_bytes(N, K, blend, plan->warps, 0) <= limit ? 0 : 1;
  plan->tables_in_smem =
      plan->layout == 0 && topk_smem_bytes(N, K, blend, plan->warps, 1) <= limit;
  plan->smem = plan->layout == 0 ? topk_smem_bytes(N, K, blend, plan->warps,
                                                   plan->tables_in_smem)
                                 : 0;
  const size_t blocks = (size_t)(R + plan->warps - 1) / plan->warps;
  plan->scratch = plan->layout == 0 ? 0
                                    : sizeof(float) * blocks * 3 * N +
                                          sizeof(uint32_t) * (size_t)R *
                                              ((N + 31) / 32);
  return cudaSuccess;
}

__device__ inline float occ_of(const uint32_t* bits, int i) {
  return (bits[i >> 5] >> (i & 31)) & 1u ? 1.0f : 0.0f;
}

// omega_k[i] occ[i] (1 - occ[nbr_k[i]]) for an occupied site i (occ[i] = 1);
// `ratio` is the site's residence-time blend factor (unused without blend).
__device__ inline float cand_rate(const TopkArgs& a, const float* rs,
                                  const float* td, const int* ti,
                                  const uint32_t* bits, int k, int i,
                                  float ratio) {
  const size_t o = (size_t)k * a.N + i;
  float omega;
  if (a.blend) {
    const float d = td[o];
    const float de = d + ratio * (rs[o] - d);
    omega = d < 1.0e5f ? apply_law(a.kind, fminf(de, 50.0f), a.params) : 0.f;
  } else {
    omega = rs[o];
  }
  return omega * 1.0f * (1.0f - occ_of(bits, ti[o]));
}

__device__ inline float blend_ratio(const TopkArgs& a, const float* tls_r,
                                    int i, float frame_time) {
  if (!a.blend) return 0.f;
  const float t = tls_r[i];
  return t < 0.f ? 1.0f : fminf((frame_time - t) / a.relax, 1.0f);
}

// The per-slot sums of the candidate rates (warp-reduced; lane k < K keeps
// slot k's in `mine`) and their total over the slots in order.
template <int KMAX>
__device__ inline float slot_sums(const TopkArgs& a, const float* rs,
                                  const float* td, const int* ti,
                                  const uint32_t* bits, const float* tls_r,
                                  float frame_time, int lane, float& mine) {
  float part[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) part[k] = 0.f;
  for (int i = lane; i < a.N; i += 32) {
    if (!((bits[i >> 5] >> (i & 31)) & 1u)) continue;  // empty: every a_k[i] = 0
    const float ratio = blend_ratio(a, tls_r, i, frame_time);
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      if (k < a.K) part[k] = part[k] + cand_rate(a, rs, td, ti, bits, k, i, ratio);
  }
  float total = 0.f;
  mine = 0.f;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k < a.K) {
      const float sk = warp_sum(part[k]);
      total = k == 0 ? sk : total + sk;
      if (lane == k) mine = sk;
    }
  }
  return total;
}

template <int WARPS, int KMAX, int LAYOUT>
__global__ void __launch_bounds__(WARPS * 32) topk_sweep_kernel(TopkArgs a) {
  extern __shared__ float sm[];
  const int n = a.N, K = a.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + warp;
  const bool active = r < a.R;
  const int words = (n + 31) / 32;
  const size_t tsize = a.tables_in_smem ? (size_t)K * n : 0;
  const size_t ntab = a.tables_in_smem ? (a.blend ? 3 : 2) * tsize : 0;
  // s [N, 3], the site-displacement prefix sum; the staged tables [K, N]:
  // resc, topi and (blend) topd; each warp's occupancy bits
  float* s = LAYOUT == 0 ? sm : a.s_glob + (size_t)blockIdx.x * 3 * n;
  float* rs_s = sm + 3 * n;
  int* ti_s = (int*)(rs_s + tsize);
  float* td_s = rs_s + 2 * tsize;
  uint32_t* bits = LAYOUT == 0 ? (uint32_t*)(rs_s + ntab) + (size_t)warp * words
                               : a.bits_glob + (size_t)r * words;

  for (int k = threadIdx.x; k < 3 * n; k += blockDim.x) s[k] = a.s_in[k];
  float* lab_r = a.lab + (size_t)r * n;
  float* tls_r = a.tls + (size_t)r * n;
  float u = 0.f;
  int evc = 0, trn = 0;
  uint32_t tile_id = 0, rin = 0;
  if (active) {
    for (int w = lane; w < words; w += 32) {
      uint32_t word = 0;
      for (int b = 0; b < 32; ++b) {
        const int i = 32 * w + b;
        if (i < n && a.occ[(size_t)r * n + i] != 0.f) word |= 1u << b;
      }
      bits[w] = word;
    }
    u = a.u[r];
    evc = a.evc[r];
    tile_id = (uint32_t)(r / a.tile + a.tile_offset);
    rin = (uint32_t)(r % a.tile);
  }
  __syncwarp();
  const float dt = a.dt;

  for (int f = 0; f < a.B; ++f) {
    __syncthreads();  // every warp is done with the previous frame
    const float* cur = a.pos + (size_t)f * 3 * n;  // this frame's positions
    step_prefix(s, f == 0 ? a.prev_in : cur - 3 * n, cur, n, a.cell);
    const size_t fo = (size_t)f * K * n;
    if (a.tables_in_smem) {
      for (size_t q = threadIdx.x; q < (size_t)K * n; q += blockDim.x) {
        rs_s[q] = a.resc[fo + q];
        ti_s[q] = a.topi[fo + q];
        if (a.blend) td_s[q] = a.topd[fo + q];
      }
    }
    __syncthreads();
    if (!active) continue;

    const float* rs = a.tables_in_smem ? rs_s : a.resc + fo;
    const int* ti = a.tables_in_smem ? ti_s : a.topi + fo;
    const float* td = a.tables_in_smem ? td_s : a.topd + fo;
    const int frame_idx = a.frame0 + f;
    const float frame_time = (float)frame_idx * dt;
    float phase = 0.f, total = 0.f, mine = 0.f;
    bool done = false;

    for (int ev = 0; ev < a.max_events; ++ev) {
      // a replica that stopped firing stays done: its remaining iterations
      // are no-ops in the reference, so the warp leaves the loop
      total = slot_sums<KMAX>(a, rs, td, ti, bits, tls_r, frame_time, lane, mine);
      const float budget = total * (dt - phase);
      if (!(u <= budget && budget > 0.f)) {
        done = true;
        break;
      }
      const float eph = phase + u / total;  // budget > 0 implies total > 0

      // slot: exponential race over the per-slot sums (lane k holds slot k)
      const uint32_t ka = cmdlmc_mix_key(a.seed, tile_id, (uint32_t)frame_idx,
                                         (uint32_t)ev, 11u);
      float bv = -1.f;
      int bi = 0x7fffffff;
      if (lane < K) {
        bv = 0.f;
        bi = lane;
        if (mine > 0.f)
          bv = mine / (0.0f - logf(cmdlmc_u01(ka, rin * (uint32_t)K + lane)));
      }
      warp_argmax(bv, bi);
      const int kbest = bi;

      // source: exponential race over the sites' rates in that slot
      const uint32_t kb = cmdlmc_mix_key(a.seed, tile_id, (uint32_t)frame_idx,
                                         (uint32_t)ev, 12u);
      bv = -1.f;
      bi = 0x7fffffff;
      for (int i = lane; i < n; i += 32) {
        float v = 0.f;
        if ((bits[i >> 5] >> (i & 31)) & 1u) {
          const float ai = cand_rate(a, rs, td, ti, bits, kbest, i,
                                     blend_ratio(a, tls_r, i, frame_time));
          if (ai > 0.f)
            v = ai / (0.0f - logf(cmdlmc_u01(kb, rin * (uint32_t)n + i)));
        }
        if (v > bv) {
          bv = v;
          bi = i;
        }
      }
      warp_argmax(bv, bi);
      const int src = bi;
      const int dst = ti[(size_t)kbest * n + src];

      const float t_event = frame_time + eph;
      float jx = cur[3 * dst] - cur[3 * src], jy = cur[3 * dst + 1] - cur[3 * src + 1],
            jz = cur[3 * dst + 2] - cur[3 * src + 2];
      a.cell.apply(jx, jy, jz);
      const float add[3] = {(s[3 * src] - s[3 * dst]) + jx,
                            (s[3 * src + 1] - s[3 * dst + 1]) + jy,
                            (s[3 * src + 2] - s[3 * dst + 2]) + jz};
      __syncwarp();  // every lane has read the occupancy bits
      if (lane == 0) {
        bits[src >> 5] &= ~(1u << (src & 31));
        bits[dst >> 5] |= 1u << (dst & 31);
        const float label = lab_r[src];
        lab_r[src] = 0.f;
        lab_r[dst] = label;
        // the destination now holds a just-jumped proton; the source's entry
        // goes stale behind the occupancy
        tls_r[dst] = t_event;
      }
      for (int p = lane; p < a.P; p += 32) {
        const size_t rp = (size_t)r * a.P + p;
        if (a.sites[rp] == src) {
          a.sites[rp] = dst;
          a.tlast[rp] = t_event;
          for (int dim = 0; dim < 3; ++dim)
            a.db[rp * 3 + dim] = a.db[rp * 3 + dim] + add[dim];
        }
      }
      const uint32_t k3 = cmdlmc_mix_key(a.seed, tile_id, (uint32_t)frame_idx,
                                         (uint32_t)ev, 3u);
      u = -logf(cmdlmc_u01(k3, rin));
      evc += 1;
      phase = eph;
      __syncwarp();  // the bits and tlast_site writes are visible to all lanes
    }
    if (!done) trn += 1;
    // frame end: the state is unchanged since the last rate evaluation unless
    // the event budget ran out, so the reference's recomputed total equals it
    const float total_end =
        done ? total
             : slot_sums<KMAX>(a, rs, td, ti, bits, tls_r, frame_time, lane, mine);
    u = u - total_end * (dt - phase);
  }

  if (active) {
    __syncwarp();
    for (int i = lane; i < n; i += 32) a.occ[(size_t)r * n + i] = occ_of(bits, i);
    if (lane == 0) {
      a.u[r] = u;
      a.evc[r] = evc;
      a.trunc[r] = trn;
    }
  }
  if (blockIdx.x == 0) {
    const float* last = a.pos + (size_t)(a.B - 1) * 3 * n;
    for (int k = threadIdx.x; k < 3 * n; k += blockDim.x) {
      a.s_out[k] = s[k];
      a.prev_out[k] = last[k];
    }
  }
}

template <int WARPS, int KMAX, int LAYOUT>
static cudaError_t launch(const TopkArgs& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_sweep_kernel<WARPS, KMAX, LAYOUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.R + WARPS - 1) / WARPS;
  topk_sweep_kernel<WARPS, KMAX, LAYOUT><<<blocks, WARPS * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// The global scratch a launch at (R, N, K, blend) needs, in bytes: 0 in
// the shared layout.
extern "C" int cmdlmc_topk_sweep_scratch(int R, int N, int K, int blend,
                                         int device, long long* scratch_bytes) {
  CmdlmcDeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  TopkPlan plan;
  cudaError_t err = topk_plan(R, N, K, blend, device, &plan);
  if (err != cudaSuccess) return (int)err;
  *scratch_bytes = (long long)plan.scratch;
  return 0;
}

extern "C" int cmdlmc_topk_sweep(
    const void* pos, const void* topd, const void* topi, const void* resc,
    const void* prev_in, const void* s_in, void* prev_out, void* s_out,
    void* occ, void* lab, void* sites, void* tlast, void* tls, void* db,
    void* u, void* evc, void* trunc, void* scratch, long long scratch_bytes,
    int R, int N, int P, int B, int K, int tile, int tile_offset, int frame0,
    int max_events, int kind, int blend, int ortho, float dt,
    float relax, uint32_t seed, const float* law6, const float* geom18,
    void* stream, int device) {
  CmdlmcDeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  if (kind < 0 || kind > 3 || K < 1 || K > 16 || N < 2 || B < 1)
    return (int)cudaErrorInvalidValue;
  TopkPlan plan;
  err = topk_plan(R, N, K, blend, device, &plan);
  if (err != cudaSuccess) return (int)err;
  if ((long long)plan.scratch > scratch_bytes) return (int)cudaErrorInvalidValue;
  TopkArgs a = {};
  a.pos = (const float*)pos;
  a.topd = (const float*)topd;
  a.topi = (const int*)topi;
  a.resc = (const float*)resc;
  a.prev_in = (const float*)prev_in;
  a.s_in = (const float*)s_in;
  a.prev_out = (float*)prev_out;
  a.s_out = (float*)s_out;
  a.occ = (float*)occ;
  a.lab = (float*)lab;
  a.sites = (int*)sites;
  a.tlast = (float*)tlast;
  a.tls = (float*)tls;
  a.db = (float*)db;
  a.u = (float*)u;
  a.evc = (int*)evc;
  a.trunc = (int*)trunc;
  a.s_glob = (float*)scratch;
  if (plan.layout == 1)  // the bits follow the blocks' prefix sums
    a.bits_glob = (uint32_t*)(a.s_glob + (size_t)((R + 31) / 32) * 3 * N);
  a.R = R;
  a.N = N;
  a.P = P;
  a.B = B;
  a.K = K;
  a.tile = tile;
  a.tile_offset = tile_offset;
  a.frame0 = frame0;
  a.max_events = max_events;
  a.kind = kind;
  a.blend = blend;
  a.tables_in_smem = plan.tables_in_smem;
  a.dt = dt;
  a.relax = relax;
  a.seed = seed;
  for (int q = 0; q < 6; ++q) a.params[q] = law6[q];
  for (int q = 0; q < 9; ++q) {
    a.cell.h[q] = geom18[q];
    a.cell.hinv[q] = geom18[9 + q];
  }
  a.cell.ortho = ortho;

  cudaStream_t s = (cudaStream_t)stream;
  const bool k8 = K <= 8;
  if (plan.layout == 1)
    return (int)(k8 ? launch<32, 8, 1>(a, plan.smem, s) : launch<32, 16, 1>(a, plan.smem, s));
  if (plan.warps == 32)
    return (int)(k8 ? launch<32, 8, 0>(a, plan.smem, s) : launch<32, 16, 0>(a, plan.smem, s));
  return (int)(k8 ? launch<8, 8, 0>(a, plan.smem, s) : launch<8, 16, 0>(a, plan.smem, s));
}
