// Kernel K4: the KMC event loop over K-nearest neighbor tables.
//
// Replaces the TPU kernel cmdlmc_tpu/ops/topk_sweep.py::_make_kernel
// (pallas_call at ops/topk_sweep.py:1538) in rows semantics, every branch of
// it (the jump statistics and the jump matrix below). One launch advances every replica through a
// whole block of frames; one warp runs one replica, lanes stride over sites.
// The candidate rate of slot k at site i is
//   a_k[i] = omega_k[i] occ[i] (1 - occ[nbr_k[i]]),
// where omega_k[i] is the stage-1 table `resc` (the law already applied),
// or, with the residence-time blend, law(min(d + ratio (r - d), 50)) with
// ratio = 1 for tls < 0 else min((t - tls) / relax, 1), 0 where d >= 1e5.
// Per frame:
//   * the block advances its prefix sum s += minimg3(post - prev)
//     (kmc_common.cuh::step_prefix, orthorhombic or triclinic) and stages
//     the frame's tables and in-neighbour lists in shared memory where they
//     fit;
//   * one full evaluation gives each lane k < K slot k's rate sum and its
//     count of positive candidates;
//   * each warp runs up to max_events event iterations: the total of the
//     slot sums in slot order; the clock test u <= total (dt - phase); an
//     exponential race for the slot over the slot sums (salt 11, counter
//     r*K + k), then for the site within it over rates read fresh from the
//     tables (salt 12, counter r*N + i); dst = nbr_kbest[src]; the
//     occupancy / label / site / t_last_jump / tlast_site / disp_base
//     updates and a fresh exponential u (salt 3); then the sums and counts
//     take only the candidates the event changed (below);
//   * at frame end the unused budget leaves u (the carried total), and a
//     replica that fired on every iteration counts one truncated frame.
// Nothing carried crosses a frame boundary, so results do not depend on how
// the frames are cut into launches.
//
// The carried sums. An event src -> dst changes four groups of candidates:
// (1) src's K slots leave, (2) dst's K slots enter (with dst's new
// tlast_site under the blend), (3) the entries (k, i) with nbr_k[i] = src,
// i occupied and neither src nor dst, gain their factor 1 - occ[src], and
// (4) those with nbr_k[i] = dst lose theirs. Groups 1, 3 and 4 are read
// before the occupancy changes, group 2 after; each (k, i) lies in exactly
// one in-neighbour list, and groups 3 and 4 skip src and dst, so no entry
// counts twice. The in-neighbour lists (ops/topk_sweep.py::in_neighbour_lists,
// built on the device beside the launch) give, per frame and site j, the
// entries q = k N + i with topi[k, i] = j in increasing q; the warp walks
// src's then dst's list in chunks of 32 entries, one lane an entry, so any
// in-degree works. Lane k gathers slot k's delta: group 1's, then per chunk
// one butterfly (warp_sum) for each slot the chunk holds, then group 2's;
// the order is fixed and no float atomics run, so a launch gives the same
// bits every time. A slot whose positive count reaches 0 gets
// the sum +0 exactly, as a full sum would: it can never win the slot race,
// whose winner's site race would otherwise find no site. The carried sums
// are a full sum plus at most max_events rounded deltas, so their bits
// differ from a full re-evaluation's; the site race never reads them.
//
// State: each warp keeps its replica's occupancy as bits (N/8 bytes: 18 B at
// N=144, 1152 B at N=9216). Each block keeps its own copy of the site prefix
// sum s (12 N bytes) and advances it frame by frame from the frame positions,
// which it reads from global memory (L2) like the tables. Warps per block:
// 8, and 32 past LARGE_N sites. The plan (topk_plan) picks one of two
// layouts from N:
//   0 "shared": s and the warps' bits in shared memory, 16 N bytes with 32
//     warps, and the frame's tables and lists beside them where they fit too
//     (N=144): every N whose 16 N bytes fit the opt-in shared memory
//     (232,448 B on the H100), so up to 14,528 sites (N=4608: 73.7 KB;
//     N=9216: 147.5 KB);
//   1 "global": s in a global scratch slice per block and the bits in one
//     per replica (both L2), every larger N, 32 warps per block.
// Where the tables are not staged whole (N=4608 and 9216 in the shared
// layout, every N in the global one), the frame's first evaluation is
// staged instead: every warp of the block, inactive ones too, copies the
// tables in tiles of `stage_tile` sites (the largest of 512, 256, ..., 32
// that fits beside the layout's state) through a two-stage ring in shared
// memory with cp.async, in increasing site order, and each active warp adds
// its occupied sites from the tile, every lane its own sites in the same
// order as unstaged. Events read the tables and lists from L2.
// A layout moves data and nothing else: both take the same draws and
// decisions and advance s once per frame in the same order, so the results
// do not depend on it. At N=144 an 8-warp block takes under 17 KB and eight
// blocks fill the SM's 64 warp slots. occ only takes the values 0 and 1, so
// the rate products are those of the float occupancy bit for bit. Labels,
// sites, t_last_jump, tlast_site and disp_base stay in global memory, where
// the kernel updates them in place: they are touched at events (and
// tlast_site once per site and rate evaluation with the blend).
//
// Races: a zero-rate candidate scores 0 and E = 0 - log(u) is +0 for a draw of
// exactly 1.0, so that draw makes a positive-rate candidate win; the JAX
// kernel's rate / -log(u) gives NaN for a zero rate there (argmax takes it,
// an impossible move). Only sites with a positive rate draw at all, and only
// occupied sites (the only ones with a positive rate) are evaluated: both
// leave every sum and decision as it is.
//
// What bounds it on the H100. The least work is one full evaluation per
// replica-frame (K products at each of the P occupied sites) and per event
// the changed candidates (2K plus the in-degrees of src and dst) and the two
// races over the K slots and the P occupied sites; at the supercells the
// replica state read once and written once (R x N floats three times)
// weighs more than that. What the time goes to is the traffic from L2: the
// site race reads slot kbest's table row at every occupied site, every
// event, in every warp. The design keeps the rest off that path: one full
// evaluation per frame instead of one per event (B3's re-evaluation is
// cheap on the TPU's vector unit, L2 traffic here), and at supercell N one
// read of each table line per block instead of one per warp for it.
//
// Jump statistics (the template option STATS; the default entry point
// launches the kernel without it): after each fired event lane 0 adds one
// to the replica's bin of the event's table distance topd[kbest][src] where
// lo <= d < hi, and one to [src][dst] of the launch's int32 [N, N] jump
// matrix (an atomicAdd); at each frame end, under the post-event state and
// before the unused budget leaves u, the warp counts for each slot k in
// order and each bin the occupied sites i whose candidate rate a_k[i] is
// positive and whose topd[k][i] lies in the bin (in nbins integer counters
// in shared memory) and adds each slot's counts to the replica's float
// exposure, as B3 adds its per-slot sums (whole numbers, the same bits).
// The replica's histogram and exposure stay in the warp's shared memory
// across the launch (3 nbins words a warp with the counters).
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
  const int* in_off;   // [B, N + 1] in-neighbour list offsets
  const int* in_ent;   // [B, K * N] entries k * N + i, grouped by topi[k, i]
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
  int tables_in_smem, stage_tile;
  float dt, relax;
  uint32_t seed;
  float params[6];
  CellImage cell;
  // STATS
  int* hist;    // [R, nbins] in place
  float* expo;  // [R, nbins] in place
  int* jm;      // [N, N] the launch's jump matrix (adds), or null
  int nbins;
  float hist_lo, hist_hi, hist_scale;
};

// Sites past which a block runs 32 warps instead of 8 (see the note above).
constexpr int LARGE_N = 1024;

// The largest tile of the staged first evaluation, in sites. Building with
// -DCMDLMC_TOPK_UNSTAGED sets it to 0, which leaves every warp to read its
// own first evaluation from L2 (chip_smoke.py --k4-before times the two).
#ifdef CMDLMC_TOPK_UNSTAGED
constexpr int MAX_STAGE_TILE = 0;
#else
constexpr int MAX_STAGE_TILE = 512;
#endif

// Dynamic shared memory of one block: with statistics each warp's counters,
// histogram and exposure (`nbins` words each); in the shared layout s [N, 3] and the warps' occupancy bits;
// the frame's tables [2 or 3, K, N] and in-neighbour lists (N + 1 offsets,
// K N entries) where staged whole; the ring of two tiles of `tile` sites of
// each table where the first evaluation is staged.
__host__ inline size_t topk_smem_bytes(int N, int K, int blend, int warps,
                                       int layout, int with_tables, int tile,
                                       int nbins) {
  const size_t ntab = blend ? 3 : 2;
  size_t words = (size_t)warps * 3 * nbins;
  if (layout == 0) words += (size_t)3 * N + (size_t)warps * ((N + 31) / 32);
  if (with_tables) words += (ntab + 1) * K * N + N + 1;
  words += 2 * ntab * K * (size_t)tile;
  return sizeof(float) * words;
}

// A launch's plan: warps per block, layout (the shared one where it fits),
// whether the tables are staged whole, else the tile of the staged first
// evaluation (0: none fits), the dynamic shared memory and the global
// scratch in bytes (s per block, then the bits per replica).
struct TopkPlan {
  int warps, layout, tables_in_smem, stage_tile;
  size_t smem, scratch;
};

static cudaError_t topk_plan(int R, int N, int K, int blend, int nbins,
                             int device, TopkPlan* plan) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t limit = (size_t)optin;
  const int w = N > LARGE_N ? 32 : 8;
  plan->warps = w;
  plan->layout =
      topk_smem_bytes(N, K, blend, w, 0, 0, 0, nbins) <= limit ? 0 : 1;
  plan->tables_in_smem =
      plan->layout == 0 && topk_smem_bytes(N, K, blend, w, 0, 1, 0, nbins) <= limit;
  plan->stage_tile = 0;
  if (!plan->tables_in_smem)
    for (int t = MAX_STAGE_TILE; t >= 32 && !plan->stage_tile; t /= 2)
      if (topk_smem_bytes(N, K, blend, w, plan->layout, 0, t, nbins) <= limit)
        plan->stage_tile = t;
  plan->smem = topk_smem_bytes(N, K, blend, w, plan->layout,
                               plan->tables_in_smem, plan->stage_tile, nbins);
  const size_t blocks = (size_t)(R + w - 1) / w;
  plan->scratch = plan->layout == 0 ? 0
                                    : sizeof(float) * blocks * 3 * N +
                                          sizeof(uint32_t) * (size_t)R *
                                              ((N + 31) / 32);
  return cudaSuccess;
}

__device__ inline bool occupied(const uint32_t* bits, int i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

__device__ inline float occ_of(const uint32_t* bits, int i) {
  return occupied(bits, i) ? 1.0f : 0.0f;
}

__device__ inline void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for every committed group of this thread but the newest.
__device__ inline void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// omega_k[i] at table offset o; `ratio` is the site's residence-time blend
// factor (unused without blend).
__device__ inline float omega_at(const TopkArgs& a, const float* rs,
                                 const float* td, size_t o, float ratio) {
  if (a.blend) {
    const float d = td[o];
    const float de = d + ratio * (rs[o] - d);
    return d < 1.0e5f ? apply_law(a.kind, fminf(de, 50.0f), a.params) : 0.f;
  }
  return rs[o];
}

// omega_k[i] occ[i] (1 - occ[nbr_k[i]]) at table offset o of an occupied
// site i (occ[i] = 1).
__device__ inline float cand_rate(const TopkArgs& a, const float* rs,
                                  const float* td, const int* ti,
                                  const uint32_t* bits, size_t o, float ratio) {
  return omega_at(a, rs, td, o, ratio) * 1.0f * (1.0f - occ_of(bits, ti[o]));
}

__device__ inline float blend_ratio(const TopkArgs& a, const float* tls_r,
                                    int i, float frame_time) {
  if (!a.blend) return 0.f;
  const float t = tls_r[i];
  return t < 0.f ? 1.0f : fminf((frame_time - t) / a.relax, 1.0f);
}

// Adds an occupied site's K candidate rates (table offsets o + k * stride)
// to the lane's per-slot partial sums and positive counts.
template <int KMAX>
__device__ inline void add_site(const TopkArgs& a, const float* rs,
                                const float* td, const int* ti,
                                const uint32_t* bits, size_t o, size_t stride,
                                float ratio, float (&part)[KMAX],
                                int (&npos)[KMAX]) {
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k < a.K) {
      const float v = cand_rate(a, rs, td, ti, bits, o + k * stride, ratio);
      part[k] = part[k] + v;
      npos[k] += v > 0.f;
    }
  }
}

// Lane k < K receives slot k's sum and positive count over the warp.
template <int KMAX>
__device__ inline void reduce_slots(int K, int lane, const float (&part)[KMAX],
                                    const int (&npos)[KMAX], float& mine,
                                    int& cnt) {
  mine = 0.f;
  cnt = 0;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k < K) {
      const float sk = warp_sum(part[k]);
      const int ck = __reduce_add_sync(FULL_MASK, npos[k]);
      if (lane == k) {
        mine = sk;
        cnt = ck;
      }
    }
  }
}

// The total of the slot sums in slot order; every lane ends with it.
__device__ inline float slot_total(float mine, int K) {
  float total = __shfl_sync(FULL_MASK, mine, 0);
  for (int k = 1; k < K; ++k) total = total + __shfl_sync(FULL_MASK, mine, k);
  return total;
}

// The frame's full evaluation by one warp over tables [K, N] it reads where
// they lie (staged whole in shared memory, or L2).
template <int KMAX>
__device__ inline void full_sums(const TopkArgs& a, const float* rs,
                                 const float* td, const int* ti,
                                 const uint32_t* bits, const float* tls_r,
                                 float frame_time, int lane, float& mine,
                                 int& cnt) {
  float part[KMAX];
  int npos[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    part[k] = 0.f;
    npos[k] = 0;
  }
  for (int i = lane; i < a.N; i += 32) {
    if (!occupied(bits, i)) continue;  // empty: every a_k[i] = 0
    add_site<KMAX>(a, rs, td, ti, bits, i, a.N,
                   blend_ratio(a, tls_r, i, frame_time), part, npos);
  }
  reduce_slots<KMAX>(a.K, lane, part, npos, mine, cnt);
}

// The same evaluation with the tables staged through the block's two-stage
// ring, tile by tile in increasing site order. Every thread of the block
// calls it (the copies and barriers are the block's); warps that run no
// replica only copy.
template <int KMAX>
__device__ inline void staged_sums(const TopkArgs& a, float* ring, size_t fo,
                                   const uint32_t* bits, const float* tls_r,
                                   float frame_time, int lane, bool active,
                                   float& mine, int& cnt) {
  const int n = a.N, T = a.stage_tile;
  const int kt = a.K * T;
  const size_t stage = (size_t)(a.blend ? 3 : 2) * kt;
  const int tiles = (n + T - 1) / T;
  auto fetch = [&](int t) {
    float* rs = ring + (t & 1) * stage;
    int* ti = (int*)(rs + kt);
    float* td = rs + 2 * kt;
    for (int q = threadIdx.x; q < kt; q += blockDim.x) {
      const int k = q / T, i = t * T + (q - k * T);
      if (i < n) {
        const size_t g = fo + (size_t)k * n + i;
        cp_async4(rs + q, a.resc + g);
        cp_async4(ti + q, a.topi + g);
        if (a.blend) cp_async4(td + q, a.topd + g);
      }
    }
  };
  float part[KMAX];
  int npos[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    part[k] = 0.f;
    npos[k] = 0;
  }
  fetch(0);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) fetch(t + 1);
    cp_async_commit();  // possibly empty: the groups stay one per tile
    cp_async_wait_prior();
    __syncthreads();  // tile t has landed from every thread's copies
    if (active) {
      const float* rs = ring + (t & 1) * stage;
      const int* ti = (const int*)(rs + kt);
      const float* td = rs + 2 * kt;
      const int t0 = t * T, hi = min(T, n - t0);
      for (int c = lane; c < hi; c += 32) {
        const int i = t0 + c;
        if (!occupied(bits, i)) continue;
        add_site<KMAX>(a, rs, td, ti, bits, c, T,
                       blend_ratio(a, tls_r, i, frame_time), part, npos);
      }
    }
    __syncthreads();  // every warp is done with the stage tile t + 2 takes
  }
  if (active) reduce_slots<KMAX>(a.K, lane, part, npos, mine, cnt);
}

// The histogram bin of an in-range distance d.
__device__ inline int topk_bin(const TopkArgs& a, float d) {
  const int b = (int)((d - a.hist_lo) * a.hist_scale);
  return b < 0 ? 0 : (b >= a.nbins ? a.nbins - 1 : b);
}

// Four 8-warp blocks per SM (64 registers a thread): the N=144 launches
// (R=4096, 512 blocks) then run in one wave on the 132 SMs.
template <int WARPS, int KMAX, int LAYOUT, bool STATS>
__global__ void __launch_bounds__(WARPS * 32, WARPS == 8 ? 4 : 1)
    topk_sweep_kernel(TopkArgs a) {
  extern __shared__ float sm[];
  const int n = a.N, K = a.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + warp;
  const bool active = r < a.R;
  const int words = (n + 31) / 32;
  const size_t kn = (size_t)K * n;
  // shared memory in order: (STATS) each warp's counters; s [N, 3] (layout
  // 0); the staged tables [K, N] resc, topi, (blend) topd and the lists
  // (N + 1 offsets, K N entries); the ring; each warp's occupancy bits
  // (layout 0)
  int* wcnt = (int*)sm + warp * 3 * a.nbins;
  int* whist = wcnt + a.nbins;
  float* wexpo = (float*)(whist + a.nbins);
  float* next = sm + (STATS ? WARPS * 3 * a.nbins : 0);
  float* s = a.s_glob + (size_t)blockIdx.x * 3 * n;
  if (LAYOUT == 0) {
    s = next;
    next += 3 * n;
  }
  float* rs_s = next;
  int* ti_s = (int*)(rs_s + kn);
  float* td_s = rs_s + 2 * kn;
  int* ent_s = (int*)(rs_s + (a.blend ? 3 : 2) * kn);
  int* off_s = ent_s + kn;
  if (a.tables_in_smem) next = (float*)(off_s + n + 1);
  float* ring = next;
  next += 2 * (size_t)(a.blend ? 3 : 2) * K * a.stage_tile;
  uint32_t* bits = LAYOUT == 0 ? (uint32_t*)next + (size_t)warp * words
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
    if (STATS)
      for (int b = lane; b < a.nbins; b += 32) {
        whist[b] = a.hist[(size_t)r * a.nbins + b];
        wexpo[b] = a.expo[(size_t)r * a.nbins + b];
      }
  }
  __syncwarp();
  const float dt = a.dt;

  for (int f = 0; f < a.B; ++f) {
    __syncthreads();  // every warp is done with the previous frame
    const float* cur = a.pos + (size_t)f * 3 * n;  // this frame's positions
    step_prefix(s, f == 0 ? a.prev_in : cur - 3 * n, cur, n, a.cell);
    const size_t fo = (size_t)f * kn;
    const int* in_off = a.in_off + (size_t)f * (n + 1);
    const int* in_ent = a.in_ent + fo;
    if (a.tables_in_smem) {
      for (size_t q = threadIdx.x; q < kn; q += blockDim.x) {
        rs_s[q] = a.resc[fo + q];
        ti_s[q] = a.topi[fo + q];
        if (a.blend) td_s[q] = a.topd[fo + q];
        ent_s[q] = in_ent[q];
      }
      for (int q = threadIdx.x; q <= n; q += blockDim.x) off_s[q] = in_off[q];
    }
    __syncthreads();

    const float* rs = a.tables_in_smem ? rs_s : a.resc + fo;
    const int* ti = a.tables_in_smem ? ti_s : a.topi + fo;
    const float* td = a.tables_in_smem ? td_s : a.topd + fo;
    const int* off = a.tables_in_smem ? off_s : in_off;
    const int* ent = a.tables_in_smem ? ent_s : in_ent;
    // the table distances the statistics bin (staged only with the blend)
    const float* tdist = a.tables_in_smem && a.blend ? td_s : a.topd + fo;
    const int frame_idx = a.frame0 + f;
    const float frame_time = (float)frame_idx * dt;
    // lane k < K carries slot k's rate sum and its count of positive
    // candidates through the frame's events
    float mine = 0.f;
    int cnt = 0;
    if (a.stage_tile)
      staged_sums<KMAX>(a, ring, fo, bits, tls_r, frame_time, lane, active, mine, cnt);
    else if (active)
      full_sums<KMAX>(a, rs, td, ti, bits, tls_r, frame_time, lane, mine, cnt);
    if (!active) continue;

    float phase = 0.f, total = slot_total(mine, K);
    bool done = false;
    for (int ev = 0; ev < a.max_events; ++ev) {
      // a replica that stopped firing stays done: its remaining iterations
      // are no-ops in the reference, so the warp leaves the loop
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

      // source: exponential race over the sites' rates in that slot, read
      // fresh from the tables
      const uint32_t kb = cmdlmc_mix_key(a.seed, tile_id, (uint32_t)frame_idx,
                                         (uint32_t)ev, 12u);
      bv = -1.f;
      bi = 0x7fffffff;
      for (int i = lane; i < n; i += 32) {
        float v = 0.f;
        if (occupied(bits, i)) {
          const float ai = cand_rate(a, rs, td, ti, bits, (size_t)kbest * n + i,
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

      // the changed candidates before the event, summed into lane k's `own`
      // (and `own_c`) for slot k: group 1, src's slots leaving; then groups
      // 3 and 4, src's and dst's in-entries, in chunks of 32 entries, one
      // lane an entry, one butterfly per slot present in the chunk
      float own = 0.f;
      int own_c = 0;
      if (lane < K) {
        const float old = cand_rate(a, rs, td, ti, bits, (size_t)lane * n + src,
                                    blend_ratio(a, tls_r, src, frame_time));
        own = -old;
        own_c = -(int)(old > 0.f);
      }
      const int s0 = off[src], ns = off[src + 1] - s0;
      const int d0 = off[dst], nd = off[dst + 1] - d0;
      for (int base = 0; base < ns + nd; base += 32) {
        const int e = base + lane;
        int k = -1, c = 0;
        float v = 0.f;
        if (e < ns + nd) {
          const bool of_src = e < ns;
          const int q = ent[of_src ? s0 + e : d0 + (e - ns)];
          const int i = q % n;
          if (i != src && i != dst && occupied(bits, i)) {
            // 1 - occ[src] goes 0 -> 1, 1 - occ[dst] goes 1 -> 0
            const float w = omega_at(a, rs, td, (size_t)q,
                                     blend_ratio(a, tls_r, i, frame_time));
            k = q / n;
            v = of_src ? w : -w;
            c = (of_src ? 1 : -1) * (int)(w > 0.f);
          }
        }
#pragma unroll
        for (int kk = 0; kk < KMAX; ++kk) {
          if (kk < K && __any_sync(FULL_MASK, k == kk)) {
            const float dv = warp_sum(k == kk ? v : 0.f);
            const int dc = __reduce_add_sync(FULL_MASK, k == kk ? c : 0);
            if (lane == kk) {
              own = own + dv;
              own_c += dc;
            }
          }
        }
      }

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
        if (STATS && a.nbins > 0) {
          const float d = tdist[(size_t)kbest * n + src];
          if (d >= a.hist_lo && d < a.hist_hi) whist[topk_bin(a, d)] += 1;
        }
        if (STATS && a.jm) atomicAdd(a.jm + (size_t)src * n + dst, 1);
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

      // group 2 after the event: dst's slots enter, at its new tlast_site
      if (lane < K) {
        const float nw = cand_rate(a, rs, td, ti, bits, (size_t)lane * n + dst,
                                   blend_ratio(a, tls_r, dst, frame_time));
        own = own + nw;
        own_c += nw > 0.f;
      }
      cnt += own_c;
      mine = cnt == 0 ? 0.f : mine + own;  // no positive candidate: +0
      total = slot_total(mine, K);
    }
    if (!done) trn += 1;
    if (STATS && a.nbins > 0) {
      // the exposure under the post-event state, slot by slot
      for (int k = 0; k < K; ++k) {
        for (int b = lane; b < a.nbins; b += 32) wcnt[b] = 0;
        __syncwarp();
        for (int i = lane; i < n; i += 32) {
          if (!occupied(bits, i)) continue;  // empty: a_k[i] = 0
          const size_t o = (size_t)k * n + i;
          const float d = tdist[o];
          if (d >= a.hist_lo && d < a.hist_hi &&
              cand_rate(a, rs, td, ti, bits, o,
                        blend_ratio(a, tls_r, i, frame_time)) > 0.f)
            atomicAdd(wcnt + topk_bin(a, d), 1);
        }
        __syncwarp();
        for (int b = lane; b < a.nbins; b += 32) wexpo[b] = wexpo[b] + (float)wcnt[b];
        __syncwarp();
      }
    }
    u = u - total * (dt - phase);  // the total after the frame's last event
  }

  if (active) {
    __syncwarp();
    for (int i = lane; i < n; i += 32) a.occ[(size_t)r * n + i] = occ_of(bits, i);
    if (lane == 0) {
      a.u[r] = u;
      a.evc[r] = evc;
      a.trunc[r] = trn;
    }
    if (STATS)
      for (int b = lane; b < a.nbins; b += 32) {
        a.hist[(size_t)r * a.nbins + b] = whist[b];
        a.expo[(size_t)r * a.nbins + b] = wexpo[b];
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

template <int WARPS, int KMAX, int LAYOUT, bool STATS>
static cudaError_t launch(const TopkArgs& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_sweep_kernel<WARPS, KMAX, LAYOUT, STATS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.R + WARPS - 1) / WARPS;
  topk_sweep_kernel<WARPS, KMAX, LAYOUT, STATS>
      <<<blocks, WARPS * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool STATS>
static cudaError_t launch_plan(const TopkArgs& a, const TopkPlan& plan,
                               cudaStream_t s) {
  const bool k8 = a.K <= 8;
  if (plan.layout == 1)
    return k8 ? launch<32, 8, 1, STATS>(a, plan.smem, s)
              : launch<32, 16, 1, STATS>(a, plan.smem, s);
  if (plan.warps == 32)
    return k8 ? launch<32, 8, 0, STATS>(a, plan.smem, s)
              : launch<32, 16, 0, STATS>(a, plan.smem, s);
  return k8 ? launch<8, 8, 0, STATS>(a, plan.smem, s)
            : launch<8, 16, 0, STATS>(a, plan.smem, s);
}

// The plan of a launch at (R, N, K, blend) with `nbins` counters per warp
// (0 without statistics): warps per block, layout, tables staged whole,
// tile of the staged first evaluation (0: none), dynamic shared memory and
// global scratch in bytes (0 in the shared layout).
extern "C" int cmdlmc_topk_sweep_plan(int R, int N, int K, int blend,
                                      int nbins, int device, long long* out6) {
  CmdlmcDeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  TopkPlan plan;
  cudaError_t err = topk_plan(R, N, K, blend, nbins, device, &plan);
  if (err != cudaSuccess) return (int)err;
  out6[0] = plan.warps;
  out6[1] = plan.layout;
  out6[2] = plan.tables_in_smem;
  out6[3] = plan.stage_tile;
  out6[4] = (long long)plan.smem;
  out6[5] = (long long)plan.scratch;
  return 0;
}

// One K4 launch; with `stats` the kernel with jump statistics (else the
// arguments after geom18 are null and 0): `hist` and
// `expo` [R, nbins] updated in place where nbins > 0, `jm` an [N, N] int32
// sum the fired jumps add to (or null), the histogram's range [lo, hi) and
// its bins per unit `scale`.
extern "C" int cmdlmc_topk_sweep(
    const void* pos, const void* topd, const void* topi, const void* resc,
    const void* in_off, const void* in_ent, const void* prev_in,
    const void* s_in, void* prev_out, void* s_out, void* occ, void* lab,
    void* sites, void* tlast, void* tls, void* db, void* u, void* evc,
    void* trunc, void* scratch, long long scratch_bytes, int R, int N, int P,
    int B, int K, int tile, int tile_offset, int frame0, int max_events,
    int kind, int blend, int ortho, float dt, float relax, uint32_t seed,
    const float* law6, const float* geom18, void* hist, void* expo, void* jm,
    int stats, int nbins, float lo, float hi, float scale, void* stream,
    int device) {
  CmdlmcDeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  if (kind < 0 || kind > 3 || K < 1 || K > 16 || N < 2 || B < 1)
    return (int)cudaErrorInvalidValue;
  if (nbins < 0 || (nbins > 0 && (!stats || !hist || !expo)) || (jm && !stats))
    return (int)cudaErrorInvalidValue;
  const int cnt = stats ? nbins : 0;
  TopkPlan plan;
  err = topk_plan(R, N, K, blend, cnt, device, &plan);
  if (err != cudaSuccess) return (int)err;
  if ((long long)plan.scratch > scratch_bytes) return (int)cudaErrorInvalidValue;
  TopkArgs a = {};
  a.pos = (const float*)pos;
  a.topd = (const float*)topd;
  a.topi = (const int*)topi;
  a.resc = (const float*)resc;
  a.in_off = (const int*)in_off;
  a.in_ent = (const int*)in_ent;
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
  a.stage_tile = plan.stage_tile;
  a.dt = dt;
  a.relax = relax;
  a.seed = seed;
  for (int q = 0; q < 6; ++q) a.params[q] = law6[q];
  for (int q = 0; q < 9; ++q) {
    a.cell.h[q] = geom18[q];
    a.cell.hinv[q] = geom18[9 + q];
  }
  a.cell.ortho = ortho;
  a.hist = (int*)hist;
  a.expo = (float*)expo;
  a.jm = (int*)jm;
  a.nbins = cnt;
  a.hist_lo = lo;
  a.hist_hi = hi;
  a.hist_scale = scale;

  cudaStream_t s = (cudaStream_t)stream;
  return (int)(stats ? launch_plan<true>(a, plan, s) : launch_plan<false>(a, plan, s));
}
