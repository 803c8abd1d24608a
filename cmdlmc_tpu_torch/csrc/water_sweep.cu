// Kernel K7: the event loop of the single-excess-proton water model.
//
// Replaces the event loop of the TPU kernel
// cmdlmc_tpu/ops/water_sweep.py::_make_kernel (pallas_call at
// ops/water_sweep.py:506; ev_iter and frame_body, :169-393) in rows
// semantics. B4 also rebuilds each frame's [N, N] distances and K-nearest
// tables inside every replica tile; here those tables come once per frame
// for all replicas from K5 (csrc/knn_tables.cu, no cutoff) and the transform
// (ops/water_sweep.py::water_tables), [B, K, N] with sites last, and this
// kernel reads them from global memory (L2) by index.
//
// One thread runs one replica through the whole block of frames; its state
// is a handful of registers (site, last site, frames since the jump, waiting
// frames, jumps, events, u, the d_OH correction and the displacement base).
// Per frame:
//   * the block advances its own copy of the site prefix sum s (12 N bytes
//     of shared memory) by s += minimg(post - prev)
//     (kmc_common.cuh::step_prefix), in the reference's order;
//   * up to max_events event iterations: the 3 candidates of the current
//     site (the K table entries at the site; the relaxation blend
//     d + clip(fsj / relax, 0, 1) (r - d); the connection back to the last
//     site kept rescaled, with the slot-3 -> 2 promotion at K = 4 or, at
//     K = 3, check_from_old against the last site's row; the law on the
//     first 3; zero while waiting), total = (r0 + r1) + r2, the clock test
//     u <= total (dt - phase), the pick [u2 >= r0] + [u2 >= r0 + r1] with
//     u2 = draw * total (salt 12, in-tile counter), the displacement rebase
//     (s[site] - s[dst]) + minimg(p[dst] - p[site]) from shared s and the
//     frame's positions in L2, the d_OH step, and a fresh u = -log(draw)
//     (salt 13);
//   * at frame end the unused budget leaves u, a replica that fired on every
//     iteration counts one truncated frame, and the per-frame counters move
//     (fsj += 1, wait = max(wait - 1, 0)); replica 0 writes its site to the
//     frame's slot of the site trace, the site the CLI prints for that frame.
// B4's any_live skip over a tile is a per-thread loop exit: a done replica's
// iteration changes nothing. Its one-hot matmul gathers are index loads. The
// logical RNG tile `tile` keys the draws and is not the CUDA block.
//
// Numerics (built with --fmad=false): total = (r0 + r1) + r2, the order of
// XLA's CPU reduction over B4's 8 lanes, so the pick compares the same
// floats; |jump|^2 = (x^2 + y^2) + z^2 and lax.rsqrt as 1.0f / sqrtf (XLA's
// CPU rsqrt is an approximation, so the d_OH correction agrees within a few
// ulps, not bit for bit). A pick that lands on a zero-rate slot (a draw of
// exactly 1.0 makes u2 = total; ROADMAP queue C item 7) takes the last slot
// with a positive rate.
//
// Bound on the H100: operations, a few dozen per candidate evaluation (two
// to five per replica-frame) and about a hundred per event, against bytes
// of the tables and positions read once (12 B x (K + 1) per site and
// frame): about 3 us at N=216, R=8192, B=256, where K7 takes over a
// millisecond (PERF.md). Each thread's loop is a chain of dependent L2 loads
// and law evaluations, and every block advances the whole prefix sum each
// frame, so wider blocks (fewer copies of that work) ran faster on the card
// than the 256 one-warp blocks that would fill its SMs: the block width is
// the caller's (ops/water_sweep.py::BLOCK_THREADS).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "kmc_common.cuh"
#include "rng.cuh"

struct WaterArgs {
  const float* pos;   // [B, N, 3]
  const float* topd;  // [B, K, N]
  const int* topi;    // [B, K, N]
  const float* resc;  // [B, K, N]
  const float* prev;  // [N, 3] positions of the frame before the block
  const float* s_in;  // [N, 3] site prefix sum at block start
  float* s_out;       // [N, 3]
  int* site;
  int* last;
  int* fsj;
  int* wait;
  int* jumps;
  int* evc;
  float* u;
  float* corr;   // [R, 3]
  float* abase;  // [R, 3]
  int* trunc;
  int* site_trace;  // [B] replica 0's site after each frame
  int R, N, B, K, tile, tile_offset, frame0, max_events, kind, relax, waiting,
      keep_last, check_old;
  float dt, d_oh, lx, ly, lz;
  uint32_t seed;
  float p[6];
};

// The 3 candidates of `site` on one frame's tables (td/ti/rs at [K][N]):
// B4's `candidates` for one replica.
__device__ inline void water_candidates(const WaterArgs& a, const float* td,
                                        const int* ti, const float* rs,
                                        int site, int last, int fsj, int wait,
                                        float rates[3], int cand[3]) {
  const int N = a.N, K = a.K;
  float de[4] = {0.f, 0.f, 0.f, 0.f}, r[4] = {0.f, 0.f, 0.f, 0.f};
  int ci[4] = {0, 0, 0, 0};
  bool is_last[4] = {false, false, false, false};
  float factor = 0.f;
  if (a.relax > 0)
    factor = fminf(fmaxf((float)fsj / (float)a.relax, 0.f), 1.f);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (s < K) {
      const float d = td[s * N + site];
      r[s] = rs[s * N + site];
      ci[s] = ti[s * N + site];
      de[s] = a.relax > 0 ? d + factor * (r[s] - d) : r[s];
      is_last[s] = a.keep_last && last >= 0 && ci[s] == last;
      if (is_last[s]) de[s] = r[s];
    }
  }
  if (a.keep_last) {
    if (K == 4) {
      // the old neighbor in slot 3 moves to slot 2
      if (is_last[3]) {
        de[2] = de[3];
        ci[2] = ci[3];
      }
    } else if (a.check_old && last >= 0 && !(is_last[0] || is_last[1] || is_last[2])) {
      // the connection exists only old -> new: the farthest active candidate
      // becomes the old site at old's rescaled distance
      int first_eq = -1;
#pragma unroll
      for (int s = 0; s < 3; ++s)
        if (first_eq < 0 && ti[s * N + last] == site) first_eq = s;
      if (first_eq >= 0) {
        int far = 0;
        if (de[1] > de[far]) far = 1;
        if (de[2] > de[far]) far = 2;
        de[far] = rs[first_eq * N + last];
        ci[far] = last;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    rates[s] = wait > 0 ? 0.f : apply_law(a.kind, de[s], a.p);
    cand[s] = ci[s];
  }
}

__global__ void water_sweep_kernel(WaterArgs a) {
  extern __shared__ float s_sh[];  // [N, 3] site prefix sum
  const int N = a.N;
  for (int i = threadIdx.x; i < 3 * N; i += blockDim.x) s_sh[i] = a.s_in[i];
  const CellImage cell = orthorhombic_image(a.lx, a.ly, a.lz);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < a.R;
  int site = 0, last = -1, fsj = 0, wait = 0, jumps = 0, evc = 0, trunc = 0;
  float u = 0.f, cx = 0.f, cy = 0.f, cz = 0.f, ax = 0.f, ay = 0.f, az = 0.f;
  uint32_t tile_id = 0, rin = 0;
  if (live) {
    site = a.site[r];
    last = a.last[r];
    fsj = a.fsj[r];
    wait = a.wait[r];
    jumps = a.jumps[r];
    evc = a.evc[r];
    u = a.u[r];
    cx = a.corr[3 * r];
    cy = a.corr[3 * r + 1];
    cz = a.corr[3 * r + 2];
    ax = a.abase[3 * r];
    ay = a.abase[3 * r + 1];
    az = a.abase[3 * r + 2];
    tile_id = (uint32_t)(r / a.tile + a.tile_offset);
    rin = (uint32_t)(r % a.tile);
  }
  const float c_oh = 2.0f * a.d_oh;
  const int wait0 = a.waiting ? a.waiting + 1 : 0;

  for (int b = 0; b < a.B; ++b) {
    const float* post = a.pos + (size_t)b * N * 3;
    const float* prev = b == 0 ? a.prev : post - (size_t)N * 3;
    __syncthreads();  // every thread is done with the last frame's s
    step_prefix(s_sh, prev, post, N, cell);
    __syncthreads();
    if (!live) continue;
    const size_t t0 = (size_t)b * a.K * N;
    const float* td = a.topd + t0;
    const int* ti = a.topi + t0;
    const float* rs = a.resc + t0;
    const uint32_t frame_idx = (uint32_t)(a.frame0 + b);
    float phase = 0.f;
    bool done = false;
    float rates[3];
    int cand[3];
    for (int ev = 0; ev < a.max_events && !done; ++ev) {
      water_candidates(a, td, ti, rs, site, last, fsj, wait, rates, cand);
      const float c1 = rates[0] + rates[1];
      const float total = c1 + rates[2];
      const float budget = total * (a.dt - phase);
      if (!(u <= budget && budget > 0.f)) {
        done = true;
        break;
      }
      const float eph = phase + u / total;
      const float u2 =
          cmdlmc_u01(cmdlmc_mix_key(a.seed, tile_id, frame_idx, ev, 12), rin) * total;
      int pick = (u2 >= rates[0] ? 1 : 0) + (u2 >= c1 ? 1 : 0);
      if (!(rates[pick] > 0.f))  // a draw of 1.0: the last positive slot
        pick = rates[2] > 0.f ? 2 : rates[1] > 0.f ? 1 : 0;
      const int dst = cand[pick];
      const float jx = minimg(post[3 * dst] - post[3 * site], a.lx);
      const float jy = minimg(post[3 * dst + 1] - post[3 * site + 1], a.ly);
      const float jz = minimg(post[3 * dst + 2] - post[3 * site + 2], a.lz);
      ax = ax + ((s_sh[3 * site] - s_sh[3 * dst]) + jx);
      ay = ay + ((s_sh[3 * site + 1] - s_sh[3 * dst + 1]) + jy);
      az = az + ((s_sh[3 * site + 2] - s_sh[3 * dst + 2]) + jz);
      if (a.d_oh != 0.f) {
        const float norm2 = (jx * jx + jy * jy) + jz * jz;
        const float inv = 1.0f / sqrtf(fmaxf(norm2, 1e-12f));
        cx = cx - (c_oh * jx) * inv;
        cy = cy - (c_oh * jy) * inv;
        cz = cz - (c_oh * jz) * inv;
      }
      last = site;
      site = dst;
      fsj = -1;
      wait = wait0;
      jumps += 1;
      evc += 1;
      u = -logf(cmdlmc_u01(cmdlmc_mix_key(a.seed, tile_id, frame_idx, ev, 13), rin));
      phase = eph;
    }
    if (!done) trunc += 1;
    water_candidates(a, td, ti, rs, site, last, fsj, wait, rates, cand);
    u = u - ((rates[0] + rates[1]) + rates[2]) * (a.dt - phase);
    fsj += 1;
    wait = wait > 1 ? wait - 1 : 0;
    if (r == 0) a.site_trace[b] = site;
  }

  if (blockIdx.x == 0) {
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * N; i += blockDim.x) a.s_out[i] = s_sh[i];
  }
  if (!live) return;
  a.site[r] = site;
  a.last[r] = last;
  a.fsj[r] = fsj;
  a.wait[r] = wait;
  a.jumps[r] = jumps;
  a.evc[r] = evc;
  a.u[r] = u;
  a.corr[3 * r] = cx;
  a.corr[3 * r + 1] = cy;
  a.corr[3 * r + 2] = cz;
  a.abase[3 * r] = ax;
  a.abase[3 * r + 1] = ay;
  a.abase[3 * r + 2] = az;
  a.trunc[r] = trunc;
}

extern "C" int cmdlmc_water_sweep(
    const void* pos, const void* topd, const void* topi, const void* resc,
    const void* prev, const void* s_in, void* s_out, void* site, void* last,
    void* fsj, void* wait, void* jumps, void* evc, void* u, void* corr,
    void* abase, void* trunc, void* site_trace, int R, int N, int B, int K, int tile,
    int tile_offset, int frame0, int max_events, int kind, int relax,
    int waiting, int keep_last, int check_old, int threads, float dt,
    float d_oh, float lx, float ly, float lz, uint32_t seed, const float* p,
    void* stream, int device) {
  CmdlmcDeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (K < 3 || K > 4 || N <= K || tile < 1 || R % tile || threads < 32 ||
      threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  WaterArgs a;
  a.pos = (const float*)pos;
  a.topd = (const float*)topd;
  a.topi = (const int*)topi;
  a.resc = (const float*)resc;
  a.prev = (const float*)prev;
  a.s_in = (const float*)s_in;
  a.s_out = (float*)s_out;
  a.site = (int*)site;
  a.last = (int*)last;
  a.fsj = (int*)fsj;
  a.wait = (int*)wait;
  a.jumps = (int*)jumps;
  a.evc = (int*)evc;
  a.u = (float*)u;
  a.corr = (float*)corr;
  a.abase = (float*)abase;
  a.trunc = (int*)trunc;
  a.site_trace = (int*)site_trace;
  a.R = R;
  a.N = N;
  a.B = B;
  a.K = K;
  a.tile = tile;
  a.tile_offset = tile_offset;
  a.frame0 = frame0;
  a.max_events = max_events;
  a.kind = kind;
  a.relax = relax;
  a.waiting = waiting;
  a.keep_last = keep_last;
  a.check_old = check_old;
  a.dt = dt;
  a.d_oh = d_oh;
  a.lx = lx;
  a.ly = ly;
  a.lz = lz;
  a.seed = seed;
  for (int i = 0; i < 6; ++i) a.p[i] = p[i];
  const size_t smem = (size_t)12 * N;
  if (smem > 48 * 1024) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(water_sweep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (R + threads - 1) / threads;
  water_sweep_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
