// The per-replica KMC event loop shared by kernels K1 (streamed W) and K3
// (in-kernel W). The two kernels differ only in where a frame's rate matrix
// W[f] comes from; everything after it is this code, so both routes run the
// same arithmetic.
//
// A thread block holds WARPS replicas, one warp per replica. Per frame:
//   * every block advances the shared site-displacement prefix sum
//     s += minimg(post - prev) in the reference's running float32
//     association and keeps the frame's positions in `cur`;
//   * `stage` fills the block's W[f] (K1 copies it from global memory, K3
//     builds it from `cur`), in shared memory with row stride N+1 so that
//     lane i reading W[i][j] hits its own bank;
//   * each warp runs up to max_events event iterations: out = W (1 - occ),
//     row = occ * out, the clock test u <= total (dt - phase), the
//     exponential race for the source (argmax row / E1) and for the
//     destination (argmax W[src] vac / E2), the occupancy / label / site /
//     t_last / disp_base updates (with the minimum-image jump rebase) and a
//     fresh exponential u;
//   * at frame end the unused budget leaves u, and a replica that fired on
//     every iteration counts one truncated frame.
// `stale` (K1 only) reuses the frame-start rows and total inside the frame.
// Lanes stride over sites; sums and argmaxes are warp shuffles. The RNG tile
// of the reference (`tile` replicas per tile) is a logical parameter of the
// draw keys, independent of the launch shape.
//
// Rows reduce W[i][j] (1 - occ[j]) along j, so an asymmetric W (the angle
// gate) needs nothing special, and the destination race reads row W[src].
//
// Numerics: build with --fmad=false and without fast math. rintf rounds half
// to even like jnp.round; logf is the accurate libm form. Argmax keeps the
// first index on ties. Gathers are index loads. In the two races a zero-rate
// candidate scores 0 and E = 0 - log(u) is +0 for a draw of exactly 1.0, so
// that draw makes a positive-rate candidate win; the JAX kernels compute
// rate / -log(u), where the same draw gives NaN for a zero rate (argmax takes
// it: an impossible move) and -inf for a positive one.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "kmc_common.cuh"
#include "rng.cuh"

struct SweepArgs {
  const float* w;        // [B, N, N] (K1; unused by K3)
  const float* pos;      // [B, N, 3]
  const float* pgrp;     // [B, N, 3] grouped P positions (K3, kind 4)
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
  int kind;              // K3: rate law kind 0-4
  float dt, cutbuf;
  float acc_cut;         // K3: largest squared distance with sqrtf <= cutbuf
  uint32_t seed;
  float box[3];
  float params[6];       // K3: law parameters (slot 3 = cos theta, kind 4)
};

// row[i] = occ[i] * sum_j W[i][j] (1 - occ[j]); returns sum_i row[i].
__device__ inline float total_rate(const float* wf, int ldw, const float* occ,
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

// Dynamic shared memory of one block: W[N, N+1] when staged, the prefix sum
// and positions [2, N, 3], and each warp's occ / labels / rows [3, N].
__host__ inline size_t sweep_smem_bytes(int N, int warps, int with_w) {
  size_t base = sizeof(float) * ((size_t)6 * N + (size_t)warps * 3 * N);
  return base + (with_w ? sizeof(float) * (size_t)N * (N + 1) : 0);
}

// The body of a sweep kernel: every replica of this block across all B
// frames. `stage(a, f, ws, cur, warp, lane)` fills W[f] into `ws` (row
// stride N+1) or leaves it in global memory when a.w_in_smem is 0; it runs
// after the frame's positions are in `cur`.
template <int WARPS, class Stage>
__device__ __forceinline__ void sweep_block(const SweepArgs& a,
                                            const Stage& stage) {
  extern __shared__ float sm[];
  const int n = a.N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t wsize = a.w_in_smem ? (size_t)n * (n + 1) : 0;
  float* ws = sm;              // [N, N+1] W of this frame
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
  const CellImage cell = orthorhombic_image(a.box[0], a.box[1], a.box[2]);

  for (int f = 0; f < a.B; ++f) {
    __syncthreads();  // every warp is done with the previous frame
    advance_prefix(s, cur, a.pos + (size_t)f * 3 * n, n, cell);
    __syncthreads();
    stage(a, f, ws, cur, warp, lane);
    __syncthreads();
    if (!active) continue;

    const float* wf = a.w_in_smem ? ws : a.w + (size_t)f * n * n;
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
