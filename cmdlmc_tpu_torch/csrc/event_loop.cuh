// The per-replica KMC event loop shared by kernels K1 (streamed W) and K3
// (in-kernel W). The two kernels differ only in where a frame's rate matrix
// W[f] comes from; everything after it is this code, so both routes run the
// same arithmetic.
//
// A thread block holds WARPS replicas, one warp per replica. Per frame:
//   * every block advances the shared site-displacement prefix sum
//     s += minimg(post - prev) in the reference's running float32
//     association and keeps the frame's positions in `cur`;
//   * the stage writes the frame's W as compact lists: for each row i the
//     columns j with W[i][j] != 0, in increasing j, and their values; for
//     each column the rows and values of its nonzero entries (K1 compacts
//     W[f] as it reads it from global memory, K3 builds each row from
//     `cur`). The launch's longest row and column (`caps`) are counted on
//     the device before it, so the host never waits for them; the block
//     takes the shared memory its occupancy leaves (`list_budget`) and the
//     lists live there where they fit, in a global scratch slice of the
//     block otherwise (`Lists`);
//   * each warp runs up to max_events event iterations: row = occ * out with
//     out = W (1 - occ), the clock test u <= total (dt - phase), the
//     exponential race for the source (argmax row / E1) and for the
//     destination (argmax W[src] vac / E2), the occupancy / label / site /
//     t_last / disp_base updates (with the minimum-image jump rebase) and a
//     fresh exponential u;
//   * at frame end the unused budget leaves u, and a replica that fired on
//     every iteration counts one truncated frame.
// `stale` (K1 only) reuses the frame-start rows and total inside the frame.
//
// Jump statistics and the cell are compile-time options (`STATS`, `TRI`),
// so the default kernel (no statistics, an orthorhombic box) runs the code
// it ran before them:
//   * TRI (K1): the jump vector and the prefix step take the round-based
//     triclinic minimum image of CellImage (h, h^-1), which is exact for
//     vectors shorter than half the smallest cell height (the host's skew
//     gate); without it the per-axis minimg of the box;
//   * STATS: with nbins > 0, after each fired event lane 0 adds one to the
//     replica's bin of the jump length sqrtf(((0 + jx^2) + jy^2) + jz^2) (B1
//     and B2's association) where lo <= d < hi, and at each frame end, under
//     the post-event occupancy and before the unused budget leaves u, the
//     warp counts for every bin the pairs (i occupied, j vacant) of row i's
//     list with W[i][j] > 0 and lo <= dist[i][j] < hi (the exposure): the
//     lists then carry each entry's exposure bin beside its value (its
//     histogram bin where W > 0 and the distance is in range, else NO_BIN),
//     found once per block and frame as the lists are built, the warp's
//     lanes walk the occupied rows' lists four entries at a time, and each
//     warp keeps nbins integer counters in shared memory, added to the
//     replica's float exposure once per frame and bin, as the TPU kernels
//     add their per-frame sums (whole numbers below 2^24, so the same bits).
//     The replica's histogram and exposure stay in the warp's shared memory
//     across the launch (3 nbins words a warp with the counters), read at
//     its start and written at its end, so no event or frame waits on a
//     global read.
//     The occupancy is 0 or 1 (the races never move a proton onto an
//     occupied site), so the exposure is that count. With a jump matrix
//     lane 0 adds one to [src][dst] of the launch's int32 [N, N] sum with
//     an atomicAdd per fired event (no one-hot product).
// A histogram bin is clip(int((d - lo) * scale), 0, nbins - 1).
// Lanes stride over sites; sums and argmaxes are warp shuffles. The RNG tile
// of the reference (`tile` replicas per tile) is a logical parameter of the
// draw keys, independent of the launch shape.
//
// Exact sparse sums: the same bits as summing every row over every column.
// out[i] = sum_j W[i][j] (1 - occ[j]) runs in ascending j; a term with
// W[i][j] = +-0 is +-0 (occ is finite), and x + (+-0) = x for every partial
// sum (it starts at +0 and so is never -0), so the sum over row i's list
// has the dense sum's bits. While every occupancy is 0 or 1 and every W of
// the frame finite, a term is W * 1 = W for a vacant column and W * 0 =
// +-0 for an occupied one, so only the vacant columns' terms are added. A
// row of an empty site is 0 * out = +-0 and adds nothing, so it is not
// summed while W is finite (with an inf, 0 * inf = NaN, and such a frame
// sums every row). Lane l adds rows l, l+32, ... in ascending i and the xor
// butterfly adds the lanes' partials, as before. The frame's first
// evaluation walks the vacant columns in ascending order and adds each
// one's entries to their rows, which gives every row its terms in the
// order of its own sum (without binary occupancy or finite W: the rows one
// by one). After an event src -> dst only the rows whose value can change
// are summed again, the occupied ones among src, dst and the rows with
// W[i][src] != 0 or W[i][dst] != 0 (the column lists; so an asymmetric W,
// the angle gate, needs nothing special), each by a lane over its row list
// with the warp's vacancy bits. Any other row has the same terms in the
// same order, so its bits stand; the partials are added again from the
// rows. The source race draws only for the sites whose row is positive and
// the destination race only over src's list: a skipped candidate scores 0
// in the dense race and cannot beat a positive score; when no candidate
// scores above 0 the dense argmax takes site 0, and so do these. Draw
// counters stay replica_in_tile * N + site.
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
  const int* caps;       // [2] the longest row and column list (device)
  unsigned char* lists_global;  // per-block list slices, or null
  size_t slice;          // bytes of one block's slice of lists_global
  size_t list_budget;    // bytes of dynamic shared memory for the lists
  int R, N, P, B, tile, tile_offset, frame0, max_events, stale;
  int extra;             // floats of stage scratch after the positions
  int kind;              // K3: rate law kind 0-4
  float dt, cutbuf;
  float acc_cut;         // K3: largest squared distance with sqrtf <= cutbuf
  uint32_t seed;
  float box[3];
  float params[6];       // K3: law parameters (slot 3 = cos theta, kind 4)
  CellImage cell;        // K1 with TRI: the cell's h and h^-1
  // STATS: jump statistics (see above)
  const float* dist;     // [B, N, N] raw distances (K1 with nbins > 0)
  int* hist;             // [R, nbins] in place
  float* expo;           // [R, nbins] in place
  int* jm;               // [N, N] the launch's jump matrix (adds), or null
  int nbins;
  float hist_lo, hist_hi, hist_scale;
};

// Blocks of `warps` warps per SM the launch bounds size registers for: 32
// warps per SM, 64 registers a thread. On the H100 (PERF.md, PR 7) a cap
// for 48 or 64 warps spilled registers and ran no faster at any launch
// shape of K1 or K3.
__host__ __device__ constexpr int sweep_min_blocks(int warps) {
  return 32 / warps > 0 ? 32 / warps : 1;
}

// A frame's W as row lists and column lists: row i holds len[i] <= cap
// entries, columns ascending, at i * ldv (values) and i * ldc (columns);
// column j holds its clen[j] <= ccap nonzero entries at j * ldr (rows and
// values), in any order. The strides keep lanes reading rows l, l+32, ...
// at the same entry on distinct banks: ldv is odd, ldc / 2 (uint16 pairs
// per word) is odd.
struct Lists {
  float* val;      // [N, ldv]
  uint16_t* bin;   // [N, ldc] each entry's exposure bin (STATS), or null
  float* cval;     // [N, ldr]
  int* clen;       // [N]
  uint16_t* col;   // [N, ldc]
  uint16_t* crow;  // [N, ldr]
  uint16_t* len;   // [N]
  int ldv, ldc, ldr;
  int cap, ccap;
};

__host__ __device__ inline int odd_at_least(int x) { return x | 1; }

// Bytes of one block's lists (16-byte multiple: global slices stay aligned).
__host__ __device__ inline size_t list_bytes(int N, int cap, int ccap) {
  const size_t n = (size_t)N;
  const size_t ldr = 2 * odd_at_least((ccap + 1) / 2);
  const size_t ldc = 2 * odd_at_least((cap + 1) / 2);
  const size_t b = 4 * n * odd_at_least(cap) + 4 * n * ldr + 4 * n +
                   2 * n * ldc + 2 * n * ldr + 2 * n;
  return (b + 15) & ~(size_t)15;
}

// Bytes of the entries' exposure bins that STATS lists add after the
// others (uint16 [N, ldc]; a 16-byte multiple).
__host__ __device__ inline size_t bin_list_bytes(int N, int cap) {
  return ((size_t)2 * N * 2 * odd_at_least((cap + 1) / 2) + 15) & ~(size_t)15;
}

__host__ __device__ inline size_t list_bytes(int N, int cap, int ccap,
                                             bool stats) {
  return list_bytes(N, cap, ccap) + (stats ? bin_list_bytes(N, cap) : 0);
}

__device__ inline Lists lists_at(unsigned char* p, int N, int cap, int ccap,
                                 bool stats) {
  Lists L;
  L.bin = stats ? (uint16_t*)(p + list_bytes(N, cap, ccap)) : nullptr;
  L.ldv = odd_at_least(cap);
  L.ldc = 2 * odd_at_least((cap + 1) / 2);
  L.ldr = 2 * odd_at_least((ccap + 1) / 2);
  L.val = (float*)p;
  L.cval = L.val + (size_t)N * L.ldv;
  L.clen = (int*)(L.cval + (size_t)N * L.ldr);
  L.col = (uint16_t*)(L.clen + N);
  L.crow = L.col + (size_t)N * L.ldc;
  L.len = L.crow + (size_t)N * L.ldr;
  L.cap = cap;
  L.ccap = ccap;
  return L;
}

// One warp's shared arrays: occupancy, labels and rows (float [N] each),
// the vacancy bits and the row marks (uint32 [ceil(N / 32)] each) and a
// list of sites (uint16 [N], padded to 4 bytes).
__host__ __device__ inline size_t warp_smem_bytes(int N) {
  return 12 * (size_t)N + 8 * (size_t)((N + 31) / 32) +
         4 * (size_t)((N + 1) / 2);
}

// Dynamic shared memory of one block without its lists: the prefix sum and
// positions [2, N, 3], `extra` floats of stage scratch and each warp's
// arrays.
__host__ inline size_t sweep_fixed_bytes(int N, int warps, int extra) {
  return sizeof(float) * ((size_t)6 * N + extra) +
         (size_t)warps * warp_smem_bytes(N);
}

// A sweep kernel's launch plan at N sites: the dynamic shared memory of a
// block, as much as the blocks one SM holds for their registers and
// threads leave each of them (with `one_block`, all of an SM's: one block
// per SM), at most the opt-in limit, and of that the bytes left for the
// lists. Fails where not even the fixed part fits.
__host__ inline cudaError_t sweep_plan(const void* kernel, int N, int warps,
                                       int extra, int device, size_t* smem,
                                       size_t* list_budget,
                                       bool one_block = false) {
  if (N < 1 || N > 65535) return cudaErrorInvalidValue;
  int optin = 0, per_sm = 0, reserved = 0, blocks = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
  if (err != cudaSuccess) return err;
  const size_t fixed = sweep_fixed_bytes(N, warps, extra);
  if (fixed > (size_t)optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fixed);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        warps * 32, fixed);
  if (err != cudaSuccess) return err;
  if (blocks < 1) return cudaErrorInvalidValue;
  if (one_block) blocks = 1;
  size_t total = (size_t)per_sm / blocks - (size_t)reserved;
  if (total > (size_t)optin) total = (size_t)optin;
  *smem = total;
  *list_budget = total - fixed;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)total);
}

// Counts of the launch's longest row and column list: caps[0] and caps[1]
// are raised to them with atomicMax (the caller zeroes them).
__device__ inline void raise_caps(int* caps, int k, int count) {
  if (count > 0) atomicMax(caps + k, count);
}

// The histogram bin of an in-range distance d.
__device__ inline int hist_bin(const SweepArgs& a, float d) {
  const int b = (int)((d - a.hist_lo) * a.hist_scale);
  return b < 0 ? 0 : (b >= a.nbins ? a.nbins - 1 : b);
}

__device__ inline bool hist_in_range(const SweepArgs& a, float d) {
  return d >= a.hist_lo && d < a.hist_hi;
}

// A list entry's exposure bin: the bin of its distance d where W > 0 and
// lo <= d < hi, else NO_BIN (the host keeps nbins below it).
constexpr uint16_t NO_BIN = 0xffff;

__device__ inline uint16_t entry_bin(const SweepArgs& a, float w, float d) {
  return w > 0.f && hist_in_range(a, d) ? (uint16_t)hist_bin(a, d) : NO_BIN;
}

// Appends this lane's value of column `j` to row i's list if it is nonzero
// (NaN counts), keeping the warp's columns in order, and row i to column
// j's list; `cnt` is the row's length so far (the same in every lane).
// With STATS the entry's exposure bin `b` goes beside its value. Returns 1
// if w is not finite.
template <bool STATS>
__device__ __forceinline__ int list_push(const Lists& L, int i, int j, float w,
                                         uint16_t b, int& cnt, int lane) {
  const bool nz = w != 0.f;
  const unsigned m = __ballot_sync(FULL_MASK, nz);
  if (nz) {
    const int p = cnt + __popc(m & ((1u << lane) - 1u));
    const int q = atomicAdd(L.clen + j, 1);
    if (p >= L.cap || q >= L.ccap) __trap();  // caps were counted from W
    L.val[(size_t)i * L.ldv + p] = w;
    if (STATS) L.bin[(size_t)i * L.ldc + p] = b;
    L.col[(size_t)i * L.ldc + p] = (uint16_t)j;
    L.crow[(size_t)j * L.ldr + q] = (uint16_t)i;
    L.cval[(size_t)j * L.ldr + q] = w;
  }
  cnt += __popc(m);
  return isfinite(w) ? 0 : 1;
}

// Writes row i's lists from `value(j)`, W[i][j] for the lane's column j < n
// (with STATS also the entry's exposure bin `bin_of(j, w)`): eight columns
// per lane are evaluated (or loaded) before any is appended, so their
// latencies overlap. Returns 1 if a value is not finite.
template <bool STATS, class Value, class Bin>
__device__ __forceinline__ int push_row(const Lists& L, int i, int n, int lane,
                                        const Value& value, const Bin& bin_of) {
  int cnt = 0, bad = 0;
  for (int base = 0; base < n; base += 8 * 32) {
    float w[8];
    uint16_t b[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int j = base + 32 * k + lane;
      w[k] = j < n ? value(j) : 0.f;
      b[k] = STATS && j < n ? bin_of(j, w[k]) : NO_BIN;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (base + 32 * k < n)  // the same in every lane
        bad |= list_push<STATS>(L, i, base + 32 * k + lane, w[k], b[k], cnt,
                                lane);
  }
  if (lane == 0) L.len[i] = (uint16_t)cnt;
  return bad;
}

// row[i] = occ[i] * sum over row i's list of W[i][j] (1 - occ[j]) (see
// "Exact sparse sums"; `fast`: binary occupancy and finite W).
__device__ __forceinline__ float row_value(const Lists& L, int i,
                                           const float* occ,
                                           const uint32_t* vac, bool fast) {
  const float* v = L.val + (size_t)i * L.ldv;
  const uint16_t* c = L.col + (size_t)i * L.ldc;
  const int len = L.len[i];
  float out = 0.f;
  if (fast) {
#pragma unroll 4
    for (int m = 0; m < len; ++m) {
      const int j = c[m];
      if ((vac[j >> 5] >> (j & 31)) & 1u) out = out + v[m];
    }
  } else {
    for (int m = 0; m < len; ++m) out = out + v[m] * (1.0f - occ[c[m]]);
  }
  return occ[i] * out;
}

// sum_i row[i]: lane l adds rows l, l+32, ... in ascending i, then the xor
// butterfly.
__device__ inline float total_of(const float* row, int n, int lane) {
  float part = 0.f;
  for (int i = lane; i < n; i += 32) part = part + row[i];
  return warp_sum(part);
}

// The body of a sweep kernel: every replica of this block across all B
// frames. `stage(a, f, L, cur, extra, warp, lane)` writes W[f]'s lists into
// L (whose column lengths start at 0) after the frame's positions are in
// `cur`, between two block barriers, and returns nonzero if it met a W
// that is not finite. With STATS each warp's nbins counters, histogram and
// exposure follow the stage scratch.
template <int WARPS, bool STATS, bool TRI, class Stage>
__device__ __forceinline__ void sweep_block(const SweepArgs& a,
                                            const Stage& stage) {
  extern __shared__ float sm[];
  const int n = a.N;
  const int nw = (n + 31) / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s = sm;                 // [N, 3] site-displacement prefix sum
  float* cur = s + 3 * n;        // [N, 3] positions of this frame
  float* extra = cur + 3 * n;    // stage scratch
  // STATS: this warp's per-frame counters, histogram and exposure [nbins]
  int* wcnt = (int*)(extra + a.extra) + warp * 3 * a.nbins;
  int* whist = wcnt + a.nbins;
  float* wexpo = (float*)(whist + a.nbins);
  unsigned char* warps_base =
      (unsigned char*)(extra + a.extra + (STATS ? WARPS * 3 * a.nbins : 0));
  unsigned char* wb = warps_base + (size_t)warp * warp_smem_bytes(n);
  float* wocc = (float*)wb;                  // [N] this warp's occ
  float* wlab = wocc + n;                    // [N] labels
  float* wrow = wlab + n;                    // [N] rows (or row0)
  uint32_t* wvac = (uint32_t*)(wrow + n);    // vacancy bits
  uint32_t* wmark = wvac + nw;               // rows to sum again
  uint16_t* wlist = (uint16_t*)(wmark + nw);  // [N] sites
  const int cap = a.caps[0], ccap = a.caps[1];
  const size_t lb = list_bytes(n, cap, ccap, STATS);
  unsigned char* lp = warps_base + (size_t)WARPS * warp_smem_bytes(n);
  if (lb > a.list_budget) {
    if (!a.lists_global || lb > a.slice) __trap();  // the host sized them
    lp = a.lists_global + (size_t)blockIdx.x * a.slice;
  }
  const Lists L = lists_at(lp, n, cap, ccap, STATS);

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
    if (STATS)
      for (int b = lane; b < a.nbins; b += 32) {
        whist[b] = a.hist[(size_t)r * a.nbins + b];
        wexpo[b] = a.expo[(size_t)r * a.nbins + b];
      }
  }
  const float dt = a.dt;
  const CellImage cell =
      TRI ? a.cell : orthorhombic_image(a.box[0], a.box[1], a.box[2]);
  const unsigned below = (1u << lane) - 1u;

  for (int f = 0; f < a.B; ++f) {
    __syncthreads();  // every warp is done with the previous frame
    advance_prefix(s, cur, a.pos + (size_t)f * 3 * n, n, cell);
    for (int j = threadIdx.x; j < n; j += blockDim.x) L.clen[j] = 0;
    __syncthreads();
    const bool finite =
        !__syncthreads_or(stage(a, f, L, cur, extra, warp, lane));
    if (!active) continue;

    // the vacancy bits and whether every occupancy is 0 or 1
    bool binary = true;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const float o = i < n ? wocc[i] : 1.f;
      binary = binary && (o == 0.f || o == 1.f);
      const unsigned v = __ballot_sync(FULL_MASK, o == 0.f);
      if (lane == 0) wvac[base >> 5] = v;
    }
    binary = __all_sync(FULL_MASK, binary);
    __syncwarp();

    const int frame_idx = a.frame0 + f;
    const float frame_time = (float)frame_idx * dt;
    float phase = 0.f;
    bool done = false;
    if (binary && finite) {
      // the vacant columns in ascending order, each adding its nonzero
      // entries to their rows: every row gets its vacant terms in ascending
      // column, the order of its row sum
      int nv = 0;
      for (int base = 0; base < n; base += 32) {
        const int i = base + lane;
        const bool v = i < n && wocc[i] == 0.f;
        const unsigned m = __ballot_sync(FULL_MASK, v);
        if (v) wlist[nv + __popc(m & below)] = (uint16_t)i;
        nv += __popc(m);
        if (i < n) wrow[i] = 0.f;
      }
      __syncwarp();
      for (int k = 0; k < nv; ++k) {
        const int j = wlist[k];
        const uint16_t* rows = L.crow + (size_t)j * L.ldr;
        const float* vals = L.cval + (size_t)j * L.ldr;
        for (int e = lane; e < L.clen[j]; e += 32) wrow[rows[e]] += vals[e];
        __syncwarp();
      }
      for (int i = lane; i < n; i += 32)
        wrow[i] = wocc[i] != 0.f ? wocc[i] * wrow[i] : 0.f;
    } else {
      for (int i = lane; i < n; i += 32)
        wrow[i] = wocc[i] != 0.f || !finite
                      ? row_value(L, i, wocc, wvac, false)
                      : 0.f;
    }
    __syncwarp();
    float total = total_of(wrow, n, lane);
    const float total0 = total;

    for (int ev = 0; ev < a.max_events; ++ev) {
      // a replica that stopped firing stays done: its remaining iterations
      // are no-ops in the reference, so the warp leaves the loop
      float budget = (a.stale ? total0 : total) * (dt - phase);
      if (!(u <= budget && budget > 0.f)) {
        done = true;
        break;
      }
      // budget > 0 implies total > 0
      float eph = phase + u / (a.stale ? total0 : total);

      // source: exponential race over row_i / E1_i (E1 = 0 - log u01), the
      // sites of positive row first gathered in ascending order
      int nc = 0;
      for (int base = 0; base < n; base += 32) {
        const int i = base + lane;
        const bool c = i < n && (a.stale ? wrow[i] * wocc[i] : wrow[i]) > 0.f;
        const unsigned m = __ballot_sync(FULL_MASK, c);
        if (c) wlist[nc + __popc(m & below)] = (uint16_t)i;
        nc += __popc(m);
      }
      __syncwarp();
      uint32_t k1 = cmdlmc_mix_key(a.seed, tile_id, (uint32_t)frame_idx,
                                   (uint32_t)ev, 1u);
      float bv = -1.f;
      int bi = 0x7fffffff;
      for (int m = lane; m < nc; m += 32) {
        const int i = wlist[m];
        const float ri = a.stale ? wrow[i] * wocc[i] : wrow[i];
        const float v = ri / (0.0f - logf(cmdlmc_u01(k1, rin * (uint32_t)n + i)));
        if (v > bv) {
          bv = v;
          bi = i;
        }
      }
      warp_argmax(bv, bi);
      const int src = bv > 0.f ? bi : 0;

      // destination: race over W[src][j] (1 - occ_j) / E2_j on src's list
      uint32_t k2 = cmdlmc_mix_key(a.seed, tile_id, (uint32_t)frame_idx,
                                   (uint32_t)ev, 2u);
      const float* vs = L.val + (size_t)src * L.ldv;
      const uint16_t* cs = L.col + (size_t)src * L.ldc;
      const int len = L.len[src];
      bv = -1.f;
      bi = 0x7fffffff;
      for (int m = lane; m < len; m += 32) {
        const int j = cs[m];
        const float w2 = vs[m] * (1.0f - wocc[j]);
        if (w2 > 0.f) {
          const float v = w2 / (0.0f - logf(cmdlmc_u01(k2, rin * (uint32_t)n + j)));
          if (v > bv) {
            bv = v;
            bi = j;
          }
        }
      }
      warp_argmax(bv, bi);
      const int dst = bv > 0.f ? bi : 0;

      const float label = wlab[src];
      const float t_event = frame_time + eph;
      float jump[3] = {cur[dst * 3] - cur[src * 3],
                       cur[dst * 3 + 1] - cur[src * 3 + 1],
                       cur[dst * 3 + 2] - cur[src * 3 + 2]};
      cell.apply(jump[0], jump[1], jump[2]);
      float add[3];
      for (int dim = 0; dim < 3; ++dim)
        add[dim] = (s[src * 3 + dim] - s[dst * 3 + dim]) + jump[dim];
      __syncwarp();  // all lanes have read occ / labels / rows / the list
      if (lane == 0) {
        wocc[src] = wocc[src] - 1.0f;
        wocc[dst] = wocc[dst] + 1.0f;
        wlab[src] = 0.f;
        wlab[dst] = label;
        if (STATS && a.nbins > 0) {
          float sq = jump[0] * jump[0];
          sq = sq + jump[1] * jump[1];
          sq = sq + jump[2] * jump[2];
          const float d = sqrtf(sq);
          if (hist_in_range(a, d)) whist[hist_bin(a, d)] += 1;
        }
        if (STATS && a.jm) atomicAdd(a.jm + (size_t)src * n + dst, 1);
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
      for (int k = lane; k < nw; k += 32) wmark[k] = 0u;
      uint32_t k3 = cmdlmc_mix_key(a.seed, tile_id, (uint32_t)frame_idx,
                                   (uint32_t)ev, 3u);
      u = -logf(cmdlmc_u01(k3, rin));
      evc += 1;
      phase = eph;
      __syncwarp();  // occupancy and labels are written, the marks cleared
      if (a.stale) continue;

      // the rows the event changes: src, dst and the rows of their columns
      const float os = wocc[src], od = wocc[dst];
      binary = binary && (os == 0.f || os == 1.f) && (od == 0.f || od == 1.f);
      if (lane == 0) {
        wvac[src >> 5] = (wvac[src >> 5] & ~(1u << (src & 31))) |
                         ((os == 0.f ? 1u : 0u) << (src & 31));
        wvac[dst >> 5] = (wvac[dst >> 5] & ~(1u << (dst & 31))) |
                         ((od == 0.f ? 1u : 0u) << (dst & 31));
        atomicOr(wmark + (src >> 5), 1u << (src & 31));
        atomicOr(wmark + (dst >> 5), 1u << (dst & 31));
      }
      for (int e = 0; e < 2; ++e) {
        const int j = e ? dst : src;
        const uint16_t* rows = L.crow + (size_t)j * L.ldr;
        for (int m = lane; m < L.clen[j]; m += 32)
          atomicOr(wmark + (rows[m] >> 5), 1u << (rows[m] & 31));
      }
      __syncwarp();
      // the marked rows of empty sites are +0 at once, the others summed
      int nm = 0;
      for (int base = 0; base < n; base += 32) {
        const int i = base + lane;
        bool mk = (wmark[base >> 5] >> lane) & 1u;
        if (mk && finite && wocc[i] == 0.f) {
          wrow[i] = 0.f;
          mk = false;
        }
        const unsigned m = __ballot_sync(FULL_MASK, mk);
        if (mk) wlist[nm + __popc(m & below)] = (uint16_t)i;
        nm += __popc(m);
      }
      __syncwarp();
      for (int k = lane; k < nm; k += 32) {
        const int i = wlist[k];
        wrow[i] = row_value(L, i, wocc, wvac, binary && finite);
      }
      __syncwarp();
      total = total_of(wrow, n, lane);
    }
    if (!done) trn += 1;
    if (STATS && a.nbins > 0) {
      // the exposure under the post-event occupancy: the occupied rows in
      // ascending order, lane l walking the l-th, (l+32)-th, ... list,
      // loading four entries before it counts any
      for (int b = lane; b < a.nbins; b += 32) wcnt[b] = 0;
      int no = 0;
      for (int base = 0; base < n; base += 32) {
        const int i = base + lane;
        const bool o = i < n && wocc[i] != 0.f;
        const unsigned m = __ballot_sync(FULL_MASK, o);
        if (o) wlist[no + __popc(m & below)] = (uint16_t)i;
        no += __popc(m);
      }
      __syncwarp();
      for (int k = lane; k < no; k += 32) {
        const int i = wlist[k];
        const uint16_t* c = L.col + (size_t)i * L.ldc;
        const uint16_t* bn = L.bin + (size_t)i * L.ldc;
        const int len = L.len[i];
        for (int m = 0; m < len; m += 4) {
          uint16_t b[4];
          bool vac[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            b[q] = m + q < len ? bn[m + q] : NO_BIN;
            vac[q] = b[q] != NO_BIN && wocc[c[m + q]] == 0.f;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (vac[q]) atomicAdd(wcnt + b[q], 1);
        }
      }
      __syncwarp();
      for (int b = lane; b < a.nbins; b += 32) wexpo[b] = wexpo[b] + (float)wcnt[b];
      __syncwarp();
    }
    // frame end: the reference evaluates the rates of the final occupancy
    // again; `total` holds them (stale: the frame-start total)
    u = u - (a.stale ? total0 : total) * (dt - phase);
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
    if (STATS)
      for (int b = lane; b < a.nbins; b += 32) {
        a.hist[(size_t)r * a.nbins + b] = whist[b];
        a.expo[(size_t)r * a.nbins + b] = wexpo[b];
      }
  }
  if (blockIdx.x == 0) {
    for (int k = threadIdx.x; k < 3 * n; k += blockDim.x) {
      a.s_out[k] = s[k];
      a.prev_out[k] = cur[k];
    }
  }
}
