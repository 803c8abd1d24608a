// Kernel K1: the streamed-W KMC event loop (rows semantics).
//
// Replaces the TPU kernel cmdlmc_tpu/ops/kmc_sweep_streamed.py::_make_kernel
// (pallas_call at ops/kmc_sweep_streamed.py:628) with layout="rows", pack=1,
// every branch of it: orthorhombic and triclinic cells, the jump histogram
// and its exposure (`nbins`) and the jump matrix (`track_matrix`). The last
// two and the triclinic cell are the template options STATS and TRI of
// event_loop.cuh; the default entry point launches the kernel without them.
// One launch advances every replica through a whole block of frames; the
// frame loop runs inside the kernel, so replica state never leaves the SM
// between frames. The event loop itself is event_loop.cuh, shared with K3;
// K1's part is where W[f] comes from: stage 1 built it in global memory, and
// each frame the block reads it from L2, a warp per row and a lane per
// column, and keeps only its nonzero entries as the frame's lists.
//
// Where the time goes on the H100 (PERF.md, PR 7): a rate evaluation adds
// only the vacant terms of the occupied rows (P (N - P) c / (N - 1) terms, c
// the nonzeros per row: about 780 at the bench.py deployment, N=144, P=96,
// c = 24 on average and 38 at most, where the dense sum took N*N = 20736),
// and after an event only the rows it changes. What remains is each warp's
// chain of dependent steps (the two races draw a hash, a logf and a divide
// per candidate of positive rate), the lists' build per block and frame,
// and the frame-start barrier, at which every warp of a block waits for
// its slowest replica. A block is K1_WARPS = 32 replicas (one per warp):
// each block builds every frame's lists once for all its replicas, and on
// the H100 32 warps ran faster than 8 or 16 (PERF.md, PR 7). At 56
// registers a thread one block fills an SM's registers, so the block takes
// the whole opt-in shared memory; the lists (about 64 KB at the bench
// deployment) live there where they fit, in a global slice per block
// otherwise. The longest row and column are counted on the device by
// `list_caps_kernel` before the sweep, so the host never waits for them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "event_loop.cuh"

// Replicas (warps) per thread block.
#define K1_WARPS 32

// Compacts W[f] from global memory into the block's row lists (with STATS
// and nbins > 0, each entry's exposure bin from dist[f] beside it: the
// [B, N, N] distances are read once per block and frame, as W is).
template <bool STATS>
struct StreamW {
  __device__ int operator()(const SweepArgs& a, int f, const Lists& L,
                            const float* /*cur*/, float* /*extra*/, int warp,
                            int lane) const {
    const int n = a.N;
    const float* wg = a.w + (size_t)f * n * n;
    const float* dg = STATS && a.nbins > 0 ? a.dist + (size_t)f * n * n : nullptr;
    int bad = 0;
    for (int i = warp; i < n; i += K1_WARPS) {
      const float* wi = wg + (size_t)i * n;
      const float* di = dg ? dg + (size_t)i * n : nullptr;
      bad |= push_row<STATS>(
          L, i, n, lane, [&](int j) { return wi[j]; },
          [&](int j, float w) { return di ? entry_bin(a, w, di[j]) : NO_BIN; });
    }
    return bad;
  }
};

template <bool STATS, bool TRI>
__global__ void __launch_bounds__(K1_WARPS * 32, sweep_min_blocks(K1_WARPS))
    kmc_sweep_streamed_kernel(SweepArgs a) {
  sweep_block<K1_WARPS, STATS, TRI>(a, StreamW<STATS>());
}

static const void* k1_kernel(bool stats, bool tri) {
  if (stats)
    return tri ? (const void*)kmc_sweep_streamed_kernel<true, true>
               : (const void*)kmc_sweep_streamed_kernel<true, false>;
  return tri ? (const void*)kmc_sweep_streamed_kernel<false, true>
             : (const void*)kmc_sweep_streamed_kernel<false, false>;
}

// Floats of a block's fixed shared memory besides the prefix sum and the
// warps' arrays: STATS's counters, histograms and exposures, 3 nbins per
// warp.
static int k1_extra(bool stats, int nbins) {
  return stats ? K1_WARPS * 3 * nbins : 0;
}

// The nonzero entries (NaN included) of the longest row and of the longest
// column of W [B, N, N] into caps[0] and caps[1]: a warp per row, a thread
// per column.
__global__ void list_caps_kernel(const float* __restrict__ w, int B, int N,
                                 int* caps) {
  const int lane = threadIdx.x & 31;
  const long long rows = (long long)B * N;
  const long long g = (long long)blockIdx.x * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  if (g < rows) {
    const float* wi = w + g * N;
    int cnt = 0;
    for (int j = lane; j < N; j += 32) cnt += wi[j] != 0.f;
    cnt = __reduce_add_sync(FULL_MASK, cnt);
    if (lane == 0) raise_caps(caps, 0, cnt);
  }
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < rows) {
    const long long f = t / N, j = t % N;
    const float* wf = w + f * N * N;
    int cnt = 0;
    for (int i = 0; i < N; ++i) cnt += wf[(size_t)i * N + j] != 0.f;
    raise_caps(caps, 1, cnt);
  }
}

// Bytes of one block's row and column lists of `cap` and `ccap` entries
// (K1 and K3 alike), with the entries' exposure bins where `stats` (the
// kernels with jump statistics): the size of a global slice.
extern "C" long long cmdlmc_sweep_list_bytes(int N, int cap, int ccap,
                                             int stats) {
  return (long long)list_bytes(N, cap, ccap, stats != 0);
}

// K1's launch plan at N sites (`sweep_plan`) and how many of its blocks one
// SM holds, for the kernel with jump statistics (`stats`, `nbins` bins) and
// the triclinic cell (`tri`) or without them.
extern "C" int cmdlmc_kmc_sweep_streamed_plan(int N, int stats, int nbins,
                                              int tri, int device,
                                              long long* smem,
                                              long long* list_budget,
                                              int* blocks_per_sm) {
  CmdlmcDeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const void* k = k1_kernel(stats, tri);
  size_t bytes = 0, budget = 0;
  cudaError_t err = sweep_plan(k, N, K1_WARPS, k1_extra(stats, nbins), device,
                               &bytes, &budget);
  if (err != cudaSuccess) return (int)err;
  *smem = (long long)bytes;
  *list_budget = (long long)budget;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, K1_WARPS * 32, bytes);
}

// Counts W's longest row and column into caps [2] (int32, on the device) on
// `stream`, with no host wait.
extern "C" int cmdlmc_kmc_sweep_streamed_caps(const void* w, int B, int N,
                                              void* caps, void* stream,
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
  list_caps_kernel<<<(unsigned)blocks, threads, 0, s>>>((const float*)w, B, N,
                                                        (int*)caps);
  return (int)cudaGetLastError();
}

// One K1 launch: `caps` as counted by cmdlmc_kmc_sweep_streamed_caps;
// `lists` null, or `slice` bytes of global scratch per block for lists that
// do not fit in shared memory. `stats` picks the kernel with jump statistics
// (nbins > 0 or a jm; else the statistics' pointers are null): `dist`
// [B, N, N] (read where nbins > 0), `hist` [R, nbins] and `expo` [R, nbins]
// updated in place, `jm` an [N, N] int32 sum the fired jumps add to (or
// null), the histogram's range [lo, hi) and its bins per unit `scale`.
// `tri` picks the triclinic kernel: `geom18` holds the cell's h then h^-1
// (row-major) and the box lengths are unused; else `geom18` may be null.
extern "C" int cmdlmc_kmc_sweep_streamed(
    const void* w, const void* pos, const void* prev_in, const void* s_in,
    void* prev_out, void* s_out, void* occ, void* lab, void* sites,
    void* tlast, void* db, void* u, void* evc, void* trunc, int R, int N,
    int P, int B, int tile, int tile_offset, int frame0, int max_events,
    int stale, const void* caps, void* lists, long long slice, float dt,
    uint32_t seed, float lx, float ly, float lz, const void* dist, void* hist,
    void* expo, void* jm, int stats, int nbins, float lo, float hi,
    float scale, int tri, const float* geom18, void* stream, int device) {
  CmdlmcDeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  if (nbins < 0 || (nbins > 0 && (!stats || !dist || !hist || !expo)) ||
      (jm && !stats) || (tri && !geom18))
    return (int)cudaErrorInvalidValue;
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
  a.caps = (const int*)caps;
  a.lists_global = (unsigned char*)lists;
  a.slice = (size_t)slice;
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
  a.dist = (const float*)dist;
  a.hist = (int*)hist;
  a.expo = (float*)expo;
  a.jm = (int*)jm;
  a.nbins = stats ? nbins : 0;
  a.hist_lo = lo;
  a.hist_hi = hi;
  a.hist_scale = scale;
  if (tri) {
    for (int q = 0; q < 9; ++q) {
      a.cell.h[q] = geom18[q];
      a.cell.hinv[q] = geom18[9 + q];
    }
    a.cell.ortho = 0;
  }

  const void* k = k1_kernel(stats != 0, tri != 0);
  size_t smem = 0;
  err = sweep_plan(k, N, K1_WARPS, k1_extra(stats != 0, a.nbins), device,
                   &smem, &a.list_budget);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  return (int)cudaLaunchKernel(k, dim3((R + K1_WARPS - 1) / K1_WARPS),
                               dim3(K1_WARPS * 32), args, smem,
                               (cudaStream_t)stream);
}
