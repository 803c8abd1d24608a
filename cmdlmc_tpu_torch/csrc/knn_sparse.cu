// Kernel K6: the per-frame K-nearest tables of a block of frames over a
// spatial plan (orthorhombic cells), equal to K5's bit for bit, and the
// kernels that build that plan on the card.
//
// Replaces the TPU kernel cmdlmc_tpu/ops/knn_sparse.py::_sparse_kernel
// (pallas_call at ops/knn_sparse.py:293).
//
// The plan (ops/knn_sparse.py::device_plan; its plain version
// device_plan_reference gives the same integers) sorts the sites of frame 0
// along a serpentine through their bin columns (bins at least cutoff +
// buffer wide in x and y, the cells of K5's cell route; 1024 steps in z),
// so that `tc` consecutive sorted sites (a column tile, 32) and `rc` of them
// (a row chunk, 16) are short pencils one bin wide with no jump across the
// box (PERF.md compares the kept pairs of other orders); it lists
// for each tile the chunks whose periodic bounding boxes, widened by each
// site's largest drift over the block, come within cutoff + buffer (plus a
// margin for float error) of the tile's, in ascending order, with their
// count. One call, six launches, no host wait:
//   sparse_site_kernel   each site's sort key, its frame-0 wrapped position
//                        less and plus its drift (its box), and the count of
//                        each bin column's sites;
//   sparse_scan_kernel   each column's first sorted position (one block);
//   sparse_bucket_kernel each column's sites, in no fixed order;
//   sparse_rank_kernel   each site's rank by (key, id) within its column:
//                        the permutation of a stable sort by key, and its
//                        inverse (a site compares with its column's ~76
//                        sites at the box x4 supercell);
//   sparse_box_kernel    each chunk's and tile's box (one warp each);
//   sparse_list_kernel   each tile's kept chunks (one warp each: a ballot and
//                        a prefix over 32 chunks at a time) and their count.
// A block whose positions leave the range the margin covers (256 box lengths
// from the origin) or are not finite keeps every chunk for every tile.
//
// The tables (knn_sparse_kernel): one block per (frame, 32 columns of a
// tile), `splits` warps, one lane per column of the sorted order. The warps
// divide the tile's kept chunks between them (warp s takes the list's
// entries s, s + splits, ...) and each walks its own through a two-slot ring
// of 32 rows in shared memory: cp.async brings the next piece's positions
// while the warp computes this piece's distances, so the block never waits
// at a barrier before its merge. Each lane keeps a sorted register list of
// the KMAX nearest rows by (distance, site id) (knn_common.cuh: rows arrive
// in the plan's order, not in id order, so an equal distance compares the ids),
// and at the end the warps' lists are merged through shared memory in the
// same order. The first k entries are written at the column's site id:
// (1e6, 0) where the list ran out. Distances are K5's bits (knn_common.cuh::
// KnnFrame: the sum order, sqrt_cut and kmc_common.cuh::minimg_near, which
// gives minimg's bits and divides only within a few ulps of a
// half-integer), so the tables equal K5's in every distance and index. The
// host picks `splits` (1-8) so that a Verlet rebuild's single frame (288
// column warps at N=9216) still puts some 16 warps on each of the 132 SMs.
//
// Bound on the H100: operations. The least work is the distance of every
// (column, row) pair the plan keeps (the minimum images, the squares, the
// cutoff test, a square root for the pairs in range) and a compare to keep k
// of them; the bytes, the positions in and the [K, N] tables out, are far
// less. The design spends nothing on the chunks the plan leaves out, and
// small tiles and chunks keep the boxes, and so the kept pairs, few.
//
// Numerics: build with --fmad=false and without fast math (kmc_common.cuh).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "kmc_common.cuh"
#include "knn_common.cuh"

#define SPARSE_MAX_SPLITS 8
#define SPARSE_Z_STEPS 1024  // the fine z steps of the sort key
#define SPARSE_MAX_BINS 256  // bins in x and in y at most

// ---------------------------------------------------------------------------
// The plan

// The serpentine key of a site in bin column (cx, cy) at fine z step cz
// (0 .. SPARSE_Z_STEPS - 1): rows of bins (cx, cy) in x-major order, y
// reversed on odd x, and z reversed on odd rows, so that consecutive keys
// are neighbours in space and a run of sorted sites is a short pencil.
__device__ __forceinline__ int serpentine_key(int cx, int cy, int cz, int gy) {
  const int row = cx * gy + ((cx & 1) ? gy - 1 - cy : cy);
  return row * SPARSE_Z_STEPS + ((row & 1) ? SPARSE_Z_STEPS - 1 - cz : cz);
}

// One thread per site j of the block [batch, n, 3]: the serpentine key of
// frame 0's bin column on the grid gx, gy and its fine z step (the float64
// binning of ops/knn_tables.py::cell_lists: u = x - L floor(x / L),
// c = min(max(floor(u (g / L)), 0), g - 1), NaN: 0; z on SPARSE_Z_STEPS
// steps); site_box[j] = (w - drift, w + drift) per axis, w = p - L
// floor(p / L) of frame 0 in float32 and drift the largest |p_f - p_0| over
// the frames; bad = 1 where a coordinate of any frame is past `reach` or not
// finite; start[row + 1] counts the sites of each bin column (row = key /
// SPARSE_Z_STEPS, integer atomics: the counts do not depend on their order).
__global__ void sparse_site_kernel(const float* __restrict__ pos, int batch, int n,
                                   double lx, double ly, double lz, int gx, int gy,
                                   float reach, int* __restrict__ key,
                                   int* __restrict__ start, float* __restrict__ site_box,
                                   int* __restrict__ bad) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const double len[3] = {lx, ly, lz};
  const int g[3] = {gx, gy, SPARSE_Z_STEPS};
  float p0[3], drift[3];
  int c[3];
  bool out = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    p0[a] = pos[3 * j + a];
    drift[a] = 0.f;
    out = out || !(fabsf(p0[a]) <= reach);
    const double x = (double)p0[a];
    const double u = x - len[a] * floor(x / len[a]);
    double cc = floor(u * ((double)g[a] / len[a]));
    if (isnan(cc)) cc = 0.0;
    cc = fmin(fmax(cc, 0.0), (double)(g[a] - 1));
    c[a] = (int)cc;
  }
  for (int f = 1; f < batch; ++f) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float q = pos[((size_t)f * n + j) * 3 + a];
      out = out || !(fabsf(q) <= reach);
      drift[a] = fmaxf(drift[a], fabsf(q - p0[a]));
    }
  }
  const int k = serpentine_key(c[0], c[1], c[2], gy);
  key[j] = k;
  atomicAdd(start + k / SPARSE_Z_STEPS + 1, 1);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float L = (float)len[a];
    const float w = p0[a] - floorf(p0[a] / L) * L;
    site_box[6 * j + a] = w - drift[a];
    site_box[6 * j + 3 + a] = w + drift[a];
  }
  if (out) atomicOr(bad, 1);
}

// One block: start[0 .. rows] from the column counts in start[1 .. rows]
// (start[0] = 0) to each column's first sorted position, a running sum in
// chunks of the block's width, and cursor[r] = start[r].
__global__ void sparse_scan_kernel(int* __restrict__ start, int* __restrict__ cursor,
                                   int rows) {
  __shared__ int part[32];
  const int t = threadIdx.x, lane = t % 32, w = t / 32;
  int carry = 0;
  for (int r0 = 0; r0 < rows; r0 += blockDim.x) {
    const int r = r0 + t;
    int v = r < rows ? start[r + 1] : 0;
    for (int o = 1; o < 32; o <<= 1) {  // inclusive sum within the warp
      const int u = __shfl_up_sync(FULL_MASK, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) part[w] = v;
    __syncthreads();
    if (w == 0) {
      int q = lane < (int)blockDim.x / 32 ? part[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL_MASK, q, o);
        if (lane >= o) q += u;
      }
      part[lane] = q;
    }
    __syncthreads();
    v += carry + (w > 0 ? part[w - 1] : 0);
    if (r < rows) start[r + 1] = v;
    carry += part[blockDim.x / 32 - 1];
    __syncthreads();  // part is rewritten by the next chunk
  }
  for (int r = t; r < rows; r += blockDim.x) cursor[r] = start[r];
}

// One thread per site: its slot among its bin column's sites (in no fixed
// order: an atomic cursor), bucket[slot] = j.
__global__ void sparse_bucket_kernel(const int* __restrict__ key, int n,
                                     int* __restrict__ cursor, int* __restrict__ bucket) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n) bucket[atomicAdd(cursor + key[j] / SPARSE_Z_STEPS, 1)] = j;
}

// One thread per site j: its sorted position, its column's start plus the
// sites of the column before it in (key, id) order, which is where a stable
// sort by key puts it; perm[position] = j and inv[j] = position.
__global__ void sparse_rank_kernel(const int* __restrict__ key, int n,
                                   const int* __restrict__ start,
                                   const int* __restrict__ bucket, int* __restrict__ perm,
                                   int* __restrict__ inv) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int kj = key[j], row = kj / SPARSE_Z_STEPS;
  const int q0 = start[row], q1 = start[row + 1];
  int q = q0;
  for (int a = q0; a < q1; ++a) {
    const int i = bucket[a];
    const int ki = key[i];
    q += ki < kj || (ki == kj && i < j);
  }
  perm[q] = j;
  inv[j] = q;
}

// One warp per chunk (blocks 0 .. n_ch - 1: sorted sites [b rc, (b + 1) rc))
// and per tile (the next n_ct blocks, tc sites each): the box's center and
// half-width per axis, (lo + hi) / 2 and (hi - lo) / 2 of the sites' boxes.
__global__ void sparse_box_kernel(const int* __restrict__ perm, int n, int rc, int tc,
                                  int n_ch, const float* __restrict__ site_box,
                                  float* __restrict__ boxes) {
  const int blk = blockIdx.x, lane = threadIdx.x;
  const bool chunk = blk < n_ch;
  const int step = chunk ? rc : tc;
  const int q0 = (chunk ? blk : blk - n_ch) * step;
  const int q1 = q0 + step < n ? q0 + step : n;
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int q = q0 + lane; q < q1; q += 32) {
    const int i = perm[q];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], site_box[6 * i + a]);
      hi[a] = fmaxf(hi[a], site_box[6 * i + 3 + a]);
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    for (int o = 16; o > 0; o >>= 1) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(FULL_MASK, lo[a], o));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(FULL_MASK, hi[a], o));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      boxes[6 * blk + a] = (lo[a] + hi[a]) * 0.5f;
      boxes[6 * blk + 3 + a] = (hi[a] - lo[a]) * 0.5f;
    }
  }
}

// One warp per tile t: chunk c is kept where the boxes' periodic gap,
// g = max((min(d, L - d) - half_c) - half_t, 0) per axis with d the centers'
// distance, has (g_x^2 + g_y^2) + g_z^2 <= cut2 (every chunk where bad).
// lists[t] = the kept chunks in ascending order, then n_ch to the row's end;
// count[t] = how many were kept.
__global__ void sparse_list_kernel(const float* __restrict__ boxes, int n_ch, int n_ct,
                                   float lx, float ly, float lz, float cut2,
                                   const int* __restrict__ bad, int* __restrict__ lists,
                                   int* __restrict__ count) {
  const int t = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (t >= n_ct) return;
  const float* tb = boxes + 6 * (size_t)(n_ch + t);
  const float len[3] = {lx, ly, lz};
  const bool all = *bad != 0;
  int* row = lists + (size_t)t * n_ch;
  int kept = 0;
  for (int c0 = 0; c0 < n_ch; c0 += 32) {
    const int c = c0 + lane;
    bool keep = false;
    if (c < n_ch) {
      const float* cb = boxes + 6 * (size_t)c;
      float g[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float d = fabsf(tb[a] - cb[a]);
        d = fminf(d, len[a] - d);
        g[a] = fmaxf((d - cb[3 + a]) - tb[3 + a], 0.f);
      }
      float acc = g[0] * g[0] + g[1] * g[1];
      acc = acc + g[2] * g[2];
      keep = all || acc <= cut2;
    }
    const unsigned votes = __ballot_sync(FULL_MASK, keep);
    if (keep) row[kept + __popc(votes & ((1u << lane) - 1u))] = c;
    kept += __popc(votes);
  }
  for (int p = kept + lane; p < n_ch; p += 32) row[p] = n_ch;
  if (lane == 0) count[t] = kept;
}

// ---------------------------------------------------------------------------
// The tables

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for every committed group of this thread but the newest.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct SparsePlanArgs {
  const int* perm;   // [n] sorted position -> site id
  const int* lists;  // [n_ct, width] each tile's kept chunks, ascending
  const int* count;  // [n_ct] the kept chunks of each tile
  int width, n_ch, rc, tc, splits;
};

// Stage piece p of this warp's chunks (32 rows at most) into `slot`: lane l
// copies row l's x, y, z with cp.async and writes its site id. Returns the
// piece's rows.
__device__ __forceinline__ int stage_piece(float4* slot, const float* __restrict__ pb,
                                           const int* __restrict__ mine, int stride,
                                           int per_chunk, int p, int n,
                                           const SparsePlanArgs& a, int lane) {
  const int ch = mine[(size_t)stride * (p / per_chunk)];
  const int q0 = ch * a.rc + (p % per_chunk) * 32;
  const int end = ch * a.rc + a.rc < n ? ch * a.rc + a.rc : n;
  const int m = end - q0 < 32 ? end - q0 : 32;
  if (lane < m) {
    const int i = a.perm[q0 + lane];
    const float* src = pb + 3 * (size_t)i;
    cp_async4(&slot[lane].x, src);
    cp_async4(&slot[lane].y, src + 1);
    cp_async4(&slot[lane].z, src + 2);
    slot[lane].w = __int_as_float(i);
  }
  return m;
}

template <int KMAX>
__global__ void __launch_bounds__(32 * SPARSE_MAX_SPLITS)
    knn_sparse_kernel(const float* __restrict__ pos, int n, int k, KnnFrame f,
                      SparsePlanArgs a, float* __restrict__ topd,
                      int* __restrict__ topi) {
  extern __shared__ float4 smem[];  // [splits][2][32] ring, then the merge
  const int b = blockIdx.y;
  const int warps_per_tile = a.tc / 32;
  const int tile = blockIdx.x / warps_per_tile;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = tile * a.tc + (blockIdx.x % warps_per_tile) * 32 + lane;
  const float* pb = pos + (size_t)b * n * 3;
  const bool col = c < n;
  int j = -1;
  float xj = 0.f, yj = 0.f, zj = 0.f;
  if (col) {
    j = a.perm[c];
    xj = pb[3 * j];
    yj = pb[3 * j + 1];
    zj = pb[3 * j + 2];
  }
  KnnList<KMAX> list;
  list.clear();
  // this warp's chunks: entries w, w + splits, ... of the tile's list
  const int kept = a.count[tile];
  const int mine_n = w < kept ? (kept - w + a.splits - 1) / a.splits : 0;
  const int per_chunk = (a.rc + 31) / 32;
  const int pieces = mine_n * per_chunk;
  const int* mine = a.lists + (size_t)tile * a.width + w;
  float4* ring = smem + (size_t)w * 64;
  int m_next = 0;
  if (pieces > 0) m_next = stage_piece(ring, pb, mine, a.splits, per_chunk, 0, n, a, lane);
  cp_async_commit();
  for (int p = 0; p < pieces; ++p) {
    const int m = m_next;
    float4* slot = ring + 32 * (p & 1);
    if (p + 1 < pieces)
      m_next = stage_piece(ring + 32 * ((p + 1) & 1), pb, mine, a.splits, per_chunk,
                           p + 1, n, a, lane);
    cp_async_commit();  // possibly empty: one group per piece
    cp_async_wait_prior();
    __syncwarp();  // every lane's copies and ids of piece p have landed
    if (col) {
#pragma unroll 4
      for (int r = 0; r < m; ++r) {
        const float4 e = slot[r];
        const int i = __float_as_int(e.w);
        const float d = f.dist(e.x - xj, e.y - yj, e.z - zj);
        if (d >= 0.f && i != j) list.insert(d, i);
      }
    }
    __syncwarp();  // every lane is done with the slot before it is refilled
  }
  if (a.splits > 1) {
    // the warps' lists, merged into warp 0's in (distance, id) order
    float* md = (float*)(smem + (size_t)a.splits * 64);
    int* mi = (int*)(md + (size_t)(a.splits - 1) * KMAX * 32);
    if (w > 0) {
#pragma unroll
      for (int s = 0; s < KMAX; ++s) {
        md[((size_t)(w - 1) * KMAX + s) * 32 + lane] = list.d[s];
        mi[((size_t)(w - 1) * KMAX + s) * 32 + lane] = list.i[s];
      }
    }
    __syncthreads();
    if (w > 0) return;
    for (int o = 0; o < a.splits - 1; ++o) {
#pragma unroll
      for (int s = 0; s < KMAX; ++s)
        list.insert(md[((size_t)o * KMAX + s) * 32 + lane],
                    mi[((size_t)o * KMAX + s) * 32 + lane]);
    }
  }
  if (col) list.store(k, n, b, j, topd, topi);
}

static size_t sparse_smem(int splits, int kmax) {
  return (size_t)splits * 64 * sizeof(float4) +
         (size_t)(splits - 1) * kmax * 32 * (sizeof(float) + sizeof(int));
}

// The plan of a block [batch, n, 3] (sparse_site_kernel, the sort,
// sparse_box_kernel, sparse_list_kernel): perm and inv [n], count [n_ct],
// lists [n_ct, n_ch] (int32); the bins gx x gy (each at most
// SPARSE_MAX_BINS); scratch: int [2 n + 2 gx gy + 2], float
// [6 (n + n_ch + n_ct)].
extern "C" int cmdlmc_sparse_plan(const void* pos, int batch, int n, double lx,
                                  double ly, double lz, int gx, int gy, float reach,
                                  int rc, int tc, float cut2, void* perm, void* inv,
                                  void* count, void* lists, void* scratch,
                                  void* fscratch, void* stream, int device) {
  CmdlmcDeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (batch < 1 || n < 1 || rc < 1 || tc < 1 || gx < 1 || gy < 1 ||
      gx > SPARSE_MAX_BINS || gy > SPARSE_MAX_BINS)
    return (int)cudaErrorInvalidValue;
  const int rows = gx * gy;
  const int n_ch = (n + rc - 1) / rc, n_ct = (n + tc - 1) / tc;
  int* key = (int*)scratch;
  int* bucket = key + n;
  int* start = bucket + n;      // rows + 1
  int* bad = start + rows + 1;  // 1
  int* cursor = bad + 1;        // rows
  float* site_box = (float*)fscratch;
  float* boxes = site_box + 6 * (size_t)n;
  const cudaStream_t s = (cudaStream_t)stream;
  int err = (int)cudaMemsetAsync(start, 0, (rows + 2) * sizeof(int), s);  // and bad
  if (err) return err;
  const int sites = (n + 255) / 256;
  sparse_site_kernel<<<sites, 256, 0, s>>>((const float*)pos, batch, n, lx, ly, lz, gx,
                                           gy, reach, key, start, site_box, bad);
  sparse_scan_kernel<<<1, 1024, 0, s>>>(start, cursor, rows);
  sparse_bucket_kernel<<<sites, 256, 0, s>>>(key, n, cursor, bucket);
  sparse_rank_kernel<<<sites, 256, 0, s>>>(key, n, start, bucket, (int*)perm, (int*)inv);
  sparse_box_kernel<<<n_ch + n_ct, 32, 0, s>>>((const int*)perm, n, rc, tc, n_ch, site_box,
                                              boxes);
  sparse_list_kernel<<<(n_ct + 3) / 4, 128, 0, s>>>(boxes, n_ch, n_ct, (float)lx,
                                                    (float)ly, (float)lz, cut2, bad,
                                                    (int*)lists, (int*)count);
  return (int)cudaGetLastError();
}

// The tables over a plan: perm [n], lists [n_ct, width] and count [n_ct]
// (int32, on the card); rc rows a chunk, tc (a multiple of 32) columns a
// tile; `splits` warps (1, 2, 4 or 8) share each 32 columns of a tile.
extern "C" int cmdlmc_knn_sparse(const void* pos, int batch, int n, int k, float lx,
                                 float ly, float lz, float cutbuf, const void* perm,
                                 const void* lists, const void* count, int width,
                                 int n_ch, int n_ct, int rc, int tc, int splits,
                                 void* topd, void* topi, void* stream, int device) {
  CmdlmcDeviceGuard guard(device);
  int err = (int)guard.err;
  if (err) return err;
  if (k < 1 || k > 16 || n < 1 || tc < 32 || tc > 1024 || tc % 32 || rc < 1 ||
      width < 0 || (splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
      (long long)n_ct * tc < n || (long long)n_ch * rc < n)
    return (int)cudaErrorInvalidValue;
  const KnnFrame f = {lx, ly, lz, 1.0f / lx, 1.0f / ly, 1.0f / lz, sqrt_cut(cutbuf)};
  const SparsePlanArgs a = {(const int*)perm, (const int*)lists, (const int*)count,
                            width, n_ch, rc, tc, splits};
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned cols = (unsigned)n_ct * (unsigned)(tc / 32);
  // gridDim.y is capped at 65535 frames per launch
  for (int b0 = 0; b0 < batch; b0 += 65535) {
    const int nb = batch - b0 < 65535 ? batch - b0 : 65535;
    const dim3 grid(cols, nb);
    const float* pb = (const float*)pos + (size_t)b0 * n * 3;
    float* dout = (float*)topd + (size_t)b0 * k * n;
    int* iout = (int*)topi + (size_t)b0 * k * n;
    if (k <= 4)
      knn_sparse_kernel<4><<<grid, 32 * splits, sparse_smem(splits, 4), s>>>(
          pb, n, k, f, a, dout, iout);
    else if (k <= 8)
      knn_sparse_kernel<8><<<grid, 32 * splits, sparse_smem(splits, 8), s>>>(
          pb, n, k, f, a, dout, iout);
    else
      knn_sparse_kernel<16><<<grid, 32 * splits, sparse_smem(splits, 16), s>>>(
          pb, n, k, f, a, dout, iout);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}
