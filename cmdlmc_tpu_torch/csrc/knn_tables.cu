// Kernel K5: the per-frame K-nearest tables of a block of frames
// (orthorhombic cells).
//
// Replaces the TPU kernel cmdlmc_tpu/ops/knn_tables.py::_knn_kernel
// (pallas_call at ops/knn_tables.py:122), for the whole block in one launch:
// for every frame b and column (site) j, topd[b][s][j] and topi[b][s][j] are
// the distance and index of the s-th nearest site i != j within
// cutoff + buffer, d = sqrtf((dx^2 + dy^2) + dz^2) with d = minimg(p_i - p_j).
// Ties go to the lower index; slots past the last neighbor in range hold
// index 0 and distance 1e6 (the exhausted-column rule of k_smallest).
//
// Two routes, picked by ops/knn_tables.py::cell_grid from the shapes alone:
//
// * The cell route. Each frame's sites are binned on the card with no host
//   wait (ops/knn_tables.py::cell_lists): knn_bin_kernel gives each site its
//   cell from its wrapped position in float64 and counts the cells; torch
//   sorts the sites by cell (stable; z fastest) and sums the counts into each
//   cell's first sorted index. One thread block per (frame,
//   pencil of cells along z); its threads take the pencil's sites (the
//   columns) in cell order, and each scans only the 27 cells around its
//   own: the block stages the 9 neighbouring pencils' rows through shared
//   memory, and each thread reads the three z cells of each that border its
//   own. With a finite cutoff a cell is wider than cutoff + buffer by a
//   margin (2^-12 of the cutoff and of the box length), so no pair in range
//   lies outside those 27 cells while the frame's positions lie within 256
//   box lengths of the origin (the float error of a minimum image stays
//   under 2^-13 box lengths there); a frame past that range (`ok` = 0,
//   checked on the card) is scanned in full. With no cutoff (the water
//   tables) the cells are sized from the density (1.5 times the radius
//   that holds k sites on average), and a column keeps its 27-cell result
//   only if its k-th distance lies below `thr`, the distance from the site
//   to the nearest face of its 3 x 3 x 3 block of cells less a margin for
//   float error: every site outside the block is then farther. A column that
//   fails the test is scanned in full (about 1e-4 of the columns at the
//   water deployments' density). The verified search was taken over the
//   full scan alone because it cuts the pairs 16-fold at N=1728 for that
//   rare rescan.
// * The full scan (fewer than 3 cells on an axis, or too few columns per
//   pencil to fill a warp's lanes): `split` adjacent lanes per column (1, 2,
//   4 or 8, so that a small block of frames still gives the card some 16
//   warps per SM) scan every row of the frame between them, the rows staged
//   through shared memory in tiles; the lanes then merge their lists by a
//   butterfly of shuffles.
//
// Both routes insert each row in range into a sorted register list ordered
// by (distance, index) (knn_before): the cell route meets the rows in cell
// order, not in index order, and the lexicographic order gives the tables
// the full scan's bits. The list holds KMAX = 4, 8 or 16 entries, the least
// of these >= k (a template): its first k entries are the k smallest pairs
// whatever its length. Each squared distance is kmc_common.cuh's
// minimg_sq order, (dx^2 + dy^2) + dz^2, with the minimum image's division
// replaced by a product with the reciprocal box length where that gives the
// same rintf (kmc_common.cuh::minimg_near); squared distances past cutoff +
// buffer skip the square root (kmc_common.cuh::sqrt_cut). So the tables
// equal the earlier one-thread-per-column full scan bit for bit on either
// route.
//
// Bound on the H100: operations. The least work is each unordered pair the
// frame needs (d(i,j) = d(j,i)): with a cutoff the pairs in neighbouring
// cells of width cutoff + buffer, with no cutoff every pair (the verified
// search's pairs where it runs), a distance and a test each, and a compare
// per ordered pair; the bytes are the positions in and the [K, N] tables
// out. The cell route spends the binning (a sort of B x N keys) and the 27
// cells of every column, about 27/C of the full scan's pairs for C cells.
//
// Numerics: build with --fmad=false and without fast math (kmc_common.cuh).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "device_guard.cuh"
#include "kmc_common.cuh"
#include "knn_common.cuh"

#define KNN_ROWS 512     // rows per shared-memory tile or staged chunk
#define KNN_THREADS 128  // threads per block of the full scan

// Every row i != j of the frame, in index order, read from global memory.
template <int KMAX>
__device__ void scan_all(KnnList<KMAX>& list, const KnnFrame& f,
                         const float* __restrict__ pb, int n, int j, float xj,
                         float yj, float zj) {
  for (int i = 0; i < n; ++i) {
    const float d = f.dist(__ldg(pb + 3 * i) - xj, __ldg(pb + 3 * i + 1) - yj,
                           __ldg(pb + 3 * i + 2) - zj);
    if (d >= 0.f && i != j) list.insert(d, i);
  }
}

template <int KMAX>
__global__ void __launch_bounds__(KNN_THREADS)
    knn_full_kernel(const float* __restrict__ pos, int n, int k, int split,
                    KnnFrame f, float* __restrict__ topd,
                    int* __restrict__ topi) {
  __shared__ float rows[3 * KNN_ROWS];
  const int b = blockIdx.y;
  const int slice = threadIdx.x % split;  // split: 1, 2, 4 or 8 lanes a column
  const int j = blockIdx.x * (KNN_THREADS / split) + threadIdx.x / split;
  const float* pb = pos + (size_t)b * n * 3;
  const bool col = j < n;
  float xj = 0.f, yj = 0.f, zj = 0.f;
  if (col) {
    xj = pb[3 * j];
    yj = pb[3 * j + 1];
    zj = pb[3 * j + 2];
  }
  KnnList<KMAX> list;
  list.clear();
  for (int i0 = 0; i0 < n; i0 += KNN_ROWS) {
    const int m = n - i0 < KNN_ROWS ? n - i0 : KNN_ROWS;
    __syncthreads();
    for (int t = threadIdx.x; t < 3 * m; t += KNN_THREADS)
      rows[t] = pb[(size_t)3 * i0 + t];
    __syncthreads();
    if (!col) continue;
    for (int ii = slice; ii < m; ii += split) {
      const float d = f.dist(rows[3 * ii] - xj, rows[3 * ii + 1] - yj,
                             rows[3 * ii + 2] - zj);
      if (d >= 0.f && i0 + ii != j) list.insert(d, i0 + ii);
    }
  }
  // the column's `split` lanes (adjacent, disjoint rows) merge their lists
  // by a butterfly: each inserts its partner's entries, so after log2(split)
  // rounds every one holds the KMAX smallest of the union
  for (int o = 1; o < split; o <<= 1) {
    float pd[KMAX];
    int pi[KMAX];
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      pd[s] = __shfl_xor_sync(FULL_MASK, list.d[s], o);
      pi[s] = __shfl_xor_sync(FULL_MASK, list.i[s], o);
    }
#pragma unroll
    for (int s = 0; s < KMAX; ++s) list.insert(pd[s], pi[s]);
  }
  if (col && slice == 0) list.store(k, n, b, j, topd, topi);
}

// The cell of every site of a block of frames, one thread a site, in the
// float64 arithmetic of ops/knn_tables.py::cell_lists: per axis the wrapped
// coordinate u = x - L floor(x / L) and c = min(max(floor(u (g / L)), 0),
// g - 1) (NaN: 0); cid = (cx ny + cy) nz + cz, and count[b][cid + 1] += 1
// (integer atomics: the counts do not depend on their order); bad[b] = 1
// where a coordinate is past `reach` (BIN_RANGE box lengths) or not
// finite. With `thr`, the verified search's bound: the distance to the
// nearest face of the site's 3 x 3 x 3 block of cells, times (1 - 2^-18),
// less `margin`, rounded down to float.
__global__ void knn_bin_kernel(const float* __restrict__ pos, int batch, int n,
                               double lx, double ly, double lz, int nx, int ny,
                               int nz, float reach, double margin,
                               int* __restrict__ cid, int* __restrict__ count,
                               int* __restrict__ bad, float* __restrict__ thr) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)batch * n) return;
  const int b = (int)(t / n);
  const float* p = pos + 3 * t;
  const double len[3] = {lx, ly, lz};
  const int g[3] = {nx, ny, nz};
  int c[3];
  double face = INFINITY;
  bool out = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    out = out || !(fabsf(p[a]) <= reach);
    const double x = (double)p[a];
    const double u = x - len[a] * floor(x / len[a]);
    double cc = floor(u * ((double)g[a] / len[a]));
    if (isnan(cc)) cc = 0.0;
    cc = fmin(fmax(cc, 0.0), (double)(g[a] - 1));
    c[a] = (int)cc;
    const double w = len[a] / (double)g[a];
    face = fmin(face, fmin(u - (cc - 1.0) * w, (cc + 2.0) * w - u));
  }
  const int id = (c[0] * ny + c[1]) * nz + c[2];
  cid[t] = id;
  atomicAdd(count + (size_t)b * (nx * ny * nz + 1) + id + 1, 1);
  if (out) atomicOr(bad + b, 1);
  if (thr) {
    const double bound = face * (1.0 - 0x1p-18) - margin;
    float v = (float)bound;
    if ((double)v > bound) v = nextafterf(v, -INFINITY);
    thr[t] = v;
  }
}

// The cell lists of one block of frames (ops/knn_tables.py::cell_lists).
struct KnnCells {
  const long long* order;  // [B, N] site ids sorted by cell (stable)
  const int* scell;        // [B, N] cell of each sorted site, (cx ny + cy) nz + cz
  const int* start;        // [B, C + 1] first sorted index of each cell
  const float* thr;        // [B, N] acceptance bound of each site, or null
  const int* bad;          // [B] 1 where a frame's positions leave the binned range
  int nx, ny, nz;
};

template <int KMAX>
__global__ void knn_cells_kernel(const float* __restrict__ pos, int n, int k,
                                 KnnFrame f, KnnCells c,
                                 float* __restrict__ topd,
                                 int* __restrict__ topi) {
  __shared__ float4 rows[KNN_ROWS];  // x, y, z, site id (bits)
  const int b = blockIdx.y, pencil = blockIdx.x;
  const int px = pencil / c.ny, py = pencil % c.ny, nz = c.nz;
  const int* st = c.start + (size_t)b * (c.nx * c.ny * nz + 1);
  const long long* order = c.order + (size_t)b * n;
  const float* pb = pos + (size_t)b * n * 3;
  const bool binned = c.bad[b] == 0;  // the same for the whole block
  const int col0 = st[pencil * nz], col1 = st[(pencil + 1) * nz];
  for (int g = col0; g < col1; g += blockDim.x) {
    const int q = g + threadIdx.x;
    const bool col = q < col1;
    int j = 0, cz = 0;
    float xj = 0.f, yj = 0.f, zj = 0.f;
    if (col) {
      j = (int)order[q];
      cz = c.scell[(size_t)b * n + q] % nz;
      xj = pb[3 * j];
      yj = pb[3 * j + 1];
      zj = pb[3 * j + 2];
    }
    KnnList<KMAX> list;
    list.clear();
    for (int p = 0; binned && p < 9; ++p) {
      const int qx = (px + p / 3 - 1 + c.nx) % c.nx;
      const int qy = (py + p % 3 - 1 + c.ny) % c.ny;
      const int base = (qx * c.ny + qy) * nz;
      const int r0 = st[base], r1 = st[base + nz];
      // this column's three cells of the pencil: z - 1, z, z + 1 (distinct,
      // nz >= 3), each a range of sorted rows
      int lo[3], hi[3];
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const int z = (cz + t - 1 + nz) % nz;
        lo[t] = st[base + z];
        hi[t] = st[base + z + 1];
      }
      for (int ch = r0; ch < r1; ch += KNN_ROWS) {
        const int m = r1 - ch < KNN_ROWS ? r1 - ch : KNN_ROWS;
        __syncthreads();  // every thread is done with the previous chunk
        for (int t = threadIdx.x; t < m; t += blockDim.x) {
          const int i = (int)order[ch + t];
          rows[t] = make_float4(pb[3 * i], pb[3 * i + 1], pb[3 * i + 2], __int_as_float(i));
        }
        __syncthreads();
        if (!col) continue;
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const int a = lo[t] > ch ? lo[t] : ch;
          const int e = hi[t] < ch + m ? hi[t] : ch + m;
          for (int r = a; r < e; ++r) {
            const float4 row = rows[r - ch];
            const int i = __float_as_int(row.w);
            const float d = f.dist(row.x - xj, row.y - yj, row.z - zj);
            if (d >= 0.f && i != j) list.insert(d, i);
          }
        }
      }
    }
    if (!col) continue;
    const bool kept = binned && (c.thr == nullptr ||
                                 list.kth(k) < c.thr[(size_t)b * n + j]);
    if (!kept) {  // the whole frame, in index order
      list.clear();
      scan_all(list, f, pb, n, j, xj, yj, zj);
    }
    list.store(k, n, b, j, topd, topi);
  }
}

static int knn_launch(const float* pos, int nb, int n, int k, KnnFrame f,
                      const KnnCells* c, int threads, int split, float* topd, int* topi,
                      cudaStream_t stream) {
  if (c) {
    const dim3 grid(c->nx * c->ny, nb);
    if (k <= 4)
      knn_cells_kernel<4><<<grid, threads, 0, stream>>>(pos, n, k, f, *c, topd, topi);
    else if (k <= 8)
      knn_cells_kernel<8><<<grid, threads, 0, stream>>>(pos, n, k, f, *c, topd, topi);
    else
      knn_cells_kernel<16><<<grid, threads, 0, stream>>>(pos, n, k, f, *c, topd, topi);
  } else {
    const int cols = KNN_THREADS / split;
    const dim3 grid((n + cols - 1) / cols, nb);
    if (k <= 4)
      knn_full_kernel<4><<<grid, KNN_THREADS, 0, stream>>>(pos, n, k, split, f, topd, topi);
    else if (k <= 8)
      knn_full_kernel<8><<<grid, KNN_THREADS, 0, stream>>>(pos, n, k, split, f, topd, topi);
    else
      knn_full_kernel<16><<<grid, KNN_THREADS, 0, stream>>>(pos, n, k, split, f, topd, topi);
  }
  return (int)cudaGetLastError();
}

// The cell lists' first pass (knn_bin_kernel) into cid [B, N], count
// [B, C + 1] and bad [B] (both zeroed by the caller) and, with thr, the
// verified search's bounds [B, N].
extern "C" int cmdlmc_knn_bin(const void* pos, int batch, int n, double lx,
                              double ly, double lz, int nx, int ny, int nz,
                              float reach, double margin, void* cid, void* count,
                              void* bad, void* thr, void* stream, int device) {
  CmdlmcDeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (n < 1 || nx < 1 || ny < 1 || nz < 1) return (int)cudaErrorInvalidValue;
  const long long sites = (long long)batch * n;
  if (sites == 0) return 0;
  knn_bin_kernel<<<(unsigned)((sites + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)pos, batch, n, lx, ly, lz, nx, ny, nz, reach, margin, (int*)cid,
      (int*)count, (int*)bad, (float*)thr);
  return (int)cudaGetLastError();
}

// order ... bad: the cell lists (all null for the full scan); nx, ny, nz:
// the cell grid; threads: the cell route's block width; split: the full
// scan's lanes per column (1, 2, 4 or 8).
extern "C" int cmdlmc_knn_tables(const void* pos, int batch, int n, int k,
                                 float lx, float ly, float lz, float cutbuf,
                                 const void* order, const void* scell,
                                 const void* start, const void* thr,
                                 const void* bad, int nx, int ny, int nz,
                                 int threads, int split, void* topd, void* topi,
                                 void* stream, int device) {
  CmdlmcDeviceGuard guard(device);
  int err = (int)guard.err;
  if (err) return err;
  const bool cells = order != nullptr;
  if (k < 1 || k > 16 || n < 1 || threads < 32 || threads > 1024 || threads % 32 ||
      (split != 1 && split != 2 && split != 4 && split != 8) ||
      (cells && (nx < 3 || ny < 3 || nz < 3 || !scell || !start || !bad)))
    return (int)cudaErrorInvalidValue;
  const KnnFrame f = {lx, ly, lz, 1.0f / lx, 1.0f / ly, 1.0f / lz, sqrt_cut(cutbuf)};
  const int C = nx * ny * nz;
  // gridDim.y is capped at 65535 frames per launch
  for (int b0 = 0; b0 < batch; b0 += 65535) {
    const int nb = batch - b0 < 65535 ? batch - b0 : 65535;
    KnnCells c = {};
    if (cells) {
      c.order = (const long long*)order + (size_t)b0 * n;
      c.scell = (const int*)scell + (size_t)b0 * n;
      c.start = (const int*)start + (size_t)b0 * (C + 1);
      c.thr = thr ? (const float*)thr + (size_t)b0 * n : nullptr;
      c.bad = (const int*)bad + b0;
      c.nx = nx;
      c.ny = ny;
      c.nz = nz;
    }
    err = knn_launch((const float*)pos + (size_t)b0 * n * 3, nb, n, k, f,
                     cells ? &c : nullptr, threads, split,
                     (float*)topd + (size_t)b0 * k * n,
                     (int*)topi + (size_t)b0 * k * n, (cudaStream_t)stream);
    if (err) return err;
  }
  return 0;
}
