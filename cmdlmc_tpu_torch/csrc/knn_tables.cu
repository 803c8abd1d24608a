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
// One thread owns one column j: it scans the rows i in ascending order and
// keeps a sorted list of the KNN_KMAX nearest in registers, inserting with a
// strict `<`, so an equal distance never displaces a lower index; the first
// k entries are the k smallest (distance, index) pairs, as the JAX kernel's
// k passes of min and first-lowest argmin give them. Rows come through
// shared memory in tiles, read by every thread of the block at once
// (broadcast). Squared distances beyond cutoff + buffer skip the square
// root (kmc_common.cuh::sqrt_cut).
//
// Bound on the H100: operations. The least work per frame is N(N-1)/2
// minimum-image distances (d(i,j) = d(j,i); three divisions and three rintf
// each), a cutoff test each, and a compare per ordered pair to keep k of
// them; the bytes are the positions in and the [K, N] tables out,
// B*N*(12 + 8K) bytes, and nothing [N, N]-sized ever leaves the SM. This
// kernel evaluates every ordered pair, twice the distance work of the bound,
// so that no column's thread waits on another's; it spends nothing on the
// selection beyond a register insertion, taken only by pairs in range.
#include <cuda_runtime.h>
#include <math.h>

#include "device_guard.cuh"
#include "kmc_common.cuh"

#define KNN_KMAX 16     // the largest k (ops/topk_sweep.py MAX_K)
#define KNN_THREADS 128  // columns per thread block
#define KNN_ROWS 512    // rows per shared-memory tile

__global__ void __launch_bounds__(KNN_THREADS)
    knn_tables_kernel(const float* __restrict__ pos, int n, int k, float lx,
                      float ly, float lz, float acc_cut,
                      float* __restrict__ topd, int* __restrict__ topi) {
  __shared__ float rows[3 * KNN_ROWS];
  const int b = blockIdx.y;
  const int j = blockIdx.x * KNN_THREADS + threadIdx.x;
  const float* pb = pos + (size_t)b * n * 3;
  const bool col = j < n;
  float xj = 0.f, yj = 0.f, zj = 0.f;
  if (col) {
    xj = pb[3 * j];
    yj = pb[3 * j + 1];
    zj = pb[3 * j + 2];
  }
  float td[KNN_KMAX];
  int ti[KNN_KMAX];
#pragma unroll
  for (int s = 0; s < KNN_KMAX; ++s) {
    td[s] = INFINITY;
    ti[s] = 0;
  }
  for (int i0 = 0; i0 < n; i0 += KNN_ROWS) {
    const int m = n - i0 < KNN_ROWS ? n - i0 : KNN_ROWS;
    __syncthreads();
    for (int t = threadIdx.x; t < 3 * m; t += KNN_THREADS)
      rows[t] = pb[(size_t)3 * i0 + t];
    __syncthreads();
    if (!col) continue;
    for (int ii = 0; ii < m; ++ii) {
      const int i = i0 + ii;
      const float acc = minimg_sq(rows[3 * ii] - xj, rows[3 * ii + 1] - yj,
                                  rows[3 * ii + 2] - zj, lx, ly, lz);
      if (!(acc <= acc_cut) || i == j) continue;
      const float d = sqrtf(acc);
      if (!(d < td[KNN_KMAX - 1])) continue;
      // insert (d, i) after every entry <= d; walk down so each slot reads
      // its upper neighbour before that one is overwritten
#pragma unroll
      for (int s = KNN_KMAX - 1; s > 0; --s) {
        if (td[s] > d) {
          if (td[s - 1] > d) {
            td[s] = td[s - 1];
            ti[s] = ti[s - 1];
          } else {
            td[s] = d;
            ti[s] = i;
          }
        }
      }
      if (td[0] > d) {
        td[0] = d;
        ti[0] = i;
      }
    }
  }
  if (!col) return;
#pragma unroll
  for (int s = 0; s < KNN_KMAX; ++s) {
    if (s < k) {
      const bool hit = td[s] < INFINITY;
      const size_t o = ((size_t)b * k + s) * n + j;
      topd[o] = hit ? td[s] : 1.0e6f;
      topi[o] = hit ? ti[s] : 0;
    }
  }
}

extern "C" int cmdlmc_knn_tables(const void* pos, int batch, int n, int k,
                                 float lx, float ly, float lz, float cutbuf,
                                 void* topd, void* topi, void* stream,
                                 int device) {
  CmdlmcDeviceGuard guard(device);
  int err = (int)guard.err;
  if (err) return err;
  if (k < 1 || k > KNN_KMAX || n < 1) return (int)cudaErrorInvalidValue;
  const float acc_cut = sqrt_cut(cutbuf);
  // gridDim.y is capped at 65535 frames per launch
  for (int b0 = 0; b0 < batch; b0 += 65535) {
    const int nb = batch - b0 < 65535 ? batch - b0 : 65535;
    dim3 grid((n + KNN_THREADS - 1) / KNN_THREADS, nb);
    knn_tables_kernel<<<grid, KNN_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)pos + (size_t)b0 * n * 3, n, k, lx, ly, lz, acc_cut,
        (float*)topd + (size_t)b0 * k * n, (int*)topi + (size_t)b0 * k * n);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}
