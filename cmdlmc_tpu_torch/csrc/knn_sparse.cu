// Kernel K6: the per-frame K-nearest tables of a block of frames over a
// spatial plan (orthorhombic cells), equal to K5's bit for bit.
//
// Replaces the TPU kernel cmdlmc_tpu/ops/knn_sparse.py::_sparse_kernel
// (pallas_call at ops/knn_sparse.py:293). The host plan (ops/knn_sparse.py,
// copied from the JAX package) sorts the sites by spatial bin (`perm`: sorted
// position -> site id), cuts the sorted order into column tiles of `tc` and
// row chunks of `rc` sites, and lists for each tile the chunks that can hold
// a neighbor within cutoff + buffer of its columns in any frame of the block
// (`lists` [n_tiles, maxa], padded with n_chunks after the real entries).
// Pairs in the chunks it leaves out lie beyond cutoff + buffer, which K5
// masks anyway.
//
// One thread block per (frame, column tile), one thread per column of the
// sorted order. The block walks its tile's chunks: it stages the chunk's
// positions and site ids in shared memory, and each thread inserts every
// in-range row into a sorted register list of the KMAX nearest, ordered
// lexicographically by (distance, site id): rows arrive in bin order, not in
// id order, so an equal distance must compare the ids (K5 sees rows in id
// order and gets the same order from a strict `<` on the distance). The
// first k entries are written at the column's site id: (1e6, 0) where the
// list ran out. The distance is K5's, kmc_common.cuh::minimg_sq of row minus
// column, sqrtf, self and squared distances past sqrt_cut(cutoff + buffer)
// masked, so K6 equals K5 in every distance and index.
//
// Bound on the H100: operations. The least work is the distance of every
// (column, row) pair the plan keeps (the minimum images, the squares, the
// cutoff test, a square root for the pairs in range) and a compare to keep k
// of them; the bytes, the positions in and the [K, N] tables out, are far
// less. The design spends nothing on the pairs the plan leaves out: the chunk
// list is read in the block, and pruned chunks are never staged.
//
// Numerics: build with --fmad=false and without fast math (kmc_common.cuh).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "device_guard.cuh"
#include "kmc_common.cuh"

// (d1, i1) < (d2, i2) lexicographically
__device__ inline bool knn_before(float d1, int i1, float d2, int i2) {
  return d1 < d2 || (d1 == d2 && i1 < i2);
}

template <int KMAX>
__global__ void knn_sparse_kernel(const float* __restrict__ pos, int n, int k,
                                  float lx, float ly, float lz, float acc_cut,
                                  const int* __restrict__ perm,
                                  const int* __restrict__ lists, int maxa,
                                  int n_ch, int rc, float* __restrict__ topd,
                                  int* __restrict__ topi) {
  extern __shared__ float4 rows[];  // [rc]: x, y, z, site id (bits)
  const int b = blockIdx.y, tile = blockIdx.x;
  const float* pb = pos + (size_t)b * n * 3;
  const int c = tile * blockDim.x + threadIdx.x;  // column in sorted order
  const bool col = c < n;
  const int j = col ? perm[c] : -1;
  float xj = 0.f, yj = 0.f, zj = 0.f;
  if (col) {
    xj = pb[3 * j];
    yj = pb[3 * j + 1];
    zj = pb[3 * j + 2];
  }
  float td[KMAX];
  int ti[KMAX];
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    td[s] = INFINITY;
    ti[s] = INT_MAX;
  }
  for (int a = 0; a < maxa; ++a) {
    const int ch = lists[(size_t)tile * maxa + a];
    if (ch >= n_ch) break;  // padding (the same for the whole block)
    const int q0 = ch * rc;
    const int m = n - q0 < rc ? n - q0 : rc;
    __syncthreads();  // every thread is done with the previous chunk
    for (int t = threadIdx.x; t < m; t += blockDim.x) {
      const int i = perm[q0 + t];
      rows[t] = make_float4(pb[3 * i], pb[3 * i + 1], pb[3 * i + 2],
                            __int_as_float(i));
    }
    __syncthreads();
    if (!col) continue;
    for (int q = 0; q < m; ++q) {
      const float4 e = rows[q];
      const int i = __float_as_int(e.w);
      const float acc = minimg_sq(e.x - xj, e.y - yj, e.z - zj, lx, ly, lz);
      if (!(acc <= acc_cut) || i == j) continue;
      const float d = sqrtf(acc);
      if (!knn_before(d, i, td[KMAX - 1], ti[KMAX - 1])) continue;
      // insert (d, i) after every entry before it; walk down so each slot
      // reads its upper neighbour before that one is overwritten
#pragma unroll
      for (int s = KMAX - 1; s > 0; --s) {
        if (knn_before(d, i, td[s], ti[s])) {
          if (knn_before(d, i, td[s - 1], ti[s - 1])) {
            td[s] = td[s - 1];
            ti[s] = ti[s - 1];
          } else {
            td[s] = d;
            ti[s] = i;
          }
        }
      }
      if (knn_before(d, i, td[0], ti[0])) {
        td[0] = d;
        ti[0] = i;
      }
    }
  }
  if (!col) return;
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    if (s < k) {
      const bool hit = td[s] < INFINITY;
      const size_t o = ((size_t)b * k + s) * n + j;
      topd[o] = hit ? td[s] : 1.0e6f;
      topi[o] = hit ? ti[s] : 0;
    }
  }
}

extern "C" int cmdlmc_knn_sparse(const void* pos, int batch, int n, int k,
                                 float lx, float ly, float lz, float cutbuf,
                                 const void* perm, const void* lists, int n_ct,
                                 int maxa, int n_ch, int rc, int tc,
                                 void* topd, void* topi, void* stream,
                                 int device) {
  CmdlmcDeviceGuard guard(device);
  int err = (int)guard.err;
  if (err) return err;
  if (k < 1 || k > 16 || n < 1 || tc < 32 || tc > 1024 || tc % 32 ||
      rc < 1 || (size_t)rc * sizeof(float4) > 48 * 1024 ||
      (long long)n_ct * tc < n || (long long)n_ch * rc < n)
    return (int)cudaErrorInvalidValue;
  const float acc_cut = sqrt_cut(cutbuf);
  const size_t smem = (size_t)rc * sizeof(float4);
  // gridDim.y is capped at 65535 frames per launch
  for (int b0 = 0; b0 < batch; b0 += 65535) {
    const int nb = batch - b0 < 65535 ? batch - b0 : 65535;
    const dim3 grid(n_ct, nb);
    const float* pb = (const float*)pos + (size_t)b0 * n * 3;
    float* dout = (float*)topd + (size_t)b0 * k * n;
    int* iout = (int*)topi + (size_t)b0 * k * n;
    if (k <= 8)
      knn_sparse_kernel<8><<<grid, tc, smem, (cudaStream_t)stream>>>(
          pb, n, k, lx, ly, lz, acc_cut, (const int*)perm, (const int*)lists,
          maxa, n_ch, rc, dout, iout);
    else
      knn_sparse_kernel<16><<<grid, tc, smem, (cudaStream_t)stream>>>(
          pb, n, k, lx, ly, lz, acc_cut, (const int*)perm, (const int*)lists,
          maxa, n_ch, rc, dout, iout);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}
