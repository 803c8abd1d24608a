// Kernel K2: batched minimum-image distance matrices for orthorhombic cells.
//
// Replaces the TPU kernel cmdlmc_tpu/ops/pairwise.py::_dist_kernel
// (pallas_call at ops/pairwise.py:55), and fills a whole block of frames in
// one launch: out[b, i, j] = |minimg(pos[b, j] - pos[b, i])|.
//
// Bound on the H100: the store of B*N*N floats (8.3 MB at [100, 144, 144],
// the dense main path's launch; 85 MB at [16, 1152, 1152]) at 3.35 TB/s; the
// positions (B*N*12 bytes) are read once from device memory. The arithmetic
// (three minimum images, the squares, an IEEE square root: some 40
// instructions an entry) would take about as long as the stores if every
// entry were computed.
//
// Design: the matrix is symmetric bit for bit (p_i - p_j is -(p_j - p_i)
// exactly, and the minimum image, the squares and the root keep the sign
// out), so the kernel computes each 32 x 32 tile pair (I, J) with I <= J
// once and writes it twice: tile (I, J) straight from registers and tile
// (J, I) through a transpose in shared memory. One block of 256 threads
// per frame and tile pair, B T (T + 1) / 2 blocks (T = ceil(N / 32): 1500
// at the main path's shape, of 1024 entries each, where a thread per entry
// took 9,000 blocks of 256); it stages the 32 row and 32 column positions
// in shared memory, and each thread computes
// four consecutive columns of a row and writes them as one float4 store
// where the row is 16-byte aligned (N % 4 == 0), scalar stores on the
// ragged edge and otherwise. The minimum image multiplies by 1 / L and
// divides only within a few ulps of a half-integer
// (kmc_common.cuh::minimg_near, bit-equal to minimg).
//
// Numerics match the plain version (ops/pairwise.py::pairwise_reference) bit
// for bit: build with --fmad=false so d - L*rint(d/L) and the sum of squares
// round per operation, rintf rounds half to even like torch.round/jnp.round,
// the squares sum x, y, z in that order, and sqrtf/division are IEEE (no fast
// math).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "kmc_common.cuh"

#define K2_THREADS 256
#define K2_TILE 32

struct PairwiseBox {
  float lx, ly, lz, ix, iy, iz;
};

__device__ __forceinline__ float pair_dist(float dx, float dy, float dz,
                                           const PairwiseBox& c) {
  dx = minimg_near(dx, c.lx, c.ix);
  dy = minimg_near(dy, c.ly, c.iy);
  dz = minimg_near(dz, c.lz, c.iz);
  float acc = dx * dx + dy * dy;
  acc = acc + dz * dz;
  return sqrtf(acc);
}

// Four entries of a row at o (columns j .. j + 3, `left` of them inside the
// matrix): one float4 store where aligned, else scalar stores.
__device__ __forceinline__ void store4(float* o, float4 d, bool aligned, int left) {
  if (aligned && left >= 4) {
    *reinterpret_cast<float4*>(o) = d;
  } else {
    if (left > 0) o[0] = d.x;
    if (left > 1) o[1] = d.y;
    if (left > 2) o[2] = d.z;
    if (left > 3) o[3] = d.w;
  }
}

// Tile pair p of the upper triangle, rows in order: (I, J) with I <= J < T.
__device__ __forceinline__ void upper_pair(int p, int tiles, int& ti, int& tj) {
  // row I starts at I T - I (I - 1) / 2; start from the root, then correct
  const double w = 2.0 * tiles + 1.0;
  int i = (int)((w - sqrt(w * w - 8.0 * p)) / 2.0);
  i = i < 0 ? 0 : (i >= tiles ? tiles - 1 : i);
  while (i > 0 && i * tiles - i * (i - 1) / 2 > p) --i;
  while (i + 1 < tiles && (i + 1) * tiles - (i + 1) * i / 2 <= p) ++i;
  ti = i;
  tj = i + p - (i * tiles - i * (i - 1) / 2);
}

__global__ void __launch_bounds__(K2_THREADS)
    pairwise_kernel(const float* __restrict__ pos, int n, int tiles, PairwiseBox box,
                    float* __restrict__ out) {
  __shared__ float rows[3][K2_TILE], cols[3][K2_TILE];
  __shared__ float tr[K2_TILE][K2_TILE + 1];  // (I, J) for its transpose
  const int t = threadIdx.x;
  const int r = t / 8, c = (t % 8) * 4;  // this thread's row and four columns
  const bool aligned = n % 4 == 0;
  int ti, tj;
  upper_pair(blockIdx.x, tiles, ti, tj);
  const int i0 = ti * K2_TILE, j0 = tj * K2_TILE;
  const float* pb = pos + (size_t)blockIdx.y * n * 3;
  float* ob = out + (size_t)blockIdx.y * n * n;
  if (t < 6 * K2_TILE) {  // the 32 row and 32 column positions
    const int col = t >= 3 * K2_TILE, e = col ? t - 3 * K2_TILE : t;
    const int first = col ? j0 : i0;
    (col ? cols : rows)[e % 3][e / 3] =
        first + e / 3 < n ? pb[(size_t)3 * first + e] : 0.f;
  }
  __syncthreads();
  const float xi = rows[0][r], yi = rows[1][r], zi = rows[2][r];
  float4 d;
  d.x = pair_dist(cols[0][c] - xi, cols[1][c] - yi, cols[2][c] - zi, box);
  d.y = pair_dist(cols[0][c + 1] - xi, cols[1][c + 1] - yi, cols[2][c + 1] - zi, box);
  d.z = pair_dist(cols[0][c + 2] - xi, cols[1][c + 2] - yi, cols[2][c + 2] - zi, box);
  d.w = pair_dist(cols[0][c + 3] - xi, cols[1][c + 3] - yi, cols[2][c + 3] - zi, box);
  if (i0 + r < n) store4(ob + (size_t)(i0 + r) * n + j0 + c, d, aligned, n - j0 - c);
  if (ti == tj) return;  // the same for the whole block
  tr[r][c] = d.x;
  tr[r][c + 1] = d.y;
  tr[r][c + 2] = d.z;
  tr[r][c + 3] = d.w;
  __syncthreads();
  // tile (J, I): row j0 + r, columns i0 + c .. i0 + c + 3
  const float4 e = make_float4(tr[c][r], tr[c + 1][r], tr[c + 2][r], tr[c + 3][r]);
  if (j0 + r < n) store4(ob + (size_t)(j0 + r) * n + i0 + c, e, aligned, n - i0 - c);
}

extern "C" int cmdlmc_pairwise(const void* pos, int batch, int n, float lx,
                               float ly, float lz, void* out, void* stream,
                               int device) {
  CmdlmcDeviceGuard guard(device);
  int err = (int)guard.err;
  if (err) return err;
  if (batch < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n == 0) return 0;
  const long long tiles = (n + K2_TILE - 1) / K2_TILE;
  if (tiles * (tiles + 1) / 2 > INT_MAX) return (int)cudaErrorInvalidValue;
  const PairwiseBox box = {lx, ly, lz, 1.0f / lx, 1.0f / ly, 1.0f / lz};
  // gridDim.y is capped at 65535 frames per launch
  for (int b0 = 0; b0 < batch; b0 += 65535) {
    const int nb = batch - b0 < 65535 ? batch - b0 : 65535;
    const dim3 grid((unsigned)(tiles * (tiles + 1) / 2), nb);
    pairwise_kernel<<<grid, K2_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)pos + (size_t)b0 * n * 3, n, (int)tiles, box,
        (float*)out + (size_t)b0 * n * n);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}
