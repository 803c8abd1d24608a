// The K-nearest kernels' shared pieces (K5 csrc/knn_tables.cu, K6
// csrc/knn_sparse.cu): the (distance, index) order, one frame's distance of
// a pair with K5's minimum image and cutoff test, and the sorted register
// list of the KMAX nearest rows. Both kernels build every distance and every
// list entry here, so their tables agree bit for bit.
//
// Numerics: every including source builds with --fmad=false and without fast
// math (kmc_common.cuh).
#pragma once
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "kmc_common.cuh"

// (d1, i1) < (d2, i2) lexicographically
__device__ __forceinline__ bool knn_before(float d1, int i1, float d2, int i2) {
  return d1 < d2 || (d1 == d2 && i1 < i2);
}

struct KnnFrame {
  float lx, ly, lz, ix, iy, iz, acc_cut;

  // distance of (dx, dy, dz) = p_i - p_j, or -1 past cutoff + buffer
  __device__ __forceinline__ float dist(float dx, float dy, float dz) const {
    dx = minimg_near(dx, lx, ix);
    dy = minimg_near(dy, ly, iy);
    dz = minimg_near(dz, lz, iz);
    float acc = dx * dx + dy * dy;
    acc = acc + dz * dz;
    if (!(acc <= acc_cut)) return -1.f;
    return sqrtf(acc);
  }
};

// The KMAX nearest rows seen so far, sorted by (distance, index).
template <int KMAX>
struct KnnList {
  float d[KMAX];
  int i[KMAX];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      d[s] = INFINITY;
      i[s] = INT_MAX;
    }
  }

  __device__ __forceinline__ void insert(float dd, int ii) {
    if (!knn_before(dd, ii, d[KMAX - 1], i[KMAX - 1])) return;
    // insert after every entry before it; walk down so each slot reads its
    // upper neighbour before that one is overwritten
#pragma unroll
    for (int s = KMAX - 1; s > 0; --s) {
      if (knn_before(dd, ii, d[s], i[s])) {
        if (knn_before(dd, ii, d[s - 1], i[s - 1])) {
          d[s] = d[s - 1];
          i[s] = i[s - 1];
        } else {
          d[s] = dd;
          i[s] = ii;
        }
      }
    }
    if (knn_before(dd, ii, d[0], i[0])) {
      d[0] = dd;
      i[0] = ii;
    }
  }

  __device__ __forceinline__ float kth(int k) const {
    float v = d[0];
#pragma unroll
    for (int s = 1; s < KMAX; ++s)
      if (s == k - 1) v = d[s];
    return v;
  }

  // the first k entries at column j of frame b: (1e6, 0) where the list ran out
  __device__ __forceinline__ void store(int k, int n, int b, int j, float* topd,
                                        int* topi) const {
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      if (s < k) {
        const bool hit = d[s] < INFINITY;
        const size_t o = ((size_t)b * k + s) * n + j;
        topd[o] = hit ? d[s] : 1.0e6f;
        topi[o] = hit ? i[s] : 0;
      }
    }
  }
};
