// Device helpers shared by the kernels: warp reductions (K1, K3, K4), the
// minimum image (K1-K6), the site-displacement prefix step (K1, K3, K4) and
// the rate laws evaluated inside a kernel (K3, K4).
//
// Numerics: every including source builds with --fmad=false and without fast
// math. rintf rounds half to even like jnp.round and torch.round; sqrtf,
// division and the libm expf / logf are the accurate forms.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#define FULL_MASK 0xffffffffu
#define KB_EV_PER_K 8.617333262e-5f  // Boltzmann constant, eV / K

__device__ inline float warp_sum(float v) {
  // xor butterfly: every lane ends with the same bits (fp add commutes)
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// Largest value over the warp, first index on ties; every lane ends with it.
__device__ inline void warp_argmax(float& v, int& idx) {
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(FULL_MASK, v, o);
    int oi = __shfl_xor_sync(FULL_MASK, idx, o);
    if (ov > v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
}

__host__ __device__ inline float minimg(float d, float len) {
  return d - len * rintf(d / len);
}

// Squared length of the orthorhombic minimum image of (dx, dy, dz), summed
// (x^2 + y^2) + z^2: the one form the K-nearest kernels (K5, K6) share, so
// their distances agree bit for bit.
__device__ inline float minimg_sq(float dx, float dy, float dz, float lx,
                                  float ly, float lz) {
  dx = minimg(dx, lx);
  dy = minimg(dy, ly);
  dz = minimg(dz, lz);
  const float acc = dx * dx + dy * dy;
  return acc + dz * dz;
}

// The round-based minimum image of a 3-vector: per axis for an orthorhombic
// cell, through the fractional coordinates h^-1 d otherwise (exact for
// vectors shorter than half the smallest cell height: jumps and per-frame
// drift). h holds the cell vectors as columns, row-major; each row product
// sums in index order, as the JAX kernels do
// (cmdlmc_tpu/ops/topk_sweep.py:981-992).
struct CellImage {
  float h[9];
  float hinv[9];
  int ortho;

  __device__ void apply(float& x, float& y, float& z) const {
    if (ortho) {
      x = minimg(x, h[0]);
      y = minimg(y, h[4]);
      z = minimg(z, h[8]);
      return;
    }
    float f[3];
    for (int i = 0; i < 3; ++i) {
      float v = hinv[3 * i] * x + hinv[3 * i + 1] * y;
      v = v + hinv[3 * i + 2] * z;
      f[i] = v - rintf(v);
    }
    float o[3];
    for (int i = 0; i < 3; ++i) {
      float v = h[3 * i] * f[0] + h[3 * i + 1] * f[1];
      o[i] = v + h[3 * i + 2] * f[2];
    }
    x = o[0];
    y = o[1];
    z = o[2];
  }
};

__host__ __device__ inline CellImage orthorhombic_image(float lx, float ly,
                                                        float lz) {
  CellImage c = {};
  c.h[0] = lx;
  c.h[4] = ly;
  c.h[8] = lz;
  c.ortho = 1;
  return c;
}

// One frame's step of the shared site-displacement prefix sum:
// s += minimg(post - cur) and cur = post for every site, in the reference's
// running float32 association. The block's threads stride over the sites.
__device__ inline void advance_prefix(float* s, float* cur, const float* post,
                                      int n, const CellImage& cell) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float p[3] = {post[3 * i], post[3 * i + 1], post[3 * i + 2]};
    float dx = p[0] - cur[3 * i], dy = p[1] - cur[3 * i + 1],
          dz = p[2] - cur[3 * i + 2];
    cell.apply(dx, dy, dz);
    s[3 * i] = s[3 * i] + dx;
    s[3 * i + 1] = s[3 * i + 1] + dy;
    s[3 * i + 2] = s[3 * i + 2] + dz;
    cur[3 * i] = p[0];
    cur[3 * i + 1] = p[1];
    cur[3 * i + 2] = p[2];
  }
}

// The same step with the previous frame's positions read where they lie
// (K4 reads both frames from global memory): s += minimg(post - prev).
__device__ inline void step_prefix(float* s, const float* prev,
                                   const float* post, int n,
                                   const CellImage& cell) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float dx = post[3 * i] - prev[3 * i], dy = post[3 * i + 1] - prev[3 * i + 1],
          dz = post[3 * i + 2] - prev[3 * i + 2];
    cell.apply(dx, dy, dz);
    s[3 * i] = s[3 * i] + dx;
    s[3 * i + 1] = s[3 * i + 1] + dy;
    s[3 * i + 2] = s[3 * i + 2] + dz;
  }
}

// Rate law `kind` at distance `dist`, parameters p[0..4], in the JAX
// kernels' operation order: 0 Fermi, 1 Constant, 2 Exponential,
// 3 ActivationEnergy (its lax.rsqrt as 1.0f / sqrtf; XLA's CPU rsqrt is an
// approximation an ulp or so away), 4 FermiAngle's distance part (Fermi).
__device__ inline float apply_law(int kind, float dist, const float* p) {
  if (kind == 1) return p[0];
  if (kind == 2) return p[0] * expf(p[1] * dist);
  if (kind == 3) {
    float dd = dist - p[3];
    float safe = fabsf(dd) > 1e-6f ? dd : 1e-6f;
    float energy = p[1] * dd * (1.0f / sqrtf(p[2] + 1.0f / (safe * safe)));
    energy = fmaxf(energy, 0.f);
    return p[0] * expf(-energy / (KB_EV_PER_K * p[4]));
  }
  return p[0] / (1.0f + expf((dist - p[1]) / p[2]));  // 0 and 4: Fermi
}

// The largest float whose sqrtf is <= cutbuf (the host's sqrtf rounds
// correctly): sqrtf is monotone, so sqrtf(acc) <= cutbuf exactly when
// acc <= acc_cut, and pairs beyond the cutoff skip the square root.
__host__ inline float sqrt_cut(float cutbuf) {
  float t = cutbuf * cutbuf;
  while (sqrtf(t) <= cutbuf && t < INFINITY) t = nextafterf(t, INFINITY);
  while (t > 0.f && sqrtf(t) > cutbuf) t = nextafterf(t, 0.f);
  return t;
}
