// Kernel 2 (port-only): the threefry2x32 hash of JAX's random keys.
//
// Replaces no TPU kernel: the JAX package's scan engine draws every random
// number from jax.random's threefry2x32 (jax/_src/prng.py::threefry_2x32,
// 20 rounds of add / rotate / xor with the key schedule injected every 4),
// which XLA fuses into its other work. The port's scan engine
// (engine/clock.py, engine/lattice.py, models/water.py) reproduces those
// keys and draws bit for bit: four hashes per event iteration and lane
// (the fold-in of the selection and draw keys, a split, the uniforms' bits,
// the exponential's bits). The plain version
// (ops/threefry.py::keyed_hash_reference) is some 170 torch operations per
// hash; this kernel is one launch per draw.
//
// Every draw the engine makes hashes a key row with the counter
// (0, base + j): a fold-in (j = 0, base the folded value), a split and the
// bits of a draw (base 0, j the element's index: JAX's iota counters, whose
// high word is 0 below 2^32 elements). So the kernel takes the key rows and
// derives the counters itself:
//
//   out[a, j] = threefry2x32(key[a], (0, base[a] + j))   a < rows, j < num
//
// base[a] is a uint32 array or one scalar for all rows; with `xor_out` the
// two output words are xored into one (JAX's 32-bit random bits). Keys and
// outputs are int64 tensors holding uint32 words (the port carries the words
// in int64 so that torch's shifts stay logical); the kernel reads the low 32
// bits of each key word at a row stride (0 broadcasts one key) and writes
// zero-extended words. The float conversions (uniform, exponential, Gumbel)
// stay in torch, so the CPU and the card share them.
//
// Bound on the H100: the function reads a key's two uint32 words once per
// row and a base word per row where base is an array, and writes two words
// (one xored) per hash: at most 20 bytes a hash, against about 80 integer
// operations (20 rounds of an add, a funnel-shift rotate and a xor; the
// injections) at 64 INT32 lanes per SM. The engine's launches are small
// (2R hashes at most, R the replicas), so their time is the launch.
// Design: one thread per hash, a grid-stride loop, the rounds unrolled with
// constant rotations (one SHF.L each).
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

#define TF_THREADS 256

__device__ __forceinline__ uint32_t tf_rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void tf_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = tf_rotl(x1, R0) ^ x0;
  x0 += x1; x1 = tf_rotl(x1, R1) ^ x0;
  x0 += x1; x1 = tf_rotl(x1, R2) ^ x0;
  x0 += x1; x1 = tf_rotl(x1, R3) ^ x0;
}

__global__ void threefry_kernel(const long long* __restrict__ key, long long key_stride,
                                const uint32_t* __restrict__ base, uint32_t base_scalar,
                                unsigned rows, unsigned num, int xor_out,
                                long long* __restrict__ out) {
  const unsigned m_total = rows * num;
  for (unsigned m = blockIdx.x * blockDim.x + threadIdx.x; m < m_total;
       m += gridDim.x * blockDim.x) {
    const unsigned a = num == 1 ? m : m / num;
    const unsigned j = m - a * num;
    const long long* k = key + (long long)a * key_stride;
    const uint32_t k0 = (uint32_t)k[0], k1 = (uint32_t)k[1];
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    const uint32_t lo = (base ? base[a] : base_scalar) + j;
    uint32_t x0 = k0;  // the counter's high word is 0
    uint32_t x1 = lo + k1;
    tf_rounds<13, 15, 26, 6>(x0, x1);
    x0 += k1; x1 += k2 + 1u;
    tf_rounds<17, 29, 16, 24>(x0, x1);
    x0 += k2; x1 += k0 + 2u;
    tf_rounds<13, 15, 26, 6>(x0, x1);
    x0 += k0; x1 += k1 + 3u;
    tf_rounds<17, 29, 16, 24>(x0, x1);
    x0 += k1; x1 += k2 + 4u;
    tf_rounds<13, 15, 26, 6>(x0, x1);
    x0 += k2; x1 += k0 + 5u;
    if (xor_out) {
      out[m] = (long long)(x0 ^ x1);
    } else {
      reinterpret_cast<longlong2*>(out)[m] = make_longlong2((long long)x0, (long long)x1);
    }
  }
}

extern "C" int cmdlmc_threefry(const void* key, long long key_stride, const void* base,
                               uint32_t base_scalar, int rows, int num, int xor_out,
                               void* out, void* stream, int device) {
  CmdlmcDeviceGuard guard(device);
  int err = (int)guard.err;
  if (err) return err;
  if (rows < 0 || num < 0 || key_stride < 0) return (int)cudaErrorInvalidValue;
  const long long m = (long long)rows * num;
  if (m == 0) return 0;
  if (m >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  long long blocks = (m + TF_THREADS - 1) / TF_THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;
  threefry_kernel<<<(unsigned)blocks, TF_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)key, key_stride, (const uint32_t*)base, base_scalar,
      (unsigned)rows, (unsigned)num, xor_out, (long long*)out);
  return (int)cudaGetLastError();
}
