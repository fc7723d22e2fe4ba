// Threefry-2x32 random bits on the card, bit for bit with jax.random and
// with this package's prng.py: the hash, fold_in and the float32 uniform
// of a one-dimensional draw. The per-node draws of the tree learner (the
// by-node feature sample and the extra-trees thresholds, JAX
// lightgbm_tpu/learner.py _make_best_for) use them, so that a draw inside
// a CUDA graph is one thread's arithmetic and not tens of torch ops.
//
// JAX's partitionable counter scheme (prng.py): element i of a draw of n
// values is hi ^ lo of threefry2x32(key, (i >> 32, i & 0xffffffff)), its
// float32 uniform in [0, 1) the top 23 bits under exponent 0, minus one.
// fold_in(key, data) is the key (hi, lo) of threefry2x32(key, (0, data)).
// Unsigned 32-bit adds wrap as the hash wants; the subtraction is exact.
#pragma once

#include <stdint.h>

namespace lgbt_draws {

__device__ __forceinline__ uint32_t rotl32(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// The 20-round Threefry-2x32 hash of the counter pair (x0, x1) under the
// key (k0, k1) (jax._src.prng._threefry2x32_lowering).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1,
                                             uint32_t* o0, uint32_t* o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t a = x0 + ks[0], b = x1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a += b;
      b = rotl32(b, rot[i & 1][j]) ^ a;
    }
    a += ks[(i + 1) % 3];
    b += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  *o0 = a;
  *o1 = b;
}

// jax.random.fold_in(key, data): the key of the counter pair (0, data).
__device__ __forceinline__ void fold_in(uint32_t k0, uint32_t k1,
                                        uint32_t data, uint32_t* n0,
                                        uint32_t* n1) {
  threefry2x32(k0, k1, 0u, data, n0, n1);
}

// Element i of jax.random.uniform(key, (n,)) in float32 (n < 2^32).
__device__ __forceinline__ float uniform01(uint32_t k0, uint32_t k1,
                                           uint32_t i) {
  uint32_t hi, lo;
  threefry2x32(k0, k1, 0u, i, &hi, &lo);
  return __uint_as_float(((hi ^ lo) >> 9) | 0x3F800000u) - 1.0f;
}

}  // namespace lgbt_draws
