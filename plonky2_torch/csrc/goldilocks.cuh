// Goldilocks field algebra (p = 2^64 - 2^32 + 1) for the port's kernels.
//
// Replaces plonky2_tpu/ops/goldilocks_limbs.py (K1). The TPU kernels carried
// every u64 as two u32 limb planes because Mosaic has no 64-bit lanes; Hopper
// has native 64-bit adds and a 64x64 -> high-64 multiply (__umul64hi), so a
// product is two multiply instructions plus reduce128 and no limb algebra is
// carried over. All functions take and return canonical values (< p): a
// non-canonical value would change every Merkle digest above it.
//
// Compiled by nvcc for the device. Without __CUDACC__ the same functions
// compile as host C++ (unsigned __int128 for the high product), so the
// arithmetic can be exercised by a host compiler.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define GL_HD __host__ __device__ __forceinline__
#else
#define GL_HD inline
#endif

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p

GL_HD uint64_t canon(uint64_t x) { return x >= P ? x - P : x; }

GL_HD uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  // on overflow s = a + b - 2^64 and a + b - p = s + EPS < p
  if (s < a) s += EPS;
  return canon(s);
}

GL_HD uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  // on borrow d = a - b + 2^64 and a - b + p = d - EPS
  return a < b ? d - EPS : d;
}

GL_HD uint64_t mulhi(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  return __umul64hi(a, b);
#else
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

// lo + hi * 2^64 mod p, using 2^64 = EPS and 2^96 = -1 (mod p), as a
// value < 2^64 that may not be canonical.
GL_HD uint64_t reduce128_nc(uint64_t lo, uint64_t hi) {
  uint64_t hi_hi = hi >> 32;
  uint64_t hi_lo = hi & EPS;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= EPS;
  uint64_t t1 = hi_lo * EPS;
  uint64_t t2 = t0 + t1;
  if (t2 < t1) t2 += EPS;
  return t2;
}

GL_HD uint64_t reduce128(uint64_t lo, uint64_t hi) { return canon(reduce128_nc(lo, hi)); }

GL_HD uint64_t mul(uint64_t a, uint64_t b) { return reduce128(a * b, mulhi(a, b)); }

// Non-canonical forms for long chains (the Poseidon rounds): inputs and
// outputs are any values < 2^64; canon() once at the end.
GL_HD uint64_t mul_nc(uint64_t a, uint64_t b) { return reduce128_nc(a * b, mulhi(a, b)); }

// a + b for any a < 2^64 and a canonical b (a + b - 2^64 + EPS < 2^64).
GL_HD uint64_t add_nc(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < b) s += EPS;
  return s;
}

// lo + hi * 2^32 mod p for lo, hi < 2^42 (the Poseidon MDS accumulators),
// as a value < 2^64 that may not be canonical.
GL_HD uint64_t reduce_small_nc(uint64_t lo, uint64_t hi) {
  uint64_t t = lo + ((hi & EPS) << 32);
  if (t < lo) t += EPS;
  uint64_t t2 = t + (hi >> 32) * EPS;
  if (t2 < t) t2 += EPS;
  return t2;
}

// x * 2^k mod p for 0 <= k < 192, by shifts (2^96 = -1 mod p): K1's
// gl_mul_pow2. With k known at compile time the branches fold away.
GL_HD uint64_t mul_pow2(uint64_t x, int k) {
  if (k == 0) return x;
  const bool neg = k >= 96;
  if (neg) k -= 96;
  uint64_t r;
  if (k < 64) {
    r = k ? reduce128(x << k, x >> (64 - k)) : x;
  } else {  // x * 2^(k-64), then times 2^64
    const int k1 = k - 64;
    r = reduce128(0, k1 ? reduce128_nc(x << k1, x >> (64 - k1)) : x);
  }
  return neg ? sub(0, r) : r;
}

GL_HD uint32_t brev(uint32_t x, int bits) {
  if (bits == 0) return 0;
#ifdef __CUDA_ARCH__
  return __brev(x) >> (32 - bits);
#else
  uint32_t r = 0;
  for (int i = 0; i < bits; i++) r = (r << 1) | ((x >> i) & 1u);
  return r;
#endif
}

}  // namespace gl
