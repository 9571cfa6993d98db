// One Poseidon-Goldilocks permutation (width 12, 8 full + 22 partial rounds,
// x^7 S-box) on one thread: K5's round function.
//
// The MDS layer is computed in the frequency domain, the method of plonky2's
// `mds_multiply_freq` (plonky2/src/hash/poseidon_goldilocks.rs). Its
// circulant part is a length-12 cyclic convolution; the Good-Thomas map
// k <-> (k mod 4, k mod 3) makes it a 4 x 3 two-dimensional one. On each
// 32-bit half of the state a real 4-point DFT per residue b = k mod 3
// (additions only), a 3-point cyclic convolution per frequency with the
// generated kernels kMdsFreq* (every tap a signed power of two: shifts and
// additions) and the inverse DFT give the circulant product exactly in signed
// 64-bit integers. The generator (plonky2_torch/hash/poseidon_constants.py)
// derives the kernels from MDS_MATRIX_CIRC, proves this code's outputs equal
// the circulant rows, and bounds every intermediate by 2^kMdsFreqBoundBits.
// DIAG[0] * s[0] is added apart and one reduce_small_nc per word joins the
// halves. A layer is 182 additions and shifted additions where the dense form
// (K4's) is 288 multiply-adds by constants.
//
// Written like goldilocks.cuh: under nvcc the functions are __host__
// __device__, without __CUDACC__ they compile as host C++, so a host compiler
// can hold the permutation against the reference. The rounds carry
// non-canonical words (any value < 2^64); callers canon() what they output.
#pragma once

#include <stdint.h>

#include "goldilocks.cuh"
#include "poseidon_constants.cuh"

namespace poseidon {

constexpr int kWidth = 12;
constexpr int kRate = 8;
constexpr int kHalfFull = 4;
constexpr int kPartial = 22;
constexpr int kRounds = 30;

GL_HD uint64_t sbox(uint64_t x) {
  const uint64_t x2 = gl::mul_nc(x, x);
  const uint64_t x3 = gl::mul_nc(x2, x);
  const uint64_t x6 = gl::mul_nc(x3, x3);
  return gl::mul_nc(x6, x);
}

// The state word k with k mod 4 = a and k mod 3 = b.
GL_HD constexpr int word(int a, int b) { return (9 * a + 4 * b) % kWidth; }

// y[r] = sum_i CIRC[(i - r) mod 12] v[i] for 0 <= v[i] < 2^32, in the order
// of operations that the generator's `mds_freq_symbolic` proves.
GL_HD void circ_freq(const int64_t v[kWidth], int64_t y[kWidth]) {
  int64_t x0[3], x2[3], xr[3], xi[3];
#pragma unroll
  for (int b = 0; b < 3; b++) {  // real 4-point DFT along a, omega = -i
    const int64_t z0 = v[word(0, b)] + v[word(2, b)];
    const int64_t z1 = v[word(0, b)] - v[word(2, b)];
    const int64_t z2 = v[word(1, b)] + v[word(3, b)];
    const int64_t z3 = v[word(3, b)] - v[word(1, b)];
    x0[b] = z0 + z2;
    x2[b] = z0 - z2;
    xr[b] = z1;
    xi[b] = z3;
  }
#pragma unroll
  for (int b = 0; b < 3; b++) {
    int64_t w0 = 0, w2 = 0, wr = 0, wi = 0;
#pragma unroll
    for (int d = 0; d < 3; d++) {  // 3-point cyclic convolutions along b
      const int e = (b - d + 3) % 3;
      w0 = w0 + kMdsFreq0(d) * x0[e];
      w2 = w2 + kMdsFreq2(d) * x2[e];
      wr = wr + kMdsFreq1Re(d) * xr[e] - kMdsFreq1Im(d) * xi[e];
      wi = wi + kMdsFreq1Re(d) * xi[e] + kMdsFreq1Im(d) * xr[e];
    }
    // inverse DFT: y[a] = W0 + (-1)^a W2 + Re(i^a W1)
    const int64_t ev = w0 + w2, od = w0 - w2;
    y[word(0, b)] = ev + wr;
    y[word(1, b)] = od - wi;
    y[word(2, b)] = ev - wr;
    y[word(3, b)] = od + wi;
  }
}

// MDS layer: row r = sum_i (CIRC[(i - r) mod 12] + DIAG[r] [i == r]) s[i].
GL_HD void mds(uint64_t s[kWidth]) {
  int64_t lo[kWidth], hi[kWidth], ylo[kWidth], yhi[kWidth];
#pragma unroll
  for (int i = 0; i < kWidth; i++) {
    lo[i] = (int64_t)(s[i] & gl::EPS);
    hi[i] = (int64_t)(s[i] >> 32);
  }
  circ_freq(lo, ylo);
  circ_freq(hi, yhi);
  ylo[0] += (int64_t)kMdsDiag0 * lo[0];
  yhi[0] += (int64_t)kMdsDiag0 * hi[0];
#pragma unroll
  for (int i = 0; i < kWidth; i++) s[i] = gl::reduce_small_nc((uint64_t)ylo[i], (uint64_t)yhi[i]);
}

// rc: this round's 12 constants (kRoundConstants + 12 r).
GL_HD void full_round(uint64_t s[kWidth], const uint64_t* rc) {
#pragma unroll
  for (int i = 0; i < kWidth; i++) s[i] = sbox(gl::add_nc(s[i], rc[i]));
  mds(s);
}

GL_HD void partial_round(uint64_t s[kWidth], const uint64_t* rc) {
#pragma unroll
  for (int i = 0; i < kWidth; i++) s[i] = gl::add_nc(s[i], rc[i]);
  s[0] = sbox(s[0]);
  mds(s);
}

// rc: kRoundConstants (device constant memory or the host array).
GL_HD void permute(uint64_t s[kWidth], const uint64_t* rc) {
#pragma unroll 1
  for (int r = 0; r < kHalfFull; r++) full_round(s, rc + r * kWidth);
#pragma unroll 1
  for (int r = kHalfFull; r < kHalfFull + kPartial; r++) partial_round(s, rc + r * kWidth);
#pragma unroll 1
  for (int r = kHalfFull + kPartial; r < kRounds; r++) full_round(s, rc + r * kWidth);
}

}  // namespace poseidon
