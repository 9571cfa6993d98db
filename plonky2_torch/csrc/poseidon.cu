// Poseidon-Goldilocks (width 12, 8 full + 22 partial rounds, x^7 S-box)
// kernels for Hopper (sm_90a).
//
// K4, k4_sponge_kernel, replaces plonky2_tpu/ops/pallas_poseidon.py
// `_sponge_call` / `sponge_pallas`: the overwrite-mode sponge
// (hash_n_to_m_no_pad(col, 4)) over every column of a [width, N] matrix,
// giving [4, N] digests. One thread owns one column: its 12-word state
// lives in registers through all ceil(width/8) absorb chunks and all 30
// rounds, so device memory sees each input word once (coalesced: thread j
// reads column j) and each digest word once. The last chunk overwrites only
// width % 8 lanes.
//
// K5, k5_permute_kernel, replaces `permute_pallas`: one full permutation of
// state-major [12, N] states. Its grind mode is the FRI proof-of-work search
// (plonky2_tpu/fri/prover.py `_grind_chunk`): thread j permutes the
// transcript state with candidate start + j written at the witness position
// and, when the popped challenge state[7] is below the threshold, takes
// atomicMin of the candidate, so a chunk yields its lowest valid witness.
//
// What bounds them on the H100: integer multiplies. A permutation is 472
// modular multiplies (S-boxes) plus 30 MDS layers of 144 multiply-adds by
// constants <= 49 and touches only 96 bytes, so the kernels are compute
// bound by three orders of magnitude. The MDS layer multiplies 32-bit halves
// by compile-time constants into two 64-bit accumulators (< 2^42) and
// reduces once per output row, and partial rounds S-box one word only.
// Round constants come from a device table read uniformly by every thread
// of a warp.
#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

namespace {

constexpr int kWidth = 12;
constexpr int kRate = 8;
constexpr int kHalfFull = 4;
constexpr int kPartial = 22;
constexpr int kRounds = 30;

// MDS_MATRIX_CIRC and MDS_MATRIX_DIAG of plonky2_torch/hash/poseidon_constants.py.
__host__ __device__ constexpr uint64_t circ(int k) {
  return k == 0 ? 17 : k == 1 ? 15 : k == 2 ? 41 : k == 3 ? 16 : k == 4 ? 2 : k == 5 ? 28
       : k == 6 ? 13 : k == 7 ? 13 : k == 8 ? 39 : k == 9 ? 18 : k == 10 ? 34 : 20;
}

__host__ __device__ constexpr uint64_t mds_coef(int r, int i) {
  return circ((i - r + kWidth) % kWidth) + ((r == 0 && i == 0) ? 8 : 0);
}

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = gl::mul(x, x);
  const uint64_t x3 = gl::mul(x2, x);
  const uint64_t x6 = gl::mul(x3, x3);
  return gl::mul(x6, x);
}

__device__ __forceinline__ void mds(uint64_t s[kWidth]) {
  uint64_t lo[kWidth], hi[kWidth];
#pragma unroll
  for (int i = 0; i < kWidth; i++) {
    lo[i] = s[i] & 0xFFFFFFFFull;
    hi[i] = s[i] >> 32;
  }
#pragma unroll
  for (int r = 0; r < kWidth; r++) {
    uint64_t acc_lo = 0, acc_hi = 0;
#pragma unroll
    for (int i = 0; i < kWidth; i++) {
      acc_lo += mds_coef(r, i) * lo[i];
      acc_hi += mds_coef(r, i) * hi[i];
    }
    s[r] = gl::reduce_small(acc_lo, acc_hi);
  }
}

__device__ __forceinline__ void permute(uint64_t s[kWidth], const uint64_t* __restrict__ rc) {
  for (int r = 0; r < kHalfFull; r++) {
#pragma unroll
    for (int i = 0; i < kWidth; i++) s[i] = sbox(gl::add(s[i], __ldg(rc + r * kWidth + i)));
    mds(s);
  }
  for (int r = kHalfFull; r < kHalfFull + kPartial; r++) {
#pragma unroll
    for (int i = 0; i < kWidth; i++) s[i] = gl::add(s[i], __ldg(rc + r * kWidth + i));
    s[0] = sbox(s[0]);
    mds(s);
  }
  for (int r = kHalfFull + kPartial; r < kRounds; r++) {
#pragma unroll
    for (int i = 0; i < kWidth; i++) s[i] = sbox(gl::add(s[i], __ldg(rc + r * kWidth + i)));
    mds(s);
  }
}

__global__ void k4_sponge_kernel(const uint64_t* __restrict__ cols, uint64_t* __restrict__ out,
                                 int width, long long n, const uint64_t* __restrict__ rc) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  uint64_t s[kWidth];
#pragma unroll
  for (int i = 0; i < kWidth; i++) s[i] = 0;
  for (int c = 0; c < width; c += kRate) {
    const int cnt = width - c < kRate ? width - c : kRate;
#pragma unroll
    for (int k = 0; k < kRate; k++)
      if (k < cnt) s[k] = cols[(long long)(c + k) * n + j];
    permute(s, rc);
  }
#pragma unroll
  for (int k = 0; k < 4; k++) out[(long long)k * n + j] = s[k];
}

struct GrindArgs {
  uint64_t inter[kWidth];  // transcript state with pending inputs written in
  uint64_t start;          // first candidate of this chunk
  uint64_t threshold;      // response must be < threshold
  int pos;                 // witness position in the state
};

__global__ void k5_permute_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                                  long long n, const uint64_t* __restrict__ rc, int grind,
                                  GrindArgs g, unsigned long long* best) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  uint64_t s[kWidth];
  if (grind) {
    const uint64_t cand = g.start + (uint64_t)j;
#pragma unroll
    for (int i = 0; i < kWidth; i++) s[i] = i == g.pos ? cand : g.inter[i];
    permute(s, rc);
    if (s[kRate - 1] < g.threshold) atomicMin(best, (unsigned long long)cand);
  } else {
#pragma unroll
    for (int i = 0; i < kWidth; i++) s[i] = in[(long long)i * n + j];
    permute(s, rc);
#pragma unroll
    for (int i = 0; i < kWidth; i++) out[(long long)i * n + j] = s[i];
  }
}

constexpr int kThreads = 128;

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// Host entry points (plain C, bound with ctypes). Each launches on `stream`,
// allocates nothing and returns cudaGetLastError(). `rc` is the [30 * 12]
// round-constant table on the device.

extern "C" int k4_sponge(const uint64_t* cols, uint64_t* out, int width, long long n,
                         const uint64_t* rc, void* stream) {
  if (width < 1 || n < 1) return (int)cudaErrorInvalidValue;
  k4_sponge_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(cols, out, width, n, rc);
  return (int)cudaGetLastError();
}

extern "C" int k5_permute(const uint64_t* in, uint64_t* out, long long n, const uint64_t* rc,
                          void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  GrindArgs g{};
  k5_permute_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(in, out, n, rc, 0, g,
                                                                           nullptr);
  return (int)cudaGetLastError();
}

extern "C" int k5_grind(const uint64_t* inter, int pos, uint64_t start, long long count,
                        uint64_t threshold, const uint64_t* rc, unsigned long long* best,
                        void* stream) {
  if (count < 1 || pos < 0 || pos >= kWidth) return (int)cudaErrorInvalidValue;
  GrindArgs g{};
  for (int i = 0; i < kWidth; i++) g.inter[i] = inter[i];
  g.start = start;
  g.threshold = threshold;
  g.pos = pos;
  k5_permute_kernel<<<blocks_for(count), kThreads, 0, (cudaStream_t)stream>>>(
      nullptr, nullptr, count, rc, 1, g, best);
  return (int)cudaGetLastError();
}
