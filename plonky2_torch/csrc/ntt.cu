// Goldilocks NTT kernels for Hopper (sm_90a).
//
// K2, k2_ntt_rows_kernel, replaces plonky2_tpu/ops/pallas_ntt.py
// `_dit_planes` / `butterflies0_pallas` (the fused DIT butterfly network over
// a VMEM-resident tile). One block owns one whole transform of up to 2^13
// points in shared memory (64 KB): it loads the row once, runs every DIT
// stage between __syncthreads(), and writes the row once, so device memory
// sees one read and one write per element. Prologue options: the coset scale
// of the LDE (`_lde_coset_scale_table`) with each input row fanned out to R
// cosets, and the zero-tail repeat of the small-LDE form; epilogue options:
// the 1/n of the inverse and the interleaved LDE layout out[p, k*R + j].
//
// K3, k3_four_step_kernel, replaces `fft_four_step_pallas` (Bailey four-step
// for transforms that do not fit one block). Phase 1 runs NTT_a down the
// columns of the [a, b] view of each row in shared-memory tiles of T
// columns and multiplies by the four-step twiddle w^(k1*i2) (1/n folded in
// for the inverse); phase 2 runs NTT_b along the rows of that result and
// writes out[k1 + a*k2] (or the interleaved LDE layout). Two launches, one
// scratch round trip.
//
// What bounds them on the H100: each element costs lg(n)/2 modular
// multiplies (about 4 32-bit IMADs each plus reduction) against 16 bytes of
// traffic, so a 2^13-point transform sits near the line where the integer
// pipes, not the 3.35 TB/s of HBM, are the limit. The design keeps every
// intermediate stage in shared memory (no stage touches device memory) and
// reads the input and writes the output coalesced; the radix-2 network with
// per-stage __syncthreads() and the strided interleaved write are the simple
// first version.
#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

namespace {

constexpr int kMaxLg = 13;          // largest transform one block holds (64 KB)
constexpr int kTileElems = 1 << 11;  // four-step tile: T vectors of L points

// Stage twiddle table: tw[2^(s-1) - 1 + j] = w_{2^s}^j for stage s, j < 2^(s-1).
__device__ __forceinline__ void dit_stages(uint64_t* sm, int nvec, int lg, int start_stage,
                                           const uint64_t* __restrict__ tw) {
  const int half_n = 1 << (lg - 1);
  const int total = nvec * half_n;
  for (int s = start_stage + 1; s <= lg; s++) {
    const int half = 1 << (s - 1);
    const uint64_t* w = tw + (half - 1);
    for (int bi = threadIdx.x; bi < total; bi += blockDim.x) {
      const int v = bi >> (lg - 1);
      const int j = bi & (half_n - 1);
      const int pos = j & (half - 1);
      const int i0 = ((j >> (s - 1)) << s) + pos;
      uint64_t* base = sm + ((size_t)v << lg);
      const uint64_t u = base[i0];
      const uint64_t t = gl::mul(base[i0 + half], __ldg(w + pos));
      base[i0] = gl::add(u, t);
      base[i0 + half] = gl::sub(u, t);
    }
    __syncthreads();
  }
}

struct RowsArgs {
  const uint64_t* in;     // [P, m]
  uint64_t* out;          // fan == 1: [P, m << rb]; fan > 1: [P, m * fan]
  const uint64_t* tw;     // stage twiddles (forward or inverse)
  const uint64_t* scale;  // [fan, m] prologue scale, or null
  int lg_m;
  int rb;                 // zero-tail repeat bits (fan == 1 only)
  int fan;                // cosets per input row; output row b = p * fan + j
  uint64_t final_mul;     // epilogue scalar (1/n for the inverse), 1 = none
};

__global__ void k2_ntt_rows_kernel(RowsArgs a) {
  extern __shared__ uint64_t sm[];
  const int lg = a.lg_m + a.rb;
  const int L = 1 << lg;
  const int m = 1 << a.lg_m;
  const int R = 1 << a.rb;
  const int b = blockIdx.x;
  const int p = b / a.fan;
  const int j = b - p * a.fan;
  const uint64_t* x = a.in + (size_t)p * m;
  const uint64_t* sc = a.scale ? a.scale + (size_t)j * m : nullptr;
  // coalesced read, bit-reversed placement (repeated R times for the zero tail)
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    uint64_t v = x[i];
    if (sc) v = gl::mul(v, __ldg(sc + i));
    const int k = (int)gl::brev((uint32_t)i, a.lg_m) << a.rb;
    for (int r = 0; r < R; r++) sm[k + r] = v;
  }
  __syncthreads();
  dit_stages(sm, 1, lg, a.rb, a.tw);
  if (a.fan == 1) {
    uint64_t* o = a.out + (size_t)b * L;
    for (int k = threadIdx.x; k < L; k += blockDim.x) {
      uint64_t v = sm[k];
      if (a.final_mul != 1) v = gl::mul(v, a.final_mul);
      o[k] = v;
    }
  } else {
    uint64_t* o = a.out + (size_t)p * L * a.fan + j;
    for (int k = threadIdx.x; k < L; k += blockDim.x) {
      uint64_t v = sm[k];
      if (a.final_mul != 1) v = gl::mul(v, a.final_mul);
      o[(size_t)k * a.fan] = v;
    }
  }
}

struct FourStepArgs {
  const uint64_t* in;     // phase 1: [P, n] input; phase 2: [B, n] scratch
  uint64_t* out;          // phase 1: [B, n] scratch; phase 2: final layout
  const uint64_t* tw;     // stage twiddles
  const uint64_t* tw4;    // [a, b] four-step twiddles w^(k1*i2) (/n when inverse)
  const uint64_t* scale;  // [fan, n] prologue scale, or null (phase 1)
  int lg_a, lg_b;
  int fan;
  int T;                  // vectors per block
  int phase;              // 1 or 2
};

__global__ void k3_four_step_kernel(FourStepArgs a) {
  extern __shared__ uint64_t sm[];
  const int lg_n = a.lg_a + a.lg_b;
  const size_t n = (size_t)1 << lg_n;
  const int A = 1 << a.lg_a;
  const int Bc = 1 << a.lg_b;
  const int T = a.T;
  if (a.phase == 1) {
    // vectors = columns i2 of the [a, b] view; this block owns T of them
    const int tiles = Bc / T;
    const int bo = blockIdx.x / tiles;
    const int c0 = (blockIdx.x - bo * tiles) * T;
    const int p = bo / a.fan;
    const int j = bo - p * a.fan;
    const uint64_t* x = a.in + (size_t)p * n;
    const uint64_t* sc = a.scale ? a.scale + (size_t)j * n : nullptr;
    for (int idx = threadIdx.x; idx < T * A; idx += blockDim.x) {
      const int v = idx % T;
      const int i1 = idx / T;
      const size_t e = (size_t)i1 * Bc + c0 + v;
      uint64_t val = x[e];
      if (sc) val = gl::mul(val, __ldg(sc + e));
      sm[(v << a.lg_a) + gl::brev((uint32_t)i1, a.lg_a)] = val;
    }
    __syncthreads();
    dit_stages(sm, T, a.lg_a, 0, a.tw);
    uint64_t* o = a.out + (size_t)bo * n;
    for (int idx = threadIdx.x; idx < T * A; idx += blockDim.x) {
      const int v = idx % T;
      const int k1 = idx / T;
      const size_t e = (size_t)k1 * Bc + c0 + v;
      o[e] = gl::mul(sm[(v << a.lg_a) + k1], __ldg(a.tw4 + e));
    }
  } else {
    // vectors = rows k1 of the phase-1 result; this block owns T of them
    const int tiles = A / T;
    const int bo = blockIdx.x / tiles;
    const int r0 = (blockIdx.x - bo * tiles) * T;
    const int p = bo / a.fan;
    const int j = bo - p * a.fan;
    const uint64_t* y = a.in + (size_t)bo * n;
    for (int idx = threadIdx.x; idx < T * Bc; idx += blockDim.x) {
      const int v = idx >> a.lg_b;
      const int i2 = idx & (Bc - 1);
      sm[(v << a.lg_b) + gl::brev((uint32_t)i2, a.lg_b)] = y[(size_t)(r0 + v) * Bc + i2];
    }
    __syncthreads();
    dit_stages(sm, T, a.lg_b, 0, a.tw);
    uint64_t* o = a.out + (size_t)p * n * a.fan + j;
    for (int idx = threadIdx.x; idx < T * Bc; idx += blockDim.x) {
      const int v = idx % T;
      const int k2 = idx / T;
      const size_t k = (size_t)(r0 + v) + (size_t)A * k2;
      o[k * a.fan] = sm[(v << a.lg_b) + k2];
    }
  }
}

int threads_for(int work) {
  int t = 32;
  while (t < work && t < 512) t <<= 1;
  return t;
}

}  // namespace

// Host entry points (plain C, bound with ctypes). Each launches on `stream`,
// allocates nothing and returns cudaGetLastError().

extern "C" int k2_ntt_rows(const uint64_t* in, uint64_t* out, const uint64_t* tw,
                           const uint64_t* scale, int batch_out, int lg_m, int rb, int fan,
                           uint64_t final_mul, void* stream) {
  const int lg = lg_m + rb;
  if (lg < 1 || lg > kMaxLg || batch_out < 1 || fan < 1 || (rb && fan != 1))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)(sizeof(uint64_t) << lg);
  cudaFuncSetAttribute(k2_ntt_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  RowsArgs a{in, out, tw, scale, lg_m, rb, fan, final_mul};
  k2_ntt_rows_kernel<<<batch_out, threads_for(1 << (lg - 1)), smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int k3_ntt_four_step(const uint64_t* in, uint64_t* out, uint64_t* scratch,
                                const uint64_t* tw, const uint64_t* tw4, const uint64_t* scale,
                                int batch_out, int lg_n, int fan, void* stream) {
  const int lg_a = (lg_n + 1) / 2;
  const int lg_b = lg_n - lg_a;
  if (lg_b < 1 || lg_a > kMaxLg || batch_out < 1 || fan < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int T1 = kTileElems >> lg_a;
  T1 = T1 < 1 ? 1 : (T1 > (1 << lg_b) ? (1 << lg_b) : T1);
  int T2 = kTileElems >> lg_b;
  T2 = T2 < 1 ? 1 : (T2 > (1 << lg_a) ? (1 << lg_a) : T2);
  const int smem1 = (int)(sizeof(uint64_t) * T1) << lg_a;
  const int smem2 = (int)(sizeof(uint64_t) * T2) << lg_b;
  const int smem = smem1 > smem2 ? smem1 : smem2;
  cudaFuncSetAttribute(k3_four_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  FourStepArgs a1{in, scratch, tw, tw4, scale, lg_a, lg_b, fan, T1, 1};
  const int blocks1 = batch_out * ((1 << lg_b) / T1);
  k3_four_step_kernel<<<blocks1, threads_for(T1 << (lg_a - 1)), smem1, s>>>(a1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  FourStepArgs a2{scratch, out, tw, tw4, nullptr, lg_a, lg_b, fan, T2, 2};
  const int blocks2 = batch_out * ((1 << lg_a) / T2);
  k3_four_step_kernel<<<blocks2, threads_for(T2 << (lg_b - 1)), smem2, s>>>(a2);
  return (int)cudaGetLastError();
}
