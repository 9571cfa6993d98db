// Goldilocks NTT kernels for Hopper (sm_90a).
//
// K2, k2_ntt_rows_kernel, replaces plonky2_tpu/ops/pallas_ntt.py
// `_dit_planes` / `butterflies0_pallas` (the fused DIT butterfly network over
// a VMEM-resident tile). One block owns one whole transform of up to 2^13
// points in shared memory (64 KB): it loads the row once and writes it once.
// The stages run as register-radix passes: each thread holds a group of 16
// points at stride 2^s0 in registers and runs 4 stages there, so 13 stages
// are 4 passes with 4 block syncs, and shared memory sees one load and one
// store per point per pass. The first pass (stages 1..4) twiddles by shifts
// (gl::mul_pow2: w_16 = 2^12, with compile-time exponents); later stages
// load one twiddle per distinct exponent. A XOR swizzle (`swz`) keeps the
// bit-reversed placement, every pass and the epilogue free of bank
// conflicts. Prologue options: the coset scale of the LDE
// (`_lde_coset_scale_table`) with each input row fanned out to `fan` cosets,
// and the zero-tail repeat of the small-LDE form; epilogue options: the 1/n
// of the inverse and the interleaved LDE layout out[p, k*fan + j]. For
// fan 2..8 the fan blocks of one input row run as a thread-block cluster and
// each writes a contiguous run of the interleaved row, reading the other
// cosets' points through distributed shared memory; any other fan writes
// at a stride of fan words.
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
// multiplies (about 30 integer instructions each) against 16 bytes of
// traffic. Counted that way a 2^13-point transform needs several times more
// time on the integer pipes than on HBM at 3.35 TB/s, though the bound
// chip_smoke.py states (4 instructions per multiply) is the bytes'. The
// design keeps every intermediate stage on chip (no stage touches device
// memory), reads the input and writes the output coalesced, and replaces
// the multiplies of stages 1..4 by shifts. K3 keeps radix-2 stages with a
// sync each (`dit_stages`).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

namespace cg = cooperative_groups;

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

constexpr int kPassLg = 4;                 // stages a pass runs in registers
constexpr int kPassPts = 1 << kPassLg;     // points a thread holds
constexpr int kMaxRowThreads = (1 << kMaxLg) / kPassPts;
constexpr int kMaxCluster = 8;             // portable thread-block cluster size

// Shared-memory word of point w of a 2^lg-point transform. For lg >= 12 the
// low 4 bits are XORed with (bits 4..7 + the top 4 bits), so that each
// half-warp's 8-byte accesses land on 16 different bank pairs in all three
// patterns: the bit-reversed placement (the top bits vary), the first pass
// (bits 4..7 vary) and every later pass and the epilogue (the low bits vary).
__device__ __forceinline__ int swz(int w, int lg) {
  return lg >= 12 ? w ^ (((w >> 4) + (w >> (lg - 4))) & 15) : w;
}

// DIT stages s0+1 .. s0+r on one group held in registers: point t of the
// group is point low + t * 2^s0 of the transform (low < 2^s0). Stage s's
// twiddle for that point is w_{2^s}^(low + (t mod 2^(q-1)) * 2^s0), q = s - s0.
// In the first pass (s0 == 0, stages 1..4) the exponents are compile-time
// constants and w_{2^s} = 2^(192 / 2^s), so the twiddles are shifts.
template <int r, bool kFirst, bool kInverse>
__device__ __forceinline__ void radix_stages(uint64_t v[1 << r], int s0, int low,
                                             const uint64_t* __restrict__ tw) {
#pragma unroll
  for (int q = 1; q <= r; q++) {
    const int half = 1 << (q - 1);
#pragma unroll
    for (int t = 0; t < (1 << r); t++) {
      if (t & half) continue;
      const int m = t & (half - 1);
      uint64_t w = v[t + half];
      if (kFirst) {
        const int k = m * (192 >> q);
        w = gl::mul_pow2(w, kInverse && k ? 192 - k : k);
      } else {
        w = gl::mul(w, __ldg(tw + ((1 << (s0 + q - 1)) - 1) + low + (m << s0)));
      }
      v[t + half] = gl::sub(v[t], w);
      v[t] = gl::add(v[t], w);
    }
  }
}

// One pass: every group of 2^r points is loaded from shared memory into
// registers, runs stages s0+1 .. s0+r there and is stored back in place.
template <int r, bool kInverse>
__device__ __forceinline__ void radix_pass(uint64_t* sm, int lg, int s0,
                                           const uint64_t* __restrict__ tw) {
  const int groups = 1 << (lg - r);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int low = g & ((1 << s0) - 1);
    const int base = low + ((g >> s0) << (s0 + r));
    uint64_t v[1 << r];
#pragma unroll
    for (int t = 0; t < (1 << r); t++) v[t] = sm[swz(base + (t << s0), lg)];
    if (s0 == 0)
      radix_stages<r, true, kInverse>(v, 0, 0, tw);
    else
      radix_stages<r, false, kInverse>(v, s0, low, tw);
#pragma unroll
    for (int t = 0; t < (1 << r); t++) sm[swz(base + (t << s0), lg)] = v[t];
  }
}

template <bool kInverse>
// Two blocks per SM: 512 threads at 64 registers (a few spill) fill the SM
// twice, so one block's pass overlaps the other's sync; unbounded, ptxas
// takes 112 registers and the SM holds one block.
__global__ void __launch_bounds__(kMaxRowThreads, 2) k2_ntt_rows_kernel(RowsArgs a) {
  extern __shared__ uint64_t sm[];
  const int lg = a.lg_m + a.rb;
  const int L = 1 << lg;
  const int m = 1 << a.lg_m;
  const int R = 1 << a.rb;
  const int nt = blockDim.x;
  const int b = blockIdx.x;
  const int p = b / a.fan;
  const int j = b - p * a.fan;
  const uint64_t* x = a.in + (size_t)p * m;
  const uint64_t* sc = a.scale ? a.scale + (size_t)j * m : nullptr;
  // coalesced read, bit-reversed placement (repeated R times for the zero tail)
  for (int i = threadIdx.x; i < m; i += nt) {
    uint64_t v = x[i];
    if (sc) v = gl::mul(v, __ldg(sc + i));
    const int k = (int)gl::brev((uint32_t)i, a.lg_m) << a.rb;
    for (int r = 0; r < R; r++) sm[swz(k + r, lg)] = v;
  }
  // the zero tail's first rb stages would only repeat each point R times
  for (int s0 = a.rb; s0 < lg; s0 += kPassLg) {
    __syncthreads();
    switch (lg - s0) {
      case 1: radix_pass<1, kInverse>(sm, lg, s0, a.tw); break;
      case 2: radix_pass<2, kInverse>(sm, lg, s0, a.tw); break;
      case 3: radix_pass<3, kInverse>(sm, lg, s0, a.tw); break;
      default: radix_pass<kPassLg, kInverse>(sm, lg, s0, a.tw); break;
    }
  }
  __syncthreads();
  const uint64_t fm = a.final_mul;
  if (a.fan == 1) {
    uint64_t* o = a.out + (size_t)b * L;
    for (int k = threadIdx.x; k < L; k += nt) {
      uint64_t v = sm[swz(k, lg)];
      if (fm != 1) v = gl::mul(v, fm);
      o[k] = v;
    }
  } else if (a.fan <= kMaxCluster) {
    // The fan blocks of input row p form one cluster (block rank j). Block j
    // writes the contiguous run out[p, j*L .. (j+1)*L) of the interleaved row,
    // reading point k of coset c from block c's shared memory.
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int lg_fan = __ffs(a.fan) - 1;
    uint64_t* o = a.out + ((size_t)p * a.fan + j) * L;
    for (int e = threadIdx.x; e < L; e += nt) {
      const int q = j * L + e;
      const uint64_t* src = cluster.map_shared_rank(sm, q & (a.fan - 1));
      uint64_t v = src[swz(q >> lg_fan, lg)];
      if (fm != 1) v = gl::mul(v, fm);
      o[e] = v;
    }
    cluster.sync();  // no block leaves while another still reads its memory
  } else {
    uint64_t* o = a.out + (size_t)p * L * a.fan + j;
    for (int k = threadIdx.x; k < L; k += nt) {
      uint64_t v = sm[swz(k, lg)];
      if (fm != 1) v = gl::mul(v, fm);
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
                           uint64_t final_mul, int inverse, void* stream) {
  const int lg = lg_m + rb;
  if (lg < 1 || lg > kMaxLg || batch_out < 1 || fan < 1 || (fan & (fan - 1)) ||
      batch_out % fan || (rb && fan != 1))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)(sizeof(uint64_t) << lg);
  const int threads = lg >= kPassLg ? 1 << (lg - kPassLg) : 1;
  void (*kernel)(RowsArgs) = inverse ? k2_ntt_rows_kernel<true> : k2_ntt_rows_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  RowsArgs a{in, out, tw, scale, lg_m, rb, fan, final_mul};
  cudaStream_t s = (cudaStream_t)stream;
  if (fan > 1 && fan <= kMaxCluster) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(batch_out);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = fan;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, a);
    if (err != cudaSuccess) return (int)err;
  } else {
    kernel<<<batch_out, threads, smem, s>>>(a);
  }
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
