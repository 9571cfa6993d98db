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
// K3, k3_tile_kernel, replaces `fft_four_step_pallas` (Bailey's four-step NTT
// for transforms that do not fit one block): with n = a * b, lg a =
// ceil(lg n / 2) and the input viewed as [a, b], an a-point NTT down each
// column i2, the twiddle w_n^(k1*i2) (1/n folded in for the inverse), a
// b-point NTT along each row k1, and out[k1 + a*k2]. Two launches through a
// scratch buffer: phase 1 runs the column NTTs on tiles of T columns (coset
// scale fused into the load), phase 2 the row NTTs on tiles of T rows and
// writes the interleaved LDE layout. Both run K2's register-radix passes
// over their T = 4 vectors, 2 stages a pass: of the tile sizes (1 to 64
// vectors) and pass widths (1 to 4 stages) that a probe timed on the H100,
// the one faster than the earlier radix-2 form (a block sync a stage) at
// every size from 2^16 to 2^20. At the main path's batch it keeps many
// threads (one per 4 points) and blocks, with half the syncs. A one-launch
// form (one thread-block cluster per transform) was slower on the device at
// [2, 2^16] and [16, 2^16]: a cluster spans at most 16 SMs.
//
// What bounds them on the H100: each element costs lg(n)/2 modular
// multiplies (about 30 integer instructions each) against 16 bytes of
// traffic. Counted that way a 2^13-point transform needs several times more
// time on the integer pipes than on HBM at 3.35 TB/s, though the bound
// chip_smoke.py states (4 instructions per multiply) is the bytes'. The
// design keeps every intermediate stage on chip (K2 touches device memory
// once each way, K3 twice), reads the input and writes the output coalesced,
// and replaces the multiplies of each transform's first pass by shifts. At
// the main path's batch ([2, 2^16]) K3 is bound by latency instead: 2^17
// points make few threads for 132 SMs, which the narrow passes offset.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLg = 13;          // largest transform one block holds (64 KB)
constexpr int kMaxFourStepLg = 2 * kMaxLg;

struct RowsArgs {
  const uint64_t* in;     // [P, m]
  uint64_t* out;          // fan == 1: [P, m << rb]; fan > 1: [P, m * fan]
  // stage twiddles (forward or inverse): tw[2^(s-1) - 1 + j] = w_{2^s}^j, j < 2^(s-1)
  const uint64_t* tw;
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

// One pass over nvec transforms of 2^lg points, transform v at sm + (v << lg):
// every group of 2^r points is loaded from shared memory into registers,
// runs stages s0+1 .. s0+r there and is stored back in place.
template <int r, bool kInverse>
__device__ __forceinline__ void radix_pass(uint64_t* sm, int lg, int s0, int nvec,
                                           const uint64_t* __restrict__ tw) {
  const int groups = 1 << (lg - r);
  for (int gv = threadIdx.x; gv < nvec * groups; gv += blockDim.x) {
    const int g = gv & (groups - 1);
    uint64_t* x = sm + ((gv >> (lg - r)) << lg);
    const int low = g & ((1 << s0) - 1);
    const int base = low + ((g >> s0) << (s0 + r));
    uint64_t v[1 << r];
#pragma unroll
    for (int t = 0; t < (1 << r); t++) v[t] = x[swz(base + (t << s0), lg)];
    if (s0 == 0)
      radix_stages<r, true, kInverse>(v, 0, 0, tw);
    else
      radix_stages<r, false, kInverse>(v, s0, low, tw);
#pragma unroll
    for (int t = 0; t < (1 << r); t++) x[swz(base + (t << s0), lg)] = v[t];
  }
}

// DIT stages s_start+1 .. lg of nvec bit-reversed transforms in shared
// memory, r stages a pass (fewer in the last), a block sync before each pass
// and after the last; the output is in natural order.
template <bool kInverse, int r = kPassLg>
__device__ __forceinline__ void radix_passes(uint64_t* sm, int lg, int s_start, int nvec,
                                             const uint64_t* __restrict__ tw) {
  for (int s0 = s_start; s0 < lg; s0 += r) {
    __syncthreads();
    switch (lg - s0 < r ? lg - s0 : r) {
      case 1: radix_pass<1, kInverse>(sm, lg, s0, nvec, tw); break;
      case 2: radix_pass<2, kInverse>(sm, lg, s0, nvec, tw); break;
      case 3: radix_pass<3, kInverse>(sm, lg, s0, nvec, tw); break;
      default: radix_pass<r, kInverse>(sm, lg, s0, nvec, tw); break;
    }
  }
  __syncthreads();
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
  radix_passes<kInverse>(sm, lg, a.rb, 1, a.tw);
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
  const uint64_t* in;     // phase 1: [P, n]; phase 2: the [P * fan, n] scratch
  uint64_t* out;          // phase 1: the scratch; phase 2: [P, n * fan] (out[p, k*fan + j])
  const uint64_t* tw;     // stage twiddles (forward or inverse)
  const uint64_t* tw4;    // [a, b] four-step twiddles w_n^(k1*i2), 1/n folded in for the inverse
  const uint64_t* scale;  // [fan, n] prologue scale, or null (phase 1 only)
  int lg_a, lg_b;
  int fan;
};

// K3's tiling: a block holds 2^kK3TileVectorsLg vectors (fewer where a
// transform has fewer, or 128 KB of shared memory holds fewer), and its
// passes run 2^kK3PassLg stages.
constexpr int kK3TileVectorsLg = 2;
constexpr int kK3PassLg = 2;
constexpr int kK3MaxTileLg = 14;  // 2^14 words, 128 KB

// T vectors a block. Phase 1: vectors are the columns i2 = v0 .. v0+T-1 of
// the [a, b] view of output row bo (input row p = bo / fan scaled by coset
// j = bo % fan); their a-point NTTs, twiddled, go to the [a, b] scratch row
// bo. Phase 2: vectors are the scratch rows k1 = v0 .. v0+T-1; their b-point
// NTTs go to out[k1 + a*k2] (interleaved).
template <bool kInverse>
__global__ void __launch_bounds__(kMaxRowThreads) k3_tile_kernel(FourStepArgs a, int T, int phase) {
  extern __shared__ uint64_t sm[];
  const int lg_n = a.lg_a + a.lg_b;
  const size_t n = (size_t)1 << lg_n;
  const int lg = phase == 1 ? a.lg_a : a.lg_b;  // vector length
  const int L = 1 << lg;
  const int tiles = (phase == 1 ? 1 << a.lg_b : 1 << a.lg_a) / T;
  const int bo = blockIdx.x / tiles;
  const int v0 = (blockIdx.x - bo * tiles) * T;
  const int p = bo / a.fan;
  const int j = bo - p * a.fan;
  if (phase == 1) {
    const uint64_t* x = a.in + (size_t)p * n;
    const uint64_t* sc = a.scale ? a.scale + (size_t)j * n : nullptr;
    for (int idx = threadIdx.x; idx < T * L; idx += blockDim.x) {
      const int v = idx % T;
      const int i1 = idx / T;
      const size_t e = ((size_t)i1 << a.lg_b) + v0 + v;
      uint64_t val = x[e];
      if (sc) val = gl::mul(val, __ldg(sc + e));
      sm[(v << lg) + swz((int)gl::brev((uint32_t)i1, lg), lg)] = val;
    }
  } else {
    const uint64_t* y = a.in + (size_t)bo * n;
    for (int idx = threadIdx.x; idx < T * L; idx += blockDim.x) {
      const int v = idx >> lg;
      const int i2 = idx & (L - 1);
      sm[(v << lg) + swz((int)gl::brev((uint32_t)i2, lg), lg)] =
          y[((size_t)(v0 + v) << lg) + i2];
    }
  }
  radix_passes<kInverse, kK3PassLg>(sm, lg, 0, T, a.tw);
  if (phase == 1) {
    uint64_t* o = a.out + (size_t)bo * n;
    for (int idx = threadIdx.x; idx < T * L; idx += blockDim.x) {
      const int v = idx % T;
      const int k1 = idx / T;
      const size_t e = ((size_t)k1 << a.lg_b) + v0 + v;
      o[e] = gl::mul(sm[(v << lg) + swz(k1, lg)], __ldg(a.tw4 + e));
    }
  } else {
    uint64_t* o = a.out + (size_t)p * n * a.fan + j;
    for (int idx = threadIdx.x; idx < T * L; idx += blockDim.x) {
      const int v = idx % T;
      const int k2 = idx / T;
      const size_t k = (size_t)(v0 + v) + ((size_t)k2 << a.lg_a);
      o[k * a.fan] = sm[(v << lg) + swz(k2, lg)];
    }
  }
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

// One K3 call: two launches through scratch [batch_out, n]; tw4 is the [a, b]
// table of the split lg a = ceil(lg_n / 2).
extern "C" int k3_ntt_four_step(const uint64_t* in, uint64_t* out, uint64_t* scratch,
                                const uint64_t* tw, const uint64_t* tw4, const uint64_t* scale,
                                int batch_out, int lg_n, int fan, int inverse, void* stream) {
  if (lg_n < 2 || lg_n > kMaxFourStepLg || batch_out < 1 || fan < 1 || batch_out % fan)
    return (int)cudaErrorInvalidValue;
  const int lg_a = (lg_n + 1) / 2;
  const int lg_b = lg_n - lg_a;
  void (*kernel)(FourStepArgs, int, int) = inverse ? k3_tile_kernel<true> : k3_tile_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sizeof(uint64_t) << kK3MaxTileLg);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  for (int phase = 1; phase <= 2; phase++) {
    const int lg = phase == 1 ? lg_a : lg_b;      // vector length
    const int across = phase == 1 ? lg_b : lg_a;  // vectors of one transform
    int lg_t = kK3TileVectorsLg;
    if (lg_t > kK3MaxTileLg - lg) lg_t = kK3MaxTileLg - lg;
    if (lg_t > across) lg_t = across;
    const int T = 1 << lg_t;
    FourStepArgs a = phase == 1 ? FourStepArgs{in, scratch, tw, tw4, scale, lg_a, lg_b, fan}
                                : FourStepArgs{scratch, out, tw, tw4, nullptr, lg_a, lg_b, fan};
    // one thread a group of 2^kK3PassLg points, 32 to kMaxRowThreads a block
    const int groups = T << (lg > kK3PassLg ? lg - kK3PassLg : 0);
    const int threads = groups < 32 ? 32 : groups > kMaxRowThreads ? kMaxRowThreads : groups;
    kernel<<<batch_out << (across - lg_t), threads, (sizeof(uint64_t) * T) << lg, s>>>(a, T, phase);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
