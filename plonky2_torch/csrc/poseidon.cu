// Poseidon-Goldilocks (width 12, 8 full + 22 partial rounds, x^7 S-box)
// kernels for Hopper (sm_90a).
//
// K4, k4_tree_kernel, replaces plonky2_tpu/ops/pallas_poseidon.py
// `_sponge_call` / `sponge_pallas` and the per-level Merkle loop around it
// (plonky2_tpu/hash/merkle.py `hash_leaf_cols_dev`, `compress_halves_dev`).
// One launch hashes the leaves of a Merkle tree (the overwrite-mode sponge
// hash_or_noop per leaf) and compresses each block's subtree in shared
// memory for `depth` levels; a second launch of the same kernel carries on
// from the level the first one stopped at, and a third, one block, finishes
// at the cap. Every level's digests go to one preallocated buffer, so no
// level is copied or concatenated before it is hashed. Both tree shapes:
//   natural: leaves are the columns of a natural-order [width, N] matrix and
//     level k pairs nodes (j, j + m) of level k-1 (m = N >> k), so the level-k
//     node j covers leaf columns j + t * (N >> k). A block owns `top`
//     consecutive nodes of its top level and with them 2^depth runs of `top`
//     consecutive nodes at every level below, so its leaf reads stay
//     coalesced as long as top >= 32.
//   rows: leaves are the rows of [N, width] and level k pairs rows (2i, 2i+1).
// The leaf step alone (ops/poseidon.py `sponge`) is the same kernel at depth 0.
//
// K5, k5_permute_kernel, replaces `permute_pallas`: one full permutation of
// state-major [12, N] states, one thread a state. Its grind mode is the FRI
// proof-of-work search (plonky2_tpu/fri/prover.py `_grind_chunk`): thread j
// permutes the transcript state with candidate start + j written at the
// witness position and, when the popped challenge state[7] is below the
// threshold, takes atomicMin of the candidate, so a chunk yields its lowest
// valid witness. 2^17 one-lane states already fill the card (about one wave
// at 60 registers), so what bounds K5 is the instructions a permutation
// issues, most of them the MDS layers': K5 runs the round function of
// poseidon_lane.cuh, whose MDS is computed in the frequency domain (182
// additions and shifted additions a layer instead of 288 multiply-adds).
//
// K5's device grind, k5_grind_device_kernel, is the proof-of-work search of
// the fused FRI transcript (the while_loop over `_grind_candidates` in
// plonky2_tpu/fri/prover.py `_fused_commit_pow_fn`): the transcript state
// [12] and its k pending inputs are read from device memory, the candidate
// goes to position k, and the lowest valid witness over the whole field lands
// in a device word preset to all ones, so the host reads nothing. One launch
// sized to fill the 132 SMs runs a grid-stride loop: thread t tries t, t + T,
// t + 2T, ... (T threads in all) and stops at its first valid candidate (an
// atomicMin) or once its next candidate exceeds the current minimum. Every
// candidate below the final minimum is therefore tried, so the result is the
// lowest valid witness that a chunk-by-chunk scan finds. What bounds it is the
// permutations up to the witness: its rank times one permutation's integer
// work (7,348 operations in the frequency-domain form) at 16.7 T/s.
//
// What bounds them on the H100: integer work, ~10.5k 32-bit multiplies and
// multiply-adds a permutation against 96 bytes of state, so the kernels are
// compute bound by two orders of magnitude. Two further limits
// shape K4: 2^16 leaves at one thread a state give only ~16 warps per SM,
// and a tree's upper levels are a chain of dependent permutations with few
// states each, so their time is one permutation's latency per level. K4
// therefore spreads a state over 4 lanes of a warp (3 words each, the MDS
// rows formed from words gathered by warp shuffles): 4x the warps for the
// same instructions per state and a ~4x shorter chain per lane. The rounds
// carry non-canonical words (any value < 2^64) and canonicalise only what
// leaves the kernel. In K4 every round, partial ones included, is a dense MDS
// layer: 144 multiply-adds by constants <= 49 on 32-bit halves into two 64-bit
// accumulators (the sparse fast-partial-round form of plonky2's poseidon.rs
// takes full 64-bit multiplies and ran slower on the H100). Round constants
// sit in constant memory (poseidon_constants.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"
#include "poseidon_constants.cuh"
#include "poseidon_lane.cuh"

namespace {

using poseidon::kHalfFull;
using poseidon::kPartial;
using poseidon::kRate;
using poseidon::kRounds;
using poseidon::kWidth;
using poseidon::sbox;

constexpr int kMaxTreeStates = 128;
constexpr int kTreeLanes = 4;  // K4 threads a state

// MDS_MATRIX_CIRC and MDS_MATRIX_DIAG of plonky2_torch/hash/poseidon_constants.py.
__host__ __device__ constexpr uint64_t circ(int k) {
  return k == 0 ? 17 : k == 1 ? 15 : k == 2 ? 41 : k == 3 ? 16 : k == 4 ? 2 : k == 5 ? 28
       : k == 6 ? 13 : k == 7 ? 13 : k == 8 ? 39 : k == 9 ? 18 : k == 10 ? 34 : 20;
}

__host__ __device__ constexpr uint64_t mds_coef(int r, int i) {
  return circ((i - r + kWidth) % kWidth) + ((r == 0 && i == 0) ? 8 : 0);
}

// Where a thread sits among the kLanes lanes of a warp that share one state:
// lane q holds words kPer * q .. kPer * q + kPer - 1 (kPer = 12 / kLanes).
template <int kLanes>
struct Lane {
  static constexpr int kPer = kWidth / kLanes;
  int q;          // this lane's part of the state
  int first;      // warp lane of the state's part 0
  unsigned mask;  // the state's lanes, for __shfl_sync
  __device__ __forceinline__ Lane()
      : q(threadIdx.x % kLanes),
        first(threadIdx.x % 32 / kLanes * kLanes),
        mask(((1u << kLanes) - 1) << first) {}
};

// MDS layer: row r = sum_i (CIRC[(i - r) mod 12] + DIAG[r] [i == r]) s[i].
// Each lane gathers the 12 words rotated by its first word, a[j] =
// s[(kPer q + j) mod 12] (shuffles from the other lanes of the state), so
// its rows k < kPer take compile-time coefficients CIRC[(j - k) mod 12];
// 32-bit halves times constants <= 49 sum in two 64-bit accumulators (< 2^42).
template <int kLanes>
__device__ __forceinline__ void mds(uint64_t x[Lane<kLanes>::kPer], const Lane<kLanes>& ln) {
  constexpr int kPer = Lane<kLanes>::kPer;
  uint64_t lo[kWidth], hi[kWidth];
#pragma unroll
  for (int d = 0; d < kLanes; d++) {
#pragma unroll
    for (int k = 0; k < kPer; k++) {
      const uint64_t v =
          d == 0 ? x[k] : __shfl_sync(ln.mask, x[k], ln.first + (ln.q + d) % kLanes);
      lo[kPer * d + k] = v & 0xFFFFFFFFull;
      hi[kPer * d + k] = v >> 32;
    }
  }
  const uint64_t diag = ln.q == 0 ? mds_coef(0, 0) - circ(0) : 0;
#pragma unroll
  for (int k = 0; k < kPer; k++) {
    uint64_t acc_lo = 0, acc_hi = 0;
#pragma unroll
    for (int j = 0; j < kWidth; j++) {
      acc_lo += circ((j - k + kWidth) % kWidth) * lo[j];
      acc_hi += circ((j - k + kWidth) % kWidth) * hi[j];
    }
    if (k == 0) {
      acc_lo += diag * lo[0];
      acc_hi += diag * hi[0];
    }
    x[k] = gl::reduce_small_nc(acc_lo, acc_hi);
  }
}

template <int kLanes>
__device__ __forceinline__ void full_round(uint64_t x[Lane<kLanes>::kPer], int r,
                                           const Lane<kLanes>& ln) {
  constexpr int kPer = Lane<kLanes>::kPer;
#pragma unroll
  for (int k = 0; k < kPer; k++)
    x[k] = sbox(gl::add_nc(x[k], kRoundConstants[r * kWidth + kPer * ln.q + k]));
  mds<kLanes>(x, ln);
}

// Dense partial round: the S-box on word 0 only (lane 0's first word; the
// other lanes select their word unchanged).
template <int kLanes>
__device__ __forceinline__ void partial_round(uint64_t x[Lane<kLanes>::kPer], int r,
                                              const Lane<kLanes>& ln) {
  constexpr int kPer = Lane<kLanes>::kPer;
#pragma unroll
  for (int k = 0; k < kPer; k++)
    x[k] = gl::add_nc(x[k], kRoundConstants[r * kWidth + kPer * ln.q + k]);
  const uint64_t s0 = sbox(x[0]);
  x[0] = ln.q == 0 ? s0 : x[0];
  mds<kLanes>(x, ln);
}

// The permutation of one state spread over kLanes lanes.
template <int kLanes>
__device__ __forceinline__ void permute(uint64_t x[Lane<kLanes>::kPer], const Lane<kLanes>& ln) {
#pragma unroll 1
  for (int r = 0; r < kHalfFull; r++) full_round<kLanes>(x, r, ln);
#pragma unroll 1
  for (int r = kHalfFull; r < kHalfFull + kPartial; r++) partial_round<kLanes>(x, r, ln);
#pragma unroll 1
  for (int r = kHalfFull + kPartial; r < kRounds; r++) full_round<kLanes>(x, r, ln);
}

// hash_or_noop of one leaf whose word c is p[c * stride]: leaves of width
// <= 4 pass through zero-padded, wider ones go through the sponge. Each lane
// reads and keeps its own words; digest words come out canonical.
template <int kLanes>
__device__ __forceinline__ void hash_leaf(uint64_t x[Lane<kLanes>::kPer],
                                          const uint64_t* __restrict__ p, long long stride,
                                          int width, const Lane<kLanes>& ln) {
  constexpr int kPer = Lane<kLanes>::kPer;
#pragma unroll
  for (int k = 0; k < kPer; k++) {
    const int w = kPer * ln.q + k;
    x[k] = width <= 4 && w < width ? p[w * stride] : 0;
  }
  if (width <= 4) return;
  for (int c = 0; c < width; c += kRate) {
    const int cnt = width - c < kRate ? width - c : kRate;
#pragma unroll
    for (int k = 0; k < kPer; k++) {
      const int w = kPer * ln.q + k;
      if (w < cnt) x[k] = p[(long long)(c + w) * stride];
    }
    permute<kLanes>(x, ln);
  }
#pragma unroll
  for (int k = 0; k < kPer; k++) x[k] = gl::canon(x[k]);
}

struct TreeArgs {
  const uint64_t* leaves;  // natural: [width, n]; rows: [n, width]; null: start from buf
  uint64_t* buf;           // every level's digests: level k at word 8 * (n - (n >> k))
  long long n;             // leaves
  int width;
  int k0;                  // level this launch starts from (0 when it hashes the leaves)
  int depth;               // levels it compresses
};

// Word w of the level-k node j: natural levels are [4, n >> k], rows [n >> k, 4].
template <bool kNatural>
__device__ __forceinline__ long long digest_word(long long n, int k, long long j, int w) {
  const long long base = 8 * (n - (n >> k));
  return kNatural ? base + w * (n >> k) + j : base + 4 * j + w;
}

// Block b starts from s0 nodes of level k0 (s0 = one leaf per state when it
// hashes them, two digests per state read from buf otherwise) and
// compresses them `depth` levels up, kTreeLanes threads per state. Shared
// memory holds two levels word-major, [4][size].
template <bool kNatural>
__global__ void __launch_bounds__(kMaxTreeStates * kTreeLanes) k4_tree_kernel(TreeArgs a) {
  constexpr int kLanes = kTreeLanes;
  constexpr int kPer = Lane<kLanes>::kPer;
  extern __shared__ uint64_t sm[];
  const Lane<kLanes> ln;
  const int states = blockDim.x / kLanes;
  const int me = threadIdx.x / kLanes;
  const bool hash = a.leaves != nullptr;
  const int s0 = hash ? states : 2 * states;
  const int top = s0 >> a.depth;
  const long long run = (a.n >> a.k0) >> a.depth;
  const long long b = blockIdx.x;
  // global index of the block's local node i at a level with `size` nodes per block
  auto node = [&](int i, int size) -> long long {
    return kNatural ? b * top + i % top + (long long)(i / top) * run : b * size + i;
  };
  uint64_t* cur = sm;           // [4][s0]
  uint64_t* nxt = sm + 4 * s0;  // [4][s0 / 2]
  for (int i = me; i < s0; i += states) {
    const long long j = node(i, s0);
    uint64_t x[kPer];
    if (hash) {
      hash_leaf<kLanes>(x, kNatural ? a.leaves + j : a.leaves + j * a.width,
                        kNatural ? a.n : 1, a.width, ln);
    } else {
#pragma unroll
      for (int k = 0; k < kPer; k++) {
        const int w = kPer * ln.q + k;
        if (w < 4) x[k] = a.buf[digest_word<kNatural>(a.n, a.k0, j, w)];
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; k++) {
      const int w = kPer * ln.q + k;
      if (w < 4) {
        cur[w * s0 + i] = x[k];
        if (hash) a.buf[digest_word<kNatural>(a.n, 0, j, w)] = x[k];
      }
    }
  }
  int size = s0;
  for (int k = 1; k <= a.depth; k++) {
    __syncthreads();
    const int half = size >> 1;
    for (int i = me; i < half; i += states) {
      const int c0 = kNatural ? i : 2 * i;
      const int c1 = kNatural ? i + half : 2 * i + 1;
      uint64_t x[kPer];
#pragma unroll
      for (int e = 0; e < kPer; e++) {  // [left digest, right digest, 0, 0, 0, 0]
        const int w = kPer * ln.q + e;
        x[e] = w < 4 ? cur[w * size + c0] : w < 8 ? cur[(w - 4) * size + c1] : 0;
      }
      permute<kLanes>(x, ln);
      const long long j = node(i, half);
#pragma unroll
      for (int e = 0; e < kPer; e++) {
        const int w = kPer * ln.q + e;
        if (w < 4) {
          const uint64_t v = gl::canon(x[e]);
          nxt[w * half + i] = v;
          a.buf[digest_word<kNatural>(a.n, a.k0 + k, j, w)] = v;
        }
      }
    }
    uint64_t* t = cur;
    cur = nxt;
    nxt = t;
    size = half;
  }
}

struct GrindArgs {
  uint64_t inter[kWidth];  // transcript state with pending inputs written in
  uint64_t start;          // first candidate of this chunk
  uint64_t threshold;      // response must be < threshold
  int pos;                 // witness position in the state
};

__global__ void k5_permute_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                                  long long n, int grind, GrindArgs g, unsigned long long* best) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  uint64_t s[kWidth];
  if (grind) {
    const uint64_t cand = g.start + (uint64_t)j;
#pragma unroll
    for (int i = 0; i < kWidth; i++) s[i] = i == g.pos ? cand : g.inter[i];
    poseidon::permute(s, kRoundConstants);
    if (gl::canon(s[kRate - 1]) < g.threshold) atomicMin(best, (unsigned long long)cand);
  } else {
#pragma unroll
    for (int i = 0; i < kWidth; i++) s[i] = in[(long long)i * n + j];
    poseidon::permute(s, kRoundConstants);
#pragma unroll
    for (int i = 0; i < kWidth; i++) out[(long long)i * n + j] = gl::canon(s[i]);
  }
}

// The device grind: candidates c < limit (the field order) in a grid-stride
// loop; best holds the lowest valid candidate found so far (all ones: none).
__global__ void k5_grind_device_kernel(const uint64_t* __restrict__ state,
                                       const uint64_t* __restrict__ pending, int k,
                                       uint64_t threshold, uint64_t limit,
                                       unsigned long long* best) {
  uint64_t inter[kWidth];
#pragma unroll
  for (int i = 0; i < kWidth; i++) inter[i] = i < k ? pending[i] : state[i];
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  for (uint64_t cand = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x; cand < limit;
       cand += stride) {
    if (cand > *(volatile unsigned long long*)best) break;
    uint64_t s[kWidth];
#pragma unroll
    for (int i = 0; i < kWidth; i++) s[i] = i == k ? cand : inter[i];
    poseidon::permute(s, kRoundConstants);
    if (gl::canon(s[kRate - 1]) < threshold) {
      atomicMin(best, (unsigned long long)cand);
      break;
    }
  }
}

constexpr int kThreads = 128;

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

int launch_k5(const uint64_t* in, uint64_t* out, long long n, int grind, const GrindArgs& g,
              unsigned long long* best, cudaStream_t s) {
  k5_permute_kernel<<<blocks_for(n), kThreads, 0, s>>>(in, out, n, grind, g, best);
  return (int)cudaGetLastError();
}

bool pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// Host entry points (plain C, bound with ctypes). Each launches on `stream`,
// allocates nothing and returns cudaGetLastError().

// One K4 launch: hashes the leaves into level 0 (leaves != null, k0 == 0)
// or reads level k0 from buf, then compresses `depth` levels, with `states`
// states a block. natural != 0 takes the natural-order shape.
extern "C" int k4_tree(const uint64_t* leaves, uint64_t* buf, long long n, int width, int k0,
                       int depth, int states, int natural, void* stream) {
  if (!pow2(n) || k0 < 0 || (n >> k0) < 1 || depth < 0 || states < 1 ||
      states > kMaxTreeStates || (leaves && (k0 != 0 || width < 1)))
    return (int)cudaErrorInvalidValue;
  const long long s0 = (leaves ? 1LL : 2LL) * states;
  const long long nodes = n >> k0;
  if (!pow2(s0) || nodes % s0 || (s0 >> depth) < 1 || ((s0 >> depth) << depth) != s0)
    return (int)cudaErrorInvalidValue;
  TreeArgs a{leaves, buf, n, width, k0, depth};
  const unsigned blocks = (unsigned)(nodes / s0);
  const unsigned threads = (unsigned)(states * kTreeLanes);
  const size_t smem = sizeof(uint64_t) * 6 * s0;
  cudaStream_t s = (cudaStream_t)stream;
  void (*kernel)(TreeArgs) = natural ? k4_tree_kernel<true> : k4_tree_kernel<false>;
  kernel<<<blocks, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int k5_permute(const uint64_t* in, uint64_t* out, long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  GrindArgs g{};
  return launch_k5(in, out, n, 0, g, nullptr, (cudaStream_t)stream);
}

extern "C" int k5_grind(const uint64_t* inter, int pos, uint64_t start, long long count,
                        uint64_t threshold, unsigned long long* best, void* stream) {
  if (count < 1 || pos < 0 || pos >= kWidth) return (int)cudaErrorInvalidValue;
  GrindArgs g{};
  for (int i = 0; i < kWidth; i++) g.inter[i] = inter[i];
  g.start = start;
  g.threshold = threshold;
  g.pos = pos;
  return launch_k5(nullptr, nullptr, count, 1, g, best, (cudaStream_t)stream);
}

// K5's device grind: one launch filling every SM (blocks a SM from the
// occupancy calculator), state [12] and pending [k] in device memory
// (pending may be null when k == 0), witness at position k, threshold
// 2^(64 - pow_bits). best: one device word preset to all ones.
extern "C" int k5_grind_device(const uint64_t* state, const uint64_t* pending, int k,
                               uint64_t threshold, unsigned long long* best, void* stream) {
  if (k < 0 || k >= poseidon::kRate || (k > 0 && !pending) || !state || !best)
    return (int)cudaErrorInvalidValue;
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k5_grind_device_kernel,
                                                        kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  k5_grind_device_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      state, pending, k, threshold, gl::P, best);
  return (int)cudaGetLastError();
}
