// Host runtime of plonky2_torch: the witness-plan executor and what it
// needs, and keccak-f.
//
// Witness generation is a data-dependent dependency graph of ~150 short
// sequential levels in a recursion circuit; it runs on the host, as in the
// reference. This library holds Goldilocks vector arithmetic, the Poseidon
// permutation and sponge, the PoseidonGate witness kernel (the fast
// partial-round decomposition the gate's constraints are written against),
// the executor of a compiled witness plan (iop/witness_plan.py), whose
// opcodes are each the dual of one generator's run_once, and keccak-f[1600]
// for KeccakGoldilocksConfig's host Merkle trees and transcript. It is the
// port's own copy of the reference package's native/src/plonky2_native.cc,
// exact duals of field/np_field.py, hash/keccak.py and the generators.
//
// Built by plonky2_torch/native/__init__.py with g++ at first use; the
// Poseidon tables (poseidon_tables.inc) are generated into the build from
// the port's hash/poseidon_constants.py and hash/poseidon_fast_partial.py.

#include <cstdint>
#include <cstring>

using u64 = uint64_t;
using u128 = __uint128_t;
using i64 = int64_t;

static const u64 P = 0xFFFFFFFF00000001ull;
static const u64 EPS = 0xFFFFFFFFull; // 2^64 mod p

static inline u64 gl_canon(u64 x) { return x >= P ? x - P : x; }

static inline u64 gadd(u64 a, u64 b) {
  u64 s = a + b;
  if (s < a) s += EPS;
  return gl_canon(s);
}

static inline u64 gsub(u64 a, u64 b) {
  u64 d = a - b;
  if (a < b) d -= EPS; // wrapping, matches np_field.sub
  return d;
}

static inline u64 gl_reduce128(u128 x) {
  u64 lo = (u64)x, hi = (u64)(x >> 64);
  u64 hi_hi = hi >> 32, hi_lo = hi & EPS;
  u64 t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= EPS;
  u64 t1 = hi_lo * EPS;
  u64 t2 = t0 + t1;
  if (t2 < t1) t2 += EPS;
  return gl_canon(t2);
}

static inline u64 gmul(u64 a, u64 b) { return gl_reduce128((u128)a * b); }

static inline u64 gexp(u64 b, u64 e) {
  u64 r = 1;
  while (e) {
    if (e & 1) r = gmul(r, b);
    b = gmul(b, b);
    e >>= 1;
  }
  return r;
}

static inline u64 ginv(u64 x) { return gexp(x, P - 2); }

extern "C" {

// ---------------------------------------------------------------------------
// Goldilocks vector ops (duals of field/np_field.py)
// ---------------------------------------------------------------------------

void gl_add(const u64* x, const u64* y, u64* out, i64 n) {
  for (i64 i = 0; i < n; i++) out[i] = gadd(x[i], y[i]);
}

void gl_sub(const u64* x, const u64* y, u64* out, i64 n) {
  for (i64 i = 0; i < n; i++) out[i] = gsub(x[i], y[i]);
}

void gl_mul(const u64* x, const u64* y, u64* out, i64 n) {
  for (i64 i = 0; i < n; i++) out[i] = gmul(x[i], y[i]);
}

void gl_neg(const u64* x, u64* out, i64 n) {
  for (i64 i = 0; i < n; i++) out[i] = x[i] == 0 ? 0 : P - x[i];
}

void gl_mul_scalar(const u64* x, u64 c, u64* out, i64 n) {
  for (i64 i = 0; i < n; i++) out[i] = gmul(x[i], c);
}

// out = c0*(a*b) + c1*d  — the ArithmeticGate op (reference
// gates/arithmetic_base.rs), fused to one pass for the witness engine.
void gl_arith(const u64* c0, const u64* c1, const u64* a, const u64* b,
              const u64* d, u64* out, i64 n) {
  for (i64 i = 0; i < n; i++)
    out[i] = gadd(gmul(c0[i], gmul(a[i], b[i])), gmul(c1[i], d[i]));
}

void gl_exp_u64(const u64* x, u64 e, u64* out, i64 n) {
  for (i64 i = 0; i < n; i++) out[i] = gexp(x[i], e);
}

void gl_inverse(const u64* x, u64* out, i64 n) {
  for (i64 i = 0; i < n; i++) out[i] = x[i] == 0 ? 0 : ginv(x[i]);
}

// Montgomery batch inversion; zeros map to zero (the reference
// field/src/types.rs:133 asserts nonzero; callers here pre-filter).
void gl_batch_inverse(const u64* x, u64* out, i64 n) {
  // prefix products over nonzero entries
  u64 acc = 1;
  for (i64 i = 0; i < n; i++) {
    out[i] = acc; // product of nonzeros before i
    if (x[i] != 0) acc = gmul(acc, x[i]);
  }
  u64 inv = ginv(acc);
  for (i64 i = n - 1; i >= 0; i--) {
    if (x[i] == 0) {
      out[i] = 0;
    } else {
      u64 res = gmul(out[i], inv);
      inv = gmul(inv, x[i]);
      out[i] = res;
    }
  }
}

// ---------------------------------------------------------------------------
// Poseidon-Goldilocks permutation (dual of hash/poseidon.py::permute)
// ---------------------------------------------------------------------------

#include "poseidon_tables.inc"
// provides: PO_RC[360], PO_MDS[12][12] (small ints),
// PO_FAST_FIRST[12], PO_FAST_RC[22], PO_FAST_INIT[11][11],
// PO_FAST_W_HATS[22][11], PO_FAST_VS[22][11]

static const int PW = 12;
static const int HALF_FULL = 4;
static const int N_PARTIAL = 22;
static const int N_ROUNDS = 30;

static inline u64 sbox7(u64 x) {
  u64 x2 = gmul(x, x);
  u64 x3 = gmul(x2, x);
  u64 x6 = gmul(x3, x3);
  return gmul(x6, x);
}

static inline void mds_full(u64* s) {
  u64 r[PW];
  for (int row = 0; row < PW; row++) {
    u128 acc = 0;
    for (int i = 0; i < PW; i++) acc += (u128)PO_MDS[row][i] * s[i];
    r[row] = gl_reduce128(acc);
  }
  memcpy(s, r, sizeof(r));
}

// one full 30-round permutation, straightforward schedule (constant layer,
// S-box [lane 0 only in partial rounds], full MDS) — algebraically identical
// to the fast-partial decomposition (reference hash/poseidon.rs:791
// poseidon_naive, proven equal by its consistency test).
static void permute_one(u64* s) {
  for (int rnd = 0; rnd < N_ROUNDS; rnd++) {
    bool full = rnd < HALF_FULL || rnd >= HALF_FULL + N_PARTIAL;
    for (int i = 0; i < PW; i++) s[i] = gadd(s[i], PO_RC[i + PW * rnd]);
    if (full) {
      for (int i = 0; i < PW; i++) s[i] = sbox7(s[i]);
    } else {
      s[0] = sbox7(s[0]);
    }
    mds_full(s);
  }
}

void poseidon_permute(u64* states, i64 n) {
  for (i64 k = 0; k < n; k++) permute_one(states + k * PW);
}

// Overwrite-mode sponge (reference hash/hashing.rs:118): absorb `in_len`
// felts in rate-8 chunks, squeeze `out_len` (<= 8) felts. Batched over n
// independent inputs laid out [n, in_len].
void poseidon_hash_no_pad(const u64* inputs, i64 in_len, u64* out,
                          i64 out_len, i64 n) {
  for (i64 k = 0; k < n; k++) {
    u64 s[PW] = {0};
    const u64* in = inputs + k * in_len;
    for (i64 off = 0; off < in_len; off += 8) {
      i64 m = in_len - off < 8 ? in_len - off : 8;
      for (i64 i = 0; i < m; i++) s[i] = in[off + i];
      permute_one(s);
    }
    for (i64 i = 0; i < out_len; i++) out[k * out_len + i] = s[i];
  }
}

// ---------------------------------------------------------------------------
// PoseidonGate witness kernel (dual of gates/poseidon_gate.py run_once).
//
// Per row: inputs[12], swap in {0,1}  ->  out[122] in wire order:
//   4 deltas, 36 full_sbox_0 (rounds 1..3 x 12), 22 partial_sbox,
//   48 full_sbox_1 (rounds 0..3 x 12), 12 outputs.
// Uses the FAST partial-round decomposition — the gate's constraint system
// is written against these intermediate values, so the decomposition is
// consensus-critical (reference hash/poseidon_goldilocks.rs:27-219).
// ---------------------------------------------------------------------------

static void poseidon_gate_row(const u64* in, u64 swap, u64* out) {
  {
    i64 w = 0;

    for (int i = 0; i < 4; i++)
      out[w++] = gmul(swap, gsub(in[i + 4], in[i]));

    u64 s[PW];
    memcpy(s, in, sizeof(s));
    if (swap == 1) {
      for (int i = 0; i < 4; i++) {
        u64 t = s[i];
        s[i] = s[i + 4];
        s[i + 4] = t;
      }
    }

    int round_ctr = 0;
    for (int r = 0; r < HALF_FULL; r++) {
      for (int i = 0; i < PW; i++) s[i] = gadd(s[i], PO_RC[i + PW * round_ctr]);
      if (r != 0)
        for (int i = 0; i < PW; i++) out[w++] = s[i];
      for (int i = 0; i < PW; i++) s[i] = sbox7(s[i]);
      mds_full(s);
      round_ctr++;
    }

    // partial rounds, fast w-hat/v decomposition
    for (int i = 0; i < PW; i++) s[i] = gadd(s[i], PO_FAST_FIRST[i]);
    {
      // mds_partial_layer_init: res[c] = sum_{r>=1} init[r-1][c-1] * s[r]
      u64 res[PW];
      res[0] = s[0];
      for (int c = 1; c < PW; c++) {
        u64 acc = 0;
        for (int r = 1; r < PW; r++)
          acc = gadd(acc, gmul(PO_FAST_INIT[r - 1][c - 1], s[r]));
        res[c] = acc;
      }
      memcpy(s, res, sizeof(res));
    }
    for (int r = 0; r < N_PARTIAL; r++) {
      out[w++] = s[0];
      u64 s0 = sbox7(s[0]);
      if (r != N_PARTIAL - 1) s0 = gadd(s0, PO_FAST_RC[r]);
      // mds_partial_layer_fast
      const u64 mds0to0 = 17 + 8; // CIRC[0] + DIAG[0]
      u64 d = gmul(mds0to0, s0);
      for (int i = 1; i < PW; i++)
        d = gadd(d, gmul(PO_FAST_W_HATS[r][i - 1], s[i]));
      u64 res[PW];
      res[0] = d;
      for (int i = 1; i < PW; i++)
        res[i] = gadd(gmul(PO_FAST_VS[r][i - 1], s0), s[i]);
      memcpy(s, res, sizeof(res));
    }
    round_ctr += N_PARTIAL;

    for (int r = 0; r < HALF_FULL; r++) {
      for (int i = 0; i < PW; i++) s[i] = gadd(s[i], PO_RC[i + PW * round_ctr]);
      for (int i = 0; i < PW; i++) out[w++] = s[i];
      for (int i = 0; i < PW; i++) s[i] = sbox7(s[i]);
      mds_full(s);
      round_ctr++;
    }

    for (int i = 0; i < PW; i++) out[w++] = s[i];
  }
}

void poseidon_gate_witness(const u64* inputs_all, const u64* swaps, u64* out_all,
                           i64 n) {
  for (i64 k = 0; k < n; k++)
    poseidon_gate_row(inputs_all + k * PW, swaps[k], out_all + k * 122);
}

// ---------------------------------------------------------------------------
// keccak-f[1600] over n states of 25 lanes, lane A[x + 5y] (dual of
// hash/keccak.py keccak_f_np; reference hash/keccak.rs).
// ---------------------------------------------------------------------------

static const u64 KC_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

static const int KC_ROT[5][5] = {{0, 36, 3, 41, 18},
                                 {1, 44, 10, 45, 2},
                                 {62, 6, 43, 15, 61},
                                 {28, 55, 25, 21, 56},
                                 {27, 20, 39, 8, 14}};

static inline u64 kc_rotl(u64 v, int r) {
  return r == 0 ? v : (v << r) | (v >> (64 - r));
}

void keccak_f1600(u64* states, i64 n) {
  for (i64 k = 0; k < n; k++) {
    u64* A = states + k * 25;
    for (int rnd = 0; rnd < 24; rnd++) {
      u64 C[5], D[5], B[25];
      for (int x = 0; x < 5; x++)
        C[x] = A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20];
      for (int x = 0; x < 5; x++)
        D[x] = C[(x + 4) % 5] ^ kc_rotl(C[(x + 1) % 5], 1);
      for (int x = 0; x < 5; x++)
        for (int y = 0; y < 5; y++) A[x + 5 * y] ^= D[x];
      for (int x = 0; x < 5; x++)
        for (int y = 0; y < 5; y++)
          B[y + 5 * ((2 * x + 3 * y) % 5)] = kc_rotl(A[x + 5 * y], KC_ROT[x][y]);
      for (int x = 0; x < 5; x++)
        for (int y = 0; y < 5; y++)
          A[x + 5 * y] = B[x + 5 * y] ^ (~B[(x + 1) % 5 + 5 * y] & B[(x + 2) % 5 + 5 * y]);
      A[0] ^= KC_RC[rnd];
    }
  }
}

// ---------------------------------------------------------------------------
// Witness-plan executor (dual of the levelized batch engine in
// iop/generator.py). The Python side compiles a circuit's generator level
// schedule ONCE into flat op streams over partition-representative indices
// (iop/witness_plan.py); this runs a contiguous op range in a single call —
// no per-level Python dispatch, no numpy gather/scatter temporaries. Each
// opcode is an exact dual of one SimpleGenerator.run_once (reference
// iop/generator.rs:206-234 and the per-gate generators); input/output rep
// orders follow dependencies()/outputs() exactly.
//
// F_{p^2} = F_p[X]/(X^2-7) helpers (reference goldilocks_extensions.rs W=7).
// ---------------------------------------------------------------------------

static inline void e2mul(u64 a0, u64 a1, u64 b0, u64 b1, u64* r0, u64* r1) {
  u64 t = gmul(a1, b1);
  *r0 = gadd(gmul(a0, b0), gmul(7ull, t));
  *r1 = gadd(gmul(a0, b1), gmul(a1, b0));
}

enum WpOp {
  WP_COPY = 1,
  WP_ARITH_BASE = 2,
  WP_ARITH_EXT = 3,
  WP_MUL_EXT = 4,
  WP_POSEIDON = 5,
  WP_RANDOM_ACCESS = 6,
  WP_REDUCING = 7,
  WP_REDUCING_EXT = 8,
  WP_INTERPOLATION = 9,
  WP_QUOTIENT_EXT = 10,
  WP_BASE_SPLIT = 11,
  WP_WIRE_SPLIT = 12,
  WP_LOW_HIGH = 13,
  WP_INVERSE = 14,
  WP_EQUALITY = 15,
  WP_NONZERO = 16,
  WP_EXP = 17,
  WP_CONSTANT = 18,
  WP_RANDOM = 19,
  WP_LOOKUP = 20,        // aux = (table offset into aux, table len)
  WP_CONSTANT_PAIR = 21, // aux = (value0, value1) -> two outputs
};

struct WpCtx {
  u64* v;
  const int32_t* opcodes;
  const i64* in_off;
  const i64* out_off;
  const i64* aux_off;
  const i64* in_reps;
  const i64* out_reps;
  const u64* aux;
};

// Executes one op. Returns -1 on success, else the failing op index
// (assertion violation: bad access index, overflowing split, zero division —
// the Python caller raises with the generator's context).
static i64 wp_exec_op(const WpCtx& c, i64 op) {
  u64* v = c.v;
  const i64* in = c.in_reps + c.in_off[op];
  const i64* out = c.out_reps + c.out_off[op];
  const u64* ax = c.aux + c.aux_off[op];
  const i64 n_in = c.in_off[op + 1] - c.in_off[op];
  const i64 n_out = c.out_off[op + 1] - c.out_off[op];
  {
    switch (c.opcodes[op]) {
      case WP_COPY:
        v[out[0]] = v[in[0]];
        break;
      case WP_ARITH_BASE:
        // c0*(m0*m1) + c1*a (reference gates/arithmetic_base.rs generator)
        v[out[0]] = gadd(gmul(ax[0], gmul(v[in[0]], v[in[1]])),
                         gmul(ax[1], v[in[2]]));
        break;
      case WP_ARITH_EXT: {
        u64 p0, p1;
        e2mul(v[in[0]], v[in[1]], v[in[2]], v[in[3]], &p0, &p1);
        v[out[0]] = gadd(gmul(ax[0], p0), gmul(ax[1], v[in[4]]));
        v[out[1]] = gadd(gmul(ax[0], p1), gmul(ax[1], v[in[5]]));
        break;
      }
      case WP_MUL_EXT: {
        u64 p0, p1;
        e2mul(v[in[0]], v[in[1]], v[in[2]], v[in[3]], &p0, &p1);
        v[out[0]] = gmul(ax[0], p0);
        v[out[1]] = gmul(ax[0], p1);
        break;
      }
      case WP_POSEIDON: {
        u64 s[12], tmp[122];
        for (int i = 0; i < 12; i++) s[i] = v[in[i]];
        u64 swap = v[in[12]];
        if (swap > 1) return op;
        poseidon_gate_row(s, swap, tmp);
        for (int i = 0; i < 122; i++) v[out[i]] = tmp[i];
        break;
      }
      case WP_RANDOM_ACCESS: {
        // claimed = items[idx]; bit-decompose idx
        // (reference gates/random_access.rs generator)
        i64 vec = n_in - 1, bits = n_out - 1;
        u64 idx = v[in[0]];
        if (idx >= (u64)vec) return op;
        v[out[0]] = v[in[1 + idx]];
        for (i64 i = 0; i < bits; i++) v[out[1 + i]] = (idx >> i) & 1;
        break;
      }
      case WP_REDUCING: {
        // acc' = acc*alpha + coeff, base coeffs (reference gates/reducing.rs)
        i64 k = n_in - 4;
        u64 a0 = v[in[0]], a1 = v[in[1]], c0 = v[in[2]], c1 = v[in[3]];
        for (i64 j = 0; j < k; j++) {
          e2mul(c0, c1, a0, a1, &c0, &c1);
          c0 = gadd(c0, v[in[4 + j]]);
          v[out[2 * j]] = c0;
          v[out[2 * j + 1]] = c1;
        }
        v[out[2 * k]] = c0;
        v[out[2 * k + 1]] = c1;
        break;
      }
      case WP_REDUCING_EXT: {
        i64 k = (n_in - 4) / 2;
        u64 a0 = v[in[0]], a1 = v[in[1]], c0 = v[in[2]], c1 = v[in[3]];
        for (i64 j = 0; j < k; j++) {
          e2mul(c0, c1, a0, a1, &c0, &c1);
          c0 = gadd(c0, v[in[4 + 2 * j]]);
          c1 = gadd(c1, v[in[5 + 2 * j]]);
          v[out[2 * j]] = c0;
          v[out[2 * j + 1]] = c1;
        }
        v[out[2 * k]] = c0;
        v[out[2 * k + 1]] = c1;
        break;
      }
      case WP_INTERPOLATION: {
        // running barycentric first-form numerator over the coset
        // (reference gates/coset_interpolation.rs generator); aux layout:
        // [deg, N, domain[N], weights[N]]; in: shift, x(2), values(2N);
        // out: shifted_x(2), {eval(2), prod(2)} per intermediate, value(2).
        i64 deg = (i64)ax[0], N = (i64)ax[1];
        const u64* domain = ax + 2;
        const u64* wts = ax + 2 + N;
        u64 shift = v[in[0]];
        if (shift == 0) return op;
        u64 is = ginv(shift);
        u64 x0 = gmul(is, v[in[1]]), x1 = gmul(is, v[in[2]]);
        v[out[0]] = x0;
        v[out[1]] = x1;
        u64 ev0 = 0, ev1 = 0, pr0 = 1, pr1 = 0;
        i64 n_int = (N - 2) / (deg - 1);
        i64 w = 2;
        i64 lo = 0, hi = deg;
        for (i64 chunk = 0;; chunk++) {
          for (i64 j = lo; j < hi; j++) {
            u64 t0 = gsub(x0, domain[j]);
            u64 wv0 = gmul(wts[j], v[in[3 + 2 * j]]);
            u64 wv1 = gmul(wts[j], v[in[4 + 2 * j]]);
            u64 m0, m1, b0, b1;
            e2mul(ev0, ev1, t0, x1, &m0, &m1);
            e2mul(wv0, wv1, pr0, pr1, &b0, &b1);
            ev0 = gadd(m0, b0);
            ev1 = gadd(m1, b1);
            e2mul(pr0, pr1, t0, x1, &pr0, &pr1);
          }
          if (chunk == n_int) break;
          v[out[w++]] = ev0;
          v[out[w++]] = ev1;
          v[out[w++]] = pr0;
          v[out[w++]] = pr1;
          lo = 1 + (deg - 1) * (chunk + 1);
          hi = lo + deg - 1 < N ? lo + deg - 1 : N;
        }
        v[out[w++]] = ev0;
        v[out[w++]] = ev1;
        break;
      }
      case WP_QUOTIENT_EXT: {
        // q = num/den in F_{p^2}: inv(d) = (d0,-d1)/(d0^2 - 7 d1^2)
        u64 d0 = v[in[2]], d1 = v[in[3]];
        u64 norm = gsub(gmul(d0, d0), gmul(7ull, gmul(d1, d1)));
        if (norm == 0) return op;
        u64 ni = ginv(norm);
        u64 i0 = gmul(d0, ni), i1 = gmul(gsub(0, d1), ni);
        e2mul(v[in[0]], v[in[1]], i0, i1, &v[out[0]], &v[out[1]]);
        break;
      }
      case WP_BASE_SPLIT: {
        // base-B limb decomposition (reference gates/base_sum.rs generator)
        u64 base = ax[0], x = v[in[0]];
        for (i64 i = 0; i < n_out; i++) {
          v[out[i]] = x % base;
          x /= base;
        }
        if (x != 0) return op;
        break;
      }
      case WP_WIRE_SPLIT: {
        i64 nl = (i64)ax[0];
        u64 mask = (nl >= 64) ? ~0ull : ((1ull << nl) - 1);
        u64 x = v[in[0]];
        for (i64 i = 0; i < n_out; i++) {
          v[out[i]] = x & mask;
          x >>= nl;
        }
        if (x != 0) return op;
        break;
      }
      case WP_LOW_HIGH: {
        i64 nl = (i64)ax[0];
        u64 mask = (nl >= 64) ? ~0ull : ((1ull << nl) - 1);
        u64 x = v[in[0]];
        v[out[0]] = x & mask;
        v[out[1]] = (nl >= 64) ? 0 : (x >> nl);
        break;
      }
      case WP_INVERSE:
        if (v[in[0]] == 0) return op;
        v[out[0]] = ginv(v[in[0]]);
        break;
      case WP_EQUALITY: {
        u64 d = gsub(v[in[0]], v[in[1]]);
        v[out[0]] = d == 0 ? 1 : 0;
        v[out[1]] = d == 0 ? 0 : ginv(d);
        break;
      }
      case WP_NONZERO:
        v[out[0]] = v[in[0]] == 0 ? 1 : ginv(v[in[0]]);
        break;
      case WP_EXP: {
        // square-and-multiply intermediates (reference
        // gates/exponentiation.rs generator); bits big-endian in the scan
        i64 b = n_in - 1;
        if (b <= 0) return op;  // 0 power bits would read out[-1] below
        u64 base = v[in[0]], cur = 1;
        for (i64 i = 0; i < b; i++) {
          if (v[in[1 + (b - i - 1)]] == 1) cur = gmul(cur, base);
          v[out[i]] = cur;
          cur = gmul(cur, cur);
        }
        v[out[b]] = v[out[b - 1]];
        break;
      }
      case WP_CONSTANT:
      case WP_RANDOM:
        // WP_RANDOM's aux slot is refreshed by the Python caller per run
        // from the seedable prover rng (util/rng.py)
        v[out[0]] = ax[0];
        break;
      case WP_LOOKUP: {
        // LUT lookup (gates/lookup.rs LookupGenerator): the (inp, out)
        // pairs live ONCE per table at the tail of the shared aux buffer;
        // identity-keyed tables (key k at slot k) take the O(1) fast path.
        u64 inp = v[in[0]];
        const u64* t = c.aux + (i64)ax[0];
        i64 n = (i64)ax[1];
        if ((i64)inp < n && t[2 * (i64)inp] == inp) {
          v[out[0]] = t[2 * (i64)inp + 1];
          break;
        }
        i64 j = 0;
        for (; j < n; j++)
          if (t[2 * j] == inp) { v[out[0]] = t[2 * j + 1]; break; }
        if (j == n) return op;  // input not in the LUT
        break;
      }
      case WP_CONSTANT_PAIR:
        v[out[0]] = ax[0];
        v[out[1]] = ax[1];
        break;
      default:
        return op;
    }
  }
  return -1;
}

i64 witness_plan_run(u64* v, const int32_t* opcodes, const i64* in_off,
                     const i64* out_off, const i64* aux_off,
                     const i64* in_reps, const i64* out_reps, const u64* aux,
                     i64 op_start, i64 op_end) {
  WpCtx c{v, opcodes, in_off, out_off, aux_off, in_reps, out_reps, aux};
  for (i64 op = op_start; op < op_end; op++) {
    i64 e = wp_exec_op(c, op);
    if (e >= 0) return e;
  }
  return -1;
}

} // extern "C"

// ---------------------------------------------------------------------------
// Threaded plan execution. Ops between two consecutive barrier indices form
// one dependency level (iop/generator.py _levelize): independent of each
// other, so workers grab them via an atomic cursor; a barrier syncs before
// the next level. Cheap levels run on the calling thread (pool wake costs
// ~10 us; an arithmetic op costs ~50 ns). The pool persists across calls —
// workers sleep on a condition variable between tasks.
// ---------------------------------------------------------------------------

#include <atomic>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct WpPool {
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  u64 gen = 0;
  int workers_done = 0;
  int n_workers = 0;
  bool shutdown = false;
  std::vector<std::thread> threads;

  // current task
  const WpCtx* ctx = nullptr;
  std::atomic<i64> cursor{0};
  i64 task_end = 0;
  std::atomic<i64> err{-1};

  void worker() {
    u64 seen = 0;
    while (true) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return gen != seen || shutdown; });
        if (shutdown) return;
        seen = gen;
      }
      run_range();
      {
        std::lock_guard<std::mutex> lk(mu);
        if (++workers_done == n_workers) cv_done.notify_one();
      }
    }
  }

  void run_range() {
    i64 op;
    while ((op = cursor.fetch_add(1, std::memory_order_relaxed)) < task_end) {
      i64 e = wp_exec_op(*ctx, op);
      if (e >= 0) err.store(e, std::memory_order_relaxed);
    }
  }

  void start(int n) {
    n_workers = n;
    for (int i = 0; i < n; i++) threads.emplace_back([this] { worker(); });
  }

  // runs [start_op, end_op) in parallel with the calling thread participating
  void run_level(const WpCtx& c, i64 start_op, i64 end_op) {
    {
      std::lock_guard<std::mutex> lk(mu);
      ctx = &c;
      cursor.store(start_op, std::memory_order_relaxed);
      task_end = end_op;
      workers_done = 0;
      gen++;
    }
    cv_work.notify_all();
    run_range();
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [&] { return workers_done == n_workers; });
  }
};

WpPool* wp_pool = nullptr;
int wp_pool_size = 0;

// rough per-op cost weights (units of ~an arithmetic op) for the
// parallelize-or-not decision per level
inline i64 wp_op_cost(int32_t opcode, i64 n_in) {
  switch (opcode) {
    case WP_POSEIDON: return 200;
    case WP_INTERPOLATION: return 150;  // ginv + ext2 recurrence
    case WP_QUOTIENT_EXT:
    case WP_INVERSE:
    case WP_EQUALITY:
    case WP_NONZERO: return 40;  // ginv-dominated
    case WP_REDUCING:
    case WP_REDUCING_EXT:
    case WP_EXP: return 4 * n_in;
    default: return 2;
  }
}

}  // namespace

extern "C" {

// Threaded variant: barriers[0..nb-1] are ascending op indices; each
// consecutive pair is one level. nthreads <= 0 disables the pool.
i64 witness_plan_run_mt(u64* v, const int32_t* opcodes, const i64* in_off,
                        const i64* out_off, const i64* aux_off,
                        const i64* in_reps, const i64* out_reps,
                        const u64* aux, const i64* barriers, i64 nb,
                        i64 nthreads) {
  WpCtx c{v, opcodes, in_off, out_off, aux_off, in_reps, out_reps, aux};
  int extra = (int)nthreads - 1;
  if (extra > 0 && (wp_pool == nullptr || wp_pool_size < extra)) {
    // grow-only singleton pool (never destroyed; threads sleep when idle)
    if (wp_pool == nullptr) {
      wp_pool = new WpPool();
      wp_pool->start(extra);
      wp_pool_size = extra;
    }
  }
  const i64 kParThreshold = 600;  // ~3 poseidons
  for (i64 b = 0; b + 1 < nb; b++) {
    i64 lo = barriers[b], hi = barriers[b + 1];
    i64 cost = 0;
    if (extra > 0 && wp_pool != nullptr)
      for (i64 op = lo; op < hi && cost < kParThreshold; op++)
        cost += wp_op_cost(opcodes[op], in_off[op + 1] - in_off[op]);
    if (cost >= kParThreshold) {
      wp_pool->err.store(-1, std::memory_order_relaxed);
      wp_pool->run_level(c, lo, hi);
      i64 e = wp_pool->err.load(std::memory_order_relaxed);
      if (e >= 0) return e;
    } else {
      for (i64 op = lo; op < hi; op++) {
        i64 e = wp_exec_op(c, op);
        if (e >= 0) return e;
      }
    }
  }
  return -1;
}

} // extern "C"
