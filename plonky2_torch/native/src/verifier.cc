// Standalone native verifier for plonky2 proofs in the reference byte
// format: the port's host-side verification binary and an independent,
// second implementation of the verification algorithm written only from
// the serialized formats (reference util/serialization/mod.rs) and the
// protocol spec (reference plonk/verifier.rs:17-118, fri/verifier.rs:62-241,
// plonk/get_challenges.rs:26-95).
//
//   plonky2_verify [--keccak] [--compressed] <verifier_data.bin> <proof.bin>
//   plonky2_verify --stark[=fibonacci|permutation] <stark_proof.bin>
//
// verifier_data.bin = VerifierCircuitData (verifier_only ++ common) as
// written by write_verifier_circuit_data; proof.bin = ProofWithPublicInputs.
// Exits 0 and prints OK when the proof verifies, 1 with a diagnostic when
// it does not, and 2 on a malformed command line (an unknown flag too).
// Default PoseidonGoldilocksConfig (the recursion-capable config);
// --keccak selects KeccakGoldilocksConfig (truncated keccak-256 Merkle
// digests + hash-onion challenger, Poseidon inner hasher; reference
// plonk/config.rs:118-126, hash/keccak.rs).
//
// Poseidon constant tables are generated from the port's protocol constants
// into poseidon_tables.inc at build time (plonky2_torch/native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <tuple>
#include <vector>
#include <array>
#include <stdexcept>

typedef uint64_t u64;
typedef uint32_t u32;
typedef unsigned __int128 u128;

static const u64 P = 0xFFFFFFFF00000001ull;
static const u64 EPSILON = 0xFFFFFFFFull; // 2^32 - 1
static const u64 MULT_GROUP_GEN = 14293326489335486720ull;
static const u64 POW2_GEN = 7277203076849721926ull; // order 2^32
static const int TWO_ADICITY = 32;
static const u64 UNUSED_SELECTOR = (1ull << 32) - 1;

#include "poseidon_tables.inc"

// ---------------------------------------------------------------------------
// Goldilocks base field
// ---------------------------------------------------------------------------

static inline u64 gl_add(u64 a, u64 b) {
  u64 s = a + b;
  if (s < a || s >= P) s -= P;  // a,b canonical => at most one subtraction
  return s;
}
static inline u64 gl_sub(u64 a, u64 b) { return a >= b ? a - b : a + P - b; }
static inline u64 gl_neg(u64 a) { return a ? P - a : 0; }
static inline u64 reduce128(u128 x) {
  u64 lo = (u64)x, hi = (u64)(x >> 64);
  u64 hi_lo = hi & EPSILON, hi_hi = hi >> 32;
  u64 t = lo - hi_hi;
  if (lo < hi_hi) t -= EPSILON;  // wraps correctly mod p
  u64 t2 = t + hi_lo * EPSILON;
  if (t2 < t) t2 += EPSILON;
  if (t2 >= P) t2 -= P;
  return t2;
}
static inline u64 gl_mul(u64 a, u64 b) { return reduce128((u128)a * b); }
static u64 gl_exp(u64 a, u64 e) {
  u64 r = 1;
  while (e) { if (e & 1) r = gl_mul(r, a); a = gl_mul(a, a); e >>= 1; }
  return r;
}
static u64 gl_inv(u64 a) {
  if (a == 0) throw std::runtime_error("division by zero");
  return gl_exp(a, P - 2);
}
static u64 root_of_unity(int n_log) {
  return gl_exp(POW2_GEN, 1ull << (TWO_ADICITY - n_log));
}
static u64 reverse_bits(u64 x, int bits) {
  u64 r = 0;
  for (int i = 0; i < bits; i++) r = (r << 1) | ((x >> i) & 1);
  return r;
}

// ---------------------------------------------------------------------------
// Quadratic extension F_{p^2} = F_p[x]/(x^2 - 7)
// ---------------------------------------------------------------------------

struct E { u64 a, b; };
static const E EZERO{0, 0}, EONE{1, 0};
static inline bool eeq(E x, E y) { return x.a == y.a && x.b == y.b; }
static inline E efrom(u64 x) { return E{x, 0}; }
static inline E eadd(E x, E y) { return E{gl_add(x.a, y.a), gl_add(x.b, y.b)}; }
static inline E esub(E x, E y) { return E{gl_sub(x.a, y.a), gl_sub(x.b, y.b)}; }
static inline E eneg(E x) { return E{gl_neg(x.a), gl_neg(x.b)}; }
static inline E emul(E x, E y) {
  // (a + b w)(c + d w) = ac + 7 bd + (ad + bc) w
  u64 a = gl_add(gl_mul(x.a, y.a), gl_mul(7, gl_mul(x.b, y.b)));
  u64 b = gl_add(gl_mul(x.a, y.b), gl_mul(x.b, y.a));
  return E{a, b};
}
static inline E escalar(u64 c, E x) { return E{gl_mul(c, x.a), gl_mul(c, x.b)}; }
static E einv(E x) {
  u64 norm = gl_sub(gl_mul(x.a, x.a), gl_mul(7, gl_mul(x.b, x.b)));
  u64 ninv = gl_inv(norm);
  return E{gl_mul(x.a, ninv), gl_mul(gl_neg(x.b), ninv)};
}
static inline E ediv(E x, E y) { return emul(x, einv(y)); }
static E eexp(E x, u64 e) {
  E r = EONE;
  while (e) { if (e & 1) r = emul(r, x); x = emul(x, x); e >>= 1; }
  return r;
}
static inline E eaddc(E x, u64 c) { return E{gl_add(x.a, c % P), x.b}; }

// Extension algebra: F_{p^2}[X]/(X^2 - 7) with E coefficients
// (reference field/src/extension/algebra.rs; used by extension-arity gates).
struct EA { E c0, c1; };
static inline EA ea_from(E x) { return EA{x, EZERO}; }
static inline EA ea_add(EA x, EA y) { return EA{eadd(x.c0, y.c0), eadd(x.c1, y.c1)}; }
static inline EA ea_sub(EA x, EA y) { return EA{esub(x.c0, y.c0), esub(x.c1, y.c1)}; }
static inline EA ea_scalar(E c, EA x) { return EA{emul(c, x.c0), emul(c, x.c1)}; }
static inline EA ea_mul(EA x, EA y) {
  E lo = eadd(emul(x.c0, y.c0), escalar(7, emul(x.c1, y.c1)));
  E hi = eadd(emul(x.c0, y.c1), emul(x.c1, y.c0));
  return EA{lo, hi};
}

// ---------------------------------------------------------------------------
// Poseidon permutation (naive round schedule — algebraically identical to the
// fast-partial form; reference hash/poseidon.rs poseidon() vs poseidon_naive())
// ---------------------------------------------------------------------------

static const int SPONGE_W = 12, SPONGE_RATE = 8;
static const int HALF_FULL = 4, N_PARTIAL = 22, N_ROUNDS = 30;

static inline u64 sbox7(u64 x) {
  u64 x2 = gl_mul(x, x);
  u64 x3 = gl_mul(x2, x);
  return gl_mul(gl_mul(x3, x3), x);
}

static void poseidon(u64 s[12]) {
  for (int rnd = 0; rnd < N_ROUNDS; rnd++) {
    bool full = rnd < HALF_FULL || rnd >= HALF_FULL + N_PARTIAL;
    for (int i = 0; i < 12; i++) s[i] = gl_add(s[i], PO_RC[i + 12 * rnd] % P);
    if (full) { for (int i = 0; i < 12; i++) s[i] = sbox7(s[i]); }
    else s[0] = sbox7(s[0]);
    u64 t[12];
    for (int r = 0; r < 12; r++) {
      u128 acc = 0;  // MDS entries are tiny (<64): 12 terms of <2^70 fit u128
      for (int i = 0; i < 12; i++) acc += (u128)PO_MDS[r][i] * s[i];
      t[r] = reduce128(acc);
    }
    memcpy(s, t, sizeof t);
  }
}

typedef std::array<u64, 4> Digest;

// ---------------------------------------------------------------------------
// Keccak-256 (original Keccak padding) + KeccakHash<25>
// (reference hash/keccak.rs; tiny-keccak semantics)
// ---------------------------------------------------------------------------

static bool KECCAK = false; // config flag: KeccakGoldilocksConfig

static inline u64 rotl64(u64 x, int s) { return s ? (x << s) | (x >> (64 - s)) : x; }

static void keccak_f(u64 a[25]) {
  static const u64 RC[24] = {
      0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808aull,
      0x8000000080008000ull, 0x000000000000808bull, 0x0000000080000001ull,
      0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008aull,
      0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000aull,
      0x000000008000808bull, 0x800000000000008bull, 0x8000000000008089ull,
      0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
      0x000000000000800aull, 0x800000008000000aull, 0x8000000080008081ull,
      0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};
  static const int ROT[25] = {0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43,
                              25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14};
  for (int rnd = 0; rnd < 24; rnd++) {
    u64 c[5], d[5], b[25];
    for (int x = 0; x < 5; x++)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; x++) d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
    for (int i = 0; i < 25; i++) a[i] ^= d[i % 5];
    for (int y = 0; y < 5; y++)
      for (int x = 0; x < 5; x++)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y], ROT[x + 5 * y]);
    for (int y = 0; y < 5; y++)
      for (int x = 0; x < 5; x++)
        a[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]);
    a[0] ^= RC[rnd];
  }
}

static std::array<uint8_t, 32> keccak256(const std::vector<uint8_t>& data) {
  const size_t RATE = 136;
  u64 st[25] = {0};
  uint8_t* stb = (uint8_t*)st; // little-endian host assumed (x86/aarch64)
  size_t i = 0;
  std::vector<uint8_t> padded = data;
  padded.push_back(0x01);
  while (padded.size() % RATE != 0) padded.push_back(0x00);
  padded[padded.size() - 1] |= 0x80;
  for (i = 0; i < padded.size(); i += RATE) {
    for (size_t j = 0; j < RATE; j++) stb[j] ^= padded[i + j];
    keccak_f(st);
  }
  std::array<uint8_t, 32> out;
  memcpy(out.data(), stb, 32);
  return out;
}

typedef std::array<uint8_t, 25> BDigest;

static std::vector<uint8_t> felts_to_bytes(const std::vector<u64>& in) {
  std::vector<uint8_t> b(in.size() * 8);
  for (size_t i = 0; i < in.size(); i++) memcpy(b.data() + 8 * i, &in[i], 8);
  return b;
}

static Digest hash_no_pad(const std::vector<u64>& in) {
  u64 st[12] = {0};
  for (size_t i = 0; i < in.size(); i += SPONGE_RATE) {
    size_t c = std::min((size_t)SPONGE_RATE, in.size() - i);
    for (size_t j = 0; j < c; j++) st[j] = in[i + j];
    poseidon(st);
  }
  return Digest{st[0], st[1], st[2], st[3]};
}

static Digest hash_or_noop(const std::vector<u64>& in) {
  if (in.size() <= 4) {
    Digest d{0, 0, 0, 0};
    for (size_t i = 0; i < in.size(); i++) d[i] = in[i];
    return d;
  }
  return hash_no_pad(in);
}

static Digest two_to_one(const Digest& l, const Digest& r) {
  std::vector<u64> in(l.begin(), l.end());
  in.insert(in.end(), r.begin(), r.end());
  return hash_no_pad(in);
}

// Generic digest: Poseidon HashOut (4 felts) or KeccakHash<25> bytes,
// selected by the KECCAK config flag.
struct GD {
  Digest f{0, 0, 0, 0};
  BDigest b{};
  bool is_b = false; // byte (keccak) digest vs felt (poseidon) digest
  bool operator==(const GD& o) const { return is_b ? b == o.b : f == o.f; }
  bool operator!=(const GD& o) const { return !(*this == o); }
};

static GD gd_from_felts(const Digest& d) { GD g; g.f = d; return g; }

static GD gd_hash_or_noop(const std::vector<u64>& in) {
  GD g;
  g.is_b = KECCAK;
  if (!KECCAK) { g.f = hash_or_noop(in); return g; }
  if (in.size() * 8 <= 25) {
    g.b.fill(0);
    for (size_t i = 0; i < in.size(); i++) memcpy(g.b.data() + 8 * i, &in[i], 8);
  } else {
    auto h = keccak256(felts_to_bytes(in));
    memcpy(g.b.data(), h.data(), 25);
  }
  return g;
}

static GD gd_two_to_one(const GD& l, const GD& r) {
  GD g;
  g.is_b = KECCAK;
  if (!KECCAK) { g.f = two_to_one(l.f, r.f); return g; }
  std::vector<uint8_t> in(l.b.begin(), l.b.end());
  in.insert(in.end(), r.b.begin(), r.b.end());
  auto h = keccak256(in);
  memcpy(g.b.data(), h.data(), 25);
  return g;
}

// 7-byte chunks -> felts (reference hash_types.rs:184-194)
static std::vector<u64> gd_to_felts(const GD& d) {
  if (!d.is_b) return {d.f[0], d.f[1], d.f[2], d.f[3]};
  std::vector<u64> out;
  for (size_t i = 0; i < 25; i += 7) {
    u64 w = 0;
    size_t c = std::min((size_t)7, (size_t)25 - i);
    memcpy(&w, d.b.data() + i, c);
    out.push_back(w);
  }
  return out;
}

// Keccak pseudo-permutation for the challenger: hash-onion + rejection
// sampling into canonical felts (reference hash/keccak.rs:63-98).
static void keccak_permute(u64 s[12]) {
  std::vector<uint8_t> state_bytes(96);
  for (int i = 0; i < 12; i++) memcpy(state_bytes.data() + 8 * i, &s[i], 8);
  std::vector<u64> out;
  while (out.size() < 12) {
    auto digest = keccak256(state_bytes);
    state_bytes.assign(digest.begin(), digest.end());
    for (int i = 0; i < 4; i++) {
      u64 w;
      memcpy(&w, digest.data() + 8 * i, 8);
      if (w < P) out.push_back(w);
    }
  }
  for (int i = 0; i < 12; i++) s[i] = out[i];
}

// ---------------------------------------------------------------------------
// Fiat-Shamir challenger (duplex sponge, overwrite mode;
// reference iop/challenger.rs:16-153)
// ---------------------------------------------------------------------------

struct Challenger {
  u64 st[12] = {0};
  std::vector<u64> in, out;

  void duplex() {
    for (size_t i = 0; i < in.size(); i++) st[i] = in[i];
    in.clear();
    if (KECCAK) keccak_permute(st); else poseidon(st);
    out.assign(st, st + SPONGE_RATE);
  }
  void observe(u64 x) {
    out.clear();
    in.push_back(x);
    if ((int)in.size() == SPONGE_RATE) duplex();
  }
  void observe_ext(E x) { observe(x.a); observe(x.b); }
  void observe_digest(const GD& d) { for (u64 x : gd_to_felts(d)) observe(x); }
  void observe_cap(const std::vector<GD>& cap) {
    for (const auto& d : cap) observe_digest(d);
  }
  u64 challenge() {
    if (!in.empty() || out.empty()) duplex();
    u64 x = out.back();
    out.pop_back();
    return x;
  }
  E ext_challenge() { u64 a = challenge(); u64 b = challenge(); return E{a, b}; }
};

// ---------------------------------------------------------------------------
// Byte reader (reference util/serialization/mod.rs read_* methods)
// ---------------------------------------------------------------------------

struct Reader {
  const uint8_t* p;
  size_t n, pos = 0;
  Reader(const uint8_t* d, size_t len) : p(d), n(len) {}
  void need(size_t k) {
    if (pos + k > n) throw std::runtime_error("unexpected end of buffer");
  }
  uint8_t u8() { need(1); return p[pos++]; }
  u32 read_u32() { need(4); u32 x; memcpy(&x, p + pos, 4); pos += 4; return x; }
  uint16_t u16() { need(2); uint16_t x; memcpy(&x, p + pos, 2); pos += 2; return x; }
  u64 usize() { need(8); u64 x; memcpy(&x, p + pos, 8); pos += 8; return x; }
  u64 field() {
    u64 x = usize();
    if (x >= P) throw std::runtime_error("non-canonical field element");
    return x;
  }
  E ext() { u64 a = field(); u64 b = field(); return E{a, b}; }
  std::vector<u64> fields(size_t k) {
    std::vector<u64> v(k);
    for (auto& x : v) x = field();
    return v;
  }
  std::vector<E> exts(size_t k) {
    std::vector<E> v(k);
    for (auto& x : v) x = ext();
    return v;
  }
  Digest digest() { Digest d; for (auto& x : d) x = field(); return d; }
  GD gdigest() {
    GD g;
    g.is_b = KECCAK;
    if (KECCAK) { need(25); memcpy(g.b.data(), p + pos, 25); pos += 25; }
    else g.f = digest();
    return g;
  }
  std::vector<u64> usize_vec() {
    size_t k = usize();
    std::vector<u64> v(k);
    for (auto& x : v) x = usize();
    return v;
  }
};

// ---------------------------------------------------------------------------
// Circuit data (reference plonk/circuit_data.rs; serialization per this
// repo's plonk/circuit_serialization.py == write_common_circuit_data)
// ---------------------------------------------------------------------------

struct FriConfigC {
  u64 rate_bits, cap_height, num_query_rounds;
  u32 pow_bits;
  int strat_kind;               // 0 fixed, 1 constant arity, 2 min size
  std::vector<u64> strat_fixed; // kind 0
  u64 arity_bits = 0, final_poly_bits = 0; // kind 1
  bool has_max = false; u64 max_arity = 0; // kind 2
  std::vector<u64> strategy_felts() const {
    if (strat_kind == 0) {
      std::vector<u64> v{0};
      v.insert(v.end(), strat_fixed.begin(), strat_fixed.end());
      return v;
    }
    if (strat_kind == 1) return {1, arity_bits, final_poly_bits};
    return {2, has_max ? max_arity : 0};
  }
};
struct FriParamsC {
  FriConfigC cfg;
  bool hiding;
  u64 degree_bits;
  std::vector<u64> arities;
  u64 lde_bits() const { return degree_bits + cfg.rate_bits; }
  u64 lde_size() const { return 1ull << lde_bits(); }
  void observe(Challenger& ch) const {
    ch.observe(cfg.rate_bits);
    ch.observe(cfg.cap_height);
    ch.observe(cfg.pow_bits);
    for (u64 x : cfg.strategy_felts()) ch.observe(x);
    ch.observe(cfg.num_query_rounds);
    ch.observe(hiding ? 1 : 0);
    ch.observe(degree_bits);
    for (u64 a : arities) ch.observe(a);
  }
};
struct ConfigC {
  u64 num_wires, num_routed_wires, num_constants, security_bits,
      num_challenges, max_qdf;
  bool use_base_arith, zk;
  FriConfigC fri;
};

enum GateTag {
  G_ARITH = 0, G_ARITH_EXT, G_BASE_SUM, G_CONSTANT, G_COSET_INTERP,
  G_EXPO, G_LOOKUP, G_LOOKUP_TABLE, G_MUL_EXT, G_NOOP, G_POSEIDON_MDS,
  G_POSEIDON, G_PUBLIC_INPUT, G_RANDOM_ACCESS, G_REDUCING_EXT, G_REDUCING,
};

struct GateC {
  int tag;
  u64 num_ops = 0;      // arith/mul ext ops, base-sum limbs, constant consts,
                        // expo bits, reducing coeffs, lookup slots
  u64 p1 = 0, p2 = 0;   // random access: copies, extra consts;
                        // lookup table: last row; coset: degree
  u64 subgroup_bits = 0;
  std::vector<u64> weights; // coset interpolation barycentric weights
};

struct CommonC {
  ConfigC config;
  FriParamsC fri_params;
  std::vector<u64> selector_indices;
  std::vector<std::pair<u64, u64>> groups;
  u64 qdf, num_gate_constraints, num_constants, num_public_inputs;
  std::vector<u64> k_is;
  u64 num_partial_products, num_lookup_polys, num_lookup_selectors;
  std::vector<std::vector<std::pair<uint16_t, uint16_t>>> luts;
  std::vector<GateC> gates;

  u64 degree_bits() const { return fri_params.degree_bits; }
  u64 degree() const { return 1ull << degree_bits(); }
  u64 num_zs_pp() const { return config.num_challenges * (1 + num_partial_products); }
  u64 num_all_lookup() const { return config.num_challenges * num_lookup_polys; }
  u64 num_quotient() const { return config.num_challenges * qdf; }
  u64 num_preprocessed() const { return num_constants + config.num_routed_wires; }
};

struct VerifierOnlyC {
  std::vector<GD> cap;
  GD circuit_digest;
};

static FriConfigC read_fri_config(Reader& r) {
  FriConfigC c;
  c.rate_bits = r.usize();
  c.cap_height = r.usize();
  c.num_query_rounds = r.usize();
  c.pow_bits = r.read_u32();
  c.strat_kind = r.u8();
  if (c.strat_kind == 0) c.strat_fixed = r.usize_vec();
  else if (c.strat_kind == 1) { c.arity_bits = r.usize(); c.final_poly_bits = r.usize(); }
  else if (c.strat_kind == 2) { c.has_max = r.u8() != 0; if (c.has_max) c.max_arity = r.usize(); }
  else throw std::runtime_error("bad reduction strategy tag");
  return c;
}

static CommonC read_common(Reader& r) {
  CommonC cd;
  cd.config.num_wires = r.usize();
  cd.config.num_routed_wires = r.usize();
  cd.config.num_constants = r.usize();
  cd.config.security_bits = r.usize();
  cd.config.num_challenges = r.usize();
  cd.config.max_qdf = r.usize();
  cd.config.use_base_arith = r.u8() != 0;
  cd.config.zk = r.u8() != 0;
  cd.config.fri = read_fri_config(r);
  cd.fri_params.cfg = read_fri_config(r);
  cd.fri_params.arities = r.usize_vec();
  cd.fri_params.degree_bits = r.usize();
  cd.fri_params.hiding = r.u8() != 0;
  cd.selector_indices = r.usize_vec();
  size_t ng = r.usize();
  for (size_t i = 0; i < ng; i++) {
    u64 a = r.usize(), b = r.usize();
    cd.groups.push_back({a, b});
  }
  cd.qdf = r.usize();
  cd.num_gate_constraints = r.usize();
  cd.num_constants = r.usize();
  cd.num_public_inputs = r.usize();
  cd.k_is = r.fields(r.usize());
  cd.num_partial_products = r.usize();
  cd.num_lookup_polys = r.usize();
  cd.num_lookup_selectors = r.usize();
  size_t nluts = r.usize();
  for (size_t i = 0; i < nluts; i++) {
    size_t len = r.usize();
    std::vector<std::pair<uint16_t, uint16_t>> lut(len);
    for (auto& e : lut) { e.first = r.u16(); e.second = r.u16(); }
    cd.luts.push_back(std::move(lut));
  }
  size_t ngates = r.usize();
  for (size_t i = 0; i < ngates; i++) {
    GateC g;
    g.tag = (int)r.read_u32();
    switch (g.tag) {
      case G_ARITH: case G_ARITH_EXT: case G_MUL_EXT:
      case G_BASE_SUM: case G_CONSTANT: case G_EXPO:
      case G_REDUCING: case G_REDUCING_EXT:
        g.num_ops = r.usize();
        break;
      case G_COSET_INTERP:
        g.subgroup_bits = r.usize();
        g.p2 = r.usize(); // degree
        g.weights = r.fields(r.usize());
        break;
      case G_LOOKUP:
        g.num_ops = r.usize(); g.p1 = r.usize(); r.pos += 32;
        break;
      case G_LOOKUP_TABLE:
        g.num_ops = r.usize(); g.p2 = r.usize(); g.p1 = r.usize(); r.pos += 32;
        break;
      case G_RANDOM_ACCESS:
        g.num_ops = r.usize(); g.p1 = r.usize(); g.p2 = r.usize();
        break;
      case G_NOOP: case G_POSEIDON: case G_POSEIDON_MDS: case G_PUBLIC_INPUT:
        break;
      default:
        throw std::runtime_error("unknown gate tag");
    }
    cd.gates.push_back(std::move(g));
  }
  return cd;
}

// ---------------------------------------------------------------------------
// Proof types (reference plonk/proof.rs; byte layout util/serialization)
// ---------------------------------------------------------------------------

struct MerkleProofC { std::vector<GD> sibs; };
struct OpeningSetC {
  std::vector<E> constants, sigmas, wires, zs, zs_next, lookup_zs,
      lookup_zs_next, partial_products, quotient;
};
struct FriQueryStepC { std::vector<E> evals; MerkleProofC mp; };
struct InitialOpen { std::vector<u64> evals; MerkleProofC mp; };
struct FriQueryRoundC { std::vector<InitialOpen> initial; std::vector<FriQueryStepC> steps; };
struct FriProofC {
  std::vector<std::vector<GD>> caps;
  std::vector<FriQueryRoundC> rounds;
  std::vector<E> final_poly;
  u64 pow_witness;
};
struct ProofC {
  std::vector<GD> wires_cap, zpp_cap, quot_cap;
  OpeningSetC open;
  FriProofC fri;
  std::vector<u64> public_inputs;
};

static MerkleProofC read_merkle_proof(Reader& r) {
  MerkleProofC m;
  size_t k = r.u8();
  for (size_t i = 0; i < k; i++) m.sibs.push_back(r.gdigest());
  return m;
}
static std::vector<GD> read_cap(Reader& r, u64 cap_height) {
  std::vector<GD> cap(1ull << cap_height);
  for (auto& d : cap) d = r.gdigest();
  return cap;
}

static ProofC read_proof(Reader& r, const CommonC& cd) {
  ProofC pf;
  u64 ch = cd.config.fri.cap_height;
  pf.wires_cap = read_cap(r, ch);
  pf.zpp_cap = read_cap(r, ch);
  pf.quot_cap = read_cap(r, ch);
  auto& o = pf.open;
  u64 nc = cd.config.num_challenges;
  o.constants = r.exts(cd.num_constants);
  o.sigmas = r.exts(cd.config.num_routed_wires);
  o.wires = r.exts(cd.config.num_wires);
  o.zs = r.exts(nc);
  o.zs_next = r.exts(nc);
  o.lookup_zs = r.exts(cd.num_all_lookup());
  o.lookup_zs_next = r.exts(cd.num_all_lookup());
  o.partial_products = r.exts(nc * cd.num_partial_products);
  o.quotient = r.exts(cd.num_quotient());
  // FRI proof
  const auto& fp = cd.fri_params;
  u64 salt = fp.hiding ? 4 : 0;
  std::vector<u64> leaves_per_oracle = {
      cd.num_preprocessed(), cd.config.num_wires + salt,
      cd.num_zs_pp() + cd.num_all_lookup() + salt, cd.num_quotient() + salt};
  for (size_t i = 0; i < fp.arities.size(); i++)
    pf.fri.caps.push_back(read_cap(r, fp.cfg.cap_height));
  for (u64 q = 0; q < fp.cfg.num_query_rounds; q++) {
    FriQueryRoundC rd;
    for (u64 nl : leaves_per_oracle) {
      InitialOpen io;
      io.evals = r.fields(nl);
      io.mp = read_merkle_proof(r);
      rd.initial.push_back(std::move(io));
    }
    for (u64 ab : fp.arities) {
      FriQueryStepC st;
      st.evals = r.exts(1ull << ab);
      st.mp = read_merkle_proof(r);
      rd.steps.push_back(std::move(st));
    }
    pf.fri.rounds.push_back(std::move(rd));
  }
  u64 final_bits = fp.degree_bits;
  for (u64 ab : fp.arities) final_bits -= ab;
  pf.fri.final_poly = r.exts(1ull << final_bits);
  pf.fri.pow_witness = r.field();
  pf.public_inputs = r.fields(r.usize());
  return pf;
}

// ---------------------------------------------------------------------------
// Gate constraint evaluation at a point (reference gates/*.rs eval_unfiltered;
// ported from this repo's ops-generic definitions, gates/*.py)
// ---------------------------------------------------------------------------

struct Vars {
  const std::vector<E>* consts;
  const std::vector<E>* wires;
  const E* pis_hash; // 4
  EA ea(u64 start) const { return EA{(*wires)[start], (*wires)[start + 1]}; }
};

static void eval_poseidon_gate(const Vars& v, std::vector<E>& out);

static void eval_gate(const GateC& g, const CommonC& cd, const Vars& v,
                      std::vector<E>& out) {
  const auto& w = *v.wires;
  const auto& cs = *v.consts;
  switch (g.tag) {
    case G_NOOP: case G_LOOKUP: case G_LOOKUP_TABLE:
      return;
    case G_ARITH: {
      E c0 = cs[0], c1 = cs[1];
      for (u64 i = 0; i < g.num_ops; i++) {
        E computed = eadd(emul(emul(w[4 * i], w[4 * i + 1]), c0),
                          emul(w[4 * i + 2], c1));
        out.push_back(esub(w[4 * i + 3], computed));
      }
      return;
    }
    case G_ARITH_EXT: {
      E c0 = cs[0], c1 = cs[1];
      for (u64 i = 0; i < g.num_ops; i++) {
        EA m0 = v.ea(8 * i), m1 = v.ea(8 * i + 2), ad = v.ea(8 * i + 4),
           o = v.ea(8 * i + 6);
        EA computed = ea_add(ea_scalar(c0, ea_mul(m0, m1)), ea_scalar(c1, ad));
        EA d = ea_sub(o, computed);
        out.push_back(d.c0); out.push_back(d.c1);
      }
      return;
    }
    case G_MUL_EXT: {
      E c0 = cs[0];
      for (u64 i = 0; i < g.num_ops; i++) {
        EA m0 = v.ea(6 * i), m1 = v.ea(6 * i + 2), o = v.ea(6 * i + 4);
        EA d = ea_sub(o, ea_scalar(c0, ea_mul(m0, m1)));
        out.push_back(d.c0); out.push_back(d.c1);
      }
      return;
    }
    case G_BASE_SUM: { // base 2
      u64 num_limbs = g.num_ops;
      E total = w[0];
      E computed = EZERO;
      for (u64 i = num_limbs; i > 0; i--)
        computed = eadd(escalar(2, computed), w[i]);
      out.push_back(esub(computed, total));
      for (u64 i = 1; i <= num_limbs; i++) { // limb * (limb - 1)
        out.push_back(emul(w[i], eaddc(w[i], P - 1)));
      }
      return;
    }
    case G_CONSTANT:
      for (u64 i = 0; i < g.num_ops; i++) out.push_back(esub(cs[i], w[i]));
      return;
    case G_PUBLIC_INPUT:
      for (int i = 0; i < 4; i++) out.push_back(esub(w[i], v.pis_hash[i]));
      return;
    case G_EXPO: {
      u64 nb = g.num_ops;
      E base = w[0];
      E output = w[1 + nb];
      for (u64 i = 0; i < nb; i++) {
        E prev = i == 0 ? EONE : emul(w[2 + nb + i - 1], w[2 + nb + i - 1]);
        E cur_bit = w[1 + (nb - i - 1)];
        E not_bit = esub(EONE, cur_bit);
        E computed = emul(prev, eadd(emul(cur_bit, base), not_bit));
        out.push_back(esub(computed, w[2 + nb + i]));
      }
      out.push_back(esub(output, w[2 + nb + nb - 1]));
      return;
    }
    case G_RANDOM_ACCESS: {
      u64 bits = g.num_ops, copies = g.p1, nx = g.p2;
      u64 vs = 1ull << bits;
      u64 start_extra = (2 + vs) * copies;
      u64 routed_used = start_extra + nx;
      for (u64 c = 0; c < copies; c++) {
        u64 base = (2 + vs) * c;
        E access = w[base];
        std::vector<E> items(vs);
        for (u64 i = 0; i < vs; i++) items[i] = w[base + 2 + i];
        E claimed = w[base + 1];
        std::vector<E> bvals(bits);
        for (u64 i = 0; i < bits; i++) bvals[i] = w[routed_used + c * bits + i];
        for (auto& b : bvals) out.push_back(emul(b, esub(b, EONE)));
        E recon = EZERO;
        for (u64 i = bits; i > 0; i--)
          recon = eadd(eadd(recon, recon), bvals[i - 1]);
        out.push_back(esub(recon, access));
        for (auto& b : bvals) {
          std::vector<E> nxt(items.size() / 2);
          for (size_t k = 0; k < nxt.size(); k++)
            nxt[k] = eadd(items[2 * k],
                          emul(b, esub(items[2 * k + 1], items[2 * k])));
          items = std::move(nxt);
        }
        out.push_back(esub(items[0], claimed));
      }
      for (u64 i = 0; i < nx; i++)
        out.push_back(esub(cs[i], w[start_extra + i]));
      return;
    }
    case G_REDUCING: {
      u64 ncf = g.num_ops;
      EA alpha = v.ea(2), acc = v.ea(4);
      u64 start_accs = 6 + ncf;
      for (u64 i = 0; i < ncf; i++) {
        EA computed = ea_add(ea_mul(acc, alpha), ea_from(w[6 + i]));
        EA next = (i == ncf - 1) ? v.ea(0) : v.ea(start_accs + 2 * i);
        EA d = ea_sub(computed, next);
        out.push_back(d.c0); out.push_back(d.c1);
        acc = next;
      }
      return;
    }
    case G_REDUCING_EXT: {
      u64 ncf = g.num_ops;
      EA alpha = v.ea(2), acc = v.ea(4);
      u64 start_accs = 6 + 2 * ncf;
      for (u64 i = 0; i < ncf; i++) {
        EA computed = ea_add(ea_mul(acc, alpha), v.ea(6 + 2 * i));
        EA next = (i == ncf - 1) ? v.ea(0) : v.ea(start_accs + 2 * i);
        EA d = ea_sub(computed, next);
        out.push_back(d.c0); out.push_back(d.c1);
        acc = next;
      }
      return;
    }
    case G_POSEIDON_MDS: {
      EA in[12], comp;
      for (int i = 0; i < 12; i++) in[i] = v.ea(2 * i);
      for (int r = 0; r < 12; r++) {
        comp = EA{EZERO, EZERO};
        for (int i = 0; i < 12; i++) {
          u64 coeff = PO_MDS[r][i];
          comp = ea_add(comp, EA{escalar(coeff, in[i].c0), escalar(coeff, in[i].c1)});
        }
        EA o = v.ea(2 * (12 + r));
        EA d = ea_sub(comp, o);
        out.push_back(d.c0); out.push_back(d.c1);
      }
      return;
    }
    case G_POSEIDON:
      eval_poseidon_gate(v, out);
      return;
    case G_COSET_INTERP: {
      u64 sb = g.subgroup_bits;
      u64 npts = 1ull << sb;
      u64 degree = g.p2;
      u64 n_inter = (npts - 2) / (degree - 1);
      u64 start_values = 1;
      u64 start_eval_pt = start_values + npts * 2;
      u64 start_eval_val = start_eval_pt + 2;
      u64 start_inter = start_eval_val + 2;
      u64 start_shifted = start_inter + 2 * 2 * n_inter;
      E shift = w[0];
      EA eval_pt = v.ea(start_eval_pt);
      EA shifted_pt = v.ea(start_shifted);
      {
        EA d = ea_sub(eval_pt, EA{emul(shift, shifted_pt.c0), emul(shift, shifted_pt.c1)});
        out.push_back(d.c0); out.push_back(d.c1);
      }
      // two-adic subgroup domain
      std::vector<u64> domain(npts);
      u64 gsub = root_of_unity((int)sb);
      domain[0] = 1;
      for (u64 i = 1; i < npts; i++) domain[i] = gl_mul(domain[i - 1], gsub);
      auto partial = [&](u64 d0, u64 d1, EA ev, EA prod) {
        for (u64 i = d0; i < d1; i++) {
          EA term = ea_sub(shifted_pt, ea_from(efrom(domain[i])));
          EA val = v.ea(start_values + 2 * i);
          u64 wt = g.weights[i];
          EA wv{escalar(wt, val.c0), escalar(wt, val.c1)};
          ev = ea_add(ea_mul(ev, term), ea_mul(wv, prod));
          prod = ea_mul(prod, term);
        }
        return std::make_pair(ev, prod);
      };
      auto [ev, prod] = partial(0, degree, EA{EZERO, EZERO}, ea_from(EONE));
      for (u64 i = 0; i < n_inter; i++) {
        EA iev = v.ea(start_inter + 2 * i);
        EA iprod = v.ea(start_inter + 2 * (n_inter + i));
        EA d1 = ea_sub(iev, ev);
        out.push_back(d1.c0); out.push_back(d1.c1);
        EA d2 = ea_sub(iprod, prod);
        out.push_back(d2.c0); out.push_back(d2.c1);
        u64 s = 1 + (degree - 1) * (i + 1);
        u64 e = std::min(s + degree - 1, npts);
        std::tie(ev, prod) = partial(s, e, iev, iprod);
      }
      EA evval = v.ea(start_eval_val);
      EA d = ea_sub(evval, ev);
      out.push_back(d.c0); out.push_back(d.c1);
      return;
    }
    default:
      throw std::runtime_error("gate eval not implemented");
  }
}

// PoseidonGate: fast partial-round decomposition over E
// (reference gates/poseidon.rs; this repo gates/poseidon_gate.py:174-237)
static void eval_poseidon_gate(const Vars& v, std::vector<E>& out) {
  const auto& w = *v.wires;
  const int WW = 12;
  const int WIRE_SWAP = 2 * WW;
  const int START_DELTA = 2 * WW + 1;
  const int START_FULL_0 = START_DELTA + 4;
  const int START_PARTIAL = START_FULL_0 + WW * (HALF_FULL - 1);
  const int START_FULL_1 = START_PARTIAL + N_PARTIAL;
  auto sbox = [](E x) {
    E x2 = emul(x, x);
    E x3 = emul(x2, x);
    return emul(emul(x3, x3), x);
  };
  E swap = w[WIRE_SWAP];
  out.push_back(emul(swap, eaddc(swap, P - 1)));
  for (int i = 0; i < 4; i++) {
    E lhs = w[i], rhs = w[i + 4], delta = w[START_DELTA + i];
    out.push_back(esub(emul(swap, esub(rhs, lhs)), delta));
  }
  E st[12];
  for (int i = 0; i < 4; i++) {
    E delta = w[START_DELTA + i];
    st[i] = eadd(w[i], delta);
    st[i + 4] = esub(w[i + 4], delta);
  }
  for (int i = 8; i < WW; i++) st[i] = w[i];

  int round_ctr = 0;
  auto constant_layer = [&](int rc) {
    for (int i = 0; i < WW; i++) st[i] = eaddc(st[i], PO_RC[i + WW * rc] % P);
  };
  auto mds_layer = [&]() {
    E t[12];
    for (int r = 0; r < WW; r++) {
      t[r] = EZERO;
      for (int i = 0; i < WW; i++)
        t[r] = eadd(t[r], escalar(PO_MDS[r][i] % P, st[i]));
    }
    memcpy(st, t, sizeof t);
  };
  for (int r = 0; r < HALF_FULL; r++) {
    constant_layer(round_ctr);
    if (r != 0) {
      for (int i = 0; i < WW; i++) {
        E sin = w[START_FULL_0 + WW * (r - 1) + i];
        out.push_back(esub(st[i], sin));
        st[i] = sin;
      }
    }
    for (int i = 0; i < WW; i++) st[i] = sbox(st[i]);
    mds_layer();
    round_ctr++;
  }
  // partial rounds, fast form
  for (int i = 0; i < WW; i++) st[i] = eaddc(st[i], PO_FAST_FIRST[i] % P);
  {
    E res[12];
    res[0] = st[0];
    for (int i = 1; i < WW; i++) res[i] = EZERO;
    for (int r = 1; r < WW; r++)
      for (int c = 1; c < WW; c++)
        res[c] = eadd(res[c], escalar(PO_FAST_INIT[r - 1][c - 1] % P, st[r]));
    memcpy(st, res, sizeof res);
  }
  auto partial_fast = [&](E s0, int r) {
    u64 mds0to0 = 17 + 8; // CIRC[0] + DIAG[0]
    E d = escalar(mds0to0, s0);
    for (int i = 1; i < WW; i++)
      d = eadd(d, escalar(PO_FAST_W_HATS[r][i - 1] % P, st[i]));
    E res[12];
    res[0] = d;
    for (int i = 1; i < WW; i++)
      res[i] = eadd(escalar(PO_FAST_VS[r][i - 1] % P, s0), st[i]);
    memcpy(st, res, sizeof res);
  };
  for (int r = 0; r < N_PARTIAL - 1; r++) {
    E sin = w[START_PARTIAL + r];
    out.push_back(esub(st[0], sin));
    E s0 = eaddc(sbox(sin), PO_FAST_RC[r] % P);
    partial_fast(s0, r);
  }
  {
    E sin = w[START_PARTIAL + N_PARTIAL - 1];
    out.push_back(esub(st[0], sin));
    partial_fast(sbox(sin), N_PARTIAL - 1);
  }
  round_ctr += N_PARTIAL;
  for (int r = 0; r < HALF_FULL; r++) {
    constant_layer(round_ctr);
    for (int i = 0; i < WW; i++) {
      E sin = w[START_FULL_1 + WW * r + i];
      out.push_back(esub(st[i], sin));
      st[i] = sin;
    }
    for (int i = 0; i < WW; i++) st[i] = sbox(st[i]);
    mds_layer();
    round_ctr++;
  }
  for (int i = 0; i < WW; i++) out.push_back(esub(st[i], w[WW + i]));
}

// ---------------------------------------------------------------------------
// Vanishing polynomial at zeta (reference plonk/vanishing_poly.rs:57-164)
// ---------------------------------------------------------------------------

static E compute_filter(u64 row, std::pair<u64, u64> group, E s, bool many) {
  E acc = EONE;
  for (u64 i = group.first; i < group.second; i++) {
    if (i == row) continue;
    acc = emul(acc, esub(efrom(i % P), s));
  }
  if (many) acc = emul(acc, esub(efrom(UNUSED_SELECTOR), s));
  return acc;
}

static std::vector<E> evaluate_gate_constraints(const CommonC& cd, const Vars& v) {
  std::vector<E> constraints(cd.num_gate_constraints, EZERO);
  u64 num_sel = cd.groups.size();
  u64 off = num_sel + cd.num_lookup_selectors;
  std::vector<E> gate_consts(v.consts->begin() + off, v.consts->end());
  Vars gv{&gate_consts, v.wires, v.pis_hash};
  for (size_t i = 0; i < cd.gates.size(); i++) {
    u64 si = cd.selector_indices[i];
    E f = compute_filter(i, cd.groups[si], (*v.consts)[si], num_sel > 1);
    std::vector<E> evals;
    eval_gate(cd.gates[i], cd, gv, evals);
    for (size_t k = 0; k < evals.size(); k++)
      constraints[k] = eadd(constraints[k], emul(f, evals[k]));
  }
  return constraints;
}

// LUT-binding polynomial eval at ChallengeDelta
// (reference vanishing_poly.rs get_lut_poly; this repo vanishing_poly.py:83-114)
static u64 eval_lut_poly(const CommonC& cd, size_t lut_index, const u64* deltas) {
  u64 b = deltas[1];
  const auto& lut = cd.luts[lut_index];
  u64 nb_slots = cd.config.num_routed_wires / 3;
  u64 n = lut.size();
  u64 rows = (n + nb_slots - 1) / nb_slots;
  u64 degree = nb_slots * rows;
  u64 nb_padded = (nb_slots - n % nb_slots) % nb_slots;
  std::vector<u64> coeffs;
  for (auto& e : lut) coeffs.push_back(gl_add(e.first, gl_mul(b, e.second)));
  u64 pad = gl_add(lut[0].first, gl_mul(b, lut[0].second));
  for (u64 i = 0; i < nb_padded; i++) coeffs.push_back(pad);
  while (coeffs.size() < degree) coeffs.push_back(0);
  // coeffs were reversed then Horner'd from the top over the reversed list —
  // equivalent to Horner over the ORIGINAL ascending order
  u64 acc = 0;
  for (auto it = coeffs.begin(); it != coeffs.end(); ++it)
    acc = gl_add(gl_mul(acc, deltas[3]), *it);
  return acc;
}

static void check_lookup_constraints(
    const CommonC& cd, const Vars& v, const std::vector<E>& local_zs,
    const std::vector<E>& next_zs, const std::vector<E>& lookup_selectors,
    const E* deltas, const std::vector<E>& lut_re_evals, std::vector<E>& out) {
  u64 num_lu = cd.config.num_routed_wires / 2;
  u64 num_lut = cd.config.num_routed_wires / 3;
  u64 lu_degree = cd.qdf - 1;
  u64 num_sldc = local_zs.size() - 1;
  u64 lut_degree = (num_lut + num_sldc - 1) / num_sldc;
  const auto& w = *v.wires;

  E z_re = local_zs[0], next_z_re = next_zs[0];
  E da = deltas[0], db = deltas[1], dalpha = deltas[2], dd = deltas[3];

  std::vector<E> looked(num_lut), looking(num_lu), lookup_combos(num_lut);
  for (u64 s = 0; s < num_lut; s++) {
    looked[s] = eadd(w[3 * s], emul(da, w[3 * s + 1]));
    lookup_combos[s] = eadd(w[3 * s], emul(db, w[3 * s + 1]));
  }
  for (u64 s = 0; s < num_lu; s++)
    looking[s] = eadd(w[2 * s], emul(da, w[2 * s + 1]));

  out.push_back(emul(lookup_selectors[3], local_zs[num_sldc]));
  out.push_back(emul(lookup_selectors[2], local_zs[1]));
  out.push_back(emul(lookup_selectors[2], z_re));
  for (u64 r = 4; r < cd.num_lookup_selectors; r++)
    out.push_back(emul(lookup_selectors[r], esub(z_re, lut_re_evals[r - 4])));

  E cur_sum = next_z_re;
  for (auto& e : lookup_combos) cur_sum = eadd(emul(cur_sum, dd), e);
  out.push_back(emul(lookup_selectors[0], esub(z_re, cur_sum)));

  std::vector<E> am_looked(num_lut), am_looking(num_lu);
  for (u64 i = 0; i < num_lut; i++) am_looked[i] = esub(dalpha, looked[i]);
  for (u64 i = 0; i < num_lu; i++) am_looking[i] = esub(dalpha, looking[i]);

  for (u64 poly = 0; poly < num_sldc; poly++) {
    u64 lut0 = poly * lut_degree, lut1 = std::min((poly + 1) * lut_degree, num_lut);
    u64 lu0 = poly * lu_degree, lu1 = std::min((poly + 1) * lu_degree, num_lu);
    E lut_prod = EONE, lu_prod = EONE;
    for (u64 i = lut0; i < lut1; i++) lut_prod = emul(lut_prod, am_looked[i]);
    for (u64 i = lu0; i < lu1; i++) lu_prod = emul(lu_prod, am_looking[i]);
    E lu_sum = EZERO;
    for (u64 i = lu0; i < lu1; i++) {
      E p = EONE;
      for (u64 j = lu0; j < lu1; j++) if (j != i) p = emul(p, am_looking[j]);
      lu_sum = eadd(lu_sum, p);
    }
    E lut_sum = EZERO;
    for (u64 i = lut0; i < lut1; i++) {
      E p = EONE;
      for (u64 j = lut0; j < lut1; j++) if (j != i) p = emul(p, am_looked[j]);
      lut_sum = eadd(lut_sum, emul(w[3 * i + 2], p));
    }
    E prev = poly == 0 ? next_zs[num_sldc] : local_zs[poly];
    E diff = esub(local_zs[poly + 1], prev);
    out.push_back(emul(lookup_selectors[0], esub(emul(lut_prod, diff), lut_sum)));
    out.push_back(emul(lookup_selectors[1], eadd(emul(lu_prod, diff), lu_sum)));
  }
}

static std::vector<E> eval_vanishing_poly(
    const CommonC& cd, E x, const Vars& v, const OpeningSetC& o,
    const std::vector<u64>& betas, const std::vector<u64>& gammas,
    const std::vector<u64>& alphas, const std::vector<u64>& deltas, E l_0_x) {
  u64 nc = cd.config.num_challenges;
  u64 nprods = cd.num_partial_products;
  u64 max_degree = cd.qdf;
  bool has_lookup = cd.num_lookup_polys != 0;

  std::vector<E> gate_terms = evaluate_gate_constraints(cd, v);

  std::vector<E> z1_terms, pp_terms, lookup_terms;
  for (u64 i = 0; i < nc; i++) {
    E z_x = o.zs[i], z_gx = o.zs_next[i];
    z1_terms.push_back(emul(l_0_x, eaddc(z_x, P - 1)));
    std::vector<E> nume, deno;
    E beta = efrom(betas[i]), gamma = efrom(gammas[i]);
    for (u64 j = 0; j < cd.config.num_routed_wires; j++) {
      E wv = (*v.wires)[j];
      E s_id = escalar(cd.k_is[j], x);
      nume.push_back(eadd(wv, eadd(emul(beta, s_id), gamma)));
      deno.push_back(eadd(wv, eadd(emul(beta, o.sigmas[j]), gamma)));
    }
    std::vector<E> accs;
    accs.push_back(z_x);
    for (u64 k = 0; k < nprods; k++) accs.push_back(o.partial_products[i * nprods + k]);
    accs.push_back(z_gx);
    u64 num_chunks = (nume.size() + max_degree - 1) / max_degree;
    for (u64 c = 0; c < num_chunks; c++) {
      E np = nume[c * max_degree], dp = deno[c * max_degree];
      for (u64 k = c * max_degree + 1; k < std::min((c + 1) * max_degree, (u64)nume.size()); k++) {
        np = emul(np, nume[k]);
        dp = emul(dp, deno[k]);
      }
      pp_terms.push_back(esub(emul(accs[c + 1], dp), emul(accs[c], np)));
    }
  }
  if (has_lookup) {
    u64 num_sel = cd.groups.size();
    std::vector<E> lookup_selectors(
        v.consts->begin() + num_sel,
        v.consts->begin() + num_sel + cd.num_lookup_selectors);
    u64 nlp = cd.num_lookup_polys;
    for (u64 i = 0; i < nc; i++) {
      std::vector<E> cur_local(o.lookup_zs.begin() + nlp * i,
                               o.lookup_zs.begin() + nlp * (i + 1));
      std::vector<E> cur_next(o.lookup_zs_next.begin() + nlp * i,
                              o.lookup_zs_next.begin() + nlp * (i + 1));
      std::vector<E> cur_deltas_e;
      u64 cur_deltas[4];
      for (int k = 0; k < 4; k++) {
        cur_deltas[k] = deltas[4 * i + k];
        cur_deltas_e.push_back(efrom(cur_deltas[k]));
      }
      std::vector<E> lut_re;
      for (size_t l = 0; l < cd.luts.size(); l++)
        lut_re.push_back(efrom(eval_lut_poly(cd, l, cur_deltas)));
      check_lookup_constraints(cd, v, cur_local, cur_next, lookup_selectors,
                               cur_deltas_e.data(), lut_re, lookup_terms);
    }
  }

  std::vector<E> terms;
  terms.insert(terms.end(), z1_terms.begin(), z1_terms.end());
  terms.insert(terms.end(), pp_terms.begin(), pp_terms.end());
  terms.insert(terms.end(), lookup_terms.begin(), lookup_terms.end());
  terms.insert(terms.end(), gate_terms.begin(), gate_terms.end());
  std::vector<E> result;
  for (u64 i = 0; i < nc; i++) {
    E acc = EZERO;
    E alpha = efrom(alphas[i]);
    for (auto it = terms.rbegin(); it != terms.rend(); ++it)
      acc = eadd(emul(alpha, acc), *it);
    result.push_back(acc);
  }
  return result;
}

// ---------------------------------------------------------------------------
// Merkle proof verification (reference hash/merkle_proofs.rs)
// ---------------------------------------------------------------------------

static void verify_merkle_proof(const std::vector<u64>& leaf, u64 index,
                                const std::vector<GD>& cap,
                                const MerkleProofC& mp) {
  GD d = gd_hash_or_noop(leaf);
  u64 idx = index;
  for (const auto& sib : mp.sibs) {
    d = (idx & 1) ? gd_two_to_one(sib, d) : gd_two_to_one(d, sib);
    idx >>= 1;
  }
  if (idx >= cap.size() || d != cap[idx])
    throw std::runtime_error("Merkle proof invalid");
}

// ---------------------------------------------------------------------------
// FRI verification (reference fri/verifier.rs)
// ---------------------------------------------------------------------------

struct FriChallengesC {
  E alpha;
  std::vector<E> betas;
  u64 pow_response;
  std::vector<u64> query_indices;
};

struct ReducingFactor {
  E base;
  u64 count = 0;
  explicit ReducingFactor(E b) : base(b) {}
  E reduce_ext(const std::vector<E>& vals) {
    E acc = EZERO;
    for (auto it = vals.rbegin(); it != vals.rend(); ++it) {
      count++;
      acc = eadd(emul(acc, base), *it);
    }
    return acc;
  }
  E reduce_base(const std::vector<u64>& vals) {
    E acc = EZERO;
    for (auto it = vals.rbegin(); it != vals.rend(); ++it) {
      count++;
      acc = eadd(emul(acc, base), efrom(*it));
    }
    return acc;
  }
  E shift(E x) {
    E r = emul(eexp(base, count), x);
    count = 0;
    return r;
  }
};

static E compute_evaluation(u64 x, u64 x_idx_in_coset, u64 arity_bits,
                            const std::vector<E>& evals, E beta) {
  u64 arity = 1ull << arity_bits;
  u64 gen = root_of_unity((int)arity_bits);
  std::vector<E> ev(arity);
  for (u64 i = 0; i < arity; i++) ev[i] = evals[reverse_bits(i, (int)arity_bits)];
  u64 rev_x = reverse_bits(x_idx_in_coset, (int)arity_bits);
  u64 coset_start = gl_mul(x, gl_exp(gen, arity - rev_x));
  std::vector<std::pair<E, E>> pts;
  u64 y = coset_start;
  for (u64 i = 0; i < arity; i++) {
    pts.push_back({efrom(y), ev[i]});
    y = gl_mul(y, gen);
  }
  // barycentric weights
  std::vector<E> weights;
  for (u64 i = 0; i < arity; i++) {
    E prod = EONE;
    for (u64 j = 0; j < arity; j++)
      if (j != i) prod = emul(prod, esub(pts[i].first, pts[j].first));
    weights.push_back(einv(prod));
  }
  for (auto& pt : pts)
    if (eeq(pt.first, beta)) return pt.second;
  E l_x = EONE;
  for (auto& pt : pts) l_x = emul(l_x, esub(beta, pt.first));
  E total = EZERO;
  for (u64 i = 0; i < arity; i++) {
    E term = emul(ediv(weights[i], esub(beta, pts[i].first)), pts[i].second);
    total = eadd(total, term);
  }
  return emul(l_x, total);
}

// FRI batch/oracle layout (reference plonk/circuit_data.rs fri_all_polys):
// batch 0 at zeta: oracle0[0..preproc], oracle1[0..wires], oracle2[0..zs_pp],
// oracle3[0..quotient], oracle2[lookup range]; batch 1 at g*zeta:
// oracle2[0..nc], oracle2[lookup range].
struct PolyRef { int oracle; u64 index; };
struct FriBatch { E point; std::vector<PolyRef> polys; };

static std::vector<FriBatch> fri_batches(const CommonC& cd, E zeta) {
  std::vector<FriBatch> batches;
  FriBatch b0;
  b0.point = zeta;
  for (u64 i = 0; i < cd.num_preprocessed(); i++) b0.polys.push_back({0, i});
  for (u64 i = 0; i < cd.config.num_wires; i++) b0.polys.push_back({1, i});
  for (u64 i = 0; i < cd.num_zs_pp(); i++) b0.polys.push_back({2, i});
  for (u64 i = 0; i < cd.num_quotient(); i++) b0.polys.push_back({3, i});
  for (u64 i = 0; i < cd.num_all_lookup(); i++)
    b0.polys.push_back({2, cd.num_zs_pp() + i});
  FriBatch b1;
  u64 g = root_of_unity((int)cd.degree_bits());
  b1.point = escalar(g, zeta);
  for (u64 i = 0; i < cd.config.num_challenges; i++) b1.polys.push_back({2, i});
  for (u64 i = 0; i < cd.num_all_lookup(); i++)
    b1.polys.push_back({2, cd.num_zs_pp() + i});
  batches.push_back(std::move(b0));
  batches.push_back(std::move(b1));
  return batches;
}

// opening values per batch, ordered to match fri_batches
// (reference plonk/proof.rs to_fri_openings)
static std::vector<std::vector<E>> fri_opening_values(const OpeningSetC& o) {
  std::vector<E> b0;
  auto app = [&](const std::vector<E>& v) { b0.insert(b0.end(), v.begin(), v.end()); };
  app(o.constants); app(o.sigmas); app(o.wires); app(o.zs);
  app(o.partial_products); app(o.quotient); app(o.lookup_zs);
  std::vector<E> b1(o.zs_next);
  b1.insert(b1.end(), o.lookup_zs_next.begin(), o.lookup_zs_next.end());
  return {b0, b1};
}

// alpha-reduce each batch's claimed opening values (shared by the verifier
// and the compressed-proof inference path)
static std::vector<E> reduce_batch_values(
    const std::vector<std::vector<E>>& batch_values, E alpha) {
  std::vector<E> reduced;
  for (auto& bv : batch_values) {
    ReducingFactor rf(alpha);
    reduced.push_back(rf.reduce_ext(bv));
  }
  return reduced;
}

// fri_combine_initial (reference fri/verifier.rs:123-162), generic over the
// instance's batches; `initial` holds one leaf per oracle at the query index.
static E fri_combine_initial(const std::vector<FriBatch>& batches,
                             const std::vector<E>& reduced,
                             const std::vector<bool>& oracle_blinding,
                             bool hiding, E alpha, u64 subgroup_x,
                             const std::vector<InitialOpen>& initial) {
  ReducingFactor rf(alpha);
  E total = EZERO;
  E sx = efrom(subgroup_x);
  for (size_t bi = 0; bi < batches.size(); bi++) {
    std::vector<u64> evals;
    for (auto& pr : batches[bi].polys) {
      const auto& ev = initial[pr.oracle].evals;
      bool salted = hiding && oracle_blinding[pr.oracle];
      u64 limit = ev.size() - (salted ? 4 : 0);
      if (pr.index >= limit) throw std::runtime_error("oracle index out of range");
      evals.push_back(ev[pr.index]);
    }
    E reduced_evals = rf.reduce_base(evals);
    E numerator = esub(reduced_evals, reduced[bi]);
    E denominator = esub(sx, batches[bi].point);
    total = rf.shift(total);
    total = eadd(total, ediv(numerator, denominator));
  }
  return total;
}

// Instance-generic FRI verification core (reference fri/verifier.rs:62-241);
// the plonk wrapper below supplies the plonk batch layout, the STARK mode
// its own.
static void verify_fri_core(const FriParamsC& params,
                            const std::vector<FriBatch>& batches,
                            const std::vector<std::vector<E>>& batch_values,
                            const std::vector<bool>& oracle_blinding,
                            const FriChallengesC& ch,
                            const std::vector<const std::vector<GD>*>& caps,
                            const FriProofC& fp) {
  if (ch.pow_response >= (1ull << (64 - params.cfg.pow_bits)))
    throw std::runtime_error("Invalid proof of work witness.");
  if (params.cfg.num_query_rounds != fp.rounds.size())
    throw std::runtime_error("Number of query rounds does not match config.");

  auto reduced = reduce_batch_values(batch_values, ch.alpha);

  int log_n = (int)params.lde_bits();

  for (size_t q = 0; q < fp.rounds.size(); q++) {
    u64 x_index = ch.query_indices[q];
    const auto& rd = fp.rounds[q];
    for (size_t oi = 0; oi < rd.initial.size(); oi++)
      verify_merkle_proof(rd.initial[oi].evals, x_index, *caps[oi], rd.initial[oi].mp);

    u64 subgroup_x = gl_mul(
        MULT_GROUP_GEN, gl_exp(root_of_unity(log_n), reverse_bits(x_index, log_n)));

    E old_eval = fri_combine_initial(batches, reduced, oracle_blinding,
                                     params.hiding, ch.alpha, subgroup_x,
                                     rd.initial);

    for (size_t i = 0; i < params.arities.size(); i++) {
      u64 arity_bits = params.arities[i];
      u64 arity = 1ull << arity_bits;
      const auto& evals = rd.steps[i].evals;
      u64 coset_index = x_index >> arity_bits;
      u64 within = x_index & (arity - 1);
      if (!eeq(evals[within], old_eval))
        throw std::runtime_error("FRI fold consistency check failed");
      old_eval = compute_evaluation(subgroup_x, within, arity_bits, evals, ch.betas[i]);
      std::vector<u64> flat;
      for (auto& e : evals) { flat.push_back(e.a); flat.push_back(e.b); }
      verify_merkle_proof(flat, coset_index, fp.caps[i], rd.steps[i].mp);
      subgroup_x = gl_exp(subgroup_x, arity);
      x_index = coset_index;
    }
    E final_eval = EZERO;
    E sxe = efrom(subgroup_x);
    for (auto it = fp.final_poly.rbegin(); it != fp.final_poly.rend(); ++it)
      final_eval = eadd(emul(final_eval, sxe), *it);
    if (!eeq(final_eval, old_eval))
      throw std::runtime_error("Final polynomial evaluation is invalid.");
  }
}

static void verify_fri_proof(const CommonC& cd, E zeta,
                             const FriChallengesC& ch,
                             const std::vector<const std::vector<GD>*>& caps,
                             const FriProofC& fp, const OpeningSetC& open) {
  const auto& params = cd.fri_params;
  std::vector<bool> oracle_blinding = {false, params.hiding, params.hiding,
                                       params.hiding};
  verify_fri_core(params, fri_batches(cd, zeta), fri_opening_values(open),
                  oracle_blinding, ch, caps, fp);
}

// ---------------------------------------------------------------------------
// Top-level verify (reference plonk/verifier.rs:17-118 + get_challenges.rs)
// ---------------------------------------------------------------------------

struct PlonkChallenges {
  std::vector<u64> betas, gammas, alphas, deltas;
  E zeta;
  FriChallengesC fch;
  Digest pis_hash;
};

// Full Fiat-Shamir transcript replay (reference plonk/get_challenges.rs:26-95
// + fri/challenges.rs:28-95). Shared by the direct verifier and the
// compressed-proof decompression (whose inference needs the query indices
// before the FRI rounds exist).
static PlonkChallenges plonk_challenges(
    const VerifierOnlyC& vd, const CommonC& cd,
    const std::vector<GD>& wires_cap, const std::vector<GD>& zpp_cap,
    const std::vector<GD>& quot_cap, const OpeningSetC& open,
    const std::vector<std::vector<GD>>& fri_caps,
    const std::vector<E>& final_poly, u64 pow_witness,
    const std::vector<u64>& public_inputs) {
  PlonkChallenges out;
  out.pis_hash = hash_no_pad(public_inputs);

  u64 nc = cd.config.num_challenges;
  bool has_lookup = cd.num_lookup_polys != 0;

  Challenger ch;
  cd.fri_params.observe(ch);
  ch.observe_digest(vd.circuit_digest);
  ch.observe_digest(gd_from_felts(out.pis_hash));
  ch.observe_cap(wires_cap);
  for (u64 i = 0; i < nc; i++) out.betas.push_back(ch.challenge());
  for (u64 i = 0; i < nc; i++) out.gammas.push_back(ch.challenge());
  if (has_lookup) {
    out.deltas = out.betas;
    out.deltas.insert(out.deltas.end(), out.gammas.begin(), out.gammas.end());
    u64 extra = 4 * nc - 2 * nc;
    for (u64 i = 0; i < extra; i++) out.deltas.push_back(ch.challenge());
  }
  ch.observe_cap(zpp_cap);
  for (u64 i = 0; i < nc; i++) out.alphas.push_back(ch.challenge());
  ch.observe_cap(quot_cap);
  out.zeta = ch.ext_challenge();

  for (auto& bv : fri_opening_values(open))
    for (auto& e : bv) ch.observe_ext(e);

  out.fch.alpha = ch.ext_challenge();
  for (auto& cap : fri_caps) {
    ch.observe_cap(cap);
    out.fch.betas.push_back(ch.ext_challenge());
  }
  for (auto& e : final_poly) ch.observe_ext(e);
  ch.observe(pow_witness);
  out.fch.pow_response = ch.challenge();
  u64 lde = cd.fri_params.lde_size();
  for (u64 i = 0; i < cd.config.fri.num_query_rounds; i++)
    out.fch.query_indices.push_back(ch.challenge() % lde);
  return out;
}

static void verify(const VerifierOnlyC& vd, const CommonC& cd, const ProofC& pf) {
  if (pf.public_inputs.size() != cd.num_public_inputs)
    throw std::runtime_error("Wrong number of public inputs");

  u64 nc = cd.config.num_challenges;
  PlonkChallenges pc = plonk_challenges(
      vd, cd, pf.wires_cap, pf.zpp_cap, pf.quot_cap, pf.open, pf.fri.caps,
      pf.fri.final_poly, pf.fri.pow_witness, pf.public_inputs);
  const Digest& pis_hash = pc.pis_hash;
  const std::vector<u64>& betas = pc.betas;
  const std::vector<u64>& gammas = pc.gammas;
  const std::vector<u64>& alphas = pc.alphas;
  const std::vector<u64>& deltas = pc.deltas;
  E zeta = pc.zeta;
  const FriChallengesC& fch = pc.fch;

  // vanishing-poly / quotient identity at zeta
  E pis_e[4];
  for (int i = 0; i < 4; i++) pis_e[i] = efrom(pis_hash[i]);
  Vars vars{&pf.open.constants, &pf.open.wires, pis_e};
  u64 degree = cd.degree();
  E zeta_pow_deg = eexp(zeta, degree);
  E z_h_zeta = eaddc(zeta_pow_deg, P - 1);
  E l_0_zeta = ediv(z_h_zeta, escalar(degree % P, eaddc(zeta, P - 1)));

  std::vector<E> vanishing = eval_vanishing_poly(cd, zeta, vars, pf.open,
                                                 betas, gammas, alphas, deltas,
                                                 l_0_zeta);
  for (u64 i = 0; i < nc; i++) {
    E t_zeta = EZERO;
    for (u64 k = cd.qdf; k > 0; k--)
      t_zeta = eadd(emul(t_zeta, zeta_pow_deg), pf.open.quotient[i * cd.qdf + k - 1]);
    if (!eeq(vanishing[i], emul(z_h_zeta, t_zeta)))
      throw std::runtime_error("Quotient identity check failed");
  }

  std::vector<const std::vector<GD>*> caps = {
      &vd.cap, &pf.wires_cap, &pf.zpp_cap, &pf.quot_cap};
  verify_fri_proof(cd, zeta, fch, caps, pf.fri, pf.open);
}

// ---------------------------------------------------------------------------
// Compressed proofs: Merkle-path dedup + inferred FRI evals
// (reference plonk/proof.rs:110-128, hash/path_compression.rs:12-52,
// serialization/mod.rs:1042-1160; dual of this repo's plonk/compressed.py)
// ---------------------------------------------------------------------------

struct CompressedFriProofC {
  std::vector<std::vector<GD>> caps;
  std::vector<u64> indices; // original 28 query indices (u32 on the wire)
  std::map<u64, std::vector<InitialOpen>> initial; // unique index -> per-oracle
  std::vector<std::map<u64, FriQueryStepC>> steps; // per reduction, arity-1 evals
  std::vector<E> final_poly;
  u64 pow_witness;
};

struct CompressedProofC {
  std::vector<GD> wires_cap, zpp_cap, quot_cap;
  OpeningSetC open;
  CompressedFriProofC fri;
  std::vector<u64> public_inputs;
};

static CompressedProofC read_compressed_proof(Reader& r, const CommonC& cd) {
  CompressedProofC pf;
  u64 ch = cd.config.fri.cap_height;
  pf.wires_cap = read_cap(r, ch);
  pf.zpp_cap = read_cap(r, ch);
  pf.quot_cap = read_cap(r, ch);
  auto& o = pf.open;
  u64 nc = cd.config.num_challenges;
  o.constants = r.exts(cd.num_constants);
  o.sigmas = r.exts(cd.config.num_routed_wires);
  o.wires = r.exts(cd.config.num_wires);
  o.zs = r.exts(nc);
  o.zs_next = r.exts(nc);
  o.lookup_zs = r.exts(cd.num_all_lookup());
  o.lookup_zs_next = r.exts(cd.num_all_lookup());
  o.partial_products = r.exts(nc * cd.num_partial_products);
  o.quotient = r.exts(cd.num_quotient());

  const auto& fp = cd.fri_params;
  u64 salt = fp.hiding ? 4 : 0;
  std::vector<u64> leaves_per_oracle = {
      cd.num_preprocessed(), cd.config.num_wires + salt,
      cd.num_zs_pp() + cd.num_all_lookup() + salt, cd.num_quotient() + salt};
  for (size_t i = 0; i < fp.arities.size(); i++)
    pf.fri.caps.push_back(read_cap(r, fp.cfg.cap_height));
  for (u64 q = 0; q < fp.cfg.num_query_rounds; q++)
    pf.fri.indices.push_back(r.read_u32());
  std::vector<u64> uniq = pf.fri.indices;
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
  for (u64 i : uniq) {
    std::vector<InitialOpen> per_oracle;
    for (u64 nl : leaves_per_oracle) {
      InitialOpen io;
      io.evals = r.fields(nl);
      io.mp = read_merkle_proof(r);
      per_oracle.push_back(std::move(io));
    }
    pf.fri.initial.emplace(i, std::move(per_oracle));
  }
  for (u64 ab : fp.arities) {
    for (auto& x : uniq) x >>= ab;
    uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
    std::map<u64, FriQueryStepC> layer;
    for (u64 i : uniq) {
      FriQueryStepC st;
      st.evals = r.exts((1ull << ab) - 1);
      st.mp = read_merkle_proof(r);
      layer.emplace(i, std::move(st));
    }
    pf.fri.steps.push_back(std::move(layer));
  }
  u64 final_bits = fp.degree_bits;
  for (u64 ab : fp.arities) final_bits -= ab;
  pf.fri.final_poly = r.exts(1ull << final_bits);
  pf.fri.pow_witness = r.field();
  // public inputs: remaining bytes, no length prefix (mod.rs:1144-1160)
  pf.public_inputs = r.fields((r.n - r.pos) / 8);
  return pf;
}

// Exact dual of plonk/compressed.py decompress_merkle_proofs: iterate the
// (possibly duplicated) query indices layer-major, pulling each unknown
// sibling from that index's compressed proof — the consumption order must
// match the compressor's marking order.
static std::vector<MerkleProofC> decompress_merkle_proofs(
    const std::vector<std::vector<u64>>& leaves_data,
    const std::vector<u64>& leaves_indices,
    const std::vector<const MerkleProofC*>& compressed, u64 height,
    u64 cap_height) {
  u64 num_leaves = 1ull << height;
  std::map<u64, GD> seen;
  for (size_t k = 0; k < leaves_indices.size(); k++)
    seen[leaves_indices[k] + num_leaves] = gd_hash_or_noop(leaves_data[k]);
  std::vector<size_t> sib_pos(leaves_indices.size(), 0);
  for (u64 layer = 0; layer + cap_height < height; layer++) {
    for (size_t k = 0; k < leaves_indices.size(); k++) {
      u64 index = (leaves_indices[k] + num_leaves) >> layer;
      GD current = seen.at(index);
      u64 sibling_index = index ^ 1;
      auto it = seen.find(sibling_index);
      if (it == seen.end()) {
        if (sib_pos[k] >= compressed[k]->sibs.size())
          throw std::runtime_error("compressed Merkle proof exhausted");
        it = seen.emplace(sibling_index,
                          compressed[k]->sibs[sib_pos[k]++]).first;
      }
      GD parent = (index % 2 == 0) ? gd_two_to_one(current, it->second)
                                   : gd_two_to_one(it->second, current);
      seen[index >> 1] = parent;
    }
  }
  std::vector<MerkleProofC> out;
  for (u64 i : leaves_indices) {
    MerkleProofC mp;
    u64 index = i + num_leaves;
    for (u64 l = 0; l + cap_height < height; l++) {
      mp.sibs.push_back(seen.at(index ^ 1));
      index >>= 1;
    }
    out.push_back(std::move(mp));
  }
  return out;
}

// Rebuild the full FriProofC from the compressed form: re-infer the dropped
// fold evals (reference plonk/proof.rs decompress + compressed.py
// _get_inferred_elements) and regenerate the deduplicated Merkle siblings.
static FriProofC decompress_fri_proof(const CompressedFriProofC& cfp,
                                      const CommonC& cd, E zeta,
                                      const FriChallengesC& fch,
                                      const OpeningSetC& open) {
  const auto& params = cd.fri_params;
  auto batches = fri_batches(cd, zeta);
  auto reduced = reduce_batch_values(fri_opening_values(open), fch.alpha);
  std::vector<bool> oracle_blinding = {false, params.hiding, params.hiding,
                                       params.hiding};
  int log_n = (int)params.lde_bits();
  size_t num_reductions = params.arities.size();

  // infer the dropped evals per first-encounter of each coset
  std::vector<std::map<u64, std::vector<E>>> evals_by_depth(num_reductions);
  for (u64 x_index0 : fch.query_indices) {
    u64 x_index = x_index0;
    u64 subgroup_x = gl_mul(
        MULT_GROUP_GEN, gl_exp(root_of_unity(log_n), reverse_bits(x_index, log_n)));
    E old_eval = fri_combine_initial(batches, reduced, oracle_blinding,
                                     params.hiding, fch.alpha, subgroup_x,
                                     cfp.initial.at(x_index));
    for (size_t i = 0; i < num_reductions; i++) {
      u64 ab = params.arities[i];
      u64 coset_index = x_index >> ab;
      if (evals_by_depth[i].count(coset_index)) break;
      u64 within = x_index & ((1ull << ab) - 1);
      std::vector<E> evals = cfp.steps[i].at(coset_index).evals;
      evals.insert(evals.begin() + within, old_eval);
      evals_by_depth[i][coset_index] = evals;
      old_eval = compute_evaluation(subgroup_x, within, ab, evals, fch.betas[i]);
      subgroup_x = gl_exp(subgroup_x, 1ull << ab);
      x_index = coset_index;
    }
  }

  // regenerate Merkle siblings, per oracle / per reduction layer
  size_t num_initial_trees = cfp.initial.begin()->second.size();
  u64 height = params.lde_bits();
  std::vector<std::vector<MerkleProofC>> it_proofs(num_initial_trees);
  for (size_t oi = 0; oi < num_initial_trees; oi++) {
    std::vector<std::vector<u64>> leaves;
    std::vector<u64> idxs;
    std::vector<const MerkleProofC*> comps;
    for (u64 x : fch.query_indices) {
      leaves.push_back(cfp.initial.at(x)[oi].evals);
      idxs.push_back(x);
      comps.push_back(&cfp.initial.at(x)[oi].mp);
    }
    it_proofs[oi] = decompress_merkle_proofs(leaves, idxs, comps, height,
                                             params.cfg.cap_height);
  }
  std::vector<std::vector<MerkleProofC>> st_proofs(num_reductions);
  {
    std::vector<u64> idxs(fch.query_indices);
    u64 h = height;
    for (size_t i = 0; i < num_reductions; i++) {
      u64 ab = params.arities[i];
      h -= ab;
      std::vector<std::vector<u64>> leaves;
      std::vector<const MerkleProofC*> comps;
      for (auto& x : idxs) {
        x >>= ab;
        const auto& ev = evals_by_depth[i].at(x);
        std::vector<u64> flat;
        for (auto& e : ev) { flat.push_back(e.a); flat.push_back(e.b); }
        leaves.push_back(std::move(flat));
        comps.push_back(&cfp.steps[i].at(x).mp);
      }
      st_proofs[i] = decompress_merkle_proofs(leaves, idxs, comps, h,
                                              params.cfg.cap_height);
    }
  }

  FriProofC out;
  out.caps = cfp.caps;
  out.final_poly = cfp.final_poly;
  out.pow_witness = cfp.pow_witness;
  for (size_t q = 0; q < fch.query_indices.size(); q++) {
    FriQueryRoundC rd;
    u64 x = fch.query_indices[q];
    for (size_t oi = 0; oi < num_initial_trees; oi++) {
      InitialOpen io;
      io.evals = cfp.initial.at(x)[oi].evals;
      io.mp = it_proofs[oi][q];
      rd.initial.push_back(std::move(io));
    }
    for (size_t i = 0; i < num_reductions; i++) {
      x >>= params.arities[i];
      FriQueryStepC st;
      st.evals = evals_by_depth[i].at(x);
      st.mp = st_proofs[i][q];
      rd.steps.push_back(std::move(st));
    }
    out.rounds.push_back(std::move(rd));
  }
  return out;
}

static void verify_compressed(const VerifierOnlyC& vd, const CommonC& cd,
                              const CompressedProofC& cpf) {
  PlonkChallenges pc = plonk_challenges(
      vd, cd, cpf.wires_cap, cpf.zpp_cap, cpf.quot_cap, cpf.open,
      cpf.fri.caps, cpf.fri.final_poly, cpf.fri.pow_witness,
      cpf.public_inputs);
  // the drawn indices must match the serialized ones (the compressed layout
  // is keyed by them)
  if (pc.fch.query_indices.size() != cpf.fri.indices.size())
    throw std::runtime_error("query index count mismatch");
  for (size_t i = 0; i < cpf.fri.indices.size(); i++)
    if (pc.fch.query_indices[i] != cpf.fri.indices[i])
      throw std::runtime_error("compressed query indices do not match transcript");
  ProofC pf;
  pf.wires_cap = cpf.wires_cap;
  pf.zpp_cap = cpf.zpp_cap;
  pf.quot_cap = cpf.quot_cap;
  pf.open = cpf.open;
  pf.public_inputs = cpf.public_inputs;
  pf.fri = decompress_fri_proof(cpf.fri, cd, pc.zeta, pc.fch, cpf.open);
  verify(vd, cd, pf);
}

// ---------------------------------------------------------------------------
// STARK verification (reference starky/src/verifier.rs:30-215,
// get_challenges.rs, vanishing_poly.rs), generic over an AIR descriptor —
// byte layout per this repo's starky/serialization.py. Registered AIRs:
// FibonacciStark and PermutationStark (starky/fibonacci_stark.py,
// starky/test_starks.py), both under standard_fast_config; the reference
// dual is the Stark-trait-generic verifier (starky/src/verifier.rs:30-68).
// ---------------------------------------------------------------------------

struct StarkProofC {
  u64 degree_bits;
  std::vector<GD> trace_cap, quot_cap;
  bool has_aux = false, has_quot = false;
  std::vector<GD> aux_cap;
  std::vector<E> local_values, next_values, quotient;
  FriProofC fri;
  std::vector<u64> public_inputs;
};

// Compact AIR descriptor: trace shape + constraint evaluation. The
// constraint order must match the Python Stark.eval exactly (the
// alpha-accumulation is order-sensitive).
struct StarkDescC {
  const char* name;
  u64 cols;
  u64 num_public_inputs;
  u64 constraint_degree;
  // alpha-combined constraint evaluation at a point: fills accs[nc]
  void (*eval)(const StarkProofC& pf, const std::vector<E>& local,
               const std::vector<E>& next, const std::vector<u64>& alphas,
               E zeta, u64 nc, std::vector<E>& accs);
};

// shared constraint-consumer helpers (starky/constraint_consumer.py):
// l0 = Z_H / (n (x - 1)), llast = Z_H / (n (x - g^{n-1})), z_last = x - g^{-1}
struct StarkPointCtx {
  E l0, llast, z_last;
  StarkPointCtx(u64 degree_bits, E zeta) {
    u64 n = 1ull << degree_bits;
    u64 g = root_of_unity((int)degree_bits);
    E z_x = eaddc(eexp(zeta, n), P - 1);
    l0 = ediv(z_x, escalar(n % P, eaddc(zeta, P - 1)));
    llast = ediv(z_x, escalar(n % P, eaddc(escalar(g, zeta), P - 1)));
    z_last = esub(zeta, efrom(gl_inv(g)));
  }
};

static void eval_fibonacci(const StarkProofC& pf, const std::vector<E>& local,
                           const std::vector<E>& next,
                           const std::vector<u64>& alphas, E zeta, u64 nc,
                           std::vector<E>& accs) {
  // starky/fibonacci_stark.py eval: x0/x1 pinned at row 0, x1 pinned at the
  // last row, transition x0' = x1, x1' = x0 + x1
  StarkPointCtx c(pf.degree_bits, zeta);
  auto cons = [&](E v) {
    for (u64 i = 0; i < nc; i++)
      accs[i] = eadd(emul(efrom(alphas[i]), accs[i]), v);
  };
  cons(emul(esub(local[0], efrom(pf.public_inputs[0])), c.l0));
  cons(emul(esub(local[1], efrom(pf.public_inputs[1])), c.l0));
  cons(emul(esub(local[1], efrom(pf.public_inputs[2])), c.llast));
  cons(emul(esub(next[0], local[1]), c.z_last));
  cons(emul(esub(next[1], eadd(local[0], local[1])), c.z_last));
}

static void eval_permutation(const StarkProofC& pf, const std::vector<E>& local,
                             const std::vector<E>& next,
                             const std::vector<u64>& alphas, E zeta, u64 nc,
                             std::vector<E>& accs) {
  // starky/test_starks.py PermutationStark eval: [x, y] pinned at row 0,
  // transition swaps the pair
  StarkPointCtx c(pf.degree_bits, zeta);
  auto cons = [&](E v) {
    for (u64 i = 0; i < nc; i++)
      accs[i] = eadd(emul(efrom(alphas[i]), accs[i]), v);
  };
  cons(emul(esub(local[0], efrom(pf.public_inputs[0])), c.l0));
  cons(emul(esub(local[1], efrom(pf.public_inputs[1])), c.l0));
  cons(emul(esub(next[0], local[1]), c.z_last));
  cons(emul(esub(next[1], local[0]), c.z_last));
}

static const StarkDescC STARK_REGISTRY[] = {
  {"fibonacci", 2, 3, 2, eval_fibonacci},
  {"permutation", 2, 2, 2, eval_permutation},
};

static void verify_stark(Reader& r, const StarkDescC& desc) {
  // standard_fast_config (starky/config.rs:52-64)
  FriConfigC fc;
  fc.rate_bits = 1; fc.cap_height = 4; fc.pow_bits = 16;
  fc.num_query_rounds = 84; fc.strat_kind = 1; fc.arity_bits = 4;
  fc.final_poly_bits = 5;
  const u64 security_bits = 100, nc = 2;
  const u64 COLS = desc.cols;
  const u64 QDF = desc.constraint_degree <= 2
                      ? 1 : desc.constraint_degree - 1;

  // -- parse (starky/serialization.py read_stark_proof) ----------------------
  StarkProofC pf;
  pf.degree_bits = r.usize();
  pf.trace_cap = read_cap(r, fc.cap_height);
  pf.has_aux = r.u8() != 0;
  if (pf.has_aux) pf.aux_cap = read_cap(r, fc.cap_height);
  pf.has_quot = r.u8() != 0;
  if (pf.has_quot) pf.quot_cap = read_cap(r, fc.cap_height);
  u64 n_local = r.usize();
  if (n_local != COLS) throw std::runtime_error("wrong trace width");
  pf.local_values = r.exts(n_local);
  pf.next_values = r.exts(n_local);
  if (r.u8() != 0) throw std::runtime_error("unexpected aux openings");
  if (r.u8() != 0) throw std::runtime_error("unexpected aux_next openings");
  if (r.u8() != 0) throw std::runtime_error("unexpected ctl_zs_first");
  if (r.u8() == 0) throw std::runtime_error("missing quotient openings");
  u64 n_quot = r.usize();
  if (n_quot != QDF * nc) throw std::runtime_error("wrong quotient count");
  pf.quotient = r.exts(n_quot);
  if (pf.has_aux) throw std::runtime_error("unexpected aux cap");
  if (!pf.has_quot) throw std::runtime_error("missing quotient cap");

  FriParamsC params;
  params.cfg = fc;
  params.hiding = false;
  params.degree_bits = pf.degree_bits;
  {
    u64 db = pf.degree_bits; // ConstantArityBits (reduction_strategies.rs)
    while (db > fc.final_poly_bits &&
           db + fc.rate_bits - fc.arity_bits >= fc.cap_height) {
      params.arities.push_back(fc.arity_bits);
      db -= fc.arity_bits;
    }
  }
  std::vector<u64> leaves_per_oracle = {COLS, QDF * nc};
  for (size_t i = 0; i < params.arities.size(); i++)
    pf.fri.caps.push_back(read_cap(r, fc.cap_height));
  for (u64 q = 0; q < fc.num_query_rounds; q++) {
    FriQueryRoundC rd;
    for (u64 nl : leaves_per_oracle) {
      InitialOpen io;
      io.evals = r.fields(nl);
      io.mp = read_merkle_proof(r);
      rd.initial.push_back(std::move(io));
    }
    for (u64 ab : params.arities) {
      FriQueryStepC st;
      st.evals = r.exts(1ull << ab);
      st.mp = read_merkle_proof(r);
      rd.steps.push_back(std::move(st));
    }
    pf.fri.rounds.push_back(std::move(rd));
  }
  u64 final_bits = pf.degree_bits;
  for (u64 ab : params.arities) final_bits -= ab;
  pf.fri.final_poly = r.exts(1ull << final_bits);
  pf.fri.pow_witness = r.field();
  pf.public_inputs = r.fields(r.usize());
  if (r.pos != r.n) throw std::runtime_error("trailing STARK proof bytes");
  if (pf.public_inputs.size() != desc.num_public_inputs)
    throw std::runtime_error("wrong number of public inputs");

  // alpha-combined constraint evaluation at a point, from the descriptor
  auto vanishing_at = [&](const std::vector<E>& local,
                          const std::vector<E>& next,
                          const std::vector<u64>& alphas,
                          E zeta) -> std::vector<E> {
    std::vector<E> accs(nc, EZERO);
    desc.eval(pf, local, next, alphas, zeta, nc, accs);
    return accs;
  };

  // -- transcript replay (starky/get_challenges.py) --------------------------
  Challenger ch;
  for (u64 pi : pf.public_inputs) ch.observe(pi);
  ch.observe(security_bits);
  ch.observe(nc);
  ch.observe(fc.rate_bits);
  ch.observe(fc.cap_height);
  ch.observe(fc.pow_bits);
  for (u64 x : fc.strategy_felts()) ch.observe(x);
  ch.observe(fc.num_query_rounds);
  ch.observe_cap(pf.trace_cap);

  std::vector<u64> alphas_prime;
  for (u64 i = 0; i < nc; i++) alphas_prime.push_back(ch.challenge());

  // constraint binding: dummy openings from challenge powers
  // (starky/vanishing.py get_dummy_polys; get_challenges.rs:202-252)
  u64 pow_degree = desc.constraint_degree + 1;
  if (pow_degree < 2) pow_degree = 2;
  u64 log_pow_degree = 0;  // log2_ceil(pow_degree)
  while ((1ull << log_pow_degree) < pow_degree) log_pow_degree++;
  u64 num_extension_powers = 50 / log_pow_degree - 1;
  if (num_extension_powers < 1) num_extension_powers = 1;
  u64 total = COLS * 2;
  u64 num_zetas = (total + num_extension_powers - 1) / num_extension_powers;
  u64 nb_dummy = std::min(num_extension_powers + 1, total);
  std::vector<E> dummy;
  for (u64 z = 0; z < num_zetas; z++) {
    E cur = ch.ext_challenge();
    for (u64 k = 0; k < nb_dummy; k++) {
      dummy.push_back(cur);
      cur = eexp(cur, pow_degree);
    }
  }
  E zeta_prime = ch.ext_challenge();
  std::vector<E> dummy_local(dummy.begin(), dummy.begin() + COLS);
  std::vector<E> dummy_next(dummy.begin() + COLS, dummy.begin() + 2 * COLS);
  for (E c : vanishing_at(dummy_local, dummy_next, alphas_prime, zeta_prime))
    ch.observe_ext(c);

  std::vector<u64> alphas;
  for (u64 i = 0; i < nc; i++) alphas.push_back(ch.challenge());
  ch.observe_cap(pf.quot_cap);
  E zeta = ch.ext_challenge();

  // openings observed in to_fri_openings order (starky/proof.py:20-35)
  for (E e : pf.local_values) ch.observe_ext(e);
  for (E e : pf.quotient) ch.observe_ext(e);
  for (E e : pf.next_values) ch.observe_ext(e);

  FriChallengesC fch;
  fch.alpha = ch.ext_challenge();
  for (auto& cap : pf.fri.caps) {
    ch.observe_cap(cap);
    fch.betas.push_back(ch.ext_challenge());
  }
  for (auto& e : pf.fri.final_poly) ch.observe_ext(e);
  ch.observe(pf.fri.pow_witness);
  fch.pow_response = ch.challenge();
  u64 lde = params.lde_size();
  for (u64 i = 0; i < fc.num_query_rounds; i++)
    fch.query_indices.push_back(ch.challenge() % lde);

  // -- quotient identity at zeta (starky/verifier.py) ------------------------
  std::vector<E> vanishing = vanishing_at(pf.local_values, pf.next_values,
                                           alphas, zeta);
  u64 n = 1ull << pf.degree_bits;
  E zeta_pow_deg = eexp(zeta, n);
  E z_h_zeta = eaddc(zeta_pow_deg, P - 1);
  for (u64 i = 0; i < nc; i++) {
    E t_zeta = EZERO;
    for (u64 k = QDF; k > 0; k--)
      t_zeta = eadd(emul(t_zeta, zeta_pow_deg), pf.quotient[i * QDF + k - 1]);
    if (!eeq(vanishing[i], emul(z_h_zeta, t_zeta)))
      throw std::runtime_error("STARK quotient identity check failed");
  }

  // -- FRI (stark.fri_instance: trace+quotient @ zeta, trace @ g*zeta) ------
  std::vector<FriBatch> batches;
  FriBatch b0;
  b0.point = zeta;
  for (u64 i = 0; i < COLS; i++) b0.polys.push_back({0, i});
  for (u64 i = 0; i < QDF * nc; i++) b0.polys.push_back({1, i});
  FriBatch b1;
  b1.point = escalar(root_of_unity((int)pf.degree_bits), zeta);
  for (u64 i = 0; i < COLS; i++) b1.polys.push_back({0, i});
  batches.push_back(std::move(b0));
  batches.push_back(std::move(b1));
  std::vector<E> bv0(pf.local_values);
  bv0.insert(bv0.end(), pf.quotient.begin(), pf.quotient.end());
  std::vector<std::vector<E>> batch_values = {bv0, pf.next_values};
  std::vector<const std::vector<GD>*> caps = {&pf.trace_cap, &pf.quot_cap};
  verify_fri_core(params, batches, batch_values, {false, false}, fch, caps,
                  pf.fri);
}

// ---------------------------------------------------------------------------

static std::vector<uint8_t> read_file(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) throw std::runtime_error(std::string("cannot open ") + path);
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(len);
  if (fread(buf.data(), 1, len, f) != (size_t)len) {
    fclose(f);
    throw std::runtime_error("short read");
  }
  fclose(f);
  return buf;
}

int main(int argc, char** argv) {
  int argi = 1;
  bool compressed = false, stark = false;
  const StarkDescC* stark_desc = &STARK_REGISTRY[0];
  bool bad_flag = false;
  while (argi < argc && argv[argi][0] == '-') {
    if (strcmp(argv[argi], "--keccak") == 0) KECCAK = true;
    else if (strcmp(argv[argi], "--compressed") == 0) compressed = true;
    else if (strcmp(argv[argi], "--stark") == 0) stark = true;  // fibonacci
    else if (strncmp(argv[argi], "--stark=", 8) == 0) {
      stark = true;
      const char* name = argv[argi] + 8;
      stark_desc = nullptr;
      for (const auto& d : STARK_REGISTRY)
        if (strcmp(d.name, name) == 0) stark_desc = &d;
      if (!stark_desc) {
        fprintf(stderr, "unknown STARK air: %s\n", name);
        return 2;
      }
    } else {
      fprintf(stderr, "unknown flag: %s\n", argv[argi]);
      bad_flag = true;
      break;
    }
    argi++;
  }
  if (bad_flag || (stark && argc - argi != 1) || (!stark && argc - argi != 2)) {
    fprintf(stderr,
            "usage: %s [--keccak] [--compressed] <verifier_data.bin> <proof.bin>\n"
            "       %s --stark[=fibonacci|permutation] <stark_proof.bin>  "
            "(standard_fast_config)\n",
            argv[0], argv[0]);
    return 2;
  }
  try {
    if (stark) {
      auto pf_bytes = read_file(argv[argi]);
      Reader pr(pf_bytes.data(), pf_bytes.size());
      verify_stark(pr, *stark_desc);
      printf("OK\n");
      return 0;
    }
    auto vd_bytes = read_file(argv[argi]);
    Reader vr(vd_bytes.data(), vd_bytes.size());
    VerifierOnlyC vd;
    u64 cap_height = vr.usize();
    vd.cap = read_cap(vr, cap_height);
    vd.circuit_digest = vr.gdigest();
    CommonC cd = read_common(vr);
    if (vr.pos != vr.n) throw std::runtime_error("trailing verifier-data bytes");

    auto pf_bytes = read_file(argv[argi + 1]);
    Reader pr(pf_bytes.data(), pf_bytes.size());
    if (compressed) {
      CompressedProofC cpf = read_compressed_proof(pr, cd);
      if (pr.pos != pr.n) throw std::runtime_error("trailing proof bytes");
      verify_compressed(vd, cd, cpf);
    } else {
      ProofC pf = read_proof(pr, cd);
      if (pr.pos != pr.n) throw std::runtime_error("trailing proof bytes");
      verify(vd, cd, pf);
    }
    printf("OK\n");
    return 0;
  } catch (const std::exception& e) {
    fprintf(stderr, "verification failed: %s\n", e.what());
    return 1;
  }
}
