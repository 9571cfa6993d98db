"""Host-side scalar Goldilocks arithmetic (pure Python ints).

Used by the Fiat-Shamir transcript, circuit building, witness generation and
proof assembly — everywhere latency (not throughput) dominates, so round-trips
to the device would be wasteful. The batched device dual lives in
`plonky2_torch.field.goldilocks`; the two are cross-checked in tests.

Capability parity: reference `field/src/goldilocks_field.rs` (p = 2^64-2^32+1,
two-adicity 32, generator 7) and `field/src/goldilocks_extensions.rs`
(quadratic extension W=7, quartic W=7, quintic W=3).
"""

from __future__ import annotations

P = 0xFFFFFFFF00000001  # 2^64 - 2^32 + 1
EPSILON = 0xFFFFFFFF  # 2^32 - 1 == 2^64 mod p
TWO_ADICITY = 32
CHARACTERISTIC = P
# reference field/src/goldilocks_field.rs:80
MULTIPLICATIVE_GROUP_GENERATOR = 14293326489335486720
# g s.t. ord(g) == 2^32: reference field/src/goldilocks_field.rs:87
POWER_OF_TWO_GENERATOR = 7277203076849721926
MASK64 = 0xFFFFFFFFFFFFFFFF


def add(a: int, b: int) -> int:
    s = a + b
    return s - P if s >= P else s


def sub(a: int, b: int) -> int:
    d = a - b
    return d + P if d < 0 else d


def neg(a: int) -> int:
    return 0 if a == 0 else P - a


def mul(a: int, b: int) -> int:
    return (a * b) % P


def square(a: int) -> int:
    return (a * a) % P


def exp(a: int, e: int) -> int:
    return pow(a, e, P)


def inverse(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("inverse of zero in Goldilocks field")
    return pow(a, P - 2, P)


def div(a: int, b: int) -> int:
    return mul(a, inverse(b))


def sqrt(a: int) -> int | None:
    """Tonelli-Shanks square root (reference field/src/types.rs PrimeField
    sqrt); returns None if `a` is a non-residue."""
    if a == 0:
        return 0
    if pow(a, (P - 1) // 2, P) != 1:
        return None
    # p - 1 = q * 2^s with q odd; s = TWO_ADICITY
    s = TWO_ADICITY
    q = (P - 1) >> s
    z = MULTIPLICATIVE_GROUP_GENERATOR  # generator -> non-residue^q has order 2^s
    m = s
    c = pow(z, q, P)
    t = pow(a, q, P)
    r = pow(a, (q + 1) // 2, P)
    while t != 1:
        t2 = t
        i = 0
        while t2 != 1:
            t2 = mul(t2, t2)
            i += 1
        b = pow(c, 1 << (m - i - 1), P)
        m = i
        c = mul(b, b)
        t = mul(t, c)
        r = mul(r, b)
    return r


def from_noncanonical_u64(x: int) -> int:
    """Reduce an arbitrary u64 to canonical form."""
    return x % P


def to_canonical_u64(x: int) -> int:
    return x % P


def primitive_root_of_unity(n_log: int) -> int:
    """2^n_log-th primitive root of unity (reference field/src/types.rs:318)."""
    assert 0 <= n_log <= TWO_ADICITY
    base = POWER_OF_TWO_GENERATOR
    return pow(base, 1 << (TWO_ADICITY - n_log), P)


def two_adic_subgroup(n_log: int) -> list[int]:
    g = primitive_root_of_unity(n_log)
    out = [1]
    for _ in range((1 << n_log) - 1):
        out.append(mul(out[-1], g))
    return out


def coset_shift() -> int:
    """The LDE coset shift = multiplicative group generator g
    (reference field/src/types.rs:441)."""
    return MULTIPLICATIVE_GROUP_GENERATOR


def batch_inverse(xs: list[int]) -> list[int]:
    """Montgomery batch inversion (all inputs nonzero)."""
    n = len(xs)
    if n == 0:
        return []
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = mul(prefix[i], x)
    inv_all = inverse(prefix[n])
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = mul(prefix[i], inv_all)
        inv_all = mul(inv_all, xs[i])
    return out


def get_unique_coset_shifts(n: int, num_shifts: int) -> list[int]:
    """PLONK k_i coset shifts: g^0 .. g^(num_shifts-1).

    These give distinct cosets of the order-n subgroup as long as
    num_shifts <= (p-1)/n (reference field/src/cosets.rs:9-24).
    """
    assert num_shifts <= (P - 1) // n
    g = MULTIPLICATIVE_GROUP_GENERATOR
    out = [1]
    for _ in range(num_shifts - 1):
        out.append(mul(out[-1], g))
    return out


# ---------------------------------------------------------------------------
# Extension fields F_{p^D} = F_p[X] / (X^D - W).
# Reference: field/src/extension/mod.rs (OEF trait) and
# field/src/goldilocks_extensions.rs (W = 7 for D=2,4; W = 3 for D=5).
# Elements are tuples of ints, length D.
# ---------------------------------------------------------------------------

EXT_W = {1: 0, 2: 7, 4: 7, 5: 3}
# DTH_ROOT: W^((p-1)/D) — element of order D, for Frobenius.
# reference field/src/goldilocks_extensions.rs DTH_ROOT constants.
EXT_DTH_ROOT = {
    2: 18446744069414584320,  # = p - 1 (order 2)
    4: 281474976710656,
    5: 1041288259238279555,
}


def ext_add(a, b):
    return tuple(add(x, y) for x, y in zip(a, b))


def ext_sub(a, b):
    return tuple(sub(x, y) for x, y in zip(a, b))


def ext_neg(a):
    return tuple(neg(x) for x in a)


def ext_scalar_mul(c: int, a):
    return tuple(mul(c, x) for x in a)


def ext_mul(a, b):
    """Schoolbook multiply in F_p[X]/(X^D - W)."""
    d = len(a)
    if d == 1:
        return (mul(a[0], b[0]),)
    w = EXT_W[d]
    acc = [0] * d
    for i in range(d):
        if a[i] == 0:
            continue
        for j in range(d):
            k = i + j
            t = a[i] * b[j]
            if k >= d:
                k -= d
                t *= w
            acc[k] = (acc[k] + t) % P
    return tuple(acc)


def ext_square(a):
    return ext_mul(a, a)


def ext_exp(a, e: int):
    d = len(a)
    result = ext_one(d)
    base = a
    while e > 0:
        if e & 1:
            result = ext_mul(result, base)
        base = ext_mul(base, base)
        e >>= 1
    return result


def ext_one(d: int):
    return tuple([1] + [0] * (d - 1))


def ext_zero(d: int):
    return (0,) * d


def ext_from_base(x: int, d: int):
    return tuple([x] + [0] * (d - 1))


def ext_frobenius(a, count: int = 1):
    """a^(p^count) via DTH_ROOT powers (reference extension/mod.rs:29-62)."""
    d = len(a)
    if d == 1:
        return a
    count = count % d
    if count == 0:
        return a
    z0 = pow(EXT_DTH_ROOT[d], count, P)
    out = []
    z = 1
    for i in range(d):
        out.append(mul(a[i], z))
        z = mul(z, z0)
    return tuple(out)


def ext_inverse(a):
    """Inverse via the norm: a^-1 = a_bar / N(a), N(a) = prod of conjugates."""
    d = len(a)
    if d == 1:
        return (inverse(a[0]),)
    if all(x == 0 for x in a):
        raise ZeroDivisionError("inverse of zero extension element")
    # a_bar = prod_{i=1}^{d-1} Frob^i(a); N(a) = a * a_bar  (base-field element)
    a_bar = ext_frobenius(a, 1)
    for i in range(2, d):
        a_bar = ext_mul(a_bar, ext_frobenius(a, i))
    norm = ext_mul(a, a_bar)
    # norm must lie in the base field
    n = norm[0]
    return ext_scalar_mul(inverse(n), a_bar)


def ext_div(a, b):
    return ext_mul(a, ext_inverse(b))
