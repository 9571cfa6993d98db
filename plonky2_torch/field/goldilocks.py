"""Batched Goldilocks field arithmetic on torch int64 tensors.

A field element is the uint64 bit pattern of a canonical residue (< p)
stored in an int64 tensor: on the CPU torch's uint64 has no add, sub, `>>`
or `<`, so adds and multiplies wrap as int64 (the same bits as uint64),
logical shifts are arithmetic shifts followed by a mask, and an unsigned
compare is `(a ^ MIN) < (b ^ MIN)`. Every function keeps its outputs
canonical; a Merkle digest over a non-canonical value would differ.

These are plain tensor ops on either device, as the reference runs its
field ops in XLA outside any kernel. The kernels in `csrc/goldilocks.cuh`
implement the same algebra per element.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from plonky2_torch import device_key
from plonky2_torch.field import scalar

MASK64 = (1 << 64) - 1
MIN64 = -(1 << 63)
MASK32 = 0xFFFFFFFF
EPSILON = scalar.EPSILON  # 2^32 - 1 == 2^64 mod p


def i64(x: int) -> int:
    """The int64 bit pattern of a u64 Python int."""
    x &= MASK64
    return x - (1 << 64) if x >= 1 << 63 else x


def u64(x: int) -> int:
    """The u64 value of an int64 bit pattern."""
    return int(x) & MASK64


P = i64(scalar.P)


def tensor(values, device) -> torch.Tensor:
    """u64 values (numpy array, list of ints) -> int64 tensor on `device`.
    The values are taken as given; callers pass canonical residues."""
    arr = np.ascontiguousarray(np.asarray(values, dtype=np.uint64))
    return torch.from_numpy(arr.view(np.int64).copy()).to(device)


def upload(values, device) -> torch.Tensor:
    """u64 values -> int64 tensor of their shape (a scalar as [1]) on
    `device` without a synchronisation: on CUDA a non-blocking copy from
    pinned host memory (the transcript state that the host observed, the
    public-inputs hash, a prove's witness), elsewhere `tensor`."""
    arr = np.ascontiguousarray(np.asarray(values, dtype=np.uint64))
    if arr.ndim == 0:
        arr = arr.reshape(1)
    device = torch.device(device)
    if device.type != "cuda":
        return tensor(arr, device)
    if arr.size == 0:
        return torch.empty((0,), dtype=torch.int64, device=device)
    host = torch.from_numpy(arr.view(np.int64).copy()).pin_memory()
    return host.to(device, non_blocking=True)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 array (one device-to-host copy)."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint64)


def lt(a, b):
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ MIN64) < (b ^ MIN64)


def shr32(x):
    """Logical x >> 32."""
    return (x >> 32) & MASK32


def canonicalize(x):
    """One conditional subtraction; p > 2^63 makes it canonicalize any u64."""
    return torch.where(lt(x, P), x, x - P)


def add(x, y):
    s = x + y
    s = torch.where(lt(s, x), s + EPSILON, s)  # overflow: x+y-p = s+EPSILON
    return canonicalize(s)


def sub(x, y):
    d = x - y
    return torch.where(lt(x, y), d - EPSILON, d)  # borrow: x-y+p = d-EPSILON


def neg(x):
    return torch.where(x == 0, x, P - x)


def reduce128(lo, hi):
    """lo + hi·2^64 mod p, using 2^64 = EPSILON and 2^96 = -1."""
    hi_hi = shr32(hi)
    hi_lo = hi & MASK32
    t0 = lo - hi_hi
    t0 = torch.where(lt(lo, hi_hi), t0 - EPSILON, t0)
    t1 = hi_lo * EPSILON
    t2 = t0 + t1
    t2 = torch.where(lt(t2, t1), t2 + EPSILON, t2)
    return canonicalize(t2)


def mul(x, y):
    """x·y mod p via 32-bit limb products and reduce128."""
    xl, xh = x & MASK32, shr32(x)
    yl, yh = y & MASK32, shr32(y)
    ll = xl * yl
    lh = xl * yh
    hl = xh * yl
    hh = xh * yh
    mid = shr32(ll) + (lh & MASK32) + (hl & MASK32)  # < 3·2^32
    lo = (ll & MASK32) | ((mid & MASK32) << 32)
    hi = hh + shr32(lh) + shr32(hl) + shr32(mid)
    return reduce128(lo, hi)


def square(x):
    return mul(x, x)


@functools.lru_cache(maxsize=1 << 12)
def _scalar(c: int, device: str) -> torch.Tensor:
    return torch.full((), c, dtype=torch.int64, device=device)


def scalar_tensor(c, device) -> torch.Tensor:
    """A 0-d int64 tensor holding the u64 `c`. A tensor (a device draw of
    the transcript) passes through; a host int becomes a cached constant
    made by a fill on `device`, so no host-to-device copy runs."""
    if isinstance(c, torch.Tensor):
        return c
    return _scalar(i64(c), str(torch.device(device)))


def ext_tensor(c, device):
    """An extension element (c0, c1), host ints or 0-d tensors, as a pair
    of 0-d tensors."""
    return scalar_tensor(c[0], device), scalar_tensor(c[1], device)


_CONSTANTS: dict = {}


def constant(values, device) -> torch.Tensor:
    """`tensor(values, device)` made once per value and device: the
    per-circuit tables and index lists that a prove reuses, so a warm prove
    copies nothing from the host. The values are u64 (or nonnegative
    indices)."""
    arr = np.ascontiguousarray(np.asarray(values, dtype=np.uint64))
    key = (arr.tobytes(), arr.shape, str(device_key(device)))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = tensor(arr, device)
    return t


def mul_scalar(x, c: int):
    """x · c for a host int c (a scalar operand, no tensor made)."""
    return mul(x, i64(c % scalar.P))


def exp_u64(x, e: int):
    """x^e for a Python-int exponent (square-and-multiply)."""
    result = None
    base = x
    while e > 0:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return torch.ones_like(x) if result is None else result


def inverse(x):
    """x^(p-2) elementwise; inverse(0) == 0."""
    return exp_u64(x, scalar.P - 2)


def cumprod(x, dim: int = 0):
    """Inclusive modular prefix products along `dim`, in log2(len) steps
    (Hillis-Steele). Products are unique, so any association gives the
    sequential loop's values."""
    x = x.movedim(dim, 0)
    k = 1
    while k < x.shape[0]:
        x = torch.cat([x[:k], mul(x[k:], x[:-k])])
        k <<= 1
    return x.movedim(0, dim)


def cumprod_across(x, group=None):
    """Inclusive modular prefix products along the first axis of a vector
    split into P contiguous blocks over `group`'s ranks (the rank's blocks
    side by side, `parallel.shard_lanes`): each block's local scan times the
    product of every block before it, from an all-gather of one total a
    block (a collective never reduces a field value). Returns (this rank's
    products, the carries [L, ...]: each block's product of every element
    before it; 1 without a group)."""
    if group is None:
        incl = cumprod(x, 0)
        return incl, torch.ones_like(incl[:1])
    L = len(group.own_parts)
    blocks = x.reshape((L, -1) + tuple(x.shape[1:]))
    incl = cumprod(blocks, 1)
    totals = group.gather_parts(incl[:, -1])  # [P, ...], every rank takes part
    before = torch.cat([torch.ones_like(totals[:1]), cumprod(totals[:-1], 0)])
    own = group.own_parts
    carry = (before[own[0]:own[0] + 1] if L == 1
             else torch.stack([before[v] for v in own]))
    return mul(incl, carry[:, None]).reshape(x.shape), carry


def exclusive_blocks(incl, carry):
    """The exclusive prefix products of `cumprod_across`'s blocks: each
    block's carry, then its inclusive products but the last."""
    blocks = incl.reshape((carry.shape[0], -1) + tuple(incl.shape[1:]))
    return torch.cat([carry[:, None], blocks[:, :-1]], dim=1).reshape(incl.shape)


def cumsum(x, dim: int = 0):
    """Inclusive modular prefix sums along `dim` (fewer than 2^31 terms):
    torch.cumsum of the 32-bit halves stays below 2^63, and the two running
    sums recombine as lo + hi·2^32 mod p."""
    if x.shape[dim] >= 1 << 31:
        raise ValueError("cumsum takes fewer than 2^31 terms")
    lo = torch.cumsum(x & MASK32, dim)  # both < 2^63 < p: canonical
    hi = torch.cumsum(shr32(x), dim)
    return add(lo, mul_scalar(hi, 1 << 32))


def inverse_vector(x):
    """Inverse of a [n] vector (n a power of two): `inverse_rows` on its
    [2^(lg n / 2), n / 2^(lg n / 2)] reshape. inverse_vector(0) == 0."""
    split = 1 << ((x.shape[0].bit_length() - 1) // 2)
    return inverse_rows(x.reshape(split, -1)).reshape(-1)


def inverse_rows(x):
    """Inverse of [R, n] via the Montgomery trick along axis 0: prefix and
    suffix product scans, then one Fermat ladder on [n].
    inverse_rows(0) == 0."""
    is_zero = x == 0
    xs = torch.where(is_zero, torch.ones_like(x), x)
    pre = cumprod(xs, 0)  # pre[i] = x_0 ... x_i
    suf = cumprod(xs.flip(0), 0).flip(0)  # suf[i] = x_i ... x_{R-1}
    one = torch.ones_like(xs[:1])
    total_inv = inverse(pre[-1])
    inv = mul(mul(torch.cat([one, pre[:-1]]), torch.cat([suf[1:], one])), total_inv)
    return torch.where(is_zero, torch.zeros_like(x), inv)


def powers(z, n: int, device=None):
    """[1, z, ..., z^(n-1)] for z a 0-d tensor (or a host int, made on
    `device`), by log-doubling."""
    z = scalar_tensor(z, device)
    out = torch.ones((1,), dtype=torch.int64, device=z.device)
    step = z.reshape(1)  # z^len(out)
    while out.shape[0] < n:
        out = torch.cat([out, mul(out, step)])[:n]
        step = square(step)
    return out


def sum_mod(x, dim: int = 0):
    """Modular sum along `dim` by pairwise halving."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        half = x.shape[0] // 2
        x = add(x[:half], x[half:])
    return x[0]


def matmul_mod(m, x):
    """[r, c] x [c, Q] modular matrix product (one broadcast multiply and a
    halving sum over c)."""
    return sum_mod(mul(m[:, :, None], x[None, :, :]), 1)


# ---------------------------------------------------------------------------
# Quadratic extension F_p[X]/(X^2 - 7) as (a0, a1) tensor pairs.
# ---------------------------------------------------------------------------

W2 = 7


def ext2_add(a, b):
    return add(a[0], b[0]), add(a[1], b[1])


def ext2_sub(a, b):
    return sub(a[0], b[0]), sub(a[1], b[1])


def ext2_mul(a, b):
    """(a0 + a1 X)(b0 + b1 X) = a0 b0 + 7 a1 b1 + (a0 b1 + a1 b0) X."""
    a0, a1 = a
    b0, b1 = b
    c0 = add(mul(a0, b0), mul_scalar(mul(a1, b1), W2))
    c1 = add(mul(a0, b1), mul(a1, b0))
    return c0, c1


def ext2_scalar_mul(c, a):
    return mul(c, a[0]), mul(c, a[1])


def ext2_square(a):
    return ext2_mul(a, a)


def ext2_neg(a):
    return neg(a[0]), neg(a[1])


def ext2_inverse(a):
    """a^-1 = conj(a) / N(a), N(a) = a0^2 - 7 a1^2."""
    a0, a1 = a
    norm = sub(square(a0), mul_scalar(square(a1), W2))
    ninv = inverse(norm)
    return mul(a0, ninv), mul(neg(a1), ninv)


def ext2_sum_mod(a, dim: int = 0):
    return sum_mod(a[0], dim), sum_mod(a[1], dim)


def ext2_powers(z, n: int, device=None):
    """[1, z, ..., z^(n-1)] for an extension scalar z = (z0, z1) of 0-d
    tensors (or host ints, made on `device`), by log-doubling. Returns
    (p0, p1), each of length n."""
    z0, z1 = (t.reshape(1) for t in ext_tensor(z, device))
    p0 = torch.ones((1,), dtype=torch.int64, device=z0.device)
    p1 = torch.zeros((1,), dtype=torch.int64, device=z0.device)
    s0, s1 = z0, z1  # z^len(p)
    while p0.shape[0] < n:
        q0, q1 = ext2_mul((p0, p1), (s0, s1))
        p0 = torch.cat([p0, q0])[:n]
        p1 = torch.cat([p1, q1])[:n]
        s0, s1 = ext2_square((s0, s1))
    return p0, p1


def ext2_pow_static(x, e: int):
    """x^e for an extension scalar x of 0-d tensors and a host exponent e
    (square-and-multiply over e's bits)."""
    if e == 0:
        return torch.ones_like(x[0]), torch.zeros_like(x[1])
    acc = x
    for bit in bin(e)[3:]:
        acc = ext2_square(acc)
        if bit == "1":
            acc = ext2_mul(acc, x)
    return acc


# ---------------------------------------------------------------------------
# Host-side constant helpers (numpy, Python ints) for twiddle tables.
# ---------------------------------------------------------------------------

def np_powers(base: int, n: int) -> np.ndarray:
    """[1, base, ..., base^(n-1)] as numpy uint64."""
    out = np.empty(n, dtype=np.uint64)
    acc = 1
    for i in range(n):
        out[i] = acc
        acc = (acc * base) % scalar.P
    return out
