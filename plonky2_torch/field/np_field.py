"""Goldilocks arithmetic on host numpy u64 arrays, for the witness
generators (a copy of the reference package's `field/np_field.py`; numpy's
unsigned arithmetic wraps mod 2^64). Reference:
field/src/goldilocks_field.rs:245-429.

The generators' batch forms run here, on the host: witness generation is
data-dependent scheduling, not device math. The native witness plan
(`iop/witness_plan.py`) is the fast engine; these are the plain ones.
"""

from __future__ import annotations

import numpy as np

P = np.uint64(0xFFFFFFFF00000001)
EPSILON = np.uint64(0xFFFFFFFF)  # 2^32 - 1 = 2^64 mod p
MASK32 = np.uint64(0xFFFFFFFF)
_32 = np.uint64(32)


def canonicalize(x: np.ndarray) -> np.ndarray:
    return np.where(x >= P, x - P, x)


def add(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    s = x + y
    s = np.where(s < x, s + EPSILON, s)
    return canonicalize(s)


def sub(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    d = x - y
    return np.where(x < y, d - EPSILON, d)


def neg(x: np.ndarray) -> np.ndarray:
    return np.where(x == 0, x, P - x)


def reduce128(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    hi_hi = hi >> _32
    hi_lo = hi & MASK32
    t0 = lo - hi_hi
    t0 = np.where(lo < hi_hi, t0 - EPSILON, t0)
    t1 = hi_lo * EPSILON
    t2 = t0 + t1
    t2 = np.where(t2 < t1, t2 + EPSILON, t2)
    return canonicalize(t2)


def mul(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    xl = x & MASK32
    xh = x >> _32
    yl = y & MASK32
    yh = y >> _32
    ll = xl * yl
    lh = xl * yh
    hl = xh * yl
    hh = xh * yh
    mid = (ll >> _32) + (lh & MASK32) + (hl & MASK32)
    lo = (ll & MASK32) | ((mid & MASK32) << _32)
    hi = hh + (lh >> _32) + (hl >> _32) + (mid >> _32)
    return reduce128(lo, hi)


def ext2_mul(a0, a1, b0, b1, w: int = 7):
    """(a0 + a1 X)(b0 + b1 X) mod (X^2 - w)."""
    t = mul(a0, b0)
    u = mul(a1, b1)
    c0 = add(t, mul(u, np.uint64(w)))
    c1 = add(mul(a0, b1), mul(a1, b0))
    return c0, c1


def ext2_add(a0, a1, b0, b1):
    return add(a0, b0), add(a1, b1)


class NumpyBaseOps:
    """The gates' ops protocol (`gates/ops.py`) on numpy u64 arrays, so a
    gate's layer code fills witness rows of a whole batch at once."""

    def constant(self, c: int):
        return np.uint64(c % int(P))

    def zero(self):
        return np.uint64(0)

    def add(self, a, b):
        return add(a, b)

    def sub(self, a, b):
        return sub(a, b)

    def mul(self, a, b):
        return mul(a, b)

    def square(self, a):
        return mul(a, a)

    def add_const(self, a, c: int):
        return add(a, self.constant(c))

    def mul_const(self, c: int, a):
        return mul(self.constant(c), a)
