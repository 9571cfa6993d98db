"""Host-side utilities: bit math, the α-reducing factor and wall-clock
scopes."""

from __future__ import annotations

import time
from contextlib import contextmanager

from plonky2_torch.field import scalar as fs


def log2_strict(n: int) -> int:
    k = n.bit_length() - 1
    if 1 << k != n:
        raise ValueError(f"{n} is not a power of two")
    return k


def reverse_bits(x: int, num_bits: int) -> int:
    out = 0
    for _ in range(num_bits):
        out = (out << 1) | (x & 1)
        x >>= 1
    return out


def reverse_index_bits(xs: list) -> list:
    k = log2_strict(len(xs))
    return [xs[reverse_bits(i, k)] for i in range(len(xs))]


class ReducingFactor:
    """Horner-with-shift-count α-reduction over extension elements (tuples)."""

    def __init__(self, base):
        self.base = base
        self.count = 0

    def reduce(self, values) -> tuple:
        """sum_i base^i * values[i], counting one mul per value."""
        values = list(values)
        d = len(self.base)
        acc = fs.ext_zero(d)
        for v in reversed(values):
            self.count += 1
            acc = fs.ext_add(fs.ext_mul(acc, self.base), self._lift(v, d))
        return acc

    def shift(self, x: tuple) -> tuple:
        out = fs.ext_mul(fs.ext_exp(self.base, self.count), x)
        self.count = 0
        return out

    def _lift(self, v, d):
        if isinstance(v, (tuple, list)):
            return tuple(v)
        return fs.ext_from_base(v, d)


class TimingTree:
    """Wall-clock scopes of a run (reference util/timing.rs:8-193). `sync`,
    where given, runs at each scope's start and end (for example
    torch.cuda.synchronize), so that a scope's time holds its device work."""

    def __init__(self, name: str = "root", sync=None):
        self.name = name
        self.sync = sync
        self.duration = 0.0
        self.children: list[TimingTree] = []
        self._stack: list[TimingTree] = [self]

    @contextmanager
    def scope(self, name: str):
        child = TimingTree(name)
        self._stack[-1].children.append(child)
        self._stack.append(child)
        if self.sync:
            self.sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                self.sync()
            child.duration = time.perf_counter() - start
            self._stack.pop()

    def split(self) -> dict[str, float]:
        """Seconds by top-level scope name, in scope order."""
        return {c.name: c.duration for c in self.children}
