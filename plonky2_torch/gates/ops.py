"""Field-operation backends and extension algebra for gate constraints.

Each gate writes its constraints once against the ops protocol (constant,
zero, one, add, sub, mul, square, neg, add_const, mul_const), as in the
reference package's `gates/ops.py`. Four backends instantiate it:
`HostExtOps` on D = 2 extension tuples of Python ints (the verifier's
evaluation at ζ, reference `eval_unfiltered`), `HostBaseOps` on base-field
Python ints (a STARK's constraints replayed row by row on a trace),
`TorchBaseOps` on int64
tensors batched over the quotient domain (constants are 0-d tensors on the
ops' device, holding the int64 bit pattern of the canonical residue), and
`CircuitOps` on a builder's `ExtensionTarget`s (the in-circuit dual,
reference `eval_unfiltered_circuit`), which gives the recursive verifier
every gate's constraints in the order of the other two.
"""

from __future__ import annotations

from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import scalar as fs


class HostExtOps:
    """Values are D = 2 extension tuples of Python ints (reference package
    gates/ops.py:24)."""

    def constant(self, c: int):
        return (c % fs.P, 0)

    def zero(self):
        return (0, 0)

    def one(self):
        return (1, 0)

    def add(self, a, b):
        return fs.ext_add(a, b)

    def sub(self, a, b):
        return fs.ext_sub(a, b)

    def mul(self, a, b):
        return fs.ext_mul(a, b)

    def square(self, a):
        return fs.ext_mul(a, a)

    def neg(self, a):
        return fs.ext_neg(a)

    def add_const(self, a, c: int):
        return (fs.add(a[0], c % fs.P), a[1])

    def mul_const(self, c: int, a):
        return fs.ext_scalar_mul(c % fs.P, a)


class HostBaseOps:
    """Values are base-field Python ints (reference package
    gates/ops.py:93)."""

    def constant(self, c: int):
        return c % fs.P

    def zero(self):
        return 0

    def one(self):
        return 1

    def add(self, a, b):
        return fs.add(a, b)

    def sub(self, a, b):
        return fs.sub(a, b)

    def mul(self, a, b):
        return fs.mul(a, b)

    def square(self, a):
        return fs.mul(a, a)

    def neg(self, a):
        return fs.neg(a)

    def add_const(self, a, c: int):
        return fs.add(a, c % fs.P)

    def mul_const(self, c: int, a):
        return fs.mul(c % fs.P, a)


class TorchBaseOps:
    """Values are int64 tensors (base field) on one device."""

    def __init__(self, device):
        self.device = device

    def constant(self, c: int):
        return g.scalar_tensor(c % fs.P, self.device)

    def zero(self):
        return self.constant(0)

    def one(self):
        return self.constant(1)

    def add(self, a, b):
        return g.add(a, b)

    def sub(self, a, b):
        return g.sub(a, b)

    def mul(self, a, b):
        return g.mul(a, b)

    def square(self, a):
        return g.square(a)

    def neg(self, a):
        return g.neg(a)

    def add_const(self, a, c: int):
        return g.add(a, self.constant(c))

    def mul_const(self, c: int, a):
        return g.mul(self.constant(c), a)


class CircuitOps:
    """Values are ExtensionTargets: each op emits circuit operations on
    `builder` (reference package gates/ops.py:185-236)."""

    def __init__(self, builder):
        self.builder = builder

    def constant(self, c):
        if isinstance(c, int):
            return self.builder.constant_extension(c % fs.P)
        return self.builder.constant_extension(c)

    def zero(self):
        return self.builder.zero_extension()

    def one(self):
        return self.builder.one_extension()

    def add(self, a, b):
        return self.builder.add_extension(a, b)

    def sub(self, a, b):
        return self.builder.sub_extension(a, b)

    def mul(self, a, b):
        return self.builder.mul_extension(a, b)

    def square(self, a):
        return self.builder.square_extension(a)

    def neg(self, a):
        return self.builder.mul_const_extension(-1, a)

    def add_const(self, a, c: int):
        return self.builder.add_const_extension(a, c)

    def mul_const(self, c: int, a):
        return self.builder.mul_const_extension(c, a)

    def from_base_target(self, t):
        """A base Target lifted into the extension ops domain."""
        return self.builder.convert_to_ext(t)


class EvaluationVars:
    """local_constants / local_wires / public_inputs_hash are sequences of
    ops-domain values."""

    def __init__(self, local_constants, local_wires, public_inputs_hash):
        self.local_constants = local_constants
        self.local_wires = local_wires
        self.public_inputs_hash = public_inputs_hash

    def get_local_ext_algebra(self, rng) -> tuple:
        """D consecutive wires as an extension-algebra element."""
        return tuple(self.local_wires[i] for i in rng)


# -- extension algebra F_{p^D}[X]/(X^D - W) over ops-domain coefficients -------

_EALG_W = 7  # W for D = 2 Goldilocks


def ealg_zero(ops, d: int = 2) -> tuple:
    return tuple(ops.zero() for _ in range(d))


def ealg_from_base(ops, x, d: int = 2) -> tuple:
    return (x,) + tuple(ops.zero() for _ in range(d - 1))


def ealg_add(ops, a, b) -> tuple:
    return tuple(ops.add(x, y) for x, y in zip(a, b))


def ealg_sub(ops, a, b) -> tuple:
    return tuple(ops.sub(x, y) for x, y in zip(a, b))


def ealg_scalar_mul(ops, c, a) -> tuple:
    """c is an ops-domain value (the algebra's scalar field)."""
    return tuple(ops.mul(c, x) for x in a)


def ealg_mul(ops, a, b, w: int = _EALG_W) -> tuple:
    d = len(a)
    acc = [ops.zero()] * d
    for i in range(d):
        for j in range(d):
            k = i + j
            t = ops.mul(a[i], b[j])
            if k >= d:
                k -= d
                t = ops.mul_const(w, t)
            acc[k] = ops.add(acc[k], t)
    return tuple(acc)
