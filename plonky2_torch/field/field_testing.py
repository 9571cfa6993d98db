"""Generic field-axiom test kit (reference field/src/field_testing.rs and
prime_field_testing.rs; the reference package's field/field_testing.py):
the ring and field laws, checked for every field and extension the port
ships on boundary and seeded samples.

Host scalars only: the device forms are held to these by the field tests
(tests/test_torch_field.py).
"""

from __future__ import annotations

import random


class FieldOps:
    """Adapter: the axioms run against (add, mul, neg, inverse, zero, one)."""

    def __init__(self, add, mul, neg, inverse, zero, one, samples):
        self.add = add
        self.mul = mul
        self.neg = neg
        self.inverse = inverse
        self.zero = zero
        self.one = one
        self.samples = list(samples)


def prime_field_ops(p: int, num_random: int = 24, seed: int = 0) -> FieldOps:
    rng = random.Random(seed)
    edge = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2]
    samples = edge + [rng.randrange(p) for _ in range(num_random)]
    return FieldOps(
        add=lambda a, b: (a + b) % p,
        mul=lambda a, b: (a * b) % p,
        neg=lambda a: (-a) % p,
        inverse=lambda a: pow(a, p - 2, p),
        zero=0,
        one=1,
        samples=samples,
    )


def check_field_axioms(ops: FieldOps) -> None:
    """Commutativity, associativity, identities, inverses, distributivity
    (reference field_testing.rs test_field_arithmetic! expansion)."""
    xs = ops.samples
    add, mul, neg, inv = ops.add, ops.mul, ops.neg, ops.inverse
    zero, one = ops.zero, ops.one
    for a in xs:
        assert add(a, zero) == a
        assert mul(a, one) == a
        assert mul(a, zero) == zero
        assert add(a, neg(a)) == zero
        if a != zero:
            assert mul(a, inv(a)) == one
        # double negation / self-subtraction
        assert neg(neg(a)) == a
    for a in xs[:12]:
        for b in xs[:12]:
            assert add(a, b) == add(b, a)
            assert mul(a, b) == mul(b, a)
            for c in xs[:8]:
                assert add(add(a, b), c) == add(a, add(b, c))
                assert mul(mul(a, b), c) == mul(a, mul(b, c))
                assert mul(a, add(b, c)) == add(mul(a, b), mul(a, c))


def check_inverse_2exp(p: int, inverse_2exp) -> None:
    """x/2^e consistency (reference prime_field_testing.rs)."""
    for e in [0, 1, 2, 31, 32, 33, 63, 64, 65, 100]:
        got = inverse_2exp(e)
        assert (got * pow(2, e, p)) % p == 1


def check_frobenius(d: int, frobenius, ext_mul, ext_sample) -> None:
    """phi(x) = x^p and phi^d = identity."""
    x = ext_sample
    y = x
    for _ in range(d):
        y = frobenius(y)
    assert y == x
