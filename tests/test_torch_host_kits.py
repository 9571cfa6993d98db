"""The port's own copies of the reference's host test kits
(`plonky2_torch/field/secp256k1.py`, `field/field_testing.py`,
`gates/gate_testing.py`): the secp256k1 fields held to the reference's on
values drawn with numpy seed 2026, the axiom kit run on the port's
Goldilocks, its extension fields and secp256k1, and the gate kit (the
low-degree check at n = 2^2 and the batched evaluation against the host
one) over every gate of `plonky2_torch/gates/`. Exact: every value is a
field element."""

import random

import numpy as np
import pytest

from plonky2_tpu.field.secp256k1 import Secp256k1Base as RefBase
from plonky2_tpu.field.secp256k1 import Secp256k1Scalar as RefScalar
from plonky2_torch.field import scalar as fs
from plonky2_torch.field.field_testing import (
    FieldOps,
    check_field_axioms,
    check_frobenius,
    check_inverse_2exp,
    prime_field_ops,
)
from plonky2_torch.field.secp256k1 import Secp256k1Base, Secp256k1Scalar
from plonky2_torch.gates.arithmetic_base import ArithmeticGate
from plonky2_torch.gates.arithmetic_extension import ArithmeticExtensionGate, MulExtensionGate
from plonky2_torch.gates.base_sum import BaseSumGate
from plonky2_torch.gates.coset_interpolation import CosetInterpolationGate
from plonky2_torch.gates.exponentiation import ExponentiationGate
from plonky2_torch.gates.gate_testing import device_vs_scalar_check, low_degree_check
from plonky2_torch.gates.lookup import LookupGate, LookupTableGate
from plonky2_torch.gates.poseidon_gate import PoseidonGate
from plonky2_torch.gates.poseidon_mds import PoseidonMdsGate
from plonky2_torch.gates.random_access import RandomAccessGate
from plonky2_torch.gates.reducing import ReducingExtensionGate, ReducingGate
from plonky2_torch.gates.simple_gates import ConstantGate, NoopGate, PublicInputGate

LUT = [(i, (i * i) % 256) for i in range(8)]
GATES = [
    ArithmeticGate(20),
    ArithmeticExtensionGate(10),
    MulExtensionGate(13),
    BaseSumGate(11, 6),
    BaseSumGate(32, 2),
    ConstantGate(2),
    CosetInterpolationGate(2),
    CosetInterpolationGate(4, 6),
    ExponentiationGate(17),
    LookupGate(40, LUT),
    LookupTableGate(26, LUT, 100),
    NoopGate(),
    PoseidonGate(),
    PoseidonMdsGate(),
    PublicInputGate(),
    RandomAccessGate(4, 4, 2),
    ReducingGate(21),
    ReducingExtensionGate(12),
]


def _seeded_values(p: int, count: int = 24) -> list[int]:
    """Values below p from numpy seed 2026 (four 64-bit words each)."""
    words = np.random.default_rng(2026).integers(0, 1 << 63, size=(count, 4), dtype=np.uint64)
    return [sum(int(w) << (64 * i) for i, w in enumerate(row)) % p for row in words]


@pytest.mark.parametrize("port, ref", [(Secp256k1Base, RefBase), (Secp256k1Scalar, RefScalar)],
                         ids=["base", "scalar"])
def test_secp256k1_fields_equal_the_reference(port, ref):
    assert (port.P, port.TWO_ADICITY, port.MULTIPLICATIVE_GROUP_GENERATOR,
            port.POWER_OF_TWO_GENERATOR) == (ref.P, ref.TWO_ADICITY,
                                             ref.MULTIPLICATIVE_GROUP_GENERATOR,
                                             ref.POWER_OF_TWO_GENERATOR)
    xs = _seeded_values(port.P)
    for a, b in zip(xs, xs[1:] + xs[:1]):
        for op in ("add", "sub", "mul", "div"):
            assert getattr(port, op)(a, b) == getattr(ref, op)(a, b), op
        for op in ("neg", "square", "inverse", "sqrt"):
            assert getattr(port, op)(a) == getattr(ref, op)(a), op
        assert port.exp(a, b) == ref.exp(a, b)
    for n_log in range(port.TWO_ADICITY + 1):
        assert port.primitive_root_of_unity(n_log) == ref.primitive_root_of_unity(n_log)


def test_goldilocks_axioms():
    check_field_axioms(prime_field_ops(fs.P))
    check_inverse_2exp(fs.P, lambda e: fs.inverse(pow(2, e, fs.P)))


@pytest.mark.parametrize("cls", [Secp256k1Base, Secp256k1Scalar], ids=["base", "scalar"])
def test_secp256k1_axioms(cls):
    check_field_axioms(prime_field_ops(cls.P, num_random=16, seed=1))
    ops = FieldOps(add=cls.add, mul=cls.mul, neg=cls.neg, inverse=cls.inverse, zero=0, one=1,
                   samples=_seeded_values(cls.P, 12))
    check_field_axioms(ops)
    for a in ops.samples:
        root = cls.sqrt(cls.square(a))
        assert root is not None and cls.square(root) == cls.square(a)


@pytest.mark.parametrize("d", [2, 4, 5])
def test_extension_axioms(d):
    rng = random.Random(d)
    edge = [tuple([0] * d), tuple([1] + [0] * (d - 1))]
    samples = edge + [tuple(rng.randrange(fs.P) for _ in range(d)) for _ in range(14)]
    ops = FieldOps(add=fs.ext_add, mul=fs.ext_mul, neg=fs.ext_neg, inverse=fs.ext_inverse,
                   zero=tuple([0] * d), one=tuple([1] + [0] * (d - 1)), samples=samples)
    check_field_axioms(ops)
    x = tuple(rng.randrange(fs.P) for _ in range(d))
    check_frobenius(d, fs.ext_frobenius, fs.ext_mul, x)
    assert tuple(fs.ext_frobenius(x)) == tuple(fs.ext_exp(x, fs.P))


@pytest.mark.parametrize("gate", GATES, ids=lambda gate: gate.id()[:40])
def test_gate_low_degree(gate):
    low_degree_check(gate)


@pytest.mark.parametrize("gate", GATES, ids=lambda gate: gate.id()[:40])
def test_gate_device_equals_host(gate):
    device_vs_scalar_check(gate)
