"""Bit splits and range checks: the builder side and their generators
(reference gadgets/split_join.rs, gadgets/range_check.rs; the reference
package's gadgets/split_join.py)."""

from __future__ import annotations

from plonky2_torch.gates.base_sum import START_LIMBS, WIRE_SUM, BaseSumGate
from plonky2_torch.iop.generator import SimpleGenerator
from plonky2_torch.iop.target import BoolTarget, Target, Wire


class WireSplitGenerator(SimpleGenerator):
    """Spreads an integer over the sum wires of BaseSum<2> gates,
    `num_limbs` bits a gate."""

    def __init__(self, integer: Target, gates: list[int], num_limbs: int):
        self.integer = integer
        self.gates = gates
        self.num_limbs = num_limbs

    def dependencies(self):
        return [self.integer]

    def outputs(self):
        return [Wire(row, WIRE_SUM) for row in self.gates]

    def run_once(self, witness, out):
        v = witness.get_target(self.integer)
        for row in self.gates:
            out.set_target(Wire(row, WIRE_SUM), v & ((1 << self.num_limbs) - 1))
            v >>= self.num_limbs
        if v != 0:
            raise ValueError(f"Integer too large to fit in {len(self.gates)} limb gates")


class LowHighGenerator(SimpleGenerator):
    """low = x mod 2^n_log, high = x >> n_log (reference
    gadgets/range_check.rs:56-100)."""

    def __init__(self, integer: Target, n_log: int, low: Target, high: Target):
        self.integer = integer
        self.n_log = n_log
        self.low = low
        self.high = high

    def dependencies(self):
        return [self.integer]

    def outputs(self):
        return [self.low, self.high]

    def run_once(self, witness, out):
        v = witness.get_target(self.integer)
        out.set_target(self.low, v & ((1 << self.n_log) - 1))
        out.set_target(self.high, v >> self.n_log)


def split_le(builder, integer: Target, num_bits: int) -> list[BoolTarget]:
    """Little-endian bits of `integer` on BaseSum<2> gates (reference
    gadgets/split_join.rs:25-59; the reference package's
    gadgets/split_join.py:52)."""
    if num_bits == 0:
        return []
    num_limbs = BaseSumGate.new_from_config(builder.config, 2).num_limbs
    k = -(-num_bits // num_limbs)
    gates = [builder.add_gate(BaseSumGate(num_limbs, 2), []) for _ in range(k)]
    bits = [BoolTarget(Wire(row, column)) for row in gates
            for column in range(START_LIMBS, START_LIMBS + num_limbs)]
    for b in bits[num_bits:]:
        builder.assert_zero(b.target)
    acc = builder.zero()
    for row in reversed(gates):
        acc = builder.mul_const_add(1 << num_limbs, acc, Wire(row, WIRE_SUM))
    builder.connect(acc, integer)
    builder.add_simple_generator(WireSplitGenerator(integer, gates, num_limbs))
    return bits[:num_bits]


def range_check(builder, x: Target, n_log: int) -> None:
    """x < 2^n_log (reference gadgets/range_check.rs)."""
    split_le(builder, x, n_log)


def low_bits(builder, x: Target, num_low_bits: int, num_bits: int) -> list[BoolTarget]:
    """The low `num_low_bits` of the `num_bits`-bit split of x (all
    `num_bits` are allocated and checked)."""
    return split_le(builder, x, num_bits)[:num_low_bits]


def split_low_high(builder, x: Target, n_log: int, num_bits: int) -> tuple[Target, Target]:
    """(low, high) with x = low + 2^n_log · high, low < 2^n_log and
    high < 2^(num_bits - n_log) (reference gadgets/range_check.rs:35-53)."""
    low = builder.add_virtual_target()
    high = builder.add_virtual_target()
    builder.add_simple_generator(LowHighGenerator(x, n_log, low, high))
    range_check(builder, low, n_log)
    range_check(builder, high, num_bits - n_log)
    pow2 = builder.constant(1 << n_log)
    comp_x = builder.mul_add(high, pow2, low)
    builder.connect(x, comp_x)
    return low, high
