"""ExponentiationGate: base^e for an exponent given by its bits, one
square-and-multiply step a bit (reference gates/exponentiation.rs; the
reference package's gates/exponentiation.py).

Wires: the base, the num_power_bits bits (little-endian), the output, then
one intermediate value a bit. Step i (most significant bit first) checks
intermediate[i] = intermediate[i - 1]^2 · (bit · base + 1 - bit), with
intermediate[-1] = 1; the last constraint ties the output to the last
intermediate."""

from __future__ import annotations

import numpy as np
import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import np_field as npf
from plonky2_torch.field import scalar as fs
from plonky2_torch.gates.gate import Gate
from plonky2_torch.iop.generator import SimpleGenerator
from plonky2_torch.iop.target import Wire


class ExponentiationGate(Gate):
    def __init__(self, num_power_bits: int):
        self.num_power_bits = num_power_bits

    @staticmethod
    def new_from_config(config) -> "ExponentiationGate":
        """As many bits as the routed wires (less base and output) and the
        wires (each bit takes an intermediate too) allow."""
        max_routed = config.num_routed_wires - 2
        max_wires = (config.num_wires - 2) // 2
        return ExponentiationGate(min(max_routed, max_wires))

    def wire_base(self) -> int:
        return 0

    def wire_power_bit(self, i: int) -> int:
        return 1 + i

    def wire_output(self) -> int:
        return 1 + self.num_power_bits

    def wire_intermediate_value(self, i: int) -> int:
        return 2 + self.num_power_bits + i

    def id(self) -> str:
        return f"ExponentiationGate {{ num_power_bits: {self.num_power_bits} }}<D=2>"

    def eval_unfiltered(self, ops, vars) -> list:
        n = self.num_power_bits
        w = vars.local_wires
        base = w[self.wire_base()]
        power_bits = [w[self.wire_power_bit(i)] for i in range(n)]
        intermediates = [w[self.wire_intermediate_value(i)] for i in range(n)]
        constraints = []
        for i in range(n):
            prev = ops.one() if i == 0 else ops.square(intermediates[i - 1])
            cur_bit = power_bits[n - i - 1]
            not_cur_bit = ops.sub(ops.one(), cur_bit)
            computed = ops.mul(prev, ops.add(ops.mul(cur_bit, base), not_cur_bit))
            constraints.append(ops.sub(computed, intermediates[i]))
        constraints.append(ops.sub(w[self.wire_output()], intermediates[n - 1]))
        return constraints

    def eval_unfiltered_device(self, wires, constants, public_inputs_hash):
        """Each step's `prev` is the previous intermediate's wire squared,
        so the steps are independent: all of them in one batch over [n, Q]."""
        n = self.num_power_bits
        base = wires[self.wire_base()][None]
        bits_rev = wires[1:1 + n].flip(0)  # step i reads power bit n - 1 - i
        interm = wires[2 + n:2 + 2 * n]
        one = g.scalar_tensor(1, wires.device)
        prev = torch.cat([one.expand(1, wires.shape[-1]), g.square(interm[:-1])])
        mult = g.add(g.mul(bits_rev, base), g.sub(one, bits_rev))
        steps = g.sub(g.mul(prev, mult), interm)
        last = g.sub(wires[self.wire_output()], interm[-1])
        return torch.cat([steps, last[None]])

    def generators(self, row: int, local_constants: list[int]) -> list:
        return [ExponentiationGenerator(row, self.num_power_bits)]

    def num_wires(self) -> int:
        return self.wire_intermediate_value(self.num_power_bits - 1) + 1

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return 4

    def num_constraints(self) -> int:
        return self.num_power_bits + 1


class ExponentiationGenerator(SimpleGenerator):
    """The intermediates and the output of one ExponentiationGate row
    (reference gates/exponentiation.rs:181)."""

    def __init__(self, row: int, num_power_bits: int):
        self.row = row
        self.num_power_bits = num_power_bits

    def _gate(self) -> ExponentiationGate:
        return ExponentiationGate(self.num_power_bits)

    def dependencies(self):
        gate = self._gate()
        return [Wire(self.row, gate.wire_base())] + [
            Wire(self.row, gate.wire_power_bit(i)) for i in range(self.num_power_bits)]

    def outputs(self):
        gate = self._gate()
        return [Wire(self.row, gate.wire_intermediate_value(i))
                for i in range(self.num_power_bits)] + [Wire(self.row, gate.wire_output())]

    def run_once(self, witness, out):
        gate, row, n = self._gate(), self.row, self.num_power_bits
        base = witness.get_target(Wire(row, gate.wire_base()))
        bits = [witness.get_target(Wire(row, gate.wire_power_bit(i))) for i in range(n)]
        intermediates, cur = [], 1
        for i in range(n):
            if bits[n - i - 1] == 1:
                cur = fs.mul(cur, base)
            intermediates.append(cur)
            cur = fs.mul(cur, cur)
        for i, v in enumerate(intermediates):
            out.set_target(Wire(row, gate.wire_intermediate_value(i)), v)
        out.set_target(Wire(row, gate.wire_output()), intermediates[-1])

    @classmethod
    def run_batch(cls, gens, witness):
        by_bits: dict[int, list] = {}
        for g_ in gens:
            by_bits.setdefault(g_.num_power_bits, []).append(g_)
        for n, gs in by_bits.items():
            gate = ExponentiationGate(n)
            rows = np.fromiter((g_.row for g_ in gs), np.int64, len(gs))
            base = witness.get_reps(witness.wire_reps(rows, gate.wire_base()))
            cur = np.ones(len(gs), np.uint64)
            inter = np.empty((n, len(gs)), np.uint64)
            for i in range(n):
                bit = witness.get_reps(witness.wire_reps(rows, gate.wire_power_bit(n - i - 1)))
                cur = np.where(bit == 1, npf.mul(cur, base), cur)
                inter[i] = cur
                cur = npf.mul(cur, cur)
            cols = [gate.wire_intermediate_value(i) for i in range(n)] + [gate.wire_output()]
            vals = np.concatenate([inter, inter[-1:]])
            witness.set_reps(np.concatenate([witness.wire_reps(rows, c) for c in cols]),
                             vals.reshape(-1))
