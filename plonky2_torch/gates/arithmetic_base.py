"""ArithmeticGate: batched `const_0 * m0 * m1 + const_1 * addend` ops
(reference gates/arithmetic_base.rs)."""

from __future__ import annotations

from plonky2_torch.field import goldilocks as g
from plonky2_torch.gates.gate import Gate
from plonky2_torch.iop.generator import ArithmeticBaseGenerator


class ArithmeticGate(Gate):
    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    @staticmethod
    def new_from_config(config) -> "ArithmeticGate":
        return ArithmeticGate(config.num_routed_wires // 4)

    @staticmethod
    def wire_ith_multiplicand_0(i: int) -> int:
        return 4 * i

    @staticmethod
    def wire_ith_multiplicand_1(i: int) -> int:
        return 4 * i + 1

    @staticmethod
    def wire_ith_addend(i: int) -> int:
        return 4 * i + 2

    @staticmethod
    def wire_ith_output(i: int) -> int:
        return 4 * i + 3

    def id(self) -> str:
        return f"ArithmeticGate {{ num_ops: {self.num_ops} }}"

    def eval_unfiltered(self, ops, vars) -> list:
        const_0 = vars.local_constants[0]
        const_1 = vars.local_constants[1]
        w = vars.local_wires
        constraints = []
        for i in range(self.num_ops):
            m0, m1, addend, output = w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]
            computed = ops.add(ops.mul(ops.mul(m0, m1), const_0), ops.mul(addend, const_1))
            constraints.append(ops.sub(output, computed))
        return constraints

    def eval_unfiltered_device(self, wires, constants, public_inputs_hash):
        """All num_ops constraints in one batched op set."""
        n = self.num_ops
        m0, m1, addend, output = (wires[off:4 * n:4] for off in range(4))
        computed = g.add(g.mul(g.mul(m0, m1), constants[0][None]),
                         g.mul(addend, constants[1][None]))
        return g.sub(output, computed)

    def generators(self, row: int, local_constants: list[int]) -> list:
        return [ArithmeticBaseGenerator(row, local_constants[0], local_constants[1], i)
                for i in range(self.num_ops)]

    def num_wires(self) -> int:
        return 4 * self.num_ops

    def num_constants(self) -> int:
        return 2

    def degree(self) -> int:
        return 3

    def num_constraints(self) -> int:
        return self.num_ops
