"""ArithmeticExtensionGate and MulExtensionGate: batched extension-field ops
(reference gates/arithmetic_extension.rs, gates/multiplication_extension.rs).

Groups of D consecutive wires hold extension elements; each op gives D
base constraints."""

from __future__ import annotations

import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.gates.gate import Gate
from plonky2_torch.gates.ops import ealg_add, ealg_mul, ealg_scalar_mul, ealg_sub

D = 2


def _interleave(c0, c1):
    """[n, Q] and [n, Q] -> [2n, Q] rows c0[0], c1[0], c0[1], ..."""
    return torch.stack([c0, c1], dim=1).reshape(2 * c0.shape[0], c0.shape[-1])


class ArithmeticExtensionGate(Gate):
    """const_0 * m0 * m1 + const_1 * addend over F_{p^D}."""

    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    def id(self) -> str:
        return f"ArithmeticExtensionGate {{ num_ops: {self.num_ops} }}"

    def eval_unfiltered(self, ops, vars) -> list:
        const_0 = vars.local_constants[0]
        const_1 = vars.local_constants[1]
        constraints = []
        for i in range(self.num_ops):
            base = 4 * D * i
            m0, m1, addend, output = (vars.get_local_ext_algebra(range(base + k * D,
                                                                       base + (k + 1) * D))
                                      for k in range(4))
            computed = ealg_add(ops, ealg_scalar_mul(ops, const_0, ealg_mul(ops, m0, m1)),
                                ealg_scalar_mul(ops, const_1, addend))
            constraints.extend(ealg_sub(ops, output, computed))
        return constraints

    def eval_unfiltered_device(self, wires, constants, public_inputs_hash):
        """One batched ext2 multiply over the [num_ops] axis."""
        n = self.num_ops
        w = [wires[off:4 * D * n:4 * D] for off in range(4 * D)]
        p = g.ext2_mul((w[0], w[1]), (w[2], w[3]))
        c0, c1 = constants[0][None], constants[1][None]
        r0 = g.add(g.mul(c0, p[0]), g.mul(c1, w[4]))
        r1 = g.add(g.mul(c0, p[1]), g.mul(c1, w[5]))
        return _interleave(g.sub(w[6], r0), g.sub(w[7], r1))

    def num_constraints(self) -> int:
        return self.num_ops * D


class MulExtensionGate(Gate):
    """const_0 * m0 * m1 over F_{p^D} (reference multiplication_extension.rs)."""

    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    def id(self) -> str:
        return f"MulExtensionGate {{ num_ops: {self.num_ops} }}"

    def eval_unfiltered(self, ops, vars) -> list:
        const_0 = vars.local_constants[0]
        constraints = []
        for i in range(self.num_ops):
            base = 3 * D * i
            m0, m1, output = (vars.get_local_ext_algebra(range(base + k * D,
                                                               base + (k + 1) * D))
                              for k in range(3))
            computed = ealg_scalar_mul(ops, const_0, ealg_mul(ops, m0, m1))
            constraints.extend(ealg_sub(ops, output, computed))
        return constraints

    def eval_unfiltered_device(self, wires, constants, public_inputs_hash):
        """One batched ext2 multiply over the [num_ops] axis."""
        n = self.num_ops
        w = [wires[off:3 * D * n:3 * D] for off in range(3 * D)]
        p = g.ext2_mul((w[0], w[1]), (w[2], w[3]))
        c0 = constants[0][None]
        return _interleave(g.sub(w[4], g.mul(c0, p[0])), g.sub(w[5], g.mul(c0, p[1])))

    def num_constraints(self) -> int:
        return self.num_ops * D
