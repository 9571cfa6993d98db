"""BaseSumGate: base-B little-endian limb decomposition with range checks
(reference gates/base_sum.rs)."""

from __future__ import annotations

import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import scalar as fs
from plonky2_torch.gates.gate import Gate

WIRE_SUM = 0
START_LIMBS = 1


class BaseSumGate(Gate):
    def __init__(self, num_limbs: int, base: int):
        self.num_limbs = num_limbs
        self.base = base

    def id(self) -> str:
        return f"BaseSumGate {{ num_limbs: {self.num_limbs} }} + Base: {self.base}"

    def eval_unfiltered(self, ops, vars) -> list:
        total = vars.local_wires[WIRE_SUM]
        limbs = [vars.local_wires[i] for i in range(START_LIMBS, START_LIMBS + self.num_limbs)]
        computed = ops.zero()
        for limb in reversed(limbs):
            computed = ops.add(ops.mul_const(self.base, computed), limb)
        constraints = [ops.sub(computed, total)]
        for limb in limbs:
            acc = limb  # prod_{i<B} (limb - i); the first factor is (limb - 0)
            for i in range(1, self.base):
                acc = ops.mul(acc, ops.add_const(limb, -i))
            constraints.append(acc)
        return constraints

    def eval_unfiltered_device(self, wires, constants, public_inputs_hash):
        """The weighted sum as one modular dot product, the range checks
        batched over the [num_limbs] axis."""
        limbs = wires[START_LIMBS:START_LIMBS + self.num_limbs]
        pows = g.constant(g.np_powers(self.base % fs.P, self.num_limbs), wires.device)
        computed = g.sum_mod(g.mul(pows[:, None], limbs), 0)
        acc = limbs
        for i in range(1, self.base):
            acc = g.mul(acc, g.sub(limbs, g.scalar_tensor(i, wires.device)))
        return torch.cat([g.sub(computed, wires[WIRE_SUM])[None], acc])

    def num_constraints(self) -> int:
        return 1 + self.num_limbs
