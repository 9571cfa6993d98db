"""BaseSumGate: base-B little-endian limb decomposition with range checks
(reference gates/base_sum.rs)."""

from __future__ import annotations

import numpy as np
import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import scalar as fs
from plonky2_torch.gates.gate import Gate
from plonky2_torch.iop.generator import SimpleGenerator
from plonky2_torch.iop.target import Wire

WIRE_SUM = 0
START_LIMBS = 1


class BaseSumGate(Gate):
    WIRE_SUM = WIRE_SUM
    START_LIMBS = START_LIMBS

    def __init__(self, num_limbs: int, base: int):
        self.num_limbs = num_limbs
        self.base = base

    @staticmethod
    def new_from_config(config, base: int) -> "BaseSumGate":
        """As many limbs as an element of the field needs (floor of
        log_base(p - 1)), at most the routed wires after the sum."""
        num_limbs, v = 0, fs.P - 1
        while v >= base:
            v //= base
            num_limbs += 1
        return BaseSumGate(min(num_limbs, config.num_routed_wires - START_LIMBS), base)

    def limbs(self) -> range:
        return range(START_LIMBS, START_LIMBS + self.num_limbs)

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

    def generators(self, row: int, local_constants: list[int]) -> list:
        return [BaseSplitGenerator(row, self.num_limbs, self.base)]

    def num_wires(self) -> int:
        return 1 + self.num_limbs

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return self.base

    def num_constraints(self) -> int:
        return 1 + self.num_limbs


class BaseSplitGenerator(SimpleGenerator):
    """The sum wire's base-B limbs (reference gates/base_sum.rs:86)."""

    def __init__(self, row: int, num_limbs: int, base: int):
        self.row = row
        self.num_limbs = num_limbs
        self.base = base

    def dependencies(self):
        return [Wire(self.row, WIRE_SUM)]

    def outputs(self):
        return [Wire(self.row, START_LIMBS + i) for i in range(self.num_limbs)]

    def run_once(self, witness, out):
        sum_value = witness.get_target(Wire(self.row, WIRE_SUM))
        limbs, v = [], sum_value
        for _ in range(self.num_limbs):
            limbs.append(v % self.base)
            v //= self.base
        if v != 0:
            raise ValueError(f"Integer {sum_value} too large for {self.num_limbs} limbs "
                             f"of base {self.base}")
        out.set_wires(self.row, range(START_LIMBS, START_LIMBS + self.num_limbs), limbs)

    @classmethod
    def run_batch(cls, gens, witness):
        by_shape: dict[tuple, list] = {}
        for g_ in gens:
            by_shape.setdefault((g_.num_limbs, g_.base), []).append(g_)
        for (num_limbs, base), gs in by_shape.items():
            rows = np.fromiter((g_.row for g_ in gs), np.int64, len(gs))
            sums = witness.get_reps(witness.wire_reps(rows, WIRE_SUM))
            v = sums.copy()
            limbs = np.empty((len(gs), num_limbs), np.uint64)
            b = np.uint64(base)
            for i in range(num_limbs):
                limbs[:, i] = v % b
                v //= b
            if (v != 0).any():
                k = int(np.nonzero(v)[0][0])
                raise ValueError(f"Integer {int(sums[k])} too large for {num_limbs} limbs "
                                 f"of base {base}")
            cols = np.arange(START_LIMBS, START_LIMBS + num_limbs, dtype=np.int64)
            reps = witness.wire_reps(rows[:, None], cols[None, :])
            witness.set_reps(reps.reshape(-1), limbs.reshape(-1))
