"""ArithmeticExtensionGate and MulExtensionGate: batched extension-field ops
(reference gates/arithmetic_extension.rs, gates/multiplication_extension.rs).

Groups of D consecutive wires hold extension elements; each op gives D
base constraints."""

from __future__ import annotations

import numpy as np
import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import np_field as npf
from plonky2_torch.field import scalar as fs
from plonky2_torch.gates.gate import Gate
from plonky2_torch.gates.ops import ealg_add, ealg_mul, ealg_scalar_mul, ealg_sub
from plonky2_torch.iop.generator import SimpleGenerator
from plonky2_torch.iop.target import Wire

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

    # the wires of op i, D each: m0, m1, the addend, the output
    @staticmethod
    def wires_ith_multiplicand_0(i: int) -> range:
        return range(4 * D * i, 4 * D * i + D)

    @staticmethod
    def wires_ith_multiplicand_1(i: int) -> range:
        return range(4 * D * i + D, 4 * D * i + 2 * D)

    @staticmethod
    def wires_ith_addend(i: int) -> range:
        return range(4 * D * i + 2 * D, 4 * D * i + 3 * D)

    @staticmethod
    def wires_ith_output(i: int) -> range:
        return range(4 * D * i + 3 * D, 4 * D * i + 4 * D)

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

    @staticmethod
    def new_from_config(config) -> "ArithmeticExtensionGate":
        return ArithmeticExtensionGate(config.num_routed_wires // (4 * D))

    def generators(self, row: int, local_constants: list[int]) -> list:
        return [ArithmeticExtensionGenerator(row, local_constants[0], local_constants[1], i)
                for i in range(self.num_ops)]

    def num_wires(self) -> int:
        return 4 * D * self.num_ops

    def num_constants(self) -> int:
        return 2

    def degree(self) -> int:
        return 3

    def num_constraints(self) -> int:
        return self.num_ops * D


class MulExtensionGate(Gate):
    """const_0 * m0 * m1 over F_{p^D} (reference multiplication_extension.rs)."""

    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    def id(self) -> str:
        return f"MulExtensionGate {{ num_ops: {self.num_ops} }}"

    # the wires of op i, D each: m0, m1, the output
    @staticmethod
    def wires_ith_multiplicand_0(i: int) -> range:
        return range(3 * D * i, 3 * D * i + D)

    @staticmethod
    def wires_ith_multiplicand_1(i: int) -> range:
        return range(3 * D * i + D, 3 * D * i + 2 * D)

    @staticmethod
    def wires_ith_output(i: int) -> range:
        return range(3 * D * i + 2 * D, 3 * D * i + 3 * D)

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

    @staticmethod
    def new_from_config(config) -> "MulExtensionGate":
        return MulExtensionGate(config.num_routed_wires // (3 * D))

    def generators(self, row: int, local_constants: list[int]) -> list:
        return [MulExtensionGenerator(row, local_constants[0], i) for i in range(self.num_ops)]

    def num_wires(self) -> int:
        return 3 * D * self.num_ops

    def num_constants(self) -> int:
        return 1

    def degree(self) -> int:
        return 3

    def num_constraints(self) -> int:
        return self.num_ops * D


# -- witness generators (reference gates/arithmetic_extension.rs:107,
#    multiplication_extension.rs) ------------------------------------------

class _ExtOpGenerator(SimpleGenerator):
    """One op slot: the ext2 inputs in wire order, then the output pair."""

    WIDTH = 4 * D  # wires an op slot takes
    N_IN = 3  # extension inputs: m0, m1 (and the addend where WIDTH is 4D)

    def _base(self) -> int:
        return self.WIDTH * self.i

    def dependencies(self):
        return [Wire(self.row, self._base() + k) for k in range(self.N_IN * D)]

    def outputs(self):
        return [Wire(self.row, self._base() + self.N_IN * D + k) for k in range(D)]

    def run_once(self, witness, out):
        v = witness.get_targets(self.dependencies())
        out.set_wires(self.row, [t.column for t in self.outputs()],
                      self._compute(fs.ext_mul((v[0], v[1]), (v[2], v[3])), v[4:]))

    @classmethod
    def run_batch(cls, gens, witness):
        """Every (row, op slot) of the batch in one numpy pass."""
        n = len(gens)
        rows = np.fromiter((g.row for g in gens), np.int64, n)
        base = np.fromiter((g._base() for g in gens), np.int64, n)
        v = [witness.get_reps(witness.wire_reps(rows, base + k)) for k in range(cls.N_IN * D)]
        p0, p1 = npf.ext2_mul(v[0], v[1], v[2], v[3])
        r0, r1 = cls._compute_np(gens, (p0, p1), v[4:])
        witness.set_reps(np.concatenate([witness.wire_reps(rows, base + cls.N_IN * D),
                                         witness.wire_reps(rows, base + cls.N_IN * D + 1)]),
                         np.concatenate([r0, r1]))


class ArithmeticExtensionGenerator(_ExtOpGenerator):
    """output = c0 · m0 · m1 + c1 · addend over F_{p^2}."""

    WIDTH, N_IN = 4 * D, 3

    def __init__(self, row: int, const_0: int, const_1: int, i: int):
        self.row = row
        self.const_0 = const_0
        self.const_1 = const_1
        self.i = i

    def _compute(self, prod, addend):
        return fs.ext_add(fs.ext_scalar_mul(self.const_0, prod),
                          fs.ext_scalar_mul(self.const_1, tuple(addend)))

    @staticmethod
    def _compute_np(gens, prod, addend):
        n = len(gens)
        c0 = np.fromiter((g.const_0 for g in gens), np.uint64, n)
        c1 = np.fromiter((g.const_1 for g in gens), np.uint64, n)
        return tuple(npf.add(npf.mul(c0, p), npf.mul(c1, a)) for p, a in zip(prod, addend))


class MulExtensionGenerator(_ExtOpGenerator):
    """output = c0 · m0 · m1 over F_{p^2}."""

    WIDTH, N_IN = 3 * D, 2

    def __init__(self, row: int, const_0: int, i: int):
        self.row = row
        self.const_0 = const_0
        self.i = i

    def _compute(self, prod, _):
        return fs.ext_scalar_mul(self.const_0, prod)

    @staticmethod
    def _compute_np(gens, prod, _):
        c0 = np.fromiter((g.const_0 for g in gens), np.uint64, len(gens))
        return tuple(npf.mul(c0, p) for p in prod)
