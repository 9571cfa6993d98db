"""ReducingGate / ReducingExtensionGate: Horner steps of alpha-reductions
(reference gates/reducing.rs, gates/reducing_extension.rs).

Wires: output (D), alpha (D), old accumulator (D), the coefficients (1 or
D each), then the intermediate accumulators (D each); the last step's
accumulator is the output."""

from __future__ import annotations

import numpy as np
import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import np_field as npf
from plonky2_torch.field import scalar as fs
from plonky2_torch.gates.gate import Gate, rows
from plonky2_torch.iop.generator import SimpleGenerator
from plonky2_torch.iop.target import Wire
from plonky2_torch.gates.ops import ealg_add, ealg_from_base, ealg_mul, ealg_sub

D = 2
WIRES_OUTPUT = range(0, D)
WIRES_ALPHA = range(D, 2 * D)
WIRES_OLD_ACC = range(2 * D, 3 * D)
START_COEFFS = 3 * D


class _Reducing(Gate):
    COEFF_WIDTH = 1  # wires per coefficient

    def __init__(self, num_coeffs: int):
        self.num_coeffs = num_coeffs

    @classmethod
    def max_coeffs_len(cls, num_wires: int, num_routed_wires: int) -> int:
        """The most coefficients a row takes: its routed wires hold the
        output, alpha, the old accumulator and the coefficients."""
        return min((num_routed_wires - 3 * D) // cls.COEFF_WIDTH,
                   (num_wires - 2 * D) // (cls.COEFF_WIDTH + D))

    @staticmethod
    def wires_output() -> range:
        return WIRES_OUTPUT

    @staticmethod
    def wires_alpha() -> range:
        return WIRES_ALPHA

    @staticmethod
    def wires_old_acc() -> range:
        return WIRES_OLD_ACC

    def wires_coeff(self, i: int) -> range:
        start = START_COEFFS + i * self.COEFF_WIDTH
        return range(start, start + self.COEFF_WIDTH)

    def _start_accs(self) -> int:
        return START_COEFFS + self.num_coeffs * self.COEFF_WIDTH

    def wires_accs(self, i: int) -> range:
        if i == self.num_coeffs - 1:
            return WIRES_OUTPUT
        return range(self._start_accs() + D * i, self._start_accs() + D * (i + 1))

    def _coeff(self, ops, vars, i):
        raise NotImplementedError

    def eval_unfiltered(self, ops, vars) -> list:
        alpha = vars.get_local_ext_algebra(WIRES_ALPHA)
        acc = vars.get_local_ext_algebra(WIRES_OLD_ACC)
        constraints = []
        for i in range(self.num_coeffs):
            computed = ealg_add(ops, ealg_mul(ops, acc, alpha), self._coeff(ops, vars, i))
            acc_i = vars.get_local_ext_algebra(self.wires_accs(i))
            constraints.extend(ealg_sub(ops, computed, acc_i))
            acc = acc_i
        return constraints

    def eval_unfiltered_device(self, wires, constants, public_inputs_hash):
        """Each Horner step reads its accumulator from the wires, so the
        num_coeffs constraints pairs are independent: one batched ext2
        multiply over the [num_coeffs] axis."""
        n = self.num_coeffs
        prev = [WIRES_OLD_ACC] + [self.wires_accs(i) for i in range(n - 1)]
        outs = [self.wires_accs(i) for i in range(n)]
        prev0, prev1 = rows(wires, [r[0] for r in prev]), rows(wires, [r[1] for r in prev])
        out0, out1 = rows(wires, [r[0] for r in outs]), rows(wires, [r[1] for r in outs])
        c0, c1 = g.ext2_mul((prev0, prev1), (wires[D][None], wires[D + 1][None]))
        coeffs = [rows(wires, [self.wires_coeff(i)[k] for i in range(n)])
                  for k in range(self.COEFF_WIDTH)]
        c0 = g.add(c0, coeffs[0])
        if self.COEFF_WIDTH == D:
            c1 = g.add(c1, coeffs[1])
        return torch.stack([g.sub(c0, out0), g.sub(c1, out1)], dim=1).reshape(
            D * n, wires.shape[-1])

    def num_wires(self) -> int:
        return 2 * D + self.num_coeffs * (self.COEFF_WIDTH + D)

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return 2

    def num_constraints(self) -> int:
        return D * self.num_coeffs


class ReducingGate(_Reducing):
    """acc' = acc * alpha + c for base-field coefficients c."""

    COEFF_WIDTH = 1

    def id(self) -> str:
        return f"ReducingGate {{ num_coeffs: {self.num_coeffs} }}"

    def wires_coeffs(self) -> range:
        return range(START_COEFFS, START_COEFFS + self.num_coeffs)

    def _coeff(self, ops, vars, i):
        return ealg_from_base(ops, vars.local_wires[self.wires_coeff(i)[0]], D)

    def generators(self, row: int, local_constants: list[int]) -> list:
        return [ReducingGenerator(row, self.num_coeffs)]


class ReducingExtensionGate(_Reducing):
    """acc' = acc * alpha + c for extension-field coefficients c."""

    COEFF_WIDTH = D

    def id(self) -> str:
        return f"ReducingExtensionGate {{ num_coeffs: {self.num_coeffs} }}"

    def _coeff(self, ops, vars, i):
        return vars.get_local_ext_algebra(self.wires_coeff(i))

    def generators(self, row: int, local_constants: list[int]) -> list:
        return [ReducingExtensionGenerator(row, self.num_coeffs)]


# -- witness generators (reference gates/reducing.rs:112,
#    reducing_extension.rs) ------------------------------------------------

class _ReducingGenerator(SimpleGenerator):
    """The Horner chain acc_i = acc_(i-1) · α + c_i; outputs each
    accumulator, then the output (the last accumulator again)."""

    GATE = None
    BATCH_MIN = 2

    def __init__(self, row: int, num_coeffs: int):
        self.row = row
        self.num_coeffs = num_coeffs

    def _out_cols(self) -> list[int]:
        gate = self.GATE(self.num_coeffs)
        return [c for i in range(self.num_coeffs) for c in gate.wires_accs(i)] + list(WIRES_OUTPUT)

    def dependencies(self):
        gate = self.GATE(self.num_coeffs)
        cols = list(WIRES_ALPHA) + list(WIRES_OLD_ACC) + [
            c for i in range(self.num_coeffs) for c in gate.wires_coeff(i)]
        return [Wire(self.row, c) for c in cols]

    def outputs(self):
        return [Wire(self.row, c) for c in self._out_cols()]

    def run_once(self, witness, out):
        v = witness.get_targets(self.dependencies())
        alpha, acc, width = (v[0], v[1]), (v[2], v[3]), self.GATE.COEFF_WIDTH
        vals = []
        for i in range(self.num_coeffs):
            c = v[4 + width * i:4 + width * (i + 1)]
            acc = fs.ext_add(fs.ext_mul(acc, alpha), (c[0], c[1] if width == D else 0))
            vals += list(acc)
        out.set_wires(self.row, self._out_cols(), vals + list(acc))

    @classmethod
    def run_batch(cls, gens, witness):
        """Rows grouped by num_coeffs: one numpy Horner chain a group."""
        by_n: dict[int, list] = {}
        for g_ in gens:
            by_n.setdefault(g_.num_coeffs, []).append(g_)
        width = cls.GATE.COEFF_WIDTH
        for num_coeffs, group in by_n.items():
            gate = cls.GATE(num_coeffs)
            rows_ = np.fromiter((g_.row for g_ in group), np.int64, len(group))
            get = lambda col: witness.get_reps(witness.wire_reps(rows_, col))  # noqa: E731
            a0, a1 = get(WIRES_ALPHA[0]), get(WIRES_ALPHA[1])
            acc0, acc1 = get(WIRES_OLD_ACC[0]), get(WIRES_OLD_ACC[1])
            vals = []
            for i in range(num_coeffs):
                wc = gate.wires_coeff(i)
                acc0, acc1 = npf.ext2_mul(acc0, acc1, a0, a1)
                acc0 = npf.add(acc0, get(wc[0]))
                if width == D:
                    acc1 = npf.add(acc1, get(wc[1]))
                vals += [acc0, acc1]
            vals += [acc0, acc1]
            cols = group[0]._out_cols()
            witness.set_reps(np.concatenate([witness.wire_reps(rows_, c) for c in cols]),
                             np.concatenate(vals))


class ReducingGenerator(_ReducingGenerator):
    GATE = ReducingGate


class ReducingExtensionGenerator(_ReducingGenerator):
    GATE = ReducingExtensionGate

