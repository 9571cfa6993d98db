"""RandomAccessGate: in-circuit array indexing through a bit-decomposed
index (reference gates/random_access.rs).

Per copy: the access index, the claimed element, then the 2^bits list
items; after all copies the extra constants' wires; after those, each
copy's index bits."""

from __future__ import annotations

import numpy as np
import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.gates.gate import Gate, rows
from plonky2_torch.iop.generator import SimpleGenerator
from plonky2_torch.iop.target import Wire


class RandomAccessGate(Gate):
    def __init__(self, bits: int, num_copies: int, num_extra_constants: int):
        self.bits = bits
        self.num_copies = num_copies
        self.num_extra_constants = num_extra_constants

    @property
    def num_ops(self) -> int:
        """The op slots `find_slot` hands out: one a copy."""
        return self.num_copies

    def vec_size(self) -> int:
        return 1 << self.bits

    def wire_access_index(self, copy: int) -> int:
        return (2 + self.vec_size()) * copy

    def wire_claimed_element(self, copy: int) -> int:
        return (2 + self.vec_size()) * copy + 1

    def wire_list_item(self, i: int, copy: int) -> int:
        return (2 + self.vec_size()) * copy + 2 + i

    def wire_extra_constant(self, i: int) -> int:
        return (2 + self.vec_size()) * self.num_copies + i

    def wire_bit(self, i: int, copy: int) -> int:
        return self.wire_extra_constant(self.num_extra_constants) + copy * self.bits + i

    def id(self) -> str:
        return (f"RandomAccessGate {{ bits: {self.bits}, num_copies: {self.num_copies}, "
                f"num_extra_constants: {self.num_extra_constants} }}<D=2>")

    def eval_unfiltered(self, ops, vars) -> list:
        w = vars.local_wires
        constraints = []
        for copy in range(self.num_copies):
            items = [w[self.wire_list_item(i, copy)] for i in range(self.vec_size())]
            bits = [w[self.wire_bit(i, copy)] for i in range(self.bits)]
            for b in bits:
                constraints.append(ops.mul(b, ops.sub(b, ops.one())))
            reconstructed = ops.zero()
            for b in reversed(bits):
                reconstructed = ops.add(ops.add(reconstructed, reconstructed), b)
            constraints.append(ops.sub(reconstructed, w[self.wire_access_index(copy)]))
            for b in bits:
                items = [ops.add(x, ops.mul(b, ops.sub(y, x)))
                         for x, y in zip(items[::2], items[1::2])]
            constraints.append(ops.sub(items[0], w[self.wire_claimed_element(copy)]))
        for i in range(self.num_extra_constants):
            constraints.append(ops.sub(vars.local_constants[i],
                                       w[self.wire_extra_constant(i)]))
        return constraints

    def eval_unfiltered_device(self, wires, constants, public_inputs_hash):
        """Over the [num_copies] axis; the bit-select tree runs once on
        [copies, vec, Q]."""
        C, B, V = self.num_copies, self.bits, self.vec_size()
        Q = wires.shape[-1]
        idx = rows(wires, [self.wire_access_index(c) for c in range(C)])  # [C, Q]
        claimed = rows(wires, [self.wire_claimed_element(c) for c in range(C)])
        items = rows(wires, [self.wire_list_item(i, c)
                             for c in range(C) for i in range(V)]).reshape(C, V, Q)
        bits = rows(wires, [self.wire_bit(i, c)
                            for c in range(C) for i in range(B)]).reshape(C, B, Q)
        one = g.scalar_tensor(1, wires.device)
        bit_checks = g.mul(bits, g.sub(bits, one))  # [C, B, Q]
        recon = torch.zeros((C, Q), dtype=torch.int64, device=wires.device)
        for i in range(B - 1, -1, -1):
            recon = g.add(g.add(recon, recon), bits[:, i])
        sel = items
        for i in range(B):
            x, y = sel[:, ::2], sel[:, 1::2]
            sel = g.add(x, g.mul(bits[:, i:i + 1], g.sub(y, x)))
        per_copy = torch.cat([bit_checks, g.sub(recon, idx)[:, None],
                              g.sub(sel[:, 0], claimed)[:, None]], dim=1)
        out = [per_copy.reshape(C * (B + 2), Q)]
        if self.num_extra_constants:
            extras = wires[self.wire_extra_constant(0):
                           self.wire_extra_constant(self.num_extra_constants)]
            out.append(g.sub(constants[:self.num_extra_constants], extras))
        return torch.cat(out)

    @staticmethod
    def new_from_config(config, bits: int) -> "RandomAccessGate":
        vec_size = 1 << bits
        max_copies = min(config.num_routed_wires // (2 + vec_size),
                         config.num_wires // (2 + vec_size + bits))
        max_extra_constants = config.num_routed_wires - (2 + vec_size) * max_copies
        return RandomAccessGate(bits, max_copies, min(max_extra_constants, config.num_constants))

    def generators(self, row: int, local_constants: list[int]) -> list:
        return [RandomAccessGenerator(row, self.bits, self.num_copies,
                                      self.num_extra_constants, copy)
                for copy in range(self.num_copies)]

    def extra_constant_wires(self) -> list[tuple[int, int]]:
        return [(i, self.wire_extra_constant(i)) for i in range(self.num_extra_constants)]

    def num_wires(self) -> int:
        return self.wire_bit(self.bits - 1, self.num_copies - 1) + 1

    def num_constants(self) -> int:
        return self.num_extra_constants

    def degree(self) -> int:
        return self.bits + 1

    def num_constraints(self) -> int:
        return self.num_copies * (self.bits + 2) + self.num_extra_constants


class RandomAccessGenerator(SimpleGenerator):
    """One copy's claimed element and index bits (reference
    gates/random_access.rs:162)."""

    def __init__(self, row, bits, num_copies, num_extra_constants, copy):
        self.row = row
        self.bits = bits
        self.num_copies = num_copies
        self.num_extra_constants = num_extra_constants
        self.copy = copy

    def _gate(self) -> RandomAccessGate:
        return RandomAccessGate(self.bits, self.num_copies, self.num_extra_constants)

    def dependencies(self):
        gate = self._gate()
        return [Wire(self.row, gate.wire_access_index(self.copy))] + [
            Wire(self.row, gate.wire_list_item(i, self.copy)) for i in range(gate.vec_size())]

    def outputs(self):
        gate = self._gate()
        return [Wire(self.row, gate.wire_claimed_element(self.copy))] + [
            Wire(self.row, gate.wire_bit(i, self.copy)) for i in range(gate.bits)]

    def run_once(self, witness, out):
        gate = self._gate()
        row, copy = self.row, self.copy
        access_index = witness.get_target(Wire(row, gate.wire_access_index(copy)))
        if access_index >= gate.vec_size():
            raise ValueError(f"Access index {access_index} is larger than the vector size "
                             f"{gate.vec_size()}")
        out.set_target(Wire(row, gate.wire_claimed_element(copy)),
                       witness.get_target(Wire(row, gate.wire_list_item(access_index, copy))))
        out.set_wires(row, [gate.wire_bit(i, copy) for i in range(gate.bits)],
                      [(access_index >> i) & 1 for i in range(gate.bits)])

    @classmethod
    def run_batch(cls, gens, witness):
        by_shape: dict[tuple, list] = {}
        for g_ in gens:
            by_shape.setdefault((g_.bits, g_.num_copies, g_.num_extra_constants), []).append(g_)
        for shape, gs in by_shape.items():
            gate = RandomAccessGate(*shape)
            n = len(gs)
            rows_ = np.fromiter((g_.row for g_ in gs), np.int64, n)
            idx_cols = np.fromiter((gate.wire_access_index(g_.copy) for g_ in gs), np.int64, n)
            aidx = witness.get_reps(witness.wire_reps(rows_, idx_cols)).astype(np.int64)
            if (aidx >= gate.vec_size()).any():
                raise ValueError(f"Access index larger than the vector size {gate.vec_size()}")
            item_cols = np.fromiter((gate.wire_list_item(int(a), g_.copy)
                                     for a, g_ in zip(aidx, gs)), np.int64, n)
            out_cols = np.empty((n, 1 + gate.bits), np.int64)
            out_vals = np.empty((n, 1 + gate.bits), np.uint64)
            out_cols[:, 0] = np.fromiter((gate.wire_claimed_element(g_.copy) for g_ in gs),
                                         np.int64, n)
            out_vals[:, 0] = witness.get_reps(witness.wire_reps(rows_, item_cols))
            for i in range(gate.bits):
                out_cols[:, 1 + i] = np.fromiter((gate.wire_bit(i, g_.copy) for g_ in gs),
                                                 np.int64, n)
                out_vals[:, 1 + i] = (aidx >> i) & 1
            reps = witness.wire_reps(rows_[:, None], out_cols)
            witness.set_reps(reps.reshape(-1), out_vals.reshape(-1))
