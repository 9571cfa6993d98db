"""PoseidonMdsGate: one Poseidon MDS layer over a state of extension-algebra
elements (reference gates/poseidon_mds.rs; the reference package's
gates/poseidon_mds.py).

Wires: the 12 inputs, then the 12 outputs, each D = 2 wires. The layer acts
on each extension component alone, so the device form runs both through one
[12, 12] modular matrix product."""

from __future__ import annotations

import functools

import numpy as np
import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import scalar as fs
from plonky2_torch.gates.gate import Gate
from plonky2_torch.gates.ops import ealg_add, ealg_sub, ealg_zero
from plonky2_torch.hash.poseidon_constants import MDS_MATRIX_CIRC, MDS_MATRIX_DIAG, SPONGE_WIDTH
from plonky2_torch.iop.generator import SimpleGenerator
from plonky2_torch.iop.target import ExtensionTarget, Wire

D = 2
W = SPONGE_WIDTH


@functools.lru_cache(maxsize=None)
def _mds_np() -> np.ndarray:
    """The layer as a dense [W, W] matrix: row r is the circulant row
    shifted by r plus the diagonal entry."""
    m = np.empty((W, W), dtype=np.uint64)
    for r in range(W):
        for j in range(W):
            m[r, j] = (MDS_MATRIX_CIRC[(j - r) % W] + (MDS_MATRIX_DIAG[r] if j == r else 0)) % fs.P
    return m


class PoseidonMdsGate(Gate):
    @staticmethod
    def wires_input(i: int) -> range:
        return range(i * D, (i + 1) * D)

    @staticmethod
    def wires_output(i: int) -> range:
        return range((W + i) * D, (W + i + 1) * D)

    def id(self) -> str:
        return ("PoseidonMdsGate(PhantomData<plonky2_field::goldilocks_field::GoldilocksField>)"
                f"<WIDTH={W}>")

    @staticmethod
    def _mds_row_shf_algebra(ops, r, v):
        res = ealg_zero(ops, D)
        for i in range(W):
            term = tuple(ops.mul_const(MDS_MATRIX_CIRC[i], x) for x in v[(i + r) % W])
            res = ealg_add(ops, res, term)
        term = tuple(ops.mul_const(MDS_MATRIX_DIAG[r], x) for x in v[r])
        return ealg_add(ops, res, term)

    def eval_unfiltered(self, ops, vars) -> list:
        inputs = [vars.get_local_ext_algebra(self.wires_input(i)) for i in range(W)]
        constraints = []
        for r in range(W):
            computed = self._mds_row_shf_algebra(ops, r, inputs)
            out = vars.get_local_ext_algebra(self.wires_output(r))
            constraints.extend(ealg_sub(ops, computed, out))
        return constraints

    def eval_unfiltered_device(self, wires, constants, public_inputs_hash):
        q = wires.shape[-1]
        m = g.constant(_mds_np(), wires.device)
        comp = wires[:W * D].reshape(W, D, q)
        outs = wires[W * D:2 * W * D].reshape(W, D, q)
        computed = torch.stack([g.matmul_mod(m, comp[:, k]) for k in range(D)], dim=1)
        return g.sub(computed, outs).reshape(W * D, q)

    def generators(self, row: int, local_constants: list[int]) -> list:
        return [PoseidonMdsGenerator(row)]

    def num_wires(self) -> int:
        return 2 * D * W

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return 1

    def num_constraints(self) -> int:
        return W * D


class PoseidonMdsGenerator(SimpleGenerator):
    """The outputs of one PoseidonMdsGate row (reference
    gates/poseidon_mds.rs:201)."""

    def __init__(self, row: int):
        self.row = row

    def dependencies(self):
        return [Wire(self.row, w) for i in range(W) for w in PoseidonMdsGate.wires_input(i)]

    def outputs(self):
        return [Wire(self.row, w) for r in range(W) for w in PoseidonMdsGate.wires_output(r)]

    def run_once(self, witness, out):
        row = self.row
        inputs = [tuple(witness.get_target(Wire(row, w)) for w in PoseidonMdsGate.wires_input(i))
                  for i in range(W)]
        for r in range(W):
            acc = fs.ext_zero(D)
            for i in range(W):
                acc = fs.ext_add(acc, fs.ext_scalar_mul(MDS_MATRIX_CIRC[i], inputs[(i + r) % W]))
            acc = fs.ext_add(acc, fs.ext_scalar_mul(MDS_MATRIX_DIAG[r], inputs[r]))
            out.set_extension_target(
                ExtensionTarget(tuple(Wire(row, w) for w in PoseidonMdsGate.wires_output(r))),
                acc)
