"""The bit-split generator (reference gadgets/split_join.rs; the reference
package's gadgets/split_join.py:11)."""

from __future__ import annotations

from plonky2_torch.gates.base_sum import WIRE_SUM
from plonky2_torch.iop.generator import SimpleGenerator
from plonky2_torch.iop.target import Target, Wire


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
