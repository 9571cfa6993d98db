"""LookupGate and LookupTableGate (reference gates/lookup.rs,
gates/lookup_table.rs; the reference package's gates/lookup.py).

Neither gate has constraints of its own: the lookup argument lives in the
RE and partial-SLDC columns of the Zs-partial-products oracle
(`plonk/prover.py`) and in their checks in the vanishing polynomial
(`plonk/vanishing_poly.py`). A LUT is a list of (u16 input, u16 output)
pairs; its keccak-256 hash is part of each gate's id and serialized bytes.

LookupGate: slot i holds a looking input at wire 2i and its output at
2i + 1. LookupTableGate: slot i holds a LUT entry's input at wire 3i, its
output at 3i + 1 and its multiplicity at 3i + 2; the LUT's rows run upside
down from the region's first row, so the RE and SLDC transitions read only
the next row.
"""

from __future__ import annotations

from plonky2_torch.gates.gate import Gate
from plonky2_torch.hash.keccak import keccak256
from plonky2_torch.iop.generator import SimpleGenerator
from plonky2_torch.iop.target import Wire


def lut_hash(lut) -> bytes:
    """keccak-256 of the LUT's pairs, each input and output as u16 LE."""
    return keccak256(b"".join(int(i).to_bytes(2, "little") + int(o).to_bytes(2, "little")
                              for i, o in lut))


class LookupGate(Gate):
    """Holds (input, output) pairs looked up elsewhere in the trace."""

    def __init__(self, num_slots: int, lut):
        self.num_slots = num_slots
        self.lut = lut
        self.lut_hash = lut_hash(lut)

    @staticmethod
    def new_from_table(config, lut) -> "LookupGate":
        return LookupGate(LookupGate.num_slots_from_config(config), lut)

    @staticmethod
    def num_slots_from_config(config) -> int:
        return config.num_routed_wires // 2

    @property
    def num_ops(self) -> int:
        return self.num_slots

    @staticmethod
    def wire_ith_looking_inp(i: int) -> int:
        return 2 * i

    @staticmethod
    def wire_ith_looking_out(i: int) -> int:
        return 2 * i + 1

    def id(self) -> str:
        return f"LookupGate {{num_slots: {self.num_slots}, lut_hash: {self.lut_hash.hex()}}}"

    def eval_unfiltered(self, ops, vars) -> list:
        return []

    def generators(self, row: int, local_constants) -> list:
        return [LookupGenerator(row, self.lut, i) for i in range(self.num_slots)]

    def num_wires(self) -> int:
        return 2 * self.num_slots

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return 0

    def num_constraints(self) -> int:
        return 0


class LookupGenerator(SimpleGenerator):
    """A slot's output from its input (reference gates/lookup.rs:178)."""

    def __init__(self, row: int, lut, slot_nb: int):
        self.row = row
        self.lut = lut
        self.slot_nb = slot_nb

    def dependencies(self):
        return [Wire(self.row, LookupGate.wire_ith_looking_inp(self.slot_nb))]

    def outputs(self):
        return [Wire(self.row, LookupGate.wire_ith_looking_out(self.slot_nb))]

    def run_once(self, witness, out_buffer):
        inp = witness.get_target(self.dependencies()[0])
        out_wire = self.outputs()[0]
        if inp < len(self.lut) and self.lut[inp][0] == inp:  # an identity-keyed table
            out_buffer.set_target(out_wire, self.lut[inp][1])
            return
        for i, o in self.lut:
            if i == inp:
                out_buffer.set_target(out_wire, o)
                return
        raise ValueError("Incorrect input value provided")


class LookupTableGate(Gate):
    """Holds the LUT's pairs and their multiplicities; `last_lut_row` is
    the first row the LUT's gates were added at (the region's lowest)."""

    def __init__(self, num_slots: int, lut, last_lut_row: int):
        self.num_slots = num_slots
        self.lut = lut
        self.lut_hash = lut_hash(lut)
        self.last_lut_row = last_lut_row

    @staticmethod
    def new_from_table(config, lut, last_lut_row: int) -> "LookupTableGate":
        return LookupTableGate(LookupTableGate.num_slots_from_config(config), lut, last_lut_row)

    @staticmethod
    def num_slots_from_config(config) -> int:
        return config.num_routed_wires // 3

    @staticmethod
    def wire_ith_looked_inp(i: int) -> int:
        return 3 * i

    @staticmethod
    def wire_ith_looked_out(i: int) -> int:
        return 3 * i + 1

    @staticmethod
    def wire_ith_multiplicity(i: int) -> int:
        return 3 * i + 2

    def id(self) -> str:
        return (f"LookupTableGate {{num_slots: {self.num_slots}, lut_hash: "
                f"{self.lut_hash.hex()}, last_lut_row: {self.last_lut_row}}}")

    def eval_unfiltered(self, ops, vars) -> list:
        return []

    def generators(self, row: int, local_constants) -> list:
        return [LookupTableGenerator(row, self.lut, i, self.num_slots, self.last_lut_row)
                for i in range(self.num_slots)]

    def num_wires(self) -> int:
        return 3 * self.num_slots

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return 0

    def num_constraints(self) -> int:
        return 0


class LookupTableGenerator(SimpleGenerator):
    """A slot's LUT entry, the LUT's first entry where the slot is past
    the LUT's end (reference gates/lookup_table.rs:190). Multiplicities are
    written by the prover (`plonk/prover.py` `set_lookup_wires`)."""

    def __init__(self, row: int, lut, slot_nb: int, num_slots: int, last_lut_row: int):
        self.row = row
        self.lut = lut
        self.slot_nb = slot_nb
        self.num_slots = num_slots
        self.last_lut_row = last_lut_row

    def dependencies(self):
        return []

    def outputs(self):
        return [Wire(self.row, LookupTableGate.wire_ith_looked_inp(self.slot_nb)),
                Wire(self.row, LookupTableGate.wire_ith_looked_out(self.slot_nb))]

    def entry(self) -> tuple[int, int]:
        """The (input, output) pair this slot holds."""
        if not self.lut:
            raise ValueError("Empty LUTs are not supported.")
        first_row = self.last_lut_row + -(-len(self.lut) // self.num_slots) - 1
        slot = (first_row - self.row) * self.num_slots + self.slot_nb
        return self.lut[slot] if slot < len(self.lut) else self.lut[0]

    def run_once(self, witness, out_buffer):
        for t, v in zip(self.outputs(), self.entry()):
            out_buffer.set_target(t, v)
