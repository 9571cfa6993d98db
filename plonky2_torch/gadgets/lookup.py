"""Lookups on the circuit builder (reference gadgets/lookup.rs; the
reference package's gadgets/lookup.py): LUTs added from pairs, from two
lists or from a function, lookups into them, and the placement of the
lookup and table gates at build time (`add_all_lookups`). TIP5_TABLE and
SMALLER_TABLE are the reference's sample LUTs.
"""

from __future__ import annotations

from plonky2_torch.gates.lookup import LookupGate, LookupTableGate
from plonky2_torch.gates.simple_gates import NoopGate
from plonky2_torch.iop.target import Target, Wire

# the Tip5 S-box (reference gadgets/lookup.rs:15)
TIP5_TABLE = [
    0, 7, 26, 63, 124, 215, 85, 254, 214, 228, 45, 185, 140, 173, 33, 240, 29, 177,
    176, 32, 8, 110, 87, 202, 204, 99, 150, 106, 230, 14, 235, 128, 213, 239, 212,
    138, 23, 130, 208, 6, 44, 71, 93, 116, 146, 189, 251, 81, 199, 97, 38, 28, 73,
    179, 95, 84, 152, 48, 35, 119, 49, 88, 242, 3, 148, 169, 72, 120, 62, 161, 166,
    83, 175, 191, 137, 19, 100, 129, 112, 55, 221, 102, 218, 61, 151, 237, 68, 164,
    17, 147, 46, 234, 203, 216, 22, 141, 65, 57, 123, 12, 244, 54, 219, 231, 96, 77,
    180, 154, 5, 253, 133, 165, 98, 195, 205, 134, 245, 30, 9, 188, 59, 142, 186,
    197, 181, 144, 92, 31, 224, 163, 111, 74, 58, 69, 113, 196, 67, 246, 225, 10,
    121, 50, 60, 157, 90, 122, 2, 250, 101, 75, 178, 159, 24, 36, 201, 11, 243, 132,
    198, 190, 114, 233, 39, 52, 21, 209, 108, 238, 91, 187, 18, 104, 194, 37, 153,
    34, 200, 143, 126, 155, 236, 118, 64, 80, 172, 89, 94, 193, 135, 183, 86, 107,
    252, 13, 167, 206, 136, 220, 207, 103, 171, 160, 76, 182, 227, 217, 158, 56,
    174, 4, 66, 109, 139, 162, 184, 211, 249, 47, 125, 232, 117, 43, 16, 42, 127,
    20, 241, 25, 149, 105, 156, 51, 53, 168, 145, 247, 223, 79, 78, 226, 15, 222,
    82, 115, 70, 210, 27, 41, 1, 170, 40, 131, 192, 229, 248, 255,
]

SMALLER_TABLE = [2, 24, 56, 100, 128, 16, 20, 49]


class LookupWire:
    """A LUT's region of rows: its last LookupGate row, its last (lowest)
    LookupTableGate row and its first (highest) one."""

    __slots__ = ("last_lu_gate", "last_lut_gate", "first_lut_gate")

    def __init__(self, last_lu_gate: int, last_lut_gate: int, first_lut_gate: int):
        self.last_lu_gate = last_lu_gate
        self.last_lut_gate = last_lut_gate
        self.first_lut_gate = first_lut_gate

    def __eq__(self, other):
        return isinstance(other, LookupWire) and all(
            getattr(self, k) == getattr(other, k) for k in self.__slots__)


class LookupMixin:
    """Mixed into CircuitBuilder (its state: `luts`, `lookup_rows`,
    `lut_to_lookups`)."""

    def add_lookup_table_from_pairs(self, table) -> int:
        """The LUT's index; a LUT equal to one added before gets that one's."""
        table = [(int(i), int(o)) for i, o in table]
        for i, o in table:
            if not (0 <= i < 1 << 16 and 0 <= o < 1 << 16):
                raise ValueError("LUT entries must be u16")
        for idx, existing in enumerate(self.luts):
            if existing == table:
                return idx
        self.luts.append(table)
        self.lut_to_lookups.append([])
        return len(self.luts) - 1

    def add_lookup_table_from_table(self, inps, outs) -> int:
        return self.add_lookup_table_from_pairs(list(zip(inps, outs)))

    def add_lookup_table_from_fn(self, f, inputs) -> int:
        return self.add_lookup_table_from_pairs([(i, f(i)) for i in inputs])

    def add_lookup_from_index(self, looking_in: Target, lut_index: int) -> Target:
        """A new target holding the output of LUT `lut_index` at
        `looking_in`."""
        if lut_index >= len(self.luts):
            raise ValueError(f"lut number {lut_index} not in luts (length = {len(self.luts)})")
        looking_out = self.add_virtual_target()
        self.lut_to_lookups[lut_index].append((looking_in, looking_out))
        return looking_out

    def add_all_lookups(self) -> None:
        """Each LUT's LookupGate rows, its LookupTableGate rows (upside down)
        and one noop row, so the region's last transition reads a zero row
        (reference gadgets/lookup.rs:80-155)."""
        for lut_index, lut in enumerate(self.luts):
            lookups = self.lut_to_lookups[lut_index]
            if not lookups:
                raise ValueError(f"LUT number {lut_index} is unused")
            last_lu_gate = self.num_gates()
            gate = LookupGate.new_from_table(self.config, lut)
            num_slots = gate.num_slots
            full = len(lookups) // num_slots
            for c in range(full):
                row = self.add_gate(gate, [])
                for i, (looking_in, looking_out) in enumerate(
                        lookups[c * num_slots:(c + 1) * num_slots]):
                    self.connect(Wire(row, LookupGate.wire_ith_looking_inp(i)), looking_in)
                    self.connect(Wire(row, LookupGate.wire_ith_looking_out(i)), looking_out)
            for looking_in, looking_out in lookups[full * num_slots:]:
                row, i = self.find_slot(gate, [lut_index], [])
                self.connect(Wire(row, LookupGate.wire_ith_looking_inp(i)), looking_in)
                self.connect(Wire(row, LookupGate.wire_ith_looking_out(i)), looking_out)

            last_lut_gate = self.num_gates()
            num_lut_entries = LookupTableGate.num_slots_from_config(self.config)
            table_gate = LookupTableGate.new_from_table(self.config, lut, last_lut_gate)
            for _ in range((len(lut) - 1) // num_lut_entries + 1):
                self.add_gate(table_gate, [])
            first_lut_gate = self.num_gates() - 1
            self.add_gate(NoopGate(), [])
            self.lookup_rows.append(LookupWire(last_lu_gate, last_lut_gate, first_lut_gate))
