"""Targets: locations in the witness (reference iop/target.rs; the same
classes as the reference package's `iop/target.py`).

A `Target` is either a concrete wire (row, column) or a virtual target with
no fixed location, routed by copy constraints. Columns below
`num_routed_wires` are routable.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True, slots=True)
class Wire:
    row: int
    column: int


@dataclass(frozen=True, slots=True)
class VirtualTarget:
    index: int


Target = Wire | VirtualTarget


def is_routable(t: Target, config) -> bool:
    if isinstance(t, Wire):
        return t.column < config.num_routed_wires
    return True


def target_index(t: Target, num_wires: int, degree: int) -> int:
    """Flat index: the wire grid first (row * num_wires + column, reference
    target.rs:55-60), then the virtual targets."""
    if isinstance(t, Wire):
        return t.row * num_wires + t.column
    return degree * num_wires + t.index


@dataclass(frozen=True, slots=True)
class BoolTarget:
    target: Target


@dataclass(frozen=True, slots=True)
class ExtensionTarget:
    """A D = 2 extension target: a pair of base targets."""

    parts: tuple

    def __getitem__(self, i):
        return self.parts[i]

    def __len__(self):
        return len(self.parts)
