"""Witness containers (reference iop/witness.rs).

`PartialWitness`: the caller's input map. `PartitionWitness`: one value slot
per copy-constraint class (its disjoint-set representative), sized by the
circuit. `full_witness` makes the [num_wires, degree] matrix the prover
commits.
"""

from __future__ import annotations

import numpy as np

from plonky2_torch.iop.target import Target, target_index


class PartialWitness:
    def __init__(self):
        self.target_values: dict[Target, int] = {}

    def set_target(self, target: Target, value: int) -> None:
        old = self.target_values.get(target)
        if old is not None and old != value:
            raise ValueError(f"Target {target} set twice with different values: {old} != {value}")
        self.target_values[target] = value

    def set_targets(self, targets, values) -> None:
        for t, v in zip(targets, values):
            self.set_target(t, v)

    def set_extension_target(self, ext_target, value: tuple) -> None:
        for t, v in zip(ext_target.parts, value):
            self.set_target(t, v)

    def set_hash_target(self, hash_target, value4) -> None:
        for t, v in zip(hash_target, value4):
            self.set_target(t, v)

    def set_bool_target(self, bool_target, value: bool) -> None:
        self.set_target(bool_target.target, 1 if value else 0)


class PartitionWitness:
    """One value slot per representative (reference iop/witness.rs:333),
    held as numpy arrays (u64 values and a known mask) so that the batch
    engines gather and scatter whole generator batches."""

    def __init__(self, representative_map, num_wires: int, degree: int):
        self.rep_map = np.asarray(representative_map, dtype=np.int64)  # flat index -> rep
        self.num_wires = num_wires
        self.degree = degree
        n = int(self.rep_map.max()) + 1 if self.rep_map.size else 0
        self.values = np.zeros(n, dtype=np.uint64)
        self.known = np.zeros(n, dtype=bool)

    def rep_index(self, target: Target) -> int:
        return int(self.rep_map[target_index(target, self.num_wires, self.degree)])

    def wire_reps(self, rows, column) -> np.ndarray:
        """rep_index of Wire(row, column) for arrays of rows and columns
        (broadcast)."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(column, dtype=np.int64)
        return self.rep_map[rows * self.num_wires + cols]

    def get_target(self, target: Target) -> int:
        rep = self.rep_index(target)
        if not self.known[rep]:
            raise ValueError(f"Target {target} not set")
        return int(self.values[rep])

    def get_targets(self, targets) -> list[int]:
        return [self.get_target(t) for t in targets]

    def get_extension_target(self, ext_target) -> tuple:
        return tuple(self.get_target(t) for t in ext_target.parts)

    def contains(self, target: Target) -> bool:
        return bool(self.known[self.rep_index(target)])

    def contains_all(self, targets) -> bool:
        return all(self.contains(t) for t in targets)

    def set_target(self, target: Target, value: int):
        """The representative's index if newly set, else None. Raises on a
        second set with another value."""
        rep = self.rep_index(target)
        if self.known[rep]:
            if int(self.values[rep]) != value:
                raise ValueError(
                    f"Partition containing {target} was set twice with different values: "
                    f"{int(self.values[rep])} != {value}")
            return None
        self.values[rep] = value
        self.known[rep] = True
        return rep

    # -- the batch engines' vector interface --------------------------------

    def get_reps(self, reps: np.ndarray) -> np.ndarray:
        """Values at representative indices (all must be known)."""
        if not self.known[reps].all():
            raise ValueError("batch read of unset representative")
        return self.values[reps]

    def set_reps(self, reps: np.ndarray, vals: np.ndarray) -> None:
        """Vector write; an already known representative, or one written
        twice in the batch, must get the same value."""
        prev_known = self.known[reps]
        if prev_known.any():
            bad = prev_known & (self.values[reps] != vals)
            if bad.any():
                raise ValueError("Partition was batch-set twice with different values "
                                 f"(first rep {int(reps[bad][0])})")
        order = np.argsort(reps, kind="stable")
        rs, vs = reps[order], vals[order]
        dup = rs[1:] == rs[:-1]
        if dup.any() and (vs[1:][dup] != vs[:-1][dup]).any():
            raise ValueError("conflicting duplicate writes within one batch")
        self.values[reps] = vals
        self.known[reps] = True

    def full_witness(self) -> np.ndarray:
        """[num_wires, degree] u64; unset wires are 0 (reference
        iop/witness.rs:376 `MatrixWitness`)."""
        vals = np.where(self.known, self.values, np.uint64(0))
        rep = self.rep_map[:self.degree * self.num_wires]
        return vals[rep].reshape(self.degree, self.num_wires).T.copy()


def read_partial_witness(path) -> PartialWitness:
    """A PartialWitness from an .npz of parallel arrays: `is_wire` (bool),
    `a` (a wire's row or a virtual target's index), `b` (a wire's column,
    else 0) and `value` (u64), in the inputs' order
    (`tests/torch_make_data.py` writes them for the committed circuits)."""
    from plonky2_torch.iop.target import VirtualTarget, Wire

    f = np.load(path)
    pw = PartialWitness()
    for is_wire, a, b, v in zip(f["is_wire"], f["a"], f["b"], f["value"]):
        pw.set_target(Wire(int(a), int(b)) if is_wire else VirtualTarget(int(a)), int(v))
    return pw
