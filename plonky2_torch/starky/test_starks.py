"""The reference test suite's toy STARKs (reference
starky/src/permutation_stark.rs, unconstrained_stark.rs and the logUp
tests). The file keeps the reference package's name; it lives in the
package, so pytest does not collect it."""

from __future__ import annotations

import numpy as np

from plonky2_torch.field import scalar as fs
from plonky2_torch.starky.stark import Stark


class PermutationStark(Stark):
    """State [x, y]; transition swaps the two values every row, so the last
    row is [x0, y0] or [y0, x0] depending on parity."""

    COLUMNS = 2
    PUBLIC_INPUTS = 2

    def __init__(self, num_rows: int):
        self.num_rows = num_rows

    def generate_trace(self, x0: int, y0: int) -> np.ndarray:
        even = np.arange(self.num_rows) % 2 == 0
        x, y = np.uint64(x0), np.uint64(y0)
        return np.stack([np.where(even, x, y), np.where(even, y, x)])

    def eval(self, ops, frame, consumer) -> None:
        local = frame.get_local_values()
        nxt = frame.get_next_values()
        pis = frame.get_public_inputs()
        consumer.constraint_first_row(ops.sub(local[0], pis[0]))
        consumer.constraint_first_row(ops.sub(local[1], pis[1]))
        consumer.constraint_transition(ops.sub(nxt[0], local[1]))
        consumer.constraint_transition(ops.sub(nxt[1], local[0]))

    def constraint_degree(self) -> int:
        return 2


class UnconstrainedStark(Stark):
    """A STARK with no constraints at all (shape and plumbing tests)."""

    COLUMNS = 2
    PUBLIC_INPUTS = 0

    def __init__(self, num_rows: int):
        self.num_rows = num_rows

    def generate_trace(self) -> np.ndarray:
        rng = np.random.default_rng(0)
        return rng.integers(0, fs.P, size=(2, self.num_rows), dtype=np.uint64)

    def eval(self, ops, frame, consumer) -> None:
        pass

    def constraint_degree(self) -> int:
        return 2


class LookupTestStark(Stark):
    """A looked column, a table column and a frequencies column tied
    together by the logUp argument alone."""

    COLUMNS = 3  # [val, table, freq]
    PUBLIC_INPUTS = 0

    def __init__(self, num_rows: int):
        self.num_rows = num_rows

    def generate_trace(self) -> np.ndarray:
        n = self.num_rows
        rng = np.random.default_rng(0)
        table = np.arange(n, dtype=np.uint64)
        vals = rng.integers(0, n, size=n)
        freq = np.bincount(vals, minlength=n).astype(np.uint64)
        return np.stack([vals.astype(np.uint64), table, freq])

    def eval(self, ops, frame, consumer) -> None:
        pass  # the lookup argument carries the whole statement

    def constraint_degree(self) -> int:
        return 3

    def lookups(self) -> list:
        from plonky2_torch.starky.lookup import Column, Filter, Lookup

        return [Lookup(
            columns=[Column.single(0)],
            table_column=Column.single(1),
            frequencies_column=Column.single(2),
            filter_columns=[Filter.default()],
        )]
