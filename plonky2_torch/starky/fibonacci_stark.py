"""The Fibonacci STARK (reference starky/src/fibonacci_stark.rs), the
driver's Starky configuration."""

from __future__ import annotations

import numpy as np

from plonky2_torch.field import scalar as fs
from plonky2_torch.starky.stark import Stark


class FibonacciStark(Stark):
    """State [x0, x1]; transition x0' <- x1, x1' <- x0 + x1."""

    COLUMNS = 2
    PUBLIC_INPUTS = 3
    PI_INDEX_X0 = 0
    PI_INDEX_X1 = 1
    PI_INDEX_RES = 2

    def __init__(self, num_rows: int):
        self.num_rows = num_rows

    def generate_trace(self, x0: int, x1: int) -> np.ndarray:
        """[COLUMNS, num_rows] u64 trace: row i is (s_i, s_{i+1}) of the
        sequence s_0 = x0, s_1 = x1, s_{k+2} = s_k + s_{k+1}."""
        seq = [x0, x1]
        for _ in range(self.num_rows - 1):
            seq.append(fs.add(seq[-2], seq[-1]))
        seq = np.asarray(seq, dtype=np.uint64)
        return np.stack([seq[:-1], seq[1:]])

    def eval(self, ops, frame, consumer) -> None:
        local = frame.get_local_values()
        nxt = frame.get_next_values()
        pis = frame.get_public_inputs()

        consumer.constraint_first_row(ops.sub(local[0], pis[self.PI_INDEX_X0]))
        consumer.constraint_first_row(ops.sub(local[1], pis[self.PI_INDEX_X1]))
        consumer.constraint_last_row(ops.sub(local[1], pis[self.PI_INDEX_RES]))
        # x0' <- x1
        consumer.constraint_transition(ops.sub(nxt[0], local[1]))
        # x1' <- x0 + x1
        consumer.constraint_transition(ops.sub(nxt[1], ops.add(local[0], local[1])))

    def constraint_degree(self) -> int:
        return 2


def fibonacci(n: int, x0: int, x1: int) -> int:
    a, b = x0, x1
    for _ in range(n):
        a, b = b, fs.add(a, b)
    return b
