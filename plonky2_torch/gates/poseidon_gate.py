"""PoseidonGate: one 30-round Poseidon permutation a row over 135 wires,
with the Merkle-path swap (reference gates/poseidon.rs).

The constraints follow the fast partial-round decomposition (the sparse
w-hat / v MDS of `hash/poseidon_fast_partial.py`); the wire layout and the
constraint order are part of the protocol. The generic form runs the
layers on the ops protocol; the device form runs each layer on [12, Q]
states, the MDS layers as modular matrix products."""

from __future__ import annotations

import functools

import numpy as np
import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import np_field as npf
from plonky2_torch.field import scalar as fs
from plonky2_torch.gates.gate import Gate
from plonky2_torch.iop.generator import SimpleGenerator
from plonky2_torch.iop.target import Wire
from plonky2_torch.hash.poseidon_constants import (
    ALL_ROUND_CONSTANTS,
    HALF_N_FULL_ROUNDS,
    MDS_MATRIX_CIRC,
    MDS_MATRIX_DIAG,
    N_PARTIAL_ROUNDS,
    SPONGE_WIDTH,
)
from plonky2_torch.hash.poseidon_fast_partial import (
    FAST_PARTIAL_FIRST_ROUND_CONSTANT,
    FAST_PARTIAL_ROUND_CONSTANTS,
    FAST_PARTIAL_ROUND_INITIAL_MATRIX,
    FAST_PARTIAL_ROUND_VS,
    FAST_PARTIAL_ROUND_W_HATS,
)

W = SPONGE_WIDTH
WIRE_SWAP = 2 * W
START_DELTA = 2 * W + 1
START_FULL_0 = START_DELTA + 4
START_PARTIAL = START_FULL_0 + W * (HALF_N_FULL_ROUNDS - 1)
START_FULL_1 = START_PARTIAL + N_PARTIAL_ROUNDS
END = START_FULL_1 + W * HALF_N_FULL_ROUNDS
MDS0TO0 = MDS_MATRIX_CIRC[0] + MDS_MATRIX_DIAG[0]


@functools.lru_cache(maxsize=None)
def _tables_np() -> dict:
    """The device form's constant tables as numpy u64."""
    mds = np.array([[(MDS_MATRIX_CIRC[(c - r) % W] + (MDS_MATRIX_DIAG[r] if r == c else 0))
                     for c in range(W)] for r in range(W)], dtype=np.uint64)
    p_init = np.zeros((W, W), dtype=np.uint64)
    p_init[0, 0] = 1
    for c in range(1, W):
        for r in range(1, W):
            p_init[c, r] = FAST_PARTIAL_ROUND_INITIAL_MATRIX[r - 1][c - 1] % fs.P
    w_hat = np.array([[MDS0TO0] + [x % fs.P for x in FAST_PARTIAL_ROUND_W_HATS[r]]
                      for r in range(N_PARTIAL_ROUNDS)], dtype=np.uint64)
    vs = np.array([[x % fs.P for x in FAST_PARTIAL_ROUND_VS[r]]
                   for r in range(N_PARTIAL_ROUNDS)], dtype=np.uint64)
    partial_rcs = np.array(FAST_PARTIAL_ROUND_CONSTANTS[:N_PARTIAL_ROUNDS], dtype=np.uint64)
    partial_rcs[N_PARTIAL_ROUNDS - 1] = 0  # the last partial round adds no constant
    return {
        "round_constants": np.array(ALL_ROUND_CONSTANTS, dtype=np.uint64).reshape(-1, W),
        "mds": mds,
        "partial_init": p_init,
        "w_hat": w_hat,
        "vs": vs,
        "partial_rcs": partial_rcs,
        "partial_first": np.array(FAST_PARTIAL_FIRST_ROUND_CONSTANT, dtype=np.uint64),
    }


@functools.lru_cache(maxsize=None)
def _tables(device: str) -> dict:
    return {k: g.tensor(v, device) for k, v in _tables_np().items()}


# -- the layers on the ops protocol (fast partial-round form) ------------------

def _sbox(ops, x):
    x3 = ops.mul(ops.square(x), x)
    return ops.mul(ops.square(x3), x)


def _mds_layer(ops, state):
    out = []
    for r in range(W):
        acc = ops.zero()
        for i in range(W):
            acc = ops.add(acc, ops.mul_const(MDS_MATRIX_CIRC[i], state[(i + r) % W]))
        out.append(ops.add(acc, ops.mul_const(MDS_MATRIX_DIAG[r], state[r])))
    return out


def _mds_partial_layer_init(ops, state):
    result = [state[0]] + [ops.zero()] * (W - 1)
    for r in range(1, W):
        for c in range(1, W):
            t = FAST_PARTIAL_ROUND_INITIAL_MATRIX[r - 1][c - 1]
            result[c] = ops.add(result[c], ops.mul_const(t, state[r]))
    return result


def _mds_partial_layer_fast(ops, state, r):
    d = ops.mul_const(MDS0TO0, state[0])
    for i in range(1, W):
        d = ops.add(d, ops.mul_const(FAST_PARTIAL_ROUND_W_HATS[r][i - 1], state[i]))
    return [d] + [ops.add(ops.mul_const(FAST_PARTIAL_ROUND_VS[r][i - 1], state[0]), state[i])
                  for i in range(1, W)]


class PoseidonGate(Gate):
    WIRE_SWAP = WIRE_SWAP

    @staticmethod
    def wire_input(i: int) -> int:
        return i

    @staticmethod
    def wire_output(i: int) -> int:
        return W + i

    def id(self) -> str:
        return ("PoseidonGate(PhantomData<plonky2_field::goldilocks_field::GoldilocksField>)"
                f"<WIDTH={W}>")

    def eval_unfiltered(self, ops, vars) -> list:
        w = vars.local_wires
        swap = w[WIRE_SWAP]
        constraints = [ops.mul(swap, ops.add_const(swap, -1))]
        for i in range(4):
            constraints.append(ops.sub(ops.mul(swap, ops.sub(w[i + 4], w[i])),
                                       w[START_DELTA + i]))
        state = list(w[:W])
        for i in range(4):  # the swapped inputs, in the reference's op order
            state[i] = ops.add(w[i], w[START_DELTA + i])
            state[i + 4] = ops.sub(w[i + 4], w[START_DELTA + i])
        round_ctr = 0
        for r in range(HALF_N_FULL_ROUNDS):
            state = [ops.add_const(x, ALL_ROUND_CONSTANTS[i + W * round_ctr])
                     for i, x in enumerate(state)]
            if r != 0:
                sbox_in = [w[START_FULL_0 + W * (r - 1) + i] for i in range(W)]
                constraints += [ops.sub(x, s) for x, s in zip(state, sbox_in)]
                state = sbox_in
            state = _mds_layer(ops, [_sbox(ops, x) for x in state])
            round_ctr += 1
        state = [ops.add_const(x, FAST_PARTIAL_FIRST_ROUND_CONSTANT[i])
                 for i, x in enumerate(state)]
        state = _mds_partial_layer_init(ops, state)
        for r in range(N_PARTIAL_ROUNDS):
            sbox_in = w[START_PARTIAL + r]
            constraints.append(ops.sub(state[0], sbox_in))
            s0 = _sbox(ops, sbox_in)
            if r < N_PARTIAL_ROUNDS - 1:
                s0 = ops.add_const(s0, FAST_PARTIAL_ROUND_CONSTANTS[r])
            state = _mds_partial_layer_fast(ops, [s0] + state[1:], r)
        round_ctr += N_PARTIAL_ROUNDS
        for r in range(HALF_N_FULL_ROUNDS):
            state = [ops.add_const(x, ALL_ROUND_CONSTANTS[i + W * round_ctr])
                     for i, x in enumerate(state)]
            sbox_in = [w[START_FULL_1 + W * r + i] for i in range(W)]
            constraints += [ops.sub(x, s) for x, s in zip(state, sbox_in)]
            state = _mds_layer(ops, [_sbox(ops, x) for x in sbox_in])
            round_ctr += 1
        constraints += [ops.sub(state[i], w[W + i]) for i in range(W)]
        return constraints

    def eval_unfiltered_device(self, wires, constants, public_inputs_hash):
        t = _tables(str(wires.device))

        def sbox(x):
            x3 = g.mul(g.square(x), x)
            return g.mul(g.square(x3), x)

        swap = wires[WIRE_SWAP]
        one = g.scalar_tensor(1, wires.device)
        inputs = wires[:W]
        deltas = wires[START_DELTA:START_DELTA + 4]
        constraints = [g.mul(swap, g.sub(swap, one))[None],
                       g.sub(g.mul(swap[None], g.sub(inputs[4:8], inputs[:4])), deltas)]
        state = torch.cat([g.add(inputs[:4], deltas), g.sub(inputs[4:8], deltas), inputs[8:]])
        rc = t["round_constants"]
        round_ctr = 0
        for r in range(HALF_N_FULL_ROUNDS):
            state = g.add(state, rc[round_ctr][:, None])
            if r != 0:
                sbox_in = wires[START_FULL_0 + W * (r - 1):START_FULL_0 + W * r]
                constraints.append(g.sub(state, sbox_in))
                state = sbox_in
            state = g.matmul_mod(t["mds"], sbox(state))
            round_ctr += 1
        state = g.add(state, t["partial_first"][:, None])
        state = g.matmul_mod(t["partial_init"], state)
        for r in range(N_PARTIAL_ROUNDS):
            sbox_in = wires[START_PARTIAL + r]
            constraints.append(g.sub(state[0], sbox_in)[None])
            s0 = g.add(sbox(sbox_in), t["partial_rcs"][r])
            d = g.sum_mod(g.mul(t["w_hat"][r][:, None], torch.cat([s0[None], state[1:]])), 0)
            state = torch.cat([d[None], g.add(state[1:], g.mul(t["vs"][r][:, None], s0[None]))])
        round_ctr += N_PARTIAL_ROUNDS
        for r in range(HALF_N_FULL_ROUNDS):
            state = g.add(state, rc[round_ctr][:, None])
            sbox_in = wires[START_FULL_1 + W * r:START_FULL_1 + W * (r + 1)]
            constraints.append(g.sub(state, sbox_in))
            state = g.matmul_mod(t["mds"], sbox(sbox_in))
            round_ctr += 1
        constraints.append(g.sub(state, wires[W:2 * W]))
        return torch.cat(constraints)

    def generators(self, row: int, local_constants: list[int]) -> list:
        return [PoseidonGenerator(row)]

    def num_wires(self) -> int:
        return END

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return 7

    def num_constraints(self) -> int:
        return 1 + 4 + W * (HALF_N_FULL_ROUNDS - 1) + N_PARTIAL_ROUNDS + W * HALF_N_FULL_ROUNDS + W


# -- the witness generator (reference gates/poseidon.rs PoseidonGenerator;
#    the reference package's gates/poseidon_gate.py:352) -------------------

# the columns PoseidonGenerator writes, in its output order: the swap
# deltas, the S-box inputs of full rounds 1..3, of the partial rounds and
# of the last four full rounds, then the outputs
OUT_COLS = ([START_DELTA + i for i in range(4)]
            + list(range(START_FULL_0, START_PARTIAL)) + list(range(START_PARTIAL, START_FULL_1))
            + list(range(START_FULL_1, START_FULL_1 + W * HALF_N_FULL_ROUNDS))
            + [W + i for i in range(W)])
IN_COLS = list(range(W)) + [WIRE_SWAP]


def witness_rows(inputs: np.ndarray, swap: np.ndarray) -> np.ndarray:
    """[n, 12] inputs and [n] swaps (0 or 1) -> [n, 122] values of OUT_COLS,
    the gate's layers run on numpy rows (the fast partial-round form, which
    the constraints are written against)."""
    ops = npf.NumpyBaseOps()
    state = [inputs[:, i] for i in range(W)]
    out = [npf.mul(swap, npf.sub(state[i + 4], state[i])) for i in range(4)]
    do_swap = swap == 1
    for i in range(4):
        a, b = state[i], state[i + 4]
        state[i], state[i + 4] = np.where(do_swap, b, a), np.where(do_swap, a, b)
    round_ctr = 0
    for r in range(HALF_N_FULL_ROUNDS):
        state = [ops.add_const(x, ALL_ROUND_CONSTANTS[i + W * round_ctr])
                 for i, x in enumerate(state)]
        if r != 0:
            out += state
        state = _mds_layer(ops, [_sbox(ops, x) for x in state])
        round_ctr += 1
    state = [ops.add_const(x, FAST_PARTIAL_FIRST_ROUND_CONSTANT[i]) for i, x in enumerate(state)]
    state = _mds_partial_layer_init(ops, state)
    for r in range(N_PARTIAL_ROUNDS):
        out.append(state[0])
        s0 = _sbox(ops, state[0])
        if r < N_PARTIAL_ROUNDS - 1:
            s0 = ops.add_const(s0, FAST_PARTIAL_ROUND_CONSTANTS[r])
        state = _mds_partial_layer_fast(ops, [s0] + state[1:], r)
    round_ctr += N_PARTIAL_ROUNDS
    for r in range(HALF_N_FULL_ROUNDS):
        state = [ops.add_const(x, ALL_ROUND_CONSTANTS[i + W * round_ctr])
                 for i, x in enumerate(state)]
        out += state
        state = _mds_layer(ops, [_sbox(ops, x) for x in state])
        round_ctr += 1
    out += state
    n = inputs.shape[0]
    return np.stack([np.broadcast_to(np.asarray(v, np.uint64), (n,)) for v in out], axis=1)


class PoseidonGenerator(SimpleGenerator):
    """Fills the swap deltas, every S-box input and the outputs of one
    PoseidonGate row."""

    BATCH_MIN = 1  # the numpy rows beat a scalar permutation even for one row

    def __init__(self, row: int):
        self.row = row

    def dependencies(self):
        return [Wire(self.row, c) for c in IN_COLS]

    def outputs(self):
        return [Wire(self.row, c) for c in OUT_COLS]

    def run_once(self, witness, out):
        v = np.asarray(witness.get_targets(self.dependencies()), np.uint64)
        if v[W] > 1:
            raise ValueError("swap must be 0 or 1")
        out.set_wires(self.row, OUT_COLS, [int(x) for x in witness_rows(v[None, :W], v[W:])[0]])

    @classmethod
    def run_batch(cls, gens, witness):
        rows_ = np.fromiter((g_.row for g_ in gens), np.int64, len(gens))
        in_cols = np.asarray(IN_COLS, np.int64)
        v = witness.get_reps(witness.wire_reps(rows_[:, None], in_cols[None, :]))
        if (v[:, W] > 1).any():
            raise ValueError("swap must be 0 or 1")
        vals = witness_rows(v[:, :W], v[:, W])
        reps = witness.wire_reps(rows_[:, None], np.asarray(OUT_COLS, np.int64)[None, :])
        witness.set_reps(reps.T.reshape(-1), vals.T.reshape(-1))
