"""Poseidon-Goldilocks permutation: the host version (the native library's
`poseidon_permute`, with `permute_py` its Python twin) and the batched
device version (kernel K5 on CUDA, its plain version on the CPU).

The round schedule is the straightforward one (constant layer, S-box layer,
MDS layer; partial rounds S-box lane 0 only), algebraically identical to
the fast-partial-round decomposition, so outputs are bit-exact.
"""

from __future__ import annotations

import numpy as np

from plonky2_torch import native
from plonky2_torch.field import scalar as fs
from plonky2_torch.hash.poseidon_constants import (
    ALL_ROUND_CONSTANTS,
    HALF_N_FULL_ROUNDS,
    MDS_MATRIX_CIRC,
    MDS_MATRIX_DIAG,
    N_PARTIAL_ROUNDS,
    N_ROUNDS,
    SPONGE_RATE,
    SPONGE_WIDTH,
)
from plonky2_torch.ops import poseidon as kp

P = fs.P
W = SPONGE_WIDTH

# M[r][i] = CIRC[(i - r) % 12] + (i == r) * DIAG[r]
_MDS = [
    [MDS_MATRIX_CIRC[(i - r) % W] + (MDS_MATRIX_DIAG[r] if i == r else 0) for i in range(W)]
    for r in range(W)
]


def _sbox(x: int) -> int:
    x2 = (x * x) % P
    x3 = (x2 * x) % P
    return (x3 * x3 % P) * x % P


def permute(state) -> list[int]:
    """One full 30-round permutation over 12 canonical ints, on the native
    library. Raises where the library cannot be built or loaded."""
    return native.poseidon_permute(np.asarray(state, np.uint64)).tolist()


def permute_py(state) -> list[int]:
    """The permutation in Python ints: the native call's tested twin."""
    s = list(state)
    for rnd in range(N_ROUNDS):
        full = rnd < HALF_N_FULL_ROUNDS or rnd >= HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS
        s = [(x + ALL_ROUND_CONSTANTS[i + W * rnd]) % P for i, x in enumerate(s)]
        if full:
            s = [_sbox(x) for x in s]
        else:
            s[0] = _sbox(s[0])
        s = [sum(_MDS[r][i] * s[i] for i in range(W)) % P for r in range(W)]
    return s


def permute_dev_sm(state):
    """Batched permutation over state-major [12, N] int64 tensors."""
    return kp.permute(state.contiguous())


def hash_n_to_m_no_pad(inputs: list[int], num_outputs: int) -> list[int]:
    """Host sponge: absorb in rate-8 chunks (overwrite), squeeze num_outputs."""
    state = np.zeros(W, np.uint64)
    for i in range(0, len(inputs), SPONGE_RATE):
        chunk = inputs[i:i + SPONGE_RATE]
        state[:len(chunk)] = chunk
        state = native.poseidon_permute(state)
    outputs = []
    while True:
        for x in state[:SPONGE_RATE].tolist():
            outputs.append(x)
            if len(outputs) == num_outputs:
                return outputs
        state = native.poseidon_permute(state)


def hash_no_pad(inputs: list[int]) -> list[int]:
    """4-felt digest (HashOut) of the input sequence."""
    return hash_n_to_m_no_pad(inputs, 4)


def hash_or_noop(inputs: list[int]) -> list[int]:
    """<= 4 felts pass through zero-padded; longer inputs are hashed."""
    if len(inputs) <= 4:
        return list(inputs) + [0] * (4 - len(inputs))
    return hash_no_pad(inputs)


def two_to_one(left: list[int], right: list[int]) -> list[int]:
    """Compress two 4-felt digests: one permutation of [left, right, 0, 0, 0, 0]."""
    state = np.zeros(W, np.uint64)
    state[:4] = left
    state[4:8] = right
    return native.poseidon_permute(state)[:4].tolist()
