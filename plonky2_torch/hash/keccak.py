"""Keccak-256 (the original 0x01 padding, as the `keccak_hash` crate) for
`KeccakGoldilocksConfig` (reference hash/keccak.rs; the reference package's
hash/keccak.py).

The permutation keccak-f[1600] runs over a batch of states [n, 25] u64 (lane
A[x + 5y]) on one of two engines, picked by argument or by `ENGINE`:
"native", the port's C++ `keccak_f1600` (`native/src/plonky2_native.cc`,
built with g++ at first use; a failed build raises), or "numpy", its plain
twin. Nothing falls back from one to the other. `keccak256_batch` hashes n
equal-length messages at once: the host Merkle trees and the proof-of-work
grind batch every leaf, pair or candidate through it.
"""

from __future__ import annotations

import numpy as np

from plonky2_torch.field import scalar as fs

ENGINE = "native"  # or "numpy"
ENGINES = ("native", "numpy")

_RC = np.array([
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
], dtype=np.uint64)

# rotation offsets: _ROT[x][y] for lane A[x + 5y]
_ROT = [[0, 36, 3, 41, 18],
        [1, 44, 10, 45, 2],
        [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56],
        [27, 20, 39, 8, 14]]

RATE_BYTES = 136  # keccak-256's rate


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    if r == 0:
        return v
    return (v << np.uint64(r)) | (v >> np.uint64(64 - r))


def keccak_f_np(states: np.ndarray) -> np.ndarray:
    """keccak-f[1600] over [n, 25] u64 lanes in numpy: the plain twin of
    the native `keccak_f1600`. Returns a new array."""
    A = [np.array(states[:, i], dtype=np.uint64) for i in range(25)]
    for rnd in range(24):
        C = [A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20] for x in range(5)]
        D = [C[(x - 1) % 5] ^ _rotl(C[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                A[x + 5 * y] ^= D[x]
        B = [None] * 25  # rho and pi: B[y, 2x + 3y] = rot(A[x, y])
        for x in range(5):
            for y in range(5):
                B[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(A[x + 5 * y], _ROT[x][y])
        for x in range(5):
            for y in range(5):
                A[x + 5 * y] = B[x + 5 * y] ^ (~B[(x + 1) % 5 + 5 * y] & B[(x + 2) % 5 + 5 * y])
        A[0] = A[0] ^ _RC[rnd]
    return np.stack(A, axis=1)


def keccak_f(states: np.ndarray, engine: str | None = None) -> np.ndarray:
    """keccak-f[1600] over [n, 25] u64 lanes on `engine` (default
    `ENGINE`). Returns a new array."""
    engine = engine or ENGINE
    if engine == "native":
        from plonky2_torch import native

        return native.keccak_f1600(states)
    if engine == "numpy":
        return keccak_f_np(states)
    raise ValueError(f"unknown keccak engine {engine!r}; expected one of {ENGINES}")


def keccak256_batch(data: np.ndarray, engine: str | None = None) -> np.ndarray:
    """Keccak-256 of n messages of one length: [n, L] u8 -> [n, 32] u8."""
    n, L = data.shape
    padded_len = (L // RATE_BYTES + 1) * RATE_BYTES  # pad10*1, domain byte 0x01
    padded = np.zeros((n, padded_len), dtype=np.uint8)
    padded[:, :L] = data
    padded[:, L] ^= 0x01
    padded[:, padded_len - 1] ^= 0x80
    states = np.zeros((n, 25), dtype=np.uint64)
    for block in range(padded_len // RATE_BYTES):
        chunk = np.ascontiguousarray(padded[:, block * RATE_BYTES:(block + 1) * RATE_BYTES])
        states[:, :RATE_BYTES // 8] ^= chunk.view("<u8").reshape(n, RATE_BYTES // 8)
        states = keccak_f(states, engine)
    return np.ascontiguousarray(states[:, :4]).view(np.uint8).reshape(n, 32)


def keccak256(data: bytes, engine: str | None = None) -> bytes:
    arr = np.frombuffer(bytes(data), dtype=np.uint8).reshape(1, -1)
    return keccak256_batch(arr, engine)[0].tobytes()


# -- KeccakHash<N> (reference hash/keccak.rs:100-130) ---------------------------

def felts_to_bytes(inputs) -> bytes:
    return b"".join(int(x).to_bytes(8, "little") for x in inputs)


def hash_no_pad(inputs, n: int = 25) -> bytes:
    return keccak256(felts_to_bytes(inputs))[:n]


def two_to_one(left: bytes, right: bytes) -> bytes:
    return keccak256(left + right)[:len(left)]


def bytes_digest_to_felts(digest: bytes) -> list[int]:
    """A byte digest as field elements of 7 bytes each, so that none
    overflows (reference hash_types.rs:184-194)."""
    return [int.from_bytes(digest[i:i + 7], "little") for i in range(0, len(digest), 7)]


def permute(state) -> list[int]:
    """The challenger's Keccak pseudo-permutation: hash the state's bytes,
    hash the digest again and again, and keep each 8-byte word below p
    until 12 are kept (reference hash/keccak.rs:63-98)."""
    state_bytes = felts_to_bytes(state)
    out: list[int] = []
    while len(out) < 12:
        state_bytes = keccak256(state_bytes)
        for i in range(0, 32, 8):
            word = int.from_bytes(state_bytes[i:i + 8], "little")
            if word < fs.P:
                out.append(word)
    return out[:12]
