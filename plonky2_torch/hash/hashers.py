"""The hasher objects: the runtime form of the reference's `Hasher` trait
(reference plonk/config.rs:36-126; the reference package's
hash/hashers.py).

`PoseidonHasher` digests are 4-felt lists (HashOut) and it is algebraic: a
circuit can verify it. `KeccakHasher` digests are `bytes` of HASH_SIZE
(BytesHash<25>), hashed on the host; it is not algebraic. The challenger,
the Merkle trees and the serializers go by the digest's form.
"""

from __future__ import annotations

import numpy as np

from plonky2_torch.hash import keccak as kk
from plonky2_torch.hash import poseidon as ps


def _pad_10_1(inputs) -> list[int]:
    """pad10*1 over field elements at rate 8 (reference plonk/config.rs:50-59)."""
    padded = list(inputs) + [1]
    while (len(padded) + 1) % ps.SPONGE_RATE:
        padded.append(0)
    return padded + [1]


class PoseidonHasher:
    """Poseidon-12 sponge hasher."""

    HASH_SIZE = 32
    algebraic = True
    name = "PoseidonHash"

    @staticmethod
    def hash_no_pad(inputs: list[int]) -> list[int]:
        return ps.hash_no_pad(inputs)

    @staticmethod
    def hash_pad(inputs: list[int]) -> list[int]:
        """The digest of `inputs` under pad10*1 at rate 8."""
        return ps.hash_no_pad(_pad_10_1(inputs))

    @staticmethod
    def hash_or_noop(inputs: list[int]) -> list[int]:
        return ps.hash_or_noop(inputs)

    @staticmethod
    def two_to_one(left, right) -> list[int]:
        return ps.two_to_one(left, right)

    @staticmethod
    def permute(state: list[int]) -> list[int]:
        return ps.permute(state)

    @staticmethod
    def digest_to_felts(digest) -> list[int]:
        return list(digest)


class KeccakHasher:
    """Keccak-256 truncated to HASH_SIZE bytes (reference hash/keccak.rs),
    on the host; the trees hash a whole level in one batch."""

    HASH_SIZE = 25
    algebraic = False
    name = "KeccakHash<25>"

    @staticmethod
    def hash_no_pad(inputs: list[int]) -> bytes:
        return kk.hash_no_pad(inputs, KeccakHasher.HASH_SIZE)

    @staticmethod
    def hash_pad(inputs: list[int]) -> bytes:
        return kk.hash_no_pad(_pad_10_1(inputs), KeccakHasher.HASH_SIZE)

    @staticmethod
    def hash_or_noop(inputs: list[int]) -> bytes:
        """The inputs' bytes, zero-padded, where they fit in a digest; else
        their hash."""
        if len(inputs) * 8 <= KeccakHasher.HASH_SIZE:
            return kk.felts_to_bytes(inputs).ljust(KeccakHasher.HASH_SIZE, b"\0")
        return KeccakHasher.hash_no_pad(inputs)

    @staticmethod
    def two_to_one(left: bytes, right: bytes) -> bytes:
        return kk.two_to_one(left, right)

    @staticmethod
    def permute(state: list[int]) -> list[int]:
        return kk.permute(state)

    @staticmethod
    def digest_to_felts(digest: bytes) -> list[int]:
        return kk.bytes_digest_to_felts(digest)

    @staticmethod
    def hash_leaves_batch(leaves: np.ndarray) -> np.ndarray:
        """hash_or_noop of each row: [n, width] u64 -> [n, HASH_SIZE] u8."""
        n, width = leaves.shape
        hs = KeccakHasher.HASH_SIZE
        data = np.ascontiguousarray(leaves, dtype="<u8").view(np.uint8).reshape(n, width * 8)
        if width * 8 <= hs:
            out = np.zeros((n, hs), dtype=np.uint8)
            out[:, :width * 8] = data
            return out
        return kk.keccak256_batch(data)[:, :hs]

    @staticmethod
    def compress_batch(digests: np.ndarray) -> np.ndarray:
        """two_to_one of each adjacent pair: [2m, HASH_SIZE] u8 -> [m, HASH_SIZE] u8."""
        m2, hs = digests.shape
        return kk.keccak256_batch(digests.reshape(m2 // 2, 2 * hs))[:, :hs]


def observe_digest(challenger, digest) -> None:
    """Observe either digest form into the transcript: a byte digest as
    7-byte field elements (reference hash_types.rs:184-194)."""
    if isinstance(digest, (bytes, bytearray)):
        challenger.observe_elements(kk.bytes_digest_to_felts(bytes(digest)))
    else:
        challenger.observe_elements(list(digest))
