"""The Poseidon hasher object (the runtime form of the `Hasher` trait);
digests are 4-felt lists (HashOut). The Keccak hasher is not ported yet."""

from __future__ import annotations

from plonky2_torch.hash import poseidon as ps


class PoseidonHasher:
    """Poseidon-12 sponge hasher."""

    @staticmethod
    def hash_no_pad(inputs: list[int]) -> list[int]:
        return ps.hash_no_pad(inputs)

    @staticmethod
    def hash_pad(inputs: list[int]) -> list[int]:
        """The digest of `inputs` under pad10*1 at rate 8 (reference
        plonk/config.rs:50-59)."""
        padded = list(inputs) + [1]
        while (len(padded) + 1) % ps.SPONGE_RATE:
            padded.append(0)
        return ps.hash_no_pad(padded + [1])

    @staticmethod
    def hash_or_noop(inputs: list[int]) -> list[int]:
        return ps.hash_or_noop(inputs)

    @staticmethod
    def two_to_one(left, right) -> list[int]:
        return ps.two_to_one(left, right)

    @staticmethod
    def permute(state: list[int]) -> list[int]:
        return ps.permute(state)
