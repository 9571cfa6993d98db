"""Fiat-Shamir challenger: duplex sponge in overwrite mode, on the host.

Behaviour is consensus critical and matches the reference package's host
`Challenger`: observing clears the output buffer; absorbing duplexes when
the input buffer reaches RATE; `get_challenge` duplexes if inputs are
pending or outputs are exhausted, then pops from the END of the squeezed
rate (first challenge = state[RATE-1]); `compact()` flushes pending inputs
and exposes the raw sponge state.
"""

from __future__ import annotations

from plonky2_torch.field import scalar as fs
from plonky2_torch.hash.poseidon_constants import SPONGE_RATE, SPONGE_WIDTH


class Challenger:
    def __init__(self, hasher=None):
        from plonky2_torch.hash.hashers import PoseidonHasher

        self.hasher = hasher or PoseidonHasher
        self.sponge_state: list[int] = [0] * SPONGE_WIDTH
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    # -- observing ---------------------------------------------------------

    def observe_element(self, element: int) -> None:
        if not 0 <= element < fs.P:
            raise ValueError(f"{element} is not a canonical field element")
        self.output_buffer.clear()
        self.input_buffer.append(element)
        if len(self.input_buffer) == SPONGE_RATE:
            self._duplexing()

    def observe_elements(self, elements) -> None:
        for e in elements:
            self.observe_element(e)

    def observe_extension_element(self, element) -> None:
        self.observe_elements(element)

    def observe_extension_elements(self, elements) -> None:
        for e in elements:
            self.observe_extension_element(e)

    def observe_hash(self, digest) -> None:
        self.observe_elements(list(digest))

    def observe_cap(self, cap) -> None:
        for digest in cap:
            self.observe_hash(digest)

    # -- squeezing ---------------------------------------------------------

    def get_challenge(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> list[int]:
        return [self.get_challenge() for _ in range(n)]

    def get_hash(self) -> list[int]:
        return self.get_n_challenges(4)

    def get_extension_challenge(self, d: int = 2) -> tuple[int, ...]:
        return tuple(self.get_n_challenges(d))

    def get_n_extension_challenges(self, n: int, d: int = 2) -> list[tuple[int, ...]]:
        return [self.get_extension_challenge(d) for _ in range(n)]

    # -- internals ---------------------------------------------------------

    def _duplexing(self) -> None:
        for i, x in enumerate(self.input_buffer):
            self.sponge_state[i] = x
        self.input_buffer.clear()
        self.sponge_state = self.hasher.permute(self.sponge_state)
        self.output_buffer = list(self.sponge_state[:SPONGE_RATE])

    def compact(self) -> list[int]:
        """Flush inputs and return the raw sponge state."""
        if self.input_buffer:
            self._duplexing()
        self.output_buffer.clear()
        return list(self.sponge_state)
