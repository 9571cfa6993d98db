"""The Fiat-Shamir challenger on builder targets (reference
iop/challenger.rs:160+ `RecursiveChallenger`; the reference package's
recursion/recursive_challenger.py:13-76).

It observes and squeezes as the host `Challenger` does; each duplexing is
one PoseidonGate row (`builder.permute`).
"""

from __future__ import annotations

from plonky2_torch.hash.poseidon_constants import SPONGE_RATE, SPONGE_WIDTH
from plonky2_torch.iop.target import ExtensionTarget, Target


class RecursiveChallenger:
    def __init__(self, builder):
        self.builder = builder
        self.sponge_state: list[Target] = [builder.zero()] * SPONGE_WIDTH
        self.input_buffer: list[Target] = []
        self.output_buffer: list[Target] = []

    def observe_element(self, target: Target) -> None:
        self.output_buffer.clear()
        self.input_buffer.append(target)
        if len(self.input_buffer) == SPONGE_RATE:
            self._duplexing()

    def observe_elements(self, targets) -> None:
        for t in targets:
            self.observe_element(t)

    def observe_extension_element(self, ext_target: ExtensionTarget) -> None:
        self.observe_elements(ext_target.parts)

    def observe_extension_elements(self, ext_targets) -> None:
        for t in ext_targets:
            self.observe_extension_element(t)

    def observe_hash(self, hash4) -> None:
        self.observe_elements(hash4)

    def observe_cap(self, cap_targets) -> None:
        for digest in cap_targets:
            self.observe_hash(digest)

    def get_challenge(self) -> Target:
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> list[Target]:
        return [self.get_challenge() for _ in range(n)]

    def get_hash(self) -> list[Target]:
        return self.get_n_challenges(4)

    def get_extension_challenge(self) -> ExtensionTarget:
        return ExtensionTarget(tuple(self.get_n_challenges(2)))

    def get_n_extension_challenges(self, n: int) -> list[ExtensionTarget]:
        return [self.get_extension_challenge() for _ in range(n)]

    def _duplexing(self) -> None:
        """Overwrite the rate with the pending inputs, permute, and
        refill the outputs from the rate."""
        for i, t in enumerate(self.input_buffer):
            self.sponge_state[i] = t
        self.input_buffer.clear()
        self.sponge_state = self.builder.permute(self.sponge_state)
        self.output_buffer = list(self.sponge_state[:SPONGE_RATE])
