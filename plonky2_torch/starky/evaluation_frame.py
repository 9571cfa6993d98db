"""StarkFrame: the local row, the next row and the public inputs
(reference starky/src/evaluation_frame.rs). Values are ops-domain: extension
tuples for the verifier, [Q] tensors for the prover's quotient."""

from __future__ import annotations


class StarkFrame:
    def __init__(self, local_values, next_values, public_inputs):
        self._local = list(local_values)
        self._next = list(next_values)
        self._pis = list(public_inputs)

    def get_local_values(self):
        return self._local

    def get_next_values(self):
        return self._next

    def get_public_inputs(self):
        return self._pis
