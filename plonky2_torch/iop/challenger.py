"""Fiat-Shamir challenger: duplex sponge in overwrite mode, on the host
(`Challenger`) and on the device (`DeviceChallenger`, `cap_boundary`).

Behaviour is consensus critical and matches the reference package's
`Challenger`: observing clears the output buffer; absorbing duplexes when
the input buffer reaches RATE; `get_challenge` duplexes if inputs are
pending or outputs are exhausted, then pops from the END of the squeezed
rate (first challenge = state[RATE-1]); `compact()` flushes pending inputs
and exposes the raw sponge state.
"""

from __future__ import annotations

import torch

from plonky2_torch.field import scalar as fs
from plonky2_torch.hash.poseidon_constants import SPONGE_RATE, SPONGE_WIDTH


class Challenger:
    """The host transcript. `hasher` permutes the sponge state: Poseidon
    by default, or the Keccak pseudo-permutation of
    `KeccakGoldilocksConfig`."""

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
        """A Poseidon digest's 4 felts, or a Keccak byte digest as 7-byte
        felts (reference hash_types.rs:184-194)."""
        from plonky2_torch.hash.hashers import observe_digest

        observe_digest(self, digest)

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


class DeviceChallenger:
    """The transcript on the device (reference iop/challenger.py
    `DeviceChallenger`): the sponge state is a [12] int64 tensor and the
    pending inputs are device values, but their count is a Python int, so
    the duplex schedule is the host challenger's exactly and nothing is read
    back. Each duplex is one K5 permutation of [12, 1]; a draw is a 0-d view
    of the squeezed state, popped from the end of the rate."""

    def __init__(self, state, pending=None):
        self.state = state  # [12] int64
        self.inputs = [] if pending is None or pending.shape[0] == 0 else [pending]
        self.k = 0 if pending is None else int(pending.shape[0])  # pending count
        self.remaining = 0  # squeezed outputs not yet drawn

    def observe_elements(self, xs) -> None:
        """Observe a 1-d tensor of field elements, in order: the host
        challenger's observe_element on each, a duplex whenever RATE inputs
        are pending."""
        xs = xs.reshape(-1)
        pos, n = 0, int(xs.shape[0])
        while pos < n:
            self.remaining = 0
            take = min(SPONGE_RATE - self.k, n - pos)
            self.inputs.append(xs[pos:pos + take])
            self.k += take
            pos += take
            if self.k == SPONGE_RATE:
                self._duplexing()

    def observe_cap_rows(self, cap) -> None:
        """cap: [rows, 4] digests, observed row-major (observe_cap's order)."""
        self.observe_elements(cap)

    def get_challenge(self):
        if self.k or not self.remaining:
            self._duplexing()
        self.remaining -= 1
        return self.state[self.remaining]

    def get_n_challenges(self, n: int) -> list:
        return [self.get_challenge() for _ in range(n)]

    def pending(self):
        """The pending inputs as one [k] tensor."""
        if not self.inputs:
            return self.state.new_empty((0,))
        return self.inputs[0] if len(self.inputs) == 1 else torch.cat(self.inputs)

    def _duplexing(self) -> None:
        from plonky2_torch.ops import poseidon as kp

        st = self.state
        if self.k:
            st = torch.cat([self.pending(), st[self.k:]])
        self.state = kp.permute(st.reshape(SPONGE_WIDTH, 1)).reshape(SPONGE_WIDTH)
        self.inputs = []
        self.k = 0
        self.remaining = SPONGE_RATE


def cap_boundary(sponge, pending, k_pending: int, cap, cap_height: int, natural: bool,
                 n_draws: int):
    """A phase boundary of the prove on the device transcript (reference
    iop/challenger.py `cap_boundary_fn`): observe one Merkle cap, then draw
    `n_draws` challenges. cap: natural=True takes a natural-order tree's
    [4, 2^cap_height] cap layer (the reference's digest c is column
    rev(c)); natural=False row-major [2^cap_height, 4] digests. Returns
    (state [12], pending [k_out], draws [n_draws], cap rows
    [2^cap_height, 4] in the reference's digest order); k_out is 0 after a
    draw and (k_pending + 4 · 2^cap_height) mod RATE without one."""
    from plonky2_torch.ops.ntt import bit_reverse_index

    if int(pending.shape[0]) != k_pending:
        raise ValueError(f"{int(pending.shape[0])} pending inputs, {k_pending} expected")
    rows = cap[:, bit_reverse_index(cap_height, cap.device)].T if natural else cap
    dc = DeviceChallenger(sponge, pending)
    dc.observe_cap_rows(rows)
    draws = dc.get_n_challenges(n_draws)
    out = torch.stack(draws) if draws else sponge.new_empty((0,))
    return dc.state, dc.pending(), out, rows
