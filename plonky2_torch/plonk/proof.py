"""Proof containers (reference plonk/proof.rs:34-420). Extension values are
D = 2 tuples of Python ints; Merkle caps are lists of 4-element digests."""

from __future__ import annotations

from dataclasses import dataclass, field

from plonky2_torch.fri.proof import FriProof
from plonky2_torch.fri.structure import FriOpeningBatch, FriOpenings


@dataclass
class OpeningSet:
    """The committed polynomials' values at ζ, and the Z polynomials' and
    the lookup columns' at g·ζ (reference plonk/proof.rs:301); the lookup
    openings are empty for a circuit without LUTs."""

    constants: list[tuple]
    plonk_sigmas: list[tuple]
    wires: list[tuple]
    plonk_zs: list[tuple]
    plonk_zs_next: list[tuple]
    partial_products: list[tuple]
    quotient_polys: list[tuple]
    lookup_zs: list[tuple] = field(default_factory=list)
    lookup_zs_next: list[tuple] = field(default_factory=list)

    def to_fri_openings(self) -> FriOpenings:
        """In the order of CommonCircuitData.fri_all_polys (the lookup
        columns after the quotient) and fri_next_batch_polys."""
        return FriOpenings(batches=[
            FriOpeningBatch(values=self.constants + self.plonk_sigmas + self.wires
                            + self.plonk_zs + self.partial_products + self.quotient_polys
                            + self.lookup_zs),
            FriOpeningBatch(values=self.plonk_zs_next + self.lookup_zs_next)])


@dataclass
class Proof:
    wires_cap: list
    plonk_zs_partial_products_cap: list
    quotient_polys_cap: list
    openings: OpeningSet
    opening_proof: FriProof


@dataclass
class ProofWithPublicInputs:
    proof: Proof
    public_inputs: list[int]


@dataclass
class ProofChallenges:
    """The verifier's replay of the transcript (reference plonk/proof.rs:259)."""

    plonk_betas: list[int]
    plonk_gammas: list[int]
    plonk_alphas: list[int]
    plonk_deltas: list[int]  # NUM_COINS_LOOKUP a challenge; empty without LUTs
    plonk_zeta: tuple
    fri_challenges: object
