"""STARK proof containers (reference starky/src/proof.rs)."""

from __future__ import annotations

from dataclasses import dataclass

from plonky2_torch.field import scalar as fs
from plonky2_torch.fri.proof import FriProof
from plonky2_torch.fri.structure import FriOpeningBatch, FriOpenings


@dataclass
class StarkOpeningSet:
    local_values: list
    next_values: list
    auxiliary_polys: list | None
    auxiliary_polys_next: list | None
    ctl_zs_first: list | None
    quotient_polys: list | None

    def to_fri_openings(self) -> FriOpenings:
        zeta_batch = FriOpeningBatch(
            values=(list(self.local_values)
                    + list(self.auxiliary_polys or [])
                    + list(self.quotient_polys or []))
        )
        zeta_next_batch = FriOpeningBatch(
            values=list(self.next_values) + list(self.auxiliary_polys_next or [])
        )
        batches = [zeta_batch, zeta_next_batch]
        if self.ctl_zs_first is not None:
            batches.append(
                FriOpeningBatch(values=[fs.ext_from_base(v, 2) for v in self.ctl_zs_first])
            )
        return FriOpenings(batches=batches)


@dataclass
class StarkProof:
    trace_cap: list
    auxiliary_polys_cap: list | None
    quotient_polys_cap: list | None
    openings: StarkOpeningSet
    opening_proof: FriProof

    def recover_degree_bits(self, config) -> int:
        initial_merkle_proof = self.opening_proof.query_round_proofs[0] \
            .initial_trees_proof.evals_proofs[0][1]
        lde_bits = config.fri_config.cap_height + len(initial_merkle_proof.siblings)
        return lde_bits - config.fri_config.rate_bits


@dataclass
class StarkProofWithPublicInputs:
    proof: StarkProof
    public_inputs: list[int]


@dataclass
class StarkProofChallenges:
    lookup_challenge_set: object | None
    stark_alphas: list[int]
    stark_zeta: tuple
    fri_challenges: object


@dataclass
class MultiProofChallenges:
    """The randomness of every STARK proof of a multi-table system
    (reference starky/src/proof.rs:196-202): each table's challenges and the
    CTL GrandProductChallengeSet that all tables share."""

    stark_challenges: list  # [StarkProofChallenges], one per table
    ctl_challenges: object  # GrandProductChallengeSet
