"""FRI proof containers (host-side)."""

from __future__ import annotations

from dataclasses import dataclass

from plonky2_torch.hash.merkle import MerkleProof

SALT_SIZE = 4  # salt felts appended to each leaf of a blinded oracle (zk)


@dataclass
class FriInitialTreeProof:
    # per oracle: (full leaf values incl. salt, merkle proof)
    evals_proofs: list[tuple[list[int], MerkleProof]]

    def unsalted_eval(self, oracle_index: int, poly_index: int, salted: bool) -> int:
        evals = self.evals_proofs[oracle_index][0]
        if salted:
            evals = evals[:-SALT_SIZE]
        return evals[poly_index]


@dataclass
class FriQueryStep:
    evals: list[tuple]  # arity extension elements
    merkle_proof: MerkleProof


@dataclass
class FriQueryRound:
    initial_trees_proof: FriInitialTreeProof
    steps: list[FriQueryStep]


@dataclass
class FriProof:
    commit_phase_merkle_caps: list[list[list[int]]]  # per step: cap of 4-felt digests
    query_round_proofs: list[FriQueryRound]
    final_poly: list[tuple]  # extension coefficients
    pow_witness: int


@dataclass
class FriChallenges:
    fri_alpha: tuple
    fri_betas: list[tuple]
    fri_pow_response: int
    fri_query_indices: list[int]
