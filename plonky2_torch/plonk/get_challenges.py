"""The verifier's replay of the Fiat-Shamir transcript on the host
`Challenger` (reference plonk/get_challenges.rs:26-95; the reference
package's plonk/get_challenges.py:13). A circuit with LUTs draws
NUM_COINS_LOOKUP values a challenge at the wires cap, not two: the β and
γ are the first 2 · num_challenges of them, and the lookup deltas are the
whole stream, challenge c's at [4c, 4c + 4)."""

from __future__ import annotations

from plonky2_torch.fri.verifier import fri_challenges
from plonky2_torch.iop.challenger import Challenger
from plonky2_torch.plonk.proof import ProofChallenges
from plonky2_torch.plonk.vanishing_poly import NUM_COINS_LOOKUP


def get_challenges(proof_with_pis, public_inputs_hash, circuit_digest,
                   common) -> ProofChallenges:
    proof = proof_with_pis.proof
    nc = common.config.num_challenges
    challenger = Challenger(common.generic_config().hasher)
    common.fri_params.observe(challenger)
    challenger.observe_hash(circuit_digest)
    challenger.observe_hash(public_inputs_hash)
    challenger.observe_cap(proof.wires_cap)
    plonk_betas = challenger.get_n_challenges(nc)
    plonk_gammas = challenger.get_n_challenges(nc)
    plonk_deltas = []
    if common.num_lookup_polys:
        plonk_deltas = (plonk_betas + plonk_gammas
                        + challenger.get_n_challenges((NUM_COINS_LOOKUP - 2) * nc))
    challenger.observe_cap(proof.plonk_zs_partial_products_cap)
    plonk_alphas = challenger.get_n_challenges(nc)
    challenger.observe_cap(proof.quotient_polys_cap)
    plonk_zeta = challenger.get_extension_challenge(2)
    for batch in proof.openings.to_fri_openings().batches:
        challenger.observe_extension_elements(batch.values)
    op = proof.opening_proof
    return ProofChallenges(
        plonk_betas=plonk_betas, plonk_gammas=plonk_gammas, plonk_alphas=plonk_alphas,
        plonk_deltas=plonk_deltas, plonk_zeta=plonk_zeta,
        fri_challenges=fri_challenges(challenger, op.commit_phase_merkle_caps, op.final_poly,
                                      op.pow_witness, common.degree_bits,
                                      common.config.fri_config))
