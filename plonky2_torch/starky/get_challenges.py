"""The STARK Fiat-Shamir transcript (reference starky/src/get_challenges.rs).

`bind_constraints` is the step that prover and verifier share: draw α',
draw the dummy openings, observe the constraints' values there, then draw
the quotient's alphas (the reference package's starky/prover.py:119-149).
`get_challenges` replays the whole transcript of a proof for the verifier.
"""

from __future__ import annotations

from plonky2_torch.fri.verifier import fri_challenges
from plonky2_torch.iop.challenger import Challenger
from plonky2_torch.starky.lookup import get_grand_product_challenge_set
from plonky2_torch.starky.proof import StarkProofChallenges, StarkProofWithPublicInputs
from plonky2_torch.starky.vanishing import compute_eval_vanishing_poly, get_dummy_polys


def bind_constraints(challenger, stark, config, public_inputs, degree_bits: int,
                     num_auxiliary_polys: int, lookup_challenges, ctl_zs_data=None,
                     num_ctl_helpers_per_z=None) -> list[int]:
    """The quotient's alphas, drawn after the constraints' values at
    simulated openings are observed; with ctl_zs_data (a table's CtlZData
    list, values not needed) the CTL checks run on dummy CtlCheckVars
    sliced from those openings (reference prover.py:133-145)."""
    alphas_prime = challenger.get_n_challenges(config.num_challenges)
    pow_degree = max(2, stark.constraint_degree() + 1)
    poly_evals = get_dummy_polys(challenger, stark.COLUMNS, num_auxiliary_polys, pow_degree)
    zeta_prime = challenger.get_extension_challenge(2)
    num_lookup_columns = stark.num_lookup_helper_columns(config)
    dummy_ctl_vars = None
    if ctl_zs_data is not None:
        from plonky2_torch.starky.cross_table_lookup import CtlCheckVars

        dummy_ctl_vars = CtlCheckVars.from_proof(
            ctl_zs_data, poly_evals.auxiliary_polys, poly_evals.auxiliary_polys_next,
            num_lookup_columns, num_ctl_helpers_per_z)
    constraints = compute_eval_vanishing_poly(
        stark, poly_evals, public_inputs, alphas_prime, zeta_prime, degree_bits,
        lookup_challenges=lookup_challenges, num_lookup_columns=num_lookup_columns,
        ctl_vars=dummy_ctl_vars,
    )
    challenger.observe_extension_elements(constraints)
    return challenger.get_n_challenges(config.num_challenges)


def unified_shape(verifier_circuit_fri_params) -> dict:
    """The FRI transcript's unified-shape lengths for a variable-degree
    recursion circuit's FRI params (reference starky/prover.rs:49-73)."""
    if verifier_circuit_fri_params is None:
        return {}
    return {"final_poly_coeff_len": verifier_circuit_fri_params.final_poly_len(),
            "max_num_query_steps": len(verifier_circuit_fri_params.reduction_arity_bits)}


def get_challenges(stark, proof_with_pis: StarkProofWithPublicInputs, config,
                   verifier_circuit_fri_params=None, challenger: Challenger | None = None,
                   observe_instance: bool = True, ctl_challenge_set=None, ctl_zs_data=None,
                   num_ctl_helpers_per_z=None, hasher=None) -> StarkProofChallenges:
    """The proof's challenges; with verifier_circuit_fri_params, its FRI
    transcript in the shape of those params (reference
    get_challenges.rs:73-90). A table of a multi-table proof replays on the
    shared `challenger` (observe_instance=False: its public inputs and trace
    cap were observed before the CTL challenges) with the CTL challenge set
    (its logUp challenges, where it has lookups) and its CtlZData shapes.
    hasher: the transcript's (Poseidon by default)."""
    proof = proof_with_pis.proof
    public_inputs = proof_with_pis.public_inputs
    degree_bits = proof.recover_degree_bits(config)

    challenger = challenger or Challenger(hasher)
    if observe_instance:
        challenger.observe_elements(public_inputs)
        config.observe(challenger)
        challenger.observe_cap(proof.trace_cap)

    lookup_challenge_set, lookup_challenges = ctl_challenge_set, None
    if stark.uses_lookups():
        if lookup_challenge_set is None:
            lookup_challenge_set = get_grand_product_challenge_set(challenger,
                                                                   config.num_challenges)
        lookup_challenges = [ch.beta for ch in lookup_challenge_set.challenges]
    if proof.auxiliary_polys_cap is not None:
        challenger.observe_cap(proof.auxiliary_polys_cap)

    stark_alphas = bind_constraints(challenger, stark, config, public_inputs, degree_bits,
                                    len(proof.openings.auxiliary_polys or []),
                                    lookup_challenges, ctl_zs_data, num_ctl_helpers_per_z)
    if proof.quotient_polys_cap is not None:
        challenger.observe_cap(proof.quotient_polys_cap)
    stark_zeta = challenger.get_extension_challenge(2)

    for batch in proof.openings.to_fri_openings().batches:
        challenger.observe_extension_elements(batch.values)

    return StarkProofChallenges(
        lookup_challenge_set=lookup_challenge_set,
        stark_alphas=stark_alphas,
        stark_zeta=stark_zeta,
        fri_challenges=fri_challenges(
            challenger,
            proof.opening_proof.commit_phase_merkle_caps,
            proof.opening_proof.final_poly,
            proof.opening_proof.pow_witness,
            degree_bits,
            config.fri_config,
            **unified_shape(verifier_circuit_fri_params),
        ),
    )
