"""The STARK verifier on the host (reference starky/src/verifier.rs:30-215;
the reference package's starky/verifier.py), on the port's FRI verifier."""

from __future__ import annotations

from plonky2_torch.field import scalar as fs
from plonky2_torch.fri.verifier import verify_fri_proof
from plonky2_torch.starky.get_challenges import get_challenges
from plonky2_torch.starky.proof import StarkProofWithPublicInputs
from plonky2_torch.starky.vanishing import compute_eval_vanishing_poly


def validate_proof_shape(stark, proof, public_inputs, config, num_ctl_aux: int = 0,
                         num_ctl_zs: int = 0) -> None:
    if len(public_inputs) != stark.PUBLIC_INPUTS:
        raise ValueError("Wrong number of public inputs")
    o = proof.openings
    if len(o.local_values) != stark.COLUMNS or len(o.next_values) != stark.COLUMNS:
        raise ValueError("Wrong number of trace openings")
    num_aux = stark.num_lookup_helper_columns(config) + num_ctl_aux
    if len(o.auxiliary_polys or []) != num_aux or len(o.auxiliary_polys_next or []) != num_aux:
        raise ValueError("Wrong number of auxiliary openings")
    if len(o.ctl_zs_first or []) != num_ctl_zs:
        raise ValueError("Wrong number of CTL Z openings")
    if len(o.quotient_polys or []) != stark.num_quotient_polys(config):
        raise ValueError("Wrong number of quotient openings")
    cap_len = 1 << config.fri_config.cap_height
    for cap in (proof.trace_cap, proof.quotient_polys_cap):
        if cap is not None and len(cap) != cap_len:
            raise ValueError("Wrong Merkle cap length")


def verify_stark_proof(stark, proof_with_pis: StarkProofWithPublicInputs, config,
                       verifier_circuit_fri_params=None, hasher=None) -> None:
    """Raises ValueError where the proof does not verify.
    verifier_circuit_fri_params: those the proof was made with, if any (its
    transcript's unified shape). hasher: the proof's (Poseidon by default)."""
    if len(proof_with_pis.public_inputs) != stark.PUBLIC_INPUTS:
        raise ValueError("Wrong number of public inputs")
    challenges = get_challenges(stark, proof_with_pis, config, verifier_circuit_fri_params,
                                hasher=hasher)
    verify_stark_proof_with_challenges(stark, proof_with_pis.proof, challenges,
                                       proof_with_pis.public_inputs, config, hasher=hasher)


def verify_stark_proof_with_challenges(stark, proof, challenges, public_inputs, config,
                                       ctl_vars=None, hasher=None) -> None:
    """ctl_vars: a table's CtlCheckVars on its openings, in a multi-table
    proof (`cross_table_lookup.verify_multi_table`)."""
    num_ctl_helpers = sum(len(v.helper_columns) for v in ctl_vars) if ctl_vars else 0
    num_ctl_zs = [0] * len(ctl_vars) if ctl_vars else []
    validate_proof_shape(stark, proof, public_inputs, config,
                         num_ctl_helpers + len(num_ctl_zs), len(num_ctl_zs))
    degree_bits = proof.recover_degree_bits(config)

    lookup_challenges = None
    if stark.uses_lookups():
        lookup_challenges = [ch.beta for ch in challenges.lookup_challenge_set.challenges]
    vanishing_polys_zeta = compute_eval_vanishing_poly(
        stark, proof.openings, public_inputs, challenges.stark_alphas,
        challenges.stark_zeta, degree_bits,
        lookup_challenges=lookup_challenges,
        num_lookup_columns=stark.num_lookup_helper_columns(config),
        ctl_vars=ctl_vars,
    )

    # vanishing(ζ) == Z_H(ζ) · t(ζ) per challenge
    zeta_pow_deg = fs.ext_exp(challenges.stark_zeta, 1 << degree_bits)
    z_h_zeta = fs.ext_sub(zeta_pow_deg, fs.ext_one(2))
    qdf = stark.quotient_degree_factor()
    quotient_polys = proof.openings.quotient_polys or []
    for i in range(config.num_challenges):
        chunk = quotient_polys[i * qdf:(i + 1) * qdf]
        t_zeta = fs.ext_zero(2)
        for c in reversed(chunk):
            t_zeta = fs.ext_add(fs.ext_mul(t_zeta, zeta_pow_deg), c)
        if vanishing_polys_zeta[i] != fs.ext_mul(z_h_zeta, t_zeta):
            raise ValueError(
                "Mismatch between evaluation and opening of quotient polynomial"
            )

    merkle_caps = [proof.trace_cap]
    if proof.auxiliary_polys_cap is not None:
        merkle_caps.append(proof.auxiliary_polys_cap)
    if proof.quotient_polys_cap is not None:
        merkle_caps.append(proof.quotient_polys_cap)

    g_root = fs.primitive_root_of_unity(degree_bits)
    verify_fri_proof(
        stark.fri_instance(challenges.stark_zeta, g_root, num_ctl_helpers, num_ctl_zs,
                           config),
        proof.openings.to_fri_openings(),
        challenges.fri_challenges,
        merkle_caps,
        proof.opening_proof,
        config.fri_params(degree_bits),
        hasher,
    )
