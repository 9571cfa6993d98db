"""Conditional recursive verification: a boolean selects one of two proofs
and one of two verifier data, and the circuit verifies the selection
(reference recursion/conditional_recursive_verifier.rs; the reference
package's recursion/conditional_recursive_verifier.py).

Every selection is `builder.select`, one target at a time, in the
reference's order, so the circuit is the reference's row for row.
"""

from __future__ import annotations

from plonky2_torch.fri.recursive_verifier import (
    FriInitialTreeProofTarget,
    FriProofTarget,
    FriQueryRoundTarget,
    FriQueryStepTarget,
    MerkleProofTarget,
)
from plonky2_torch.iop.target import ExtensionTarget
from plonky2_torch.recursion.recursive_verifier import (
    OpeningSetTarget,
    ProofTarget,
    ProofWithPublicInputsTarget,
    VerifierCircuitTarget,
    verify_proof,
)


def _select_vec(builder, b, v0, v1) -> list:
    return [builder.select(b, t0, t1) for t0, t1 in zip(v0, v1)]


def _select_hash(builder, b, h0, h1) -> list:
    return _select_vec(builder, b, h0, h1)


def _select_cap(builder, b, cap0, cap1) -> list:
    if len(cap0) != len(cap1):
        raise ValueError("caps of different heights")
    return [_select_hash(builder, b, h0, h1) for h0, h1 in zip(cap0, cap1)]


def _select_ext(builder, b, e0, e1) -> ExtensionTarget:
    return ExtensionTarget(tuple(builder.select(b, t0, t1) for t0, t1 in zip(e0.parts, e1.parts)))


def _select_vec_ext(builder, b, v0, v1) -> list:
    return [_select_ext(builder, b, e0, e1) for e0, e1 in zip(v0, v1)]


_OPENING_FIELDS = ("constants", "plonk_sigmas", "wires", "plonk_zs", "plonk_zs_next",
                   "lookup_zs", "next_lookup_zs", "partial_products", "quotient_polys")


def _select_opening_set(builder, b, os0, os1) -> OpeningSetTarget:
    return OpeningSetTarget(**{name: _select_vec_ext(builder, b, getattr(os0, name),
                                                     getattr(os1, name))
                               for name in _OPENING_FIELDS})


def _select_merkle_proof(builder, b, p0, p1) -> MerkleProofTarget:
    return MerkleProofTarget(siblings=_select_cap(builder, b, p0.siblings, p1.siblings))


def _select_opening_proof(builder, b, p0: FriProofTarget, p1: FriProofTarget) -> FriProofTarget:
    rounds = []
    for r0, r1 in zip(p0.query_round_proofs, p1.query_round_proofs):
        evals_proofs = [
            (_select_vec(builder, b, e0, e1), _select_merkle_proof(builder, b, m0, m1))
            for (e0, m0), (e1, m1) in zip(r0.initial_trees_proof.evals_proofs,
                                          r1.initial_trees_proof.evals_proofs)]
        steps = [FriQueryStepTarget(
            evals=_select_vec_ext(builder, b, s0.evals, s1.evals),
            merkle_proof=_select_merkle_proof(builder, b, s0.merkle_proof, s1.merkle_proof))
            for s0, s1 in zip(r0.steps, r1.steps)]
        rounds.append(FriQueryRoundTarget(
            initial_trees_proof=FriInitialTreeProofTarget(evals_proofs=evals_proofs),
            steps=steps))
    return FriProofTarget(
        commit_phase_merkle_caps=[_select_cap(builder, b, c0, c1) for c0, c1 in zip(
            p0.commit_phase_merkle_caps, p1.commit_phase_merkle_caps)],
        query_round_proofs=rounds,
        final_poly=_select_vec_ext(builder, b, p0.final_poly, p1.final_poly),
        pow_witness=builder.select(b, p0.pow_witness, p1.pow_witness))


def select_proof_with_pis(builder, b, pwp0: ProofWithPublicInputsTarget,
                          pwp1: ProofWithPublicInputsTarget) -> ProofWithPublicInputsTarget:
    """b ? pwp0 : pwp1 (reference conditional_recursive_verifier.rs:68-121)."""
    p0, p1 = pwp0.proof, pwp1.proof
    return ProofWithPublicInputsTarget(
        proof=ProofTarget(
            wires_cap=_select_cap(builder, b, p0.wires_cap, p1.wires_cap),
            plonk_zs_partial_products_cap=_select_cap(
                builder, b, p0.plonk_zs_partial_products_cap, p1.plonk_zs_partial_products_cap),
            quotient_polys_cap=_select_cap(builder, b, p0.quotient_polys_cap,
                                           p1.quotient_polys_cap),
            openings=_select_opening_set(builder, b, p0.openings, p1.openings),
            opening_proof=_select_opening_proof(builder, b, p0.opening_proof,
                                                p1.opening_proof)),
        public_inputs=_select_vec(builder, b, pwp0.public_inputs, pwp1.public_inputs))


def select_verifier_data(builder, b, vd0: VerifierCircuitTarget,
                         vd1: VerifierCircuitTarget) -> VerifierCircuitTarget:
    return VerifierCircuitTarget(
        constants_sigmas_cap=_select_cap(builder, b, vd0.constants_sigmas_cap,
                                         vd1.constants_sigmas_cap),
        circuit_digest=_select_hash(builder, b, vd0.circuit_digest, vd1.circuit_digest))


def conditionally_verify_proof(builder, condition, pwp0, vd0, pwp1, vd1, inner_common) -> None:
    """Verify pwp0 against vd0 where `condition`, else pwp1 against vd1
    (reference conditional_recursive_verifier.rs:24-41)."""
    selected_proof = select_proof_with_pis(builder, condition, pwp0, pwp1)
    selected_vd = select_verifier_data(builder, condition, vd0, vd1)
    verify_proof(builder, selected_proof, selected_vd, inner_common)


def conditionally_verify_proof_or_dummy(builder, condition, proof_with_pis, inner_verifier_data,
                                        inner_common, device=None) -> None:
    """Verify `proof_with_pis` where `condition`, else a dummy proof of
    `inner_common`'s shape, built and proved on `device` (reference
    conditional_recursive_verifier.rs:44-64)."""
    from plonky2_torch.recursion import dummy_circuit

    dummy_pt, dummy_vdt = dummy_circuit.dummy_proof_and_vk(builder, inner_common, device)
    conditionally_verify_proof(builder, condition, proof_with_pis, inner_verifier_data,
                               dummy_pt, dummy_vdt, inner_common)
