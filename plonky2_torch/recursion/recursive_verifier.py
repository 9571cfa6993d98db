"""A proof's and a verifier's targets in a recursion circuit, and their
witness setters (reference recursion/recursive_verifier.rs and
iop/witness.rs `set_proof_with_pis_target`; the reference package's
recursion/recursive_verifier.py:39-142, 327-360). The in-circuit verifier
is not ported: these rebuild the targets of a recursion circuit the
reference built, in its allocation order, and fill them from a proof."""

from __future__ import annotations

from dataclasses import dataclass

from plonky2_torch.fri.recursive_verifier import (
    add_virtual_cap,
    add_virtual_fri_proof,
    set_cap_target,
    set_fri_proof_target,
)


@dataclass
class VerifierCircuitTarget:
    constants_sigmas_cap: list  # 4-target digests
    circuit_digest: list  # 4 targets


@dataclass
class OpeningSetTarget:
    constants: list
    plonk_sigmas: list
    wires: list
    plonk_zs: list
    plonk_zs_next: list
    lookup_zs: list
    next_lookup_zs: list
    partial_products: list
    quotient_polys: list


@dataclass
class ProofTarget:
    wires_cap: list
    plonk_zs_partial_products_cap: list
    quotient_polys_cap: list
    openings: OpeningSetTarget
    opening_proof: object


@dataclass
class ProofWithPublicInputsTarget:
    proof: ProofTarget
    public_inputs: list


def add_virtual_proof_with_pis(builder, common) -> ProofWithPublicInputsTarget:
    """Targets for a proof of `common`'s circuit (without lookups or zero
    knowledge, as the port's proofs are), then its public inputs."""
    if common.num_lookup_polys or common.fri_params.hiding:
        raise ValueError("proofs with lookups or zero knowledge are not ported")
    proof = _add_virtual_proof(builder, common)
    return ProofWithPublicInputsTarget(
        proof=proof, public_inputs=builder.add_virtual_targets(common.num_public_inputs))


def _add_virtual_proof(builder, common) -> ProofTarget:
    cap_height = common.fri_params.config.cap_height
    num_leaves_per_oracle = [common.num_preprocessed_polys(), common.config.num_wires,
                             common.num_zs_partial_products_polys()]
    if common.num_quotient_polys() > 0:
        num_leaves_per_oracle.append(common.num_quotient_polys())
    return ProofTarget(
        wires_cap=add_virtual_cap(builder, cap_height),
        plonk_zs_partial_products_cap=add_virtual_cap(builder, cap_height),
        quotient_polys_cap=add_virtual_cap(builder, cap_height),
        openings=_add_opening_set(builder, common),
        opening_proof=add_virtual_fri_proof(builder, num_leaves_per_oracle,
                                            common.fri_params))


def _add_opening_set(builder, common) -> OpeningSetTarget:
    nc = common.config.num_challenges
    ext = builder.add_virtual_extension_targets
    return OpeningSetTarget(
        constants=ext(common.num_constants),
        plonk_sigmas=ext(common.config.num_routed_wires),
        wires=ext(common.config.num_wires),
        plonk_zs=ext(nc),
        plonk_zs_next=ext(nc),
        lookup_zs=[],
        next_lookup_zs=[],
        partial_products=ext(nc * common.num_partial_products),
        quotient_polys=ext(common.num_quotient_polys()))


def add_virtual_verifier_data(builder, cap_height: int) -> VerifierCircuitTarget:
    return VerifierCircuitTarget(constants_sigmas_cap=add_virtual_cap(builder, cap_height),
                                 circuit_digest=builder.add_virtual_hash())


def set_proof_with_pis_target(pw, proof_t: ProofWithPublicInputsTarget, proof_with_pis) -> None:
    proof = proof_with_pis.proof
    pw.set_targets(proof_t.public_inputs, proof_with_pis.public_inputs)
    set_cap_target(pw, proof_t.proof.wires_cap, proof.wires_cap)
    set_cap_target(pw, proof_t.proof.plonk_zs_partial_products_cap,
                   proof.plonk_zs_partial_products_cap)
    set_cap_target(pw, proof_t.proof.quotient_polys_cap, proof.quotient_polys_cap)
    ot, o = proof_t.proof.openings, proof.openings
    for name in ("constants", "plonk_sigmas", "wires", "plonk_zs", "plonk_zs_next",
                 "partial_products", "quotient_polys"):
        for t, v in zip(getattr(ot, name), getattr(o, name)):
            pw.set_extension_target(t, v)
    set_fri_proof_target(pw, proof_t.proof.opening_proof, proof.opening_proof)


def set_verifier_data_target(pw, vdt: VerifierCircuitTarget, verifier_only) -> None:
    set_cap_target(pw, vdt.constants_sigmas_cap, verifier_only.constants_sigmas_cap)
    pw.set_hash_target(vdt.circuit_digest, verifier_only.circuit_digest)
