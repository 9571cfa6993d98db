"""The verifier of a proof in a circuit: the proof's and the verifier
data's targets, the transcript replayed on builder targets, the vanishing
polynomial at ζ and the FRI check, and the witness setters (reference
recursion/recursive_verifier.rs, plonk/get_challenges.rs and
iop/witness.rs `set_proof_with_pis_target`; the reference package's
recursion/recursive_verifier.py).

The vanishing polynomial is the host verifier's ops-generic
`eval_vanishing_poly` on `CircuitOps`, so the circuit checks the gate
constraints in the order the prover and the verifier compute them. Over
a circuit with LUTs the transcript draws the lookup deltas, each LUT's
polynomial is evaluated in the circuit (`eval_lut_poly_circuit`, before
the vanishing polynomial, as the reference adds its targets) and the
lookup columns' openings join the Zs-partial-products oracle's leaves.
A zero-knowledge proof's salted oracles give leaves SALT_SIZE wider; the
FRI check strips the salt.
"""

from __future__ import annotations

from dataclasses import dataclass

from plonky2_torch.field import scalar as fs
from plonky2_torch.fri.recursive_verifier import (
    FriChallengesTarget,
    add_virtual_cap,
    add_virtual_fri_proof,
    set_cap_target,
    set_fri_proof_target,
    verify_fri_proof,
)
from plonky2_torch.fri.proof import SALT_SIZE
from plonky2_torch.fri.structure import FriBatchInfo, FriInstanceInfo, FriOpeningBatch, FriOpenings
from plonky2_torch.gadgets.reducing import ReducingFactorTarget
from plonky2_torch.gates.ops import CircuitOps, EvaluationVars
from plonky2_torch.iop.target import ExtensionTarget
from plonky2_torch.plonk.vanishing_poly import (
    NUM_COINS_LOOKUP,
    eval_lut_poly_circuit,
    eval_vanishing_poly,
)
from plonky2_torch.recursion.recursive_challenger import RecursiveChallenger


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

    def to_fri_openings(self) -> FriOpenings:
        """The openings at ζ, then at g · ζ (reference plonk/proof.rs)."""
        return FriOpenings(batches=[
            FriOpeningBatch(values=(self.constants + self.plonk_sigmas + self.wires
                                    + self.plonk_zs + self.partial_products
                                    + self.quotient_polys + self.lookup_zs)),
            FriOpeningBatch(values=self.plonk_zs_next + self.next_lookup_zs)])


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


@dataclass
class ProofChallengesTarget:
    plonk_betas: list
    plonk_gammas: list
    plonk_alphas: list
    plonk_deltas: list
    plonk_zeta: ExtensionTarget
    fri_challenges: FriChallengesTarget


def add_virtual_proof_with_pis(builder, common) -> ProofWithPublicInputsTarget:
    """Targets for a proof of `common`'s circuit, then its public inputs."""
    proof = _add_virtual_proof(builder, common)
    return ProofWithPublicInputsTarget(
        proof=proof, public_inputs=builder.add_virtual_targets(common.num_public_inputs))


def _add_virtual_proof(builder, common) -> ProofTarget:
    cap_height = common.fri_params.config.cap_height
    salt = SALT_SIZE if common.fri_params.hiding else 0
    num_leaves_per_oracle = [common.num_preprocessed_polys(), common.config.num_wires + salt,
                             common.num_zs_partial_products_polys()
                             + common.num_all_lookup_polys() + salt]
    if common.num_quotient_polys() > 0:
        num_leaves_per_oracle.append(common.num_quotient_polys() + salt)
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
        lookup_zs=ext(common.num_all_lookup_polys()),
        next_lookup_zs=ext(common.num_all_lookup_polys()),
        partial_products=ext(nc * common.num_partial_products),
        quotient_polys=ext(common.num_quotient_polys()))


def add_virtual_verifier_data(builder, cap_height: int) -> VerifierCircuitTarget:
    return VerifierCircuitTarget(constants_sigmas_cap=add_virtual_cap(builder, cap_height),
                                 circuit_digest=builder.add_virtual_hash())


# -- the transcript in the circuit (reference plonk/get_challenges.rs) -------------

def _observe_fri_params(builder, challenger, fri_params) -> None:
    """The FRI parameters as constants, in the order of the host's
    `FriParams.observe`."""
    c = builder.constant
    cfg = fri_params.config
    challenger.observe_element(c(cfg.rate_bits))
    challenger.observe_element(c(cfg.cap_height))
    challenger.observe_element(c(cfg.proof_of_work_bits))
    challenger.observe_elements([c(v) for v in cfg.reduction_strategy.serialize_felts()])
    challenger.observe_element(c(cfg.num_query_rounds))
    challenger.observe_element(c(1 if fri_params.hiding else 0))
    challenger.observe_element(c(fri_params.degree_bits))
    challenger.observe_elements([c(v) for v in fri_params.reduction_arity_bits])


def get_challenges_target(builder, proof_t: ProofTarget, public_inputs_hash, circuit_digest,
                          common) -> ProofChallengesTarget:
    nc = common.config.num_challenges
    challenger = RecursiveChallenger(builder)
    _observe_fri_params(builder, challenger, common.fri_params)
    challenger.observe_hash(circuit_digest)
    challenger.observe_hash(public_inputs_hash)

    challenger.observe_cap(proof_t.wires_cap)
    plonk_betas = challenger.get_n_challenges(nc)
    plonk_gammas = challenger.get_n_challenges(nc)
    plonk_deltas = []
    if common.num_lookup_polys:
        plonk_deltas = (plonk_betas + plonk_gammas
                        + challenger.get_n_challenges((NUM_COINS_LOOKUP - 2) * nc))
    challenger.observe_cap(proof_t.plonk_zs_partial_products_cap)
    plonk_alphas = challenger.get_n_challenges(nc)
    challenger.observe_cap(proof_t.quotient_polys_cap)
    plonk_zeta = challenger.get_extension_challenge()
    for batch in proof_t.openings.to_fri_openings().batches:
        challenger.observe_extension_elements(batch.values)

    # the FRI challenges (reference fri/challenges.rs)
    fri_alpha = challenger.get_extension_challenge()
    fri_betas = []
    for cap in proof_t.opening_proof.commit_phase_merkle_caps:
        challenger.observe_cap(cap)
        fri_betas.append(challenger.get_extension_challenge())
    challenger.observe_extension_elements(proof_t.opening_proof.final_poly)
    challenger.observe_element(proof_t.opening_proof.pow_witness)
    fri_pow_response = challenger.get_challenge()
    fri_query_indices = challenger.get_n_challenges(common.config.fri_config.num_query_rounds)
    return ProofChallengesTarget(
        plonk_betas=plonk_betas, plonk_gammas=plonk_gammas, plonk_alphas=plonk_alphas,
        plonk_deltas=plonk_deltas, plonk_zeta=plonk_zeta,
        fri_challenges=FriChallengesTarget(fri_alpha=fri_alpha, fri_betas=fri_betas,
                                           fri_pow_response=fri_pow_response,
                                           fri_query_indices=fri_query_indices))


def _get_fri_instance_target(builder, common, zeta: ExtensionTarget) -> FriInstanceInfo:
    """`common.get_fri_instance` with the points as targets."""
    zeta_next = builder.mul_const_extension(fs.primitive_root_of_unity(common.degree_bits),
                                            zeta)
    return FriInstanceInfo(oracles=common.fri_oracles(), batches=[
        FriBatchInfo(point=zeta, polynomials=common.fri_all_polys()),
        FriBatchInfo(point=zeta_next, polynomials=common.fri_next_batch_polys())])


# -- verification ------------------------------------------------------------------

def verify_proof(builder, proof_with_pis: ProofWithPublicInputsTarget,
                 inner_verifier_data: VerifierCircuitTarget, inner_common) -> None:
    """Constrain the circuit to accept `proof_with_pis` as a proof of the
    inner circuit (reference recursion/recursive_verifier.rs:18-39)."""
    if len(proof_with_pis.public_inputs) != inner_common.num_public_inputs:
        raise ValueError("the public inputs do not match the inner circuit")
    public_inputs_hash = builder.hash_n_to_hash_no_pad(list(proof_with_pis.public_inputs))
    challenges = get_challenges_target(builder, proof_with_pis.proof, public_inputs_hash,
                                       inner_verifier_data.circuit_digest, inner_common)
    _verify_proof_with_challenges(builder, proof_with_pis.proof, public_inputs_hash,
                                  challenges, inner_verifier_data, inner_common)


def _verify_proof_with_challenges(builder, proof_t: ProofTarget, public_inputs_hash,
                                  challenges: ProofChallengesTarget, inner_verifier_data,
                                  common) -> None:
    one = builder.one_extension()
    openings = proof_t.openings
    zeta = challenges.plonk_zeta
    lift = builder.convert_to_ext
    vars = EvaluationVars(openings.constants, openings.wires,
                          [lift(h) for h in public_inputs_hash])

    zeta_pow_deg = builder.exp_power_of_2_extension(zeta, common.degree_bits)
    z_h_zeta = builder.sub_extension(zeta_pow_deg, one)
    # L_0(ζ) = Z_H(ζ) / (n (ζ - 1))
    denom = builder.mul_const_extension(common.degree % fs.P, builder.sub_extension(zeta, one))
    l_0_zeta = builder.div_extension(z_h_zeta, denom)
    deltas = challenges.plonk_deltas
    lut_re_evals = [[lift(eval_lut_poly_circuit(
        builder, common, k, deltas[NUM_COINS_LOOKUP * c:NUM_COINS_LOOKUP * (c + 1)]))
        for k in range(len(common.luts))]
        for c in range(common.config.num_challenges)] if deltas else []
    vanishing_polys_zeta = eval_vanishing_poly(
        CircuitOps(builder), common, zeta, vars, openings.plonk_zs, openings.plonk_zs_next,
        openings.partial_products, openings.plonk_sigmas,
        [lift(b) for b in challenges.plonk_betas], [lift(g) for g in challenges.plonk_gammas],
        [lift(a) for a in challenges.plonk_alphas], l_0_zeta, openings.lookup_zs,
        openings.next_lookup_zs, [lift(d) for d in deltas], lut_re_evals)

    # each challenge's vanishing value = Z_H(ζ) · t(ζ), t's chunks
    # recombined with powers of ζ^n
    qdf = common.quotient_degree_factor
    scale = ReducingFactorTarget(zeta_pow_deg)
    for i in range(common.config.num_challenges):
        recombined = scale.reduce(openings.quotient_polys[i * qdf:(i + 1) * qdf], builder)
        builder.connect_extension(vanishing_polys_zeta[i],
                                  builder.mul_extension(z_h_zeta, recombined))

    merkle_caps = [inner_verifier_data.constants_sigmas_cap, proof_t.wires_cap,
                   proof_t.plonk_zs_partial_products_cap, proof_t.quotient_polys_cap]
    verify_fri_proof(builder, _get_fri_instance_target(builder, common, zeta),
                     openings.to_fri_openings(), challenges.fri_challenges, merkle_caps,
                     proof_t.opening_proof, common.fri_params)


# -- witness setters ---------------------------------------------------------------

def set_proof_with_pis_target(pw, proof_t: ProofWithPublicInputsTarget, proof_with_pis) -> None:
    proof = proof_with_pis.proof
    pw.set_targets(proof_t.public_inputs, proof_with_pis.public_inputs)
    set_cap_target(pw, proof_t.proof.wires_cap, proof.wires_cap)
    set_cap_target(pw, proof_t.proof.plonk_zs_partial_products_cap,
                   proof.plonk_zs_partial_products_cap)
    set_cap_target(pw, proof_t.proof.quotient_polys_cap, proof.quotient_polys_cap)
    ot, o = proof_t.proof.openings, proof.openings
    for targets, values in ((ot.constants, o.constants), (ot.plonk_sigmas, o.plonk_sigmas),
                            (ot.wires, o.wires), (ot.plonk_zs, o.plonk_zs),
                            (ot.plonk_zs_next, o.plonk_zs_next), (ot.lookup_zs, o.lookup_zs),
                            (ot.next_lookup_zs, o.lookup_zs_next),
                            (ot.partial_products, o.partial_products),
                            (ot.quotient_polys, o.quotient_polys)):
        for t, v in zip(targets, values):
            pw.set_extension_target(t, v)
    set_fri_proof_target(pw, proof_t.proof.opening_proof, proof.opening_proof)


def set_verifier_data_target(pw, vdt: VerifierCircuitTarget, verifier_only) -> None:
    set_cap_target(pw, vdt.constants_sigmas_cap, verifier_only.constants_sigmas_cap)
    pw.set_hash_target(vdt.circuit_digest, verifier_only.circuit_digest)
