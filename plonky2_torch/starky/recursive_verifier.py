"""STARK -> SNARK recursion: a STARK proof verified inside a Plonky2 circuit
(reference starky/src/recursive_verifier.rs:32-315; the reference package's
starky/recursive_verifier.py).

The AIR's constraints are evaluated in the circuit by the same ops-generic
`Stark.eval` and `eval_lookups` that the prover and the host verifier run,
on `CircuitOps`, so their op order is the prover's by construction. A
circuit verifies proofs of one degree, or, with `min_degree_bits_to_support`
and a proof target made `with_degree_target=True`, of any degree in a
range: the proof then carries its degree bits as a target, the selectors,
Z_H and the subgroup generator are computed from it in the circuit, and
FRI runs `verify_fri_proof_with_multiple_degree_bits` (such proofs are made
with `verifier_circuit_fri_params`, so that their transcript has the
circuit's shape). A table of a multi-table proof is verified against
challenges drawn on a shared transcript, with its CTL checks (`ctl_vars`)
and its CTL Zs opened at 1 (`cross_table_lookup.verify_multi_table_circuit`).

    pt = add_virtual_stark_proof_with_pis(builder, stark, config, degree_bits)
    verify_stark_proof_circuit(builder, stark, pt, config, degree_bits)
    set_stark_proof_with_pis_target(pw, pt, proof)
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
    verify_fri_proof_with_multiple_degree_bits,
)
from plonky2_torch.fri.structure import (
    FriBatchInfo,
    FriInstanceInfo,
    FriOpeningBatch,
    FriOpenings,
    FriOracleInfo,
    FriPolynomialInfo,
)
from plonky2_torch.gadgets.reducing import ReducingFactorTarget
from plonky2_torch.gates.ops import CircuitOps
from plonky2_torch.recursion.recursive_challenger import RecursiveChallenger
from plonky2_torch.starky.constraint_consumer import ConstraintConsumer
from plonky2_torch.starky.evaluation_frame import StarkFrame
from plonky2_torch.starky.lookup import LookupCheckVars, eval_lookups


@dataclass
class StarkOpeningSetTarget:
    local_values: list
    next_values: list
    auxiliary_polys: list | None
    auxiliary_polys_next: list | None
    ctl_zs_first: list | None
    quotient_polys: list | None

    def to_fri_openings(self, builder=None) -> FriOpenings:
        """The batches at ζ and g·ζ, and the CTL Zs at 1 lifted to the
        extension (the builder lifts them)."""
        batches = [
            FriOpeningBatch(values=(list(self.local_values) + list(self.auxiliary_polys or [])
                                    + list(self.quotient_polys or []))),
            FriOpeningBatch(values=list(self.next_values)
                            + list(self.auxiliary_polys_next or []))]
        if self.ctl_zs_first is not None:
            if builder is None:
                raise ValueError("the CTL batch needs the builder to lift its targets")
            batches.append(FriOpeningBatch(
                values=[builder.convert_to_ext(t) for t in self.ctl_zs_first]))
        return FriOpenings(batches=batches)


@dataclass
class StarkProofTarget:
    trace_cap: list
    auxiliary_polys_cap: list | None
    quotient_polys_cap: list | None
    openings: StarkOpeningSetTarget
    opening_proof: object
    # the proof's degree bits as a target, for variable-degree verification
    degree_bits: object = None


@dataclass
class StarkProofWithPublicInputsTarget:
    proof: StarkProofTarget
    public_inputs: list


@dataclass
class StarkProofChallengesTarget:
    stark_alphas: list
    stark_zeta: object
    fri_challenges: FriChallengesTarget
    lookup_challenge_set: list | None = None  # [(beta, gamma)] targets


# -- the proof's targets and their witness ----------------------------------------

def add_virtual_stark_proof_with_pis(builder, stark, config, degree_bits: int,
                                     with_degree_target: bool = False,
                                     num_ctl_helper_zs: int = 0,
                                     num_ctl_zs: int = 0) -> StarkProofWithPublicInputsTarget:
    proof = add_virtual_stark_proof(builder, stark, config, degree_bits, with_degree_target,
                                    num_ctl_helper_zs, num_ctl_zs)
    return StarkProofWithPublicInputsTarget(
        proof=proof, public_inputs=builder.add_virtual_targets(stark.PUBLIC_INPUTS))


def add_virtual_stark_proof(builder, stark, config, degree_bits: int,
                            with_degree_target: bool = False, num_ctl_helper_zs: int = 0,
                            num_ctl_zs: int = 0) -> StarkProofTarget:
    """The targets of a STARK proof of 2^degree_bits rows, in the
    reference's allocation order (recursive_verifier.rs:238-280).
    num_ctl_helper_zs (CTL helper and Z columns) and num_ctl_zs (CTL Zs)
    size the CTL part of the auxiliary oracle and the openings at 1."""
    fri_params = config.fri_params(degree_bits)
    cap_height = fri_params.config.cap_height
    num_quotient = stark.num_quotient_polys(config)
    num_aux = stark.num_lookup_helper_columns(config) + num_ctl_helper_zs
    num_leaves_per_oracle = [stark.COLUMNS]
    if num_aux > 0:
        num_leaves_per_oracle.append(num_aux)
    if num_quotient > 0:
        num_leaves_per_oracle.append(num_quotient)
    return StarkProofTarget(
        trace_cap=add_virtual_cap(builder, cap_height),
        auxiliary_polys_cap=add_virtual_cap(builder, cap_height) if num_aux else None,
        quotient_polys_cap=add_virtual_cap(builder, cap_height) if num_quotient else None,
        openings=StarkOpeningSetTarget(
            local_values=builder.add_virtual_extension_targets(stark.COLUMNS),
            next_values=builder.add_virtual_extension_targets(stark.COLUMNS),
            auxiliary_polys=builder.add_virtual_extension_targets(num_aux) if num_aux else None,
            auxiliary_polys_next=(builder.add_virtual_extension_targets(num_aux)
                                  if num_aux else None),
            ctl_zs_first=builder.add_virtual_targets(num_ctl_zs) if num_ctl_zs else None,
            quotient_polys=builder.add_virtual_extension_targets(num_quotient)),
        opening_proof=add_virtual_fri_proof(builder, num_leaves_per_oracle, fri_params),
        degree_bits=builder.add_virtual_target() if with_degree_target else None)


def set_stark_proof_with_pis_target(pw, proof_t: StarkProofWithPublicInputsTarget,
                                    proof_with_pis, pis_degree_bits: int | None = None) -> None:
    """Fill the targets from a proof; a variable-degree target takes the
    proof's degree bits, and a smaller proof's FRI targets are zero-padded."""
    proof = proof_with_pis.proof
    if proof_t.proof.degree_bits is not None:
        if pis_degree_bits is None:
            raise ValueError("a variable-degree proof target needs the proof's degree bits")
        pw.set_target(proof_t.proof.degree_bits, pis_degree_bits)
    pw.set_targets(proof_t.public_inputs, proof_with_pis.public_inputs)
    set_cap_target(pw, proof_t.proof.trace_cap, proof.trace_cap)
    if proof_t.proof.auxiliary_polys_cap is not None:
        set_cap_target(pw, proof_t.proof.auxiliary_polys_cap, proof.auxiliary_polys_cap)
    if proof_t.proof.quotient_polys_cap is not None:
        set_cap_target(pw, proof_t.proof.quotient_polys_cap, proof.quotient_polys_cap)
    ot, o = proof_t.proof.openings, proof.openings
    for targets, values in ((ot.local_values, o.local_values),
                            (ot.next_values, o.next_values),
                            (ot.auxiliary_polys or [], o.auxiliary_polys or []),
                            (ot.auxiliary_polys_next or [], o.auxiliary_polys_next or [])):
        for t, v in zip(targets, values):
            pw.set_extension_target(t, v)
    if ot.ctl_zs_first is not None:
        pw.set_targets(ot.ctl_zs_first, o.ctl_zs_first)
    for t, v in zip(ot.quotient_polys or [], o.quotient_polys or []):
        pw.set_extension_target(t, v)
    set_fri_proof_target(pw, proof_t.proof.opening_proof, proof.opening_proof)


# -- the transcript in the circuit ---------------------------------------------------

def _observe_stark_config(builder, challenger, config) -> None:
    c = builder.constant
    challenger.observe_element(c(config.security_bits))
    challenger.observe_element(c(config.num_challenges))
    cfg = config.fri_config
    challenger.observe_element(c(cfg.rate_bits))
    challenger.observe_element(c(cfg.cap_height))
    challenger.observe_element(c(cfg.proof_of_work_bits))
    challenger.observe_elements([c(v) for v in cfg.reduction_strategy.serialize_felts()])
    challenger.observe_element(c(cfg.num_query_rounds))


def _get_dummy_polys_target(builder, challenger, num_trace_polys: int, num_aux_polys: int,
                            pow_degree: int) -> StarkOpeningSetTarget:
    """The simulated openings of the constraint binding, as the host's
    `vanishing.get_dummy_polys` draws them."""
    log_pow_degree = (pow_degree - 1).bit_length()
    num_extension_powers = max(1, 50 // log_pow_degree - 1)
    total = num_trace_polys * 2 + num_aux_polys * 2
    num_zetas = (total + num_extension_powers - 1) // num_extension_powers
    nb_dummy_per_zeta = min(num_extension_powers + 1, total)
    evals = []
    for zeta in challenger.get_n_extension_challenges(num_zetas):
        cur = zeta
        for _ in range(nb_dummy_per_zeta):
            evals.append(cur)
            cur = builder.exp_u64_extension(cur, pow_degree)
    next_start = num_trace_polys
    aux_start = num_trace_polys * 2
    aux_next_start = aux_start + num_aux_polys
    is_aux = num_aux_polys > 0
    return StarkOpeningSetTarget(
        local_values=evals[:next_start],
        next_values=evals[next_start:aux_start],
        auxiliary_polys=evals[aux_start:aux_next_start] if is_aux else None,
        auxiliary_polys_next=evals[aux_next_start:] if is_aux else None,
        ctl_zs_first=None,
        quotient_polys=None)


def _variable_degree_data(builder, max_degree_bits: int, degree_bits_t, zeta_t):
    """From the degree-bits target: the degree, its bits, ζ^degree, Z_H(ζ)
    and the subgroup generator g = POWER_OF_TWO_GENERATOR^(2^(TWO_ADICITY -
    degree_bits)) (reference starky vanishing_poly.rs:223-241)."""
    one = builder.one_extension()
    two = builder.two()
    max_bits = max_degree_bits + 1
    degree = builder.exp(two, degree_bits_t, max_bits)
    degree_bits_vec = builder.split_le(degree, max_bits)
    zeta_pow_deg = builder.exp_extension_from_bits(zeta_t, degree_bits_vec)
    z_h = builder.sub_extension(zeta_pow_deg, one)
    two_adicity_sub = builder.sub(builder.constant(fs.TWO_ADICITY), degree_bits_t)
    pow2 = builder.exp(two, two_adicity_sub, fs.TWO_ADICITY)
    g_t = builder.exp(builder.constant(fs.POWER_OF_TWO_GENERATOR), pow2, fs.TWO_ADICITY)
    return degree, degree_bits_vec, zeta_pow_deg, z_h, g_t


def compute_eval_vanishing_poly_circuit(builder, stark, openings_t, public_inputs_t, alphas_t,
                                        zeta_t, degree_bits: int, lookup_challenges_t=None,
                                        num_lookup_columns: int = 0, degree_bits_target=None,
                                        ctl_vars=None) -> list:
    """The α-combined constraints at ζ in the circuit (reference
    vanishing_poly.rs:194+), one per α; with degree_bits_target the
    selectors and Z_H take the degree the proof carries; ctl_vars: the
    table's CtlCheckVars on these targets."""
    ops = CircuitOps(builder)
    one = builder.one_extension()
    if degree_bits_target is None:
        n = 1 << degree_bits
        g = fs.primitive_root_of_unity(degree_bits)
        zeta_pow_deg = builder.exp_power_of_2_extension(zeta_t, degree_bits)
        z_h = builder.sub_extension(zeta_pow_deg, one)
        d0 = builder.mul_const_extension(n % fs.P, builder.sub_extension(zeta_t, one))
        gz = builder.mul_const_extension(g, zeta_t)
        d1 = builder.mul_const_extension(n % fs.P, builder.sub_extension(gz, one))
        l_0 = builder.div_extension(z_h, d0)
        l_last = builder.div_extension(z_h, d1)
        z_last = builder.sub_extension(zeta_t, builder.constant_extension(fs.inverse(g)))
    else:
        degree, _, _, z_h, g_t = _variable_degree_data(builder, degree_bits,
                                                       degree_bits_target, zeta_t)
        degree_ext = builder.convert_to_ext(degree)
        g_ext = builder.convert_to_ext(g_t)
        d0 = builder.mul_extension(degree_ext, builder.sub_extension(zeta_t, one))
        gz = builder.mul_extension(g_ext, zeta_t)
        d1 = builder.mul_extension(degree_ext, builder.sub_extension(gz, one))
        l_0 = builder.div_extension(z_h, d0)
        l_last = builder.div_extension(z_h, d1)
        z_last = builder.sub_extension(zeta_t, builder.inverse_extension(g_ext))
    consumer = ConstraintConsumer(ops, [builder.convert_to_ext(a) for a in alphas_t],
                                  z_last, l_0, l_last)
    frame = StarkFrame(openings_t.local_values, openings_t.next_values,
                       [builder.convert_to_ext(p) for p in public_inputs_t])
    stark.eval(ops, frame, consumer)
    if lookup_challenges_t is not None:
        lookup_vars = LookupCheckVars(
            (openings_t.auxiliary_polys or [])[:num_lookup_columns],
            (openings_t.auxiliary_polys_next or [])[:num_lookup_columns],
            [builder.convert_to_ext(c) for c in lookup_challenges_t])
        eval_lookups(ops, stark, frame, lookup_vars, consumer)
    if ctl_vars is not None:
        from plonky2_torch.starky.cross_table_lookup import eval_cross_table_lookup_checks

        eval_cross_table_lookup_checks(ops, frame, ctl_vars, consumer, stark.constraint_degree())
    return consumer.accumulators()


def _get_challenges_target(builder, stark, proof_with_pis_t, config, degree_bits: int,
                           degree_bits_target=None, challenger=None,
                           observe_instance: bool = True, ctl_challenge_set=None,
                           ctl_zs_data=None,
                           num_ctl_helpers_per_z=None) -> StarkProofChallengesTarget:
    """The proof's transcript replayed by a `RecursiveChallenger`, in the
    host's `get_challenges` order (the lookup challenge sets included); a
    table of a multi-table proof replays on the shared challenger with the
    CTL challenge set (a GrandProductChallengeSet of targets) and its
    CtlZData shapes, as the host's does."""
    proof_t = proof_with_pis_t.proof
    nc = config.num_challenges
    challenger = challenger or RecursiveChallenger(builder)
    if observe_instance:
        challenger.observe_elements(proof_with_pis_t.public_inputs)
        _observe_stark_config(builder, challenger, config)
        challenger.observe_cap(proof_t.trace_cap)
    lookup_challenge_set = lookup_betas = None
    if ctl_challenge_set is not None:
        lookup_challenge_set = [(ch.beta, ch.gamma) for ch in ctl_challenge_set.challenges]
    num_lookup_columns = stark.num_lookup_helper_columns(config)
    if stark.uses_lookups():
        if lookup_challenge_set is None:
            lookup_challenge_set = [(challenger.get_challenge(), challenger.get_challenge())
                                    for _ in range(nc)]
        lookup_betas = [beta for beta, _ in lookup_challenge_set]
    if proof_t.auxiliary_polys_cap is not None:
        challenger.observe_cap(proof_t.auxiliary_polys_cap)
    stark_alphas_prime = challenger.get_n_challenges(nc)

    pow_degree = max(2, stark.constraint_degree() + 1)
    poly_evals = _get_dummy_polys_target(builder, challenger, stark.COLUMNS,
                                         len(proof_t.openings.auxiliary_polys or []),
                                         pow_degree)
    zeta_prime = challenger.get_extension_challenge()
    dummy_ctl_vars = None
    if ctl_zs_data is not None:
        from plonky2_torch.starky.cross_table_lookup import CtlCheckVars

        dummy_ctl_vars = CtlCheckVars.from_proof(
            ctl_zs_data, poly_evals.auxiliary_polys, poly_evals.auxiliary_polys_next,
            num_lookup_columns, num_ctl_helpers_per_z)
    constraint_evals = compute_eval_vanishing_poly_circuit(
        builder, stark, poly_evals, proof_with_pis_t.public_inputs, stark_alphas_prime,
        zeta_prime, degree_bits, lookup_challenges_t=lookup_betas,
        num_lookup_columns=num_lookup_columns, degree_bits_target=degree_bits_target,
        ctl_vars=dummy_ctl_vars)
    challenger.observe_extension_elements(constraint_evals)

    stark_alphas = challenger.get_n_challenges(nc)
    if proof_t.quotient_polys_cap is not None:
        challenger.observe_cap(proof_t.quotient_polys_cap)
    stark_zeta = challenger.get_extension_challenge()
    for batch in proof_t.openings.to_fri_openings(builder).batches:
        challenger.observe_extension_elements(batch.values)

    fri_alpha = challenger.get_extension_challenge()
    fri_betas = []
    for cap in proof_t.opening_proof.commit_phase_merkle_caps:
        challenger.observe_cap(cap)
        fri_betas.append(challenger.get_extension_challenge())
    challenger.observe_extension_elements(proof_t.opening_proof.final_poly)
    challenger.observe_element(proof_t.opening_proof.pow_witness)
    fri_pow_response = challenger.get_challenge()
    fri_query_indices = challenger.get_n_challenges(config.fri_config.num_query_rounds)
    return StarkProofChallengesTarget(
        stark_alphas=stark_alphas, stark_zeta=stark_zeta,
        fri_challenges=FriChallengesTarget(fri_alpha=fri_alpha, fri_betas=fri_betas,
                                           fri_pow_response=fri_pow_response,
                                           fri_query_indices=fri_query_indices),
        lookup_challenge_set=lookup_challenge_set)


def _fri_instance_target(builder, stark, zeta_t, g, config, num_ctl_helpers: int = 0,
                         num_ctl_zs: int = 0) -> FriInstanceInfo:
    """The FRI instance at ζ and g·ζ, and, with CTLs, the CTL Zs at 1; g is
    the subgroup generator, a constant, or an ExtensionTarget in the
    variable-degree mode."""
    oracles = [FriOracleInfo(stark.COLUMNS, False)]
    trace_info = FriPolynomialInfo.from_range(0, range(stark.COLUMNS))
    aux_info = quotient_info = []
    num_lookup = stark.num_lookup_helper_columns(config)
    num_aux = num_lookup + num_ctl_helpers + num_ctl_zs
    if num_aux > 0:
        aux_info = FriPolynomialInfo.from_range(len(oracles), range(num_aux))
        oracles.append(FriOracleInfo(num_aux, False))
    num_quotient = stark.num_quotient_polys(config)
    if num_quotient > 0:
        quotient_info = FriPolynomialInfo.from_range(len(oracles), range(num_quotient))
        oracles.append(FriOracleInfo(num_quotient, False))
    zeta_batch = FriBatchInfo(point=zeta_t, polynomials=trace_info + aux_info + quotient_info)
    zeta_next = (builder.mul_const_extension(g, zeta_t) if isinstance(g, int)
                 else builder.mul_extension(g, zeta_t))
    zeta_next_batch = FriBatchInfo(point=zeta_next, polynomials=trace_info + aux_info)
    batches = [zeta_batch, zeta_next_batch]
    if num_ctl_zs > 0:
        ctl_zs_info = FriPolynomialInfo.from_range(
            1, range(num_lookup + num_ctl_helpers, num_aux))
        batches.append(FriBatchInfo(point=builder.one_extension(), polynomials=ctl_zs_info))
    return FriInstanceInfo(oracles=oracles, batches=batches)


# -- verification ----------------------------------------------------------------------

def verify_stark_proof_circuit(builder, stark, proof_with_pis_t, inner_config, degree_bits: int,
                               min_degree_bits_to_support: int | None = None) -> None:
    """Verify a STARK proof of 2^degree_bits rows in the circuit (reference
    recursive_verifier.rs:32-76); with min_degree_bits_to_support, of any
    degree in [min_degree_bits_to_support, degree_bits] (reference
    recursive_verifier.rs:77-208)."""
    if len(proof_with_pis_t.public_inputs) != stark.PUBLIC_INPUTS:
        raise ValueError("Wrong number of public inputs")
    proof_t = proof_with_pis_t.proof
    degree_bits_t = None
    if min_degree_bits_to_support is not None:
        degree_bits_t = proof_t.degree_bits
        if degree_bits_t is None:
            raise ValueError("variable-degree verification needs add_virtual_stark_proof_"
                             "with_pis(..., with_degree_target=True)")
    challenges = _get_challenges_target(builder, stark, proof_with_pis_t, inner_config,
                                        degree_bits, degree_bits_target=degree_bits_t)
    verify_stark_proof_with_challenges_circuit(
        builder, stark, proof_t, proof_with_pis_t.public_inputs, challenges, inner_config,
        degree_bits, min_degree_bits_to_support=min_degree_bits_to_support)


def verify_stark_proof_with_challenges_circuit(builder, stark, proof_t, public_inputs_t,
                                               challenges, inner_config, degree_bits: int,
                                               ctl_vars=None,
                                               min_degree_bits_to_support: int | None = None
                                               ) -> None:
    """The checks against challenge targets already drawn: the quotient
    at ζ (with the table's CTL checks, ctl_vars), then FRI (reference
    verify_stark_proof_with_challenges_circuit)."""
    dynamic = min_degree_bits_to_support is not None
    degree_bits_t = proof_t.degree_bits if dynamic else None
    if dynamic:
        builder.inverse(degree_bits_t)  # the degree bits are nonzero
    one = builder.one_extension()
    zeta = challenges.stark_zeta
    lookup_betas = None
    if stark.uses_lookups() and challenges.lookup_challenge_set is not None:
        lookup_betas = [beta for beta, _ in challenges.lookup_challenge_set]
    vanishing_polys_zeta = compute_eval_vanishing_poly_circuit(
        builder, stark, proof_t.openings, public_inputs_t, challenges.stark_alphas, zeta,
        degree_bits, lookup_challenges_t=lookup_betas,
        num_lookup_columns=stark.num_lookup_helper_columns(inner_config),
        degree_bits_target=degree_bits_t, ctl_vars=ctl_vars)

    if dynamic:
        degree, _, zeta_pow_deg, z_h_zeta, g = _variable_degree_data(builder, degree_bits,
                                                                     degree_bits_t, zeta)
        g = builder.convert_to_ext(g)
    else:
        zeta_pow_deg = builder.exp_power_of_2_extension(zeta, degree_bits)
        z_h_zeta = builder.sub_extension(zeta_pow_deg, one)
        g = fs.primitive_root_of_unity(degree_bits)
    qdf = stark.quotient_degree_factor()
    scale = ReducingFactorTarget(zeta_pow_deg)
    quotient_polys = proof_t.openings.quotient_polys or []
    for i in range(inner_config.num_challenges):
        recombined = scale.reduce(quotient_polys[i * qdf:(i + 1) * qdf], builder)
        builder.connect_extension(vanishing_polys_zeta[i],
                                  builder.mul_extension(z_h_zeta, recombined))

    merkle_caps = [proof_t.trace_cap]
    if proof_t.auxiliary_polys_cap is not None:
        merkle_caps.append(proof_t.auxiliary_polys_cap)
    if proof_t.quotient_polys_cap is not None:
        merkle_caps.append(proof_t.quotient_polys_cap)
    num_ctl_helpers = sum(len(v.helper_columns) for v in ctl_vars) if ctl_vars else 0
    num_ctl_zs = len(ctl_vars) if ctl_vars else 0
    fri_instance = _fri_instance_target(builder, stark, zeta, g, inner_config,
                                        num_ctl_helpers, num_ctl_zs)
    openings = proof_t.openings.to_fri_openings(builder)
    params = inner_config.fri_params(degree_bits)
    if dynamic:
        degree_sub_one = builder.add_const(degree, fs.P - 1)
        degree_sub_one_bits_vec = builder.split_le(degree_sub_one, degree_bits)
        verify_fri_proof_with_multiple_degree_bits(
            builder, fri_instance, openings, challenges.fri_challenges, merkle_caps,
            proof_t.opening_proof, params, degree_bits_t, degree_sub_one_bits_vec,
            min_degree_bits_to_support)
    else:
        verify_fri_proof(builder, fri_instance, openings, challenges.fri_challenges,
                         merkle_caps, proof_t.opening_proof, params)
