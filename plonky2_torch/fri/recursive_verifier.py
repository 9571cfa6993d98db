"""The FRI verifier in a circuit, the FRI proof's targets and their witness
setters (reference fri/recursive_verifier.rs and fri/witness_util.rs; the
reference package's fri/recursive_verifier.py).

The verification follows the host's `fri/verifier.py` step by step: a
Merkle path becomes swapped Poseidon rows, a coset fold a
CosetInterpolationGate row, an α-reduction Reducing(Extension)Gate rows.
`verify_fri_proof_with_multiple_degree_bits` verifies, in one circuit,
proofs of any degree in a range, their degree a target (STARK recursion's
variable-degree mode); batch FRI's circuit verifier is `fri/batch_fri.py`'s.
"""

from __future__ import annotations

from dataclasses import dataclass

from plonky2_torch.field import scalar as fs
from plonky2_torch.gadgets.reducing import ReducingFactorTarget
from plonky2_torch.gates.coset_interpolation import CosetInterpolationGate
from plonky2_torch.iop.target import ExtensionTarget, Target
from plonky2_torch.util import reverse_bits


@dataclass
class MerkleProofTarget:
    siblings: list  # 4-target digests


@dataclass
class FriInitialTreeProofTarget:
    evals_proofs: list  # per oracle: (list[Target], MerkleProofTarget)

    def unsalted_eval(self, oracle_index: int, poly_index: int, salted: bool) -> Target:
        evals = self.evals_proofs[oracle_index][0]
        return evals[:len(evals) - (4 if salted else 0)][poly_index]


@dataclass
class FriQueryStepTarget:
    evals: list  # list[ExtensionTarget]
    merkle_proof: MerkleProofTarget


@dataclass
class FriQueryRoundTarget:
    initial_trees_proof: FriInitialTreeProofTarget
    steps: list


@dataclass
class FriProofTarget:
    commit_phase_merkle_caps: list  # per fold step: a cap of 4-target digests
    query_round_proofs: list
    final_poly: list  # list[ExtensionTarget]
    pow_witness: Target


@dataclass
class FriChallengesTarget:
    fri_alpha: ExtensionTarget
    fri_betas: list  # ExtensionTargets
    fri_pow_response: Target
    fri_query_indices: list  # Targets


class PrecomputedReducedOpeningsTarget:
    """Each opening batch α-reduced once, for every query round."""

    def __init__(self, openings_target, alpha: ExtensionTarget, builder):
        self.reduced_openings_at_point = [
            ReducingFactorTarget(alpha).reduce(batch.values, builder)
            for batch in openings_target.batches]


# -- allocation, in the reference's order --------------------------------------

def add_virtual_cap(builder, cap_height: int) -> list:
    return [builder.add_virtual_hash() for _ in range(1 << cap_height)]


def add_virtual_merkle_proof(builder, num_siblings: int) -> MerkleProofTarget:
    return MerkleProofTarget(siblings=[builder.add_virtual_hash() for _ in range(num_siblings)])


def add_virtual_fri_proof(builder, num_leaves_per_oracle: list[int], params) -> FriProofTarget:
    cap_height = params.config.cap_height
    return FriProofTarget(
        commit_phase_merkle_caps=[add_virtual_cap(builder, cap_height)
                                  for _ in params.reduction_arity_bits],
        query_round_proofs=[_add_virtual_fri_query(builder, num_leaves_per_oracle, params)
                            for _ in range(params.config.num_query_rounds)],
        final_poly=builder.add_virtual_extension_targets(params.final_poly_len()),
        pow_witness=builder.add_virtual_target())


def _add_virtual_fri_query(builder, num_leaves_per_oracle, params) -> FriQueryRoundTarget:
    cap_height = params.config.cap_height
    initial = FriInitialTreeProofTarget(evals_proofs=[
        (builder.add_virtual_targets(n),
         add_virtual_merkle_proof(builder, params.lde_bits - cap_height))
        for n in num_leaves_per_oracle])
    steps = []
    codeword_bits = params.lde_bits
    for arity_bits in params.reduction_arity_bits:
        codeword_bits -= arity_bits
        steps.append(FriQueryStepTarget(
            evals=builder.add_virtual_extension_targets(1 << arity_bits),
            merkle_proof=add_virtual_merkle_proof(builder, codeword_bits - cap_height)))
    return FriQueryRoundTarget(initial_trees_proof=initial, steps=steps)


# -- verification (reference fri/recursive_verifier.rs:29-478) ---------------------

def fri_verify_proof_of_work(builder, fri_pow_response: Target, config) -> None:
    builder.assert_leading_zeros(fri_pow_response, config.proof_of_work_bits)


def compute_evaluation(builder, x: Target, x_index_within_coset_bits, arity_bits: int, evals,
                       beta: ExtensionTarget) -> ExtensionTarget:
    """The folded value at β: the coset's evaluations, in natural order,
    interpolated on the coset x · g^(-index) <ω>."""
    arity = 1 << arity_bits
    if len(evals) != arity:
        raise ValueError("one evaluation for each point of the coset")
    g_inv = fs.exp(fs.primitive_root_of_unity(arity_bits), arity - 1)
    evals = [evals[reverse_bits(i, arity_bits)] for i in range(arity)]
    start = builder.exp_from_bits_const_base(g_inv, list(x_index_within_coset_bits)[::-1])
    coset_start = builder.mul(start, x)
    gate = CosetInterpolationGate(arity_bits, builder.config.max_quotient_degree_factor)
    return builder.interpolate_coset(gate, coset_start, evals, beta)


def fri_combine_initial(builder, instance, proof_t: FriInitialTreeProofTarget,
                        alpha: ExtensionTarget, subgroup_x: Target, precomputed,
                        params) -> ExtensionTarget:
    """Σ over the batches, shifted by α^(terms so far), of
    (reduced evaluations - reduced openings) / (x - the batch's point)."""
    subgroup_x_ext = builder.convert_to_ext(subgroup_x)
    alpha_rf = ReducingFactorTarget(alpha)
    total = builder.zero_extension()
    for batch, reduced_openings in zip(instance.batches,
                                       precomputed.reduced_openings_at_point):
        evals = [proof_t.unsalted_eval(
                     p.oracle_index, p.polynomial_index,
                     params.hiding and instance.oracles[p.oracle_index].blinding)
                 for p in batch.polynomials]
        reduced_evals = alpha_rf.reduce_base(evals, builder)
        numerator = builder.sub_extension(reduced_evals, reduced_openings)
        denominator = builder.sub_extension(subgroup_x_ext, batch.point)
        total = alpha_rf.shift(total, builder)
        quotient = builder.div_extension(numerator, denominator)
        total = builder.add_extension(quotient, total)
    return total


def verify_fri_proof(builder, instance, openings_t, challenges_t: FriChallengesTarget,
                     initial_merkle_caps_t, proof_t: FriProofTarget, params) -> None:
    """The proof of work, then every query round."""
    if params.final_poly_len() != len(proof_t.final_poly):
        raise ValueError("the final polynomial's length does not match the FRI params")
    if params.config.num_query_rounds != len(proof_t.query_round_proofs):
        raise ValueError("the number of query rounds does not match the FRI params")
    fri_verify_proof_of_work(builder, challenges_t.fri_pow_response, params.config)
    precomputed = PrecomputedReducedOpeningsTarget(openings_t, challenges_t.fri_alpha, builder)
    for i, round_proof in enumerate(proof_t.query_round_proofs):
        _fri_verifier_query_round(builder, instance, challenges_t, precomputed,
                                  initial_merkle_caps_t, proof_t,
                                  challenges_t.fri_query_indices[i], params.lde_size,
                                  round_proof, params)


def _fri_verifier_query_round(builder, instance, challenges_t, precomputed,
                              initial_merkle_caps_t, proof_t, x_index: Target, n: int,
                              round_proof, params) -> None:
    n_log = n.bit_length() - 1
    # all 64 bits of the index are split; a non-canonical encoding has a
    # negligible effect on soundness (reference assert_noncanonical_indices_ok)
    x_index_bits = builder.low_bits(x_index, n_log, 64)
    cap_index = builder.le_sum(x_index_bits[len(x_index_bits) - params.config.cap_height:])
    for (evals, merkle_proof), cap in zip(round_proof.initial_trees_proof.evals_proofs,
                                          initial_merkle_caps_t):
        builder.verify_merkle_proof_to_cap_with_cap_index(list(evals), x_index_bits, cap_index,
                                                          cap, merkle_proof)

    # subgroup_x = g · φ^reverse(x_index)
    g_const = builder.constant(fs.MULTIPLICATIVE_GROUP_GENERATOR)
    phi = fs.primitive_root_of_unity(n_log)
    phi_pow = builder.exp_from_bits_const_base(phi, x_index_bits[::-1])
    subgroup_x = builder.mul(g_const, phi_pow)

    old_eval = fri_combine_initial(builder, instance, round_proof.initial_trees_proof,
                                   challenges_t.fri_alpha, subgroup_x, precomputed, params)
    for i, arity_bits in enumerate(params.reduction_arity_bits):
        evals = round_proof.steps[i].evals
        coset_index_bits = x_index_bits[arity_bits:]
        x_index_within_coset_bits = x_index_bits[:arity_bits]
        x_index_within_coset = builder.le_sum(x_index_within_coset_bits)
        # the folded value of the last step is this step's evaluation there
        new_eval = builder.random_access_extension(x_index_within_coset, list(evals))
        builder.connect_extension(new_eval, old_eval)
        old_eval = compute_evaluation(builder, subgroup_x, x_index_within_coset_bits,
                                      arity_bits, evals, challenges_t.fri_betas[i])
        builder.verify_merkle_proof_to_cap_with_cap_index(
            [c for e in evals for c in e.parts], coset_index_bits, cap_index,
            proof_t.commit_phase_merkle_caps[i], round_proof.steps[i].merkle_proof)
        subgroup_x = builder.exp_power_of_2(subgroup_x, arity_bits)
        x_index_bits = coset_index_bits

    # the final polynomial at subgroup_x, by Horner
    acc = builder.zero_extension()
    for coeff in reversed(proof_t.final_poly):
        acc = builder.scalar_mul_add_extension(subgroup_x, acc, coeff)
    builder.connect_extension(acc, old_eval)


def verify_fri_proof_with_multiple_degree_bits(
        builder, instance, openings_t, challenges_t: FriChallengesTarget,
        initial_merkle_caps_t, proof_t: FriProofTarget, params, current_degree_bits: Target,
        degree_sub_one_bits_vec, min_degree_bits_to_support: int) -> None:
    """One circuit for FRI proofs of any degree in
    [min_degree_bits_to_support, params.degree_bits]: the proof's targets
    have the largest shape (a smaller proof's are zero-padded, as its
    unified-shape transcript was), the cap index and subgroup point of
    each query are selected by the degree, and a fold step runs only where
    the bit of degree - 1 that it stands for is set (reference
    fri/recursive_verifier.rs:189-274)."""
    if params.final_poly_len() != len(proof_t.final_poly):
        raise ValueError("the final polynomial's length does not match the FRI params")
    log_n = params.config.rate_bits + params.degree_bits
    min_log_n = params.config.rate_bits + min_degree_bits_to_support
    if min_log_n <= params.config.cap_height:
        raise ValueError("the smallest degree's LDE is not taller than the cap")
    current_log_n = builder.add_const(current_degree_bits, params.config.rate_bits)
    fri_verify_proof_of_work(builder, challenges_t.fri_pow_response, params.config)
    if params.config.num_query_rounds != len(proof_t.query_round_proofs):
        raise ValueError("the number of query rounds does not match the FRI params")
    precomputed = PrecomputedReducedOpeningsTarget(openings_t, challenges_t.fri_alpha, builder)
    for i, round_proof in enumerate(proof_t.query_round_proofs):
        _fri_verifier_query_round_multi(builder, instance, challenges_t, precomputed,
                                        initial_merkle_caps_t, proof_t,
                                        challenges_t.fri_query_indices[i], min_log_n, log_n,
                                        current_log_n, degree_sub_one_bits_vec, round_proof,
                                        params)


def _fri_verifier_query_round_multi(builder, instance, challenges_t, precomputed,
                                    initial_merkle_caps_t, proof_t, x_index: Target,
                                    min_log_n: int, max_log_n: int, log_n_t: Target,
                                    degree_sub_one_bits_vec, round_proof, params) -> None:
    cap_height = params.config.cap_height
    n_index = builder.sub(log_n_t, builder.constant(min_log_n))
    x_index_bits = builder.low_bits(x_index, max_log_n, 64)
    cap_indices = [builder.le_sum(x_index_bits[n - cap_height:n])
                   for n in range(min_log_n, max_log_n + 1)]
    cap_index = builder.random_access(n_index, cap_indices)
    one = builder.one()
    for (evals, merkle_proof), cap in zip(round_proof.initial_trees_proof.evals_proofs,
                                          initial_merkle_caps_t):
        builder.verify_merkle_proof_to_cap_with_cap_indices(
            one, list(evals), x_index_bits, min_log_n, max_log_n, n_index, cap_index, cap,
            merkle_proof)

    # subgroup_x for each domain size, then the live one selected
    g_const = builder.constant(fs.MULTIPLICATIVE_GROUP_GENERATOR)
    subgroup_x_vec = []
    for n_log in range(min_log_n, max_log_n + 1):
        phi_pow = builder.exp_from_bits_const_base(fs.primitive_root_of_unity(n_log),
                                                   x_index_bits[:n_log][::-1])
        subgroup_x_vec.append(builder.mul(g_const, phi_pow))
    subgroup_x = builder.random_access(n_index, subgroup_x_vec)

    old_eval = fri_combine_initial(builder, instance, round_proof.initial_trees_proof,
                                   challenges_t.fri_alpha, subgroup_x, precomputed, params)
    idx = len(degree_sub_one_bits_vec) - sum(params.reduction_arity_bits)
    for i, arity_bits in enumerate(params.reduction_arity_bits):
        evals = round_proof.steps[i].evals
        coset_index_bits = x_index_bits[arity_bits:]
        x_index_within_coset_bits = x_index_bits[:arity_bits]
        x_index_within_coset = builder.le_sum(x_index_within_coset_bits)
        step_active = degree_sub_one_bits_vec[idx]
        new_eval = builder.random_access_extension(x_index_within_coset, list(evals))
        builder.conditional_assert_eq_ext(step_active.target, new_eval, old_eval)
        ev = compute_evaluation(builder, subgroup_x, x_index_within_coset_bits, arity_bits,
                                evals, challenges_t.fri_betas[i])
        old_eval = builder.select_ext(step_active, ev, old_eval)
        builder.verify_merkle_proof_to_cap_with_cap_indices(
            step_active.target, [c for e in evals for c in e.parts], coset_index_bits,
            min_log_n, max_log_n, n_index, cap_index, proof_t.commit_phase_merkle_caps[i],
            round_proof.steps[i].merkle_proof)
        subgroup_x_cur = builder.exp_power_of_2(subgroup_x, arity_bits)
        subgroup_x = builder.select(step_active, subgroup_x_cur, subgroup_x)
        x_index_bits = coset_index_bits
        idx += arity_bits

    acc = builder.zero_extension()
    for coeff in reversed(proof_t.final_poly):
        acc = builder.scalar_mul_add_extension(subgroup_x, acc, coeff)
    builder.connect_extension(acc, old_eval)


# -- witness setters -----------------------------------------------------------

_ZERO_DIGEST = (0, 0, 0, 0)


def set_fri_proof_target(pw, proof_t: FriProofTarget, proof) -> None:
    """Fills a FriProofTarget; targets beyond the proof's shape (a smaller
    proof in a larger target) are zero-padded, as the reference does."""
    pw.set_target(proof_t.pow_witness, proof.pow_witness)
    if len(proof_t.final_poly) < len(proof.final_poly):
        raise ValueError("the final polynomial does not fit its targets")
    pad = [(0, 0)] * (len(proof_t.final_poly) - len(proof.final_poly))
    for t, v in zip(proof_t.final_poly, list(proof.final_poly) + pad):
        pw.set_extension_target(t, v)
    if len(proof_t.commit_phase_merkle_caps) < len(proof.commit_phase_merkle_caps):
        raise ValueError("the commit-phase caps do not fit their targets")
    for cap_t, cap in zip(proof_t.commit_phase_merkle_caps, proof.commit_phase_merkle_caps):
        set_cap_target(pw, cap_t, cap)
    for cap_t in proof_t.commit_phase_merkle_caps[len(proof.commit_phase_merkle_caps):]:
        for digest_t in cap_t:
            pw.set_hash_target(digest_t, _ZERO_DIGEST)
    for qt, q in zip(proof_t.query_round_proofs, proof.query_round_proofs):
        for (evals_t, mp_t), (evals, mp) in zip(qt.initial_trees_proof.evals_proofs,
                                                q.initial_trees_proof.evals_proofs):
            pw.set_targets(evals_t, evals)
            set_merkle_proof_target(pw, mp_t, mp)
        for st, s in zip(qt.steps, q.steps):
            for t, v in zip(st.evals, s.evals):
                pw.set_extension_target(t, v)
            set_merkle_proof_target(pw, st.merkle_proof, s.merkle_proof)
        for st in qt.steps[len(q.steps):]:
            for t in st.evals:
                pw.set_extension_target(t, (0, 0))
            for sib_t in st.merkle_proof.siblings:
                pw.set_hash_target(sib_t, _ZERO_DIGEST)


def set_cap_target(pw, cap_t, cap) -> None:
    for digest_t, digest in zip(cap_t, cap):
        pw.set_hash_target(digest_t, digest)


def set_merkle_proof_target(pw, proof_t: MerkleProofTarget, proof) -> None:
    if len(proof_t.siblings) < len(proof.siblings):
        raise ValueError("the Merkle proof does not fit its targets")
    for sib_t, sib in zip(proof_t.siblings, proof.siblings):
        pw.set_hash_target(sib_t, sib)
    for sib_t in proof_t.siblings[len(proof.siblings):]:
        pw.set_hash_target(sib_t, _ZERO_DIGEST)
