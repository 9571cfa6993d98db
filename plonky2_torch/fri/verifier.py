"""The FRI verifier on the host, in Python-int field arithmetic (reference
fri/verifier.rs, fri/challenges.rs:28-95; the reference package's
fri/verifier.py:17-172). Merkle paths go through
`hash/merkle.py` `verify_merkle_proof_to_cap`.

At zero PoW bits the proof-of-work bound is 2^64, so every response
passes, as in the reference; the port's prover then takes witness 0
(ROADMAP section 3).
"""

from __future__ import annotations

from plonky2_torch.field import scalar as fs
from plonky2_torch.fri.proof import FriChallenges
from plonky2_torch.hash.merkle import verify_merkle_proof_to_cap
from plonky2_torch.util import ReducingFactor, log2_strict, reverse_bits


def fri_challenges(challenger, commit_phase_merkle_caps, final_poly, pow_witness,
                   degree_bits: int, config, final_poly_coeff_len=None,
                   max_num_query_steps=None) -> FriChallenges:
    """α, each fold step's β, the PoW response and the query indices; with
    the unified shape's lengths, the prover's zero caps (their βs unused)
    and zero final coefficients observed as it observed them (reference
    fri/challenges.rs:28-95)."""
    lde_size = 1 << (degree_bits + config.rate_bits)
    fri_alpha = challenger.get_extension_challenge(2)
    fri_betas = []
    for cap in commit_phase_merkle_caps:
        challenger.observe_cap(cap)
        fri_betas.append(challenger.get_extension_challenge(2))
    if max_num_query_steps is not None:
        for _ in range(len(commit_phase_merkle_caps), max_num_query_steps):
            challenger.observe_elements([0] * (4 << config.cap_height))
            challenger.get_extension_challenge(2)
    challenger.observe_extension_elements(final_poly)
    if final_poly_coeff_len is not None:
        for _ in range(len(final_poly), final_poly_coeff_len):
            challenger.observe_extension_element((0, 0))
    challenger.observe_element(pow_witness)
    fri_pow_response = challenger.get_challenge()
    fri_query_indices = [challenger.get_challenge() % lde_size
                         for _ in range(config.num_query_rounds)]
    return FriChallenges(fri_alpha, fri_betas, fri_pow_response, fri_query_indices)


def _barycentric_weights(xs: list[tuple]) -> list[tuple]:
    weights = []
    for i, x_i in enumerate(xs):
        prod = fs.ext_one(2)
        for j, x_j in enumerate(xs):
            if j != i:
                prod = fs.ext_mul(prod, fs.ext_sub(x_i, x_j))
        weights.append(fs.ext_inverse(prod))
    return weights


def _interpolate(points: list[tuple], x: tuple, weights: list[tuple]) -> tuple:
    """The interpolant of `points` at x, in barycentric form (reference
    field/src/interpolation.rs:13-86)."""
    for x_i, y_i in points:
        if x_i == x:
            return y_i
    l_x = fs.ext_one(2)
    for x_i, _ in points:
        l_x = fs.ext_mul(l_x, fs.ext_sub(x, x_i))
    total = fs.ext_zero(2)
    for (x_i, y_i), w_i in zip(points, weights):
        total = fs.ext_add(total, fs.ext_mul(fs.ext_div(w_i, fs.ext_sub(x, x_i)), y_i))
    return fs.ext_mul(l_x, total)


def compute_evaluation(x: int, x_index_within_coset: int, arity_bits: int,
                       evals: list[tuple], beta: tuple) -> tuple:
    """P'(x^arity) from the coset's values {P(x g^i)}, by interpolation at
    β (reference fri/verifier.rs:22-47)."""
    arity = 1 << arity_bits
    if len(evals) != arity:
        raise ValueError(f"{len(evals)} coset values, arity {arity}")
    gen = fs.primitive_root_of_unity(arity_bits)
    evals = [evals[reverse_bits(i, arity_bits)] for i in range(arity)]
    rev_x = reverse_bits(x_index_within_coset, arity_bits)
    y = fs.mul(x, fs.exp(gen, arity - rev_x))
    points = []
    for e in evals:
        points.append((fs.ext_from_base(y, 2), e))
        y = fs.mul(y, gen)
    return _interpolate(points, beta, _barycentric_weights([p for p, _ in points]))


def verify_proof_of_work(fri_pow_response: int, config) -> None:
    if fri_pow_response >= (1 << (64 - config.proof_of_work_bits)):
        raise ValueError("Invalid proof of work witness.")


class PrecomputedReducedOpenings:
    """Each opening batch α-reduced once for every query round."""

    def __init__(self, openings, alpha):
        self.reduced_openings_at_point = [ReducingFactor(alpha).reduce(batch.values)
                                          for batch in openings.batches]


def verify_fri_proof(instance, openings, challenges: FriChallenges, initial_merkle_caps,
                     proof, params, hasher=None) -> None:
    """Raise unless `proof` opens `openings`; its Merkle paths are
    `hasher`'s (Poseidon by default)."""
    verify_proof_of_work(challenges.fri_pow_response, params.config)
    if params.config.num_query_rounds != len(proof.query_round_proofs):
        raise ValueError("Number of query rounds does not match config.")
    precomputed = PrecomputedReducedOpenings(openings, challenges.fri_alpha)
    for x_index, round_proof in zip(challenges.fri_query_indices, proof.query_round_proofs):
        _verify_query_round(instance, challenges, precomputed, initial_merkle_caps, proof,
                            x_index, params.lde_size, round_proof, params, hasher)


def fri_combine_initial(instance, initial_proof, alpha, subgroup_x: int, precomputed,
                        params) -> tuple:
    """The initial openings α-reduced into the composition value at x
    (reference fri/verifier.rs:123-162)."""
    alpha_rf = ReducingFactor(alpha)
    total = fs.ext_zero(2)
    sx = fs.ext_from_base(subgroup_x, 2)
    for batch, reduced_openings in zip(instance.batches, precomputed.reduced_openings_at_point):
        evals = [initial_proof.unsalted_eval(
                     p.oracle_index, p.polynomial_index,
                     params.hiding and instance.oracles[p.oracle_index].blinding)
                 for p in batch.polynomials]
        numerator = fs.ext_sub(alpha_rf.reduce(evals), reduced_openings)
        denominator = fs.ext_sub(sx, batch.point)
        total = fs.ext_add(alpha_rf.shift(total), fs.ext_div(numerator, denominator))
    return total


def _verify_query_round(instance, challenges, precomputed, initial_merkle_caps, proof,
                        x_index: int, n: int, round_proof, params, hasher=None) -> None:
    for (evals, merkle_proof), cap in zip(round_proof.initial_trees_proof.evals_proofs,
                                          initial_merkle_caps):
        verify_merkle_proof_to_cap(evals, x_index, cap, merkle_proof, hasher)
    log_n = log2_strict(n)
    subgroup_x = fs.mul(fs.MULTIPLICATIVE_GROUP_GENERATOR,
                        fs.exp(fs.primitive_root_of_unity(log_n), reverse_bits(x_index, log_n)))
    old_eval = fri_combine_initial(instance, round_proof.initial_trees_proof,
                                   challenges.fri_alpha, subgroup_x, precomputed, params)
    for i, arity_bits in enumerate(params.reduction_arity_bits):
        arity = 1 << arity_bits
        evals = round_proof.steps[i].evals
        coset_index = x_index >> arity_bits
        x_index_within_coset = x_index & (arity - 1)
        if evals[x_index_within_coset] != old_eval:
            raise ValueError(f"FRI fold consistency check failed at step {i}")
        old_eval = compute_evaluation(subgroup_x, x_index_within_coset, arity_bits, evals,
                                      challenges.fri_betas[i])
        verify_merkle_proof_to_cap([c for e in evals for c in e], coset_index,
                                   proof.commit_phase_merkle_caps[i],
                                   round_proof.steps[i].merkle_proof, hasher)
        subgroup_x = fs.exp(subgroup_x, arity)
        x_index = coset_index
    final_eval = fs.ext_zero(2)
    sx = fs.ext_from_base(subgroup_x, 2)
    for coeff in reversed(proof.final_poly):
        final_eval = fs.ext_add(fs.ext_mul(final_eval, sx), coeff)
    if final_eval != old_eval:
        raise ValueError("Final polynomial evaluation is invalid.")
