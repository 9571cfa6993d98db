"""Batch FRI: polynomials of several degrees committed under one cap and
opened in one FRI argument (reference batch_fri/{oracle,prover,verifier,
recursive_verifier}.rs; the reference package's fri/batch_fri.py).

Each degree group is LDE'd and its bit-reversed rows committed in one
`BatchMerkleTree`. The commit phase folds the tallest group's composition
polynomial, zero-padded to the LDE length; when the folded codeword
reaches a shorter group's LDE size, that group's codeword is added in,
scaled by the step's β, and the coefficients are refreshed by a coset
iFFT. Two transcript paths give the same proof bytes:

- fused (Poseidon, at least one fold step, outside force_host_path()): the
  transcript stays on the device (`DeviceChallenger`) through each cap and
  β, the final polynomial, K5's device grind, the PoW response and the
  query indices; the openings are gathered at the device indices and the
  argument leaves the device in one fetch, after which the host challenger
  is synced to the state the host path leaves;
- host: the host challenger, one cap and one β crossing per fold step, the
  grind chunk by chunk, the indices drawn on the host.

`verify_batch_fri_proof` checks a proof on the host and
`verify_batch_fri_proof_circuit` in a circuit.
"""

from __future__ import annotations

import torch

from plonky2_torch import parallel
from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import ntt
from plonky2_torch.field import scalar as fs
from plonky2_torch.fri import prover as fp
from plonky2_torch.fri.oracle import _as_tensor, _lde_leaves
from plonky2_torch.fri.proof import FriProof
from plonky2_torch.fri.verifier import (
    PrecomputedReducedOpenings,
    compute_evaluation,
    verify_proof_of_work,
)
from plonky2_torch.hash.merkle import (
    BatchMerkleTree,
    make_merkle_tree,
    verify_batch_merkle_proof_to_cap,
    verify_merkle_proof_to_cap,
)
from plonky2_torch.iop.challenger import DeviceChallenger
from plonky2_torch.util import ReducingFactor, log2_strict, reverse_bits


class BatchFriOracle:
    """Polynomial groups of strictly decreasing degrees committed under one
    batch Merkle cap (reference batch_fri/oracle.rs:30-123). poly_groups:
    [num_polys, n_k] coefficients per group, u64 matrices or int64 tensors,
    on `device` (CUDA unless the caller asks for another; under a process
    group the group's device, the oracle whole on every rank)."""

    def __init__(self, poly_groups: list, rate_bits: int, cap_height: int, device=None):
        device = _device(device)
        self.polynomial_groups = [_as_tensor(p, device) for p in poly_groups]
        self.degree_bits = [log2_strict(p.shape[-1]) for p in self.polynomial_groups]
        if any(a <= b for a, b in zip(self.degree_bits, self.degree_bits[1:])):
            raise ValueError("the groups' degrees must decrease strictly")
        self.rate_bits = rate_bits
        self.batch_merkle_tree = BatchMerkleTree(
            [_lde_leaves(ntt.coset_lde(c, rate_bits)) for c in self.polynomial_groups],
            cap_height)

    @staticmethod
    def from_values(value_groups: list, rate_bits: int, cap_height: int, device=None):
        device = _device(device)
        return BatchFriOracle([ntt.ifft(_as_tensor(v, device)) for v in value_groups],
                              rate_bits, cap_height, device)


def _device(device):
    """`device`, or under a process group the group's (which a given device
    must agree with): batch FRI runs whole on every rank, as the reference
    runs it unsharded under a mesh."""
    return device if parallel.active_mesh() is None else parallel.placement(device)[1]


def batch_fri_proof(batch_trees: list, composition_coeffs: list, challenger, fri_params,
                    hasher=None) -> FriProof:
    """composition_coeffs: per degree group, largest first, the ext
    coefficient tensors (c0, c1) of its α-combined quotient polynomial
    (reference batch_fri/prover.rs:25-148). The fold trees are `hasher`'s
    (Poseidon by default); `fri.prover._LAST_PATH` records the path,
    "batch_fused" or "batch_host". Under a process group it runs whole on
    every rank with the group suspended."""
    with parallel.use_mesh(None):
        return _batch_fri_proof(batch_trees, composition_coeffs, challenger, fri_params,
                                hasher)


def _batch_fri_proof(batch_trees, composition_coeffs, challenger, fri_params, hasher):
    from plonky2_torch.hash.hashers import PoseidonHasher

    if (not fp._FORCE_HOST and getattr(hasher, "algebraic", True)
            and challenger.hasher is PoseidonHasher and fri_params.reduction_arity_bits):
        fp._LAST_PATH = "batch_fused"
        return _batch_fri_proof_fused(batch_trees, composition_coeffs, challenger, fri_params)
    fp._LAST_PATH = "batch_host"
    device = composition_coeffs[0][0].device

    def observe_and_draw(tree):
        challenger.observe_cap(tree.cap)
        return g.ext_tensor(challenger.get_extension_challenge(2), device)

    trees, coeffs = _commit_phase(composition_coeffs, fri_params, observe_and_draw, hasher)
    c0, c1 = g.to_numpy(torch.stack(coeffs))
    keep = len(c0) >> fri_params.config.rate_bits
    if c0[keep:].any() or c1[keep:].any():
        raise ValueError("the folded polynomial is not of the final degree")
    final_poly = [(int(a), int(b)) for a, b in zip(c0[:keep], c1[:keep])]
    for coeff in final_poly:
        challenger.observe_extension_element(coeff)
    pow_witness = fp.fri_proof_of_work(challenger, fri_params.config, device)
    n = int(coeffs[0].shape[0]) << sum(fri_params.reduction_arity_bits)
    rounds = fp._fri_prover_query_rounds(batch_trees, trees, challenger, n, fri_params)
    return FriProof(commit_phase_merkle_caps=[t.cap for t in trees],
                    query_round_proofs=rounds, final_poly=final_poly, pow_witness=pow_witness)


def _commit_phase(composition_coeffs, fri_params, observe_and_draw, hasher=None):
    """The folds (reference batch_fri/prover.rs:40-120): returns the fold
    trees and the last coefficients, full LDE length (zero tail).
    observe_and_draw(tree) observes the tree's cap and returns β as a pair
    of tensors on the coefficients' device."""
    rate_bits, cap_height = fri_params.config.rate_bits, fri_params.config.cap_height
    groups = [fp._initial_lde(c, rate_bits) for c in composition_coeffs]
    values = groups[0]
    n = int(values[0].shape[0])
    coeffs = tuple(torch.cat([c, c.new_zeros(n - c.shape[0])]) for c in composition_coeffs[0])
    shift = fs.MULTIPLICATIVE_GROUP_GENERATOR
    trees = []
    index = 1
    for arity_bits in fri_params.reduction_arity_bits:
        tree = make_merkle_tree(fp._fold_step_leaves(values, arity_bits), cap_height, hasher)
        trees.append(tree)
        beta = observe_and_draw(tree)
        coeffs = fp._fold_coeffs(coeffs, beta, arity_bits)
        shift = fs.exp(shift, 1 << arity_bits)
        v = ntt.coset_fft(torch.stack(coeffs), shift)
        values = (v[0], v[1])
        if index < len(groups) and v.shape[1] == groups[index][0].shape[0]:
            values = g.ext2_add(g.ext2_mul(values, beta), groups[index])
            c = ntt.coset_ifft(torch.stack(values), shift)
            coeffs = (c[0], c[1])
            index += 1
    if index != len(groups):
        raise ValueError("the arities never reach some degree group's size")
    return trees, coeffs


def _batch_fri_proof_fused(batch_trees, composition_coeffs, challenger, fri_params) -> FriProof:
    """The fused batch FRI proof (reference `_batch_fri_proof_fused`): no
    host synchronisation before its one fetch."""
    device = composition_coeffs[0][0].device
    rate_bits = fri_params.config.rate_bits
    arities = tuple(fri_params.reduction_arity_bits)
    sponge = g.upload(challenger.sponge_state, device)
    pending = g.upload(challenger.input_buffer, device)
    dc = DeviceChallenger(sponge, pending)
    trees, coeffs = _commit_phase(composition_coeffs, fri_params,
                                  lambda tree: (dc.observe_cap_rows(tree.cap_dev),
                                                (dc.get_challenge(), dc.get_challenge()))[1])
    keep = int(coeffs[0].shape[0]) >> rate_bits
    final = (coeffs[0][:keep], coeffs[1][:keep])
    witness, pow_response, idx = fp._final_pow_queries(dc, final, fri_params)
    packed = torch.cat([t.cap_dev.reshape(-1) for t in trees]
                       + [final[0], final[1], witness, pow_response.reshape(1), idx, dc.state])
    out_dev, shapes = fp._gather_all(batch_trees, trees, arities, idx, [packed])
    return fp._fri_fused_finish(out_dev, len(batch_trees), challenger, fri_params, True, None,
                                0, False, keep, int(pending.shape[0]), shapes)[0]


# -- the host verifier -------------------------------------------------------------

class _InstanceView:
    """The initial openings of one degree group: its polynomials sit at
    per-oracle offsets in the concatenated leaf rows."""

    def __init__(self, evals_proofs, offsets):
        self.evals_proofs = evals_proofs
        self.offsets = offsets

    def unsalted_eval(self, oracle_index: int, poly_index: int, salted: bool):
        return self.evals_proofs[oracle_index][0][self.offsets[oracle_index] + poly_index]


def _offsets(instances, num_oracles: int) -> list[list[int]]:
    """Each instance's first polynomial's column in each oracle's rows."""
    out, acc = [], [0] * num_oracles
    for inst in instances:
        out.append(list(acc))
        for oi, o in enumerate(inst.oracles):
            acc[oi] += o.num_polys
    return out


def _batch_combine_initial(instance, initial_proof, alpha, subgroup_x: int,
                           precomputed) -> tuple:
    alpha_rf = ReducingFactor(alpha)
    total = fs.ext_zero(2)
    sx = fs.ext_from_base(subgroup_x, 2)
    for batch, reduced_openings in zip(instance.batches, precomputed.reduced_openings_at_point):
        evals = [initial_proof.unsalted_eval(p.oracle_index, p.polynomial_index, False)
                 for p in batch.polynomials]
        numerator = fs.ext_sub(alpha_rf.reduce(evals), reduced_openings)
        total = alpha_rf.shift(total)
        total = fs.ext_add(total, fs.ext_div(numerator, fs.ext_sub(sx, batch.point)))
    return total


def _subgroup_x(n_bits: int, x_index: int) -> int:
    return fs.mul(fs.MULTIPLICATIVE_GROUP_GENERATOR,
                  fs.exp(fs.primitive_root_of_unity(n_bits), reverse_bits(x_index, n_bits)))


def verify_batch_fri_proof(degree_bits: list[int], instances, openings, challenges,
                           initial_merkle_caps, leaf_heights_per_oracle, proof: FriProof,
                           params, hasher=None) -> None:
    """Raise unless `proof` opens each group's `openings` (reference
    batch_fri/verifier.rs:23-250). leaf_heights_per_oracle: per initial
    oracle, its BatchMerkleTree's leaf heights (LDE sizes, in bits)."""
    verify_proof_of_work(challenges.fri_pow_response, params.config)
    if params.config.num_query_rounds != len(proof.query_round_proofs):
        raise ValueError("Number of query rounds does not match config.")
    precomputed = [PrecomputedReducedOpenings(o, challenges.fri_alpha) for o in openings]
    lde_bits = [d + params.config.rate_bits for d in degree_bits]
    offsets = _offsets(instances, len(initial_merkle_caps))
    for x_index, round_proof in zip(challenges.fri_query_indices, proof.query_round_proofs):
        evals_proofs = round_proof.initial_trees_proof.evals_proofs
        for oi, ((evals, merkle_proof), cap) in enumerate(zip(evals_proofs,
                                                              initial_merkle_caps)):
            leaves, pos = [], 0
            for inst in instances:
                k = inst.oracles[oi].num_polys
                leaves.append(evals[pos:pos + k])
                pos += k
            verify_batch_merkle_proof_to_cap(leaves, leaf_heights_per_oracle[oi], x_index, cap,
                                             merkle_proof, hasher)
        n_bits = lde_bits[0]
        subgroup_x = _subgroup_x(n_bits, x_index)
        old_eval = _batch_combine_initial(instances[0], _InstanceView(evals_proofs, offsets[0]),
                                          challenges.fri_alpha, subgroup_x, precomputed[0])
        batch_index = 1
        xi = x_index
        for i, arity_bits in enumerate(params.reduction_arity_bits):
            arity = 1 << arity_bits
            evals = round_proof.steps[i].evals
            coset_index = xi >> arity_bits
            within = xi & (arity - 1)
            if tuple(evals[within]) != tuple(old_eval):
                raise ValueError(f"Batch FRI fold consistency failed at step {i}")
            old_eval = compute_evaluation(subgroup_x, within, arity_bits, evals,
                                          challenges.fri_betas[i])
            verify_merkle_proof_to_cap([c for e in evals for c in e], coset_index,
                                       proof.commit_phase_merkle_caps[i],
                                       round_proof.steps[i].merkle_proof, hasher)
            subgroup_x = fs.exp(subgroup_x, arity)
            xi = coset_index
            n_bits -= arity_bits
            if batch_index < len(lde_bits) and n_bits == lde_bits[batch_index]:
                ev = _batch_combine_initial(
                    instances[batch_index], _InstanceView(evals_proofs, offsets[batch_index]),
                    challenges.fri_alpha, _subgroup_x(n_bits, xi), precomputed[batch_index])
                old_eval = fs.ext_add(fs.ext_mul(old_eval, challenges.fri_betas[i]), ev)
                batch_index += 1
        if batch_index != len(instances):
            raise ValueError("Wrong number of folded instances.")
        sx = fs.ext_from_base(subgroup_x, 2)
        final_eval = fs.ext_zero(2)
        for coeff in reversed(proof.final_poly):
            final_eval = fs.ext_add(fs.ext_mul(final_eval, sx), tuple(coeff))
        if final_eval != tuple(old_eval):
            raise ValueError("Batch FRI final polynomial evaluation is invalid.")


# -- the verifier in a circuit -------------------------------------------------------

def verify_batch_fri_proof_circuit(builder, degree_bits: list[int], instances, openings_t_list,
                                   challenges_t, initial_merkle_caps_t,
                                   leaf_heights_per_oracle, proof_t, params) -> None:
    """The circuit dual of `verify_batch_fri_proof` (reference
    batch_fri/recursive_verifier.rs:22-332), in the reference's op order:
    batch-Merkle initial paths, and each shorter group's combination added
    into the running fold where the codeword reaches its size."""
    from plonky2_torch.fri.recursive_verifier import (
        PrecomputedReducedOpeningsTarget,
        fri_combine_initial,
        fri_verify_proof_of_work,
    )
    from plonky2_torch.fri.recursive_verifier import compute_evaluation as compute_evaluation_t

    if params.final_poly_len() != len(proof_t.final_poly):
        raise ValueError("the final polynomial's length does not match the FRI params")
    fri_verify_proof_of_work(builder, challenges_t.fri_pow_response, params.config)
    if params.config.num_query_rounds != len(proof_t.query_round_proofs):
        raise ValueError("the number of query rounds does not match the FRI params")
    precomputed = [PrecomputedReducedOpeningsTarget(o, challenges_t.fri_alpha, builder)
                   for o in openings_t_list]
    lde_bits = [d + params.config.rate_bits for d in degree_bits]
    offsets = _offsets(instances, len(initial_merkle_caps_t))
    g_const = builder.constant(fs.MULTIPLICATIVE_GROUP_GENERATOR)

    def subgroup_x_t(n: int, bits):
        phi_pow = builder.exp_from_bits_const_base(fs.primitive_root_of_unity(n), bits[::-1])
        return builder.mul(g_const, phi_pow)

    for qi, round_proof in enumerate(proof_t.query_round_proofs):
        n_bits = lde_bits[0]
        x_index_bits = builder.low_bits(challenges_t.fri_query_indices[qi], n_bits, 64)
        cap_index = builder.le_sum(x_index_bits[n_bits - params.config.cap_height:])
        evals_proofs = round_proof.initial_trees_proof.evals_proofs
        for oi, ((evals, merkle_proof), cap) in enumerate(zip(evals_proofs,
                                                              initial_merkle_caps_t)):
            leaves, pos = [], 0
            for inst in instances:
                k = inst.oracles[oi].num_polys
                leaves.append(list(evals[pos:pos + k]))
                pos += k
            builder.verify_batch_merkle_proof_to_cap_with_cap_index(
                leaves, leaf_heights_per_oracle[oi], x_index_bits, cap_index, cap, merkle_proof)
        subgroup_x = subgroup_x_t(n_bits, x_index_bits)
        old_eval = fri_combine_initial(builder, instances[0],
                                       _InstanceView(evals_proofs, offsets[0]),
                                       challenges_t.fri_alpha, subgroup_x, precomputed[0], params)
        batch_index = 1
        n = n_bits
        for i, arity_bits in enumerate(params.reduction_arity_bits):
            evals = round_proof.steps[i].evals
            coset_index_bits = x_index_bits[arity_bits:]
            within_bits = x_index_bits[:arity_bits]
            within = builder.le_sum(within_bits)
            builder.connect_extension(builder.random_access_extension(within, list(evals)),
                                      old_eval)
            old_eval = compute_evaluation_t(builder, subgroup_x, within_bits, arity_bits, evals,
                                            challenges_t.fri_betas[i])
            builder.verify_merkle_proof_to_cap_with_cap_index(
                [c for e in evals for c in e.parts], coset_index_bits, cap_index,
                proof_t.commit_phase_merkle_caps[i], round_proof.steps[i].merkle_proof)
            subgroup_x = builder.exp_power_of_2(subgroup_x, arity_bits)
            x_index_bits = coset_index_bits
            n -= arity_bits
            if batch_index < len(lde_bits) and n == lde_bits[batch_index]:
                ev = fri_combine_initial(
                    builder, instances[batch_index],
                    _InstanceView(evals_proofs, offsets[batch_index]), challenges_t.fri_alpha,
                    subgroup_x_t(n, x_index_bits), precomputed[batch_index], params)
                old_eval = builder.mul_extension(old_eval, challenges_t.fri_betas[i])
                old_eval = builder.add_extension(old_eval, ev)
                batch_index += 1
        if batch_index != len(instances):
            raise ValueError("Wrong number of folded instances.")
        acc = builder.zero_extension()
        for coeff in reversed(proof_t.final_poly):
            acc = builder.scalar_mul_add_extension(subgroup_x, acc, coeff)
        builder.connect_extension(acc, old_eval)
