"""Compressed proofs (reference plonk/proof.rs:58-257, fri/proof.rs:125-330,
hash/path_compression.rs; the reference package's plonk/compressed.py).

A compressed proof drops what the verifier can rebuild: the Merkle
siblings that one query's path already fixes for another's, each query's
initial openings and fold steps once per distinct index, and in each fold
step's coset the one value that the step before it gives. `compress` takes
the query indices from the transcript's replay; `decompress` replays it
again, re-derives the dropped values (`_get_inferred_elements`) and
recomputes the dropped siblings, which gives the proof's bytes back.
"""

from __future__ import annotations

from dataclasses import dataclass

from plonky2_torch.field import scalar as fs
from plonky2_torch.fri.proof import FriInitialTreeProof, FriProof, FriQueryRound, FriQueryStep
from plonky2_torch.fri.verifier import (
    PrecomputedReducedOpenings,
    compute_evaluation,
    fri_combine_initial,
)
from plonky2_torch.hash.merkle import MerkleProof
from plonky2_torch.plonk.get_challenges import get_challenges
from plonky2_torch.plonk.proof import Proof, ProofWithPublicInputs
from plonky2_torch.util import reverse_bits


@dataclass
class CompressedFriQueryRounds:
    indices: list[int]  # the query indices, in query order
    initial_trees_proofs: dict  # index -> FriInitialTreeProof
    steps: list  # per fold step: coset index -> FriQueryStep, one value dropped


@dataclass
class CompressedFriProof:
    commit_phase_merkle_caps: list
    query_round_proofs: CompressedFriQueryRounds
    final_poly: list
    pow_witness: int


@dataclass
class CompressedProof:
    wires_cap: list
    plonk_zs_partial_products_cap: list
    quotient_polys_cap: list
    openings: object
    opening_proof: CompressedFriProof


@dataclass
class CompressedProofWithPublicInputs:
    proof: CompressedProof
    public_inputs: list[int]


# -- Merkle paths (reference hash/path_compression.rs) ----------------------------

def compress_merkle_proofs(cap_height: int, indices, proofs) -> list[MerkleProof]:
    """Each proof less the siblings that an earlier path of the batch, or
    the leaves themselves, already determine."""
    if not proofs:
        raise ValueError("no proofs to compress")
    height = cap_height + len(proofs[0].siblings)
    num_leaves = 1 << height
    known = [False] * (2 * num_leaves)
    for i in indices:
        for j in range(height - cap_height):
            known[(i + num_leaves) >> j] = True
    out = []
    for i, p in zip(indices, proofs):
        siblings = []
        index = i + num_leaves
        for sibling in p.siblings:
            if not known[index ^ 1]:
                siblings.append(sibling)
                known[index ^ 1] = True
            index >>= 1
            known[index] = True
        out.append(MerkleProof(siblings))
    return out


def decompress_merkle_proofs(leaves_data, leaves_indices, compressed_proofs, height: int,
                             cap_height: int, hasher) -> list[MerkleProof]:
    """The full proofs back: each path's nodes hashed up from its leaf,
    a missing sibling taken from the compressed proof in order."""
    num_leaves = 1 << height
    seen = {i + num_leaves: hasher.hash_or_noop(v)
            for i, v in zip(leaves_indices, leaves_data)}
    sib_iters = [iter(p.siblings) for p in compressed_proofs]
    for layer_height in range(height - cap_height):
        for i, it in zip(leaves_indices, sib_iters):
            index = (i + num_leaves) >> layer_height
            if index ^ 1 not in seen:
                seen[index ^ 1] = next(it)
            if index % 2 == 0:
                seen[index >> 1] = hasher.two_to_one(seen[index], seen[index ^ 1])
            else:
                seen[index >> 1] = hasher.two_to_one(seen[index ^ 1], seen[index])
    return [MerkleProof([seen[((i + num_leaves) >> k) ^ 1] for k in range(height - cap_height)])
            for i in leaves_indices]


# -- FRI proofs --------------------------------------------------------------------

def compress_fri_proof(proof: FriProof, indices, params) -> CompressedFriProof:
    cap_height = params.config.cap_height
    arity_bits = list(params.reduction_arity_bits)
    n_init = len(proof.query_round_proofs[0].initial_trees_proof.evals_proofs)
    it_indices = [[] for _ in range(n_init)]
    it_leaves = [[] for _ in range(n_init)]
    it_proofs = [[] for _ in range(n_init)]
    st_indices = [[] for _ in arity_bits]
    st_evals = [[] for _ in arity_bits]
    st_proofs = [[] for _ in arity_bits]
    for index, qrp in zip(indices, proof.query_round_proofs):
        for i, (leaves, p) in enumerate(qrp.initial_trees_proof.evals_proofs):
            it_indices[i].append(index)
            it_leaves[i].append(leaves)
            it_proofs[i].append(p)
        for i, step in enumerate(qrp.steps):
            within = index & ((1 << arity_bits[i]) - 1)
            index >>= arity_bits[i]
            st_indices[i].append(index)
            evals = list(step.evals)
            evals.pop(within)  # the verifier re-infers this value
            st_evals[i].append(evals)
            st_proofs[i].append(step.merkle_proof)
    it_proofs = [compress_merkle_proofs(cap_height, js, ps)
                 for js, ps in zip(it_indices, it_proofs)]
    st_proofs = [compress_merkle_proofs(cap_height, js, ps)
                 for js, ps in zip(st_indices, st_proofs)]
    rounds = CompressedFriQueryRounds(indices=list(indices), initial_trees_proofs={},
                                      steps=[{} for _ in arity_bits])
    for q, index in enumerate(indices):
        rounds.initial_trees_proofs.setdefault(index, FriInitialTreeProof(
            evals_proofs=[(it_leaves[j][q], it_proofs[j][q]) for j in range(n_init)]))
        for j, ab in enumerate(arity_bits):
            index >>= ab
            rounds.steps[j].setdefault(index, FriQueryStep(evals=st_evals[j][q],
                                                           merkle_proof=st_proofs[j][q]))
    return CompressedFriProof(commit_phase_merkle_caps=proof.commit_phase_merkle_caps,
                              query_round_proofs=rounds, final_poly=proof.final_poly,
                              pow_witness=proof.pow_witness)


def _challenges(proof_with_pis, verifier_data, common):
    public_inputs_hash = common.generic_config().inner_hasher.hash_no_pad(
        list(proof_with_pis.public_inputs))
    return get_challenges(proof_with_pis, public_inputs_hash, verifier_data.circuit_digest,
                          common)


def compress(proof_with_pis, verifier_data, common) -> CompressedProofWithPublicInputs:
    """`proof_with_pis` compressed at its query indices (reference
    circuit_data.rs:206-215)."""
    indices = _challenges(proof_with_pis, verifier_data, common).fri_challenges.fri_query_indices
    p = proof_with_pis.proof
    return CompressedProofWithPublicInputs(
        proof=CompressedProof(
            wires_cap=p.wires_cap, plonk_zs_partial_products_cap=p.plonk_zs_partial_products_cap,
            quotient_polys_cap=p.quotient_polys_cap, openings=p.openings,
            opening_proof=compress_fri_proof(p.opening_proof, indices, common.fri_params)),
        public_inputs=list(proof_with_pis.public_inputs))


def _get_inferred_elements(cpwp, challenges, common) -> list[tuple]:
    """The values that compression dropped, in the order `decompress_fri_proof`
    takes them: per query, each fold step not yet seen at its depth gets
    the value folded from the step before (reference
    get_challenges.rs:195-257)."""
    zeta = challenges.plonk_zeta
    fri = challenges.fri_challenges
    rounds = cpwp.proof.opening_proof.query_round_proofs
    params = common.fri_params
    precomputed = PrecomputedReducedOpenings(cpwp.proof.openings.to_fri_openings(), fri.fri_alpha)
    log_n = common.degree_bits + common.config.fri_config.rate_bits
    instance = common.get_fri_instance(zeta)
    seen_by_depth = [set() for _ in params.reduction_arity_bits]
    out = []
    for x_index in fri.fri_query_indices:
        subgroup_x = fs.mul(fs.MULTIPLICATIVE_GROUP_GENERATOR,
                            fs.exp(fs.primitive_root_of_unity(log_n),
                                   reverse_bits(x_index, log_n)))
        old_eval = fri_combine_initial(instance, rounds.initial_trees_proofs[x_index],
                                       fri.fri_alpha, subgroup_x, precomputed, params)
        for i, ab in enumerate(params.reduction_arity_bits):
            coset_index = x_index >> ab
            if coset_index in seen_by_depth[i]:
                break
            seen_by_depth[i].add(coset_index)
            out.append(old_eval)
            within = x_index & ((1 << ab) - 1)
            evals = list(rounds.steps[i][coset_index].evals)
            evals.insert(within, old_eval)
            old_eval = compute_evaluation(subgroup_x, within, ab, evals, fri.fri_betas[i])
            subgroup_x = fs.exp(subgroup_x, 1 << ab)
            x_index = coset_index
    return out


def decompress_fri_proof(cfp: CompressedFriProof, challenges, inferred, params,
                         hasher) -> FriProof:
    indices = challenges.fri_challenges.fri_query_indices
    inferred = iter(inferred)
    cap_height = params.config.cap_height
    arity_bits = list(params.reduction_arity_bits)
    rounds = cfp.query_round_proofs
    n_init = len(next(iter(rounds.initial_trees_proofs.values())).evals_proofs)
    it_indices = [[] for _ in range(n_init)]
    it_leaves = [[] for _ in range(n_init)]
    it_proofs = [[] for _ in range(n_init)]
    st_indices = [[] for _ in arity_bits]
    st_evals = [[] for _ in arity_bits]
    st_flat = [[] for _ in arity_bits]
    st_proofs = [[] for _ in arity_bits]
    height = params.degree_bits + params.config.rate_bits
    heights = []
    for ab in arity_bits:
        heights.append((heights[-1] if heights else height) - ab)
    evals_by_depth = [{} for _ in arity_bits]
    for index in indices:
        for i, (leaves, p) in enumerate(rounds.initial_trees_proofs[index].evals_proofs):
            it_indices[i].append(index)
            it_leaves[i].append(leaves)
            it_proofs[i].append(p)
        for i, ab in enumerate(arity_bits):
            within = index & ((1 << ab) - 1)
            index >>= ab
            step = rounds.steps[i][index]
            st_indices[i].append(index)
            if index not in evals_by_depth[i]:
                evals = list(step.evals)
                evals.insert(within, next(inferred))
                evals_by_depth[i][index] = evals
            evals = evals_by_depth[i][index]
            st_evals[i].append(evals)
            st_flat[i].append([c for e in evals for c in e])
            st_proofs[i].append(step.merkle_proof)
    it_proofs = [decompress_merkle_proofs(ls, js, ps, height, cap_height, hasher)
                 for ls, js, ps in zip(it_leaves, it_indices, it_proofs)]
    st_proofs = [decompress_merkle_proofs(ls, js, ps, h, cap_height, hasher)
                 for ls, js, ps, h in zip(st_flat, st_indices, st_proofs, heights)]
    query_rounds = [
        FriQueryRound(
            initial_trees_proof=FriInitialTreeProof(
                evals_proofs=[(it_leaves[j][q], it_proofs[j][q]) for j in range(n_init)]),
            steps=[FriQueryStep(evals=st_evals[j][q], merkle_proof=st_proofs[j][q])
                   for j in range(len(arity_bits))])
        for q in range(len(indices))]
    return FriProof(commit_phase_merkle_caps=cfp.commit_phase_merkle_caps,
                    query_round_proofs=query_rounds, final_poly=cfp.final_poly,
                    pow_witness=cfp.pow_witness)


def decompress(cpwp: CompressedProofWithPublicInputs, verifier_data,
               common) -> ProofWithPublicInputs:
    challenges = _challenges(cpwp, verifier_data, common)
    inferred = _get_inferred_elements(cpwp, challenges, common)
    p = cpwp.proof
    return ProofWithPublicInputs(
        proof=Proof(
            wires_cap=p.wires_cap, plonk_zs_partial_products_cap=p.plonk_zs_partial_products_cap,
            quotient_polys_cap=p.quotient_polys_cap, openings=p.openings,
            opening_proof=decompress_fri_proof(p.opening_proof, challenges, inferred,
                                               common.fri_params,
                                               common.generic_config().hasher)),
        public_inputs=list(cpwp.public_inputs))


def verify_compressed(cpwp: CompressedProofWithPublicInputs, verifier_data, common) -> None:
    """Decompress, then verify (reference circuit_data.rs verify_compressed)."""
    from plonky2_torch.plonk.verifier import verify

    verify(decompress(cpwp, verifier_data, common), verifier_data, common)
