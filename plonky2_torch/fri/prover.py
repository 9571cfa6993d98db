"""FRI prover: commit-phase folding, proof-of-work grind, query rounds.

The transcript stays on the host (`iop.challenger.Challenger`); folding,
re-LDEs and Merkle builds run on the device, one cap and one β crossing
per fold step. Coefficient tensors are kept trimmed to their nonzero prefix
(folding the zero tail yields zeros, so results are identical).
"""

from __future__ import annotations

import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import ntt
from plonky2_torch.field import scalar as fs
from plonky2_torch.fri.proof import (
    FriInitialTreeProof,
    FriProof,
    FriQueryRound,
    FriQueryStep,
)
from plonky2_torch.hash.merkle import make_merkle_tree, open_many_packed
from plonky2_torch.ops import poseidon as kp

GRIND_CHUNK_CUDA = 1 << 17
GRIND_CHUNK_CPU = 1 << 12


def fri_proof(initial_merkle_trees, final_coeffs, challenger, fri_params) -> FriProof:
    """final_coeffs: ext coefficient tensors (c0, c1) of length 2^degree_bits."""
    n = fri_params.lde_size
    trees, final_poly = _fri_committed_trees(final_coeffs, challenger, fri_params)
    pow_witness = fri_proof_of_work(challenger, fri_params.config, final_coeffs[0].device)
    query_round_proofs = _fri_prover_query_rounds(
        initial_merkle_trees, trees, challenger, n, fri_params)
    return FriProof(
        commit_phase_merkle_caps=[t.cap for t in trees],
        query_round_proofs=query_round_proofs,
        final_poly=final_poly,
        pow_witness=pow_witness,
    )


def _fold_step_leaves(values, arity_bits: int):
    """Bit-reverse the values, chunk them into arity cosets and flatten each
    coset's extension elements into one leaf [e0.0, e0.1, e1.0, ...]."""
    v0, v1 = values
    L = v0.shape[0]
    perm = torch.from_numpy(ntt.bit_reverse_perm(L.bit_length() - 1)).to(v0.device)
    return torch.stack([v0[perm], v1[perm]], dim=-1).reshape(L >> arity_bits,
                                                             2 << arity_bits)


def _fold_coeffs_and_relde(coeffs, beta, arity_bits: int, rate_bits: int, shift: int):
    """Fold the coefficients by β per arity chunk; LDE them on the next coset."""
    c0, c1 = coeffs
    arity = 1 << arity_bits
    m = c0.shape[0] // arity
    c0 = c0.reshape(m, arity)
    c1 = c1.reshape(m, arity)
    acc = (c0[:, arity - 1], c1[:, arity - 1])
    for j in range(arity - 2, -1, -1):
        acc = g.ext2_add(g.ext2_mul(acc, beta), (c0[:, j], c1[:, j]))
    values = ntt.lde_fft(torch.stack(acc), rate_bits, shift=shift)
    return acc, (values[0], values[1])


def _initial_lde(coeffs, rate_bits: int):
    values = ntt.coset_lde(torch.stack(coeffs), rate_bits)
    return values[0], values[1]


def _fri_committed_trees(coeffs, challenger, fri_params):
    rate_bits = fri_params.config.rate_bits
    cap_height = fri_params.config.cap_height
    device = coeffs[0].device
    shift = fs.MULTIPLICATIVE_GROUP_GENERATOR
    values = _initial_lde(coeffs, rate_bits)
    trees = []
    for arity_bits in fri_params.reduction_arity_bits:
        tree = make_merkle_tree(_fold_step_leaves(values, arity_bits), cap_height)
        trees.append(tree)
        challenger.observe_cap(tree.cap)
        beta = challenger.get_extension_challenge(2)
        shift = fs.exp(shift, 1 << arity_bits)
        coeffs, values = _fold_coeffs_and_relde(coeffs, g.ext_tensor(beta, device), arity_bits,
                                                rate_bits, shift)

    c0, c1 = g.to_numpy(torch.stack(coeffs))
    final_poly = [(int(a), int(b)) for a, b in zip(c0, c1)]
    for coeff in final_poly:
        challenger.observe_extension_element(coeff)
    return trees, final_poly


def fri_proof_of_work(challenger, config, device) -> int:
    """Grind for the LOWEST witness whose duplexed challenge has
    proof_of_work_bits leading zeros (any valid witness verifies, but only
    the lowest gives the reference's proof bytes)."""
    pow_bits = config.proof_of_work_bits
    if pow_bits == 0:
        witness = 0
    else:
        intermediate = list(challenger.sponge_state)
        pos = len(challenger.input_buffer)
        for i, x in enumerate(challenger.input_buffer):
            intermediate[i] = x
        threshold = 1 << (64 - pow_bits)
        chunk = GRIND_CHUNK_CUDA if torch.device(device).type == "cuda" else GRIND_CHUNK_CPU
        start = 0
        while True:
            witness = kp.grind_chunk(intermediate, pos, start, chunk, threshold, device)
            if witness is not None:
                break
            start += chunk
            if start >= fs.P:
                raise RuntimeError("proof of work failed (searched the entire field)")
    challenger.observe_element(witness)
    response = challenger.get_challenge()
    if response >= 1 << (64 - pow_bits):
        raise RuntimeError("proof-of-work witness does not meet the threshold")
    return witness


def _fri_prover_query_rounds(initial_merkle_trees, trees, challenger, n, fri_params):
    indices = [c % n for c in challenger.get_n_challenges(fri_params.config.num_query_rounds)]
    tree_indices = [indices] * len(initial_merkle_trees)
    xs = indices
    for arity_bits in fri_params.reduction_arity_bits:
        xs = [x >> arity_bits for x in xs]
        tree_indices.append(xs)
    all_opens = open_many_packed(list(initial_merkle_trees) + list(trees), tree_indices)
    initial_opens = all_opens[:len(initial_merkle_trees)]
    step_opens = all_opens[len(initial_merkle_trees):]
    rounds = []
    for qi in range(len(indices)):
        steps = [FriQueryStep(evals=_unflatten(opens[qi][0]), merkle_proof=opens[qi][1])
                 for opens in step_opens]
        rounds.append(FriQueryRound(
            initial_trees_proof=FriInitialTreeProof(
                evals_proofs=[opens[qi] for opens in initial_opens]),
            steps=steps,
        ))
    return rounds


def _unflatten(flat: list[int]) -> list[tuple]:
    return [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]
