"""The FRI proof's targets and their witness setters (reference
fri/recursive_verifier.rs:661-744 and fri/witness_util.rs; the reference
package's fri/recursive_verifier.py:21-126, 358-400). The in-circuit
verifier itself is not ported: the port fills the targets of a recursion
circuit the reference built."""

from __future__ import annotations

from dataclasses import dataclass

from plonky2_torch.iop.target import Target


@dataclass
class MerkleProofTarget:
    siblings: list  # 4-target digests


@dataclass
class FriInitialTreeProofTarget:
    evals_proofs: list  # per oracle: (list[Target], MerkleProofTarget)


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
