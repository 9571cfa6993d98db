"""Batch FRI end to end: degree groups committed in one `BatchFriOracle`,
opened in one batch-FRI proof, verified on the host and in a circuit.

The transcript is the reference's tests/test_batch_fri.py one: observe the
batch cap, draw α, and for each group take the `_batch_quotient` of its
polynomials at its own point (POINTS, in order); `batch_fri_proof` folds
them. `circuit` verifies such a proof in a Plonky2 circuit: the transcript
replayed by a `RecursiveChallenger` and `verify_batch_fri_proof_circuit`,
the openings as constants.

    groups = random_groups((20, 16, 12), (16, 8, 4), seed=2026)
    run = prove(groups, params, device="cuda")      # oracle, proof, challenger
    verify(run, params)
    data, targets = circuit(run, params, CircuitConfig.standard_recursion_config())
    data.prove(circuit_inputs(targets, run))

The default shape is chip_smoke's: degree bits 20, 16, 12 with 16, 8, 4
polynomials under `StarkConfig.standard_fast_config()`'s FRI config.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import scalar as fs
from plonky2_torch.fri.batch_fri import (
    BatchFriOracle,
    batch_fri_proof,
    verify_batch_fri_proof,
    verify_batch_fri_proof_circuit,
)
from plonky2_torch.fri.oracle import _batch_quotient, eval_polys_at
from plonky2_torch.fri.proof import FriProof
from plonky2_torch.fri.recursive_verifier import (
    FriChallengesTarget,
    add_virtual_cap,
    add_virtual_fri_proof,
    set_cap_target,
    set_fri_proof_target,
)
from plonky2_torch.fri.serialization import Writer
from plonky2_torch.fri.structure import (
    FriBatchInfo,
    FriInstanceInfo,
    FriOpeningBatch,
    FriOpenings,
    FriOracleInfo,
    FriPolynomialInfo,
)
from plonky2_torch.fri.verifier import fri_challenges
from plonky2_torch.iop.challenger import Challenger
from plonky2_torch.iop.witness import PartialWitness
from plonky2_torch.recursion.recursive_challenger import RecursiveChallenger

BITS = (20, 16, 12)
COUNTS = (16, 8, 4)
POINTS = ((5, 7), (11, 13), (17, 19))


def random_groups(bits=BITS, counts=COUNTS, seed: int = 2026) -> list[np.ndarray]:
    """Each group's coefficients [count, 2^bits] u64 from one numpy
    generator, largest group first."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, fs.P, size=(c, 1 << b), dtype=np.uint64)
            for b, c in zip(bits, counts)]


@dataclass
class BatchRun:
    oracle: BatchFriOracle
    proof: FriProof
    challenger: Challenger  # after the proof
    points: tuple

    @property
    def bits(self) -> list[int]:
        return self.oracle.degree_bits

    @property
    def counts(self) -> list[int]:
        return [int(p.shape[0]) for p in self.oracle.polynomial_groups]


def commit(groups, params, device=None) -> BatchFriOracle:
    return BatchFriOracle(groups, params.config.rate_bits, params.config.cap_height, device)


def prove(groups, params, device=None, points=POINTS, oracle=None) -> BatchRun:
    """Commit `groups` (or take `oracle`) and prove their openings at
    `points`; the FRI transcript's path is `fri.prover`'s (fused unless
    force_host_path())."""
    oracle = oracle or commit(groups, params, device)
    challenger = Challenger()
    challenger.observe_cap(oracle.batch_merkle_tree.cap)
    alpha = challenger.get_extension_challenge(2)
    comps = [_batch_quotient(c, alpha, points[i], params.config.rate_bits)
             for i, c in enumerate(oracle.polynomial_groups)]
    proof = batch_fri_proof([oracle.batch_merkle_tree], comps, challenger, params)
    return BatchRun(oracle, proof, challenger, tuple(points[:len(comps)]))


def proof_bytes(proof: FriProof) -> bytes:
    w = Writer()
    w.write_fri_proof(proof)
    return bytes(w.buf)


def openings(run: BatchRun) -> list[list[tuple]]:
    """Each group's polynomials at its point, on their device, one fetch a
    group."""
    out = []
    for coeffs, z in zip(run.oracle.polynomial_groups, run.points):
        e0, e1 = g.to_numpy(torch.stack(eval_polys_at(coeffs, z)))
        out.append([(int(a), int(b)) for a, b in zip(e0, e1)])
    return out


def instances(counts, points) -> list[FriInstanceInfo]:
    """One instance a group: its one oracle's polynomials at its point."""
    return [FriInstanceInfo(oracles=[FriOracleInfo(c, False)],
                            batches=[FriBatchInfo(point=z, polynomials=FriPolynomialInfo.
                                                  from_range(0, range(c)))])
            for c, z in zip(counts, points)]


def leaf_heights(run: BatchRun, params) -> list[list[int]]:
    return [[b + params.config.rate_bits for b in run.bits]]


def verify(run: BatchRun, params, values=None) -> None:
    """Replay the transcript and verify on the host; raises ValueError.
    `values`: the openings (`openings(run)` unless given)."""
    values = openings(run) if values is None else values
    cap = run.oracle.batch_merkle_tree.cap
    v = Challenger()
    v.observe_cap(cap)
    p = run.proof
    challenges = fri_challenges(v, p.commit_phase_merkle_caps, p.final_poly, p.pow_witness,
                                params.degree_bits, params.config)
    verify_batch_fri_proof(run.bits, instances(run.counts, run.points),
                           [FriOpenings(batches=[FriOpeningBatch(values=list(vals))])
                            for vals in values],
                           challenges, [cap], leaf_heights(run, params), p, params)


def circuit(run: BatchRun, params, config, values=None, device=None, timing=None):
    """The circuit that verifies `run`'s proof: (CircuitData, (cap targets,
    FRI proof targets)), built on `device` (CUDA unless the caller asks for
    another)."""
    from plonky2_torch.plonk.circuit_builder import CircuitBuilder

    values = openings(run) if values is None else values
    builder = CircuitBuilder(config)
    cap_t = add_virtual_cap(builder, params.config.cap_height)
    proof_t = add_virtual_fri_proof(builder, [sum(run.counts)], params)
    ch = RecursiveChallenger(builder)
    ch.observe_cap(cap_t)
    alpha_t = ch.get_extension_challenge()
    betas_t = []
    for cap in proof_t.commit_phase_merkle_caps:
        ch.observe_cap(cap)
        betas_t.append(ch.get_extension_challenge())
    ch.observe_extension_elements(proof_t.final_poly)
    ch.observe_element(proof_t.pow_witness)
    pow_response_t = ch.get_challenge()
    query_indices_t = ch.get_n_challenges(params.config.num_query_rounds)
    challenges_t = FriChallengesTarget(fri_alpha=alpha_t, fri_betas=betas_t,
                                       fri_pow_response=pow_response_t,
                                       fri_query_indices=query_indices_t)
    instances_t = instances(run.counts, [builder.constant_extension(z) for z in run.points])
    openings_t = [FriOpenings(batches=[FriOpeningBatch(
        values=[builder.constant_extension(v) for v in vals])]) for vals in values]
    verify_batch_fri_proof_circuit(builder, run.bits, instances_t, openings_t, challenges_t,
                                   [cap_t], leaf_heights(run, params), proof_t, params)
    return builder.build(device=device, timing=timing), (cap_t, proof_t)


def circuit_inputs(targets, run: BatchRun) -> PartialWitness:
    cap_t, proof_t = targets
    pw = PartialWitness()
    set_cap_target(pw, cap_t, run.oracle.batch_merkle_tree.cap)
    set_fri_proof_target(pw, proof_t, run.proof)
    return pw
