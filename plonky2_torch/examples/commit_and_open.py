"""The commit-and-open sequence of one PLONK prove, with PLONK's
polynomials given as inputs.

In the reference prover's order: commit the four oracles (constants and
sigmas, wires, Zs and partial products from values; the quotient from
coefficients), observe the FRI parameters, the circuit digest, the
public-inputs hash and the caps as `prove` does, draw β, γ, α and ζ,
evaluate the openings at ζ and g·ζ, build the FRI instance as
`get_fri_instance` does and prove the openings. The result is the bytes of
the three prove-time caps, the two opening batches and the FRI proof.

`MIDDLE_*` are the shapes of the bench_recursion middle circuit: degree
2^13, rate 3, cap height 4, oracles of 85 / 135 / 20 / 16 polynomials, FRI
arities (4, 4), 16 PoW bits, 28 queries, two challenges.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from plonky2_torch import resolve_device
from plonky2_torch.field import goldilocks as g
from plonky2_torch.field import scalar as fs
from plonky2_torch.fri.config import FriConfig, FriReductionStrategy
from plonky2_torch.fri.oracle import PolynomialBatch, eval_polys_at
from plonky2_torch.fri.serialization import Writer
from plonky2_torch.fri.structure import (
    FriBatchInfo,
    FriInstanceInfo,
    FriOracleInfo,
    FriPolynomialInfo,
)
from plonky2_torch.iop.challenger import Challenger
from plonky2_torch.util import log2_strict

MIDDLE_DEGREE_BITS = 13
MIDDLE_COUNTS = (85, 135, 20, 16)  # constants+sigmas, wires, Zs+partial products, quotient
ORACLE_BLINDING = (False, True, True, True)  # the PLONK oracles' FRI roles
ZS_ORACLE = 2


def middle_fri_config(proof_of_work_bits: int = 16, num_query_rounds: int = 28) -> FriConfig:
    return FriConfig(rate_bits=3, cap_height=4, proof_of_work_bits=proof_of_work_bits,
                     reduction_strategy=FriReductionStrategy.ConstantArityBits(4, 5),
                     num_query_rounds=num_query_rounds)


@dataclass
class CommitAndOpenInputs:
    constants_sigmas: np.ndarray     # [n_cs, n] u64 values
    wires: np.ndarray                # [n_w, n] u64 values
    zs_partial_products: np.ndarray  # [n_z, n] u64 values
    quotient_coeffs: np.ndarray      # [n_q, n] u64 coefficients
    circuit_digest: list[int]
    public_inputs_hash: list[int]
    num_challenges: int = 2


def random_inputs(degree_bits: int, counts=MIDDLE_COUNTS, seed: int = 0,
                  num_challenges: int = 2) -> CommitAndOpenInputs:
    """Uniform canonical field elements drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    n = 1 << degree_bits

    def mat(rows):
        return rng.integers(0, fs.P, size=(rows, n), dtype=np.uint64)

    cs, w, z, q = (mat(c) for c in counts)
    digest = [int(v) for v in rng.integers(0, fs.P, size=4, dtype=np.uint64)]
    pi_hash = [int(v) for v in rng.integers(0, fs.P, size=4, dtype=np.uint64)]
    return CommitAndOpenInputs(cs, w, z, q, digest, pi_hash, num_challenges)


def _ext_list(e0, e1) -> list[tuple]:
    return [(int(a), int(b)) for a, b in zip(g.to_numpy(e0), g.to_numpy(e1))]


def commit_and_open(inputs: CommitAndOpenInputs, config: FriConfig, device=None) -> bytes:
    """Run the sequence on `device` (CUDA unless the caller asks for
    another) and return the proof bytes."""
    device = resolve_device(device)
    rate_bits, cap_height = config.rate_bits, config.cap_height
    nc = inputs.num_challenges
    degree_bits = log2_strict(inputs.wires.shape[1])
    fri_params = config.fri_params(degree_bits, hiding=False)

    def commit_values(values):
        return PolynomialBatch.from_values(values, rate_bits, False, cap_height, device=device)

    constants_sigmas = commit_values(inputs.constants_sigmas)
    wires = commit_values(inputs.wires)

    challenger = Challenger()
    fri_params.observe(challenger)
    challenger.observe_hash(inputs.circuit_digest)
    challenger.observe_hash(inputs.public_inputs_hash)
    challenger.observe_cap(wires.merkle_tree.cap)
    challenger.get_n_challenges(nc)  # betas
    challenger.get_n_challenges(nc)  # gammas

    zs_partial_products = commit_values(inputs.zs_partial_products)
    challenger.observe_cap(zs_partial_products.merkle_tree.cap)
    challenger.get_n_challenges(nc)  # alphas

    quotient = PolynomialBatch.from_coeffs(inputs.quotient_coeffs, rate_bits, False,
                                           cap_height, device=device)
    challenger.observe_cap(quotient.merkle_tree.cap)
    zeta = challenger.get_extension_challenge(2)
    if fs.ext_exp(zeta, 1 << degree_bits) == fs.ext_one(2):
        raise ValueError("Opening point is in the subgroup.")
    zeta_next = fs.ext_scalar_mul(fs.primitive_root_of_unity(degree_bits), zeta)

    oracles = [constants_sigmas, wires, zs_partial_products, quotient]
    e0, e1 = eval_polys_at(torch.cat([o.polynomials for o in oracles]), zeta)
    n0, n1 = eval_polys_at(zs_partial_products.polynomials[:nc], zeta_next)
    zeta_values = _ext_list(e0, e1)
    next_values = _ext_list(n0, n1)
    challenger.observe_extension_elements(zeta_values)
    challenger.observe_extension_elements(next_values)

    all_polys = [FriPolynomialInfo(i, j) for i, o in enumerate(oracles)
                 for j in range(o.polynomials.shape[0])]
    instance = FriInstanceInfo(
        oracles=[FriOracleInfo(o.polynomials.shape[0], b)
                 for o, b in zip(oracles, ORACLE_BLINDING)],
        batches=[FriBatchInfo(point=zeta, polynomials=all_polys),
                 FriBatchInfo(point=zeta_next,
                              polynomials=FriPolynomialInfo.from_range(ZS_ORACLE, range(nc)))])
    opening_proof = PolynomialBatch.prove_openings(instance, oracles, challenger, fri_params)

    w = Writer()
    for o in (wires, zs_partial_products, quotient):
        w.write_merkle_cap(o.merkle_tree.cap)
    w.write_field_ext_vec(zeta_values)
    w.write_field_ext_vec(next_values)
    w.write_fri_proof(opening_proof)
    return bytes(w.buf)
