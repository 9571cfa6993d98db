"""STARK -> SNARK: a Starky proof verified inside a Plonky2 circuit (the
reference's tests/test_stark_recursion.py, at any size).

`wrap_circuit` builds the circuit for a STARK of 2^degree_bits rows, or,
with `min_degree_bits`, for any degree in [min_degree_bits, degree_bits]
(the proof's degree then a target; such proofs are made with
`verifier_circuit_fri_params = config.fri_params(degree_bits)`); the
STARK's public inputs become the circuit's. `wrap_inputs` fills its
targets from a proof.

    data, pt = wrap_circuit(stark, config, 20, CircuitConfig.standard_recursion_config())
    proof = data.prove(wrap_inputs(pt, stark_proof))     # public inputs = the STARK's

chip_smoke wraps the 2^20-row FibonacciStark and LookupTestStark proofs
and runs the variable-degree circuit at (18, 12) over 2^14- and 2^17-row
FibonacciStark proofs.
"""

from __future__ import annotations

from plonky2_torch.iop.witness import PartialWitness
from plonky2_torch.starky.recursive_verifier import (
    add_virtual_stark_proof_with_pis,
    set_stark_proof_with_pis_target,
    verify_stark_proof_circuit,
)


def wrap_circuit(stark, stark_config, degree_bits: int, config, min_degree_bits=None,
                 device=None, timing=None):
    """(CircuitData, proof targets) of the circuit verifying `stark`'s
    proofs, built on `device` (CUDA unless the caller asks for another)."""
    from plonky2_torch.plonk.circuit_builder import CircuitBuilder

    builder = CircuitBuilder(config)
    pt = add_virtual_stark_proof_with_pis(builder, stark, stark_config, degree_bits,
                                          with_degree_target=min_degree_bits is not None)
    verify_stark_proof_circuit(builder, stark, pt, stark_config, degree_bits,
                               min_degree_bits_to_support=min_degree_bits)
    builder.register_public_inputs(pt.public_inputs)
    return builder.build(device=device, timing=timing), pt


def wrap_inputs(pt, stark_proof, degree_bits: int | None = None) -> PartialWitness:
    """The witness inputs of a wrap: the proof's targets, and its degree
    bits where the circuit takes any degree."""
    pw = PartialWitness()
    set_stark_proof_with_pis_target(pw, pt, stark_proof, pis_degree_bits=degree_bits)
    return pw
