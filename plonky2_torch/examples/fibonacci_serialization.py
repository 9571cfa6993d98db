"""Circuit and proof serialization round trips (reference
plonky2/examples/fibonacci_serialization.rs; the reference package's
examples/fibonacci_serialization.py).

    python -m plonky2_torch.examples.fibonacci_serialization   # on the card

Builds the 100th Fibonacci number's circuit and proves it; writes the proof
and the verifier data to the reference's bytes, reads them back and
verifies; writes the prover data, reads it back and proves again from it.
"""

from __future__ import annotations

from plonky2_torch.iop.witness import PartialWitness
from plonky2_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_torch.plonk.circuit_serialization import (
    verifier_data_from_bytes,
    verifier_data_to_bytes,
)
from plonky2_torch.plonk.config import CircuitConfig
from plonky2_torch.plonk.prover import prove
from plonky2_torch.plonk.prover_serialization import prover_data_to_bytes, read_prover_data
from plonky2_torch.plonk.serialization import proof_from_bytes, proof_to_bytes
from plonky2_torch.plonk.verifier import verify


def main(device=None) -> dict:
    """The round trips on `device` (CUDA unless the caller asks for
    another). Returns the proof's, the verifier data's and the prover
    data's bytes."""
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    initial_a = builder.add_virtual_target()
    initial_b = builder.add_virtual_target()
    prev, cur = initial_a, initial_b
    for _ in range(99):
        prev, cur = cur, builder.add(prev, cur)
    builder.register_public_inputs([initial_a, initial_b, cur])
    data = builder.build(device=device)
    pw = PartialWitness()
    pw.set_target(initial_a, 0)
    pw.set_target(initial_b, 1)
    proof_bytes = proof_to_bytes(data.prove(pw, device=device))
    vd_bytes = verifier_data_to_bytes(data.verifier_only, data.common)
    print(f"proof: {len(proof_bytes)} bytes, verifier data: {len(vd_bytes)} bytes")

    vd, common = verifier_data_from_bytes(vd_bytes)
    verify(proof_from_bytes(proof_bytes, common), vd, common)
    print("verified from serialized artifacts")

    prover_bytes = prover_data_to_bytes(data.prover_only, data.common)
    prover_only, common = read_prover_data(prover_bytes)
    if prover_data_to_bytes(prover_only, common) != prover_bytes:
        raise ValueError("the prover data does not round-trip")
    again = prove(prover_only, common, pw, device=device)
    verify(again, vd, common)
    print(f"prover data: {len(prover_bytes)} bytes, read back and proved again")
    return {"proof": proof_bytes, "verifier": vd_bytes, "prover": prover_bytes}


if __name__ == "__main__":
    main()
