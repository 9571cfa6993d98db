"""Prove knowledge of 100! (reference plonky2/examples/factorial.rs; the
reference package's examples/factorial.py).

    python -m plonky2_torch.examples.factorial            # on the card
"""

from __future__ import annotations

from plonky2_torch.iop.witness import PartialWitness
from plonky2_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_torch.plonk.config import CircuitConfig


def build_and_prove(device=None):
    """Build, then prove, on `device` (CUDA unless the caller asks for
    another). Returns (CircuitData, ProofWithPublicInputs)."""
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    initial = builder.add_virtual_target()
    cur = initial
    for i in range(2, 101):
        cur = builder.mul(cur, builder.constant(i))
    builder.register_public_input(initial)
    builder.register_public_input(cur)

    data = builder.build(device=device)
    pw = PartialWitness()
    pw.set_target(initial, 1)
    return data, data.prove(pw, device=device)


def main(device=None):
    data, proof = build_and_prove(device)
    print(f"Factorial starting at {proof.public_inputs[0]} is {proof.public_inputs[1]}")
    data.verify(proof)
    print("verified")


if __name__ == "__main__":
    main()
