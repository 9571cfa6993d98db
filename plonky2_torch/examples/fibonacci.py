"""Prove the 100th Fibonacci number (reference plonky2/examples/fibonacci.rs;
the reference package's examples/fibonacci.py).

    python -m plonky2_torch.examples.fibonacci            # on the card
"""

from __future__ import annotations

from plonky2_torch.iop.witness import PartialWitness
from plonky2_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_torch.plonk.config import CircuitConfig


def build_and_prove(device=None):
    """Build, then prove, on `device` (CUDA unless the caller asks for
    another). Returns (CircuitData, ProofWithPublicInputs)."""
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    initial_a = builder.add_virtual_target()
    initial_b = builder.add_virtual_target()
    prev, cur = initial_a, initial_b
    for _ in range(99):
        prev, cur = cur, builder.add(prev, cur)
    builder.register_public_input(initial_a)
    builder.register_public_input(initial_b)
    builder.register_public_input(cur)

    pw = PartialWitness()
    pw.set_target(initial_a, 0)
    pw.set_target(initial_b, 1)
    data = builder.build(device=device)
    return data, data.prove(pw, device=device)


def main(device=None):
    data, proof = build_and_prove(device)
    print(f"100th Fibonacci number mod |F| (starting with {proof.public_inputs[0]}, "
          f"{proof.public_inputs[1]}) is: {proof.public_inputs[2]}")
    data.verify(proof)
    print("verified")


if __name__ == "__main__":
    main()
