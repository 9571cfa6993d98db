"""Range-check a public value (reference plonky2/examples/range_check.rs;
the reference package's examples/range_check.py).

    python -m plonky2_torch.examples.range_check          # on the card
"""

from __future__ import annotations

from plonky2_torch.iop.witness import PartialWitness
from plonky2_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_torch.plonk.config import CircuitConfig


def build_and_prove(value: int = 12345678, device=None):
    """Build, then prove, on `device` (CUDA unless the caller asks for
    another). Returns (CircuitData, ProofWithPublicInputs)."""
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    x = builder.add_virtual_target()
    builder.range_check(x, 32)
    builder.register_public_input(x)

    pw = PartialWitness()
    pw.set_target(x, value)
    data = builder.build(device=device)
    return data, data.prove(pw, device=device)


def main(device=None):
    data, proof = build_and_prove(device=device)
    print(f"Value {proof.public_inputs[0]} is less than 2^32")
    data.verify(proof)
    print("verified")


if __name__ == "__main__":
    main()
