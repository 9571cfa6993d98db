"""Prove knowledge of 100! (reference plonky2/examples/factorial.rs; the
reference package's examples/factorial.py), and of 39! under
`KeccakGoldilocksConfig` (`keccak_build_and_prove`: the circuit of
`fixtures/keccak_factorial.*`, tools/generate_fixtures.py:117-136).

    python -m plonky2_torch.examples.factorial            # on the card
"""

from __future__ import annotations

from plonky2_torch.iop.witness import PartialWitness
from plonky2_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_torch.plonk.config import CircuitConfig, keccak_goldilocks_config


def build_and_prove(device=None, n: int = 100, gc=None):
    """Build, then prove, n! under the generic config `gc` (None:
    Poseidon) on `device` (CUDA unless the caller asks for another).
    Returns (CircuitData, ProofWithPublicInputs)."""
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config(), gc=gc)
    initial = builder.add_virtual_target()
    cur = initial
    for i in range(2, n + 1):
        cur = builder.mul(cur, builder.constant(i))
    builder.register_public_input(initial)
    builder.register_public_input(cur)

    data = builder.build(device=device)
    pw = PartialWitness()
    pw.set_target(initial, 1)
    return data, data.prove(pw, device=device)


def keccak_build_and_prove(device=None):
    """39! under `KeccakGoldilocksConfig`: Keccak Merkle caps and
    transcript, Poseidon in-circuit."""
    return build_and_prove(device, 39, keccak_goldilocks_config())


def main(device=None):
    data, proof = build_and_prove(device)
    print(f"Factorial starting at {proof.public_inputs[0]} is {proof.public_inputs[1]}")
    data.verify(proof)
    print("verified")


if __name__ == "__main__":
    main()
